"""The port's geometry and ``Chunk`` protocol against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package's
``BoundingBox``/``PhysicalBoundingBox``/``RegionOfInterest``/``ROITree``
and ``Chunk`` (whose payload here is a host numpy array, so every
reference is the JAX package's numpy leg) and through the port's. Results
must be equal, arrays BITWISE with the same dtype and metadata. Each
chunk method runs on the port twice: on a numpy payload (the JAX
package's host leg, repeated) and on a CPU tensor payload (the torch leg
a card payload takes, under numpy's type rules).
"""
import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core import bbox as jax_bbox
from chunkflow_tpu.core import roi as jax_roi
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.chunk.base import LayerType
from chunkflow_tpu_torch.core import bbox, roi
from chunkflow_tpu_torch.core.cartesian import Cartesian

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)


def plain(value):
    """A result of either package as plain Python data (boxes as their
    corners and voxel size, arrays as (dtype, list))."""
    if isinstance(value, (bbox.BoundingBox, jax_bbox.BoundingBox)):
        out = ("box", tuple(value.start), tuple(value.stop))
        if hasattr(value, "voxel_size"):
            out += (tuple(value.voxel_size),)
        return out
    if isinstance(value, (bbox.BoundingBoxes, jax_bbox.BoundingBoxes)):
        return [plain(b) for b in value]
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return tuple(value)  # Cartesian
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return value.item()
        return (str(value.dtype), value.tolist())
    if isinstance(value, torch.Tensor):
        return plain(value.numpy())
    if isinstance(value, np.generic):
        return value.item()
    return value


# ---------------------------------------------------------------------------
# BoundingBox, PhysicalBoundingBox, BoundingBoxes
# ---------------------------------------------------------------------------
BOX = ((2, -3, 5), (10, 29, 21))
OTHER = ((6, 0, -4), (14, 16, 12))

BOX_CALLS = {
    "shape": lambda m, b, o: b.shape,
    "voxel_count": lambda m, b, o: b.voxel_count,
    "center": lambda m, b, o: b.center,
    "string": lambda m, b, o: b.string,
    "slices": lambda m, b, o: [(s.start, s.stop) for s in b.slices],
    "repr": lambda m, b, o: repr(b),
    "hash": lambda m, b, o: hash(b) == hash(m.BoundingBox(*BOX)),
    "clone": lambda m, b, o: b.clone(),
    "translate": lambda m, b, o: b.translate((1, -2, 3)),
    "adjust": lambda m, b, o: b.adjust((1, 2, -1)),
    "adjust_none": lambda m, b, o: b.adjust(None),
    "union": lambda m, b, o: b.union(o),
    "intersection": lambda m, b, o: b.intersection(o),
    "overlaps": lambda m, b, o: (b.overlaps(o),
                                 b.overlaps(o.translate((40, 0, 0)))),
    "contains_point": lambda m, b, o: [b.contains_point(p) for p in (
        (2, -3, 5), (10, 29, 21), (9, 28, 20), (1, 0, 6))],
    "contains_box_and_point": lambda m, b, o: (
        b.contains(o), b.contains(b.adjust(-1)), b.contains((10, 29, 21)),
        b.contains((11, 0, 6))),
    "clamp": lambda m, b, o: b.clamp(o),
    "is_valid": lambda m, b, o: (b.is_valid(), b.intersection(
        o.translate((30, 0, 0))).is_valid()),
    "is_aligned_with": lambda m, b, o: (
        b.is_aligned_with((2, 4, 4)), b.is_aligned_with((4, 16, 8),
                                                        offset=(2, -3, 5)),
        m.BoundingBox((0, 0, 0), (8, 16, 16)).is_aligned_with((4, 8, 8))),
    "snap_outward": lambda m, b, o: b.snap_to_blocks((4, 8, 8)),
    "snap_inward": lambda m, b, o: b.snap_to_blocks((4, 8, 8), offset=(1, 1, 1),
                                                    outward=False),
    "minpt_maxpt": lambda m, b, o: (b.minpt, b.maxpt),
    "from_list": lambda m, b, o: m.BoundingBox.from_list([1, 2, 3, 7, 8, 9]),
    "from_points": lambda m, b, o: m.BoundingBox.from_points(
        np.array([[1.5, -2.2, 7.0], [4.0, 3.9, -0.5], [2, 2, 2]])),
    "from_center": lambda m, b, o: m.BoundingBox.from_center((5, 5, 5),
                                                             (1, 2, 3)),
    "from_slices": lambda m, b, o: m.BoundingBox.from_slices(
        (slice(0, 3), slice(1, 4), slice(2, 9), slice(-1, 5))),
    "from_string": lambda m, b, o: m.BoundingBox.from_string(
        "0-3_16384-16492_86294-88342_121142-123190.json"),
    "from_delta": lambda m, b, o: m.BoundingBox.from_delta((1, 2, 3),
                                                           (4, 5, 6)),
    "from_array_like": lambda m, b, o: m.BoundingBox.from_array_like(
        np.zeros((2, 3, 4, 5)), voxel_offset=(1, 1, 1)),
    "to_from_array": lambda m, b, o: (b.to_array(),
                                      m.BoundingBox.from_array(b.to_array())),
    "inverse_order": lambda m, b, o: b.inverse_order(),
    "adjust_corner": lambda m, b, o: b.adjust_corner((1, -1, 2, 3, 0, -2)),
    "left_neighbors": lambda m, b, o: b.left_neighbors,
    "aligned_blocks_bounded": lambda m, b, o:
        b.decompose_to_aligned_block_bounding_boxes((4, 8, 8)),
    "aligned_blocks_unbounded": lambda m, b, o:
        b.decompose_to_aligned_block_bounding_boxes((3, 7, 5),
                                                    bounded=False),
    "unaligned_blocks": lambda m, b, o:
        b.decompose_to_unaligned_block_bounding_boxes((3, 7, 5)),
    "decompose": lambda m, b, o: b.decompose((4, 8, 8)),
    "equality": lambda m, b, o: (b == m.BoundingBox(*BOX), b == o),
}


@pytest.mark.parametrize("call", sorted(BOX_CALLS))
def test_bounding_box_matches_jax(call):
    fn = BOX_CALLS[call]
    ref = fn(jax_bbox, jax_bbox.BoundingBox(*BOX),
             jax_bbox.BoundingBox(*OTHER))
    got = fn(bbox, bbox.BoundingBox(*BOX), bbox.BoundingBox(*OTHER))
    assert plain(got) == plain(ref)


def test_bounding_box_errors_match_jax():
    for m in (jax_bbox, bbox):
        with pytest.raises(ValueError, match="6 elements"):
            m.BoundingBox(*BOX).adjust_corner((1, 2, 3))
        with pytest.raises(ValueError, match="not a multiple"):
            m.BoundingBox(*BOX).decompose((3, 3, 3))
        with pytest.raises(ValueError, match="cannot parse"):
            m.BoundingBox.from_string("nope")


PHYS_CALLS = {
    "physical": lambda b: (b.physical_start, b.physical_stop),
    "to_voxel_size": lambda b: b.to_voxel_size((40, 16, 16)),
    "to_voxel_size_finer": lambda b: b.to_voxel_size((20, 2, 2)),
    "to_other_voxel_size": lambda b: b.to_other_voxel_size((40, 16, 16)),
    "voxel_bounding_box": lambda b: b.voxel_bounding_box,
    "inherited": lambda b: (b.shape, b.string, b.voxel_count),
}


@pytest.mark.parametrize("call", sorted(PHYS_CALLS))
def test_physical_bounding_box_matches_jax(call):
    args = ((2, 5, 9), (10, 29, 37), (40, 4, 4))
    ref = PHYS_CALLS[call](jax_bbox.PhysicalBoundingBox(*args))
    got = PHYS_CALLS[call](bbox.PhysicalBoundingBox(*args))
    assert plain(got) == plain(ref)


@pytest.mark.parametrize("kwargs", [
    dict(chunk_size=(8, 32, 32), overlap=(2, 8, 8), roi_start=(1, 2, 3),
         roi_stop=(20, 90, 70)),
    dict(chunk_size=(8, 32, 32), stride=(6, 24, 24), roi_size=(20, 90, 70),
         bounded=True),
    dict(chunk_size=(8, 32, 32), grid_size=(2, 3, 1)),
    dict(chunk_size=(8, 32, 32), roi_start=(3, 5, 7), roi_stop=(30, 70, 70),
         aligned_block_size=(8, 16, 16), block_offset=(1, 1, 1)),
], ids=["overlap", "stride-bounded", "grid", "aligned"])
def test_task_grid_matches_jax(kwargs):
    ref = jax_bbox.BoundingBoxes.from_manual_setup(**kwargs)
    got = bbox.BoundingBoxes.from_manual_setup(**kwargs)
    assert plain(got) == plain(ref)
    assert plain(got.roi) == plain(ref.roi)
    assert tuple(got.grid_size) == tuple(ref.grid_size)


# ---------------------------------------------------------------------------
# RegionOfInterest, ROITree
# ---------------------------------------------------------------------------
def test_region_of_interest_matches_jax():
    args = ((0, 8, 16), (12, 72, 80), (40, 4, 4))
    ref, got = jax_roi.RegionOfInterest(*args), roi.RegionOfInterest(*args)
    assert plain(got.bounding_box) == plain(ref.bounding_box)
    assert tuple(got.physical_size) == tuple(ref.physical_size)
    assert plain(got.clone()) == plain(ref.clone())
    assert repr(got) == repr(ref)
    for vs in ((40, 8, 8), (80, 16, 16), (20, 2, 2)):
        assert ([(s.start, s.stop) for s in got.slices_in_scale(vs)]
                == [(s.start, s.stop) for s in ref.slices_in_scale(vs)])
    box = ((1, 2, 3), (5, 6, 7))
    assert plain(roi.RegionOfInterest.from_bbox(bbox.BoundingBox(*box),
                                                (4, 4, 4))) \
        == plain(jax_roi.RegionOfInterest.from_bbox(
            jax_bbox.BoundingBox(*box), (4, 4, 4)))


@pytest.mark.parametrize("block", [(4, 16, 16), (5, 24, 8), (64, 64, 64)])
def test_roi_tree_matches_jax(block):
    args = ((0, 8, 16), (12, 72, 80), (40, 4, 4))
    ref = jax_roi.ROITree.from_roi(jax_roi.RegionOfInterest(*args), block)
    got = roi.ROITree.from_roi(roi.RegionOfInterest(*args), block)
    assert len(got) == len(ref)
    assert plain(list(got.leaves())) == plain(list(ref.leaves()))
    assert (got.axis, got.is_leaf) == (ref.axis, ref.is_leaf)


# ---------------------------------------------------------------------------
# the Chunk protocol
# ---------------------------------------------------------------------------
OFFSET, VSIZE = (3, -2, 7), (40, 4, 4)


def _arr(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random(shape).astype(dtype)
    if np.dtype(dtype) == np.bool_:
        return rng.random(shape) > 0.5
    return rng.integers(0, 256, shape).astype(dtype)


def _pair(arr, **meta):
    """(JAX chunk, port chunk on numpy, port chunk on a CPU tensor), each
    on its own copy of ``arr``."""
    meta = dict(dict(voxel_offset=OFFSET, voxel_size=VSIZE), **meta)
    return (JaxChunk(arr.copy(), **meta), Chunk(arr.copy(), **meta),
            Chunk(torch.from_numpy(arr.copy()), **meta))


def _host(value):
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


def assert_same_chunk(got, ref):
    """Bitwise payload, the same dtype, the same metadata."""
    assert type(got).__name__ == type(ref).__name__
    want, have = np.asarray(ref.array), _host(got.array)
    assert have.dtype == want.dtype, (have.dtype, want.dtype)
    assert have.shape == want.shape
    assert np.array_equal(have, want, equal_nan=want.dtype.kind == "f")
    if want.dtype.kind == "f":  # signed zeros too
        assert np.array_equal(np.signbit(have), np.signbit(want))
    assert tuple(got.voxel_offset) == tuple(ref.voxel_offset)
    assert tuple(got.voxel_size) == tuple(ref.voxel_size)
    assert got.layer_type.value == ref.layer_type.value


def assert_same(got, ref):
    if isinstance(ref, JaxChunk):
        assert_same_chunk(got, ref)
    elif isinstance(ref, (np.ndarray, np.generic)):
        have, want = _host(got), np.asarray(ref)
        assert have.dtype == want.dtype and np.array_equal(have, want)
    else:
        assert plain(got) == plain(ref)


U8 = _arr("uint8", (4, 16, 16))
F32 = _arr("float32", (4, 16, 16), seed=1) * np.float32(2) - np.float32(1)
F32_4D = _arr("float32", (3, 4, 16, 16), seed=2)
U32 = _arr("uint32", (4, 16, 16), seed=3)

# (payload, what the operator does): the mixin's operators under numpy's
# rules (NEP 50: a Python scalar is weak)
UFUNC_CALLS = {
    "u8_times_float": (U8, lambda c: c * 2.5),
    "u8_times_int": (U8, lambda c: c * 3),
    "f32_div_float": (F32, lambda c: c / 127.5),
    "f32_sub_float": (F32, lambda c: c - 1.0),
    "float_rsub_f32": (F32, lambda c: 1.0 - c),
    "float_rdiv_f32": (F32, lambda c: 3.0 / c),
    "u8_div_u8": (U8, lambda c: c / (c | 1)),
    "f32_times_u8_array": (F32, lambda c: c * U8),
    "u8_plus_f32_array": (U8, lambda c: c + F32),
    "f32_squared": (F32, lambda c: c * c),
    "f32_gt_float": (F32, lambda c: c > 0.3),
    "u8_le_int": (U8, lambda c: c <= 100),
    "f32_eq_self": (F32, lambda c: c == c),
    "u8_ne_int": (U8, lambda c: c != 7),
    "neg_f32": (F32, lambda c: -c),
    "abs_f32": (F32, lambda c: abs(c)),
    "maximum": (F32, lambda c: np.maximum(c, 0.25)),
    "minimum": (F32_4D, lambda c: np.minimum(c, F32_4D[::-1])),
    "u8_and_int": (U8, lambda c: c & 0x3C),
    "u8_or_u8": (U8, lambda c: c | U8[::-1]),
    "invert_u8": (U8, lambda c: ~c),
    "u32_xor_int": (U32, lambda c: c ^ 12345),
    "f32_4d_times_3d": (F32_4D, lambda c: c * F32_4D[0]),
}


@pytest.mark.parametrize("call", sorted(UFUNC_CALLS))
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_chunk_operators_match_jax(call, payload):
    arr, fn = UFUNC_CALLS[call]
    jax_chunk, np_chunk, t_chunk = _pair(arr)
    ref = fn(jax_chunk)
    got = fn(np_chunk if payload == "numpy" else t_chunk)
    assert_same(got, ref)
    if payload == "tensor":
        assert isinstance(got.array, torch.Tensor)


def test_chunk_times_chunk_keeps_the_left_metadata():
    """A chunk times a chunk of another dtype (the ``multiply``
    command): numpy's promotion and the left operand's metadata, on every
    combination of payloads."""
    a, b = F32, U8
    ref = JaxChunk(a.copy(), voxel_offset=OFFSET) * JaxChunk(b.copy())
    for left in (a, torch.from_numpy(a.copy())):
        for right in (b, torch.from_numpy(b.copy())):
            got = Chunk(left, voxel_offset=OFFSET) * Chunk(right)
            assert_same_chunk(got, ref)


def _setitem(c):
    c[0, 1:3] = 7
    c[1] = c[2]
    return c


def _save(c):
    patch = type(c)(np.full((2, 5, 5), 9, np.uint8), voxel_offset=(4, 0, 10))
    c.save(patch)
    return c


def _blend(c):
    patch = type(c)(np.full((3, 6, 6), 2, np.uint8), voxel_offset=(5, 10, 18))
    c.blend(patch)
    c.add_overlap(patch)
    return c


def _fill(c):
    c.fill(3)
    return c


def _properties(c):
    c.properties = {"voxel_offset": (1, 2, 3), "voxel_size": None,
                    "layer_type": "segmentation"}
    return (c.properties["voxel_offset"], c.properties["voxel_size"],
            c.properties["layer_type"].value)


def _contiguous(c):
    c.array = c.array[:, ::2]
    return c.ascontiguousarray()


CHUNK_CALLS = {
    "array": (U8, lambda c: np.asarray(c)),
    "array_dtype": (U8, lambda c: np.asarray(c, dtype=np.float32)),
    "getitem": (F32_4D, lambda c: c[1, 2:, ::3]),
    "setitem": (U8, _setitem),
    "astype": (F32, lambda c: c.astype(np.uint8)),
    "astype_f64": (U8, lambda c: c.astype(np.float64)),
    "clone": (U8, lambda c: c.clone()),
    "fill": (F32, _fill),
    "where": (U8, lambda c: c.where(np.asarray(U8) > 200)),
    "ascontiguousarray": (F32, _contiguous),
    "shrink3": (F32_4D, lambda c: c.shrink((1, 2, 3))),
    "shrink6": (U8, lambda c: c.shrink((0, 1, 2, 1, 3, 0))),
    "pad_to_constant": (F32_4D, lambda c: c.pad_to((6, 20, 17))),
    "pad_to_edge": (U8, lambda c: c.pad_to((5, 19, 16), mode="edge")),
    "pad_to_same": (U8, lambda c: c.pad_to((4, 16, 16))),
    "transpose3d": (U8, lambda c: c.transpose()),
    "transpose4d": (F32_4D, lambda c: c.transpose()),
    "transpose4d_all": (F32_4D, lambda c: c.transpose(only_spatial=False)),
    "squeeze_channel": (F32_4D[:1].copy(), lambda c: c.squeeze_channel()),
    "squeeze_3d": (U8, lambda c: c.squeeze_channel()),
    "min_max": (F32, lambda c: (c.min(), c.max())),
    "save": (U8, _save),
    "blend": (U8, _blend),
    "properties": (U8, _properties),
    "predicates": (F32_4D, lambda c: (c.is_image, c.is_segmentation,
                                      c.is_affinity_map,
                                      c.is_probability_map)),
    "geometry": (F32_4D, lambda c: (
        c.nchannels, len(c), c.ndoffset,
        [(s.start, s.stop) for s in c.slices], c.bounding_box, c.start,
        c.stop, c.size, c.voxel_stop)),
    "cutout": (F32_4D, lambda c: c.cutout(c.bbox.adjust((-1, -2, -3)))),
    "crop_margin": (U8, lambda c: c.crop_margin((1, 3, 2))),
    "all_zero": (U8, lambda c: (c.all_zero(), (c * 0).all_zero())),
    "with_voxel_size": (U8, lambda c: c.with_voxel_size((8, 8, 8))),
    "layer_inference": (U32, lambda c: c.layer_type.value),
    "repr": (U8, lambda c: repr(c).replace("torch.", "")),
}


@pytest.mark.parametrize("call", sorted(CHUNK_CALLS))
@pytest.mark.parametrize("payload", ["numpy", "tensor"])
def test_chunk_methods_match_jax(call, payload):
    arr, fn = CHUNK_CALLS[call]
    jax_chunk, np_chunk, t_chunk = _pair(arr)
    ref = fn(jax_chunk)
    got = fn(np_chunk if payload == "numpy" else t_chunk)
    if isinstance(ref, tuple) and ref and isinstance(ref[0], np.ndarray):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_same(g, r)
    elif isinstance(ref, tuple):
        assert [plain(_host(g)) if isinstance(g, torch.Tensor) else plain(g)
                for g in got] == [plain(r) for r in ref]
    else:
        assert_same(got, ref)


def test_chunk_from_array_and_wrapping_match_jax():
    box = ((1, 2, 3), (5, 18, 19))
    ref = JaxChunk.from_array(U8, jax_bbox.BoundingBox(*box), voxel_size=VSIZE)
    got = Chunk.from_array(U8, bbox.BoundingBox(*box), voxel_size=VSIZE)
    assert_same_chunk(got, ref)
    assert_same_chunk(Chunk(got), JaxChunk(ref))
    with pytest.raises(ValueError, match="does not match"):
        Chunk.from_array(U8, bbox.BoundingBox((0, 0, 0), (1, 1, 1)))


def test_a_card_payload_is_not_read_implicitly():
    chunk = Chunk(torch.zeros(2, 3, 4))
    chunk.array = torch.zeros(2, 3, 4, device="meta")
    with pytest.raises(TypeError, match="host"):
        np.asarray(chunk)


# the Chunk methods that raised before the file formats and the
# segmentation legs were ported: each now runs, the port's result (or the
# file it writes, read by the other package) equal to the JAX package's
_ONCE_UNPORTED = {
    "connected_component": lambda tmp, m: m(U8).connected_component(),
    "gaussian_filter_2d": lambda tmp, m: m(U8).gaussian_filter_2d(1.5),
    "to_h5": lambda tmp, m: JaxChunk.from_h5(
        m(F32_4D, voxel_offset=(1, 2, 3), voxel_size=VSIZE).to_h5(
            str(tmp / f"{m.__module__}.h5"))),
    "from_h5": lambda tmp, m: m.from_h5(
        JaxChunk(F32_4D, voxel_offset=(1, 2, 3), voxel_size=VSIZE).to_h5(
            str(tmp / f"{m.__module__}.h5"))),
    "to_tif": lambda tmp, m: JaxChunk.from_tif(
        m(U8).to_tif(str(tmp / f"{m.__module__}.tif")),
        voxel_offset=(4, 5, 6)),
    "from_tif": lambda tmp, m: m.from_tif(
        JaxChunk(U8).to_tif(str(tmp / f"{m.__module__}.tif")),
        voxel_offset=(4, 5, 6)),
}


@pytest.mark.parametrize("method", sorted(_ONCE_UNPORTED),
                         ids=sorted(_ONCE_UNPORTED))
def test_unported_chunk_methods_name_their_item(tmp_path, method):
    """These methods raised naming their ROADMAP item until it was
    ported; now each gives the JAX package's result."""
    call = _ONCE_UNPORTED[method]
    assert_same_chunk(call(tmp_path, Chunk), call(tmp_path, JaxChunk))


def test_layer_types_and_cartesian_are_the_jax_packages():
    assert [t.value for t in LayerType] == [
        t.value for t in type(JaxChunk(U8).layer_type)]
    assert Cartesian(1, 2, 3) * 2 == (2, 4, 6)
