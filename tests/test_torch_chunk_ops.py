"""The port's chunk operators against the JAX package, on the CPU.

Seeded numpy inputs, small (4x16x16, 3x4x16x16), go through the JAX
package and the port; results are BITWISE equal with the same dtype and
metadata (``Segmentation.evaluate``: within 1e-12 relative, float64 sums
of pair counts). The reference leg is named per test:

- host numpy: ``threshold``, ``quantize``, ``from_segmentation``,
  ``normalize_contrast``/``normalize_shang``, ``adjust_grey``,
  ``validate``, ``Segmentation``, ``ProbabilityMap``, ``ops/remap.py``
  (the JAX package computes a host chunk's operators with numpy);
- ``jnp`` on the CPU: ``maskout`` and ``channel_voting`` (the JAX package
  runs them with ``jnp`` wherever the chunk lives).

The port runs each on a numpy payload and, where the operator has a
torch leg (a card payload's), on a CPU tensor payload too.
"""
import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk import AffinityMap as JaxAffinityMap
from chunkflow_tpu.chunk import Image as JaxImage
from chunkflow_tpu.chunk import ProbabilityMap as JaxProbabilityMap
from chunkflow_tpu.chunk import Segmentation as JaxSegmentation
from chunkflow_tpu.chunk import adjust_grey as jax_adjust_grey
from chunkflow_tpu.chunk import validate as jax_validate
from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.ops import mask as jax_mask
from chunkflow_tpu.ops import remap as jax_remap
from chunkflow_tpu.ops import threshold as jax_threshold
from chunkflow_tpu.ops import voting as jax_voting
from chunkflow_tpu_torch.chunk import (
    AffinityMap,
    Chunk,
    Image,
    ProbabilityMap,
    Segmentation,
)
from chunkflow_tpu_torch.chunk import adjust_grey, validate
from chunkflow_tpu_torch.chunk.image import percentiles
from chunkflow_tpu_torch.ops import mask, remap, threshold, voting
from tests.test_torch_chunk import assert_same_chunk

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

OFFSET, VSIZE = (3, 8, 24), (40, 4, 4)
PAYLOADS = ["numpy", "tensor"]


def _rng(seed):
    return np.random.default_rng(seed)


def _payload(arr, payload):
    return torch.from_numpy(arr.copy()) if payload == "tensor" else arr.copy()


def _chunks(cls_jax, cls_port, arr, payload, **meta):
    meta = dict(dict(voxel_offset=OFFSET, voxel_size=VSIZE), **meta)
    return cls_jax(arr.copy(), **meta), cls_port(_payload(arr, payload),
                                                 **meta)


# ---------------------------------------------------------------------------
# threshold (reference: the JAX host leg, numpy)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype, value", [
    ("float32", 0.5), ("float32", 0.3), ("float32", 0.7000001),
    ("uint8", 0.5), ("uint8", 100.0), ("float64", 0.3)])
def test_threshold_matches_jax(payload, dtype, value):
    arr = _rng(1).random((3, 4, 16, 16))
    if dtype == "uint8":
        arr = arr * 255
    arr = arr.astype(dtype)
    ref_in, got_in = _chunks(JaxChunk, Chunk, arr, payload)
    ref = jax_threshold.threshold(ref_in, value)
    assert_same_chunk(threshold.threshold(got_in, value), ref)
    assert_same_chunk(got_in.threshold(value), ref_in.threshold(value))


def test_threshold_float_output_is_a_probability_map():
    arr = _rng(2).random((4, 16, 16)).astype(np.float32)
    for payload in PAYLOADS:
        ref = jax_threshold.threshold(JaxChunk(arr), 0.5, dtype=np.float32)
        got = threshold.threshold(Chunk(_payload(arr, payload)), 0.5,
                                  dtype=np.float32)
        assert_same_chunk(got, ref)


# ---------------------------------------------------------------------------
# maskout (reference: jnp on the CPU)
# ---------------------------------------------------------------------------
MASK_CASES = {
    # (chunk shape, chunk offset, mask factor, mask offset)
    "same-res": ((4, 16, 16), (1, 2, 3), (1, 1, 1), (0, 0, 0)),
    "coarse-aligned": ((4, 16, 16), (2, 16, 32), (1, 4, 4), (0, 0, 0)),
    "coarse-off-grid": ((4, 16, 16), (1, 5, 11), (1, 4, 4), (0, 0, 0)),
    "coarse-z-off-grid": ((5, 16, 16), (3, 9, 2), (2, 4, 8), (1, 1, 0)),
    "affinity-off-grid": ((3, 4, 16, 16), (2, 18, 7), (1, 16, 16), (0, 0, 0)),
}


def _mask_inputs(case, dtype):
    shape, offset, factor, moffset = MASK_CASES[case]
    rng = _rng(3)
    arr = rng.random(shape)
    arr = (arr * 255).astype(dtype) if np.dtype(dtype).kind in "iu" else \
        (arr * 2 - 1).astype(dtype)
    vsize = (40, 4, 4)
    mvsize = tuple(v * f for v, f in zip(vsize, factor))
    # cover the chunk with the coarse mask, plus a border
    stop = [(o + s) * v // mv + 2 for o, s, v, mv in
            zip(offset, shape[-3:], vsize, mvsize)]
    mshape = tuple(st - mo for st, mo in zip(stop, moffset))
    marr = (rng.random(mshape) > 0.4).astype(np.uint8)
    return arr, offset, vsize, marr, moffset, mvsize


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "uint8", "uint32", "float64"])
@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_maskout_matches_jax(case, dtype, inverse, payload):
    arr, offset, vsize, marr, moffset, mvsize = _mask_inputs(case, dtype)
    ref = jax_mask.maskout(
        JaxChunk(arr.copy(), voxel_offset=offset, voxel_size=vsize),
        JaxChunk(marr, voxel_offset=moffset, voxel_size=mvsize),
        inverse=inverse)
    got = mask.maskout(
        Chunk(_payload(arr, payload), voxel_offset=offset, voxel_size=vsize),
        Chunk(marr, voxel_offset=moffset, voxel_size=mvsize),
        inverse=inverse, device="cpu")
    assert_same_chunk(got, ref)
    assert isinstance(got.array, np.ndarray) == (payload == "numpy")


def test_maskout_method_and_factor_check_match_jax():
    arr, offset, vsize, marr, moffset, mvsize = _mask_inputs(
        "coarse-off-grid", "float32")
    jc = JaxChunk(arr, voxel_offset=offset, voxel_size=vsize)
    jm = JaxChunk(marr, voxel_offset=moffset, voxel_size=mvsize)
    pc = Chunk(arr, voxel_offset=offset, voxel_size=vsize)
    pm = Chunk(marr, voxel_offset=moffset, voxel_size=mvsize)
    assert_same_chunk(pc.maskout(pm, device="cpu"), jc.maskout(jm))
    assert tuple(mask.upsample_factor(pc, pm)) == tuple(
        jax_mask.upsample_factor(jc, jm))
    bad = Chunk(marr, voxel_size=(40, 6, 6))
    with pytest.raises(ValueError, match="integer multiple"):
        mask.maskout(pc, bad, device="cpu")


def test_maskout_of_a_host_chunk_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr, offset, vsize, marr, moffset, mvsize = _mask_inputs("same-res",
                                                             "float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mask.maskout(Chunk(arr, voxel_offset=offset, voxel_size=vsize),
                     Chunk(marr, voxel_offset=moffset, voxel_size=mvsize))


# ---------------------------------------------------------------------------
# channel voting (reference: jnp on the CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", ["float32", "uint8", "float64"])
def test_channel_voting_matches_jax(payload, dtype):
    arr = _rng(4).random((5, 4, 16, 16))
    if dtype == "uint8":
        arr = arr * 4  # many ties: the first maximal channel wins
    arr = arr.astype(dtype)
    ref_in, got_in = _chunks(JaxChunk, Chunk, arr, payload)
    ref = jax_voting.channel_voting(ref_in)
    assert_same_chunk(voting.channel_voting(got_in, device="cpu"), ref)
    assert_same_chunk(got_in.channel_voting(device="cpu"),
                      ref_in.channel_voting())
    with pytest.raises(ValueError, match="4D"):
        voting.channel_voting(Chunk(arr[0]), device="cpu")


# ---------------------------------------------------------------------------
# remap (reference: the JAX numpy leg, and its native leg where built)
# ---------------------------------------------------------------------------
def _labels(shape, dtype, seed=5, scale=97):
    return (_rng(seed).integers(0, 40, shape) * scale).astype(dtype)


@pytest.mark.parametrize("dtype", ["uint8", "uint32", "uint64", "int64"])
def test_remap_functions_match_jax(dtype):
    arr = _labels((4, 16, 16), dtype, scale=3 if dtype == "uint8" else 97)
    for start_id in (1, 7):
        out, mapping = remap.renumber(arr, start_id=start_id)
        ref, ref_map = jax_remap.renumber(arr, start_id=start_id)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)
        assert mapping == ref_map
    some = {int(v): int(v) // 3 + 1 for v in np.unique(arr)[1:5]}
    for preserve in (True, False):
        assert np.array_equal(remap.remap(arr, some, preserve),
                              jax_remap.remap(arr, some, preserve))
        keys = np.array(list(some)[::-1])
        values = np.array([some[k] for k in keys])
        assert np.array_equal(
            remap.remap_arrays(arr, keys, values, preserve),
            jax_remap.remap_arrays(arr, keys, values, preserve))
        assert np.array_equal(
            remap.remap_arrays(arr, keys[:0], values[:0], preserve),
            jax_remap.remap_arrays(arr, keys[:0], values[:0], preserve))
    assert np.array_equal(remap.remap(arr, {}), jax_remap.remap(arr, {}))
    for counts in (False, True):
        got = remap.unique_ids(arr, return_counts=counts)
        ref = jax_remap.unique_ids(arr, return_counts=counts)
        assert plain_ids(got) == plain_ids(ref)


def plain_ids(value):
    if isinstance(value, tuple):
        return [v.tolist() for v in value]
    return value.tolist()


@pytest.mark.parametrize("native", ["present", "absent"])
def test_renumber_at_native_size_matches_jax(monkeypatch, native):
    """Above the JAX package's native threshold (2^20 voxels, uint32) its
    native C++ leg runs where it builds; the port's numpy leg is bitwise
    it, and bitwise the JAX numpy leg (native switched off)."""
    from chunkflow_tpu import native as jax_native

    if native == "present" and not jax_native.available():
        pytest.skip("the JAX package's native library does not build here")
    if native == "absent":
        monkeypatch.setattr(jax_remap, "_native_or_none", lambda: None)
    arr = _labels((16, 256, 256), np.uint32, seed=6, scale=1009)
    assert arr.size >= jax_remap._NATIVE_MIN_SIZE
    out, mapping = remap.renumber(arr, start_id=3)
    ref, ref_map = jax_remap.renumber(arr, start_id=3)
    assert np.array_equal(out, ref) and mapping == ref_map
    table = {v: (v * 7) % 1000 + 1 for v in list(ref_map)[:50]}
    assert np.array_equal(remap.remap(arr, table),
                          jax_remap.remap(arr, table))


# ---------------------------------------------------------------------------
# adjust_grey and validate (reference: the JAX host leg, numpy)
# ---------------------------------------------------------------------------
def _grey(seed=7, shape=(4, 16, 16)):
    return _rng(seed).integers(0, 256, shape).astype(np.uint8)


ADJUST_CALLS = {
    "clip_percentile": lambda m: m.clip_percentile(_grey(), 0.05, 0.02),
    "window_level": lambda m: m.window_level(
        _grey().astype(np.float32), 40.0, 100.0),
    "rescale": lambda m: m.rescale(_grey().astype(np.float32), (0, 255)),
    "rescale_same": lambda m: m.rescale(np.ones(3, np.float32), (-1, 1)),
    "voxels_for_stats": lambda m: m.get_voxels_for_stats(
        _grey().astype(np.float32)),
    "normalize_meanstd": lambda m: m.normalize(
        _grey().astype(np.float32), "meanstd", do_clipping=True),
    "normalize_fill": lambda m: m.normalize(
        _grey().astype(np.float32), "fill", target_scale=(0, 1)),
    "normalize_blank": lambda m: m.normalize(
        np.full((2, 4, 4), 255, np.float32), "fill", do_clipping=True),
    "adjust_gamma": lambda m: m.adjust_gamma(
        _grey().astype(np.float32) / 300, 0.7, auto_rescale=True),
    "grey_augment": lambda m: m.grey_augment(
        _grey().astype(np.float32) / 127.5 - 1,
        rng=np.random.default_rng(8), gamma_prob=1.0),
    "normalize_shang": lambda m: m.normalize_shang(_grey(), None, None, True),
    "normalize_shang_range": lambda m: m.normalize_shang(
        _grey().astype(np.uint16), 10.0, 200.0, False),
}


@pytest.mark.parametrize("call", sorted(ADJUST_CALLS))
def test_adjust_grey_matches_jax(call):
    got = ADJUST_CALLS[call](adjust_grey)
    ref = ADJUST_CALLS[call](jax_adjust_grey)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _boxed(box: bool):
    img = _rng(9).integers(1, 256, (24, 40, 40)).astype(np.uint8)
    if box:
        img[3:21, 8:30, 6:32] = 0
    return img


@pytest.mark.parametrize("box", [False, True])
def test_validate_matches_jax(box):
    img = _boxed(box)
    got = validate.validate_by_template_matching(img)
    assert got == jax_validate.validate_by_template_matching(img)
    assert got is (not box)
    assert Chunk(img).validate() == JaxChunk(img).validate()
    assert Chunk(torch.from_numpy(img)).validate() == got
    template = np.zeros((2, 7, 7), bool)
    template[0] = True
    assert np.array_equal(
        validate.match_template_ncc(img.astype(bool), template),
        jax_validate.match_template_ncc(img.astype(bool), template))


# ---------------------------------------------------------------------------
# Image (reference: the JAX host leg, numpy percentiles)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("per_section", [True, False])
@pytest.mark.parametrize("dtype, shape", [
    ("uint8", (4, 16, 16)), ("uint8", (3, 5, 16, 16)),
    ("uint16", (4, 16, 16)), ("float32", (4, 16, 16))])
def test_normalize_contrast_matches_jax(payload, per_section, dtype, shape):
    rng = _rng(10)
    arr = rng.random(shape)
    arr = (arr * np.iinfo(dtype).max).astype(dtype) \
        if np.dtype(dtype).kind == "u" else arr.astype(dtype)
    ref_in, got_in = _chunks(JaxImage, Image, arr, payload)
    for kwargs in (dict(), dict(lower_clip_fraction=0.1,
                                upper_clip_fraction=0.25, minval=0,
                                maxval=200)):
        ref = ref_in.normalize_contrast(per_section=per_section, **kwargs)
        got = got_in.normalize_contrast(per_section=per_section, **kwargs)
        assert_same_chunk(got, ref)


@pytest.mark.parametrize("n, percents", [
    (256, (1.0, 99.0)), (7, (0.0, 100.0, 50.0)), (1, (1.0, 99.0)),
    (16 * 256, (12.5, 87.5, 33.3))])
def test_percentiles_are_numpys(n, percents):
    """The torch leg's order statistics and numpy's ``_lerp``, with a NaN
    slice, against ``np.percentile`` on float32."""
    arr = _rng(11).random((3, n)).astype(np.float32)
    arr[1, n // 2] = np.nan
    got = percentiles(torch.from_numpy(arr[:, None]), percents, 2)
    for p, g in zip(percents, got):
        ref = np.percentile(arr[:, None], p, axis=(-2, -1), keepdims=True)
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), ref, equal_nan=True)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_normalize_shang_matches_jax(payload):
    arr = _grey(12)
    ref_in, got_in = _chunks(JaxImage, Image, arr, payload)
    for kwargs in (dict(), dict(nominalmin=1.0, nominalmax=200.0,
                                clipvalues=True)):
        assert_same_chunk(got_in.normalize_shang(**kwargs),
                          ref_in.normalize_shang(**kwargs))
    assert_same_chunk(Image.from_chunk(got_in), JaxImage.from_chunk(ref_in))


# ---------------------------------------------------------------------------
# AffinityMap (reference: the JAX host leg, numpy)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("mode", ["xy", "z"])
@pytest.mark.parametrize("dtype", ["float32", "uint8", "float64"])
def test_quantize_matches_jax(payload, mode, dtype):
    arr = _rng(13).random((3, 4, 16, 16)) * 1.2 - 0.1
    if dtype == "uint8":
        arr = arr.clip(0, 1) * 255
    arr = arr.astype(dtype)
    ref_in, got_in = _chunks(JaxAffinityMap, AffinityMap, arr, payload)
    assert_same_chunk(got_in.quantize(mode), ref_in.quantize(mode))
    with pytest.raises(ValueError, match="quantize mode"):
        got_in.quantize("w")


def test_affinity_map_from_segmentation_matches_jax():
    seg = _labels((4, 16, 16), np.uint32, seed=14, scale=1) // 8
    for inside, boundary in ((1.0, 0.0), (0.75, 0.25)):
        ref = JaxAffinityMap.from_segmentation(
            JaxChunk(seg, voxel_offset=OFFSET), inside, boundary)
        got = AffinityMap.from_segmentation(
            Chunk(seg, voxel_offset=OFFSET), inside, boundary)
        assert_same_chunk(got, ref)
    assert_same_chunk(AffinityMap.from_chunk(got),
                      JaxAffinityMap.from_chunk(ref))
    with pytest.raises(ValueError, match="4D"):
        AffinityMap(seg)


# ---------------------------------------------------------------------------
# Segmentation (reference: the JAX host leg, numpy / scipy.sparse)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
def test_segmentation_evaluate_matches_jax(payload):
    gt = _labels((4, 16, 16), np.uint32, seed=15, scale=1) // 4
    seg = gt.copy()
    seg[:, :8] = (seg[:, :8] + 3) % 11      # merges and splits
    seg[1:3, 4:12, 4:12] = 0
    ref = JaxSegmentation(seg).evaluate(JaxChunk(gt))
    got = Segmentation(_payload(seg, payload)).evaluate(Chunk(gt))
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-12, abs=0)
    assert Segmentation(seg).evaluate(gt) == JaxSegmentation(seg).evaluate(gt)
    empty = np.zeros_like(seg)
    assert Segmentation(empty).evaluate(gt) == \
        JaxSegmentation(empty).evaluate(gt)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
def test_segmentation_remapping_matches_jax(payload, dtype):
    arr = _labels((4, 16, 16), dtype, seed=16)
    ref_seg, got_seg = _chunks(JaxSegmentation, Segmentation, arr, payload)
    assert_same_chunk(got_seg.renumber(), ref_seg.renumber())
    assert_same_chunk(got_seg.renumber(start_id=5, base_id=1000),
                      ref_seg.renumber(start_id=5, base_id=1000))
    got, got_base = got_seg.remap(base_id=77)
    ref, ref_base = ref_seg.remap(base_id=77)
    assert_same_chunk(got, ref) and got_base == ref_base
    assert_same_chunk(got_seg.mask_fragments(60),
                      ref_seg.mask_fragments(60))
    keep = [int(v) for v in np.unique(arr)[2:9:2]]
    assert_same_chunk(got_seg.mask_except(keep), ref_seg.mask_except(keep))
    assert_same_chunk(Segmentation.from_chunk(Chunk(arr)),
                      JaxSegmentation.from_chunk(JaxChunk(arr)))


# ---------------------------------------------------------------------------
# ProbabilityMap (reference: the JAX host leg, scipy.ndimage)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("shape", [(4, 16, 16), (2, 4, 16, 16)])
def test_detect_points_matches_jax(payload, shape):
    arr = _rng(17).random(shape).astype(np.float32)
    ref_in, got_in = _chunks(JaxProbabilityMap, ProbabilityMap, arr, payload)
    for kwargs in (dict(min_distance=2), dict(min_distance=1,
                                              threshold_rel=0.8)):
        got_pts, got_conf = got_in.detect_points(**kwargs)
        ref_pts, ref_conf = ref_in.detect_points(**kwargs)
        assert got_pts.dtype == ref_pts.dtype
        assert np.array_equal(got_pts, ref_pts)
        assert got_conf.dtype == ref_conf.dtype
        assert np.array_equal(got_conf, ref_conf)
    assert_same_chunk(ProbabilityMap.from_chunk(got_in),
                      JaxProbabilityMap.from_chunk(ref_in))
