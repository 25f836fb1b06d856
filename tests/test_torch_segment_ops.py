"""The port's segmentation legs against the JAX package, on the CPU.

Connected components (the port's own build of the native union-find
against the JAX package's, bitwise; the plain scipy legs; the device
leg's label propagation, run in torch on the CPU, bitwise the JAX
``label_binary_device``), the mode and average pools and the pyramid,
the gaussian and median filters, the native renumber/remap, and the
commands ``connected-components``, ``downsample``, ``downsample-upload``,
``gaussian-filter``, ``load-precomputed --validate-mip`` and
``save-precomputed --create-thumbnail`` through both CLIs.

Tolerances: everything is bitwise except the gaussian's device leg,
where XLA's convolution sums the taps in an order of its own. On float32
it holds within n float32 ulp of the output's largest magnitude, n the
tap count (the bound of a sum of n terms in any order; measured on [0, 1]
data: 1.1 ulp at 5 taps, 4.5 at 57, 5.6 at 81). An integer output is at
most 1 away (a sum that lands on an exact integer truncates to either
side); measured: bitwise.
"""
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

from chunkflow_tpu import native as jax_native
from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.flow.runtime import new_task as jax_new_task
from chunkflow_tpu.ops import connected_components as jax_cc
from chunkflow_tpu.ops import downsample as jax_down
from chunkflow_tpu.ops import filters as jax_filters
from chunkflow_tpu.ops import remap as jax_remap
from chunkflow_tpu_torch import BoundingBox, Chunk, _build, native
from chunkflow_tpu_torch.flow.runtime import new_task
from chunkflow_tpu_torch.ops import connected_components as cc
from chunkflow_tpu_torch.ops import downsample as down
from chunkflow_tpu_torch.ops import filters, remap
from chunkflow_tpu_torch.segment.merge_table import labels_isomorphic
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
from tests.test_torch_chunk import assert_same_chunk
from tests.test_torch_cli_ops import jax_stage, port_stage

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

OFFSET, VSIZE = (2, 4, 6), (40, 4, 4)
SHAPE = (9, 21, 23)


def _binary(seed=0, p=0.55, shape=SHAPE):
    return np.random.default_rng(seed).random(shape) > p


def _multivalue(seed=0, shape=SHAPE, dtype=np.uint32):
    """Blobs of few values that touch (mixed mask components), ties of
    equal values across gaps, and isolated voxels."""
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 4, shape).astype(dtype)
    arr[:, 5:9] = 7
    arr[:, 9:11, ::3] = 0
    arr[2::4] = 0
    return arr


def _threshold_map(seed=0):
    return np.random.default_rng(seed).random(SHAPE).astype(np.float32)


INPUTS = {
    "binary-uint8": lambda: _binary().astype(np.uint8),
    "bool": lambda: _binary(1),
    "float-threshold": lambda: _threshold_map(2),
    "multivalue-uint32": lambda: _multivalue(3),
    "multivalue-uint64": lambda: _multivalue(4, dtype=np.uint64) << 33,
    "multivalue-uint8": lambda: _multivalue(5, dtype=np.uint8),
}


# ---------------------------------------------------------------------------
# the native build
# ---------------------------------------------------------------------------
def test_host_build_recipe():
    cmd = _build.gxx_command(_build.library_path(_build.HOST_LIBRARY))
    assert cmd[1:6] == ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    assert [os.path.basename(a) for a in cmd if a.endswith(".cpp")] == [
        "cc3d.cpp", "remap.cpp", "watershed.cpp", "surface_nets.cpp",
        "compressed_segmentation.cpp", "zstd.cpp", "blosc.cpp", "clahe.cpp",
        "crc32c.cpp"]
    # keyed by the sources' hash, under the git-ignored build/
    path = _build.library_path(_build.HOST_LIBRARY)
    assert path.parent == _build.BUILD_DIR and "libchunkflow_host-" in \
        path.name
    native.load()
    assert path.exists()
    # the sources ship with the package
    import tomllib

    config = tomllib.loads((_build.CSRC.parent.parent / "pyproject.toml")
                           .read_text())
    data = config["tool"]["setuptools"]["package-data"]["chunkflow_tpu_torch"]
    assert "csrc/host/*.cpp" in data and "csrc/host/*.h" in data


# host sources the port has and the JAX package has not: the precomputed
# codecs, the zstd and blosc decoders and the CRC-32C, which the JAX
# package leaves to tensorstore, and CLAHE, which it leaves to cv2
PORT_ONLY_SOURCES = ("compressed_segmentation.cpp", "zstd.cpp", "blosc.cpp",
                     "clahe.cpp", "crc32c.cpp")


def test_host_sources_are_the_jax_packages_copies():
    """The port compiles its own copies; the union-find and remap code is
    the JAX package's, line for line below the header comment. The
    port's own sources are no copies."""
    jax_src = os.path.join(os.path.dirname(jax_native.__file__), "src")
    for name in PORT_ONLY_SOURCES:
        assert name in _build.HOST_SOURCES
        assert not os.path.exists(os.path.join(jax_src, name))
    for name in _build.HOST_SOURCES + _build.HOST_HEADERS:
        if name in PORT_ONLY_SOURCES:
            continue
        ours = (_build.HOST / name).read_text().splitlines()
        with open(os.path.join(jax_src, name)) as f:
            theirs = f.read().splitlines()
        body = [i for i, line in enumerate(theirs)
                if not line.startswith("//")][0]
        assert ours[-(len(theirs) - body):] == theirs[body:], name


def test_a_failed_host_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "GXX_FLAGS", ("-this-flag-does-not-exist",))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="host C.. build failed"):
        _build.load(_build.HOST_LIBRARY)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        _build.gxx()


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_host_labels_are_the_jax_host_legs(name, connectivity):
    arr = INPUTS[name]()
    got = cc.connected_components(Chunk(arr, voxel_offset=OFFSET,
                                        voxel_size=VSIZE),
                                  threshold=0.6, connectivity=connectivity)
    ref = jax_cc.connected_components(
        JaxChunk(arr, voxel_offset=OFFSET, voxel_size=VSIZE), threshold=0.6,
        connectivity=connectivity)
    assert_same_chunk(got, ref)
    # the plain versions: scipy, bitwise on a binary input; the JAX
    # package's multi-value split numbers by value first (same partition)
    binary = arr > 0.6 if arr.dtype.kind == "f" else arr
    if arr.dtype.kind == "f" or arr.max() <= 1:
        plain = cc.label_binary_plain(binary != 0, connectivity)
        assert plain.dtype == np.uint32 and np.array_equal(plain, got.array)
    else:
        plain = cc.label_multivalue_plain(arr, connectivity)
        with mock.patch.object(jax_cc, "_native", lambda: None):
            ref_plain = jax_cc.label_multivalue(arr, connectivity)
        assert np.array_equal(plain, ref_plain)
        assert labels_isomorphic(plain, got.array)
        assert np.array_equal(plain, jax_cc._label_multivalue_loop(
            arr, connectivity))


@pytest.mark.parametrize("threads", ["1", "3", "8"])
def test_native_labels_do_not_depend_on_the_thread_count(monkeypatch,
                                                         threads):
    arr = _multivalue(6, shape=(16, 24, 20))
    monkeypatch.setenv("CHUNKFLOW_NATIVE_THREADS", threads)
    got, count = native.connected_components(arr, 18)
    monkeypatch.delenv("CHUNKFLOW_NATIVE_THREADS")
    ref, ref_count = jax_native.connected_components(arr, 18)
    assert count == ref_count and np.array_equal(got, ref)


def _jax_trip_count(binary, connectivity):
    """The JAX device leg's while_loop trip count, replayed in numpy."""
    offsets = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
               for dx in (-1, 0, 1) if (dz, dy, dx) != (0, 0, 0)
               and abs(dz) + abs(dy) + abs(dx) <= {6: 1, 18: 2, 26: 3}[
                   connectivity]]
    big = np.iinfo(np.uint32).max
    z, y, x = binary.shape
    labels = np.where(binary, np.arange(1, binary.size + 1).reshape(
        binary.shape), big).astype(np.uint32)
    trips = 0
    while True:
        trips += 1
        padded = np.pad(labels, 1, constant_values=big)
        best = labels.copy()
        for dz, dy, dx in offsets:
            best = np.minimum(best, padded[1 + dz:1 + dz + z,
                                           1 + dy:1 + dy + y,
                                           1 + dx:1 + dx + x])
        new = np.where(binary, best, big)
        if np.array_equal(new, labels):
            return trips
        labels = new


@pytest.mark.parametrize("connectivity", [6, 18, 26])
@pytest.mark.parametrize("shape, p", [(SHAPE, 0.45), ((1, 40, 3), 0.2),
                                      ((5, 6, 7), 1.0), ((33, 9, 8), 0.6)],
                         ids=["noise", "snake", "empty", "tall"])
def test_device_labels_are_the_jax_device_leg(connectivity, shape, p):
    binary = _binary(7, p=p, shape=shape)
    ref = np.asarray(jax_cc.label_binary_device(binary, connectivity))
    before = cc.sweeps
    got = cc.label_binary_device(torch.from_numpy(binary), connectivity)
    assert got.dtype == torch.uint32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), ref)
    assert cc.sweeps - before == _jax_trip_count(binary, connectivity)
    # a numpy input lands on ``device``
    assert np.array_equal(
        cc.label_binary_device(binary, connectivity, device="cpu").numpy(),
        ref)


@pytest.mark.parametrize("connectivity", [6, 26])
@pytest.mark.parametrize("name", ["binary-uint8", "bool", "float-threshold"])
@pytest.mark.parametrize("payload", ["host", "cpu-tensor"])
def test_device_leg_of_a_chunk_is_the_jax_device_leg(name, connectivity,
                                                     payload):
    arr = INPUTS[name]()
    data = arr if payload == "host" else torch.from_numpy(arr)
    got = Chunk(data, voxel_offset=OFFSET, voxel_size=VSIZE)\
        .connected_component(threshold=0.4, connectivity=connectivity,
                             device="cpu")
    ref = JaxChunk(arr, voxel_offset=OFFSET, voxel_size=VSIZE)\
        .connected_component(threshold=0.4, connectivity=connectivity,
                             device=True)
    assert isinstance(got.array, torch.Tensor)
    assert_same_chunk(got, JaxChunk(np.asarray(ref.array),
                                    voxel_offset=ref.voxel_offset,
                                    voxel_size=ref.voxel_size,
                                    layer_type="segmentation"))
    host = Chunk(arr).connected_component(threshold=0.4,
                                          connectivity=connectivity)
    assert labels_isomorphic(got.array.numpy(), host.array)


def test_device_leg_refuses_what_the_jax_one_refuses():
    with pytest.raises(ValueError, match="binary"):
        cc.connected_components(Chunk(_multivalue(8)), device="cpu")
    with pytest.raises(ValueError, match="single-channel"):
        cc.connected_components(Chunk(np.zeros((2, 3, 4, 5), np.float32)),
                                device="cpu")
    with pytest.raises(ValueError, match="connectivity"):
        cc.label_binary_device(torch.zeros(2, 2, 2, dtype=torch.bool), 8)
    # 2^32 voxels: the guard fires before anything is allocated
    huge = torch.zeros((), dtype=torch.bool).expand(2 ** 16, 2 ** 16, 1)
    with pytest.raises(ValueError, match="uint32 seeds"):
        cc.label_binary_device(huge)


# ---------------------------------------------------------------------------
# pools and the pyramid
# ---------------------------------------------------------------------------
FACTORS = [(1, 2, 2), (2, 2, 2), (1, 3, 3), (2, 3, 2)]


def _seg(dtype, seed=9, shape=(2, 8, 19, 17)):
    """Three labels, so most windows hold ties; 32- and 64-bit labels
    above 2^(bits-2), where a signed view is negative."""
    arr = np.random.default_rng(seed).integers(0, 3, shape).astype(dtype)
    if np.dtype(dtype).itemsize >= 4:
        arr = arr * np.array(2 ** (8 * np.dtype(dtype).itemsize - 2) + 7,
                             dtype=dtype)
    return arr


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("dtype", ["uint8", "uint32", "uint64", "int64"])
@pytest.mark.parametrize("ndim", [3, 4])
def test_mode_pool_is_the_jax_packages(factor, dtype, ndim):
    arr = _seg(dtype)
    if ndim == 3:
        arr = arr[0]
    ref = jax_down.downsample(JaxChunk(arr, voxel_offset=OFFSET,
                                       voxel_size=VSIZE,
                                       layer_type="segmentation"), factor)
    for data in (arr, torch.from_numpy(arr)):
        got = down.downsample(Chunk(data, voxel_offset=OFFSET,
                                    voxel_size=VSIZE,
                                    layer_type="segmentation"), factor)
        assert_same_chunk(got, ref)
    # the host leg and the torch leg of the pool itself
    z, y, x = (s // f * f for s, f in zip(arr.shape[-3:], factor))
    trimmed = (arr if ndim == 4 else arr[None])[:, :z, :y, :x]
    from chunkflow_tpu_torch.core.cartesian import Cartesian

    f = Cartesian(*factor)
    assert np.array_equal(
        down.mode_pool_device(torch.from_numpy(trimmed), f).numpy(),
        down.mode_pool_numpy(trimmed, f))


def test_mode_pool_ties_go_to_the_first_corner():
    arr = np.array([[[5, 9], [9, 5]]], dtype=np.uint32)  # 2-2 tie
    got = down.downsample_mode(Chunk(arr, layer_type="segmentation"))
    assert got.array.tolist() == [[[5]]]
    arr = np.array([[[1, 2], [3, 4]]], dtype=np.uint64)  # all differ
    got = down.downsample_mode(Chunk(torch.from_numpy(arr),
                                     layer_type="segmentation"))
    assert got.array.tolist() == [[[1]]]


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int16", "float32"])
@pytest.mark.parametrize("shape", [(3, 9, 26, 31), (8, 32, 48)])
def test_average_pool_is_the_jax_packages(factor, dtype, shape):
    """Bitwise on integers (their window sums are exact in float32). On
    float32 the port sums each window in z-major order, one add each, as
    XLA's CPU reduce_window does where it does not vectorize (the first
    shape); where it does (an output row a multiple of 8, the second) it
    adds in pairs: within (window size) float32 ulp of the largest
    input (measured: 1 ulp)."""
    rng = np.random.default_rng(10)
    if dtype == "float32":
        arr = (rng.standard_normal(shape) * 100).astype(np.float32)
    else:
        info = np.iinfo(dtype)
        arr = rng.integers(info.min, info.max, shape, endpoint=True,
                           dtype=dtype)
    ref = jax_down.downsample(JaxChunk(arr, voxel_offset=OFFSET,
                                       voxel_size=VSIZE), factor)
    for data in (arr, torch.from_numpy(arr)):
        got = down.downsample(Chunk(data, voxel_offset=OFFSET,
                                    voxel_size=VSIZE), factor)
        if dtype != "float32":
            assert_same_chunk(got, ref)
            continue
        have, want = np.asarray(got.array), np.asarray(ref.array)
        assert have.dtype == want.dtype and have.shape == want.shape
        assert tuple(got.voxel_offset) == tuple(ref.voxel_offset)
        assert tuple(got.voxel_size) == tuple(ref.voxel_size)
        tol = np.prod(factor) * np.finfo(np.float32).eps * np.abs(arr).max()
        assert np.abs(have - want).max() <= tol


def test_average_pool_of_bfloat16_stays_bfloat16():
    arr = torch.from_numpy(np.random.default_rng(11).random(
        (4, 8, 8)).astype(np.float32)).to(torch.bfloat16)
    got = down.downsample_average(Chunk(arr))
    want = down.downsample_average(Chunk(arr.to(torch.float32).numpy()))
    assert got.array.dtype == torch.bfloat16
    assert torch.equal(got.array, torch.from_numpy(want.array).to(
        torch.bfloat16))


@pytest.mark.parametrize("layer", ["image", "segmentation"])
def test_pyramid_is_the_jax_packages(layer):
    arr = (_seg("uint32")[0] if layer == "segmentation"
           else np.random.default_rng(12).integers(
               0, 256, (8, 19, 17)).astype(np.uint8))
    ref = jax_down.pyramid(JaxChunk(arr, voxel_offset=(2, 8, 8),
                                    voxel_size=VSIZE, layer_type=layer),
                           num_mips=3)
    got = down.pyramid(Chunk(arr, voxel_offset=(2, 8, 8), voxel_size=VSIZE,
                             layer_type=layer), num_mips=3)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert_same_chunk(g, r)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------
def _image(dtype, seed=13, shape=(4, 23, 27)):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.random(shape).astype(np.float32)
    return rng.integers(0, np.iinfo(dtype).max, shape,
                        endpoint=True).astype(dtype)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_gaussian_host_leg_is_the_jax_host_leg(sigma, dtype):
    arr = _image(dtype)
    for a in (arr, arr[None]):
        got = filters.gaussian_filter_2d(Chunk(a, voxel_offset=OFFSET),
                                         sigma)
        ref = jax_filters.gaussian_filter_2d(JaxChunk(a, voxel_offset=OFFSET),
                                             sigma)
        assert_same_chunk(got, ref)


@pytest.mark.parametrize("sigma", [0.5, 1.0, 2.5, 7.0])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_gaussian_device_leg_holds_to_the_jax_device_leg(sigma, dtype):
    """The torch leg against the JAX device leg (``jnp.convolve``), each
    on the CPU, within the tolerance the module docstring states."""
    import jax.numpy as jnp

    arr = _image(dtype, shape=(3, 2, 40, 37))
    got = filters.gaussian_filter_2d(Chunk(torch.from_numpy(arr)), sigma)
    ref = np.asarray(jax_filters.gaussian_filter_2d(
        JaxChunk(jnp.asarray(arr)), sigma).array)
    have = got.array.numpy()
    assert have.dtype == ref.dtype and have.shape == ref.shape
    diff = np.abs(have.astype(np.float64) - ref.astype(np.float64))
    taps = len(filters.gaussian_taps(sigma))
    if dtype == "float32":
        tol = taps * np.finfo(np.float32).eps * float(np.abs(ref).max())
        assert diff.max() <= tol
    else:
        assert diff.max() <= 1
    # a radius wider than the section reflects as numpy's "symmetric"
    small = _image("float32", shape=(2, 3, 4))
    got = filters.gaussian_filter_2d(Chunk(torch.from_numpy(small)), 2.0)
    ref = np.asarray(jax_filters.gaussian_filter_2d(
        JaxChunk(jnp.asarray(small)), 2.0).array)
    assert np.abs(got.array.numpy() - ref).max() <= \
        len(filters.gaussian_taps(2.0)) * np.finfo(np.float32).eps


@pytest.mark.parametrize("size", [3, 5])
def test_median_filter_is_the_jax_packages(size):
    for arr in (_image("uint8"), _image("float32")[None]):
        got = filters.median_filter(Chunk(torch.from_numpy(arr)), size)
        ref = jax_filters.median_filter(JaxChunk(arr), size)
        assert_same_chunk(got, ref)


# ---------------------------------------------------------------------------
# native renumber / remap
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["uint32", "uint64"])
def test_native_renumber_and_remap_are_the_jax_packages(dtype):
    rng = np.random.default_rng(14)
    arr = (rng.integers(0, 5000, (64, 128, 130)) * 3).astype(dtype)
    assert arr.size >= remap._NATIVE_MIN_SIZE  # the native leg runs
    got, mapping = remap.renumber(arr, start_id=5)
    ref, ref_mapping = jax_remap.renumber(arr, start_id=5)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert mapping == ref_mapping
    # the numpy leg gives the same (first-appearance order)
    with mock.patch.object(remap, "_NATIVE_MIN_SIZE", arr.size + 1):
        plain, plain_mapping = remap.renumber(arr, start_id=5)
    assert np.array_equal(plain, got) and plain_mapping == mapping
    table = {int(k): int(k) // 3 + 1 for k in rng.choice(
        np.unique(arr), 700, replace=False)}
    for keep in (True, False):
        got = remap.remap(arr, table, preserve_missing=keep)
        ref = jax_remap.remap(arr, table, preserve_missing=keep)
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
        with mock.patch.object(remap, "_NATIVE_MIN_SIZE", arr.size + 1):
            assert np.array_equal(remap.remap(arr, table,
                                              preserve_missing=keep), got)


def test_native_remap_refuses_a_value_that_does_not_fit():
    arr = np.ones((128, 128, 64), np.uint32)
    with pytest.raises(OverflowError):
        remap.remap(arr, {1: 2 ** 40})


# ---------------------------------------------------------------------------
# the commands through both CLIs
# ---------------------------------------------------------------------------
def _tasks(arr, offset=OFFSET, **meta):
    meta = dict(dict(voxel_offset=offset, voxel_size=VSIZE), **meta)
    jax_task, port_task = jax_new_task(), new_task()
    jax_task["chunk"] = JaxChunk(arr.copy(), **meta)
    port_task["chunk"] = Chunk(arr.copy(), **meta)
    return jax_task, port_task


def _run_both(args, arr, **meta):
    """(port task, JAX task) after one command of each CLI."""
    jax_task, port_task = _tasks(arr, **meta)
    ref = list(jax_stage(args)(iter([jax_task])))[0]
    got = list(port_stage(args)(iter([port_task])))[0]
    return got, ref


COMMANDS = {
    "connected-components": (["connected-components"], "float"),
    "connected-components-6": (["connected-components", "-c", "6", "-t",
                                "0.3", "-o", "seg"], "float"),
    "connected-components-multivalue": (["connected-components", "-c", "18"],
                                        "multivalue"),
    "connected-components-binary-host": (["connected-components", "--host"],
                                         "binary"),
    "downsample-image": (["downsample"], "uint8"),
    "downsample-segmentation": (["downsample", "-f", "2", "2", "2", "-o",
                                 "down"], "segmentation"),
    "downsample-affinity": (["downsample", "--factor", "1", "3", "3"],
                            "affinity"),
    "gaussian-filter": (["gaussian-filter"], "uint8"),
    "gaussian-filter-sigma": (["gaussian-filter", "-s", "2.5", "-i", "chunk",
                               "-o", "blur"], "float"),
}


def _input(kind):
    if kind == "float":
        return _threshold_map(15), {}
    if kind == "multivalue":
        return _multivalue(16), {"layer_type": "segmentation"}
    if kind == "binary":
        return _binary(17).astype(np.uint8), {}
    if kind == "segmentation":
        return _seg("uint32")[0], {"layer_type": "segmentation"}
    if kind == "affinity":
        return np.random.default_rng(18).random((3, 4, 12, 15)).astype(
            np.float32), {}
    return _image("uint8"), {}


@pytest.mark.parametrize("name", sorted(COMMANDS))
def test_command_matches_the_jax_cli(name):
    args, kind = COMMANDS[name]
    arr, meta = _input(kind)
    got, ref = _run_both(args, arr, **meta)
    out = args[args.index("-o") + 1] if "-o" in args else "chunk"
    assert_same_chunk(got[out], ref[out])


@pytest.mark.parametrize("connectivity", ["6", "18", "26"])
def test_connected_components_device_matches_the_jax_cli(connectivity):
    """``--device`` labels a host chunk on the group ``--device`` (here
    the CPU), as the JAX CLI labels it on its default device."""
    got, ref = _run_both(["connected-components", "--device", "-c",
                          connectivity, "-t", "0.45"], _threshold_map(19))
    assert isinstance(got["chunk"].array, torch.Tensor)
    ref_chunk = ref["chunk"]
    assert_same_chunk(got["chunk"], JaxChunk(
        np.asarray(ref_chunk.array), voxel_offset=ref_chunk.voxel_offset,
        voxel_size=ref_chunk.voxel_size, layer_type="segmentation"))


# a volume origin on every mip's grid (mip 3 is 1 x 8 x 8 of mip 0)
ALIGNED = (2, 8, 16)


def _volume(path, arr, mips=4, layer="image", dtype="uint8"):
    PrecomputedVolume.create(str(path), volume_size=arr.shape[-3:],
                             voxel_size=VSIZE, voxel_offset=ALIGNED,
                             dtype=dtype, layer_type=layer,
                             block_size=(4, 8, 8), num_mips=mips)
    vol = PrecomputedVolume(str(path))
    vol.save(Chunk(arr, voxel_offset=ALIGNED, voxel_size=VSIZE))
    return vol


def _blocks(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f == "info" or "log" in d:
                continue
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


@pytest.mark.parametrize("layer", ["image", "segmentation"])
@pytest.mark.parametrize("extra", [[], ["--start-mip", "2"],
                                   ["--stop-mip", "3", "-f", "1", "2", "2"]],
                         ids=["all", "start-2", "stop-3"])
def test_downsample_upload_writes_the_jax_clis_blocks(tmp_path, layer,
                                                      extra):
    pytest.importorskip("tensorstore")
    dtype = "uint32" if layer == "segmentation" else "uint8"
    arr = (_seg("uint32", shape=(1, 8, 32, 32))[0] if layer == "segmentation"
           else _image("uint8", shape=(8, 32, 32)))
    _volume(tmp_path / "port", arr, layer=layer, dtype=dtype)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    for tag in ("jax", "port"):
        args = ["downsample-upload", "-v", str(tmp_path / tag), *extra]
        jax_task, port_task = _tasks(arr, offset=ALIGNED, layer_type=layer)
        if tag == "jax":
            list(jax_stage(args)(iter([jax_task])))
        else:
            list(port_stage(args)(iter([port_task])))
    assert _blocks(tmp_path / "port") == _blocks(tmp_path / "jax")
    assert len(_blocks(tmp_path / "port")) > len(_blocks(tmp_path / "port"
                                                          / "40_4_4"))


def test_downsample_upload_refuses_a_start_below_the_chunk():
    with pytest.raises(Exception, match="start-mip"):
        list(port_stage(["downsample-upload", "-v", "unused", "--start-mip",
                         "0"])(iter([_tasks(_image("uint8"))[1]])))


@pytest.mark.parametrize("case", ["consistent", "corrupt", "offset-window",
                                  "too-coarse"])
def test_validate_mip_passes_and_fails_as_in_the_jax_cli(tmp_path, case):
    """``--validate-mip`` holds the cutout, mean-pooled, against the coarse
    mip; both CLIs accept and refuse the same volumes."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox

    arr = _image("uint8", shape=(8, 32, 32))
    vol = _volume(tmp_path / "v", arr, mips=3)
    chunk = Chunk(arr, voxel_offset=ALIGNED, voxel_size=VSIZE)
    for level, pooled in enumerate(down.pyramid(chunk, num_mips=2),
                                   start=1):
        vol.save(pooled, mip=level)
    if case == "corrupt":
        vol.save(Chunk(np.zeros((8, 8, 8), np.uint8),
                       voxel_offset=(ALIGNED[0], 2, 4)), mip=2)
    box = {"offset-window": ((3, 9, 19), (9, 39, 47))}.get(
        case, (ALIGNED, tuple(o + s for o, s in zip(ALIGNED, arr.shape))))
    mip = "3" if case == "too-coarse" else "2"
    args = ["load-precomputed", "-v", str(tmp_path / "v"), "--validate-mip",
            mip]
    outcomes = []
    for stage, task, box_cls in ((jax_stage, jax_new_task(), JaxBox),
                                 (port_stage, new_task(), BoundingBox)):
        task["bbox"] = box_cls(*box)
        try:
            list(stage(args)(iter([task])))
            outcomes.append("passed")
        except ValueError as exc:
            outcomes.append(str(exc).split(":")[0])
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] == "passed") == (case in ("consistent",
                                                  "offset-window"))


@pytest.mark.parametrize("layer", ["image", "segmentation"])
def test_create_thumbnail_writes_the_jax_clis_blocks(tmp_path, layer):
    pytest.importorskip("tensorstore")
    if layer == "segmentation":
        arr, dtype = _seg("uint32", shape=(1, 8, 32, 32))[0], "uint32"
    else:
        arr, dtype = _image("uint8", shape=(8, 32, 32)), "uint8"
    PrecomputedVolume.create(str(tmp_path / "port"), volume_size=(8, 32, 32),
                             voxel_size=VSIZE, voxel_offset=ALIGNED,
                             dtype=dtype, block_size=(4, 8, 8), num_mips=3,
                             layer_type=("segmentation"
                                         if layer == "segmentation"
                                         else "image"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    meta = {"layer_type": "segmentation"} if layer == "segmentation" else {}
    jax_task, port_task = _tasks(arr, offset=ALIGNED, **meta)
    for tag, stage, task in (("jax", jax_stage, jax_task),
                             ("port", port_stage, port_task)):
        list(stage(["save-precomputed", "-v", str(tmp_path / tag),
                    "--create-thumbnail", "--no-upload-log"])(iter([task])))
    assert _blocks(tmp_path / "port") == _blocks(tmp_path / "jax")
    mips = {k.split(os.sep)[0] for k in _blocks(tmp_path / "port")}
    assert len(mips) == 3
