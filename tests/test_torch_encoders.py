"""The port's zstd and LZ4 encoders (``csrc/host/zstd.cpp``
``cf_zstd_compress``, ``csrc/host/blosc.cpp`` ``cf_lz4_compress``, and
their plain Python twins ``volume/zstd.py:compress_plain``,
``volume/blosc.py:lz4_compress_plain``) against ``zstandard`` and
tensorstore on the CPU.

Every zstd frame the port writes (random bytes, runs, zeros, empty input,
one byte, just over a 128 KB block, three blocks of which one is RLE and
one raw; levels -5, 1, 3, 9 and 19) is the plain twin's bytes and
decodes bitwise through ``zstandard``, the C++ decoder and the plain
decoder; a chunk the port writes into a tensorstore-made zstd store reads
in tensorstore. The frames are at most 1.25 times ``zstandard``'s size at
levels 1 and 3 on three fixtures: a uint8 affinity chunk of the seeded
parity UNet3D, the uint64 connected components of its threshold, and the
float32 leaves of ``tests/data/orbax_parity_seed0``. The LZ4 blocks are
the plain twin's bytes and decode through both LZ4 decoders; a blosc
store of each cname that the port writes holds frames of the cname's
codec and reads in tensorstore; its blosc-lz4 frames are at most 1.25
times tensorstore's own blosc-lz4 chunk of the same data (no LZ4 package
is installed here to compare with). ``save-zarr`` into a tensorstore-made
zstd store and a blosc-lz4 store runs in both CLIs on one chunk, and each
package reads the other's store equal.
"""
import functools
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chunkflow_tpu_torch import native
from chunkflow_tpu_torch.volume import blosc, zstd
from chunkflow_tpu_torch.volume.zarr import ZarrArray

zstandard = pytest.importorskip("zstandard")
ts = pytest.importorskip("tensorstore")

torch.set_num_threads(1)

LEVELS = [-5, 1, 3, 9, 19]
BLOCK = zstd.MAX_BLOCK


def _periodic(size, period, noise, seed):
    """A ramp of ``period`` with ``noise`` bytes set to 7: matches at
    several offsets, broken at random."""
    rng = np.random.default_rng(seed)
    data = (np.arange(size) % period).astype(np.uint8)
    data[rng.integers(0, size, noise)] = 7
    return data.tobytes()


def _three_blocks():
    rng = np.random.default_rng(3)
    return (_periodic(BLOCK, 251, 400, 1) + bytes(BLOCK)
            + rng.integers(0, 256, BLOCK, dtype=np.uint8).tobytes()
            + b"tail123")


_RNG = np.random.default_rng(21)
INPUTS = {
    "random": _RNG.integers(0, 256, 3000, dtype=np.uint8).tobytes(),
    "runs": b"".join(bytes([i % 7]) * (i % 50 + 1) for i in range(400)),
    "zeros": bytes(5000),
    "empty": b"",
    "one-byte": b"\x2a",
    "over-a-block": _periodic(BLOCK + 4099, 97, 300, 2),
    "three-blocks": _three_blocks(),
    "float32": _RNG.normal(size=900).astype(np.float32).tobytes(),
    "text": b" ".join(_RNG.choice([b"alpha", b"beta", b"gamma", b"delta",
                                   b"x" * 7, b"zz"], 700).tolist()),
}


def _blocks(frame):
    """The kinds of the blocks of one frame (0 raw, 1 RLE, 2
    compressed)."""
    kinds, pos = [], zstd._frame_header(frame, 0)[1]
    while True:
        header = int.from_bytes(frame[pos:pos + 3], "little")
        kinds.append((header >> 1) & 3)
        pos += 3 + (1 if (header >> 1) & 3 == 1 else header >> 3)
        if header & 1:
            return kinds


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", LEVELS)
def test_every_frame_is_the_plain_twins_and_decodes_everywhere(level, name):
    data = INPUTS[name]
    frame = zstd.compress(data, level)
    assert frame == zstd.compress_plain(data, level)
    assert zstd.content_size(frame) == len(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert native.zstd_decompress(frame, len(data)) == data
    assert zstd.decompress_plain(frame) == data
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(data) and params.has_checksum
    if name == "three-blocks":
        assert _blocks(frame) == [2, 1, 0, 0]
    if name in ("over-a-block", "runs", "text"):
        assert 2 in _blocks(frame) and len(frame) < len(data) // 2


def test_the_window_bounds_every_match():
    """A frame larger than the level's window states the window, which
    ``zstandard``'s default limit (2**27) takes; a smaller one is a single
    segment as large as its content."""
    data = _periodic(3 * (1 << 19) + 11, 4093, 2000, 4)
    for level, window in ((1, 1 << 19), (3, 1 << 21), (19, 1 << 23)):
        frame = zstd.compress(data, level)
        params = zstandard.get_frame_parameters(frame)
        single = len(data) <= window
        assert params.window_size == (len(data) if single else window)
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        assert zstd.decompress(frame) == data


def test_a_full_output_raises_naming_its_code():
    lib = native.load()
    data = INPUTS["text"]
    out = np.empty(16, dtype=np.uint8)
    code = lib.cf_zstd_compress(data, len(data), 3, out.ctypes.data, 16)
    assert code < 0
    assert b"larger than the output" in lib.cf_zstd_error(code)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.binary(min_size=1, max_size=24),
                          st.integers(1, 40)), max_size=30),
       st.sampled_from(LEVELS))
def test_repeated_pieces_round_trip(pieces, level):
    data = b"".join(piece * count for piece, count in pieces)
    frame = zstd.compress(data, level)
    assert frame == zstd.compress_plain(data, level)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    block = native.lz4_compress(data)
    assert block == blosc.lz4_compress_plain(data)
    assert blosc._lz4(block, len(data)) == data


# ---------------------------------------------------------------------------
# the stores
# ---------------------------------------------------------------------------
def _array(shape, seed, dtype="uint16"):
    rng = np.random.default_rng(seed)
    ramp = np.arange(int(np.prod(shape))).reshape(shape) // 5 % 300
    return (ramp + rng.integers(0, 4, shape)).astype(dtype)


def _ts_zarr(path, arr, compressor, chunks=None):
    store = ts.open({"driver": "zarr",
                     "kvstore": {"driver": "file", "path": str(path)},
                     "metadata": {"chunks": list(chunks or arr.shape),
                                  "compressor": compressor}},
                    create=True, dtype=arr.dtype.name,
                    shape=arr.shape).result()
    store[...] = arr
    return store


@pytest.mark.parametrize("level", LEVELS)
def test_a_zstd_store_the_port_writes_reads_in_tensorstore(tmp_path, level):
    arr = _array((6, 20, 30), seed=level + 10)
    store = _ts_zarr(tmp_path, arr, {"id": "zstd", "level": level},
                     chunks=(3, 10, 30))
    part = _array((4, 7, 9), seed=3)
    port = ZarrArray(str(tmp_path))
    port.write((slice(1, 5), slice(2, 9), slice(10, 19)), part)
    arr[1:5, 2:9, 10:19] = part
    assert np.array_equal(store.read().result(), arr)
    assert np.array_equal(ts.open(store.spec()).result().read().result(),
                          arr)
    assert np.array_equal(ZarrArray(str(tmp_path)).read(), arr)
    frame = (tmp_path / "0.0.0").read_bytes()
    assert frame == zstd.compress_plain(arr[:3, :10].tobytes(), level)
    assert zstandard.ZstdDecompressor().decompress(frame) == \
        arr[:3, :10].tobytes()


@pytest.mark.parametrize("cname", sorted(blosc.WRITES))
def test_a_blosc_store_gets_frames_of_its_cname(tmp_path, cname):
    """Frames of the codec ``blosc.WRITES`` gives the cname (each its own
    codec; ``lz4hc`` LZ4's), read by tensorstore and both decoders."""
    arr = _array((5, 40, 61), seed=len(cname))
    store = _ts_zarr(tmp_path, np.zeros_like(arr), {
        "id": "blosc", "cname": cname, "clevel": 5, "shuffle": 1,
        "blocksize": 0})
    ZarrArray(str(tmp_path)).write(None, arr)
    assert np.array_equal(store.read().result(), arr)
    frame = (tmp_path / "0.0.0").read_bytes()
    assert frame[2] >> 5 == blosc.WRITES[cname]
    assert frame[2] & 0x1F == 0x11  # one stream a block, byte shuffle
    assert len(frame) < 0.75 * arr.nbytes
    assert blosc.decompress(frame) == blosc.decompress_plain(frame) == \
        arr.tobytes()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_lz4_blocks_are_the_plain_twins_and_decode(name):
    data = INPUTS[name]
    block = native.lz4_compress(data)
    assert block == blosc.lz4_compress_plain(data)
    assert blosc._lz4(block, len(data)) == data
    # the end-of-block rules: the last five bytes are literals
    if len(data) >= 13:
        assert block[-5:] == data[-5:]


# ---------------------------------------------------------------------------
# sizes against the reference libraries
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1)
def size_fixtures():
    """The three fixtures of the size bounds, as arrays."""
    from chunkflow_tpu_torch.models import orbax
    from chunkflow_tpu_torch.models.unet3d import UNet3D, seeded_init
    from tests.test_torch_orbax import FIXTURE

    model = seeded_init(UNet3D(in_channels=1, out_channels=3),
                        torch.Generator().manual_seed(0)).eval()
    image = np.random.default_rng(0).random((1, 1, 8, 64, 64),
                                            dtype=np.float32)
    with torch.no_grad():
        aff = model(torch.from_numpy(image))[0].numpy()
    seg, _ = native.connected_components((aff[0] > 0.5).astype(np.uint8), 6)
    leaves = []

    def walk(tree):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                walk(tree[key])
            else:
                leaves.append(np.asarray(tree[key], np.float32).ravel())

    walk(orbax.load_params(str(FIXTURE)))
    return {"affinity": np.round(aff * 255).astype(np.uint8),
            "segmentation": seg.astype(np.uint64),
            "leaves": np.concatenate(leaves)}


@pytest.mark.parametrize("level", [1, 3])
@pytest.mark.parametrize("name", ["affinity", "segmentation", "leaves"])
def test_zstd_frames_within_a_quarter_of_zstandards(name, level):
    data = size_fixtures()[name].tobytes()
    ours = zstd.compress(data, level)
    ref = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(ours) == data
    assert len(ours) <= 1.25 * len(ref), (len(ours), len(ref))


@pytest.mark.parametrize("name", ["affinity", "segmentation", "leaves"])
def test_lz4_frames_within_a_quarter_of_tensorstores(tmp_path, name):
    arr = size_fixtures()[name]
    blosc_lz4 = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                 "blocksize": 0}
    _ts_zarr(tmp_path / "ts", arr, blosc_lz4)
    store = _ts_zarr(tmp_path / "port", np.zeros_like(arr), blosc_lz4)
    ZarrArray(str(tmp_path / "port")).write(None, arr)
    assert np.array_equal(store.read().result(), arr)
    key = ".".join("0" * arr.ndim)
    ours = (tmp_path / "port" / key).read_bytes()
    ref = (tmp_path / "ts" / key).read_bytes()
    assert ours[2] >> 5 == ref[2] >> 5 == 1  # both lz4
    assert len(ours) <= 1.25 * len(ref), (len(ours), len(ref))


# ---------------------------------------------------------------------------
# save-zarr in both CLIs
# ---------------------------------------------------------------------------
STORES = {"zstd": {"id": "zstd", "level": 1},
          "blosc-lz4": {"id": "blosc", "cname": "lz4", "clevel": 5,
                        "shuffle": -1, "blocksize": 0}}


@pytest.mark.parametrize("kind", sorted(STORES))
def test_save_zarr_into_a_tensorstore_store_in_both_clis(tmp_path, kind):
    """Each CLI's ``save-zarr`` of one float32 zyx chunk into a store
    tensorstore made, then each package's ``load-zarr`` of the other's
    store: equal to the chunk."""
    from chunkflow_tpu.chunk.base import Chunk as JaxChunk
    from chunkflow_tpu.flow.runtime import new_task as jax_new_task
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.flow.runtime import new_task
    from tests.test_torch_cli_ops import jax_stage, port_stage

    values = np.random.default_rng(8).random((6, 24, 40), dtype=np.float32)
    paths = {pkg: tmp_path / pkg for pkg in ("jax", "port")}
    for path in paths.values():
        _ts_zarr(path, np.zeros_like(values), STORES[kind],
                 chunks=(4, 16, 16))
    jax_task, port_task = jax_new_task(), new_task()
    jax_task["chunk"] = JaxChunk(values.copy())
    port_task["chunk"] = Chunk(values.copy())
    list(jax_stage(["save-zarr", "-p", str(paths["jax"])])(iter([jax_task])))
    list(port_stage(["save-zarr", "-p", str(paths["port"])])(
        iter([port_task])))
    meta = json.loads((paths["port"] / ".zarray").read_text())
    assert meta["compressor"]["id"] == STORES[kind]["id"]
    frame = (paths["port"] / "0.0.0").read_bytes()
    if kind == "zstd":
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
    else:
        assert frame[2] >> 5 == 1
    got_jax = list(jax_stage(["load-zarr", "-p", str(paths["port"])])(
        iter([jax_new_task()])))[0]["chunk"]
    got_port = list(port_stage(["load-zarr", "-p", str(paths["jax"])])(
        iter([new_task()])))[0]["chunk"]
    assert np.array_equal(np.asarray(got_jax.array), values)
    assert np.array_equal(np.asarray(got_port.array), values)
