"""The zarr stores the port creates and the blosc frames it writes,
against tensorstore 0.1.80 and the JAX package on the CPU.

* A store the port creates (``ZarrArray.create``; ``save-zarr`` into a
  path with no store) has the ``.zarray`` tensorstore creates for the
  same dtype and shape, ``json.loads`` equal and byte for byte: 24 shapes
  of ranks 3 and 4 over uint8, uint16, uint32, uint64, float32 and
  bfloat16, with and without chunks given. Through both CLIs'
  ``save-zarr`` (a chunk at an offset, ``--volume-size``,
  ``--chunk-size``, ``--dtype bfloat16``) the two stores' metadata are
  equal and each package's ``load-zarr`` reads both stores bitwise.
* A write into a blosc store of every cname (``blosclz``, ``lz4``,
  ``lz4hc``, ``snappy``, ``zlib``, ``zstd``) and shuffle (0, 1, 2, -1)
  for each of those dtypes reads bitwise in tensorstore, with the
  cname's codec and the shuffle's bits in each frame's flags; what
  tensorstore writes there reads bitwise in the port. Chunks of 105
  elements (a bit shuffle leaves them as c-blosc does) and 320.
* The blosclz and snappy encoders, the hash-chain LZ4 of ``lz4hc`` and
  the bit shuffle (host C++) give their plain twins' bytes, and decode
  through both decoders; their frames are at most 1.25 times
  tensorstore's on the three size fixtures of
  ``tests/test_torch_encoders.py`` (``python -m
  tests.test_torch_zarr_writes`` prints every cname's and shuffle's
  ratio).
"""
import json

import numpy as np
import pytest
import torch

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.flow.runtime import new_task as jax_new_task
from chunkflow_tpu_torch import Chunk, native
from chunkflow_tpu_torch.flow.runtime import new_task
from chunkflow_tpu_torch.volume import blosc
from chunkflow_tpu_torch.volume.zarr import (
    DEFAULT_COMPRESSOR,
    ZarrArray,
    bfloat16_bits,
    default_chunks,
)
from tests.test_torch_chunk import assert_same_chunk
from tests.test_torch_cli_ops import jax_stage, port_stage
from tests.test_torch_encoders import INPUTS, size_fixtures

ts = pytest.importorskip("tensorstore")
ml_dtypes = pytest.importorskip("ml_dtypes")

torch.set_num_threads(1)

DTYPES = ["uint8", "uint16", "uint32", "uint64", "float32", "bfloat16"]
CNAMES = ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"]
SHUFFLES = [0, 1, 2, -1]

# (shape, chunks given or None), ranks 3 and 4, each created in every
# dtype of DTYPES in turn
SHAPES = [
    ((64, 512, 512), None), ((3, 64, 512, 512), None),
    ((3, 200, 300, 400), None), ((20, 100, 100), None),
    ((20, 1000, 1000), None), ((1000, 1000, 1000), None),
    ((7, 3000, 11), None), ((5, 12, 14), None), ((4, 4096, 4096, 4096), None),
    ((64, 64, 64, 64), None), ((1, 1, 1), None), ((0, 5, 5), None),
    ((2, 2, 2, 1048576), None), ((16, 16, 4096), None),
    ((101, 102, 103), None), ((1, 1024, 1024), None),
    ((64, 512, 512), (16, 128, 128)), ((12, 16, 20), (4, 8, 8)),
    ((3, 64, 512, 512), (1, 32, 256, 256)), ((5, 12, 14), (5, 12, 14)),
    ((3, 8, 9, 10), (3, 8, 9, 10)), ((2, 30, 30, 30), None),
    ((9, 9, 9, 9), (2, 3, 4, 5)), ((128, 128, 128), (64, 64, 64)),
]


def _ts_create(path, dtype, shape, chunks=None, compressor=None):
    spec = {"driver": "zarr", "kvstore": {"driver": "file",
                                          "path": str(path)}}
    metadata = {}
    if chunks is not None:
        metadata["chunks"] = list(chunks)
    if compressor is not None:
        metadata["compressor"] = compressor
    if metadata:
        spec["metadata"] = metadata
    return ts.open(spec, create=True, open=True, dtype=dtype,
                   shape=shape).result()


def _values(dtype, shape, seed):
    """Seeded values of ``dtype`` (bfloat16: float32 values that are
    bfloat16 numbers) with runs, so every codec finds matches."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, shape) * 3 + (np.arange(shape[-1]) // 4)
    if dtype in ("float32", "bfloat16"):
        out = (base / 7.0 - 2.5).astype(np.float32)
        if dtype == "bfloat16":
            out = out.astype(ml_dtypes.bfloat16).astype(np.float32)
        return out
    return base.astype(dtype)


def _ts_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)


# ---------------------------------------------------------------------------
# the store the port creates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,chunks", SHAPES)
def test_created_zarray_is_tensorstores(tmp_path, shape, chunks):
    for i, dtype in enumerate(DTYPES):
        ours, theirs = tmp_path / f"port{i}", tmp_path / f"ts{i}"
        ZarrArray.create(str(ours), shape, dtype, chunks=chunks)
        _ts_create(theirs, dtype, shape, chunks)
        got = (ours / ".zarray").read_bytes()
        want = (theirs / ".zarray").read_bytes()
        assert json.loads(got) == json.loads(want), (dtype, got, want)
        assert got == want
        if chunks is None:
            assert tuple(json.loads(got)["chunks"]) == default_chunks(shape)


def test_chip_smokes_created_zarray_is_tensorstores(tmp_path):
    """The ``.zarray`` that ``chip_smoke.py`` phase 21 expects of the
    store its ``save-zarr`` leg creates is tensorstore's, and the port's
    for that shape and dtype."""
    import chip_smoke

    _ts_create(tmp_path / "ts", "float32", chip_smoke.CREATED_STORE)
    ZarrArray.create(str(tmp_path / "port"), chip_smoke.CREATED_STORE,
                     "float32")
    want = (tmp_path / "ts" / ".zarray").read_text()
    assert want == chip_smoke.CREATED_ZARRAY
    assert (tmp_path / "port" / ".zarray").read_text() == want


def test_default_chunks_hold_at_most_a_mebi_element():
    assert default_chunks((64, 512, 512)) == (64, 128, 128)
    assert default_chunks((3, 64, 512, 512)) == (3, 64, 73, 73)
    assert default_chunks((1000, 1000, 1000)) == (101, 101, 101)
    assert default_chunks((0, 5, 5)) == (1, 5, 5)
    assert default_chunks(()) == ()


# (chunk dtype, store shape, chunk shape, chunk offset, --chunk-size)
SAVES = [
    ("uint8", (16, 300, 300), (4, 16, 16), (2, 250, 240), None),
    ("uint16", (12, 16, 20), (5, 12, 14), (1, 2, 3), (4, 8, 8)),
    ("uint32", None, (6, 10, 12), (0, 0, 0), None),
    ("uint64", (8, 100, 100), (4, 9, 9), (3, 90, 0), None),
    ("float32", (6, 20, 30), (6, 20, 30), (0, 0, 0), (3, 7, 11)),
    ("float32", (4, 600, 600), (4, 20, 20), (0, 500, 500), None),
    ("bfloat16", None, (4, 12, 16), (2, 4, 0), None),
]


@pytest.mark.parametrize("dtype,size,shape,offset,chunk_size", SAVES)
def test_save_zarr_creates_the_jax_store(tmp_path, dtype, size, shape,
                                         offset, chunk_size):
    """Both CLIs' ``save-zarr`` into a path with no store: the same
    ``.zarray``; each package's ``load-zarr`` reads both stores as the
    chunk. A bfloat16 chunk reaches both stages as ``--dtype bfloat16``
    of float32 values."""
    values = _values(dtype, shape, seed=len(shape) + shape[0])
    src = values if dtype != "bfloat16" else values.astype(np.float32)
    args = []
    if size is not None:
        args += ["--volume-size", *map(str, size)]
    if chunk_size is not None:
        args += ["--chunk-size", *map(str, chunk_size)]
    if dtype == "bfloat16":
        args += ["--dtype", "bfloat16"]
    port_task, jax_task = new_task(), jax_new_task()
    port_task["chunk"] = Chunk(src, voxel_offset=offset)
    jax_task["chunk"] = JaxChunk(src, voxel_offset=offset)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    list(port_stage(["save-zarr", "-p", ours, *args])(iter([port_task])))
    list(jax_stage(["save-zarr", "-p", theirs, *args])(iter([jax_task])))
    got = (tmp_path / "port" / ".zarray").read_text()
    assert json.loads(got) == json.loads(
        (tmp_path / "jax" / ".zarray").read_text())
    assert json.loads(got)["compressor"] == DEFAULT_COMPRESSOR
    box = tuple(slice(o, o + s) for o, s in zip(offset, shape))
    for store in (ours, theirs):
        read = ["load-zarr", "-p", store]
        port_out = list(port_stage(read)(iter([new_task()])))[0]["chunk"]
        jax_out = list(jax_stage(read)(iter([jax_new_task()])))[0]["chunk"]
        if dtype == "bfloat16":
            assert port_out.array.dtype == torch.bfloat16
            got_bits = port_out.array.view(torch.int16).numpy()[box]
            want = np.asarray(jax_out.array)[box]
            assert np.array_equal(got_bits, want.view(np.int16))
            assert np.array_equal(bfloat16_bits(values).view(np.int16),
                                  got_bits)
        else:
            assert_same_chunk(port_out, jax_out)
            assert np.array_equal(np.asarray(port_out.array)[box], values)


def test_save_zarr_refuses_what_jax_refuses(tmp_path):
    """A czyx chunk into the zyx store both packages create: each
    creates the store, then refuses the write with ``ValueError``."""
    aff = np.random.default_rng(2).random((1, 4, 8, 8), dtype=np.float32)
    port_task, jax_task = new_task(), jax_new_task()
    port_task["chunk"] = Chunk(aff).astype(torch.bfloat16)
    jax_task["chunk"] = JaxChunk(aff.astype(ml_dtypes.bfloat16))
    with pytest.raises(ValueError):
        list(port_stage(["save-zarr", "-p", str(tmp_path / "p")])(
            iter([port_task])))
    with pytest.raises(ValueError):
        list(jax_stage(["save-zarr", "-p", str(tmp_path / "j")])(
            iter([jax_task])))
    assert json.loads((tmp_path / "p" / ".zarray").read_text()) == \
        json.loads((tmp_path / "j" / ".zarray").read_text())
    # a dtype the port cannot hold is refused before any store is made,
    # a name numpy does not know as the JAX stage refuses it
    for name in ("int4", "float8_e4m3fn"):
        with pytest.raises(NotImplementedError, match=name):
            port_stage(["save-zarr", "-p", str(tmp_path / "q"), "--dtype",
                        name])
    with pytest.raises(TypeError):
        port_stage(["save-zarr", "-p", str(tmp_path / "q"), "--dtype",
                    "no-such-type"])
    assert not (tmp_path / "q").exists()


EXISTING = ["bfloat16", "float32", "float64", "float16", "uint8", "int32"]


@pytest.mark.parametrize("via", ["chunk", "--dtype"])
@pytest.mark.parametrize("store_dtype", EXISTING)
def test_a_bfloat16_chunk_into_an_existing_store_as_the_jax_stage(
        tmp_path, store_dtype, via):
    """A bfloat16 chunk (an inference output's dtype, or ``--dtype
    bfloat16`` of a float32 chunk) into a store that the JAX
    ``save-zarr`` made of another chunk first: both CLIs write the same
    bytes, or both raise ``TypeError`` where tensorstore's safe cast
    rule refuses the store's dtype."""
    values = np.random.default_rng(4).normal(size=(4, 8, 8)).astype(
        np.float32)
    values[0, 0, :3] = [1 + 2 ** -8, -(1 + 3 * 2 ** -8), 300.5]
    first = _values(store_dtype, (4, 8, 16), seed=6).astype(
        _ts_dtype(store_dtype))
    port_task, jax_task = new_task(), jax_new_task()
    if via == "chunk":
        port_task["chunk"] = Chunk(torch.from_numpy(values).to(
            torch.bfloat16), voxel_offset=(0, 0, 8))
        jax_task["chunk"] = JaxChunk(values.astype(ml_dtypes.bfloat16),
                                     voxel_offset=(0, 0, 8))
        args = []
    else:
        port_task["chunk"] = Chunk(values, voxel_offset=(0, 0, 8))
        jax_task["chunk"] = JaxChunk(values, voxel_offset=(0, 0, 8))
        args = ["--dtype", "bfloat16"]
    stores = {}
    for who in ("port", "jax"):
        stores[who] = str(tmp_path / who)
        made = jax_new_task()
        made["chunk"] = JaxChunk(first)
        list(jax_stage(["save-zarr", "-p", stores[who]])(iter([made])))
    port_save = port_stage(["save-zarr", "-p", stores["port"], *args])
    jax_save = jax_stage(["save-zarr", "-p", stores["jax"], *args])
    if store_dtype not in ("bfloat16", "float32", "float64"):
        for save, task in ((port_save, port_task), (jax_save, jax_task)):
            with pytest.raises(TypeError):
                list(save(iter([task])))
        return
    list(port_save(iter([port_task])))
    list(jax_save(iter([jax_task])))
    read = {who: np.asarray(ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": path}}).result().read().result())
        for who, path in stores.items()}
    assert read["port"].dtype == read["jax"].dtype == first.dtype
    assert read["port"].tobytes() == read["jax"].tobytes()
    rounded = values.astype(ml_dtypes.bfloat16).astype(first.dtype)
    assert read["port"][..., 8:].tobytes() == rounded.tobytes()
    assert read["port"][..., :8].tobytes() == first[..., :8].tobytes()


# ---------------------------------------------------------------------------
# blosc frames of every cname and shuffle
# ---------------------------------------------------------------------------
def _flags(frame):
    return frame[2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shuffle", SHUFFLES)
@pytest.mark.parametrize("cname", CNAMES)
def test_blosc_writes_read_in_tensorstore(tmp_path, cname, shuffle, dtype):
    compressor = {"id": "blosc", "cname": cname, "clevel": 5,
                  "shuffle": shuffle, "blocksize": 0}
    itemsize = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    want_shuffle = {0: 0, 1: 0x01, 2: 0x04}[
        shuffle if shuffle != -1 else (2 if itemsize == 1 else 1)]
    for chunks in ((3, 5, 7), (4, 10, 8)):
        shape = (6, 10, 17)
        arr = _values(dtype, shape, seed=sum(chunks) + SHUFFLES.index(
            shuffle))
        path = tmp_path / f"{cname}{shuffle}{chunks[0]}"
        store = _ts_create(path, dtype, shape, chunks, compressor)
        port = ZarrArray(str(path))
        port.write(None, arr)
        assert np.array_equal(
            np.asarray(store.read().result()).astype(np.float64),
            arr.astype(np.float64))
        frame = (path / "0.0.0").read_bytes()
        assert _flags(frame) >> 5 == blosc.WRITES[cname]
        assert _flags(frame) & 0x05 == want_shuffle
        assert blosc.decompress(frame) == blosc.decompress_plain(frame)
        # tensorstore's frames, read in the port
        other = arr[::-1].copy()
        store[...] = other.astype(_ts_dtype(dtype))
        read = ZarrArray(str(path)).read_values()
        if dtype == "bfloat16":
            read = read.float().numpy()
        assert np.array_equal(read, other)


@pytest.mark.parametrize("name", sorted(INPUTS) + ["far"])
def test_encoder_streams_are_the_plain_twins(name):
    """blosclz, snappy and the hash-chain LZ4 of ``lz4hc`` (at clevels 1
    and 5), each decoded by the plain decoder."""
    data = _far() if name == "far" else INPUTS[name]
    if data:
        stream = native.blosclz_compress(data)
        assert stream == blosc.blosclz_compress_plain(data)
        assert blosc._blosclz(stream, len(data)) == data
    stream = native.snappy_compress(data)
    assert stream == blosc.snappy_compress_plain(data)
    assert blosc._snappy(stream, len(data)) == data
    for level in (1, 5):
        depth = blosc.hc_depth(level)
        block = native.lz4hc_compress(data, depth)
        assert block == blosc.lz4hc_compress_plain(data, depth)
        assert blosc._lz4(block, len(data)) == data


def _far():
    """16-byte strings each repeated once, then the start again about
    70000 bytes back: a match only blosclz's 16-bit far distance
    reaches."""
    rng = np.random.default_rng(5)
    pairs = [bytes(rng.integers(0, 256, 16, dtype=np.uint8)) * 2
             for _ in range(2200)]
    body = b"".join(pairs)
    return body + body[:3000] + b"tail-of-the-input"


def test_a_far_match_reads_in_tensorstore(tmp_path):
    """A blosclz frame of ``_far`` (a match 70400 bytes back, past the
    13-bit near distances) reads bitwise in tensorstore."""
    data = np.frombuffer(_far(), dtype=np.uint8)
    stream = native.blosclz_compress(data.tobytes())
    assert len(stream) < 0.6 * len(data)
    path = tmp_path / "far"
    store = _ts_create(path, "uint8", data.shape, data.shape,
                       {"id": "blosc", "cname": "blosclz", "clevel": 5,
                        "shuffle": 0, "blocksize": 0})
    ZarrArray(str(path)).write(None, data)
    assert np.array_equal(store.read().result(), data)


@pytest.mark.parametrize("typesize", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_bitshuffle_is_the_plain_twin_and_inverts(name, typesize):
    data = INPUTS[name]
    data = data[:len(data) - len(data) % typesize]
    shuffled = native.bitshuffle(data, typesize)
    assert shuffled == blosc.bitshuffle_plain(data, typesize)
    count = len(data) // typesize
    if count % 8:
        assert shuffled == data  # left as c-blosc leaves it
    else:
        rows = np.frombuffer(shuffled, np.uint8)
        assert blosc._bitunshuffle(rows, typesize, count) == data


@pytest.mark.parametrize("cname,shuffle", [
    ("blosclz", 1), ("snappy", 1), ("blosclz", 2), ("snappy", 2),
    ("lz4", 2), ("blosclz", 0), ("snappy", 0), ("lz4hc", 0), ("lz4hc", 1),
    ("lz4hc", 2)])
@pytest.mark.parametrize("name", ["affinity", "segmentation", "leaves"])
def test_frames_within_a_quarter_of_tensorstores(tmp_path, name, cname,
                                                 shuffle):
    arr = size_fixtures()[name]
    compressor = {"id": "blosc", "cname": cname, "clevel": 5,
                  "shuffle": shuffle, "blocksize": 0}
    sizes = {}
    for who in ("ts", "port"):
        store = _ts_create(tmp_path / who, arr.dtype.name, arr.shape,
                           arr.shape, compressor)
        if who == "ts":
            store[...] = arr
        else:
            ZarrArray(str(tmp_path / who)).write(None, arr)
            assert np.array_equal(store.read().result(), arr)
        key = ".".join("0" * arr.ndim)
        sizes[who] = len((tmp_path / who / key).read_bytes())
    assert sizes["port"] <= 1.25 * sizes["ts"], sizes


def size_table(root):
    """{(fixture, cname, shuffle): the port's chunk size over
    tensorstore's} for every cname and shuffle on the three size
    fixtures, written under ``root``."""
    from pathlib import Path

    table = {}
    for name, arr in size_fixtures().items():
        for cname in CNAMES:
            for shuffle in SHUFFLES:
                sizes = []
                for who in ("ts", "port"):
                    path = Path(root) / f"{name}-{cname}-{shuffle}-{who}"
                    store = _ts_create(path, arr.dtype.name, arr.shape,
                                       arr.shape, {
                                           "id": "blosc", "cname": cname,
                                           "clevel": 5, "shuffle": shuffle,
                                           "blocksize": 0})
                    if who == "ts":
                        store[...] = arr
                    else:
                        ZarrArray(str(path)).write(None, arr)
                    key = ".".join("0" * arr.ndim)
                    sizes.append((path / key).stat().st_size)
                table[name, cname, shuffle] = sizes[1] / sizes[0]
    return table


if __name__ == "__main__":
    # the size ratios PERF.md quotes: python -m tests.test_torch_zarr_writes
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for (name, cname, shuffle), ratio in size_table(tmp).items():
            print(f"{name:13s} {cname:8s} shuffle {shuffle:2d}: "
                  f"{ratio:.4f}")
