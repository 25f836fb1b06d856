"""The stores tensorstore writes that the port once refused, against
tensorstore and the JAX package on the CPU.

Zarr v3 ``sharding_indexed`` (``volume/compressors.py``'s pipeline,
``volume/zarr.py:Zarr3Array``): stores tensorstore writes with the index
at the start or the end, with and without ``crc32c``, inner chunks raw,
gzip, zstd or blosc, ``transpose`` inside and outside the shard, nested
sharding, big-endian values, partly written (missing inner chunks and
shards read as the fill value) read bitwise what tensorstore reads; a
shard is read by ranges (its index, then the inner chunks a read
overlaps); a corrupted index or inner chunk under crc32c raises; ``load-zarr
--driver zarr3`` and ``load_tensorstore`` give what the JAX package's
give. The committed ``tests/data/sharded_zarr3`` (``python -m
tests.test_torch_zarr3`` rewrites it) is the seeded array of
``chip_smoke.py`` phase 25. Zarr v2 ``bz2`` and ``order: F`` read and
write (tensorstore reads the port's writes back); N5 ``xz`` and
``bzip2`` read. The host C++ CRC-32C equals its Python twin.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.volume import compressors
from chunkflow_tpu_torch.volume.crc32c import crc32c, crc32c_plain
from chunkflow_tpu_torch.volume.storage import FileKV
from chunkflow_tpu_torch.volume.zarr import ZarrArray, open_array

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "sharded_zarr3"
SHAPE, SHARD = (16, 32, 40), (8, 16, 16)
WRITTEN = (slice(2, 13), slice(3, 20), slice(0, 17))
SUB = (slice(3, 11), slice(5, 30), slice(1, 39))

INNER = {
    "raw": [{"name": "bytes"}],
    "gzip": [{"name": "bytes"}, {"name": "gzip",
                                 "configuration": {"level": 5}}],
    "zstd": [{"name": "bytes"}, {"name": "zstd",
                                 "configuration": {"level": 3,
                                                   "checksum": True}}],
    "blosc": [{"name": "bytes"}, {"name": "blosc", "configuration": {
        "cname": "lz4", "clevel": 5, "shuffle": "shuffle", "typesize": 2,
        "blocksize": 0}}],
}


def sharding(inner, location="end", crc=True, chunk=(4, 8, 8)):
    index = [{"name": "bytes", "configuration": {"endian": "little"}}]
    return {"name": "sharding_indexed", "configuration": {
        "chunk_shape": list(chunk), "codecs": inner,
        "index_codecs": index + ([{"name": "crc32c"}] if crc else []),
        "index_location": location}}


def _matrix():
    cases = {}
    for location in ("start", "end"):
        for crc in (True, False):
            for name, inner in INNER.items():
                cases[f"{location}-{'crc32c' if crc else 'bare'}-{name}"] = (
                    [sharding(inner, location, crc)], "uint16", SHARD)
    big = [{"name": "bytes", "configuration": {"endian": "big"}},
           {"name": "crc32c"}]
    cases["transpose-inside"] = ([sharding(
        [{"name": "transpose", "configuration": {"order": [1, 2, 0]}}]
        + big)], "uint16", SHARD)
    cases["transpose-outside"] = (
        [{"name": "transpose", "configuration": {"order": [0, 2, 1]}},
         sharding([{"name": "bytes"}], chunk=(4, 16, 8))], "uint16",
        (8, 16, 32))
    cases["nested"] = ([sharding([sharding(
        [{"name": "bytes"}, {"name": "crc32c"}], "start",
        chunk=(2, 4, 4))])], "uint16", SHARD)
    cases["big-endian-float32"] = ([sharding(big, "start")], "float32",
                                   SHARD)
    cases["unsharded-transpose-crc32c"] = (
        [{"name": "transpose", "configuration": {"order": [1, 0, 2]}}]
        + big, "uint16", SHARD)
    return cases


MATRIX = _matrix()


def _values(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, 65535, shape, dtype=dtype)


def ts_store(root, codecs, dtype, shard, fill=7, shape=SHAPE):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "zarr3", "kvstore": {"driver": "file",
                                           "path": str(root)},
            "metadata": {"shape": list(shape), "data_type": dtype,
                         "chunk_grid": {"name": "regular", "configuration": {
                             "chunk_shape": list(shard)}},
                         "codecs": codecs, "fill_value": fill}}
    return ts.open(spec, create=True).result()


def partly_written(root, name):
    """The store of case ``name``, written in ``WRITTEN`` only: whole
    shards and inner chunks were never written."""
    codecs, dtype, shard = MATRIX[name]
    store = ts_store(root, codecs, dtype, shard)
    store[WRITTEN] = _values(dtype, SHAPE)[WRITTEN]
    return store


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_sharded_stores_read_what_tensorstore_reads(tmp_path, name):
    store = partly_written(tmp_path / "s", name)
    want = store.read().result()
    array = open_array(str(tmp_path / "s"), "zarr3")
    got = array.read()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(array.read(SUB), want[SUB])
    # the fill value where nothing was written, the values where it was
    assert (got[:2] == 7).all() and (got[13:] == 7).all()
    assert np.array_equal(got[WRITTEN], _values(want.dtype, SHAPE)[WRITTEN])


class CountingKV(FileKV):
    """A directory that counts the reads of each kind and their bytes."""

    def __init__(self, root):
        super().__init__(root)
        self.calls = {"whole": 0, "range": 0, "suffix": 0}
        self.nbytes = 0

    def _count(self, kind, data):
        self.calls[kind] += 1
        self.nbytes += len(data or b"")
        return data

    def read_bytes(self, name):
        return self._count("whole", super().read_bytes(name))

    def read_range(self, name, start, stop, if_generation=None):
        data, generation = super().read_range(name, start, stop,
                                              if_generation)
        return self._count("range", data), generation

    def read_suffix(self, name, length):
        return self._count("suffix", super().read_suffix(name, length))


@pytest.mark.parametrize("location", ["start", "end"])
def test_a_shard_is_read_by_ranges(tmp_path, location):
    """One inner chunk's worth of a shard costs its index and that chunk:
    the shard itself is never read whole."""
    codecs = [sharding(INNER["raw"], location)]
    store = ts_store(tmp_path / "s", codecs, "uint16", SHARD)
    values = _values("uint16", SHAPE)
    store[...] = values
    kv = CountingKV(str(tmp_path))
    array = open_array("s", "zarr3", kv=kv)
    kv.calls, kv.nbytes = dict.fromkeys(kv.calls, 0), 0
    assert np.array_equal(array.read((slice(0, 4), slice(0, 8),
                                      slice(0, 8))), values[:4, :8, :8])
    index = 2 * 2 * 2 * 16 + 4
    assert kv.calls == {"whole": 0, "range": 1 + (location == "start"),
                        "suffix": int(location == "end")}
    assert kv.nbytes == index + 4 * 8 * 8 * 2


@pytest.mark.parametrize("where", ["index", "inner-chunk"])
def test_a_corrupted_shard_under_crc32c_raises(tmp_path, where):
    """A byte flipped in a shard's index, or in an inner chunk whose codecs
    end in crc32c: tensorstore refuses the shard, and so does the port."""
    ts = pytest.importorskip("tensorstore")
    inner = [{"name": "bytes"}] + (
        [{"name": "crc32c"}] if where == "inner-chunk" else [])
    ts_store(tmp_path / "s", [sharding(inner)], "uint16",
             SHARD)[...] = _values("uint16", SHAPE)
    shard = tmp_path / "s" / "c" / "0" / "0" / "0"
    data = bytearray(shard.read_bytes())
    data[-10 if where == "index" else 0] ^= 0xFF
    shard.write_bytes(bytes(data))
    fresh = ts.open({"driver": "zarr3", "kvstore": {
        "driver": "file", "path": str(tmp_path / "s")}}).result()
    with pytest.raises(ValueError):
        fresh.read().result()
    with pytest.raises(ValueError, match="crc32c"):
        open_array(str(tmp_path / "s"), "zarr3").read()


def test_load_zarr_and_load_tensorstore_read_sharded_stores_as_jax():
    """The committed store through ``load-zarr --driver zarr3`` and the
    ``load_tensorstore`` plugin of both packages."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu.flow.runtime import new_task as jax_new_task
    from chunkflow_tpu_torch import BoundingBox
    from chunkflow_tpu_torch.flow.runtime import new_task
    from tests.test_torch_chunk import assert_same_chunk
    from tests.test_torch_cli_ops import _tasks, jax_stage, port_stage

    pytest.importorskip("tensorstore")
    base = ["load-zarr", "-p", str(FIXTURE), "--driver", "zarr3"]
    for args, box in ((base + ["--voxel-size", "40", "4", "4"], None),
                      (base, ((1, 5, 9), (15, 60, 50)))):
        port_task, jax_task = new_task(), jax_new_task()
        if box is not None:
            port_task["bbox"], jax_task["bbox"] = (BoundingBox(*box),
                                                   JaxBox(*box))
        got = list(port_stage(args)(iter([port_task])))[0]["chunk"]
        ref = list(jax_stage(args)(iter([jax_task])))[0]["chunk"]
        assert_same_chunk(got, ref)
    args = ["plugin", "-n", "load_tensorstore", "-i", "bbox", "-o", "chunk",
            "-a", f"driver=zarr3;kvstore=file://{FIXTURE}"]
    box = ((2, 9, 5), (15, 61, 58))
    jax_task, port_task = _tasks()
    jax_task["bbox"], port_task["bbox"] = JaxBox(*box), BoundingBox(*box)
    ref = list(jax_stage(args)(iter([jax_task])))[0]["chunk"]
    got = list(port_stage(args)(iter([port_task])))[0]["chunk"]
    assert_same_chunk(got, ref)


def test_the_committed_sharded_store_is_the_seeded_array():
    from chip_smoke import (
        SHARDED_HOLES,
        SHARDED_INNER,
        SHARDED_SHAPE,
        SHARDED_SHARD,
        sharded_array,
    )

    ts = pytest.importorskip("tensorstore")
    want = sharded_array(np)
    got = open_array(str(FIXTURE), "zarr3").read()
    assert np.array_equal(got, want)
    store = ts.open({"driver": "zarr3", "kvstore": {
        "driver": "file", "path": str(FIXTURE)}}).result()
    assert np.array_equal(store.read().result(), want)
    meta = json.loads((FIXTURE / "zarr.json").read_text())
    assert tuple(meta["shape"]) == SHARDED_SHAPE
    assert tuple(meta["chunk_grid"]["configuration"]["chunk_shape"]) == \
        SHARDED_SHARD
    (codec,) = meta["codecs"]
    config = codec["configuration"]
    assert codec["name"] == "sharding_indexed"
    assert tuple(config["chunk_shape"]) == SHARDED_INNER
    assert [c["name"] for c in config["codecs"]] == ["bytes", "zstd"]
    assert [c["name"] for c in config["index_codecs"]] == ["bytes", "crc32c"]
    # the hole of a whole shard is no file; the inner hole an entry of 2^64-1
    shard_hole, inner_hole = SHARDED_HOLES
    cell = [a // s for (a, _), s in zip(shard_hole, SHARDED_SHARD)]
    assert not (FIXTURE / "c" / "/".join(map(str, cell))).exists()
    index = np.frombuffer((FIXTURE / "c" / "0" / "0" / "0").read_bytes()[
        -(8 * 16 + 4):-4], "<u8").reshape(2, 2, 2, 2)
    inner = tuple(a // s for (a, _), s in zip(inner_hole, SHARDED_INNER))
    assert (index[inner] == compressors.MISSING).all()
    assert (index != compressors.MISSING).sum() == 7 * 2


@pytest.mark.parametrize("order", ["C", "F"])
@pytest.mark.parametrize("compressor", [None, "bz2", "blosc"])
def test_zarr_v2_bz2_and_fortran_order_read_and_write(tmp_path, compressor,
                                                      order):
    """tensorstore's store; the port reads it, writes into part of it, and
    tensorstore reads the port's writes."""
    ts = pytest.importorskip("tensorstore")
    compressors_v2 = {None: None, "bz2": {"id": "bz2", "level": 3},
                      "blosc": {"id": "blosc", "cname": "lz4", "clevel": 5,
                                "shuffle": 1, "blocksize": 0}}
    values = _values("uint16", (9, 14, 17), seed=4)
    spec = {"driver": "zarr", "kvstore": {"driver": "file",
                                          "path": str(tmp_path / "s")},
            "metadata": {"shape": list(values.shape), "chunks": [4, 8, 8],
                         "dtype": "<u2", "order": order,
                         "compressor": compressors_v2[compressor]}}
    store = ts.open(spec, create=True).result()
    store[1:9, 2:14, 0:15] = values[1:9, 2:14, 0:15]
    array = ZarrArray(str(tmp_path / "s"))
    assert array.order == order
    assert np.array_equal(array.read(), store.read().result())
    patch = _values("uint16", (5, 9, 10), seed=5)
    array.write((slice(2, 7), slice(3, 12), slice(4, 14)), patch)
    want = store.read().result().copy()
    want[2:7, 3:12, 4:14] = patch
    reread = ts.open({"driver": "zarr", "kvstore": spec["kvstore"]}).result()
    assert np.array_equal(reread.read().result(), want)
    assert np.array_equal(ZarrArray(str(tmp_path / "s")).read(), want)


@pytest.mark.parametrize("compression", [
    {"type": "xz", "preset": 6}, {"type": "bzip2", "blockSize": 9}],
    ids=["xz", "bzip2"])
def test_n5_xz_and_bzip2_read_bitwise(tmp_path, compression):
    ts = pytest.importorskip("tensorstore")
    values = _values("uint16", (9, 14, 17), seed=6)
    store = ts.open({"driver": "n5", "kvstore": {
        "driver": "file", "path": str(tmp_path / "s")}, "metadata": {
        "dimensions": list(values.shape), "blockSize": [4, 8, 8],
        "dataType": "uint16", "compression": compression}},
        create=True).result()
    store[0:8, 2:14, 1:17] = values[0:8, 2:14, 1:17]
    assert np.array_equal(open_array(str(tmp_path / "s"), "n5").read(),
                          store.read().result())
    codec = compressors.from_n5("s", compression, 2)
    data = values.tobytes()
    assert codec.decode(codec.encode(data)) == data


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 63, 1000, 4097])
def test_crc32c_host_matches_its_python_twin(size):
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    assert crc32c(data) == crc32c_plain(data)
    # a running CRC continues across a split
    half = size // 2
    assert crc32c(data[half:], crc32c(data[:half])) == crc32c(data)
    assert crc32c_plain(b"123456789") == crc32c(b"123456789") == 0xE3069283


def write_fixture() -> None:
    """``FIXTURE``, written by tensorstore: ``chip_smoke.sharded_array``,
    whose holes are fill and so never stored."""
    from chip_smoke import SHARDED_INNER, SHARDED_SHARD, sharded_array

    shutil.rmtree(FIXTURE, ignore_errors=True)
    values = sharded_array(np)
    store = ts_store(FIXTURE, [sharding(
        [{"name": "bytes"}, {"name": "zstd", "configuration": {"level": 3}}],
        "end", True, SHARDED_INNER)], "uint8", SHARDED_SHARD, fill=0,
        shape=values.shape)
    store[...] = values


if __name__ == "__main__":
    write_fixture()
