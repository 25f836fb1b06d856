"""The port's blosc decoders (``csrc/host/blosc.cpp`` and its plain
version, ``volume/blosc.py:decompress_plain``) on stores that tensorstore
writes on the CPU: zarr v2 arrays of every cname tensorstore writes
(blosclz, lz4, lz4hc, snappy, zlib, zstd), shuffle 0/1/2 and typesizes
1/2/4/8, each chunk decoded by both to tensorstore's values; zarr v2 and
N5 at tensorstore's defaults and zarr v3 with the ``blosc`` and ``zstd``
codecs read bitwise through ``volume/zarr.py``; the port's writes into a
blosc store (compressed frames of the store's cname) and into a ``bfloat16``
store (rounded as tensorstore rounds) read back in tensorstore and the
JAX ``load-zarr``; a malformed frame raises; the committed store
``tests/data/blosc_zarr`` (rewritten by ``python -m
tests.test_torch_blosc``) reads to its seeded array.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from chunkflow_tpu_torch.volume import blosc
from chunkflow_tpu_torch.volume.zarr import ZarrArray, open_array

ts = pytest.importorskip("tensorstore")

torch.set_num_threads(1)

FIXTURE = Path(__file__).resolve().parent / "data" / "blosc_zarr"
CNAMES = ["blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd"]
DTYPES = ["uint8", "uint16", "float32", "float64"]


def _array(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.normal(size=shape) * 20).astype(dtype)
    ramp = np.arange(int(np.prod(shape))).reshape(shape) // 7 % 200
    return (ramp + rng.integers(0, 3, shape)).astype(dtype)


def fixture_array() -> np.ndarray:
    """The committed store's values: a seeded uint16 ramp."""
    return _array("uint16", (8, 64, 64), seed=16)


def _ts_zarr(path, arr, compressor, chunks=None):
    store = ts.open({"driver": "zarr",
                     "kvstore": {"driver": "file", "path": str(path)},
                     "metadata": {"chunks": list(chunks or arr.shape),
                                  "compressor": compressor}},
                    create=True, dtype=arr.dtype.name,
                    shape=arr.shape).result()
    store[...] = arr
    return store


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", CNAMES)
def test_every_cname_shuffle_and_typesize(tmp_path, cname, shuffle, dtype):
    """One chunk of a ragged size (a short last block) decoded by both
    decoders, and the array through ``ZarrArray``."""
    arr = _array(dtype, (5, 37, 61), seed=len(cname) + shuffle)
    _ts_zarr(tmp_path, arr, {"id": "blosc", "cname": cname, "clevel": 5,
                             "shuffle": shuffle, "blocksize": 0})
    frame = (tmp_path / "0.0.0").read_bytes()
    assert frame[3] == arr.dtype.itemsize
    assert blosc.decompress(frame) == arr.tobytes()
    assert blosc.decompress_plain(frame) == arr.tobytes()
    assert np.array_equal(ZarrArray(str(tmp_path)).read(), arr)


@pytest.mark.parametrize("cname", ["lz4", "zstd"])
def test_many_blocks_in_one_chunk(tmp_path, cname):
    """A chunk of many blosc blocks, byte- and bit-shuffled (C++ only)."""
    arr = _array("uint16", (13, 333, 301), seed=4)
    for shuffle in (1, 2):
        _ts_zarr(tmp_path / str(shuffle), arr,
                 {"id": "blosc", "cname": cname, "clevel": 5,
                  "shuffle": shuffle, "blocksize": 0})
        frame = (tmp_path / str(shuffle) / "0.0.0").read_bytes()
        assert int.from_bytes(frame[4:8], "little") > \
            2 * int.from_bytes(frame[8:12], "little")
        assert blosc.decompress(frame) == arr.tobytes()


def test_tensorstore_defaults_read_bitwise(tmp_path):
    """zarr v2 and N5 with tensorstore's default compressor (blosc),
    partly written, and zarr v3 with ``blosc`` and ``zstd`` codecs."""
    arr = _array("int16", (9, 14, 17), seed=7)
    want = np.zeros_like(arr)
    want[2:9, 1:14, 3:17] = arr[2:9, 1:14, 3:17]
    specs = {
        "zarr": ({"metadata": {"chunks": [4, 8, 8]}}, {}),
        "n5": ({"metadata": {"blockSize": [4, 8, 8]}}, {}),
        "zarr3": ({}, {"codec": ts.CodecSpec({
            "driver": "zarr3", "codecs": [
                {"name": "bytes", "configuration": {"endian": "big"}},
                {"name": "blosc", "configuration": {
                    "cname": "lz4", "clevel": 5, "shuffle": "bitshuffle",
                    "typesize": 2, "blocksize": 0}}]})}),
        "zarr3-zstd": ({}, {"codec": ts.CodecSpec({
            "driver": "zarr3",
            "codecs": [{"name": "bytes"},
                       {"name": "zstd", "configuration": {"level": 5}}]})}),
    }
    for name, (spec, kwargs) in specs.items():
        driver = name.split("-")[0]
        path = tmp_path / name
        store = ts.open(dict({"driver": driver, "kvstore": {
            "driver": "file", "path": str(path)}}, **spec), create=True,
            dtype="int16", shape=arr.shape, **kwargs).result()
        store[2:9, 1:14, 3:17] = arr[2:9, 1:14, 3:17]
        if driver == "zarr":
            assert json.loads((path / ".zarray").read_text())[
                "compressor"]["id"] == "blosc"
        if driver == "n5":
            assert json.loads((path / "attributes.json").read_text())[
                "compression"]["type"] == "blosc"
        assert np.array_equal(open_array(str(path), driver).read(), want)


def test_a_bfloat16_store_reads_as_bfloat16(tmp_path):
    """tensorstore's ``bfloat16`` zarr dtype: its uint16 bits, and a
    ``torch.bfloat16`` tensor through ``read_values``, ``load-zarr`` and
    ``load_tensorstore``."""
    from chunkflow_tpu_torch.flow import cli
    from chunkflow_tpu_torch.flow.runtime import new_task

    values = np.random.default_rng(3).normal(size=(4, 8, 8)).astype(
        np.float32)
    bits = (values.view(np.uint32) >> 16).astype(np.uint16)
    store = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(tmp_path)}}, create=True,
        dtype="bfloat16", shape=values.shape).result()
    store[...] = bits.view(ts.bfloat16.numpy_dtype)
    port = ZarrArray(str(tmp_path))
    assert port.bfloat16 and np.array_equal(port.read(), bits)
    want = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    assert torch.equal(port.read_values(), want)
    _, stages = cli.build_stages(["--device", "cpu", "load-zarr", "-p",
                                  str(tmp_path)])
    chunk = list(stages[0](iter([new_task()])))[0]["chunk"]
    assert chunk.array.dtype == torch.bfloat16
    assert torch.equal(chunk.array, want)
    from chunkflow_tpu_torch import BoundingBox
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    plugin = load_plugin("load_tensorstore")(
        BoundingBox((0, 0, 0), values.shape), kvstore=f"file://{tmp_path}")
    assert torch.equal(plugin.array, want)


def test_the_port_writes_a_blosc_store_tensorstore_reads(tmp_path):
    """A write into a tensorstore blosc-lz4 store stores compressed
    frames of the lz4 codec, byte-shuffled, which tensorstore and both
    decoders read; ``blosc.compress`` round-trips every typesize, a ragged
    tail and more than one block."""
    arr = _array("uint16", (6, 20, 30), seed=9)
    _ts_zarr(tmp_path, arr, {"id": "blosc", "cname": "lz4", "clevel": 5,
                             "shuffle": 1, "blocksize": 0},
             chunks=(3, 10, 30))
    port = ZarrArray(str(tmp_path))
    part = _array("uint16", (4, 7, 9), seed=10)
    port.write((slice(1, 5), slice(2, 9), slice(10, 19)), part)
    arr[1:5, 2:9, 10:19] = part
    read = ts.open({"driver": "zarr", "kvstore": {
        "driver": "file", "path": str(tmp_path)}}).result()
    assert np.array_equal(read.read().result(), arr)
    assert np.array_equal(ZarrArray(str(tmp_path)).read(), arr)
    frame = (tmp_path / "0.0.0").read_bytes()
    assert frame[2] == 0x31  # lz4, one stream a block, byte shuffle
    assert frame[3] == 2 and len(frame) < 3 * 10 * 30 * 2
    # one voxel, a ragged typesize tail, more than one block
    for shape, dtype in (((1, 1, 1), "uint8"), ((2, 3, 5), "float64"),
                         ((4, 128, 160), "float32")):
        path = tmp_path / f"{dtype}"
        whole = _array(dtype, shape, seed=11)
        store = _ts_zarr(path, np.zeros_like(whole), {
            "id": "blosc", "cname": "zstd", "clevel": 3, "shuffle": 2,
            "blocksize": 0})
        ZarrArray(str(path)).write(None, whole)
        assert np.array_equal(store.read().result(), whole)
    rng = np.random.default_rng(4)
    for typesize in (1, 2, 4, 8):
        for size in (0, 5, 3 * 1024 + 3, blosc.BLOCK * 2 + 13):
            data = (np.arange(size) // 5 % 97).astype(np.uint8)
            data[rng.integers(0, max(size, 1), size // 50)] = 3
            frame = blosc.compress(data.tobytes(), typesize)
            assert blosc.decompress(frame) == \
                blosc.decompress_plain(frame) == data.tobytes()


def test_save_zarr_into_a_bfloat16_store_rounds_as_tensorstore(tmp_path):
    """The port's ``save-zarr`` of a float32 chunk into a tensorstore
    ``bfloat16`` store rounds to the nearest bfloat16, ties to even, as
    tensorstore's own write does; tensorstore and the JAX ``load-zarr``
    read back what the port wrote, and a bfloat16 chunk goes in exactly."""
    from chunkflow_tpu.flow.runtime import new_task as jax_new_task
    from chunkflow_tpu_torch import Chunk
    from chunkflow_tpu_torch.flow.runtime import new_task
    from tests.test_torch_cli_ops import jax_stage, port_stage

    bf16 = ts.bfloat16.numpy_dtype
    values = np.random.default_rng(5).normal(size=(4, 8, 8)).astype(
        np.float32)
    # halfway between two bfloat16s: ties go to the even one
    values[0, 0, :4] = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 0.73]
    spec = {"driver": "zarr", "kvstore": {"driver": "file",
                                          "path": str(tmp_path)}}
    ts.open(spec, create=True, dtype="bfloat16",
            shape=(4, 8, 16)).result()[:, :, 8:] = values.astype(bf16)
    task = new_task()
    task["chunk"] = Chunk(values)
    save = port_stage(["save-zarr", "-p", str(tmp_path)])
    list(save(iter([task])))
    want = values.astype(bf16)
    assert want[0, 0, :3].astype(np.float32).tolist() == [
        1.0, 1 + 2 ** -6, -1.0]
    got = ts.open(spec).result().read().result()
    assert got[..., :8].view(np.uint16).tolist() == \
        want.view(np.uint16).tolist()
    assert np.array_equal(got[..., :8].view(np.uint16),
                          got[..., 8:].view(np.uint16))
    ref = list(jax_stage(["load-zarr", "-p", str(tmp_path)])(
        iter([jax_new_task()])))[0]["chunk"]
    assert np.array_equal(np.asarray(ref.array)[..., :8].view(np.uint16),
                          want.view(np.uint16))
    # a bfloat16 chunk is written as it is
    exact = torch.from_numpy(values).to(torch.bfloat16)
    task = new_task()
    task["chunk"] = Chunk(exact, voxel_offset=(0, 0, 8))
    list(save(iter([task])))
    assert torch.equal(ZarrArray(str(tmp_path)).read_values()[..., 8:],
                       exact)


def test_bad_frames_raise(tmp_path):
    arr = np.tile(np.arange(24, dtype=np.uint16), (4, 16, 1))
    _ts_zarr(tmp_path, arr, {"id": "blosc", "cname": "lz4", "clevel": 5,
                             "shuffle": 1, "blocksize": 0})
    frame = (tmp_path / "0.0.0").read_bytes()
    # a block larger than the frame's data, which would allocate 4 GiB
    huge = frame[:8] + (2 ** 32 - 1).to_bytes(4, "little") + frame[12:]
    for bad in (frame[:12], frame[:len(frame) // 2],
                frame[:2] + bytes([frame[2] | 0x05]) + frame[3:], huge):
        for decode in (blosc.decompress, blosc.decompress_plain):
            with pytest.raises(ValueError):
                decode(bad)
    # a compressed stream whose bytes are not lz4
    start = int.from_bytes(frame[16:20], "little")
    assert int.from_bytes(frame[start:start + 4], "little") < arr.size
    with pytest.raises(ValueError, match="expected"):
        blosc.decompress(frame, arr.nbytes + 2)
    corrupt = bytearray(frame)
    corrupt[start + 4:start + 40] = b"\xff" * 36
    for decode in (blosc.decompress, blosc.decompress_plain):
        with pytest.raises(ValueError):
            decode(bytes(corrupt))


def test_the_committed_store_reads_to_its_array():
    port = ZarrArray(str(FIXTURE))
    assert port.compressor.name == "blosc"
    assert np.array_equal(port.read(), fixture_array())
    assert sum(p.stat().st_size for p in FIXTURE.iterdir()) <= 64 * 1024


def write_fixture() -> None:
    shutil.rmtree(FIXTURE, ignore_errors=True)
    _ts_zarr(FIXTURE, fixture_array(), {"id": "blosc", "cname": "lz4",
                                        "clevel": 5, "shuffle": 1,
                                        "blocksize": 0},
             chunks=(8, 32, 32))


if __name__ == "__main__":
    write_fixture()
