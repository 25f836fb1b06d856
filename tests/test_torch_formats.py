"""The port's chunk file formats against the JAX package, on the CPU.

HDF5, TIFF, PNG sections, NRRD, MRC and zarr v2: each format is written
by one package and read by the other (and by the writer itself), with
the array bitwise, its dtype, voxel offset, voxel size and layer type
intact (bfloat16 is stored as float32 by both). Zarr: the port reads what
tensorstore writes (the JAX ``save-zarr``, into a store the port made;
zarr v3 and N5 stores through ``load-zarr --driver``), tensorstore reads
what the port writes, and a blosc or zstd store raises. The
file commands are parsed by both CLIs from one argument list and must
write the same files; whole command lines (the README's quick start with
the identity engine, ``load-h5`` cutouts, channels, prefixes and
``--remove-empty``) run through both CLIs.
"""
import json
import os

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.flow.cli import main as jax_main
from chunkflow_tpu.flow.runtime import new_task as jax_new_task
from chunkflow_tpu.volume import io_mrc as jax_mrc
from chunkflow_tpu.volume import io_nrrd as jax_nrrd
from chunkflow_tpu.volume import io_png as jax_png
from chunkflow_tpu_torch import Chunk
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.flow.runtime import new_task
from chunkflow_tpu_torch.volume import io_mrc, io_nrrd, io_png
from chunkflow_tpu_torch.volume.zarr import ZarrArray
from tests.test_torch_chunk import assert_same_chunk
from tests.test_torch_cli_ops import jax_stage, port_stage

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

OFFSET, VSIZE = (3, 5, 7), (40, 4, 4)


def _arr(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, endpoint=True,
                        dtype=dtype)


def _pair(arr, **meta):
    """The same chunk in each package (the port's on a numpy payload)."""
    meta = dict(dict(voxel_offset=OFFSET, voxel_size=VSIZE), **meta)
    return JaxChunk(arr.copy(), **meta), Chunk(arr.copy(), **meta)


def _same_file_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ---------------------------------------------------------------------------
# HDF5
# ---------------------------------------------------------------------------
H5_CASES = {
    "uint8": ("uint8", (6, 20, 24), {}),
    "uint32-segmentation": ("uint32", (6, 20, 24),
                            {"layer_type": "segmentation"}),
    "float32-affinity": ("float32", (3, 6, 20, 24), {}),
    "uint16-image-4d": ("uint16", (1, 6, 20, 24), {"layer_type": "image"}),
}


@pytest.mark.parametrize("name", sorted(H5_CASES))
@pytest.mark.parametrize("chunk_size", [None, (2, 8, 8)])
def test_h5_written_by_one_package_is_read_by_the_other(tmp_path, name,
                                                        chunk_size):
    dtype, shape, meta = H5_CASES[name]
    jax_chunk, port_chunk = _pair(_arr(dtype, shape), **meta)
    port_path = port_chunk.to_h5(str(tmp_path / "port.h5"),
                                 chunk_size=chunk_size, with_unique=True)
    jax_path = jax_chunk.to_h5(str(tmp_path / "jax.h5"),
                               chunk_size=chunk_size, with_unique=True)
    import h5py

    with h5py.File(port_path) as fp, h5py.File(jax_path) as fj:
        assert sorted(fp) == sorted(fj)
        assert dict(fp.attrs) == dict(fj.attrs)
        assert fp["main"].chunks == fj["main"].chunks
        for key in fj:
            assert fp[key].dtype == fj[key].dtype
            assert np.array_equal(fp[key][()], fj[key][()])
    assert_same_chunk(Chunk.from_h5(jax_path), JaxChunk.from_h5(port_path))
    assert_same_chunk(Chunk.from_h5(port_path), jax_chunk)


@pytest.mark.parametrize("payload", ["cpu-tensor", "bfloat16"])
def test_h5_of_a_tensor_payload(tmp_path, payload):
    """A tensor payload (the card's, here on the CPU) writes the file its
    numpy payload writes; bfloat16 is stored as float32, as the JAX
    package stores its bfloat16."""
    arr = _arr("float32", (3, 4, 16, 16))
    tensor = torch.from_numpy(arr)
    if payload == "bfloat16":
        tensor = tensor.to(torch.bfloat16)
        arr = tensor.to(torch.float32).numpy()
    jax_chunk = JaxChunk(arr, voxel_offset=OFFSET, voxel_size=VSIZE)
    path = Chunk(tensor, voxel_offset=OFFSET, voxel_size=VSIZE).to_h5(
        str(tmp_path / "t.h5"))
    assert_same_chunk(Chunk.from_h5(path), jax_chunk)
    assert_same_chunk(JaxChunk.from_h5(path), jax_chunk)


@pytest.mark.parametrize("kwargs", [
    {"bbox": ((4, 8, 9), (7, 20, 30))},
    {"channels": "0,2"},
    {"channels": [2, 1], "dtype": np.float64},
    {"bbox": ((3, 5, 7), (5, 6, 8)), "channels": "1", "dtype": np.float16},
    {"voxel_offset": (0, 0, 0), "voxel_size": (8, 8, 8)},
], ids=["bbox", "channels-str", "channels-list-dtype", "all", "override"])
def test_from_h5_options_match_jax(tmp_path, kwargs):
    arr = _arr("float32", (3, 6, 20, 24), seed=3)
    path = JaxChunk(arr, voxel_offset=OFFSET, voxel_size=VSIZE).to_h5(
        str(tmp_path / "c.h5"))
    if "bbox" in kwargs:
        from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
        from chunkflow_tpu_torch import BoundingBox

        box = kwargs["bbox"]
        got = Chunk.from_h5(path, **dict(kwargs, bbox=BoundingBox(*box)))
        ref = JaxChunk.from_h5(path, **dict(kwargs, bbox=JaxBox(*box)))
    else:
        got, ref = Chunk.from_h5(path, **kwargs), JaxChunk.from_h5(path,
                                                                   **kwargs)
    assert_same_chunk(got, ref)


def test_to_h5_names_a_directory_after_the_bbox(tmp_path):
    jax_chunk, port_chunk = _pair(_arr("uint8", (4, 8, 8)))
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got = port_chunk.to_h5(str(tmp_path / "p"))
    ref = jax_chunk.to_h5(str(tmp_path / "j"))
    assert os.path.basename(got) == os.path.basename(ref)


# ---------------------------------------------------------------------------
# TIFF, PNG sections, NRRD, MRC
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compression", ["zlib", "lzw", "packbits", "raw"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
def test_tif_written_by_one_package_is_read_by_the_other(tmp_path, dtype,
                                                         compression):
    jax_chunk, port_chunk = _pair(_arr(dtype, (5, 18, 22), seed=4))
    port_chunk.to_tif(str(tmp_path / "p.tif"), compression=compression)
    jax_chunk.to_tif(str(tmp_path / "j.tif"), compression=compression)
    for path in ("p.tif", "j.tif"):
        kwargs = dict(voxel_offset=OFFSET, voxel_size=VSIZE)
        assert_same_chunk(Chunk.from_tif(str(tmp_path / path), **kwargs),
                          JaxChunk.from_tif(str(tmp_path / "j.tif"),
                                            **kwargs))
    assert np.array_equal(
        np.asarray(JaxChunk.from_tif(str(tmp_path / "p.tif")).array),
        jax_chunk.array)


@pytest.mark.parametrize("case", ["uint8", "float01", "affinity-float",
                                  "affinity-uint8", "uint16-4d"])
def test_pngs_written_by_one_package_are_read_by_the_other(tmp_path, case):
    arr = {
        "uint8": _arr("uint8", (4, 12, 14)),
        "float01": _arr("float32", (4, 12, 14)),
        "affinity-float": _arr("float32", (3, 4, 12, 14)),
        "affinity-uint8": _arr("uint8", (3, 4, 12, 14)),
        "uint16-4d": _arr("uint16", (1, 4, 12, 14)),
    }[case]
    meta = {"layer_type": "affinity_map"} if "affinity" in case else {}
    jax_chunk, port_chunk = _pair(arr, **meta)
    io_png.save_pngs(port_chunk, str(tmp_path / "p"), name_prefix="s")
    jax_png.save_pngs(jax_chunk, str(tmp_path / "j"), name_prefix="s")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    for name in names:
        assert _same_file_bytes(tmp_path / "p" / name, tmp_path / "j" / name)
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    box = ((OFFSET[0] + 1, 2, 3), (OFFSET[0] + 3, 10, 12))
    got = io_png.load_pngs(str(tmp_path / "j"), bbox=BoundingBox(*box),
                           voxel_offset=(OFFSET[0], 0, 0))
    ref = jax_png.load_pngs(str(tmp_path / "p"), bbox=JaxBox(*box),
                            voxel_offset=(OFFSET[0], 0, 0))
    assert_same_chunk(got, ref)


@pytest.mark.parametrize("encoding", ["raw", "gzip"])
@pytest.mark.parametrize("dtype", ["uint8", "int16", "uint32", "uint64",
                                   "float32", "float64"])
def test_nrrd_written_by_one_package_is_read_by_the_other(tmp_path, dtype,
                                                          encoding):
    arr = _arr(dtype, (2, 5, 9, 11), seed=5)
    io_nrrd.save_nrrd(str(tmp_path / "p.nrrd"), arr, voxel_size=VSIZE,
                      voxel_offset=OFFSET, encoding=encoding)
    jax_nrrd.save_nrrd(str(tmp_path / "j.nrrd"), arr, voxel_size=VSIZE,
                       voxel_offset=OFFSET, encoding=encoding)
    assert _same_file_bytes(tmp_path / "p.nrrd", tmp_path / "j.nrrd")
    got, got_header = io_nrrd.load_nrrd(str(tmp_path / "j.nrrd"))
    ref, ref_header = jax_nrrd.load_nrrd(str(tmp_path / "p.nrrd"))
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert got_header == ref_header


def test_nrrd_of_a_bfloat16_tensor(tmp_path):
    tensor = torch.from_numpy(_arr("float32", (4, 6, 7))).to(torch.bfloat16)
    io_nrrd.save_nrrd(str(tmp_path / "b.nrrd"), tensor)
    ref, _ = jax_nrrd.load_nrrd(str(tmp_path / "b.nrrd"))
    assert ref.dtype == np.float32
    assert np.array_equal(ref, tensor.to(torch.float32).numpy())


@pytest.mark.parametrize("dtype", ["int8", "int16", "uint16", "float32",
                                   "uint8"])
def test_mrc_written_by_one_package_is_read_by_the_other(tmp_path, dtype):
    arr = _arr(dtype, (4, 9, 13), seed=6)
    io_mrc.save_mrc(str(tmp_path / "p.mrc"), arr, voxel_size_nm=VSIZE,
                    voxel_offset=OFFSET)
    jax_mrc.save_mrc(str(tmp_path / "j.mrc"), arr, voxel_size_nm=VSIZE)
    ref, ref_header = jax_mrc.load_mrc(str(tmp_path / "p.mrc"))
    got, got_header = io_mrc.load_mrc(str(tmp_path / "j.mrc"))
    # MRC has no uint8 mode: both packages write it as float32
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    assert np.array_equal(ref, arr.astype(ref.dtype))
    assert got_header["voxel_size_nm"] == ref_header["voxel_size_nm"]
    assert got_header["voxel_size_nm"] == VSIZE
    # the port keeps the offset in NXSTART..NZSTART; the JAX file has 0
    assert io_mrc.load_mrc(str(tmp_path / "p.mrc"))[1]["voxel_offset"] == \
        OFFSET
    assert got_header["voxel_offset"] == (0, 0, 0)


# ---------------------------------------------------------------------------
# zarr v2
# ---------------------------------------------------------------------------
def _ts_open(path, metadata=None, **kwargs):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": "zarr", "kvstore": {"driver": "file",
                                          "path": str(path)}}
    if metadata is not None:
        spec["metadata"] = metadata
    return ts.open(spec, **kwargs).result()


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32", "uint64"])
@pytest.mark.parametrize("chunks", [(4, 8, 8), (3, 7, 11), None])
def test_zarr_written_by_the_port_reads_in_tensorstore(tmp_path, dtype,
                                                       chunks):
    full = np.zeros((10, 20, 30), dtype=dtype)
    store = ZarrArray.create(str(tmp_path / "z"), full.shape, dtype,
                             chunks=chunks)
    for i, box in enumerate(((slice(1, 9), slice(3, 17), slice(2, 29)),
                             (slice(0, 4), slice(0, 8), slice(0, 8)),
                             (slice(5, 10), slice(10, 20), slice(20, 30)))):
        part = _arr(dtype, tuple(s.stop - s.start for s in box), seed=i)
        store.write(box, part)
        full[box] = part
    assert np.array_equal(_ts_open(tmp_path / "z").read().result(), full)
    assert np.array_equal(ZarrArray(str(tmp_path / "z")).read(), full)
    sub = (slice(2, 7), slice(5, 19), slice(1, 25))
    assert np.array_equal(ZarrArray(str(tmp_path / "z")).read(sub),
                          full[sub])


@pytest.mark.parametrize("compressor", [
    {"id": "zlib", "level": 5}, {"id": "gzip", "level": 3}, None])
@pytest.mark.parametrize("separator", [".", "/"])
def test_zarr_written_by_tensorstore_reads_in_the_port(tmp_path, compressor,
                                                       separator):
    arr = _arr("int16", (9, 14, 17), seed=7)
    meta = {"chunks": [4, 8, 8], "compressor": compressor,
            "dimension_separator": separator}
    store = _ts_open(tmp_path / "z", create=True, dtype="int16",
                     shape=arr.shape, metadata=meta)
    store[2:9, 0:14, 5:17] = arr[2:9, 0:14, 5:17]
    want = np.zeros_like(arr)
    want[2:9, 0:14, 5:17] = arr[2:9, 0:14, 5:17]
    port = ZarrArray(str(tmp_path / "z"))
    assert np.array_equal(port.read(), want)  # missing chunks: fill (0)
    # a partial write of the port's, read back by both
    port.write((slice(0, 3), slice(1, 6), slice(0, 4)), arr[:3, 1:6, :4])
    want[:3, 1:6, :4] = arr[:3, 1:6, :4]
    assert np.array_equal(_ts_open(tmp_path / "z").read().result(), want)
    assert np.array_equal(ZarrArray(str(tmp_path / "z")).read(), want)


def test_zarr_null_fill_reads_as_zeros_and_blosc_raises(tmp_path):
    """tensorstore's default zarr store (blosc, a null fill) reads
    bitwise; a blosc cname tensorstore does not write raises
    ``ValueError``, as tensorstore does."""
    store = _ts_open(tmp_path / "b", create=True, dtype="float32",
                     shape=(4, 6, 8))  # tensorstore's defaults: blosc, null
    meta = json.loads((tmp_path / "b" / ".zarray").read_text())
    assert meta["compressor"]["id"] == "blosc" and meta["fill_value"] is None
    store[1:4] = _arr("float32", (3, 6, 8))
    want = np.zeros((4, 6, 8), np.float32)
    want[1:4] = _arr("float32", (3, 6, 8))
    assert np.array_equal(ZarrArray(str(tmp_path / "b")).read(), want)
    meta["compressor"]["cname"] = "lzma"
    (tmp_path / "b" / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="lzma"):
        ZarrArray(str(tmp_path / "b"))
    with pytest.raises(ValueError):
        _ts_open(tmp_path / "b")
    meta.update(compressor={"id": "zlib", "level": 1})
    (tmp_path / "n").mkdir()
    (tmp_path / "n" / ".zarray").write_text(json.dumps(meta))
    assert np.array_equal(ZarrArray(str(tmp_path / "n")).read(),
                          np.zeros((4, 6, 8), np.float32))


def test_jax_save_zarr_reads_in_the_port(tmp_path):
    """The JAX CLI's ``save-zarr`` creates its store with tensorstore's
    default compressor (blosc); the port CLI's ``load-zarr`` and the
    port's ``load_tensorstore`` plugin read it bitwise."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox
    from chunkflow_tpu_torch.flow.plugin import load_plugin

    arr = _arr("uint16", (6, 20, 24), seed=11)
    task = jax_new_task()
    task["chunk"] = JaxChunk(arr.copy(), voxel_offset=(2, 4, 8))
    store = str(tmp_path / "z")
    list(jax_stage(["save-zarr", "-p", store])(iter([task])))
    meta = json.loads((tmp_path / "z" / ".zarray").read_text())
    assert meta["compressor"]["id"] == "blosc"
    box = ((2, 4, 8), (8, 24, 32))
    args = ["load-zarr", "-p", store]
    port_task, jax_task = new_task(), jax_new_task()
    port_task["bbox"], jax_task["bbox"] = BoundingBox(*box), JaxBox(*box)
    got = list(port_stage(args)(iter([port_task])))[0]["chunk"]
    ref = list(jax_stage(args)(iter([jax_task])))[0]["chunk"]
    assert_same_chunk(got, ref)
    assert np.array_equal(got.array, arr)
    plugin = load_plugin("load_tensorstore")(BoundingBox(*box),
                                            kvstore=f"file://{store}")
    assert np.array_equal(plugin.array, arr)


def test_zarr_selection_outside_the_array_raises(tmp_path):
    store = ZarrArray.create(str(tmp_path / "z"), (4, 5, 6), "uint8")
    with pytest.raises(IndexError, match="outside"):
        store.read((slice(0, 5),))
    with pytest.raises(ValueError, match="writing"):
        store.write((slice(0, 2),), np.zeros((3, 5, 6), np.uint8))


@pytest.mark.parametrize("start", [None, (2, 3, 4)])
def test_save_zarr_and_load_zarr_match_the_jax_cli(tmp_path, start):
    """The port creates the store, tensorstore's default blosc-lz4 one;
    the JAX ``save-zarr`` writes into it; each package's ``load-zarr``
    reads what both wrote."""
    pytest.importorskip("tensorstore")
    arr = _arr("uint16", (5, 12, 14), seed=8)
    port_task, jax_task = new_task(), jax_new_task()
    port_task["chunk"] = Chunk(arr, voxel_offset=(1, 2, 3))
    second = _arr("uint16", (5, 12, 14), seed=9)
    jax_task["chunk"] = JaxChunk(second, voxel_offset=(6, 2, 3))
    store = str(tmp_path / "s")
    list(port_stage(["save-zarr", "-p", store, "--volume-size", "12", "16",
                     "20", "--chunk-size", "4", "8", "8"])(iter([port_task])))
    assert json.loads((tmp_path / "s" / ".zarray").read_text())[
        "compressor"] == {"blocksize": 0, "clevel": 5, "cname": "lz4",
                          "id": "blosc", "shuffle": -1}
    list(jax_stage(["save-zarr", "-p", store])(iter([jax_task])))
    want = np.zeros((12, 16, 20), np.uint16)
    want[1:6, 2:14, 3:17] = arr
    want[6:11, 2:14, 3:17] = second
    args = ["load-zarr", "-p", store]
    if start is not None:
        args += ["--chunk-start", *map(str, start), "--chunk-size", "4", "5",
                 "6"]
    else:
        args += ["--voxel-size", "40", "4", "4"]
    got = list(port_stage(args)(iter([new_task()])))[0]["chunk"]
    ref = list(jax_stage(args)(iter([jax_new_task()])))[0]["chunk"]
    assert_same_chunk(got, ref)
    if start is None:
        assert np.array_equal(got.array, want)
    # a task bbox is the cutout when no explicit box is given
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    box = ((0, 1, 2), (7, 9, 11))
    port_task, jax_task = new_task(), jax_new_task()
    port_task["bbox"], jax_task["bbox"] = BoundingBox(*box), JaxBox(*box)
    got = list(port_stage(["load-zarr", "-p", store])(iter([port_task])))
    ref = list(jax_stage(["load-zarr", "-p", store])(iter([jax_task])))
    assert_same_chunk(got[0]["chunk"], ref[0]["chunk"])


def test_save_zarr_creates_a_store_covering_the_chunk(tmp_path):
    task = new_task()
    task["chunk"] = Chunk(_arr("float32", (3, 4, 5)), voxel_offset=(2, 3, 4))
    list(port_stage(["save-zarr", "--store", str(tmp_path / "z"),
                     "--dtype", "float64"])(iter([task])))
    got = _ts_open(tmp_path / "z").read().result()
    assert got.shape == (5, 7, 9) and got.dtype == np.float64
    assert np.array_equal(got[2:, 3:, 4:], task["chunk"].array)


ZARR3_N5 = {
    "zarr3-bytes": ("zarr3", None),
    "zarr3-big-endian-gzip": ("zarr3", {
        "codecs": [{"name": "bytes", "configuration": {"endian": "big"}},
                   {"name": "gzip", "configuration": {"level": 5}}],
        "chunk_grid": {"name": "regular",
                       "configuration": {"chunk_shape": [2, 4, 4]}},
        "chunk_key_encoding": {"name": "default",
                               "configuration": {"separator": "."}}}),
    "zarr3-v2-keys": ("zarr3", {
        "chunk_key_encoding": {"name": "v2"},
        "chunk_grid": {"name": "regular",
                       "configuration": {"chunk_shape": [4, 5, 6]}}}),
    "n5-raw": ("n5", {"compression": {"type": "raw"},
                      "blockSize": [4, 5, 6]}),
    "n5-gzip": ("n5", {"compression": {"type": "gzip"},
                       "blockSize": [2, 4, 8]}),
}


def _ts_store(path, driver, metadata, dtype, shape):
    ts = pytest.importorskip("tensorstore")
    spec = {"driver": driver, "kvstore": {"driver": "file",
                                          "path": str(path)}}
    if metadata is not None:
        spec["metadata"] = metadata
    return ts.open(spec, create=True, dtype=dtype, shape=shape).result()


@pytest.mark.parametrize("name", sorted(ZARR3_N5))
def test_load_zarr_drivers_match_the_jax_cli(tmp_path, name):
    """``load-zarr --driver zarr3/n5`` reads what tensorstore wrote (partly
    written: the missing chunks read as zeros), as the JAX CLI does."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    driver, metadata = ZARR3_N5[name]
    arr = _arr("float32", (9, 14, 17), seed=13)
    store = _ts_store(tmp_path / "s", driver, metadata, "float32", arr.shape)
    store[2:9, 1:14, 3:17] = arr[2:9, 1:14, 3:17]
    base = ["load-zarr", "-p", str(tmp_path / "s"), "--driver", driver]
    for args, box in ((base + ["--voxel-size", "40", "4", "4"], None),
                      (base + ["--chunk-start", "1", "3", "2",
                               "--chunk-size", "6", "8", "13"], None),
                      (base, ((0, 2, 5), (9, 12, 17)))):
        port_task, jax_task = new_task(), jax_new_task()
        if box is not None:
            port_task["bbox"], jax_task["bbox"] = (BoundingBox(*box),
                                                   JaxBox(*box))
        got = list(port_stage(args)(iter([port_task])))[0]["chunk"]
        ref = list(jax_stage(args)(iter([jax_task])))[0]["chunk"]
        assert_same_chunk(got, ref)


@pytest.mark.parametrize("driver", ["zarr3", "n5"],
                         ids=["zarr3-zstd", "n5-blosc"])
def test_zarr3_and_n5_codecs_outside_the_stdlib_raise(tmp_path, driver):
    """zstd zarr v3 and blosc N5 (tensorstore's N5 default) read bitwise,
    and so do the codecs the port once lacked (zarr v3
    ``sharding_indexed``, N5 xz); a codec no store of tensorstore's holds
    raises ``ValueError`` in both."""
    from chunkflow_tpu_torch.volume.zarr import open_array

    ts = pytest.importorskip("tensorstore")
    arr = _arr("uint16", (4, 5, 6), seed=12)
    codecs = {"zarr3": [{"name": "bytes"}, {"name": "zstd"}]}
    once_unported = {
        "zarr3": {"codec": ts.CodecSpec({"driver": "zarr3", "codecs": [{
            "name": "sharding_indexed", "configuration": {
                "chunk_shape": [2, 5, 6], "codecs": [{"name": "bytes"}],
                "index_codecs": [{"name": "bytes"},
                                 {"name": "crc32c"}]}}]})},
        "n5": {"codec": ts.CodecSpec({"driver": "n5",
                                      "compression": {"type": "xz"}})}}
    for name, kwargs in (("s", {"codec": ts.CodecSpec(
            {"driver": "zarr3", "codecs": codecs["zarr3"]})}
            if driver == "zarr3" else {}), ("u", once_unported[driver])):
        spec = {"driver": driver, "kvstore": {"driver": "file",
                                              "path": str(tmp_path / name)}}
        store = ts.open(spec, create=True, dtype="uint16", shape=arr.shape,
                        **kwargs).result()
        store[...] = arr
        got = open_array(str(tmp_path / name), driver).read()
        assert np.array_equal(got, arr)
        assert np.array_equal(got, store.read().result())
    # a codec no store of tensorstore's holds
    meta_file = {"zarr3": "zarr.json", "n5": "attributes.json"}[driver]
    meta = json.loads((tmp_path / "u" / meta_file).read_text())
    if driver == "zarr3":
        meta["codecs"] = [{"name": "bytes"}, {"name": "lz77"}]
    else:
        meta["compression"] = {"type": "lz77"}
    (tmp_path / "u" / meta_file).write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="lz77"):
        open_array(str(tmp_path / "u"), driver)
    with pytest.raises(ValueError):
        ts.open({"driver": driver, "kvstore": {
            "driver": "file", "path": str(tmp_path / "u")}}).result()


# ---------------------------------------------------------------------------
# the file commands through both CLIs
# ---------------------------------------------------------------------------
def _both_write(tmp_path, args, arr, **meta):
    """Run one writing command of each CLI on the same chunk, each into
    its own directory; ``{}`` in ``args`` is that directory."""
    dirs = {}
    for tag, stage, task, cls in (("jax", jax_stage, jax_new_task(),
                                   JaxChunk),
                                  ("port", port_stage, new_task(), Chunk)):
        d = tmp_path / tag
        d.mkdir()
        task["chunk"] = cls(arr.copy(), **dict(
            dict(voxel_offset=OFFSET, voxel_size=VSIZE), **meta))
        list(stage([a.replace("{}", str(d)) for a in args])(iter([task])))
        dirs[tag] = d
    return dirs["jax"], dirs["port"]


WRITE_COMMANDS = {
    "save-h5": ["save-h5", "-f", "{}/c.h5"],
    "save-h5-prefix": ["save-h5", "--file-name-prefix", "{}/p-", "-s", "2",
                       "4", "4", "-c", "lzf", "--without-offset"],
    "save-h5-dtype-vsize": ["save-h5", "-f", "{}/c.h5", "-d", "float32",
                            "-v", "8", "8", "8"],
    "save-tif": ["save-tif", "-f", "{}/c.tif", "--compression", "lzw"],
    "save-tif-dtype": ["save-tif", "-f", "{}/c.tif", "-d", "uint16"],
    "save-pngs": ["save-pngs", "-o", "{}/png"],
    "save-nrrd": ["save-nrrd", "-f", "{}/c.nrrd"],
}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("name", sorted(WRITE_COMMANDS))
def test_write_command_matches_the_jax_cli(tmp_path, name):
    jax_dir, port_dir = _both_write(tmp_path, WRITE_COMMANDS[name],
                                    _arr("uint8", (4, 12, 14), seed=10))
    assert _files(port_dir) == _files(jax_dir)
    for rel in _files(jax_dir):
        if rel.endswith(".h5"):  # HDF5 files carry creation times
            assert_same_chunk(Chunk.from_h5(str(port_dir / rel)),
                              JaxChunk.from_h5(str(jax_dir / rel)))
        else:
            assert _same_file_bytes(port_dir / rel, jax_dir / rel), rel


LOAD_H5 = {
    "whole": [],
    "cutout-size": ["--cutout-start", "4", "7", "9", "--cutout-size", "2",
                    "5", "6"],
    "cutout-stop": ["-t", "3", "5", "7", "-p", "6", "10", "12", "-x", "8",
                    "8", "8"],
    "channels": ["-c", "0,2", "-e", "float64", "-l", "image",
                 "--set-bbox"],
    "offset-override": ["-v", "0", "0", "0", "-d", "main"],
}


@pytest.mark.parametrize("name", sorted(LOAD_H5))
def test_load_h5_matches_the_jax_cli(tmp_path, name):
    arr = _arr("float32", (3, 4, 12, 14), seed=11)
    path = JaxChunk(arr, voxel_offset=OFFSET, voxel_size=VSIZE).to_h5(
        str(tmp_path / "c.h5"))
    args = ["load-h5", "-f", path, *LOAD_H5[name]]
    got = list(port_stage(args)(iter([new_task()])))[0]
    ref = list(jax_stage(args)(iter([jax_new_task()])))[0]
    assert_same_chunk(got["chunk"], ref["chunk"])
    assert (got.get("bbox") is None) == (ref.get("bbox") is None)
    if ref.get("bbox") is not None:
        assert got["bbox"].string == ref["bbox"].string


def test_load_h5_prefix_from_the_task_bbox_and_remove_empty(tmp_path):
    """A non-.h5 file name is a prefix completed by the task bbox;
    ``--remove-empty`` deletes an all-zero file, in both CLIs."""
    from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
    from chunkflow_tpu_torch import BoundingBox

    box = ((3, 5, 7), (7, 17, 21))
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        JaxChunk(_arr("uint8", (4, 12, 14)), voxel_offset=box[0]).to_h5(
            str(d / f"t-{JaxBox(*box).string}.h5"))
        JaxChunk(np.zeros((4, 12, 14), np.uint8), voxel_offset=box[0]).to_h5(
            str(d / f"z-{JaxBox(*box).string}.h5"))
    results = {}
    for tag, stage, task, box_cls in (
            ("jax", jax_stage, jax_new_task(), JaxBox),
            ("port", port_stage, new_task(), BoundingBox)):
        task["bbox"] = box_cls(*box)
        d = tmp_path / tag
        out = list(stage(["load-h5", "-f", f"{d}/t-", "--remove-empty"])(
            iter([dict(task)])))[0]
        zero = list(stage(["load-h5", "-f", f"{d}/z-", "--remove-empty",
                           "-o", "z"])(iter([dict(task)])))[0]
        results[tag] = (out["chunk"], zero["z"], sorted(os.listdir(d)))
    assert_same_chunk(results["port"][0], results["jax"][0])
    assert_same_chunk(results["port"][1], results["jax"][1])
    assert results["port"][2] == results["jax"][2] == [
        f"t-{JaxBox(*box).string}.h5"]


def test_load_h5_needs_a_cutout_end():
    with pytest.raises(cli.UsageError, match="cutout"):
        port_stage(["load-h5", "-f", "x.h5", "-t", "1", "2", "3"])
    with pytest.raises(cli.UsageError, match="exactly one"):
        port_stage(["save-h5"])
    with pytest.raises(cli.UsageError, match="together"):
        port_stage(["load-zarr", "-p", "x", "--chunk-start", "1", "2", "3"])


LOAD_OTHER = {
    "load-tif": ("c.tif", ["load-tif", "-f", "{}/c.tif", "-v", "1", "2",
                           "3", "-s", "40", "4", "4", "-l", "segmentation",
                           "-d", "uint32"]),
    "load-png": ("png", ["load-png", "-p", "{}/png", "-t", "3", "0", "0",
                         "-x", "40", "4", "4", "-c", "4", "2", "3", "-s",
                         "2", "6", "7", "--dtype", "float32"]),
    "load-png-whole": ("png", ["load-png", "-p", "{}/png", "-d", "5"]),
}


@pytest.mark.parametrize("name", sorted(LOAD_OTHER))
def test_load_command_matches_the_jax_cli(tmp_path, name):
    what, args = LOAD_OTHER[name]
    chunk = JaxChunk(_arr("uint8", (4, 12, 14), seed=12),
                     voxel_offset=(3, 0, 0))
    if what == "c.tif":
        chunk.to_tif(str(tmp_path / "c.tif"))
    else:
        jax_png.save_pngs(chunk, str(tmp_path / "png"))
    args = [a.replace("{}", str(tmp_path)) for a in args]
    got = list(port_stage(args)(iter([new_task()])))[0]["chunk"]
    ref = list(jax_stage(args)(iter([jax_new_task()])))[0]["chunk"]
    assert_same_chunk(got, ref)


CHAINS = {
    # the README's quick start, with the identity engine
    "quick-start": (["load-h5", "-f", "{in}", "inference", "-f",
                     "identity", "-p", "4", "16", "16", "-v", "2", "8", "8",
                     "-c", "3", "-b", "2", "save-h5", "-f", "{out}"]),
    "quick-start-uint8": (["load-h5", "-f", "{in}", "inference", "-f",
                           "identity", "-p", "4", "16", "16", "-v", "2", "8",
                           "8", "-c", "3", "-b", "2", "--output-dtype",
                           "uint8", "save-h5", "-f", "{out}"]),
    "cutout-normalize": (["load-h5", "-f", "{in}", "--cutout-start", "4",
                          "6", "8", "--cutout-size", "4", "20", "20",
                          "normalize-intensity", "save-h5", "-f", "{out}"]),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_h5_command_line_matches_the_jax_cli(tmp_path, name):
    """The same command line through both CLIs: each reads the other's
    output file as its own."""
    image = JaxChunk.create((8, 32, 32), dtype=np.uint8, pattern="sin",
                            voxel_offset=OFFSET, voxel_size=VSIZE)
    src = image.to_h5(str(tmp_path / "image.h5"))
    outs = {tag: str(tmp_path / f"{tag}.h5") for tag in ("jax", "port")}
    args = {tag: [a.format(**{"in": src, "out": out}) if "{" in a else a
                  for a in CHAINS[name]] for tag, out in outs.items()}
    assert cli.main(["--device", "cpu", *args["port"]]) == 0
    result = CliRunner().invoke(jax_main, args["jax"],
                                catch_exceptions=False)
    assert result.exit_code == 0, result.output
    assert_same_chunk(JaxChunk.from_h5(outs["port"]),
                      JaxChunk.from_h5(outs["jax"]))
    assert_same_chunk(Chunk.from_h5(outs["jax"]),
                      JaxChunk.from_h5(outs["port"]))
