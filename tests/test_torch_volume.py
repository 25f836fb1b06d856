"""The port's storage plane and precomputed volumes against the JAX package.

The JAX ``PrecomputedVolume`` runs on tensorstore, as its own tests run
it; the port's reads and writes the same ``raw`` files with numpy. Each
package writes and the other reads, bitwise: uint8 one-channel and
float32 three-channel volumes, a voxel offset that is no multiple of the
block, a ragged high edge (clipped edge blocks), mip 1 of a two-mip
volume, partial writes. Also the info files, block names and existence,
the save conversions, missing and corrupt blocks, the read paths (block
by block == one read, cache hit == miss, read after write through the
cache) and the task files of both packages.
"""
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("tensorstore")

from chunkflow_tpu.chunk.base import Chunk as JaxChunk
from chunkflow_tpu.core.bbox import BoundingBox as JaxBox
from chunkflow_tpu.core.bbox import BoundingBoxes as JaxBoxes
from chunkflow_tpu.volume import storage as jax_storage
from chunkflow_tpu.volume.precomputed import PrecomputedVolume as JaxVolume
from chunkflow_tpu.volume.precomputed import load_chunk_or_volume as jax_load
from chunkflow_tpu_torch import BoundingBox, Chunk
from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.core.bbox import BoundingBoxes
from chunkflow_tpu_torch.flow import cli
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.precomputed import (
    PrecomputedVolume,
    load_chunk_or_volume,
)

# the suite runs in several pytest-xdist workers on one machine: each
# worker's default intra-op pool (a thread per core) oversubscribes it,
# which slows every worker and starves the timing tests beside them
torch.set_num_threads(1)

SIZE = (16, 60, 70)          # ragged against the blocks in y and x
BLOCK = (8, 32, 32)
OFFSET = (3, 5, 7)           # no multiple of the block
FULL = (OFFSET, tuple(o + s for o, s in zip(OFFSET, SIZE)))


@pytest.fixture(autouse=True)
def fresh_caches(monkeypatch):
    """Both packages keep a process-wide block cache keyed by path; a
    volume one package wrote must not be served from the other's cache."""
    for var in ("CHUNKFLOW_STORAGE", "CHUNKFLOW_STORAGE_CACHE_MB",
                "CHUNKFLOW_STORAGE_CONCURRENCY", "CHUNKFLOW_TELEMETRY"):
        monkeypatch.delenv(var, raising=False)
    storage.reset_shared_cache()
    jax_storage.reset_shared_cache()
    telemetry.reset()
    yield
    storage.reset_shared_cache()
    jax_storage.reset_shared_cache()


def _create(cls, path, dtype="uint8", channels=1, mips=1, **kwargs):
    return cls.create(str(path), volume_size=SIZE, voxel_size=(40, 4, 4),
                      voxel_offset=OFFSET, num_channels=channels, dtype=dtype,
                      block_size=BLOCK, num_mips=mips, **kwargs)


def _data(dtype, channels, shape=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((channels,) if channels > 1 else ()) + tuple(shape)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _files(path):
    out = {}
    for root, _dirs, names in os.walk(path):
        for name in names:
            if name == "info" or root.endswith("log"):
                continue
            with open(os.path.join(root, name), "rb") as f:
                out[os.path.relpath(os.path.join(root, name), path)] = f.read()
    return out


def _port_read(path, box, mip=0, **kwargs):
    return PrecomputedVolume(str(path)).cutout(BoundingBox(*box), mip=mip,
                                               **kwargs).array


def _jax_read(path, box, mip=0):
    jax_storage.reset_shared_cache()
    return np.asarray(JaxVolume(str(path)).cutout(JaxBox(*box), mip=mip).array)


# ---------------------------------------------------------------------------
# cross-format reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype, channels", [("uint8", 1), ("float32", 3)])
def test_each_package_reads_what_the_other_wrote(tmp_path, dtype, channels):
    data = _data(dtype, channels)
    _create(PrecomputedVolume, tmp_path / "port", dtype, channels).save(
        Chunk(data, voxel_offset=OFFSET))
    _create(JaxVolume, tmp_path / "jax", dtype, channels).save(
        JaxChunk(data, voxel_offset=OFFSET))
    assert np.array_equal(_jax_read(tmp_path / "port", FULL), data)
    assert np.array_equal(_port_read(tmp_path / "jax", FULL), data)
    # the same files, byte for byte: edge blocks clipped in name and size
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax) and len(port) == 2 * 2 * 3
    assert "4_4_40/39-71_37-65_11-19" in port
    assert all(port[name] == jax[name] for name in port)
    # a window across block corners
    window = ((5, 20, 30), (17, 50, 70))
    want = data[..., 2:14, 15:45, 23:63]
    assert np.array_equal(_port_read(tmp_path / "jax", window), want)
    assert np.array_equal(_jax_read(tmp_path / "port", window), want)


@pytest.mark.parametrize("dtype, channels", [("uint8", 1), ("float32", 3)])
def test_partial_writes_read_the_same(tmp_path, dtype, channels):
    """Unaligned writes over existing and absent blocks (read, modify,
    write) leave the same files in both packages."""
    base = _data(dtype, channels)
    patch = _data(dtype, channels, shape=(7, 30, 39), seed=1)
    for cls, chunk_cls, name in ((PrecomputedVolume, Chunk, "port"),
                                 (JaxVolume, JaxChunk, "jax")):
        vol = _create(cls, tmp_path / name, dtype, channels)
        vol.save(chunk_cls(base[..., :8, :32, :32], voxel_offset=OFFSET))
        vol.save(chunk_cls(patch, voxel_offset=(5, 15, 18)))
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    assert all(port[name] == jax[name] for name in port)
    assert np.array_equal(_port_read(tmp_path / "jax", FULL),
                          _jax_read(tmp_path / "port", FULL))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mip_one_of_a_two_mip_volume(tmp_path, writer):
    coarse = _data("uint8", 1, shape=(16, 30, 35), seed=2)
    port = _create(PrecomputedVolume, tmp_path / "port", mips=2)
    jax = _create(JaxVolume, tmp_path / "jax", mips=2)
    assert port.info == jax.info
    bounds = port.bounds(1)
    assert tuple(bounds.start) == (3, 2, 3) and tuple(bounds.shape) == \
        (16, 30, 35)
    if writer == "port":
        port.save(Chunk(coarse, voxel_offset=bounds.start), mip=1)
        got = _jax_read(tmp_path / "port", (bounds.start, bounds.stop), mip=1)
    else:
        jax.save(JaxChunk(coarse, voxel_offset=tuple(bounds.start)), mip=1)
        got = _port_read(tmp_path / "jax", (bounds.start, bounds.stop), mip=1)
    assert np.array_equal(got, coarse)


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kwargs", [
    dict(dtype="uint8", channels=1, mips=1),
    dict(dtype="float32", channels=3, mips=3),
    dict(dtype="uint32", channels=1, mips=2, layer_type="segmentation"),
])
def test_info_is_the_jax_packages(tmp_path, kwargs):
    port = _create(PrecomputedVolume, tmp_path / "port", **kwargs)
    jax = _create(JaxVolume, tmp_path / "jax", **kwargs)
    with open(tmp_path / "port" / "info") as f:
        on_disk = json.load(f)
    assert on_disk == jax.info == port.info
    assert PrecomputedVolume(str(tmp_path / "jax")).layer_type == \
        jax.layer_type
    for mip in range(kwargs["mips"]):
        assert tuple(port.bounds(mip).start) == tuple(jax.bounds(mip).start)
        assert tuple(port.bounds(mip).stop) == tuple(jax.bounds(mip).stop)
        assert tuple(port.block_size(mip)) == tuple(jax.block_size(mip))
        assert tuple(port.voxel_size(mip)) == tuple(jax.voxel_size(mip))


def test_block_names_and_existence_after_partial_writes(tmp_path):
    port = _create(PrecomputedVolume, tmp_path / "port")
    jax = _create(JaxVolume, tmp_path / "jax")
    data = _data("uint8", 1)
    first = ((3, 5, 7), (11, 37, 39))        # exactly one block
    port.save(Chunk(data[:8, :32, :32], voxel_offset=first[0]))
    jax.save(JaxChunk(data[:8, :32, :32], voxel_offset=first[0]))
    boxes = [first, ((3, 5, 7), (19, 65, 77)), ((4, 6, 8), (10, 36, 38)),
             ((11, 37, 39), (19, 65, 77)), ((12, 40, 40), (13, 41, 41))]
    for lo, hi in boxes:
        assert port.block_names(BoundingBox(lo, hi)) == \
            jax.block_names(JaxBox(lo, hi))
        assert port.has_all_blocks(BoundingBox(lo, hi)) == \
            jax.has_all_blocks(JaxBox(lo, hi))
    assert port.has_all_blocks(BoundingBox(*first))
    assert not port.has_all_blocks(BoundingBox(*FULL))


# ---------------------------------------------------------------------------
# save conversions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk_dtype, volume_dtype", [
    ("uint8", "float32"),    # divided by 255
    ("float32", "uint8"),    # clipped to [0, 1], scaled, truncated
])
def test_save_conversions_are_the_jax_packages(tmp_path, chunk_dtype,
                                               volume_dtype):
    rng = np.random.default_rng(3)
    if chunk_dtype == "uint8":
        data = rng.integers(0, 256, (3,) + SIZE, dtype=np.uint8)
    else:  # values outside [0, 1] on both sides
        data = (rng.random((3,) + SIZE, dtype=np.float32) * 1.6 - 0.3)
    _create(PrecomputedVolume, tmp_path / "port", volume_dtype, 3).save(
        Chunk(data, voxel_offset=OFFSET))
    _create(JaxVolume, tmp_path / "jax", volume_dtype, 3).save(
        JaxChunk(data, voxel_offset=OFFSET))
    port, jax = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(jax)
    assert all(port[name] == jax[name] for name in port)
    got = _port_read(tmp_path / "port", FULL)
    assert got.dtype == np.dtype(volume_dtype)
    if volume_dtype == "uint8":
        assert got.min() == 0 and got.max() == 255


def test_bfloat16_chunk_saves_as_float32(tmp_path):
    data = torch.rand((3,) + SIZE, generator=torch.Generator().manual_seed(0))
    vol = _create(PrecomputedVolume, tmp_path / "port", "float32", 3)
    vol.save(Chunk(data.to(torch.bfloat16), voxel_offset=OFFSET))
    want = data.to(torch.bfloat16).to(torch.float32).numpy()
    assert np.array_equal(_jax_read(tmp_path / "port", FULL), want)


# ---------------------------------------------------------------------------
# missing and corrupt blocks
# ---------------------------------------------------------------------------
def test_missing_blocks_fill_or_raise(tmp_path):
    vol = _create(PrecomputedVolume, tmp_path / "port")
    vol.save(Chunk(_data("uint8", 1)[:8, :32, :32], voxel_offset=OFFSET))
    box = BoundingBox((5, 20, 30), (17, 50, 70))
    got = vol.cutout(box).array
    assert np.array_equal(got, _jax_read(tmp_path / "port",
                                         (box.start, box.stop)))
    assert not got[6:].any()  # the absent blocks read as zeros
    with pytest.raises(FileNotFoundError, match="strict read"):
        vol.cutout(box, fill_missing=False)
    inside = BoundingBox((4, 6, 8), (10, 36, 38))
    assert vol.cutout(inside, fill_missing=False).array.any()


@pytest.mark.parametrize("damage", ["truncated", "too_long", "empty"])
def test_a_corrupt_block_raises_and_is_never_zeros(tmp_path, damage):
    vol = _create(PrecomputedVolume, tmp_path / "port")
    vol.save(Chunk(_data("uint8", 1), voxel_offset=OFFSET))
    path = tmp_path / "port" / "4_4_40" / "7-39_5-37_3-11"
    data = path.read_bytes()
    path.write_bytes({"truncated": data[:-1], "too_long": data + b"\0",
                      "empty": b""}[damage])
    storage.reset_shared_cache()
    for fill in (True, False):
        with pytest.raises(storage.CorruptBlockError, match="corrupt block"):
            PrecomputedVolume(str(tmp_path / "port")).cutout(
                BoundingBox(*FULL), fill_missing=fill)


# ---------------------------------------------------------------------------
# read paths
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [FULL, ((5, 20, 30), (17, 50, 70)),
                                    ((3, 5, 7), (4, 6, 8))])
def test_blockwise_read_is_one_read_and_cache_hits_are_misses(
        tmp_path, monkeypatch, window):
    data = _data("float32", 3)
    _create(PrecomputedVolume, tmp_path / "v", "float32", 3).save(
        Chunk(data, voxel_offset=OFFSET))
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
    cold = _port_read(tmp_path / "v", window)
    monkeypatch.setenv("CHUNKFLOW_STORAGE", "serial")
    serial = _port_read(tmp_path / "v", window)
    monkeypatch.delenv("CHUNKFLOW_STORAGE")
    monkeypatch.delenv("CHUNKFLOW_STORAGE_CACHE_MB")
    storage.reset_shared_cache()
    telemetry.reset()
    miss = _port_read(tmp_path / "v", window)
    hit = _port_read(tmp_path / "v", window)
    counters = telemetry.snapshot()["counters"]
    assert counters["storage/hits"] == counters["storage/misses"] > 0
    lo = tuple(w - o for w, o in zip(window[0], OFFSET))
    hi = tuple(w - o for w, o in zip(window[1], OFFSET))
    want = data[(slice(None),) + tuple(slice(a, b) for a, b in zip(lo, hi))]
    for got in (cold, serial, miss, hit):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("box", [((3, 5, 7), (11, 37, 39)),     # aligned
                                 ((5, 15, 18), (12, 45, 57))])  # unaligned
def test_read_after_write_through_the_cache(tmp_path, box):
    vol = _create(PrecomputedVolume, tmp_path / "v", "float32", 3)
    vol.save(Chunk(_data("float32", 3), voxel_offset=OFFSET))
    vol.cutout(BoundingBox(*FULL))  # every block cached
    shape = tuple(b - a for a, b in zip(*box))
    new = _data("float32", 3, shape=shape, seed=4)
    vol.save(Chunk(new, voxel_offset=box[0]))
    assert np.array_equal(vol.cutout(BoundingBox(*box)).array, new)
    assert np.array_equal(_jax_read(tmp_path / "v", box), new)


def test_async_save_is_durable_once_drained(tmp_path):
    data = _data("float32", 3)
    vol = _create(PrecomputedVolume, tmp_path / "v", "float32", 3)
    chunk = Chunk(data.copy(), voxel_offset=OFFSET)
    future = vol.save(chunk, wait=False)
    chunk.array[:] = 0  # the caller may reuse its buffer at once
    future.result()
    assert np.array_equal(_jax_read(tmp_path / "v", FULL), data)


def test_cloud_roots_open_and_unknown_codecs_raise(tmp_path, monkeypatch):
    # gs:// and s3:// open through the port's own clients, here against
    # local fakes (tests/test_torch_cloud_storage.py holds them against
    # the JAX package)
    from chunkflow_tpu_torch.testing import cloud_fakes

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
    monkeypatch.delenv("GOOGLE_APPLICATION_CREDENTIALS", raising=False)
    with cloud_fakes.FakeGCS() as gcs, cloud_fakes.FakeS3(secrets={
            cloud_fakes.ACCESS_KEY: cloud_fakes.SECRET_KEY}) as s3:
        for key, value in cloud_fakes.cloud_env(gcs=gcs.url,
                                                s3=s3.url).items():
            monkeypatch.setenv(key, value)
        data = _data("float32", 3)
        for url in ("gs://bucket/v", "s3://bucket/v"):
            vol = _create(PrecomputedVolume, url, "float32", 3)
            vol.save(Chunk(data, voxel_offset=OFFSET))
            storage.reset_shared_cache()
            got = PrecomputedVolume(url).cutout(BoundingBox(*FULL)).array
            assert np.array_equal(got, data)
        assert gcs.objects.keys() == s3.objects.keys()
    # every precomputed encoding is ported (tests/test_torch_encodings.py):
    # an encoding or a sharding that neither package reads raises
    # ValueError at the first read, in both
    for name, change in (("lz4", {"encoding": "lz4"}),
                         ("sharded", {"sharding": {"@type":
                                                   "neuroglancer_uint64_"
                                                   "sharded_v2"}})):
        vol = _create(JaxVolume, tmp_path / name)
        info = dict(vol.info)
        info["scales"] = [dict(info["scales"][0], **change)]
        (tmp_path / name / "info").write_text(json.dumps(info))
        with pytest.raises(ValueError):
            _port_read(tmp_path / name, FULL)
        with pytest.raises(ValueError):
            _jax_read(tmp_path / name, FULL)
    # a zarr store in tensorstore's default codec (blosc) reads; one
    # whose compressor tensorstore does not register raises ValueError, as
    # tensorstore does
    from chunkflow_tpu_torch.volume.zarr import ZarrArray

    (tmp_path / "z").mkdir()
    meta = {
        "zarr_format": 2, "shape": [4, 4, 4], "chunks": [4, 4, 4],
        "dtype": "|u1", "order": "C", "filters": None, "fill_value": None,
        "dimension_separator": ".",
        "compressor": {"id": "blosc", "cname": "lz4", "clevel": 5,
                       "shuffle": -1, "blocksize": 0}}
    (tmp_path / "z" / ".zarray").write_text(json.dumps(meta))
    assert not ZarrArray(str(tmp_path / "z")).read().any()
    meta["compressor"] = {"id": "lzma"}
    (tmp_path / "z" / ".zarray").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="lzma"):
        ZarrArray(str(tmp_path / "z"))


def test_load_chunk_or_volume(tmp_path):
    data = _data("uint8", 1)
    vol = PrecomputedVolume.from_chunk(Chunk(data, voxel_offset=OFFSET),
                                       str(tmp_path / "v"),
                                       block_size=BLOCK)
    assert np.array_equal(_jax_read(tmp_path / "v", FULL), data)
    assert isinstance(load_chunk_or_volume(str(tmp_path / "v")),
                      PrecomputedVolume)
    got = load_chunk_or_volume(str(tmp_path / "v"), bbox=BoundingBox(*FULL))
    assert np.array_equal(got.array, data)
    np.save(tmp_path / "c.npy", data)
    assert np.array_equal(load_chunk_or_volume(str(tmp_path / "c.npy")).array,
                          data)
    assert vol.info["type"] == "image"
    # h5 (cut out over a bbox) and tif files, as the JAX package loads them
    JaxChunk(data, voxel_offset=OFFSET).to_h5(str(tmp_path / "c.h5"))
    JaxChunk(data).to_tif(str(tmp_path / "c.tif"))
    box = BoundingBox((4, 9, 9), (8, 29, 29))
    got = load_chunk_or_volume(str(tmp_path / "c.h5"), bbox=box)
    ref = jax_load(str(tmp_path / "c.h5"), bbox=JaxBox((4, 9, 9), (8, 29, 29)))
    assert np.array_equal(got.array, ref.array) and got.bbox == box
    assert np.array_equal(load_chunk_or_volume(str(tmp_path / "c.tif")).array,
                          data)


# ---------------------------------------------------------------------------
# the CLI's volume commands
# ---------------------------------------------------------------------------
def test_load_precomputed_options(tmp_path):
    data = _data("uint8", 1)
    _create(PrecomputedVolume, tmp_path / "v").save(
        Chunk(data, voxel_offset=OFFSET))
    (tmp_path / "v" / "blackout_section_ids.json").write_text(
        json.dumps({"section_ids": [5, 6, 40]}))
    out = tmp_path / "c.npy"
    assert cli.main(["--device", "cpu", "load-precomputed", "-v",
                     str(tmp_path / "v"), "--chunk-start", "4", "9", "9",
                     "--chunk-size", "4", "20", "20", "--blackout-sections",
                     "save-npy", "-f", str(out)]) == 0
    want = data[1:5, 4:24, 2:22].copy()
    want[1:3] = 0  # sections 5 and 6
    assert np.array_equal(np.load(out), want)
    # --validate-mip and --create-thumbnail run (their parity with the JAX
    # CLI: tests/test_torch_segment_ops.py): a volume of one mip has no
    # coarser mip to validate against, and no pyramid to write
    with pytest.raises(ValueError, match="must be coarser"):
        cli.main(["--device", "cpu", "load-precomputed", "-v",
                  str(tmp_path / "v"), "--chunk-start", "4", "9", "9",
                  "--chunk-size", "4", "20", "20", "--validate-mip", "1"])
    assert cli.main(["--device", "cpu", "create-chunk", "--size", "4", "20",
                     "20", "-t", *map(str, OFFSET), "save-precomputed", "-v",
                     str(tmp_path / "v"), "--create-thumbnail"]) == 0


def test_save_precomputed_threshold_log_and_skip(tmp_path):
    """create-info from a chunk, save with an upload log, skip a task
    whose blocks exist, and skip a save below the intensity threshold."""
    vol = str(tmp_path / "v")
    args = ["--device", "cpu", "-v", "create-chunk", "--size", "8", "32",
            "32", "--pattern", "random", "--voxel-offset", "3", "5", "7",
            "create-info", "-v", vol, "-i", "chunk", "-s", "8", "32", "64",
            "--block-size", "8", "32", "32",
            "save-precomputed", "-v", vol]
    assert cli.main(args) == 0
    info = PrecomputedVolume(vol).info
    # the chunk gave every default but the size
    assert info["data_type"] == "uint8" and info["scales"][0]["size"] == \
        [64, 32, 8] and info["scales"][0]["voxel_offset"] == [7, 5, 3]
    with open(os.path.join(vol, "log", "3-11_5-37_7-39.json")) as f:
        assert json.load(f)["bbox"] == "3-11_5-37_7-39"
    want = Chunk.create(size=(8, 32, 32), dtype=np.uint8,
                        pattern="random").array
    assert np.array_equal(_port_read(vol, ((3, 5, 7), (11, 37, 39))), want)
    marker = tmp_path / "done-"
    assert cli.main(["--device", "cpu", "generate-tasks", "-c", "8", "32",
                     "32", "--roi-start", "3", "5", "7", "-g", "1", "1", "2",
                     "skip-task-by-blocks-in-volume", "-v", vol,
                     "mark-complete", "-p", str(marker)]) == 0
    assert sorted(os.listdir(tmp_path)) == ["done-3-11_5-37_39-71.done", "v"]
    zero_vol = str(tmp_path / "z")
    assert cli.main(["--device", "cpu", "create-chunk", "--size", "8", "32",
                     "32", "--pattern", "zero", "create-info", "-v", zero_vol,
                     "-s", "8", "32", "32", "--block-size", "8", "32", "32",
                     "save-precomputed", "-v", zero_vol,
                     "--intensity-threshold", "0.5", "--no-upload-log"]) == 0
    assert sorted(os.listdir(zero_vol)) == ["info"]


# ---------------------------------------------------------------------------
# task files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("suffix", [".txt", ".npy"])
def test_task_files_read_in_the_other_package(tmp_path, suffix):
    port = BoundingBoxes.from_manual_setup(chunk_size=(8, 32, 32),
                                           overlap=(2, 4, 4),
                                           roi_start=(1, -3, 5),
                                           roi_stop=(20, 70, 61))
    jax = JaxBoxes.from_manual_setup(chunk_size=(8, 32, 32),
                                     overlap=(2, 4, 4), roi_start=(1, -3, 5),
                                     roi_stop=(20, 70, 61))
    port.to_file(str(tmp_path / f"port{suffix}"))
    jax.to_file(str(tmp_path / f"jax{suffix}"))
    assert (tmp_path / f"port{suffix}").read_bytes() == \
        (tmp_path / f"jax{suffix}").read_bytes()
    from_jax = BoundingBoxes.from_file(str(tmp_path / f"jax{suffix}"))
    from_port = JaxBoxes.from_file(str(tmp_path / f"port{suffix}"))
    assert from_jax == port and len(from_jax) == len(jax) == 18
    assert [b.string for b in from_port] == [b.string for b in from_jax]


def test_generate_tasks_file_and_fetch_task_from_file(tmp_path, monkeypatch):
    """generate-tasks --task-file, then fetch-task-from-file by job index,
    SLURM array index and granularity, as the JAX CLI slices it."""
    from click.testing import CliRunner

    from chunkflow_tpu.flow.cli import main as jax_main

    tasks = str(tmp_path / "tasks.npy")
    assert cli.main(["generate-tasks", "-c", "4", "8", "8", "-g", "2", "2",
                     "3", "--task-file", tasks]) == 0
    assert len(BoundingBoxes.from_file(tasks)) == 12
    for args, env in (([], "5"), (["--job-index", "2", "-g", "3"], None),
                      (["--job-index", "9", "-g", "2"], None)):
        if env is None:
            monkeypatch.delenv("SLURM_ARRAY_TASK_ID", raising=False)
        else:
            monkeypatch.setenv("SLURM_ARRAY_TASK_ID", env)
        markers = {}
        for name, run in (("port", lambda a: cli.main(a)),
                          ("jax", lambda a: CliRunner().invoke(
                              jax_main, a, catch_exceptions=False)
                           .exit_code)):
            prefix = tmp_path / name / f"{len(args)}-"
            assert run(["fetch-task-from-file", "-f", tasks, *args,
                        "mark-complete", "-p", str(prefix)]) == 0
            markers[name] = sorted(os.listdir(tmp_path / name)) \
                if (tmp_path / name).exists() else []
        assert markers["port"] == markers["jax"]


# ---------------------------------------------------------------------------
# the storage plane's other backends
# ---------------------------------------------------------------------------
def test_memory_backend_blockwise_reads_and_writes_as_the_jax_package():
    rng = np.random.default_rng(8)
    data = rng.integers(0, 256, (3, 20, 45, 50), dtype=np.uint8)
    port = storage.MemoryBackend(data.copy(), block_shape=(3, 8, 16, 16))
    jax = jax_storage.MemoryBackend(data.copy(), block_shape=(3, 8, 16, 16))
    cache = storage.BlockCache(1 << 20)
    for lo, hi in (((0, 0, 0, 0), (3, 20, 45, 50)),
                   ((0, 3, 7, 9), (3, 17, 40, 33)), ((1, 8, 16, 16),
                                                     (2, 9, 17, 17))):
        got = storage.blockwise_cutout(port, lo, hi, cache=cache)
        assert np.array_equal(got, jax_storage.blockwise_cutout(jax, lo, hi))
        assert np.array_equal(got, storage.serial_cutout(port, lo, hi))
    patch = rng.integers(0, 256, (3, 8, 16, 16), dtype=np.uint8)
    for lo in ((0, 8, 16, 16), (0, 5, 3, 30)):  # aligned, unaligned
        storage.blockwise_save(port, lo, patch, cache=cache)
        jax_storage.blockwise_save(jax, lo, patch)
        full = ((0, 0, 0, 0), (3, 20, 45, 50))
        assert np.array_equal(storage.blockwise_cutout(port, *full,
                                                       cache=cache),
                              jax_storage.serial_cutout(jax, *full))
    with pytest.raises(ValueError, match="outside storage domain"):
        storage.serial_cutout(port, (0, 0, 0, 0), (3, 21, 45, 50))
    port.close()
    jax.close()


@pytest.mark.parametrize("kv", ["file", "memory"])
def test_kv_array_blocks_are_the_jax_packages(tmp_path, kv):
    """The npy-block store: the JAX package writes, the port reads, and
    the other way round, absent blocks as the fill value."""
    rng = np.random.default_rng(9)
    data = rng.integers(1, 1000, (12, 40, 40)).astype(np.uint32)
    args = dict(domain=((0, 0, 0), (12, 40, 40)), dtype=np.uint32,
                block_shape=(4, 16, 16), fill=7)
    if kv == "file":
        port_kv = storage.FileKV(str(tmp_path))
        jax_kv = jax_storage.FileKV(str(tmp_path))
    else:
        port_kv, jax_kv = storage.MemoryKV(), jax_storage.MemoryKV()
    port = storage.KVArrayBackend(port_kv, **args)
    jax = jax_storage.KVArrayBackend(jax_kv, **args)
    jax.write_async((0, 0, 0), (8, 33, 20), data[:8, :33, :20]).result()
    port.write_async((0, 0, 0), (8, 33, 20), data[:8, :33, :20]).result()
    want = np.full((12, 40, 40), 7, np.uint32)
    want[:8, :33, :20] = data[:8, :33, :20]
    everything = ((0, 0, 0), (12, 40, 40))
    assert np.array_equal(port.read_async(*everything).result(), want)
    assert np.array_equal(jax.read_async(*everything).result(), want)
    if kv == "file":
        reader = storage.KVArrayBackend(storage.FileKV(str(tmp_path)),
                                        **args)
        assert np.array_equal(reader.read_async(*everything).result(), want)
        assert sorted(os.listdir(tmp_path / "blocks"))[0] == \
            "0-4_0-16_0-16.npy"
    assert port_kv.exists_many(["blocks/0-4_0-16_0-16.npy", "nope"]) == \
        {"blocks/0-4_0-16_0-16.npy": True, "nope": False}
    port.close()
    jax.close()


def test_block_cache_budget_and_shared_cache(monkeypatch):
    cache = storage.BlockCache(3000)
    for i in range(4):
        assert cache.put(("t", i), np.zeros(1000, np.uint8))
    assert len(cache) == 3 and cache.evictions == 1
    assert cache.get(("t", 0)) is None and cache.get(("t", 3)) is not None
    assert not cache.put(("t", 9), np.zeros(4000, np.uint8))
    assert cache.invalidate_token("t") == 3 and cache.nbytes == 0
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
    assert storage.shared_cache() is None
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "1")
    assert storage.shared_cache().max_bytes == 1 << 20
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CONCURRENCY", "3")
    storage.reset_read_concurrency()
    assert storage.read_concurrency() == 3
    storage.set_read_concurrency(5)
    assert storage.read_concurrency() == 5
    storage.reset_read_concurrency()


def test_bbox_block_arithmetic_is_the_jax_packages():
    """clamp, is_aligned_with, snap_to_blocks, decompose and the numpy
    bridge of the port's BoundingBox, against the JAX package's."""
    boxes = [((3, 5, 7), (19, 65, 77)), ((0, -8, 16), (8, 24, 48)),
             ((4, 6, 8), (10, 36, 38))]
    outer = ((2, 0, 0), (16, 40, 60))
    for lo, hi in boxes:
        port, jax = BoundingBox(lo, hi), JaxBox(lo, hi)
        assert port.clamp(BoundingBox(*outer)).string == \
            jax.clamp(JaxBox(*outer)).string
        for block, offset in (((8, 32, 32), None), ((8, 32, 32), OFFSET),
                              ((4, 8, 8), (0, 0, 0))):
            assert port.is_aligned_with(block, offset) == \
                jax.is_aligned_with(block, offset)
            for outward in (True, False):
                assert port.snap_to_blocks(block, offset, outward).string == \
                    jax.snap_to_blocks(block, offset, outward).string
        assert [b.string for b in
                port.decompose_to_unaligned_block_bounding_boxes((8, 16, 32))
                ] == [b.string for b in
                      jax.decompose_to_unaligned_block_bounding_boxes(
                          (8, 16, 32))]
        assert np.array_equal(port.to_array(), jax.to_array())
        assert BoundingBox.from_array(jax.to_array()) == port
    grid = BoundingBox((0, 0, 0), (16, 64, 32))
    assert [b.string for b in grid.decompose((8, 32, 32))] == \
        [b.string for b in JaxBox((0, 0, 0), (16, 64, 32)).decompose(
            (8, 32, 32))]
    with pytest.raises(ValueError, match="not a multiple"):
        grid.decompose((5, 32, 32))
    tasks = BoundingBoxes.from_manual_setup(chunk_size=(8, 32, 32),
                                            roi_stop=(16, 64, 32))
    assert tasks[1:] == BoundingBoxes(list(tasks)[1:]) and tasks[0] == \
        list(tasks)[0]


def test_strict_cli_read_raises_on_an_absent_block(tmp_path):
    vol = _create(PrecomputedVolume, tmp_path / "v")
    vol.save(Chunk(_data("uint8", 1)[:8, :32, :32], voxel_offset=OFFSET))
    args = ["--device", "cpu", "load-precomputed", "-v", str(tmp_path / "v"),
            "--chunk-start", *map(str, OFFSET), "--chunk-size", "16", "32",
            "32", "save-npy", "-f", str(tmp_path / "c.npy")]
    assert cli.main(args) == 0  # absent blocks: zeros
    assert not np.load(tmp_path / "c.npy")[8:].any()
    with pytest.raises(FileNotFoundError, match="strict read"):
        cli.main(args[:5] + ["--no-fill-missing"] + args[5:])
