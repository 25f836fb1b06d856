"""Sharded precomputed scales on the CPU, against tensorstore.

tensorstore (the JAX package's storage driver) and the port write the
same small volumes (16x64x60, chunks 8x16x16, one all zero) into
``neuroglancer_uint64_sharded_v1`` scales under both hashes and several
preshift, minishard and shard widths:

* with ``raw`` data the shard files are tensorstore's byte for byte
  (``raw`` and ``gzip`` minishard indices): the shard index, the
  delta-coded minishard indices, the chunk order, the all-zero chunk left
  out, the clipped edge chunks;
* with ``gzip`` data (another zlib stream) each package reads the other's
  shards bitwise, in every encoding;
* partial writes give tensorstore's shards; chunks written back to zero
  leave their shards (a shard left empty is removed) and read as zeros in
  both;
* two processes writing disjoint chunks of one shard lose none.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ts = pytest.importorskip("tensorstore")

from chunkflow_tpu_torch import BoundingBox, Chunk
from chunkflow_tpu_torch.volume import storage
from chunkflow_tpu_torch.volume.precomputed import PrecomputedVolume
from chunkflow_tpu_torch.volume.sharding import (
    ShardedChunks,
    ShardingSpec,
    compressed_morton_code,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SIZE = (16, 64, 60)      # ragged in x against the chunks: clipped edges
CHUNK = (8, 16, 16)
OFFSET = (5, 0, 3)
BOX = BoundingBox(OFFSET, tuple(o + s for o, s in zip(OFFSET, SIZE)))
LAYOUTS = [(0, 0, 0), (1, 2, 1), (2, 3, 2), (0, 1, 4)]  # preshift, mini, shard


def _spec(hash_, layout, index="raw", data="raw"):
    preshift, mini, shard = layout
    return {"@type": "neuroglancer_uint64_sharded_v1",
            "preshift_bits": preshift, "hash": hash_,
            "minishard_bits": mini, "shard_bits": shard,
            "minishard_index_encoding": index, "data_encoding": data}


@pytest.fixture(autouse=True)
def no_cache(monkeypatch):
    monkeypatch.setenv("CHUNKFLOW_STORAGE_CACHE_MB", "0")
    storage.reset_shared_cache()


def _write_info(path, encoding, dtype, channels, sharding, **scale):
    os.makedirs(path, exist_ok=True)
    info = {"type": "image", "data_type": dtype, "num_channels": channels,
            "scales": [dict({"key": "s", "size": list(SIZE[::-1]),
                             "resolution": [4, 4, 40],
                             "voxel_offset": list(OFFSET[::-1]),
                             "chunk_sizes": [list(CHUNK[::-1])],
                             "encoding": encoding, "sharding": sharding},
                            **scale)]}
    with open(os.path.join(path, "info"), "w") as f:
        json.dump(info, f)


def _ts(path):
    return ts.open({"driver": "neuroglancer_precomputed",
                    "kvstore": {"driver": "file", "path": str(path)},
                    "scale_index": 0}).result()


def _ts_write(path, czyx, lo=OFFSET):
    arr = np.transpose(czyx if czyx.ndim == 4 else czyx[None], (3, 2, 1, 0))
    z, y, x = lo
    _ts(path)[x:x + arr.shape[0], y:y + arr.shape[1],
              z:z + arr.shape[2]].write(arr).result()


def _ts_read(path):
    arr = np.transpose(_ts(path)[OFFSET[2]:, OFFSET[1]:, OFFSET[0]:]
                       .read().result(), (3, 2, 1, 0))
    return arr[0] if arr.shape[0] == 1 else arr


def _port_read(path):
    return PrecomputedVolume(str(path)).cutout(BOX).array


def _shards(path):
    scale = os.path.join(path, "s")
    return {n: open(os.path.join(scale, n), "rb").read()
            for n in sorted(os.listdir(scale)) if n.endswith(".shard")}


def _data(dtype="uint16", channels=1, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((channels,) if channels > 1 else ()) + SIZE
    data = rng.integers(1, 200, shape).astype(dtype)
    data[..., :CHUNK[0], :CHUNK[1], :CHUNK[2]] = 0   # chunk 0 is empty
    return data


# ---------------------------------------------------------------------------
# chunk ids (the hashes are held by the byte-for-byte shards below: a chunk
# in another shard or minishard changes the files)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grid, position, code", [
    ((4, 4, 2), (0, 0, 0), 0),
    ((4, 4, 2), (1, 0, 0), 1),
    ((4, 4, 2), (0, 1, 0), 2),
    ((4, 4, 2), (0, 0, 1), 4),
    ((4, 4, 2), (2, 0, 0), 8),     # z has run out of bits
    ((4, 4, 2), (3, 3, 1), 31),
    ((1, 8, 1), (0, 5, 0), 5),     # one dimension only
])
def test_compressed_morton_code(grid, position, code):
    assert compressed_morton_code(position, grid) == code


# ---------------------------------------------------------------------------
# tensorstore's shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("index", ["raw", "gzip"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("hash_", ["identity", "murmurhash3_x86_128"])
def test_raw_data_shards_are_tensorstores_byte_for_byte(tmp_path, hash_,
                                                        layout, index):
    spec = _spec(hash_, layout, index=index)
    data = _data()
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, "raw", "uint16", 1, spec)
    _ts_write(tmp_path / "ts", data)
    PrecomputedVolume(str(tmp_path / "port")).save(
        Chunk(data, voxel_offset=OFFSET))
    assert _shards(tmp_path / "port") == _shards(tmp_path / "ts")
    for tag in ("ts", "port"):
        assert np.array_equal(_port_read(tmp_path / tag), data)


CODECS = [("raw", "float32", 2, {}), ("jpeg", "uint8", 1, {}),
          ("png", "uint16", 3, {}),
          ("compressed_segmentation", "uint64", 1,
           {"compressed_segmentation_block_size": [4, 8, 8]})]


@pytest.mark.parametrize("encoding, dtype, channels, extra", CODECS,
                         ids=[c[0] for c in CODECS])
@pytest.mark.parametrize("hash_", ["identity", "murmurhash3_x86_128"])
def test_gzip_shards_read_bitwise_both_ways(tmp_path, encoding, dtype,
                                            channels, extra, hash_):
    spec = _spec(hash_, (1, 2, 1), index="gzip", data="gzip")
    data = _data(dtype, channels)
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, encoding, dtype, channels, spec, **extra)
    _ts_write(tmp_path / "ts", data)
    PrecomputedVolume(str(tmp_path / "port")).save(
        Chunk(data, voxel_offset=OFFSET))
    want = _ts_read(tmp_path / "ts")
    for tag in ("ts", "port"):
        assert np.array_equal(_port_read(tmp_path / tag), want)
        assert np.array_equal(_ts_read(tmp_path / tag), want)
    assert sorted(_shards(tmp_path / "port")) == sorted(
        _shards(tmp_path / "ts"))


def test_partial_writes_are_tensorstores_and_zeroed_chunks_leave(tmp_path):
    """Unaligned writes (read, modify, write of the covered chunks) give
    tensorstore's shards. A region written back to zero takes its chunks
    out of their shards, and a shard left empty is removed: the volume
    reads zeros there, in both packages. (tensorstore itself keeps the
    old chunk when a stored chunk of a sharded scale is overwritten with
    the fill value, and reads it back: ROADMAP, "Not faults".)"""
    spec = _spec("identity", (2, 0, 3))  # ids 0-3: shard 0 alone
    for tag in ("ts", "port"):
        _write_info(tmp_path / tag, "raw", "uint16", 1, spec)
    data = _data()
    rng = np.random.default_rng(3)
    writes = [((6, 5, 9), rng.integers(1, 99, (5, 20, 30), dtype=np.uint16)),
              ((13, 40, 20), rng.integers(1, 99, (8, 24, 43),
                                          dtype=np.uint16))]
    _ts_write(tmp_path / "ts", data)
    vol = PrecomputedVolume(str(tmp_path / "port"))
    vol.save(Chunk(data, voxel_offset=OFFSET))
    for lo, arr in writes:
        _ts_write(tmp_path / "ts", arr, lo=lo)
        vol.save(Chunk(arr, voxel_offset=lo))
    assert _shards(tmp_path / "port") == _shards(tmp_path / "ts")
    want = _ts_read(tmp_path / "ts")
    assert np.array_equal(_port_read(tmp_path / "port"), want)
    before = set(_shards(tmp_path / "port"))
    vol.save(Chunk(np.zeros((8, 32, 32), np.uint16), voxel_offset=OFFSET))
    want[:8, :32, :32] = 0
    assert set(_shards(tmp_path / "port")) == before - {"0.shard"}
    assert np.array_equal(_port_read(tmp_path / "port"), want)
    assert np.array_equal(_ts_read(tmp_path / "port"), want)


def test_a_missing_or_truncated_shard(tmp_path):
    spec = _spec("murmurhash3_x86_128", (0, 1, 1))
    _write_info(tmp_path, "raw", "uint16", 1, spec)
    chunks = ShardedChunks(str(tmp_path / "s"), ShardingSpec(spec))
    assert chunks.read(5) is None       # no shard file
    chunks.write({5: b"x" * 16, 6: b"y" * 16})
    assert (chunks.read(5), chunks.read(6)) == (b"x" * 16, b"y" * 16)
    assert chunks.read(7) is None       # not in its shard
    for name, blob in _shards(tmp_path).items():
        (tmp_path / "s" / name).write_bytes(blob[:20])
    with pytest.raises(ValueError, match="truncated"):
        chunks.read(5) or chunks.read(6)


# ---------------------------------------------------------------------------
# writers in two processes
# ---------------------------------------------------------------------------
_WRITER = """
import sys
from chunkflow_tpu_torch.volume.sharding import ShardedChunks, ShardingSpec
import json
spec = ShardingSpec(json.loads(sys.argv[2]))
chunks = ShardedChunks(sys.argv[1], spec)
first = int(sys.argv[3])
for cid in range(first, 400, 2):   # this writer's ids: one parity
    chunks.write({cid: (b"%d:" % cid) * 50})
"""


def test_two_processes_writing_disjoint_chunks_of_one_shard(tmp_path):
    """400 chunk ids in one shard (no shard bits), even ids from one
    process and odd ids from the other, one read-modify-write each: every
    chunk is in the shard at the end."""
    spec = _spec("identity", (0, 2, 0))
    directory = str(tmp_path / "s")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WRITER, directory,
                               json.dumps(spec), str(first)], env=env)
             for first in (0, 1)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    chunks = ShardedChunks(directory, ShardingSpec(spec))
    for cid in range(400):
        assert chunks.read(cid) == (b"%d:" % cid) * 50
    assert sorted(os.listdir(directory)) == ["0.shard", "0.shard.lock"]
