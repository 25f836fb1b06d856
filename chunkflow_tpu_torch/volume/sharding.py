"""Sharded precomputed scales: ``neuroglancer_uint64_sharded_v1``.

The layout is neuroglancer's ``src/datasource/precomputed/sharded.md``.
A chunk's id is the compressed Morton code of its position on the
scale's chunk grid; ``hash(id >> preshift_bits)`` (``identity`` or the
low 64 bits of ``murmurhash3_x86_128``) picks its minishard (the low
``minishard_bits``) and its shard (the next ``shard_bits``). A shard is
one file, ``<shard in hex>.shard``:

* the shard index: per minishard, the [start, end) byte range of its
  minishard index (uint64 little-endian, from the end of the shard
  index; an empty minishard is [0, 0));
* per minishard in ascending order: its chunks' data in ascending id
  order, then its minishard index: the ids, the offsets (each from the
  end of the previous chunk; the first from the end of the shard index)
  and the sizes, each delta-coded ids, as three uint64 rows, ``raw`` or
  ``gzip``;
* each chunk's bytes are its encoded block (``volume/codecs.py``),
  ``raw`` or ``gzip`` (``data_encoding``).

A chunk all of the fill value (zero) is not stored, as tensorstore does
not store one; a stored chunk written back to zero leaves its shard
(where tensorstore 0.1.80 keeps the old chunk and reads it back), and a
shard left without chunks is removed. The layout is the one tensorstore
writes, so a ``raw`` shard is its file byte for byte.

:class:`ShardedChunks` reads and writes chunks by id. A write is a
read-modify-write of the whole shard under an ``fcntl`` lock on
``<shard>.lock`` beside it, written to a temporary file and renamed into
place: a reader sees the old shard or the new one, and two processes
writing disjoint chunks of one shard lose neither.
"""
from __future__ import annotations

import fcntl
import gzip
import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

SHARDING_TYPE = "neuroglancer_uint64_sharded_v1"
_MASK32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    return h ^ (h >> 16)


def murmurhash3_x86_128_low64(value: int, seed: int = 0) -> int:
    """The low 64 bits of MurmurHash3_x86_128 of ``value`` as eight
    little-endian bytes (the sharded format's ``murmurhash3_x86_128``)."""
    c1, c2, c3 = 0x239B961B, 0xAB0E9789, 0x38B34AE5
    h1 = h2 = h3 = h4 = seed & _MASK32
    lo, hi = value & _MASK32, (value >> 32) & _MASK32
    # an 8-byte key is all tail: bytes 4-7 into k2, bytes 0-3 into k1
    k2 = (hi * c2) & _MASK32
    k2 = (_rotl32(k2, 16) * c3) & _MASK32
    h2 ^= k2
    k1 = (lo * c1) & _MASK32
    k1 = (_rotl32(k1, 15) * c2) & _MASK32
    h1 ^= k1
    h1, h2, h3, h4 = h1 ^ 8, h2 ^ 8, h3 ^ 8, h4 ^ 8
    h1 = (h1 + h2 + h3 + h4) & _MASK32
    h2, h3, h4 = (h2 + h1) & _MASK32, (h3 + h1) & _MASK32, (h4 + h1) & _MASK32
    h1, h2, h3, h4 = _fmix32(h1), _fmix32(h2), _fmix32(h3), _fmix32(h4)
    h1 = (h1 + h2 + h3 + h4) & _MASK32
    h2 = (h2 + h1) & _MASK32
    return (h2 << 32) | h1


def compressed_morton_code(position: Sequence[int],
                           grid_shape: Sequence[int]) -> int:
    """The chunk id of ``position`` (xyz) on a grid of ``grid_shape``
    (xyz): the bits of x, y, z interleaved, each dimension contributing
    only the bits its extent needs."""
    bits = [max(0, int(s) - 1).bit_length() for s in grid_shape]
    code, out_bit = 0, 0
    for i in range(max(bits, default=0)):
        for d in range(len(bits)):
            if i < bits[d]:
                code |= ((int(position[d]) >> i) & 1) << out_bit
                out_bit += 1
    return code


def _gunzip(data: bytes) -> bytes:
    try:
        return gzip.decompress(data)
    except (OSError, EOFError, zlib.error) as exc:
        raise ValueError(f"corrupt gzip data in a shard: {exc}") from None


class ShardingSpec:
    """The ``sharding`` entry of a scale."""

    def __init__(self, spec: Mapping):
        if spec.get("@type") != SHARDING_TYPE:
            raise ValueError(f"sharding @type must be {SHARDING_TYPE!r}, "
                             f"got {spec.get('@type')!r}")
        self.preshift_bits = int(spec.get("preshift_bits", 0))
        self.minishard_bits = int(spec.get("minishard_bits", 0))
        self.shard_bits = int(spec.get("shard_bits", 0))
        self.hash = spec.get("hash", "identity")
        self.minishard_index_encoding = spec.get("minishard_index_encoding",
                                                 "raw")
        self.data_encoding = spec.get("data_encoding", "raw")
        if self.hash not in ("identity", "murmurhash3_x86_128"):
            raise ValueError(f"unknown sharding hash {self.hash!r}")
        for name in ("minishard_index_encoding", "data_encoding"):
            if getattr(self, name) not in ("raw", "gzip"):
                raise ValueError(f"sharding {name} must be raw or gzip, "
                                 f"got {getattr(self, name)!r}")
        if not (0 <= self.preshift_bits <= 64 and
                0 <= self.minishard_bits <= 32 and
                0 <= self.shard_bits <= 64 - self.minishard_bits):
            raise ValueError(f"sharding bits out of range: {dict(spec)}")

    def locate(self, chunk_id: int) -> Tuple[int, int]:
        """(shard, minishard) of a chunk id."""
        key = chunk_id >> self.preshift_bits
        hashed = (key if self.hash == "identity"
                  else murmurhash3_x86_128_low64(key))
        minishard = hashed & ((1 << self.minishard_bits) - 1)
        shard = (hashed >> self.minishard_bits) & ((1 << self.shard_bits) - 1)
        return shard, minishard

    def shard_name(self, shard: int) -> str:
        digits = -(-self.shard_bits // 4)
        return f"{shard:0{digits}x}.shard"

    def encode_data(self, data) -> bytes:
        data = bytes(data)
        return gzip.compress(data, mtime=0) \
            if self.data_encoding == "gzip" else data

    def decode_data(self, data: bytes) -> bytes:
        return _gunzip(data) if self.data_encoding == "gzip" else data


class ShardedChunks:
    """The chunks of one sharded scale under a local directory, by id."""

    def __init__(self, directory: str, spec: ShardingSpec):
        self.directory = directory
        self.spec = spec
        self._index_bytes = 16 << spec.minishard_bits
        self._locks: Dict[int, threading.Lock] = {}
        self._locks_lock = threading.Lock()

    def _path(self, shard: int) -> str:
        return os.path.join(self.directory, self.spec.shard_name(shard))

    # ---- reading ----------------------------------------------------------
    def _minishard(self, f, minishard: int) -> np.ndarray:
        """The minishard index as rows (ids, absolute offsets, sizes)."""
        f.seek(16 * minishard)
        entry = f.read(16)
        if len(entry) != 16:
            raise ValueError(f"truncated shard index in {f.name}")
        start, end = np.frombuffer(entry, dtype="<u8").tolist()
        if end == start:
            return np.zeros((3, 0), dtype=np.uint64)
        if end < start:
            raise ValueError(f"corrupt shard index in {f.name}")
        f.seek(self._index_bytes + start)
        raw = f.read(end - start)
        if len(raw) != end - start:
            raise ValueError(f"truncated minishard index in {f.name}")
        if self.spec.minishard_index_encoding == "gzip":
            raw = _gunzip(raw)
        if len(raw) % 24:
            raise ValueError(f"corrupt minishard index in {f.name}")
        rows = np.frombuffer(raw, dtype="<u8").reshape(3, -1).astype(
            np.uint64)
        ids = np.cumsum(rows[0], dtype=np.uint64)
        starts = np.empty_like(rows[1])
        pos = 0
        for i, (delta, size) in enumerate(zip(rows[1].tolist(),
                                              rows[2].tolist())):
            pos += delta
            starts[i] = pos
            pos += size
        return np.stack([ids, starts, rows[2]])

    def read(self, chunk_id: int) -> Optional[bytes]:
        """The chunk's block bytes (data encoding undone), or None when
        the shard does not hold it."""
        shard, minishard = self.spec.locate(chunk_id)
        try:
            f = open(self._path(shard), "rb")
        except FileNotFoundError:
            return None
        with f:
            index = self._minishard(f, minishard)
            hit = np.nonzero(index[0] == np.uint64(chunk_id))[0]
            if hit.size == 0:
                return None
            start, size = int(index[1, hit[0]]), int(index[2, hit[0]])
            f.seek(self._index_bytes + start)
            data = f.read(size)
        if len(data) != size:
            raise ValueError(f"truncated chunk {chunk_id} in "
                             f"{self._path(shard)}")
        return self.spec.decode_data(data)

    def _entries(self, path: str) -> Dict[int, bytes]:
        """Every stored chunk of a shard, id -> its stored bytes."""
        try:
            f = open(path, "rb")
        except FileNotFoundError:
            return {}
        entries = {}
        with f:
            for minishard in range(1 << self.spec.minishard_bits):
                index = self._minishard(f, minishard)
                for cid, start, size in index.T.tolist():
                    f.seek(self._index_bytes + start)
                    entries[cid] = f.read(size)
        return entries

    # ---- writing ----------------------------------------------------------
    def encode_shard(self, entries: Mapping[int, bytes]) -> bytes:
        """A shard file of ``entries`` (id -> stored bytes)."""
        by_minishard: Dict[int, list] = {}
        for cid in sorted(entries):
            by_minishard.setdefault(self.spec.locate(cid)[1], []).append(cid)
        index = np.zeros((1 << self.spec.minishard_bits, 2), dtype="<u8")
        parts, pos = [], 0
        for minishard in sorted(by_minishard):
            ids = by_minishard[minishard]
            rows = np.zeros((3, len(ids)), dtype="<u8")
            prev_id, prev_end = 0, 0
            for i, cid in enumerate(ids):
                data = entries[cid]
                rows[:, i] = (cid - prev_id, pos - prev_end, len(data))
                parts.append(data)
                prev_id, prev_end = cid, pos + len(data)
                pos = prev_end
            packed = rows.tobytes()
            if self.spec.minishard_index_encoding == "gzip":
                packed = gzip.compress(packed, mtime=0)
            index[minishard] = (pos, pos + len(packed))
            parts.append(packed)
            pos += len(packed)
        return index.tobytes() + b"".join(parts)

    def _thread_lock(self, shard: int) -> threading.Lock:
        with self._locks_lock:
            return self._locks.setdefault(shard, threading.Lock())

    def write(self, updates: Mapping[int, Optional[bytes]]) -> None:
        """Store each chunk's block bytes (None: remove the chunk), one
        locked read-modify-write per shard, the shards concurrently."""
        by_shard: Dict[int, Dict[int, Optional[bytes]]] = {}
        for cid, data in updates.items():
            by_shard.setdefault(self.spec.locate(cid)[0], {})[cid] = data
        os.makedirs(self.directory, exist_ok=True)
        if len(by_shard) == 1:
            self._rewrite(*next(iter(by_shard.items())))
            return
        futures = [_pool().submit(self._rewrite, shard, changes)
                   for shard, changes in sorted(by_shard.items())]
        for future in futures:
            future.result()

    def _rewrite(self, shard: int, changes: Mapping[int, Optional[bytes]]):
        stored = {cid: None if data is None else self.spec.encode_data(data)
                  for cid, data in changes.items()}
        path = self._path(shard)
        with self._thread_lock(shard), open(f"{path}.lock", "a") as held:
            fcntl.flock(held, fcntl.LOCK_EX)
            entries = self._entries(path)
            for cid, data in stored.items():
                if data is None:
                    entries.pop(cid, None)
                else:
                    entries[cid] = data
            if not entries:
                if os.path.exists(path):
                    os.remove(path)
                return
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(self.encode_shard(entries))
            os.replace(tmp, path)


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _pool() -> ThreadPoolExecutor:
    """The threads that rewrite the shards of one write concurrently."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix="chunkflow-shards")
        return _POOL
