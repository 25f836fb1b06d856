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

:class:`ShardedChunks` reads and writes chunks by id through a KV plane
(a directory, ``gs://``, ``s3://``). A write is a conditional
read-modify-write of the whole shard; on a directory it also holds an
``fcntl`` lock on ``<shard>.lock`` beside it and writes through a
temporary file and a rename: a reader sees the old shard or the new one,
and two processes writing disjoint chunks of one shard lose neither.
"""
from __future__ import annotations

import gzip
import random
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.volume.storage import PreconditionFailed

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
    """The chunks of one sharded scale, by id, in the shards under
    ``prefix`` of a KV plane (``volume/storage.py``: a directory, a bucket).

    A read is three ranged reads, as tensorstore reads a remote shard: the
    shard index, the minishard index, the chunk; the later two pinned to
    the first one's generation (a shard rewritten between them is read
    again). A write rewrites each touched shard: read it with its
    generation, re-encode it, write it under ``if_generation`` (a shard
    left empty is deleted under the same condition) and, when another
    writer got there first, read it again and retry, with backoff, so two
    writers of disjoint chunks of one shard lose neither's. On a local
    directory the rewrite runs under the shard's ``<shard>.lock`` flock
    (``FileKV.locked``), so it never has to retry."""

    #: rewrites of one shard tried before giving up, and the first backoff
    retries = 24
    backoff = 0.01

    def __init__(self, kv, prefix: str, spec: ShardingSpec):
        self.kv = kv
        self.prefix = prefix
        self.spec = spec
        self._index_bytes = 16 << spec.minishard_bits

    def _name(self, shard: int) -> str:
        name = self.spec.shard_name(shard)
        return f"{self.prefix}/{name}" if self.prefix else name

    # ---- reading ----------------------------------------------------------
    def _minishard_rows(self, raw: bytes, name: str) -> np.ndarray:
        """A minishard index as rows (ids, offsets from the end of the
        shard index, sizes)."""
        if self.spec.minishard_index_encoding == "gzip":
            raw = _gunzip(raw)
        if len(raw) % 24:
            raise ValueError(f"corrupt minishard index in {name}")
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

    def _span(self, index: bytes, minishard: int, name: str):
        """The [start, end) of a minishard's index from the shard index
        (None: an empty minishard)."""
        if len(index) < self._index_bytes:
            raise ValueError(f"truncated shard index in {name}")
        start, end = np.frombuffer(index[16 * minishard:16 * minishard + 16],
                                   dtype="<u8").tolist()
        if end == start:
            return None
        if end < start:
            raise ValueError(f"corrupt shard index in {name}")
        return start, end

    def _read_part(self, name, start, stop, generation) -> bytes:
        data, _ = self.kv.read_range(name, start, stop,
                                     if_generation=generation)
        if data is None or len(data) != stop - start:
            raise ValueError(f"truncated shard {name}")
        return data

    def read(self, chunk_id: int) -> Optional[bytes]:
        """The chunk's block bytes (data encoding undone), or None when
        the shard does not hold it."""
        shard, minishard = self.spec.locate(chunk_id)
        name = self._name(shard)
        base = self._index_bytes
        for _ in range(self.retries):
            index, generation = self.kv.read_range(name, 0, base)
            if index is None:
                return None
            span = self._span(index, minishard, name)
            if span is None:
                return None
            try:
                rows = self._minishard_rows(self._read_part(
                    name, base + span[0], base + span[1], generation), name)
                hit = np.nonzero(rows[0] == np.uint64(chunk_id))[0]
                if hit.size == 0:
                    return None
                start, size = int(rows[1, hit[0]]), int(rows[2, hit[0]])
                if size == 0:
                    return self.spec.decode_data(b"")
                data = self._read_part(name, base + start,
                                       base + start + size, generation)
            except PreconditionFailed:
                continue  # rewritten meanwhile: read the new shard
            return self.spec.decode_data(data)
        raise PreconditionFailed(f"{name} kept changing while it was read")

    def _entries(self, blob: Optional[bytes], name: str) -> Dict[int, bytes]:
        """Every stored chunk of a shard file, id -> its stored bytes."""
        if blob is None:
            return {}
        entries = {}
        base = self._index_bytes
        for minishard in range(1 << self.spec.minishard_bits):
            span = self._span(blob, minishard, name)
            if span is None:
                continue
            if base + span[1] > len(blob):
                raise ValueError(f"truncated minishard index in {name}")
            rows = self._minishard_rows(blob[base + span[0]:base + span[1]],
                                        name)
            for cid, start, size in rows.T.tolist():
                entries[cid] = blob[base + start:base + start + size]
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

    def write(self, updates: Mapping[int, Optional[bytes]]) -> None:
        """Store each chunk's block bytes (None: remove the chunk), one
        conditional read-modify-write per shard, the shards concurrently."""
        by_shard: Dict[int, Dict[int, Optional[bytes]]] = {}
        for cid, data in updates.items():
            by_shard.setdefault(self.spec.locate(cid)[0], {})[cid] = data
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
        name = self._name(shard)
        rng = random.Random()
        with self.kv.locked(name):
            for attempt in range(self.retries):
                blob, generation = self.kv.read_with_generation(name)
                entries = self._entries(blob, name)
                for cid, data in stored.items():
                    if data is None:
                        entries.pop(cid, None)
                    else:
                        entries[cid] = data
                try:
                    if entries:
                        self.kv.write_bytes(name, self.encode_shard(entries),
                                            if_generation=generation)
                    elif blob is not None:
                        self.kv.delete(name, if_generation=generation)
                    return
                except PreconditionFailed:
                    telemetry.inc("storage/shard_conflicts")
                    time.sleep(min(1.0, self.backoff * 2 ** attempt)
                               * rng.uniform(0.5, 1.0))
        raise PreconditionFailed(f"{name}: lost {self.retries} races in a "
                                 f"row rewriting the shard")


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
