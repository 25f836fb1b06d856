"""The storage plane: one backend interface, a block cache, blockwise IO.

The counterpart of ``chunkflow_tpu/volume/storage.py``. A volume is a
key-value store of fixed-size blocks, task grids overlap (halos), and
block-aligned tasks never share a block. So a cutout is read as the
storage blocks that cover it, concurrently, through a process-wide LRU of
blocks (:class:`BlockCache`), and an aligned save writes whole blocks
without reading them first:

* :class:`StorageBackend`: the async array interface.
  :class:`PrecomputedBackend` reads and writes neuroglancer precomputed
  blocks through their codec and, on a sharded scale, their shards (the
  port's only reader of real volumes);
  :class:`MemoryBackend` and :class:`KVArrayBackend` are fixtures and the
  npy-block store of the JAX package;
* the KV plane (:class:`FileKV`, :class:`MemoryKV`, and ``cloud/``'s
  ``GCSKV`` and ``S3KV`` through :func:`open_kv`): ``info`` and sidecar
  files, blocks, shards, block existence, ranged reads and conditional
  writes;
* :func:`blockwise_cutout` / :func:`serial_cutout` and
  :func:`blockwise_save`.

``CHUNKFLOW_STORAGE=serial`` reads with one whole-range read and writes
through the backend's read-modify-write path; the bytes are the same.
``CHUNKFLOW_STORAGE_CACHE_MB`` sizes the cache (default 256, <= 0: none);
``CHUNKFLOW_STORAGE_CONCURRENCY`` the block reads per wave (default 8,
which the depth controller widens through :func:`set_read_concurrency`).
All-zero blocks are never cached: an absent block reads as zeros, and a
neighbour's later write must not be hidden behind them.

Telemetry: spans ``storage/read``, ``storage/write``; counters
``storage/hits``, ``storage/misses``, ``storage/block_reads``,
``storage/bytes_read``, ``storage/bytes_written``,
``storage/aligned_writes``, ``storage/unaligned_writes``,
``storage/shard_conflicts`` (a shard rewrite that lost a race) and, on
``gs://`` and ``s3://``, ``storage/http/*`` (``cloud/http.py``); gauges
``storage/cache_bytes``, ``storage/read_concurrency``.
"""
from __future__ import annotations

import abc
import contextlib
import fcntl
import itertools
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.volume.codecs import CorruptBlockError

__all__ = [
    "storage_mode", "cache_bytes_limit", "read_concurrency",
    "set_read_concurrency", "BlockCache", "shared_cache",
    "reset_shared_cache", "GatherFuture", "StorageBackend", "MemoryBackend",
    "KVBackend", "PreconditionFailed", "FileKV", "MemoryKV", "split_url",
    "open_kv", "KVArrayBackend",
    "PrecomputedBackend", "CorruptBlockError", "serial_cutout",
    "blockwise_cutout", "blockwise_save",
]

_OFF_VALUES = ("serial", "0", "off", "false", "no")


def storage_mode() -> str:
    """``concurrent`` (default) or ``serial`` (``CHUNKFLOW_STORAGE``),
    read per call."""
    value = os.environ.get("CHUNKFLOW_STORAGE", "concurrent").lower()
    return "serial" if value in _OFF_VALUES else "concurrent"


def cache_bytes_limit() -> int:
    """The block cache's byte budget (``CHUNKFLOW_STORAGE_CACHE_MB``,
    default 256 MB; a malformed value means the default)."""
    raw = os.environ.get("CHUNKFLOW_STORAGE_CACHE_MB", "")
    try:
        mb = float(raw) if raw else 256.0
    except ValueError:
        mb = 256.0
    return int(mb * (1 << 20))


_CONC_LOCK = threading.Lock()
_READ_CONCURRENCY: Optional[int] = None


def read_concurrency() -> int:
    """Block reads per wave of a cutout: ``CHUNKFLOW_STORAGE_CONCURRENCY``
    (default 8) until :func:`set_read_concurrency` sets it."""
    with _CONC_LOCK:
        if _READ_CONCURRENCY is not None:
            return _READ_CONCURRENCY
    raw = os.environ.get("CHUNKFLOW_STORAGE_CONCURRENCY", "")
    try:
        return max(1, int(raw)) if raw else 8
    except ValueError:
        return 8


def set_read_concurrency(n: int) -> None:
    """Set the live block-read parallelism (the depth controller's
    ``storage`` knob)."""
    global _READ_CONCURRENCY
    with _CONC_LOCK:
        _READ_CONCURRENCY = max(1, int(n))
    telemetry.gauge("storage/read_concurrency", max(1, int(n)))


def reset_read_concurrency() -> None:
    """Back to the environment's value (tests)."""
    global _READ_CONCURRENCY
    with _CONC_LOCK:
        _READ_CONCURRENCY = None


# ---------------------------------------------------------------------------
# the block cache
# ---------------------------------------------------------------------------
class BlockCache:
    """A bytes-bounded, thread-safe LRU of read-only storage blocks, keyed
    ``(backend.cache_token, block_lo)``."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._nbytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._entries.get(key)
            if arr is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return arr

    def put(self, key, arr: np.ndarray) -> bool:
        """Insert one block (marked read-only in place); a block larger
        than the budget is refused; older blocks are evicted to fit."""
        nbytes = int(arr.nbytes)
        if nbytes > self.max_bytes:
            return False
        arr.setflags(write=False)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._nbytes -= old.nbytes
            self._entries[key] = arr
            self._nbytes += nbytes
            while self._nbytes > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._nbytes -= evicted.nbytes
                self.evictions += 1
        return True

    def invalidate(self, key) -> bool:
        with self._lock:
            arr = self._entries.pop(key, None)
            if arr is None:
                return False
            self._nbytes -= arr.nbytes
            return True

    def invalidate_token(self, token) -> int:
        """Drop every block of one dataset (a recreated volume)."""
        with self._lock:
            doomed = [k for k in self._entries if k and k[0] == token]
            for key in doomed:
                self._nbytes -= self._entries.pop(key).nbytes
            return len(doomed)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes = 0


_CACHE_LOCK = threading.Lock()
_SHARED_CACHE: Optional[BlockCache] = None


def shared_cache() -> Optional[BlockCache]:
    """The process-wide block cache (None when the budget is <= 0),
    rebuilt when the budget changes."""
    global _SHARED_CACHE
    limit = cache_bytes_limit()
    if limit <= 0:
        return None
    with _CACHE_LOCK:
        if _SHARED_CACHE is None or _SHARED_CACHE.max_bytes != limit:
            _SHARED_CACHE = BlockCache(limit)
        return _SHARED_CACHE


def reset_shared_cache() -> None:
    global _SHARED_CACHE
    with _CACHE_LOCK:
        _SHARED_CACHE = None


class GatherFuture:
    """One future over many: ``result()`` drains every member even when
    one fails and raises the first failure; ``copy`` gathers the members'
    copy legs (after which the caller may reuse its buffer)."""

    __slots__ = ("_futures",)

    def __init__(self, futures: Iterable):
        self._futures = list(futures)

    def result(self):
        first: Optional[BaseException] = None
        for future in self._futures:
            try:
                future.result()
            except BaseException as exc:
                if first is None:
                    first = exc
        if first is not None:
            raise first
        return None

    @property
    def copy(self) -> "GatherFuture":
        return GatherFuture([getattr(f, "copy", f) for f in self._futures])


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------
class StorageBackend(abc.ABC):
    """An async array store in its own index order; the cutout and save
    machinery and the cache are written once against this."""

    #: identity of the backing dataset: the cache's key namespace
    cache_token: str

    @property
    @abc.abstractmethod
    def domain(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """(inclusive_min, exclusive_max) index bounds."""

    @property
    @abc.abstractmethod
    def dtype(self) -> np.dtype:
        ...

    @property
    @abc.abstractmethod
    def block_shape(self) -> Tuple[int, ...]:
        ...

    @property
    def grid_offset(self) -> Tuple[int, ...]:
        """Where the block grid is anchored (the domain's lower bound)."""
        return self.domain[0]

    @abc.abstractmethod
    def read_async(self, lo: Sequence[int], hi: Sequence[int]):
        """Start reading ``[lo, hi)``; a future of an ndarray."""

    @abc.abstractmethod
    def write_async(self, lo: Sequence[int], hi: Sequence[int], arr):
        """Start writing ``arr`` over ``[lo, hi)``; a future."""


def _slices(lo, hi) -> tuple:
    return tuple(slice(l, h) for l, h in zip(lo, hi))


class MemoryBackend(StorageBackend):
    """A backend over a numpy array (tests). ``latency_s`` charges a
    simulated fetch latency per storage block covered, in the backend's
    worker threads."""

    _SEQ = itertools.count()

    def __init__(self, array: np.ndarray,
                 block_shape: Optional[Sequence[int]] = None,
                 latency_s: float = 0.0, max_workers: int = 8):
        self._array = array
        self._lock = threading.Lock()
        self._latency_s = float(latency_s)
        self.cache_token = f"memory-{next(self._SEQ)}"
        self._block_shape = tuple(int(v)
                                  for v in (block_shape or array.shape))
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="chunkflow-storage")

    @property
    def domain(self):
        return (tuple(0 for _ in self._array.shape),
                tuple(int(s) for s in self._array.shape))

    @property
    def dtype(self) -> np.dtype:
        return self._array.dtype

    @property
    def block_shape(self):
        return self._block_shape

    def _covered_blocks(self, lo, hi) -> int:
        n = 1
        for l, h, b in zip(lo, hi, self._block_shape):
            n *= max(1, -((-(h - (l - l % b))) // b))
        return n

    def _read(self, lo, hi):
        if self._latency_s:
            time.sleep(self._latency_s * self._covered_blocks(lo, hi))
        with self._lock:
            return np.array(self._array[_slices(lo, hi)], copy=True)

    def _write(self, lo, hi, arr):
        if self._latency_s:
            time.sleep(self._latency_s * self._covered_blocks(lo, hi))
        with self._lock:
            self._array[_slices(lo, hi)] = arr

    def read_async(self, lo, hi):
        return self._pool.submit(self._read, tuple(lo), tuple(hi))

    def write_async(self, lo, hi, arr):
        return self._pool.submit(self._write, tuple(lo), tuple(hi), arr)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# the KV plane (sidecar files, block existence, shards)
# ---------------------------------------------------------------------------
class PreconditionFailed(IOError):
    """A conditional write or delete found another generation: another
    writer got there first."""


class KVBackend(abc.ABC):
    """The object plane of a volume root: ``info``, sidecars, blocks and
    shards.

    A *generation* names one version of an object (GCS's generation, S3's
    ETag, a file's ``(st_mtime_ns, st_size, st_ino)``); an absent object's
    is ``0``. A write or delete under ``if_generation`` happens only while
    the object is at that generation (``0``: must not exist) and raises
    :class:`PreconditionFailed` otherwise, so a read-modify-write that
    lost a race can read again and retry."""

    @abc.abstractmethod
    def read_bytes(self, name: str) -> Optional[bytes]:
        """The value of ``name``, or None when absent."""

    @abc.abstractmethod
    def read_with_generation(self, name: str) -> Tuple[Optional[bytes], object]:
        """``(value or None, generation)``."""

    @abc.abstractmethod
    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None) -> Tuple[Optional[bytes], object]:
        """``(bytes [start, stop) of the value or None, generation)``;
        under ``if_generation`` another generation raises
        :class:`PreconditionFailed`."""

    @abc.abstractmethod
    def write_bytes(self, name: str, data, if_generation=None) -> None:
        """Write ``data`` (bytes or any buffer) as ``name``."""

    @abc.abstractmethod
    def delete(self, name: str, if_generation=None) -> None:
        """Remove ``name`` (absent: nothing to do, unless a generation
        other than 0 is required)."""

    @abc.abstractmethod
    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        ...

    def locked(self, name: str):
        """A context that holds off other writers of ``name`` where the
        backend can (a file lock); elsewhere writes race and conditional
        writes settle it."""
        return contextlib.nullcontext()


def _file_generation(st: os.stat_result) -> tuple:
    return (st.st_mtime_ns, st.st_size, st.st_ino)


class FileKV(KVBackend):
    """A directory on the local filesystem. Writes go through a temporary
    file and a rename, so no reader sees a torn value; a conditional write
    or delete compares and writes under the name's ``<name>.lock`` flock
    (:meth:`locked`, re-entrant in a thread)."""

    def __init__(self, root: str):
        self.root = root
        self._held = threading.local()
        self._thread_locks: Dict[str, threading.Lock] = {}
        self._thread_locks_lock = threading.Lock()

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def read_bytes(self, name: str) -> Optional[bytes]:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def read_with_generation(self, name: str):
        try:
            with open(self._path(name), "rb") as f:
                return f.read(), _file_generation(os.fstat(f.fileno()))
        except FileNotFoundError:
            return None, 0

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        try:
            f = open(self._path(name), "rb")
        except FileNotFoundError:
            if if_generation not in (None, 0):
                raise PreconditionFailed(f"{name} is gone") from None
            return None, 0
        with f:
            generation = _file_generation(os.fstat(f.fileno()))
            if if_generation is not None and generation != if_generation:
                raise PreconditionFailed(f"{name} changed")
            f.seek(start)
            return f.read(max(0, stop - start)), generation

    def _generation(self, name: str):
        try:
            return _file_generation(os.stat(self._path(name)))
        except FileNotFoundError:
            return 0

    @contextlib.contextmanager
    def locked(self, name: str):
        held = getattr(self._held, "names", None)
        if held is None:
            held = self._held.names = {}
        if held.get(name):
            held[name] += 1
            try:
                yield
            finally:
                held[name] -= 1
            return
        with self._thread_locks_lock:
            lock = self._thread_locks.setdefault(name, threading.Lock())
        path = self._path(name)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        with lock, open(f"{path}.lock", "a") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            held[name] = 1
            try:
                yield
            finally:
                held[name] = 0

    def write_bytes(self, name: str, data, if_generation=None) -> None:
        if if_generation is not None:
            with self.locked(name):
                if self._generation(name) != if_generation:
                    raise PreconditionFailed(f"{name} changed")
                self.write_bytes(name, data)
            return
        path = self._path(name)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def delete(self, name: str, if_generation=None) -> None:
        if if_generation is not None:
            with self.locked(name):
                if self._generation(name) != if_generation:
                    raise PreconditionFailed(f"{name} changed")
                self.delete(name)
            return
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            pass

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        return {name: os.path.exists(self._path(name)) for name in names}


class MemoryKV(KVBackend):
    """An in-process KV plane (tests); thread-safe; generations count
    writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._data: Dict[str, bytes] = {}
        self._generations: Dict[str, int] = {}
        self._next = itertools.count(1)

    def read_bytes(self, name: str) -> Optional[bytes]:
        with self._lock:
            return self._data.get(name)

    def read_with_generation(self, name: str):
        with self._lock:
            return self._data.get(name), self._generations.get(name, 0)

    def read_range(self, name: str, start: int, stop: int,
                   if_generation=None):
        with self._lock:
            generation = self._generations.get(name, 0)
            if if_generation is not None and generation != if_generation:
                raise PreconditionFailed(f"{name} changed")
            data = self._data.get(name)
            return (None if data is None else data[start:stop]), generation

    def _check(self, name: str, if_generation) -> None:
        if if_generation is not None and \
                self._generations.get(name, 0) != if_generation:
            raise PreconditionFailed(f"{name} changed")

    def write_bytes(self, name: str, data, if_generation=None) -> None:
        with self._lock:
            self._check(name, if_generation)
            self._data[name] = bytes(data)
            self._generations[name] = next(self._next)

    def delete(self, name: str, if_generation=None) -> None:
        with self._lock:
            self._check(name, if_generation)
            self._data.pop(name, None)
            self._generations.pop(name, None)

    def exists_many(self, names: Sequence[str]) -> Dict[str, bool]:
        with self._lock:
            return {name: name in self._data for name in names}


def split_url(path: str) -> Tuple[str, str, str]:
    """``(scheme, bucket, prefix)`` of a volume root, as the JAX package's
    ``_kvstore_spec`` reads it: ``gs://b/p`` and ``s3://b/p`` name a bucket
    and a path in it; ``file://p`` and a bare path are ``("file", "",
    p)``."""
    for scheme in ("gs", "s3"):
        if path.startswith(f"{scheme}://"):
            bucket, _, rest = path[len(scheme) + 3:].partition("/")
            return scheme, bucket, rest
    if path.startswith("file://"):
        path = path[len("file://"):]
    return "file", "", path


def open_kv(path: str) -> KVBackend:
    """The KV plane of a volume root: :class:`FileKV` for a bare path or
    ``file://``, ``GCSKV`` for ``gs://bucket/path``, ``S3KV`` for
    ``s3://bucket/path`` (``cloud/``)."""
    scheme, bucket, rest = split_url(path)
    if scheme == "gs":
        from chunkflow_tpu_torch.cloud.gcs import GCSKV

        return GCSKV(bucket, rest)
    if scheme == "s3":
        from chunkflow_tpu_torch.cloud.s3 import S3KV

        return S3KV(bucket, rest)
    return FileKV(rest)


class KVArrayBackend(StorageBackend):
    """One object per storage block through a :class:`KVBackend`, on the
    grid anchored at the domain origin; blocks are npy files keyed
    ``<prefix>/<lo-hi per axis>.npy`` (the JAX package's store). An absent
    block reads as ``fill``. A write that covers a whole (clamped) block
    stores it; a partial write reads, modifies and writes the block."""

    _SEQ = itertools.count()

    def __init__(self, kv: KVBackend, domain, dtype,
                 block_shape: Sequence[int], prefix: str = "blocks",
                 fill=0, max_workers: int = 4):
        self._kv = kv
        lo, hi = domain
        self._domain = (tuple(int(v) for v in lo), tuple(int(v) for v in hi))
        self._dtype = np.dtype(dtype)
        self._block_shape = tuple(int(v) for v in block_shape)
        self._prefix = prefix
        self._fill = fill
        root = getattr(kv, "root", None) or getattr(kv, "url", None)
        self.cache_token = (f"kvarray:{root}:{prefix}" if root is not None
                            else f"kvarray:mem{next(self._SEQ)}:{prefix}")
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="chunkflow-kvarray")
        self._rmw_locks = [threading.Lock() for _ in range(64)]

    @property
    def domain(self):
        return self._domain

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def block_shape(self):
        return self._block_shape

    def _block_key(self, blo, bhi) -> str:
        span = "_".join(f"{l}-{h}" for l, h in zip(blo, bhi))
        return f"{self._prefix}/{span}.npy"

    def _decode(self, data: bytes, shape) -> np.ndarray:
        import io

        return np.load(io.BytesIO(data), allow_pickle=False)

    def _encode(self, arr: np.ndarray):
        import io

        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr, dtype=self._dtype),
                allow_pickle=False)
        return buf.getvalue()

    def _read_block(self, blo, bhi) -> np.ndarray:
        shape = tuple(h - l for l, h in zip(blo, bhi))
        data = self._kv.read_bytes(self._block_key(blo, bhi))
        if data is None:
            return np.full(shape, self._fill, dtype=self._dtype)
        return self._decode(data, shape)

    def _write_block(self, blo, bhi, arr: np.ndarray) -> None:
        self._kv.write_bytes(self._block_key(blo, bhi), self._encode(arr))

    def _read(self, lo, hi) -> np.ndarray:
        dlo, dhi = self._domain
        blocks = _covering_blocks(lo, hi, self._block_shape,
                                  self.grid_offset, dlo, dhi)
        if len(blocks) == 1 and blocks[0] == (lo, hi):
            return self._read_block(lo, hi)  # one whole block: no copy
        out = np.empty(tuple(h - l for l, h in zip(lo, hi)), dtype=self._dtype)
        for blo, bhi in blocks:
            _copy_block(out, lo, hi, self._read_block(blo, bhi), blo, bhi)
        return out

    def _write(self, lo, hi, arr: np.ndarray) -> None:
        dlo, dhi = self._domain
        for blo, bhi in _covering_blocks(lo, hi, self._block_shape,
                                         self.grid_offset, dlo, dhi):
            sel = tuple(slice(max(l, bl) - l, min(h, bh) - l)
                        for l, h, bl, bh in zip(lo, hi, blo, bhi))
            if all(l <= bl and bh <= h
                   for l, h, bl, bh in zip(lo, hi, blo, bhi)):
                self._write_block(blo, bhi, arr[sel])
                continue
            lock = self._rmw_locks[hash(blo) % len(self._rmw_locks)]
            with lock:  # partial: read, modify, write
                block = np.array(self._read_block(blo, bhi))
                block[tuple(slice(max(l, bl) - bl, min(h, bh) - bl)
                            for l, h, bl, bh in zip(lo, hi, blo, bhi))] = \
                    arr[sel]
                self._write_block(blo, bhi, block)

    def read_async(self, lo, hi):
        return self._pool.submit(self._read, tuple(lo), tuple(hi))

    def write_async(self, lo, hi, arr):
        return self._pool.submit(self._write, tuple(lo), tuple(hi), arr)

    def close(self) -> None:
        self._pool.shutdown(wait=False)


def _done_future() -> Future:
    future = Future()
    future.set_result(None)
    return future


class PrecomputedBackend(KVArrayBackend):
    """One scale of a neuroglancer precomputed volume, in czyx index
    order, through its block codec (``volume/codecs.py``: ``raw``,
    ``jpeg``, ``png``, ``compressed_segmentation``) and, for a sharded
    scale, its shards (``volume/sharding.py``).

    Unsharded, one file per block, named
    ``{key}/{x0}-{x1}_{y0}-{y1}_{z0}-{z1}`` in voxel coordinates; the
    block grid is anchored at the scale's ``voxel_offset``; an edge block
    is clipped to the volume bounds in its name and its size. Sharded, a
    block is the chunk of its grid position's compressed Morton id. A
    block holds every channel. An absent block reads as zeros
    (``cutout`` checks existence first in strict mode); a block that does
    not decode to its shape raises :class:`CorruptBlockError`.

    A sharded write encodes every block it covers and then rewrites each
    touched shard once (``whole_range_writes``: an aligned save hands
    the backend its whole range, not block by block); a block all zeros
    is removed from its shard, as tensorstore stores no chunk of the fill
    value.

    ``write_async`` copies the data on the caller's thread (so the caller
    may reuse its buffer) and encodes and writes in the pool: its
    future's ``copy`` leg is done when it returns.
    """

    def __init__(self, kv: KVBackend, key: str, size_zyx, offset_zyx,
                 block_zyx, num_channels: int, dtype,
                 token: Optional[str] = None, max_workers: int = 8,
                 codec=None, sharded=None):
        from chunkflow_tpu_torch.volume.codecs import RawCodec

        offset = tuple(int(v) for v in offset_zyx)
        domain = ((0,) + offset,
                  (int(num_channels),) + tuple(o + int(s) for o, s in
                                               zip(offset, size_zyx)))
        super().__init__(kv, domain, np.dtype(dtype).newbyteorder("<"),
                         (int(num_channels),) + tuple(int(b)
                                                      for b in block_zyx),
                         prefix=key, max_workers=max_workers)
        if token is not None:
            self.cache_token = token
        self._codec = codec if codec is not None else RawCodec(dtype)
        self._sharded = sharded
        self.whole_range_writes = sharded is not None
        # xyz extent of the chunk grid, for sharded chunk ids
        self._grid = tuple(-(-int(s) // int(b)) for s, b in
                           zip(reversed(tuple(size_zyx)),
                               reversed(tuple(block_zyx))))

    def _block_key(self, blo, bhi) -> str:
        (_, z0, y0, x0), (_, z1, y1, x1) = blo, bhi
        return f"{self._prefix}/{x0}-{x1}_{y0}-{y1}_{z0}-{z1}"

    def _chunk_id(self, blo) -> int:
        from chunkflow_tpu_torch.volume.sharding import \
            compressed_morton_code

        goff, block = self.grid_offset, self._block_shape
        position = [(blo[d] - goff[d]) // block[d] for d in (3, 2, 1)]
        return compressed_morton_code(position, self._grid)

    def _decode(self, data: bytes, shape) -> np.ndarray:
        # a block file holds every channel
        shape = (self._block_shape[0],) + tuple(shape[1:])
        try:
            return self._codec.decode(data, shape)
        except CorruptBlockError as exc:
            raise CorruptBlockError(
                f"corrupt block under {self._prefix} ({self._codec.name}): "
                f"{exc}") from None

    def _encode(self, arr: np.ndarray):
        return self._codec.encode(arr)

    def _read_block(self, blo, bhi) -> np.ndarray:
        # a block is all its channels: read the whole, select the range
        full_lo = (0,) + tuple(blo[1:])
        full_hi = (self._block_shape[0],) + tuple(bhi[1:])
        if self._sharded is None:
            block = super()._read_block(full_lo, full_hi)
        else:
            data = self._sharded.read(self._chunk_id(full_lo))
            shape = tuple(h - l for l, h in zip(full_lo, full_hi))
            block = (np.zeros(shape, dtype=self._dtype) if data is None
                     else self._decode(data, shape))
        return block[blo[0]:bhi[0]]

    def _write(self, lo, hi, arr: np.ndarray) -> None:
        if lo[0] != 0 or hi[0] != self._block_shape[0]:
            # some channels only: every covered block is read first
            full_lo = (0,) + tuple(lo[1:])
            full_hi = (self._block_shape[0],) + tuple(hi[1:])
            block = np.array(self._read(full_lo, full_hi))
            block[lo[0]:hi[0]] = arr
            lo, hi, arr = full_lo, full_hi, block
        if self._sharded is None:
            super()._write(lo, hi, arr)
            return
        dlo, dhi = self._domain
        updates = {}
        for blo, bhi in _covering_blocks(lo, hi, self._block_shape,
                                         self.grid_offset, dlo, dhi):
            sel = tuple(slice(max(l, bl) - l, min(h, bh) - l)
                        for l, h, bl, bh in zip(lo, hi, blo, bhi))
            if all(l <= bl and bh <= h
                   for l, h, bl, bh in zip(lo, hi, blo, bhi)):
                block = arr[sel]
            else:  # partial: read, modify
                block = np.array(self._read_block(blo, bhi))
                block[tuple(slice(max(l, bl) - bl, min(h, bh) - bl)
                            for l, h, bl, bh in zip(lo, hi, blo, bhi))] = \
                    arr[sel]
            updates[self._chunk_id(blo)] = (self._encode(block)
                                            if block.any() else None)
        self._sharded.write(updates)

    def write_async(self, lo, hi, arr):
        data = np.array(arr, dtype=self._dtype, order="C", copy=True)
        future = self._pool.submit(self._write, tuple(lo), tuple(hi), data)
        future.copy = _done_future()
        return future


# ---------------------------------------------------------------------------
# blockwise reads
# ---------------------------------------------------------------------------
def _covering_blocks(lo, hi, block, goff, dlo, dhi) -> List[tuple]:
    """Clamped block bounds ``(blo, bhi)`` covering ``[lo, hi)`` on the
    grid anchored at ``goff``, in grid order."""
    ranges = [range((lo[d] - goff[d]) // block[d],
                    -((-(hi[d] - goff[d])) // block[d]))
              for d in range(len(lo))]
    blocks = []
    for idx in itertools.product(*ranges):
        blo = tuple(max(goff[d] + idx[d] * block[d], dlo[d])
                    for d in range(len(lo)))
        bhi = tuple(min(goff[d] + (idx[d] + 1) * block[d], dhi[d])
                    for d in range(len(lo)))
        blocks.append((blo, bhi))
    return blocks


def _copy_block(out, lo, hi, arr, blo, bhi) -> None:
    """Copy the part of a block (over ``[blo, bhi)``) inside ``[lo, hi)``
    into ``out`` (origin ``lo``)."""
    sel_out, sel_blk = [], []
    for d in range(len(lo)):
        ilo, ihi = max(lo[d], blo[d]), min(hi[d], bhi[d])
        sel_out.append(slice(ilo - lo[d], ihi - lo[d]))
        sel_blk.append(slice(ilo - blo[d], ihi - blo[d]))
    out[tuple(sel_out)] = arr[tuple(sel_blk)]


def _check_domain(backend: StorageBackend, lo, hi) -> None:
    dlo, dhi = backend.domain
    for d in range(len(lo)):
        if lo[d] < dlo[d] or hi[d] > dhi[d] or lo[d] >= hi[d]:
            raise ValueError(f"request [{tuple(lo)}, {tuple(hi)}) outside "
                             f"storage domain [{dlo}, {dhi})")


def serial_cutout(backend: StorageBackend, lo: Sequence[int],
                  hi: Sequence[int]) -> np.ndarray:
    """One blocking whole-range read (``CHUNKFLOW_STORAGE=serial``)."""
    lo, hi = tuple(int(v) for v in lo), tuple(int(v) for v in hi)
    _check_domain(backend, lo, hi)
    with telemetry.span("storage/read", mode="serial"):
        arr = np.asarray(backend.read_async(lo, hi).result())
    telemetry.inc("storage/bytes_read", arr.nbytes)
    return arr


def blockwise_cutout(backend: StorageBackend, lo: Sequence[int],
                     hi: Sequence[int],
                     cache: Optional[BlockCache] = None) -> np.ndarray:
    """Read ``[lo, hi)`` block by block: cached blocks from memory, the
    rest as concurrent reads in waves of :func:`read_concurrency`. Whole
    (clamped) blocks are read even at the edges, so a neighbour's halo
    read finds them in the cache."""
    lo, hi = tuple(int(v) for v in lo), tuple(int(v) for v in hi)
    _check_domain(backend, lo, hi)
    dlo, dhi = backend.domain
    out = np.empty(tuple(h - l for l, h in zip(lo, hi)), dtype=backend.dtype)
    blocks = _covering_blocks(lo, hi, backend.block_shape,
                              backend.grid_offset, dlo, dhi)
    hits = 0
    bytes_read = 0
    missing: List[tuple] = []
    with telemetry.span("storage/read", mode="blockwise",
                        blocks=len(blocks)):
        for blo, bhi in blocks:
            cached = (cache.get((backend.cache_token, blo))
                      if cache is not None else None)
            if cached is None:
                missing.append((blo, bhi))
            else:
                hits += 1
                _copy_block(out, lo, hi, cached, blo, bhi)
        wave = max(1, read_concurrency())
        for i in range(0, len(missing), wave):
            batch = missing[i:i + wave]
            futures = [backend.read_async(blo, bhi) for blo, bhi in batch]
            for (blo, bhi), future in zip(batch, futures):
                arr = np.asarray(future.result())
                bytes_read += arr.nbytes
                # an all-zero block may not exist yet: never pin it
                if cache is not None and arr.any():
                    cache.put((backend.cache_token, blo), arr)
                _copy_block(out, lo, hi, arr, blo, bhi)
    if telemetry.enabled():
        if hits:
            telemetry.inc("storage/hits", hits)
        if missing:
            telemetry.inc("storage/misses", len(missing))
            telemetry.inc("storage/block_reads", len(missing))
            telemetry.inc("storage/bytes_read", bytes_read)
        if cache is not None:
            telemetry.gauge("storage/cache_bytes", cache.nbytes)
    return out


# ---------------------------------------------------------------------------
# the coalescing write path
# ---------------------------------------------------------------------------
def _write_is_aligned(lo, hi, block, goff, dlo, dhi) -> bool:
    """True when ``[lo, hi)`` starts on the block grid and ends on it or at
    the domain's edge: the write owns whole blocks."""
    for d in range(len(lo)):
        if (lo[d] - goff[d]) % block[d] != 0:
            return False
        if hi[d] != dhi[d] and (hi[d] - goff[d]) % block[d] != 0:
            return False
    return True


def blockwise_save(backend: StorageBackend, lo: Sequence[int],
                   arr: np.ndarray, cache: Optional[BlockCache] = None,
                   wait: bool = True):
    """Write ``arr`` at ``lo``. An aligned write is one future per block
    (one for the whole range on a backend with ``whole_range_writes``),
    and the cache takes a copy of each written block (read-after-write
    through the cache returns the new bytes before they are durable); an
    unaligned write is one backend write and drops the covered blocks
    from the cache.

    ``wait=True`` returns once every block is durable (all futures
    drained, the first failure raised). ``wait=False`` waits for the copy
    legs only and returns a :class:`GatherFuture`, which the task's ack
    drains (``runtime.drain_pending_writes``)."""
    lo = tuple(int(v) for v in lo)
    hi = tuple(l + s for l, s in zip(lo, arr.shape))
    _check_domain(backend, lo, hi)
    dlo, dhi = backend.domain
    block, goff = backend.block_shape, backend.grid_offset
    aligned = (storage_mode() == "concurrent"
               and _write_is_aligned(lo, hi, block, goff, dlo, dhi))
    whole_range = getattr(backend, "whole_range_writes", False)
    futures = []
    with telemetry.span("storage/write",
                        mode="aligned" if aligned else "unaligned"):
        if aligned:
            if whole_range:  # the backend batches its blocks itself
                futures.append(backend.write_async(lo, hi, arr))
            for blo, bhi in _covering_blocks(lo, hi, block, goff, dlo, dhi):
                sub = arr[tuple(slice(bl - l, bh - l)
                                for l, bl, bh in zip(lo, blo, bhi))]
                if not whole_range:
                    futures.append(backend.write_async(blo, bhi, sub))
                if cache is not None:
                    block_copy = np.array(sub, copy=True)
                    if block_copy.any():
                        cache.put((backend.cache_token, blo), block_copy)
                    else:
                        cache.invalidate((backend.cache_token, blo))
            telemetry.inc("storage/aligned_writes")
        else:
            futures.append(backend.write_async(lo, hi, arr))
            if cache is not None:
                for blo, _bhi in _covering_blocks(lo, hi, block, goff,
                                                  dlo, dhi):
                    cache.invalidate((backend.cache_token, blo))
            telemetry.inc("storage/unaligned_writes")
        telemetry.inc("storage/bytes_written", arr.nbytes)
        gathered = GatherFuture(futures)
        if wait:
            gathered.result()
            return None
        gathered.copy.result()
    return gathered
