"""Chunked arrays: zarr v2 (read and write), zarr v3 and N5 (read),
through the KV plane.

The JAX package's ``load-zarr``/``save-zarr`` go through tensorstore's
``zarr``, ``zarr3`` and ``n5`` drivers; the port reads and writes the
same files itself, through a :class:`~volume.storage.KVBackend`: a local
directory (a bare path or ``file://``), ``gs://`` or ``s3://``
(``storage.open_kv``), or a KV handed in with a key prefix (an array
inside an OCDBT store, ``volume/ocdbt.py``):

- zarr v2: ``.zarray`` JSON metadata, ``order`` C or F (each chunk's
  values in that order), ``dimension_separator`` "." (tensorstore's
  default) or "/", every chunk file a full chunk, compressed by any
  compressor of ``volume/compressors.py`` (raw, zlib, gzip, bz2, zstd,
  blosc). ``filters`` are refused, as tensorstore refuses them. A store
  the port creates (:meth:`ZarrArray.create`) has the ``.zarray``
  tensorstore 0.1.80 writes for the same dtype and shape: blosc ``lz4``
  at clevel 5 with shuffle -1, a null fill value, C order, "." keys and
  tensorstore's chunk grid (:func:`default_chunks`). The dtype
  ``bfloat16``, which numpy lacks, is known here only:
  :meth:`ChunkedArray.read` gives its uint16 bits,
  :meth:`ChunkedArray.read_values` a ``torch.bfloat16`` tensor, and
  :meth:`ZarrArray.write` rounds what it is given to the nearest
  bfloat16 (ties to even), as tensorstore converts.
- zarr v3: ``zarr.json``, a regular chunk grid, the ``default`` ("c/0/0")
  or ``v2`` chunk key encoding, and the codec pipeline of
  ``compressors.Zarr3Codecs``: ``transpose``, then ``bytes`` (either
  endian) or ``sharding_indexed`` (the index at the start or the end;
  inner chunks read by ranges, only those a read overlaps; nested
  sharding), then ``gzip``, ``zstd``, ``blosc`` or ``crc32c``.
- N5: ``attributes.json``, blocks keyed "i/j/k" in the array's dimension
  order, each a big-endian header (mode, rank, the block's own shape)
  and its voxels in Fortran order, big-endian, compressed as zarr v2's
  or by ``bzip2`` or ``xz``.

Each chunk's read from the KV plane and its decode are timed into the
telemetry spans ``zarr/kv_read`` and ``zarr/decode``.

A chunk that is missing reads as the fill value (zarr's ``null``, and
N5's, is zero), as does a shard's inner chunk that was never written. A
write that covers part of a zarr v2 chunk reads, modifies and rewrites
it. What the port does not read (another compressor or codec) raises
naming its ROADMAP item.
"""
from __future__ import annotations

import itertools
import json
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.volume import compressors
from chunkflow_tpu_torch.volume.storage import (
    KVBackend,
    StorageBackend,
    open_kv,
)

#: the elements of a chunk tensorstore aims at where no chunks are given
CHUNK_ELEMENTS = 1 << 20
#: the compressor of a store the port creates: tensorstore's default
DEFAULT_COMPRESSOR = {"blocksize": 0, "clevel": 5, "cname": "lz4",
                      "id": "blosc", "shuffle": -1}
_refused = compressors.refused


def default_chunks(shape: Sequence[int]) -> Tuple[int, ...]:
    """tensorstore's chunk grid for a new zarr array of ``shape`` with no
    chunks given, whatever the dtype: the largest edge ``c`` such that a
    chunk of ``min(c, s)`` along each dimension ``s`` (at least 1) holds
    at most :data:`CHUNK_ELEMENTS` elements."""
    extents = [max(1, int(s)) for s in shape]

    def elements(edge: int) -> int:
        return int(np.prod([min(edge, e) for e in extents], dtype=object))

    lo, hi = 1, max(extents, default=1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if elements(mid) <= CHUNK_ELEMENTS:
            lo = mid
        else:
            hi = mid - 1
    return tuple(min(lo, e) for e in extents)


def _fill(value, dtype: np.dtype):
    if value is None:
        return dtype.type(0)
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        return dtype.type(float(value.replace("Infinity", "inf")))
    return dtype.type(value)


def _fill_of(value, dtype: np.dtype, bfloat16: bool):
    """The fill value as stored: a bfloat16 one as its uint16 bits."""
    if not bfloat16:
        return _fill(value, dtype)
    bits = np.array(_fill(value, np.dtype("<f4"))).view(np.uint32)
    return dtype.type(int(bits) >> 16)


def bfloat16_tensor(bits: np.ndarray):
    """uint16 bits as the ``torch.bfloat16`` tensor they encode."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def bfloat16_bits(values) -> np.ndarray:
    """Values (a numpy array or a tensor) rounded to the nearest bfloat16,
    ties to even, as uint16 bits."""
    import torch

    if not isinstance(values, torch.Tensor):
        values = torch.from_numpy(np.ascontiguousarray(values,
                                                       dtype=np.float32))
    values = values.detach().cpu().to(torch.bfloat16).contiguous()
    return values.view(torch.int16).numpy().view(np.uint16)


def _dtype(name: str) -> Tuple[np.dtype, bool]:
    """(the numpy dtype a stored dtype name reads as, whether it is
    bfloat16, which reads as its uint16 bits)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def _store(path: str, kv: Optional[KVBackend]) -> Tuple[KVBackend, str]:
    """(the KV plane, the key prefix) of an array at ``path``: ``path``
    is the array's root, or, with ``kv``, its key prefix in ``kv``."""
    if kv is None:
        return open_kv(path), ""
    prefix = path.strip("/")
    return kv, f"{prefix}/" if prefix else ""


class ChunkedArray:
    """A chunked array on a KV plane: ``shape``, ``chunks``, ``dtype``,
    ``fill_value``, and a subclass's ``_read_chunk(cell)`` giving one
    whole chunk in C order."""

    path: str
    kv: KVBackend
    prefix: str
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: np.dtype
    fill_value: np.generic
    compressor: compressors.Compressor
    bfloat16: bool = False

    def _read_chunk(self, cell) -> np.ndarray:
        raise NotImplementedError

    def _read_file(self, key: str) -> Optional[bytes]:
        with telemetry.span("zarr/kv_read"):
            return self.kv.read_bytes(self.prefix + key)

    def _metadata(self, name: str, what: str) -> dict:
        data = self._read_file(name)
        if data is None:
            raise FileNotFoundError(f"{self.path}: no {name} (not {what})")
        return json.loads(data)

    def _decode(self, data: bytes, stored: np.dtype, count: int) -> np.ndarray:
        """A chunk's values from its stored bytes (``count`` values)."""
        with telemetry.span("zarr/decode"):
            raw = self.compressor.decode(data, count * stored.itemsize)
        return np.frombuffer(raw, dtype=stored, count=count)

    def _fill_chunk(self) -> np.ndarray:
        return np.full(self.chunks, self.fill_value, dtype=self.dtype)

    def _box(self, index) -> Tuple[Tuple[int, int], ...]:
        """(start, stop) per dimension of an index into this array: a
        tuple of slices of the leading dimensions (unit steps)."""
        index = tuple(index) if index is not None else ()
        if len(index) > len(self.shape):
            raise IndexError(f"{len(index)} indices into a "
                             f"{len(self.shape)}-d array")
        box = []
        for dim, size in enumerate(self.shape):
            s = index[dim] if dim < len(index) else slice(None)
            start = 0 if s.start is None else int(s.start)
            stop = size if s.stop is None else int(s.stop)
            if s.step not in (None, 1) or not 0 <= start <= stop <= size:
                raise IndexError(f"{self.path}: [{start}:{stop}] is outside "
                                 f"dimension {dim} of size {size}")
            box.append((start, stop))
        return tuple(box)

    def _cells(self, box):
        """Each chunk cell overlapping ``box``: (cell index, the slices of
        the cell, the slices of the selection)."""
        ranges = [range(a // c, -(-b // c)) if b > a else range(0)
                  for (a, b), c in zip(box, self.chunks)]
        for cell in itertools.product(*ranges):
            in_cell, in_sel = [], []
            for i, ((a, b), c) in zip(cell, zip(box, self.chunks)):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                in_cell.append(slice(lo - i * c, hi - i * c))
                in_sel.append(slice(lo - a, hi - a))
            yield cell, tuple(in_cell), tuple(in_sel)

    def _read_part(self, cell, in_cell) -> np.ndarray:
        """The part ``in_cell`` (slices) of the chunk ``cell``."""
        return self._read_chunk(cell)[in_cell]

    def read(self, index=None) -> np.ndarray:
        box = self._box(index)
        out = np.empty(tuple(b - a for a, b in box), dtype=self.dtype)
        for cell, in_cell, in_sel in self._cells(box):
            out[in_sel] = self._read_part(cell, in_cell)
        return out

    def read_values(self, index=None):
        """:meth:`read`, but a ``bfloat16`` array as a ``torch.bfloat16``
        tensor on the CPU (numpy has no bfloat16)."""
        arr = self.read(index)
        return bfloat16_tensor(arr) if self.bfloat16 else arr


class ZarrArray(ChunkedArray):
    """A zarr v2 array at ``path`` (with ``kv``: the key prefix ``path``
    in ``kv``)."""

    def __init__(self, path: str, kv: Optional[KVBackend] = None):
        self.path = path
        self.kv, self.prefix = _store(path, kv)
        meta = self._metadata(".zarray", "a zarr v2 array")
        if meta.get("zarr_format") != 2:
            _refused(path, f"zarr_format {meta.get('zarr_format')}")
        self.order = meta.get("order", "C")
        if self.order not in ("C", "F"):
            _refused(path, f"the chunk order {self.order!r}")
        if meta.get("filters"):
            _refused(path, f"filters {meta['filters']}")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype, self.bfloat16 = _dtype(meta["dtype"])
        self.compressor = compressors.from_zarr(
            path, meta.get("compressor"), self.dtype.itemsize)
        self.fill_value = _fill_of(meta.get("fill_value"), self.dtype,
                                   self.bfloat16)
        self.separator = meta.get("dimension_separator", ".")

    @classmethod
    def create(cls, path: str, shape: Sequence[int], dtype,
               chunks: Optional[Sequence[int]] = None) -> "ZarrArray":
        """A new array whose chunks all read as zeros, with the
        ``.zarray`` that tensorstore 0.1.80 writes for ``dtype`` (a numpy
        dtype or ``"bfloat16"``) and ``shape``: ``chunks`` where given,
        else :func:`default_chunks`, and :data:`DEFAULT_COMPRESSOR`; its
        JSON keys sorted and compact, as tensorstore writes them."""
        shape = tuple(int(s) for s in shape)
        if chunks is None:
            chunks = default_chunks(shape)
        name = "bfloat16" if str(dtype) == "bfloat16" else np.dtype(dtype).str
        meta = {
            "chunks": [int(c) for c in chunks],
            "compressor": dict(DEFAULT_COMPRESSOR),
            "dimension_separator": ".", "dtype": name, "fill_value": None,
            "filters": None, "order": "C", "shape": list(shape),
            "zarr_format": 2,
        }
        open_kv(path).write_bytes(".zarray", json.dumps(
            meta, sort_keys=True, separators=(",", ":")).encode())
        return cls(path)

    def _key(self, index: Tuple[int, ...]) -> str:
        return self.separator.join(str(i) for i in index)

    def _read_chunk(self, index) -> np.ndarray:
        data = self._read_file(self._key(index))
        if data is None:
            return self._fill_chunk()
        count = int(np.prod(self.chunks))
        return self._decode(data, self.dtype, count).reshape(
            self.chunks, order=self.order).copy()

    def _write_chunk(self, index, block: np.ndarray) -> None:
        data = np.asarray(block, dtype=self.dtype).tobytes(order=self.order)
        self.kv.write_bytes(self.prefix + self._key(index),
                            self.compressor.encode(data))

    def write(self, index, array) -> None:
        """Write ``array`` (a numpy array, or for a ``bfloat16`` array also
        a tensor) at ``index``, converted to the array's dtype."""
        box = self._box(index)
        array = bfloat16_bits(array) if self.bfloat16 else np.asarray(array)
        want = tuple(b - a for a, b in box)
        if array.shape != want:
            raise ValueError(f"{self.path}: writing {array.shape} into a "
                             f"{want} selection")
        for cell, in_cell, in_sel in self._cells(box):
            covered = all(
                s.start == 0 and s.stop == min(c, size - i * c)
                for s, c, size, i in zip(in_cell, self.chunks, self.shape,
                                         cell))
            block = self._fill_chunk() if covered else self._read_chunk(cell)
            block[in_cell] = array[in_sel]
            self._write_chunk(cell, block)


class Zarr3Array(ChunkedArray):
    """A zarr v3 array at ``path`` (read only; with ``kv``: the key prefix
    ``path`` in ``kv``)."""

    def __init__(self, path: str, kv: Optional[KVBackend] = None):
        self.path = path
        self.kv, self.prefix = _store(path, kv)
        meta = self._metadata("zarr.json", "a zarr v3 array")
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            _refused(path, "a zarr v3 node that is not an array")
        grid = meta["chunk_grid"]
        if grid.get("name") != "regular":
            _refused(path, f"the {grid.get('name')} chunk grid")
        self.dtype, self.bfloat16 = _dtype(meta["data_type"])
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(grid["configuration"]["chunk_shape"])
        self.fill_value = _fill_of(meta.get("fill_value"), self.dtype,
                                   self.bfloat16)
        self.codecs = compressors.Zarr3Codecs(
            path, meta["codecs"], self.dtype, self.fill_value,
            len(self.shape))
        encoding = meta.get("chunk_key_encoding", {"name": "default"})
        default = encoding["name"] == "default"
        self.separator = encoding.get("configuration", {}).get(
            "separator", "/" if default else ".")
        self.key_prefix = ["c"] if default else []

    def _read_part(self, cell, in_cell) -> np.ndarray:
        key = self.separator.join(self.key_prefix + [str(i) for i in cell])
        box = tuple((s.start, s.stop) for s in in_cell)
        part = self.codecs.decode(
            compressors.KeySource(self.kv, self.prefix + key), self.chunks,
            box)
        if part is None:
            return np.full(tuple(b - a for a, b in box), self.fill_value,
                           dtype=self.dtype)
        return part


class N5Array(ChunkedArray):
    """An N5 dataset at ``path`` (read only; with ``kv``: the key prefix
    ``path`` in ``kv``), in the dimension order of its
    ``attributes.json``, as tensorstore presents it."""

    def __init__(self, path: str, kv: Optional[KVBackend] = None):
        self.path = path
        self.kv, self.prefix = _store(path, kv)
        meta = self._metadata("attributes.json", "an N5 dataset")
        self.shape = tuple(meta["dimensions"])
        self.chunks = tuple(meta["blockSize"])
        self.dtype = np.dtype(meta["dataType"])
        self.compressor = compressors.from_n5(
            path, meta.get("compression"), self.dtype.itemsize)
        self.fill_value = self.dtype.type(0)

    def _read_chunk(self, cell) -> np.ndarray:
        data = self._read_file("/".join(str(i) for i in cell))
        if data is None:
            return self._fill_chunk()
        mode, rank = struct.unpack(">HH", data[:4])
        if mode not in (0, 1):
            _refused(self.path, f"N5 block mode {mode}")
        # the block's own shape: an edge block may be smaller
        size = struct.unpack(f">{rank}I", data[4:4 + 4 * rank])
        body = data[4 + 4 * rank + (4 if mode == 1 else 0):]
        count = int(np.prod(size))
        values = self._decode(body, self.dtype.newbyteorder(">"), count)
        block = self._fill_chunk()
        block[tuple(slice(0, s) for s in size)] = values.reshape(
            size, order="F")
        return block


def open_array(path: str, driver: str = "zarr",
               kv: Optional[KVBackend] = None) -> ChunkedArray:
    """The array at ``path`` (a local path, ``file://``, ``gs://`` or
    ``s3://``; with ``kv``, a key prefix in ``kv``) in the format
    tensorstore's ``driver`` names: ``zarr`` (v2), ``zarr3`` or ``n5``."""
    return {"zarr": ZarrArray, "zarr3": Zarr3Array, "n5": N5Array}[driver](
        path, kv)


class ArrayBackend(StorageBackend):
    """A :class:`ChunkedArray` on the storage plane (read only): its
    chunks are the blocks, its domain starts at 0, as tensorstore's zarr
    and N5 drivers present it."""

    def __init__(self, array: ChunkedArray, token: str,
                 max_workers: int = 8):
        self.array = array
        self.cache_token = token
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="zarr-read")

    @property
    def domain(self):
        return (0,) * len(self.array.shape), tuple(self.array.shape)

    @property
    def dtype(self) -> np.dtype:
        return self.array.dtype

    @property
    def block_shape(self):
        return tuple(self.array.chunks)

    def as_values(self, arr: np.ndarray):
        """A cutout of this backend as :meth:`ChunkedArray.read_values`
        gives it (a ``bfloat16`` array's bits as a ``torch.bfloat16``
        tensor)."""
        return bfloat16_tensor(arr) if self.array.bfloat16 else arr

    def read_async(self, lo, hi):
        return self._pool.submit(self.array.read, tuple(
            slice(int(a), int(b)) for a, b in zip(lo, hi)))

    def write_async(self, lo, hi, arr):
        raise NotImplementedError(f"{self.array.path}: the storage-plane "
                                  f"view of a zarr or N5 array is read "
                                  f"only")
