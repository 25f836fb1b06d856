"""Chunked arrays on local disk: zarr v2 (read and write), zarr v3 and N5
(read), with numpy and the stdlib's zlib.

The JAX package's ``load-zarr``/``save-zarr`` go through tensorstore's
``zarr``, ``zarr3`` and ``n5`` drivers; the port reads and writes the
same files itself:

- zarr v2: ``.zarray`` JSON metadata, C order, ``dimension_separator``
  "." (tensorstore's default) or "/", chunks stored raw (``compressor:
  null``) or compressed with ``zlib`` or ``gzip``; every chunk file a
  full chunk. A store the port creates writes zlib.
- zarr v3: ``zarr.json``, a regular chunk grid, the ``default`` ("c/0/0")
  or ``v2`` chunk key encoding, the ``bytes`` codec (either endian),
  optionally followed by ``gzip``.
- N5: ``attributes.json``, blocks keyed "i/j/k" in the array's dimension
  order, each a big-endian header (mode, rank, the block's own shape)
  and its voxels in Fortran order, big-endian, raw or gzip.

A chunk that is missing reads as the fill value (zarr's ``null``, and
N5's, is zero). A write that covers part of a zarr v2 chunk reads,
modifies and rewrites it. A codec that is not in the stdlib (blosc,
zstd, sharding; tensorstore's own default is blosc) raises naming its
ROADMAP item.
"""
from __future__ import annotations

import itertools
import json
import os
import struct
import threading
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

DEFAULT_CHUNK = 128


def _not_supported(path: str, what: str):
    raise NotImplementedError(
        f"{path}: {what} is not ported (ROADMAP, queue 1: chunk file "
        f"formats; the port reads raw, zlib and gzip chunks)")


def _fill(value, dtype: np.dtype):
    if value is None:
        return dtype.type(0)
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        return dtype.type(float(value.replace("Infinity", "inf")))
    return dtype.type(value)


def _inflate(data: bytes) -> bytes:
    # wbits 32 + 15: a zlib or a gzip stream, by its header
    return zlib.decompress(data, 47)


def _metadata(path: str, name: str, what: str) -> dict:
    meta_path = os.path.join(path, name)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"{path}: no {name} (not {what})")
    with open(meta_path) as f:
        return json.load(f)


class ChunkedArray:
    """A chunked array on disk: ``shape``, ``chunks``, ``dtype``,
    ``fill_value``, and a subclass's ``_read_chunk(cell)`` giving one
    whole chunk in C order."""

    path: str
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: np.dtype
    fill_value: np.generic

    def _read_chunk(self, cell) -> np.ndarray:
        raise NotImplementedError

    def _read_file(self, *key: str) -> Optional[bytes]:
        try:
            with open(os.path.join(self.path, *key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

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

    def read(self, index=None) -> np.ndarray:
        box = self._box(index)
        out = np.empty(tuple(b - a for a, b in box), dtype=self.dtype)
        for cell, in_cell, in_sel in self._cells(box):
            out[in_sel] = self._read_chunk(cell)[in_cell]
        return out


class ZarrArray(ChunkedArray):
    """A zarr v2 array in the directory ``path``."""

    def __init__(self, path: str):
        self.path = path
        meta = _metadata(path, ".zarray", "a zarr v2 array")
        if meta.get("zarr_format") != 2:
            _not_supported(path, f"zarr_format {meta.get('zarr_format')}")
        if meta.get("order", "C") != "C":
            _not_supported(path, "Fortran-order chunks")
        if meta.get("filters"):
            _not_supported(path, f"filters {meta['filters']}")
        compressor = meta.get("compressor")
        if compressor is not None and compressor.get("id") not in ("zlib",
                                                                   "gzip"):
            _not_supported(path, f"the {compressor.get('id')} compressor")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = compressor
        self.fill_value = _fill(meta.get("fill_value"), self.dtype)
        self.separator = meta.get("dimension_separator", ".")

    @classmethod
    def create(cls, path: str, shape: Sequence[int], dtype,
               chunks: Optional[Sequence[int]] = None,
               level: int = 1) -> "ZarrArray":
        """A new zlib-compressed array of zeros (fill value 0)."""
        shape = tuple(int(s) for s in shape)
        if chunks is None:
            chunks = tuple(min(s, DEFAULT_CHUNK) for s in shape)
        meta = {
            "zarr_format": 2, "shape": list(shape),
            "chunks": [int(c) for c in chunks],
            "dtype": np.dtype(dtype).str, "order": "C",
            "compressor": {"id": "zlib", "level": int(level)},
            "fill_value": 0, "filters": None, "dimension_separator": ".",
        }
        os.makedirs(path, exist_ok=True)
        _write_atomic(os.path.join(path, ".zarray"),
                      json.dumps(meta).encode())
        return cls(path)

    def _key(self, index: Tuple[int, ...]) -> str:
        return self.separator.join(str(i) for i in index)

    def _read_chunk(self, index) -> np.ndarray:
        data = self._read_file(self._key(index))
        if data is None:
            return self._fill_chunk()
        if self.compressor is not None:
            data = _inflate(data)
        return np.frombuffer(data, dtype=self.dtype).reshape(
            self.chunks).copy()

    def _write_chunk(self, index, block: np.ndarray) -> None:
        data = np.ascontiguousarray(block, dtype=self.dtype).tobytes()
        if self.compressor is not None:
            level = int(self.compressor.get("level", 1))
            if self.compressor["id"] == "gzip":
                import gzip

                data = gzip.compress(data, compresslevel=level, mtime=0)
            else:
                data = zlib.compress(data, level)
        path = os.path.join(self.path, self._key(index))
        if self.separator == "/":
            os.makedirs(os.path.dirname(path), exist_ok=True)
        _write_atomic(path, data)

    def write(self, index, array) -> None:
        box = self._box(index)
        array = np.asarray(array)
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
    """A zarr v3 array in the directory ``path`` (read only)."""

    def __init__(self, path: str):
        self.path = path
        meta = _metadata(path, "zarr.json", "a zarr v3 array")
        if meta.get("zarr_format") != 3 or meta.get("node_type") != "array":
            _not_supported(path, "a zarr v3 node that is not an array")
        grid = meta["chunk_grid"]
        if grid.get("name") != "regular":
            _not_supported(path, f"the {grid.get('name')} chunk grid")
        codecs = [c["name"] for c in meta["codecs"]]
        if codecs not in (["bytes"], ["bytes", "gzip"]):
            _not_supported(path, f"the codecs {codecs}")
        endian = meta["codecs"][0].get("configuration", {}).get("endian",
                                                                "little")
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(grid["configuration"]["chunk_shape"])
        self.dtype = np.dtype(meta["data_type"])
        self.stored = self.dtype.newbyteorder("<" if endian == "little"
                                              else ">")
        self.gzip = codecs[-1] == "gzip"
        self.fill_value = _fill(meta.get("fill_value"), self.dtype)
        encoding = meta.get("chunk_key_encoding", {"name": "default"})
        default = encoding["name"] == "default"
        self.separator = encoding.get("configuration", {}).get(
            "separator", "/" if default else ".")
        self.prefix = ["c"] if default else []

    def _read_chunk(self, cell) -> np.ndarray:
        data = self._read_file(self.separator.join(
            self.prefix + [str(i) for i in cell]))
        if data is None:
            return self._fill_chunk()
        if self.gzip:
            data = _inflate(data)
        return np.frombuffer(data, dtype=self.stored).reshape(
            self.chunks).astype(self.dtype)


class N5Array(ChunkedArray):
    """An N5 dataset in the directory ``path`` (read only), in the
    dimension order of its ``attributes.json``, as tensorstore presents
    it."""

    def __init__(self, path: str):
        self.path = path
        meta = _metadata(path, "attributes.json", "an N5 dataset")
        compression = meta.get("compression", {"type": "raw"})
        if compression.get("type") not in ("raw", "gzip"):
            _not_supported(path, f"the {compression.get('type')} N5 "
                                 f"compression")
        self.shape = tuple(meta["dimensions"])
        self.chunks = tuple(meta["blockSize"])
        self.dtype = np.dtype(meta["dataType"])
        self.gzip = compression["type"] == "gzip"
        self.fill_value = self.dtype.type(0)

    def _read_chunk(self, cell) -> np.ndarray:
        data = self._read_file(*(str(i) for i in cell))
        if data is None:
            return self._fill_chunk()
        mode, rank = struct.unpack(">HH", data[:4])
        if mode not in (0, 1):
            _not_supported(self.path, f"N5 block mode {mode}")
        # the block's own shape: an edge block may be smaller
        size = struct.unpack(f">{rank}I", data[4:4 + 4 * rank])
        body = data[4 + 4 * rank + (4 if mode == 1 else 0):]
        if self.gzip:
            body = _inflate(body)
        values = np.frombuffer(body, dtype=self.dtype.newbyteorder(">"),
                               count=int(np.prod(size)))
        block = self._fill_chunk()
        block[tuple(slice(0, s) for s in size)] = values.reshape(
            size, order="F")
        return block


def open_array(path: str, driver: str = "zarr") -> ChunkedArray:
    """The array at ``path`` in the format tensorstore's ``driver`` names:
    ``zarr`` (v2), ``zarr3`` or ``n5``."""
    return {"zarr": ZarrArray, "zarr3": Zarr3Array, "n5": N5Array}[driver](
        path)


def _write_atomic(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}-{threading.get_ident()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
