"""The chunk codecs of zarr v2, zarr v3 and N5: one registry.

Each store names its compressor its own way: zarr v2's ``.zarray``
``compressor`` (``{"id": ...}`` or null), zarr v3's bytes-to-bytes
``codecs``, N5's ``compression`` (``{"type": ...}``). All of them map
here onto one of seven compressors:

- ``raw``: the bytes as they are;
- ``zlib`` and ``gzip``: the stdlib's ``zlib`` (either stream is read by
  its header);
- ``bz2`` (zarr v2 ``bz2``, N5 ``bzip2``) and ``xz`` (N5 ``xz``): the
  stdlib's ``bz2`` and ``lzma``;
- ``zstd``: the host C++ encoder and decoder (``volume/zstd.py``);
- ``blosc``: the host C++ decoder (``volume/blosc.py``), for every cname
  tensorstore writes (``blosclz``, ``lz4``, ``lz4hc``, ``snappy``,
  ``zlib``, ``zstd``), and frames of the store's cname written.

A zarr v3 array's ``codecs`` are a pipeline (:class:`Zarr3Codecs`):
``transpose`` (array to array), then ``bytes`` or ``sharding_indexed``
(array to bytes), then any of ``gzip``, ``zstd``, ``blosc`` and
``crc32c`` (bytes to bytes). A ``sharding_indexed`` chunk (a shard) is an
index of ``(offset, nbytes)`` per inner chunk, at its start or its end,
itself encoded by its ``index_codecs``, and inner chunks encoded by the
inner ``codecs``, which may shard again. A shard is read by ranges: its
index, then only the inner chunks a read overlaps
(:class:`KeySource`, on the KV plane's ``read_range`` and
``read_suffix``). A missing shard or inner chunk reads as the fill value;
a ``crc32c`` that does not match raises ``ValueError``.

A store the port creates is the one tensorstore creates: blosc, cname
``lz4``, clevel 5, shuffle -1 (``volume/zarr.py``). A write into an
existing store writes its compressor at its level: zstd frames into a
zstd store (``zstd.compress``), and into a blosc store blosc frames
shuffled as the store's ``shuffle`` says, in the codec of its cname: LZ4
for ``lz4`` (found by LZ4 HC's hash chains for ``lz4hc``), blosclz,
snappy, zlib or zstd for the others (``blosc.compress``). A compressor id, codec, blosc cname or shuffle that
tensorstore does not register raises ``ValueError``, as tensorstore
does.
"""
from __future__ import annotations

import bz2
import gzip
import itertools
import lzma
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from chunkflow_tpu_torch.core import telemetry
from chunkflow_tpu_torch.volume import blosc, zstd

READS = "raw, zlib, gzip, bz2, xz, zstd and blosc"
#: the bound on a zstd frame's output where nothing states its size
ZSTD_MAX_BYTES = 1 << 36
#: an index entry of an inner chunk that was never written
MISSING = 2 ** 64 - 1


def refused(path: str, what: str):
    """Raise for a store tensorstore does not open either (its own error
    is a ``ValueError`` too)."""
    raise ValueError(f"{path}: {what}, which tensorstore does not open "
                     f"either (the port reads {READS} chunks)")


class Compressor:
    """One compressor: ``decode(data, size)`` gives the ``size`` bytes of a
    chunk (``size`` None: as many as the data holds), ``encode(data)`` the
    bytes to store (a blosc one in the codec of its ``cname``, shuffled as
    its ``shuffle`` says)."""

    def __init__(self, name: str, level: int = 1, typesize: int = 1,
                 path: str = "", cname: str = "zlib", shuffle=1):
        self.name, self.level, self.typesize = name, int(level), typesize
        self.path, self.cname, self.shuffle = path, cname, shuffle

    def decode(self, data: bytes, size: Optional[int] = None) -> bytes:
        if self.name == "raw":
            return data
        if self.name in ("zlib", "gzip"):
            # wbits 32 + 15: a zlib or a gzip stream, by its header
            return zlib.decompress(data, 47)
        if self.name == "bz2":
            return bz2.decompress(data)
        if self.name == "xz":
            return lzma.decompress(data)
        if self.name == "zstd":
            return zstd.decompress(data, size, max_size=ZSTD_MAX_BYTES)
        return blosc.decompress(data, size)

    def encode(self, data: bytes) -> bytes:
        if self.name == "raw":
            return data
        if self.name == "zlib":
            return zlib.compress(data, self.level)
        if self.name == "gzip":
            return gzip.compress(data, compresslevel=self.level, mtime=0)
        if self.name == "bz2":
            return bz2.compress(data, self.level)
        if self.name == "xz":
            return lzma.compress(data, format=lzma.FORMAT_XZ,
                                 preset=self.level)
        if self.name == "zstd":
            return zstd.compress(data, self.level)
        return blosc.compress(data, self.typesize, self.level, self.cname,
                              self.shuffle)


class Crc32c:
    """zarr v3's ``crc32c`` codec: the bytes, then their CRC-32C as four
    little-endian bytes."""

    def __init__(self, path: str = ""):
        self.path = path

    def decode(self, data: bytes, size: Optional[int] = None) -> bytes:
        from chunkflow_tpu_torch.volume.crc32c import crc32c

        if len(data) < 4:
            raise ValueError(f"{self.path}: {len(data)} bytes hold no "
                             f"crc32c")
        body, (stored,) = data[:-4], struct.unpack("<I", data[-4:])
        if crc32c(body) != stored:
            raise ValueError(f"{self.path}: crc32c mismatch (the stored "
                             f"checksum is {stored:#010x})")
        return body

    def encode(self, data: bytes) -> bytes:
        from chunkflow_tpu_torch.volume.crc32c import crc32c

        return bytes(data) + struct.pack("<I", crc32c(data))


def _blosc(path: str, config: dict, typesize: int) -> Compressor:
    cname = config.get("cname")
    if cname not in blosc.CNAMES:
        refused(path, f"the blosc cname {cname!r}")
    shuffle = config.get("shuffle", 1)
    try:
        blosc.shuffle_flags(shuffle, typesize)
    except blosc.BloscError:
        refused(path, f"the blosc shuffle {shuffle!r}")
    return Compressor("blosc", config.get("clevel", 5), typesize, path,
                      cname, shuffle)


def from_zarr(path: str, compressor: Optional[dict],
              typesize: int) -> Compressor:
    """A zarr v2 ``compressor``."""
    if compressor is None:
        return Compressor("raw")
    cid = compressor.get("id")
    if cid in ("zlib", "gzip", "zstd", "bz2"):
        return Compressor(cid, compressor.get("level", 1), path=path)
    if cid == "blosc":
        return _blosc(path, compressor, typesize)
    refused(path, f"the {cid} compressor")


def from_n5(path: str, compression: Optional[dict],
            typesize: int) -> Compressor:
    """An N5 ``compression``."""
    compression = compression or {"type": "raw"}
    kind = compression.get("type")
    if kind in ("raw", "gzip", "zstd"):
        return Compressor(kind, compression.get("level", 1), path=path)
    if kind == "bzip2":
        return Compressor("bz2", compression.get("blockSize", 9), path=path)
    if kind == "xz":
        return Compressor("xz", compression.get("preset", 6), path=path)
    if kind == "blosc":
        return _blosc(path, compression, typesize)
    refused(path, f"the {kind} N5 compression")


# ---------------------------------------------------------------------------
# where a chunk's bytes come from
# ---------------------------------------------------------------------------
class Source:
    """Stored bytes, read ``whole()``, by a range (``read(start, stop)``)
    or by their tail (``suffix(length)``)."""

    def window(self, offset: int, length: int) -> "Window":
        return Window(self, offset, length)


class KeySource(Source):
    """One value on a KV plane; each read returns None when the value is
    absent."""

    def __init__(self, kv, key: str):
        self.kv, self.key = kv, key

    def whole(self) -> Optional[bytes]:
        with telemetry.span("zarr/kv_read"):
            return self.kv.read_bytes(self.key)

    def read(self, start: int, stop: int) -> Optional[bytes]:
        with telemetry.span("zarr/kv_read"):
            return self.kv.read_range(self.key, start, stop)[0]

    def suffix(self, length: int) -> Optional[bytes]:
        with telemetry.span("zarr/kv_read"):
            return self.kv.read_suffix(self.key, length)


class BytesSource(Source):
    """Bytes in memory as a source."""

    def __init__(self, data: bytes):
        self.data = data

    def whole(self) -> bytes:
        return self.data

    def read(self, start: int, stop: int) -> bytes:
        return self.data[start:stop]

    def suffix(self, length: int) -> bytes:
        return self.data[max(0, len(self.data) - length):]


class Window(Source):
    """``length`` bytes at ``offset`` of another source: an inner chunk
    of a shard. A read that comes back short raises ``ValueError``."""

    def __init__(self, base: Source, offset: int, length: int):
        self.base, self.offset, self.length = base, offset, length

    def read(self, start: int, stop: int) -> bytes:
        stop = min(stop, self.length)
        if start >= stop:
            return b""
        data = self.base.read(self.offset + start, self.offset + stop)
        if data is None or len(data) != stop - start:
            raise ValueError(
                f"a shard's entry at {self.offset}+{self.length} reaches "
                f"past the shard's bytes")
        return data

    def whole(self) -> bytes:
        return self.read(0, self.length)

    def suffix(self, length: int) -> bytes:
        return self.read(max(0, self.length - length), self.length)


# ---------------------------------------------------------------------------
# zarr v3: the codec pipeline
# ---------------------------------------------------------------------------
Box = Tuple[Tuple[int, int], ...]


class Transpose:
    """zarr v3's ``transpose``: the stored array is the array's axes in
    ``order``."""

    def __init__(self, path: str, config: dict, ndim: int):
        order = config.get("order")
        if not isinstance(order, list) or sorted(order) != list(range(ndim)):
            refused(path, f"the transpose order {order!r}")
        self.order = tuple(int(i) for i in order)


class BytesCodec:
    """zarr v3's ``bytes``: the values in C order, in ``endian``."""

    def __init__(self, path: str, config: dict, dtype: np.dtype):
        endian = (config or {}).get("endian", "little")
        self.stored = dtype.newbyteorder("<" if endian == "little" else ">")
        self.dtype, self.path = dtype, path

    def size(self, shape) -> int:
        return int(np.prod(shape)) * self.dtype.itemsize

    def decode(self, source: Source, shape, box: Box,
               data: Optional[bytes] = None) -> Optional[np.ndarray]:
        if data is None:
            data = source.whole()
            if data is None:
                return None
        count = int(np.prod(shape))
        if len(data) != count * self.stored.itemsize:
            raise ValueError(f"{self.path}: a chunk of {len(data)} bytes "
                             f"where {count} values of {self.stored} were "
                             f"expected")
        with telemetry.span("zarr/decode"):
            values = np.frombuffer(data, dtype=self.stored).reshape(shape)
            return values[tuple(slice(a, b) for a, b in box)].astype(
                self.dtype)


class Sharding:
    """zarr v3's ``sharding_indexed``: a chunk of inner chunks and their
    index."""

    def __init__(self, path: str, config: dict, dtype: np.dtype, fill):
        self.path, self.fill = path, fill
        self.inner_shape = tuple(int(c) for c in config["chunk_shape"])
        ndim = len(self.inner_shape)
        self.inner = Zarr3Codecs(path, config.get("codecs") or
                                 [{"name": "bytes"}], dtype, fill, ndim)
        self.index = Zarr3Codecs(path, config.get("index_codecs") or
                                 [{"name": "bytes"}, {"name": "crc32c"}],
                                 np.dtype("<u8"), 0, ndim + 1)
        if not isinstance(self.index.to_bytes, BytesCodec) or \
                self.index.transposes or not all(
                    isinstance(c, Crc32c)
                    for c in self.index.to_bytes_codecs):
            refused(path, "a shard index that is not bytes "
                                "(and crc32c)")
        location = config.get("index_location", "end")
        if location not in ("start", "end"):
            refused(path, f"the index location {location!r}")
        self.at_end = location == "end"

    def decode(self, source: Source, shape, box: Box,
               data: Optional[bytes] = None) -> Optional[np.ndarray]:
        if data is not None:
            source = BytesSource(data)
        if any(s % c for s, c in zip(shape, self.inner_shape)):
            raise ValueError(f"{self.path}: a shard of {tuple(shape)} is "
                             f"not whole inner chunks of {self.inner_shape}")
        grid = tuple(s // c for s, c in zip(shape, self.inner_shape))
        length = int(np.prod(grid)) * 16 + 4 * len(
            self.index.to_bytes_codecs)
        raw = source.suffix(length) if self.at_end else source.read(0, length)
        if raw is None:
            return None
        if len(raw) != length:
            raise ValueError(f"{self.path}: a shard index of {len(raw)} "
                             f"bytes where {length} were expected")
        whole = tuple((0, n) for n in grid + (2,))
        index = self.index.decode(BytesSource(raw), grid + (2,), whole)
        out = np.full(tuple(b - a for a, b in box), self.fill,
                      dtype=self.inner.dtype)
        ranges = [range(a // c, -(-b // c)) if b > a else range(0)
                  for (a, b), c in zip(box, self.inner_shape)]
        for cell in itertools.product(*ranges):
            offset, nbytes = (int(v) for v in index[cell])
            if offset == MISSING and nbytes == MISSING:
                continue
            in_cell, in_out = [], []
            for i, (a, b), c in zip(cell, box, self.inner_shape):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                in_cell.append((lo - i * c, hi - i * c))
                in_out.append(slice(lo - a, hi - a))
            piece = self.inner.decode(source.window(offset, nbytes),
                                      self.inner_shape, tuple(in_cell))
            out[tuple(in_out)] = piece
        return out


class Zarr3Codecs:
    """A zarr v3 codec chain for ``ndim``-d arrays of ``dtype`` whose
    missing parts read as ``fill``: ``transposes``, then ``to_bytes`` (a
    :class:`BytesCodec` or :class:`Sharding`), then ``to_bytes_codecs``
    (compressors and :class:`Crc32c`, in the order they encode)."""

    def __init__(self, path: str, codecs: Sequence[dict], dtype: np.dtype,
                 fill, ndim: int):
        self.path, self.dtype = path, np.dtype(dtype)
        self.transposes: List[Transpose] = []
        self.to_bytes = None
        self.to_bytes_codecs: List = []
        for codec in codecs:
            name = codec.get("name")
            config = codec.get("configuration") or {}
            if name == "transpose" and self.to_bytes is None:
                self.transposes.append(Transpose(path, config, ndim))
            elif name == "bytes" and self.to_bytes is None:
                self.to_bytes = BytesCodec(path, config, self.dtype)
            elif name == "sharding_indexed" and self.to_bytes is None:
                self.to_bytes = Sharding(path, config, self.dtype, fill)
            elif name in ("gzip", "zstd") and self.to_bytes is not None:
                self.to_bytes_codecs.append(
                    Compressor(name, config.get("level", 1), path=path))
            elif name == "blosc" and self.to_bytes is not None:
                self.to_bytes_codecs.append(
                    _blosc(path, config, self.dtype.itemsize))
            elif name == "crc32c" and self.to_bytes is not None:
                self.to_bytes_codecs.append(Crc32c(path))
            else:
                refused(path, f"the codecs "
                                    f"{[c.get('name') for c in codecs]}")
        if self.to_bytes is None:
            refused(path, f"the codecs {[c.get('name') for c in codecs]}"
                                f" (no array-to-bytes codec)")

    def decode(self, source: Source, shape, box: Box
               ) -> Optional[np.ndarray]:
        """The part ``box`` of the chunk of ``shape`` stored in
        ``source``, or None where the chunk is absent."""
        for t in self.transposes:
            shape = tuple(shape[i] for i in t.order)
            box = tuple(box[i] for i in t.order)
        data = None
        if self.to_bytes_codecs:
            data = source.whole()
            if data is None:
                return None
            sized = isinstance(self.to_bytes, BytesCodec)
            with telemetry.span("zarr/decode"):
                for i, codec in enumerate(reversed(self.to_bytes_codecs)):
                    last = i == len(self.to_bytes_codecs) - 1
                    data = codec.decode(data, self.to_bytes.size(shape)
                                        if sized and last else None)
        values = self.to_bytes.decode(source, shape, box, data)
        if values is None:
            return None
        for t in reversed(self.transposes):
            values = values.transpose(np.argsort(t.order))
        return values
