"""The block codecs of the neuroglancer precomputed format.

The layouts are neuroglancer's ``src/datasource/precomputed/volume.md``;
each codec turns one ``[c, z, y, x]`` block, clipped to the volume bounds
at the edges, into the bytes of its file (or of its entry in a shard) and
back:

* ``raw``: the block's little-endian values in C order (x fastest);
* ``jpeg``: uint8, 1 or 3 channels; an image x wide and y*z tall (z-major
  rows), gray or RGB, encoded by Pillow at the scale's ``jpeg_quality``
  (default 75, tensorstore's) and decoded by Pillow;
* ``png``: uint8 or uint16, 1 to 4 channels (gray, gray and alpha, RGB,
  RGBA), the same image layout, 16-bit samples big-endian; written with
  no row filter at the scale's ``png_level`` of zlib (default 6), read
  with every row filter (the host C++ undoes them);
* ``compressed_segmentation``: uint32 or uint64, each channel on its own
  in blocks of the scale's ``compressed_segmentation_block_size``, in the
  host C++ (``csrc/host/compressed_segmentation.cpp``).

:func:`make_codec` checks the scale's pairing of encoding, dtype and
channels and raises ``ValueError`` where tensorstore refuses to open such
a scale, so the port raises at the call where the JAX package does (the
first read or write). A block whose bytes do not decode to its shape
raises :class:`CorruptBlockError`.

``encode_compressed_segmentation_plain``,
``decode_compressed_segmentation_plain`` and ``png_unfilter_plain`` are
the numpy versions of the host C++, for the tests.
"""
from __future__ import annotations

import io
import struct
import zlib
from typing import Sequence

import numpy as np

from chunkflow_tpu_torch import native

ENCODINGS = ("raw", "jpeg", "png", "compressed_segmentation")
JPEG_QUALITY = 75
PNG_LEVEL = 6


class CorruptBlockError(ValueError):
    """A stored block that does not decode to its shape: never read as
    zeros."""


class RawCodec:
    name = "raw"

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype).newbyteorder("<")

    def encode(self, block: np.ndarray):
        return np.ascontiguousarray(block, dtype=self.dtype)

    def decode(self, data: bytes, shape) -> np.ndarray:
        expected = int(np.prod(shape)) * self.dtype.itemsize
        if len(data) != expected:
            raise CorruptBlockError(
                f"{len(data)} bytes, expected {expected} for a "
                f"{tuple(shape)} {self.dtype.name} block")
        return np.frombuffer(data, dtype=self.dtype).reshape(shape)


def _image(block: np.ndarray) -> np.ndarray:
    """``[c, z, y, x]`` as the (y*z, x, c) image of the block's file."""
    c, z, y, x = block.shape
    return np.ascontiguousarray(np.moveaxis(block, 0, -1)).reshape(
        z * y, x, c)


def _block(image: np.ndarray, shape) -> np.ndarray:
    c, z, y, x = shape
    return np.ascontiguousarray(np.moveaxis(image.reshape(z, y, x, c), -1,
                                            0))


class JpegCodec:
    name = "jpeg"
    _MODES = {1: "L", 3: "RGB"}

    def __init__(self, quality: int = JPEG_QUALITY):
        self.quality = int(quality)

    def encode(self, block: np.ndarray) -> bytes:
        from PIL import Image

        image = _image(block)
        if image.shape[-1] == 1:
            image = image[..., 0]
        buf = io.BytesIO()
        Image.fromarray(image, self._MODES[block.shape[0]]).save(
            buf, format="JPEG", quality=self.quality)
        return buf.getvalue()

    def decode(self, data: bytes, shape) -> np.ndarray:
        from PIL import Image

        c, z, y, x = shape
        try:
            with Image.open(io.BytesIO(data)) as img:
                if img.format != "JPEG" or img.mode != self._MODES[c]:
                    raise CorruptBlockError(
                        f"a {img.format} {img.mode} image where a "
                        f"{self._MODES[c]} jpeg belongs")
                image = np.asarray(img)
        except CorruptBlockError:
            raise
        except Exception as exc:  # noqa: BLE001 - Pillow's many errors
            raise CorruptBlockError(f"not a jpeg: {exc}") from None
        if image.shape[:2] != (z * y, x):
            raise CorruptBlockError(
                f"a {image.shape[1]}x{image.shape[0]} jpeg where a "
                f"{x}x{z * y} block belongs")
        return _block(image, shape)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


class PngCodec:
    name = "png"

    def __init__(self, dtype, level: int = PNG_LEVEL):
        self.dtype = np.dtype(dtype)
        self.level = int(level)

    def encode(self, block: np.ndarray) -> bytes:
        c, z, y, x = block.shape
        image = _image(block).astype(self.dtype.newbyteorder(">"),
                                     copy=False)
        rows = image.reshape(z * y, -1).view(np.uint8)
        filtered = np.zeros((z * y, rows.shape[1] + 1), dtype=np.uint8)
        filtered[:, 1:] = rows  # filter byte 0: None
        header = struct.pack(">IIBBBBB", x, z * y, self.dtype.itemsize * 8,
                             _PNG_COLOR[c], 0, 0, 0)
        return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(filtered.tobytes(),
                                                    self.level))
                + _png_chunk(b"IEND", b""))

    def decode(self, data: bytes, shape) -> np.ndarray:
        c, z, y, x = shape
        if data[:8] != _PNG_SIGNATURE:
            raise CorruptBlockError("not a png")
        pos, header, idat = 8, None, []
        while pos + 8 <= len(data):
            (length,) = struct.unpack(">I", data[pos:pos + 4])
            kind = data[pos + 4:pos + 8]
            body = data[pos + 8:pos + 8 + length]
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
            pos += 12 + length
        bits = self.dtype.itemsize * 8
        want = (x, z * y, bits, _PNG_COLOR[c], 0, 0, 0)
        if header != want:
            raise CorruptBlockError(
                f"png header (width, height, depth, colour, compression, "
                f"filter, interlace) {header}, expected {want}")
        try:
            filtered = np.frombuffer(zlib.decompress(b"".join(idat)),
                                     dtype=np.uint8)
        except zlib.error as exc:
            raise CorruptBlockError(f"png data: {exc}") from None
        stride = x * c * self.dtype.itemsize
        try:
            rows = native.png_unfilter(filtered, z * y, stride,
                                       c * self.dtype.itemsize)
        except ValueError as exc:
            raise CorruptBlockError(f"png data: {exc}") from None
        image = rows.view(self.dtype.newbyteorder(">")).astype(self.dtype)
        return _block(image, shape)


class CompressedSegmentationCodec:
    name = "compressed_segmentation"

    def __init__(self, dtype, block_size_zyx: Sequence[int]):
        self.dtype = np.dtype(dtype)
        self.block_size = tuple(int(v) for v in block_size_zyx)

    def encode(self, block: np.ndarray) -> bytes:
        return native.compressed_segmentation_encode(
            np.ascontiguousarray(block, dtype=self.dtype), self.block_size)

    def decode(self, data: bytes, shape) -> np.ndarray:
        try:
            return native.compressed_segmentation_decode(
                data, shape, self.dtype, self.block_size)
        except ValueError as exc:
            raise CorruptBlockError(str(exc)) from None


def make_codec(scale: dict, dtype, num_channels: int):
    """The codec of one scale of an info file. A pairing tensorstore does
    not open raises ``ValueError``, as its open does in the JAX package."""
    encoding = scale.get("encoding", "raw")
    dtype = np.dtype(dtype)
    if encoding == "raw":
        return RawCodec(dtype)
    if encoding == "jpeg":
        if dtype != np.uint8:
            raise ValueError(f'"jpeg" encoding only supported for uint8, '
                             f'not {dtype.name}')
        if num_channels not in (1, 3):
            raise ValueError(f'"jpeg" encoding only supports 1 or 3 '
                             f'channels, not {num_channels}')
        return JpegCodec(scale.get("jpeg_quality", JPEG_QUALITY))
    if encoding == "png":
        if dtype not in (np.uint8, np.uint16):
            raise ValueError(f'"png" encoding only supported for uint8 and '
                             f'uint16, not {dtype.name}')
        if not 1 <= num_channels <= 4:
            raise ValueError(f'"png" encoding only supports 1 to 4 '
                             f'channels, not {num_channels}')
        return PngCodec(dtype, scale.get("png_level", PNG_LEVEL))
    if encoding == "compressed_segmentation":
        if dtype not in (np.uint32, np.uint64):
            raise ValueError(f'"compressed_segmentation" encoding only '
                             f'supported for uint32 and uint64, not '
                             f'{dtype.name}')
        size = scale.get("compressed_segmentation_block_size")
        if size is None:
            raise ValueError('"compressed_segmentation" encoding needs the '
                             'scale\'s "compressed_segmentation_block_size"')
        return CompressedSegmentationCodec(dtype, tuple(reversed(size)))
    raise ValueError(f"unknown precomputed encoding {encoding!r}; one of "
                     f"{ENCODINGS}")


# ---------------------------------------------------------------------------
# the plain versions of the host C++ (tests)
# ---------------------------------------------------------------------------
def _bits_for(n: int) -> int:
    if n == 1:
        return 0
    bits = 1
    while (1 << bits) < n:
        bits *= 2
    return bits


def encode_compressed_segmentation_plain(block: np.ndarray,
                                         block_size_zyx) -> bytes:
    """:func:`native.compressed_segmentation_encode` in numpy."""
    block = np.asarray(block)
    words_per = block.dtype.itemsize // 4
    bz, by, bx = (int(v) for v in block_size_zyx)
    c = block.shape[0]
    out = [0] * c
    for ch in range(c):
        out[ch] = len(out)
        chan = block[ch]
        z, y, x = chan.shape
        grid = (-(-z // bz), -(-y // by), -(-x // bx))
        base = len(out)
        out.extend([0] * (2 * grid[0] * grid[1] * grid[2]))
        tables = {}
        for b, (gz, gy, gx) in enumerate(np.ndindex(*grid)):
            sub = chan[gz * bz:(gz + 1) * bz, gy * by:(gy + 1) * by,
                       gx * bx:(gx + 1) * bx]
            table, index = np.unique(sub, return_inverse=True)
            bits = _bits_for(table.size)
            value_offset = len(out) - base
            n_words = -(-bits * bz * by * bx // 32)
            words = np.zeros(n_words, dtype=np.uint64)
            if bits:
                full = np.zeros((bz, by, bx), dtype=np.uint64)
                full[:sub.shape[0], :sub.shape[1], :sub.shape[2]] = \
                    index.reshape(sub.shape)
                pos = np.arange(full.size, dtype=np.uint64) * bits
                np.bitwise_or.at(words, (pos // 32).astype(np.int64),
                                 full.reshape(-1) << (pos % 32))
            out.extend(int(w) for w in words)
            key = tuple(table.tolist())
            if key in tables:
                table_offset = tables[key]
            else:
                table_offset = len(out) - base
                tables[key] = table_offset
                for v in key:
                    out.extend((v >> (32 * w)) & 0xFFFFFFFF
                               for w in range(words_per))
            out[base + 2 * b] = table_offset | (bits << 24)
            out[base + 2 * b + 1] = value_offset
    return np.array(out, dtype="<u4").tobytes()


def decode_compressed_segmentation_plain(data: bytes, shape_czyx, dtype,
                                         block_size_zyx) -> np.ndarray:
    """:func:`native.compressed_segmentation_decode` in numpy."""
    dtype = np.dtype(dtype)
    words = np.frombuffer(data, dtype="<u4").astype(np.uint64)
    words_per = dtype.itemsize // 4
    c, z, y, x = (int(v) for v in shape_czyx)
    bz, by, bx = (int(v) for v in block_size_zyx)
    grid = (-(-z // bz), -(-y // by), -(-x // bx))
    out = np.zeros((c, z, y, x), dtype=dtype)
    pos = np.arange(bz * by * bx, dtype=np.uint64)
    for ch in range(c):
        chan = words[int(words[ch]):]
        for b, (gz, gy, gx) in enumerate(np.ndindex(*grid)):
            table_offset = int(chan[2 * b]) & 0xFFFFFF
            bits = int(chan[2 * b]) >> 24
            values = int(chan[2 * b + 1])
            if bits:
                p = pos * np.uint64(bits)
                idx = (chan[values + (p // 32).astype(np.int64)]
                       >> (p % 32)) & np.uint64((1 << bits) - 1)
            else:
                idx = np.zeros(pos.size, dtype=np.uint64)
            entries = chan[table_offset + idx.astype(np.int64)[:, None]
                           * words_per + np.arange(words_per)]
            vals = np.zeros(pos.size, dtype=np.uint64)
            for w in range(words_per):
                vals |= entries[:, w] << np.uint64(32 * w)
            full = vals.reshape(bz, by, bx)
            dst = out[ch, gz * bz:(gz + 1) * bz, gy * by:(gy + 1) * by,
                      gx * bx:(gx + 1) * bx]
            dst[...] = full[:dst.shape[0], :dst.shape[1], :dst.shape[2]]
    return out


def png_unfilter_plain(filtered: np.ndarray, rows: int, stride: int,
                       bpp: int) -> np.ndarray:
    """:func:`native.png_unfilter` in numpy."""
    src = np.asarray(filtered, dtype=np.uint8).reshape(rows, stride + 1)
    out = np.zeros((rows, stride), dtype=np.int64)
    for r in range(rows):
        kind, line = int(src[r, 0]), src[r, 1:].astype(np.int64)
        up = out[r - 1] if r else np.zeros(stride, dtype=np.int64)
        cur = out[r]
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            elif kind == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                raise ValueError(f"PNG row {r} has an unknown filter type")
            cur[i] = (line[i] + pred) & 0xFF
    return out.astype(np.uint8).reshape(-1)
