"""Blosc1 frames: the decoders and the frames the port writes.

:func:`decompress` runs the host C++ (``csrc/host/blosc.cpp``); it is the
only decoder the storage plane calls. :func:`decompress_plain` is the same
walk in Python and numpy, for the tests.

A frame is a 16-byte header (format version, codec version, flags,
typesize, nbytes, blocksize, cbytes), then the data as it is (the
memcpyed flag, 0x02) or a table of block starts and the blocks. A block
is split into ``typesize`` streams unless the 0x10 flag says not to or
it is the short last block; each stream is its 4-byte compressed size
and the codec's bytes (the bytes as they are when the size is the
stream's own). The codec is the flags' top three bits: ``blosclz``,
``lz4`` (and ``lz4hc``), ``snappy``, ``zlib`` and ``zstd``
(``volume/zstd.py``). Then the block is byte-unshuffled (0x01) or
bit-unshuffled (0x04). A frame that does not decode raises
``ValueError``.

:func:`compress` writes the frames the port stores, one stream per block,
byte-shuffled by the typesize, in the codec of the store's cname: LZ4
blocks for ``lz4`` and ``lz4hc`` (the host C++ ``cf_lz4_compress``;
:func:`lz4_compress_plain` gives its bytes), zstd frames for ``zstd``
(``volume/zstd.py``, at the store's clevel) and zlib streams for ``zlib``
and for the two cnames the port does not encode, ``blosclz`` and
``snappy`` (every blosc reader decodes them all).
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

CODECS = ("blosclz", "lz4", "snappy", "zlib", "zstd")
#: the cnames tensorstore writes, by their codec in the frame's flags
CNAMES = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3,
          "zstd": 4}


_LZ4_HASH_LOG = 16


class BloscError(ValueError):
    """A blosc frame that does not decode."""


#: the block size :func:`compress` writes (a multiple of every typesize)
BLOCK = 256 * 1024
#: the header flags: byte shuffle, one stream per block
_SHUFFLE, _NOSPLIT = 0x01, 0x10
#: the codec :func:`compress` writes for each cname
WRITES = {"blosclz": 3, "lz4": 1, "lz4hc": 1, "snappy": 3, "zlib": 3,
          "zstd": 4}


def _encode(codec: int, raw: bytes, level: int) -> bytes:
    if codec == 1:
        from chunkflow_tpu_torch import native

        return native.lz4_compress(raw)
    if codec == 4:
        from chunkflow_tpu_torch.volume import zstd

        return zstd.compress(raw, level)
    return zlib.compress(raw, level)


def compress(data, typesize: int = 1, level: int = 5,
             cname: str = "zlib") -> bytes:
    """A frame holding ``data``: blocks of :data:`BLOCK` bytes, each
    byte-shuffled by ``typesize`` (where it is above 1) and compressed at
    ``level`` by the codec :data:`WRITES` gives ``cname``, or kept as they
    are where that is no smaller."""
    data = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    typesize = int(typesize)
    if not 1 <= typesize <= 255:
        raise BloscError(f"typesize {typesize} is outside 1..255")
    if cname not in WRITES:
        raise BloscError(f"the blosc cname {cname!r} is not one of "
                         f"{sorted(WRITES)}")
    codec = WRITES[cname]
    nbytes = len(data)
    blocksize = max(1, min(BLOCK, nbytes))
    nblocks = -(-nbytes // blocksize)
    flags = _NOSPLIT | codec << 5 | (_SHUFFLE if typesize > 1 else 0)
    starts, streams, pos = [], [], 16 + 4 * nblocks
    for i in range(nblocks):
        block = data[i * blocksize:(i + 1) * blocksize]
        if typesize > 1:
            count = len(block) // typesize
            body = block[:count * typesize].reshape(count, typesize).T
            block = np.concatenate([body.reshape(-1),
                                    block[count * typesize:]])
        raw = block.tobytes()
        packed = _encode(codec, raw, int(level))
        if len(packed) >= len(raw):
            packed = raw  # a stream its block's own size is stored as is
        starts.append(pos)
        streams.append(struct.pack("<i", len(packed)) + packed)
        pos += len(streams[-1])
    if nbytes > 0x7FFFFFFF - pos:
        raise BloscError(f"{nbytes} bytes do not fit one frame")
    return b"".join([struct.pack("<BBBBIII", 2, 1, flags, typesize, nbytes,
                                 blocksize, pos),
                     struct.pack(f"<{nblocks}I", *starts), *streams])


def decompress(data, size: Optional[int] = None) -> bytes:
    """The decoded bytes of the blosc frame ``data`` (host C++); with
    ``size``, a frame of another size raises before anything is
    allocated."""
    from chunkflow_tpu_torch import native

    return native.blosc_decompress(bytes(data), size)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
def _copy_back(out: bytearray, offset: int, length: int) -> None:
    if offset <= 0 or offset > len(out):
        raise BloscError("match before the start of the stream")
    start = len(out) - offset
    if offset >= length:
        out += out[start:start + length]
    else:
        for k in range(length):
            out.append(out[start + k])


def _blosclz(data: bytes, size: int) -> bytes:
    out = bytearray()
    if not data:
        return b""
    ip, end = 1, len(data)
    ctrl = data[0] & 31
    while True:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:
                while True:
                    if ip + 1 >= end:
                        raise BloscError("truncated blosclz match")
                    code = data[ip]
                    ip += 1
                    length += code
                    if code != 255:
                        break
            elif ip + 1 >= end:
                raise BloscError("truncated blosclz match")
            code = data[ip]
            ip += 1
            length += 3
            distance = ofs + code
            if code == 255 and ofs == 31 << 8:
                if ip + 1 >= end:
                    raise BloscError("truncated blosclz match")
                distance = (data[ip] << 8) + data[ip + 1] + 8191
                ip += 2
            if len(out) + length > size or distance + 1 > len(out):
                raise BloscError("blosclz match out of bounds")
            if ip >= end:
                break  # a last match is never copied, as in c-blosc
            ctrl = data[ip]
            ip += 1
            _copy_back(out, distance + 1, length)
        else:
            run = ctrl + 1
            if len(out) + run > size or ip + run > end:
                raise BloscError("blosclz literals out of bounds")
            out += data[ip:ip + run]
            ip += run
            if ip >= end:
                break
            ctrl = data[ip]
            ip += 1
    return bytes(out)


def _lz4(data: bytes, size: int) -> bytes:
    out = bytearray()
    ip, end = 0, len(data)
    while True:
        if ip >= end:
            raise BloscError("truncated lz4 block")
        token = data[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if ip >= end:
                    raise BloscError("truncated lz4 block")
                lit += data[ip]
                ip += 1
                if data[ip - 1] != 255:
                    break
        if ip + lit > end or len(out) + lit > size:
            raise BloscError("lz4 literals out of bounds")
        out += data[ip:ip + lit]
        ip += lit
        if ip == end:
            return bytes(out)
        if ip + 2 > end:
            raise BloscError("truncated lz4 offset")
        offset = data[ip] | (data[ip + 1] << 8)
        ip += 2
        length = token & 15
        if length == 15:
            while True:
                if ip >= end:
                    raise BloscError("truncated lz4 block")
                length += data[ip]
                ip += 1
                if data[ip - 1] != 255:
                    break
        length += 4
        if len(out) + length > size:
            raise BloscError("lz4 match out of bounds")
        _copy_back(out, offset, length)


def lz4_compress_plain(data) -> bytes:
    """``data`` as one LZ4 block (Python and numpy): the bytes of the host
    C++ ``cf_lz4_compress``."""
    data = bytes(data)
    n = len(data)
    out = bytearray()

    def length(extra: int) -> None:
        out.extend(b"\xff" * (extra // 255))
        out.append(extra % 255)

    def sequence(lit: int, offset: int, match: int) -> None:
        ml = match - 4 if match else 0
        out.append(min(lit, 15) << 4 | min(ml, 15))
        if lit >= 15:
            length(lit - 15)
        out.extend(data[anchor:anchor + lit])
        if match:
            out.extend(struct.pack("<H", offset))
            if ml >= 15:
                length(ml - 15)

    hashes = []
    if n >= 4:
        words = np.frombuffer(data, np.uint8).astype(np.uint32)
        words = words[:-3] | words[1:-2] << 8 | words[2:-1] << 16 | \
            words[3:] << 24
        hashes = ((words * np.uint32(2654435761))
                  >> np.uint32(32 - _LZ4_HASH_LOG)).tolist()
    table = {}
    ip = anchor = 0
    last, limit = n - 12, n - 5
    while ip <= last:
        cand = table.get(hashes[ip], -1)
        table[hashes[ip]] = ip
        if cand < 0 or ip - cand > 65535 or \
                data[cand:cand + 4] != data[ip:ip + 4]:
            ip += 1 + ((ip - anchor) >> 6)
            continue
        while ip > anchor and cand > 0 and data[ip - 1] == data[cand - 1]:
            ip -= 1
            cand -= 1
        match = 4
        while ip + match < limit and data[cand + match] == data[ip + match]:
            match += 1
        sequence(ip - anchor, ip - cand, match)
        ip += match
        anchor = ip
        if ip - 2 <= n - 4:
            table[hashes[ip - 2]] = ip - 2
    sequence(n - anchor, 0, 0)
    return bytes(out)


def _snappy(data: bytes, size: int) -> bytes:
    ip, length, shift = 0, 0, 0
    while True:
        if ip >= len(data) or shift > 28:
            raise BloscError("bad snappy length")
        b = data[ip]
        ip += 1
        length |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    if length > size:
        raise BloscError("snappy stream larger than its block")
    out = bytearray()
    end = len(data)
    while ip < end:
        tag = data[ip]
        ip += 1
        kind = tag & 3
        if kind == 0:
            n = tag >> 2
            if n >= 60:
                extra = n - 59
                n = int.from_bytes(data[ip:ip + extra], "little")
                ip += extra
            n += 1
            if ip + n > end or len(out) + n > length:
                raise BloscError("snappy literal out of bounds")
            out += data[ip:ip + n]
            ip += n
            continue
        if kind == 1:
            n = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[ip]
            ip += 1
        else:
            width = 2 if kind == 2 else 4
            n = (tag >> 2) + 1
            offset = int.from_bytes(data[ip:ip + width], "little")
            ip += width
        if ip > end or len(out) + n > length:
            raise BloscError("snappy copy out of bounds")
        _copy_back(out, offset, n)
    if len(out) != length:
        raise BloscError("snappy stream shorter than its length")
    return bytes(out)


def _stream(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        return _blosclz(data, size)
    if codec == 1:
        return _lz4(data, size)
    if codec == 2:
        return _snappy(data, size)
    if codec == 3:
        return zlib.decompress(data)
    if codec == 4:
        from chunkflow_tpu_torch.volume.zstd import decompress_plain

        return decompress_plain(data)
    raise BloscError(f"blosc codec {codec} is not one of {CODECS}")


def _bitunshuffle(block: np.ndarray, typesize: int, count: int) -> bytes:
    rows = block[:count * typesize].reshape(typesize, 8, count // 8)
    bits = np.unpackbits(rows, axis=-1, bitorder="little")  # [b, k, i]
    return np.packbits(bits.transpose(2, 0, 1), axis=-1,
                       bitorder="little").tobytes()


def decompress_plain(data) -> bytes:
    """The decoded bytes of the blosc frame ``data`` (Python and
    numpy)."""
    data = bytes(data)
    if len(data) < 16:
        raise BloscError("truncated frame")
    version, _, flags, typesize, nbytes, blocksize, cbytes = \
        struct.unpack_from("<BBBBIII", data)
    if not 1 <= version <= 4 or flags & 0x05 == 0x05:
        raise BloscError(f"unsupported blosc frame version {version}")
    if not 16 <= cbytes <= len(data):
        raise BloscError("truncated frame")
    if flags & 0x02:
        if nbytes > cbytes - 16:
            raise BloscError("truncated frame")
        return data[16:16 + nbytes]
    if nbytes == 0:
        return b""
    if not 0 < blocksize <= nbytes or typesize <= 0:
        raise BloscError("corrupt frame header")
    codec = flags >> 5
    nblocks = -(-nbytes // blocksize)
    leftover = nbytes % blocksize
    if 16 + 4 * nblocks > cbytes:
        raise BloscError("truncated frame")
    out = bytearray()
    for i in range(nblocks):
        short = i == nblocks - 1 and leftover > 0
        bsize = leftover if short else blocksize
        nstreams = typesize if not flags & 0x10 and not short else 1
        neblock = bsize // nstreams
        if neblock * nstreams != bsize:
            raise BloscError("block does not split into its streams")
        ip = struct.unpack_from("<I", data, 16 + 4 * i)[0]
        parts = []
        for _ in range(nstreams):
            if not 16 <= ip <= cbytes - 4:
                raise BloscError("truncated frame")
            csize = struct.unpack_from("<i", data, ip)[0]
            ip += 4
            if not 0 <= csize <= cbytes - ip:
                raise BloscError("stream beyond the frame")
            raw = data[ip:ip + csize]
            part = raw if csize == neblock else _stream(codec, raw, neblock)
            if len(part) != neblock:
                raise BloscError("stream decoded to another size")
            parts.append(part)
            ip += csize
        block = np.frombuffer(b"".join(parts), dtype=np.uint8)
        if flags & 0x01 and typesize > 1:
            count = bsize // typesize
            body = block[:count * typesize].reshape(typesize, count).T
            block = np.concatenate([body.reshape(-1),
                                    block[count * typesize:]])
        elif flags & 0x04:
            count = bsize // typesize
            if version == 2 and count % 8:
                count = 0
            count -= count % 8
            block = np.concatenate([
                np.frombuffer(_bitunshuffle(block, typesize, count),
                              dtype=np.uint8),
                block[count * typesize:]])
        out += block.tobytes()
    return bytes(out)
