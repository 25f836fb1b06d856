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
shuffled as the store's ``shuffle`` says (0 none, 1 byte, 2 bit, -1 bit
for a one-byte type and byte otherwise, as tensorstore writes), in the
codec of the store's cname, each by the host C++ with a plain twin that
gives its bytes: LZ4 blocks for ``lz4`` (``cf_lz4_compress``,
:func:`lz4_compress_plain`) and, by LZ4 HC's hash-chain search, for
``lz4hc`` (``cf_lz4hc_compress``, :func:`lz4hc_compress_plain`, at
:func:`hc_depth` of the clevel), blosclz streams for
``blosclz`` (:func:`blosclz_compress_plain`), snappy streams for
``snappy`` (:func:`snappy_compress_plain`), zstd frames for ``zstd``
(``volume/zstd.py``, at the store's clevel) and zlib streams for
``zlib``. The bit shuffle is ``cf_bitshuffle`` (:func:`bitshuffle_plain`).
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


_HASH_LOG = 16


class BloscError(ValueError):
    """A blosc frame that does not decode."""


#: the block size :func:`compress` writes (a multiple of every typesize)
BLOCK = 256 * 1024
#: the header flags: byte shuffle, bit shuffle, one stream per block
_SHUFFLE, _BITSHUFFLE, _NOSPLIT = 0x01, 0x04, 0x10
#: the codec :func:`compress` writes for each cname
WRITES = {"blosclz": 0, "lz4": 1, "lz4hc": 1, "snappy": 2, "zlib": 3,
          "zstd": 4}
#: a zarr v3 blosc codec's shuffle names, as the zarr v2 numbers
SHUFFLES = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}


def hc_depth(level: int) -> int:
    """The candidates ``lz4hc`` searches a position at a clevel (LZ4 HC's
    ``1 << (level - 1)``, levels 1 to 9)."""
    return 1 << (min(max(int(level), 1), 9) - 1)


def _encode(cname: str, raw: bytes, level: int) -> bytes:
    from chunkflow_tpu_torch import native

    codec = WRITES[cname]
    if cname == "lz4hc":
        return native.lz4hc_compress(raw, hc_depth(level))
    if codec == 0:
        return native.blosclz_compress(raw)
    if codec == 1:
        return native.lz4_compress(raw)
    if codec == 2:
        return native.snappy_compress(raw)
    if codec == 4:
        from chunkflow_tpu_torch.volume import zstd

        return zstd.compress(raw, level)
    return zlib.compress(raw, level)


def shuffle_flags(shuffle, typesize: int) -> int:
    """The header's shuffle flags for a store's ``shuffle`` (0, 1, 2, -1,
    or a zarr v3 name): -1 bit-shuffles a one-byte type and byte-shuffles
    the rest, as tensorstore's frames show."""
    shuffle = SHUFFLES.get(shuffle, shuffle)
    if shuffle == -1:
        shuffle = 2 if typesize == 1 else 1
    if shuffle not in (0, 1, 2):
        raise BloscError(f"the blosc shuffle {shuffle!r} is not one of "
                         f"-1, 0, 1, 2")
    return (0, _SHUFFLE, _BITSHUFFLE)[shuffle]


def _byteshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    count = len(block) // typesize
    body = block[:count * typesize].reshape(count, typesize).T
    return np.concatenate([body.reshape(-1), block[count * typesize:]])


def compress(data, typesize: int = 1, level: int = 5,
             cname: str = "zlib", shuffle=1) -> bytes:
    """A frame holding ``data``: blocks of :data:`BLOCK` bytes, each
    shuffled by ``typesize`` as ``shuffle`` says and compressed at
    ``level`` by the codec :data:`WRITES` gives ``cname``, or kept as they
    are where that is no smaller."""
    from chunkflow_tpu_torch import native

    data = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    typesize = int(typesize)
    if not 1 <= typesize <= 255:
        raise BloscError(f"typesize {typesize} is outside 1..255")
    if cname not in WRITES:
        raise BloscError(f"the blosc cname {cname!r} is not one of "
                         f"{sorted(WRITES)}")
    codec = WRITES[cname]
    shuffled = shuffle_flags(shuffle, typesize)
    nbytes = len(data)
    blocksize = max(1, min(BLOCK, nbytes))
    nblocks = -(-nbytes // blocksize)
    flags = _NOSPLIT | codec << 5 | shuffled
    starts, streams, pos = [], [], 16 + 4 * nblocks
    for i in range(nblocks):
        block = data[i * blocksize:(i + 1) * blocksize]
        if shuffled == _SHUFFLE and typesize > 1:
            block = _byteshuffle(block, typesize)
        raw = block.tobytes()
        if shuffled == _BITSHUFFLE:
            raw = native.bitshuffle(raw, typesize)
        packed = _encode(cname, raw, int(level))
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


def _hashes(data: bytes) -> list:
    """The host C++ ``hash4`` of the 4 bytes at each position."""
    if len(data) < 4:
        return []
    words = np.frombuffer(data, np.uint8).astype(np.uint32)
    words = words[:-3] | words[1:-2] << 8 | words[2:-1] << 16 | \
        words[3:] << 24
    return ((words * np.uint32(2654435761))
            >> np.uint32(32 - _HASH_LOG)).tolist()


def _greedy_matches(data: bytes, max_offset: int, last: int, limit: int):
    """The host C++ ``greedy_matches``: each match as (literals start,
    their count, offset back, length), then the literals after the last
    as (start, count, 0, 0)."""
    n = len(data)
    hashes = _hashes(data)
    table = {}
    ip = anchor = 0
    while ip <= last:
        cand = table.get(hashes[ip], -1)
        table[hashes[ip]] = ip
        if cand < 0 or ip - cand > max_offset or \
                data[cand:cand + 4] != data[ip:ip + 4]:
            ip += 1 + ((ip - anchor) >> 6)
            continue
        while ip > anchor and cand > 0 and data[ip - 1] == data[cand - 1]:
            ip -= 1
            cand -= 1
        match = 4
        while ip + match < limit and data[cand + match] == data[ip + match]:
            match += 1
        yield anchor, ip - anchor, ip - cand, match
        ip += match
        anchor = ip
        if ip - 2 <= n - 4:
            table[hashes[ip - 2]] = ip - 2
    yield anchor, n - anchor, 0, 0


def _run255(out: bytearray, extra: int) -> None:
    out.extend(b"\xff" * (extra // 255))
    out.append(extra % 255)


def _chain_matches(data: bytes, max_offset: int, last: int, limit: int,
                   depth: int):
    """The host C++ ``chain_matches``: :func:`_greedy_matches`, each match
    the longest of up to ``depth`` earlier positions of its hash."""
    n = len(data)
    hashes = _hashes(data)
    head, prev = {}, {}
    ip = anchor = entered = 0
    while ip <= last:
        for pos in range(entered, ip):
            prev[pos & 0xFFFF] = head.get(hashes[pos], -1)
            head[hashes[pos]] = pos
        entered = max(entered, ip)
        best, source = 0, -1
        cand = head.get(hashes[ip], -1)
        for _ in range(depth):
            if cand < 0 or ip - cand > max_offset:
                break
            if data[cand:cand + 4] == data[ip:ip + 4]:
                match = 4
                while ip + match < limit and \
                        data[cand + match] == data[ip + match]:
                    match += 1
                if match > best:
                    best, source = match, cand
            following = prev.get(cand & 0xFFFF, -1)
            if following >= cand:
                break
            cand = following
        if not best:
            ip += 1
            continue
        while ip > anchor and source > 0 and \
                data[ip - 1] == data[source - 1]:
            ip, source, best = ip - 1, source - 1, best + 1
        yield anchor, ip - anchor, ip - source, best
        ip += best
        anchor = ip
    yield anchor, n - anchor, 0, 0


def _lz4_block(data: bytes, matches) -> bytes:
    """The LZ4 sequences of ``matches`` (as :func:`_greedy_matches` gives
    them) over ``data``."""
    out = bytearray()
    for start, lit, offset, match in matches:
        ml = match - 4 if match else 0
        out.append(min(lit, 15) << 4 | min(ml, 15))
        if lit >= 15:
            _run255(out, lit - 15)
        out.extend(data[start:start + lit])
        if match:
            out.extend(struct.pack("<H", offset))
            if ml >= 15:
                _run255(out, ml - 15)
    return bytes(out)


def lz4_compress_plain(data) -> bytes:
    """``data`` as one LZ4 block (Python and numpy): the bytes of the host
    C++ ``cf_lz4_compress``."""
    data = bytes(data)
    return _lz4_block(data, _greedy_matches(data, 65535, len(data) - 12,
                                            len(data) - 5))


def lz4hc_compress_plain(data, depth: int) -> bytes:
    """``data`` as one LZ4 block by the hash-chain search (Python and
    numpy): the bytes of the host C++ ``cf_lz4hc_compress``."""
    data = bytes(data)
    return _lz4_block(data, _chain_matches(data, 65535, len(data) - 12,
                                           len(data) - 5, depth))


#: blosclz distances below this are 13-bit; a far one is 16-bit past it
_BLOSCLZ_NEAR = 8191


def blosclz_compress_plain(data) -> bytes:
    """``data`` (not empty) as one blosclz stream (Python): the bytes of
    the host C++ ``cf_blosclz_compress``."""
    data = bytes(data)
    out = bytearray()
    for start, lit, offset, match in _greedy_matches(
            data, 65535 + _BLOSCLZ_NEAR + 1, len(data) - 12, len(data) - 5):
        for run in range(start, start + lit, 32):
            chunk = data[run:min(run + 32, start + lit)]
            out.append(len(chunk) - 1)
            out.extend(chunk)
        if not match:
            continue
        m, distance = match - 3, offset - 1
        near = distance < _BLOSCLZ_NEAR
        out.append((min(m, 6) + 1) << 5 | (distance >> 8 if near else 31))
        if m >= 6:
            _run255(out, m - 6)
        if near:
            out.append(distance & 255)
        else:
            out.append(255)
            out.extend(struct.pack(">H", distance - _BLOSCLZ_NEAR))
    return bytes(out)


def _snappy_copy(out: bytearray, offset: int, length: int) -> None:
    if length < 12 and offset < 2048:
        out.extend((1 | (length - 4) << 2 | (offset >> 8) << 5,
                    offset & 255))
    else:
        out.append(2 | (length - 1) << 2)
        out.extend(struct.pack("<H", offset))


def snappy_compress_plain(data) -> bytes:
    """``data`` as one snappy stream (Python): the bytes of the host C++
    ``cf_snappy_compress``."""
    data = bytes(data)
    out = bytearray()
    length = len(data)
    while length >= 0x80:
        out.append(length & 0x7F | 0x80)
        length >>= 7
    out.append(length)
    for start, lit, offset, match in _greedy_matches(
            data, 65535, len(data) - 4, len(data)):
        if lit:
            n = lit - 1
            if n < 60:
                out.append(n << 2)
            else:
                width = (n.bit_length() + 7) // 8
                out.append((59 + width) << 2)
                out.extend(n.to_bytes(width, "little"))
            out.extend(data[start:start + lit])
        while match >= 68:
            _snappy_copy(out, offset, 64)
            match -= 64
        if match > 64:
            _snappy_copy(out, offset, 60)
            match -= 60
        if match:
            _snappy_copy(out, offset, match)
    return bytes(out)


def bitshuffle_plain(block, typesize: int) -> bytes:
    """One blosc block bit-shuffled by ``typesize`` (numpy): the bytes of
    the host C++ ``cf_bitshuffle``."""
    data = np.frombuffer(bytes(block), dtype=np.uint8)
    count = len(data) // typesize
    if count % 8:
        return data.tobytes()
    elems = data[:count * typesize].reshape(count // 8, 8, typesize)
    bits = np.unpackbits(elems[..., None], axis=-1, bitorder="little")
    rows = np.packbits(bits.transpose(2, 3, 0, 1), axis=-1,
                       bitorder="little")  # [byte, bit, element / 8]
    return rows.tobytes() + data[count * typesize:].tobytes()


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
