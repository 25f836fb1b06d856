"""Zstandard frames (RFC 8878): the port's encoder and decoders.

:func:`compress` and :func:`decompress` run the host C++
(``csrc/host/zstd.cpp``); they are the only encoder and decoder the
storage plane calls. :func:`compress_plain` and :func:`decompress_plain`
are the same algorithms in pure Python, for the tests: they are slow (a
few hundred KB/s) and see only small inputs there. :func:`compress_plain`
gives the bytes of :func:`compress`, so the C++ is held byte for byte
where no ``zstandard`` is installed.

Both decoders decode a run of frames: zstd frames, each with raw, RLE and
compressed blocks (Huffman literals with direct or FSE-compressed weights,
treeless literals, one or four streams; FSE sequences in predefined, RLE,
compressed and repeat modes, with the three repeat offsets), an optional
content size, an optional XXH64 content checksum (verified), and
skippable frames between them. A frame that names a dictionary raises, as
does any frame that does not decode within its own bytes and the output
size: a malformed frame raises :class:`ZstdError` and never reads or
writes outside its buffers.

The encoder writes one frame: the content size, a window of at most
2**23 bytes (single-segment when the content fits it), blocks of up to
128 KB (RLE where a block is one byte value, raw where compressing does
not make it smaller), the XXH64 checksum. A compressed block's matches
come from a hash table of 4-byte sequences, chained and searched deeper,
and lazily, as the level rises (:data:`LEVELS`; a level below 1 searches
as level 1 and skips ahead faster through literals); the three repeat
offsets are kept as the decoder keeps them. Literals are Huffman-coded
(weights direct or FSE-compressed, one stream or four) where that is
smaller than raw; each sequence code goes predefined, RLE or
FSE-compressed, whichever is smallest.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """A zstd frame that does not decode."""


# ---------------------------------------------------------------------------
# the frames' sizes and the writer
# ---------------------------------------------------------------------------
def _frame_header(data, pos: int):
    """``(content size or None, header length, has checksum,
    window size)`` of the zstd frame whose magic is at ``pos``."""
    end = len(data)
    if pos + 5 > end:
        raise ZstdError("truncated frame header")
    fhd = data[pos + 4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 0x08:
        raise ZstdError("reserved bit set in the frame header")
    checksum = (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    p = pos + 5
    window = 0
    if not single:
        if p >= end:
            raise ZstdError("truncated frame header")
        wd = data[p]
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
        p += 1
    if p + did_size + fcs_size > end:
        raise ZstdError("truncated frame header")
    did = int.from_bytes(data[p:p + did_size], "little")
    if did:
        raise ZstdError(f"the frame needs dictionary {did}; the port "
                        f"decodes no dictionary")
    p += did_size
    size = None
    if fcs_size:
        size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            size += 256
    p += fcs_size
    if single:
        window = size
    return size, p - pos, checksum, window


def content_size(data) -> Optional[int]:
    """The total decoded size of the frames in ``data`` when every frame
    states its content size, else None. Reads only the frame and block
    headers."""
    pos, total, end = 0, 0, len(data)
    while pos < end:
        if pos + 8 > end:
            raise ZstdError("truncated frame")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            pos += 8 + struct.unpack_from("<I", data, pos + 4)[0]
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        size, header, checksum, _ = _frame_header(data, pos)
        if size is None:
            return None
        total += size
        pos += header
        while True:
            if pos + 3 > end:
                raise ZstdError("truncated block header")
            bh = int.from_bytes(data[pos:pos + 3], "little")
            kind = (bh >> 1) & 3
            pos += 3 + (1 if kind == 1 else bh >> 3)
            if bh & 1:
                break
        pos += 4 * checksum
    if pos != end:
        raise ZstdError("truncated frame")
    return total


# ---------------------------------------------------------------------------
# the host C++
# ---------------------------------------------------------------------------
def decompress(data, size: Optional[int] = None,
               max_size: Optional[int] = None) -> bytes:
    """The decoded bytes of the frames in ``data`` (host C++). Where the
    frames do not state their content size, ``size`` is the decoded size
    or ``max_size`` its bound (a larger output raises): the output buffer
    then starts at 8 times the frames' size and grows fourfold, up to the
    bound, while the frames do not fit it."""
    from chunkflow_tpu_torch import native

    data = bytes(data)
    known = content_size(data)
    if known is not None:
        if max_size is not None and known > max_size:
            raise ZstdError(f"frames of {known} bytes, above the bound of "
                            f"{max_size}")
        if size is not None and size != known:
            raise ZstdError(f"frames of {known} bytes where {size} were "
                            f"expected")
        return native.zstd_decompress(data, known)
    if size is not None:
        return native.zstd_decompress(data, size)
    if max_size is None:
        raise ZstdError("a frame without its content size needs the "
                        "decoded size or a bound")
    cap = min(max_size, max(1 << 16, 8 * len(data)))
    while True:
        try:
            return native.zstd_decompress(data, cap, exact=False)
        except native.ZstdOutputFull:
            if cap >= max_size:
                raise
            cap = min(max_size, 4 * cap)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------
_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        while p + 32 <= n:
            lanes = struct.unpack_from("<4Q", data, p)
            v = [_round(a, b) for a, b in zip(v, lanes)]
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ _round(0, a)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, p)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (struct.unpack_from("<I", data, p)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


class _Forward:
    """Little-endian bits read forward (FSE table descriptions); bits past
    ``end`` read as zeros, and :meth:`byte_end` raises if any was
    used."""

    def __init__(self, data, start: int, end: int):
        self.data, self.bit, self.end = data, start * 8, end * 8

    def read(self, n: int) -> int:
        byte = self.bit >> 3
        chunk = int.from_bytes(
            self.data[byte:min(byte + 4, self.end >> 3)], "little")
        value = (chunk >> (self.bit & 7)) & ((1 << n) - 1)
        self.bit += n
        return value

    def byte_end(self) -> int:
        if self.bit > self.end:
            raise ZstdError("FSE table description overruns its block")
        return (self.bit + 7) >> 3


class _Backward:
    """A backward bitstream: the bytes ``[start, end)``, read from the last
    byte down after its padding, the first bit read the most significant.
    Reading past the start yields zero bits; ``bits`` then goes negative."""

    def __init__(self, data, start: int, end: int):
        if end <= start:
            raise ZstdError("empty bitstream")
        last = data[end - 1]
        if last == 0:
            raise ZstdError("bitstream without its end mark")
        self.value = int.from_bytes(data[start:end], "little")
        self.bits = (end - start - 1) * 8 + last.bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.bits -= n
        if self.bits >= 0:
            return (self.value >> self.bits) & ((1 << n) - 1)
        return (self.value << -self.bits) & ((1 << n) - 1)


def _highbit(x: int) -> int:
    return x.bit_length() - 1


class _Fse:
    """A decoding table: per state its symbol, bit count and next-state
    base."""

    def __init__(self, norm: List[int], log: int):
        size = 1 << log
        symbols = [0] * size
        high = size
        desc = [0] * len(norm)
        for s, p in enumerate(norm):
            if p == -1:
                high -= 1
                symbols[high] = s
                desc[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        pos = 0
        for s, p in enumerate(norm):
            if p <= 0:
                continue
            desc[s] = p
            for _ in range(p):
                symbols[pos] = s
                pos = (pos + step) & (size - 1)
                while pos >= high:
                    pos = (pos + step) & (size - 1)
        if pos != 0:
            raise ZstdError("FSE table does not fill its states")
        self.symbols = symbols
        self.nbits = [0] * size
        self.base = [0] * size
        for i, s in enumerate(symbols):
            nxt = desc[s]
            desc[s] += 1
            nb = log - _highbit(nxt)
            self.nbits[i] = nb
            self.base[i] = (nxt << nb) - size
        self.log = log

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        table = cls.__new__(cls)
        table.symbols, table.nbits, table.base, table.log = \
            [symbol], [0], [0], 0
        return table

    @classmethod
    def read(cls, data, pos: int, end: int, max_log: int,
             max_symbol: int) -> Tuple["_Fse", int]:
        """The table described at ``pos``, and the position after it."""
        bits = _Forward(data, pos, end)
        log = bits.read(4) + 5
        if log > max_log:
            raise ZstdError(f"FSE accuracy {log} above {max_log}")
        remaining = 1 << log
        norm: List[int] = []
        while remaining > 0 and len(norm) <= max_symbol:
            nb = _highbit(remaining + 1) + 1
            low_mask = (1 << (nb - 1)) - 1
            threshold = (1 << nb) - 1 - (remaining + 1)
            val = bits.read(nb)
            if (val & low_mask) < threshold:
                bits.bit -= 1
                val &= low_mask
            elif val > low_mask:
                val -= threshold
            prob = val - 1
            remaining -= abs(prob)
            norm.append(prob)
            if prob == 0:
                while True:
                    repeat = bits.read(2)
                    norm.extend([0] * repeat)
                    if repeat != 3:
                        break
        if remaining != 0 or len(norm) > max_symbol + 1:
            raise ZstdError("corrupt FSE table description")
        return cls(norm, log), bits.byte_end()


_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
# (predefined distribution, its accuracy, the largest accuracy, the
# largest symbol)
_KINDS = {"ll": (_LL_DEFAULT, 6, 9, 35), "of": (_OF_DEFAULT, 5, 8, 31),
          "ml": (_ML_DEFAULT, 6, 9, 52)}


class _Huffman:
    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            raise ZstdError("Huffman weights all zero")
        max_bits = _highbit(total) + 1
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise ZstdError("Huffman weights do not complete a tree")
        weights = weights + [_highbit(left) + 1]
        if max_bits > 11:
            raise ZstdError(f"Huffman code of {max_bits} bits")
        bits = [max_bits + 1 - w if w else 0 for w in weights]
        size = 1 << max_bits
        counts = [0] * (max_bits + 2)
        for b in bits:
            counts[b] += 1
        start = [0] * (max_bits + 2)
        for b in range(max_bits, 0, -1):
            start[b - 1] = start[b] + counts[b] * (1 << (max_bits - b))
        self.symbols = [0] * size
        self.nbits = [0] * size
        for b in range(max_bits, 0, -1):
            for i in range(start[b], start[b - 1]):
                self.nbits[i] = b
        for s, b in enumerate(bits):
            if b:
                span = 1 << (max_bits - b)
                for i in range(start[b], start[b] + span):
                    self.symbols[i] = s
                start[b] += span
        self.max_bits = max_bits

    @classmethod
    def read(cls, data, pos: int, end: int) -> Tuple["_Huffman", int]:
        if pos >= end:
            raise ZstdError("truncated Huffman tree description")
        header = data[pos]
        pos += 1
        if header >= 128:
            count = header - 127
            nbytes = (count + 1) // 2
            if pos + nbytes > end:
                raise ZstdError("truncated Huffman weights")
            weights = []
            for i in range(count):
                byte = data[pos + i // 2]
                weights.append(byte >> 4 if i % 2 == 0 else byte & 15)
            return cls(weights), pos + nbytes
        if pos + header > end or header == 0:
            raise ZstdError("truncated Huffman weights")
        table, start = _Fse.read(data, pos, pos + header, 6, 255)
        stream = _Backward(data, start, pos + header)
        s1, s2 = stream.read(table.log), stream.read(table.log)
        weights = []
        states = [s1, s2]
        turn = 0
        while True:
            if len(weights) >= 255:
                raise ZstdError("too many Huffman weights")
            st = states[turn]
            weights.append(table.symbols[st])
            states[turn] = table.base[st] + stream.read(table.nbits[st])
            if stream.bits < 0:
                weights.append(table.symbols[states[1 - turn]])
                break
            turn = 1 - turn
        if any(w > 11 for w in weights):
            raise ZstdError("Huffman weight above 11")
        return cls(weights), pos + header

    def decode(self, data, start: int, end: int, count: int) -> bytes:
        stream = _Backward(data, start, end)
        mask = (1 << self.max_bits) - 1
        state = stream.read(self.max_bits)
        out = bytearray(count)
        for i in range(count):
            out[i] = self.symbols[state]
            nb = self.nbits[state]
            state = ((state << nb) | stream.read(nb)) & mask
        if stream.bits != -self.max_bits:
            raise ZstdError("Huffman stream not consumed exactly")
        return bytes(out)


class _FrameState:
    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data, pos: int, end: int, state: _FrameState
              ) -> Tuple[bytes, int]:
    if pos >= end:
        raise ZstdError("truncated literals section")
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            if pos + 2 > end:
                raise ZstdError("truncated literals header")
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            if pos + 3 > end:
                raise ZstdError("truncated literals header")
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if size > MAX_BLOCK:
            raise ZstdError("literals larger than a block")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    length = (3, 3, 4, 5)[fmt]
    if pos + length > end:
        raise ZstdError("truncated literals header")
    v = int.from_bytes(data[pos:pos + length], "little")
    streams = 1 if fmt == 0 else 4
    width = (10, 10, 14, 18)[fmt]
    regen = (v >> 4) & ((1 << width) - 1)
    comp = (v >> (4 + width)) & ((1 << width) - 1)
    pos += length
    if regen > MAX_BLOCK:
        raise ZstdError("literals larger than a block")
    if pos + comp > end:
        raise ZstdError("truncated compressed literals")
    stop = pos + comp
    if kind == 2:
        state.huffman, pos = _Huffman.read(data, pos, stop)
    elif state.huffman is None:
        raise ZstdError("treeless literals without an earlier tree")
    table = state.huffman
    if streams == 1:
        return table.decode(data, pos, stop, regen), stop
    if pos + 6 > stop:
        raise ZstdError("truncated jump table")
    sizes = list(struct.unpack_from("<3H", data, pos))
    pos += 6
    sizes.append(stop - pos - sum(sizes))
    if sizes[3] < 0:
        raise ZstdError("jump table beyond the literals")
    each = (regen + 3) // 4
    counts = [each, each, each, regen - 3 * each]
    if counts[3] < 0:
        raise ZstdError("four streams of too few literals")
    out = b""
    for size, count in zip(sizes, counts):
        out += table.decode(data, pos, pos + size, count)
        pos += size
    return out, stop


def _sequences(data, pos: int, end: int, state: _FrameState):
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[pos]
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise ZstdError("truncated sequences header")
        count, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise ZstdError("truncated sequences header")
        count = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00
        pos += 3
    if count == 0:
        if pos != end:
            raise ZstdError("bytes after an empty sequences section")
        return []
    if pos >= end:
        raise ZstdError("truncated sequences header")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for name, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        mode = (modes >> shift) & 3
        default, log, max_log, max_symbol = _KINDS[name]
        if mode == 0:
            state.tables[name] = _Fse(default, log)
        elif mode == 1:
            if pos >= end:
                raise ZstdError("truncated RLE sequence table")
            if data[pos] > max_symbol:
                raise ZstdError("RLE sequence symbol out of range")
            state.tables[name] = _Fse.rle(data[pos])
            pos += 1
        elif mode == 2:
            state.tables[name], pos = _Fse.read(data, pos, end, max_log,
                                                max_symbol)
        elif state.tables[name] is None:
            raise ZstdError("repeat mode without an earlier table")
    ll_t, of_t, ml_t = (state.tables[k] for k in ("ll", "of", "ml"))
    stream = _Backward(data, pos, end)
    ll_s = stream.read(ll_t.log)
    of_s = stream.read(of_t.log)
    ml_s = stream.read(ml_t.log)
    reps = state.reps
    out = []
    for i in range(count):
        of_code = of_t.symbols[of_s]
        ll_code = ll_t.symbols[ll_s]
        ml_code = ml_t.symbols[ml_s]
        if of_code > 31 or ll_code > 35 or ml_code > 52:
            raise ZstdError("sequence code out of range")
        value = (1 << of_code) + stream.read(of_code)
        ml = _ML_BASE[ml_code] + stream.read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + stream.read(_LL_BITS[ll_code])
        if value > 3:
            offset = value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            idx = value - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[idx] if idx < 3 else reps[0] - 1
                if offset == 0:
                    raise ZstdError("repeat offset of 0")
                if idx > 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        out.append((ll, offset, ml))
        if i + 1 < count:
            ll_s = ll_t.base[ll_s] + stream.read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + stream.read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + stream.read(of_t.nbits[of_s])
        if stream.bits < 0:
            raise ZstdError("sequences overrun their bitstream")
    if stream.bits != 0:
        raise ZstdError("sequences bitstream not consumed exactly")
    return out


def _block(data, pos: int, end: int, state: _FrameState, out: bytearray,
           frame_start: int) -> None:
    literals, pos = _literals(data, pos, end, state)
    lit = 0
    for ll, offset, ml in _sequences(data, pos, end, state):
        if lit + ll > len(literals):
            raise ZstdError("sequences use more literals than decoded")
        out += literals[lit:lit + ll]
        lit += ll
        if offset > len(out) - frame_start:
            raise ZstdError("match offset before the frame's start")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            for k in range(ml):
                out.append(out[start + k])
    out += literals[lit:]


def decompress_plain(data) -> bytes:
    """The decoded bytes of the frames in ``data`` (pure Python)."""
    data = bytes(data)
    out = bytearray()
    pos, end = 0, len(data)
    if end == 0:
        raise ZstdError("no frame")
    while pos < end:
        if pos + 4 > end:
            raise ZstdError("truncated frame")
        magic = struct.unpack_from("<I", data, pos)[0]
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if pos + 8 > end:
                raise ZstdError("truncated skippable frame")
            skip = struct.unpack_from("<I", data, pos + 4)[0]
            if pos + 8 + skip > end:
                raise ZstdError("truncated skippable frame")
            pos += 8 + skip
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        size, header, checksum, window = _frame_header(data, pos)
        pos += header
        frame_start = len(out)
        state = _FrameState()
        block_max = min(window, MAX_BLOCK) if window else MAX_BLOCK
        while True:
            if pos + 3 > end:
                raise ZstdError("truncated block header")
            bh = int.from_bytes(data[pos:pos + 3], "little")
            last, kind, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            pos += 3
            if kind == 3:
                raise ZstdError("reserved block type")
            if kind == 1:
                if pos >= end or bsize > block_max:
                    raise ZstdError("bad RLE block")
                out += bytes([data[pos]]) * bsize
                pos += 1
            else:
                if pos + bsize > end or bsize > block_max:
                    raise ZstdError("block beyond the frame")
                if kind == 0:
                    out += data[pos:pos + bsize]
                else:
                    _block(data, pos, pos + bsize, state, out, frame_start)
                pos += bsize
            if last:
                break
        if size is not None and len(out) - frame_start != size:
            raise ZstdError(f"frame decoded to {len(out) - frame_start} "
                            f"bytes, its header says {size}")
        if checksum:
            if pos + 4 > end:
                raise ZstdError("truncated checksum")
            want = struct.unpack_from("<I", data, pos)[0]
            if xxh64(out[frame_start:]) & 0xFFFFFFFF != want:
                raise ZstdError("content checksum mismatch")
            pos += 4
    return bytes(out)


# ---------------------------------------------------------------------------
# the encoder
# ---------------------------------------------------------------------------
#: from the lowest level up, the last level of each row and its search:
#: (window log, hash log, chain depth, lazy, skip log). A position is
#: searched for its rep0 match, then up to ``chain depth`` earlier
#: positions with the same hash; with ``lazy`` a match waits while the
#: next position has a longer one; literals are stepped over ever faster,
#: by 1 + (the run so far >> skip log). Levels below 1 search as level 1
#: with a skip log of 8 + level (at least 1); level 0 is level 3.
LEVELS = ((1, (19, 16, 1, 0, 8)), (2, (20, 16, 2, 0, 8)),
          (3, (21, 17, 3, 0, 8)), (4, (21, 17, 6, 0, 10)),
          (6, (21, 17, 8, 1, 8)), (9, (22, 18, 16, 1, 9)),
          (15, (22, 18, 32, 1, 10)), (22, (23, 19, 64, 1, 11)))
MIN_MATCH = 4
#: a match at a new offset is at least this long: a shorter one costs
#: about as many bits as its literals, and on noisy data ends each run of
#: literals, so stepping through them never speeds up
_HASH_MIN_MATCH = 5
#: the positions a match inserts at each of its ends
_INSERT_ENDS = 16
_HASH_MUL = 2654435761
_HUFFMAN_MAX_BITS = 11


def params(level: int) -> Tuple[int, int, int, int, int]:
    """``(window log, hash log, chain depth, lazy, skip log)`` of
    ``level`` (:data:`LEVELS`)."""
    level = int(level)
    if level == 0:
        level = 3
    if level < 1:
        window, hashes, depth, lazy, _ = LEVELS[0][1]
        return window, hashes, depth, lazy, max(1, 8 + level)
    for top, row in LEVELS:
        if level <= top:
            return row
    return LEVELS[-1][1]


def compress(data, level: int = 3) -> bytes:
    """``data`` as one zstd frame at ``level`` (host C++)."""
    from chunkflow_tpu_torch import native

    return native.zstd_compress(bytes(data), int(level))


class _BitWriter:
    """Bits appended from the least significant; :meth:`finish` adds the
    end mark a backward bitstream's reader looks for."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.count = 0
        self.total = 0

    def add(self, value: int, nbits: int) -> None:
        self.acc |= value << self.count
        self.count += nbits
        self.total += nbits
        while self.count >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.count -= 8

    def flush(self) -> bytes:
        if self.count:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)

    def finish(self) -> bytes:
        self.add(1, 1)
        return self.flush()


class _FseTable(_Fse):
    """An FSE table and its encoder: the state of a symbol whose next-state
    range holds a given state."""

    def __init__(self, norm: List[int], log: int):
        super().__init__(norm, log)
        self.norm = norm
        self.states = {}
        for i, s in enumerate(self.symbols):
            self.states.setdefault(s, []).append(i)

    def encode(self, symbol: int, state: int) -> Tuple[int, int, int]:
        """``(the state of symbol, the bits that lead from it to state,
        their count)``."""
        count = max(self.norm[symbol], 1)
        value = state + (1 << self.log)
        nbits = self.log - _highbit(count) - 1
        if nbits < 0 or value >> nbits >= 2 * count:
            nbits += 1
        i = self.states[symbol][(value >> nbits) - count]
        return i, state - self.base[i], nbits

    def start(self, symbol: int) -> int:
        """The first state of ``symbol``: the one with the most bits, at
        least one where the symbol does not fill the table."""
        return self.states[symbol][0]


class _RleTable:
    log = 0

    def encode(self, symbol: int, state: int) -> Tuple[int, int, int]:
        return 0, 0, 0

    def start(self, symbol: int) -> int:
        return 0


def _table_log(max_log: int, total: int, max_symbol: int) -> int:
    """The accuracy of a table for ``total`` symbols up to
    ``max_symbol`` (zstd's ``FSE_optimalTableLog``)."""
    log = min(max_log, _highbit(total - 1) - 2)
    log = max(log, min(_highbit(total) + 1, _highbit(max_symbol) + 2))
    return max(5, min(log, max_log))


def _normalize(counts: List[int], total: int, log: int) -> List[int]:
    """``counts`` as a distribution over ``1 << log`` states: -1 for a
    symbol below one state, each other rounded to nearest, the rounding's
    excess taken from the largest, one state at a time."""
    size = 1 << log
    low = total >> log
    norm = [0] * len(counts)
    remaining = size
    for s, c in enumerate(counts):
        if not c:
            continue
        if c <= low:
            norm[s] = -1
            remaining -= 1
            continue
        p = c * size // total
        if 2 * (c * size - p * total) >= total:
            p += 1
        norm[s] = max(p, 1)
        remaining -= norm[s]
    while remaining < 0:
        s = max(range(len(norm)), key=lambda k: (norm[k], -k))
        norm[s] -= 1
        remaining += 1
    if remaining:
        s = max(range(len(norm)), key=lambda k: (norm[k], -k))
        norm[s] += remaining
    return norm


def _write_ncount(norm: List[int], log: int) -> bytes:
    """The table description :meth:`_Fse.read` reads."""
    w = _BitWriter()
    w.add(log - 5, 4)
    remaining = 1 << log
    s = 0
    while remaining > 0:
        prob = norm[s]
        nb = _highbit(remaining + 1) + 1
        low = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - (remaining + 1)
        v = prob + 1
        if v < threshold:
            w.add(v, nb - 1)
        elif v <= low:
            w.add(v, nb)
        else:
            w.add(v + threshold, nb)
        remaining -= abs(prob)
        s += 1
        if prob == 0:
            zeros = 0
            while norm[s + zeros] == 0:
                zeros += 1
            s += zeros
            while zeros >= 3:
                w.add(3, 2)
                zeros -= 3
            w.add(zeros, 2)
    return w.flush()


def _huffman_lengths(counts: List[int]) -> List[int]:
    """Code lengths of at most :data:`_HUFFMAN_MAX_BITS` bits, and a
    complete code, for the symbols with a count."""
    order = sorted((c, s) for s, c in enumerate(counts) if c)
    n = len(order)
    weight = [c for c, _ in order] + [0] * (n - 1)
    parent = [0] * (2 * n - 1)
    leaf, inner = 0, n
    for node in range(n, 2 * n - 1):
        pair = []
        for _ in range(2):
            if leaf < n and (inner >= node or weight[leaf] <= weight[inner]):
                pair.append(leaf)
                leaf += 1
            else:
                pair.append(inner)
                inner += 1
        weight[node] = weight[pair[0]] + weight[pair[1]]
        parent[pair[0]] = parent[pair[1]] = node
    depth = [0] * (2 * n - 1)
    for k in range(2 * n - 3, -1, -1):
        depth[k] = depth[parent[k]] + 1
    limit = _HUFFMAN_MAX_BITS
    bits = [min(d, limit) for d in depth[:n]]
    kraft = sum(1 << (limit - b) for b in bits)
    while kraft > 1 << limit:
        k = max(range(n), key=lambda i: (bits[i] if bits[i] < limit else -1,
                                         -i))
        kraft -= 1 << (limit - bits[k] - 1)
        bits[k] += 1
    while kraft < 1 << limit:
        for k in range(n - 1, -1, -1):
            if bits[k] > 1 and kraft + (1 << (limit - bits[k])) <= 1 << limit:
                kraft += 1 << (limit - bits[k])
                bits[k] -= 1
                break
    lengths = [0] * len(counts)
    for (_, s), b in zip(order, bits):
        lengths[s] = b
    return lengths


def _fse_weights(weights: List[int]) -> Optional[bytes]:
    """Huffman weights FSE-compressed (two interleaved states), or None
    where that cannot be written."""
    n = len(weights)
    counts = [0] * 12
    for w in weights:
        counts[w] += 1
    if n < 2 or sum(1 for c in counts if c) < 2:
        return None
    log = _table_log(6, n, max(weights))
    norm = _normalize(counts[:max(weights) + 1], n, log)
    table = _FseTable(norm, log)
    w = _BitWriter()
    states = [0] * n
    states[n - 1] = table.start(weights[n - 1])
    states[n - 2] = table.start(weights[n - 2])
    for k in range(n - 3, -1, -1):
        states[k], bits, nbits = table.encode(weights[k], states[k + 2])
        w.add(bits, nbits)
    w.add(states[1], log)
    w.add(states[0], log)
    body = _write_ncount(norm, log) + w.finish()
    return bytes([len(body)]) + body if len(body) < 128 else None


def _literals_header(kind: int, size: int) -> bytes:
    if size < 32:
        return bytes([kind | size << 3])
    if size < 4096:
        return (kind | 1 << 2 | size << 4).to_bytes(2, "little")
    return (kind | 3 << 2 | size << 4).to_bytes(3, "little")


def _huffman_literals(lits: bytes) -> Optional[bytes]:
    counts = [0] * 256
    for b in lits:
        counts[b] += 1
    lengths = _huffman_lengths(counts)
    max_bits = max(lengths)
    last = max(s for s in range(256) if counts[s])
    weights = [max_bits + 1 - b if b else 0 for b in lengths[:last]]
    tree = _fse_weights(weights)
    if len(weights) <= 128:
        direct = bytes([127 + len(weights)]) + bytes(
            (weights[i] << 4) | (weights[i + 1] if i + 1 < len(weights)
                                 else 0)
            for i in range(0, len(weights), 2))
        if tree is None or len(direct) <= len(tree):
            tree = direct
    if tree is None:
        return None
    per_length = [0] * (max_bits + 1)
    for b in lengths:
        if b:
            per_length[b] += 1
    start = [0] * (max_bits + 1)
    for b in range(max_bits, 0, -1):
        start[b - 1] = start[b] + per_length[b] * (1 << (max_bits - b))
    codes = [0] * 256
    for s in range(256):
        b = lengths[s]
        if b:
            codes[s] = start[b] >> (max_bits - b)
            start[b] += 1 << (max_bits - b)
    n = len(lits)
    if n < 1024:
        parts = [lits]
    else:
        each = (n + 3) // 4
        parts = [lits[i * each:(i + 1) * each] for i in range(3)] + \
            [lits[3 * each:]]
    streams = []
    for part in parts:
        w = _BitWriter()
        for b in reversed(part):
            w.add(codes[b], lengths[b])
        streams.append(w.finish())
    body = tree
    if len(parts) == 4:
        body += struct.pack("<3H", *(len(s) for s in streams[:3]))
    body += b"".join(streams)
    if len(parts) == 1:
        fmt = 0
    else:
        big = max(n, len(body))
        fmt = 1 if big < 1024 else 2 if big < 16384 else 3
    width = (10, 10, 14, 18)[fmt]
    if len(body) >= 1 << width:
        return None
    header = 2 | fmt << 2 | n << 4 | len(body) << (4 + width)
    return header.to_bytes((3, 3, 4, 5)[fmt], "little") + body


def _literals_section(lits: bytes) -> bytes:
    raw = _literals_header(0, len(lits)) + lits
    if not lits:
        return raw
    if lits.count(lits[0]) == len(lits):
        rle = _literals_header(1, len(lits)) + lits[:1]
        return rle if len(rle) < len(raw) else raw
    huffman = _huffman_literals(lits)
    return huffman if huffman is not None and len(huffman) < len(raw) \
        else raw


def _ll_code(ll: int) -> int:
    if ll < 16:
        return ll
    if ll >= 64:
        return _highbit(ll) + 19
    code = 16
    while _LL_BASE[code + 1] <= ll:
        code += 1
    return code


def _ml_code(ml: int) -> int:
    base = ml - 3
    if base < 32:
        return base
    if base >= 128:
        return _highbit(base) + 36
    code = 32
    while _ML_BASE[code + 1] <= ml:
        code += 1
    return code


def _chain_bits(table, codes: List[int]) -> int:
    """The bits ``codes`` take through ``table``, its initial state's
    included."""
    state = table.start(codes[-1])
    total = table.log
    for code in reversed(codes[:-1]):
        state, _, nbits = table.encode(code, state)
        total += nbits
    return total


def _sequence_table(codes: List[int], name: str):
    """``(mode, description, table)`` for one kind of code: RLE where
    there is one symbol, else predefined or FSE-compressed, whichever
    takes fewer bits."""
    default, log, max_log, max_symbol = _KINDS[name]
    top = max(codes)
    if all(c == codes[0] for c in codes):
        return 1, bytes([codes[0]]), _RleTable()
    choices = []
    if top < len(default):
        table = _FseTable(default, log)
        choices.append((_chain_bits(table, codes), 0, b"", table))
    counts = [0] * (top + 1)
    for c in codes:
        counts[c] += 1
    log = _table_log(max_log, len(codes), top)
    norm = _normalize(counts, len(codes), log)
    table = _FseTable(norm, log)
    description = _write_ncount(norm, log)
    choices.append((_chain_bits(table, codes) + 8 * len(description), 2,
                    description, table))
    _, mode, description, table = min(choices, key=lambda c: (c[0], c[1]))
    return mode, description, table


def _sequences_section(seqs) -> bytes:
    n = len(seqs)
    if n < 128:
        out = bytearray([n])
    elif n < 0x7F00:
        out = bytearray([(n >> 8) + 128, n & 255])
    else:
        out = bytearray([255]) + (n - 0x7F00).to_bytes(2, "little")
    if not n:
        return bytes(out)
    ll_codes = [_ll_code(ll) for ll, _, _ in seqs]
    ml_codes = [_ml_code(ml) for _, _, ml in seqs]
    of_codes = [_highbit(v) for _, v, _ in seqs]
    tables = {}
    modes = 0
    descriptions = b""
    for name, codes, shift in (("ll", ll_codes, 6), ("of", of_codes, 4),
                               ("ml", ml_codes, 2)):
        mode, description, tables[name] = _sequence_table(codes, name)
        modes |= mode << shift
        descriptions += description
    ll_t, of_t, ml_t = tables["ll"], tables["of"], tables["ml"]
    w = _BitWriter()
    i = n - 1
    ll_s = ll_t.start(ll_codes[i])
    ml_s = ml_t.start(ml_codes[i])
    of_s = of_t.start(of_codes[i])
    while True:
        ll, value, ml = seqs[i]
        w.add(ll - _LL_BASE[ll_codes[i]], _LL_BITS[ll_codes[i]])
        w.add(ml - _ML_BASE[ml_codes[i]], _ML_BITS[ml_codes[i]])
        w.add(value - (1 << of_codes[i]), of_codes[i])
        i -= 1
        if i < 0:
            break
        of_s, bits, nbits = of_t.encode(of_codes[i], of_s)
        w.add(bits, nbits)
        ml_s, bits, nbits = ml_t.encode(ml_codes[i], ml_s)
        w.add(bits, nbits)
        ll_s, bits, nbits = ll_t.encode(ll_codes[i], ll_s)
        w.add(bits, nbits)
    w.add(ml_s, ml_t.log)
    w.add(of_s, of_t.log)
    w.add(ll_s, ll_t.log)
    return bytes(out) + bytes([modes]) + descriptions + w.finish()


def _offset_value(offset: int, ll: int, reps: List[int]) -> int:
    """The offset value of a match after ``ll`` literals, the repeat
    offsets updated as the decoder updates them."""
    if ll:
        value = 1 if offset == reps[0] else 2 if offset == reps[1] else \
            3 if offset == reps[2] else offset + 3
    else:
        value = 1 if offset == reps[1] else 2 if offset == reps[2] else \
            3 if offset == reps[0] - 1 else offset + 3
    if value > 3:
        reps[2], reps[1], reps[0] = reps[1], reps[0], offset
    elif value - 1 + (ll == 0):
        if value - 1 + (ll == 0) > 1:
            reps[2] = reps[1]
        reps[1], reps[0] = reps[0], offset
    return value


def _match_length(data: bytes, a: int, b: int, end: int) -> int:
    n, most, step = 0, end - b, 256
    while step:
        while n + step <= most and \
                data[a + n:a + n + step] == data[b + n:b + n + step]:
            n += step
        step >>= 4
    return n


class _Matcher:
    """The match finder over one frame's bytes."""

    def __init__(self, data: bytes, level: int):
        window, hash_log, self.depth, self.lazy, self.skip = params(level)
        self.data = data
        self.max_distance = (1 << window) - 1
        words = np.frombuffer(data, np.uint8).astype(np.uint32)
        if len(data) >= 4:
            words = words[:-3] | words[1:-2] << 8 | words[2:-1] << 16 | \
                words[3:] << 24
            self.hashes = ((words * np.uint32(_HASH_MUL))
                           >> np.uint32(32 - hash_log)).tolist()
        else:
            self.hashes = []
        self.table = [-1] * (1 << hash_log)
        self.chain = [-1] * len(data) if self.depth > 1 else None

    def insert(self, p: int) -> int:
        h = self.hashes[p]
        first = self.table[h]
        self.table[h] = p
        if self.chain is not None:
            self.chain[p] = first
        return first

    def search(self, ip: int, end: int, rep: int):
        """The longest match at ``ip`` ending by ``end``: ``(length,
        offset)``, the match at the repeat offset ``rep`` first; ``ip`` is
        inserted."""
        data = self.data
        best, offset = 0, 0
        if rep <= min(ip, self.max_distance):
            best = _match_length(data, ip - rep, ip, end)
            offset = rep
        cand = self.insert(ip)
        tries = self.depth
        while cand >= 0 and ip - cand <= self.max_distance:
            length = _match_length(data, cand, ip, end)
            if length > best and length >= _HASH_MIN_MATCH:
                best, offset = length, ip - cand
            tries -= 1
            if not tries or self.chain is None:
                break
            cand = self.chain[cand]
        return best, offset

    def parse(self, start: int, end: int, reps: List[int]):
        """The literals and ``(literal length, offset value, match
        length)`` sequences of the block ``[start, end)``."""
        lits, seqs = [], []
        ip = anchor = start
        last = end - MIN_MATCH
        top = len(self.data) - MIN_MATCH
        while ip <= last:
            # the repeat offset a match right after the last one codes as
            # 1 is rep1, after literals rep0
            length, offset = self.search(ip, end,
                                         reps[0] if ip > anchor else reps[1])
            if length < MIN_MATCH:
                ip += 1 + ((ip - anchor) >> self.skip)
                continue
            probed = ip
            while self.lazy and ip + 1 <= last:
                more, other = self.search(ip + 1, end, reps[0])
                probed = ip + 1
                if more <= length:
                    break
                ip, length, offset = ip + 1, more, other
            # a match reaches back over the literals before it
            while ip > anchor and ip > offset and \
                    self.data[ip - 1] == self.data[ip - 1 - offset]:
                ip -= 1
                length += 1
            lits.append(self.data[anchor:ip])
            seqs.append((ip - anchor, _offset_value(offset, ip - anchor, reps),
                         length))
            # a long match is inserted at its two ends only
            stop = min(ip + length, top + 1)
            for p in range(probed + 1, min(ip + _INSERT_ENDS, stop)):
                self.insert(p)
            for p in range(max(probed + 1, ip + _INSERT_ENDS,
                               ip + length - _INSERT_ENDS), stop):
                self.insert(p)
            ip += length
            anchor = ip
        lits.append(self.data[anchor:end])
        return b"".join(lits), seqs


def _block_header(last: bool, kind: int, size: int) -> bytes:
    return (int(last) | kind << 1 | size << 3).to_bytes(3, "little")


def compress_plain(data, level: int = 3) -> bytes:
    """``data`` as one zstd frame at ``level`` (pure Python): the bytes of
    :func:`compress`."""
    data = bytes(data)
    n = len(data)
    window = params(level)[0]
    single = n <= 1 << window
    if single and n < 256:
        fcs_flag, fcs = 0, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fcs_flag, fcs = 2, n.to_bytes(4, "little")
    else:
        fcs_flag, fcs = 3, n.to_bytes(8, "little")
    out = bytearray(struct.pack("<I", MAGIC))
    out.append(fcs_flag << 6 | int(single) << 5 | 1 << 2)
    if not single:
        out.append((window - 10) << 3)
    out += fcs
    if not n:
        out += _block_header(True, 0, 0)
    matcher = _Matcher(data, level)
    reps = [1, 4, 8]
    for start in range(0, n, MAX_BLOCK):
        end = min(n, start + MAX_BLOCK)
        last = end == n
        block = data[start:end]
        if block.count(block[0]) == len(block):
            out += _block_header(last, 1, len(block)) + block[:1]
            continue
        saved = reps[:]
        lits, seqs = matcher.parse(start, end, reps)
        body = _literals_section(lits) + _sequences_section(seqs)
        if len(body) < len(block):
            out += _block_header(last, 2, len(body)) + body
        else:
            reps[:] = saved
            out += _block_header(last, 0, len(block)) + block
    out += struct.pack("<I", xxh64(data) & 0xFFFFFFFF)
    return bytes(out)
