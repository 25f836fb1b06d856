"""Zstandard frames (RFC 8878), decode only.

:func:`decompress` runs the host C++ (``csrc/host/zstd.cpp``); it is the
only decoder the storage plane calls. :func:`decompress_plain` is the same
algorithm in pure Python, for the tests: it is slow (a few hundred KB/s)
and sees only small inputs there.

Both decode a run of frames: zstd frames, each with raw, RLE and
compressed blocks (Huffman literals with direct or FSE-compressed weights,
treeless literals, one or four streams; FSE sequences in predefined, RLE,
compressed and repeat modes, with the three repeat offsets), an optional
content size, an optional XXH64 content checksum (verified), and
skippable frames between them. A frame that names a dictionary raises, as
does any frame that does not decode within its own bytes and the output
size: a malformed frame raises :class:`ZstdError` and never reads or
writes outside its buffers. The port writes no zstd.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

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
