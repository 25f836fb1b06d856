// Blosc1 frames: the decoder, and the encoders of the frames the port
// writes.
//
// A frame is a 16-byte header (format version, codec version, flags,
// typesize, nbytes, blocksize, cbytes), then either the data as it is
// (the memcpyed flag) or a table of block starts and the blocks. A block
// is split into `typesize` streams unless the header's 0x10 flag says not
// to or it is the short last block; each stream is its 4-byte compressed
// size and the codec's bytes, or the bytes as they are when that size is
// the stream's own. The codec is the flags' top three bits: blosclz, lz4
// (and lz4hc, the same block format), snappy, zlib (inflated by the
// caller's function, so the library links nothing) and zstd
// (cf_zstd_decompress, zstd.cpp). Then the block is byte- or
// bit-unshuffled. Every read and write is bounds-checked; a malformed
// frame returns a negative code. volume/blosc.py:decompress_plain is the
// same walk in Python and numpy.
//
// The encoders share one greedy match finder: a hash of 4-byte sequences
// (the last position of each hash kept), matches extended backwards over
// the literals before them, stepping ever faster through literals. Each
// codec sets how far back a match may reach and where matches stop:
//   cf_lz4_compress      one LZ4 block; at most 65535 back, no match
//                        starting in the last 12 bytes, the last 5
//                        literals, as the block format sets;
//   cf_lz4hc_compress    the same block, each match the longest of a
//                        hash chain's candidates (chain_matches), for
//                        lz4hc stores;
//   cf_blosclz_compress  one blosclz stream (c-blosc 1.x's decoder):
//                        literal runs of at most 32 bytes, matches of 3+
//                        bytes up to 73727 back (13-bit near and 16-bit
//                        far distances), the last 5 bytes literals, since
//                        the decoder never copies a last match;
//   cf_snappy_compress   snappy's raw format: a varint length, literals,
//                        copies with 1-byte offsets (lengths 4-11, under
//                        2048 back) or 2-byte offsets (lengths 1-64),
//                        at most 65535 back.
// cf_bitshuffle is the inverse of the decoder's bit-unshuffle: 8 elements
// at a time, their bits transposed as an 8x8 matrix per byte of the type.
// A block whose element count is not a multiple of 8 stays as it is, as
// c-blosc 1.x leaves it in a frame of format version 2.
// volume/blosc.py's lz4_compress_plain, lz4hc_compress_plain,
// blosclz_compress_plain, snappy_compress_plain and bitshuffle_plain give
// the same bytes.
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int64_t cf_zstd_decompress(const uint8_t* src, int64_t n,
                                      uint8_t* dst, int64_t cap);

namespace {

enum Error : int64_t {
  kTruncated = -1,
  kUnsupported = -2,
  kCorrupt = -3,
  kOutputFull = -4,
  kCodec = -5,
};

using Inflate = int64_t (*)(const uint8_t*, int64_t, uint8_t*, int64_t);

inline uint32_t u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
}

// Copy `len` bytes from `offset` back; the regions may overlap.
inline bool copy_back(uint8_t* out, int64_t op, int64_t cap, int64_t offset,
                      int64_t len) {
  if (offset <= 0 || offset > op || len > cap - op) return false;
  const uint8_t* from = out + op - offset;
  uint8_t* to = out + op;
  if (offset >= len) {
    std::memcpy(to, from, len);
  } else {
    for (int64_t k = 0; k < len; ++k) to[k] = from[k];
  }
  return true;
}

// blosclz (c-blosc 1.x): a control byte whose top three bits are the
// match length (0: a literal run of ctrl + 1 bytes), a 13-bit distance,
// a 16-bit far distance after 255, and a last match never copied.
int64_t blosclz(const uint8_t* ip, int64_t n, uint8_t* out, int64_t cap) {
  if (n == 0) return 0;
  const uint8_t* ip_limit = ip + n;
  int64_t op = 0;
  uint32_t ctrl = (*ip++) & 31u;
  while (true) {
    if (ctrl >= 32) {
      int64_t len = static_cast<int64_t>(ctrl >> 5) - 1;
      int64_t ofs = static_cast<int64_t>(ctrl & 31u) << 8;
      uint8_t code;
      if (len == 7 - 1) {
        do {
          if (ip + 1 >= ip_limit) return kCorrupt;
          code = *ip++;
          len += code;
        } while (code == 255);
      } else if (ip + 1 >= ip_limit) {
        return kCorrupt;
      }
      code = *ip++;
      len += 3;
      int64_t distance = ofs + code;
      if (code == 255 && ofs == (31 << 8)) {
        if (ip + 1 >= ip_limit) return kCorrupt;
        ofs = static_cast<int64_t>(*ip++) << 8;
        ofs += *ip++;
        distance = ofs + 8191;
      }
      if (len > cap - op) return kCorrupt;
      if (distance + 1 > op) return kCorrupt;
      if (ip >= ip_limit) break;
      ctrl = *ip++;
      if (!copy_back(out, op, cap, distance + 1, len)) return kCorrupt;
      op += len;
    } else {
      int64_t run = ctrl + 1;
      if (run > cap - op || run > ip_limit - ip) return kCorrupt;
      std::memcpy(out + op, ip, run);
      op += run;
      ip += run;
      if (ip >= ip_limit) break;
      ctrl = *ip++;
    }
  }
  return op;
}

// One LZ4 block: tokens of literal and match lengths, 2-byte offsets, the
// last sequence literals only.
int64_t lz4(const uint8_t* ip, int64_t n, uint8_t* out, int64_t cap) {
  const uint8_t* end = ip + n;
  int64_t op = 0;
  while (true) {
    if (ip >= end) return kCorrupt;
    int token = *ip++;
    int64_t lit = token >> 4;
    if (lit == 15) {
      int b;
      do {
        if (ip >= end) return kCorrupt;
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > end - ip || lit > cap - op) return kCorrupt;
    std::memcpy(out + op, ip, lit);
    ip += lit;
    op += lit;
    if (ip == end) break;
    if (end - ip < 2) return kCorrupt;
    int64_t offset = ip[0] | (ip[1] << 8);
    ip += 2;
    int64_t len = token & 15;
    if (len == 15) {
      int b;
      do {
        if (ip >= end) return kCorrupt;
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (!copy_back(out, op, cap, offset, len)) return kCorrupt;
    op += len;
  }
  return op;
}

// Snappy's raw format: a varint length, then literals and copies with
// 1-, 2- or 4-byte offsets.
int64_t snappy(const uint8_t* ip, int64_t n, uint8_t* out, int64_t cap) {
  const uint8_t* end = ip + n;
  uint64_t length = 0;
  for (int shift = 0;; shift += 7) {
    if (ip >= end || shift > 28) return kCorrupt;
    uint8_t b = *ip++;
    length |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
  }
  if (length > static_cast<uint64_t>(cap)) return kCorrupt;
  int64_t op = 0;
  while (ip < end) {
    uint8_t tag = *ip++;
    int kind = tag & 3;
    if (kind == 0) {
      int64_t len = tag >> 2;
      if (len >= 60) {
        int extra = static_cast<int>(len) - 59;
        if (end - ip < extra) return kCorrupt;
        len = 0;
        for (int i = 0; i < extra; ++i) len |= static_cast<int64_t>(ip[i]) << (8 * i);
        ip += extra;
      }
      len += 1;
      if (len > end - ip || len > cap - op) return kCorrupt;
      std::memcpy(out + op, ip, len);
      ip += len;
      op += len;
      continue;
    }
    int64_t len, offset;
    if (kind == 1) {
      if (ip >= end) return kCorrupt;
      len = 4 + ((tag >> 2) & 7);
      offset = (static_cast<int64_t>(tag >> 5) << 8) | *ip++;
    } else if (kind == 2) {
      if (end - ip < 2) return kCorrupt;
      len = (tag >> 2) + 1;
      offset = ip[0] | (ip[1] << 8);
      ip += 2;
    } else {
      if (end - ip < 4) return kCorrupt;
      len = (tag >> 2) + 1;
      offset = u32(ip);
      ip += 4;
    }
    if (!copy_back(out, op, cap, offset, len)) return kCorrupt;
    op += len;
  }
  return op == static_cast<int64_t>(length) ? op : kCorrupt;
}

void unshuffle(const uint8_t* src, uint8_t* dst, int64_t typesize,
               int64_t size) {
  int64_t count = size / typesize;
  for (int64_t j = 0; j < typesize; ++j) {
    const uint8_t* row = src + j * count;
    for (int64_t i = 0; i < count; ++i) dst[i * typesize + j] = row[i];
  }
  int64_t done = count * typesize;
  std::memcpy(dst + done, src + done, size - done);
}

// The 8x8 bit matrix in x (row j = byte j) transposed: bit k of byte j
// becomes bit j of byte k. Its own inverse.
inline uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// The bit-transposed rows (byte b, bit k) of `count` elements, a multiple
// of 8, back into elements: 8 elements at a time, per byte of the type.
void bitunshuffle(const uint8_t* src, uint8_t* dst, int64_t typesize,
                  int64_t count) {
  int64_t row = count / 8;
  for (int64_t m = 0; m < row; ++m) {
    for (int64_t b = 0; b < typesize; ++b) {
      uint64_t x = 0;
      for (int k = 0; k < 8; ++k) {
        x |= static_cast<uint64_t>(src[(b * 8 + k) * row + m]) << (8 * k);
      }
      x = transpose8(x);
      for (int j = 0; j < 8; ++j) {
        dst[(m * 8 + j) * typesize + b] = static_cast<uint8_t>(x >> (8 * j));
      }
    }
  }
}

int64_t stream(int codec, const uint8_t* src, int64_t n, uint8_t* dst,
               int64_t size, Inflate inflate) {
  switch (codec) {
    case 0: return blosclz(src, n, dst, size);
    case 1: return lz4(src, n, dst, size);
    case 2: return snappy(src, n, dst, size);
    case 3: return inflate ? inflate(src, n, dst, size) : kUnsupported;
    case 4: {
      int64_t got = cf_zstd_decompress(src, n, dst, size);
      return got < 0 ? kCodec : got;
    }
    default: return kUnsupported;
  }
}

constexpr int kHashLog = 16;
constexpr int kSkip = 6;  // the step through literals grows every 64 bytes

inline uint32_t hash4(const uint8_t* p) {
  uint32_t word;
  std::memcpy(&word, p, 4);
  return (word * 2654435761u) >> (32 - kHashLog);
}

// A bounded byte sink: `full` once anything did not fit.
struct Out {
  uint8_t* dst;
  int64_t cap, pos = 0;
  bool full = false;
  inline void byte(uint8_t b) {
    if (pos >= cap) {
      full = true;
      return;
    }
    dst[pos++] = b;
  }
  void run255(int64_t extra) {  // 255s, then the rest: LZ4's and blosclz's
    while (extra >= 255) {
      byte(255);
      extra -= 255;
    }
    byte(static_cast<uint8_t>(extra));
  }
  void copy(const uint8_t* src, int64_t n) {
    if (n > cap - pos) {
      full = true;
      return;
    }
    std::memcpy(dst + pos, src, n);
    pos += n;
  }
};

// The greedy matches of src[0..n): emit(literals, count, offset, length)
// for each match (offset back, length >= 4), then emit(literals, count,
// 0, 0) for the literals after the last. A match starts at or before
// `last` and ends at or before `limit`, at most `max_offset` back.
template <class Emit>
void greedy_matches(const uint8_t* src, int64_t n, int64_t max_offset,
                    int64_t last, int64_t limit, Emit&& emit) {
  std::vector<int64_t> table(static_cast<size_t>(1) << kHashLog, -1);
  int64_t ip = 0, anchor = 0;
  while (ip <= last) {
    uint32_t h = hash4(src + ip);
    int64_t cand = table[h];
    table[h] = ip;
    if (cand < 0 || ip - cand > max_offset || std::memcmp(src + cand, src + ip, 4) != 0) {
      ip += 1 + ((ip - anchor) >> kSkip);
      continue;
    }
    while (ip > anchor && cand > 0 && src[ip - 1] == src[cand - 1]) {
      ip -= 1;
      cand -= 1;
    }
    int64_t len = 4;
    while (ip + len < limit && src[cand + len] == src[ip + len]) len++;
    emit(src + anchor, ip - anchor, ip - cand, len);
    ip += len;
    anchor = ip;
    if (ip - 2 <= n - 4) table[hash4(src + ip - 2)] = ip - 2;
  }
  emit(src + anchor, n - anchor, 0, 0);
}

// The matches of src[0..n) as greedy_matches gives them, but each the
// longest of up to `depth` earlier positions of its hash (a chain through
// the last 64 KiB), stepping one byte at a time, and every position
// entered in the chains, as LZ4 HC searches.
template <class Emit>
void chain_matches(const uint8_t* src, int64_t n, int64_t max_offset,
                   int64_t last, int64_t limit, int depth, Emit&& emit) {
  constexpr int64_t kWindow = int64_t{1} << 16;
  std::vector<int64_t> head(static_cast<size_t>(1) << kHashLog, -1);
  std::vector<int64_t> prev(kWindow, -1);
  int64_t ip = 0, anchor = 0, entered = 0;
  while (ip <= last) {
    for (; entered < ip; ++entered) {
      uint32_t h = hash4(src + entered);
      prev[entered & (kWindow - 1)] = head[h];
      head[h] = entered;
    }
    int64_t best = 0, from = -1;
    int64_t cand = head[hash4(src + ip)];
    for (int d = 0; d < depth && cand >= 0 && ip - cand <= max_offset; ++d) {
      if (std::memcmp(src + cand, src + ip, 4) == 0) {
        int64_t len = 4;
        while (ip + len < limit && src[cand + len] == src[ip + len]) len++;
        if (len > best) {
          best = len;
          from = cand;
        }
      }
      int64_t next = prev[cand & (kWindow - 1)];
      if (next >= cand) break;  // a slot a later position took over
      cand = next;
    }
    if (best == 0) {
      ip += 1;
      continue;
    }
    while (ip > anchor && from > 0 && src[ip - 1] == src[from - 1]) {
      ip -= 1;
      from -= 1;
      best += 1;
    }
    emit(src + anchor, ip - anchor, ip - from, best);
    ip += best;
    anchor = ip;
  }
  emit(src + anchor, n - anchor, 0, 0);
}

// An LZ4 sequence: a token, literals, then (where len > 0) a 2-byte
// offset and the match length past its token's 15.
void lz4_sequence(Out& out, const uint8_t* lits, int64_t lit, int64_t offset,
                  int64_t len) {
  int64_t ml = len > 0 ? len - 4 : 0;
  out.byte(static_cast<uint8_t>((lit < 15 ? lit : 15) << 4 | (ml < 15 ? ml : 15)));
  if (lit >= 15) out.run255(lit - 15);
  out.copy(lits, lit);
  if (len <= 0) return;
  out.byte(static_cast<uint8_t>(offset));
  out.byte(static_cast<uint8_t>(offset >> 8));
  if (ml >= 15) out.run255(ml - 15);
}

constexpr int64_t kBlosclzNear = 8191;  // distances below are 13-bit
constexpr int64_t kBlosclzMaxOffset = 65535 + kBlosclzNear + 1;

// blosclz: literal runs of at most 32 bytes (control byte run - 1); a
// match is a control byte of (length - 2, at most 7) << 5 and the
// distance's top 5 bits, length bytes past 7 - 2 + 3, then the distance's
// low byte, or 255 and a 16-bit far distance.
void blosclz_sequence(Out& out, const uint8_t* lits, int64_t lit,
                      int64_t offset, int64_t len) {
  while (lit > 0) {
    int64_t run = lit < 32 ? lit : 32;
    out.byte(static_cast<uint8_t>(run - 1));
    out.copy(lits, run);
    lits += run;
    lit -= run;
  }
  if (len <= 0) return;
  int64_t m = len - 3, distance = offset - 1;
  uint8_t code = static_cast<uint8_t>((m < 6 ? m : 6) + 1) << 5;
  bool near = distance < kBlosclzNear;
  out.byte(code | static_cast<uint8_t>(near ? distance >> 8 : 31));
  if (m >= 6) out.run255(m - 6);
  if (near) {
    out.byte(static_cast<uint8_t>(distance));
  } else {
    int64_t far = distance - kBlosclzNear;
    out.byte(255);
    out.byte(static_cast<uint8_t>(far >> 8));
    out.byte(static_cast<uint8_t>(far));
  }
}

// snappy: a literal's tag holds its length - 1 below 60, else 60-63 for
// 1-4 little-endian length bytes; a copy is split into parts of at most
// 64 bytes (the last at least 4), each with a 1- or 2-byte offset.
void snappy_copy(Out& out, int64_t offset, int64_t len) {
  if (len < 12 && offset < 2048) {
    out.byte(static_cast<uint8_t>(1 | (len - 4) << 2 | (offset >> 8) << 5));
    out.byte(static_cast<uint8_t>(offset));
  } else {
    out.byte(static_cast<uint8_t>(2 | (len - 1) << 2));
    out.byte(static_cast<uint8_t>(offset));
    out.byte(static_cast<uint8_t>(offset >> 8));
  }
}

void snappy_sequence(Out& out, const uint8_t* lits, int64_t lit,
                     int64_t offset, int64_t len) {
  if (lit > 0) {
    int64_t n = lit - 1;
    if (n < 60) {
      out.byte(static_cast<uint8_t>(n << 2));
    } else {
      int bytes = n < (1 << 8) ? 1 : n < (1 << 16) ? 2 : n < (1 << 24) ? 3 : 4;
      out.byte(static_cast<uint8_t>((59 + bytes) << 2));
      for (int i = 0; i < bytes; ++i) out.byte(static_cast<uint8_t>(n >> (8 * i)));
    }
    out.copy(lits, lit);
  }
  while (len >= 68) {
    snappy_copy(out, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    snappy_copy(out, offset, 60);
    len -= 60;
  }
  if (len > 0) snappy_copy(out, offset, len);
}

}  // namespace

extern "C" {

// One LZ4 block of src[0..n) into dst[0..cap); returns its size, or
// kOutputFull where it does not fit.
int64_t cf_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  Out out{dst, cap};
  greedy_matches(src, n, 65535, n - 12, n - 5,
                 [&](const uint8_t* lits, int64_t lit, int64_t offset, int64_t len) {
                   lz4_sequence(out, lits, lit, offset, len);
                 });
  return out.full ? kOutputFull : out.pos;
}

// One LZ4 block of src[0..n) as LZ4 HC finds its matches (chain_matches,
// `depth` candidates a position), as cf_lz4_compress.
int64_t cf_lz4hc_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                          int depth) {
  Out out{dst, cap};
  chain_matches(src, n, 65535, n - 12, n - 5, depth,
                [&](const uint8_t* lits, int64_t lit, int64_t offset, int64_t len) {
                  lz4_sequence(out, lits, lit, offset, len);
                });
  return out.full ? kOutputFull : out.pos;
}

// One blosclz stream of src[0..n), n > 0, as cf_lz4_compress.
int64_t cf_blosclz_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  Out out{dst, cap};
  greedy_matches(src, n, kBlosclzMaxOffset, n - 12, n - 5,
                 [&](const uint8_t* lits, int64_t lit, int64_t offset, int64_t len) {
                   blosclz_sequence(out, lits, lit, offset, len);
                 });
  return out.full ? kOutputFull : out.pos;
}

// One snappy stream of src[0..n), as cf_lz4_compress.
int64_t cf_snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  Out out{dst, cap};
  for (uint64_t length = static_cast<uint64_t>(n);; length >>= 7) {
    if (length < 0x80) {
      out.byte(static_cast<uint8_t>(length));
      break;
    }
    out.byte(static_cast<uint8_t>(length | 0x80));
  }
  greedy_matches(src, n, 65535, n - 4, n,
                 [&](const uint8_t* lits, int64_t lit, int64_t offset, int64_t len) {
                   snappy_sequence(out, lits, lit, offset, len);
                 });
  return out.full ? kOutputFull : out.pos;
}

// src[0..nbytes) bit-shuffled by `typesize` into dst: row (b, k) holds
// bit k of byte b of every element, 8 elements a byte.
void cf_bitshuffle(const uint8_t* src, uint8_t* dst, int64_t typesize,
                   int64_t nbytes) {
  int64_t count = nbytes / typesize;
  if (count % 8 != 0) {
    std::memcpy(dst, src, nbytes);
    return;
  }
  int64_t row = count / 8;
  for (int64_t m = 0; m < row; ++m) {
    for (int64_t b = 0; b < typesize; ++b) {
      uint64_t x = 0;
      for (int j = 0; j < 8; ++j) {
        x |= static_cast<uint64_t>(src[(m * 8 + j) * typesize + b]) << (8 * j);
      }
      x = transpose8(x);
      for (int k = 0; k < 8; ++k) {
        dst[(b * 8 + k) * row + m] = static_cast<uint8_t>(x >> (8 * k));
      }
    }
  }
  int64_t done = count * typesize;
  std::memcpy(dst + done, src + done, nbytes - done);
}

// The nbytes of a blosc frame, or a negative code.
int64_t cf_blosc_nbytes(const uint8_t* src, int64_t n) {
  if (n < 16) return kTruncated;
  return u32(src + 4);
}

// Decode the blosc frame in src[0..n) into dst[0..cap); returns its
// nbytes, or a negative code (cf_blosc_error names it). `inflate`
// decodes a zlib stream into a buffer of the size given and returns the
// bytes written (negative on failure).
int64_t cf_blosc_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, Inflate inflate) {
  if (n < 16) return kTruncated;
  int version = src[0], flags = src[2];
  int64_t typesize = src[3];
  int64_t nbytes = u32(src + 4), blocksize = u32(src + 8), cbytes = u32(src + 12);
  if (version < 1 || version > 4) return kUnsupported;
  if ((flags & 0x05) == 0x05) return kUnsupported;  // blosc2's long header
  if (cbytes > n || cbytes < 16) return kTruncated;
  if (nbytes > cap) return kOutputFull;
  if (flags & 0x02) {
    if (nbytes > cbytes - 16) return kTruncated;
    std::memcpy(dst, src + 16, nbytes);
    return nbytes;
  }
  if (nbytes == 0) return 0;
  // c-blosc never writes a block larger than the frame's data
  if (blocksize <= 0 || blocksize > nbytes || typesize <= 0) return kCorrupt;
  int codec = (flags >> 5) & 7;
  bool shuffle = (flags & 0x01) && typesize > 1;
  bool bitshuffle = flags & 0x04;
  bool dont_split = flags & 0x10;
  int64_t nblocks = (nbytes + blocksize - 1) / blocksize;
  int64_t leftover = nbytes % blocksize;
  if (16 + 4 * nblocks > cbytes) return kTruncated;
  std::vector<uint8_t> tmp((shuffle || bitshuffle) ? blocksize : 0);
  for (int64_t i = 0; i < nblocks; ++i) {
    bool last_short = (i == nblocks - 1) && leftover > 0;
    int64_t bsize = last_short ? leftover : blocksize;
    int64_t nstreams = (!dont_split && !last_short) ? typesize : 1;
    int64_t neblock = bsize / nstreams;
    if (neblock * nstreams != bsize) return kCorrupt;
    uint8_t* out = dst + i * blocksize;
    uint8_t* into = (shuffle || bitshuffle) ? tmp.data() : out;
    int64_t ip = u32(src + 16 + 4 * i);
    for (int64_t j = 0; j < nstreams; ++j) {
      if (ip < 16 || ip > cbytes - 4) return kTruncated;
      int64_t csize = static_cast<int32_t>(u32(src + ip));
      ip += 4;
      if (csize < 0 || csize > cbytes - ip) return kCorrupt;
      uint8_t* part = into + j * neblock;
      if (csize == neblock) {
        std::memcpy(part, src + ip, neblock);
      } else {
        int64_t got = stream(codec, src + ip, csize, part, neblock, inflate);
        if (got < 0) return got;
        if (got != neblock) return kCorrupt;
      }
      ip += csize;
    }
    if (shuffle) {
      unshuffle(into, out, typesize, bsize);
    } else if (bitshuffle) {
      int64_t count = bsize / typesize;
      if (version == 2 && count % 8 != 0) {
        std::memcpy(out, into, bsize);
      } else {
        count -= count % 8;
        bitunshuffle(into, out, typesize, count);
        int64_t done = count * typesize;
        std::memcpy(out + done, into + done, bsize - done);
      }
    }
  }
  return nbytes;
}

const char* cf_blosc_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated frame";
    case kUnsupported: return "unsupported frame version or codec";
    case kCorrupt: return "corrupt frame";
    case kOutputFull: return "decoded data larger than the output";
    case kCodec: return "a stream's codec failed";
    default: return "unknown error";
  }
}

}  // extern "C"
