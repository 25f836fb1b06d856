// Blosc1 frames, decode only, and the LZ4 block encoder of the frames the
// port writes.
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
// cf_lz4_compress writes one LZ4 block: greedy matches found by a hash of
// 4-byte sequences, at most 65535 back, extended backwards over the
// literals before them, stepping ever faster through literals; no match
// starts in the last 12 bytes and the last 5 are literals, as the block
// format sets. volume/blosc.py:lz4_compress_plain gives the same bytes.
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

// The bit-transposed rows (byte b, bit k) of `count` elements, a multiple
// of 8, back into elements.
void bitunshuffle(const uint8_t* src, uint8_t* dst, int64_t typesize,
                  int64_t count) {
  int64_t row = count / 8;
  std::memset(dst, 0, count * typesize);
  for (int64_t b = 0; b < typesize; ++b) {
    for (int k = 0; k < 8; ++k) {
      const uint8_t* bits = src + (b * 8 + k) * row;
      for (int64_t m = 0; m < row; ++m) {
        uint8_t byte = bits[m];
        if (!byte) continue;
        for (int j = 0; j < 8; ++j) {
          dst[(m * 8 + j) * typesize + b] |=
              static_cast<uint8_t>(((byte >> j) & 1) << k);
        }
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

constexpr int kLz4HashLog = 16;
constexpr int64_t kLz4MaxOffset = 65535;
constexpr int64_t kLz4LastLiterals = 5;
constexpr int64_t kLz4MatchLimit = 12;  // no match starts in the last 12 bytes
constexpr int kLz4Skip = 6;

inline uint32_t lz4_hash(const uint8_t* p) {
  uint32_t word;
  std::memcpy(&word, p, 4);
  return (word * 2654435761u) >> (32 - kLz4HashLog);
}

struct Lz4Out {
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
  void length(int64_t extra) {  // a length's bytes past its token's 15
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
  // literals src[0..lit), then (where len > 0) a match of len at offset
  void sequence(const uint8_t* src, int64_t lit, int64_t offset, int64_t len) {
    int64_t ml = len > 0 ? len - 4 : 0;
    byte(static_cast<uint8_t>((lit < 15 ? lit : 15) << 4 | (ml < 15 ? ml : 15)));
    if (lit >= 15) length(lit - 15);
    copy(src, lit);
    if (len <= 0) return;
    byte(static_cast<uint8_t>(offset));
    byte(static_cast<uint8_t>(offset >> 8));
    if (ml >= 15) length(ml - 15);
  }
};

}  // namespace

extern "C" {

// One LZ4 block of src[0..n) into dst[0..cap); returns its size, or
// kOutputFull where it does not fit.
int64_t cf_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  Lz4Out out{dst, cap};
  std::vector<int64_t> table(static_cast<size_t>(1) << kLz4HashLog, -1);
  int64_t ip = 0, anchor = 0;
  int64_t last = n - kLz4MatchLimit, limit = n - kLz4LastLiterals;
  while (ip <= last) {
    uint32_t h = lz4_hash(src + ip);
    int64_t cand = table[h];
    table[h] = ip;
    if (cand < 0 || ip - cand > kLz4MaxOffset || std::memcmp(src + cand, src + ip, 4) != 0) {
      ip += 1 + ((ip - anchor) >> kLz4Skip);
      continue;
    }
    while (ip > anchor && cand > 0 && src[ip - 1] == src[cand - 1]) {
      ip -= 1;
      cand -= 1;
    }
    int64_t len = 4;
    while (ip + len < limit && src[cand + len] == src[ip + len]) len++;
    out.sequence(src + anchor, ip - anchor, ip - cand, len);
    ip += len;
    anchor = ip;
    if (ip - 2 <= n - 4) table[lz4_hash(src + ip - 2)] = ip - 2;
  }
  out.sequence(src + anchor, n - anchor, 0, 0);
  return out.full ? kOutputFull : out.pos;
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
