// Zstandard frames (RFC 8878): an encoder and a decoder.
//
// cf_zstd_decompress decodes a run of frames (zstd frames and skippable
// frames) into a buffer of the size given: raw, RLE and compressed
// blocks; Huffman literals with direct or FSE-compressed weights,
// treeless literals, one or four streams; FSE sequences in predefined,
// RLE, compressed and repeat modes, with the three repeat offsets; the
// XXH64 content checksum, verified. A frame that names a dictionary is
// refused. Every read is checked against the input and every write
// against the output: a malformed frame returns a negative code and
// touches nothing outside its buffers. volume/zstd.py:decompress_plain
// is the same algorithm in Python.
//
// cf_zstd_compress writes one frame at a level: the content size, a
// window that bounds every match (single-segment where the content fits
// it), blocks of up to 128 KB (RLE, raw where compressing would not make
// a block smaller, else compressed), the XXH64 checksum. Matches come
// from a hash table of 4-byte sequences, chained and searched deeper and
// lazily as the level rises (kLevels); literals are Huffman-coded where
// that is smaller, each sequence code predefined, RLE or FSE-compressed,
// whichever takes fewer bits. volume/zstd.py:compress_plain is the same
// algorithm in Python and gives the same bytes.
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <utility>
#include <vector>

namespace {

enum Error : int64_t {
  kTruncated = -1,
  kBadMagic = -2,
  kDictionary = -3,
  kReserved = -4,
  kCorrupt = -5,
  kOutputFull = -6,
  kChecksum = -7,
  kSizeMismatch = -8,
  kFrameFull = -9,
  kNoMemory = -10,
};

constexpr int kMaxBlock = 128 * 1024;

struct Fail {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Fail{code}; }

inline uint64_t load_le(const uint8_t* p, int64_t n) {
  uint64_t v = 0;
  if (n >= 8) {
    std::memcpy(&v, p, 8);  // x86-64 and aarch64 hosts: little-endian
    return v;
  }
  for (int64_t i = n - 1; i >= 0; --i) v = (v << 8) | p[i];
  return v;
}

inline int highbit(uint32_t x) { return 31 - __builtin_clz(x); }

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, int64_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xround(v1, load_le(p, 8));
      v2 = xround(v2, load_le(p + 8, 8));
      v3 = xround(v3, load_le(p + 16, 8));
      v4 = xround(v4, load_le(p + 24, 8));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += static_cast<uint64_t>(n);
  while (end - p >= 8) {
    h ^= xround(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= load_le(p, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------- bit readers
// Little-endian bits read forward; bits past the end read as zeros, and
// byte_end() fails if any was used.
struct Forward {
  const uint8_t* data;
  int64_t bit, end;  // in bits from data
  uint32_t read(int n) {
    int64_t byte = bit >> 3;
    int64_t avail = (end >> 3) - byte;
    uint64_t v = avail > 0 ? load_le(data + byte, avail < 8 ? avail : 8) : 0;
    uint32_t value = static_cast<uint32_t>((v >> (bit & 7)) & ((1u << n) - 1));
    bit += n;
    return value;
  }
  int64_t byte_end() const {
    if (bit > end) fail(kCorrupt);
    return (bit + 7) >> 3;
  }
};

// A backward bitstream: read from its last byte down, after the padding
// that ends at the last byte's highest set bit; the first bit read is the
// most significant. Reading past the start gives zero bits and drives
// `bits` negative.
struct Backward {
  const uint8_t* data;
  int64_t len;
  int64_t bits;
  Backward(const uint8_t* p, int64_t n) : data(p), len(n) {
    if (n <= 0) fail(kCorrupt);
    uint8_t last = p[n - 1];
    if (last == 0) fail(kCorrupt);
    bits = (n - 1) * 8 + highbit(last);
  }
  inline uint64_t read(int n) {
    if (n == 0) return 0;
    bits -= n;
    if (bits >= 0) {
      int64_t byte = bits >> 3;
      int64_t avail = len - byte;
      uint64_t v = load_le(data + byte, avail < 8 ? avail : 8);
      return (v >> (bits & 7)) & ((1ULL << n) - 1);
    }
    int64_t have = bits + n;
    if (have <= 0) return 0;
    uint64_t v = load_le(data, len < 8 ? len : 8);
    return (v & ((1ULL << have) - 1)) << (-bits);
  }
};

// --------------------------------------------------------------- FSE
struct Fse {
  int log = 0;
  uint16_t symbol[512];
  uint8_t nbits[512];
  uint16_t base[512];

  void build(const int16_t* norm, int count, int accuracy) {
    int size = 1 << accuracy;
    int high = size;
    uint16_t desc[256];
    for (int s = 0; s < count; ++s) {
      if (norm[s] == -1) {
        symbol[--high] = static_cast<uint16_t>(s);
        desc[s] = 1;
      }
    }
    int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < count; ++s) {
      if (norm[s] <= 0) continue;
      desc[s] = static_cast<uint16_t>(norm[s]);
      for (int i = 0; i < norm[s]; ++i) {
        symbol[pos] = static_cast<uint16_t>(s);
        do {
          pos = (pos + step) & mask;
        } while (pos >= high);
      }
    }
    if (pos != 0) fail(kCorrupt);
    for (int i = 0; i < size; ++i) {
      uint16_t next = desc[symbol[i]]++;
      int nb = accuracy - highbit(next);
      nbits[i] = static_cast<uint8_t>(nb);
      base[i] = static_cast<uint16_t>((next << nb) - size);
    }
    log = accuracy;
  }

  void rle(int s) {
    log = 0;
    symbol[0] = static_cast<uint16_t>(s);
    nbits[0] = 0;
    base[0] = 0;
  }

  // The table described at p[0..n); returns the bytes it took.
  int64_t read(const uint8_t* p, int64_t n, int max_log, int max_symbol) {
    Forward bits{p, 0, n * 8};
    int accuracy = static_cast<int>(bits.read(4)) + 5;
    if (accuracy > max_log) fail(kCorrupt);
    int remaining = 1 << accuracy;
    int16_t norm[256];
    int count = 0;
    while (remaining > 0 && count <= max_symbol) {
      int nb = highbit(remaining + 1) + 1;
      uint32_t low_mask = (1u << (nb - 1)) - 1;
      uint32_t threshold = (1u << nb) - 1 - (remaining + 1);
      uint32_t val = bits.read(nb);
      if ((val & low_mask) < threshold) {
        bits.bit -= 1;
        val &= low_mask;
      } else if (val > low_mask) {
        val -= threshold;
      }
      int prob = static_cast<int>(val) - 1;
      remaining -= prob < 0 ? -prob : prob;
      norm[count++] = static_cast<int16_t>(prob);
      if (prob == 0) {
        while (true) {
          int repeat = static_cast<int>(bits.read(2));
          for (int i = 0; i < repeat; ++i) {
            if (count > max_symbol) fail(kCorrupt);
            norm[count++] = 0;
          }
          if (repeat != 3) break;
        }
      }
    }
    if (remaining != 0 || count > max_symbol + 1) fail(kCorrupt);
    int64_t used = bits.byte_end();
    build(norm, count, accuracy);
    return used;
  }
};

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {0,    1,    2,     3,     4,     5,    6,    7,
                              8,    9,    10,    11,    12,    13,   14,   15,
                              16,   18,   20,    22,    24,    28,   32,   40,
                              48,   64,   128,   256,   512,   1024, 2048, 4096,
                              8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// ------------------------------------------------------------ Huffman
struct Huffman {
  int max_bits = 0;
  uint8_t symbol[1 << 11];
  uint8_t nbits[1 << 11];

  void build(const uint8_t* weights, int count) {
    uint32_t total = 0;
    for (int i = 0; i < count; ++i) {
      if (weights[i] > 11) fail(kCorrupt);
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) fail(kCorrupt);
    max_bits = highbit(total) + 1;
    uint32_t left = (1u << max_bits) - total;
    if (left & (left - 1)) fail(kCorrupt);
    if (max_bits > 11 || count >= 256) fail(kCorrupt);
    uint8_t bits[256];
    int symbols = count + 1;
    for (int i = 0; i < count; ++i)
      bits[i] = weights[i] ? static_cast<uint8_t>(max_bits + 1 - weights[i]) : 0;
    bits[count] = static_cast<uint8_t>(max_bits + 1 - (highbit(left) + 1));
    int counts[13] = {0};
    for (int s = 0; s < symbols; ++s) counts[bits[s]]++;
    int start[13] = {0};
    for (int b = max_bits; b >= 1; --b) {
      start[b - 1] = start[b] + counts[b] * (1 << (max_bits - b));
      for (int i = start[b]; i < start[b - 1]; ++i) nbits[i] = static_cast<uint8_t>(b);
    }
    for (int s = 0; s < symbols; ++s) {
      if (!bits[s]) continue;
      int span = 1 << (max_bits - bits[s]);
      std::memset(symbol + start[bits[s]], s, span);
      start[bits[s]] += span;
    }
  }

  // The tree described at p[0..n); returns the bytes it took.
  int64_t read(const uint8_t* p, int64_t n) {
    if (n < 1) fail(kTruncated);
    int header = p[0];
    uint8_t weights[256];
    int count = 0;
    if (header >= 128) {
      count = header - 127;
      int64_t nbytes = (count + 1) / 2;
      if (1 + nbytes > n) fail(kTruncated);
      for (int i = 0; i < count; ++i) {
        uint8_t byte = p[1 + i / 2];
        weights[i] = (i % 2 == 0) ? byte >> 4 : byte & 15;
      }
      build(weights, count);
      return 1 + nbytes;
    }
    if (header == 0 || 1 + header > n) fail(kTruncated);
    Fse table;
    int64_t used = table.read(p + 1, header, 6, 255);
    Backward stream(p + 1 + used, header - used);
    uint32_t state[2];
    state[0] = static_cast<uint32_t>(stream.read(table.log));
    state[1] = static_cast<uint32_t>(stream.read(table.log));
    int turn = 0;
    while (true) {
      if (count >= 255) fail(kCorrupt);
      uint32_t st = state[turn];
      weights[count++] = static_cast<uint8_t>(table.symbol[st]);
      state[turn] = table.base[st] + static_cast<uint32_t>(stream.read(table.nbits[st]));
      if (stream.bits < 0) {
        if (count >= 255) fail(kCorrupt);
        weights[count++] = static_cast<uint8_t>(table.symbol[state[1 - turn]]);
        break;
      }
      turn = 1 - turn;
    }
    build(weights, count);
    return 1 + header;
  }

  void decode(const uint8_t* p, int64_t n, uint8_t* out, int64_t count) const {
    Backward stream(p, n);
    uint32_t mask = (1u << max_bits) - 1;
    uint32_t state = static_cast<uint32_t>(stream.read(max_bits));
    for (int64_t i = 0; i < count; ++i) {
      out[i] = symbol[state];
      int nb = nbits[state];
      state = ((state << nb) | static_cast<uint32_t>(stream.read(nb))) & mask;
    }
    if (stream.bits != -max_bits) fail(kCorrupt);
  }
};

struct FrameState {
  bool has_huffman = false;
  Huffman huffman;
  Fse ll, of, ml;
  bool has_ll = false, has_of = false, has_ml = false;
  uint32_t reps[3] = {1, 4, 8};
  std::vector<uint8_t> literals = std::vector<uint8_t>(kMaxBlock);
};

// The literals section at p[0..n) into st.literals; returns the bytes it
// took and sets `count`.
int64_t literals(const uint8_t* p, int64_t n, FrameState& st, int64_t& count) {
  if (n < 1) fail(kTruncated);
  int kind = p[0] & 3, fmt = (p[0] >> 2) & 3;
  if (kind < 2) {
    int64_t size, pos;
    if (fmt == 0 || fmt == 2) {
      size = p[0] >> 3;
      pos = 1;
    } else if (fmt == 1) {
      if (n < 2) fail(kTruncated);
      size = (p[0] >> 4) + (p[1] << 4);
      pos = 2;
    } else {
      if (n < 3) fail(kTruncated);
      size = (p[0] >> 4) + (p[1] << 4) + (static_cast<int64_t>(p[2]) << 12);
      pos = 3;
    }
    if (size > kMaxBlock) fail(kCorrupt);
    count = size;
    if (kind == 0) {
      if (pos + size > n) fail(kTruncated);
      std::memcpy(st.literals.data(), p + pos, size);
      return pos + size;
    }
    if (pos + 1 > n) fail(kTruncated);
    std::memset(st.literals.data(), p[pos], size);
    return pos + 1;
  }
  static const int kLength[4] = {3, 3, 4, 5};
  static const int kWidth[4] = {10, 10, 14, 18};
  int length = kLength[fmt], width = kWidth[fmt];
  if (n < length) fail(kTruncated);
  uint64_t v = load_le(p, length);
  int64_t regen = (v >> 4) & ((1u << width) - 1);
  int64_t comp = (v >> (4 + width)) & ((1u << width) - 1);
  if (regen > kMaxBlock) fail(kCorrupt);
  int64_t pos = length;
  if (pos + comp > n) fail(kTruncated);
  int64_t stop = pos + comp;
  if (kind == 2) {
    pos += st.huffman.read(p + pos, stop - pos);
    st.has_huffman = true;
  } else if (!st.has_huffman) {
    fail(kCorrupt);
  }
  count = regen;
  uint8_t* out = st.literals.data();
  if (fmt == 0) {
    st.huffman.decode(p + pos, stop - pos, out, regen);
    return stop;
  }
  if (pos + 6 > stop) fail(kTruncated);
  int64_t sizes[4];
  sizes[0] = load_le(p + pos, 2);
  sizes[1] = load_le(p + pos + 2, 2);
  sizes[2] = load_le(p + pos + 4, 2);
  pos += 6;
  sizes[3] = stop - pos - sizes[0] - sizes[1] - sizes[2];
  if (sizes[3] < 0) fail(kCorrupt);
  int64_t each = (regen + 3) / 4;
  int64_t counts[4] = {each, each, each, regen - 3 * each};
  if (counts[3] < 0) fail(kCorrupt);
  for (int i = 0; i < 4; ++i) {
    st.huffman.decode(p + pos, sizes[i], out, counts[i]);
    pos += sizes[i];
    out += counts[i];
  }
  return stop;
}

struct Output {
  uint8_t* dst;
  int64_t cap, pos, frame_start;
  inline void put(const uint8_t* src, int64_t n) {
    if (n > cap - pos) fail(kOutputFull);
    std::memcpy(dst + pos, src, n);
    pos += n;
  }
  inline void match(int64_t offset, int64_t length) {
    if (offset > pos - frame_start || offset <= 0) fail(kCorrupt);
    if (length > cap - pos) fail(kOutputFull);
    uint8_t* out = dst + pos;
    const uint8_t* from = out - offset;
    if (offset >= length) {
      std::memcpy(out, from, length);
    } else {
      for (int64_t k = 0; k < length; ++k) out[k] = from[k];
    }
    pos += length;
  }
};

void table_for(Fse& table, bool& has, int mode, const uint8_t* p, int64_t n,
               int64_t& pos, const int16_t* deflt, int dcount, int dlog,
               int max_log, int max_symbol) {
  if (mode == 0) {
    table.build(deflt, dcount, dlog);
  } else if (mode == 1) {
    if (pos >= n) fail(kTruncated);
    if (p[pos] > max_symbol) fail(kCorrupt);
    table.rle(p[pos]);
    pos += 1;
  } else if (mode == 2) {
    pos += table.read(p + pos, n - pos, max_log, max_symbol);
  } else if (!has) {
    fail(kCorrupt);
  }
  has = true;
}

void block(const uint8_t* p, int64_t n, FrameState& st, Output& out) {
  int64_t lit_count = 0;
  int64_t pos = literals(p, n, st, lit_count);
  const uint8_t* lits = st.literals.data();
  if (pos >= n) fail(kTruncated);
  int64_t count;
  int b0 = p[pos];
  if (b0 < 128) {
    count = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > n) fail(kTruncated);
    count = ((b0 - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail(kTruncated);
    count = p[pos + 1] + (p[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (count == 0) {
    if (pos != n) fail(kCorrupt);
    out.put(lits, lit_count);
    return;
  }
  if (pos >= n) fail(kTruncated);
  int modes = p[pos++];
  if (modes & 3) fail(kReserved);
  table_for(st.ll, st.has_ll, (modes >> 6) & 3, p, n, pos, kLLDefault, 36, 6, 9, 35);
  table_for(st.of, st.has_of, (modes >> 4) & 3, p, n, pos, kOFDefault, 29, 5, 8, 31);
  table_for(st.ml, st.has_ml, (modes >> 2) & 3, p, n, pos, kMLDefault, 53, 6, 9, 52);
  Backward stream(p + pos, n - pos);
  uint32_t ll_s = static_cast<uint32_t>(stream.read(st.ll.log));
  uint32_t of_s = static_cast<uint32_t>(stream.read(st.of.log));
  uint32_t ml_s = static_cast<uint32_t>(stream.read(st.ml.log));
  uint32_t* reps = st.reps;
  int64_t lit = 0;
  for (int64_t i = 0; i < count; ++i) {
    uint32_t of_code = st.of.symbol[of_s];
    uint32_t ll_code = st.ll.symbol[ll_s];
    uint32_t ml_code = st.ml.symbol[ml_s];
    if (of_code > 31 || ll_code > 35 || ml_code > 52) fail(kCorrupt);
    uint64_t value = (1ULL << of_code) + stream.read(static_cast<int>(of_code));
    int64_t ml = kMLBase[ml_code] + stream.read(kMLBits[ml_code]);
    int64_t ll = kLLBase[ll_code] + stream.read(kLLBits[ll_code]);
    uint64_t offset;
    if (value > 3) {
      offset = value - 3;
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = static_cast<uint32_t>(offset);
      if (offset > 0xFFFFFFFFULL) fail(kCorrupt);
    } else {
      uint32_t idx = static_cast<uint32_t>(value - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = reps[0];
      } else {
        offset = idx < 3 ? reps[idx] : static_cast<uint64_t>(reps[0]) - 1;
        if (offset == 0) fail(kCorrupt);
        if (idx > 1) reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = static_cast<uint32_t>(offset);
      }
    }
    if (i + 1 < count) {
      ll_s = st.ll.base[ll_s] + static_cast<uint32_t>(stream.read(st.ll.nbits[ll_s]));
      ml_s = st.ml.base[ml_s] + static_cast<uint32_t>(stream.read(st.ml.nbits[ml_s]));
      of_s = st.of.base[of_s] + static_cast<uint32_t>(stream.read(st.of.nbits[of_s]));
    }
    if (stream.bits < 0) fail(kCorrupt);
    if (ll > lit_count - lit) fail(kCorrupt);
    out.put(lits + lit, ll);
    lit += ll;
    out.match(static_cast<int64_t>(offset), ml);
  }
  if (stream.bits != 0) fail(kCorrupt);
  out.put(lits + lit, lit_count - lit);
}

int64_t frames(const uint8_t* src, int64_t n, Output& out) {
  if (n == 0) fail(kTruncated);
  int64_t pos = 0;
  FrameState st;
  while (pos < n) {
    if (n - pos < 4) fail(kTruncated);
    uint32_t magic = static_cast<uint32_t>(load_le(src + pos, 4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) fail(kTruncated);
      int64_t skip = static_cast<int64_t>(load_le(src + pos + 4, 4));
      if (skip > n - pos - 8) fail(kTruncated);
      pos += 8 + skip;
      continue;
    }
    if (magic != 0xFD2FB528u) fail(kBadMagic);
    if (n - pos < 5) fail(kTruncated);
    int fhd = src[pos + 4];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1;
    if (fhd & 0x08) fail(kReserved);
    int checksum = (fhd >> 2) & 1;
    static const int kDid[4] = {0, 1, 2, 4};
    int did_size = kDid[fhd & 3];
    int fcs_size = fcs_flag == 0 ? single : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
    int64_t p = pos + 5;
    uint64_t window = 0;
    if (!single) {
      if (p >= n) fail(kTruncated);
      int wd = src[p++];
      uint64_t base = 1ULL << (10 + (wd >> 3));
      window = base + (base >> 3) * (wd & 7);
    }
    if (p + did_size + fcs_size > n) fail(kTruncated);
    if (did_size && load_le(src + p, did_size) != 0) fail(kDictionary);
    p += did_size;
    bool has_size = fcs_size > 0;
    uint64_t size = has_size ? load_le(src + p, fcs_size) : 0;
    if (fcs_size == 2) size += 256;
    p += fcs_size;
    if (single) window = size;
    int64_t block_max = (window && window < static_cast<uint64_t>(kMaxBlock))
                            ? static_cast<int64_t>(window) : kMaxBlock;
    pos = p;
    out.frame_start = out.pos;
    st.has_huffman = st.has_ll = st.has_of = st.has_ml = false;
    st.reps[0] = 1;
    st.reps[1] = 4;
    st.reps[2] = 8;
    while (true) {
      if (n - pos < 3) fail(kTruncated);
      uint32_t bh = static_cast<uint32_t>(load_le(src + pos, 3));
      int last = bh & 1, kind = (bh >> 1) & 3;
      int64_t bsize = bh >> 3;
      pos += 3;
      if (kind == 3) fail(kReserved);
      if (bsize > block_max) fail(kCorrupt);
      if (kind == 1) {
        if (pos >= n) fail(kTruncated);
        if (bsize > out.cap - out.pos) fail(kOutputFull);
        std::memset(out.dst + out.pos, src[pos], bsize);
        out.pos += bsize;
        pos += 1;
      } else {
        if (bsize > n - pos) fail(kTruncated);
        if (kind == 0) {
          out.put(src + pos, bsize);
        } else {
          block(src + pos, bsize, st, out);
        }
        pos += bsize;
      }
      if (last) break;
    }
    if (has_size && static_cast<uint64_t>(out.pos - out.frame_start) != size)
      fail(kSizeMismatch);
    if (checksum) {
      if (n - pos < 4) fail(kTruncated);
      uint32_t want = static_cast<uint32_t>(load_le(src + pos, 4));
      uint64_t got = xxh64(out.dst + out.frame_start, out.pos - out.frame_start);
      if (static_cast<uint32_t>(got) != want) fail(kChecksum);
      pos += 4;
    }
  }
  return out.pos;
}

// -------------------------------------------------------------- encoder
// volume/zstd.py:LEVELS: from the lowest level up, the last level of each
// row and its search.
struct Params {
  int window_log, hash_log, depth, lazy, skip;
};
const std::pair<int, Params> kLevels[8] = {
    {1, {19, 16, 1, 0, 8}},   {2, {20, 16, 2, 0, 8}},
    {3, {21, 17, 3, 0, 8}},   {4, {21, 17, 6, 0, 10}},
    {6, {21, 17, 8, 1, 8}},   {9, {22, 18, 16, 1, 9}},
    {15, {22, 18, 32, 1, 10}}, {22, {23, 19, 64, 1, 11}}};
constexpr int kMinMatch = 4;
// a match at a new offset is at least this long (volume/zstd.py
// _HASH_MIN_MATCH)
constexpr int64_t kHashMinMatch = 5;
constexpr int64_t kInsertEnds = 16;  // positions a match inserts at each end
constexpr int kHuffmanMaxBits = 11;

Params params(int level) {
  if (level == 0) level = 3;
  if (level < 1) {
    Params p = kLevels[0].second;
    p.skip = std::max(1, 8 + level);
    return p;
  }
  for (const auto& row : kLevels)
    if (level <= row.first) return row.second;
  return kLevels[7].second;
}

// Bits appended from the least significant; finish() adds the end mark a
// backward bitstream's reader looks for.
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int count = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void add(uint64_t value, int nbits) {
    acc |= value << count;
    count += nbits;
    while (count >= 8) {
      out.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      count -= 8;
    }
  }
  void flush() {
    if (count) out.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    count = 0;
  }
  void finish() {
    add(1, 1);
    flush();
  }
};

// An FSE table and its encoder: the state of a symbol whose next-state
// range holds a given state. An RLE table has log 0 and writes nothing.
struct FseEncoder {
  Fse table;
  bool rle = false;
  int16_t norm[256];
  uint16_t first[257];  // the symbol's states, ascending, in order[]
  uint16_t order[512];

  void build(const int16_t* n, int count, int log) {
    rle = false;
    table.build(n, count, log);
    std::memcpy(norm, n, count * sizeof(int16_t));
    int size = 1 << log;
    std::memset(first, 0, sizeof(first));
    for (int i = 0; i < size; ++i) first[table.symbol[i] + 1]++;
    for (int s = 0; s < 256; ++s) first[s + 1] += first[s];
    uint16_t fill[256];
    std::memcpy(fill, first, sizeof(fill));
    for (int i = 0; i < size; ++i) order[fill[table.symbol[i]]++] = static_cast<uint16_t>(i);
  }
  void make_rle() {
    rle = true;
    table.log = 0;
  }
  int log() const { return table.log; }
  // The state of `symbol` that leads to `state`; sets the bits and their
  // count.
  inline uint32_t encode(int symbol, uint32_t state, uint32_t& bits, int& nbits) const {
    if (rle) {
      bits = 0;
      nbits = 0;
      return 0;
    }
    int count = norm[symbol] > 0 ? norm[symbol] : 1;
    uint32_t value = state + (1u << table.log);
    int nb = table.log - highbit(static_cast<uint32_t>(count)) - 1;
    if (nb < 0 || static_cast<int64_t>(value >> nb) >= 2 * count) nb += 1;
    uint32_t i = order[first[symbol] + (value >> nb) - count];
    bits = state - table.base[i];
    nbits = nb;
    return i;
  }
  // The first state of `symbol`: the one with the most bits.
  uint32_t start(int symbol) const { return rle ? 0 : order[first[symbol]]; }
};

int table_log(int max_log, int64_t total, int max_symbol) {
  int log = std::min(max_log, highbit(static_cast<uint32_t>(total - 1)) - 2);
  log = std::max(log, std::min(highbit(static_cast<uint32_t>(total)) + 1,
                               highbit(static_cast<uint32_t>(max_symbol)) + 2));
  return std::max(5, std::min(log, max_log));
}

// `counts` as a distribution over 1 << log states (volume/zstd.py
// _normalize).
void normalize(const int64_t* counts, int n, int64_t total, int log, int16_t* norm) {
  int64_t size = 1LL << log, low = total >> log, remaining = size;
  for (int s = 0; s < n; ++s) {
    norm[s] = 0;
    int64_t c = counts[s];
    if (!c) continue;
    if (c <= low) {
      norm[s] = -1;
      remaining -= 1;
      continue;
    }
    int64_t p = c * size / total;
    if (2 * (c * size - p * total) >= total) p += 1;
    norm[s] = static_cast<int16_t>(std::max<int64_t>(p, 1));
    remaining -= norm[s];
  }
  auto largest = [&]() {
    int best = 0;
    for (int k = 1; k < n; ++k)
      if (norm[k] > norm[best]) best = k;
    return best;
  };
  while (remaining < 0) {
    norm[largest()] -= 1;
    remaining += 1;
  }
  if (remaining) norm[largest()] += static_cast<int16_t>(remaining);
}

// The table description Fse::read reads.
void write_ncount(const int16_t* norm, int log, std::vector<uint8_t>& out) {
  BitWriter w(out);
  w.add(log - 5, 4);
  int remaining = 1 << log, s = 0;
  while (remaining > 0) {
    int prob = norm[s];
    int nb = highbit(remaining + 1) + 1;
    int low = (1 << (nb - 1)) - 1;
    int threshold = (1 << nb) - 1 - (remaining + 1);
    int v = prob + 1;
    if (v < threshold) {
      w.add(v, nb - 1);
    } else if (v <= low) {
      w.add(v, nb);
    } else {
      w.add(v + threshold, nb);
    }
    remaining -= prob < 0 ? -prob : prob;
    s += 1;
    if (prob == 0) {
      int zeros = 0;
      while (norm[s + zeros] == 0) zeros++;
      s += zeros;
      while (zeros >= 3) {
        w.add(3, 2);
        zeros -= 3;
      }
      w.add(zeros, 2);
    }
  }
  w.flush();
}

// Code lengths of at most kHuffmanMaxBits bits, a complete code, for the
// symbols with a count.
void huffman_lengths(const int64_t* counts, uint8_t* lengths) {
  std::pair<int64_t, int> order[256];
  int n = 0;
  for (int s = 0; s < 256; ++s)
    if (counts[s]) order[n++] = {counts[s], s};
  std::sort(order, order + n);
  int64_t weight[511];
  int parent[511], depth[511];
  for (int i = 0; i < n; ++i) weight[i] = order[i].first;
  int leaf = 0, inner = n;
  for (int node = n; node < 2 * n - 1; ++node) {
    int pair[2];
    for (int j = 0; j < 2; ++j) {
      if (leaf < n && (inner >= node || weight[leaf] <= weight[inner])) {
        pair[j] = leaf++;
      } else {
        pair[j] = inner++;
      }
    }
    weight[node] = weight[pair[0]] + weight[pair[1]];
    parent[pair[0]] = parent[pair[1]] = node;
  }
  depth[2 * n - 2] = 0;
  for (int k = 2 * n - 3; k >= 0; --k) depth[k] = depth[parent[k]] + 1;
  const int limit = kHuffmanMaxBits;
  int bits[256];
  int64_t kraft = 0;
  for (int i = 0; i < n; ++i) {
    bits[i] = std::min(depth[i], limit);
    kraft += 1LL << (limit - bits[i]);
  }
  while (kraft > (1LL << limit)) {
    int k = -1;
    for (int i = 0; i < n; ++i)
      if (bits[i] < limit && (k < 0 || bits[i] > bits[k])) k = i;
    kraft -= 1LL << (limit - bits[k] - 1);
    bits[k] += 1;
  }
  while (kraft < (1LL << limit)) {
    for (int k = n - 1; k >= 0; --k) {
      if (bits[k] > 1 && kraft + (1LL << (limit - bits[k])) <= (1LL << limit)) {
        kraft += 1LL << (limit - bits[k]);
        bits[k] -= 1;
        break;
      }
    }
  }
  std::memset(lengths, 0, 256);
  for (int i = 0; i < n; ++i) lengths[order[i].second] = static_cast<uint8_t>(bits[i]);
}

// Huffman weights FSE-compressed (two interleaved states); false where
// that cannot be written.
bool fse_weights(const uint8_t* weights, int n, std::vector<uint8_t>& out) {
  int64_t counts[12] = {0};
  int top = 0, distinct = 0;
  for (int i = 0; i < n; ++i) {
    counts[weights[i]]++;
    top = std::max<int>(top, weights[i]);
  }
  for (int64_t c : counts) distinct += c > 0;
  if (n < 2 || distinct < 2) return false;
  int log = table_log(6, n, top);
  int16_t norm[12];
  normalize(counts, top + 1, n, log, norm);
  FseEncoder table;
  table.build(norm, top + 1, log);
  std::vector<uint8_t> body;
  write_ncount(norm, log, body);
  BitWriter w(body);
  std::vector<uint32_t> states(n);
  states[n - 1] = table.start(weights[n - 1]);
  states[n - 2] = table.start(weights[n - 2]);
  for (int k = n - 3; k >= 0; --k) {
    uint32_t bits;
    int nbits;
    states[k] = table.encode(weights[k], states[k + 2], bits, nbits);
    w.add(bits, nbits);
  }
  w.add(states[1], log);
  w.add(states[0], log);
  w.finish();
  if (body.size() >= 128) return false;
  out.clear();
  out.push_back(static_cast<uint8_t>(body.size()));
  out.insert(out.end(), body.begin(), body.end());
  return true;
}

void literals_header(int kind, int64_t size, std::vector<uint8_t>& out) {
  if (size < 32) {
    out.push_back(static_cast<uint8_t>(kind | size << 3));
  } else if (size < 4096) {
    uint32_t v = static_cast<uint32_t>(kind | 1 << 2 | size << 4);
    out.push_back(v & 0xFF);
    out.push_back(v >> 8);
  } else {
    uint32_t v = static_cast<uint32_t>(kind | 3 << 2 | size << 4);
    out.push_back(v & 0xFF);
    out.push_back((v >> 8) & 0xFF);
    out.push_back(v >> 16);
  }
}

bool huffman_literals(const uint8_t* lits, int64_t n, std::vector<uint8_t>& out) {
  int64_t counts[256] = {0};
  for (int64_t i = 0; i < n; ++i) counts[lits[i]]++;
  uint8_t lengths[256];
  huffman_lengths(counts, lengths);
  int max_bits = 0, last = 0;
  for (int s = 0; s < 256; ++s) {
    max_bits = std::max<int>(max_bits, lengths[s]);
    if (counts[s]) last = s;
  }
  uint8_t weights[256];
  for (int s = 0; s < last; ++s)
    weights[s] = lengths[s] ? static_cast<uint8_t>(max_bits + 1 - lengths[s]) : 0;
  std::vector<uint8_t> tree;
  bool have = fse_weights(weights, last, tree);
  if (last <= 128) {
    std::vector<uint8_t> direct;
    direct.push_back(static_cast<uint8_t>(127 + last));
    for (int i = 0; i < last; i += 2)
      direct.push_back(static_cast<uint8_t>(weights[i] << 4 | (i + 1 < last ? weights[i + 1] : 0)));
    if (!have || direct.size() <= tree.size()) {
      tree = direct;
      have = true;
    }
  }
  if (!have) return false;
  int per_length[kHuffmanMaxBits + 1] = {0};
  for (int s = 0; s < 256; ++s)
    if (lengths[s]) per_length[lengths[s]]++;
  uint32_t start[kHuffmanMaxBits + 1] = {0};
  for (int b = max_bits; b >= 1; --b)
    start[b - 1] = start[b] + per_length[b] * (1u << (max_bits - b));
  uint32_t codes[256] = {0};
  for (int s = 0; s < 256; ++s) {
    int b = lengths[s];
    if (!b) continue;
    codes[s] = start[b] >> (max_bits - b);
    start[b] += 1u << (max_bits - b);
  }
  int64_t bounds[5] = {0, n, n, n, n};
  int parts = 1;
  if (n >= 1024) {
    int64_t each = (n + 3) / 4;
    parts = 4;
    bounds[1] = each;
    bounds[2] = 2 * each;
    bounds[3] = 3 * each;
  }
  std::vector<uint8_t> body(tree);
  size_t jump = body.size();
  if (parts == 4) body.resize(body.size() + 6);
  for (int p = 0; p < parts; ++p) {
    size_t before = body.size();
    BitWriter w(body);
    for (int64_t i = bounds[p + 1] - 1; i >= bounds[p]; --i) w.add(codes[lits[i]], lengths[lits[i]]);
    w.finish();
    if (parts == 4 && p < 3) {
      size_t size = body.size() - before;
      body[jump + 2 * p] = static_cast<uint8_t>(size);
      body[jump + 2 * p + 1] = static_cast<uint8_t>(size >> 8);
    }
  }
  int64_t comp = static_cast<int64_t>(body.size());
  int fmt;
  if (parts == 1) {
    fmt = 0;
  } else {
    int64_t big = std::max(n, comp);
    fmt = big < 1024 ? 1 : (big < 16384 ? 2 : 3);
  }
  static const int kWidth[4] = {10, 10, 14, 18};
  static const int kLength[4] = {3, 3, 4, 5};
  int width = kWidth[fmt];
  if (comp >= (1LL << width)) return false;
  uint64_t header = 2 | fmt << 2 | static_cast<uint64_t>(n) << 4 |
                    static_cast<uint64_t>(comp) << (4 + width);
  out.clear();
  for (int i = 0; i < kLength[fmt]; ++i) out.push_back(static_cast<uint8_t>(header >> (8 * i)));
  out.insert(out.end(), body.begin(), body.end());
  return true;
}

void literals_section(const uint8_t* lits, int64_t n, std::vector<uint8_t>& out) {
  size_t raw = (n < 32 ? 1 : n < 4096 ? 2 : 3) + n;
  if (n > 0) {
    bool same = true;
    for (int64_t i = 1; i < n && same; ++i) same = lits[i] == lits[0];
    if (same) {
      size_t rle = (n < 32 ? 1 : n < 4096 ? 2 : 3) + 1;
      if (rle < raw) {
        literals_header(1, n, out);
        out.push_back(lits[0]);
        return;
      }
    } else {
      std::vector<uint8_t> huffman;
      if (huffman_literals(lits, n, huffman) && huffman.size() < raw) {
        out.insert(out.end(), huffman.begin(), huffman.end());
        return;
      }
    }
  }
  literals_header(0, n, out);
  out.insert(out.end(), lits, lits + n);
}

inline int ll_code(uint32_t ll) {
  if (ll < 16) return ll;
  if (ll >= 64) return highbit(ll) + 19;
  int code = 16;
  while (kLLBase[code + 1] <= ll) code++;
  return code;
}

inline int ml_code(uint32_t ml) {
  uint32_t base = ml - 3;
  if (base < 32) return base;
  if (base >= 128) return highbit(base) + 36;
  int code = 32;
  while (kMLBase[code + 1] <= ml) code++;
  return code;
}

// The bits `codes` take through `table`, its initial state's included.
int64_t chain_bits(const FseEncoder& table, const std::vector<uint8_t>& codes) {
  size_t n = codes.size();
  uint32_t state = table.start(codes[n - 1]), bits;
  int64_t total = table.log();
  int nbits;
  for (size_t i = n - 1; i-- > 0;) {
    state = table.encode(codes[i], state, bits, nbits);
    total += nbits;
  }
  return total;
}

// The mode, the description and the table of one kind of code (volume/
// zstd.py _sequence_table).
int sequence_table(const std::vector<uint8_t>& codes, const int16_t* deflt,
                   int dcount, int dlog, int max_log, std::vector<uint8_t>& description,
                   FseEncoder& table) {
  description.clear();
  int top = 0;
  bool same = true;
  for (uint8_t c : codes) {
    top = std::max<int>(top, c);
    same = same && c == codes[0];
  }
  if (same) {
    description.push_back(codes[0]);
    table.make_rle();
    return 1;
  }
  int64_t best = -1;
  if (top < dcount) {
    table.build(deflt, dcount, dlog);
    best = chain_bits(table, codes);
  }
  int64_t counts[53] = {0};
  for (uint8_t c : codes) counts[c]++;
  int log = table_log(max_log, static_cast<int64_t>(codes.size()), top);
  int16_t norm[53];
  normalize(counts, top + 1, static_cast<int64_t>(codes.size()), log, norm);
  FseEncoder compressed;
  compressed.build(norm, top + 1, log);
  std::vector<uint8_t> ncount;
  write_ncount(norm, log, ncount);
  int64_t cost = chain_bits(compressed, codes) + 8 * static_cast<int64_t>(ncount.size());
  if (best >= 0 && best <= cost) return 0;
  table = compressed;
  description = ncount;
  return 2;
}

struct Sequence {
  uint32_t ll, value, ml;
};

void sequences_section(const std::vector<Sequence>& seqs, std::vector<uint8_t>& out) {
  size_t n = seqs.size();
  if (n < 128) {
    out.push_back(static_cast<uint8_t>(n));
  } else if (n < 0x7F00) {
    out.push_back(static_cast<uint8_t>((n >> 8) + 128));
    out.push_back(static_cast<uint8_t>(n & 255));
  } else {
    out.push_back(255);
    out.push_back(static_cast<uint8_t>((n - 0x7F00) & 255));
    out.push_back(static_cast<uint8_t>((n - 0x7F00) >> 8));
  }
  if (!n) return;
  std::vector<uint8_t> ll_codes(n), ml_codes(n), of_codes(n);
  for (size_t i = 0; i < n; ++i) {
    ll_codes[i] = static_cast<uint8_t>(ll_code(seqs[i].ll));
    ml_codes[i] = static_cast<uint8_t>(ml_code(seqs[i].ml));
    of_codes[i] = static_cast<uint8_t>(highbit(seqs[i].value));
  }
  FseEncoder ll_t, of_t, ml_t;
  std::vector<uint8_t> ll_d, of_d, ml_d;
  int modes = sequence_table(ll_codes, kLLDefault, 36, 6, 9, ll_d, ll_t) << 6;
  modes |= sequence_table(of_codes, kOFDefault, 29, 5, 8, of_d, of_t) << 4;
  modes |= sequence_table(ml_codes, kMLDefault, 53, 6, 9, ml_d, ml_t) << 2;
  out.push_back(static_cast<uint8_t>(modes));
  out.insert(out.end(), ll_d.begin(), ll_d.end());
  out.insert(out.end(), of_d.begin(), of_d.end());
  out.insert(out.end(), ml_d.begin(), ml_d.end());
  BitWriter w(out);
  size_t i = n - 1;
  uint32_t ll_s = ll_t.start(ll_codes[i]), ml_s = ml_t.start(ml_codes[i]),
           of_s = of_t.start(of_codes[i]), bits;
  int nbits;
  while (true) {
    const Sequence& q = seqs[i];
    w.add(q.ll - kLLBase[ll_codes[i]], kLLBits[ll_codes[i]]);
    w.add(q.ml - kMLBase[ml_codes[i]], kMLBits[ml_codes[i]]);
    w.add(q.value - (1u << of_codes[i]), of_codes[i]);
    if (i == 0) break;
    i -= 1;
    of_s = of_t.encode(of_codes[i], of_s, bits, nbits);
    w.add(bits, nbits);
    ml_s = ml_t.encode(ml_codes[i], ml_s, bits, nbits);
    w.add(bits, nbits);
    ll_s = ll_t.encode(ll_codes[i], ll_s, bits, nbits);
    w.add(bits, nbits);
  }
  w.add(ml_s, ml_t.log());
  w.add(of_s, of_t.log());
  w.add(ll_s, ll_t.log());
  w.finish();
}

// The offset value of a match after `ll` literals, the repeat offsets
// updated as the decoder updates them.
uint32_t offset_value(uint32_t offset, uint32_t ll, uint32_t* reps) {
  uint32_t value;
  if (ll) {
    value = offset == reps[0] ? 1 : offset == reps[1] ? 2 : offset == reps[2] ? 3 : offset + 3;
  } else {
    value = offset == reps[1] ? 1 : offset == reps[2] ? 2 : offset == reps[0] - 1 ? 3 : offset + 3;
  }
  uint32_t idx = value - 1 + (ll == 0 ? 1 : 0);
  if (value > 3) {
    reps[2] = reps[1];
    reps[1] = reps[0];
    reps[0] = offset;
  } else if (idx) {
    if (idx > 1) reps[2] = reps[1];
    reps[1] = reps[0];
    reps[0] = offset;
  }
  return value;
}

inline int64_t match_length(const uint8_t* data, int64_t a, int64_t b, int64_t end) {
  int64_t n = 0, most = end - b;
  while (n + 8 <= most) {
    uint64_t x, y;
    std::memcpy(&x, data + a + n, 8);
    std::memcpy(&y, data + b + n, 8);
    if (x != y) return n + (__builtin_ctzll(x ^ y) >> 3);
    n += 8;
  }
  while (n < most && data[a + n] == data[b + n]) n++;
  return n;
}

// The match finder over one frame's bytes (volume/zstd.py _Matcher).
struct Matcher {
  const uint8_t* data;
  int64_t n, max_distance, window_mask;
  int hash_shift;
  Params p;
  std::vector<int64_t> table, chain;

  Matcher(const uint8_t* d, int64_t size, int level) : data(d), n(size), p(params(level)) {
    max_distance = (1LL << p.window_log) - 1;
    window_mask = max_distance;
    hash_shift = 32 - p.hash_log;
    table.assign(static_cast<size_t>(1) << p.hash_log, -1);
    if (p.depth > 1) chain.assign(static_cast<size_t>(std::min<int64_t>(n, 1LL << p.window_log)), -1);
  }
  inline uint32_t hash(int64_t pos) const {
    uint32_t word;
    std::memcpy(&word, data + pos, 4);
    return (word * 2654435761u) >> hash_shift;
  }
  inline int64_t insert(int64_t pos) {
    uint32_t h = hash(pos);
    int64_t first = table[h];
    table[h] = pos;
    if (!chain.empty()) chain[pos & window_mask] = first;
    return first;
  }
  // The longest match at ip ending by end, the match at `rep` first; ip
  // is inserted.
  int64_t search(int64_t ip, int64_t end, uint32_t rep, int64_t& offset) {
    int64_t best = 0;
    offset = 0;
    if (rep <= std::min(ip, max_distance)) {
      best = match_length(data, ip - rep, ip, end);
      offset = rep;
    }
    int64_t cand = insert(ip);
    int tries = p.depth;
    while (cand >= 0 && ip - cand <= max_distance) {
      int64_t length = match_length(data, cand, ip, end);
      if (length > best && length >= kHashMinMatch) {
        best = length;
        offset = ip - cand;
      }
      if (--tries == 0 || chain.empty()) break;
      cand = chain[cand & window_mask];
    }
    return best;
  }
  // The literals and sequences of the block [start, end).
  void parse(int64_t start, int64_t end, uint32_t* reps, std::vector<uint8_t>& lits,
             std::vector<Sequence>& seqs) {
    lits.clear();
    seqs.clear();
    int64_t ip = start, anchor = start, last = end - kMinMatch, top = n - kMinMatch;
    while (ip <= last) {
      int64_t offset;
      int64_t length = search(ip, end, ip > anchor ? reps[0] : reps[1], offset);
      if (length < kMinMatch) {
        ip += 1 + ((ip - anchor) >> p.skip);
        continue;
      }
      int64_t probed = ip;
      while (p.lazy && ip + 1 <= last) {
        int64_t other;
        int64_t more = search(ip + 1, end, reps[0], other);
        probed = ip + 1;
        if (more <= length) break;
        ip += 1;
        length = more;
        offset = other;
      }
      while (ip > anchor && ip > offset && data[ip - 1] == data[ip - 1 - offset]) {
        ip -= 1;
        length += 1;
      }
      lits.insert(lits.end(), data + anchor, data + ip);
      uint32_t ll = static_cast<uint32_t>(ip - anchor);
      seqs.push_back({ll, offset_value(static_cast<uint32_t>(offset), ll, reps),
                      static_cast<uint32_t>(length)});
      // a long match is inserted at its two ends only
      int64_t stop = std::min(ip + length, top + 1);
      for (int64_t q = probed + 1; q < std::min(ip + kInsertEnds, stop); ++q) insert(q);
      for (int64_t q = std::max({probed + 1, ip + kInsertEnds, ip + length - kInsertEnds});
           q < stop; ++q)
        insert(q);
      ip += length;
      anchor = ip;
    }
    lits.insert(lits.end(), data + anchor, data + end);
  }
};

struct Frame {
  uint8_t* dst;
  int64_t cap, pos = 0;
  void put(const uint8_t* src, int64_t count) {
    if (count > cap - pos) fail(kFrameFull);
    std::memcpy(dst + pos, src, count);
    pos += count;
  }
  void put_le(uint64_t v, int bytes) {
    uint8_t b[8];
    for (int i = 0; i < bytes; ++i) b[i] = static_cast<uint8_t>(v >> (8 * i));
    put(b, bytes);
  }
  void block_header(bool last, int kind, int64_t size) {
    put_le(static_cast<uint64_t>(last) | kind << 1 | static_cast<uint64_t>(size) << 3, 3);
  }
};

int64_t compress(const uint8_t* src, int64_t n, int level, Frame& out) {
  Params p = params(level);
  bool single = n <= (1LL << p.window_log);
  int fcs_flag, fcs_bytes;
  uint64_t fcs = static_cast<uint64_t>(n);
  if (single && n < 256) {
    fcs_flag = 0;
    fcs_bytes = 1;
  } else if (n < 65536 + 256) {
    fcs_flag = 1;
    fcs_bytes = 2;
    fcs -= 256;
  } else if (n < (1LL << 32)) {
    fcs_flag = 2;
    fcs_bytes = 4;
  } else {
    fcs_flag = 3;
    fcs_bytes = 8;
  }
  out.put_le(0xFD2FB528u, 4);
  out.put_le(fcs_flag << 6 | (single ? 1 : 0) << 5 | 1 << 2, 1);
  if (!single) out.put_le((p.window_log - 10) << 3, 1);
  out.put_le(fcs, fcs_bytes);
  if (n == 0) out.block_header(true, 0, 0);
  Matcher matcher(src, n, level);
  uint32_t reps[3] = {1, 4, 8};
  std::vector<uint8_t> lits, body;
  std::vector<Sequence> seqs;
  for (int64_t start = 0; start < n; start += kMaxBlock) {
    int64_t end = std::min<int64_t>(n, start + kMaxBlock), size = end - start;
    bool last = end == n;
    const uint8_t* block = src + start;
    bool same = true;
    for (int64_t i = 1; i < size && same; ++i) same = block[i] == block[0];
    if (same) {
      out.block_header(last, 1, size);
      out.put(block, 1);
      continue;
    }
    uint32_t saved[3] = {reps[0], reps[1], reps[2]};
    matcher.parse(start, end, reps, lits, seqs);
    body.clear();
    literals_section(lits.data(), static_cast<int64_t>(lits.size()), body);
    sequences_section(seqs, body);
    if (static_cast<int64_t>(body.size()) < size) {
      out.block_header(last, 2, static_cast<int64_t>(body.size()));
      out.put(body.data(), static_cast<int64_t>(body.size()));
    } else {
      std::memcpy(reps, saved, sizeof(saved));
      out.block_header(last, 0, size);
      out.put(block, size);
    }
  }
  out.put_le(static_cast<uint32_t>(xxh64(src, n)), 4);
  return out.pos;
}

}  // namespace

extern "C" {

// Decode the frames in src[0..n) into dst[0..cap); returns the bytes
// written, or a negative code (cf_zstd_error names it).
int64_t cf_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap) {
  Output out{dst, cap, 0, 0};
  try {
    return frames(src, n, out);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {
    return kCorrupt;
  }
}

// Encode src[0..n) as one frame at `level` into dst[0..cap); returns the
// frame's size, or a negative code (cf_zstd_error names it).
int64_t cf_zstd_compress(const uint8_t* src, int64_t n, int level, uint8_t* dst,
                         int64_t cap) {
  Frame out{dst, cap};
  try {
    return compress(src, n, level, out);
  } catch (const Fail& f) {
    return f.code;
  } catch (...) {  // the tables' allocation
    return kNoMemory;
  }
}

const char* cf_zstd_error(int64_t code) {
  switch (code) {
    case kTruncated: return "truncated frame";
    case kBadMagic: return "not a zstd frame";
    case kDictionary: return "the frame needs a dictionary";
    case kReserved: return "reserved field set";
    case kCorrupt: return "corrupt frame";
    case kOutputFull: return "decoded data larger than the output";
    case kChecksum: return "content checksum mismatch";
    case kSizeMismatch: return "decoded size differs from the frame's content size";
    case kFrameFull: return "the frame is larger than the output";
    case kNoMemory: return "out of memory for the encoder's tables";
    default: return "unknown error";
  }
}

}  // extern "C"
