// Zstandard frames (RFC 8878), decode only.
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
#include <cstdint>
#include <cstring>
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
    default: return "unknown error";
  }
}

}  // extern "C"
