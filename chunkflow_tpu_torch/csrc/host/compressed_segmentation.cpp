// The block codecs of the neuroglancer precomputed format that run per
// voxel on the host: compressed_segmentation (uint32 and uint64 labels)
// and the PNG row filters.
//
// compressed_segmentation, as neuroglancer's
// src/datasource/precomputed/volume.md lays it out and tensorstore writes
// it: a chunk [c, z, y, x] is one uint32 offset per channel (in 32-bit
// words from the start of the chunk), then each channel on its own. A
// channel is a grid of blocks [bz, by, bx] in zyx raster order; its
// header holds two words per block: the lookup table's offset (low 24
// bits) with the encoded bit width (high 8 bits), and the encoded
// values' offset, both in words from the channel's start. A block's
// values are indices into its table, packed little-endian at 0, 1, 2, 4,
// 8, 16 or 32 bits over the whole block shape (an edge block clipped to
// the chunk leaves the voxels outside it at index 0); its table is its
// distinct labels in ascending order, one word (uint32) or two (uint64,
// low word first) each, and a table equal to an earlier block's of the
// same channel is not written again: the block points at the first.
//
// C ABI (ctypes on the Python side):
//   cseg_encode_{u32,u64}(in, c, z, y, x, bz, by, bx, out, capacity):
//     the number of words written, or -needed when capacity is short.
//   cseg_decode_{u32,u64}(data, nwords, c, z, y, x, bz, by, bx, out):
//     0, or -1 when an offset, a bit width or an index lies outside the
//     data (a corrupt chunk).
//   png_unfilter(in, rows, stride, bpp, out): undo the per-row filters
//     (None, Sub, Up, Average, Paeth) of rows of `stride` bytes, each
//     led by its filter byte; 0, or -(row + 1) at an unknown filter.
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <vector>

namespace {

template <typename T>
constexpr int64_t kWords = sizeof(T) / 4;

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
void encode_channel(const T* in, const int64_t shape[3],
                    const int64_t block[3], std::vector<uint32_t>* out) {
  const size_t base = out->size();
  int64_t grid[3];
  int64_t nblocks = 1;
  for (int i = 0; i < 3; ++i) {
    grid[i] = ceil_div(shape[i], block[i]);
    nblocks *= grid[i];
  }
  const int64_t block_voxels = block[0] * block[1] * block[2];
  out->resize(base + 2 * nblocks, 0u);
  std::map<std::vector<T>, uint32_t> tables;
  std::vector<T> values;
  std::vector<uint32_t> index;
  int64_t g[3];
  for (g[0] = 0; g[0] < grid[0]; ++g[0]) {
    for (g[1] = 0; g[1] < grid[1]; ++g[1]) {
      for (g[2] = 0; g[2] < grid[2]; ++g[2]) {
        int64_t lo[3], n[3];
        for (int i = 0; i < 3; ++i) {
          lo[i] = g[i] * block[i];
          n[i] = std::min(block[i], shape[i] - lo[i]);
        }
        values.clear();
        for (int64_t z = 0; z < n[0]; ++z)
          for (int64_t y = 0; y < n[1]; ++y) {
            const T* row = in + ((lo[0] + z) * shape[1] + lo[1] + y) *
                                    shape[2] + lo[2];
            values.insert(values.end(), row, row + n[2]);
          }
        std::vector<T> table(values);
        std::sort(table.begin(), table.end());
        table.erase(std::unique(table.begin(), table.end()), table.end());
        uint32_t bits = 0;
        if (table.size() != 1) {
          bits = 1;
          while ((uint64_t(1) << bits) < table.size()) bits *= 2;
        }
        const int64_t value_words = ceil_div(bits * block_voxels, 32);
        const uint32_t value_offset = uint32_t(out->size() - base);
        out->resize(out->size() + value_words, 0u);
        if (bits) {
          uint32_t* words = out->data() + base + value_offset;
          int64_t k = 0;
          T last = table[0];
          uint32_t last_index = 0;
          for (int64_t z = 0; z < n[0]; ++z)
            for (int64_t y = 0; y < n[1]; ++y)
              for (int64_t x = 0; x < n[2]; ++x, ++k) {
                const T v = values[k];
                if (v != last) {
                  last = v;
                  last_index = uint32_t(
                      std::lower_bound(table.begin(), table.end(), v) -
                      table.begin());
                }
                const uint64_t o = uint64_t(x + block[2] *
                                            (y + block[1] * z));
                words[o * bits / 32] |= last_index << (o * bits % 32);
              }
        }
        uint32_t table_offset;
        auto found = tables.find(table);
        if (found != tables.end()) {
          table_offset = found->second;
        } else {
          table_offset = uint32_t(out->size() - base);
          for (T v : table)
            for (int64_t w = 0; w < kWords<T>; ++w)
              out->push_back(uint32_t(uint64_t(v) >> (32 * w)));
          tables.emplace(std::move(table), table_offset);
        }
        const int64_t b = (g[0] * grid[1] + g[1]) * grid[2] + g[2];
        (*out)[base + 2 * b] = table_offset | (bits << 24);
        (*out)[base + 2 * b + 1] = value_offset;
      }
    }
  }
}

template <typename T>
int64_t encode(const T* in, int64_t c, int64_t z, int64_t y, int64_t x,
               int64_t bz, int64_t by, int64_t bx, uint32_t* out,
               int64_t capacity) {
  const int64_t shape[3] = {z, y, x};
  const int64_t block[3] = {bz, by, bx};
  std::vector<uint32_t> words(c, 0u);
  for (int64_t ch = 0; ch < c; ++ch) {
    words[ch] = uint32_t(words.size());
    encode_channel(in + ch * z * y * x, shape, block, &words);
  }
  const int64_t n = int64_t(words.size());
  if (n > capacity) return -n;
  std::memcpy(out, words.data(), n * 4);
  return n;
}

template <typename T>
int decode(const uint32_t* data, int64_t nwords, int64_t c, int64_t z,
           int64_t y, int64_t x, int64_t bz, int64_t by, int64_t bx,
           T* out) {
  const int64_t shape[3] = {z, y, x};
  const int64_t block[3] = {bz, by, bx};
  int64_t grid[3];
  for (int i = 0; i < 3; ++i) grid[i] = ceil_div(shape[i], block[i]);
  const int64_t nblocks = grid[0] * grid[1] * grid[2];
  const int64_t block_voxels = bz * by * bx;
  if (nwords < c) return -1;
  for (int64_t ch = 0; ch < c; ++ch) {
    const int64_t start = data[ch];
    if (start + 2 * nblocks > nwords) return -1;
    const uint32_t* chan = data + start;
    const int64_t avail = nwords - start;
    T* dst = out + ch * z * y * x;
    int64_t g[3];
    for (g[0] = 0; g[0] < grid[0]; ++g[0])
      for (g[1] = 0; g[1] < grid[1]; ++g[1])
        for (g[2] = 0; g[2] < grid[2]; ++g[2]) {
          const int64_t b = (g[0] * grid[1] + g[1]) * grid[2] + g[2];
          const int64_t table = chan[2 * b] & 0xffffffu;
          const uint32_t bits = chan[2 * b] >> 24;
          const int64_t values = chan[2 * b + 1];
          if (bits != 0 && bits != 1 && bits != 2 && bits != 4 &&
              bits != 8 && bits != 16 && bits != 32)
            return -1;
          if (values + ceil_div(bits * block_voxels, 32) > avail) return -1;
          const int64_t table_len = (avail - table) / kWords<T>;
          if (table >= avail || table_len < 1) return -1;
          const uint64_t mask = bits == 32 ? 0xffffffffull
                                           : (uint64_t(1) << bits) - 1;
          int64_t lo[3], n[3];
          for (int i = 0; i < 3; ++i) {
            lo[i] = g[i] * block[i];
            n[i] = std::min(block[i], shape[i] - lo[i]);
          }
          for (int64_t zz = 0; zz < n[0]; ++zz)
            for (int64_t yy = 0; yy < n[1]; ++yy) {
              T* row = dst + ((lo[0] + zz) * y + lo[1] + yy) * x + lo[2];
              for (int64_t xx = 0; xx < n[2]; ++xx) {
                int64_t idx = 0;
                if (bits) {
                  const uint64_t o = uint64_t(xx + bx * (yy + by * zz));
                  idx = (chan[values + o * bits / 32] >>
                         (o * bits % 32)) & mask;
                }
                if (idx >= table_len) return -1;
                const uint32_t* entry = chan + table + idx * kWords<T>;
                uint64_t v = entry[0];
                if (kWords<T> == 2) v |= uint64_t(entry[1]) << 32;
                row[xx] = T(v);
              }
            }
        }
  }
  return 0;
}

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return pb <= pc ? uint8_t(b) : uint8_t(c);
}

}  // namespace

extern "C" {

int64_t cseg_encode_u32(const uint32_t* in, int64_t c, int64_t z, int64_t y,
                        int64_t x, int64_t bz, int64_t by, int64_t bx,
                        uint32_t* out, int64_t capacity) {
  return encode(in, c, z, y, x, bz, by, bx, out, capacity);
}

int64_t cseg_encode_u64(const uint64_t* in, int64_t c, int64_t z, int64_t y,
                        int64_t x, int64_t bz, int64_t by, int64_t bx,
                        uint32_t* out, int64_t capacity) {
  return encode(in, c, z, y, x, bz, by, bx, out, capacity);
}

int cseg_decode_u32(const uint32_t* data, int64_t nwords, int64_t c,
                    int64_t z, int64_t y, int64_t x, int64_t bz, int64_t by,
                    int64_t bx, uint32_t* out) {
  return decode(data, nwords, c, z, y, x, bz, by, bx, out);
}

int cseg_decode_u64(const uint32_t* data, int64_t nwords, int64_t c,
                    int64_t z, int64_t y, int64_t x, int64_t bz, int64_t by,
                    int64_t bx, uint64_t* out) {
  return decode(data, nwords, c, z, y, x, bz, by, bx, out);
}

int64_t png_unfilter(const uint8_t* in, int64_t rows, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* src = in + r * (stride + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* cur = out + r * stride;
    const uint8_t* up = r ? cur - stride : nullptr;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      switch (filter) {
        case 0: cur[i] = src[i]; break;
        case 1: cur[i] = uint8_t(src[i] + a); break;
        case 2: cur[i] = uint8_t(src[i] + b); break;
        case 3: cur[i] = uint8_t(src[i] + ((a + b) >> 1)); break;
        case 4: cur[i] = uint8_t(src[i] + paeth(a, b, c)); break;
        default: return -(r + 1);
      }
    }
  }
  return 0;
}

}  // extern "C"
