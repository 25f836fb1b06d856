// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), the checksum of
// zarr v3's crc32c codec and of tensorstore's sharded index.
//
// cf_crc32c continues a running CRC over n bytes: slicing-by-8 over
// tables built once, plain C++ (no instruction-set intrinsics), so it
// builds on any host. volume/crc32c.py:crc32c_plain is the same function
// in Python, one table, a byte at a time.
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFFu];
  }
};

const Tables& tables() {
  static const Tables built;
  return built;
}

inline uint32_t load_le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
         static_cast<uint32_t>(p[2]) << 16 | static_cast<uint32_t>(p[3]) << 24;
}

}  // namespace

extern "C" {

// the CRC-32C of data[0:n], continuing `crc` (0 to start)
uint32_t cf_crc32c(uint32_t crc, const uint8_t* data, int64_t n) {
  const auto& t = tables().t;
  uint32_t c = ~crc;
  while (n >= 8) {
    const uint32_t lo = load_le32(data) ^ c;
    const uint32_t hi = load_le32(data + 4);
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^
        t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
        t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ t[0][(c ^ *data++) & 0xFF];
  return ~c;
}

}  // extern "C"
