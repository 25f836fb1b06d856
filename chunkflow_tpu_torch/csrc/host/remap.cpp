// Segmentation id remapping — the fastremap (C++) equivalent's hot paths.
// The port's copy of chunkflow_tpu/native/src/remap.cpp.
//
// Reference capability: fastremap.renumber / fastremap.remap used by
// chunk/segmentation.py remap/renumber flows. The numpy fallback in
// ops/remap.py is O(n log n) (sort-based); these are single-pass with an
// open-addressing hash table (linear probing, splitmix64 finalizer).
//
// C ABI (no pybind11 in this image; ctypes on the Python side):
//   cf_renumber_{u32,u64}: relabel to [start_id, ...), 0 stays 0.
//     Returns the number of (old, new) pairs written to keys/vals, or
//     -needed when max_pairs is too small. In the -needed case the output
//     array IS fully relabeled (the map held every id) — only the pair
//     export didn't fit, so the caller just re-exports with a bigger
//     buffer (simplest: rerun the call).
//   cf_remap_{u32,u64}: apply an explicit mapping; ids not in the map pass
//     through (preserve_missing=1) or become 0.
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

// open-addressing map: key 0 marks an empty slot (segmentation id 0 is
// background and never inserted)
struct U64Map {
  std::vector<uint64_t> keys;
  std::vector<uint64_t> vals;
  uint64_t mask;
  size_t count = 0;

  explicit U64Map(size_t expected) {
    size_t cap = 64;
    while (cap < expected * 2) cap <<= 1;
    keys.assign(cap, 0);
    vals.assign(cap, 0);
    mask = cap - 1;
  }

  void grow() {
    U64Map bigger(keys.size());  // doubles: cap*2 >= size*2
    for (size_t i = 0; i < keys.size(); ++i)
      if (keys[i]) bigger.insert_new(keys[i], vals[i]);
    keys.swap(bigger.keys);
    vals.swap(bigger.vals);
    mask = bigger.mask;
  }

  void insert_new(uint64_t k, uint64_t v) {
    uint64_t i = mix64(k) & mask;
    while (keys[i]) i = (i + 1) & mask;
    keys[i] = k;
    vals[i] = v;
    ++count;
  }

  // returns the value for k, inserting next_id (and bumping it) when new
  uint64_t get_or_assign(uint64_t k, uint64_t& next_id) {
    if ((count + 1) * 2 > keys.size()) grow();
    uint64_t i = mix64(k) & mask;
    while (keys[i]) {
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
    keys[i] = k;
    vals[i] = next_id;
    ++count;
    return next_id++;
  }

  // lookup only; found=false when absent
  uint64_t find(uint64_t k, bool& found) const {
    uint64_t i = mix64(k) & mask;
    while (keys[i]) {
      if (keys[i] == k) {
        found = true;
        return vals[i];
      }
      i = (i + 1) & mask;
    }
    found = false;
    return 0;
  }
};

template <typename T>
int64_t renumber_impl(const T* in, T* out, int64_t n, uint64_t start_id,
                      uint64_t* pair_keys, uint64_t* pair_vals,
                      int64_t max_pairs) {
  U64Map map(1 << 12);
  uint64_t next_id = start_id;
  for (int64_t i = 0; i < n; ++i) {
    const T v = in[i];
    out[i] = v == 0 ? T(0) : T(map.get_or_assign(v, next_id));
  }
  const int64_t pairs = static_cast<int64_t>(map.count);
  if (pairs > max_pairs) return -pairs;
  int64_t w = 0;
  for (size_t i = 0; i < map.keys.size(); ++i) {
    if (map.keys[i]) {
      pair_keys[w] = map.keys[i];
      pair_vals[w] = map.vals[i];
      ++w;
    }
  }
  return pairs;
}

template <typename T>
int64_t remap_impl(const T* in, T* out, int64_t n, const uint64_t* keys,
                   const uint64_t* vals, int64_t npairs,
                   int preserve_missing) {
  U64Map map(static_cast<size_t>(npairs) + 1);
  for (int64_t i = 0; i < npairs; ++i)
    if (keys[i]) map.insert_new(keys[i], vals[i]);
  bool zero_mapped = false;
  uint64_t zero_val = 0;
  for (int64_t i = 0; i < npairs; ++i)
    if (keys[i] == 0) {
      zero_mapped = true;
      zero_val = vals[i];
    }
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t v = in[i];
    if (v == 0) {
      out[i] = zero_mapped ? T(zero_val) : T(0);
      continue;
    }
    bool found;
    const uint64_t m = map.find(v, found);
    out[i] = found ? T(m) : (preserve_missing ? in[i] : T(0));
  }
  return 0;
}

}  // namespace

extern "C" {

int64_t cf_renumber_u32(const uint32_t* in, uint32_t* out, int64_t n,
                        uint64_t start_id, uint64_t* keys, uint64_t* vals,
                        int64_t max_pairs) {
  return renumber_impl(in, out, n, start_id, keys, vals, max_pairs);
}

int64_t cf_renumber_u64(const uint64_t* in, uint64_t* out, int64_t n,
                        uint64_t start_id, uint64_t* keys, uint64_t* vals,
                        int64_t max_pairs) {
  return renumber_impl(in, out, n, start_id, keys, vals, max_pairs);
}

int64_t cf_remap_u32(const uint32_t* in, uint32_t* out, int64_t n,
                     const uint64_t* keys, const uint64_t* vals,
                     int64_t npairs, int preserve_missing) {
  return remap_impl(in, out, n, keys, vals, npairs, preserve_missing);
}

int64_t cf_remap_u64(const uint64_t* in, uint64_t* out, int64_t n,
                     const uint64_t* keys, const uint64_t* vals,
                     int64_t npairs, int preserve_missing) {
  return remap_impl(in, out, n, keys, vals, npairs, preserve_missing);
}

}  // extern "C"
