// Shared z-slab threading helpers + union-find for the native kernels
// (cc3d.cpp here; the JAX package's watershed.cpp too). The port's copy
// of chunkflow_tpu/native/src/zslab.h. The safety pattern both kernels rely on:
// parallel passes unite only WITHIN-slab voxel indices, so union-find
// chains never cross a slab boundary while workers run (path-halving
// writes stay inside each worker's slab); the one z-plane of seam edges
// per boundary is stitched sequentially after the join.
#ifndef CHUNKFLOW_NATIVE_ZSLAB_H_
#define CHUNKFLOW_NATIVE_ZSLAB_H_

#include <cstdint>
#include <cstdlib>
#include <functional>
#include <thread>
#include <utility>
#include <vector>

namespace chunkflow {

struct UnionFind {
  std::vector<uint32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<uint32_t>(i);
  }
  uint32_t find(uint32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  }
  bool unite(uint32_t a, uint32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return false;
    if (b < a) std::swap(a, b);
    parent[b] = a;  // smaller root wins -> deterministic labeling
    return true;
  }
};

// CHUNKFLOW_NATIVE_THREADS overrides; default = hardware_concurrency
// capped at 8 (the edge scans saturate memory bandwidth well before
// that). Small volumes stay sequential: the slab machinery only pays
// off when each slab has real work.
inline int thread_count(int64_t sz) {
  int nt = 0;
  if (const char* env = std::getenv("CHUNKFLOW_NATIVE_THREADS")) {
    nt = std::atoi(env);
  }
  if (nt <= 0) {
    nt = static_cast<int>(std::thread::hardware_concurrency());
    if (nt > 8) nt = 8;
  }
  if (nt < 1) nt = 1;
  // need >= 2 z-planes per slab so every slab owns interior z-edges
  const int max_by_work = static_cast<int>(sz / 2);
  if (nt > max_by_work) nt = max_by_work;
  return nt < 1 ? 1 : nt;
}

// contiguous z-slab [z0, z1) per worker; deterministic for fixed (sz, nt)
inline std::vector<int64_t> slab_bounds(int64_t sz, int nt) {
  std::vector<int64_t> bounds(nt + 1);
  for (int t = 0; t <= nt; ++t) bounds[t] = sz * t / nt;
  return bounds;
}

inline void run_slabs(int64_t sz, int nt,
                      const std::function<void(int, int64_t, int64_t)>& body) {
  const auto bounds = slab_bounds(sz, nt);
  if (nt == 1) {
    body(0, bounds[0], bounds[1]);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int t = 0; t < nt; ++t)
    workers.emplace_back(body, t, bounds[t], bounds[t + 1]);
  for (auto& w : workers) w.join();
}

}  // namespace chunkflow

#endif  // CHUNKFLOW_NATIVE_ZSLAB_H_
