// 3D connected components via union-find over voxel indices.
// The port's copy of chunkflow_tpu/native/src/cc3d.cpp, the native
// equivalent of the cc3d wheel the reference depends on
// (chunkflow/chunk/base.py:136): label distinct-value regions of a 3D
// volume under 6/18/26 connectivity. Host-side work, kept off the
// card; threaded over z-slabs (zslab.h): each
// worker unites same-value neighbor pairs whose BOTH endpoints lie in
// its slab, the seam planes (neighbors with dz = -1 crossing a slab
// boundary) stitch sequentially after the join, and the final ids are
// assigned by one sequential first-encounter raster scan — so the
// labeling is identical for every thread count (components and
// numbering are both order-independent).
#include <cstdint>
#include <vector>

#include "zslab.h"

namespace {

// neighbor offsets with all coordinates <= 0 and lexicographically
// negative (each undirected edge enumerated once), grouped by
// connectivity class
struct Offset { int dz, dy, dx; int cls; };  // cls: 1=face 2=edge 3=corner
constexpr Offset kOffsets[] = {
    {0, 0, -1, 1},  {0, -1, 0, 1},  {-1, 0, 0, 1},
    {0, -1, -1, 2}, {0, -1, 1, 2},  {-1, 0, -1, 2}, {-1, 0, 1, 2},
    {-1, -1, 0, 2}, {-1, 1, 0, 2},
    {-1, -1, -1, 3}, {-1, -1, 1, 3}, {-1, 1, -1, 3}, {-1, 1, 1, 3},
};

template <typename T>
uint32_t label_impl(const T* in, uint32_t* out, int64_t sz, int64_t sy,
                    int64_t sx, int connectivity) {
  const int max_cls = connectivity == 6 ? 1 : (connectivity == 18 ? 2 : 3);
  const int64_t n = sz * sy * sx;
  const int nt = chunkflow::thread_count(sz);
  chunkflow::UnionFind uf(n);

  // visit the (already-enumerated-once) neighbor edges of voxels in
  // z-range [z0, z1). Slab pass (seam_only = false): edges whose
  // neighbor falls below z0 are skipped — they cross the slab seam and
  // run later in the sequential seam pass (seam_only = true, which
  // visits ONLY the dz = -1 edges of one boundary plane).
  auto unite_range = [&](int64_t z0, int64_t z1, bool seam_only) {
    for (int64_t z = z0; z < z1; ++z) {
      for (int64_t y = 0; y < sy; ++y) {
        const int64_t row = (z * sy + y) * sx;
        for (int64_t x = 0; x < sx; ++x) {
          const int64_t idx = row + x;
          const T v = in[idx];
          if (v == 0) continue;
          for (const auto& off : kOffsets) {
            if (off.cls > max_cls) continue;
            if (seam_only && off.dz == 0) continue;
            const int64_t nz = z + off.dz;
            if (!seam_only && nz < z0) continue;  // crosses the seam
            const int64_t ny = y + off.dy, nx = x + off.dx;
            if (nz < 0 || ny < 0 || ny >= sy || nx < 0 || nx >= sx)
              continue;
            const int64_t nidx = (nz * sy + ny) * sx + nx;
            if (in[nidx] != v) continue;
            uf.unite(static_cast<uint32_t>(idx),
                     static_cast<uint32_t>(nidx));
          }
        }
      }
    }
  };

  chunkflow::run_slabs(sz, nt, [&](int, int64_t z0, int64_t z1) {
    unite_range(z0, z1, /*seam_only=*/false);
  });
  if (nt > 1) {
    // seam stitch: the one z-plane per interior boundary, sequential
    const auto bounds = chunkflow::slab_bounds(sz, nt);
    for (int t = 1; t < nt; ++t) {
      const int64_t z = bounds[t];
      if (z > 0) unite_range(z, z + 1, /*seam_only=*/true);
    }
  }

  // Final ids by sequential first-encounter raster scan, allocation-free
  // (no O(n) remap vector): smaller-root-wins makes every root the
  // component's MINIMUM voxel index, i.e. its first raster encounter.
  // After full path compression, roots renumber in place — parent[root]
  // is overwritten with the component id, and every later voxel of the
  // component reads it directly (its root index is always < its own).
  for (int64_t i = 0; i < n; ++i)
    if (in[i] != 0) uf.parent[i] = uf.find(static_cast<uint32_t>(i));
  uint32_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (in[i] == 0) {
      out[i] = 0;
      continue;
    }
    const uint32_t root = uf.parent[i];
    if (root == static_cast<uint32_t>(i)) {
      uf.parent[i] = ++count;
      out[i] = count;
    } else {
      out[i] = uf.parent[root];
    }
  }
  return count;
}

}  // namespace

extern "C" {

uint32_t cc3d_label_u32(const uint32_t* in, uint32_t* out, int64_t sz,
                        int64_t sy, int64_t sx, int connectivity) {
  return label_impl(in, out, sz, sy, sx, connectivity);
}

uint32_t cc3d_label_u64(const uint64_t* in, uint32_t* out, int64_t sz,
                        int64_t sy, int64_t sx, int connectivity) {
  return label_impl(in, out, sz, sy, sx, connectivity);
}

uint32_t cc3d_label_u8(const uint8_t* in, uint32_t* out, int64_t sz,
                       int64_t sy, int64_t sx, int connectivity) {
  return label_impl(in, out, sz, sy, sx, connectivity);
}

}  // extern "C"
