// Surface-nets mesher: segmentation volume -> per-object triangle mesh.
// The port's copy of chunkflow_tpu/native/src/surface_nets.cpp, the native
// equivalent of the zmesh wheel used by the reference's mesh
// operator (chunkflow/flow/mesh.py:78-92). Surface nets places one vertex
// per boundary cell (the dual of marching cubes) and emits two triangles
// per boundary face — simpler than marching cubes, watertight on label
// volumes, and the standard choice for connectomics mesh pyramids.
//
// API contract (C ABI, ctypes-friendly): two-phase call. First call with
// vertices == faces == nullptr to get counts; then allocate and call again
// to fill. Vertices are in voxel units relative to the volume origin
// (caller scales by voxel size / adds global offset).
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

inline int64_t flat(int64_t z, int64_t y, int64_t x, int64_t sy, int64_t sx) {
  return (z * sy + y) * sx + x;
}

struct MeshAccum {
  std::vector<float> vertices;   // xyz triples, voxel units
  std::vector<uint32_t> faces;   // index triples
  std::unordered_map<int64_t, uint32_t> cell_vertex;  // cell id -> vertex idx
};

// one vertex per 2x2x2 cell that touches both inside and outside
template <typename T>
void mesh_object(const T* seg, int64_t sz, int64_t sy, int64_t sx, T obj,
                 MeshAccum& acc) {
  auto inside = [&](int64_t z, int64_t y, int64_t x) -> bool {
    if (z < 0 || z >= sz || y < 0 || y >= sy || x < 0 || x >= sx) return false;
    return seg[flat(z, y, x, sy, sx)] == obj;
  };
  auto cell_id = [&](int64_t cz, int64_t cy, int64_t cx) -> int64_t {
    // cells are indexed by minimum-corner voxel and range [-1, size-1]
    // along each axis; shift by +1 for a collision-free id
    return ((cz + 1) * (sy + 2) + (cy + 1)) * (sx + 2) + (cx + 1);
  };
  auto get_vertex = [&](int64_t cz, int64_t cy, int64_t cx) -> uint32_t {
    const int64_t id = cell_id(cz, cy, cx);
    auto it = acc.cell_vertex.find(id);
    if (it != acc.cell_vertex.end()) return it->second;
    const uint32_t idx = static_cast<uint32_t>(acc.vertices.size() / 3);
    // cell (cz,cy,cx) spans voxels [cz-? ...]; vertex at the cell center:
    // between voxel corners, i.e. at (cz+0.5, cy+0.5, cx+0.5) shifted -0.5
    acc.vertices.push_back(static_cast<float>(cx) + 0.5f);  // x
    acc.vertices.push_back(static_cast<float>(cy) + 0.5f);  // y
    acc.vertices.push_back(static_cast<float>(cz) + 0.5f);  // z
    acc.cell_vertex.emplace(id, idx);
    return idx;
  };
  // For each face between voxel v=(z,y,x) inside and neighbor outside,
  // emit a quad of the 4 dual cells around that face. Cells are indexed by
  // their minimum-corner voxel, ranging [-1, size-1] (offset by +0 here;
  // vertex coords handle the 0.5 shift). We iterate faces along each axis.
  auto emit_quad = [&](uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                       bool flip) {
    if (flip) {
      acc.faces.insert(acc.faces.end(), {a, c, b, a, d, c});
    } else {
      acc.faces.insert(acc.faces.end(), {a, b, c, a, c, d});
    }
  };
  for (int64_t z = 0; z < sz; ++z)
    for (int64_t y = 0; y < sy; ++y)
      for (int64_t x = 0; x < sx; ++x) {
        if (!inside(z, y, x)) continue;
        // +z face
        if (!inside(z + 1, y, x)) {
          const uint32_t a = get_vertex(z, y - 0, x - 0);
          const uint32_t b = get_vertex(z, y - 0, x - 1);
          const uint32_t c = get_vertex(z, y - 1, x - 1);
          const uint32_t d = get_vertex(z, y - 1, x - 0);
          emit_quad(a, b, c, d, false);
        }
        // -z face
        if (!inside(z - 1, y, x)) {
          const uint32_t a = get_vertex(z - 1, y - 0, x - 0);
          const uint32_t b = get_vertex(z - 1, y - 0, x - 1);
          const uint32_t c = get_vertex(z - 1, y - 1, x - 1);
          const uint32_t d = get_vertex(z - 1, y - 1, x - 0);
          emit_quad(a, b, c, d, true);
        }
        // +y face
        if (!inside(z, y + 1, x)) {
          const uint32_t a = get_vertex(z - 0, y, x - 0);
          const uint32_t b = get_vertex(z - 0, y, x - 1);
          const uint32_t c = get_vertex(z - 1, y, x - 1);
          const uint32_t d = get_vertex(z - 1, y, x - 0);
          emit_quad(a, b, c, d, true);
        }
        // -y face
        if (!inside(z, y - 1, x)) {
          const uint32_t a = get_vertex(z - 0, y - 1, x - 0);
          const uint32_t b = get_vertex(z - 0, y - 1, x - 1);
          const uint32_t c = get_vertex(z - 1, y - 1, x - 1);
          const uint32_t d = get_vertex(z - 1, y - 1, x - 0);
          emit_quad(a, b, c, d, false);
        }
        // +x face
        if (!inside(z, y, x + 1)) {
          const uint32_t a = get_vertex(z - 0, y - 0, x);
          const uint32_t b = get_vertex(z - 0, y - 1, x);
          const uint32_t c = get_vertex(z - 1, y - 1, x);
          const uint32_t d = get_vertex(z - 1, y - 0, x);
          emit_quad(a, b, c, d, false);
        }
        // -x face
        if (!inside(z, y, x - 1)) {
          const uint32_t a = get_vertex(z - 0, y - 0, x - 1);
          const uint32_t b = get_vertex(z - 0, y - 1, x - 1);
          const uint32_t c = get_vertex(z - 1, y - 1, x - 1);
          const uint32_t d = get_vertex(z - 1, y - 0, x - 1);
          emit_quad(a, b, c, d, true);
        }
      }
}

}  // namespace

extern "C" {

// Phase 1 (vertices==nullptr): returns 0, writes counts.
// Phase 2: fills caller-allocated buffers (n_vertices*3 floats,
// n_faces*3 uint32). Deterministic between phases for identical input.
int32_t surface_nets_mesh_u32(const uint32_t* seg, int64_t sz, int64_t sy,
                              int64_t sx, uint32_t obj, float* vertices,
                              uint32_t* faces, int64_t* n_vertices,
                              int64_t* n_faces) {
  MeshAccum acc;
  mesh_object(seg, sz, sy, sx, obj, acc);
  *n_vertices = static_cast<int64_t>(acc.vertices.size() / 3);
  *n_faces = static_cast<int64_t>(acc.faces.size() / 3);
  if (vertices != nullptr && faces != nullptr) {
    std::copy(acc.vertices.begin(), acc.vertices.end(), vertices);
    std::copy(acc.faces.begin(), acc.faces.end(), faces);
  }
  return 0;
}

}  // extern "C"
