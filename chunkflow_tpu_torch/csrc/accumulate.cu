// Bump-weighted overlap-add of one batch of patch predictions.
//
// Replaces the Pallas TPU kernel chunkflow_tpu/ops/pallas_blend.py
// fused_accumulate_patches. For b = 0 .. B-1 in ascending order:
//
//   out[:, s_b : s_b + p]  += (pred[b] * bump) * valid[b]   (or pred[b] as-is
//                                                             when pre_weighted)
//   weight[s_b : s_b + p]  += bump * valid[b]
//
// in place. The JAX result depends on that order (lax.scatter_add applies
// duplicate updates in index order, and the TPU grid runs sequentially), so
// atomicAdd — whose order is not fixed — is out.
//
// Design, "owner computes": one launch per batch, over the union box of the
// batch's output windows (computed on the host from the starts table).
// Each thread owns one (z, y, x) voxel of the box and walks b = 0 .. B-1,
// adding each covering patch's contribution with __fmul_rn / __fadd_rn
// (no FMA contraction; the library is built with -fmad=false too), so every
// cell sees exactly the sequential sum: bitwise the plain PyTorch version's
// (ops/accumulate.py fused_accumulate_patches_plain). A thread covered by no
// window writes nothing. Each cell is read once and written once. A batch
// of more than kMaxBatch rows is split by the wrapper into launches in
// ascending order on one stream, which keeps every cell's order.
//
// Bound: memory — the prediction stack and the bump are read once, the
// covered out/weight cells read and written once; (3 co + 2) flops per
// covered voxel and patch are far below the card's rate. Grid: x = runs of
// kThreads voxels along x, y and z = the box's rows and planes, so no
// thread divides; neighbouring threads take neighbouring x and every stream
// coalesces. The starts table rides in the kernel's parameters. Nothing is
// allocated here.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 64;
constexpr int kMaxGridYZ = 65535;

struct Starts {
  int32_t zyx[3 * kMaxBatch];
};

__device__ __forceinline__ bool inside(int d, int p) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(p);
}

template <bool kPreWeighted>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(float* __restrict__ out, float* __restrict__ weight,
                  const float* __restrict__ preds,
                  const float* __restrict__ valid,
                  const float* __restrict__ bump, const Starts starts, int B,
                  int co, int Z, int Y, int X, int pz, int py, int px, int bz,
                  int by, int bx, int bdx) {
  const int lx = blockIdx.x * kThreads + threadIdx.x;
  if (lx >= bdx) return;
  const int z = bz + blockIdx.z;
  const int y = by + blockIdx.y;
  const int x = bx + lx;
  const size_t voxel = (static_cast<size_t>(z) * Y + y) * X + x;
  const size_t plane = static_cast<size_t>(Z) * Y * X;
  const size_t patch = static_cast<size_t>(pz) * py * px;

  float w = weight[voxel];
  bool covered = false;
  for (int b = 0; b < B; ++b) {
    const int dz = z - starts.zyx[3 * b];
    const int dy = y - starts.zyx[3 * b + 1];
    const int dx = x - starts.zyx[3 * b + 2];
    if (!inside(dz, pz) || !inside(dy, py) || !inside(dx, px)) continue;
    covered = true;
    const float bm = bump[(static_cast<size_t>(dz) * py + dy) * px + dx];
    w = __fadd_rn(w, __fmul_rn(bm, valid[b]));
  }
  if (!covered) return;
  weight[voxel] = w;

  for (int c = 0; c < co; ++c) {
    float s = out[c * plane + voxel];
    for (int b = 0; b < B; ++b) {
      const int dz = z - starts.zyx[3 * b];
      const int dy = y - starts.zyx[3 * b + 1];
      const int dx = x - starts.zyx[3 * b + 2];
      if (!inside(dz, pz) || !inside(dy, py) || !inside(dx, px)) continue;
      const size_t off = (static_cast<size_t>(dz) * py + dy) * px + dx;
      const float p = preds[(static_cast<size_t>(b) * co + c) * patch + off];
      const float contrib =
          kPreWeighted ? p : __fmul_rn(__fmul_rn(p, bump[off]), valid[b]);
      s = __fadd_rn(s, contrib);
    }
    out[c * plane + voxel] = s;
  }
}

}  // namespace

extern "C" int accumulate_max_batch() { return kMaxBatch; }

// starts: host [B, 3] int32 (B <= kMaxBatch), copied into the launch's
// parameters; box = (bz, by, bx, bdz, bdy, bdx), the union of the windows
extern "C" int accumulate_patches_launch(
    void* out, void* weight, const void* preds, const void* valid,
    const void* bump, const int32_t* starts, int B, int co, int Z, int Y,
    int X, int pz, int py, int px, int bz, int by, int bx, int bdz, int bdy,
    int bdx, int pre_weighted, void* stream) {
  if (B < 1 || B > kMaxBatch || bdx < 1 || bdy < 1 || bdz < 1 ||
      bdy > kMaxGridYZ || bdz > kMaxGridYZ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Starts s;
  std::memcpy(s.zyx, starts, sizeof(int32_t) * 3 * B);
  const dim3 grid((bdx + kThreads - 1) / kThreads, bdy, bdz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(weight);
  const float* p = static_cast<const float*>(preds);
  const float* v = static_cast<const float*>(valid);
  const float* bm = static_cast<const float*>(bump);
  if (pre_weighted) {
    accumulate_kernel<true><<<grid, kThreads, 0, st>>>(
        o, w, p, v, bm, s, B, co, Z, Y, X, pz, py, px, bz, by, bx, bdx);
  } else {
    accumulate_kernel<false><<<grid, kThreads, 0, st>>>(
        o, w, p, v, bm, s, B, co, Z, Y, X, pz, py, px, bz, by, bx, bdx);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* accumulate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
