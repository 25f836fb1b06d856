// Patch gather with in-kernel int -> float32 conversion.
//
// Replaces the Pallas TPU kernel chunkflow_tpu/ops/pallas_gather.py
// gather_patches. For every row b of the starts table and every channel c:
//
//   out[b, c, k, i, j] = convert(chunk[c, z_b + k, y_b + i, x_b + j])
//
// where convert is exact int -> float32 (round to nearest, as numpy's
// astype) followed by ONE float32 multiply by scale = float32(1/iinfo.max),
// and float32 passes through untouched. The result is bitwise the plain
// PyTorch version's (ops/gather.py gather_patches_plain).
//
// Bound: memory. Each input element is read once and each output element
// written once; one multiply per element is far below the card's rate.
// Design: the TPU kernel DMAs (sublane, 128)-aligned windows into VMEM
// because Mosaic needs tile-aligned copies; here there is no alignment
// rule, so each block reads its patch rows straight from the chunk.
// Grid: x = one (b, c, z) plane, y = a band of kRowsPerBlock patch rows
// (several blocks per plane keep the card full at small batches); the
// threads of a block walk x, so reads and writes coalesce. The starts
// table rides in the kernel's parameters (at most kMaxBatch rows per
// launch; the wrapper splits larger batches), so a launch needs no copy
// to the device. Nothing is allocated here.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kMaxBatch = 64;

struct Starts {
  int32_t zyx[3 * kMaxBatch];
};

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  // 8- and 16-bit ints are exact in float32
  return static_cast<float>(v);
}

template <>
__device__ __forceinline__ float to_float<int32_t>(int32_t v) {
  return __int2float_rn(v);
}

template <>
__device__ __forceinline__ float to_float<uint32_t>(uint32_t v) {
  return __uint2float_rn(v);
}

template <typename T, bool kScale>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ chunk, const Starts starts,
              float* __restrict__ out, int ci, int Z, int Y, int X, int pz,
              int py, int px, float scale) {
  const int plane = blockIdx.x;  // (b * ci + c) * pz + k
  const int k = plane % pz;
  const int bc = plane / pz;
  const int c = bc % ci;
  const int b = bc / ci;
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, py - row0);
  const int z = starts.zyx[3 * b] + k;
  const int y = starts.zyx[3 * b + 1] + row0;
  const int x0 = starts.zyx[3 * b + 2];
  const T* src =
      chunk + ((static_cast<size_t>(c) * Z + z) * Y + y) * X + x0;
  float* dst = out + (static_cast<size_t>(plane) * py + row0) * px;
  for (int r = 0; r < rows; ++r) {
    for (int j = threadIdx.x; j < px; j += kThreads) {
      const float v = to_float(src[static_cast<size_t>(r) * X + j]);
      dst[static_cast<size_t>(r) * px + j] = kScale ? __fmul_rn(v, scale) : v;
    }
  }
}

template <typename T, bool kScale>
int launch(const void* chunk, const Starts& starts, void* out, int B, int ci,
           int Z, int Y, int X, int pz, int py, int px, float scale,
           cudaStream_t stream) {
  const dim3 grid(B * ci * pz, (py + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_kernel<T, kScale><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(chunk), starts, static_cast<float*>(out), ci, Z,
      Y, X, pz, py, px, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_max_batch() { return kMaxBatch; }

// starts: host [B, 3] int32 (B <= kMaxBatch), copied into the launch's
// parameters. dtype codes: see ops/gather.py _DTYPE_CODES
extern "C" int gather_patches_launch(const void* chunk, int dtype_code,
                                     const int32_t* starts, int B, void* out,
                                     int ci, int Z, int Y, int X, int pz,
                                     int py, int px, float scale,
                                     void* stream) {
  if (B < 1 || B > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  Starts s;
  std::memcpy(s.zyx, starts, sizeof(int32_t) * 3 * B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return launch<uint8_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                   scale, st);
    case 1:
      return launch<int8_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                  scale, st);
    case 2:
      return launch<uint16_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                    scale, st);
    case 3:
      return launch<int16_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                   scale, st);
    case 4:
      return launch<int32_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                   scale, st);
    case 5:
      return launch<uint32_t, true>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                    scale, st);
    case 6:
      return launch<float, false>(chunk, s, out, B, ci, Z, Y, X, pz, py, px,
                                  scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
