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
// written once; one multiply per element is far below the card's rate. At
// the main path's shapes (a uint8 chunk, 2 x 20 x 256 x 256 patches) a
// launch moves 13 MB, a few microseconds at the card's rate, so its time
// is set by how many bytes are in flight against the memory's latency:
// loads of a byte per thread, one at a time, leave the card mostly idle.
// Here every read of such a launch is in flight at once, 16 bytes a copy.
//
// Design. The output rows of the launch, (b, c, k, i) in order, are one
// contiguous run of px floats each. A patch row wider than a tile holds
// (more than kTileBytes - 16 bytes) is cut into segments of that many
// bytes, the last one shorter; below, a "row" is one such segment, and
// every patch row of the main path is one segment. A block owns a tile of
// consecutive rows, so its output is one contiguous span.
//   1. The tile's threads find where each of its rows starts in the chunk.
//   2. They copy the 16-byte-aligned superset of every row, from
//      floor16(address of x0) to ceil16(address of x0 + px), into shared
//      memory with 16-byte cp.async copies, all issued before one wait.
//      The superset comes from the absolute address, so any x0, any row
//      pitch and a view with a storage offset all take this one path. The
//      bytes it reads beyond the row lie in 16-byte granules that hold a
//      byte of the chunk, so they are mapped memory; they are never used.
//   3. Each thread converts four consecutive output elements out of shared
//      memory (at each row's own byte offset) and writes them with one
//      16-byte store; the span's unaligned ends, at most three elements
//      each, take scalar stores.
// Grid: as many blocks as fit on the card at once (SMs x resident blocks
// per SM, queried once per device), and the rows spread evenly over them,
// so a launch is one full wave and nothing waits for a second; when the
// rows outnumber what the tiles hold, each block walks several tiles.
// kTileBytes is large enough that the main path's shapes, float32 chunks
// included, need one tile per block at the card's resident count.
// The starts table rides in the kernel's parameters (at most kMaxBatch
// rows per launch; the wrapper splits larger batches), so a launch needs
// no copy to the device. Nothing is allocated here.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBatch = 64;
// shared memory of a tile's row copies, and the most rows a tile holds
constexpr int kTileBytes = 24576;
constexpr int kMaxRows = 128;
constexpr int kMaxDevices = 16;

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

// the one conversion every element takes: exact int -> float32, then one
// multiply by the scale; float32 passes through
template <typename T>
__device__ __forceinline__ float convert(T v, float scale) {
  const float f = to_float(v);
  return std::is_same<T, float>::value ? f : __fmul_rn(f, scale);
}

// four elements in one shared-memory load
template <typename T> struct Vec4;
template <> struct Vec4<uint8_t> { using type = uchar4; };
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<uint16_t> { using type = ushort4; };
template <> struct Vec4<int16_t> { using type = short4; };
template <> struct Vec4<int32_t> { using type = int4; };
template <> struct Vec4<uint32_t> { using type = uint4; };
template <> struct Vec4<float> { using type = float4; };

// bytes between the starts of two rows of a tile: the row and up to 15
// bytes of alignment slack, rounded to 16
__host__ __device__ __forceinline__ int row_pitch(int row_bytes) {
  return (row_bytes + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile(
      "cp.async.commit_group;\n"
      "cp.async.wait_group 0;\n" ::
          : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ chunk, __grid_constant__ const Starts starts,
              float* __restrict__ out, int ci, int Z, int Y, int X, int pz,
              int py, int px, int seg, int rows_total, int tile_rows,
              float scale) {
  __shared__ __align__(16) unsigned char tile[kTileBytes];
  __shared__ const unsigned char* row_src[kMaxRows];  // 16-byte aligned
  __shared__ int row_head[kMaxRows];  // the row's first byte in its copy
  __shared__ int row_len[kMaxRows];   // the row's elements
  constexpr int kSize = static_cast<int>(sizeof(T));
  const int segs = (px + seg - 1) / seg;  // rows per patch row
  const int pitch = row_pitch(seg * kSize);
  const int slots = pitch / 16;
  const int tiles = (rows_total + tile_rows - 1) / tile_rows;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = t * tile_rows;
    const int rows = min(tile_rows, rows_total - r0);

    // 1. where each row starts: row r0 + r is segment s of patch row
    //    line = ((b * ci + c) * pz + k) * py + i
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int line = (r0 + r) / segs;
      const int s = r0 + r - line * segs;
      const int plane = line / py;
      const int i = line - plane * py;
      const int k = plane % pz;
      const int bc = plane / pz;
      const int c = bc % ci;
      const int b = bc / ci;
      const size_t offset =
          ((static_cast<size_t>(c) * Z + starts.zyx[3 * b] + k) * Y +
           starts.zyx[3 * b + 1] + i) *
              X +
          starts.zyx[3 * b + 2] + s * seg;
      const uintptr_t addr = reinterpret_cast<uintptr_t>(chunk + offset);
      row_src[r] = reinterpret_cast<const unsigned char*>(addr & ~uintptr_t{15});
      row_head[r] = static_cast<int>(addr & 15);
      row_len[r] = min(seg, px - s * seg);
    }
    __syncthreads();

    // 2. every row's aligned superset into shared memory, one wait
    for (int s = threadIdx.x; s < rows * slots; s += kThreads) {
      const int r = s / slots;
      const int g = s - r * slots;
      if (g * 16 < row_head[r] + row_len[r] * kSize) {
        copy16_async(tile + r * pitch + g * 16, row_src[r] + g * 16);
      }
    }
    wait_copies();
    __syncthreads();

    // 3. convert; 16-byte stores where the output is 16-byte aligned.
    // The tile's output starts `lead` elements into patch row line0 (at
    // its segment s0) and runs n elements.
    const int line0 = r0 / segs;
    const int s0 = r0 - line0 * segs;
    const int lead = s0 * seg;
    const int line1 = (r0 + rows) / segs;
    const int n = (line1 - line0) * px + (r0 + rows - line1 * segs) * seg - lead;
    // output element e of the tile is element j of its row r
    auto locate = [&](int e, int& r, int& j) {
      const int f = e + lead;
      const int rr = f / px;
      j = f - rr * px;
      const int s = segs > 1 ? j / seg : 0;
      j -= s * seg;
      r = rr * segs + s - s0;
    };
    auto element = [&](int r, int j) {
      return convert<T>(*reinterpret_cast<const T*>(
          tile + r * pitch + row_head[r] + j * kSize), scale);
    };
    float* dst = out + static_cast<size_t>(line0) * px + lead;
    const int head = min(
        n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) / 4);
    const int quads = (n - head) / 4;
    for (int q = threadIdx.x; q < quads; q += kThreads) {
      const int e = head + 4 * q;
      int r, j;
      locate(e, r, j);
      const int at = r * pitch + row_head[r] + j * kSize;
      float4 v;
      if (j + 4 <= row_len[r] && at % (4 * kSize) == 0) {
        // four elements of one row, one aligned shared-memory load
        const auto w = *reinterpret_cast<const typename Vec4<T>::type*>(tile + at);
        v = make_float4(convert<T>(w.x, scale), convert<T>(w.y, scale),
                        convert<T>(w.z, scale), convert<T>(w.w, scale));
      } else {
        float f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          f[u] = element(r, j);
          if (++j == row_len[r]) {
            j = 0;
            ++r;
          }
        }
        v = make_float4(f[0], f[1], f[2], f[3]);
      }
      *reinterpret_cast<float4*>(dst + e) = v;
    }
    for (int s = threadIdx.x; s < n - 4 * quads; s += kThreads) {
      const int e = s < head ? s : s + 4 * quads;
      int r, j;
      locate(e, r, j);
      dst[e] = element(r, j);
    }
    __syncthreads();  // the next tile reuses the shared arrays
  }
}

// gather_kernel<T>'s resident blocks per SM on device dev, and its SMs
template <typename T>
cudaError_t occupancy(int dev, int* per_sm, int* sms) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gather_kernel<T>, kThreads, 0);
}

// blocks of gather_kernel<T> the current device holds at once, queried
// once per device
template <typename T>
cudaError_t resident_blocks(int* blocks) {
  static int cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  err = occupancy<T>(dev, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

template <typename T>
int launch(const void* chunk, const Starts& starts, void* out, int B, int ci,
           int Z, int Y, int X, int pz, int py, int px, float scale,
           cudaStream_t stream) {
  // a row is at most a tile's worth of a patch row: a segment of 16-byte
  // multiples, so every segment of a patch row has its row's alignment
  const int seg = std::min(px, (kTileBytes - 16) / static_cast<int>(sizeof(T)));
  const int pitch = row_pitch(seg * static_cast<int>(sizeof(T)));
  int resident = 0;
  const cudaError_t err = resident_blocks<T>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long rows_total =
      static_cast<long long>(B) * ci * pz * py * ((px + seg - 1) / seg);
  if (rows_total > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // rows spread evenly over one wave of blocks, as far as a tile holds
  const long long even = (rows_total + resident - 1) / resident;
  const long long fit = std::min(kMaxRows, kTileBytes / pitch);
  const int tile_rows = static_cast<int>(std::min(fit, even));
  const long long tiles = (rows_total + tile_rows - 1) / tile_rows;
  const int grid = static_cast<int>(std::min<long long>(tiles, resident));
  gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(chunk), starts, static_cast<float*>(out), ci, Z,
      Y, X, pz, py, px, seg, static_cast<int>(rows_total), tile_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
struct Tag {
  using type = T;
};

// calls fn(Tag<T>{}) for the chunk type of a dtype code (see
// ops/gather.py _DTYPE_CODES)
template <typename F>
int with_dtype(int dtype_code, F&& fn) {
  switch (dtype_code) {
    case 0: return fn(Tag<uint8_t>{});
    case 1: return fn(Tag<int8_t>{});
    case 2: return fn(Tag<uint16_t>{});
    case 3: return fn(Tag<int16_t>{});
    case 4: return fn(Tag<int32_t>{});
    case 5: return fn(Tag<uint32_t>{});
    case 6: return fn(Tag<float>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int gather_max_batch() { return kMaxBatch; }

// starts: host [B, 3] int32 (B <= kMaxBatch), copied into the launch's
// parameters
extern "C" int gather_patches_launch(const void* chunk, int dtype_code,
                                     const int32_t* starts, int B, void* out,
                                     int ci, int Z, int Y, int X, int pz,
                                     int py, int px, float scale,
                                     void* stream) {
  if (B < 1 || B > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  Starts s;
  std::memcpy(s.zyx, starts, sizeof(int32_t) * 3 * B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype_code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return launch<T>(chunk, s, out, B, ci, Z, Y, X, pz, py, px, scale, st);
  });
}

// the kernel's resident blocks per SM on the current device, and the
// device's SM count
extern "C" int gather_occupancy(int dtype_code, int* blocks_per_sm,
                                int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return with_dtype(dtype_code, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return static_cast<int>(occupancy<T>(dev, blocks_per_sm, sms));
  });
}

extern "C" const char* gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
