// int8 x int8 -> int32 3D convolution, any stride and dilation: the
// generic path of the real int8 leg's integer op (ops/int8_conv.py picks
// it by shape: the Hopper kernel of conv3d_int8.cu takes the stride-1,
// dilation-1 convolutions every family runs; this one the rest).
//
// Replaces no Pallas kernel: the JAX package's real int8 leg runs every
// activation-touched convolution as one XLA op,
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32)
// (chunkflow_tpu/inference/precision.py:294-298, _int8_conv).
//
//   out[b, n, od, oh, ow] = sum_{tz, ty, tx, c}
//       x[b, od*sz - pz + tz*dz, oh*sy - py + ty*dy, ow*sx - px + tx*dx, c]
//     * w[n, tz, ty, tx, c]                 (zero outside the input)
//
// Layouts: x channels-last int8 [B, D, H, W, P] with C <= P channels used
// (P, the position pitch, a multiple of 4), w int8 [N, kz, ky, kx, C]
// contiguous, out int32 [B, N, Do, Ho, Wo] (NCDHW). C is a multiple of 4
// (the wrapper pads the weights' channels with zeros, which add exactly;
// the input's channels past the real ones then meet zero weights).
//
// Design (the port's first int8 kernel): a tiled implicit GEMM. M =
// B*Do*Ho*Wo output positions, N output channels, K = kz*ky*kx*C, walked
// 32 at a time (the MMA depth; the tail is zero-filled). A block of 128
// threads (4 warps of 32x32) owns a BM x BN tile: BM = 64, BN = 64, or BM
// = 128, BN = 32 when N <= 32. Each K step gathers the A tile (the im2col
// rows, 4 bytes of channels per load) and the B tile from global memory
// into registers while the tensor cores work on the previous step's tiles
// in shared memory (two buffers, one barrier a step), then runs
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 over them. Shared rows
// are padded to 12 words so the fragment reads hit 32 distinct banks. The
// int32 accumulators are written straight from registers.
//
// Bound: max(2 * MACs / 1979e12, bytes / 3.35e12) on an H100 SXM. It ran
// the parity enc0 layer at 7.2% of that bound (PERF.md), which is why the
// stride-1 layers moved to conv3d_int8.cu. Nothing is allocated here.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBK = 32;      // K bytes per step (the MMA depth)
constexpr int kPitch = 12;   // shared words per tile row (8 + 4 of padding)

struct Shape {
  int B, D, H, W, C, P, N, kz, ky, kx, Do, Ho, Wo;
  int sz, sy, sx, pz, py, px, dz, dy, dx;
  int K;      // kz * ky * kx * C
  int S;      // Do * Ho * Wo
  long long M;  // B * S
};

__device__ __forceinline__ bool inside(int v, int n) {
  return static_cast<unsigned>(v) < static_cast<unsigned>(n);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kWarpsM x kWarpsN warps, each computing 32 x 32 outputs
template <int kWarpsM, int kWarpsN>
__global__ void __launch_bounds__(kThreads)
conv3d_int8_generic_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           int32_t* __restrict__ out, const Shape s) {
  constexpr int kBM = 32 * kWarpsM;
  constexpr int kBN = 32 * kWarpsN;
  constexpr int kRowsA = kBM / 16;  // A rows each thread loads per step
  constexpr int kRowsB = kBN / 16;  // B rows each thread loads per step
  static_assert(kWarpsM * kWarpsN * 32 == kThreads, "4 warps");

  __shared__ uint32_t As[2][kBM * kPitch];
  __shared__ uint32_t Bs[2][kBN * kPitch];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane >> 2;   // groupID
  const int tg = lane & 3;   // threadID_in_group
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's load slots: word column kw of rows tid/8 + 16 i
  const int kw = tid & 7;
  const int row0 = tid >> 3;
  // the input corner of each A row (od*sz - pz, ...) and its batch plane;
  // a row past M gets an impossible depth so every tap reads zero
  int a_b[kRowsA], a_z[kRowsA], a_y[kRowsA], a_x[kRowsA];
#pragma unroll
  for (int i = 0; i < kRowsA; ++i) {
    const long long m = m0 + row0 + 16 * i;
    if (m < s.M) {
      const int b = static_cast<int>(m / s.S);
      int r = static_cast<int>(m - static_cast<long long>(b) * s.S);
      const int od = r / (s.Ho * s.Wo);
      r -= od * s.Ho * s.Wo;
      const int oh = r / s.Wo;
      const int ow = r - oh * s.Wo;
      a_b[i] = b;
      a_z[i] = od * s.sz - s.pz;
      a_y[i] = oh * s.sy - s.py;
      a_x[i] = ow * s.sx - s.px;
    } else {
      a_b[i] = 0;
      a_z[i] = -(1 << 30);
      a_y[i] = 0;
      a_x[i] = 0;
    }
  }

  uint32_t ra[kRowsA], rb[kRowsB];
  auto load = [&](int k0) {
    const int k = k0 + 4 * kw;
    const bool kin = k < s.K;
    int tz = 0, ty = 0, tx = 0, c = 0;
    if (kin) {
      const int tap = k / s.C;
      c = k - tap * s.C;
      tz = tap / (s.ky * s.kx);
      const int r = tap - tz * s.ky * s.kx;
      ty = r / s.kx;
      tx = r - ty * s.kx;
    }
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) {
      const int z = a_z[i] + tz * s.dz;
      const int y = a_y[i] + ty * s.dy;
      const int xx = a_x[i] + tx * s.dx;
      uint32_t v = 0;
      if (kin && inside(z, s.D) && inside(y, s.H) && inside(xx, s.W)) {
        const size_t off =
            ((((static_cast<size_t>(a_b[i]) * s.D + z) * s.H + y) * s.W +
              xx) * s.P) + c;
        v = __ldg(reinterpret_cast<const uint32_t*>(x + off));
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) {
      const int n = n0 + row0 + 16 * i;
      uint32_t v = 0;
      if (kin && n < s.N) {
        v = __ldg(reinterpret_cast<const uint32_t*>(
            w + static_cast<size_t>(n) * s.K + k));
      }
      rb[i] = v;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kRowsA; ++i) As[buf][(row0 + 16 * i) * kPitch + kw] = ra[i];
#pragma unroll
    for (int i = 0; i < kRowsB; ++i) Bs[buf][(row0 + 16 * i) * kPitch + kw] = rb[i];
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  const int steps = (s.K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int cur = step & 1;
    const bool more = step + 1 < steps;
    if (more) load((step + 1) * kBK);  // in flight during the MMAs
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + g;
      a[mt][0] = As[cur][r * kPitch + tg];
      a[mt][1] = As[cur][(r + 8) * kPitch + tg];
      a[mt][2] = As[cur][r * kPitch + tg + 4];
      a[mt][3] = As[cur][(r + 8) * kPitch + tg + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = wn * 32 + nt * 8 + g;
      b[nt][0] = Bs[cur][r * kPitch + tg];
      b[nt][1] = Bs[cur][r * kPitch + tg + 4];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    if (more) store(cur ^ 1);
    __syncthreads();
  }

  // c0, c1: row g, columns 2 tg, 2 tg + 1; c2, c3: row g + 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + wm * 32 + mt * 16 + g + 8 * half;
      if (m >= s.M) continue;
      const int b = static_cast<int>(m / s.S);
      const long long sp = m - static_cast<long long>(b) * s.S;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * tg + e;
          if (n < s.N) {
            out[(static_cast<size_t>(b) * s.N + n) * s.S + sp] =
                acc[mt][nt][2 * half + e];
          }
        }
      }
    }
  }
}

}  // namespace

// x: int8 [B, D, H, W, P] channels-last, C of the P channels used; w:
// int8 [N, kz, ky, kx, C]; out: int32 [B, N, Do, Ho, Wo]. C % 4 == 0, P
// % 4 == 0, P >= C and 4-byte aligned pointers (the wrapper guarantees
// them).
extern "C" int conv3d_int8_generic_launch(
    const void* x, const void* w, void* out, int B, int D, int H, int W,
    int C, int P, int N, int kz, int ky, int kx, int Do, int Ho, int Wo,
    int sz, int sy, int sx, int pz, int py, int px, int dz, int dy, int dx,
    void* stream) {
  if (B < 1 || C < 4 || C % 4 || P < C || P % 4 || N < 1 || Do < 1 ||
      Ho < 1 || Wo < 1 ||
      kz < 1 || ky < 1 || kx < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{B, D, H, W, C, P, N, kz, ky, kx, Do, Ho, Wo,
          sz, sy, sx, pz, py, px, dz, dy, dx,
          kz * ky * kx * C, Do * Ho * Wo, 0};
  s.M = static_cast<long long>(B) * s.S;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  int32_t* o = static_cast<int32_t*>(out);
  if (N <= 32) {
    const long long tiles = (s.M + 127) / 128;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    conv3d_int8_generic_kernel<4, 1><<<dim3(static_cast<unsigned>(tiles), 1),
                               kThreads, 0, st>>>(xi, wi, o, s);
  } else {
    const long long tiles = (s.M + 63) / 64;
    if (tiles > 0x7fffffffLL || (N + 63) / 64 > 65535) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    conv3d_int8_generic_kernel<2, 2><<<dim3(static_cast<unsigned>(tiles),
                                    (N + 63) / 64),
                               kThreads, 0, st>>>(xi, wi, o, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv3d_int8_generic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
