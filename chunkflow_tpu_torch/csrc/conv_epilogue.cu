// The pointwise epilogue of an RSUNet convolution, in place, in one pass.
//
// Replaces no TPU kernel: the JAX package (chunkflow_tpu/models/rsunet.py)
// writes the bias add, the folded batch norm, the residual or skip add and
// the ReLU as separate jnp operations and leaves their fusion to XLA. Here
// they were separate PyTorch passes over the whole convolution output; this
// kernel is all of them in one read and one write of it.
//
// y is the convolution's output [N, C, D, H, W] without its bias, laid out
// NCDHW-contiguous or channels_last_3d (NDHWC); other, when given, lies in
// y's layout and dtype. In order, each step rounded to y's dtype where the
// plain sequence (ops/conv_epilogue.py conv_epilogue_plain) rounds:
//
//   y = y + bias[c]
//   y = y * scale[c], then y = y + shift[c]   (when scale is given)
//   y = y + other                             (the residual or the skip)
//   y = relu(y)                               (when scale is given)
//
// In bfloat16 each step is one sm_90 bfloat16x2 instruction that rounds
// once to nearest even, which gives PyTorch's float32-then-round result for
// bfloat16 operands (see add2 below); in float32, __fadd_rn / __fmul_rn
// (the library is built with -fmad=false too, so nothing contracts to an
// FMA). The parameters arrive as float32 and are rounded to the compute
// dtype here, as .to(dtype) rounds them (params_bf16). The ReLU is
// PyTorch's clamp_min(y, 0): a NaN passes through, anything else is
// max(y, +0). Bitwise the plain sequence, NaN, infinities and signed zeros
// included.
//
// Bound: bytes. Each element of y is read and written once and other read
// once; a handful of operations per element is far below the card's rate,
// but with too few in flight they stall the loads. So:
// 16-byte vector loads and stores (8 bfloat16 or 4 float32), four of them in
// flight per thread (all loads issued before any arithmetic), bfloat16
// worked in pairs (a fifth of the instructions of widening each element to
// float32, rounding it back and widening it again); the C
// parameters of a launch rounded once per block into shared memory; a block
// per 4 x 256 vectors, thousands of blocks at the deep levels' widths. An
// element's channel comes from its flat index without a division in the
// loop: the block's first element is placed once (thread 0, 64-bit), and
// each vector from there by multiply-and-shift dividers; NDHWC is the case
// of channel runs one element long. y and other start 16-byte aligned (a
// convolution's output is a fresh allocation; the launcher refuses any
// other pointer); a vector cut by the end of y is finished element by element (the
// ragged tail). Nothing is allocated here.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// the parameters of a launch in shared memory: 3 x 2048 x 4 bytes
constexpr int kMaxChannels = 2048;

// n / d and n % d for n < 2^31 by a multiply-high and a shift (the magic
// number of d computed once on the host).
struct Divider {
  uint32_t d, magic, shift;

  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const {
    return n - div(n) * d;
  }
};

Divider make_divider(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (uint64_t{1} << shift) < d) ++shift;
  const uint64_t magic =
      ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - d)) / d + 1;
  return {d, static_cast<uint32_t>(magic), shift};
}

// bfloat16 pairs in a 32-bit word, each operation rounded once to nearest
// even (sm_90's add/mul .rn.bf16x2; .rn also keeps ptxas from contracting a
// multiply and an add). PyTorch computes a bfloat16 op in float32 and rounds
// the result: for two bfloat16 operands that is the same number, since their
// product is exact in float32, and so is their sum unless their exponents
// lie more than 16 apart, when the float32 rounding lies below the
// bfloat16 rounding's sticky bit and cannot move it.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// PyTorch's ReLU, clamp_min(v, 0): a NaN stays (the canonical NaN a
// rounded operation leaves), anything else is max(v, +0)
__device__ __forceinline__ uint32_t relu2(uint32_t a) {
  uint32_t d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

// a parameter (a float32 holding a bfloat16 value) as the bf16 bits of the
// low half
__device__ __forceinline__ uint32_t bits(float p) {
  return __float_as_uint(p) >> 16;
}

template <bool kAffine, bool kOther>
__device__ __forceinline__ uint32_t step2(uint32_t x, uint32_t other,
                                          uint32_t b, uint32_t s,
                                          uint32_t h) {
  uint32_t v = add2(x, b);
  if (kAffine) v = add2(mul2(v, s), h);
  if (kOther) v = add2(v, other);
  if (kAffine) v = relu2(v);
  return v;
}

// float32: each operation rounds by itself (__fadd_rn / __fmul_rn; the
// library is built with -fmad=false too)
template <bool kAffine, bool kOther>
__device__ __forceinline__ float step1(float x, float other, float b,
                                       float s, float h) {
  float v = __fadd_rn(x, b);
  if (kAffine) v = __fadd_rn(__fmul_rn(v, s), h);
  if (kOther) v = __fadd_rn(v, other);
  if (kAffine && !isnan(v)) v = fmaxf(v, 0.0f);
  return v;
}

template <typename T>
struct Vec {
  static constexpr int kWidth = 16 / sizeof(T);
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// one element of y, and of other (T() when absent), at channel c
template <bool kAffine, bool kOther>
__device__ __forceinline__ float apply1(float x, float other,
                                       const float* params, int c, int C) {
  return step1<kAffine, kOther>(x, other, params[c],
                                kAffine ? params[C + c] : 0.0f,
                                kAffine ? params[2 * C + c] : 0.0f);
}

template <bool kAffine, bool kOther>
__device__ __forceinline__ __nv_bfloat16 apply1(__nv_bfloat16 x,
                                               __nv_bfloat16 other,
                                               const float* params, int c,
                                               int C) {
  const uint32_t v = step2<kAffine, kOther>(
      __bfloat16_as_ushort(x), __bfloat16_as_ushort(other), bits(params[c]),
      kAffine ? bits(params[C + c]) : 0u,
      kAffine ? bits(params[2 * C + c]) : 0u);
  return __ushort_as_bfloat16(static_cast<unsigned short>(v));
}

// Element e lies in channel (e / inner) % C: inner is D * H * W for NCDHW
// and 1 for NDHWC. kStep: a vector may cross from one channel to the next
// (inner % V != 0), so its elements' channels are stepped one by one.
template <typename T, int V, bool kStep, bool kAffine, bool kOther>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(T* __restrict__ y, const T* __restrict__ other,
                     const float* __restrict__ bias,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, int64_t n, int C,
                     uint32_t inner, Divider div_c, Divider div_inner,
                     int params_bf16) {
  extern __shared__ float params[];  // bias, then scale and shift: C each
  __shared__ uint32_t first[2];      // the block's first channel, its place
  constexpr int kTile = kThreads * kUnroll * V;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;

  Pack<T, V> x[kUnroll], r[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t e =
        e0 + static_cast<int64_t>(u * kThreads + threadIdx.x) * V;
    if (e + V <= n) {
      x[u] = *reinterpret_cast<const Pack<T, V>*>(y + e);
      if (kOther) r[u] = *reinterpret_cast<const Pack<T, V>*>(other + e);
    }
  }
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float p[3] = {bias[c], kAffine ? scale[c] : 0.0f,
                        kAffine ? shift[c] : 0.0f};
    for (int k = 0; k < (kAffine ? 3 : 1); ++k)
      params[k * C + c] =
          params_bf16 ? __bfloat162float(__float2bfloat16_rn(p[k])) : p[k];
  }
  if (threadIdx.x == 0) {
    const int64_t run = e0 / inner;
    first[0] = static_cast<uint32_t>(run % C);
    first[1] = static_cast<uint32_t>(e0 - run * inner);
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const uint32_t o = static_cast<uint32_t>(u * kThreads + threadIdx.x) * V;
    const int64_t e = e0 + o;
    if (e >= n) break;
    // each element's channel: the first from the block's, the rest by
    // stepping along the vector
    const uint32_t t = first[1] + o;
    const uint32_t q = div_inner.div(t);
    uint32_t pos = t - q * inner, c = div_c.mod(first[0] + q), ch[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (kStep && j > 0 && ++pos == inner) {
        pos = 0;
        c = c + 1 == static_cast<uint32_t>(C) ? 0 : c + 1;
      }
      ch[j] = c;
    }
    if (e + V > n) {
      // the ragged tail: element by element
      for (int j = 0; j < static_cast<int>(n - e); ++j)
        y[e + j] = apply1<kAffine, kOther>(
            y[e + j], kOther ? other[e + j] : T(), params, ch[j], C);
      continue;
    }
    if constexpr (sizeof(T) == 2) {
      // bfloat16 pairs
      uint32_t* w = reinterpret_cast<uint32_t*>(x[u].v);
      const uint32_t* ow = reinterpret_cast<const uint32_t*>(r[u].v);
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const int lo = ch[2 * k], hi = ch[2 * k + 1];
        const auto pair = [&](int at) {
          return bits(params[at + lo]) | bits(params[at + hi]) << 16;
        };
        w[k] = step2<kAffine, kOther>(w[k], kOther ? ow[k] : 0u, pair(0),
                                      kAffine ? pair(C) : 0u,
                                      kAffine ? pair(2 * C) : 0u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        x[u].v[j] = apply1<kAffine, kOther>(x[u].v[j], r[u].v[j], params,
                                            ch[j], C);
    }
    *reinterpret_cast<Pack<T, V>*>(y + e) = x[u];
  }
}

template <typename T, int V, bool kStep>
cudaError_t launch_mode(T* y, const T* other, const float* bias,
                        const float* scale, const float* shift, int64_t n,
                        int C, uint32_t inner, int params_bf16,
                        cudaStream_t stream) {
  constexpr int64_t kTile = kThreads * kUnroll * V;
  const dim3 grid(static_cast<unsigned>((n + kTile - 1) / kTile));
  const Divider div_c = make_divider(C);
  const Divider div_inner = make_divider(inner);
  const size_t smem = (scale ? 3 : 1) * C * sizeof(float);
  const auto kernel =
      scale ? (other ? conv_epilogue_kernel<T, V, kStep, true, true>
                     : conv_epilogue_kernel<T, V, kStep, true, false>)
            : (other ? conv_epilogue_kernel<T, V, kStep, false, true>
                     : conv_epilogue_kernel<T, V, kStep, false, false>);
  kernel<<<grid, kThreads, smem, stream>>>(y, other, bias, scale, shift, n, C,
                                           inner, div_c, div_inner,
                                           params_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* y_, const void* other_, const float* bias,
                   const float* scale, const float* shift, int64_t n, int C,
                   uint32_t inner, int params_bf16, cudaStream_t stream) {
  T* y = static_cast<T*>(y_);
  const T* other = static_cast<const T*>(other_);
  constexpr int V = Vec<T>::kWidth;
  if (inner % V == 0)
    return launch_mode<T, V, false>(y, other, bias, scale, shift, n, C, inner,
                                    params_bf16, stream);
  return launch_mode<T, V, true>(y, other, bias, scale, shift, n, C, inner,
                                 params_bf16, stream);
}

}  // namespace

// y: N * C * D * H * W elements of bfloat16 (bf16 1) or float32, updated in
// place; element e in channel (e / inner) % C: inner = D * H * W for NCDHW,
// 1 for NDHWC. other: the residual or skip in y's layout and dtype, or
// null. bias: C float32; scale and shift: C float32 each, or both null
// (then no ReLU either). params_bf16 rounds the parameters to bfloat16
// first. n > 0, 0 < C <= 2048, 0 < inner < 2^31 - 2^14, y and other
// 16-byte aligned; anything else returns cudaErrorInvalidValue.
extern "C" int conv_epilogue_launch(void* y, const void* other,
                                    const float* bias, const float* scale,
                                    const float* shift, long long n, int C,
                                    long long inner, int bf16,
                                    int params_bf16, void* stream) {
  if (n <= 0 || C <= 0 || C > kMaxChannels || inner <= 0 ||
      inner >= (int64_t{1} << 31) - (int64_t{1} << 14) ||
      (scale == nullptr) != (shift == nullptr) ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(other) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t in32 = static_cast<uint32_t>(inner);
  return bf16 ? launch<__nv_bfloat16>(y, other, bias, scale, shift, n, C,
                                      in32, params_bf16, s)
              : launch<float>(y, other, bias, scale, shift, n, C, in32,
                              params_bf16, s);
}

extern "C" const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
