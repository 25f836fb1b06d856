// int8 x int8 -> int32 3D convolution on Hopper: the real int8 leg's
// integer op, for every stride-1, dilation-1 layer the families run.
//
// Replaces no Pallas kernel: the JAX package's real int8 leg runs every
// activation-touched convolution as one XLA op,
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32)
// (chunkflow_tpu/inference/precision.py:294-298, _int8_conv). No PyTorch
// call on the card convolves int8 in 3D into int32, so this is that op,
// written by hand for sm_90a. The sums are exact int32 in any order, so
// the kernel may tile, split and reorder K freely; the quantize pass and
// the dequant stay torch ops in inference/precision.py. Strided or dilated
// convolutions (none on a family's path) run conv3d_int8_generic.cu, the
// mma.sync kernel; ops/int8_conv.py picks the path from the shape alone.
//
//   out[b, n, od, oh, ow] = sum_{tz, ty, tx, c}
//       x[b, od - pz + tz, oh - py + ty, ow - px + tx, c]
//     * w[n, c, tz, ty, tx]
//   (zero outside the input)
//
// Layouts. x: int8 channels-last [B, D, H, W, P]; the first Cp =
// round_up(C, 16) of each position's P bytes are read (P a multiple of
// 16: the quantize pass writes that layout, and the channels past C meet
// zero weights, so whatever they hold adds nothing). wpack: the weights as
// the K steps walk them (conv3d_int8_pack_kernel below). out: int32 [B,
// N, Do, Ho, Wo] (NCDHW, the model's layout).
//
// K order. A K step is 32 bytes of depth, the wgmma k. It is two
// sub-steps of 16 channels each; sub-step u = slab * T + tap walks the T
// taps of 16-channel slab 0, then of slab 1, ... (U = T * Cp / 16 of
// them; the steps are padded with zero weights to a multiple of 4). A
// split of K is a range of steps, so its halo holds only its slabs.
//
// Bound: max(2 * MACs / 1979e12, bytes / 3.35e12) on an H100 SXM, bytes
// counting each input and weight byte once and each int32 output once.
//   parity enc0 (2 x 28 x 20 x 256 x 256 by 28 x 28 x 3 x 3 x 3): 55.5 G
//   MACs = 56 us of int8 peak; 73.4 MB in + 293.6 MB out = 367 MB = 110
//   us of memory: bound by the output's bytes.
//   tpu_s2d4 bridge (2 x 256 x 5 x 8 x 8 by 256 x 256 x 3 x 3 x 3): 1.13 G
//   MACs = 1.1 us; 2.6 MB = 0.8 us: bound by operations, and in practice
//   by latency: 640 output rows, 6912 deep.
//
// Design, against each limit of the mma.sync kernel that came before it
// (now conv3d_int8_generic.cu; 7.2% of the enc0 bound on an H100):
// - Short K steps behind a block barrier, each decoding its tap with
//   divisions. Here a block loads its tile's operands once, then issues
//   the tile's K steps back to back, 4 per commit group, with no block
//   barrier; the per-sub-step halo offsets come from a table built once
//   per block, so the hot loop does no division.
// - Narrow, synchronous loads; every input byte gathered again per tap.
//   A block owns a tile of 128 output positions and loads the tile's halo
//   (the tile grown by the filter's reach) with one TMA load per 16-channel
//   slab from a 5-D tensor map over x, into one of two halo buffers (one
//   where two do not fit), issued by a producer warp for the next tile
//   while the consumers work.
//   TMA zero-fills coordinates outside the tensor, negative ones
//   included: that fill is the zero padding, with no branch. Every tap is
//   then a shifted view of the one halo. (A TMA im2col load per tap was
//   the alternative; it moves 27 times the halo through L2.)
// - mma.sync from 4 warps. Here wgmma.mma_async m64nBNk32 .s32.s8.s8 from
//   two consumer warpgroups (64 rows of the tile each), BN the output
//   channels rounded up to a width the instruction takes (8, 16, 32, 64,
//   128 or 256; wider N is tiled over blockIdx.y). A comes from registers:
//   each lane gives ldmatrix.x4 the halo address of its row's 16 bytes of
//   one sub-step, and the four 8 x 16-byte matrices are the warp's
//   m64nNk32 .s8 A fragment. A warpgroup's 64 rows are 8 groups of 8
//   positions contiguous along W, a uniform stride apart (a run of 64
//   positions, or an 8 x 8 block of x by y for outputs narrower than 64),
//   16 bytes a position: conflict-free. (wgmma reading A from shared
//   memory through a no-swizzle descriptor on the same halo ran slower
//   on the card.) B comes from shared memory through a 128-byte-swizzled
//   K-major descriptor: the pack kernel writes each output channel's 4 K
//   steps as one swizzled 128-byte row. The block keeps its whole filter
//   slice (its N tile and K range) resident when it fits (28 -> 28 at
//   3x3x3: 28 steps x 32 x 32 bytes), loaded once with one bulk copy;
//   otherwise (the 1.77 MB bridge) the producer warp streams it through an
//   mbarrier ring of K chunks, and that loop is a separate instance.
//   Accumulators stay in registers. Blocks are persistent over the M
//   tiles of their (N tile, K split), two to an SM where they fit, so one
//   block's epilogue overlaps the other's products.
// - Too few blocks on deep layers. When the M x N tiles cannot fill the
//   132 SMs, the K steps split into ranges over blockIdx.z (ops/int8_conv
//   computes the split from the shape), each range adding its sums into an
//   output the wrapper zeroed with red.global.add.s32 from the
//   accumulators: integer addition is exact in any order. The bridge goes
//   from 40 blocks walking 216 K steps each (the mma.sync kernel) to 108
//   walking 12.
// - A scattered epilogue. Each warpgroup stages 32 output channels of its
//   64 rows at a time in shared memory and writes them as 16-byte stores:
//   runs of 64 int32 (256 bytes) per output channel along W, where the
//   mma.sync kernel writes 4 bytes per thread from the fragments.
// Nothing is allocated here.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumerWarps = 8;                      // two warpgroups
constexpr int kThreads = 32 * (kConsumerWarps + 1);    // + a producer warp
constexpr int kRows = 64 * kConsumerWarps / 4;         // positions per tile
constexpr int kStageCols = 32;   // output channels staged per pass
constexpr int kStagePitch = 68;  // staged words per channel (64 rows + 4)
constexpr int kMaxStages = 8;
constexpr int kMaxHalo = 2;  // halo buffers: tiles loading ahead
constexpr int kGroup = 4;    // K steps per 128-byte swizzled weight row

// The launch plan, as ops/int8_conv.py's PLAN_FIELDS lists it (in order).
struct Plan {
  int B, D, H, W, pitch, cp, N, kz, ky, kx, Do, Ho, Wo, pz, py, px;
  int bn, n_tiles, bt, dt, ht, wt, m_tiles, splits, sps, steps;
  int kc, stages, resident, gx, sbo, halo_buffers;
  int slab_bytes, halo_bytes, stage_bytes, staging_bytes, table_bytes;
  int smem;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int K>
__device__ __forceinline__ void fence_acc(int (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a no-swizzle K-major wgmma operand descriptor: start address, LBO (the
// next 16 bytes of K), SBO (the next 8 rows), all in 16-byte units
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// a 128-byte-swizzled K-major descriptor: rows of 128 bytes (kGroup K
// steps), 8-row atoms 1024 bytes apart, the start advanced 32 bytes per
// K step inside the atom (the swizzle XORs the address bits in place)
__device__ __forceinline__ uint64_t make_desc_sw128(uint32_t addr) {
  return make_desc(addr, 16, 1024) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_n8(int (&d)[4],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_n16(int (&d)[8],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_n256(int (&d)[128],
    const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// m64 x BN x k32, A from registers, B from shared memory
template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2],
                                      const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BN == 8) wgmma_n8(d, a, db);
  if constexpr (BN == 16) wgmma_n16(d, a, db);
  if constexpr (BN == 32) wgmma_n32(d, a, db);
  if constexpr (BN == 64) wgmma_n64(d, a, db);
  if constexpr (BN == 128) wgmma_n128(d, a, db);
  if constexpr (BN == 256) wgmma_n256(d, a, db);
}

// The A fragments of kF consecutive K steps: lane L gives ldmatrix the
// halo address of its warp's row L % 16 in the sub-step of K half L / 16
template <int kF>
__device__ __forceinline__ void load_a(uint32_t (&f)[kF][4], int t0,
                                       uint32_t lrow, const int* table,
                                       int half) {
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    ldsm_x4(f[k], lrow + table[2 * (t0 + k) + half]);
  }
}

// kF products of consecutive K steps, the first at local step ls0 of the
// weights on at wb (128-byte swizzled rows of kGroup steps)
template <int BN, int kF>
__device__ __forceinline__ void mma_steps(int (&acc)[BN / 2],
                                          const uint32_t (&f)[kF][4],
                                          uint32_t wb, int ls0) {
#pragma unroll
  for (int k = 0; k < kF; ++k) {
    const int ls = ls0 + k;
    wgmma<BN>(acc, f[k],
              make_desc_sw128(wb + (ls / kGroup) * (BN * 128) +
                              (ls % kGroup) * 32));
  }
}

struct Pos {
  int b, z, y, x;
};

// the output corner of M tile mt
__device__ __forceinline__ Pos tile_of(int mt, const Plan& p) {
  const int nx = (p.Wo + p.wt - 1) / p.wt;
  const int ny = (p.Ho + p.ht - 1) / p.ht;
  const int nz = (p.Do + p.dt - 1) / p.dt;
  const int tx = mt % nx;
  int r = mt / nx;
  const int ty = r % ny;
  r /= ny;
  const int tz = r % nz;
  return {r / nz * p.bt, tz * p.dt, ty * p.ht, tx * p.wt};
}

// row m of a tile (row-major over bt x dt x ht x wt)
__device__ __forceinline__ Pos row_of(int m, const Plan& p) {
  return {m / (p.wt * p.ht * p.dt), m / (p.wt * p.ht) % p.dt,
          m / p.wt % p.ht, m % p.wt};
}

// One commit group of kF K steps from t (A in f); then, once the group
// before it is done with g and with its weight chunk, the next group's A
// into g. kStream: the weights stream through the ring, and a group that
// opens a chunk waits for it to land (a separate instance: the resident
// loop ran faster on the card without the ring's bookkeeping).
template <int BN, int kF, bool kStream>
__device__ __forceinline__ void group(
    int (&acc)[BN / 2], const uint32_t (&f)[kF][4], uint32_t (&g)[kF][4],
    int t, int grouped, const Plan& p, int q, uint32_t ring, uint32_t lrow,
    const int* table, int half, uint64_t* w_full, uint64_t* w_empty,
    int lane) {
  int ls = t;
  uint32_t wb = ring;
  if constexpr (kStream) {
    const int c = t / p.kc;
    const int st = (q + c) % p.stages;
    ls = t - c * p.kc;
    if (ls == 0) mbar_wait(&w_full[st], ((q + c) / p.stages) & 1);
    wb += st * p.stage_bytes;
  }
  wgmma_fence();
  mma_steps<BN, kF>(acc, f, wb, ls);
  wgmma_commit();
  if (t + kF < grouped) {
    wgmma_wait<1>();
    if constexpr (kStream) {
      if (ls == 0 && t > 0 && lane == 0) {  // chunk c - 1 is done
        mbar_arrive(&w_empty[(q + t / p.kc - 1) % p.stages]);
      }
    }
    load_a<kF>(g, t + kF, lrow, table, half);
  }
}

// Every K step of one tile: kF steps per commit group, each group's A
// fragments loaded (ldmatrix) while the previous group's products run.
template <int BN, int kF, bool kStream>
__device__ __forceinline__ void mainloop(
    int (&acc)[BN / 2], int grouped, const Plan& p, int q, uint32_t ring,
    uint32_t lrow, const int* table, int half, uint64_t* w_full,
    uint64_t* w_empty, int lane) {
  uint32_t fa[kF][4], fb[kF][4];
  load_a<kF>(fa, 0, lrow, table, half);
  for (int t = 0; t < grouped; t += 2 * kF) {
    group<BN, kF, kStream>(acc, fa, fb, t, grouped, p, q, ring, lrow, table,
                           half, w_full, w_empty, lane);
    if (t + kF < grouped) {
      group<BN, kF, kStream>(acc, fb, fa, t + kF, grouped, p, q, ring, lrow,
                             table, half, w_full, w_empty, lane);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, BN <= 64 ? 2 : 1)
conv3d_int8_hopper_kernel(const __grid_constant__ CUtensorMap xmap,
                          const int8_t* __restrict__ wpack,
                          int32_t* __restrict__ out, const Plan p) {
  constexpr int kAcc = BN / 2;
  constexpr int kCols = BN < kStageCols ? BN : kStageCols;
  constexpr int kF = BN == 256 ? 2 : 4;  // K steps per commit group
  extern __shared__ __align__(1024) uint8_t smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nt = blockIdx.y;
  const int T = p.kz * p.ky * p.kx;
  const int U = (p.cp >> 4) * T;
  const int s0 = blockIdx.z * p.sps;
  const int nsteps = min(p.steps, s0 + p.sps) - s0;
  const int sl0 = 2 * s0 / T;
  const int sl1 = (min(2 * (s0 + nsteps), U) - 1) / T;
  const int Wh = p.wt + p.kx - 1;
  const int Hh = p.ht + p.ky - 1;
  const int Dh = p.dt + p.kz - 1;

  uint8_t* ring = smem;  // [stages][stage_bytes], 1024-byte aligned
  uint8_t* halo = smem + p.stages * p.stage_bytes;  // [halo_buffers][...]
  int32_t* staging =
      reinterpret_cast<int32_t*>(halo + p.halo_buffers * p.halo_bytes);
  int* table = reinterpret_cast<int*>(reinterpret_cast<uint8_t*>(staging) +
                                      p.staging_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(table) + p.table_bytes);
  uint64_t* halo_full = bars;
  uint64_t* halo_empty = bars + kMaxHalo;
  uint64_t* w_full = bars + 2 * kMaxHalo;
  uint64_t* w_empty = bars + 2 * kMaxHalo + p.stages;

  // the shared byte offset of each sub-step of this K range: its slab's
  // place in the halo buffer plus its tap's shift
  const int grouped = (nsteps + kGroup - 1) / kGroup * kGroup;
  for (int i = tid; i < 2 * grouped; i += kThreads) {
    const int u = min(2 * s0 + i, U - 1);
    const int slab = u / T;
    const int tap = u - slab * T;
    const int tz = tap / (p.ky * p.kx);
    const int r = tap - tz * p.ky * p.kx;
    const int ty = r / p.kx;
    const int tx = r - ty * p.kx;
    table[i] = (slab - sl0) * p.slab_bytes + ((tz * Hh + ty) * Wh + tx) * 16;
  }
  if (tid == 0) {
    for (int i = 0; i < p.halo_buffers; ++i) {
      mbar_init(&halo_full[i], 1);
      mbar_init(&halo_empty[i], kConsumerWarps);
    }
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nchunks = (nsteps + p.kc - 1) / p.kc;
  // the packed weights hold whole groups of kGroup steps (zero-padded)
  const int packed = (p.steps + kGroup - 1) / kGroup * kGroup;
  if (warp == kConsumerWarps) {
    // ---- producer: one thread issues every copy ------------------------
    if (lane != 0) return;
    const int8_t* wsrc =
        wpack + (static_cast<size_t>(nt) * packed + s0) * (BN * 32);
    if (p.resident) {
      const uint32_t bytes = grouped * (BN * 32);
      mbar_expect_tx(&w_full[0], bytes);
      bulk_load(ring, wsrc, bytes, &w_full[0]);
    }
    const uint32_t halo_tx =
        (sl1 - sl0 + 1) * (16u * p.bt * Dh * Hh * Wh);
    int q = 0;
    int i = 0;
    for (int mt = blockIdx.x; mt < p.m_tiles; mt += gridDim.x, ++i) {
      const int hb = i % p.halo_buffers;
      mbar_wait(&halo_empty[hb], ((i / p.halo_buffers) & 1) ^ 1);
      const Pos tl = tile_of(mt, p);
      mbar_expect_tx(&halo_full[hb], halo_tx);
      for (int sl = sl0; sl <= sl1; ++sl) {
        tma_load_5d(halo + hb * p.halo_bytes + (sl - sl0) * p.slab_bytes,
                    &xmap, &halo_full[hb], sl * 16, tl.x - p.px,
                    tl.y - p.py, tl.z - p.pz, tl.b);
      }
      if (p.resident) continue;
      for (int c = 0; c < nchunks; ++c, ++q) {
        const int st = q % p.stages;
        mbar_wait(&w_empty[st], ((q / p.stages) & 1) ^ 1);
        const uint32_t bytes = min(p.kc, grouped - c * p.kc) * (BN * 32);
        mbar_expect_tx(&w_full[st], bytes);
        bulk_load(ring + st * p.stage_bytes,
                  wsrc + static_cast<size_t>(c) * p.kc * (BN * 32), bytes,
                  &w_full[st]);
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 rows of the tile each -------------
  // A warpgroup's 64 rows are 8 groups of 8 positions contiguous along W,
  // the groups p.sbo bytes apart in every slab of the halo (the plan's
  // tiles make that stride uniform): the no-swizzle K-major layout wgmma
  // reads A from, shifted by each sub-step's table offset.
  const int wg = warp >> 2;
  const int wi = warp & 3;
  uint32_t wg_base;
  {
    const Pos r = row_of(wg * 64, p);
    wg_base = (((r.b * Dh + r.z) * Hh + r.y) * Wh + r.x) * 16;
  }
  const uint32_t ring_u32 = smem_u32(ring);
  const int i16 = wi * 16 + (lane & 15);  // this lane's ldmatrix row
  const int half = lane >> 4;             // and K half
  int32_t* stage_wg = staging + wg * kCols * kStagePitch;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int tw = tid & 127;       // thread in the warpgroup
  const int r4 = (tw & 15) * 4;   // its 4 rows in the store loop
  // the tile rows of this thread's accumulators and of its stores
  const Pos racc[2] = {row_of(wg * 64 + wi * 16 + g, p),
                       row_of(wg * 64 + wi * 16 + g + 8, p)};
  const Pos rst = row_of(wg * 64 + r4, p);
  const bool add = p.splits > 1;
  const size_t plane = static_cast<size_t>(p.Do) * p.Ho * p.Wo;
  int q = 0;
  int i = 0;
  for (int mt = blockIdx.x; mt < p.m_tiles; mt += gridDim.x, ++i) {
    const int hb = i % p.halo_buffers;
    int acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0;
    if (p.resident) mbar_wait(&w_full[0], 0);
    mbar_wait(&halo_full[hb], (i / p.halo_buffers) & 1);
    const uint32_t hbase = smem_u32(halo + hb * p.halo_bytes) + wg_base;
    fence_acc(acc);
    const uint32_t lrow = hbase + (i16 >> 3) * p.sbo + (i16 & 7) * 16;
    if (p.resident) {
      mainloop<BN, kF, false>(acc, grouped, p, q, ring_u32, lrow, table,
                              half, w_full, w_empty, lane);
    } else {
      mainloop<BN, kF, true>(acc, grouped, p, q, ring_u32, lrow, table,
                             half, w_full, w_empty, lane);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) {
      if (!p.resident) {
        // the last group's chunk, and the one before when the last group
        // opened a chunk (group() releases the others)
        if (grouped > kF && (grouped - kF) % p.kc == 0) {
          mbar_arrive(&w_empty[(q + nchunks - 2) % p.stages]);
        }
        mbar_arrive(&w_empty[(q + nchunks - 1) % p.stages]);
      }
      mbar_arrive(&halo_empty[hb]);
    }
    if (!p.resident) q += nchunks;

    // epilogue. Element j of the accumulator is row 16 wi + g + 8 ((j >>
    // 1) & 1), channel 8 (j >> 2) + 2 tg + (j & 1).
    const Pos tl = tile_of(mt, p);
    if (add) {
      // a split of K: red.global.add straight from the accumulators
      size_t at[2];
      bool in[2];
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int b = tl.b + racc[e2].b, z = tl.z + racc[e2].z;
        const int y = tl.y + racc[e2].y, x = tl.x + racc[e2].x;
        in[e2] = b < p.B && z < p.Do && y < p.Ho && x < p.Wo;
        at[e2] = static_cast<size_t>(b) * p.N * plane +
                 (static_cast<size_t>(z) * p.Ho + y) * p.Wo + x;
      }
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int n = nt * BN + 8 * (j >> 2) + 2 * tg + (j & 1);
        const int e2 = (j >> 1) & 1;
        if (!in[e2] || n >= p.N) continue;
        asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(
                         out + at[e2] + static_cast<size_t>(n) * plane),
                     "r"(acc[j])
                     : "memory");
      }
      continue;
    }
    // the whole sum: kCols channels at a time through shared memory, each
    // thread storing rows r4..r4 + 3 of its warpgroup (4 consecutive x of
    // one (b, z, y)) as one 16-byte store where they are whole
    const int b = tl.b + rst.b;
    const int z = tl.z + rst.z;
    const int y = tl.y + rst.y;
    const int x = tl.x + rst.x;
    const bool inside = b < p.B && z < p.Do && y < p.Ho && x < p.Wo;
    const bool whole = p.Wo % 4 == 0 && x + 3 < p.Wo;
    const size_t at = static_cast<size_t>(b) * p.N * plane +
                      (static_cast<size_t>(z) * p.Ho + y) * p.Wo + x;
#pragma unroll
    for (int cg = 0; cg < BN / kCols; ++cg) {
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) {
        const int jj = cg * (kCols / 2) + j;
        const int col = 8 * (jj >> 2) + 2 * tg + (jj & 1) - cg * kCols;
        const int r = wi * 16 + g + 8 * ((jj >> 1) & 1);
        stage_wg[col * kStagePitch + r] = acc[jj];
      }
      named_sync(1 + wg);
      for (int col = tw >> 4; col < kCols; col += 8) {
        const int n = nt * BN + cg * kCols + col;
        if (!inside || n >= p.N) continue;
        const int4 val = *reinterpret_cast<const int4*>(
            &stage_wg[col * kStagePitch + r4]);
        int32_t* dst = out + at + static_cast<size_t>(n) * plane;
        if (whole) {
          *reinterpret_cast<int4*>(dst) = val;
          continue;
        }
        const int vals[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x + e < p.Wo) dst[e] = vals[e];
        }
      }
      named_sync(1 + wg);
    }
  }
}

// The packed weights: for N tile nt and group G of kGroup K steps, one
// 128-byte row per output channel n, 16-byte chunk c = 2 (s % kGroup) + h
// at physical chunk c ^ (n % 8). Chunk (s, h) holds w[nt * BN + n, 16 *
// slab + j, tap] for j < 16 of sub-step u = 2 s + h = slab * T + tap;
// zero past N, C or U. One thread per physical chunk: 16 channel reads
// (contiguous when the weights are channels-last), one 16-byte store.
__global__ void conv3d_int8_pack_kernel(const int8_t* __restrict__ w,
                                        int4* __restrict__ wpack, int N,
                                        int C, int ky, int kx, int T, int U,
                                        int groups, int bn, long long rows,
                                        long long sn, long long sc,
                                        long long sz, long long sy,
                                        long long sx) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < rows; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int pc = static_cast<int>(i & 7);
    long long r = i >> 3;
    const int n = static_cast<int>(r % bn);
    r /= bn;
    const int grp = static_cast<int>(r % groups);
    const int nn = static_cast<int>(r / groups) * bn + n;
    const int c = pc ^ (n & 7);
    const int u = 2 * (grp * kGroup + (c >> 1)) + (c & 1);
    const int slab = u / T;
    const int tap = u - slab * T;
    int4 v = make_int4(0, 0, 0, 0);
    if (u < U && nn < N) {
      const int8_t* src = w + nn * sn + (tap / (ky * kx)) * sz +
                          (tap / kx % ky) * sy + (tap % kx) * sx +
                          16 * slab * sc;
      if (sc == 1 && 16 * slab + 16 <= C &&
          reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        v = *reinterpret_cast<const int4*>(src);  // 16 whole channels
      } else {
        uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (16 * slab + j < C) {
            b[j >> 2] |= static_cast<uint32_t>(
                             static_cast<uint8_t>(src[j * sc]))
                         << (8 * (j & 3));
          }
        }
        v = make_int4(static_cast<int>(b[0]), static_cast<int>(b[1]),
                      static_cast<int>(b[2]), static_cast<int>(b[3]));
      }
    }
    wpack[i] = v;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the CUDA driver API's tensor-map encoder, fetched once through the
// runtime (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

template <int BN>
cudaError_t launch(const CUtensorMap& map, const int8_t* wpack, int32_t* out,
                   const Plan& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_int8_hopper_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  conv3d_int8_hopper_kernel<BN>
      <<<dim3(p.gx, p.n_tiles, p.splits), kThreads, p.smem, stream>>>(
          map, wpack, out, p);
  return cudaGetLastError();
}

}  // namespace

// w: int8 [N, C, kz, ky, kx] at the given element strides; wpack: int8
// [n_tiles * steps * 2 * bn * 16] (the layout above; steps, the packed
// K steps, a multiple of kGroup).
extern "C" int conv3d_int8_pack_launch(
    const void* w, void* wpack, int N, int C, int kz, int ky, int kx,
    long long sn, long long sc, long long sz, long long sy, long long sx,
    int cp, int steps, int bn, int n_tiles, void* stream) {
  const int T = kz * ky * kx;
  const long long rows = static_cast<long long>(n_tiles) * steps * 2 * bn;
  if (N < 1 || C < 1 || T < 1 || cp % 16 || cp < C || bn < 8 || rows < 1 ||
      steps % kGroup ||
      reinterpret_cast<uintptr_t>(wpack) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (rows + 255) / 256;
  conv3d_int8_pack_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks
                                                                  : 4096),
                            256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int4*>(wpack), N, C, ky,
      kx, T, cp / 16 * T, steps / kGroup, bn, rows, sn, sc, sz, sy, sx);
  return static_cast<int>(cudaGetLastError());
}

// x: int8 [B, D, H, W, pitch] channels-last, 16-byte aligned; wpack from
// conv3d_int8_pack_launch; out: int32 [B, N, Do, Ho, Wo], zeroed when
// plan.splits > 1. fields: the Plan, nfields ints.
extern "C" int conv3d_int8_launch(const void* x, const void* wpack,
                                  void* out, const int* fields, int nfields,
                                  void* stream) {
  if (nfields != static_cast<int>(sizeof(Plan) / sizeof(int))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  const int* src = fields;
  int* dst = reinterpret_cast<int*>(&p);
  for (int i = 0; i < nfields; ++i) dst[i] = src[i];
  if (p.pitch % 16 || p.cp % 16 || p.cp > p.pitch || p.stages < 1 ||
      p.halo_buffers < 1 || p.halo_buffers > kMaxHalo ||
      p.stages > kMaxStages || p.bt * p.dt * p.ht * p.wt != kRows ||
      p.smem > 232448 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wpack)) %
          16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t pitch = static_cast<cuuint64_t>(p.pitch);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(p.cp),
                              static_cast<cuuint64_t>(p.W),
                              static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.D),
                              static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[4] = {pitch, pitch * p.W, pitch * p.W * p.H,
                                 pitch * p.W * p.H * p.D};
  const cuuint32_t box[5] = {16, static_cast<cuuint32_t>(p.wt + p.kx - 1),
                             static_cast<cuuint32_t>(p.ht + p.ky - 1),
                             static_cast<cuuint32_t>(p.dt + p.kz - 1),
                             static_cast<cuuint32_t>(p.bt)};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int8_t* wp = static_cast<const int8_t*>(wpack);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.bn) {
    case 8: err = launch<8>(map, wp, o, p, st); break;
    case 16: err = launch<16>(map, wp, o, p, st); break;
    case 32: err = launch<32>(map, wp, o, p, st); break;
    case 64: err = launch<64>(map, wp, o, p, st); break;
    case 128: err = launch<128>(map, wp, o, p, st); break;
    case 256: err = launch<256>(map, wp, o, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* conv3d_int8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
