// The block-sparse and clustered matmuls on Hopper's tensor cores (sm_90a):
// the tensor-core route, for bf16 x, of four kernels that differ only in how
// one stored weight becomes wgmma's bf16 A operand, which a weight policy of
// block_sparse_kernels.cuh says (Parts<W> below):
//
//   y[m, n] = sum over kept K-blocks r, k of x[m, k] * w[k, n]
//
//   Codebook<I>    clustered_matmul, sonic_matmul: int8 or int32 cluster
//                  ids, w = codebook[id], the codebook (C fp32 centroids)
//                  staged in shared memory; three bf16 parts per centroid
//   Int8Scale      block_sparse_matmul_int8: int8 values, one bf16 part
//                  (exact); the kept block's fp32 scale is applied per chunk
//   Plain<float>   block_sparse_matmul, fp32 values: three bf16 parts,
//                  split in registers
//   Plain<bf16>    block_sparse_matmul, bf16 values: one part, as stored
//
// y (M, N) is fp32.  The dense case (kDense: clustered_matmul) is one
// N-block of width N whose K is walked in 64-row chunks; the block-sparse
// case walks the kept blocks of the tile's N-block, (Nb, R, bk, bn) raw
// values with (Nb, R) ascending K-block ids.
//
// Design:
//  * A and B swapped: one thread block computes y^T for 64 weight columns
//    (wgmma's M side) against a tile of T tokens (its N side, T in
//    {8, 32, 64, 256} chosen per launch, token_tile below), so 4 rows pad
//    to 8, not 64.  B, the x tile, is read from shared memory through a
//    wgmma descriptor in the 128-byte swizzled, K-major layout that TMA
//    writes (rows of 64 bf16 = 128 bytes, 8-row atoms of 1024 B).  A, the
//    weights as bf16 parts, is built where it costs least:
//      T <= 64: in registers, as wgmma's register fragment of A (each warp
//      16 weight columns), by one consumer warpgroup that builds the next
//      chunk's fragments while the current chunk's wgmma run;
//      T = 256: in shared memory (one 8 KB tile per part and chunk, double
//      buffered, in the descriptor's swizzled layout), built once by the
//      256 threads of two consumer warpgroups that take 128 tokens each.
//  * fp32 weights as three bf16 parts.  x in bf16 is exact; an fp32 weight
//    c (a centroid, or a Plain<float> value) is split into hi = bf16(c),
//    mid = bf16(c - hi), lo = bf16(c - hi - mid) (each difference is exact
//    in fp32), so hi + mid + lo carries it whole (24 mantissa bits in three
//    8-bit parts).  Two parts carry it to about 2^-16 relative, which is
//    not enough: at K = 1024 with unit-scale weights the output misses the
//    1e-4 the kernels are held to (tests/test_torch_codebook_mma.py and
//    tests/test_torch_block_mma.py show both).  split_codebook_bf16 in
//    kernels/sonic_matmul/kernel.py is the same arithmetic in PyTorch.  A
//    codebook is split once per block as it is staged, packed per centroid
//    as {hi | mid << 16, lo}; the int8 codebook is kept in 16 copies, one
//    per bank pair, and a thread looks up in its own, so a warp's random
//    lookups do not collide.  A Plain<float> value is split in registers as
//    its fragment is built.  Three wgmma per k16 step go into one fp32
//    tile.  An int8 value (|v| <= 128, 8 significant bits) and a bf16 value
//    are exact in one bf16 part: one wgmma per k16 step.
//  * Int8Scale reorders the Pallas kernel's x @ (w * s)
//    (src/repro/kernels/block_sparse_matmul/kernel.py:80-84) into s * (x @ w)
//    per chunk, both in fp32: a 64-column tile lies inside one N-block
//    (bn % 64 == 0) and a chunk of min(bk, 64) rows inside one kept block,
//    so each chunk's tile has one scale, s[j, r], which the consumer reads
//    beside the indices and applies as it adds the tile into the output:
//    out = fmaf(s, tile, out).
//  * A ring of kStages (3 to 16, by T and the raw type) shared-memory
//    stages, each holding one chunk's x tile (rows m0 .. m0 + T at K offset
//    idx[j, r] * bk + k0, 128-byte swizzled) and its raw weights (four TMA
//    boxes of chunk rows x 16 columns, one per warp, so a warp's fragment
//    loads hit distinct banks), loaded by TMA with completion on mbarriers.
//    One producer thread (in the warp after the consumers) keeps the ring
//    full and reads the kept-block indices itself.  Rows past M and K past
//    the edge arrive as zeros (TMA fills out of bounds with zero) and are
//    never stored.
//  * Sums in two levels.  The tensor cores add in fp32 but truncate (round
//    toward zero) as they add each k16 step into the accumulator, so a
//    chain over all of K drifts past 1e-4 at K = 2048 with unit weights.
//    Each chunk's kParts * chunk / 16 wgmma therefore run into a fresh
//    register tile (lo products first, then mid, then hi, so the small
//    terms are added while the tile is small), which the consumer adds into
//    the output tile on the CUDA cores (fp32, round to nearest; times the
//    block's scale for Int8Scale) once they are done.
//  * No split-K and no atomics: each output is one fp32 chain over the kept
//    blocks in ascending r and k, the same for every T, so two runs agree
//    bit for bit and a row's result does not depend on M.  All-zero
//    weights (or x) give exact zeros.
//  * Enough blocks: T is chosen per launch from M and the number of column
//    tiles, so a narrow projection or a few rows still spread over the
//    SMs.  At T <= 64 a block takes half the SM's shared memory (two blocks
//    per SM); small T leaves room for more stages (16 of 4 KB int8 values
//    at T = 8, 6 of 16 KB fp32 values or int32 ids), so more weight bytes
//    are in flight per SM.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*weights / 989 TFLOP/s); the
// three parts of an fp32 weight triple the tensor-core work, so their
// operations floor is 3 * 2*M*weights / 989 TFLOP/s.
//
// Taken when (kernels/build.py mma_route): x is bf16, and bk % 16 == 0 and
// bn % 64 == 0 (the block-sparse kernels), or K % 8 == 0 and N % 64 == 0
// (clustered_matmul; TMA needs 16-byte row strides).  Everything else keeps
// tiled_kernel (block_sparse_kernels.cuh) on the CUDA cores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_sparse_kernels.cuh"

namespace {
namespace mma {

constexpr int kCols = 64;         // weight columns per tile: wgmma's M side
constexpr int kChunkK = 64;       // K rows per stage: one 128-byte x row
constexpr int kGroupCols = 16;    // weight columns of one warp's A rows
constexpr int kSmemMax = 232448;  // 227 KB a block may use

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Threads of a block with a token tile of T: one consumer warpgroup per 128
// tokens (wgmma N = T / kGroups), then one producer warp.
template <int T>
struct Roles {
  static constexpr int kGroups = T > 128 ? 2 : 1;
  static constexpr int kN = T / kGroups;
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;
};

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v));
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// How a weight policy's raw values become wgmma's bf16 A parts: kParts
// parts per weight, in order hi, mid, lo; pair() turns the raw values of
// two consecutive k of one column into one register per part (the lower k
// in the low half).  A codebook is staged as kTable packed centroids in
// kCopies copies; cb is the thread's copy.
template <typename W>
struct Parts;

template <typename I>
struct Parts<Codebook<I>> {
  static constexpr int kParts = 3;
  static constexpr int kTable = Codebook<I>::kCodebook;
  // int8 ids: 16 copies of the (<= 128) packed centroids, copy r in bank
  // pair r, so a warp's random lookups do not collide; one copy of 1024
  static constexpr int kCopies = sizeof(I) == 1 ? 16 : 1;
  static __device__ __forceinline__ void pair(I a, I b, const uint2* cb, uint32_t (&o)[3]) {
    const uint2 u = cb[static_cast<int>(a) * kCopies];
    const uint2 v = cb[static_cast<int>(b) * kCopies];
    o[0] = __byte_perm(u.x, v.x, 0x5410);  // hi
    o[1] = __byte_perm(u.x, v.x, 0x7632);  // mid
    o[2] = __byte_perm(u.y, v.y, 0x5410);  // lo
  }
};

template <>
struct Parts<Int8Scale> {
  static constexpr int kParts = 1;
  static constexpr int kTable = 0, kCopies = 1;
  static __device__ __forceinline__ void pair(int8_t a, int8_t b, const uint2*,
                                              uint32_t (&o)[1]) {
    o[0] = bf16x2_bits(static_cast<float>(a), static_cast<float>(b));  // exact
  }
};

template <>
struct Parts<Plain<float>> {
  static constexpr int kParts = 3;
  static constexpr int kTable = 0, kCopies = 1;
  static __device__ __forceinline__ void pair(float a, float b, const uint2*, uint32_t (&o)[3]) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
    const float ra = a - __low2float(hi), rb = b - __high2float(hi);
    const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
    o[0] = *reinterpret_cast<const uint32_t*>(&hi);
    o[1] = *reinterpret_cast<const uint32_t*>(&mid);
    o[2] = bf16x2_bits(ra - __low2float(mid), rb - __high2float(mid));
  }
};

template <>
struct Parts<Plain<__nv_bfloat16>> {
  static constexpr int kParts = 1;
  static constexpr int kTable = 0, kCopies = 1;
  static __device__ __forceinline__ void pair(__nv_bfloat16 a, __nv_bfloat16 b, const uint2*,
                                              uint32_t (&o)[1]) {
    o[0] = bf16_bits(a) | bf16_bits(b) << 16;
  }
};

// Shared memory of one block, in order: kStages x tiles, kStages raw weight
// tiles, at T = 256 two A buffers (kParts 8 KB tiles each), the packed
// codebook (Codebook<I> only), the barriers.
template <typename W, int T>
struct Layout {
  using P = Parts<W>;
  static constexpr int kXBytes = T * kChunkK * 2;
  static constexpr int kRawBytes = kChunkK * kCols * (int)sizeof(typename W::Raw);
  static constexpr int kStageBytes = kXBytes + kRawBytes;
  static constexpr int kPartBytes = kCols * kChunkK * 2;
  static constexpr int kABytes = T > 64 ? P::kParts * kPartBytes : 0;
  static constexpr int kFixed =
      1024 /* alignment */ + 2 * kABytes + 8 * P::kCopies * P::kTable + 2 * 16 * 8;
  // T <= 64: half the SM, so two blocks share one and one's fragment
  // building hides behind the other's wgmma
  static constexpr int kBudget = T > 64 ? kSmemMax : kSmemMax / 2 - 1024;
  static constexpr int kStages = cmin(16, (kBudget - kFixed) / kStageBytes);
  static constexpr int kSmem = kFixed + kStages * kStageBytes;
  static_assert(kStages >= 3, "a ring of at least three stages");
};

struct Params {
  const float* codebook;  // Codebook<I>: (C,) fp32 centroids
  const float* scales;    // Int8Scale: (Nb, R) fp32, one per kept block
  const int* indices;     // (Nb, R) kept K-block ids; null when dense
  float* y;
  int C, M, N, R, bk, bn;
  int chunk;     // K rows per stage: 64 (dense) or min(bk, 64) = 16 * kSteps
  int n_chunks;  // chunks per tile: ceil(K / 64) or R * bk / chunk
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

// Descriptor of a K-major bf16 tile in the 128-byte swizzled layout: rows
// of 128 bytes, 8-row atoms 1024 bytes apart (SBO); LBO is unused.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, A (64 x 16 bf16) from registers, B (16 x N bf16) from
// shared memory through its descriptor, fp32 accumulate: d += A * B.
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};
// The same with A from shared memory through its descriptor (T = 256).
template <int N>
struct WgmmaSS;
template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(acc));
  }
};

// ------------------------------------------------------------ the kernel

// Codebook<I>: splits the C centroids into their three bf16 parts
// (split_codebook_bf16) and stages them packed, kCopies copies each, by the
// block's `threads` threads; the caller's next barrier publishes them.
template <typename W>
__device__ __forceinline__ void stage_parts(uint2* cb, const float* codebook, int C, int t,
                                            int threads) {
  using P = Parts<W>;
  if constexpr (P::kTable > 0) {
    for (int e = t; e < C * P::kCopies; e += threads) {
      const float c = __ldg(codebook + e / P::kCopies);
      const __nv_bfloat16 hi = __float2bfloat16_rn(c);
      const float r = c - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
      cb[e] = make_uint2(bf16_bits(hi) | bf16_bits(mid) << 16, bf16_bits(lo));
    }
  }
}

// One k16 step of a warp's A fragment, from the stage's raw weights: the
// warp's 16 weight columns are a [chunk][16] block of the raw tile (one TMA
// box per warp), and the thread's eight values are columns lane/4 (+8) at
// rows k0 + 2(lane%4) (+1, +8, +9), as wgmma's register layout of A wants
// them, turned into the parts' registers by the policy.
template <typename W>
__device__ __forceinline__ void a_fragment(const typename W::Raw* blk, const uint2* cb, int k0,
                                           int lane, uint32_t (&a)[Parts<W>::kParts][4]) {
  using P = Parts<W>;
  const int col = lane >> 2;
  const int row = k0 + 2 * (lane & 3);
  typename W::Raw v[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // register r: column col + 8 (r & 1), rows row + 8 (r >> 1)
    const typename W::Raw* p = blk + (row + 8 * (r >> 1)) * kGroupCols + col + 8 * (r & 1);
    v[2 * r] = p[0];
    v[2 * r + 1] = p[kGroupCols];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w[P::kParts];
    P::pair(v[2 * r], v[2 * r + 1], cb, w);
#pragma unroll
    for (int q = 0; q < P::kParts; ++q) a[q][r] = w[q];
  }
}

// T = 256: turns one chunk's raw weights into the kParts bf16 A tiles in
// shared memory (64 rows n x 64 k, 128-byte swizzled, as the descriptors
// read them), shared by the two consumer warpgroups; each thread writes one
// 16-byte run (8 consecutive k of one column) of every part at a time.
template <typename W, int kThreads, int kSteps>
__device__ __forceinline__ void dequant_to_smem(const typename W::Raw* raw, const uint2* cb,
                                                uint8_t* a, int t) {
  using P = Parts<W>;
  constexpr int kPartBytes = kCols * kChunkK * 2;
  constexpr int kRuns = kSteps * 2 * kCols;
  const uint2* mine = cb + (t & (P::kCopies - 1));
#pragma unroll
  for (int i = 0; i < (kRuns + kThreads - 1) / kThreads; ++i) {
    const int e = t + i * kThreads;
    if (kRuns % kThreads && e >= kRuns) break;  // bk = 16: half the threads
    const int n = e & (kCols - 1);
    const int g = e >> 6;  // 8-row group of k
    const typename W::Raw* col =
        raw + (n >> 4) * (kSteps * 16 * kGroupCols) + (n & (kGroupCols - 1));
    typename W::Raw v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = col[(g * 8 + q) * kGroupCols];
    uint32_t w[4][P::kParts];
#pragma unroll
    for (int h = 0; h < 4; ++h) P::pair(v[2 * h], v[2 * h + 1], mine, w[h]);
    const int off = n * 128 + ((g ^ (n & 7)) << 4);
#pragma unroll
    for (int q = 0; q < P::kParts; ++q)
      *reinterpret_cast<uint4*>(a + q * kPartBytes + off) =
          make_uint4(w[0][q], w[1][q], w[2][q], w[3][q]);
  }
}

// Adds one chunk's fresh tensor-core tile into the output tile on the CUDA
// cores, times the kept block's scale for Int8Scale.
template <typename W, int R>
__device__ __forceinline__ void add_tile(float (&acc)[R], const float (&part)[R], float s) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = W::kScaled ? fmaf(s, part[i], acc[i]) : acc[i] + part[i];
}

template <typename W, int T, int kSteps, bool kDense>
__global__ void __launch_bounds__(Roles<T>::kThreads, 1)
mma_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap raw_map,
           const Params p) {
  using Raw = typename W::Raw;
  using P = Parts<W>;
  using L = Layout<W, T>;
  using G = Roles<T>;
  constexpr int S = L::kStages;
  constexpr int kParts = P::kParts;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = base;                      // S x tiles, 1024-aligned each
  uint8_t* wt = xs + S * L::kXBytes;       // S raw weight tiles, [4 warps][chunk][16]
  uint8_t* abuf = wt + S * L::kRawBytes;   // T = 256: two A buffers, 1024-aligned
  uint2* cb = reinterpret_cast<uint2*>(abuf + 2 * L::kABytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(cb + P::kCopies * P::kTable);
  uint64_t* empty = full + S;

  const int t = threadIdx.x;
  int j = 0, c0 = blockIdx.x * kCols;  // N-block, first column of the tile in it
  if (!kDense) {
    const int tiles = p.bn / kCols;
    j = blockIdx.x / tiles;
    c0 = (blockIdx.x - j * tiles) * kCols;
  }
  const int m0 = blockIdx.y * T;
  const int per_block = kDense ? 1 : p.bk / p.chunk;  // chunks per kept block

  stage_parts<W>(cb, p.codebook, p.C, t, G::kThreads);
  if (t == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int block_elems = p.chunk * kGroupCols;  // one warp's raw weights per stage
  if (t >= G::kConsumers) {
    // Producer: one thread keeps the ring full.
    if (t == G::kConsumers) {
      const int raw_bytes = p.chunk * kCols * static_cast<int>(sizeof(Raw));
      for (int c = 0; c < p.n_chunks; ++c) {
        const int s = c % S;
        if (c >= S) mbar_wait(&empty[s], (c / S - 1) & 1);
        int xk, row;
        if (kDense) {
          xk = c * kChunkK;
          row = xk;
        } else {
          const int r = c / per_block;
          const int k0 = (c - r * per_block) * p.chunk;
          xk = __ldg(p.indices + j * p.R + r) * p.bk + k0;
          row = (j * p.R + r) * p.bk + k0;
        }
        mbar_expect_tx(&full[s], L::kXBytes + raw_bytes);
        tma_load_2d(xs + s * L::kXBytes, &x_map, &full[s], xk, m0);
        Raw* w = reinterpret_cast<Raw*>(wt + s * L::kRawBytes);
#pragma unroll
        for (int q = 0; q < kCols / kGroupCols; ++q)
          tma_load_2d(w + q * block_elems, &raw_map, &full[s], c0 + q * kGroupCols, row);
      }
    }
    return;
  }

  // The scale of chunk c's kept block (Int8Scale; 1 for the others).
  auto scale = [&](int c) {
    if constexpr (W::kScaled) return __ldg(p.scales + j * p.R + c / per_block);
    return 1.f;
  };
  const int g = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  float acc[G::kN / 2], part[G::kN / 2];
#pragma unroll
  for (int i = 0; i < G::kN / 2; ++i) acc[i] = part[i] = 0.f;

  if constexpr (T > 64) {
    // T = 256: two consumer warpgroups, group g owning tokens m0 + 128g ..
    // +128, share the A tiles, which all 256 threads build in shared memory
    // (so the conversions are not done twice).  Per chunk the kParts *
    // kSteps wgmma of each group run into `part` (zeroed by the first; lo,
    // then mid, then hi) while the next chunk is built into the other A
    // buffer; then `part` is added into `acc` as below.
    mbar_wait(&full[0], 0);
    dequant_to_smem<W, G::kConsumers, kSteps>(reinterpret_cast<const Raw*>(wt), cb, abuf, t);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // A visible to wgmma
    asm volatile("bar.sync 1, %0;" ::"n"(G::kConsumers) : "memory");
    for (int c = 0; c < p.n_chunks; ++c) {
      const int s = c % S;
      const float sc = scale(c);
      const uint32_t xa = smem_u32(xs + s * L::kXBytes + g * G::kN * 128);
      const uint32_t aa = smem_u32(abuf + (c & 1) * L::kABytes);
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int q = kParts - 1; q >= 0; --q)
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
          WgmmaSS<G::kN>::mma(part, desc_b128(aa + q * L::kPartBytes + k * 32),
                              desc_b128(xa + k * 32), q < kParts - 1 || k > 0);
      wgmma_commit();
      if (c + 1 < p.n_chunks) {
        const int s1 = (c + 1) % S;
        mbar_wait(&full[s1], ((c + 1) / S) & 1);
        dequant_to_smem<W, G::kConsumers, kSteps>(
            reinterpret_cast<const Raw*>(wt + s1 * L::kRawBytes), cb,
            abuf + ((c + 1) & 1) * L::kABytes, t);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      wgmma_wait<0>();
      fence_operands(part);
      add_tile<W>(acc, part, sc);
      mbar_arrive(&empty[s]);
      asm volatile("bar.sync 1, %0;" ::"n"(G::kConsumers) : "memory");
    }
  } else {
    // Consumer warpgroup.  Per chunk, each thread first builds its fragments
    // of all kSteps k16 steps (loads batched), then all kParts * kSteps
    // wgmma run into `part` (zeroed by the first): the lo products, then
    // mid, then hi, so the small terms are added while the tile is small.
    // `part` is then added into `acc` on the CUDA cores (fp32, round to
    // nearest), so the tensor cores' accumulation never carries more than
    // one chunk.  The next chunk's fragments (and scale) are built into a
    // second register set while the wgmma run.
    const uint2* mine = cb + (t & (P::kCopies - 1));
    uint32_t a0[kSteps][kParts][4], a1[kSteps][kParts][4];
    float s0 = 1.f, s1 = 1.f;

    auto build = [&](uint32_t (&a)[kSteps][kParts][4], float& sc, int c) {
      const int s = c % S;
      sc = scale(c);
      mbar_wait(&full[s], (c / S) & 1);
      const Raw* blk = reinterpret_cast<const Raw*>(wt + s * L::kRawBytes) + warp * block_elems;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) a_fragment<W>(blk, mine, 16 * k, lane, a[k]);
    };
    auto issue = [&](uint32_t (&a)[kSteps][kParts][4], int c) {
      const uint32_t xa = smem_u32(xs + (c % S) * L::kXBytes);
      fence_operands(part);
      wgmma_fence();
#pragma unroll
      for (int q = kParts - 1; q >= 0; --q)
#pragma unroll
        for (int k = 0; k < kSteps; ++k)
          Wgmma<T>::mma(part, a[k][q], desc_b128(xa + k * 32), q < kParts - 1 || k > 0);
      wgmma_commit();
    };
    auto finish = [&](float sc, int c) {
      wgmma_wait<0>();
      fence_operands(part);
      add_tile<W>(acc, part, sc);
      mbar_arrive(&empty[c % S]);
    };

    build(a0, s0, 0);
    for (int c = 0; c < p.n_chunks; c += 2) {
      issue(a0, c);
      if (c + 1 < p.n_chunks) build(a1, s1, c + 1);
      finish(s0, c);
      if (c + 1 >= p.n_chunks) break;
      issue(a1, c + 1);
      if (c + 2 < p.n_chunks) build(a0, s0, c + 2);
      finish(s1, c + 1);
    }
  }

  // Accumulator fragment: warp w of a group holds weight columns
  // 16w + lane/4 (+8); register 4i + {0, 1, 2, 3} is token 8i + 2*(lane%4)
  // (+1) of the group's tokens.
  const int n0 = j * p.bn + c0 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < G::kN / 8; ++i) {
    const int m = m0 + g * G::kN + i * 8 + 2 * (lane & 3);
    if (m < p.M) {
      p.y[(size_t)m * p.N + n0] = acc[4 * i];
      p.y[(size_t)m * p.N + n0 + 8] = acc[4 * i + 2];
    }
    if (m + 1 < p.M) {
      p.y[(size_t)(m + 1) * p.N + n0] = acc[4 * i + 1];
      p.y[(size_t)(m + 1) * p.N + n0 + 8] = acc[4 * i + 3];
    }
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A 2-D tensor map over a row-major (outer, inner) array.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int elem,
                     uint64_t inner, uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * elem};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-map element type of a policy's raw weights (TMA copies bits).
template <typename Raw>
constexpr CUtensorMapDataType raw_type() {
  return sizeof(Raw) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
         : sizeof(Raw) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                            : CU_TENSOR_MAP_DATA_TYPE_INT32;
}

template <typename W, int T, int kSteps, bool kDense>
cudaError_t launch_t(const __nv_bfloat16* x, int K, const typename W::Raw* raw, uint64_t raw_rows,
                     const Params& p, int tiles, cudaStream_t stream) {
  using L = Layout<W, T>;
  using Raw = typename W::Raw;
  if ((p.M + T - 1) / T > 65535) return cudaErrorInvalidValue;
  CUtensorMap x_map, raw_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, K, p.M, kChunkK, T,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&raw_map, raw_type<Raw>(), raw, sizeof(Raw), kDense ? p.N : p.bn, raw_rows,
                kGroupCols, p.chunk, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = mma_kernel<W, T, kSteps, kDense>;
  static unsigned long long ready = 0;  // devices the shared-memory size is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err == cudaSuccess) ready |= 1ull << dev;
  }
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, (p.M + T - 1) / T), Roles<T>::kThreads, L::kSmem, stream>>>(x_map,
                                                                                   raw_map, p);
  return cudaGetLastError();
}

// The token tile T: of 8, 32, 64 and 256, up to the smallest that holds
// M, the one with the least modelled time: ceil(blocks / SMs) waves of a
// chunk's time, 1000, 1150, 1400 and 2900 cycles (estimated for the
// codebook from launch times over K on an H100: chip_smoke.py phase 9,
// us_per_launch_by_shape).  Building A costs about as much per chunk as the
// wgmma of 64 tokens, so T = 256, which builds A once for 256 tokens,
// does the least work per token, and narrow tiles spread narrow
// projections and few rows over more SMs.  It depends on M and N only; a
// row's result does not depend on it.
inline int token_tile(int M, int tiles) {
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  constexpr int kTile[4] = {8, 32, 64, 256};
  constexpr int kCycles[4] = {1000, 1150, 1400, 2900};
  int best = 8;
  long long best_cost = -1;
  for (int i = 0; i < 4; ++i) {
    const long long blocks = static_cast<long long>(tiles) * ((M + kTile[i] - 1) / kTile[i]);
    const long long cost = (blocks + sms - 1) / sms * kCycles[i];
    if (best_cost < 0 || cost <= best_cost) {
      best = kTile[i];
      best_cost = cost;
    }
    if (kTile[i] >= M) break;
  }
  return best;
}

template <typename W, int kSteps, bool kDense>
cudaError_t launch(const __nv_bfloat16* x, int K, const typename W::Raw* raw, uint64_t raw_rows,
                   const Params& p, int tiles, cudaStream_t stream) {
  switch (token_tile(p.M, tiles)) {
    case 8: return launch_t<W, 8, kSteps, kDense>(x, K, raw, raw_rows, p, tiles, stream);
    case 32: return launch_t<W, 32, kSteps, kDense>(x, K, raw, raw_rows, p, tiles, stream);
    case 64: return launch_t<W, 64, kSteps, kDense>(x, K, raw, raw_rows, p, tiles, stream);
    default: return launch_t<W, 256, kSteps, kDense>(x, K, raw, raw_rows, p, tiles, stream);
  }
}

// clustered_matmul on the tensor cores: ids (K, N), K % 8 == 0, N % 64 == 0.
template <typename I>
cudaError_t launch_dense(const __nv_bfloat16* x, const I* ids, const float* codebook, int C,
                         float* y, int M, int K, int N, cudaStream_t stream) {
  if (M < 1 || K < 8 || K % 8 || N < kCols || N % kCols || C < 1 ||
      C > Codebook<I>::kCodebook) {
    return cudaErrorInvalidValue;
  }
  const Params p{codebook, nullptr, nullptr, y, C, M, N, 1, K, N, kChunkK,
                 (K + kChunkK - 1) / kChunkK};
  return launch<Codebook<I>, kChunkK / 16, true>(x, K, ids, K, p, N / kCols, stream);
}

// A block-sparse matmul on the tensor cores: raw weights (Nb, R, bk, bn) of
// policy W, bk a power of two from 16 to 128, bn a multiple of 64; the
// codebook (C centroids) for Codebook<int8_t>, the (Nb, R) scales for
// Int8Scale.
template <typename W>
cudaError_t launch_sparse(const __nv_bfloat16* x, const typename W::Raw* raw,
                          const float* codebook, int C, const float* scales, const int* indices,
                          float* y, int M, int K, int Nb, int R, int bk, int bn,
                          cudaStream_t stream) {
  if (M < 1 || Nb < 1 || R < 1 || bk < 16 || bk > kMaxBk || (bk & (bk - 1)) || bn < kCols ||
      bn % kCols || K % 8 || (Parts<W>::kTable > 0 && (C < 1 || C > Parts<W>::kTable))) {
    return cudaErrorInvalidValue;
  }
  const int chunk = cmin(bk, kChunkK);
  const Params p{codebook, scales, indices, y, C, M, Nb * bn, R, bk, bn, chunk,
                 R * (bk / chunk)};
  const uint64_t rows = static_cast<uint64_t>(Nb) * R * bk;
  const int tiles = Nb * (bn / kCols);
  switch (chunk / 16) {
    case 1: return launch<W, 1, false>(x, K, raw, rows, p, tiles, stream);
    case 2: return launch<W, 2, false>(x, K, raw, rows, p, tiles, stream);
    default: return launch<W, 4, false>(x, K, raw, rows, p, tiles, stream);
  }
}

}  // namespace mma
}  // namespace
