// Device code shared by the port's SONIC matmul kernels, for Hopper (sm_90a).
//
// Every kernel of the port computes y (M, N) fp32 = x (M, K) @ W with x in
// bf16 or fp32, every product accumulated in fp32.  W is balanced
// block-sparse (values (Nb, R, bk, bn), indices (Nb, R) int32 ascending
// K-block ids) or dense; the kernels differ only in how one weight is
// stored, which a "weight policy" below says:
//
//   Int8Scale     int8 value × the kept block's fp32 scale
//   Codebook<I>   cluster id (int8 or int32) → codebook[id], the codebook
//                 (C fp32 centroids) staged in shared memory
//   Plain<V>      the fp32 or bf16 value itself
//
// Two kernel shapes take a policy:
//
//  * matvec_kernel, decode rows (1 ≤ M ≤ 7), int8-stored weights.  One
//    thread block per (N-block, slice of up to 32 columns); each thread owns
//    VEC adjacent columns (one 4-byte load per weight row) and the 256
//    threads split the bk rows among row groups.  Kept blocks are walked in
//    ascending r, four at a time: their x slices are staged in shared memory
//    as fp32 behind one barrier, and each thread issues 16 independent
//    weight loads before it uses any.  The row groups' partial sums are
//    reduced through shared memory in a fixed order: no atomics, the same
//    output from run to run.  Bound: bytes (each weight byte feeds ≤ 7
//    multiply-adds), so the design is about loads in flight.
//
//  * tiled_kernel, any M.  One thread block per (column tile of TW ≤ 128
//    columns, tile of BM rows); each of the 256 threads owns a TM × TN
//    register tile.  The kept blocks are walked in ascending r in chunks of
//    32 K rows: the gathered x chunk and the weight chunk (dequantized to
//    fp32) go through shared memory, the next chunk is fetched into
//    registers while the multiply-adds run.  The ragged M edge is masked in
//    the kernel (rows past M load 0 and are never stored).  A dense W (the
//    clustered kernel) is the case Nb = 1, bn = N, R = K / bk with the
//    identity for indices (kDense).  TW is 32 for M ≤ 32, else 128 (capped
//    by the block width), so a few rows still fill more of the card; it only
//    moves a column to another thread block.
//
// Neither shape splits K: each output is one fp32 chain over (r, k) in
// ascending order, so a row's result depends neither on M nor on the tile.
// Both run their products on the CUDA cores in fp32.  For bf16 x the four
// matmuls (clustered_matmul, sonic_matmul, block_sparse_matmul and
// block_sparse_matmul_int8) take the tensor-core kernel of block_mma.cuh
// instead (wgmma, TMA loads into a ring of stages, a producer warp; the
// same weight policies) wherever its tiles fit; tiled_kernel stays their
// route for fp32 x and small blocks.
//
// Everything here has internal linkage: each .cu file instantiates what its
// entry point launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 7;  // decode rows: M < DECODE_M_THRESHOLD = 8
constexpr int kMaxBk = 128;
constexpr int kMaxCodebookInt32 = 1024;  // centroids in shared memory for int32 ids

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------ weight policies

struct Int8Scale {
  using Raw = int8_t;
  static constexpr bool kScaled = true;
  static constexpr int kCodebook = 0;
  static __device__ __forceinline__ float dequant(Raw v, float s, const float*) {
    return static_cast<float>(v) * s;
  }
};

template <typename I>
struct Codebook {
  using Raw = I;
  static constexpr bool kScaled = false;
  // int8 ids are non-negative, so at most 128 centroids
  static constexpr int kCodebook = sizeof(I) == 1 ? 128 : kMaxCodebookInt32;
  static __device__ __forceinline__ float dequant(Raw v, float, const float* cb) {
    return cb[static_cast<int>(v)];
  }
};

template <typename V>
struct Plain {
  using Raw = V;
  static constexpr bool kScaled = false;
  static constexpr int kCodebook = 0;
  static __device__ __forceinline__ float dequant(Raw v, float, const float*) {
    return to_float(v);
  }
};

// Stage a policy's codebook in shared memory; the caller's next barrier
// publishes it.
template <typename W>
__device__ __forceinline__ void stage_codebook(float* cbs, const float* codebook, int C) {
  if constexpr (W::kCodebook > 0) {
    for (int i = threadIdx.x; i < C; i += kThreads) cbs[i] = __ldg(codebook + i);
  }
}

// ------------------------------------------------------------------ matvec

constexpr int kSliceThreads = 8;  // threads across one column slice
constexpr int kGroup = 4;         // kept blocks whose x is staged per barrier
constexpr int kBatch = 16;        // weight rows a thread loads before using them

// VEC adjacent int8-stored weights of one row: loaded raw, dequantized on use.
template <int VEC>
struct Int8Vec;
template <>
struct Int8Vec<4> {
  using type = char4;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return __ldg(reinterpret_cast<const char4*>(p));
  }
  template <typename W>
  static __device__ __forceinline__ void dequant(type v, float s, const float* cb,
                                                 float (&w)[4]) {
    w[0] = W::dequant(v.x, s, cb);
    w[1] = W::dequant(v.y, s, cb);
    w[2] = W::dequant(v.z, s, cb);
    w[3] = W::dequant(v.w, s, cb);
  }
};
template <>
struct Int8Vec<1> {
  using type = signed char;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return __ldg(reinterpret_cast<const signed char*>(p));
  }
  template <typename W>
  static __device__ __forceinline__ void dequant(type v, float s, const float* cb,
                                                 float (&w)[1]) {
    w[0] = W::dequant(v, s, cb);
  }
};

__host__ __device__ __forceinline__ int slice_threads(int bn, int vec) {
  return bn / vec < kSliceThreads ? bn / vec : kSliceThreads;
}

template <typename T, typename W, int M, int VEC>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x, const int8_t* __restrict__ values,
              const float* __restrict__ scales, const float* __restrict__ codebook, int C,
              const int* __restrict__ indices, float* __restrict__ y, int K, int N, int R,
              int bk, int bn) {
  static_assert(sizeof(typename W::Raw) == 1, "the matvec streams 1-byte weights");
  constexpr int kXStride = kGroup * kMaxBk;  // per-row stride of xs
  __shared__ float xs[M * kXStride];         // x of the group's kept blocks, (m, r, k)
  __shared__ float ss[kGroup];               // the group's scales (Int8Scale)
  __shared__ float cbs[W::kCodebook > 0 ? W::kCodebook : 1];
  __shared__ float part[kThreads * VEC * M];

  const int tcols = slice_threads(bn, VEC);
  const int sw = tcols * VEC;          // slice width in columns
  const int trows = kThreads / tcols;  // row groups
  const int slices = bn / sw;
  const int j = blockIdx.x / slices;
  const int c0 = (blockIdx.x - j * slices) * sw;
  const int t = threadIdx.x;
  const int tc = t % tcols;
  const int tr = t / tcols;
  const int col = c0 + tc * VEC;  // first column (within the N-block) this thread owns
  const int bk_shift = 31 - __clz(bk);  // bk is a power of two

  stage_codebook<W>(cbs, codebook, C);
  float acc[M][VEC];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;

  // Kept blocks in ascending r, kGroup at a time.  The group's rows
  // (g * bk of them, contiguous in `values`) are dealt to the row groups
  // round-robin; each thread loads kBatch rows before it uses any.
  for (int r0 = 0; r0 < R; r0 += kGroup) {
    const int g = R - r0 < kGroup ? R - r0 : kGroup;
    const int rows = g * bk;
    __syncthreads();  // every thread is done with the previous group
    for (int e = t; e < M * rows; e += kThreads) {
      const int m = e / rows;
      const int rk = e - m * rows;  // (kept block within group) * bk + k
      const int rr = rk >> bk_shift;
      const int kblk = __ldg(indices + j * R + r0 + rr);
      xs[m * kXStride + rk] =
          to_float(x[(size_t)m * K + (size_t)kblk * bk + (rk - (rr << bk_shift))]);
    }
    if (W::kScaled && t < g) ss[t] = __ldg(scales + j * R + r0 + t);
    __syncthreads();
    const int8_t* base = values + (size_t)(j * R + r0) * bk * bn + col;
    for (int e0 = tr; e0 < rows; e0 += kBatch * trows) {
      typename Int8Vec<VEC>::type raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * trows;
        if (e < rows) raw[u] = Int8Vec<VEC>::load(base + (size_t)e * bn);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * trows;
        if (e < rows) {
          float w[VEC];
          Int8Vec<VEC>::template dequant<W>(raw[u], W::kScaled ? ss[e >> bk_shift] : 0.f,
                                            cbs, w);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const float xv = xs[m * kXStride + e];
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
          }
        }
      }
    }
  }

  // Fixed-order reduction of the row groups' partial sums (no atomics).
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < VEC; ++c) part[(tr * M + m) * sw + tc * VEC + c] = acc[m][c];
  __syncthreads();
  for (int o = t; o < M * sw; o += kThreads) {
    const int m = o / sw;
    const int c = o - m * sw;
    float sum = 0.f;
    for (int g = 0; g < trows; ++g) sum += part[(g * M + m) * sw + c];
    y[(size_t)m * N + (size_t)j * bn + c0 + c] = sum;
  }
}

template <typename T, typename W, int M>
cudaError_t launch_matvec_rows(const T* x, const int8_t* values, const float* scales,
                               const float* codebook, int C, const int* indices, float* y,
                               int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (bn % 4 == 0) {
    const int slices = bn / (slice_threads(bn, 4) * 4);
    matvec_kernel<T, W, M, 4><<<Nb * slices, kThreads, 0, stream>>>(
        x, values, scales, codebook, C, indices, y, K, Nb * bn, R, bk, bn);
  } else {
    const int slices = bn / slice_threads(bn, 1);
    matvec_kernel<T, W, M, 1><<<Nb * slices, kThreads, 0, stream>>>(
        x, values, scales, codebook, C, indices, y, K, Nb * bn, R, bk, bn);
  }
  return cudaGetLastError();
}

// Launches the matvec for M = 1..7 on `stream`; returns cudaGetLastError().
template <typename T, typename W>
cudaError_t launch_matvec(const T* x, const int8_t* values, const float* scales,
                          const float* codebook, int C, const int* indices, float* y, int M,
                          int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (bk < 1 || bk > kMaxBk || bn < 1 || bn > 128 || Nb < 1 || R < 1) {
    return cudaErrorInvalidValue;
  }
#define SONIC_MATVEC_ROWS(m)                                                                \
  case m:                                                                                   \
    return launch_matvec_rows<T, W, m>(x, values, scales, codebook, C, indices, y, K, Nb, R, \
                                       bk, bn, stream);
  switch (M) {
    SONIC_MATVEC_ROWS(1)
    SONIC_MATVEC_ROWS(2)
    SONIC_MATVEC_ROWS(3)
    SONIC_MATVEC_ROWS(4)
    SONIC_MATVEC_ROWS(5)
    SONIC_MATVEC_ROWS(6)
    SONIC_MATVEC_ROWS(7)
    default: return cudaErrorInvalidValue;
  }
#undef SONIC_MATVEC_ROWS
}

// ------------------------------------------------------------------- tiled

constexpr int kChunk = 32;  // K rows of a kept block staged per step

__host__ __device__ constexpr int log2_pow2(int v) { return v <= 1 ? 0 : 1 + log2_pow2(v / 2); }

// Thread tiling for a column tile of width TW.
template <int TW>
struct Tile {
  static constexpr int TN = TW < 4 ? TW : 4;        // columns per thread
  static constexpr int TCOL = TW / TN;              // threads across columns
  static constexpr int TROW = kThreads / TCOL;      // threads across rows
  static constexpr int BM = TROW > 32 ? TROW : 32;  // rows per tile
  static constexpr int TM = BM / TROW;              // rows per thread
  static constexpr int XPT = BM * kChunk / kThreads;                   // x values per thread
  static constexpr int WPT = (kChunk * TW + kThreads - 1) / kThreads;  // weights per thread
  static constexpr int SHIFT = log2_pow2(TW);
};

template <typename T, typename W, int TW, bool kDense>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const T* __restrict__ x, const typename W::Raw* __restrict__ values,
             const float* __restrict__ scales, const float* __restrict__ codebook, int C,
             const int* __restrict__ indices, float* __restrict__ y, int M, int K, int N, int R,
             int bk, int bn) {
  using P = Tile<TW>;
  using Raw = typename W::Raw;
  __shared__ float xs[P::BM][kChunk + 1];  // +1: rows of different threads hit different banks
  __shared__ __align__(16) float ws[kChunk * TW];
  __shared__ float cbs[W::kCodebook > 0 ? W::kCodebook : 1];

  const int slices = bn / TW;
  const int j = blockIdx.x / slices;                  // N-block
  const int c0 = (blockIdx.x - j * slices) * TW;      // first column of the tile in it
  const int m0 = blockIdx.y * P::BM;                  // first row of the tile
  const int t = threadIdx.x;
  const int tc = t % P::TCOL;
  const int tr = t / P::TCOL;
  const int chunk = bk < kChunk ? bk : kChunk;
  const int chunk_shift = 31 - __clz(chunk);  // chunk is a power of two
  const int per_block = bk >> chunk_shift;    // chunks per kept block
  const int n_chunks = R * per_block;

  stage_codebook<W>(cbs, codebook, C);
  float acc[P::TM][P::TN];
#pragma unroll
  for (int i = 0; i < P::TM; ++i)
#pragma unroll
    for (int c = 0; c < P::TN; ++c) acc[i][c] = 0.f;

  // Chunk c of the (r ascending, k ascending) walk, fetched into registers:
  // x rows m0.. at K-block idx[j,r] (rows past M read as 0) and the weight
  // rows of the tile (row stride bn in `values`).
  float xr[P::XPT];
  Raw wr[P::WPT];
  float s_next = 0.f;
  auto fetch = [&](int c) {
    const int r = c / per_block;
    const int k0 = (c - r * per_block) << chunk_shift;
    if (W::kScaled) s_next = __ldg(scales + j * R + r);
    const int kblk = kDense ? r : __ldg(indices + j * R + r);
    const T* xp = x + (size_t)kblk * bk + k0;
#pragma unroll
    for (int u = 0; u < P::XPT; ++u) {
      const int e = t + u * kThreads;
      const int i = e >> chunk_shift;
      const int row = m0 + i;
      xr[u] = (i < P::BM && row < M) ? to_float(xp[(size_t)row * K + (e & (chunk - 1))]) : 0.f;
    }
    const Raw* wp = values + ((size_t)(j * R + r) * bk + k0) * bn + c0;
#pragma unroll
    for (int u = 0; u < P::WPT; ++u) {
      const int e = t + u * kThreads;
      wr[u] = e < chunk * TW ? __ldg(wp + (size_t)(e >> P::SHIFT) * bn + (e & (TW - 1)))
                             : Raw{};
    }
  };

  fetch(0);
  for (int c = 0; c < n_chunks; ++c) {
    const float s = s_next;
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int u = 0; u < P::XPT; ++u) {
      const int e = t + u * kThreads;
      const int i = e >> chunk_shift;
      if (i < P::BM) xs[i][e & (chunk - 1)] = xr[u];
    }
#pragma unroll
    for (int u = 0; u < P::WPT; ++u) {
      const int e = t + u * kThreads;
      if (e < chunk * TW) ws[e] = W::dequant(wr[u], s, cbs);
    }
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);  // in flight during the multiply-adds below
    for (int kk = 0; kk < chunk; ++kk) {
      float a[P::TM];
      float b[P::TN];
#pragma unroll
      for (int i = 0; i < P::TM; ++i) a[i] = xs[tr * P::TM + i][kk];
      if constexpr (P::TN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[kk * TW + tc * 4]);
        b[0] = v.x;
        b[1] = v.y;
        b[2] = v.z;
        b[3] = v.w;
      } else {
#pragma unroll
        for (int c2 = 0; c2 < P::TN; ++c2) b[c2] = ws[kk * TW + tc * P::TN + c2];
      }
#pragma unroll
      for (int i = 0; i < P::TM; ++i)
#pragma unroll
        for (int c2 = 0; c2 < P::TN; ++c2) acc[i][c2] = fmaf(a[i], b[c2], acc[i][c2]);
    }
  }

#pragma unroll
  for (int i = 0; i < P::TM; ++i) {
    const int row = m0 + tr * P::TM + i;
    if (row < M) {
#pragma unroll
      for (int c = 0; c < P::TN; ++c)
        y[(size_t)row * N + (size_t)j * bn + c0 + tc * P::TN + c] = acc[i][c];
    }
  }
}

template <typename T, typename W, int TW, bool kDense>
cudaError_t launch_tiled_tw(const T* x, const typename W::Raw* values, const float* scales,
                            const float* codebook, int C, const int* indices, float* y, int M,
                            int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  const int tiles = (M + Tile<TW>::BM - 1) / Tile<TW>::BM;
  if (tiles > 65535) return cudaErrorInvalidValue;
  tiled_kernel<T, W, TW, kDense><<<dim3(Nb * (bn / TW), tiles), kThreads, 0, stream>>>(
      x, values, scales, codebook, C, indices, y, M, K, Nb * bn, R, bk, bn);
  return cudaGetLastError();
}

// Launches the tiled kernel on `stream`; returns cudaGetLastError().  The
// column tile is the largest power of two ≤ 32 (M ≤ 32) or ≤ 128 dividing bn.
template <typename T, typename W, bool kDense>
cudaError_t launch_tiled(const T* x, const typename W::Raw* values, const float* scales,
                         const float* codebook, int C, const int* indices, float* y, int M,
                         int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (M < 1 || bk < 1 || bk > kMaxBk || (bk & (bk - 1)) || bn < 1 || Nb < 1 || R < 1) {
    return cudaErrorInvalidValue;
  }
  int tw = 1;
  while (tw * 2 <= (M <= 32 ? 32 : 128) && bn % (tw * 2) == 0) tw *= 2;
#define SONIC_TILED_TW(w)                                                                  \
  case w:                                                                                  \
    return launch_tiled_tw<T, W, w, kDense>(x, values, scales, codebook, C, indices, y, M, \
                                            K, Nb, R, bk, bn, stream);
  switch (tw) {
    SONIC_TILED_TW(1)
    SONIC_TILED_TW(2)
    SONIC_TILED_TW(4)
    SONIC_TILED_TW(8)
    SONIC_TILED_TW(16)
    SONIC_TILED_TW(32)
    SONIC_TILED_TW(64)
    SONIC_TILED_TW(128)
    default: return cudaErrorInvalidValue;
  }
#undef SONIC_TILED_TW
}

}  // namespace
