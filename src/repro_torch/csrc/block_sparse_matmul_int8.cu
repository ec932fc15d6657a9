// Tiled int8 block-sparse matmul, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel block_sparse_matmul_int8_pallas
// (src/repro/kernels/block_sparse_matmul/kernel.py:91).  For prefill rows
// (M >= 8):
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ (values[j,r] * scales[j,r])
//
// values (Nb, R, bk, bn) int8, scales (Nb, R) fp32, indices (Nb, R) int32
// (ascending K-block ids), x (M, K) bf16 or fp32, y (M, Nb*bn) fp32; every
// product is accumulated in fp32.  bk and bn are powers of two up to 128.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*R*bk*Nb*bn / 989 TFLOP/s),
// the second term priced at the bf16 tensor-core peak.  At a 256-row
// prefill the operations bound it: ~256 multiply-adds per kept weight byte.
//
// Design (simple first):
//  * One thread block per (N-block j, tile of BM rows of x): grid.x walks
//    the N-blocks, grid.y the M-tiles.  Each of the 256 threads owns a
//    TM x TN register tile of the (BM x bn) output; at bn = 128 that is
//    4 rows x 4 columns of a 32 x 128 tile, so a 256-row prefill of a
//    2048-wide projection runs 128 blocks.
//  * The kept blocks are walked in ascending r, each in chunks of 32 K rows:
//    the x chunk (BM x 32, gathered at K-block idx[j,r]) and the int8 weight
//    chunk (32 x bn, dequantized against scales[j,r]) are staged in shared
//    memory as fp32, then every thread runs its fp32 multiply-adds.  The
//    next chunk is fetched into registers while those run.
//  * The kernel masks the ragged M edge itself: rows past M load as 0 and
//    are never stored, so x is never padded to a tile multiple.
//  * No split-K: each output is one fp32 chain over (r, k) in a fixed order,
//    so a row's result does not depend on M or on its tile.
// The products run on the CUDA cores in fp32, far from the tensor-core
// bound above.  wgmma on bf16 (or int8) tiles, TMA loads into a ring of
// shared-memory stages and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // K rows of a kept block staged per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Thread tiling for an N-block of width BN.
template <int BN>
struct Tile {
  static constexpr int TN = BN < 4 ? BN : 4;        // columns per thread
  static constexpr int TCOL = BN / TN;              // threads across columns
  static constexpr int TROW = kThreads / TCOL;      // threads across rows
  static constexpr int BM = TROW > 32 ? TROW : 32;  // rows per tile
  static constexpr int TM = BM / TROW;              // rows per thread
  static constexpr int XPT = BM * kChunk / kThreads;                  // x values per thread
  static constexpr int WPT = (kChunk * BN + kThreads - 1) / kThreads;  // weights per thread
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
block_sparse_matmul_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ values,
                                const float* __restrict__ scales,
                                const int* __restrict__ indices, float* __restrict__ y, int M,
                                int K, int N, int R, int bk) {
  using P = Tile<BN>;
  __shared__ float xs[P::BM][kChunk + 1];  // +1: rows of different threads hit different banks
  __shared__ __align__(16) float ws[kChunk * BN];

  const int j = blockIdx.x;           // N-block
  const int m0 = blockIdx.y * P::BM;  // first row of the tile
  const int t = threadIdx.x;
  const int tc = t % P::TCOL;
  const int tr = t / P::TCOL;
  const int chunk = bk < kChunk ? bk : kChunk;
  const int chunk_shift = 31 - __clz(chunk);  // chunk is a power of two
  const int per_block = bk >> chunk_shift;    // chunks per kept block
  const int n_chunks = R * per_block;

  float acc[P::TM][P::TN];
#pragma unroll
  for (int i = 0; i < P::TM; ++i)
#pragma unroll
    for (int c = 0; c < P::TN; ++c) acc[i][c] = 0.f;

  // Chunk c of the (r ascending, k ascending) walk, fetched into registers:
  // x rows m0.. at K-block idx[j,r] (rows past M read as 0) and the int8
  // weight rows, contiguous in `values`.
  float xr[P::XPT];
  int8_t wr[P::WPT];
  float s_next;
  auto fetch = [&](int c) {
    const int r = c / per_block;
    const int k0 = (c - r * per_block) << chunk_shift;
    s_next = __ldg(scales + j * R + r);
    const T* xp = x + (size_t)__ldg(indices + j * R + r) * bk + k0;
#pragma unroll
    for (int u = 0; u < P::XPT; ++u) {
      const int e = t + u * kThreads;
      const int i = e >> chunk_shift;
      const int row = m0 + i;
      xr[u] = (i < P::BM && row < M) ? to_float(xp[(size_t)row * K + (e & (chunk - 1))]) : 0.f;
    }
    const int8_t* wp = values + ((size_t)(j * R + r) * bk + k0) * BN;
#pragma unroll
    for (int u = 0; u < P::WPT; ++u) {
      const int e = t + u * kThreads;
      wr[u] = e < chunk * BN ? __ldg(reinterpret_cast<const signed char*>(wp) + e) : 0;
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
      if (e < chunk * BN) ws[e] = static_cast<float>(wr[u]) * s;
    }
    __syncthreads();
    if (c + 1 < n_chunks) fetch(c + 1);  // in flight during the multiply-adds below
    for (int kk = 0; kk < chunk; ++kk) {
      float a[P::TM];
      float b[P::TN];
#pragma unroll
      for (int i = 0; i < P::TM; ++i) a[i] = xs[tr * P::TM + i][kk];
      if constexpr (P::TN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(&ws[kk * BN + tc * 4]);
        b[0] = v.x;
        b[1] = v.y;
        b[2] = v.z;
        b[3] = v.w;
      } else {
#pragma unroll
        for (int c2 = 0; c2 < P::TN; ++c2) b[c2] = ws[kk * BN + tc * P::TN + c2];
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
        y[(size_t)row * N + (size_t)j * BN + tc * P::TN + c] = acc[i][c];
    }
  }
}

template <typename T, int BN>
cudaError_t launch_bn(const T* x, const int8_t* values, const float* scales,
                      const int* indices, float* y, int M, int K, int Nb, int R, int bk,
                      cudaStream_t stream) {
  const int tiles = (M + Tile<BN>::BM - 1) / Tile<BN>::BM;
  if (tiles > 65535) return cudaErrorInvalidValue;
  block_sparse_matmul_int8_kernel<T, BN><<<dim3(Nb, tiles), kThreads, 0, stream>>>(
      x, values, scales, indices, y, M, K, Nb * BN, R, bk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bn(const T* x, const int8_t* values, const float* scales,
                        const int* indices, float* y, int M, int K, int Nb, int R, int bk,
                        int bn, cudaStream_t stream) {
  switch (bn) {
    case 1: return launch_bn<T, 1>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 2: return launch_bn<T, 2>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 4: return launch_bn<T, 4>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 8: return launch_bn<T, 8>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 16: return launch_bn<T, 16>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 32: return launch_bn<T, 32>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 64: return launch_bn<T, 64>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    case 128: return launch_bn<T, 128>(x, values, scales, indices, y, M, K, Nb, R, bk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int block_sparse_matmul_int8(const void* x, int x_is_bf16, const int8_t* values,
                                        const float* scales, const int* indices, float* y,
                                        int M, int K, int Nb, int R, int bk, int bn,
                                        cudaStream_t stream) {
  if (M < 1 || bk < 1 || bk > 128 || Nb < 1 || R < 1) return cudaErrorInvalidValue;
  if (x_is_bf16)
    return dispatch_bn(static_cast<const __nv_bfloat16*>(x), values, scales, indices, y, M, K,
                       Nb, R, bk, bn, stream);
  return dispatch_bn(static_cast<const float*>(x), values, scales, indices, y, M, K, Nb, R,
                     bk, bn, stream);
}
