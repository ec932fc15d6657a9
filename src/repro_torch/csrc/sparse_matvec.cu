// Compressed sparse matvec (the C3 zero-compression FC dataflow), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_matvec_pallas
// (src/repro/kernels/sparse_matvec/kernel.py:40):
//
//   y[b, n] = sum_c x_nz[b, c] * Wt[idx[c], n]
//
// x_nz (B, knz) bf16 or fp32 (the kept activations), idx (knz,) int32 (the
// kept input rows of Wt, each in [0, K)), Wt (K, N) bf16 or fp32 row-major,
// y (B, N) fp32; every product is accumulated in fp32.  Only the rows that
// idx names are read: a zero activation never costs a weight byte.
//
// Bound on an H100: bytes.  Each gathered row is read once (knz * N weight
// elements), x_nz and y once; a weight feeds B multiply-adds, two orders of
// magnitude below the card's operations line at decode B.  For one step of
// tinyllama-1.1b's 155 projections at knz = K / 4 that is 517 MB of bf16
// rows, ~0.154 ms at 3.35 TB/s.
//
// Design.  The Pallas grid (N / bn, knz) carries the sum over c from one
// grid step to the next in its output block; blocks here run in parallel,
// and one block walking all knz rows of a column slice would leave most of
// the 132 SMs idle (N is 256 for wk and wv).  So c is cut into chunks of
// kChunk = 64 rows and the grid is (column tiles, chunks):
//
//  * pass 1 (partial_kernel): a block loads its chunk's 64 indices into
//    shared memory; each of its 8 warps loads its 8 rows of the chunk for
//    the block's column tile, all 8 loads in flight before any is used, 16
//    bytes a thread (8 bf16 or 4 fp32 columns; neighbouring threads on
//    neighbouring columns of the contiguous row stripe).  The rows stay in
//    registers while x_nz is walked in groups of up to 8 rows (staged in
//    shared memory as fp32), so a weight is read once whatever B is.  The 8
//    warps' sums are added through shared memory in warp order and written
//    to the chunk's slot of a workspace (B, N) fp32 (straight to y when
//    there is one chunk).
//  * pass 2 (reduce_kernel): y = the chunks' partial sums added in chunk
//    order.
//
// Each output is thus one fixed chain: 8 rows in order within a warp, the 8
// warps in order, the chunks in order.  The chain depends on knz alone, not
// on B, the row group or the tile, and there are no atomics: a row's result
// does not depend on how many rows ride with it, and repeats bit for bit.
// Where N is not a multiple of the vector width (or Wt is not 16-byte
// aligned) the same kernel takes one column a thread; the ragged N edge is
// masked.  knz = 0 gives exact zeros.  The products run on the CUDA cores in
// fp32.  Not yet done: more rows in flight per thread (cp.async / TMA into a
// ring of stages), and folding pass 2 into pass 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                     // idx rows per partial sum
constexpr int kRowsPerWarp = kChunk / kWarps;  // loaded before any is used
constexpr int kMaxChunks = 65535;              // gridDim.y

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC adjacent weights of a row: one 16-byte load (VEC = 16 / sizeof(W)), or
// one element converted at load (VEC = 1).
template <typename W, int VEC>
struct Stripe {
  using Raw = typename std::conditional<VEC == 1, float, uint4>::type;

  static __device__ __forceinline__ Raw load(const W* p) {
    if constexpr (VEC == 1) {
      return to_float(__ldg(p));
    } else {
      return __ldg(reinterpret_cast<const uint4*>(p));
    }
  }

  static __device__ __forceinline__ Raw zero() {
    if constexpr (VEC == 1) {
      return 0.f;
    } else {
      return make_uint4(0u, 0u, 0u, 0u);
    }
  }

  static __device__ __forceinline__ void unpack(const Raw& r, float (&w)[VEC]) {
    if constexpr (VEC == 1) {
      w[0] = r;
    } else if constexpr (std::is_same<W, float>::value) {
      w[0] = __uint_as_float(r.x);
      w[1] = __uint_as_float(r.y);
      w[2] = __uint_as_float(r.z);
      w[3] = __uint_as_float(r.w);
    } else {  // bf16: element 2i in the low half of a word, 2i + 1 in the high
      const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[2 * i] = __uint_as_float(words[i] << 16);
        w[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
      }
    }
  }
};

// Pass 1: out[chunk] (B, N) = the chunk's rows' contribution, for one column
// tile of 32 * VEC columns.  RG rows of x are taken per pass over the rows.
template <typename X, typename W, int VEC, int RG>
__global__ void __launch_bounds__(kThreads)
    partial_kernel(const X* __restrict__ x, const int* __restrict__ idx,
                   const W* __restrict__ wt, float* __restrict__ out, int B, int knz, int K,
                   int N) {
  using S = Stripe<W, VEC>;
  constexpr int kTile = 32 * VEC;
  __shared__ int s_row[kChunk];
  __shared__ float s_x[RG][kChunk];
  __shared__ float s_part[kWarps][kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kChunk;
  const int rows = min(kChunk, knz - c0);
  const int tile0 = blockIdx.x * kTile;
  const int col = tile0 + lane * VEC;  // VEC divides N when VEC > 1
  float* part = out + static_cast<size_t>(blockIdx.y) * B * N;

  if (threadIdx.x < kChunk) {
    // clamped, so that a bad index cannot read outside Wt
    const int r = threadIdx.x < rows ? idx[c0 + threadIdx.x] : 0;
    s_row[threadIdx.x] = min(max(r, 0), K - 1);
  }
  __syncthreads();

  typename S::Raw raw[kRowsPerWarp];
#pragma unroll
  for (int u = 0; u < kRowsPerWarp; ++u) {
    const int r = warp * kRowsPerWarp + u;
    raw[u] = (col < N && r < rows) ? S::load(wt + static_cast<size_t>(s_row[r]) * N + col)
                                   : S::zero();
  }

  for (int b0 = 0; b0 < B; b0 += RG) {
    __syncthreads();  // the previous group is done with s_x
    for (int i = threadIdx.x; i < RG * kChunk; i += kThreads) {
      const int b = i / kChunk, r = i % kChunk;
      s_x[b][r] = (b0 + b < B && r < rows)
                      ? to_float(x[static_cast<size_t>(b0 + b) * knz + c0 + r])
                      : 0.f;
    }
    __syncthreads();

    float acc[RG][VEC];
#pragma unroll
    for (int b = 0; b < RG; ++b)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[b][v] = 0.f;
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      float w[VEC];
      S::unpack(raw[u], w);
#pragma unroll
      for (int b = 0; b < RG; ++b) {
        const float xv = s_x[b][warp * kRowsPerWarp + u];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[b][v] = fmaf(xv, w[v], acc[b][v]);
      }
    }

    // the warps' sums, added in warp order, one row of x at a time
#pragma unroll
    for (int b = 0; b < RG; ++b) {
      if (b0 + b < B) {  // the same for every thread of the block
#pragma unroll
        for (int v = 0; v < VEC; ++v) s_part[warp][lane * VEC + v] = acc[b][v];
        __syncthreads();
        for (int t = threadIdx.x; t < kTile; t += kThreads) {
          if (tile0 + t < N) {
            float s = s_part[0][t];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) s += s_part[w][t];
            part[static_cast<size_t>(b0 + b) * N + tile0 + t] = s;
          }
        }
        __syncthreads();
      }
    }
  }
}

// Pass 2: y[i] = sum over chunks, in chunk order, of ws[chunk][i].
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const float* __restrict__ ws, float* __restrict__ y, int chunks, int BN) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= BN) return;
  float s = ws[i];
  for (int c = 1; c < chunks; ++c) s += ws[static_cast<size_t>(c) * BN + i];
  y[i] = s;
}

template <typename X, typename W, int VEC>
void launch_partial(const X* x, const int* idx, const W* wt, float* out, int B, int knz, int K,
                    int N, int chunks, cudaStream_t stream) {
  const dim3 grid((N + 32 * VEC - 1) / (32 * VEC), chunks);
  // rows of x per pass over the weights: all of B up to 8
  if (B > 4)
    partial_kernel<X, W, VEC, 8><<<grid, kThreads, 0, stream>>>(x, idx, wt, out, B, knz, K, N);
  else if (B > 2)
    partial_kernel<X, W, VEC, 4><<<grid, kThreads, 0, stream>>>(x, idx, wt, out, B, knz, K, N);
  else if (B == 2)
    partial_kernel<X, W, VEC, 2><<<grid, kThreads, 0, stream>>>(x, idx, wt, out, B, knz, K, N);
  else
    partial_kernel<X, W, VEC, 1><<<grid, kThreads, 0, stream>>>(x, idx, wt, out, B, knz, K, N);
}

template <typename X, typename W>
void dispatch_vec(const X* x, const int* idx, const W* wt, float* out, int B, int knz, int K,
                  int N, int chunks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(W);
  if (N % kVec == 0 && reinterpret_cast<uintptr_t>(wt) % 16 == 0)
    launch_partial<X, W, kVec>(x, idx, wt, out, B, knz, K, N, chunks, stream);
  else
    launch_partial<X, W, 1>(x, idx, wt, out, B, knz, K, N, chunks, stream);
}

template <typename X>
void dispatch_w(const X* x, const int* idx, const void* wt, int wt_is_bf16, float* out, int B,
                int knz, int K, int N, int chunks, cudaStream_t stream) {
  if (wt_is_bf16)
    dispatch_vec(x, idx, static_cast<const __nv_bfloat16*>(wt), out, B, knz, K, N, chunks,
                 stream);
  else
    dispatch_vec(x, idx, static_cast<const float*>(wt), out, B, knz, K, N, chunks, stream);
}

}  // namespace

// Rows of idx per partial sum: the workspace must hold
// ceil(knz / sparse_matvec_chunk_rows()) * B * N floats when that is > 1.
extern "C" int sparse_matvec_chunk_rows() { return kChunk; }

extern "C" int sparse_matvec(const void* x, int x_is_bf16, const int* idx, const void* wt,
                             int wt_is_bf16, float* y, float* workspace, int workspace_floats,
                             int B, int knz, int K, int N, cudaStream_t stream) {
  if (B < 1 || knz < 0 || K < 1 || N < 1) return cudaErrorInvalidValue;
  const int bn = B * N;
  if (knz == 0) return cudaMemsetAsync(y, 0, static_cast<size_t>(bn) * sizeof(float), stream);
  const int chunks = (knz + kChunk - 1) / kChunk;
  if (chunks > kMaxChunks) return cudaErrorInvalidValue;
  float* out = y;
  if (chunks > 1) {
    if (workspace == nullptr ||
        static_cast<long long>(workspace_floats) < static_cast<long long>(chunks) * bn)
      return cudaErrorInvalidValue;
    out = workspace;
  }
  if (x_is_bf16)
    dispatch_w(static_cast<const __nv_bfloat16*>(x), idx, wt, wt_is_bf16, out, B, knz, K, N,
               chunks, stream);
  else
    dispatch_w(static_cast<const float*>(x), idx, wt, wt_is_bf16, out, B, knz, K, N, chunks,
               stream);
  if (chunks > 1) reduce_kernel<<<(bn + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      workspace, y, chunks, bn);
  return cudaGetLastError();
}
