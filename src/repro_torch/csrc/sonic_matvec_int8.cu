// Decode-shaped int8 block-sparse matvec, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel sonic_matvec_int8_pallas
// (src/repro/kernels/sonic_matmul/kernel.py:93).  For M < 8 decode rows:
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ (values[j,r] * scales[j,r])
//
// values (Nb, R, bk, bn) int8, scales (Nb, R) fp32, indices (Nb, R) int32
// (ascending K-block ids), x (M, K) bf16 or fp32, y (M, Nb*bn) fp32; every
// product is accumulated in fp32.  bk and bn are powers of two up to 128.
//
// Bound on an H100: bytes.  Each kept int8 weight is read once and feeds at
// most 7 multiply-adds, far below the ~295 operations per byte at which the
// card stops waiting on memory, so the least time is the kept weights (plus
// scales, indices, x and y) over 3.35 TB/s.  At tinyllama-1.1b's widths one
// decode step moves ~0.52 GB of kept weights in 155 launches of a few MB.
//
// Design, for that bound:
//  * One thread block per (N-block j, slice of up to 32 columns), so even a
//    2048-wide projection fills 64 blocks.  Each thread owns 4 adjacent
//    columns (one 4-byte load per weight row; 1 column when bn < 4) and
//    the block's 256 threads split the bk rows among row groups.  A warp
//    reads 4 rows x 32 contiguous bytes: whole 32-byte sectors, no waste.
//  * The kept blocks are walked in ascending r, four at a time: their
//    x[:, idx[j,r]*bk : +bk] slices (at most 7 rows each) are staged in
//    shared memory as fp32 and broadcast to every thread, behind one
//    barrier.  The group's int8 rows are dealt to the row groups; each
//    thread issues 16 independent weight loads before it uses any, so
//    enough bytes are in flight to cover the memory latency.  Each weight
//    is streamed once, dequantized against its block's scale, and
//    multiplied into fp32 registers.
//  * The row groups' partial sums are reduced through shared memory in a
//    fixed order, with no atomics: the output is the same from run to run.
//  * There is no split over r across blocks and no M padding.
// Still simple: no cp.async or TMA pipeline across groups, one launch per
// projection, and every block re-reads its x slices from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 7;  // decode rows: M < DECODE_M_THRESHOLD = 8
constexpr int kMaxBk = 128;
constexpr int kSliceThreads = 8;  // threads across one column slice
constexpr int kGroup = 4;         // kept blocks whose x is staged per barrier
constexpr int kBatch = 16;        // weight rows a thread loads before using them

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC adjacent int8 weights of one row: loaded raw, dequantized on use.
template <int VEC>
struct Raw;
template <>
struct Raw<4> {
  using type = char4;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return __ldg(reinterpret_cast<const char4*>(p));
  }
  static __device__ __forceinline__ void dequant(type v, float s, float (&w)[4]) {
    w[0] = static_cast<float>(v.x) * s;
    w[1] = static_cast<float>(v.y) * s;
    w[2] = static_cast<float>(v.z) * s;
    w[3] = static_cast<float>(v.w) * s;
  }
};
template <>
struct Raw<1> {
  using type = signed char;
  static __device__ __forceinline__ type load(const int8_t* p) {
    return __ldg(reinterpret_cast<const signed char*>(p));
  }
  static __device__ __forceinline__ void dequant(type v, float s, float (&w)[1]) {
    w[0] = static_cast<float>(v) * s;
  }
};

// Thread layout shared by the kernel and its launch: threads across a slice.
__host__ __device__ __forceinline__ int slice_threads(int bn, int vec) {
  return bn / vec < kSliceThreads ? bn / vec : kSliceThreads;
}

template <typename T, int M, int VEC>
__global__ void __launch_bounds__(kThreads)
sonic_matvec_int8_kernel(const T* __restrict__ x, const int8_t* __restrict__ values,
                         const float* __restrict__ scales, const int* __restrict__ indices,
                         float* __restrict__ y, int K, int N, int R, int bk, int bn) {
  constexpr int kXStride = kGroup * kMaxBk;  // per-row stride of xs
  __shared__ float xs[M * kXStride];         // x of the group's kept blocks, (m, r, k)
  __shared__ float ss[kGroup];               // the group's scales
  __shared__ float part[kThreads * VEC * M];

  const int tcols = slice_threads(bn, VEC);
  const int sw = tcols * VEC;  // slice width in columns
  const int trows = kThreads / tcols;  // row groups
  const int slices = bn / sw;
  const int j = blockIdx.x / slices;
  const int c0 = (blockIdx.x - j * slices) * sw;
  const int t = threadIdx.x;
  const int tc = t % tcols;
  const int tr = t / tcols;
  const int col = c0 + tc * VEC;  // first column (within the N-block) this thread owns
  const int bk_shift = 31 - __clz(bk);  // bk is a power of two

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
    if (t < g) ss[t] = __ldg(scales + j * R + r0 + t);
    __syncthreads();
    const int8_t* base = values + (size_t)(j * R + r0) * bk * bn + col;
    for (int e0 = tr; e0 < rows; e0 += kBatch * trows) {
      typename Raw<VEC>::type raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * trows;
        if (e < rows) raw[u] = Raw<VEC>::load(base + (size_t)e * bn);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * trows;
        if (e < rows) {
          float w[VEC];
          Raw<VEC>::dequant(raw[u], ss[e >> bk_shift], w);
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

template <typename T, int M>
cudaError_t launch_rows(const T* x, const int8_t* values, const float* scales,
                        const int* indices, float* y, int K, int Nb, int R, int bk, int bn,
                        cudaStream_t stream) {
  if (bn % 4 == 0) {
    const int slices = bn / (slice_threads(bn, 4) * 4);
    sonic_matvec_int8_kernel<T, M, 4><<<Nb * slices, kThreads, 0, stream>>>(
        x, values, scales, indices, y, K, Nb * bn, R, bk, bn);
  } else {
    const int slices = bn / slice_threads(bn, 1);
    sonic_matvec_int8_kernel<T, M, 1><<<Nb * slices, kThreads, 0, stream>>>(
        x, values, scales, indices, y, K, Nb * bn, R, bk, bn);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const T* x, const int8_t* values, const float* scales,
                          const int* indices, float* y, int M, int K, int Nb, int R, int bk,
                          int bn, cudaStream_t stream) {
  switch (M) {
    case 1: return launch_rows<T, 1>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 2: return launch_rows<T, 2>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 3: return launch_rows<T, 3>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 4: return launch_rows<T, 4>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 5: return launch_rows<T, 5>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 6: return launch_rows<T, 6>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    case 7: return launch_rows<T, 7>(x, values, scales, indices, y, K, Nb, R, bk, bn, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int sonic_matvec_int8(const void* x, int x_is_bf16, const int8_t* values,
                                 const float* scales, const int* indices, float* y, int M,
                                 int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (M < 1 || M > kMaxRows || bk < 1 || bk > kMaxBk || bn < 1 || bn > 128 || Nb < 1 ||
      R < 1)
    return cudaErrorInvalidValue;
  if (x_is_bf16)
    return dispatch_rows(static_cast<const __nv_bfloat16*>(x), values, scales, indices, y, M,
                         K, Nb, R, bk, bn, stream);
  return dispatch_rows(static_cast<const float*>(x), values, scales, indices, y, M, K, Nb, R,
                       bk, bn, stream);
}
