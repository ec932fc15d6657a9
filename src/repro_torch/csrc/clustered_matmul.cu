// Clustered-weight matmul, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel clustered_matmul_pallas
// (src/repro/kernels/clustered_matmul/kernel.py:39).  For any M:
//
//   y[m, n] = sum_k x[m, k] * codebook[ids[k, n]]
//
// ids (K, N) int8 or int32 cluster ids (row-major), codebook (C,) fp32
// (C <= 128 for int8 ids, <= 1024 for int32), x (M, K) bf16 or fp32,
// y (M, N) fp32; every product is accumulated in fp32.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*K*N / 989 TFLOP/s).  Every
// weight is read (there is no sparsity), one byte each for int8 ids: a
// 4-row decode step of tinyllama-1.1b is bound by bytes (~0.31 ms), a
// 256-row prefill by operations (~0.55 ms).
//
// Design: the dense case of tiled_kernel in block_sparse_kernels.cuh: one
// "N-block" of width N, K cut into blocks of bk = the largest power of two
// <= 32 dividing K, walked in order (so any K is taken), with the
// Codebook<int8> or Codebook<int32> weight policy (the codebook staged in
// shared memory once per thread block).  The column tile is the largest
// power of two <= 128 (<= 32 for M <= 32) dividing N, so any N is taken; the
// reference's own 256 / 256 / 512 tiles are not needed.  The M edge is
// masked in the kernel.  The products run on the CUDA cores in fp32.

#include "block_sparse_kernels.cuh"

namespace {

template <typename T>
cudaError_t dispatch_ids(const T* x, const void* ids, int ids_is_int32, const float* codebook,
                         int C, float* y, int M, int K, int N, cudaStream_t stream) {
  int bk = 1;
  while (bk * 2 <= kChunk && K % (bk * 2) == 0) bk *= 2;
  if (ids_is_int32) {
    if (C < 1 || C > Codebook<int>::kCodebook) return cudaErrorInvalidValue;
    return launch_tiled<T, Codebook<int>, true>(x, static_cast<const int*>(ids), nullptr,
                                                codebook, C, nullptr, y, M, K, 1, K / bk, bk, N,
                                                stream);
  }
  if (C < 1 || C > Codebook<int8_t>::kCodebook) return cudaErrorInvalidValue;
  return launch_tiled<T, Codebook<int8_t>, true>(x, static_cast<const int8_t*>(ids), nullptr,
                                                 codebook, C, nullptr, y, M, K, 1, K / bk, bk,
                                                 N, stream);
}

}  // namespace

extern "C" int clustered_matmul(const void* x, int x_is_bf16, const void* ids, int ids_is_int32,
                                const float* codebook, int C, float* y, int M, int K, int N,
                                cudaStream_t stream) {
  if (M < 1 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (x_is_bf16)
    return dispatch_ids(static_cast<const __nv_bfloat16*>(x), ids, ids_is_int32, codebook, C, y,
                        M, K, N, stream);
  return dispatch_ids(static_cast<const float*>(x), ids, ids_is_int32, codebook, C, y, M, K, N,
                      stream);
}
