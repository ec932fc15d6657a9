// Tiled fp block-sparse matmul, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel block_sparse_matmul_pallas
// (src/repro/kernels/block_sparse_matmul/kernel.py:40).  For any M:
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ values[j,r]
//
// values (Nb, R, bk, bn) fp32 or bf16, indices (Nb, R) int32 (ascending
// K-block ids), x (M, K) bf16 or fp32, y (M, Nb*bn) fp32; every product is
// accumulated in fp32.  bk and bn are powers of two up to 128.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*kept / 989 TFLOP/s).  With
// fp32 values the weights are 4 bytes each, so a 4-row decode step of
// tinyllama-1.1b at sparsity 0.5 is bound by bytes (~0.62 ms) and a
// 256-row prefill nearly so (~0.8 ms).
//
// Design: tiled_kernel in block_sparse_kernels.cuh with the Plain<fp32> or
// Plain<bf16> weight policy: only the kept K-blocks of x are gathered, the
// kept values are staged through shared memory as fp32.  A warp reads 32
// consecutive values of a row (128 bytes for fp32).  For M <= 32 the
// column tile is 32 wide so a few rows still run 4 thread blocks per
// N-block.  The products run on the CUDA cores in fp32.

#include "block_sparse_kernels.cuh"

namespace {

template <typename T>
cudaError_t dispatch_values(const T* x, const void* values, int values_is_bf16,
                            const int* indices, float* y, int M, int K, int Nb, int R, int bk,
                            int bn, cudaStream_t stream) {
  if (values_is_bf16)
    return launch_tiled<T, Plain<__nv_bfloat16>, false>(
        x, static_cast<const __nv_bfloat16*>(values), nullptr, nullptr, 0, indices, y, M, K,
        Nb, R, bk, bn, stream);
  return launch_tiled<T, Plain<float>, false>(x, static_cast<const float*>(values), nullptr,
                                              nullptr, 0, indices, y, M, K, Nb, R, bk, bn,
                                              stream);
}

}  // namespace

extern "C" int block_sparse_matmul(const void* x, int x_is_bf16, const void* values,
                                   int values_is_bf16, const int* indices, float* y, int M,
                                   int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (x_is_bf16)
    return dispatch_values(static_cast<const __nv_bfloat16*>(x), values, values_is_bf16,
                           indices, y, M, K, Nb, R, bk, bn, stream);
  return dispatch_values(static_cast<const float*>(x), values, values_is_bf16, indices, y, M,
                         K, Nb, R, bk, bn, stream);
}
