// fp block-sparse matmul, hand-written for Hopper (sm_90a).
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
// 256-row prefill nearly so (~0.8 ms); the tensor-core route's three bf16
// products per fp32 value put its operations floor at ~0.8 ms.
//
// Two entry points, one per route (kernels/build.py mma_route picks):
//
//  * block_sparse_matmul_mma, the tensor-core route, for bf16 x with
//    bk % 16 == 0 and bn % 64 == 0: the block-sparse case of mma_kernel in
//    block_mma.cuh with the Plain<fp32> or Plain<bf16> weight policy.  64
//    columns of an N-block per thread block against a tile of 8 to 256
//    tokens, each kept block's values and x slice TMA-loaded, min(bk, 64) K
//    rows a stage, into a ring of shared-memory stages; an fp32 value is
//    split in registers into hi / mid / lo bf16 parts (three wgmma per k16
//    step), a bf16 value is one part; each chunk runs into a fresh fp32
//    tile, the chunks summed on the CUDA cores.
//  * block_sparse_matmul, the CUDA-core route, for fp32 x and small blocks:
//    tiled_kernel in block_sparse_kernels.cuh with the Plain<fp32> or
//    Plain<bf16> weight policy: only the kept K-blocks of x are gathered,
//    the kept values are staged through shared memory as fp32, fp32 FMAs.
//    For M <= 32 the column tile is 32 wide so a few rows still run 4
//    thread blocks per N-block.
//
// Neither splits K, so a row's result does not depend on M.

#include "block_mma.cuh"

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

extern "C" int block_sparse_matmul_mma(const void* x, int x_is_bf16, const void* values,
                                       int values_is_bf16, const int* indices, float* y, int M,
                                       int K, int Nb, int R, int bk, int bn,
                                       cudaStream_t stream) {
  if (!x_is_bf16) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  if (values_is_bf16)
    return mma::launch_sparse<Plain<__nv_bfloat16>>(
        xb, static_cast<const __nv_bfloat16*>(values), nullptr, 0, nullptr, indices, y, M, K,
        Nb, R, bk, bn, stream);
  return mma::launch_sparse<Plain<float>>(xb, static_cast<const float*>(values), nullptr, 0,
                                          nullptr, indices, y, M, K, Nb, R, bk, bn, stream);
}
