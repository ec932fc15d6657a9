// Tiled SONIC matmul (block sparsity × clustering), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sonic_matmul_pallas
// (src/repro/kernels/sonic_matmul/kernel.py:142).  For M >= 8 rows:
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ codebook[idx_values[j,r]]
//
// idx_values (Nb, R, bk, bn) int8 cluster ids, codebook (C,) fp32 with
// C <= 128, indices (Nb, R) int32 (ascending K-block ids), x (M, K) bf16 or
// fp32, y (M, Nb*bn) fp32; every product is accumulated in fp32.  bk and bn
// are powers of two up to 128.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*kept / 989 TFLOP/s).  At a
// 256-row prefill of tinyllama-1.1b the operations bound it (~0.35 ms a
// step): 256 multiply-adds per id byte.
//
// Design: tiled_kernel in block_sparse_kernels.cuh with the Codebook<int8>
// weight policy: the codebook is staged in shared memory once per thread
// block, and each 32-row chunk of a kept block is turned into fp32 centroids
// there as it is staged.  The reference pads M to a tile multiple; this
// kernel masks the ragged edge.  The products run on the CUDA cores in fp32,
// far from the tensor-core bound.

#include "block_sparse_kernels.cuh"

extern "C" int sonic_matmul(const void* x, int x_is_bf16, const int8_t* idx_values,
                            const float* codebook, int C, const int* indices, float* y, int M,
                            int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  using W = Codebook<int8_t>;
  if (C < 1 || C > W::kCodebook) return cudaErrorInvalidValue;
  if (x_is_bf16)
    return launch_tiled<__nv_bfloat16, W, false>(static_cast<const __nv_bfloat16*>(x),
                                                 idx_values, nullptr, codebook, C, indices, y,
                                                 M, K, Nb, R, bk, bn, stream);
  return launch_tiled<float, W, false>(static_cast<const float*>(x), idx_values, nullptr,
                                       codebook, C, indices, y, M, K, Nb, R, bk, bn, stream);
}
