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
// Design: tiled_kernel in block_sparse_kernels.cuh with the Int8Scale
// weight policy: each 32-row chunk of a kept block is dequantized against
// its block's scale into fp32 shared memory.  The products run on the CUDA
// cores in fp32, far from the tensor-core bound above.

#include "block_sparse_kernels.cuh"

extern "C" int block_sparse_matmul_int8(const void* x, int x_is_bf16, const int8_t* values,
                                        const float* scales, const int* indices, float* y,
                                        int M, int K, int Nb, int R, int bk, int bn,
                                        cudaStream_t stream) {
  if (x_is_bf16)
    return launch_tiled<__nv_bfloat16, Int8Scale, false>(
        static_cast<const __nv_bfloat16*>(x), values, scales, nullptr, 0, indices, y, M, K, Nb,
        R, bk, bn, stream);
  return launch_tiled<float, Int8Scale, false>(static_cast<const float*>(x), values, scales,
                                               nullptr, 0, indices, y, M, K, Nb, R, bk, bn,
                                               stream);
}
