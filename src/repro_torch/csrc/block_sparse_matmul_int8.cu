// Int8 block-sparse matmul, hand-written for Hopper (sm_90a).
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
// prefill of tinyllama-1.1b the bytes bound it (~0.35 ms a step of 155
// projections), the operations nearly so (~0.27 ms).
//
// Two entry points, one per route (kernels/build.py mma_route picks):
//
//  * block_sparse_matmul_int8_mma, the tensor-core route, for bf16 x with
//    bk % 16 == 0 and bn % 64 == 0: the block-sparse case of mma_kernel in
//    block_mma.cuh with the Int8Scale weight policy.  64 columns of an
//    N-block per thread block against a tile of 8 to 256 tokens; the
//    producer reads the tile's kept-block ids and TMA-loads each kept
//    block's int8 values and x slice, min(bk, 64) K rows a stage, into a
//    ring of shared-memory stages; each int8 value is one exact bf16 part
//    (one wgmma per k16 step, no lookup), each chunk runs into a fresh fp32
//    tile that the consumer adds into the output times the block's scale
//    (s * (x @ w) per chunk, where the Pallas kernel takes x @ (w * s)).
//  * block_sparse_matmul_int8, the CUDA-core route, for fp32 x and small
//    blocks (serve_quant's 16 x 16): tiled_kernel in block_sparse_kernels.cuh
//    with the Int8Scale weight policy (each 32-row chunk of a kept block
//    dequantized against its scale into fp32 shared memory, fp32 FMAs).
//
// Neither splits K, so a row's result does not depend on M.

#include "block_mma.cuh"

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

extern "C" int block_sparse_matmul_int8_mma(const void* x, int x_is_bf16, const int8_t* values,
                                            const float* scales, const int* indices, float* y,
                                            int M, int K, int Nb, int R, int bk, int bn,
                                            cudaStream_t stream) {
  if (!x_is_bf16) return cudaErrorInvalidValue;
  return mma::launch_sparse<Int8Scale>(static_cast<const __nv_bfloat16*>(x), values, nullptr, 0,
                                       scales, indices, y, M, K, Nb, R, bk, bn, stream);
}
