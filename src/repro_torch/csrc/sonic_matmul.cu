// Tiled SONIC matmul (block sparsity x clustering), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel sonic_matmul_pallas
// (src/repro/kernels/sonic_matmul/kernel.py:142).  For any M:
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ codebook[idx_values[j,r]]
//
// idx_values (Nb, R, bk, bn) int8 cluster ids, codebook (C,) fp32 with
// C <= 128, indices (Nb, R) int32 (ascending K-block ids), x (M, K) bf16 or
// fp32, y (M, Nb*bn) fp32; every product is accumulated in fp32.  bk and bn
// are powers of two up to 128.
//
// Bound on an H100: max(bytes / 3.35 TB/s, 2*M*kept / 989 TFLOP/s).  At a
// 256-row prefill of tinyllama-1.1b the bytes bound it (~0.35 ms a step);
// the tensor-core route's three bf16 products per weight put its
// operations floor at ~0.8 ms.
//
// Two entry points, one per route (kernels/build.py mma_route picks):
//
//  * sonic_matmul_mma, the tensor-core route, for bf16 x with bk % 16 == 0
//    and bn % 64 == 0: the block-sparse case of mma_kernel in block_mma.cuh
//    with the Codebook<int8> weight policy.  64 columns of an N-block per
//    thread block against a tile of 8 to 256 tokens; the producer reads the
//    tile's kept-block ids and TMA-loads each kept block's ids and x slice,
//    min(bk, 64) K rows a stage, into a ring of shared-memory stages; the
//    consumers dequantize into hi / mid / lo bf16 A fragments and issue
//    three wgmma per k16 step into a fresh fp32 tile per chunk, the chunks
//    summed on the CUDA cores.
//  * sonic_matmul, the CUDA-core route, for fp32 x and small blocks:
//    tiled_kernel in block_sparse_kernels.cuh with the Codebook<int8> weight
//    policy (the codebook staged in shared memory, each 32-row chunk turned
//    into fp32 centroids as it is staged, fp32 FMAs, the ragged M edge
//    masked).
//
// Neither splits K, so a row's result does not depend on M.

#include "block_mma.cuh"

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

extern "C" int sonic_matmul_mma(const void* x, int x_is_bf16, const int8_t* idx_values,
                                const float* codebook, int C, const int* indices, float* y, int M,
                                int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (!x_is_bf16) return cudaErrorInvalidValue;
  return mma::launch_sparse<Codebook<int8_t>>(static_cast<const __nv_bfloat16*>(x), idx_values,
                                              codebook, C, nullptr, indices, y, M, K, Nb, R, bk,
                                              bn, stream);
}
