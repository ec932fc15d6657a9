// Decode-shaped SONIC matvec (block sparsity × clustering), hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel sonic_matvec_pallas
// (src/repro/kernels/sonic_matmul/kernel.py:37).  For M < 8 decode rows:
//
//   y[m, j*bn : +bn] = sum_r x[m, idx[j,r]*bk : +bk] @ codebook[idx_values[j,r]]
//
// idx_values (Nb, R, bk, bn) int8 cluster ids, codebook (C,) fp32 with
// C <= 128, indices (Nb, R) int32 (ascending K-block ids), x (M, K) bf16 or
// fp32, y (M, Nb*bn) fp32; every product is accumulated in fp32.  bk and bn
// are powers of two up to 128.
//
// Bound on an H100: bytes.  One byte per kept weight (its cluster id) feeds
// at most 7 multiply-adds (21 bf16 products on the tensor cores), so the
// least time is the kept ids (plus indices, codebook, x and y) over
// 3.35 TB/s: ~0.16 ms for one tinyllama-1.1b decode step at sparsity 0.5.
//
// Two entry points, one per route (kernels/build.py mma_route picks, from
// the block shape and x's type, never from M):
//
//  * sonic_matvec_mma, the tensor-core route, for bf16 x with bk % 16 == 0
//    and bn % 64 == 0: decode_kernel in decode_mma.cuh with the
//    Codebook<int8> policy.  It does sonic_matmul_mma's arithmetic (each
//    centroid as three bf16 parts from the block's 16 bank-pair copies of
//    the split codebook, three wgmma m64n8k16 per k16 step into a fresh
//    fp32 tile per 64-row chunk, lo then mid then hi, the tiles added in
//    ascending chunk order), so a decode row equals the same row in a
//    prefill or verify window bit for bit.  The chunks of each 64-column
//    tile are spread over a cluster of `split` blocks
//    (kernels/build.py decode_split) and combined in order through
//    distributed shared memory.
//  * sonic_matvec, the CUDA-core route, for fp32 x and other blocks:
//    matvec_kernel in block_sparse_kernels.cuh with the Codebook<int8>
//    policy (the codebook staged in shared memory once per block, each id
//    streamed with 4-byte loads and looked up there, fp32 FMAs).

#include "decode_mma.cuh"

extern "C" int sonic_matvec(const void* x, int x_is_bf16, const int8_t* idx_values,
                            const float* codebook, int C, const int* indices, float* y, int M,
                            int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  using W = Codebook<int8_t>;
  if (C < 1 || C > W::kCodebook) return cudaErrorInvalidValue;
  if (x_is_bf16)
    return launch_matvec<__nv_bfloat16, W>(static_cast<const __nv_bfloat16*>(x), idx_values,
                                           nullptr, codebook, C, indices, y, M, K, Nb, R, bk,
                                           bn, stream);
  return launch_matvec<float, W>(static_cast<const float*>(x), idx_values, nullptr, codebook, C,
                                 indices, y, M, K, Nb, R, bk, bn, stream);
}

extern "C" int sonic_matvec_mma(const void* x, int x_is_bf16, const int8_t* idx_values,
                                const float* codebook, int C, const int* indices, float* y, int M,
                                int K, int Nb, int R, int bk, int bn, int split,
                                cudaStream_t stream) {
  if (!x_is_bf16) return cudaErrorInvalidValue;
  return mma::launch_decode<Codebook<int8_t>>(static_cast<const __nv_bfloat16*>(x), idx_values,
                                              codebook, C, nullptr, indices, y, M, K, Nb, R, bk,
                                              bn, split, stream);
}
