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
// at most 7 multiply-adds, so the least time is the kept ids (plus indices,
// codebook, x and y) over 3.35 TB/s: ~0.16 ms for one tinyllama-1.1b decode
// step at sparsity 0.5.
//
// Design: matvec_kernel in block_sparse_kernels.cuh with the Codebook<int8>
// weight policy.  The codebook is staged in shared memory once per thread
// block; each id is streamed once with the int8 kernel's coalesced 4-byte
// loads and turned into its centroid by a shared-memory gather (the ids are
// signed int8, cast to int before indexing).  What holds it back is the
// int8 kernel's: too few loads in flight per SM, no cp.async / TMA.

#include "block_sparse_kernels.cuh"

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
