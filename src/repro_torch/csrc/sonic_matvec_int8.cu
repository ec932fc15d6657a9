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
// Design: matvec_kernel in block_sparse_kernels.cuh with the Int8Scale
// weight policy (the group's scales staged in shared memory beside its x).
// Still simple: no cp.async or TMA pipeline across groups, one launch per
// projection, and every block re-reads its x slices from L2.

#include "block_sparse_kernels.cuh"

extern "C" int sonic_matvec_int8(const void* x, int x_is_bf16, const int8_t* values,
                                 const float* scales, const int* indices, float* y, int M,
                                 int K, int Nb, int R, int bk, int bn, cudaStream_t stream) {
  if (x_is_bf16)
    return launch_matvec<__nv_bfloat16, Int8Scale>(static_cast<const __nv_bfloat16*>(x),
                                                   values, scales, nullptr, 0, indices, y, M,
                                                   K, Nb, R, bk, bn, stream);
  return launch_matvec<float, Int8Scale>(static_cast<const float*>(x), values, scales, nullptr,
                                         0, indices, y, M, K, Nb, R, bk, bn, stream);
}
