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
// Two entry points, one per route (kernels/build.py mma_route picks, from
// the block shape and x's type, never from M):
//
//  * sonic_matvec_int8_mma, the tensor-core route, for bf16 x with
//    bk % 16 == 0 and bn % 64 == 0: decode_kernel in decode_mma.cuh with
//    the Int8Scale policy.  It does block_sparse_matmul_int8_mma's
//    arithmetic (one exact bf16 part per int8 value, one wgmma m64n8k16 per
//    k16 step into a fresh fp32 tile per 64-row chunk, out = fmaf(s, tile,
//    out) in ascending chunk order), so a decode row equals the same row in
//    a prefill or verify window bit for bit.  The chunks of each 64-column
//    tile are spread over a cluster of `split` blocks
//    (kernels/build.py decode_split), their tiles parked in shared memory
//    and combined in order through distributed shared memory.
//  * sonic_matvec_int8, the CUDA-core route, for fp32 x and other blocks:
//    matvec_kernel in block_sparse_kernels.cuh with the Int8Scale policy
//    (one block per (N-block, 32-column slice), 16 weight loads in flight
//    per thread, fp32 FMAs, a fixed-order reduction of the row groups).

#include "decode_mma.cuh"

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

extern "C" int sonic_matvec_int8_mma(const void* x, int x_is_bf16, const int8_t* values,
                                     const float* scales, const int* indices, float* y, int M,
                                     int K, int Nb, int R, int bk, int bn, int split,
                                     cudaStream_t stream) {
  if (!x_is_bf16) return cudaErrorInvalidValue;
  return mma::launch_decode<Int8Scale>(static_cast<const __nv_bfloat16*>(x), values, nullptr, 0,
                                       scales, indices, y, M, K, Nb, R, bk, bn, split, stream);
}

#ifdef SONIC_DECODE_CLOCKS
// (n, 7) SM clocks of decode_kernel's blocks 0 .. n - 1 in the last launch.
extern "C" int decode_clocks(long long* host, int n) {
  return cudaMemcpyFromSymbol(host, mma::g_decode_clocks,
                              sizeof(long long) * mma::kClockPoints * n);
}
#endif
