// Decode-style attention over a dense KV cache, hand-written for Hopper
// (sm_90a): a decode step (C = 1 query row per slot) or a speculative-verify
// window (C = k + 1 rows), each row attending the cache up to its own
// position.
//
// Replaces no TPU kernel: the JAX package computes this function in plain
// jnp (src/repro/models/layers.py decode_attention), and so does the port's
// plain version (models/layers.py decode_attention_plain, the CPU route).
// On the card that plain version turned the whole S_max cache of every slot,
// K and V, into a new layout in every layer and step, read it a third time
// in the products, and made fp32 scores over all S_max positions.
//
//   out[b, c, kh G + g, :] = sum_s p_s v[b, s, kh, :],
//   p = softmax over s = 0 .. min(pos[b] + c, S_max - 1) of
//       (q[b, c, kh G + g, :] . k[b, s, kh, :]) * Dh^-1/2
//
// q (B, C, H, Dh) bf16 or fp32 and k, v (B, S_max, KH, Dh) bf16 or fp32, all
// read where they lie (strides for slot, row or position, and head; Dh
// contiguous; k and v rows 16-byte aligned), pos (B,) int32 or int64 read on
// the device, out (B, C, H, Dh) contiguous in the cache's type; G = H / KH.
//
// Bound on an H100: bytes.  Each live K/V row is read once per KV head and
// feeds that head's G * C query rows, about G * C operations a byte, far
// below the card's operations line; the least time is the live K/V (plus q
// and out) over 3.35 TB/s.
//
// Design: two launches, a workspace, no atomics.
//  * Splits.  Positions are cut into splits of kSplit = 128, a constant, so
//    that no sum of a row depends on B, C or S_max.  The first kernel's grid
//    is KV heads x splits x (slot, row group), fixed when a CUDA graph
//    captures it (the heads of one slot and split run side by side: they
//    read one stretch of the cache); a block reads pos[b] on the device and
//    exits at once if its split starts past the last position any of its
//    rows attends.
//  * One block per (split, slot, KV head, row group) copies the split's K and
//    V rows once into shared memory with cp.async, 16 bytes a thread, K and
//    V in two groups so that the scores run while V lands; rows past the
//    block's last live position are not read (those up to the next multiple
//    of 4 are zero-filled).  It serves all its query rows (c, g) at once, up
//    to kMaxRows = 16; more rows take more row groups (gridDim.z).  Rows of
//    large fp32 heads (two tiles past the shared memory) take one buffer: V
//    lands in K's after the scores.
//  * Scores: thread t takes position t; for each row one fp32 fmaf chain over
//    Dh in ascending order, times Dh^-1/2; a position past the row's own is
//    -inf.  Per row the split's max (exact), p = exp(s - max), and the sum of
//    p by one fixed tree (a warp butterfly, then the four warps in order).
//  * p . v: thread d takes column d; for each row one fp32 fmaf chain over
//    the split's positions in ascending order.
//  * The split's (max, sum, p . v) per row go to the workspace in fp32; the
//    second kernel (one block per slot, KV head and row) weighs the row's
//    splits 0 .. its own last by exp(m_j - M), adds them in ascending order
//    and writes the output once, in the cache's type.
//  * Row independence: every sum of a row is a chain or tree fixed by the
//    split and the position alone, and a masked position adds exact zeros
//    (p = 0 times a finite or zero-filled v), so a row has the same bits in a
//    decode step, in a verify window, in any batch and at any S_max.
//  * Programmatic dependent launch: neither kernel reads anything before
//    griddepcontrol.wait.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {
namespace da {

constexpr int kSplit = 128;  // positions per split: one per thread of a block
constexpr int kThreads = kSplit;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;      // query rows (c, g) per block
constexpr int kSmemMax = 232448;  // the most shared memory a block can opt in to

struct Params {
  const void* q;    // (B, C, H, Dh)
  const void* k;    // (B, S, KH, Dh)
  const void* v;    // (B, S, KH, Dh)
  const void* pos;  // (B,)
  void* out;        // (B, C, H, Dh) contiguous, of the cache's type
  float* part;      // workspace (B KH, n_splits, rows, Dh): a split's p . v
  float2* ml;       // workspace (B KH, n_splits, rows): a split's (max, sum)
  long long q_sb, q_sc, q_sh;  // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int q_bf16, pos_i64;
  int B, C, H, KH, G, Dh, S;
  int rows;        // C G query rows per (slot, KV head)
  int n_splits;    // ceil(S / kSplit)
  int pitch;       // bytes of one cached row in shared memory
  int one_buffer;  // V lands in K's buffer after the scores
  float scale;     // Dh^-1/2
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One 16-byte unit of a cached row in shared memory, as fp32.
template <typename W>
struct Unit;
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const char* s, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Unit<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const char* s, float (&f)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(s);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
};

// The last position query row c of slot b attends (pos is a position: a
// negative one reads as 0).
__device__ __forceinline__ int last_live(const Params& p, int b, int c) {
  const long long at = p.pos_i64 ? static_cast<const long long*>(p.pos)[b]
                                 : static_cast<const int*>(p.pos)[b];
  const long long l = at + c;
  return static_cast<int>(l < 0 ? 0 : l >= p.S ? p.S - 1 : l);
}

// Shared memory of a split block: the K and V tiles (one tile with
// one_buffer), q as fp32 [R][Dh], p [R][kSplit] and the reductions'
// per-warp values [2][kWarps][R].
__host__ __device__ inline int tile_bytes(const Params& p) { return kSplit * p.pitch; }
__host__ __device__ inline int split_smem(const Params& p, int R) {
  return (p.one_buffer ? 1 : 2) * tile_bytes(p) + 4 * (R * p.Dh + R * kSplit + 2 * kWarps * R);
}

template <typename W, int R>
__global__ void __launch_bounds__(kThreads) split_kernel(const Params p) {
  extern __shared__ __align__(16) char smem[];
  constexpr int E = Unit<W>::kElems;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int groups = (p.rows + R - 1) / R;
  const int kh = blockIdx.x, split = blockIdx.y, b = blockIdx.z / groups;
  const int r0 = (blockIdx.z - b * groups) * R;
  const int pair = b * p.KH + kh;
  const int nr = min(R, p.rows - r0);  // this block's rows
  const int p0 = split * kSplit;       // its first position

  grid_dependency_wait();
  const int last = last_live(p, b, (r0 + nr - 1) / p.G);  // rows ascend in c
  if (p0 > last) return;
  const int live = min(kSplit, last - p0 + 1);  // positions any row attends
  const int fetched = (live + 3) & ~3;           // rows copied or zero-filled

  char* ks = smem;
  char* vs = p.one_buffer ? smem : smem + tile_bytes(p);
  float* qs = reinterpret_cast<float*>(smem + (p.one_buffer ? 1 : 2) * tile_bytes(p));
  float* ps = qs + R * p.Dh;
  float* red = ps + R * kSplit;
  const int units = p.Dh * static_cast<int>(sizeof(W)) / 16;  // per cached row

  auto fetch = [&](const void* base, long long sb, long long ss, long long sh, char* dst) {
    const char* src = static_cast<const char*>(base) +
                      (static_cast<long long>(b) * sb + static_cast<long long>(kh) * sh) *
                          static_cast<long long>(sizeof(W));
    for (int i = t; i < fetched * units; i += kThreads) {
      const int row = i / units, u = i - row * units;
      const bool in = row < live;
      const char* at = src + (in ? static_cast<long long>(p0 + row) * ss *
                                       static_cast<long long>(sizeof(W)) + u * 16
                                 : 0);
      cp_async_16(dst + row * p.pitch + u * 16, at, in ? 16 : 0);
    }
    cp_async_commit();
  };
  fetch(p.k, p.k_sb, p.k_ss, p.k_sh, ks);
  if (!p.one_buffer) fetch(p.v, p.v_sb, p.v_ss, p.v_sh, vs);

  // q as fp32 (rows past nr as zeros) while the copies fly; each row's limit
  // relative to p0 (negative: it attends nothing in this split).
  for (int i = t; i < R * p.Dh; i += kThreads) {
    const int r = i / p.Dh, d = i - r * p.Dh;
    float x = 0.f;
    if (r < nr) {
      const int row = r0 + r, c = row / p.G, g = row - c * p.G;
      const long long off = b * p.q_sb + c * p.q_sc + (kh * p.G + g) * p.q_sh + d;
      x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[off])
                   : static_cast<const float*>(p.q)[off];
    }
    qs[i] = x;
  }
  int lim[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lim[r] = r < nr ? last_live(p, b, (r0 + r) / p.G) - p0 : -1;

  if (p.one_buffer)
    cp_async_wait<0>();
  else
    cp_async_wait<1>();  // K has landed
  __syncthreads();

  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
  if (t < live) {
    const char* krow = ks + t * p.pitch;
    for (int u = 0; u < units; ++u) {
      float kf[E];
      Unit<W>::load(krow + u * 16, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + r * p.Dh + u * E);
#pragma unroll
        for (int e = 0; e < E / 4; ++e) {
          const float4 qv = q4[e];  // one address for the warp: a broadcast
          s[r] = fmaf(qv.x, kf[4 * e], s[r]);
          s[r] = fmaf(qv.y, kf[4 * e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[4 * e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[4 * e + 3], s[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = t <= lim[r] ? __fmul_rn(s[r], p.scale) : -CUDART_INF_F;

  // The split's max of each row, then p and its sum by one fixed tree.
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x = s[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[warp * R + r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = fmaxf(fmaxf(red[r], red[R + r]), fmaxf(red[2 * R + r], red[3 * R + r]));
    const float e = m[r] == -CUDART_INF_F ? 0.f : expf(__fsub_rn(s[r], m[r]));
    ps[r * kSplit + t] = e;
    float x = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[(kWarps + warp) * R + r] = x;
  }
  __syncthreads();  // p and the sums are in; K is no longer read
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* w = red + kWarps * R + r;
    l[r] = __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[R]), w[2 * R]), w[3 * R]);
  }
  if (p.one_buffer) fetch(p.v, p.v_sb, p.v_ss, p.v_sh, vs);
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  const size_t slot = (static_cast<size_t>(pair) * p.n_splits + split) * p.rows + r0;
  for (int d = t; d < p.Dh; d += kThreads) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    const char* col = vs + d * static_cast<int>(sizeof(W));
    for (int i = 0; i < fetched / 4; ++i) {
      float v4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v4[j] = to_float(*reinterpret_cast<const W*>(col + (4 * i + j) * p.pitch));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pr = reinterpret_cast<const float4*>(ps + r * kSplit)[i];
        acc[r] = fmaf(pr.x, v4[0], acc[r]);
        acc[r] = fmaf(pr.y, v4[1], acc[r]);
        acc[r] = fmaf(pr.z, v4[2], acc[r]);
        acc[r] = fmaf(pr.w, v4[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) p.part[(slot + r) * p.Dh + d] = acc[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (t == r && r < nr) p.ml[slot + r] = make_float2(m[r], l[r]);
  launch_dependents();
}

// One block per (slot, KV head) and query row: the row's splits 0 .. its
// last, weighed by exp(m_j - M) and added in ascending order.  The splits'
// (max, sum) come into shared memory at once, one split a thread, and each
// thread's column of p . v partials is loaded before it is summed.
template <typename W>
__global__ void __launch_bounds__(kThreads) combine_kernel(const Params p) {
  // [n_splits]: (max, sum), then (weight, sum) of each split; [n_splits].x: the total
  extern __shared__ float2 mlj[];
  const int t = threadIdx.x, lane = t & 31;
  const int pair = blockIdx.x, row = blockIdx.y, b = pair / p.KH, kh = pair - b * p.KH;
  const int c = row / p.G, g = row - c * p.G;
  grid_dependency_wait();
  const int n = last_live(p, b, c) / kSplit + 1;
  const size_t first = static_cast<size_t>(pair) * p.n_splits * p.rows + row;
  for (int j = t; j < n; j += kThreads) mlj[j] = p.ml[first + static_cast<size_t>(j) * p.rows];
  __syncthreads();
  float big = -CUDART_INF_F;  // the max over the splits (exact in any order)
  for (int j = lane; j < n; j += 32) big = fmaxf(big, mlj[j].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) big = fmaxf(big, __shfl_xor_sync(0xffffffffu, big, o));
  __syncthreads();  // every warp has read the maxima
  for (int j = t; j < n; j += kThreads) mlj[j].x = expf(__fsub_rn(mlj[j].x, big));
  __syncthreads();
  if (t == 0) {
    float sum = 0.f;
    for (int j = 0; j < n; ++j) sum = fmaf(mlj[j].y, mlj[j].x, sum);
    mlj[p.n_splits].x = sum;
  }
  __syncthreads();
  const float* part = p.part + first * p.Dh;
  const size_t stride = static_cast<size_t>(p.rows) * p.Dh;  // between splits
  W* out = static_cast<W*>(p.out) +
           ((static_cast<size_t>(b) * p.C + c) * p.H + kh * p.G + g) * p.Dh;
  for (int d = t; d < p.Dh; d += kThreads) {
    float o = 0.f;
    int j = 0;
    for (; j + 8 <= n; j += 8) {  // eight loads in flight, then their sums in order
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = part[(j + i) * stride + d];
#pragma unroll
      for (int i = 0; i < 8; ++i) o = fmaf(x[i], mlj[j + i].x, o);
    }
    for (; j < n; ++j) o = fmaf(part[j * stride + d], mlj[j].x, o);
    out[d] = from_float<W>(__fdiv_rn(o, mlj[p.n_splits].x));
  }
}

template <typename K>
cudaError_t launch(K kernel, const Params& p, dim3 grid, int smem, cudaStream_t stream,
                   unsigned long long& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err == cudaSuccess) ready |= 1ull << dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename W, int R>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  static unsigned long long ready = 0;  // devices the shared-memory size is set on
  const dim3 grid(p.KH, p.n_splits, p.B * ((p.rows + R - 1) / R));
  return launch(split_kernel<W, R>, p, grid, split_smem(p, R), stream, ready);
}

template <typename W>
cudaError_t run(const Params& p, cudaStream_t stream) {
  // Rows per block: the power of two at or above C G, at most kMaxRows.
  const int rows = p.rows;
  cudaError_t err = rows <= 1   ? launch_split<W, 1>(p, stream)
                    : rows <= 2 ? launch_split<W, 2>(p, stream)
                    : rows <= 4 ? launch_split<W, 4>(p, stream)
                    : rows <= 8 ? launch_split<W, 8>(p, stream)
                                : launch_split<W, kMaxRows>(p, stream);
  if (err != cudaSuccess) return err;
  static unsigned long long ready = 0;
  return launch(combine_kernel<W>, p, dim3(p.B * p.KH, p.rows), 8 * (p.n_splits + 1), stream,
                ready);
}

}  // namespace da
}  // namespace

// out (B, C, H, Dh) = decode-style attention of q over the cache k, v
// (B, S, KH, Dh), each query row c of slot b over positions 0 .. min(pos[b]
// + c, S - 1).  part (B KH ceil(S / 128) C H/KH Dh fp32) and ml (the same
// without Dh, float2) are the workspace.  Strides are in elements; q's and
// the cache's Dh must be contiguous, the cache's rows 16-byte aligned.
extern "C" int decode_attention(const void* q, int q_is_bf16, const void* k, const void* v,
                                int kv_is_bf16, const void* pos, int pos_is_i64, void* out,
                                float* part, float2* ml, int B, int C, int H, int KH, int Dh,
                                int S, long long q_sb, long long q_sc, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                long long v_ss, long long v_sh, float scale,
                                cudaStream_t stream) {
  if (B < 1 || C < 1 || KH < 1 || H < KH || H % KH || Dh < 8 || Dh > 256 || Dh % 8 || S < 1)
    return cudaErrorInvalidValue;
  da::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.pos = pos;
  p.out = out;
  p.part = part;
  p.ml = ml;
  p.q_sb = q_sb;
  p.q_sc = q_sc;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.q_bf16 = q_is_bf16;
  p.pos_i64 = pos_is_i64;
  p.B = B;
  p.C = C;
  p.H = H;
  p.KH = KH;
  p.G = H / KH;
  p.Dh = Dh;
  p.S = S;
  p.rows = C * p.G;
  p.n_splits = (S + da::kSplit - 1) / da::kSplit;
  p.scale = scale;
  // a cached row's 16-byte units, made odd so that the 8 rows one phase of a
  // warp's 16-byte loads reads fall in distinct banks
  p.pitch = ((Dh * (kv_is_bf16 ? 2 : 4) / 16) | 1) * 16;
  p.one_buffer = 0;
  if (da::split_smem(p, da::kMaxRows) > da::kSmemMax) p.one_buffer = 1;
  if (static_cast<long long>(B) * ((p.rows + da::kMaxRows - 1) / da::kMaxRows) > 65535 ||
      p.n_splits > 65535 || static_cast<long long>(B) * KH > 2147483647 || p.rows > 65535 ||
      8 * (p.n_splits + 1) > da::kSmemMax)
    return cudaErrorInvalidValue;
  return kv_is_bf16 ? da::run<__nv_bfloat16>(p, stream) : da::run<float>(p, stream);
}
