// Compressed sparse matvec (the C3 zero-compression FC dataflow), hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_matvec_pallas
// (src/repro/kernels/sparse_matvec/kernel.py:40):
//
//   y[b, n] = sum_c x_nz[b, c] * Wt[idx[c], n]
//
// x_nz (B, knz) bf16 or fp32 (the kept activations), idx (knz,) int32 (the
// kept input rows of Wt, each in [0, K); ascending as topk_sparse_matmul makes
// them, which nothing here relies on), Wt (K, N) bf16 or fp32 row-major,
// y (B, N) fp32; every product is accumulated in fp32.  Only the rows that
// idx names are read: a zero activation never costs a weight byte.
//
// Bound on an H100: bytes.  Each gathered row is read once (knz * N weight
// elements), x_nz and y once; a weight feeds B multiply-adds, two orders of
// magnitude below the card's operations line at decode B.  For one step of
// tinyllama-1.1b's 155 projections at knz = K / 4 that is 517 MB of bf16
// rows, ~0.157 ms at 3.35 TB/s; per projection 0.08 to 9.8 us, so all but
// the LM head are bound by the latency of one launch, not by bandwidth.
//
// Design: one launch per projection, no workspace, no atomics.
//  * Grid.  The kept rows are cut into chunks of kChunk = 32, the columns
//    into tiles of `tile` in {32, 64, 128, 256}.  A tile's chunks are dealt
//    in balanced contiguous ranges to the `split` blocks (1, 2, 4 or 8) of
//    one thread-block cluster.  kernels/build.py sparse_matvec_plan picks
//    tile and split from knz, N and the card's SMs, never from B, so that
//    no projection runs on a few SMs (k and v, N = 256, take tiles of 32
//    columns).  Rows of x past 8 take more row groups (gridDim.y), each a
//    pass over the rows of its tile.
//  * Copies.  A block's kWarps warps work apart until the combine: warp w
//    takes rows 8w .. 8w + 7 of each of the block's chunks and copies them
//    itself, so that every warp has copies in flight (with one producer warp
//    per block the copies in flight set the pace).  A warp keeps kDepth
//    chunks of its rows in flight in its own ring in shared memory: each
//    row's segment of the tile (a contiguous stripe of Wt) by cp.async, 16
//    bytes a lane, one cp.async group per chunk.  The rows' ids come kDepth
//    chunks ahead of the rows, in the same groups (4 bytes a lane), and the
//    first kDepth chunks' ids are the block's first loads.  Ids are clamped
//    to [0, K), so a bad id cannot read outside Wt.
//  * Products, on the CUDA cores in fp32: lane l takes the tile's columns
//    VEC l .. VEC l + VEC - 1 (VEC = tile / 32) for RG rows of x at once (1,
//    4 or 8), each in a running sum over all the block's chunks:
//    acc = fmaf(x, w, acc), rows ascending.  x is staged in shared memory as
//    fp32 [row][RG], kXChunks chunks at a time (all of a block's chunks at
//    tinyllama-1.1b's shapes), by the block while its first rows are in
//    flight, and read as broadcasts.
//  * Combine.  Each warp's sums go through distributed shared memory into
//    the block of the cluster that combines those slots (block q combines
//    slots [q share, (q + 1) share) of the tile's RG x tile, share = RG *
//    tile / split), at row (rank, warp).  After one cluster barrier each
//    output is the sum of its kWarps * split warp sums in ascending (rank,
//    warp) order, written once to y.
//  * Order.  Each output is one fixed chain: fmaf over each warp's rows in
//    ascending order, then the warp sums added in (rank, warp) order.  It
//    depends on knz and split (so on knz, N and the SM count), never on B,
//    the row group, the tile or the route: two runs agree bit for bit and a
//    row's result does not depend on how many rows ride with it
//    (tests/test_torch_sparse_matvec_order.py emulates the chain).
//  * Programmatic dependent launch.  idx and x_nz are outputs of the kernels
//    ahead of this one in the stream (top-k, sort, gather), so a block reads
//    nothing before griddepcontrol.wait.
//  * Routes (kernels/build.py sparse_matvec_route, from the shape and the
//    alignment): 16-byte copies need 16-byte aligned row starts (N *
//    sizeof(W) % 16 == 0 and Wt 16-byte aligned).  Other shapes take the
//    CUDA-core route: each warp loads its rows' columns straight into
//    registers, one chunk at a time; the products and the combine are the
//    same, and so are the bits.
// knz = 0 gives exact zeros (a memset).

#include "decode_mma.cuh"

namespace {
namespace smv {

using mma::cmin;

constexpr int kChunk = 32;                     // kept rows per chunk
constexpr int kWarps = 4;                      // warps per block
constexpr int kRowsPerWarp = kChunk / kWarps;  // rows of a chunk per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 8;                   // blocks of a cluster (portable size)
constexpr int kXChunks = 16;                   // chunks of x staged at once
constexpr int kXBatch = 8;                     // x loads a thread has in flight
constexpr int kRingBytes = 64 * 1024;          // per block: all warps' rings

// 16 (or 4) bytes global -> shared, asynchronously; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(mma::smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(mma::smem_u32(dst)), "l"(src),
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC adjacent weights of one row in shared memory, loaded at once (VEC *
// sizeof(W) bytes, aligned to that) and converted to fp32.
template <typename W, int VEC>
struct Seg {
  static constexpr int kBytes = VEC * static_cast<int>(sizeof(W));
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const W* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x;
        w[4 * i + 1] = v.y;
        w[4 * i + 2] = v.z;
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }

  // bf16: element 2i in the low half of word i, 2i + 1 in the high half
  __device__ __forceinline__ void unpack(float (&f)[VEC]) const {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      if constexpr (sizeof(W) == 4)
        f[v] = __uint_as_float(w[v]);
      else
        f[v] = __uint_as_float(v & 1 ? w[v / 2] & 0xffff0000u : w[v / 2] << 16);
    }
  }
};

struct Params {
  const void* x;   // (B, knz) bf16 or fp32
  const int* idx;  // (knz,) kept rows of Wt
  const void* wt;  // (K, N) of W
  float* y;        // (B, N)
  int x_bf16, B, knz, K, N;
  int split;       // blocks per column tile (the cluster)
  int n_chunks;    // ceil(knz / kChunk)
  int async;       // 1: rows by cp.async into the rings; 0: loads into registers
};

template <typename W, int RG, int VEC>
struct Layout {
  static constexpr int kTile = 32 * VEC;
  static constexpr int kRowBytes = kTile * static_cast<int>(sizeof(W));
  // chunks a warp keeps in flight (its ring), within kRingBytes per block
  static constexpr int kDepth = cmin(8, kRingBytes / (kChunk * kRowBytes));
  static constexpr int kRingWarpBytes = kDepth * kRowsPerWarp * kRowBytes;
  static constexpr int kRecvFloats = kWarps * RG * kTile;
  static constexpr int kXFloats = kXChunks * kChunk * RG;
  static constexpr int kIds = 2 * kDepth * kRowsPerWarp;  // a warp's ring of ids
  static constexpr int kBytes =
      kWarps * kRingWarpBytes + 4 * (kRecvFloats + kXFloats + kWarps * kIds);
};

template <typename W, int RG, int VEC>
__global__ void __launch_bounds__(kThreads) smv_kernel(const Params p) {
  namespace cg = cooperative_groups;
  using L = Layout<W, RG, VEC>;
  constexpr int kTile = L::kTile, kDepth = L::kDepth;
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  W* ring = reinterpret_cast<W*>(smem + warp * L::kRingWarpBytes);      // [kDepth][8][kTile]
  float* recv = reinterpret_cast<float*>(smem + kWarps * L::kRingWarpBytes);  // [4 split][share]
  float* xs = recv + L::kRecvFloats;                                     // [16 chunks][32][RG]
  int* ids = reinterpret_cast<int*>(xs + L::kXFloats) + warp * L::kIds;  // [2 kDepth][8]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x / p.split * kTile;  // the tile's first column
  const int b0 = blockIdx.y * RG;               // the row group's first row of x
  // This block's chunks, [first, first + n), each block at least one
  const int first = rank * p.n_chunks / p.split;
  const int n = (rank + 1) * p.n_chunks / p.split - first;
  const int share = RG * kTile / p.split;  // slots this block combines (a power of two)
  const int share_log2 = __ffs(share) - 1;
  const W* wt = static_cast<const W*>(p.wt);
  auto row0 = [&](int l) { return (first + l) * kChunk + warp * kRowsPerWarp; };
  auto rows_of = [&](int l) { return cmin(kRowsPerWarp, p.knz - row0(l)); };

  mma::grid_dependency_wait();
  mma::launch_dependents();
  // This block has started: the others may write into its shared memory
  // once they have all passed the matching wait.
  mma::cluster_arrive_relaxed();

  // Chunk l's ids of this warp's rows into slot l % (2 kDepth) (lanes 0..7).
  auto fetch_ids = [&](int l) {
    if (l < n && lane < kRowsPerWarp) {
      const bool in = lane < rows_of(l);
      cp_async_4(&ids[l % (2 * kDepth) * kRowsPerWarp + lane], p.idx + (in ? row0(l) + lane : 0),
                 in ? 4 : 0);
    }
  };
  // Chunk l's rows into stage l % kDepth, from the ids in their slot: each
  // row's segment as 16-byte units, kLanes lanes per row, kPass rows per
  // pass of the warp, kPer units per lane and row.
  constexpr int kUnits = L::kRowBytes / 16;  // a power of 2
  constexpr int kLanes = kUnits < 32 ? kUnits : 32;
  constexpr int kPass = 32 / kLanes, kPer = kUnits / kLanes;
  const int units = cmin(kTile, p.N - n0) * static_cast<int>(sizeof(W)) / 16;
  const size_t pitch = static_cast<size_t>(p.N) * sizeof(W);
  const char* src = reinterpret_cast<const char*>(wt + n0) + lane % kLanes * 16;
  auto fetch_rows = [&](int l) {
    if (l >= n) return;
    const int rows = rows_of(l);
    const int* slot = ids + l % (2 * kDepth) * kRowsPerWarp;
    char* dst = reinterpret_cast<char*>(ring + l % kDepth * kRowsPerWarp * kTile) +
                lane % kLanes * 16;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp / kPass; ++i) {
      const int u = i * kPass + lane / kLanes;
      if (u < rows) {
        const size_t r = min(max(slot[u], 0), p.K - 1);
#pragma unroll
        for (int m = 0; m < kPer; ++m)
          if (lane % kLanes + m * 32 < units)
            cp_async_16(dst + (u * kUnits + m * 32) * 16, src + r * pitch + m * 32 * 16);
      }
    }
  };
  // x: staged by the block into shared memory as fp32 [row][RG], a window
  // of kXChunks chunks at a time, kXBatch loads a thread in flight.
  auto x_at = [&](int b, int row) -> float {
    const size_t i = static_cast<size_t>(b) * p.knz + row;
    return p.x_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(p.x) + i))
                    : __ldg(static_cast<const float*>(p.x) + i);
  };
  auto x_rows = [&](int l0) {  // of the window of chunks l0 .. l0 + kXChunks - 1
    return cmin(cmin(kXChunks, n - l0) * kChunk, p.knz - (first + l0) * kChunk);
  };
  auto load_x = [&](int l0, int i0, float (&v)[kXBatch]) {
    const int r0 = (first + l0) * kChunk, rows = x_rows(l0);
#pragma unroll
    for (int k = 0; k < kXBatch; ++k) {  // along each row of x: coalesced
      const int i = i0 + k * kThreads, b = i / rows;
      v[k] = i < rows * RG && b0 + b < p.B ? x_at(b0 + b, r0 + i - b * rows) : 0.f;
    }
  };
  auto store_x = [&](int l0, int i0, const float (&v)[kXBatch]) {
    const int rows = x_rows(l0);
#pragma unroll
    for (int k = 0; k < kXBatch; ++k) {
      const int i = i0 + k * kThreads, b = i / rows;
      if (i < rows * RG) xs[(i - b * rows) * RG + b] = v[k];
    }
  };
  auto stage_x = [&](int l0, int i0) {  // the window's batches from i0 on
    for (; i0 < x_rows(l0) * RG; i0 += kThreads * kXBatch) {
      float v[kXBatch];
      load_x(l0, i0, v);
      store_x(l0, i0, v);
    }
  };

  // Prologue: the ids of the first kDepth chunks asked for, then the first
  // batch of x (after the ids, so that they do not queue behind it), then
  // (once the ids are in) their rows with the next kDepth chunks' ids, one
  // group per chunk; then the rest of x's first window.
  for (int d = 0; d < kDepth; ++d) fetch_ids(d);
  cp_async_commit();
  float x0[kXBatch];
  load_x(0, t, x0);
  cp_async_wait<0>();
  __syncwarp();
  for (int d = 0; d < kDepth; ++d) {
    if (p.async) fetch_rows(d);
    fetch_ids(d + kDepth);
    cp_async_commit();
  }
  store_x(0, t, x0);
  stage_x(0, t + kThreads * kXBatch);
  __syncthreads();

  float acc[RG][VEC];
#pragma unroll
  for (int b = 0; b < RG; ++b)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[b][v] = 0.f;
  auto fma_row = [&](const float (&w)[VEC], const float* xr) {
    float xv[RG];
#pragma unroll
    for (int b = 0; b < RG; ++b) xv[b] = xr[b];  // one address for the warp: a broadcast
#pragma unroll
    for (int b = 0; b < RG; ++b)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[b][v] = fmaf(xv[b], w[v], acc[b][v]);
  };

  for (int l = 0; l < n; ++l) {
    if (l > 0 && l % kXChunks == 0) {
      __syncthreads();  // every warp is done with the last window
      stage_x(l, t);
      __syncthreads();
    }
    cp_async_wait<kDepth - 1>();  // chunk l's rows and chunk l + kDepth's ids
    __syncwarp();
    const int rows = rows_of(l);
    const float* xw = xs + (l % kXChunks * kChunk + warp * kRowsPerWarp) * RG;
    if (p.async) {
      const W* seg = ring + l % kDepth * kRowsPerWarp * kTile + lane * VEC;
#pragma unroll
      for (int u0 = 0; u0 < kRowsPerWarp; u0 += 4) {
        Seg<W, VEC> raw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) raw[i].load(seg + (u0 + i) * kTile);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (u0 + i < rows) {  // the same for the whole warp
            float w[VEC];
            raw[i].unpack(w);
            fma_row(w, xw + (u0 + i) * RG);
          }
        }
      }
    } else {
      const int* slot = ids + l % (2 * kDepth) * kRowsPerWarp;
      float w[kRowsPerWarp][VEC];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u) {
        const size_t r = u < rows ? min(max(slot[u], 0), p.K - 1) : 0;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int col = n0 + lane * VEC + v;
          w[u][v] = u < rows && col < p.N ? to_float(__ldg(wt + r * p.N + col)) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u)
        if (u < rows) fma_row(w[u], xw + u * RG);
    }
    __syncwarp();  // every lane is done with stage l % kDepth and ids slot l % (2 kDepth)
    if (p.async) fetch_rows(l + kDepth);
    fetch_ids(l + 2 * kDepth);
    cp_async_commit();
  }

  // Push this warp's sums to their combining blocks, at row (rank, warp):
  // slot f = b * tile + column, each lane's VEC columns in stores of up to
  // 16 bytes, so that a warp's stores fill consecutive words (scalar stores
  // VEC words apart would collide in the banks).  Then the ordered combine
  // of this block's slots from its own shared memory.
  mma::cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int b = 0; b < RG; ++b) {
    if (b0 + b < p.B) {
      const int f = b * kTile + lane * VEC;  // VEC slots with one owner
      float* dst = cluster.map_shared_rank(recv, f >> share_log2) +
                   (rank * kWarps + warp) * share + (f & (share - 1));
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int v = 0; v < VEC; v += 4)
          *reinterpret_cast<float4*>(dst + v) =
              make_float4(acc[b][v], acc[b][v + 1], acc[b][v + 2], acc[b][v + 3]);
      } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[b][0], acc[b][1]);
      } else {
        dst[0] = acc[b][0];
      }
    }
  }
  mma::cluster_arrive();  // this block's sums pushed (release) ...
  mma::cluster_wait();    // ... and every other block's arrived (acquire)
  const int terms = kWarps * p.split;
  for (int e = t; e < share; e += kThreads) {
    const int f = rank * share + e;
    const int b = f / kTile, col = n0 + f % kTile;
    if (b0 + b >= p.B || col >= p.N) continue;
    float out = recv[e];
#pragma unroll 8
    for (int q = 1; q < terms; ++q) out = __fadd_rn(out, recv[q * share + e]);
    p.y[static_cast<size_t>(b0 + b) * p.N + col] = out;
  }
}

template <typename W, int RG, int VEC>
cudaError_t launch_t(const Params& p, int tiles, int groups, cudaStream_t stream) {
  auto kernel = smv_kernel<W, RG, VEC>;
  static unsigned long long ready = 0;  // devices the shared-memory size is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mma::kSmemMax);
    if (err == cudaSuccess) ready |= 1ull << dev;
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.split, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<W, RG, VEC>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename W, int RG>
cudaError_t by_tile(const Params& p, int tile, int groups, cudaStream_t stream) {
  const int tiles = (p.N + tile - 1) / tile;
  switch (tile) {
    case 32: return launch_t<W, RG, 1>(p, tiles, groups, stream);
    case 64: return launch_t<W, RG, 2>(p, tiles, groups, stream);
    case 128: return launch_t<W, RG, 4>(p, tiles, groups, stream);
    default: return launch_t<W, RG, 8>(p, tiles, groups, stream);
  }
}

// Rows of x per block: all of B up to 8, in groups of 8 past that.
template <typename W>
cudaError_t by_rows(const Params& p, int tile, cudaStream_t stream) {
  const int rg = p.B == 1 ? 1 : p.B <= 4 ? 4 : 8;
  const int groups = (p.B + rg - 1) / rg;
  if (groups > 65535) return cudaErrorInvalidValue;
  if (rg == 1) return by_tile<W, 1>(p, tile, groups, stream);
  if (rg == 4) return by_tile<W, 4>(p, tile, groups, stream);
  return by_tile<W, 8>(p, tile, groups, stream);
}

}  // namespace smv
}  // namespace

// y (B, N) = x_nz (B, knz) @ Wt[idx] in one launch: `tile` columns per block
// (32, 64, 128 or 256) and `split` blocks per tile (1, 2, 4 or 8, at most
// ceil(knz / 32)), as kernels/build.py sparse_matvec_plan chooses them;
// `async` 1 copies rows with cp.async (N * sizeof(W) % 16 == 0 and Wt
// 16-byte aligned, else an error), 0 loads them into registers.
extern "C" int sparse_matvec(const void* x, int x_is_bf16, const int* idx, const void* wt,
                             int wt_is_bf16, float* y, int B, int knz, int K, int N, int tile,
                             int split, int async, cudaStream_t stream) {
  if (B < 1 || knz < 0 || K < 1 || N < 1) return cudaErrorInvalidValue;
  if (knz == 0) return cudaMemsetAsync(y, 0, static_cast<size_t>(B) * N * sizeof(float), stream);
  const int esize = wt_is_bf16 ? 2 : 4;
  const int n_chunks = (knz + smv::kChunk - 1) / smv::kChunk;
  if ((tile != 32 && tile != 64 && tile != 128 && tile != 256) || split < 1 ||
      split > smv::kMaxSplit || (split & (split - 1)) || split > n_chunks)
    return cudaErrorInvalidValue;
  if (async && ((N * esize) % 16 || reinterpret_cast<uintptr_t>(wt) % 16))
    return cudaErrorInvalidValue;
  const smv::Params p{x, idx, wt, y, x_is_bf16, B, knz, K, N, split, n_chunks, async};
  if (wt_is_bf16) return smv::by_rows<__nv_bfloat16>(p, tile, stream);
  return smv::by_rows<float>(p, tile, stream);
}
