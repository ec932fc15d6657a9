// The decode matvecs on Hopper's tensor cores (sm_90a): the tensor-core
// route, for bf16 x and M <= 7 rows, of sonic_matvec_int8 (Int8Scale) and
// sonic_matvec (Codebook<int8_t>).
//
//   y[m, n] = sum over kept K-blocks r, k of x[m, k] * w[k, n]
//
// Arithmetic: that of mma_kernel (block_mma.cuh) at a token tile of 8, so
// a decode row gets the bits of the same row in a prefill or verify window
// of the block-sparse matmuls (block_sparse_matmul_int8, sonic_matmul).
// For each N-block j, 64-column tile, kept block r (ascending) and chunk of
// min(bk, 64) rows of it (ascending):
//  * the tokens are padded to 8 with zeros (TMA fills rows past M);
//  * the chunk's fresh fp32 tile (64 columns x 8 tokens) comes from the
//    same wgmma m64n8k16 steps as mma_kernel's, A (the weights as bf16
//    parts, Parts<W>) in registers, B (x) from shared memory, the parts in
//    the same order (lo, then mid, then hi for the codebook), starting from
//    a zero tile;
//  * the tiles are added into the output in ascending (r, chunk) order
//    from 0: out = fmaf(s[j, r], tile, out) (Int8Scale) or out + tile, as
//    add_tile does.
// No split-K sum of partial outputs: each output is still one fp32 chain
// over the chunks in order.
//
// What differs from mma_kernel, so that a few rows stream at the bytes
// bound (mma_kernel's one consumer walks a tile's chunks one after another,
// ~1000 cycles each at a tile of 8 tokens):
//  * Chunks in parallel, combine in order.  The chunk tiles are independent;
//    only their sum is ordered.  The chunks of a 64-column tile are dealt
//    in balanced contiguous ranges to the `split` blocks of one cluster
//    (split in {1, 2, 4, 8}, chosen by kernels/build.py decode_split from
//    the weight's shape, the card's SMs and the blocks an SM holds, never
//    from M).  Each block's consumer
//    warpgroup keeps two chunks' wgmma in flight while it builds the next
//    chunk's A fragments.  At split 1 the block adds each tile into
//    registers as it finishes, as mma_kernel does.  Otherwise block q of
//    the cluster combines 1 / split of the tile's 512 fragment slots (64
//    columns x 8 tokens): each finished tile's slots (4 a thread; those of
//    tokens past M are dropped) go straight into the shared memory of the
//    block that combines them, through distributed shared memory, at the
//    chunk's row; after one cluster barrier each block adds its slots' rows
//    in ascending chunk order from its own shared memory and writes y.  No
//    workspace in device memory, no atomics.
//  * One producer thread per block TMA-loads the chunks of its range into
//    a ring of up to kDecodeStages stages, so a block with at most that many
//    chunks has all its weight bytes in flight at once: per chunk the x
//    tile of 8 tokens (128-byte swizzled) and the tile's 64 columns of
//    weights as one box of 64-byte rows, 64-byte swizzled so that the
//    fragment loads hit distinct banks (mma_kernel takes four boxes of
//    16-byte rows).  The block loads its kept-block ids before any weight,
//    so that its x offsets do not queue behind the weights of the whole
//    grid.
//  * Launched with programmatic stream serialization: before it waits on
//    the kernels ahead of it in the stream, a block initialises its
//    barriers and asks L2 for its first two chunks' weights and its kept-
//    block ids and scales (hints; nothing is read into the block before the
//    wait), so a chain of projections overlaps one launch's first fetch
//    with the one before.
//
// Bound on an H100: bytes.  Each kept weight byte feeds at most 7
// multiply-adds (3 x 7 bf16 products for the codebook's parts), so the
// least time is the kept weights (plus scales or codebook, indices, x and
// y) over 3.35 TB/s: 0.157 ms for one tinyllama-1.1b decode step of 155
// projections at sparsity 0.5.
//
// Taken when (kernels/build.py mma_route) x is bf16, bk % 16 == 0 and
// bn % 64 == 0; fp32 x and other blocks keep matvec_kernel
// (block_sparse_kernels.cuh) on the CUDA cores.
#pragma once

#include <cooperative_groups.h>

#include "block_mma.cuh"

namespace {
namespace mma {

constexpr int kDecodeTokens = 8;   // wgmma's N: the token tile
constexpr int kMaxSplit = 8;       // blocks of a cluster (portable size)
constexpr int kMaxLocal = 64;      // chunks per block
constexpr int kDecodeStages = 16;  // ring stages per block
constexpr int kSlots = kCols * kDecodeTokens;  // fragment slots of one 64-column tile

// Compile-time switch, off in the built library: -DSONIC_DECODE_CLOCKS
// records per block the SM clock at seven points of decode_kernel
// (tools/decode_mma_clocks.py builds with it and reads them back through
// the entry point decode_clocks of sonic_matvec_int8.cu).
#ifdef SONIC_DECODE_CLOCKS
constexpr int kClockBlocks = 8192, kClockPoints = 7;
__device__ long long g_decode_clocks[kClockBlocks][kClockPoints];
#define DECODE_STAMP(i, who)                                             \
  do {                                                                   \
    if (threadIdx.x == (who) && blockIdx.x < kClockBlocks)               \
      g_decode_clocks[blockIdx.x][i] = clock64();                        \
  } while (0)
#else
#define DECODE_STAMP(i, who) \
  do {                       \
  } while (0)
#endif

constexpr int kDecodeConsumers = 128;  // one consumer warpgroup
constexpr int kDecodeThreads = kDecodeConsumers + 32;  // and one producer warp
static_assert(kMaxLocal <= kDecodeThreads, "one thread loads each chunk's kept-block id");

// Shared memory of one decode block: `stages` x tiles (1024-aligned),
// `stages` raw weight tiles (chunk x 64), the received chunk tiles of the
// slots it combines (split > 1: n_chunks x 512 / split floats), the packed
// codebook (Codebook<I> only), the barriers, the x offsets of the block's
// chunks and the scale of each of the tile's chunks (Int8Scale only).
template <typename W>
struct DecodeLayout {
  using P = Parts<W>;
  static constexpr int kXBytes = kDecodeTokens * kChunkK * 2;
  static constexpr int kRawBytes = kChunkK * kCols * (int)sizeof(typename W::Raw);
  static constexpr int kCbBytes = 8 * P::kCopies * P::kTable;
  static __host__ __device__ constexpr int recv_floats(int n_chunks, int split) {
    return split > 1 ? n_chunks * kSlots / split : 0;
  }
  static __host__ __device__ constexpr int bytes(int stages, int n_chunks, int split,
                                                  int local) {
    return 1024 + stages * (kXBytes + kRawBytes) + 4 * recv_floats(n_chunks, split) +
           kCbBytes + 2 * stages * 8 + 4 * local + (W::kScaled ? 4 * n_chunks : 0);
  }
};

struct DecodeParams {
  const float* codebook;  // Codebook<I>: (C,) fp32 centroids
  const float* scales;    // Int8Scale: (Nb, R) fp32, one per kept block
  const int* indices;     // (Nb, R) kept K-block ids
  float* y;
  int C, M, N, R, bk, bn;
  int chunk;     // K rows per chunk: min(bk, 64) = 16 * kSteps
  int n_chunks;  // chunks per 64-column tile: R * bk / chunk
  int split;     // blocks per tile (the cluster)
  int local;     // chunks per block: ceil(n_chunks / split)
  int stages;    // ring stages: min(local, kDecodeStages), or what fits
};

// Programmatic dependent launch: wait until the grids this one depends on
// have completed and their writes are visible; let the next grid in the
// stream start its blocks (they wait in turn before reading anything).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
// A hint: bring a TMA box of the tensor into L2 (no shared memory written).
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int inner, int outer) {
  asm volatile("cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(inner), "r"(outer)
               : "memory");
}

// Cluster barrier, in two halves: arrive (release: this thread's earlier
// writes, to its own or another block's shared memory, become visible to
// the cluster; relaxed: only counts) and wait (acquire).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// Blocks per SM the registers are budgeted for: one part (int8) keeps the
// fragments of two chunks in 32 registers, three parts in 96.
// kernels/build.py DECODE_BLOCKS_PER_SM repeats these for decode_split.
template <typename W>
constexpr int kDecodeBlocksPerSm = Parts<W>::kParts == 1 ? 4 : 2;

// One k16 step of a warp's A fragment (a_fragment's registers) from a
// stage of raw weights that one TMA box wrote as [chunk][64] with the
// 64-byte swizzle: the 16-byte unit u of row k lies at unit u ^ (k / 2 % 4),
// so the rows 2 apart that a warp's lanes read fall in distinct banks.
// Warp w's 16 weight columns are unit w.
template <typename W>
__device__ __forceinline__ void a_fragment_sw64(const typename W::Raw* raw, const uint2* cb,
                                                int k0, int warp, int lane,
                                                uint32_t (&a)[Parts<W>::kParts][4]) {
  static_assert(sizeof(typename W::Raw) == 1, "64 one-byte weights fill a 64-byte row");
  using P = Parts<W>;
  const int col = lane >> 2;
  const int row = k0 + 2 * (lane & 3);
  typename W::Raw v[8];
#pragma unroll
  for (int r = 0; r < 4; ++r) {  // register r: column col + 8 (r & 1), rows row + 8 (r >> 1)
    const int k = row + 8 * (r >> 1);  // even: k and k + 1 share a swizzle
    const typename W::Raw* p = raw + k * kCols + ((warp ^ ((k >> 1) & 3)) << 4) + col + 8 * (r & 1);
    v[2 * r] = p[0];
    v[2 * r + 1] = p[kCols];
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w[P::kParts];
    P::pair(v[2 * r], v[2 * r + 1], cb, w);
#pragma unroll
    for (int q = 0; q < P::kParts; ++q) a[q][r] = w[q];
  }
}

template <typename W, int kSteps>
__global__ void __launch_bounds__(kDecodeThreads, kDecodeBlocksPerSm<W>)
decode_kernel(const __grid_constant__ CUtensorMap x_map,
              const __grid_constant__ CUtensorMap raw_map, const DecodeParams p) {
  namespace cg = cooperative_groups;
  using Raw = typename W::Raw;
  using P = Parts<W>;
  using L = DecodeLayout<W>;
  constexpr int kParts = P::kParts;
  constexpr int kConsumers = kDecodeConsumers;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int S = p.stages;
  const int share = kSlots / p.split;  // fragment slots this block combines
  uint8_t* xs = base;                  // S x tiles, 1024-aligned each
  uint8_t* wt = xs + S * L::kXBytes;   // S raw tiles, [chunk][64] swizzled
  float* recv = reinterpret_cast<float*>(wt + S * L::kRawBytes);  // [n_chunks][share]
  uint2* cb = reinterpret_cast<uint2*>(recv + L::recv_floats(p.n_chunks, p.split));
  uint64_t* full = reinterpret_cast<uint64_t*>(cb + P::kCopies * P::kTable);
  uint64_t* empty = full + S;
  int* xks = reinterpret_cast<int*>(empty + S);          // [local] K offset of x per chunk
  float* scs = reinterpret_cast<float*>(xks + p.local);  // [n_chunks] Int8Scale: chunk scales

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / p.split;
  const int tiles = p.bn / kCols;
  const int j = tile / tiles;                 // N-block
  const int c0 = (tile - j * tiles) * kCols;  // first column of the tile in it
  const int per_block = p.bk / p.chunk;       // chunks per kept block
  // This block's chunks, [first, first + n): the tile's chunks dealt in
  // balanced contiguous ranges (each block at least one, at most `local`).
  const int first = rank * p.n_chunks / p.split;
  const int n = (rank + 1) * p.n_chunks / p.split - first;
  const bool alone = p.split == 1;            // the whole chain in this block's registers
  const int t = threadIdx.x;
  DECODE_STAMP(0, 0);

  // Before the wait on the grids this one depends on: barriers, and L2
  // prefetches of the block's first two weight boxes and of the tile's
  // kept-block ids and scales, hints that read nothing into the block.
  // After it every thread takes part in the loads the producer needs first
  // (each chunk's kept-block id, its x offset: thread l loads chunk l's) and
  // then in the codebook and the chunks' scales; the weights are asked for
  // once the ids have come, so that the ids do not queue behind them.
  auto raw_row = [&](int l) {
    const int c = first + l;
    const int r = c / per_block;
    return (j * p.R + r) * p.bk + (c - r * per_block) * p.chunk;
  };
  if (t == kConsumers) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int l = 0; l < min(n, 2); ++l) tma_prefetch_2d(&raw_map, c0, raw_row(l));
  } else if (t < kConsumers && t * 8 < p.R) {  // one 32-byte sector each
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p.indices + j * p.R + t * 8));
    if (W::kScaled) asm volatile("prefetch.global.L2 [%0];" ::"l"(p.scales + j * p.R + t * 8));
  }
  grid_dependency_wait();
  launch_dependents();
  if (t < n) {
    const int c = first + t;
    xks[t] = __ldg(p.indices + j * p.R + c / per_block) * p.bk + (c % per_block) * p.chunk;
  }
  stage_parts<W>(cb, p.codebook, p.C, t, kDecodeThreads);
  if constexpr (W::kScaled)
    for (int c = t; c < p.n_chunks; c += kDecodeThreads)
      scs[c] = __ldg(p.scales + j * p.R + c / per_block);
  __syncthreads();
  // This block has started: the others may write into its shared memory
  // once they have all passed the matching wait.
  if (!alone) cluster_arrive_relaxed();
  DECODE_STAMP(1, 0);

  if (t >= kConsumers) {
    // Producer: one thread keeps the ring full, each chunk's x tile and
    // weights completing on its stage's barrier; the warp takes no part in
    // the combine.
    if (t == kConsumers) {
      const int bytes = L::kXBytes + p.chunk * kCols * static_cast<int>(sizeof(Raw));
      for (int l = 0; l < n; ++l) {
        const int s = l % S;
        if (l >= S) mbar_wait(&empty[s], (l / S - 1) & 1);
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(xs + s * L::kXBytes, &x_map, &full[s], xks[l], 0);
        tma_load_2d(wt + s * L::kRawBytes, &raw_map, &full[s], c0, raw_row(l));
      }
      DECODE_STAMP(2, kConsumers);
    }
    if (!alone) {
      cluster_wait();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // Consumer warpgroup.  Chunk l's fragments are built (loads batched) and
  // its kParts * kSteps wgmma issued into a fresh tile (lo, then mid, then
  // hi) before the previous chunk's group is waited for, so two chunks'
  // products are in flight, and the next chunk is built while one is.  A
  // finished tile is added into the output in registers (split 1) or
  // pushed, each slot to the block of the cluster that combines it; then
  // its stage is released.
  const int warp = t >> 5, lane = t & 31;
  const uint2* mine = cb + (t & (P::kCopies - 1));
  uint32_t a0[kSteps][kParts][4], a1[kSteps][kParts][4];
  float p0[4], p1[4], acc[4] = {0.f, 0.f, 0.f, 0.f};
  // Register i of consumer thread t is slot f = 128 i + t: column
  // 16 warp + lane / 4 + 8 (i / 2) of the tile, token 2 (lane % 4) + i % 2;
  // its combining block, and its place in that block's rows.
  float* dst[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int f = i * kConsumers + t;
    dst[i] = !alone && 2 * (lane & 3) + (i & 1) < p.M
                 ? cluster.map_shared_rank(recv, f / share) + f % share
                 : nullptr;
  }

  auto build = [&](uint32_t (&a)[kSteps][kParts][4], int l) {
    const int s = l % S;
    mbar_wait(&full[s], (l / S) & 1);
    const Raw* blk = reinterpret_cast<const Raw*>(wt + s * L::kRawBytes);
#pragma unroll
    for (int k = 0; k < kSteps; ++k) a_fragment_sw64<W>(blk, mine, 16 * k, warp, lane, a[k]);
  };
  auto issue = [&](uint32_t (&a)[kSteps][kParts][4], float (&part)[4], int l) {
    const uint32_t xa = smem_u32(xs + (l % S) * L::kXBytes);
    fence_operands(part);
    wgmma_fence();
#pragma unroll
    for (int q = kParts - 1; q >= 0; --q)
#pragma unroll
      for (int k = 0; k < kSteps; ++k)
        Wgmma<kDecodeTokens>::mma(part, a[k][q], desc_b128(xa + k * 32),
                                  q < kParts - 1 || k > 0);
    wgmma_commit();
  };
  auto retire = [&](float (&part)[4], int l) {  // after the wait on its group
    fence_operands(part);
    if (alone) {
      add_tile<W>(acc, part, W::kScaled ? scs[l] : 1.f);
    } else {
      const int row = (first + l) * share;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (dst[i]) dst[i][row] = part[i];
    }
    mbar_arrive(&empty[l % S]);
  };

  // Every block has at least one chunk (decode_split keeps split <= the
  // chunks; the ranges are balanced).  The wgmma are issued outside any
  // condition (a conditional break before them instead), so that the
  // compiler need not serialize them.
  build(a0, 0);
  issue(a0, p0, 0);
  if (!alone) cluster_wait();  // every block of the cluster has started
  DECODE_STAMP(3, 0);
  if (n > 1) build(a1, 1);
  for (int l = 0;; l += 2) {  // chunk l in flight in p0; a1 holds chunk l + 1
    if (l + 1 >= n) {
      wgmma_wait<0>();
      retire(p0, l);
      break;
    }
    issue(a1, p1, l + 1);
    wgmma_wait<1>();
    retire(p0, l);
    if (l + 2 < n) build(a0, l + 2);
    if (l + 2 >= n) {
      wgmma_wait<0>();
      retire(p1, l + 1);
      break;
    }
    issue(a0, p0, l + 2);
    wgmma_wait<1>();
    retire(p1, l + 1);
    if (l + 3 < n) build(a1, l + 3);
  }
  DECODE_STAMP(4, 0);
  if (alone) {
    const int n0 = j * p.bn + c0 + 16 * warp + (lane >> 2);
    const int m = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m + (i & 1) < p.M) p.y[(size_t)(m + (i & 1)) * p.N + n0 + 8 * (i >> 1)] = acc[i];
    DECODE_STAMP(5, 0);
    DECODE_STAMP(6, 0);
    return;
  }
  cluster_arrive();  // this block's tiles pushed (release) ...
  cluster_wait();    // ... and every other block's arrived (acquire)
  DECODE_STAMP(5, 0);

  // The ordered combine of this block's share of the tile's slots, from
  // its own shared memory: slot f = rank * share + e, chunk c at
  // recv[c * share + e].
  for (int e = t; e < share; e += kConsumers) {
    const int f = rank * share + e;
    const int u = f % kConsumers, i = f / kConsumers;  // thread and register of the slot
    const int m = 2 * (u & 3) + (i & 1);
    if (m >= p.M) continue;
    float out = 0.f;
    for (int c = 0; c < p.n_chunks; c += 8) {
      float v[8], sc[8];
#pragma unroll
      for (int h = 0; h < 8; ++h) {  // loads first (past the last chunk: in bounds, unused)
        const int cc = min(c + h, p.n_chunks - 1);
        v[h] = recv[cc * share + e];
        sc[h] = W::kScaled ? scs[cc] : 1.f;
      }
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (c + h < p.n_chunks) out = W::kScaled ? fmaf(sc[h], v[h], out) : out + v[h];
    }
    const int col = j * p.bn + c0 + 16 * (u >> 5) + ((u & 31) >> 2) + 8 * (i >> 1);
    p.y[(size_t)m * p.N + col] = out;
  }
  DECODE_STAMP(6, 0);
}

// make_map through a small cache of the maps of recent launches, keyed by
// every input of the map (a map holds a layout and an address, no data, so
// an address reused by another tensor of the same layout gets the same
// map): a decode step launches each projection's weights, and usually the
// same few x buffers, again and again, and encoding two maps per launch
// costs host time the decode step is bound by.
inline bool cached_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int elem,
                       uint64_t inner, uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                       CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* ptr = nullptr;
    uint64_t inner = 0, outer = 0;
    uint32_t box_inner = 0, box_outer = 0;
    int type = 0, elem = 0, swizzle = 0;
    CUtensorMap map;
  };
  static thread_local Entry cache[512];
  Entry& e = cache[(reinterpret_cast<uintptr_t>(ptr) / 256 ^ outer * 31 ^ inner) % 512];
  if (e.ptr == ptr && e.inner == inner && e.outer == outer && e.box_inner == box_inner &&
      e.box_outer == box_outer && e.type == type && e.elem == elem && e.swizzle == swizzle) {
    *map = e.map;
    return true;
  }
  if (!make_map(map, type, ptr, elem, inner, outer, box_inner, box_outer, swizzle)) return false;
  e = Entry{ptr, inner, outer, box_inner, box_outer, type, elem, swizzle, *map};
  return true;
}

template <typename W, int kSteps>
cudaError_t launch_decode_t(const __nv_bfloat16* x, int K, const typename W::Raw* raw,
                            uint64_t raw_rows, const DecodeParams& p, int tiles,
                            cudaStream_t stream) {
  CUtensorMap x_map, raw_map;
  if (!cached_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, K, p.M, kChunkK,
                  kDecodeTokens, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !cached_map(&raw_map, raw_type<typename W::Raw>(), raw, sizeof(typename W::Raw), p.bn,
                  raw_rows, kCols, p.chunk, CU_TENSOR_MAP_SWIZZLE_64B)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = decode_kernel<W, kSteps>;
  static unsigned long long ready = 0;  // devices the shared-memory size is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
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
  cfg.gridDim = dim3(tiles * p.split);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = DecodeLayout<W>::bytes(p.stages, p.n_chunks, p.split, p.local);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, kernel, x_map, raw_map, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A decode matvec on the tensor cores: x (M <= 7, K) bf16, raw weights
// (Nb, R, bk, bn) of policy W, bk a power of two from 16 to 128, bn a
// multiple of 64, `split` blocks per 64-column tile (1, 2, 4 or 8, at most
// the tile's chunks) with at most kMaxLocal chunks each; the codebook (C centroids) for
// Codebook<int8_t>, the (Nb, R) scales for Int8Scale.  The ring takes what
// shared memory the received tiles leave, up to kDecodeStages stages and
// at least 2.
template <typename W>
cudaError_t launch_decode(const __nv_bfloat16* x, const typename W::Raw* raw,
                          const float* codebook, int C, const float* scales, const int* indices,
                          float* y, int M, int K, int Nb, int R, int bk, int bn, int split,
                          cudaStream_t stream) {
  if (M < 1 || M > kMaxRows || Nb < 1 || R < 1 || bk < 16 || bk > kMaxBk || (bk & (bk - 1)) ||
      bn < kCols || bn % kCols || K % 8 || split < 1 || split > kMaxSplit ||
      (split & (split - 1)) || (Parts<W>::kTable > 0 && (C < 1 || C > Parts<W>::kTable))) {
    return cudaErrorInvalidValue;
  }
  const int chunk = cmin(bk, kChunkK);
  const int n_chunks = R * (bk / chunk);
  const int local = (n_chunks + split - 1) / split;
  if (local > kMaxLocal || split > n_chunks) return cudaErrorInvalidValue;
  DecodeParams p{codebook, scales, indices, y, C, M, Nb * bn, R, bk, bn, chunk, n_chunks,
                 split, local, cmin(local, kDecodeStages)};
  while (p.stages > 2 &&
         DecodeLayout<W>::bytes(p.stages, n_chunks, split, local) > kSmemMax)
    --p.stages;
  if (DecodeLayout<W>::bytes(p.stages, n_chunks, split, local) > kSmemMax)
    return cudaErrorInvalidValue;
  const uint64_t rows = static_cast<uint64_t>(Nb) * R * bk;
  const int tiles = Nb * (bn / kCols);
  switch (chunk / 16) {
    case 1: return launch_decode_t<W, 1>(x, K, raw, rows, p, tiles, stream);
    case 2: return launch_decode_t<W, 2>(x, K, raw, rows, p, tiles, stream);
    default: return launch_decode_t<W, 4>(x, K, raw, rows, p, tiles, stream);
  }
}

}  // namespace mma
}  // namespace
