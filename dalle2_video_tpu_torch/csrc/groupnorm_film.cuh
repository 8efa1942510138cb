// The shared machinery of the GroupNorm -> FiLM -> SiLU kernels (forward,
// csrc/groupnorm_film.cu; backward, csrc/groupnorm_film_bwd.cu).
//
// Both are memory-bound passes over (B, L, C) tensors that need every
// value of a batch row's group before they can write anything, so each is
// ONE cooperative launch of kGridBlocks blocks (one per H100 SM), the grid
// split into B rows of blocks_per_row blocks, each block owning a
// contiguous slice of positions of its batch row:
//   phase 1 streams the block's slice through a ring of shared-memory
//           stages filled by TMA bulk copies (cp.async.bulk, one thread
//           issues, an mbarrier per stage counts the bytes) and sums it;
//   grid.sync(), then each batch row's block sums are folded in a fixed
//           order, every lane's loads in flight at once (the backward: a
//           second grid.sync() after its fold);
//   phase 2 walks the slice in reverse: the last `stages` tiles of phase
//           1 are still in shared memory (the whole slice when it fits:
//           x is then read from HBM once), the rest is read again, most
//           recently read first, so L2 still holds much of it.
// What lies between the phases is latency the whole card waits for, so
// everything that does not need the sums (the FiLM coefficients) is loaded
// before phase 1, and each fold is one round trip to L2.
// The grid and the ring are fixed by the shape alone (the wrapper's plan,
// ops/groupnorm_film.py: every batch row at once on blocks_per_row =
// kGridBlocks / B blocks; passes of rows only past kGridBlocks rows), so
// every sum is taken in one order and two calls agree bit for bit. The
// launch is cooperative: the entry points check that the card holds the
// whole grid at once and return cudaErrorCooperativeLaunchTooLarge
// otherwise (no block waits on another except through grid.sync() of a
// launch the runtime co-schedules).
//
// Thread t always sees channels c0 .. c0 + N - 1 with c0 = (t N) % C: a
// slice starts on a position, and kThreads N and kTileVecs N are multiples
// of C (C a power of two from the vector width up to kMaxC).
#pragma once

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace d2v {
namespace gn {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTileBytes = 16384;           // one stream's bytes per ring stage
constexpr int kTileVecs = kTileBytes / 16;  // 16-byte vectors: 2 per thread
constexpr int kGridBlocks = GN_GRID_BLOCKS;  // one block per H100 SM (the wrapper's GRID_BLOCKS)
constexpr int kMaxC = 1024;
constexpr int kMaxG = 32;
constexpr int kFoldLoads = (kGridBlocks + 31) / 32;  // a lane's share of a row's blocks
constexpr int kRedFloats = 8 * (kThreads + 1);      // block_channel_sums' scratch

template <typename T>
using Vec = Vec16<T>;

// one bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A block's slice of its batch row: positions [r0, r1), as 16-byte vectors
// v0 .. v0 + nv - 1 of the whole tensor, in n_tiles ring tiles.
struct Slice {
  size_t v0;
  int nv;
  int n_tiles;
};

__device__ __forceinline__ Slice slice_of(int b, int j, int k, int L, int C, int N) {
  const int per = (L + k - 1) / k;
  const int r0 = min(L, j * per);
  const int r1 = min(L, r0 + per);
  Slice s;
  s.v0 = (static_cast<size_t>(b) * L + r0) * (C / N);
  s.nv = (r1 - r0) * (C / N);
  s.n_tiles = (s.nv + kTileVecs - 1) / kTileVecs;
  return s;
}

// The ring: `stages` stages of NS streams (x; or x and g), one mbarrier a
// stage. Tile t of the slice lives in stage t % stages. Every thread keeps
// the parity of each stage's next phase in `parity` (bit s).
template <int NS>
struct Ring {
  char* buf;
  uint64_t* bars;
  int stages;
  uint32_t parity;

  __device__ __forceinline__ char* tile(int stage, int stream) const {
    return buf + (static_cast<size_t>(stage) * NS + stream) * kTileBytes;
  }
  // thread 0 only: bulk copies of tile t of each stream into its stage
  __device__ __forceinline__ void issue(int t, const Slice& s, const char* const* src) {
    const int stage = t % stages;
    const int n = min(kTileVecs, s.nv - t * kTileVecs);
    const uint32_t bytes = static_cast<uint32_t>(n) * 16u;
    mbar_expect_tx(&bars[stage], bytes * NS);
#pragma unroll
    for (int st = 0; st < NS; ++st)
      bulk_g2s(tile(stage, st), src[st] + (s.v0 + static_cast<size_t>(t) * kTileVecs) * 16,
               bytes, &bars[stage]);
  }
  __device__ __forceinline__ void wait(int t) {
    const int stage = t % stages;
    mbar_wait(&bars[stage], (parity >> stage) & 1u);
    parity ^= 1u << stage;
  }
};

// Phase 1: every tile of the slice, in order, through the ring (thread 0
// has issued the first min(stages, n_tiles) with start()); consume(t, n)
// sees tile t's n vectors. At the end the last min(stages, n_tiles) tiles
// are still in their stages.
template <int NS>
__device__ __forceinline__ void start(Ring<NS>& ring, const Slice& s, const char* const* src) {
  if (threadIdx.x == 0)
    for (int t = 0; t < min(ring.stages, s.n_tiles); ++t) ring.issue(t, s, src);
}
template <int NS, typename F>
__device__ __forceinline__ void stream_forward(Ring<NS>& ring, const Slice& s,
                                               const char* const* src, F consume) {
  const int n = s.n_tiles;
  for (int t = 0; t < n; ++t) {
    ring.wait(t);
    consume(t, min(kTileVecs, s.nv - t * kTileVecs));
    if (t + ring.stages < n) {
      __syncthreads();  // the stage is free
      if (threadIdx.x == 0) ring.issue(t + ring.stages, s, src);
    }
  }
}

// Phase 2: the tiles in reverse; the resident ones need no copy, the others
// are copied into the stage the previous tile of that stage freed.
template <int NS, typename F>
__device__ __forceinline__ void stream_reverse(Ring<NS>& ring, const Slice& s,
                                               const char* const* src, F consume) {
  const int n = s.n_tiles;
  for (int t = n - 1; t >= 0; --t) {
    if (t < n - ring.stages) ring.wait(t);
    consume(t, min(kTileVecs, s.nv - t * kTileVecs));
    if (t - ring.stages >= 0) {
      __syncthreads();
      if (threadIdx.x == 0) ring.issue(t - ring.stages, s, src);
    }
  }
}

__device__ __forceinline__ float2 warp_total2(float a, float b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  return make_float2(a, b);
}

// The sums over i < n <= kGridBlocks of p[i] and q[i], written by other
// blocks before a grid.sync(), over a warp: lane l loads i = l, l + 32, ...
// all at once (past L1; each load instruction reads contiguous words, so
// the blocks that read the same sums ask L2 for few sectors), adds them in
// that order, then a butterfly; every lane returns the same bits.
__device__ __forceinline__ float2 warp_sum2_blocks(const float* p, const float* q, int n) {
  const int lane = threadIdx.x & 31;
  float va[kFoldLoads], vb[kFoldLoads];
#pragma unroll
  for (int m = 0; m < kFoldLoads; ++m) {
    const int i = lane + 32 * m;
    va[m] = i < n ? __ldcg(p + i) : 0.f;
    vb[m] = i < n ? __ldcg(q + i) : 0.f;
  }
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int m = 0; m < kFoldLoads; ++m) {
    a += va[m];
    b += vb[m];
  }
  return warp_total2(a, b);
}

// The sums of p[i] and q[i], i < n, over a warp (shared memory): lane l
// adds i = l, l + 32, ... in order, then a butterfly.
__device__ __forceinline__ float2 warp_sum2_shared(const float* p, const float* q, int n) {
  const int lane = threadIdx.x & 31;
  float a = 0.f, b = 0.f;
  for (int i = lane; i < n; i += 32) {
    a += p[i];
    b += q[i];
  }
  return warp_total2(a, b);
}

// The block's per-channel totals of two sets of the threads' sums, v[N]
// and w[N] (thread t's element e is channel (t N + e) % C), into outv[c],
// outw[c], c < C: a butterfly over the lanes that share channels (period
// C / N apart), then a pairwise tree over each channel's distinct sums --
// one per warp, or per lane period where that exceeds a warp -- kept
// e-major in red (kRedFloats: rows of kThreads + 1) so that no two lanes of
// a store share a bank and few of a load do.
template <int N>
__device__ __forceinline__ void block_channel_sums(float (&v)[N], float (&w)[N], float* red,
                                                   float* outv, float* outw, int C) {
  static_assert(kWarps == 16, "the tree below folds 16 sums");
  const int period = C / N;
  for (int off = period; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      v[e] += __shfl_xor_sync(0xffffffffu, v[e], off);
      w[e] += __shfl_xor_sync(0xffffffffu, w[e], off);
    }
  }
  // channel c = t0 N + e sits at threads t0 + m * step_t, m < terms
  const int step_t = max(period, 32);
  const int terms = kThreads / step_t;  // a power of two, at most 16
  for (int round = 0; round < 2; ++round) {
    float* out = round == 0 ? outv : outw;
#pragma unroll
    for (int e = 0; e < N; ++e) red[e * (kThreads + 1) + threadIdx.x] = round == 0 ? v[e] : w[e];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float* r = red + (c % N) * (kThreads + 1) + c / N;
      float a[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) a[m] = m < terms ? r[m * step_t] : 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) a[m] += a[m + 8];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] += a[m + 4];
#pragma unroll
      for (int m = 0; m < 2; ++m) a[m] += a[m + 2];
      out[c] = a[0] + a[1];
    }
    __syncthreads();
  }
}

// Checks and launches a cooperative kernel with `smem` bytes of dynamic
// shared memory on a (blocks_per_row, rows) grid. The shared-memory
// attribute and the number of blocks the card holds at once are set and
// read once per kernel and device.
constexpr int kMaxDevices = 64;
template <typename K>
cudaError_t launch_cooperative(K kernel, int blocks_per_row, int rows, size_t smem, void** args,
                               cudaStream_t stream) {
  static std::atomic<int> resident[kMaxDevices];  // 0: not read yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int capacity = resident[dev].load();
  if (capacity == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    capacity = per_sm * sms;
    if (capacity == 0) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev].store(capacity);
  }
  if (capacity < blocks_per_row * rows) return cudaErrorCooperativeLaunchTooLarge;
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks_per_row, rows), dim3(kThreads), args, smem,
                                     stream);
}

// The widths the kernels take: C a power of two, a multiple of the vector
// width and of G, dividing kThreads N, at most kMaxC; G divides kThreads.
// The grid: rows_per_pass divides B, at most kGridBlocks blocks.
inline bool shape_ok(int B, int C, int G, int blocks_per_row, int rows_per_pass, int vec) {
  if (B <= 0 || rows_per_pass <= 0 || B % rows_per_pass != 0 || blocks_per_row <= 0 ||
      blocks_per_row * rows_per_pass > kGridBlocks)
    return false;
  if (G <= 0 || G > kMaxG || kThreads % G != 0 || C % G != 0 || C > kMaxC) return false;
  return C % vec == 0 && (kThreads * vec) % C == 0;
}

}  // namespace gn
}  // namespace d2v
