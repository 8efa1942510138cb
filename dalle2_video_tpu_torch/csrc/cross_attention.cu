// Cross-attention forward over a short context, for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/cross_attention.py::
// fused_cross_attention (body _kernel), reached through cross_attention.
//
// Computes, per (batch, head), out = softmax(q k^T * scale) v over a
// context of m keys: the learned null kv, 2 time tokens and 4 video tokens
// (m = 7 in the base unet, 3 in the SR unet), plus one token per frame
// embed (per-frame video embeds: 90 frames, m = 93) and, at the unets' two
// middle blocks, max_text_len text tokens (m = 263 / 259 at 256, 349 with
// per-frame embeds). q and out are (b, n, h, d), k and v (b, m, h, d) --
// the layout CrossAttention produces, so no transpose is needed around the
// call. bf16 or f32; d = 64 (the CrossAttention default) or 32; any m >= 1,
// as the TPU kernel, which holds the whole context in VMEM.
//
// The function is _kernel's, step by step: the logits in f32 from the
// product, times scale in f32 (after the product, not folded into q),
// jax.nn.softmax in f32 over all m keys (exp(s - max), then divided by the
// sum), p rounded to v's dtype, p v accumulated in f32, the output rounded
// once. In f32 the rounding of p changes nothing.
//
// What bounds it on the H100: memory for a short context (each (token,
// head) row reads a d-vector of q and writes a d-vector of out against
// ~4*m*d flops; k and v are tiny); at m in the hundreds the products and
// the m exponentials a row come level with the bytes.
//
// bf16, m <= kMaxM (the serving shapes without text or per-frame tokens;
// mma.sync m16n8k16, bf16 in, f32 accumulate):
//   * work items are (batch, 32-token tile, head); each warp walks its own
//     items (persistent blocks, one per SM, 8 warps each) and owns a ring
//     of kStages q boxes in shared memory. Its lane 0 keeps TMA loads of
//     the next boxes in flight (a 4-D map of q, box = one head's 32 rows,
//     swizzled at the row width: one head's rows lie h*d*2 = 1 KB apart in
//     memory, and unswizzled every ldmatrix of them would be an 8-way bank
//     conflict);
//   * a warp keeps the K^T fragments (d/16 k-steps x ceil(m/8) n8 tiles)
//     and V fragments (keys zero-padded to 16, d/8 n8 tiles) of its
//     current (batch, head) in registers, loaded again only when it moves
//     to another;
//   * per 16-row tile: ldmatrix of q, S = Q K^T, keys >= m set to -inf,
//     the row max and sum over the quad's 4 lanes, p = e / sum rounded to
//     bf16 and repacked in registers as the A fragment of P V;
//   * the output goes into one of two swizzled out boxes in shared memory,
//     which a TMA store writes back (rows past n are clipped), so no global
//     store is issued by the math lanes.
// bf16, m > kMaxM (the keys no longer fit in a warp's registers): a block
// owns one (batch, head) and a run of its 32-token items. It stages K
// (key-major) and V^T (channel-major, so a B fragment of P V is one 32-bit
// load) of up to kChunkKeys keys in shared memory, rows padded by 8 so the
// fragment loads are free of bank conflicts, and each warp takes one item
// at a time: q's A fragments straight from global memory, then three
// sweeps over the 16-key tiles -- the row max, the sum of exp(s - max),
// and p = exp(s - max) * (1 / sum) (within an f32 rounding of the
// quotient) rounded to bf16 into P V. S is recomputed in each sweep
// because an online softmax would round p against a running max and sum,
// not the final ones, and so round a different p than the JAX kernel. A
// longer context is walked in chunks, staged again in each sweep, the
// block's warps in step. Two blocks an SM (16 warps, 128 registers a
// thread), the tile loop unrolled by two, for latency the warps can hide.
// f32 takes the CUDA cores: kLanes = d / 8 threads per (token, head) row,
// one (batch, head) per block, k and v read through the L1 cache, three
// sweeps as above (the logits recomputed) with p = exp(s - max) / sum.

#include "common.cuh"

namespace {

constexpr int kMaxM = 16;  // keys the bf16 short route holds in a warp's registers

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kThreads = 256;
constexpr int kVec = 8;  // channels per lane

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// One (batch, head) per block (a 1-D grid: per_bh blocks for each), its
// tokens in runs of kRowsPerBlock rows. Each lane forms its 8-channel
// partial dot product with a key; a butterfly of shuffles completes the
// logit in every lane of the row. k and v are read straight from memory:
// one head's context is a few hundred KB at most, so it stays in L1 / L2.
template <int D>
__global__ void __launch_bounds__(kThreads)
cross_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int n,
                           int h, int m, float scale, int per_bh, int tokens_per_block) {
  constexpr int kLanes = D / kVec;  // threads per row (8 at d = 64)
  constexpr int kRowsPerBlock = kThreads / kLanes;
  const int bh = blockIdx.x / per_bh;
  const int batch = bh / h, head = bh % h;
  const int t0 = (blockIdx.x % per_bh) * tokens_per_block;
  const int t1 = min(n, t0 + tokens_per_block);
  const int lane = threadIdx.x % kLanes;
  const int c0 = lane * kVec;
  const size_t key_stride = static_cast<size_t>(h) * D;
  const float* kb = k + (static_cast<size_t>(batch) * m * h + head) * D + c0;
  const float* vb = v + (static_cast<size_t>(batch) * m * h + head) * D + c0;
  // the loop bound is uniform across the block, so every lane of a warp
  // takes part in every shuffle; rows past the end compute on zeros and
  // store nothing
  for (int base = t0; base < t1; base += kRowsPerBlock) {
    const int tok = base + threadIdx.x / kLanes;
    const bool valid = tok < t1;
    const size_t at = ((static_cast<size_t>(batch) * n + tok) * h + head) * D + c0;
    float qr[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) load8(q + at, qr);
    auto logit = [&](int j) {
      float kr[kVec];
      load8(kb + j * key_stride, kr);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kVec; ++c) dot = fmaf(qr[c], kr[c], dot);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off, kLanes);
      return dot * scale;
    };
    // jax.nn.softmax's order: the max, the sum of exp(s - max), each
    // p = exp(s - max) / sum; then p v
    float smax = -INFINITY;
    for (int j = 0; j < m; ++j) smax = fmaxf(smax, logit(j));
    float l = 0.f;
    for (int j = 0; j < m; ++j) l += expf(logit(j) - smax);
    float acc[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < m; ++j) {
      const float p = expf(logit(j) - smax) / l;
      float vr[kVec];
      load8(vb + j * key_stride, vr);
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
    }
    if (valid) store8(o + at, acc);
  }
}

// blocks per (batch, head) for about `want` blocks in all, each a run of
// `unit`-token multiples; returns the tokens per block
inline int split_tokens(int n, int bh, int unit, long want, int* per_bh) {
  const long units = (n + unit - 1) / unit;
  long per = (want + bh - 1) / bh;
  if (per > units) per = units;
  if (per < 1) per = 1;
  const long units_per_block = (units + per - 1) / per;
  *per_bh = static_cast<int>((units + units_per_block - 1) / units_per_block);
  return static_cast<int>(units_per_block * unit);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int n,
                       int h, int m, float scale, cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / (D / kVec);
  int per_bh = 1;
  const int tokens = split_tokens(n, b * h, kRowsPerBlock, 8L * 132, &per_bh);
  const long blocks = static_cast<long>(b) * h * per_bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  cross_attention_f32_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, h, m, scale, per_bh, tokens);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 / mma
constexpr int kWarps = 8;
constexpr int kTokens = 32;  // tokens per work item: one head's box
constexpr int kStages = 4;   // q boxes per warp
constexpr int kOutBufs = 2;  // out boxes per warp
constexpr int kMaxDevices = 64;

using d2v::mma_bf16;
using d2v::pack_bf16;

template <int D>
struct Box {
  static constexpr int kRowBytes = 2 * D;  // one (token, head) row
  static constexpr int kBytes = kTokens * kRowBytes;
  // TMA's swizzle at the row width: 16-byte chunk c of byte offset o moves
  // to c ^ ((o >> 7) & kMask) (128B: 8 chunks, 64B: 4)
  static constexpr int kMask = D == 64 ? 7 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr int kWarpBytes = (kStages + kOutBufs) * kBytes;
  static constexpr int kSmem = 1024 + kWarps * (kWarpBytes + kStages * 8);
};

// byte offset of (row, 16-byte chunk) in a swizzled box
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  const uint32_t o = row * Box<D>::kRowBytes + chunk * 16;
  return o ^ (((o >> 7) & Box<D>::kMask) << 4);
}

// the box of a (b, n, h, D) tensor at (column 0, head, token, batch)
__device__ __forceinline__ void tma_load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                             int head, int tok, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(d2v::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(d2v::smem_u32(bar)), "r"(0), "r"(head), "r"(tok), "r"(batch) : "memory");
}
__device__ __forceinline__ void tma_store_box(const CUtensorMap* map, const void* src, int head,
                                              int tok, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(d2v::smem_u32(src)),
        "r"(0), "r"(head), "r"(tok), "r"(batch) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's stores still read shared memory
template <int n>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(n) : "memory");
}
__device__ __forceinline__ void store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct Params {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int h, m, tiles;  // tiles: 32-token tiles per batch row
  long items;       // b x tiles x h
  float scale;
};

// NT: n8 key tiles, 1 for m <= 8, 2 for m <= 16
template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32, 1)
cross_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using B = Box<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (d2v::smem_u32(smem_raw) & 1023)) & 1023);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* boxes = smem + warp * B::kWarpBytes;  // kStages q boxes, then the out boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWarps * B::kWarpBytes) + warp * kStages;

  // this warp's items: first, first + stride, ... (head fastest, so with
  // h dividing the warps in flight a warp stays on one head)
  const long stride = static_cast<long>(gridDim.x) * kWarps;
  const long first = static_cast<long>(blockIdx.x) * kWarps + warp;
  const int mine = first < p.items ? static_cast<int>((p.items - 1 - first) / stride + 1) : 0;
  auto where = [&](int j, int& head, int& tok, int& batch) {
    const long item = first + j * stride;
    head = static_cast<int>(item % p.h);
    const long r = item / p.h;
    tok = static_cast<int>(r % p.tiles) * kTokens;
    batch = static_cast<int>(r / p.tiles);
  };
  auto issue = [&](int j) {  // lane 0: item j's q box into its ring slot
    int head, tok, batch;
    where(j, head, tok, batch);
    uint64_t* bar = &full[j % kStages];
    d2v::mbar_expect_tx(bar, B::kBytes);
    tma_load_box(boxes + (j % kStages) * B::kBytes, &tm_q, bar, head, tok, batch);
  };
  if (lane == 0) {
    for (int s = 0; s < kStages; ++s) d2v::mbar_init(&full[s], 1);
    d2v::mbar_init_fence();
    for (int j = 0; j < kStages && j < mine; ++j) issue(j);
  }
  __syncwarp();

  const uint16_t* kraw = reinterpret_cast<const uint16_t*>(p.k);
  const uint16_t* vraw = reinterpret_cast<const uint16_t*>(p.v);
  uint32_t kb[NT][D / 16][2];  // K^T: (k = channels 2t.., 2t + 8..; n = key g)
  uint32_t vb[D / 8][2];       // V: (k = keys 2t.., 2t + 8..; n = channel g)
  int cur = -1;                // the (batch, head) of the fragments held

  for (int j = 0; j < mine; ++j) {
    int head, tok, batch;
    where(j, head, tok, batch);
    const int ctx = batch * p.h + head;
    if (ctx != cur) {
      cur = ctx;
      // element (key, channel) of this (batch, head)'s context, 0 past m
      auto at = [&](const uint16_t* base, int key, int c) -> uint32_t {
        if (key >= p.m) return 0u;
        return base[((static_cast<size_t>(batch) * p.m + key) * p.h + head) * D + c];
      };
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c = kk * 16 + 2 * t + 8 * hf;
            kb[nt][kk][hf] = at(kraw, 8 * nt + g, c) | (at(kraw, 8 * nt + g, c + 1) << 16);
          }
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int key = 2 * t + 8 * hf;
          vb[jn][hf] = at(vraw, key, 8 * jn + g) | (at(vraw, key + 1, 8 * jn + g) << 16);
        }
    }

    const int slot = j % kStages;
    d2v::mbar_wait(&full[slot], (j / kStages) & 1);
    const uint8_t* qbox = boxes + slot * B::kBytes;
    uint8_t* obox = boxes + (kStages + j % kOutBufs) * B::kBytes;
    if (lane == 0) store_wait_read<kOutBufs - 1>();  // item j - 2's store has read obox
    __syncwarp();

#pragma unroll
    for (int rt = 0; rt < kTokens / 16; ++rt) {
      // the A fragments of rows 16 rt .. 16 rt + 15: lane l gives row
      // (l & 7) + 8 ((l >> 3) & 1), chunk 2 kk + (l >> 4)
      uint32_t qa[D / 16][4];
      const int arow = 16 * rt + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        d2v::ldsm_x4(qa[kk], qbox + swz<D>(arow, 2 * kk + (lane >> 4)));

      // S = Q K^T, then * scale in f32; keys past m -> -inf
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) mma_bf16(s[nt], qa[kk], kb[nt][kk][0], kb[nt][kk][1]);
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;  // rows g, g + 8
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * nt + 2 * t + (e & 1);
          s[nt][e] = key < p.m ? s[nt][e] * p.scale : -INFINITY;
          if (e < 2) mx0 = fmaxf(mx0, s[nt][e]);
          else mx1 = fmaxf(mx1, s[nt][e]);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // jax.nn.softmax: e = exp(s - max) (0 past m), p = e / sum(e)
      float l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = expf(s[nt][e] - (e < 2 ? mx0 : mx1));
          if (e < 2) l0 += s[nt][e];
          else l1 += s[nt][e];
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      // p rounded to bf16: the A fragment of P V (keys 8..15 zero when NT = 1)
      uint32_t pa[4];
      pa[0] = pack_bf16(s[0][0] / l0, s[0][1] / l0);
      pa[1] = pack_bf16(s[0][2] / l1, s[0][3] / l1);
      pa[2] = NT > 1 ? pack_bf16(s[NT - 1][0] / l0, s[NT - 1][1] / l0) : 0u;
      pa[3] = NT > 1 ? pack_bf16(s[NT - 1][2] / l1, s[NT - 1][3] / l1) : 0u;

      // O = P V in f32, rounded once, into the out box
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(acc, pa, vb[jn][0], vb[jn][1]);
        const int row = 16 * rt + g;
        *reinterpret_cast<uint32_t*>(obox + (swz<D>(row, jn) + 4 * t)) = pack_bf16(acc[0], acc[1]);
        *reinterpret_cast<uint32_t*>(obox + (swz<D>(row + 8, jn) + 4 * t)) =
            pack_bf16(acc[2], acc[3]);
      }
    }

    // the out box to global memory, and the q slot (every lane's ldmatrix
    // of it done: their results were used) refilled
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      tma_store_box(&tm_o, obox, head, tok, batch);
      if (j + kStages < mine) issue(j + kStages);
    }
  }
  if (lane == 0) store_wait_all();
}

// A 4-D map of a (b, n, h, D) bf16 tensor, box (D, 1 head, kTokens, 1),
// swizzled at the row width; tokens past n read as zero, and are not
// written.
template <int D>
cudaError_t encode_box_map(CUtensorMap* map, const void* base, int b, int n, int h) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = d2v::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(b)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * h, row * h * n};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, kTokens, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Box<D>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

template <int D, int NT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int b, int n,
                        int h, int m, float scale, cudaStream_t stream) {
  CUtensorMap tq, to;
  cudaError_t err = encode_box_map<D>(&tq, q, b, n, h);
  if (err == cudaSuccess) err = encode_box_map<D>(&to, o, b, n, h);
  if (err != cudaSuccess) return err;
  Params p;
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.h = h;
  p.m = m;
  p.tiles = (n + kTokens - 1) / kTokens;
  p.items = static_cast<long>(b) * p.tiles * h;
  p.scale = scale;
  auto* kern = cross_attention_bf16_kernel<D, NT>;
  // the shared-memory attribute once per instance and device, not per call
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Box<D>::kSmem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  // persistent: one block per SM (a whole wave), fewer when there are
  // fewer items than warps
  const long want = (p.items + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(want < sm_count() ? want : sm_count());
  kern<<<blocks, kWarps * 32, Box<D>::kSmem, stream>>>(tq, to, p);
  return cudaGetLastError();
}

// ------------------------------------------------ bf16 / mma, m > kMaxM
constexpr int kChunkKeys = 512;  // keys staged at once (a multiple of 16)
constexpr int kItemRows = 32;    // tokens per warp item: two 16-row mma tiles

struct WideParams {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* o;
  int n, h, m;
  int chunk;       // keys staged at once: min(m rounded up to 16, kChunkKeys)
  int items;       // 32-token items of one (batch, head)
  int per_bh;      // blocks per (batch, head)
  int per_block;   // items per block
  float scale;
};

// shared memory: K (chunk, D + 8) and V^T (D, chunk + 8), bf16
template <int D>
constexpr size_t wide_smem(int chunk) {
  return 2ull * (static_cast<size_t>(chunk) * (D + 8) + static_cast<size_t>(D) * (chunk + 8));
}

// two blocks an SM: 16 warps to hide the latency of each warp's chains
// (the registers held to 128 a thread)
template <int D>
__global__ void __launch_bounds__(kWarps * 32, 2)
cross_attention_wide_kernel(const WideParams p) {
  constexpr int kKs = D + 8;  // K row stride (elements): 4g + t distinct banks
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* vt = ks + static_cast<size_t>(p.chunk) * kKs;
  const int vs = p.chunk + 8;  // V^T row stride: chunk / 2 + 4 words, also distinct banks
  const int bh = blockIdx.x / p.per_bh;
  const int batch = bh / p.h, head = bh % p.h;
  const int first = (blockIdx.x % p.per_bh) * p.per_block;
  const int last = min(first + p.per_block, p.items);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nchunks = (p.m + p.chunk - 1) / p.chunk;
  const size_t key_stride = static_cast<size_t>(p.h) * D;
  const size_t ctx = (static_cast<size_t>(batch) * p.m * p.h + head) * D;

  // keys [c * chunk, (c + 1) * chunk) of this (batch, head) into shared
  // memory, zeros past m; a thread moves 8 channels of one key, the warp
  // 32 consecutive keys (so the transposed V stores are conflict-free)
  auto stage = [&](int c) {
    const int key0 = c * p.chunk;
    for (int i = threadIdx.x; i < p.chunk * (D / 8); i += blockDim.x) {
      const int j = i % p.chunk, cg = i / p.chunk;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key0 + j < p.m) {
        const size_t off = ctx + (key0 + j) * key_stride + cg * 8;
        kv = __ldg(reinterpret_cast<const uint4*>(p.k + off));
        vv = __ldg(reinterpret_cast<const uint4*>(p.v + off));
      }
      *reinterpret_cast<uint4*>(ks + j * kKs + cg * 8) = kv;
      const uint16_t* ve = reinterpret_cast<const uint16_t*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(cg * 8 + e) * vs + j] = ve[e];
    }
  };
  // S = Q K^T * scale for the 16 keys at kt of the staged chunk c, keys
  // past m at -inf: s[r][nt][e] is row 16 r + g (e < 2) or + 8, key
  // kt + 8 nt + 2 t + (e & 1)
  auto logits = [&](const uint32_t (&qa)[2][D / 16][4], int c, int kt, float (&s)[2][2][4]) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) s[r][nt][0] = s[r][nt][1] = s[r][nt][2] = s[r][nt][3] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint16_t* krow = ks + (kt + 8 * nt + g) * kKs + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
#pragma unroll
        for (int r = 0; r < 2; ++r) mma_bf16(s[r][nt], qa[r][kk], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = c * p.chunk + kt + 8 * nt + 2 * t + (e & 1) < p.m;
#pragma unroll
        for (int r = 0; r < 2; ++r) s[r][nt][e] = in ? s[r][nt][e] * p.scale : -INFINITY;
      }
  };
  // sweep over every 16-key tile of the context, chunk by chunk (staged
  // again only when there is more than one), calling f(c, kt)
  auto sweep = [&](auto&& f) {
    for (int c = 0; c < nchunks; ++c) {
      if (nchunks > 1) {
        __syncthreads();  // every warp is done with the previous chunk
        stage(c);
        __syncthreads();
      }
      const int keys = min(p.chunk, p.m - c * p.chunk);
#pragma unroll 2
      for (int kt = 0; kt < keys; kt += 16) f(c, kt);
    }
  };

  if (nchunks == 1) {
    stage(0);
    __syncthreads();
  }
  // the item loop's bound is uniform across the block, so every warp
  // reaches every __syncthreads of a chunked sweep; items past the end
  // compute on zeros and store nothing
  for (int base = first; base < last; base += kWarps) {
    const int item = base + warp;
    const bool valid = item < last;
    const int tok0 = item * kItemRows;
    // q's A fragments: row (16 r + g) or + 8, channels kk*16 + 2t (+ 8)
    uint32_t qa[2][D / 16][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tok = tok0 + 16 * r + g + 8 * hf;
        const bool in = valid && tok < p.n;
        const uint16_t* qrow =
            p.q + ((static_cast<size_t>(batch) * p.n + tok) * p.h + head) * D + 2 * t;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          qa[r][kk][hf] = in ? __ldg(reinterpret_cast<const unsigned int*>(qrow + kk * 16)) : 0u;
          qa[r][kk][2 + hf] =
              in ? __ldg(reinterpret_cast<const unsigned int*>(qrow + kk * 16 + 8)) : 0u;
        }
      }

    // the row max (rows g, g + 8 of each 16-row tile), over the quad
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
    sweep([&](int c, int kt) {
      float s[2][2][4];
      logits(qa, c, kt, s);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[r][e >> 1] = fmaxf(mx[r][e >> 1], s[r][nt][e]);
    });
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          mx[r][hf] = fmaxf(mx[r][hf], __shfl_xor_sync(0xffffffffu, mx[r][hf], off));

    // the sum of exp(s - max)
    float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    sweep([&](int c, int kt) {
      float s[2][2][4];
      logits(qa, c, kt, s);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) l[r][e >> 1] += expf(s[r][nt][e] - mx[r][e >> 1]);
    });
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[r][hf] += __shfl_xor_sync(0xffffffffu, l[r][hf], off);
    // p = e * (1 / sum): within an f32 rounding of e / sum, far inside
    // the window the bf16 hold gives a probability's rounding
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[r][hf] = 1.f / l[r][hf];

    // p = exp(s - max) / sum rounded to bf16 (the A fragment of P V), and
    // O = P V in f32 (l holds 1 / sum now)
    float acc[2][D / 8][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][jn][e] = 0.f;
    sweep([&](int c, int kt) {
      float s[2][2][4];
      logits(qa, c, kt, s);
      uint32_t pa[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        auto prob = [&](int nt, int e) { return expf(s[r][nt][e] - mx[r][e >> 1]) * l[r][e >> 1]; };
        pa[r][0] = pack_bf16(prob(0, 0), prob(0, 1));
        pa[r][1] = pack_bf16(prob(0, 2), prob(0, 3));
        pa[r][2] = pack_bf16(prob(1, 0), prob(1, 1));
        pa[r][3] = pack_bf16(prob(1, 2), prob(1, 3));
      }
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn) {
        const uint16_t* vrow = vt + (jn * 8 + g) * vs + kt + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
#pragma unroll
        for (int r = 0; r < 2; ++r) mma_bf16(acc[r][jn], pa[r], b0, b1);
      }
    });

    // the output, rounded once
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int tok = tok0 + 16 * r + g + 8 * hf;
        if (!valid || tok >= p.n) continue;
        uint16_t* orow = p.o + ((static_cast<size_t>(batch) * p.n + tok) * p.h + head) * D + 2 * t;
#pragma unroll
        for (int jn = 0; jn < D / 8; ++jn)
          *reinterpret_cast<uint32_t*>(orow + jn * 8) =
              pack_bf16(acc[r][jn][2 * hf], acc[r][jn][2 * hf + 1]);
      }
  }
}

template <int D>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o, int b, int n,
                        int h, int m, float scale, cudaStream_t stream) {
  WideParams p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.o = static_cast<uint16_t*>(o);
  p.n = n;
  p.h = h;
  p.m = m;
  p.chunk = min((m + 15) / 16 * 16, kChunkKeys);
  p.items = (n + kItemRows - 1) / kItemRows;
  p.scale = scale;
  // about two blocks per SM in all (each stages its head's context once
  // when it fits one chunk), every block a run of whole items
  p.per_block = split_tokens(p.items, b * h, 1, 2L * sm_count(), &p.per_bh);
  const long blocks = static_cast<long>(b) * h * p.per_bh;
  if (blocks > 0x7fffffffL) return cudaErrorInvalidValue;
  auto* kern = cross_attention_wide_kernel<D>;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(wide_smem<D>(kChunkKeys)));
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, wide_smem<D>(p.chunk), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int b, int n,
                          int h, int m, float scale, cudaStream_t stream) {
  if (m <= 8) return launch_bf16<D, 1>(q, k, v, o, b, n, h, m, scale, stream);
  if (m <= kMaxM) return launch_bf16<D, 2>(q, k, v, o, b, n, h, m, scale, stream);
  return launch_wide<D>(q, k, v, o, b, n, h, m, scale, stream);
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q, o (b, n, h, d); k, v (b, m, h, d).
extern "C" int d2v_cross_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int b, int n,
                                       int h, int m, int d, int dtype,
                                       float sm_scale, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || m <= 0 || (d != 32 && d != 64))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16)
    return d == 64 ? dispatch_bf16<64>(q, k, v, o, b, n, h, m, sm_scale, s)
                   : dispatch_bf16<32>(q, k, v, o, b, n, h, m, sm_scale, s);
  if (dtype == d2v::kFloat32)
    return d == 64 ? launch_f32<64>(q, k, v, o, b, n, h, m, sm_scale, s)
                   : launch_f32<32>(q, k, v, o, b, n, h, m, sm_scale, s);
  return cudaErrorInvalidValue;
}
