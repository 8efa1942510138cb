// Tiny-context cross-attention forward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/cross_attention.py::
// fused_cross_attention (body _kernel), reached through cross_attention.
//
// Computes, per (batch, head), out = softmax(q k^T * scale) v where the
// context holds only m keys (2 time tokens + 4 video tokens + the learned
// null kv = 7 in the base unet, 3 in the SR unet). q and out are
// (b, n, h, d), k and v (b, m, h, d) -- the layout CrossAttention produces,
// so no transpose is needed around the call. bf16 or f32; d = 64 (the
// CrossAttention default) or 32; m <= kMaxM.
//
// The function is _kernel's, step by step: the logits in f32 from the
// product, times scale in f32 (after the product, not folded into q),
// jax.nn.softmax in f32 (exp(s - max), then divided by the sum), p rounded
// to v's dtype, p v accumulated in f32, the output rounded once. In f32 the
// rounding of p changes nothing.
//
// What bounds it on the H100: memory. Each (token, head) row reads a
// d-vector of q and writes a d-vector of out against ~4*m*d flops, so the
// kernel should run at the rate the card moves q and out; k and v are tiny.
//
// bf16 design (mma.sync m16n8k16, bf16 in, f32 accumulate):
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
// f32 inputs take a CUDA-core kernel (kLanes = d / 8 threads per (token,
// head) row, the context staged in shared memory as f32), the same order.

#include "common.cuh"

namespace {

constexpr int kMaxM = 16;

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

// A block stages its batch row's whole context (m x h x d keys and values)
// in shared memory, then walks many row tiles (grid-stride). Each lane
// forms its 8-channel partial dot product with every key; a butterfly of
// warp shuffles completes the m logits in every lane.
template <int D>
__global__ void __launch_bounds__(kThreads)
cross_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int n,
                           int h, int m, float scale) {
  constexpr int kLanes = D / kVec;  // threads per row (8 at d = 64)
  constexpr int kRowsPerBlock = kThreads / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;  // (m, h, D)
  float* vs = smem + m * h * D;

  const int b = blockIdx.y;
  const size_t ctx = static_cast<size_t>(b) * m * h * D;
  for (int i = threadIdx.x; i < m * h * D; i += kThreads) {
    ks[i] = k[ctx + i];
    vs[i] = v[ctx + i];
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int c0 = lane * kVec;
  const long rows = static_cast<long>(n) * h;
  const size_t batch_off = static_cast<size_t>(b) * rows * D;
  // the loop bound is uniform across the block, so every lane of a warp
  // takes part in every shuffle; rows past the end compute on zeros and
  // store nothing
  for (long tile = static_cast<long>(blockIdx.x) * kRowsPerBlock; tile < rows;
       tile += static_cast<long>(gridDim.x) * kRowsPerBlock) {
    const long row = tile + threadIdx.x / kLanes;
    const bool valid = row < rows;
    const int head = static_cast<int>(row % h);
    const size_t base = batch_off + static_cast<size_t>(row) * D + c0;
    float qr[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) load8(q + base, qr);

    float s[kMaxM];
    float smax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        const float* kr = ks + (j * h + head) * D + c0;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) dot = fmaf(qr[c], kr[c], dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off, kLanes);
        s[j] = dot * scale;
        smax = fmaxf(smax, s[j]);
      }
    }
    // jax.nn.softmax's order: exp(s - max), the sum, each p = e / sum;
    // then p v
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        s[j] = expf(s[j] - smax);
        l += s[j];
      }
    }
    float acc[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        const float p = s[j] / l;
        const float* vr = vs + (j * h + head) * D + c0;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
    }
    if (valid) store8(o + base, acc);
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int b, int n,
                       int h, int m, float scale, cudaStream_t stream) {
  const size_t smem = 2ull * m * h * D * sizeof(float);
  auto kernel = cross_attention_f32_kernel<D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kRowsPerBlock = kThreads / (D / kVec);
  const long rows = static_cast<long>(n) * h;
  long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long cap = (8L * 132 + b - 1) / b;  // ~8 resident blocks per SM in all
  if (blocks > cap) blocks = cap;
  dim3 grid(static_cast<unsigned>(blocks), b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, h, m, scale);
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

template <int D>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int b, int n,
                          int h, int m, float scale, cudaStream_t stream) {
  if (m <= 8) return launch_bf16<D, 1>(q, k, v, o, b, n, h, m, scale, stream);
  return launch_bf16<D, 2>(q, k, v, o, b, n, h, m, scale, stream);
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q, o (b, n, h, d); k, v (b, m, h, d).
extern "C" int d2v_cross_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int b, int n,
                                       int h, int m, int d, int dtype,
                                       float sm_scale, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || m <= 0 || m > kMaxM || (d != 32 && d != 64))
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
