// Flash multi-query attention backward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/flash_mqa.py::_bwd_pallas (bodies
// _mqa_bwd_dq_kernel and _mqa_bwd_dkv_kernel), reached through the
// custom_vjp of flash_mqa, and at batch 1 that custom_vjp's
// _bwd_xla_scan (XLA on the TPU).
//
// Inputs: q (b, n_q, d) with the query heads folded into the rows; the
// shared k, v (b, n_kv, d); g = dL/dout (b, n_q, d); the forward's
// natural-log row logsumexp lse (b, n_q) and delta = rowsum(g * out)
// (b, n_q), both f32. Computes, recomputing P from the saved lse instead
// of storing it,
//   P = exp(s - lse),  s = qs k^T,  qs = scale * q,  dP = g v^T,
//   dS = P * (dP - delta),  dq = scale * dS k,  dk = dS^T qs,  dv = P^T g.
// Two routes, chosen by the wrapper as the JAX package's bwd_impl "auto"
// chooses (ops/flash_mqa.py::bwd_rounds):
//   * tensor cores (bf16, batch >= 2): _bwd_pallas's arithmetic -- the
//     wrapper hands in qs already rounded to bf16, and dS (for dq, dk) and
//     P (for dv) are rounded to bf16 before their products; every sum f32;
//   * CUDA cores (f32, or batch 1): all-f32 math. At batch 1 this is
//     _bwd_xla_scan's, which never reads out: a first pass of the dq
//     kernel computes delta = rowsum(P * dP) itself, in f32, into the
//     delta buffer the dk/dv pass reads (a bf16 out would put its rounding
//     into delta).
//
// What bounds it on the H100: arithmetic. At the training shape (b = 2,
// n_q = 92160, n_kv = 5761, d = 32) one call forms 1.06e9 probabilities and
// five (n_q x n_kv x d) products (3.4e11 FLOP): bound 0.34 ms on the tensor
// cores. Two passes, for determinism, recompute S and dP in the second:
// seven products and 2.1e9 exponentials, a floor of ~0.51 ms for the
// exponentials alone (16 per clock per SM).
//
// Tensor-core route (mma.sync m16n8k16, FlashAttention-2's backward
// layout), three launches:
//   1. dq: a block of 4 warps owns kRows query rows (32 a warp; 16 at
//      d = 64), their qs and g as A fragments in registers. It streams
//      64-key tiles of K and V through a two-stage cp.async ring in shared
//      memory (rows padded to d + 8 elements: conflict-free ldmatrix). Per
//      16-key chunk: S = qs K^T and dP = g V^T (B by plain ldmatrix of the
//      [key][d] tiles), P = exp2(S log2e - lse log2e), dS = P (dP - delta)
//      in f32; the accumulators repack in registers, rounded to bf16, as
//      the A fragment of dQ += dS K (B by ldmatrix.trans); scale at the end.
//   2. dk/dv: the mirror image. A block owns kRows keys of one batch row,
//      K and V as A fragments, and streams its query split's 64-row tiles
//      of qs, g, lse and delta: S^T = K qs^T, dP^T = V g^T, then dV +=
//      bf16(P^T) g and dK += bf16(dS^T) qs. f32 partials per query split;
//   3. the reduce pass sums them in a fixed order (no atomics: two calls
//      agree bit for bit). A fused single pass would need dq summed across
//      key blocks -- atomics, or ~2 GB of partials at the training shape.
// Both mask the ragged kv tail (n_kv = 5761 is never tile-aligned) in
// registers: a key past n_kv has its logit set to -inf before the
// exponential, so it never forms a p, and P stays exact when every logit is
// below -87. Query rows past n_q are zero-filled with lse = delta = 0, so
// their P is 1 and every product they enter is 0.
//
// CUDA-core route: dq one query row per thread over 64-key tiles staged in
// shared memory as f32; dk/dv one key per thread over staged query rows,
// the query range split across blocks into the same f32 partials and
// reduce pass. Right and simple; f32 and batch 1 are checks and small
// shapes, not the training path.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;   // dq: query rows per block, one per thread
constexpr int kTile = 64;    // dq: keys staged per pass
constexpr int kKeys = 128;   // dk/dv: keys per block, one per thread
constexpr int kQTile = 32;   // dk/dv: query rows staged per pass
constexpr int kTargetBlocks = 8 * 132;  // dk/dv blocks to aim for: ~8 per H100 SM

// kDelta: the pass that writes delta = rowsum(P * dP) of each query row
// (batch 1) instead of dq; the dq pass after it reads that delta.
template <typename T, int D, bool kDelta>
__global__ void __launch_bounds__(kRows)
flash_mqa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        float* __restrict__ delta, T* __restrict__ dq,
                        int n_q, int n_kv, float scale_log2, float sm_scale) {
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n_q;
  const size_t r = static_cast<size_t>(b) * n_q + (active ? row : 0);
  const T* kb = k + static_cast<size_t>(b) * n_kv * D;
  const T* vb = v + static_cast<size_t>(b) * n_kv * D;

  float qr[D], gr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = d2v::to_f(q[r * D + c]) * scale_log2;  // base-2 logits
    gr[c] = d2v::to_f(g[r * D + c]);
    acc[c] = 0.f;
  }
  const float lse2 = lse[r] * kLog2e;
  const float dd = kDelta ? 0.f : delta[r];
  float dsum = 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += kTile) {
    const int tile = min(kTile, n_kv - kv0);
    __syncthreads();
    const size_t off = static_cast<size_t>(kv0) * D;
    for (int i = threadIdx.x; i < tile * D; i += kRows) {
      ks[i] = d2v::to_f(kb[off + i]);
      vs[i] = d2v::to_f(vb[off + i]);
    }
    __syncthreads();

    for (int j = 0; j < tile; ++j) {  // the ragged tail ends the loop
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
      float kj[D];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 kk = kr[c4];
        const float4 vv = vr[c4];
        kj[4 * c4] = kk.x;
        kj[4 * c4 + 1] = kk.y;
        kj[4 * c4 + 2] = kk.z;
        kj[4 * c4 + 3] = kk.w;
        s = fmaf(qr[4 * c4], kk.x, s);
        s = fmaf(qr[4 * c4 + 1], kk.y, s);
        s = fmaf(qr[4 * c4 + 2], kk.z, s);
        s = fmaf(qr[4 * c4 + 3], kk.w, s);
        dp = fmaf(gr[4 * c4], vv.x, dp);
        dp = fmaf(gr[4 * c4 + 1], vv.y, dp);
        dp = fmaf(gr[4 * c4 + 2], vv.z, dp);
        dp = fmaf(gr[4 * c4 + 3], vv.w, dp);
      }
      const float p = exp2f(s - lse2);
      if constexpr (kDelta) {
        dsum = fmaf(p, dp, dsum);
      } else {
        const float ds = p * (dp - dd);
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, kj[c], acc[c]);
      }
    }
  }

  if (active) {
    if constexpr (kDelta) {
      delta[r] = dsum;
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) dq[r * D + c] = d2v::from_f<T>(acc[c] * sm_scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kKeys)
flash_mqa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ partial, int n_q, int n_kv,
                         int rows_per_split, float scale_log2,
                         float sm_scale) {
  __shared__ __align__(16) float qs[kQTile * D];
  __shared__ __align__(16) float gs[kQTile * D];
  __shared__ float ls[kQTile];
  __shared__ float dls[kQTile];

  const int b = blockIdx.z;
  const int split = blockIdx.y;
  const int key = blockIdx.x * kKeys + threadIdx.x;
  const bool active = key < n_kv;
  const size_t kr = static_cast<size_t>(b) * n_kv + (active ? key : 0);

  float kreg[D], vreg[D], dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    kreg[c] = d2v::to_f(k[kr * D + c]) * scale_log2;
    vreg[c] = d2v::to_f(v[kr * D + c]);
    dk[c] = 0.f;
    dv[c] = 0.f;
  }

  const T* qb = q + static_cast<size_t>(b) * n_q * D;
  const T* gb = g + static_cast<size_t>(b) * n_q * D;
  const float* lb = lse + static_cast<size_t>(b) * n_q;
  const float* db = delta + static_cast<size_t>(b) * n_q;
  const int r0 = split * rows_per_split;
  const int r1 = min(n_q, r0 + rows_per_split);

  for (int i0 = r0; i0 < r1; i0 += kQTile) {
    const int rows = min(kQTile, r1 - i0);
    __syncthreads();
    const size_t off = static_cast<size_t>(i0) * D;
    for (int i = threadIdx.x; i < rows * D; i += kKeys) {
      qs[i] = d2v::to_f(qb[off + i]);
      gs[i] = d2v::to_f(gb[off + i]);
    }
    if (threadIdx.x < rows) {
      ls[threadIdx.x] = lb[i0 + threadIdx.x] * kLog2e;
      dls[threadIdx.x] = db[i0 + threadIdx.x];
    }
    __syncthreads();

    for (int i = 0; i < rows; ++i) {
      const float4* qr = reinterpret_cast<const float4*>(qs + i * D);
      const float4* gr = reinterpret_cast<const float4*>(gs + i * D);
      float qi[D], gi[D];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < D / 4; ++c4) {
        const float4 qq = qr[c4];
        const float4 gg = gr[c4];
        qi[4 * c4] = qq.x;
        qi[4 * c4 + 1] = qq.y;
        qi[4 * c4 + 2] = qq.z;
        qi[4 * c4 + 3] = qq.w;
        gi[4 * c4] = gg.x;
        gi[4 * c4 + 1] = gg.y;
        gi[4 * c4 + 2] = gg.z;
        gi[4 * c4 + 3] = gg.w;
        s = fmaf(qq.x, kreg[4 * c4], s);
        s = fmaf(qq.y, kreg[4 * c4 + 1], s);
        s = fmaf(qq.z, kreg[4 * c4 + 2], s);
        s = fmaf(qq.w, kreg[4 * c4 + 3], s);
        dp = fmaf(gg.x, vreg[4 * c4], dp);
        dp = fmaf(gg.y, vreg[4 * c4 + 1], dp);
        dp = fmaf(gg.z, vreg[4 * c4 + 2], dp);
        dp = fmaf(gg.w, vreg[4 * c4 + 3], dp);
      }
      const float p = exp2f(s - ls[i]);
      const float ds = p * (dp - dls[i]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dk[c] = fmaf(ds, qi[c], dk[c]);
        dv[c] = fmaf(p, gi[c], dv[c]);
      }
    }
  }

  if (active) {
    float4* out = reinterpret_cast<float4*>(
        partial + ((static_cast<size_t>(split) * gridDim.z + b) * n_kv + key) * 2 * D);
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      out[c4] = make_float4(dk[4 * c4] * sm_scale, dk[4 * c4 + 1] * sm_scale,
                            dk[4 * c4 + 2] * sm_scale, dk[4 * c4 + 3] * sm_scale);
      out[D / 4 + c4] = make_float4(dv[4 * c4], dv[4 * c4 + 1], dv[4 * c4 + 2],
                                    dv[4 * c4 + 3]);
    }
  }
}

// Sums the splits' partials in split order: dk, dv (b, n_kv, d) in T.
template <typename T>
__global__ void __launch_bounds__(256)
flash_mqa_bwd_reduce_kernel(const float* __restrict__ partial,
                            T* __restrict__ dk, T* __restrict__ dv,
                            int n_split, size_t rows, int d) {
  const size_t n = rows * d;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / d;
    const int c = static_cast<int>(i % d);
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* p = partial + (static_cast<size_t>(s) * rows + row) * 2 * d;
      sk += p[c];
      sv += p[d + c];
    }
    dk[i] = d2v::from_f<T>(sk);
    dv[i] = d2v::from_f<T>(sv);
  }
}

// ------------------------------------------------- bf16 / tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using d2v::cp_async16;
using d2v::cp_async4;
using d2v::ldsm_x4;
using d2v::ldsm_x4_trans;
using d2v::mma_bf16;
using d2v::pack_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // streamed rows per stage: queries (dk/dv), keys (dq)
static_assert(kThreads == 2 * kTile, "one lse and one delta copy per thread");

template <int D>
struct Shape {
  static constexpr int kMT = D == 64 ? 1 : 2;       // m16 tiles per warp
  static constexpr int kRows = kWarps * 16 * kMT;  // rows a block owns
  static constexpr int kPitch = D + 8;             // padded shared row (bf16)
  static constexpr int kKS = D / 16;               // k16 steps over d
  static constexpr int kNT = D / 8;                // n8 tiles over d
};

// One ring stage: rows row0 .. row0 + kTile of two [row][d] tensors into
// padded shared tiles, rows at or past `valid` zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* sa, bf16* sb, const bf16* a,
                                          const bf16* b, int row0, int valid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r < valid;
    const size_t off = static_cast<size_t>(row0 + (in ? r : 0)) * D + c;
    cp_async16(sa + r * Shape<D>::kPitch + c, a + off, in);
    cp_async16(sb + r * Shape<D>::kPitch + c, b + off, in);
  }
}

// B fragments of X^T (k = d, n = the 16 rows from r0) from a [row][d]
// tile: out[nt][ks] for the n8 tile of rows r0 + 8 nt and k16 step ks.
template <int D>
__device__ __forceinline__ void ldsm_rows(uint32_t (&out)[2][D / 16][2],
                                          const bf16* tile, int r0, int lane) {
  constexpr int kJ = D / 8;  // 8 x 8 matrices per n8 tile
#pragma unroll
  for (int m4 = 0; m4 < 2 * kJ / 4; ++m4) {
    const int m = m4 * 4 + (lane >> 3);
    uint32_t r[4];
    ldsm_x4(r, tile + (r0 + (m / kJ) * 8 + (lane & 7)) * Shape<D>::kPitch + (m % kJ) * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int mm = m4 * 4 + e;
      out[mm / kJ][(mm % kJ) / 2][mm % 2] = r[e];
    }
  }
}

// B fragments of X (k = the 16 rows from r0, n = d) from a [row][d] tile:
// out[nt] for the n8 tile of d.
template <int D>
__device__ __forceinline__ void ldsm_rows_trans(uint32_t (&out)[D / 8][2],
                                                const bf16* tile, int r0, int lane) {
  const bf16* row = tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Shape<D>::kPitch
                    + (lane >> 4) * 8;
#pragma unroll
  for (int n2 = 0; n2 < D / 16; ++n2) {
    uint32_t r[4];
    ldsm_x4_trans(r, row + n2 * 16);
    out[2 * n2][0] = r[0];
    out[2 * n2][1] = r[1];
    out[2 * n2 + 1][0] = r[2];
    out[2 * n2 + 1][1] = r[3];
  }
}

// A fragments of the 16 rows from row0 of a [row][d] tensor in global
// memory; rows at or past n are zero.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* x,
                                       int row0, int n, int lane) {
  const int r0 = row0 + (lane >> 2), r1 = r0 + 8, c0 = 2 * (lane & 3);
  auto ld = [&](int r, int c) -> uint32_t {
    return r < n ? *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(r) * D + c) : 0u;
  };
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + c0;
    a[ks][0] = ld(r0, c);
    a[ks][1] = ld(r1, c);
    a[ks][2] = ld(r0, c + 8);
    a[ks][3] = ld(r1, c + 8);
  }
}

// an accumulator pair of n8 tiles (16 columns) as one A fragment, in bf16
__device__ __forceinline__ void pack_a(uint32_t* a, const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// dk/dv partials of one query split: partial[split][b][key][0..D) = dK,
// [D..2D) = dV. Grid (key blocks, n_split, b).
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ g,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ partial, int n_q, int n_kv, int tiles_per_split) {
  using S = Shape<D>;
  constexpr int MT = S::kMT, KS = S::kKS, NT = S::kNT, P = S::kPitch;
  __shared__ __align__(16) bf16 sq[2][kTile * P];
  __shared__ __align__(16) bf16 sg[2][kTile * P];
  __shared__ __align__(16) float sl[2][kTile];
  __shared__ __align__(16) float sd[2][kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int bi = blockIdx.z, split = blockIdx.y;
  const int key0 = blockIdx.x * S::kRows + warp * 16 * MT;
  const size_t qrow = static_cast<size_t>(bi) * n_q;
  const bf16* qb = qs + qrow * D;
  const bf16* gb = g + qrow * D;
  const float* lb = lse + qrow;
  const float* db = delta + qrow;
  const bf16* kb = k + static_cast<size_t>(bi) * n_kv * D;
  const bf16* vb = v + static_cast<size_t>(bi) * n_kv * D;

  uint32_t ka[MT][KS][4], va[MT][KS][4];
  float dk[MT][NT][4], dv[MT][NT][4];
  bool kvalid[MT][2];  // the lane's accumulator rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a<D>(ka[mt], kb, key0 + 16 * mt, n_kv, lane);
    load_a<D>(va[mt], vb, key0 + 16 * mt, n_kv, lane);
    kvalid[mt][0] = key0 + 16 * mt + (lane >> 2) < n_kv;
    kvalid[mt][1] = key0 + 16 * mt + (lane >> 2) + 8 < n_kv;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][nt][e] = dv[mt][nt][e] = 0.f;
  }
  const bool ragged = blockIdx.x * S::kRows + S::kRows > n_kv;  // uniform

  const int n_tiles = (n_q + kTile - 1) / kTile;
  const int t0 = split * tiles_per_split;
  const int t1 = min(n_tiles, t0 + tiles_per_split);
  auto prefetch = [&](int tile, int buf) {
    const int row0 = tile * kTile;
    const int valid = min(kTile, n_q - row0);
    load_tile<D>(sq[buf], sg[buf], qb, gb, row0, valid);
    const int r = threadIdx.x % kTile;
    const bool in = r < valid;
    const int src = row0 + (in ? r : 0);
    if (threadIdx.x < kTile) d2v::cp_async4(&sl[buf][r], lb + src, in);
    else d2v::cp_async4(&sd[buf][r], db + src, in);
  };

  if (t0 < t1) prefetch(t0, 0);
  d2v::cp_async_commit();
  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) prefetch(tile + 1, buf ^ 1);
    d2v::cp_async_commit();
    d2v::cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* tq = sq[buf];
    const bf16* tg = sg[buf];
    const int rows = min(kTile, n_q - tile * kTile);
#pragma unroll 1
    for (int c = 0; c < rows; c += 16) {  // padded rows past n_q add 0
      uint32_t bq[2][KS][2], bg[2][KS][2];
      ldsm_rows<D>(bq, tq, c, lane);
      ldsm_rows<D>(bg, tg, c, lane);
      float l2[2][2], dl[2][2];  // per column (query) of the lane's tiles
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l2[nt][e] = sl[buf][c + nt * 8 + 2 * t + e] * kLog2e;
          dl[nt][e] = sd[buf][c + nt * 8 + 2 * t + e];
        }
      uint32_t pa[MT][4], sa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma_bf16(s[nt], ka[mt][ks], bq[nt][ks][0], bq[nt][ks][1]);  // S^T = K qs^T
            mma_bf16(dp[nt], va[mt][ks], bg[nt][ks][0], bg[nt][ks][1]);  // dP^T = V g^T
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[nt][e], kLog2e, -l2[nt][e & 1]);
            if (ragged && !kvalid[mt][e >> 1]) x = -INFINITY;  // a key past n_kv
            s[nt][e] = exp2f(x);                                 // P^T
            dp[nt][e] = s[nt][e] * (dp[nt][e] - dl[nt][e & 1]);  // dS^T
          }
        }
        pack_a(pa[mt], s);
        pack_a(sa[mt], dp);
      }
      uint32_t bgt[NT][2], bqt[NT][2];
      ldsm_rows_trans<D>(bgt, tg, c, lane);
      ldsm_rows_trans<D>(bqt, tq, c, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(dv[mt][nt], pa[mt], bgt[nt][0], bgt[nt][1]);  // dV += P^T g
          mma_bf16(dk[mt][nt], sa[mt], bqt[nt][0], bqt[nt][1]);  // dK += dS^T qs
        }
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  float* out = partial + (static_cast<size_t>(split) * gridDim.z + bi) * n_kv * 2 * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 16 * mt + (lane >> 2) + 8 * h;
      if (key >= n_kv) continue;
      float* row = out + static_cast<size_t>(key) * 2 * D + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(dk[mt][nt][2 * h], dk[mt][nt][2 * h + 1]);
        *reinterpret_cast<float2*>(row + D + nt * 8) =
            make_float2(dv[mt][nt][2 * h], dv[mt][nt][2 * h + 1]);
      }
    }
}

// dq = scale * sum over keys of bf16(dS) k. Grid (query blocks, b).
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ g,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int n_q, int n_kv, float sm_scale) {
  using S = Shape<D>;
  constexpr int MT = S::kMT, KS = S::kKS, NT = S::kNT, P = S::kPitch;
  __shared__ __align__(16) bf16 sk[2][kTile * P];
  __shared__ __align__(16) bf16 sv[2][kTile * P];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int bi = blockIdx.y;
  const int row0 = blockIdx.x * S::kRows + warp * 16 * MT;
  const size_t qrow = static_cast<size_t>(bi) * n_q;
  const bf16* kb = k + static_cast<size_t>(bi) * n_kv * D;
  const bf16* vb = v + static_cast<size_t>(bi) * n_kv * D;

  uint32_t qa[MT][KS][4], ga[MT][KS][4];
  float acc[MT][NT][4], l2[MT][2], dl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a<D>(qa[mt], qs + qrow * D, row0 + 16 * mt, n_q, lane);
    load_a<D>(ga[mt], g + qrow * D, row0 + 16 * mt, n_q, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows past n_q: lse = delta = 0, never stored
      const int r = row0 + 16 * mt + (lane >> 2) + 8 * h;
      l2[mt][h] = r < n_q ? lse[qrow + r] * kLog2e : 0.f;
      dl[mt][h] = r < n_q ? delta[qrow + r] : 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  const int n_tiles = (n_kv + kTile - 1) / kTile;
  auto prefetch = [&](int tile, int buf) {
    load_tile<D>(sk[buf], sv[buf], kb, vb, tile * kTile, min(kTile, n_kv - tile * kTile));
  };
  prefetch(0, 0);
  d2v::cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) prefetch(tile + 1, buf ^ 1);
    d2v::cp_async_commit();
    d2v::cp_async_wait<1>();
    __syncthreads();
    const bf16* tk = sk[buf];
    const bf16* tv = sv[buf];
    const int keys = min(kTile, n_kv - tile * kTile);
#pragma unroll 1
    for (int c = 0; c < keys; c += 16) {  // chunks wholly past n_kv skipped
      const bool ragged = c + 16 > keys;   // uniform
      uint32_t bk[2][KS][2], bv[2][KS][2];
      ldsm_rows<D>(bk, tk, c, lane);
      ldsm_rows<D>(bv, tv, c, lane);
      uint32_t sa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            mma_bf16(s[nt], qa[mt][ks], bk[nt][ks][0], bk[nt][ks][1]);   // S = qs K^T
            mma_bf16(dp[nt], ga[mt][ks], bv[nt][ks][0], bv[nt][ks][1]);  // dP = g V^T
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[nt][e], kLog2e, -l2[mt][e >> 1]);
            if (ragged && c + nt * 8 + 2 * t + (e & 1) >= keys) x = -INFINITY;
            dp[nt][e] = exp2f(x) * (dp[nt][e] - dl[mt][e >> 1]);  // dS
          }
        }
        pack_a(sa[mt], dp);
      }
      uint32_t bkt[NT][2];
      ldsm_rows_trans<D>(bkt, tk, c, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], sa[mt], bkt[nt][0], bkt[nt][1]);  // dQ += dS K
    }
    __syncthreads();
  }

  bf16* ob = dq + qrow * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * mt + (lane >> 2) + 8 * h;
      if (r >= n_q) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r) * D + nt * 8 + 2 * t) =
            pack_bf16(acc[mt][nt][2 * h] * sm_scale, acc[mt][nt][2 * h + 1] * sm_scale);
    }
}

template <int D>
cudaError_t launch(const void* qs, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk,
                   void* dv, float* partial, int b, int n_q, int n_kv,
                   int n_split, float sm_scale, cudaStream_t stream) {
  constexpr int kRows = Shape<D>::kRows;
  const auto* q_ = static_cast<const bf16*>(qs);
  const auto* k_ = static_cast<const bf16*>(k);
  const auto* v_ = static_cast<const bf16*>(v);
  const auto* g_ = static_cast<const bf16*>(g);
  dq_kernel<D><<<dim3((n_q + kRows - 1) / kRows, b), kThreads, 0, stream>>>(
      q_, k_, v_, g_, lse, delta, static_cast<bf16*>(dq), n_q, n_kv, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_q + kTile - 1) / kTile;
  const int per = (n_tiles + n_split - 1) / n_split;
  dkv_kernel<D><<<dim3((n_kv + kRows - 1) / kRows, n_split, b), kThreads, 0, stream>>>(
      q_, k_, v_, g_, lse, delta, partial, n_q, n_kv, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t rows = static_cast<size_t>(b) * n_kv;
  const size_t want = (rows * D + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_mqa_bwd_reduce_kernel<bf16><<<blocks, 256, 0, stream>>>(
      partial, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n_split, rows, D);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, float* delta, void* dq, void* dk,
                   void* dv, float* partial, int b, int n_q, int n_kv,
                   int n_split, float sm_scale, bool delta_from_p, cudaStream_t stream) {
  const float scale_log2 = sm_scale * kLog2e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const dim3 grid((n_q + kRows - 1) / kRows, b);
  cudaError_t err;
  if (delta_from_p) {
    flash_mqa_bwd_dq_kernel<T, D, true><<<grid, kRows, 0, stream>>>(
        qt, kt, vt, gt, lse, delta, nullptr, n_q, n_kv, scale_log2, sm_scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  flash_mqa_bwd_dq_kernel<T, D, false><<<grid, kRows, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), n_q, n_kv, scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows_per_split = (n_q + n_split - 1) / n_split;
  flash_mqa_bwd_dkv_kernel<T, D>
      <<<dim3((n_kv + kKeys - 1) / kKeys, n_split, b), kKeys, 0, stream>>>(
          qt, kt, vt, gt, lse, delta, partial, n_q, n_kv, rows_per_split,
          scale_log2, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t rows = static_cast<size_t>(b) * n_kv;
  const size_t want = (rows * D + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  flash_mqa_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      partial, static_cast<T*>(dk), static_cast<T*>(dv), n_split, rows, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, float* delta,
                       void* dq, void* dk, void* dv, float* partial, int b,
                       int n_q, int n_kv, int d, int n_split, bool tensor_cores,
                       bool delta_from_p, float sm_scale, cudaStream_t stream) {
#define D2V_BWD_ARGS q, k, v, g, lse, delta, dq, dk, dv, partial, b, n_q, n_kv, n_split, sm_scale
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (tensor_cores) {
      switch (d) {
        case 16: return tc::launch<16>(D2V_BWD_ARGS, stream);
        case 32: return tc::launch<32>(D2V_BWD_ARGS, stream);
        case 64: return tc::launch<64>(D2V_BWD_ARGS, stream);
        default: return cudaErrorInvalidValue;
      }
    }
  } else if (tensor_cores) {
    return cudaErrorInvalidValue;  // the tensor-core route is bf16 only
  }
  switch (d) {
    case 16: return launch<T, 16>(D2V_BWD_ARGS, delta_from_p, stream);
    case 32: return launch<T, 32>(D2V_BWD_ARGS, delta_from_p, stream);
    case 64: return launch<T, 64>(D2V_BWD_ARGS, delta_from_p, stream);
    default: return cudaErrorInvalidValue;
  }
#undef D2V_BWD_ARGS
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// The split count the wrapper sizes `partial` for: enough (key block,
// split) dk/dv blocks for ~8 a SM, a split never less than one streamed
// tile of query rows (tensor cores) or one row (CUDA cores). 0 for a shape
// the kernel does not take.
extern "C" int d2v_flash_mqa_bwd_splits(int b, int n_q, int n_kv, int d, int tensor_cores) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0 || (d != 16 && d != 32 && d != 64)) return 0;
  const int keys = !tensor_cores ? kKeys
                   : d == 64     ? tc::Shape<64>::kRows
                                 : tc::Shape<32>::kRows;
  const long long splittable = tensor_cores ? (n_q + tc::kTile - 1) / tc::kTile : n_q;
  const long long kv_blocks = static_cast<long long>(b) * ((n_kv + keys - 1) / keys);
  const long long want = (kTargetBlocks + kv_blocks - 1) / kv_blocks;
  return static_cast<int>(want < splittable ? want : splittable);
}

// q, g, dq (b, n_q, d); k, v, dk, dv (b, n_kv, d); lse, delta (b, n_q) f32;
// partial: n_split * b * n_kv * 2 * d floats of scratch, n_split from
// d2v_flash_mqa_bwd_splits. tensor_cores != 0 takes the bf16 tensor-core
// route, whose q is qs = bf16(scale * q). delta_from_p != 0 (CUDA cores
// only) makes the kernel write delta = rowsum(P * dP) into `delta` first;
// else `delta` holds rowsum(g * out).
extern "C" int d2v_flash_mqa_bwd(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse, void* delta,
                                 void* dq, void* dk, void* dv, void* partial,
                                 int b, int n_q, int n_kv, int d, int n_split,
                                 int dtype, int tensor_cores, int delta_from_p,
                                 float sm_scale, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0 || n_split <= 0 || n_split > n_q ||
      b > 65535 || n_split > 65535 || (tensor_cores && delta_from_p))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* p = static_cast<float*>(partial);
  if (dtype == d2v::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, g, l, dl, dq, dk, dv, p, b, n_q, n_kv, d,
                                     n_split, tensor_cores != 0, delta_from_p != 0,
                                     sm_scale, s);
  if (dtype == d2v::kFloat32)
    return dispatch_d<float>(q, k, v, g, l, dl, dq, dk, dv, p, b, n_q, n_kv, d, n_split,
                             tensor_cores != 0, delta_from_p != 0, sm_scale, s);
  return cudaErrorInvalidValue;
}
