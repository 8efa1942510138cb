// Flash multi-query attention forward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/flash_mqa.py::_flash_mqa_fwd_only
// (body _flash_mqa_kernel), reached through mqa_attention.
//
// Computes out = softmax(q k^T * scale) v against ONE shared kv head, with
// an online (streaming) softmax and float32 state, and optionally the row
// logsumexp (natural log) that the training slice's backward will need.
// q: (b, n_q, d) with the query heads folded into the rows; k, v:
// (b, n_kv, d); bf16 or f32; d in {16, 32, 64}.
//
// What bounds it on the H100: at the serving shape (d = 32, n_kv = 5761)
// the arithmetic intensity is very high, so memory is not the limit. One
// call at b = 2 does 2 * 92160 * 5761 ~ 1.06e9 exponentials and ~136 GFLOP
// of products; the exponentials (16 per clock per SM) and the per-logit
// softmax bookkeeping, not the tensor cores, set the floor.
//
// bf16 (the serving path): tensor cores through mma.sync m16n8k16, laid out
// as FlashAttention-2 does --
//   * a block of 4 warps owns 64 query rows, 16 per warp; each warp keeps
//     its Q fragments, its (16 x d) f32 output accumulator, and the running
//     max / sum of its rows in registers;
//   * the block stages 64-key tiles of K (row-major) and V (transposed) in
//     shared memory, rows padded so the fragment reads are conflict-free;
//     because the kv head is shared, every block streams the same small kv
//     (737 KB per batch row at the serving shape), which stays in L2;
//   * S = Q K^T comes out in the mma accumulator layout, which is exactly
//     the A-operand layout of P for P V, so P never leaves registers;
//   * base-2 softmax (log2 e folded into the scale), one max update per
//     64-key tile, row reductions over the 4 lanes of an mma group.
// f32 inputs take a CUDA-core kernel (one query row per thread), exact in
// f32, for the f32 sampling configuration and for checks.
// Both mask the ragged kv tail (n_kv = 5761 is never tile-aligned) in the
// kernel: logits past n_kv are -inf and every tile (f32: every 16-key
// chunk) starts on a real key, so the running max is always a real logit.
// A padded column can never hold the max, which keeps the output exact
// even when every real logit is below -87 (the fault the TPU kernel once
// had).

#include <type_traits>

#include "common.cuh"

namespace {

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kRows = 128;   // query rows per block, one per thread
constexpr int kTile = 64;    // keys staged in shared memory per pass
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_mqa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int n_q, int n_kv,
                     float scale_log2) {
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n_q;
  const T* kb = k + static_cast<size_t>(b) * n_kv * D;
  const T* vb = v + static_cast<size_t>(b) * n_kv * D;

  float qr[D];
  float acc[D];
  const T* qrow = q + (static_cast<size_t>(b) * n_q + (active ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? d2v::to_f(qrow[c]) * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY;  // running max (base-2 logits)
  float l = 0.f;        // running denominator

  for (int kv0 = 0; kv0 < n_kv; kv0 += kTile) {
    const int tile = min(kTile, n_kv - kv0);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * D; i += kRows) {
      const int r = i / D;
      const int c = i % D;
      float kval = 0.f, vval = 0.f;
      if (r < tile) {
        const size_t off = static_cast<size_t>(kv0 + r) * D + c;
        kval = d2v::to_f(kb[off]);
        vval = d2v::to_f(vb[off]);
      }
      ks[r][c] = kval;
      vs[r][c] = vval;
    }
    __syncthreads();

    for (int j0 = 0; j0 < tile; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j0 + jj][c], dot);
        // keys past the ragged tail are masked here, never padded in HBM
        s[jj] = (j0 + jj < tile) ? dot : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      // cmax is finite: key j0 < tile is real
      const float m_new = fmaxf(m, cmax);
      const float alpha = exp2f(m - m_new);  // 0 on the first chunk
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m_new);  // exactly 0 for masked keys
        l += p;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(p, vs[j0 + jj][c], acc[c]);
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = 1.f / l;
    T* orow = o + (static_cast<size_t>(b) * n_q + row) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = d2v::from_f<T>(acc[c] * inv);
    if (lse != nullptr) {
      lse[static_cast<size_t>(b) * n_q + row] = (m + log2f(l)) * kLn2;
    }
  }
}

// ---------------------------------------------------------------- bf16 / mma
constexpr int kWarps = 4;
constexpr int kBlockRows = kWarps * 16;
constexpr int kKv = 64;  // keys per shared-memory tile

using d2v::mma_bf16;
using d2v::pack_bf16;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_mqa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int n_q, int n_kv,
                         float scale_log2) {
  constexpr int KP = D + 8;    // padded K row (elements)
  constexpr int VP = kKv + 8;  // padded V^T row (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kKv * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // mma group: rows g and g + 8
  const int t = lane & 3;   // lane in group: columns 2t, 2t + 1
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBlockRows + warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * n_q * D;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * n_kv * D;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * n_kv * D;

  auto ld2 = [&](int row, int col) -> uint32_t {
    if (row >= n_q) return 0u;
    return *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(row) * D + col);
  };
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld2(r0, c);
    qa[kk][1] = ld2(r1, c);
    qa[kk][2] = ld2(r0, c + 8);
    qa[kk][3] = ld2(r1, c + 8);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r0 / r1
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the sums

  for (int kv0 = 0; kv0 < n_kv; kv0 += kKv) {
    const int tile = min(kKv, n_kv - kv0);
    __syncthreads();
    for (int i = threadIdx.x; i < kKv * D / 8; i += kWarps * 32) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (r < tile) {
        const size_t off = static_cast<size_t>(kv0 + r) * D + c;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks + r * KP + c) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(c + e) * VP + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys, accumulator layout (rows g, g+8)
    float s[kKv / 8][4];
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * j + g) * KP + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    // scale, mask the ragged tail, row max over the 4 lanes of the group
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 8 * j + 2 * t + (e & 1);
        s[j][e] = key < tile ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key 0 of the tile is real, so mx0 / mx1 are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);  // 0 on tile 0
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);  // masked keys -> exactly 0
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    m0 = mn0;
    m1 = mn1;
    // O += P V: the S accumulators are P's A fragments, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kKv / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = vt + (8 * n + g) * VP + kk * 16 + 2 * t;
        mma_bf16(acc[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * n_q * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (lse != nullptr && t == 0) {
    float* lb = lse + static_cast<size_t>(b) * n_q;
    if (r0 < n_q) lb[r0] = (m0 + log2f(l0)) * kLn2;
    if (r1 < n_q) lb[r1] = (m1 + log2f(l1)) * kLn2;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int n_q, int n_kv, float scale_log2,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    dim3 grid((n_q + kBlockRows - 1) / kBlockRows, b);
    flash_mqa_fwd_mma_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, n_q, n_kv,
        scale_log2);
  } else {
    dim3 grid((n_q + kRows - 1) / kRows, b);
    flash_mqa_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), lse, n_q, n_kv,
        scale_log2);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int n_q, int n_kv, int d,
                       float scale_log2, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, n_q, n_kv, scale_log2, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, n_q, n_kv, scale_log2, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, n_q, n_kv, scale_log2, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, d), k and v (b, n_kv, d), o like q; lse (b, n_q) f32 or null.
extern "C" int d2v_flash_mqa_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int n_q, int n_kv,
                                 int d, int dtype, float sm_scale,
                                 void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  if (dtype == d2v::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, lse_f, b, n_q, n_kv, d,
                                     scale_log2, s);
  if (dtype == d2v::kFloat32)
    return dispatch_d<float>(q, k, v, o, lse_f, b, n_q, n_kv, d, scale_log2, s);
  return cudaErrorInvalidValue;
}
