// The inner-kv flash-MQA forward (the flash redesign's A/B variant) for
// Hopper (sm_90a).
//
// Replaces: scripts/perf_r3_probe9.py::inner_fwd (kernel _inner_kernel).
//
// Computes out = softmax(q k^T) v against ONE shared kv head; the wrapper
// folds the scale into q (in f32, rounded to q's dtype) as the JAX wrapper
// does. q: (b, n_q, d), k and v: (b, n_kv, d), bf16 or f32, d = 32. What
// makes it the probe's kernel:
//   * the fused denominator: v is extended by a mask-ones block (1 on a
//     real key, 0 on a padded one), so P [V | 1] carries the row sum on the
//     tensor cores. One n8 tile of ones (8 equal columns) is enough on this
//     card; the TPU's d extra columns only filled its 128-lane tile;
//   * k is zero-padded up to a multiple of (tile x INNER) keys: a padded
//     column has logit 0 and enters the max; its ones entry and v row are 0;
//   * each step of a block stages INNER kv sub-tiles (64 keys each on the
//     bf16 path) and runs them either as one chain of (max, acc) updates,
//     a max update per sub-tile (MERGE chain), or as INNER independent
//     (m_j, acc_j) register sets, each P_j = exp(S_j - m_j), merged into the
//     running state at the end of the step (MERGE par). The par sets are
//     independent mma -> exp -> mma chains that the warp scheduler can
//     interleave: on this card the counterpart of the TPU's MXU/VPU
//     overlap. par with INNER = 4 holds 4 x 20 f32 accumulators per thread
//     at d = 32 (chip_smoke.py prints the ptxas register and spill report).
// The same underflow caveat as the r2 kernel holds: a padded zero logit can
// hold the max, so a row whose real logits all lie more than ~87 below 0
// is lost; the checks stay away from that regime.
//
// What bounds it on the H100: the exponentials, as for the flash forward
// (1.70e10 at the probe geometry = 4.06 ms at 4.18e12/s); the extra ones
// tile adds a quarter to the P V product, which stays under that bound.
// Layout as csrc/flash_mqa.cu: 4 warps x 16 query rows, mma.sync
// m16n8k16, S in the accumulator layout reused as P's A operand, base-2
// exponentials with log2(e) folded into the logits.
//
// f32 inputs take a CUDA-core kernel (one query row per thread; 16-key
// sub-tiles, a step of 16 x INNER keys), exact in f32, for the probe's
// small check. Its par merges each partial as soon as it is formed: the
// same sequence of operations on the same values as merging them all at
// the end of the step, without INNER register sets a thread could not hold.

#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 32;

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kSub = 16;    // keys per sub-tile (the f32 tile)

template <int INNER, bool PAR>
__global__ void __launch_bounds__(kRows)
inner_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int n_q,
                 int n_kv) {
  constexpr int kStep = kSub * INNER;
  __shared__ float ks[kStep][kD];
  __shared__ float vs[kStep][kD + 1];  // [v | ones]

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n_q;
  const float* kb = k + static_cast<size_t>(b) * n_kv * kD;
  const float* vb = v + static_cast<size_t>(b) * n_kv * kD;
  const float* qrow = q + (static_cast<size_t>(b) * n_q + (active ? row : 0)) * kD;

  float qr[kD], acc[kD + 1];
#pragma unroll
  for (int c = 0; c < kD; ++c) qr[c] = active ? qrow[c] * kLog2e : 0.f;
#pragma unroll
  for (int c = 0; c <= kD; ++c) acc[c] = 0.f;
  float m = -INFINITY;

  for (int kv0 = 0; kv0 < n_kv; kv0 += kStep) {
    __syncthreads();
    for (int i = threadIdx.x; i < kStep * kD; i += kRows) {
      const int r = i / kD, c = i % kD;
      const bool real = kv0 + r < n_kv;
      const size_t off = static_cast<size_t>(kv0 + r) * kD + c;
      ks[r][c] = real ? kb[off] : 0.f;
      vs[r][c] = real ? vb[off] : 0.f;
      if (c == 0) vs[r][kD] = real ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < INNER; ++j) {
      float s[kSub];
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kD; ++c) dot = fmaf(qr[c], ks[j * kSub + jj][c], dot);
        s[jj] = dot;
        mx = fmaxf(mx, dot);
      }
      if (!PAR) {  // chain: one running (m, acc), a max update per sub-tile
        const float mn = fmaxf(m, mx);
        const float alpha = exp2f(m - mn);
#pragma unroll
        for (int c = 0; c <= kD; ++c) acc[c] *= alpha;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float p = exp2f(s[jj] - mn);
#pragma unroll
          for (int c = 0; c <= kD; ++c) acc[c] = fmaf(p, vs[j * kSub + jj][c], acc[c]);
        }
        m = mn;
      } else {  // par: the partial (m_j, a_j) of this sub-tile, then its merge
        float a[kD + 1];
#pragma unroll
        for (int c = 0; c <= kD; ++c) a[c] = 0.f;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float p = exp2f(s[jj] - mx);
#pragma unroll
          for (int c = 0; c <= kD; ++c) a[c] = fmaf(p, vs[j * kSub + jj][c], a[c]);
        }
        const float mn = fmaxf(m, mx);
        const float am = exp2f(m - mn), aj = exp2f(mx - mn);
#pragma unroll
        for (int c = 0; c <= kD; ++c) acc[c] = acc[c] * am + a[c] * aj;
        m = mn;
      }
    }
  }

  if (active) {
    const float inv = 1.f / acc[kD];
    float* orow = o + (static_cast<size_t>(b) * n_q + row) * kD;
#pragma unroll
    for (int c = 0; c < kD; ++c) orow[c] = acc[c] * inv;
  }
}

// ---------------------------------------------------------------- bf16 / mma
constexpr int kWarps = 4;
constexpr int kBlockRows = kWarps * 16;
constexpr int kKv = 64;         // keys per sub-tile (the bf16 tile)
constexpr int kN = kD / 8 + 1;  // n8 tiles of [V | ones]

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int KP = kD + 8;   // padded K row (elements)
constexpr int VP = kKv + 8;  // padded [V | ones]^T row (elements)

// S = Q K_j^T for the warp's 16 rows, scaled to base 2, and its row maxima
// over the 4 lanes of each mma group.
__device__ __forceinline__ void scores(uint32_t (*qa)[4],
                                       const __nv_bfloat16* ks, int g, int t,
                                       float (*s)[4], float& mx0, float& mx1) {
  mx0 = mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKv / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const __nv_bfloat16* kr = ks + (8 * j + g) * KP + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr + kk * 16),
               *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= kLog2e;
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
}

// a += exp2(S - m) [V_j | ones] (the denominator rides in a[kN - 1]).
__device__ __forceinline__ void pv(float (*s)[4], float mn0, float mn1,
                                   const __nv_bfloat16* vt, int g, int t,
                                   float (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < kKv / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(exp2f(s[2 * kk][0] - mn0), exp2f(s[2 * kk][1] - mn0));
    pa[1] = pack_bf16(exp2f(s[2 * kk][2] - mn1), exp2f(s[2 * kk][3] - mn1));
    pa[2] = pack_bf16(exp2f(s[2 * kk + 1][0] - mn0), exp2f(s[2 * kk + 1][1] - mn0));
    pa[3] = pack_bf16(exp2f(s[2 * kk + 1][2] - mn1), exp2f(s[2 * kk + 1][3] - mn1));
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const __nv_bfloat16* vr = vt + (8 * n + g) * VP + kk * 16 + 2 * t;
      mma_bf16(a[n], pa, *reinterpret_cast<const uint32_t*>(vr),
               *reinterpret_cast<const uint32_t*>(vr + 8));
    }
  }
}

template <int INNER, bool PAR>
__global__ void __launch_bounds__(kWarps * 32)
inner_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int n_q, int n_kv) {
  __shared__ __align__(16) __nv_bfloat16 ks[INNER][kKv * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[INNER][kN * 8 * VP];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // mma group: rows g and g + 8
  const int t = lane & 3;   // lane in group: columns 2t, 2t + 1
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBlockRows + warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * n_q * kD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * n_kv * kD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * n_kv * kD;
  const __nv_bfloat16 one = __float2bfloat16(1.f), zero = __float2bfloat16(0.f);

  auto ld2 = [&](int row, int col) -> uint32_t {
    if (row >= n_q) return 0u;
    return *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(row) * kD + col);
  };
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld2(r0, c);
    qa[kk][1] = ld2(r1, c);
    qa[kk][2] = ld2(r0, c + 8);
    qa[kk][3] = ld2(r1, c + 8);
  }
  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (base 2), rows r0 / r1

  for (int kv0 = 0; kv0 < n_kv; kv0 += kKv * INNER) {
    __syncthreads();
    for (int i = threadIdx.x; i < INNER * kKv * kD / 8; i += kWarps * 32) {
      const int j = i / (kKv * kD / 8);
      const int r = (i / (kD / 8)) % kKv;
      const int c = (i % (kD / 8)) * 8;
      const bool real = kv0 + j * kKv + r < n_kv;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (real) {  // past the tail: the zero padding
        const size_t off = static_cast<size_t>(kv0 + j * kKv + r) * kD + c;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks[j] + r * KP + c) = kr;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[j][(c + e) * VP + r] = ve[e];
      if (c == 0) {  // the ones tile: 1 on a real key, 0 on a padded one
#pragma unroll
        for (int e = 0; e < 8; ++e) vt[j][(kD + e) * VP + r] = real ? one : zero;
      }
    }
    __syncthreads();

    if (!PAR) {
#pragma unroll
      for (int j = 0; j < INNER; ++j) {
        float s[kKv / 8][4], mx0, mx1;
        scores(qa, ks[j], g, t, s, mx0, mx1);
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          acc[n][0] *= a0;
          acc[n][1] *= a0;
          acc[n][2] *= a1;
          acc[n][3] *= a1;
        }
        pv(s, mn0, mn1, vt[j], g, t, acc);
        m0 = mn0;
        m1 = mn1;
      }
    } else {
      float part[INNER][kN][4], pm0[INNER], pm1[INNER];
#pragma unroll
      for (int j = 0; j < INNER; ++j) {  // INNER independent chains
        float s[kKv / 8][4];
        scores(qa, ks[j], g, t, s, pm0[j], pm1[j]);
#pragma unroll
        for (int n = 0; n < kN; ++n) part[j][n][0] = part[j][n][1] = part[j][n][2] = part[j][n][3] = 0.f;
        pv(s, pm0[j], pm1[j], vt[j], g, t, part[j]);
      }
#pragma unroll
      for (int j = 0; j < INNER; ++j) {  // merged at the end of the step
        const float mn0 = fmaxf(m0, pm0[j]), mn1 = fmaxf(m1, pm1[j]);
        const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
        const float b0 = exp2f(pm0[j] - mn0), b1 = exp2f(pm1[j] - mn1);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          acc[n][0] = acc[n][0] * a0 + part[j][n][0] * b0;
          acc[n][1] = acc[n][1] * a0 + part[j][n][1] * b0;
          acc[n][2] = acc[n][2] * a1 + part[j][n][2] * b1;
          acc[n][3] = acc[n][3] * a1 + part[j][n][3] * b1;
        }
        m0 = mn0;
        m1 = mn1;
      }
    }
  }

  // every column of the ones tile holds the row sum
  const float inv0 = 1.f / acc[kN - 1][0], inv1 = 1.f / acc[kN - 1][2];
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * n_q * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * kD + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * kD + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int INNER, bool PAR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int n_q, int n_kv, int dtype, cudaStream_t s) {
  if (dtype == d2v::kBFloat16) {
    dim3 grid((n_q + kBlockRows - 1) / kBlockRows, b);
    inner_mma_kernel<INNER, PAR><<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_q, n_kv);
  } else if (dtype == d2v::kFloat32) {
    dim3 grid((n_q + kRows - 1) / kRows, b);
    inner_f32_kernel<INNER, PAR><<<grid, kRows, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n_q, n_kv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, 32) already scaled, k and v (b, n_kv, 32), o like q;
// inner in {2, 4}; merge 0 = chain, 1 = par.
extern "C" int d2v_flash_inner_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int n_q, int n_kv, int dtype,
                                   int inner, int merge, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (inner == 2 && merge == 0) return launch<2, false>(q, k, v, o, b, n_q, n_kv, dtype, s);
  if (inner == 2 && merge == 1) return launch<2, true>(q, k, v, o, b, n_q, n_kv, dtype, s);
  if (inner == 4 && merge == 0) return launch<4, false>(q, k, v, o, b, n_q, n_kv, dtype, s);
  if (inner == 4 && merge == 1) return launch<4, true>(q, k, v, o, b, n_q, n_kv, dtype, s);
  return cudaErrorInvalidValue;
}
