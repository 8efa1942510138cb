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
//     real key, 0 on a padded one), so P [V | 1] carries the row sum;
//   * k is zero-padded up to a multiple of block_k x INNER keys: a padded
//     column has logit 0 and enters the max; its ones entry and v row are 0;
//   * each step takes INNER sub-blocks of block_k keys, either as one chain
//     of (max, acc) updates, a max update per sub-block (MERGE chain), or as
//     INNER independent (m_j, acc_j) partials, each P_j = exp(S_j - m_j),
//     merged into the running state in sub-block order (MERGE par).
// The same underflow caveat as the r2 kernel holds: a padded zero logit can
// hold the max, so a row whose real logits all lie more than ~87 below 0
// is lost; the checks stay away from that regime.
//
// bf16 runs the flash forward's Hopper mainloop (csrc/flash_fwd_wgmma.cuh:
// wgmma + TMA, two consumer warpgroups; the exact max of each sub-block by
// two passes over its 128-key tiles, the denominator on the tensor cores)
// with the zero-padding policy. par merges each partial as soon as it is
// formed: the same operations on the same values as merging them all at
// the end of the step. What bounds it: the exponentials, as for the flash
// forward (1.70e10 at the probe geometry = 4.06 ms at 4.18e12/s).
//
// f32 inputs take a CUDA-core kernel (one query row per thread; 16-key
// sub-tiles, a step of 16 x INNER keys: in f32 the block size changes only
// the order of f32 roundings), exact in f32, for the probe's small check.

#include "common.cuh"
#include "flash_fwd_wgmma.cuh"

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

template <int INNER, bool PAR>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int n_q, int n_kv, int dtype, int block_k, cudaStream_t s) {
  if (dtype == d2v::kBFloat16) {
    if (block_k <= 0) return cudaErrorInvalidValue;
    const int step = block_k * INNER;
    const int n_span = (n_kv + step - 1) / step * step;  // the zero padding
    return d2v::wg::launch_flash_fwd<kD, true, PAR>(q, k, v, o, nullptr, b, n_q, n_kv,
                                                    n_span, block_k, 1.f, s);
  }
  if (dtype != d2v::kFloat32) return cudaErrorInvalidValue;
  dim3 grid((n_q + kRows - 1) / kRows, b);
  inner_f32_kernel<INNER, PAR><<<grid, kRows, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n_q, n_kv);
  return cudaGetLastError();
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, 32) already scaled, k and v (b, n_kv, 32), o like q; block_k:
// keys per sub-block of the bf16 kernel (a multiple of its 128-key tile);
// inner in {2, 4}; merge 0 = chain, 1 = par.
extern "C" int d2v_flash_inner_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int n_q, int n_kv, int dtype,
                                   int block_k, int inner, int merge, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (inner == 2 && merge == 0) return launch<2, false>(q, k, v, o, b, n_q, n_kv, dtype, block_k, s);
  if (inner == 2 && merge == 1) return launch<2, true>(q, k, v, o, b, n_q, n_kv, dtype, block_k, s);
  if (inner == 4 && merge == 0) return launch<4, false>(q, k, v, o, b, n_q, n_kv, dtype, block_k, s);
  if (inner == 4 && merge == 1) return launch<4, true>(q, k, v, o, b, n_q, n_kv, dtype, block_k, s);
  return cudaErrorInvalidValue;
}
