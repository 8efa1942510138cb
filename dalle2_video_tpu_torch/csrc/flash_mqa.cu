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
// bf16 (the serving path) computes the JAX kernel's function -- q * scale
// rounded to bf16, one running-max update per block_k keys, probabilities
// rounded to bf16 and summed in f32 for the denominator -- on the Hopper
// mainloop of csrc/flash_fwd_wgmma.cuh (wgmma + TMA, a producer warpgroup
// and two consumer warpgroups; its header says what bounds it and how).
// f32 inputs take a CUDA-core kernel (one query row per thread, one max
// update per 16 keys: in f32 the block size changes only the order of f32
// roundings), exact in f32, for the f32 sampling configuration and checks.
// It masks the ragged kv tail in the kernel: logits past n_kv are -inf and
// every 16-key chunk starts on a real key, so the running max is always a
// real logit. A padded column can never hold the max, which keeps the
// output exact even when every real logit is below -87 (the fault the TPU
// kernel once had); the bf16 mainloop keeps the same property.

#include "common.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kRows = 128;   // query rows per block, one per thread
constexpr int kTile = 64;    // keys staged in shared memory per pass
constexpr int kChunk = 16;   // keys per online-softmax update
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(kRows)
flash_mqa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int n_q, int n_kv,
                     float scale_log2) {
  __shared__ float ks[kTile][D];
  __shared__ float vs[kTile][D];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n_q;
  const float* kb = k + static_cast<size_t>(b) * n_kv * D;
  const float* vb = v + static_cast<size_t>(b) * n_kv * D;

  float qr[D];
  float acc[D];
  const float* qrow = q + (static_cast<size_t>(b) * n_q + (active ? row : 0)) * D;
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? qrow[c] * scale_log2 : 0.f;
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
        kval = kb[off];
        vval = vb[off];
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
    float* orow = o + (static_cast<size_t>(b) * n_q + row) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) orow[c] = acc[c] * inv;
    if (lse != nullptr) {
      lse[static_cast<size_t>(b) * n_q + row] = (m + log2f(l)) * kLn2;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int b, int n_q, int n_kv, int dtype, int block_k, float sm_scale,
                   cudaStream_t stream) {
  if (dtype == d2v::kBFloat16)
    return d2v::wg::launch_flash_fwd<D, false, false>(q, k, v, o, lse, b, n_q, n_kv, n_kv,
                                                      block_k, sm_scale, stream);
  if (dtype != d2v::kFloat32) return cudaErrorInvalidValue;
  dim3 grid((n_q + kRows - 1) / kRows, b);
  flash_mqa_fwd_kernel<D><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, n_q, n_kv,
      sm_scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, d), k and v (b, n_kv, d), o like q; lse (b, n_q) f32 or null;
// block_k: keys per running-max update of the bf16 kernel (a multiple of
// its 128-key tile).
extern "C" int d2v_flash_mqa_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int b, int n_q, int n_kv,
                                 int d, int dtype, int block_k, float sm_scale,
                                 void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  switch (d) {
    case 16: return launch<16>(q, k, v, o, lse_f, b, n_q, n_kv, dtype, block_k, sm_scale, s);
    case 32: return launch<32>(q, k, v, o, lse_f, b, n_q, n_kv, dtype, block_k, sm_scale, s);
    case 64: return launch<64>(q, k, v, o, lse_f, b, n_q, n_kv, dtype, block_k, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}
