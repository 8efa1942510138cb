// The round-2 flash-MQA forward (the flash redesign's A/B control) for
// Hopper (sm_90a).
//
// Replaces: scripts/perf_r3_probe8.py::r2_fwd (kernel _r2_kernel), the
// probe's copy of the flash forward before its denominator was fused.
//
// Computes out = softmax(q k^T) v against ONE shared kv head; q arrives
// scaled by the caller. q: (b, n_q, d), k and v: (b, n_kv, d), bf16 or f32,
// d = 32. What makes it r2, and is kept so that its cost is r2's:
//   * the ragged kv tail is zero-padded up to a multiple of block_k (the
//     bf16 path; 16 keys on the f32 path): a padded column has logit 0, it
//     enters the running max, and its probability is multiplied by a 0/1
//     mask after the exponential;
//   * the running max moves once per block_k keys, as in the JAX kernel,
//     and the accumulators are rescaled once per block;
//   * the denominator is an explicit row sum of the f32 probabilities
//     before their rounding, kept as its own state l = l * alpha +
//     rowsum(p).
// Where this differs from exact softmax: a padded zero logit can hold the
// running max, so when every real logit of a row lies more than ~87 below 0
// (e^-87 is at the f32 underflow) the probabilities underflow and the row
// is lost. That is the fault the TPU kernel had, closed for the flash
// forward itself (csrc/flash_mqa.cu masks with -inf); the checks of this
// kernel stay away from that regime (their logits are O(1), the most
// negative test rows around -5).
//
// What bounds it on the H100: at the probe geometry (b = 2, 368,640 query
// rows, 23,041 keys, d = 32) 1.70e10 exponentials at 4.18e12/s = 4.06 ms;
// the products (2.17e12 FLOP) take 2.2 ms at the dense bf16 rate, the
// bytes 0.03 ms. bf16 runs the flash forward's Hopper mainloop
// (csrc/flash_fwd_wgmma.cuh: wgmma + TMA, two consumer warpgroups, the
// exact max of each block by two passes over its 128-key tiles) with its
// r2 policy: the zero padding of row 11's chain, sm_scale 1, and the
// denominator as each thread's f32 partial sums of the unrounded p, so
// P V runs at N = d with no ones columns.
// f32 inputs take a CUDA-core kernel (one query row per thread, 16-key
// chunks), exact in f32, for checks.

#include "common.cuh"
#include "flash_fwd_wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kD = 32;

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kRows = 128;  // query rows per block, one per thread
constexpr int kTile = 64;   // keys staged in shared memory per pass
constexpr int kChunk = 16;  // keys per online-softmax update (the f32 tile)

__global__ void __launch_bounds__(kRows)
r2_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int n_q,
              int n_kv) {
  __shared__ float ks[kTile][kD];
  __shared__ float vs[kTile][kD];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool active = row < n_q;
  const float* kb = k + static_cast<size_t>(b) * n_kv * kD;
  const float* vb = v + static_cast<size_t>(b) * n_kv * kD;
  const float* qrow = q + (static_cast<size_t>(b) * n_q + (active ? row : 0)) * kD;

  float qr[kD], acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    qr[c] = active ? qrow[c] * kLog2e : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int kv0 = 0; kv0 < n_kv; kv0 += kTile) {
    const int tile = min(kTile, n_kv - kv0);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kD; i += kRows) {
      const int r = i / kD, c = i % kD;
      const size_t off = static_cast<size_t>(kv0 + r) * kD + c;
      ks[r][c] = r < tile ? kb[off] : 0.f;  // the zero padding
      vs[r][c] = r < tile ? vb[off] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < tile; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kD; ++c) dot = fmaf(qr[c], ks[j0 + jj][c], dot);
        s[jj] = dot;  // a padded key's logit is 0 and enters the max
        cmax = fmaxf(cmax, dot);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = exp2f(m - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - m_new) * (j0 + jj < tile ? 1.f : 0.f);
        lsum += p;
#pragma unroll
        for (int c = 0; c < kD; ++c) acc[c] = fmaf(p, vs[j0 + jj][c], acc[c]);
      }
      l = l * alpha + lsum;
      m = m_new;
    }
  }

  if (active) {
    const float inv = 1.f / l;
    float* orow = o + (static_cast<size_t>(b) * n_q + row) * kD;
#pragma unroll
    for (int c = 0; c < kD; ++c) orow[c] = acc[c] * inv;
  }
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, 32) already scaled, k and v (b, n_kv, 32), o like q; block_k:
// keys per running-max update of the bf16 kernel (a multiple of its 128-key
// tile), the zero padding reaching a multiple of it.
extern "C" int d2v_flash_r2_fwd(const void* q, const void* k, const void* v,
                                void* o, int b, int n_q, int n_kv, int dtype,
                                int block_k, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16) {
    if (block_k <= 0) return cudaErrorInvalidValue;
    const int n_span = (n_kv + block_k - 1) / block_k * block_k;  // the zero padding
    return d2v::wg::launch_flash_fwd<kD, true, false, true>(q, k, v, o, nullptr, b, n_q, n_kv,
                                                            n_span, block_k, 1.f, s);
  }
  if (dtype == d2v::kFloat32) {
    dim3 grid((n_q + kRows - 1) / kRows, b);
    r2_f32_kernel<<<grid, kRows, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n_q, n_kv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
