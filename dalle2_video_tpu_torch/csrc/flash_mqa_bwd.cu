// Flash multi-query attention backward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/flash_mqa.py::_bwd_pallas (bodies
// _mqa_bwd_dq_kernel and _mqa_bwd_dkv_kernel), reached through the
// custom_vjp of flash_mqa.
//
// Inputs: q (b, n_q, d) with the query heads folded into the rows; the
// shared k, v (b, n_kv, d); g = dL/dout (b, n_q, d); the forward's
// natural-log row logsumexp lse (b, n_q) and delta = rowsum(g * out)
// (b, n_q), both f32. bf16 or f32 tensors, f32 arithmetic throughout.
// Computes, recomputing P from the saved lse instead of storing it,
//   P = exp(s - lse),  s = scale * q k^T,  dP = g v^T,  dS = P * (dP - delta)
//   dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T g.
//
// What bounds it on the H100: arithmetic. At the training shape (b = 2,
// n_q = 92160, n_kv = 5761, d = 32) one call forms 1.06e9 probabilities and
// five (n_q x n_kv x d) products (3.4e11 FLOP): bound 0.34 ms on the tensor
// cores. This first version runs every product on the CUDA cores in f32
// (~2.6e11 FMA over both passes, ~4 ms even at the f32 FMA peak, and the
// one-row-per-thread loops reach a fraction of that peak), so it is right
// and simple, not fast; tensor cores are later work. PERF.md has its times.
//
// Design (three launches, one counted call):
//   1. dq: one query row per thread, its q, g and dq accumulator in
//      registers; 64-key tiles of k and v staged in shared memory as f32
//      and read as broadcast float4s. The key loop stops at the ragged tail
//      (n_kv = 5761 is never tile-aligned): a key past n_kv is never staged
//      and its p is never formed, so no padded column can leak into a sum,
//      and p = exp2(s - lse) stays exact when every logit is below -87.
//   2. dk/dv: one key per thread, its k, v and both accumulators in
//      registers, query rows streamed through shared memory. dk/dv reduce
//      over every query row of all heads (92,160 rows for 5761 keys): a
//      grid of (kv tiles x batch) alone is 92 blocks with 92k-row loops, so
//      the query range is also split across blocks (grid.y). Each split
//      writes f32 partials, and
//   3. a reduce pass sums the splits in a fixed order and casts to the
//      output dtype. Partials (not atomics) keep the result deterministic,
//      which the card tests rely on; they cost 35 MB of scratch at the
//      training shape and one extra read of it.

#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;   // dq: query rows per block, one per thread
constexpr int kTile = 64;    // dq: keys staged per pass
constexpr int kKeys = 128;   // dk/dv: keys per block, one per thread
constexpr int kQTile = 32;   // dk/dv: query rows staged per pass

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_mqa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
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
  const float dd = delta[r];

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
      const float ds = p * (dp - dd);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, kj[c], acc[c]);
    }
  }

  if (active) {
#pragma unroll
    for (int c = 0; c < D; ++c) dq[r * D + c] = d2v::from_f<T>(acc[c] * sm_scale);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk,
                   void* dv, float* partial, int b, int n_q, int n_kv,
                   int n_split, float sm_scale, cudaStream_t stream) {
  const float scale_log2 = sm_scale * kLog2e;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  flash_mqa_bwd_dq_kernel<T, D><<<dim3((n_q + kRows - 1) / kRows, b), kRows, 0, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), n_q, n_kv, scale_log2, sm_scale);
  cudaError_t err = cudaGetLastError();
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
                       const void* g, const float* lse, const float* delta,
                       void* dq, void* dk, void* dv, float* partial, int b,
                       int n_q, int n_kv, int d, int n_split, float sm_scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, g, lse, delta, dq, dk, dv, partial, b, n_q, n_kv, n_split, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, g, lse, delta, dq, dk, dv, partial, b, n_q, n_kv, n_split, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, g, lse, delta, dq, dk, dv, partial, b, n_q, n_kv, n_split, sm_scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q, g, dq (b, n_q, d); k, v, dk, dv (b, n_kv, d); lse, delta (b, n_q) f32;
// partial: n_split * b * n_kv * 2 * d floats of scratch.
extern "C" int d2v_flash_mqa_bwd(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, void* dk,
                                 void* dv, void* partial, int b, int n_q,
                                 int n_kv, int d, int n_split, int dtype,
                                 float sm_scale, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0 || n_split <= 0 || n_split > n_q)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  auto* p = static_cast<float*>(partial);
  if (dtype == d2v::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, g, l, dl, dq, dk, dv, p, b, n_q,
                                     n_kv, d, n_split, sm_scale, s);
  if (dtype == d2v::kFloat32)
    return dispatch_d<float>(q, k, v, g, l, dl, dq, dk, dv, p, b, n_q, n_kv, d,
                             n_split, sm_scale, s);
  return cudaErrorInvalidValue;
}
