// Fused GroupNorm -> FiLM -> SiLU backward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/groupnorm_film.py::_bwd_impl (body
// _bwd_kernel), reached through the custom_vjp of groupnorm_film_silu.
//
// Forward: y = silu(z), z = xhat * A + Bv, xhat the group-normalised x.
// Given x and g = dL/dy (B, L, C), the per-(batch, channel) A, Bv and the
// forward's per-channel mean / rstd (all (B, C) f32), with G groups of
// N_g = L * C / G values, it recomputes dz = g * silu'(z) and returns
//   dA_c = sum_L dz * xhat,  dB_c = sum_L dz             (B, C) f32
//   dx = rstd * (A * dz - S1_g - xhat * S2_g),
//   S1_g = sum_{c in g} A_c dB_c / N_g,  S2_g = sum_{c in g} A_c dA_c / N_g.
// The wrapper chains the (B, C) dA, dB into the gamma / beta / FiLM
// gradients, as the JAX package does outside its kernel.
//
// What bounds it on the H100: memory. It must read x and g once and write
// dx once; the sums pass reads x and g a second time (L2 catches part of
// it at the small shapes).
//
// Design: the TPU kernel carries t1 = sum dz and t2 = sum dz * xhat across a
// sequential (phase, L) grid. Hopper blocks run in no order, so it is three
// launches (one counted call):
//   1. gn_bwd_partial: grid (chunks, B). Each block sums one chunk of rows
//      with 16-byte vector loads of x and g. C divides the block's vector
//      stride, so every thread always sees the same channels: it keeps
//      their coefficients and its sums in registers; the threads' sums go
//      to shared memory and are folded per channel in a fixed order; one
//      (t1, t2) row of C values per (batch, chunk) goes to scratch.
//   2. gn_bwd_reduce: grid (C / 32, B). Sums the chunks per channel in a
//      fixed order into dA and dB.
//   3. gn_bwd_dx: grid (blocks, B). Each block folds A * dB and A * dA into
//      the G group sums (each group's channels in order), keeps its own
//      channels' coefficients in registers, and makes one vectorised pass
//      writing dx.
// No atomics: two calls agree bit for bit.
// The width rule is the forward's: C a power of two from the vector width
// (8 bf16 / 4 f32) up to 1024, a multiple of G; G divides 256.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 32;
constexpr int kMaxC = 1024;
template <typename T>
using Vec = d2v::Vec16<T>;

struct Coef {  // one channel's forward coefficients
  float mean, rstd, a, b;
};

__device__ __forceinline__ Coef load_coef(const float* a_vec, const float* b_vec,
                                          const float* mean, const float* rstd,
                                          size_t i) {
  return Coef{mean[i], rstd[i], a_vec[i], b_vec[i]};
}

// dz = g * silu'(z) and xhat, recomputed from the saved statistics
__device__ __forceinline__ void dz_xhat(float xv, float gv, const Coef& k,
                                        float* dz, float* xhat) {
  const float xh = (xv - k.mean) * k.rstd;
  const float z = fmaf(xh, k.a, k.b);
  const float sig = 1.f / (1.f + __expf(-z));
  *dz = gv * sig * fmaf(z, 1.f - sig, 1.f);
  *xhat = xh;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ a_vec,
                      const float* __restrict__ b_vec,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      float* __restrict__ partial, int L, int C,
                      int rows_per_chunk) {
  constexpr int N = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  __shared__ float red1[kThreads * 8];  // each thread's N channel sums
  __shared__ float red2[kThreads * 8];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;

  const int c0 = (threadIdx.x * N) % C;
  Coef coef[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    coef[e] = load_coef(a_vec, b_vec, mean, rstd, static_cast<size_t>(b) * C + c0 + e);
  float t1[N], t2[N];
#pragma unroll
  for (int e = 0; e < N; ++e) t1[e] = t2[e] = 0.f;

  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(L, r0 + rows_per_chunk);
  const size_t v0 = (static_cast<size_t>(b) * L + r0) * C / N;
  const size_t nv = static_cast<size_t>(max(r1 - r0, 0)) * C / N;
  const Raw* xv = reinterpret_cast<const Raw*>(x) + v0;
  const Raw* gv = reinterpret_cast<const Raw*>(g) + v0;
#pragma unroll 2
  for (size_t i = threadIdx.x; i < nv; i += kThreads) {
    Raw xr = xv[i], gr = gv[i];
    const T* xs = reinterpret_cast<const T*>(&xr);
    const T* gs = reinterpret_cast<const T*>(&gr);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float dz, xh;
      dz_xhat(d2v::to_f(xs[e]), d2v::to_f(gs[e]), coef[e], &dz, &xh);
      t1[e] += dz;
      t2[e] = fmaf(dz, xh, t2[e]);
    }
  }
  // lanes l and l + C/N see the same channels (C/N is a power of two): a
  // butterfly of shuffles gives each of them the warp's sum
  const int period = C / N;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    for (int off = period; off < 32; off <<= 1) {
      t1[e] += __shfl_xor_sync(0xffffffffu, t1[e], off);
      t2[e] += __shfl_xor_sync(0xffffffffu, t2[e], off);
    }
  }
  // thread t's element e is channel (t N + e) % C, at red[t N + e]; channel
  // c's distinct sums sit at c + k * max(C, 32 N): one per warp, or one per
  // lane period -- folded in that order
#pragma unroll
  for (int e = 0; e < N; ++e) {
    red1[threadIdx.x * N + e] = t1[e];
    red2[threadIdx.x * N + e] = t2[e];
  }
  __syncthreads();
  float* p = partial + (static_cast<size_t>(b) * gridDim.x + chunk) * 2 * C;
  const int step = max(C, 32 * N);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = c; k < kThreads * N; k += step) {
      a1 += red1[k];
      a2 += red2[k];
    }
    p[c] = a1;
    p[C + c] = a2;
  }
}

// 8 chunk lanes x 32 channels per block; fixed summation order
__global__ void __launch_bounds__(kThreads)
gn_bwd_reduce_kernel(const float* __restrict__ partial, int n_chunks, int C,
                     float* __restrict__ da, float* __restrict__ db) {
  __shared__ float r1[8][32];
  __shared__ float r2[8][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32;
  const int row = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float a1 = 0.f, a2 = 0.f;
  if (c < C) {
    for (int k = row; k < n_chunks; k += 8) {
      const float* p = partial + (static_cast<size_t>(b) * n_chunks + k) * 2 * C;
      a1 += p[c];
      a2 += p[C + c];
    }
  }
  r1[row][lane] = a1;
  r2[row][lane] = a2;
  __syncthreads();
  if (row == 0 && c < C) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s1 += r1[k][lane];
      s2 += r2[k][lane];
    }
    db[static_cast<size_t>(b) * C + c] = s1;  // dB = sum dz
    da[static_cast<size_t>(b) * C + c] = s2;  // dA = sum dz * xhat
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                 const float* __restrict__ a_vec,
                 const float* __restrict__ b_vec,
                 const float* __restrict__ mean,
                 const float* __restrict__ rstd,
                 const float* __restrict__ da, const float* __restrict__ db,
                 T* __restrict__ dx, int L, int C, int G) {
  constexpr int N = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  __shared__ float gs1[kMaxG];
  __shared__ float gs2[kMaxG];
  const int b = blockIdx.y;
  const int cpg = C / G;
  const size_t bc = static_cast<size_t>(b) * C;
  if (threadIdx.x < G) {  // each group's channels in order
    float a1 = 0.f, a2 = 0.f;
    for (size_t c = bc + threadIdx.x * cpg; c < bc + (threadIdx.x + 1) * cpg; ++c) {
      a1 = fmaf(a_vec[c], db[c], a1);
      a2 = fmaf(a_vec[c], da[c], a2);
    }
    gs1[threadIdx.x] = a1;
    gs2[threadIdx.x] = a2;
  }
  __syncthreads();

  const float inv_n = 1.f / (static_cast<float>(L) * static_cast<float>(cpg));
  const int c0 = (threadIdx.x * N) % C;
  Coef coef[N];
  float sg1[N], sg2[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    coef[e] = load_coef(a_vec, b_vec, mean, rstd, bc + c0 + e);
    sg1[e] = gs1[(c0 + e) / cpg] * inv_n;
    sg2[e] = gs2[(c0 + e) / cpg] * inv_n;
  }
  const size_t n_vec = static_cast<size_t>(L) * C / N;
  const Raw* xv = reinterpret_cast<const Raw*>(x + static_cast<size_t>(b) * L * C);
  const Raw* gv = reinterpret_cast<const Raw*>(g + static_cast<size_t>(b) * L * C);
  Raw* ov = reinterpret_cast<Raw*>(dx + static_cast<size_t>(b) * L * C);
#pragma unroll 2
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += static_cast<size_t>(gridDim.x) * kThreads) {
    Raw xr = xv[i], gr = gv[i];
    const T* xs = reinterpret_cast<const T*>(&xr);
    const T* gs = reinterpret_cast<const T*>(&gr);
    Raw res;
    T* out = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      float dz, xh;
      dz_xhat(d2v::to_f(xs[e]), d2v::to_f(gs[e]), coef[e], &dz, &xh);
      out[e] = d2v::from_f<T>(coef[e].rstd * (coef[e].a * dz - sg1[e] - xh * sg2[e]));
    }
    ov[i] = res;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* a_vec,
                   const float* b_vec, const float* mean, const float* rstd,
                   void* dx, float* da, float* db, float* partial, int B, int L,
                   int C, int G, int n_chunks, int dx_blocks,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const int rows_per_chunk = (L + n_chunks - 1) / n_chunks;
  gn_bwd_partial_kernel<T><<<dim3(n_chunks, B), kThreads, 0, stream>>>(
      xt, gt, a_vec, b_vec, mean, rstd, partial, L, C, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_reduce_kernel<<<dim3((C + 31) / 32, B), kThreads, 0, stream>>>(
      partial, n_chunks, C, da, db);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_dx_kernel<T><<<dim3(dx_blocks, B), kThreads, 0, stream>>>(
      xt, gt, a_vec, b_vec, mean, rstd, da, db, static_cast<T*>(dx), L, C, G);
  return cudaGetLastError();
}

bool shape_ok(int C, int G, int vec) {
  if (G <= 0 || G > kMaxG || kThreads % G != 0 || C % G != 0 || C > kMaxC) return false;
  return C % vec == 0 && (kThreads * vec) % C == 0;
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x, g, dx (B, L, C); a_vec, b_vec, mean, rstd (B, C) f32 inputs; da, db
// (B, C) f32 outputs; partial: B * n_chunks * 2 * C floats of scratch.
extern "C" int d2v_groupnorm_film_silu_bwd(
    const void* x, const void* g, const void* a_vec, const void* b_vec,
    const void* mean, const void* rstd, void* dx, void* da, void* db,
    void* partial, int B, int L, int C, int G, int n_chunks, int dx_blocks,
    int dtype, void* stream) {
  if (B <= 0 || L <= 0 || n_chunks <= 0 || n_chunks > L || dx_blocks <= 0 ||
      !shape_ok(C, G, dtype == d2v::kBFloat16 ? 8 : 4))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* dA = static_cast<float*>(da);
  auto* dB = static_cast<float*>(db);
  auto* p = static_cast<float*>(partial);
  if (dtype == d2v::kBFloat16)
    return launch<__nv_bfloat16>(x, g, f(a_vec), f(b_vec), f(mean), f(rstd), dx,
                                 dA, dB, p, B, L, C, G, n_chunks, dx_blocks, s);
  if (dtype == d2v::kFloat32)
    return launch<float>(x, g, f(a_vec), f(b_vec), f(mean), f(rstd), dx, dA, dB,
                         p, B, L, C, G, n_chunks, dx_blocks, s);
  return cudaErrorInvalidValue;
}
