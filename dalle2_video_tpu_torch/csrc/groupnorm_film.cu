// Fused GroupNorm -> FiLM -> SiLU forward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/groupnorm_film.py::_fwd_impl
// (body _kernel), reached through groupnorm_film_silu.
//
// Computes, for x (B, L, C) with G groups,
//   y = silu(xhat * A + Bv),  A = gamma * (scale + 1),
//                             Bv = beta * (scale + 1) + shift,
// with xhat the group-normalised x (statistics in f32, biased variance,
// eps inside the rsqrt), and returns the per-channel broadcast of each
// group's mean and rstd as the TPU kernel does. scale and shift are
// (B, C) or absent (then 0).
//
// What bounds it on the H100: memory. It must read x and write y once
// each; the statistics pass reads x a second time (L2 catches part of it).
//
// Design: the TPU kernel carries its sums across a sequential grid; Hopper
// blocks run in no order, so the work is two launches:
//   1. gn_stats: grid (chunks, B). Each block sums one chunk of rows with
//      16-byte vector loads; because C divides the block's vector stride,
//      every thread always sees the same channels and keeps their f32 sum
//      and sum of squares in registers, then folds them into groups with
//      shared-memory atomics; one (sum, sumsq) pair per (batch, chunk,
//      group) goes to a small scratch buffer.
//   2. gn_apply: grid (blocks, B). Each block reduces its batch row's
//      partials to group mean/rstd, folds GroupNorm affine + FiLM into a
//      per-channel (multiplier, offset) pair, keeps its own channels' pairs
//      in registers, and makes one vectorised pass applying
//      silu(x * mul + off).
// C must be a multiple of G and of the vector width (8 bf16 / 4 f32) and
// divide 256 vectors' worth of elements (2048 bf16 / 1024 f32), up to
// 1024 -- every width the unets use (8 ... 512); G must divide 256 (G = 8
// in every Block3D).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxG = 32;
constexpr int kMaxC = 1024;
template <typename T>
using Vec = d2v::Vec16<T>;

// Thread t always sees channels c0 .. c0 + N - 1 with c0 = (t * N) % C:
// every stride below is a multiple of kThreads * N, which C divides.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int L,
                int C, int G, int rows_per_chunk) {
  constexpr int N = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  __shared__ float gsum[kMaxG];
  __shared__ float gsq[kMaxG];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  if (threadIdx.x < G) {
    gsum[threadIdx.x] = 0.f;
    gsq[threadIdx.x] = 0.f;
  }
  __syncthreads();

  float s[N], sq[N];
#pragma unroll
  for (int e = 0; e < N; ++e) s[e] = sq[e] = 0.f;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(L, r0 + rows_per_chunk);
  const size_t v0 = (static_cast<size_t>(b) * L + r0) * C / N;
  const size_t nv = static_cast<size_t>(max(r1 - r0, 0)) * C / N;
  const Raw* xv = reinterpret_cast<const Raw*>(x) + v0;
#pragma unroll 4
  for (size_t i = threadIdx.x; i < nv; i += kThreads) {
    Raw raw = xv[i];
    const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float val = d2v::to_f(in[e]);
      s[e] += val;
      sq[e] = fmaf(val, val, sq[e]);
    }
  }
  // lanes l and l + C/N see the same channels: fold them with shuffles so
  // only C/N lanes per warp (at most 32) touch the shared group sums
  const int period = C / N;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    for (int off = period; off < 32; off <<= 1) {
      s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
      sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], off);
    }
  }
  const int c0 = (threadIdx.x * N) % C;
  const int cpg = C / G;
  if (lane < period) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int g = (c0 + e) / cpg;
      atomicAdd(&gsum[g], s[e]);
      atomicAdd(&gsq[g], sq[e]);
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float* p = partial + ((static_cast<size_t>(b) * gridDim.x + chunk) * G +
                          threadIdx.x) * 2;
    p[0] = gsum[threadIdx.x];
    p[1] = gsq[threadIdx.x];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ partial,
                int n_chunks, const T* __restrict__ gamma,
                const T* __restrict__ beta, const T* __restrict__ scale,
                const T* __restrict__ shift, T* __restrict__ y,
                float* __restrict__ mean_out, float* __restrict__ rstd_out,
                int L, int C, int G, float eps) {
  constexpr int N = Vec<T>::N;
  using Raw = typename Vec<T>::Raw;
  __shared__ float gsum[kMaxG];
  __shared__ float gsq[kMaxG];
  __shared__ float mul[kMaxC];
  __shared__ float off[kMaxC];
  const int b = blockIdx.y;
  if (threadIdx.x < G) {
    gsum[threadIdx.x] = 0.f;
    gsq[threadIdx.x] = 0.f;
  }
  __syncthreads();
  // partial i belongs to group i % G; G divides kThreads, so each thread
  // keeps one group's sums in registers, lanes l and l + G are folded with
  // shuffles, and only G lanes per warp touch shared memory
  const float* pb = partial + static_cast<size_t>(b) * n_chunks * G * 2;
  float ps = 0.f, pq = 0.f;
  for (int i = threadIdx.x; i < n_chunks * G; i += kThreads) {
    ps += pb[2 * i];
    pq += pb[2 * i + 1];
  }
  for (int off = G; off < 32; off <<= 1) {
    ps += __shfl_xor_sync(0xffffffffu, ps, off);
    pq += __shfl_xor_sync(0xffffffffu, pq, off);
  }
  if (threadIdx.x % 32 < G) {
    atomicAdd(&gsum[threadIdx.x % G], ps);
    atomicAdd(&gsq[threadIdx.x % G], pq);
  }
  __syncthreads();
  const int cpg = C / G;
  const float n_el = static_cast<float>(L) * static_cast<float>(cpg);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int g = c / cpg;
    const float mean = gsum[g] / n_el;
    const float var = fmaxf(gsq[g] / n_el - mean * mean, 0.f);
    const float rstd = rsqrtf(var + eps);
    const float sc = scale ? d2v::to_f(scale[static_cast<size_t>(b) * C + c]) : 0.f;
    const float sh = shift ? d2v::to_f(shift[static_cast<size_t>(b) * C + c]) : 0.f;
    const float a = d2v::to_f(gamma[c]) * (sc + 1.f);
    const float bv = d2v::to_f(beta[c]) * (sc + 1.f) + sh;
    mul[c] = rstd * a;
    off[c] = bv - mean * rstd * a;
    if (blockIdx.x == 0) {
      mean_out[static_cast<size_t>(b) * C + c] = mean;
      rstd_out[static_cast<size_t>(b) * C + c] = rstd;
    }
  }
  __syncthreads();

  const int c0 = (threadIdx.x * N) % C;
  float mr[N], orr[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    mr[e] = mul[c0 + e];
    orr[e] = off[c0 + e];
  }
  const size_t n_vec = static_cast<size_t>(L) * C / N;
  const Raw* xv = reinterpret_cast<const Raw*>(x + static_cast<size_t>(b) * L * C);
  Raw* yv = reinterpret_cast<Raw*>(y + static_cast<size_t>(b) * L * C);
#pragma unroll 4
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += static_cast<size_t>(gridDim.x) * kThreads) {
    Raw raw = xv[i];
    const T* in = reinterpret_cast<const T*>(&raw);
    Raw res;
    T* out = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float z = fmaf(d2v::to_f(in[e]), mr[e], orr[e]);
      out[e] = d2v::from_f<T>(z / (1.f + __expf(-z)));
    }
    yv[i] = res;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   const void* scale, const void* shift, void* y,
                   float* mean, float* rstd, float* partial, int B, int L,
                   int C, int G, int n_chunks, int apply_blocks, float eps,
                   cudaStream_t stream) {
  const int rows_per_chunk = (L + n_chunks - 1) / n_chunks;
  gn_stats_kernel<T><<<dim3(n_chunks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, L, C, G, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<dim3(apply_blocks, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), partial, n_chunks,
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(scale), static_cast<const T*>(shift),
      static_cast<T*>(y), mean, rstd, L, C, G, eps);
  return cudaGetLastError();
}

// C must divide one block-stride of 16-byte vectors, so each thread's
// channels stay fixed (see the kernels), and hold whole vectors.
bool shape_ok(int C, int G, int vec) {
  if (G <= 0 || G > kMaxG || kThreads % G != 0 || C % G != 0 || C > kMaxC) return false;
  return C % vec == 0 && (kThreads * vec) % C == 0;
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x, y (B, L, C); gamma, beta (C,); scale, shift (B, C) or null; mean, rstd
// (B, C) f32 outputs; partial: B * n_chunks * G * 2 floats of scratch.
extern "C" int d2v_groupnorm_film_silu_fwd(
    const void* x, const void* gamma, const void* beta, const void* scale,
    const void* shift, void* y, void* mean, void* rstd, void* partial, int B,
    int L, int C, int G, int n_chunks, int apply_blocks, int dtype, float eps,
    void* stream) {
  if (B <= 0 || L <= 0 || n_chunks <= 0 || n_chunks > L || apply_blocks <= 0 ||
      !shape_ok(C, G, dtype == d2v::kBFloat16 ? 8 : 4))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<float*>(mean);
  auto* r = static_cast<float*>(rstd);
  auto* p = static_cast<float*>(partial);
  if (dtype == d2v::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, scale, shift, y, m, r, p, B,
                                 L, C, G, n_chunks, apply_blocks, eps, s);
  if (dtype == d2v::kFloat32)
    return launch<float>(x, gamma, beta, scale, shift, y, m, r, p, B, L, C, G,
                         n_chunks, apply_blocks, eps, s);
  return cudaErrorInvalidValue;
}
