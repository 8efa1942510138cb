// Fused GroupNorm -> FiLM -> SiLU forward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/groupnorm_film.py::_fwd_impl
// (body _kernel), reached through groupnorm_film_silu.
//
// Computes, for x (B, L, C) with G groups, the JAX kernel's function
//   mean, var = E[x], E[x^2] - mean^2 over each group (f32 sums),
//   rstd = rsqrt(var + eps),
//   z = (x - mean) * rstd * A + Bv,  A = gamma * (scale + 1),
//                                    Bv = beta * (scale + 1) + shift,
//   y = silu(z),
// in the order of _kernel (A, Bv folded in f32 as _fold_ab), and returns the
// per-channel broadcast of each group's mean and rstd as the TPU kernel
// does. scale and shift are (B, C) or absent (then 0). var is clamped at 0
// before eps is added (the JAX kernel is not: where cancellation takes a
// near-constant group's f32 E[x^2] - mean^2 below -eps it gives NaN).
//
// What bounds it on the H100: memory. It must read x and write y once each.
//
// Design (csrc/groupnorm_film.cuh): one cooperative launch, one block per
// SM. Each thread first forms A, Bv of its fixed channels in registers
// while the first tiles are in flight. Phase 1 streams the block's slice
// through a ring of 12 shared-memory stages of 16 KB filled by TMA bulk
// copies; each thread keeps the f32 sum and sum of squares of its channels
// in registers. They are folded in a fixed order (a butterfly over the
// lanes that share channels, a pairwise tree over the warps, a warp sum
// over each group's channels) into one (sum, sumsq) pair per (block,
// group); grid.sync(); a warp per group folds its batch row's pairs (one
// round trip, fixed order) into mean and rstd, and the block walks its
// slice in reverse writing y: the last 12 tiles (192 KB) never left shared
// memory, the rest is read again from L2 where it still is. Where a slice
// fits the ring x is read from HBM once. silu divides with __fdividef
// (within 2 ulp): the IEEE division bounded phase 2 at the smaller widths.

#include "groupnorm_film.cuh"

namespace {

namespace gn = d2v::gn;
constexpr int kStages = 12;  // 192 KB of x
constexpr size_t kSmem = static_cast<size_t>(kStages) * gn::kTileBytes +
                         (gn::kRedFloats + 2 * gn::kMaxC + 2 * gn::kMaxG) * sizeof(float) +
                         kStages * sizeof(uint64_t);
static_assert(kSmem <= 232448, "the ring and scratch must fit an SM's shared memory");

template <typename T>
__global__ void __launch_bounds__(gn::kThreads, 1)
gn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
              const T* __restrict__ scale, const T* __restrict__ shift, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              float* __restrict__ partial, int B, int L, int C, int G, float eps) {
  constexpr int N = gn::Vec<T>::N;
  using Raw = typename gn::Vec<T>::Raw;
  extern __shared__ __align__(128) char smem[];
  float* red = reinterpret_cast<float*>(smem + kStages * gn::kTileBytes);
  float* chan_s = red + gn::kRedFloats;
  float* chan_q = chan_s + gn::kMaxC;
  float* gmean = chan_q + gn::kMaxC;
  float* grstd = gmean + gn::kMaxG;
  uint64_t* bars = reinterpret_cast<uint64_t*>(grstd + gn::kMaxG);

  const int j = blockIdx.x, k = gridDim.x;
  const int c0 = (threadIdx.x * N) % C;
  const int cpg = C / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float n_el = static_cast<float>(L) * static_cast<float>(cpg);
  int grp[N];
#pragma unroll
  for (int e = 0; e < N; ++e) grp[e] = (c0 + e) / cpg;
  gn::Ring<1> ring{smem, bars, kStages, 0u};
  const char* src[1] = {reinterpret_cast<const char*>(x)};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) d2v::mbar_init(&bars[i], 1);
    d2v::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised

  // gridDim.y batch rows a pass, the passes one after another
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const gn::Slice s = gn::slice_of(b, j, k, L, C, N);
    gn::start(ring, s, src);
    // A = gamma (scale + 1), Bv = beta (scale + 1) + shift of this thread's
    // channels, f32, as _fold_ab, while the first tiles are in flight
    const size_t bc = static_cast<size_t>(b) * C + c0;
    float ca[N], cb[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float s1 = scale ? d2v::to_f(scale[bc + e]) + 1.f : 1.f;
      const float sh = shift ? d2v::to_f(shift[bc + e]) : 0.f;
      ca[e] = d2v::to_f(gamma[c0 + e]) * s1;
      cb[e] = fmaf(d2v::to_f(beta[c0 + e]), s1, sh);
    }

    // phase 1: this thread's channels' sums
    float sm[N], sq[N];
#pragma unroll
    for (int e = 0; e < N; ++e) sm[e] = sq[e] = 0.f;
    gn::stream_forward(ring, s, src, [&](int t, int n) {
      const Raw* tv = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 0));
#pragma unroll
      for (int r = 0; r < gn::kTileVecs / gn::kThreads; ++r) {
        const int i = r * gn::kThreads + threadIdx.x;
        if (i < n) {
          Raw raw = tv[i];
          const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float v = d2v::to_f(in[e]);
            sm[e] += v;
            sq[e] = fmaf(v, v, sq[e]);
          }
        }
      }
    });
    gn::block_channel_sums<N>(sm, sq, red, chan_s, chan_q, C);
    for (int g = warp; g < G; g += gn::kWarps) {
      const float2 t = gn::warp_sum2_shared(chan_s + g * cpg, chan_q + g * cpg, cpg);
      if (lane == 0) {  // partial (B, G, 2, k): each sum's k blocks contiguous
        float* p = partial + (static_cast<size_t>(b) * G + g) * 2 * k + j;
        p[0] = t.x;
        p[k] = t.y;
      }
    }
    cooperative_groups::this_grid().sync();

    // each group's statistics from its batch row's k pairs, in one order
    for (int g = warp; g < G; g += gn::kWarps) {
      const float* p = partial + (static_cast<size_t>(b) * G + g) * 2 * k;
      const float2 t = gn::warp_sum2_blocks(p, p + k, k);
      if (lane == 0) {
        const float mean = t.x / n_el;
        const float var = fmaxf(t.y / n_el - mean * mean, 0.f);
        gmean[g] = mean;
        grstd[g] = rsqrtf(var + eps);
      }
    }
    __syncthreads();
    float mu[N], rs[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      mu[e] = gmean[grp[e]];
      rs[e] = grstd[grp[e]];
    }

    // phase 2: y = silu((x - mean) * rstd * A + Bv), the slice in reverse
    Raw* yv = reinterpret_cast<Raw*>(y) + s.v0;
    gn::stream_reverse(ring, s, src, [&](int t, int n) {
      const Raw* tv = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 0));
      Raw* out_t = yv + static_cast<size_t>(t) * gn::kTileVecs;
#pragma unroll
      for (int r = 0; r < gn::kTileVecs / gn::kThreads; ++r) {
        const int i = r * gn::kThreads + threadIdx.x;
        if (i < n) {
          Raw raw = tv[i];
          const T* in = reinterpret_cast<const T*>(&raw);
          Raw res;
          T* o = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float z = fmaf((d2v::to_f(in[e]) - mu[e]) * rs[e], ca[e], cb[e]);
            o[e] = d2v::from_f<T>(__fdividef(z, 1.f + __expf(-z)));
          }
          __stcs(out_t + i, res);  // streaming: L2 keeps what is read again
        }
      }
    });
    if (j == 0)
      for (int c = threadIdx.x; c < C; c += gn::kThreads) {
        mean_out[static_cast<size_t>(b) * C + c] = gmean[c / cpg];
        rstd_out[static_cast<size_t>(b) * C + c] = grstd[c / cpg];
      }
    __syncthreads();  // the ring and gmean are free for the next pass
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta, const void* scale,
                   const void* shift, void* y, void* mean, void* rstd, void* partial, int B,
                   int L, int C, int G, int blocks_per_row, int rows_per_pass, float eps,
                   cudaStream_t stream) {
  void* args[] = {&x, &gamma, &beta, &scale, &shift, &y, &mean, &rstd, &partial,
                  &B, &L, &C, &G, &eps};
  return gn::launch_cooperative(gn_fwd_kernel<T>, blocks_per_row, rows_per_pass, kSmem, args,
                                stream);
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x, y (B, L, C); gamma, beta (C,); scale, shift (B, C) or null; mean, rstd
// (B, C) f32 outputs; partial: B * G * 2 * blocks_per_row floats of
// scratch. The grid is (blocks_per_row, rows_per_pass): rows_per_pass
// batch rows at a time, rows_per_pass dividing B, every block resident at
// once (ops/groupnorm_film.py::plan).
extern "C" int d2v_groupnorm_film_silu_fwd(
    const void* x, const void* gamma, const void* beta, const void* scale,
    const void* shift, void* y, void* mean, void* rstd, void* partial, int B,
    int L, int C, int G, int blocks_per_row, int rows_per_pass, int dtype, float eps,
    void* stream) {
  const int vec = dtype == d2v::kBFloat16 ? 8 : 4;
  if (L <= 0 || !gn::shape_ok(B, C, G, blocks_per_row, rows_per_pass, vec))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16)
    return launch<__nv_bfloat16>(x, gamma, beta, scale, shift, y, mean, rstd, partial, B, L,
                                 C, G, blocks_per_row, rows_per_pass, eps, s);
  if (dtype == d2v::kFloat32)
    return launch<float>(x, gamma, beta, scale, shift, y, mean, rstd, partial, B, L, C, G,
                         blocks_per_row, rows_per_pass, eps, s);
  return cudaErrorInvalidValue;
}
