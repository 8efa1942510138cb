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
// dx once.
//
// Design (csrc/groupnorm_film.cuh): one cooperative launch, one block per
// SM. Phase 1 streams the block's slice of x and g through a ring of 6
// shared-memory stages (16 KB of each a stage) filled by TMA bulk copies;
// each thread keeps its fixed channels' coefficients and its f32 sums of dz
// and dz * xhat in registers; the block folds them per channel in a fixed
// order (a butterfly, then a pairwise tree over the warps) into one (t1,
// t2) row of C values per block; grid.sync(); a warp folds each channel's k
// rows in one order (one round trip) into dB, dA (outputs) -- every block
// all of its row's channels where C is at most its 16 warps, else the
// row's blocks sharing them and a second grid.sync(); each block folds A *
// dB and A * dA into the G group sums (a warp per group over its channels)
// and walks its slice in reverse writing dx: the last 6 tiles (96 KB of x
// and of g) never left shared memory, the rest is read again from L2 where
// it still is. silu' takes its sigmoid with __fdividef (within 2 ulp).

#include "groupnorm_film.cuh"

namespace {

namespace gn = d2v::gn;
constexpr int kStages = 6;  // 96 KB each of x and g
constexpr size_t kSmem = static_cast<size_t>(kStages) * 2 * gn::kTileBytes +
                         (gn::kRedFloats + 3 * gn::kMaxC + 2 * gn::kMaxG) * sizeof(float) +
                         kStages * sizeof(uint64_t);
static_assert(kSmem <= 232448, "the ring and scratch must fit an SM's shared memory");

struct Coef {  // one channel's forward coefficients
  float mean, rstd, a, b;
};

// dz = g * silu'(z) and xhat, recomputed from the saved statistics
__device__ __forceinline__ void dz_xhat(float xv, float gv, const Coef& k, float* dz,
                                        float* xhat) {
  const float xh = (xv - k.mean) * k.rstd;
  const float z = fmaf(xh, k.a, k.b);
  const float sig = __fdividef(1.f, 1.f + __expf(-z));
  *dz = gv * sig * fmaf(z, 1.f - sig, 1.f);
  *xhat = xh;
}

template <typename T>
__global__ void __launch_bounds__(gn::kThreads, 1)
gn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
              const float* __restrict__ a_vec, const float* __restrict__ b_vec,
              const float* __restrict__ mean, const float* __restrict__ rstd,
              T* __restrict__ dx, float* __restrict__ da, float* __restrict__ db,
              float* __restrict__ partial, int B, int L, int C, int G) {
  constexpr int N = gn::Vec<T>::N;
  using Raw = typename gn::Vec<T>::Raw;
  extern __shared__ __align__(128) char smem[];
  float* red = reinterpret_cast<float*>(smem + kStages * 2 * gn::kTileBytes);
  float* chan1 = red + gn::kRedFloats;
  float* chan2 = chan1 + gn::kMaxC;
  float* arow = chan2 + gn::kMaxC;  // this batch row's A
  float* gs1 = arow + gn::kMaxC;
  float* gs2 = gs1 + gn::kMaxG;
  uint64_t* bars = reinterpret_cast<uint64_t*>(gs2 + gn::kMaxG);

  const int j = blockIdx.x, k = gridDim.x;
  const int c0 = (threadIdx.x * N) % C;
  const int cpg = C / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const float inv_n = 1.f / (static_cast<float>(L) * static_cast<float>(cpg));
  int grp[N];
#pragma unroll
  for (int e = 0; e < N; ++e) grp[e] = (c0 + e) / cpg;
  gn::Ring<2> ring{smem, bars, kStages, 0u};
  const char* src[2] = {reinterpret_cast<const char*>(x), reinterpret_cast<const char*>(g)};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) d2v::mbar_init(&bars[i], 1);
    d2v::mbar_init_fence();
  }
  __syncthreads();  // the barriers are initialised
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();

  // gridDim.y batch rows a pass, the passes one after another
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const gn::Slice s = gn::slice_of(b, j, k, L, C, N);
    gn::start(ring, s, src);
    const size_t bc = static_cast<size_t>(b) * C;
    Coef coef[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const size_t i = bc + c0 + e;
      coef[e] = Coef{mean[i], rstd[i], a_vec[i], b_vec[i]};
    }
    for (int c = threadIdx.x; c < C; c += gn::kThreads) arow[c] = a_vec[bc + c];

    // phase 1: this thread's channels' sums of dz and dz * xhat
    float t1[N], t2[N];
#pragma unroll
    for (int e = 0; e < N; ++e) t1[e] = t2[e] = 0.f;
    gn::stream_forward(ring, s, src, [&](int t, int n) {
      const Raw* xt = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 0));
      const Raw* gt = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 1));
#pragma unroll
      for (int r = 0; r < gn::kTileVecs / gn::kThreads; ++r) {
        const int i = r * gn::kThreads + threadIdx.x;
        if (i < n) {
          Raw xr = xt[i], gr = gt[i];
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
      }
    });
    gn::block_channel_sums<N>(t1, t2, red, chan1, chan2, C);
    // partial (B, 2, C, k): each channel's k block sums contiguous
    float* pb = partial + bc * 2 * k;
    for (int c = threadIdx.x; c < C; c += gn::kThreads) {
      pb[static_cast<size_t>(c) * k + j] = chan1[c];
      pb[static_cast<size_t>(C + c) * k + j] = chan2[c];
    }
    grid.sync();

    // dB, dA: each channel's k block sums folded by one warp in one order.
    // Where the row has at most a warp per channel of a block, every block
    // folds them all itself; else the row's warps share its channels and a
    // second grid.sync() publishes dB, dA. Then S1, S2: each group's sums of
    // A dB and A dA, a warp per group.
    if (C <= gn::kWarps) {
      if (warp < C) {
        const float2 t = gn::warp_sum2_blocks(pb + static_cast<size_t>(warp) * k,
                                              pb + static_cast<size_t>(C + warp) * k, k);
        if (lane == 0) {
          chan1[warp] = arow[warp] * t.x;
          chan2[warp] = arow[warp] * t.y;
          if (j == 0) {
            db[bc + warp] = t.x;  // dB = sum dz
            da[bc + warp] = t.y;  // dA = sum dz * xhat
          }
        }
      }
    } else {
      for (int c = j * gn::kWarps + warp; c < C; c += k * gn::kWarps) {
        const float2 t = gn::warp_sum2_blocks(pb + static_cast<size_t>(c) * k,
                                              pb + static_cast<size_t>(C + c) * k, k);
        if (lane == 0) {
          db[bc + c] = t.x;
          da[bc + c] = t.y;
        }
      }
      grid.sync();
      for (int c = threadIdx.x; c < C; c += gn::kThreads) {
        chan1[c] = arow[c] * __ldcg(db + bc + c);
        chan2[c] = arow[c] * __ldcg(da + bc + c);
      }
    }
    __syncthreads();
    for (int q = warp; q < G; q += gn::kWarps) {
      const float2 t = gn::warp_sum2_shared(chan1 + q * cpg, chan2 + q * cpg, cpg);
      if (lane == 0) {
        gs1[q] = t.x;
        gs2[q] = t.y;
      }
    }
    __syncthreads();
    float sg1[N], sg2[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      sg1[e] = gs1[grp[e]] * inv_n;
      sg2[e] = gs2[grp[e]] * inv_n;
    }

    // phase 2: dx, the slice in reverse
    Raw* ov = reinterpret_cast<Raw*>(dx) + s.v0;
    gn::stream_reverse(ring, s, src, [&](int t, int n) {
      const Raw* xt = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 0));
      const Raw* gt = reinterpret_cast<const Raw*>(ring.tile(t % kStages, 1));
      Raw* out_t = ov + static_cast<size_t>(t) * gn::kTileVecs;
#pragma unroll
      for (int r = 0; r < gn::kTileVecs / gn::kThreads; ++r) {
        const int i = r * gn::kThreads + threadIdx.x;
        if (i < n) {
          Raw xr = xt[i], gr = gt[i];
          const T* xs = reinterpret_cast<const T*>(&xr);
          const T* gs = reinterpret_cast<const T*>(&gr);
          Raw res;
          T* o = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            float dz, xh;
            dz_xhat(d2v::to_f(xs[e]), d2v::to_f(gs[e]), coef[e], &dz, &xh);
            o[e] = d2v::from_f<T>(coef[e].rstd * (coef[e].a * dz - sg1[e] - xh * sg2[e]));
          }
          __stcs(out_t + i, res);  // streaming: L2 keeps what is read again
        }
      }
    });
    __syncthreads();  // the ring and the row's vectors are free for the next pass
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const void* a_vec, const void* b_vec,
                   const void* mean, const void* rstd, void* dx, void* da, void* db,
                   void* partial, int B, int L, int C, int G, int blocks_per_row,
                   int rows_per_pass, cudaStream_t stream) {
  void* args[] = {&x, &g, &a_vec, &b_vec, &mean, &rstd, &dx, &da, &db, &partial,
                  &B, &L, &C, &G};
  return gn::launch_cooperative(gn_bwd_kernel<T>, blocks_per_row, rows_per_pass, kSmem, args,
                                stream);
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x, g, dx (B, L, C); a_vec, b_vec, mean, rstd (B, C) f32 inputs; da, db
// (B, C) f32 outputs; partial: B * 2 * C * blocks_per_row floats of
// scratch. The grid is (blocks_per_row, rows_per_pass) as the forward's
// (ops/groupnorm_film.py::plan).
extern "C" int d2v_groupnorm_film_silu_bwd(
    const void* x, const void* g, const void* a_vec, const void* b_vec,
    const void* mean, const void* rstd, void* dx, void* da, void* db,
    void* partial, int B, int L, int C, int G, int blocks_per_row, int rows_per_pass,
    int dtype, void* stream) {
  const int vec = dtype == d2v::kBFloat16 ? 8 : 4;
  if (L <= 0 || !gn::shape_ok(B, C, G, blocks_per_row, rows_per_pass, vec))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16)
    return launch<__nv_bfloat16>(x, g, a_vec, b_vec, mean, rstd, dx, da, db, partial, B, L, C,
                                 G, blocks_per_row, rows_per_pass, s);
  if (dtype == d2v::kFloat32)
    return launch<float>(x, g, a_vec, b_vec, mean, rstd, dx, da, db, partial, B, L, C, G,
                         blocks_per_row, rows_per_pass, s);
  return cudaErrorInvalidValue;
}
