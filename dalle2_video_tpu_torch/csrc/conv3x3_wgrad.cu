// Weight gradient of the 3x3 SAME stride-1 convolution for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/spatial_conv.py::_wgrad_packed
// (body _wgrad_kernel), reached through the custom_vjp of conv3x3_packed and
// the fused Block3D's backward.
//
// dW[tap, c, co] = sum over every pixel p of x[p shifted by the tap, c] *
// dy[p, co] (zero where the shifted pixel leaves its frame), in f32. x
// (P = N*H*W pixels, C) and dy (P, Co) share a dtype; dW comes out as
// (9, C, Co) f32. As a GEMM: M = 9 * C, N = Co, and K = P, the long axis
// (737,280 pixels at the unet's 64x64 stage for B*T = 180).
//
// What bounds it on the H100: at that stage 54 GFLOP against 189 MB of x
// and dy, about 0.056 ms either way; at the small deep stages (8x8, C =
// 512) the bytes are few and the products dominate.
//
// bf16 design (tensor cores, all nine taps in one block, as the TPU kernel
// builds every tap from one halo'd block):
//   * a block owns one (64 c x 64 co) tile and one split of the "groups":
//     a group is R image rows of one frame, over a segment of at most 64
//     columns. The block stages each group's x rows ONCE, natural
//     channels-last [pixel][channel], with a one-pixel zero border and the
//     halo row above and below from the same frame, at a row pitch of
//     P = segment + 2 pixels; and the group's dy rows at the same pitch
//     (the two extra columns zero). Output pixel (r, w) sits at q = r P + w
//     in both, so tap (dh, dw)'s x operand is the same tile read from
//     q + dh P + dw: x and dy cross the bus once per group, with no index
//     arithmetic per tap, and the zero dy columns make the pitch's padding
//     add nothing.
//   * a two-stage ring of cp.async 16-byte copies (zero-filling the border
//     and every row outside the frame) keeps the next group in flight
//     while the tensor cores work on this one.
//   * 12 warps: warp w takes tap row dh = w / 4 and a 32 x 32 (c, co)
//     quarter of the tile, for its three taps dw = 0, 1, 2 (96 f32
//     accumulators a thread). mma.sync m16n8k16 with K = pixels: both
//     operands by ldmatrix.trans from the [pixel][channel] tiles (rows
//     padded to 72 elements, so 8 consecutive pixels hit 8 different bank
//     groups at any tap offset); the dy fragments serve all three taps.
//   * split-K: each split writes its f32 sums to partial[split], and
//     wgrad_reduce_kernel adds the splits in a fixed order. No atomics, so
//     two calls agree bit for bit; the wrapper keeps every split's sum at
//     most 6,272 pixels (ops/spatial_conv.py::WGRAD_CHAIN), which keeps
//     the kernel within ~1e-5 of the largest value of an f64
//     computation (cuDNN's f32 weight gradient, one sum over all 737,280
//     pixels, is ~1e-4 off; chip_smoke.py logs both).
// f32: the CUDA-core kernel below, one tap per block (256 threads, a 4 x 4
// register tile each), same partials and reduce.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTile = 64;  // channels per tile side, c and co

struct Geom {
  int H, W, HW, C, Co;
  long long total;
};

// the flat source pixel of p for tap (dh, dw), or -1 outside its frame
__device__ __forceinline__ long long tap_source(long long p, int dh, int dw, const Geom& g) {
  const int hw = static_cast<int>(p % g.HW);
  const int h = hw / g.W, w = hw - (hw / g.W) * g.W;
  const int hh = h + dh - 1, ww = w + dw - 1;
  if (hh < 0 || hh >= g.H || ww < 0 || ww >= g.W) return -1;
  return p + static_cast<long long>(dh - 1) * g.W + (dw - 1);
}

// ------------------------------------------------- bf16 / tensor cores
using bf16 = __nv_bfloat16;

// The plan's two limits are the wrapper's (ops/spatial_conv.py: WGRAD_SEG,
// WGRAD_MAX_K), handed in as -D macros when it builds this file.
#if !defined(D2V_WGRAD_SEG) || !defined(D2V_WGRAD_MAX_K)
#error "build with -DD2V_WGRAD_SEG and -DD2V_WGRAD_MAX_K (ops/_cuda.py does)"
#endif
constexpr int kSeg = D2V_WGRAD_SEG;           // widest row segment staged
constexpr int kMaxPitch = kSeg + 2;           // pixels per staged row
constexpr int kMaxK = D2V_WGRAD_MAX_K;        // staged dy pixels
static_assert(kMaxK % 16 == 0 && kMaxK >= kMaxPitch, "K steps of 16, at least one row");
constexpr int kXRows = kMaxK + 2 * kMaxPitch + 2;  // staged x pixels, taps' reach
constexpr int kRowE = kTile + 8;              // padded [pixel] row (elements)
constexpr int kWarps16 = 12;
constexpr int kThreads16 = kWarps16 * 32;
constexpr int kStageElems = (kXRows + kMaxK) * kRowE;
constexpr size_t kSmem16 = 2 * kStageElems * sizeof(bf16);  // 158,400 bytes at 64 / 208
static_assert(kSmem16 <= 227 * 1024, "one block's ring must fit an SM's shared memory");

struct Plan {
  int R, seg, pitch, k_pad;  // rows per group, segment, row pitch, staged K
  int n_rg, n_seg;           // row groups per frame, segments per row
  long long groups;
  int groups_per_split;
};

// Stage group gi's x rows (with halo and border) and dy rows of the tile
// (c0, co0) into xs / ds.
__device__ __forceinline__ void stage_group(bf16* xs, bf16* ds, const bf16* x, const bf16* dy,
                                            long long gi, const Geom& g, const Plan& pl,
                                            int c0, int co0) {
  const int sg = static_cast<int>(gi % pl.n_seg);
  const long long fr = gi / pl.n_seg;
  const int rg = static_cast<int>(fr % pl.n_rg);
  const long long f = fr / pl.n_rg;
  const int h0 = rg * pl.R, w0 = sg * pl.seg;
  const long long frame = f * g.HW;
  const int x_rows = pl.k_pad + 2 * pl.pitch + 2;
  for (int i = threadIdx.x; i < x_rows * 8; i += kThreads16) {
    const int q = i >> 3, v = (i & 7) * 8;
    const int rr = q / pl.pitch, cc = q - rr * pl.pitch;
    const int hh = h0 + rr - 1, ww = w0 + cc - 1;
    const bool in = rr < pl.R + 2 && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
    const long long src = in ? frame + static_cast<long long>(hh) * g.W + ww : 0;
    d2v::cp_async16(xs + q * kRowE + v, x + src * g.C + c0 + v, in);
  }
  for (int i = threadIdx.x; i < pl.k_pad * 8; i += kThreads16) {
    const int q = i >> 3, v = (i & 7) * 8;
    const int r = q / pl.pitch, cc = q - r * pl.pitch;
    const int hh = h0 + r, ww = w0 + cc;
    const bool in = r < pl.R && cc < pl.seg && hh < g.H && ww < g.W;
    const long long src = in ? frame + static_cast<long long>(hh) * g.W + ww : 0;
    d2v::cp_async16(ds + q * kRowE + v, dy + src * g.Co + co0 + v, in);
  }
}

__global__ void __launch_bounds__(kThreads16, 1)
wgrad_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                  float* __restrict__ partial, Geom g, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int n_co = g.Co / kTile;
  const int co0 = (blockIdx.x % n_co) * kTile;
  const int c0 = (blockIdx.x / n_co) * kTile;
  const int split = blockIdx.y;
  const long long gi0 = static_cast<long long>(split) * pl.groups_per_split;
  const long long gi1 = min(pl.groups, gi0 + pl.groups_per_split);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dh = warp / 4, wm = warp & 1, wn = (warp >> 1) & 1;
  // ldmatrix row of this lane: A (x, [pixel][c]) matrices ordered (c, pixel)
  // halves as (0,0) (8,0) (0,8) (8,8); B (dy, [pixel][co]) as (0,0) (0,8)
  // in pixels, then the next 8 co
  const int a_pix = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_col = wm * 32 + ((lane >> 3) & 1) * 8;
  const int b_pix = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = wn * 32 + (lane >> 4) * 8;
  const int tap_off = dh * pl.pitch;

  float acc[3][2][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j][0] = acc[t][i][j][1] = acc[t][i][j][2] = acc[t][i][j][3] = 0.f;

  auto xs_of = [&](int buf) { return smem + buf * kStageElems; };
  auto ds_of = [&](int buf) { return smem + buf * kStageElems + kXRows * kRowE; };
  if (gi0 < gi1) stage_group(xs_of(0), ds_of(0), x, dy, gi0, g, pl, c0, co0);
  d2v::cp_async_commit();
  for (long long gi = gi0; gi < gi1; ++gi) {
    const int buf = static_cast<int>(gi - gi0) & 1;
    if (gi + 1 < gi1) stage_group(xs_of(buf ^ 1), ds_of(buf ^ 1), x, dy, gi + 1, g, pl, c0, co0);
    d2v::cp_async_commit();
    d2v::cp_async_wait<1>();  // this group's copies have landed
    __syncthreads();
    const bf16* xs = xs_of(buf) + (tap_off + a_pix) * kRowE + a_col;
    const bf16* ds = ds_of(buf) + b_pix * kRowE + b_col;
#pragma unroll 1
    for (int k0 = 0; k0 < pl.k_pad; k0 += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        uint32_t r[4];
        d2v::ldsm_x4_trans(r, ds + k0 * kRowE + nn * 16);
        b[2 * nn][0] = r[0];
        b[2 * nn][1] = r[1];
        b[2 * nn + 1][0] = r[2];
        b[2 * nn + 1][1] = r[3];
      }
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          d2v::ldsm_x4_trans(a[mi], xs + (k0 + dw) * kRowE + mi * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) d2v::mma_bf16(acc[dw][mi][nj], a[mi], b[nj][0], b[nj][1]);
      }
    }
    __syncthreads();  // the buffer is refilled two groups on
  }

  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int dw = 0; dw < 3; ++dw) {
    const size_t base = (static_cast<size_t>(split) * 9 + dh * 3 + dw) * g.C;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int r = c0 + wm * 32 + mi * 16 + gq;
        const int col = co0 + wn * 32 + nj * 8 + 2 * t;
        float* p0 = partial + (base + r) * g.Co + col;
        *reinterpret_cast<float2*>(p0) = make_float2(acc[dw][mi][nj][0], acc[dw][mi][nj][1]);
        *reinterpret_cast<float2*>(p0 + static_cast<size_t>(8) * g.Co) =
            make_float2(acc[dw][mi][nj][2], acc[dw][mi][nj][3]);
      }
  }
}

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kBP32 = 32;          // pixels per step
constexpr int kRow32 = kTile + 4;  // staged [pixel][channel] row (floats)
constexpr int kThreads32 = 256;    // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads32)
wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ partial, Geom g, int steps_per_split) {
  __shared__ __align__(16) float xs[kBP32 * kRow32];  // [pixel][c]
  __shared__ __align__(16) float ds[kBP32 * kRow32];  // [pixel][co]

  const int n_co = g.Co / kTile, n_c = g.C / kTile;
  const int co0 = (blockIdx.x % n_co) * kTile;
  const int c0 = ((blockIdx.x / n_co) % n_c) * kTile;
  const int tap = blockIdx.x / (n_co * n_c);
  const int dh = tap / 3, dw = tap % 3;
  const int split = blockIdx.y;
  const long long k_begin = static_cast<long long>(split) * steps_per_split * kBP32;
  const long long k_end = min(g.total, k_begin + static_cast<long long>(steps_per_split) * kBP32);

  const int tid = threadIdx.x;
  const int tc = tid / 16, tco = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  constexpr int kVecs = kTile / 4;  // float4 per staged row
  for (long long k0 = k_begin; k0 < k_end; k0 += kBP32) {
    __syncthreads();
    for (int i = tid; i < kBP32 * kVecs; i += kThreads32) {
      const int pl = i / kVecs, v = i % kVecs;
      const long long p = k0 + pl;
      const bool in = p < k_end;
      const long long src = in ? tap_source(p, dh, dw, g) : -1;
      float4 xr = make_float4(0.f, 0.f, 0.f, 0.f), dr = xr;
      if (src >= 0) xr = *reinterpret_cast<const float4*>(x + src * g.C + c0 + v * 4);
      if (in) dr = *reinterpret_cast<const float4*>(dy + p * g.Co + co0 + v * 4);
      *reinterpret_cast<float4*>(xs + pl * kRow32 + v * 4) = xr;
      *reinterpret_cast<float4*>(ds + pl * kRow32 + v * 4) = dr;
    }
    __syncthreads();
#pragma unroll 8
    for (int pl = 0; pl < kBP32; ++pl) {
      const float4 a = *reinterpret_cast<const float4*>(xs + pl * kRow32 + tc * 4);
      const float4 b = *reinterpret_cast<const float4*>(ds + pl * kRow32 + tco * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
  }

  const size_t base = (static_cast<size_t>(split) * 9 + tap) * g.C + c0 + tc * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(partial + (base + i) * g.Co + co0 + tco * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// dW = sum of the n_split partials, in split order
__global__ void __launch_bounds__(256)
wgrad_reduce_kernel(const float* __restrict__ partial, int n_split, size_t n,
                    float* __restrict__ dw) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += partial[static_cast<size_t>(k) * n + i];
  dw[i] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dy, float* dw, float* partial,
                   const Geom& g, int n_split, int rows, int seg, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same_v<T, bf16>) {
    Plan pl;
    pl.R = rows;
    pl.seg = seg;
    pl.pitch = seg + 2;
    pl.k_pad = (rows * pl.pitch + 15) / 16 * 16;
    if (rows <= 0 || seg <= 0 || seg > kSeg || pl.k_pad > kMaxK) return cudaErrorInvalidValue;
    pl.n_rg = (g.H + rows - 1) / rows;
    pl.n_seg = (g.W + seg - 1) / seg;
    pl.groups = g.total / g.HW * pl.n_rg * pl.n_seg;
    pl.groups_per_split = static_cast<int>((pl.groups + n_split - 1) / n_split);
    err = cudaFuncSetAttribute(wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmem16));  // above the 48 KB default
    if (err != cudaSuccess) return err;
    const dim3 grid((g.C / kTile) * (g.Co / kTile), n_split);
    wgrad_bf16_kernel<<<grid, kThreads16, kSmem16, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), partial, g, pl);
  } else {
    const long long steps = (g.total + kBP32 - 1) / kBP32;
    const int per = static_cast<int>((steps + n_split - 1) / n_split);
    const dim3 grid(9 * (g.C / kTile) * (g.Co / kTile), n_split);
    wgrad_f32_kernel<<<grid, kThreads32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), partial, g, per);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n = static_cast<size_t>(9) * g.C * g.Co;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
      partial, n_split, n, dw);
  return cudaGetLastError();
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x (N, H, W, C), dy (N, H, W, Co), one dtype; dw (9, C, Co) f32 out;
// partial: n_split * 9 * C * Co floats of scratch. C, Co multiples of 64.
// bf16: a group is `rows` image rows of a `seg`-column segment
// (ops/spatial_conv.py::wgrad_plan); f32 ignores both.
extern "C" int d2v_conv3x3_wgrad(const void* x, const void* dy, void* dw,
                                 void* partial, int n, int h, int wd, int c,
                                 int co, int n_split, int rows, int seg, int dtype,
                                 void* stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c <= 0 || co <= 0 || c % kTile != 0 ||
      co % kTile != 0 || n_split <= 0 || n_split > 65535)
    return cudaErrorInvalidValue;
  Geom g;
  g.H = h;
  g.W = wd;
  g.HW = h * wd;
  g.C = c;
  g.Co = co;
  g.total = static_cast<long long>(n) * h * wd;
  auto s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(dw);
  auto* p = static_cast<float*>(partial);
  if (dtype == d2v::kBFloat16) return launch<bf16>(x, dy, out, p, g, n_split, rows, seg, s);
  if (dtype == d2v::kFloat32) return launch<float>(x, dy, out, p, g, n_split, rows, seg, s);
  return cudaErrorInvalidValue;
}
