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
// Design: a split-K reduction. The TPU kernel carries one f32 accumulator
// across its sequential grid; Hopper blocks run in no order, so:
//   1. wgrad_*_kernel: grid (9 taps x C/64 x Co/64 tiles, n_split). Each
//      block owns one tap and a 64 x 64 (c, co) tile, walks its split's
//      contiguous range of pixels in steps, and writes its f32 sums to
//      partial[split]. bf16: 4 warps of 32 x 32 on mma.sync m16n8k16, the
//      step's 64 pixels of x (shifted, zero outside the frame) and dy
//      staged transposed in shared memory ([channel][pixel], the K axis
//      contiguous, as flash_mqa.cu stages V^T). f32: 256 threads, a 4 x 4
//      register tile each, on the CUDA cores.
//   2. wgrad_reduce_kernel: dW = the partials added in split order.
// No atomics, so two calls agree bit for bit. The wrapper picks n_split
// (about 8 blocks per SM in all). Splitting also keeps each f32 sum short:
// at the 64x64 stage the kernel is within ~6e-6 of the largest value of an
// f64 computation, cuDNN's f32 weight gradient, whose sums run the whole
// 737,280 pixels, ~1e-4 (H100; chip_smoke.py logs both).

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

// ------------------------------------------------------------ bf16 / mma
constexpr int kBP16 = 64;             // pixels per step
constexpr int kRowT = kBP16 + 8;      // padded [channel][pixel] row
constexpr int kThreads16 = 128;       // 2 (c) x 2 (co) warps of 32 x 32

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads16)
wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ dy,
                  float* __restrict__ partial, Geom g, int steps_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kTile * kRowT];  // [c][pixel]
  __shared__ __align__(16) __nv_bfloat16 ds[kTile * kRowT];  // [co][pixel]

  const int n_co = g.Co / kTile, n_c = g.C / kTile;
  const int co0 = (blockIdx.x % n_co) * kTile;
  const int c0 = ((blockIdx.x / n_co) % n_c) * kTile;
  const int tap = blockIdx.x / (n_co * n_c);
  const int dh = tap / 3, dw = tap % 3;
  const int split = blockIdx.y;
  const long long k_begin = static_cast<long long>(split) * steps_per_split * kBP16;
  const long long k_end = min(g.total, k_begin + static_cast<long long>(steps_per_split) * kBP16);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 2, wn = warp / 2;
  const int gq = lane >> 2, t = lane & 3;
  // staging: each thread owns one pixel of the step and every other
  // 8-channel vector of it (neighbouring threads, neighbouring pixels:
  // the transposed shared stores are conflict-free)
  const int pl = tid % kBP16, v0 = tid / kBP16;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (long long k0 = k_begin; k0 < k_end; k0 += kBP16) {
    __syncthreads();  // the previous step's fragments are read
    const long long p = k0 + pl;
    const bool in = p < k_end;
    const long long src = in ? tap_source(p, dh, dw, g) : -1;
    for (int v = v0; v < kTile / 8; v += kThreads16 / kBP16) {
      uint4 xr = make_uint4(0, 0, 0, 0), dr = make_uint4(0, 0, 0, 0);
      if (src >= 0) xr = *reinterpret_cast<const uint4*>(x + src * g.C + c0 + v * 8);
      if (in) dr = *reinterpret_cast<const uint4*>(dy + p * g.Co + co0 + v * 8);
      const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&xr);
      const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dr);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xs[(v * 8 + e) * kRowT + pl] = xe[e];
        ds[(v * 8 + e) * kRowT + pl] = de[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBP16 / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* r0 = xs + (wm * 32 + i * 16 + gq) * kRowT + kk * 16 + 2 * t;
        const __nv_bfloat16* r1 = r0 + 8 * kRowT;
        a[i][0] = ld32(r0);
        a[i][1] = ld32(r1);
        a[i][2] = ld32(r0 + 8);
        a[i][3] = ld32(r1 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* br = ds + (wn * 32 + 8 * j + gq) * kRowT + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
        mma_bf16(acc[0][j], a[0], b0, b1);
        mma_bf16(acc[1][j], a[1], b0, b1);
      }
    }
  }

  const size_t base = (static_cast<size_t>(split) * 9 + tap) * g.C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = c0 + wm * 32 + i * 16 + gq;
      const int col = co0 + wn * 32 + 8 * j + 2 * t;
      float* p0 = partial + (base + r) * g.Co + col;
      float* p1 = p0 + static_cast<size_t>(8) * g.Co;
      p0[0] = acc[i][j][0];
      p0[1] = acc[i][j][1];
      p1[0] = acc[i][j][2];
      p1[1] = acc[i][j][3];
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
                   const Geom& g, int n_split, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int bp = kBf16 ? kBP16 : kBP32;
  const long long steps = (g.total + bp - 1) / bp;
  const int per = static_cast<int>((steps + n_split - 1) / n_split);
  const dim3 grid(9 * (g.C / kTile) * (g.Co / kTile), n_split);
  if constexpr (kBf16) {
    wgrad_bf16_kernel<<<grid, kThreads16, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), partial, g, per);
  } else {
    wgrad_f32_kernel<<<grid, kThreads32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), partial, g, per);
  }
  cudaError_t err = cudaGetLastError();
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
extern "C" int d2v_conv3x3_wgrad(const void* x, const void* dy, void* dw,
                                 void* partial, int n, int h, int wd, int c,
                                 int co, int n_split, int dtype, void* stream) {
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
  if (dtype == d2v::kBFloat16) return launch<__nv_bfloat16>(x, dy, out, p, g, n_split, s);
  if (dtype == d2v::kFloat32) return launch<float>(x, dy, out, p, g, n_split, s);
  return cudaErrorInvalidValue;
}
