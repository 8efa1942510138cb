// 3x3 SAME stride-1 convolution for Hopper (sm_90a), channels-last, with an
// optional bias + GroupNorm-statistics epilogue.
//
// Replaces:
//   * dalle2_video_tpu/ops/pallas/spatial_conv.py::_conv_packed_raw
//     (d2v_conv3x3) -- the conv forward, and its dx, which is the same conv
//     of dL/dy with the weight flipped in (kh, kw) and (C, Co) swapped;
//   * dalle2_video_tpu/ops/pallas/fused_block.py::_conv_bias_stats
//     (d2v_conv3x3_bias_stats) -- the conv, plus the f32 bias, y stored in
//     the activation dtype, and per-(batch row, channel) sums of y and y^2
//     over (T, H, W) taken from the f32 value before the rounding.
//
// x (P = N*H*W pixels, C) with N the folded B*T frames; w as (9, Co, C):
// tap-major, each output channel's input channels contiguous; y (P, Co).
// Accumulation is f32; y is rounded once to the input dtype.
//
// What bounds it on the H100: at the model's shapes the products. The
// unet's 64-wide 64x64 stage at B*T = 180 is 54 GFLOP against 94 MB in and
// 94 MB out, about 0.055 ms either way at 989 TFLOP/s and 3.35 TB/s, so
// both bounds matter; the kernel's own limit is how fast it feeds the
// tensor cores.
//
// Design, bf16 (the model path): an implicit GEMM, M = output pixels, N =
// Co, K = 9 * C, on mma.sync m16n8k16 with f32 accumulators (the fragment
// layout of flash_mqa.cu). A block owns 128 consecutive output pixels (in
// flat (n, h, w) order) x 64 output channels, 8 warps of 32 x 32. For each
// 32-channel slice of C it stages in shared memory:
//   * the input rows the 9 taps of its pixels read -- the tile with its
//     1-pixel halo: for tap (dh, dw) pixel p reads flat pixel
//     p + (dh - 1) W + (dw - 1), so three runs of 130 pixels starting at
//     p0 + (dh - 1) W - 1 cover it; when W < 130 the runs overlap and are
//     staged once as one run of 2W + 130 pixels. Pixels past either end of
//     the tensor are staged as zeros;
//   * the 9 taps' 64 x 32 weight slices.
// Then the 9 taps x 2 k-steps run from shared memory; a tap whose source
// pixel falls outside its frame (the SAME padding) contributes a zero A
// fragment, chosen per pixel from a 9-bit mask computed once per block.
// The TPU kernel's pixel-pair packing and 4/3 zero padding existed to fill
// 128-lane vectors at C = 64; none of it is needed here.
//
// f32 (checks and f32 configs; TF32 is off by the port's policy) runs the
// same tiling on the CUDA cores: 64 pixels x 64 channels a block, a 4 x 4
// register tile a thread, 16-channel slices.
//
// Statistics epilogue: a block's pixels all belong to one batch row (the
// grid's z), so a block's partial sums never straddle two rows. Each
// block writes its per-channel partial (sum y, sum y^2) for its pixels --
// the thread sums folded by warp shuffles, then across warps through
// shared memory, in a fixed order -- and a second kernel adds the
// partials of each (batch row, channel) in a fixed order. No atomics: two
// calls agree bit for bit.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kTaps = 9;
constexpr int kBN = 64;  // output channels per block

// ---------------------------------------------------------------- geometry
struct Geom {
  int H, W, HW, C, Co;
  long long total;  // pixels in the tensor
  int R;            // pixels per batch row (the statistics' unit)
};

// The staged halo: run dh starts at flat pixel p0 + (dh - 1) W - 1 and is
// stored from shared row dh * S; S = W when the runs overlap (one run of
// 2W + L pixels), else L (three runs of L pixels).
struct Halo {
  int S, L, rows;
  __host__ __device__ Halo(int W, int bm) {
    L = bm + 2;
    S = W < L ? W : L;
    rows = 2 * S + L;
  }
  __device__ long long src(long long p0, int W, int r) const {
    if (S < L) return p0 - W - 1 + r;
    const int dh = r / L;
    return p0 + static_cast<long long>(dh - 1) * W - 1 + (r - dh * L);
  }
};

// Which of the 9 taps of output pixel p lie inside its frame.
__device__ __forceinline__ unsigned tap_mask(long long p, const Geom& g) {
  const int hw = static_cast<int>(p % g.HW);
  const int h = hw / g.W, w = hw - (hw / g.W) * g.W;
  unsigned m = 0;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
      const int hh = h + dh - 1, ww = w + dw - 1;
      if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W) m |= 1u << (dh * 3 + dw);
    }
  return m;
}

// ------------------------------------------------------------ bf16 / mma
constexpr int kBM16 = 128;  // output pixels per block
constexpr int kBK16 = 32;   // input channels per staged slice
constexpr int kRow16 = kBK16 + 8;  // padded staged row (elements)
constexpr int kThreads16 = 256;    // 4 (M) x 2 (N) warps of 32 x 32

using d2v::mma_bf16;
using d2v::pack_bf16;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

size_t smem_bytes_bf16(int W) {
  const Halo halo(W, kBM16);
  return (static_cast<size_t>(halo.rows) + kTaps * kBN) * kRow16 * sizeof(__nv_bfloat16);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads16)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wk,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ partial, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const Halo halo(g.W, kBM16);
  __nv_bfloat16* bs = as + halo.rows * kRow16;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp % 4, wn = warp / 4;
  const int gq = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, co0 = blockIdx.y * kBN, brow = blockIdx.z;
  const long long p0 = static_cast<long long>(brow) * g.R + static_cast<long long>(tile) * kBM16;
  const int n_valid = min(kBM16, g.R - tile * kBM16);

  // this thread's 4 output rows: m16 tile i, half hh -> wm*32 + 16i + 8hh + gq
  int mrow[4];
  unsigned msk[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mrow[q] = wm * 32 + (q >> 1) * 16 + (q & 1) * 8 + gq;
    msk[q] = mrow[q] < n_valid ? tap_mask(p0 + mrow[q], g) : 0u;
  }

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  constexpr int kVecs = kBK16 / 8;  // 16-byte vectors per staged row
  for (int c0 = 0; c0 < g.C; c0 += kBK16) {
    __syncthreads();  // the previous slice's fragments are read
    for (int i = tid; i < halo.rows * kVecs; i += kThreads16) {
      const int r = i / kVecs, v = i % kVecs;
      const long long src = halo.src(p0, g.W, r);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (src >= 0 && src < g.total)
        val = *reinterpret_cast<const uint4*>(x + src * g.C + c0 + v * 8);
      *reinterpret_cast<uint4*>(as + r * kRow16 + v * 8) = val;
    }
    for (int i = tid; i < kTaps * kBN * kVecs; i += kThreads16) {
      const int v = i % kVecs, n = (i / kVecs) % kBN, tap = i / (kVecs * kBN);
      const size_t off = (static_cast<size_t>(tap) * g.Co + co0 + n) * g.C + c0 + v * 8;
      *reinterpret_cast<uint4*>(bs + (tap * kBN + n) * kRow16 + v * 8) =
          *reinterpret_cast<const uint4*>(wk + off);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int roff = (tap / 3) * halo.S + (tap % 3);
#pragma unroll
      for (int kk = 0; kk < kBK16 / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool v0 = (msk[2 * i] >> tap) & 1u, v1 = (msk[2 * i + 1] >> tap) & 1u;
          const __nv_bfloat16* r0 = as + (roff + mrow[2 * i]) * kRow16 + kk * 16 + 2 * t;
          const __nv_bfloat16* r1 = as + (roff + mrow[2 * i + 1]) * kRow16 + kk * 16 + 2 * t;
          a[i][0] = v0 ? ld32(r0) : 0u;
          a[i][1] = v1 ? ld32(r1) : 0u;
          a[i][2] = v0 ? ld32(r0 + 8) : 0u;
          a[i][3] = v1 ? ld32(r1 + 8) : 0u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* br = bs + (tap * kBN + wn * 32 + 8 * j + gq) * kRow16 + kk * 16 + 2 * t;
          const uint32_t b0 = ld32(br), b1 = ld32(br + 8);
          mma_bf16(acc[0][j], a[0], b0, b1);
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
  }

  // epilogue: (bias), store rounded, (per-channel sums of the f32 values)
  float cs[4][2], css[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + 8 * j + 2 * t;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (kStats) {
      b0 = bias[co0 + col];
      b1 = bias[co0 + col + 1];
    }
    cs[j][0] = cs[j][1] = css[j][0] = css[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mrow[2 * i + hh];
        if (m < n_valid) {
          const float v0 = acc[i][j][2 * hh] + b0, v1 = acc[i][j][2 * hh + 1] + b1;
          *reinterpret_cast<uint32_t*>(y + (p0 + m) * g.Co + co0 + col) = pack_bf16(v0, v1);
          if constexpr (kStats) {
            cs[j][0] += v0;
            cs[j][1] += v1;
            css[j][0] = fmaf(v0, v0, css[j][0]);
            css[j][1] = fmaf(v1, v1, css[j][1]);
          }
        }
      }
    }
  }
  if constexpr (kStats) {
    // fold the 8 row groups of the warp (lane bits 2..4), then the 4 M-warps
    __shared__ float red[4][kBN][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], off);
          css[j][e] += __shfl_xor_sync(0xffffffffu, css[j][e], off);
        }
    if (gq == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * 32 + 8 * j + 2 * t + e;
          red[wm][col][0] = cs[j][e];
          red[wm][col][1] = css[j][e];
        }
    }
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f, ss = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s += red[k][tid][0];
        ss += red[k][tid][1];
      }
      float* p = partial + (static_cast<size_t>(brow) * gridDim.x + tile) * 2 * g.Co;
      p[co0 + tid] = s;
      p[g.Co + co0 + tid] = ss;
    }
  }
}

// ------------------------------------------------------- f32 / CUDA cores
constexpr int kBM32 = 64;   // output pixels per block
constexpr int kBK32 = 16;   // input channels per staged slice
constexpr int kRowA32 = kBK32 + 1;  // staged pixel row (floats)
constexpr int kRowB32 = kBN + 4;    // staged weight row: [tap][k][n]
constexpr int kThreads32 = 256;     // 16 x 16 threads, 4 x 4 outputs each

size_t smem_bytes_f32(int W) {
  const Halo halo(W, kBM32);
  return (static_cast<size_t>(halo.rows) * kRowA32 + kTaps * kBK32 * kRowB32) * sizeof(float);
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads32)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                   const float* __restrict__ bias, float* __restrict__ y,
                   float* __restrict__ partial, Geom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Halo halo(g.W, kBM32);
  // weights first: their rows are 16-byte aligned for float4 reads
  float* bs = reinterpret_cast<float*>(smem_raw);
  float* as = bs + kTaps * kBK32 * kRowB32;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;  // channels tx*4.., pixels ty*4..
  const int tile = blockIdx.x, co0 = blockIdx.y * kBN, brow = blockIdx.z;
  const long long p0 = static_cast<long long>(brow) * g.R + static_cast<long long>(tile) * kBM32;
  const int n_valid = min(kBM32, g.R - tile * kBM32);

  unsigned msk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    msk[i] = m < n_valid ? tap_mask(p0 + m, g) : 0u;
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  constexpr int kVecs = kBK32 / 4;
  for (int c0 = 0; c0 < g.C; c0 += kBK32) {
    __syncthreads();
    for (int i = tid; i < halo.rows * kVecs; i += kThreads32) {
      const int r = i / kVecs, v = i % kVecs;
      const long long src = halo.src(p0, g.W, r);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (src >= 0 && src < g.total)
        val = *reinterpret_cast<const float4*>(x + src * g.C + c0 + v * 4);
      float* dst = as + r * kRowA32 + v * 4;
      dst[0] = val.x;
      dst[1] = val.y;
      dst[2] = val.z;
      dst[3] = val.w;
    }
    for (int i = tid; i < kTaps * kBN * kVecs; i += kThreads32) {
      const int v = i % kVecs, n = (i / kVecs) % kBN, tap = i / (kVecs * kBN);
      const float4 val = *reinterpret_cast<const float4*>(
          wk + (static_cast<size_t>(tap) * g.Co + co0 + n) * g.C + c0 + v * 4);
      float* dst = bs + (tap * kBK32 + v * 4) * kRowB32 + n;
      dst[0] = val.x;
      dst[kRowB32] = val.y;
      dst[2 * kRowB32] = val.z;
      dst[3 * kRowB32] = val.w;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int roff = (tap / 3) * halo.S + (tap % 3);
#pragma unroll 4
      for (int k = 0; k < kBK32; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(bs + (tap * kBK32 + k) * kRowB32 + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // a select, not a product: a neighbour frame's inf must not leak
          const float a = ((msk[i] >> tap) & 1u) ? as[(roff + ty * 4 + i) * kRowA32 + k] : 0.f;
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }

  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kStats) {
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[e] = bias[co0 + tx * 4 + e];
  }
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, css[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m < n_valid) {
      float4 o;
      o.x = acc[i][0] + bv[0];
      o.y = acc[i][1] + bv[1];
      o.z = acc[i][2] + bv[2];
      o.w = acc[i][3] + bv[3];
      *reinterpret_cast<float4*>(y + (p0 + m) * g.Co + co0 + tx * 4) = o;
      if constexpr (kStats) {
        const float v[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          cs[e] += v[e];
          css[e] = fmaf(v[e], v[e], css[e]);
        }
      }
    }
  }
  if constexpr (kStats) {
    __shared__ float red[16][kBN][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[ty][tx * 4 + e][0] = cs[e];
      red[ty][tx * 4 + e][1] = css[e];
    }
    __syncthreads();
    if (tid < kBN) {
      float s = 0.f, ss = 0.f;
      for (int k = 0; k < 16; ++k) {
        s += red[k][tid][0];
        ss += red[k][tid][1];
      }
      float* p = partial + (static_cast<size_t>(brow) * gridDim.x + tile) * 2 * g.Co;
      p[co0 + tid] = s;
      p[g.Co + co0 + tid] = ss;
    }
  }
}

// 8 tile lanes x 32 channels per block; fixed summation order
__global__ void __launch_bounds__(256)
stats_reduce_kernel(const float* __restrict__ partial, int tiles, int Co,
                    float* __restrict__ s, float* __restrict__ ss) {
  __shared__ float r1[8][32];
  __shared__ float r2[8][32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x % 32, row = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float a1 = 0.f, a2 = 0.f;
  if (c < Co) {
    for (int k = row; k < tiles; k += 8) {
      const float* p = partial + (static_cast<size_t>(b) * tiles + k) * 2 * Co;
      a1 += p[c];
      a2 += p[Co + c];
    }
  }
  r1[row][lane] = a1;
  r2[row][lane] = a2;
  __syncthreads();
  if (row == 0 && c < Co) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      t1 += r1[k][lane];
      t2 += r2[k][lane];
    }
    s[static_cast<size_t>(b) * Co + c] = t1;
    ss[static_cast<size_t>(b) * Co + c] = t2;
  }
}

template <typename T, bool kStats>
cudaError_t launch(const void* x, const void* wk, const float* bias, void* y,
                   float* s, float* ss, float* partial, const Geom& g, int batch,
                   cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int bm = kBf16 ? kBM16 : kBM32;
  const int tiles = (g.R + bm - 1) / bm;
  const dim3 grid(tiles, g.Co / kBN, batch);
  cudaError_t err;
  if constexpr (kBf16) {
    const size_t smem = smem_bytes_bf16(g.W);
    auto kern = conv3x3_bf16_kernel<kStats>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads16, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wk), bias, static_cast<T*>(y),
        partial, g);
  } else {
    const size_t smem = smem_bytes_f32(g.W);
    auto kern = conv3x3_f32_kernel<kStats>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(wk), bias, static_cast<T*>(y),
        partial, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !kStats) return err;
  stats_reduce_kernel<<<dim3(g.Co / 32, batch), 256, 0, stream>>>(partial, tiles, g.Co, s, ss);
  return cudaGetLastError();
}

template <bool kStats>
int dispatch(const void* x, const void* wk, const void* bias, void* y, void* s,
             void* ss, void* partial, int n, int h, int w, int c, int co,
             int batch, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || batch <= 0 || n % batch != 0 || c <= 0 ||
      co <= 0 || co % kBN != 0)
    return cudaErrorInvalidValue;
  Geom g;
  g.H = h;
  g.W = w;
  g.HW = h * w;
  g.C = c;
  g.Co = co;
  g.total = static_cast<long long>(n) * h * w;
  g.R = (n / batch) * h * w;
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == d2v::kBFloat16) {
    if (c % kBK16 != 0) return cudaErrorInvalidValue;
    return launch<__nv_bfloat16, kStats>(x, wk, f(bias), y, o(s), o(ss), o(partial), g,
                                         batch, st);
  }
  if (dtype == d2v::kFloat32) {
    if (c % kBK32 != 0) return cudaErrorInvalidValue;
    return launch<float, kStats>(x, wk, f(bias), y, o(s), o(ss), o(partial), g, batch, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x (N, H, W, C), w (9, Co, C), y (N, H, W, Co), one dtype; C % 32 == 0,
// Co % 64 == 0.
extern "C" int d2v_conv3x3(const void* x, const void* w, void* y, int n, int h,
                           int wd, int c, int co, int dtype, void* stream) {
  return dispatch<false>(x, w, nullptr, y, nullptr, nullptr, nullptr, n, h, wd, c,
                         co, 1, dtype, stream);
}

// As d2v_conv3x3 with bias (Co,) f32 added in f32, and s, ss (batch, Co) f32
// the sums of y and y^2 over each batch row's N / batch frames. partial:
// batch * tiles * 2 * Co floats of scratch, tiles = ceil(rows' pixels / 128)
// for bf16 (/ 64 for f32).
extern "C" int d2v_conv3x3_bias_stats(const void* x, const void* w,
                                      const void* bias, void* y, void* s, void* ss,
                                      void* partial, int n, int h, int wd, int c,
                                      int co, int batch, int dtype, void* stream) {
  return dispatch<true>(x, w, bias, y, s, ss, partial, n, h, wd, c, co, batch, dtype,
                        stream);
}
