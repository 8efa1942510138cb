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
// Co, K = 9 * C, on mma.sync m16n8k16 with f32 accumulators, laid out as
// the weight gradient's (conv3x3_wgrad.cu):
//   * persistent blocks: a block owns one 64-wide Co tile and walks a
//     static run of output tiles (every blocks_per_co-th), the blocks
//     filling whole waves of one block per SM. A tile is F frames x R rows
//     x a segment of at most 64 columns, at most 512 pixels, and never
//     straddles two batch rows (ops/spatial_conv.py::conv_plan picks F, R,
//     the segment and the blocks);
//   * x staged once per tile and 32-channel slice: every staged frame with
//     its halo rows and a one-pixel zero border at a pitch of P = segment
//     + 2 pixels, by cp.async with zero-fill. Output pixel (f, r, c) reads
//     tap (dh, dw) at staged pixel (f (R + 2) + r + dh) P + c + dw: the
//     same tile at a constant offset, no per-pixel tap mask or select. The
//     SAME padding is zeros in shared memory, so a neighbouring frame's
//     value (an inf) never enters a product;
//   * a two-stage ring: the next (tile, slice) is in flight while the
//     tensor cores work on this one;
//   * weights: at C <= 64 the nine taps of every slice stay resident for
//     the block's whole run of tiles (staged once per block); above, and
//     for a block of one tile, each slice's nine taps go through the ring
//     beside x, once per tile of up to 512 pixels;
//   * 8 warps of 64 pixels x 64 channels (128 f32 accumulators a thread);
//     A fragments by ldmatrix.x4 from the [pixel][channel] tile (each
//     lane's row address fixed per plan, a tap adds its offset), B by
//     ldmatrix.x4 from the [tap][co][channel] weights; rows padded to 40
//     elements, so 8 consecutive pixels hit 8 different 16-byte bank
//     groups at any tap offset. Each (tap, k16) step's A fragments are
//     loaded a step ahead;
//   * epilogue: the rounded tile goes through the x buffer its last slice
//     used (free until the ring refills it) and leaves in whole 128-byte
//     rows of 64 channels.
// The TPU kernel's pixel-pair packing and 4/3 zero padding existed to fill
// 128-lane vectors at C = 64; none of it is needed here.
//
// f32 (checks and f32 configs; TF32 is off by the port's policy) runs on
// the CUDA cores: 64 pixels x 64 channels a block, a 4 x 4 register tile a
// thread, 16-channel slices, the tap mask below.
//
// Statistics epilogue: a tile's pixels all belong to one batch row. Each
// tile writes its per-channel partial (sum y, sum y^2) of its valid pixels
// -- the thread sums folded by warp shuffles, then across warps through
// shared memory, in a fixed order -- and a second kernel adds the
// partials of each (batch row, channel) in tile order. No atomics: two
// calls agree bit for bit.

#include "common.cuh"

// The plan's constants are the wrapper's (ops/spatial_conv.py: CONV_BK,
// CONV_BN, CONV_TILE, CONV_SEG, CONV_STAGED, CONV_F32_TILE), handed in as
// -D macros when it builds this file.
#if !defined(D2V_CONV_BK) || !defined(D2V_CONV_BN) || !defined(D2V_CONV_TILE) || \
    !defined(D2V_CONV_SEG) || !defined(D2V_CONV_STAGED) || !defined(D2V_CONV_F32_TILE)
#error "build with the D2V_CONV_* -D macros (ops/_cuda.py does)"
#endif

namespace {

constexpr int kTaps = 9;
constexpr int kBN = D2V_CONV_BN;  // output channels per block
static_assert(kBN == 64, "a warp's 64-channel tile is the block's");

// ---------------------------------------------------------------- geometry
struct Geom {
  int H, W, HW, C, Co;
  long long total;  // pixels in the tensor
  int R;            // pixels per batch row (the statistics' unit)
};

// ------------------------------------------------------------ bf16 / mma
using bf16 = __nv_bfloat16;
constexpr int kBK16 = D2V_CONV_BK;       // input channels per staged slice
static_assert(kBK16 == 32, "a staged pixel row is four 16-byte copies");
constexpr int kRow16 = kBK16 + 8;        // padded staged row (elements)
constexpr int kWarps16 = 8;
constexpr int kThreads16 = kWarps16 * 32;
constexpr int kWarpM = 64;               // output pixels per warp
constexpr int kTile16 = D2V_CONV_TILE;   // output pixels per tile
static_assert(kTile16 == kWarps16 * kWarpM, "a tile is the 8 warps' pixels");
constexpr int kSeg = D2V_CONV_SEG;       // widest column segment
constexpr int kStaged = D2V_CONV_STAGED; // most staged pixels per tile
constexpr int kXStage = kStaged * kRow16;           // elements per x stage
constexpr int kWSlice = kTaps * kBN * kRow16;       // elements per weight slice
constexpr int kResidentSlices = 2;                  // C <= 64: all weights resident
constexpr size_t kSmem16 = (2 * static_cast<size_t>(kXStage) + 2 * kWSlice) * sizeof(bf16);
static_assert(kSmem16 + kWarps16 * kBN * 2 * sizeof(float) <= 227 * 1024,
              "the ring, the weights and the statistics fold fit one SM");
static_assert(kTile16 * kBN <= kXStage, "an x stage holds the rounded output tile");

struct Plan {
  int F, R, seg, P;        // frames, rows, columns of a tile; staged row pitch
  int n_fg, n_rg, n_seg;   // frame groups per batch row, row groups, segments
  int tiles_per_row;       // n_fg * n_rg * n_seg
  int tiles;               // batch rows * tiles_per_row
  int frames;              // frames per batch row
  int blocks_per_co;
  int staged, m_used;      // F (R + 2) P staged pixels; F R seg output pixels
};

struct TileAt {
  int frame0, frame_end, row0, col0;
};

__device__ __forceinline__ TileAt tile_at(int t, const Plan& pl) {
  const int brow = t / pl.tiles_per_row;
  int rem = t - brow * pl.tiles_per_row;
  const int sg = rem % pl.n_seg;
  rem /= pl.n_seg;
  const int rg = rem % pl.n_rg;
  const int fg = rem / pl.n_rg;
  TileAt ta;
  ta.frame0 = brow * pl.frames + fg * pl.F;
  ta.frame_end = (brow + 1) * pl.frames;
  ta.row0 = rg * pl.R;
  ta.col0 = sg * pl.seg;
  return ta;
}

// x of tile ta, channels c0 .. c0 + 31, with halo rows and zero border
__device__ __forceinline__ void stage_x(bf16* xs, const bf16* x, const TileAt& ta,
                                        const Geom& g, const Plan& pl, int c0) {
  const int per_frame = (pl.R + 2) * pl.P;
  for (int i = threadIdx.x; i < pl.staged * 4; i += kThreads16) {
    const int q = i >> 2, v = (i & 3) * 8;
    const int f = q / per_frame;
    const int rem = q - f * per_frame;
    const int rr = rem / pl.P, cc = rem - rr * pl.P;
    const int fr = ta.frame0 + f, hh = ta.row0 + rr - 1, ww = ta.col0 + cc - 1;
    const bool in = fr < ta.frame_end && hh >= 0 && hh < g.H && ww >= 0 && ww < g.W;
    const long long src = in ? (static_cast<long long>(fr) * g.H + hh) * g.W + ww : 0;
    d2v::cp_async16(xs + q * kRow16 + v, x + src * g.C + c0 + v, in);
  }
}

// the nine taps' (64 co x 32 c) weights of channels c0 .. c0 + 31
__device__ __forceinline__ void stage_w(bf16* ws, const bf16* wk, const Geom& g, int co0,
                                        int c0) {
  for (int i = threadIdx.x; i < kTaps * kBN * 4; i += kThreads16) {
    const int v = (i & 3) * 8, n = (i >> 2) % kBN, tap = (i >> 2) / kBN;
    d2v::cp_async16(ws + (tap * kBN + n) * kRow16 + v,
                    wk + (static_cast<size_t>(tap) * g.Co + co0 + n) * g.C + c0 + v, true);
  }
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads16, 1)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wk,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    float* __restrict__ partial, Geom g, Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* wbase = smem + 2 * kXStage;

  const int n_co = g.Co / kBN;
  const int co0 = (blockIdx.x % n_co) * kBN;
  const int t0 = blockIdx.x / n_co;
  const int n_slices = g.C / kBK16;
  const int my_tiles = t0 < pl.tiles ? (pl.tiles - 1 - t0) / pl.blocks_per_co + 1 : 0;
  // a block of one tile streams its weights: its first slice starts sooner
  const bool resident = n_slices <= kResidentSlices && my_tiles > 1;
  const int steps = my_tiles * n_slices;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  const bool warp_active = warp * kWarpM < pl.m_used;
  // ldmatrix row of this lane: A matrices (pixels 0-7, c 0-7) (8-15, 0-7)
  // (0-7, 8-15) (8-15, 8-15) of each m16 tile; B (co 0-7, c 0-7) (0-7,
  // 8-15) (8-15, 0-7) (8-15, 8-15) of each pair of n8 tiles. A pixel's
  // staged place is the same in every tile; pixels past m_used read
  // staged pixel 0 and are never stored.
  int a_off[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = warp * kWarpM + 16 * i + (lane & 15);
    int s = 0;
    if (m < pl.m_used) {
      const int f = m / (pl.R * pl.seg), rem = m - f * pl.R * pl.seg;
      const int r = rem / pl.seg, c = rem - r * pl.seg;
      s = (f * (pl.R + 2) + r) * pl.P + c;
    }
    a_off[i] = s * kRow16 + (lane >> 4) * 8;
  }
  const int b_off = ((lane & 7) + ((lane >> 4) & 1) * 8) * kRow16 + ((lane >> 3) & 1) * 8;
  const int dh_off = pl.P * kRow16;

  float bv[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bv[j][0] = kStats ? bias[co0 + 8 * j + 2 * t] : 0.f;
    bv[j][1] = kStats ? bias[co0 + 8 * j + 2 * t + 1] : 0.f;
  }
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (resident)
    for (int s = 0; s < n_slices; ++s) stage_w(wbase + s * kWSlice, wk, g, co0, s * kBK16);
  if (steps > 0) {
    stage_x(smem, x, tile_at(t0, pl), g, pl, 0);
    if (!resident) stage_w(wbase, wk, g, co0, 0);
  }
  d2v::cp_async_commit();

  for (int j = 0; j < steps; ++j) {
    const int buf = j & 1;
    if (j + 1 < steps) {
      const int tn = t0 + ((j + 1) / n_slices) * pl.blocks_per_co;
      const int sn = (j + 1) % n_slices;
      stage_x(smem + (buf ^ 1) * kXStage, x, tile_at(tn, pl), g, pl, sn * kBK16);
      if (!resident) stage_w(wbase + (buf ^ 1) * kWSlice, wk, g, co0, sn * kBK16);
    }
    d2v::cp_async_commit();
    d2v::cp_async_wait<1>();  // this step's copies have landed
    __syncthreads();
    const int slice = j % n_slices;
    if (warp_active) {
      const bf16* xs = smem + buf * kXStage;
      const bf16* ws = wbase + (resident ? slice : buf) * kWSlice + b_off;
      // (tap, k16) steps; each step's A fragments are loaded one step ahead
      constexpr int kSteps = kTaps * (kBK16 / 16);
      auto a_at = [&](int st, int i) {
        const int tap = st / (kBK16 / 16), kk = st % (kBK16 / 16);
        return xs + a_off[i] + (tap / 3) * dh_off + (tap % 3) * kRow16 + kk * 16;
      };
      uint32_t a[2][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d2v::ldsm_x4(a[0][i], a_at(0, i));
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int cur = st & 1;
        if (st + 1 < kSteps) {
#pragma unroll
          for (int i = 0; i < 4; ++i) d2v::ldsm_x4(a[cur ^ 1][i], a_at(st + 1, i));
        }
        const int tap = st / (kBK16 / 16), kk = st % (kBK16 / 16);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          d2v::ldsm_x4(bf, ws + (tap * kBN + jj * 16) * kRow16 + kk * 16);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d2v::mma_bf16(acc[i][2 * jj], a[cur][i], bf[0], bf[1]);
            d2v::mma_bf16(acc[i][2 * jj + 1], a[cur][i], bf[2], bf[3]);
          }
        }
      }
    }
    __syncthreads();  // the buffer is refilled two steps on
    if (slice != n_slices - 1) continue;

    // epilogue of tile tt: (bias), round, (per-channel sums of the f32
    // values of its valid pixels); the rounded tile goes through this
    // step's x buffer, free until the next step stages into it, as
    // [pixel][64 co] rows with their 16-byte chunks swizzled by pixel % 8
    // (conflict-free both ways), and leaves in whole 128-byte rows
    const int tt = t0 + (j / n_slices) * pl.blocks_per_co;
    const TileAt ta = tile_at(tt, pl);
    bf16* ys = smem + buf * kXStage;
    float cs[8][2], css[8][2];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) cs[jn][0] = cs[jn][1] = css[jn][0] = css[jn][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = warp * kWarpM + 16 * i + 8 * hh + gq;
        bool valid = false;
        if constexpr (kStats) {
          const int f = m / (pl.R * pl.seg), rem = m - f * pl.R * pl.seg;
          const int r = rem / pl.seg, c = rem - r * pl.seg;
          valid = m < pl.m_used && ta.frame0 + f < ta.frame_end && ta.row0 + r < g.H &&
                  ta.col0 + c < g.W;
        }
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const float v0 = acc[i][jn][2 * hh] + bv[jn][0];
          const float v1 = acc[i][jn][2 * hh + 1] + bv[jn][1];
          *reinterpret_cast<uint32_t*>(ys + m * kBN + ((jn ^ (m & 7)) * 8) + 2 * t) =
              d2v::pack_bf16(v0, v1);
          if (kStats && valid) {
            cs[jn][0] += v0;
            cs[jn][1] += v1;
            css[jn][0] = fmaf(v0, v0, css[jn][0]);
            css[jn][1] = fmaf(v1, v1, css[jn][1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) acc[i][jn][0] = acc[i][jn][1] = acc[i][jn][2] = acc[i][jn][3] = 0.f;
    __syncthreads();
    for (int idx = threadIdx.x; idx < pl.m_used * 8; idx += kThreads16) {
      const int m = idx >> 3, k = idx & 7;
      const int f = m / (pl.R * pl.seg), rem = m - f * pl.R * pl.seg;
      const int r = rem / pl.seg, c = rem - r * pl.seg;
      const int fr = ta.frame0 + f, row = ta.row0 + r, col = ta.col0 + c;
      if (fr < ta.frame_end && row < g.H && col < g.W)
        *reinterpret_cast<uint4*>(y + ((static_cast<long long>(fr) * g.H + row) * g.W + col) *
                                          g.Co + co0 + 8 * k) =
            *reinterpret_cast<const uint4*>(ys + m * kBN + ((k ^ (m & 7)) * 8));
    }
    if constexpr (kStats) {
      // fold the 8 row groups of the warp (lane bits 2..4), then the 8 warps
      __shared__ float red[kWarps16][kBN][2];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            cs[jn][e] += __shfl_xor_sync(0xffffffffu, cs[jn][e], off);
            css[jn][e] += __shfl_xor_sync(0xffffffffu, css[jn][e], off);
          }
      if (gq == 0) {
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red[warp][8 * jn + 2 * t + e][0] = cs[jn][e];
            red[warp][8 * jn + 2 * t + e][1] = css[jn][e];
          }
      }
      __syncthreads();
      if (threadIdx.x < kBN) {
        float s = 0.f, ss = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps16; ++k) {
          s += red[k][threadIdx.x][0];
          ss += red[k][threadIdx.x][1];
        }
        float* p = partial + static_cast<size_t>(tt) * 2 * g.Co;
        p[co0 + threadIdx.x] = s;
        p[g.Co + co0 + threadIdx.x] = ss;
      }
      // red is written again only after the next tile's steps
    }
    __syncthreads();  // ys is read out before the next step stages into it
  }
}

// ------------------------------------------------------- f32 / CUDA cores
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

constexpr int kBM32 = D2V_CONV_F32_TILE;  // output pixels per block
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

template <bool kStats>
cudaError_t launch_bf16(const bf16* x, const bf16* wk, const float* bias, bf16* y, float* s,
                        float* ss, float* partial, const Geom& g, int batch, int frames,
                        int rows, int seg, int tiles_per_row, int blocks, cudaStream_t stream) {
  Plan pl;
  pl.F = frames;
  pl.R = rows;
  pl.seg = seg;
  pl.P = seg + 2;
  if (frames <= 0 || rows <= 0 || seg <= 0 || seg > kSeg || rows > g.H || seg > g.W)
    return cudaErrorInvalidValue;
  pl.frames = static_cast<int>(g.total / g.HW) / batch;
  pl.n_fg = (pl.frames + frames - 1) / frames;
  pl.n_rg = (g.H + rows - 1) / rows;
  pl.n_seg = (g.W + seg - 1) / seg;
  pl.tiles_per_row = pl.n_fg * pl.n_rg * pl.n_seg;
  pl.tiles = batch * pl.tiles_per_row;
  pl.staged = frames * (rows + 2) * pl.P;
  pl.m_used = frames * rows * seg;
  const int n_co = g.Co / kBN;
  if (pl.tiles_per_row != tiles_per_row || pl.m_used > kTile16 || pl.staged > kStaged ||
      blocks <= 0 || blocks % n_co != 0)
    return cudaErrorInvalidValue;
  pl.blocks_per_co = blocks / n_co;
  auto kern = conv3x3_bf16_kernel<kStats>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem16));  // above the 48 KB default
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads16, kSmem16, stream>>>(x, wk, bias, y, partial, g, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kStats) return err;
  stats_reduce_kernel<<<dim3(g.Co / 32, batch), 256, 0, stream>>>(partial, tiles_per_row, g.Co,
                                                                 s, ss);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_f32(const float* x, const float* wk, const float* bias, float* y, float* s,
                       float* ss, float* partial, const Geom& g, int batch, int tiles_per_row,
                       cudaStream_t stream) {
  const int tiles = (g.R + kBM32 - 1) / kBM32;
  if (kStats && tiles != tiles_per_row) return cudaErrorInvalidValue;
  const dim3 grid(tiles, g.Co / kBN, batch);
  const size_t smem = smem_bytes_f32(g.W);
  auto kern = conv3x3_f32_kernel<kStats>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads32, smem, stream>>>(x, wk, bias, y, partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kStats) return err;
  stats_reduce_kernel<<<dim3(g.Co / 32, batch), 256, 0, stream>>>(partial, tiles, g.Co, s, ss);
  return cudaGetLastError();
}

template <bool kStats>
int dispatch(const void* x, const void* wk, const void* bias, void* y, void* s, void* ss,
             void* partial, int n, int h, int w, int c, int co, int batch, int frames,
             int rows, int seg, int tiles_per_row, int blocks, int dtype, void* stream) {
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
    return launch_bf16<kStats>(static_cast<const bf16*>(x), static_cast<const bf16*>(wk),
                               f(bias), static_cast<bf16*>(y), o(s), o(ss), o(partial), g,
                               batch, frames, rows, seg, tiles_per_row, blocks, st);
  }
  if (dtype == d2v::kFloat32) {
    if (c % kBK32 != 0) return cudaErrorInvalidValue;
    return launch_f32<kStats>(f(x), f(wk), f(bias), o(y), o(s), o(ss), o(partial), g, batch,
                              tiles_per_row, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// x (N, H, W, C), w (9, Co, C), y (N, H, W, Co), one dtype; C % 32 == 0,
// Co % 64 == 0. bf16: a tile is `frames` frames x `rows` rows x `seg`
// columns, `blocks` persistent blocks (ops/spatial_conv.py::conv_plan,
// which also gives tiles_per_row); f32 ignores the plan.
extern "C" int d2v_conv3x3(const void* x, const void* w, void* y, int n, int h, int wd,
                           int c, int co, int frames, int rows, int seg, int tiles_per_row,
                           int blocks, int dtype, void* stream) {
  return dispatch<false>(x, w, nullptr, y, nullptr, nullptr, nullptr, n, h, wd, c, co, 1,
                         frames, rows, seg, tiles_per_row, blocks, dtype, stream);
}

// As d2v_conv3x3 with bias (Co,) f32 added in f32, and s, ss (batch, Co) f32
// the sums of y and y^2 over each batch row's N / batch frames. partial:
// batch * tiles_per_row * 2 * Co floats of scratch; tiles_per_row is the
// plan's (bf16), or ceil(the row's pixels / D2V_CONV_F32_TILE) (f32).
extern "C" int d2v_conv3x3_bias_stats(const void* x, const void* w, const void* bias,
                                      void* y, void* s, void* ss, void* partial, int n, int h,
                                      int wd, int c, int co, int batch, int frames, int rows,
                                      int seg, int tiles_per_row, int blocks, int dtype,
                                      void* stream) {
  return dispatch<true>(x, w, bias, y, s, ss, partial, n, h, wd, c, co, batch, frames, rows,
                        seg, tiles_per_row, blocks, dtype, stream);
}
