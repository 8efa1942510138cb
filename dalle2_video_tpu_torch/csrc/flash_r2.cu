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
//     mask after the exponential -- every tile takes the mask multiply;
//   * the running max moves once per block_k keys, as in the JAX kernel:
//     on the bf16 path a max pass over the block's 64-key tiles runs before
//     its exponentials, recomputing Q K^T (the block's keys are staged
//     twice), and the accumulators are rescaled once per block;
//   * the denominator is an explicit row sum of the f32 probabilities (over
//     the 4 lanes of an mma group on the bf16 path), kept as its own state
//     l = l * alpha + rowsum(p).
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
// bytes 0.03 ms. A block of 4 warps owns 64 query rows, mma.sync m16n8k16
// for both products, S in the accumulator layout reused as P's A operand,
// p = 2^((s - m) log2 e); each tile's P V starts from zero and is added in
// f32 (a sum over thousands of keys in the mma accumulator drifts past a
// bf16 rounding); the kv stays in L2.
// f32 inputs take a CUDA-core kernel (one query row per thread, 16-key
// chunks), exact in f32, for checks.

#include "common.cuh"

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

// ---------------------------------------------------------------- bf16 / mma
constexpr int kWarps = 4;
constexpr int kBlockRows = kWarps * 16;
constexpr int kKv = 64;  // keys per shared-memory tile (the bf16 tile)

using d2v::mma_bf16;
using d2v::pack_bf16;

__global__ void __launch_bounds__(kWarps * 32)
r2_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int n_q, int n_kv, int block_k) {
  constexpr int KP = kD + 8;   // padded K row (elements)
  constexpr int VP = kKv + 8;  // padded V^T row (elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kKv * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[kD * VP];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // mma group: rows g and g + 8
  const int t = lane & 3;   // lane in group: columns 2t, 2t + 1
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kBlockRows + warp * 16 + g;
  const int r1 = r0 + 8;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * n_q * kD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * n_kv * kD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * n_kv * kD;

  auto ld2 = [&](int row, int col) -> uint32_t {
    if (row >= n_q) return 0u;
    return *reinterpret_cast<const uint32_t*>(qb + static_cast<size_t>(row) * kD + col);
  };
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ld2(r0, c);
    qa[kk][1] = ld2(r1, c);
    qa[kk][2] = ld2(r0, c + 8);
    qa[kk][3] = ld2(r1, c + 8);
  }
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, rows r0 / r1
  float l0 = 0.f, l1 = 0.f;              // running row sums, whole rows

  // Stage the tile at kv0 (K, and V transposed when with_v), zero-padded
  // past the tail, and return S = Q K^T.
  auto tile_scores = [&](int kv0, bool with_v, float (*s)[4]) {
    const int tile = min(kKv, n_kv - kv0);
    __syncthreads();
    for (int i = threadIdx.x; i < kKv * kD / 8; i += kWarps * 32) {
      const int r = i / (kD / 8);
      const int c = (i % (kD / 8)) * 8;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (r < tile) {  // past the tail: the zero padding
        const size_t off = static_cast<size_t>(kv0 + r) * kD + c;
        kr = *reinterpret_cast<const uint4*>(kb + off);
        if (with_v) vr = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(ks + r * KP + c) = kr;
      if (with_v) {
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vr);
#pragma unroll
        for (int e = 0; e < 8; ++e) vt[(c + e) * VP + r] = ve[e];
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKv / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * j + g) * KP + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
  };

  const int n_pad = (n_kv + block_k - 1) / block_k * block_k;
  for (int blk = 0; blk < n_pad; blk += block_k) {
    const int end = min(blk + block_k, n_kv);  // the block's real keys end here
    // pass 1: the block's max over every column, padded zeros included
    float mx0 = blk + block_k > n_kv ? 0.f : -INFINITY;  // a padded column: logit 0
    float mx1 = mx0;
    for (int kv0 = blk; kv0 < end; kv0 += kKv) {
      float s[kKv / 8][4];
      tile_scores(kv0, false, s);
#pragma unroll
      for (int j = 0; j < kKv / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f((m0 - mn0) * kLog2e), a1 = exp2f((m1 - mn1) * kLog2e);  // once a block
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    l0 *= a0;
    l1 *= a1;
    m0 = mn0;
    m1 = mn1;
    // pass 2: p = exp(s - m) * kvmask (as 2^((s - m) log2 e): s - m is
    // exact near the max), its row sums, and P V
    for (int kv0 = blk; kv0 < end; kv0 += kKv) {
      const int tile = min(kKv, n_kv - kv0);
      float s[kKv / 8][4];
      tile_scores(kv0, true, s);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < kKv / 8; ++j) {
        const float k0 = 8 * j + 2 * t < tile ? 1.f : 0.f;
        const float k1 = 8 * j + 2 * t + 1 < tile ? 1.f : 0.f;
        s[j][0] = exp2f((s[j][0] - mn0) * kLog2e) * k0;
        s[j][1] = exp2f((s[j][1] - mn0) * kLog2e) * k1;
        s[j][2] = exp2f((s[j][2] - mn1) * kLog2e) * k0;
        s[j][3] = exp2f((s[j][3] - mn1) * kLog2e) * k1;
        ls0 += s[j][0] + s[j][1];
        ls1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ls0 += __shfl_xor_sync(0xffffffffu, ls0, off);
        ls1 += __shfl_xor_sync(0xffffffffu, ls1, off);
      }
      l0 += ls0;
      l1 += ls1;
      // the tile's P V from zero, then added in f32: a sum over thousands of
      // keys kept in the mma accumulator drifts past a bf16 rounding
      float pt[kD / 8][4];
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) pt[n][0] = pt[n][1] = pt[n][2] = pt[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKv / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kD / 8; ++n) {
          const __nv_bfloat16* vr = vt + (8 * n + g) * VP + kk * 16 + 2 * t;
          mma_bf16(pt[n], pa, *reinterpret_cast<const uint32_t*>(vr),
                   *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += pt[n][e];
    }
  }

  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * n_q * kD;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    if (r0 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * kD + c) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < n_q)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * kD + c) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q (b, n_q, 32) already scaled, k and v (b, n_kv, 32), o like q; block_k:
// keys per running-max update of the bf16 kernel (a multiple of its 64-key
// tile), the zero padding reaching a multiple of it.
extern "C" int d2v_flash_r2_fwd(const void* q, const void* k, const void* v,
                                void* o, int b, int n_q, int n_kv, int dtype,
                                int block_k, void* stream) {
  if (b <= 0 || n_q <= 0 || n_kv <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16) {
    if (block_k <= 0 || block_k % kKv != 0) return cudaErrorInvalidValue;
    dim3 grid((n_q + kBlockRows - 1) / kBlockRows, b);
    r2_mma_kernel<<<grid, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), n_q, n_kv,
        block_k);
  } else if (dtype == d2v::kFloat32) {
    dim3 grid((n_q + kRows - 1) / kRows, b);
    r2_f32_kernel<<<grid, kRows, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), n_q, n_kv);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
