// Tiny-context cross-attention forward for Hopper (sm_90a).
//
// Replaces: dalle2_video_tpu/ops/pallas/cross_attention.py::
// fused_cross_attention (body _kernel), reached through cross_attention.
//
// Computes, per (batch, head), out = softmax(q k^T * scale) v where the
// context holds only m keys (2 time tokens + 4 video tokens + the learned
// null kv = 7 in the base unet, 3 in the SR unet). q and out are
// (b, n, h, d), k and v (b, m, h, d) -- the layout CrossAttention produces,
// so no transpose is needed around the call. bf16 or f32; d = 64 (the
// CrossAttention default) or 32; m <= kMaxM.
//
// What bounds it on the H100: memory. Each (token, head) row reads a
// d-vector of q and writes a d-vector of out against ~4*m*d flops, so the
// kernel should run at the rate the card moves q and out; k and v are tiny.
//
// Design: kLanes = d / 8 threads share one (token, head) row, each owning 8
// consecutive channels, so a warp's q loads and out stores are 16-byte
// vectors over one contiguous span (rows are (token, head) pairs in memory
// order). Each lane forms its 8-channel partial dot product with every key;
// a butterfly of warp shuffles completes the m logits in every lane; the
// softmax runs in registers and each lane accumulates its 8 output
// channels. A block first stages its batch row's whole context (m x h x d
// keys and values, as f32) in shared memory, then walks many row tiles
// (grid-stride), so the context is read once per block. No logits tensor
// ever reaches device memory. (The TPU kernel holds one (b*h) context per
// grid cell; here all heads of a batch row share the block, which keeps
// the (b, n, h, d) layout.)

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxM = 16;
constexpr int kVec = 8;  // channels per lane

template <typename T>
struct Vec8;
template <>
struct Vec8<__nv_bfloat16> {
  using Raw = uint4;  // 8 x bf16
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* f) {
    Raw r = *reinterpret_cast<const Raw*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = __bfloat162float(e[i]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* f) {
    Raw r;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) e[i] = __float2bfloat16(f[i]);
    *reinterpret_cast<Raw*>(p) = r;
  }
};
template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int n,
                       int h, int m, float scale) {
  constexpr int kLanes = D / kVec;  // threads per row (8 at d = 64)
  constexpr int kRowsPerBlock = kThreads / kLanes;
  extern __shared__ float smem[];
  float* ks = smem;  // (m, h, D)
  float* vs = smem + m * h * D;

  const int b = blockIdx.y;
  const size_t ctx = static_cast<size_t>(b) * m * h * D;
  for (int i = threadIdx.x; i < m * h * D; i += kThreads) {
    ks[i] = d2v::to_f(k[ctx + i]);
    vs[i] = d2v::to_f(v[ctx + i]);
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int c0 = lane * kVec;
  const long rows = static_cast<long>(n) * h;
  const size_t batch_off = static_cast<size_t>(b) * rows * D;
  // the loop bound is uniform across the block, so every lane of a warp
  // takes part in every shuffle; rows past the end compute on zeros and
  // store nothing
  for (long tile = static_cast<long>(blockIdx.x) * kRowsPerBlock; tile < rows;
       tile += static_cast<long>(gridDim.x) * kRowsPerBlock) {
    const long row = tile + threadIdx.x / kLanes;
    const bool valid = row < rows;
    const int head = static_cast<int>(row % h);
    const size_t base = batch_off + static_cast<size_t>(row) * D + c0;
    float qr[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (valid) Vec8<T>::load(q + base, qr);

    float s[kMaxM];
    float smax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        const float* kr = ks + (j * h + head) * D + c0;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kVec; ++c) dot = fmaf(qr[c], kr[c], dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off, kLanes);
        s[j] = dot * scale;
        smax = fmaxf(smax, s[j]);
      }
    }
    float acc[kVec];
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] = 0.f;
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j < m) {
        const float p = __expf(s[j] - smax);
        l += p;
        const float* vr = vs + (j * h + head) * D + c0;
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[c] = fmaf(p, vr[c], acc[c]);
      }
    }
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < kVec; ++c) acc[c] *= inv;
    if (valid) Vec8<T>::store(o + base, acc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int n, int h, int m, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2ull * m * h * D * sizeof(float);
  auto kernel = cross_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int kRowsPerBlock = kThreads / (D / kVec);
  const long rows = static_cast<long>(n) * h;
  long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long cap = (8L * 132 + b - 1) / b;  // ~8 resident blocks per SM in all
  if (blocks > cap) blocks = cap;
  dim3 grid(static_cast<unsigned>(blocks), b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, h, m, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int b, int n, int h, int m, int d, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, b, n, h, m, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, n, h, m, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

D2V_EXPORT_ERROR_STRING

// q, o (b, n, h, d); k, v (b, m, h, d).
extern "C" int d2v_cross_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int b, int n,
                                       int h, int m, int d, int dtype,
                                       float sm_scale, void* stream) {
  if (b <= 0 || n <= 0 || h <= 0 || m <= 0 || m > kMaxM)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == d2v::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, n, h, m, d, sm_scale, s);
  if (dtype == d2v::kFloat32)
    return dispatch_d<float>(q, k, v, o, b, n, h, m, d, sm_scale, s);
  return cudaErrorInvalidValue;
}
