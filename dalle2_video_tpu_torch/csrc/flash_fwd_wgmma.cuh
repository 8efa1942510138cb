// The flash-MQA forward's Hopper mainloop (wgmma + TMA), shared by the
// flash forward (csrc/flash_mqa.cu, row 1), the probes' r2 forward
// (csrc/flash_r2.cu, row 10) and their inner-kv forward (csrc/flash_inner.cu,
// row 11), bf16 only.
//
// Computes what the JAX kernels compute (ops/pallas/flash_mqa.py::
// _flash_mqa_kernel, scripts/perf_r3_probe8.py::_r2_kernel,
// scripts/perf_r3_probe9.py::_inner_kernel): with qs =
// bf16(q * sm_scale), per block of block_k keys the running max moves once,
// m' = max(m, rowmax(qs k^T)); p = bf16(exp(s - m')); acc = acc exp(m - m')
// + p [v | 1] in f32; out = acc_v / l, lse = m + log l. Policies:
//   * row 1 (PAD_ZERO false): keys past n_kv contribute nothing and never
//     enter the max (the JAX kernel's edge padding with a zeroed ones row),
//     so a row stays exact when every logit is below -87;
//   * row 11 (PAD_ZERO true): k is zero-padded to n_span = a multiple of
//     block_k x inner, so a block that holds padding takes logit 0 into its
//     max; its ones entry is 0. chain: as row 1, one max per block_k
//     sub-block. par (PAR): each sub-block j gets its own max m_j, a_j =
//     bf16(exp(s - m_j)) [v | 1], merged at once as acc exp(m - m') + a_j
//     exp(m_j - m') -- the arithmetic of merging them at the end of the
//     JAX step, in the same order;
//   * row 10 (PAD_ZERO and R2): the chain policy over keys zero-padded to
//     a multiple of block_k, q arriving scaled (sm_scale 1: bf16(q 1) =
//     q), but l is the f32 sum of the unrounded p (_r2_kernel's l = l alpha
//     + sum(p)), which a ones column cannot give: each thread keeps its own
//     f32 partials per row, masked with p at keys past n_kv, rescaled with
//     the accumulators once a block and summed over the quad at the end;
//     P V runs at N = d, with no ones group in the V slot. Padded v rows
//     are zero, so _r2_kernel's mask multiply needs nothing more.
//
// What bounds it on the H100: the exponentials (16 a clock per SM): 1.70e10
// at the probe geometry = 4.06 ms, 1.06e9 at the serving shape = 0.254 ms.
// The design:
//   * the exact per-block max is two passes over the block's 128-key
//     tiles: pass 1 is S = qs K^T on wgmma and one fmax a logit; pass 2
//     recomputes S and forms p = ex2((s - m) log2e): s - m is exact near
//     the max, where a rounded m log2e folded into one FFMA would move
//     the large probabilities by a few f32 ulp and flip their bf16
//     rounding more often. The rescale of the accumulators runs once a
//     block;
//   * P, packed to bf16 in registers, is the A operand of one product per
//     16 keys against [V | ones] (N = d + 8): the ones columns give l as
//     the f32 sum of the rounded p, as the JAX ones column does, with no
//     add a logit; a masked key has p = 0, so the ones need no mask;
//   * each tile's P [V | 1] starts from zero and is added to the running
//     sums in f32: a sum over thousands of keys kept in the tensor cores'
//     accumulator drifts by more than a bf16 rounding of the output;
//   * K arrives by TMA (cuTensorMapEncodeTiled, through
//     cudaGetDriverEntryPoint: no -lcuda) into a ring swizzled at the row
//     width (2d bytes); a block's K tiles stay resident for both passes
//     when they fit, else pass 2 streams them again. V arrives in 8-column
//     groups, unswizzled, each V slot followed by its resident ones
//     columns. Rows past n_kv are TMA's zero fill; the kv is shared by
//     every block (0.74 MB a batch row at the serving shape), so it stays
//     in L2;
//   * one producer warpgroup (one thread each for K and V loads) and two
//     consumer warpgroups of 64 query rows each, which take turns (named
//     barriers) to issue pass 2's products, so that one group's
//     exponentials run while the other's products occupy the tensor
//     cores. setmaxnreg moves registers to the consumers at run time;
//     ptxas still allocates the consumer code within the launch bound's
//     168 registers, so a group holds one score tile and waits for its own
//     products before its exponentials (a second score buffer spills).

#pragma once

#include <algorithm>

#include "common.cuh"

namespace d2v {
namespace wg {

constexpr int kTileKeys = 128;  // keys per K / V tile
constexpr int kConsumers = 2;   // consumer warpgroups, 64 query rows each
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
constexpr int kBlockRows = 64 * kConsumers;
constexpr int kVStages = 4;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kExtraBytes = 1024 + 1024;  // alignment, barriers
constexpr int kGroupBytes = kTileKeys * 16;  // 8 columns of a V tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D, bool R2 = false>
struct Layout {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kTileBytes = kTileKeys * kRowBytes;
  // wgmma's layout code for the swizzle whose width is one row (32, 64 or
  // 128 bytes), and the TMA swizzle of the same width
  static constexpr uint64_t kLayout = D == 16 ? 3 : (D == 32 ? 2 : 1);
  static constexpr CUtensorMapSwizzle kSwizzle =
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
              : (D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
  // P [V | ones]: d columns of V, 8 of ones (r2: P V alone)
  static constexpr int kPvN = R2 ? D : D + 8;
  // a V slot: its 8-column groups (128 keys x 16 bytes each, the
  // unswizzled MN-major layout), the last the ones (none for r2)
  static constexpr int kVSlotBytes = kPvN / 8 * kGroupBytes;
  static constexpr int kMaxKStages =
      (kSmemLimit - kExtraBytes - kVStages * kVSlotBytes) / kTileBytes;
};

struct Params {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  float* lse;    // (b, n_q) f32, or null
  int n_q, n_kv;
  int n_span;    // keys the blocks cover: n_kv, or the zero-padded length
  int block_k;   // keys per running-max update, a multiple of kTileKeys
  int k_stages;  // K ring slots
  int resident;  // 1: a block's K tiles stay for both passes
  float sm_scale;
};

// ------------------------------------------------------------ PTX helpers
// the box of a (b, n_kv, d) tensor at (column, key, batch) -> shared
// memory, its bytes reported to bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int key, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
        "r"(col), "r"(key), "r"(batch) : "memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin a register across the asynchronous products: the compiler may
// neither read an accumulator before the wait nor reuse an operand
// register early
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
template <int N>
__device__ __forceinline__ void pin_all(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) pin(r[i]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor: start address, leading / stride byte
// offsets (16-byte units), layout (swizzle) code
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (layout << 62);
}

// ------------------------------------------------------ wgmma, A in registers
// A (64 x 16) per warp w of the group: rows 16w + g and + 8, the m16n8k16 A
// fragment; the accumulator: n8 chunk j in d[4j..4j+3] = (row g, columns
// 8j + 2t, + 1), (row g + 8, the same). accumulate 0 overwrites d.
// d[64] (+)= a (64 x 16, registers) * b (16 x 128, shared memory, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[12] (+)= a (64 x 16, registers) * b (16 x 24, shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n24k16_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[16] (+)= a (64 x 16, registers) * b (16 x 32, shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[20] (+)= a (64 x 16, registers) * b (16 x 40, shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n40k16_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[36] (+)= a (64 x 16, registers) * b (16 x 72, shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n72k16_rs(float* d, const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// acc (+)= P [V | ones], N = d + 8: the last n8 chunk the denominator;
// r2: acc (+)= P V, N = d
template <int D, bool R2>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t b, int acc) {
  constexpr int n = Layout<D, R2>::kPvN;
  static_assert(n == 24 || n == 32 || n == 40 || n == 72, "no wgmma wrapper for this N");
  if constexpr (n == 24) wgmma_m64n24k16_rs(d, a, b, acc);
  if constexpr (n == 32) wgmma_m64n32k16_rs(d, a, b, acc);
  if constexpr (n == 40) wgmma_m64n40k16_rs(d, a, b, acc);
  if constexpr (n == 72) wgmma_m64n72k16_rs(d, a, b, acc);
}

// Issue S = qs K^T for the K tile at ring position `pos` (waiting for its
// load) as one committed group; its result is read after a wg_wait_all.
template <int D>
__device__ __forceinline__ void issue_scores(float* s, uint32_t (*qa)[4], uint8_t* kring,
                                             uint64_t* kfull, uint32_t n_k, uint32_t pos) {
  using L = Layout<D>;
  const uint32_t slot = pos % n_k;
  mbar_wait(&kfull[slot], (pos / n_k) & 1);
  const uint64_t kd = make_desc(kring + slot * L::kTileBytes, 16, 8 * L::kRowBytes, L::kLayout);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_m64n128k16_rs(s, qa[kk], kd + 2 * kk, kk > 0);
  wg_commit();
}

// hand a ring slot back to its producer: one arrival per consumer warp
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// ----------------------------------------------------------------- kernel
// One block: 128 query rows of one batch row; warpgroups 0 and 1 compute
// 64 rows each, warpgroup 2 loads K and V.
template <int D, bool PAD_ZERO, bool PAR, bool R2>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<D, R2>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int n_k = p.k_stages;
  uint8_t* kring = smem;
  uint8_t* vring = kring + n_k * L::kTileBytes;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(vring + kVStages * L::kVSlotBytes);
  uint64_t* kempty = kfull + n_k;
  uint64_t* vfull = kempty + n_k;
  uint64_t* vempty = vfull + kVStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int n_blocks = (p.n_span + p.block_k - 1) / p.block_k;
  // 128-key tiles of block bi that hold a real key
  auto tiles = [&](int bi) {
    const int k0 = bi * p.block_k, k1 = min(k0 + p.block_k, p.n_kv);
    return k1 > k0 ? (k1 - k0 + kTileKeys - 1) / kTileKeys : 0;
  };

  if (tid == 0) {
    for (int i = 0; i < n_k; ++i) {
      mbar_init(&kfull[i], 1);
      mbar_init(&kempty[i], 4 * kConsumers);  // one arrival per consumer warp
    }
    for (int i = 0; i < kVStages; ++i) {
      mbar_init(&vfull[i], 1);
      mbar_init(&vempty[i], 4 * kConsumers);
    }
    mbar_init_fence();
  }
  for (int i = tid; !R2 && i < kVStages * kGroupBytes / 4; i += kThreads) {  // the ones columns
    const int slot = i / (kGroupBytes / 4), w = i % (kGroupBytes / 4);
    reinterpret_cast<uint32_t*>(vring + slot * L::kVSlotBytes + L::kTileBytes)[w] = 0x3F803F80u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ones -> wgmma
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = (tid - kConsumerThreads) / 32;
    if (warp < 2 && tid % 32 == 0) {
      const bool is_k = warp == 0;
      const CUtensorMap* map = is_k ? &tm_k : &tm_v;
      uint8_t* ring = is_k ? kring : vring;
      uint64_t* full = is_k ? kfull : vfull;
      uint64_t* empty = is_k ? kempty : vempty;
      const uint32_t stages = is_k ? n_k : kVStages;
      const uint32_t slot_bytes = is_k ? L::kTileBytes : L::kVSlotBytes;
      uint32_t n = 0;
      for (int bi = 0; bi < n_blocks; ++bi) {
        const int t = tiles(bi);
        // pass 2 reads K again: from the ring when resident, else loaded twice
        const int loads = (is_k && !p.resident) ? 2 * t : t;
        for (int i = 0; i < loads; ++i, ++n) {
          const uint32_t slot = n % stages;
          mbar_wait(&empty[slot], ((n / stages) & 1) ^ 1);
          mbar_expect_tx(&full[slot], L::kTileBytes);
          const int key = bi * p.block_k + (i % t) * kTileKeys;
          if (is_k) {
            tma_load(ring + slot * slot_bytes, map, &full[slot], 0, key, b);
          } else {  // V by 8-column groups
            for (int j = 0; j < D / 8; ++j)
              tma_load(ring + slot * slot_bytes + j * kGroupBytes, map, &full[slot], 8 * j, key, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid % 128;
    const int warp = ct / 32, lane = ct % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = blockIdx.x * kBlockRows + (tid / 128) * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    const __nv_bfloat16* qb = p.q + static_cast<size_t>(b) * p.n_q * D;

    // qs = bf16(q * sm_scale), straight into the A fragments
    uint32_t qa[D / 16][4];
    auto ldq = [&](int row, int col) -> uint32_t {
      if (row >= p.n_q) return 0u;
      const __nv_bfloat162 v =
          *reinterpret_cast<const __nv_bfloat162*>(qb + static_cast<size_t>(row) * D + col);
      return pack_bf16(__low2float(v) * p.sm_scale, __high2float(v) * p.sm_scale);
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = ldq(r0, c);
      qa[kk][1] = ldq(r1, c);
      qa[kk][2] = ldq(r0, c + 8);
      qa[kk][3] = ldq(r1, c + 8);
    }

    // o: the running P [V | 1] (its chunk d / 8 the denominator l); pt: one
    // tile's, added to it in f32. r2: o the running P V, and ls this
    // thread's f32 partial sums of the unrounded p (rows g, g + 8, two
    // chains each), rescaled with o and summed over the quad at the end
    constexpr int kAcc = L::kPvN / 2;
    float o[kAcc], pt[L::kPvN / 2];
    float ls[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t pa[8][4];  // P of the tile in flight, read by its product
    float s[64];        // one tile's scores, then its probabilities
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max (natural log units)
    uint32_t kn = 0, vn = 0;  // ring positions consumed

    // The two groups take turns (named barriers 1 and 2, group 0 first) to
    // issue pass 2's products.
    const int wgi = tid / 128;
#define D2V_TURN(...)                                                   \
  do {                                                                  \
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wgi) : "memory");      \
    __VA_ARGS__;                                                        \
    asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wgi) : "memory");    \
  } while (0)
    if (wgi == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // group 0 first

    for (int bi = 0; bi < n_blocks; ++bi) {
      const int nt = tiles(bi);
      const int key0 = bi * p.block_k;
      const uint32_t k1 = p.resident ? kn : kn + nt;  // K positions of pass 2

      // ---- pass 1: the block's row max over its real keys
      float mx[8];  // 4 chains a row
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i] = -INFINITY;
      for (int tt = 0; tt < nt; ++tt) {
        issue_scores<D>(s, qa, kring, kfull, n_k, kn + tt);
        wg_wait_all();
        pin_all<64>(s);
        if (!p.resident) release(&kempty[(kn + tt) % n_k], lane);
        const int real = p.n_kv - (key0 + tt * kTileKeys);  // < 128: the tail tile
        if (real < kTileKeys) {
#pragma unroll
          for (int i = 0; i < 64; ++i)
            if (8 * (i / 4) + 2 * t4 + (i & 1) >= real) s[i] = -INFINITY;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float& m = mx[(i & 2) * 2 + (i / 4) % 4];
          m = fmaxf(m, s[i]);
        }
      }
      float mx0 = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
      float mx1 = fmaxf(fmaxf(mx[4], mx[5]), fmaxf(mx[6], mx[7]));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if (PAD_ZERO && key0 + p.block_k > p.n_kv) {  // zero-padded keys: logit 0
        mx0 = fmaxf(mx0, 0.f);
        mx1 = fmaxf(mx1, 0.f);
      }
      // the new running max m'; p = exp(s - ref) with ref = m' (row 1,
      // chain) or the sub-block's own max (par); each tile's product is
      // added with weight aj = exp(ref - m'), the running sums rescaled
      // once by am = exp(m - m')
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ref0 = PAR ? mx0 : mn0, ref1 = PAR ? mx1 : mn1;
      const float am0 = ex2((m0 - mn0) * kLog2e), am1 = ex2((m1 - mn1) * kLog2e);
      const float aj0 = PAR ? ex2((mx0 - mn0) * kLog2e) : 1.f;
      const float aj1 = PAR ? ex2((mx1 - mn1) * kLog2e) : 1.f;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) o[i] *= (i & 2) ? am1 : am0;
      if (R2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) ls[i] *= (i & 2) ? am1 : am0;
      }
      m0 = mn0;
      m1 = mn1;

      // ---- pass 2: the probabilities and P [V | 1]. A step waits for its
      // S and the previous tile's product (no register of a product in
      // flight is written, or ptxas serializes the products), forms and
      // packs P, then issues the next tile's S and this tile's product.
      auto add_tile = [&]() {  // the finished tile product into the running sums
        pin_all<L::kPvN / 2>(pt);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
#pragma unroll
          for (int h = 0; h < 4; ++h) pin(pa[kk][h]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) o[i] = fmaf(pt[i], (i & 2) ? aj1 : aj0, o[i]);
        release(&vempty[(vn - 1) % kVStages], lane);
      };
      if (nt > 0) {
        D2V_TURN(issue_scores<D>(s, qa, kring, kfull, n_k, k1));
        for (int tt = 0; tt < nt; ++tt) {
          wg_wait_all();  // S(tt) and P V(tt - 1)
          pin_all<64>(s);
          release(&kempty[(k1 + tt) % n_k], lane);
          if (tt > 0) add_tile();
#pragma unroll
          for (int i = 0; i < 64; ++i) s[i] = ex2((s[i] - ((i & 2) ? ref1 : ref0)) * kLog2e);
          const int real = p.n_kv - (key0 + tt * kTileKeys);
          if (real < kTileKeys) {  // the tail tile: keys past n_kv give 0
#pragma unroll
            for (int i = 0; i < 64; ++i)
              if (8 * (i / 4) + 2 * t4 + (i & 1) >= real) s[i] = 0.f;
          }
          if (R2) {  // the denominator: the f32 sum of the unrounded p
#pragma unroll
            for (int i = 0; i < 64; ++i) ls[(i & 2) | ((i >> 2) & 1)] += s[i];
          }
#pragma unroll
          for (int kk = 0; kk < 8; ++kk)
#pragma unroll
            for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
          const uint32_t vslot = vn % kVStages;
          // unswizzled MN-major B: 8 x 8 core matrices of 128 bytes, the
          // next 8 keys 128 bytes on, the next 8 columns a group (2 KB) on
          const uint64_t vd = make_desc(vring + vslot * L::kVSlotBytes, 128, kGroupBytes, 0);
          D2V_TURN(
              if (tt + 1 < nt) issue_scores<D>(s, qa, kring, kfull, n_k, k1 + tt + 1);
              mbar_wait(&vfull[vslot], (vn / kVStages) & 1);
              wg_fence();
              _Pragma("unroll") for (int kk = 0; kk < 8; ++kk)
                  wgmma_pv<D, R2>(pt, pa[kk], vd + kk * (256 >> 4), kk > 0);
              wg_commit());
          ++vn;
        }
        wg_wait_all();
        add_tile();
      }
      kn += p.resident ? nt : 2 * nt;
    }
    if (wgi == 0) asm volatile("bar.sync 1, 256;\n" ::: "memory");  // group 1's last hand-over
#undef D2V_TURN

    // out = acc_v / l (every column of the ones chunk holds l), lse = m + log l
    float l0, l1;
    if constexpr (R2) {
      l0 = ls[0] + ls[1];
      l1 = ls[2] + ls[3];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
    } else {
      l0 = o[D / 2];
      l1 = o[D / 2 + 2];
    }
    __nv_bfloat16* ob = p.o + static_cast<size_t>(b) * p.n_q * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r0 < p.n_q)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * D + c) =
            pack_bf16(o[4 * j] / l0, o[4 * j + 1] / l0);
      if (r1 < p.n_q)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * D + c) =
            pack_bf16(o[4 * j + 2] / l1, o[4 * j + 3] / l1);
    }
    if (p.lse != nullptr && t4 == 0) {
      float* lb = p.lse + static_cast<size_t>(b) * p.n_q;
      if (r0 < p.n_q) lb[r0] = m0 + logf(l0);
      if (r1 < p.n_q) lb[r1] = m1 + logf(l1);
    }
  }
}

// ------------------------------------------------------------------- host
// A 3-D map of a (b, n_kv, d) bf16 tensor, box (width, 128, 1); rows past
// n_kv read as zero.
template <int D>
inline cudaError_t encode_kv_map(CUtensorMap* map, const void* base, int b, int n_kv, int width,
                                 CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(n_kv),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(2 * D),
                                 static_cast<cuuint64_t>(2 * D) * n_kv};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(width), kTileKeys, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Shared memory of one block with `k_stages` K slots.
template <int D, bool R2>
constexpr int smem_bytes(int k_stages) {
  return kExtraBytes + k_stages * Layout<D, R2>::kTileBytes +
         kVStages * Layout<D, R2>::kVSlotBytes;
}

// q, o (b, n_q, D); k, v (b, n_kv, D); all bf16. n_span: the keys the
// blocks cover (n_kv, or the zero-padded length under PAD_ZERO).
template <int D, bool PAD_ZERO, bool PAR, bool R2 = false>
cudaError_t launch_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int b, int n_q, int n_kv, int n_span, int block_k, float sm_scale,
                             cudaStream_t stream) {
  if (block_k <= 0 || block_k % kTileKeys != 0) return cudaErrorInvalidValue;
  const int per_block = block_k / kTileKeys;
  const int k_stages = std::min(per_block, Layout<D, R2>::kMaxKStages);
  // K: whole rows, swizzled at the row width; V: 8-column groups, unswizzled
  CUtensorMap tk, tv;
  cudaError_t err = encode_kv_map<D>(&tk, k, b, n_kv, D, Layout<D>::kSwizzle);
  if (err == cudaSuccess) err = encode_kv_map<D>(&tv, v, b, n_kv, 8, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.n_q = n_q;
  p.n_kv = n_kv;
  p.n_span = n_span;
  p.block_k = block_k;
  p.k_stages = k_stages;
  p.resident = k_stages == per_block;
  p.sm_scale = sm_scale;
  const int smem = smem_bytes<D, R2>(k_stages);
  auto* kern = flash_fwd_wgmma_kernel<D, PAD_ZERO, PAR, R2>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_q + kBlockRows - 1) / kBlockRows, b);
  kern<<<grid, kThreads, smem, stream>>>(tk, tv, p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace d2v
