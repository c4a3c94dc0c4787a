// wgmma building blocks shared by the bf16 attention kernels
// (attention.cu, attention_bwd.cu) and the bf16 gemm (gemm.cu):
// warpgroups of 64 rows, 128-byte-swizzled shared tiles written by
// cp.async or TMA, wgmma.m64nNk16 products (N 64, 128) with the
// accumulators (and the A operand of the attention's second product) in
// registers, mbarriers, and the bias, max and sum helpers that run on the
// accumulator layout.  A tile of HDP head columns (64, 80, 96 or 128; the
// head dim padded with zeros up to it) is HDP / 64 panels of 64 columns in
// the 128-byte swizzle (one 128-byte line a row), then for HDP 80 and 96 a
// tail panel of 16 or 32 columns in the 32- or 64-byte swizzle.
#pragma once

#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include <atomic>

#include <cuda.h>  // CUtensorMap (types only: nothing links libcuda)

#include "common.cuh"

constexpr int WG_ROWS = 64;      // rows per warpgroup (wgmma's M)
constexpr int WG_GROUPS = 2;     // the forward's warpgroups per block
constexpr int WG_Q = WG_ROWS * WG_GROUPS;  // rows per block
constexpr int WG_THREADS = 128 * WG_GROUPS;

constexpr float VC_LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit: one MUFU.EX2 (relative error about
// 2^-22, results below 2^-126 flushed to 0)
__device__ __forceinline__ float vc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(x) as 2^(x log2 e): one multiply and one MUFU.EX2 where expf takes
// about ten instructions.  It may differ from expf in the last bits; the
// bf16 outputs stay at least 99% bit-equal to the plain version's
// (chip_smoke.py checks every bf16 row).
__device__ __forceinline__ float vc_exp(float x) {
  return vc_exp2(x * VC_LOG2E);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  // bytes 0: the 16 bytes at dst are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) -> visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_wait0() { wg_wait<0>(); }
// keeps the compiler from moving accesses to an accumulator across the
// asynchronous wgmma that reads and writes it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (each >> 4), the swizzle in bits 62-63 (1: 128
// bytes, 2: 64, 3: 32)
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, uint64_t mode) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return desc_sw(addr, lbo, sbo, 1);
}

// The head-dim panels of a tile of HDP columns and ROWS rows: FULL panels
// of 64 columns, ROWS x 128 bytes each in the 128-byte swizzle, then (HDP
// 80, 96) a tail panel of TAIL columns, ROWS x TB bytes in the TB-byte
// swizzle.  Each swizzle XORs the 16-byte unit of a row with address bits
// 7 and up, so every panel of a 1024-byte aligned tile starts on its
// pattern.
template <int HDP>
struct Panels {
  static constexpr int FULL = HDP / 64;
  static constexpr int TAIL = HDP % 64;      // 0, 16 or 32 columns
  static constexpr int TB = 2 * TAIL;        // its row bytes
  static constexpr uint64_t TMODE = TAIL == 16 ? 3 : 2;  // 32 / 64 bytes
  static_assert(TAIL == 0 || TAIL == 16 || TAIL == 32, "HDP 64, 80, 96, 128");
  // byte offset of row r's 16-byte unit c (c < HDP / 8)
  template <int ROWS>
  __device__ __forceinline__ static uint32_t unit(int r, int c) {
    if constexpr (TAIL != 0) {
      if (c >= 8 * FULL)
        return FULL * (ROWS * 128) + r * TB +
               (((c - 8 * FULL) ^ (r / (128 / TB) % (TB / 16))) << 4);
    }
    return (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
  }
};

#define WG_D8(o)                                                       \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define WG_REGS32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d (+)= A . B, 64 x 64 x 16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define WG_D32(o) WG_D8(o), WG_D8(o + 8), WG_D8(o + 16), WG_D8(o + 24)
#define WG_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"

// d (+)= A . B, 64 x 128 x 16, A and B K-major in shared memory (the
// gemm's A rows and W rows); the accumulator layout is the 64 x 64 one's,
// eight columns per j: d[4 j + 2 i + c] is (row 16 w + ln / 4 + 8 i,
// column 8 j + 2 (ln % 4) + c), j < 16
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D32(0), WG_D32(32)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B over one 64-deep k-step of 128-byte-swizzled K-major tiles:
// this warpgroup's 64 A rows at sa, the B tile's 128 rows at sb (both
// 1024-byte aligned, 8-row groups 1024 bytes apart); each 16-deep step is
// 32 bytes further into the 128-byte lines.  The caller fences, commits
// and waits.
__device__ __forceinline__ void ss_kstep(float (&d)[64], uint32_t sa,
                                         uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, desc_sw128(sa + kk * 32, 16, 1024),
             desc_sw128(sb + kk * 32, 16, 1024), 1);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA and register reallocation (the gemm's producer/consumer
// ring)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also announces `bytes` of TMA transfers to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// blocks until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// the box of `map` at element coordinates (c0 innermost, c1) -> shared
// memory at dst, completion counted in bytes on `bar`; out-of-bounds
// elements arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// d += A . B, 64 x 16 x 16 and 64 x 32 x 16 (an attention tile's tail
// panel), A from registers, B MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_t(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : WG_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_t(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B, 64 x 64 x 16, A from registers (four bf16 pairs per thread),
// B MN-major (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// rows [r0, r0 + ROWS) of one head's hd columns -> the swizzled tile at
// shared address dst by cp.async (the block's THREADS threads sharing the
// copies), zero-filled past `valid` rows and past hd columns.  Row r's
// 16-byte chunk c lands at Panels<HDP>::unit<ROWS>(r, c): in a panel of 64
// columns at r * 128 + ((c % 8) ^ (r % 8)) * 16 of that panel.
template <int HDP, int ROWS, int THREADS = WG_THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long sr, int r0, int valid,
                                          int hd) {
  constexpr int CH = HDP / 8;  // 16-byte chunks per row
  constexpr int N = ROWS * CH;
#pragma unroll
  for (int it = 0; it < (N + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (N % THREADS && i >= N) break;
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < valid && c * 8 < hd;
    const bf16* p = ok ? src + (size_t)(r0 + r) * sr + c * 8 : src;
    cp_async16(dst + Panels<HDP>::template unit<ROWS>(r, c), p, ok ? 16 : 0);
  }
}

// Issues s[n] (+)= rows [arow, arow + 64) of the A tile (AROWS x HDP at
// sa) . rows [64 n, 64 n + 64) of the B tile (KT x HDP at sb) as columns,
// both K-major: a k-step of 16 columns is 32 bytes into a panel's line,
// 8-row groups 8 lines apart (1024 bytes in a 64-column panel, 256 or 512
// in a tail panel of 16 or 32 columns).  The caller fences, commits and
// waits, so several products can share one wait.
template <int HDP, int KT, int AROWS = WG_Q>
__device__ __forceinline__ void ss_issue(float (&s)[KT / 64][32],
                                         uint32_t sa, uint32_t sb,
                                         int arow = 0) {
  using P = Panels<HDP>;
#pragma unroll
  for (int n = 0; n < KT / 64; ++n)
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (kk < 4 * P::FULL) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss(s[n],
                 desc_sw128(sa + (kk / 4) * (AROWS * 128) + arow * 128 + col,
                            16, 1024),
                 desc_sw128(sb + (kk / 4) * (KT * 128) + n * 64 * 128 + col,
                            16, 1024),
                 kk > 0);
      } else {
        const uint32_t col = (kk - 4 * P::FULL) * 32;
        wgmma_ss(s[n],
                 desc_sw(sa + P::FULL * (AROWS * 128) + arow * P::TB + col,
                         16, 8 * P::TB, P::TMODE),
                 desc_sw(sb + P::FULL * (KT * 128) + n * 64 * P::TB + col,
                         16, 8 * P::TB, P::TMODE),
                 1);
      }
    }
}

// s = q . k^T as one waited product: ss_issue between the fences, this
// warpgroup's rows [arow, arow + 64) of the q tile at sq
template <int HDP, int KT>
__device__ __forceinline__ void qk_product(float (&s)[KT / 64][32],
                                           uint32_t sq, uint32_t sk,
                                           int arow) {
#pragma unroll
  for (int n = 0; n < KT / 64; ++n) fence_regs(s[n]);
  wg_fence();
  ss_issue<HDP, KT>(s, sq, sk, arow);
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int n = 0; n < KT / 64; ++n) fence_regs(s[n]);
}

// d += p . V[:, 64 np : 64 np + 64] over the tile's KT rows: p in
// registers (k-step ks: four bf16 pairs), V (KT x HDP at sv) the MN-major
// B operand: a k-step of 16 rows is 2048 bytes on, 8-row groups 1024
// bytes apart, panels of 64 columns KT * 128 bytes apart
template <int KT>
__device__ __forceinline__ void pv_product(float (&d)[32],
                                           const uint32_t (&p)[KT / 16][4],
                                           uint32_t sv, int np) {
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks)
    wgmma_rs_t(d, p[ks],
               desc_sw128(sv + np * (KT * 128) + ks * 16 * 128, KT * 128,
                          1024));
}

// d += p . V[:, 64 FULL : HDP] over the tile's KT rows (HDP 80, 96): V's
// tail panel at sv (KT rows of TB bytes) the MN-major B operand, N = TAIL
// columns: a k-step of 16 rows is 16 TB bytes on, 8-row groups 8 TB
// bytes apart
template <int HDP, int KT>
__device__ __forceinline__ void pv_tail(float (&d)[Panels<HDP>::TAIL / 2],
                                        const uint32_t (&p)[KT / 16][4],
                                        uint32_t sv) {
  using P = Panels<HDP>;
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks)
    wgmma_rs_t(d, p[ks],
               desc_sw(sv + ks * 16 * P::TB, KT * P::TB, 8 * P::TB,
                       P::TMODE));
}

// The accumulator layout of a 64 x 64 wgmma tile: thread (warp w of the
// warpgroup, lane ln) holds d[4 j + 2 i + c] = element (row 16 w + ln / 4
// + 8 i, column 8 j + 2 (ln % 4) + c), j < 8, i, c < 2.  The A operand of
// a 16-column k-step takes the same pairs: columns 16 kk .. 16 kk + 15
// are d[8 kk .. 8 kk + 7], packed two by two.

// this thread's f32 bias at keys kc + 8 jj + {0, 1} (jj < KT / 8) of its
// rows i = 0, 1: bv[i][2 jj + c]; 0 at and past l_actual (checked on the
// EDGE tile only).  A group of four lanes reads 32 contiguous bytes of one
// row (float2s when the rows are 8-byte aligned).
template <int KT, bool EDGE>
__device__ __forceinline__ void load_bias(float (&bv)[2][KT / 4],
                                          const float* const (&brow)[2],
                                          int kc, int l_actual, bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj) {
      const int kg = kc + 8 * jj;
      float2 x = make_float2(0.0f, 0.0f);
      if (brow[i] && (!EDGE || kg < l_actual)) {
        if (vec) {
          x = __ldg(reinterpret_cast<const float2*>(brow[i] + kg));
        } else {
          x.x = __ldg(brow[i] + kg);
          if (!EDGE || kg + 1 < l_actual) x.y = __ldg(brow[i] + kg + 1);
        }
      }
      bv[i][2 * jj] = x.x;
      bv[i][2 * jj + 1] = x.y;
    }
}

template <int KT>
__device__ __forceinline__ void load_bias(float (&bv)[2][KT / 4],
                                          const float* const (&brow)[2],
                                          int kc, int l_actual, bool vec,
                                          bool edge) {
  if (edge)
    load_bias<KT, true>(bv, brow, kc, l_actual, vec);
  else
    load_bias<KT, false>(bv, brow, kc, l_actual, vec);
}

// s = s [* scale] [+ bias], keys at or past l_actual set to `neg` (on the
// EDGE tile only); the products and sums rounded one by one, as the plain
// version's separate operations round them
template <int KT, bool SCALE, bool BIAS, bool EDGE>
__device__ __forceinline__ void finish_scores(float (&s)[KT / 64][32],
                                              const float (&bv)[2][KT / 4],
                                              float scale, int kc,
                                              int l_actual, float neg) {
#pragma unroll
  for (int n = 0; n < KT / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int j = e / 4, i = (e / 2) % 2, c = e % 2;
      float x = s[n][e];
      if (SCALE) x = __fmul_rn(x, scale);
      if (BIAS) x = __fadd_rn(x, bv[i][2 * (8 * n + j) + c]);
      s[n][e] = !EDGE || kc + 64 * n + 8 * j + c < l_actual ? x : neg;
    }
}

template <int KT, bool SCALE, bool BIAS>
__device__ __forceinline__ void finish_scores(float (&s)[KT / 64][32],
                                              const float (&bv)[2][KT / 4],
                                              float scale, int kc,
                                              int l_actual, float neg,
                                              bool edge) {
  if (edge)
    finish_scores<KT, SCALE, BIAS, true>(s, bv, scale, kc, l_actual, neg);
  else
    finish_scores<KT, SCALE, BIAS, false>(s, bv, scale, kc, l_actual, neg);
}

// max over the row of the accumulator tile: own values, then the group of
// four lanes
template <int KT>
__device__ __forceinline__ float row_max(const float (&s)[KT / 64][32],
                                         int i, float init) {
  float x = init;
#pragma unroll
  for (int n = 0; n < KT / 64; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x = fmaxf(x, fmaxf(s[n][4 * j + 2 * i], s[n][4 * j + 2 * i + 1]));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x: low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// the bias rows of this thread's two query rows (null past Lp or without a
// bias) and whether they can be read as float2s
struct BiasRows {
  const float* row[2];
  bool vec;
  __device__ __forceinline__ BiasRows(const Bias& bias, int b, int h,
                                      int row0, int Lp) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      row[i] = row0 + 8 * i < Lp ? bias.row(b, h, row0 + 8 * i, Lp)
                                 : nullptr;
    vec = !(Lp & 1) && !(reinterpret_cast<uintptr_t>(bias.p) & 7) &&
          !(bias.sb & 1) && !(bias.sh & 1);
  }
};

// A block of warpgroups, each 64 consecutive rows (queries, or keys in the
// key-major backward) of one head, sharing the tiles of the other side
// (WG_GROUPS of them in the forward, one in the backward).  The thread's
// place in it.
struct WgThread {
  int wg, row0, cq;  // warpgroup, first of its two rows, first column
  __device__ __forceinline__ WgThread(int q0) {
    const int lane = threadIdx.x % 32;
    wg = threadIdx.x / 128;
    row0 = q0 + wg * WG_ROWS + (threadIdx.x / 32 % 4) * 16 + lane / 4;
    cq = 2 * (lane % 4);
  }
};

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Lets `kernel` take `bytes` of dynamic shared memory (needed above 48 KB),
// once per device: `done` holds one bit per device, a static of the
// caller's template instance.
static inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                                     std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return e;
}

// a wgmma kernel as the measurement scripts list it
struct WgKernel {
  const char* name;
  const void* fn;
  int threads;  // per block
  size_t smem;  // dynamic shared memory per block
};

// Kernel `index` of `kernels`: its name into name[0 .. len), and info =
// {threads per block, registers per thread, local (spill) bytes per
// thread, shared bytes per block (static + dynamic), resident blocks per
// SM} on the current device.  Returns -1 past the last kernel, else a
// cudaError_t.
static inline int wg_kernel_info(const WgKernel* kernels, int count,
                                 int index, char* name, int len, int* info) {
  if (index < 0 || index >= count) return -1;
  const WgKernel& kn = kernels[index];
  snprintf(name, len, "%s", kn.name);
  cudaError_t e = cudaFuncSetAttribute(
      kn.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kn.smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kn.fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kn.fn,
                                                    kn.threads, kn.smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = kn.threads;
  info[1] = a.numRegs;
  info[2] = (int)a.localSizeBytes;
  info[3] = (int)(a.sharedSizeBytes + kn.smem);
  info[4] = blocks;
  return 0;
}
