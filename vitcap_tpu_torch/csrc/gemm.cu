// gemm: out(M, N) = A(M, K) . W(N, K)^T with f32 accumulation and a fused
// epilogue (+ bias, exact-erf GELU, + residual, store in the compute dtype
// or in f32), rounded where the TPU kernels round:
// - default (_qkv_kernel, _tail_kernel, _bert_qkv_kernel): the product is
//   rounded to the compute dtype, then the residual and the bias (itself
//   rounded) are added in the compute dtype, and GELU reads that value;
// - f32_sum (_bert_tail_kernel): the bias and the residual are added to the
//   f32 product; GELU reads the sum rounded to the compute dtype; out_f32
//   stores the f32 sum for the post-LayerNorm;
// - bias_first (_bert_tail_train_kernel, K7, the BERT train tail): the
//   product and the bias are each rounded and added in the compute dtype,
//   then hidden dropout (keep ? t * round(1 / (1 - rate)) : 0, in the
//   compute dtype; keep bit vc_dropout_keep(row % rows_per_image, column,
//   seed, 2 * image + which)), then the residual is added in the compute
//   dtype.
// `pre`, when given, also stores the value GELU reads (the pre-GELU fc1
// output that the train backwards of K6 and K7 keep).  epi_math holds that
// order once for every kernel.
//
// Replaces the matrix products inside the TPU kernels of
// vitcap_tpu/ops/fused_block.py: _qkv_kernel (:150, qkv), _tail_kernel
// (:235: proj, fc1, fc2), _bert_qkv_kernel (:534, fused q/k/v),
// _bert_tail_kernel (:604: out-dense, intermediate, output), the train
// kernels _qkv_train_kernel (:1381), _tail_train_stats_kernel (:1398) and
// _bert_tail_train_kernel (:1095), and the dense products of
// vitcap_tpu/ops/decode_step.py:115 _kernel.  W keeps the torch Linear
// layout (out, in), so A and W are both K-contiguous (K-major operands of
// wgmma).
//
// What bounds it on the H100, by regime, and what the design does:
// - Large M (encode, prefill, train forward: M = 37,888 at 384 px, 73,728
//   at 512 px; K, N in {768, 2304, 3072}).  2 M N K flops against
//   (M K + N K + M N) elements is far above the card's ~295 flops a byte:
//   the tensor cores' issue rate bounds it, then the epilogue, whose
//   rounding and GELU run on the CUDA cores (10-40 instructions an
//   output, at most 8 warps an SM to run them).  gemm_wide_kernel is
//   persistent (one block per SM walking 128 x 128 output tiles, N
//   fastest): a producer warp keeps a 5-stage ring of 64-deep A and W
//   tiles filled by TMA (128-byte swizzle, zeros past every edge) on
//   mbarriers; two consumer warpgroups take alternate tiles whole (their
//   128 x 128 f32 accumulators in registers, setmaxnreg: 232 for them,
//   40 for the producer) and run wgmma.m64n128k16 straight from the ring,
//   freeing a stage as its products retire.  They take turns (ping-pong):
//   one consumer's epilogue runs while the other's products keep the
//   tensor cores busy, and the producer runs ahead into the next tiles.
// - Small M (the decode step: M = 128 greedy, 384 beam-3; the B = 2
//   parity runs).  The weight bytes bound it (N K bf16: 1.2-4.7 MB, 0.35-
//   1.4 us at 3.35 TB/s), and its 64 x 128 output tiles number only
//   12-144 for 132 SMs.  gemm_split_kernel gives each tile a thread-block
//   cluster of up to 8 blocks along K: each block (one warpgroup, a
//   4-stage cp.async ring in the same swizzle, wgmma.m64n128k16) sums its
//   own range of k-steps into registers and writes the f32 partial tile
//   to its shared memory; after a cluster barrier each block takes a
//   share of the tile's outputs, adds their partials from every rank in
//   rank order through distributed shared memory, and applies the
//   epilogue.  One launch, no workspace, the same bits every call.
// - ops/gemm.py plan() picks the variant and the cluster size per call
//   from (M, N, K): the only place that choice is made.
// The epilogue reads the accumulators in wgmma's layout from registers
// into a warpgroup's staging tile in shared memory (float2 writes, no bank
// conflicts), then each thread takes 8 adjacent outputs of a few rows:
// the bias read once as two float4s, each residual as eight bf16 in 16
// bytes, the pre-GELU values and the outputs stored 16 bytes (32 for
// out_f32) at a time, every row segment contiguous across the threads.
// The rounding order is a template (the kernels are built once per kind
// and GELU), so a thread's outputs run branch-free and interleave, and the
// rounded kinds without GELU run in bf16x2 arithmetic (two outputs an
// instruction, the same bits).  The epilogue's first form, unrolled over
// all of a thread's 128 accumulators with every mode's branches inlined
// per output and scalar-wide accesses, took several times as long as the
// products on the card.  The f32 path is full f32 on the
// CUDA cores (no TF32), because f32 is the ModelConfig default and the
// parity contract is exact f32 arithmetic.
#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

struct Epilogue {
  const float* bias;  // (N,) f32 or null
  const void* res;    // (M, N) in the compute dtype, or null
  void* out;          // (M, N) compute dtype, or f32 when out_f32
  void* pre;          // (M, N) compute dtype: the value GELU reads, or null
  int M, N;
  int gelu;
  int f32_sum;
  int out_f32;
  int bias_first;     // the K7 order, with hidden dropout when drop.on
  Dropout drop;
  unsigned which;     // dropout salt = 2 * image + which
  int rows_per_image;
  int octs;           // N % 8 == 0 and every pointer 16-byte aligned
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// The epilogue's order of roundings, one kernel instance per kind and
// GELU (every other option is a runtime flag of Epilogue).
enum EpiKind { EPI_ROUND = 0, EPI_F32_SUM = 1, EPI_BIAS_FIRST = 2 };

// the bias as epi_math's kind adds it: rounded to T but for EPI_F32_SUM
template <typename T, int KIND>
__device__ __forceinline__ float bias_term(float b) {
  return KIND == EPI_F32_SUM ? b : rnd<T>(b);
}

// One output's epilogue: v the f32 product, bt its column's bias_term (0
// without a bias: adding 0 leaves every value, rounded or not, as it
// was), r its residual (RES), keep its dropout bit (true without dropout,
// where inv is 1); returns the value stored and sets `pre` to the value
// GELU reads (EPI_ROUND).  No branch depends on the element, so a thread's
// outputs interleave.
template <typename T, int KIND, bool GELU, bool RES>
__device__ __forceinline__ float epi_math(const Epilogue& e, float v,
                                          float bt, float r, bool keep,
                                          float& pre) {
  if (KIND == EPI_F32_SUM) {
    v += bt;
    if (GELU) v = gelu_erf(rnd<T>(v));
    if (RES) v += r;
  } else if (KIND == EPI_BIAS_FIRST) {
    v = rnd<T>(rnd<T>(v) + bt);
    v = keep ? rnd<T>(v * rnd<T>(e.drop.inv)) : 0.0f;
    if (RES) v = rnd<T>(r + v);
  } else {
    v = rnd<T>(v);
    if (RES) v = rnd<T>(v + r);
    v = rnd<T>(v + bt);
    pre = v;
    if (GELU) v = gelu_erf(v);
  }
  return v;
}

template <typename T, int KIND, bool GELU>
__device__ __forceinline__ float epi_math_b(const Epilogue& e, float v,
                                            float b, float r, bool keep,
                                            float& pre) {
  return e.res ? epi_math<T, KIND, GELU, true>(e, v, bias_term<T, KIND>(b),
                                               r, keep, pre)
               : epi_math<T, KIND, GELU, false>(e, v, bias_term<T, KIND>(b),
                                                r, keep, pre);
}

// epi_math with everything read from e, b the raw bias (the f32 kernel,
// and the bf16 kernels' scalar fallback)
template <typename T>
__device__ __forceinline__ float epi_math(const Epilogue& e, float v, float b,
                                          float r, bool keep, float& pre) {
  if (e.f32_sum)
    return e.gelu ? epi_math_b<T, EPI_F32_SUM, true>(e, v, b, r, keep, pre)
                  : epi_math_b<T, EPI_F32_SUM, false>(e, v, b, r, keep, pre);
  if (e.bias_first)
    return epi_math_b<T, EPI_BIAS_FIRST, false>(e, v, b, r, keep, pre);
  return e.gelu ? epi_math_b<T, EPI_ROUND, true>(e, v, b, r, keep, pre)
                : epi_math_b<T, EPI_ROUND, false>(e, v, b, r, keep, pre);
}

// an output row and the dropout coordinates of its columns: (token within
// its image, salt 2 * image + which)
struct EpiRow {
  int row;
  unsigned tok, salt;
};
__device__ __forceinline__ EpiRow epi_row(const Epilogue& e, int row) {
  if (!e.drop.on) return {row, 0u, 0u};
  const int img = row / e.rows_per_image;
  return {row, (unsigned)(row - img * e.rows_per_image), 2u * img + e.which};
}
__device__ __forceinline__ bool epi_keep(const Epilogue& e, const EpiRow& rw,
                                         int col) {
  return !e.drop.on || vc_dropout_keep(rw.tok, col, e.drop.seed, rw.salt,
                                       e.drop.thresh);
}

// the epilogue of output (row, col) alone: the f32 kernel, and the bf16
// kernels where `octs` is off (N % 8 or unaligned pointers)
template <typename T>
__device__ __forceinline__ void epi_store(const Epilogue& e, int row, int col,
                                          float v) {
  if (row >= e.M || col >= e.N) return;
  const size_t idx = (size_t)row * e.N + col;
  const float b = e.bias ? e.bias[col] : 0.0f;
  const float r = e.res ? to_f32(static_cast<const T*>(e.res)[idx]) : 0.0f;
  float pre = 0.0f;
  v = epi_math<T>(e, v, b, r, epi_keep(e, epi_row(e, row), col), pre);
  if (e.pre) static_cast<T*>(e.pre)[idx] = from_f32<T>(pre);
  if (e.out_f32)
    static_cast<float*>(e.out)[idx] = v;
  else
    static_cast<T*>(e.out)[idx] = from_f32<T>(v);
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// outputs (row, col .. col + 7) one by one, where `octs` is off: out of
// line, so the common path's code stays small
__device__ __noinline__ void epi_scalar8(Epilogue e, int row, int col,
                                         float4 v0, float4 v1) {
  const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
  for (int c = 0; c < 8; ++c) epi_store<bf16>(e, row, col + c, v[c]);
}

// The bf16 epilogue of outputs (row0 + u dr, col .. col + 7), u < U, col %
// 8 == 0, from their f32 sums v[u]: the bias read once (two float4s) and
// turned into bias terms once for the U rows, every row's residual (eight
// bf16, 16 bytes) loaded before the first store (the compiler cannot move
// a load past a store that may alias it), the pre-GELU values and the
// outputs stored 16 bytes (32 for out_f32) at a time.
template <int KIND, bool GELU, bool RES, int U>
__device__ __forceinline__ void epi_rows_of(const Epilogue& e, int row0,
                                            int dr, int row_end, int col,
                                            const float4 (&v)[U][2]) {
  float bt[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (e.bias) {
    const float4* bp = reinterpret_cast<const float4*>(e.bias + col);
    const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) bt[c] = bias_term<bf16, KIND>(b[c]);
  }
  uint4 rr[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    rr[u] = RES && row0 + u * dr < row_end
                ? __ldg(reinterpret_cast<const uint4*>(
                      static_cast<const bf16*>(e.res) +
                      (size_t)(row0 + u * dr) * e.N + col))
                : make_uint4(0u, 0u, 0u, 0u);
  // the rounded kinds without GELU in bf16x2 arithmetic: the f32 sum or
  // product of two bf16 values, rounded to bf16, is the bf16 operation's
  // own result (one rounding), so this is epi_math's order bit for bit at
  // a quarter of its instructions
  constexpr bool PAIRS = KIND != EPI_F32_SUM && !GELU;
  __nv_bfloat162 btp[4], inv2;
  if (PAIRS) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      btp[q] = __floats2bfloat162_rn(bt[2 * q], bt[2 * q + 1]);
    inv2 = __float2bfloat162_rn(e.drop.inv);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int row = row0 + u * dr;
    if (row >= row_end) break;
    const size_t idx = (size_t)row * e.N + col;
    const uint32_t rw32[4] = {rr[u].x, rr[u].y, rr[u].z, rr[u].w};
    const float vin[8] = {v[u][0].x, v[u][0].y, v[u][0].z, v[u][0].w,
                          v[u][1].x, v[u][1].y, v[u][1].z, v[u][1].w};
    float o[8], p[8];
    uint4 packed;             // the bf16 outputs of PAIRS, which are also
    if (PAIRS) {              // the pre-GELU values
      const EpiRow rw = epi_row(e, row);
      uint32_t t32[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 r2 =
            *reinterpret_cast<const __nv_bfloat162*>(&rw32[q]);
        __nv_bfloat162 t = __floats2bfloat162_rn(vin[2 * q], vin[2 * q + 1]);
        if (KIND == EPI_BIAS_FIRST) {
          t = __hadd2(t, btp[q]);
          if (e.drop.on) {
            const __nv_bfloat162 kept = __hmul2(t, inv2);
            const bf16 zero = __float2bfloat16(0.0f);
            t.x = vc_dropout_keep(rw.tok, col + 2 * q, e.drop.seed, rw.salt,
                                  e.drop.thresh)
                      ? kept.x
                      : zero;
            t.y = vc_dropout_keep(rw.tok, col + 2 * q + 1, e.drop.seed,
                                  rw.salt, e.drop.thresh)
                      ? kept.y
                      : zero;
          }
          if (RES) t = __hadd2(r2, t);
        } else {
          if (RES) t = __hadd2(t, r2);
          t = __hadd2(t, btp[q]);
        }
        t32[q] = *reinterpret_cast<const uint32_t*>(&t);
        const float2 f = __bfloat1622float2(t);
        o[2 * q] = f.x;
        o[2 * q + 1] = f.y;
      }
      packed = make_uint4(t32[0], t32[1], t32[2], t32[3]);
    } else {                  // EPI_F32_SUM, or GELU: no dropout
      float rin[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&rw32[q]));
        rin[2 * q] = f.x;
        rin[2 * q + 1] = f.y;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        p[c] = 0.0f;
        o[c] = epi_math<bf16, KIND, GELU, RES>(e, vin[c], bt[c], rin[c], true,
                                               p[c]);
      }
    }
    if (e.pre)
      *reinterpret_cast<uint4*>(static_cast<bf16*>(e.pre) + idx) =
          PAIRS ? packed : pack8(p);
    if (e.out_f32) {
      float4* op = reinterpret_cast<float4*>(static_cast<float*>(e.out) + idx);
      op[0] = make_float4(o[0], o[1], o[2], o[3]);
      op[1] = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      *reinterpret_cast<uint4*>(static_cast<bf16*>(e.out) + idx) =
          PAIRS ? packed : pack8(o);
    }
  }
}

// epi_rows_of for the rows before row_end (at most M)
template <int KIND, bool GELU, int U>
__device__ __forceinline__ void epi_rows(const Epilogue& e, int row0, int dr,
                                         int row_end, int col,
                                         const float4 (&v)[U][2]) {
  if (col >= e.N) return;
  row_end = min(row_end, e.M);
  if (!e.octs) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row0 + u * dr < row_end)
        epi_scalar8(e, row0 + u * dr, col, v[u][0], v[u][1]);
    return;
  }
  if (e.res)
    epi_rows_of<KIND, GELU, true, U>(e, row0, dr, row_end, col, v);
  else
    epi_rows_of<KIND, GELU, false, U>(e, row0, dr, row_end, col, v);
}

// Asks L2 for the residual rows [m0, m0 + rows) x columns [n0, n0 + cols)
// (cols * 2 a multiple of 128), `threads` threads sharing the 128-byte
// lines, so the epilogue finds them there.
template <int THREADS>
__device__ __forceinline__ void prefetch_res(const Epilogue& e, int m0,
                                             int n0, int rows, int cols,
                                             int tid) {
  if (!e.res) return;
  const int per_row = cols * 2 / 128;
  for (int l = tid; l < rows * per_row; l += THREADS) {
    const int row = m0 + l / per_row, col = n0 + l % per_row * 64;
    if (row < e.M && col < e.N)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
          static_cast<const bf16*>(e.res) + (size_t)row * e.N + col));
  }
}

// The accumulator columns [8 J0, 8 J0 + 8 NJ) of this thread's two rows
// (wgmma.cuh's layout) -> a warpgroup's f32 staging tile in shared memory,
// rows LD floats apart: float2 writes, free of bank conflicts for LD % 32
// == 8.
template <int J0, int NJ, int LD, int R>
__device__ __forceinline__ void stage_acc(const float (&d)[R], float* stage) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32 % 4;
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stage + (16 * w + lane / 4 + 8 * i) * LD +
                                 8 * jj + 2 * (lane % 4)) =
          make_float2(d[4 * (J0 + jj) + 2 * i], d[4 * (J0 + jj) + 2 * i + 1]);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// bf16, large M: persistent TMA + wgmma kernel, consumers in ping-pong
// ---------------------------------------------------------------------------

constexpr int GW_BM = 128, GW_BN = 128, GW_BK = 64, GW_ST = 5;
constexpr int GW_A = GW_BM * GW_BK * 2;        // one stage's A tile, bytes
constexpr int GW_B = GW_BN * GW_BK * 2;        // one stage's W tile
constexpr int GW_STAGE = GW_A + GW_B;
constexpr int GW_THREADS = 3 * 128;            // producer + 2 consumers
constexpr int GW_SC = 32;                      // columns per epilogue pass
constexpr int GW_LD = GW_SC + 8;               // staging row stride, floats
constexpr int GW_STAGING = GW_BM * GW_LD * 4;  // per consumer, bytes
// the ring, the two staging tiles, the full and empty barriers, the two
// consumers' turn barriers, and slack to align the ring to 1024
constexpr size_t GW_SMEM =
    GW_ST * GW_STAGE + 2 * GW_STAGING + (2 * GW_ST + 2) * 8 + 1024;

// Columns [CH GW_SC, (CH + 1) GW_SC) of a consumer's two 64-row halves of
// accumulators -> its staging tile.
template <int CH>
__device__ __forceinline__ void wide_stage(const float (&acc)[2][GW_BN / 2],
                                           float* stage) {
  stage_acc<CH * GW_SC / 8, GW_SC / 8, GW_LD>(acc[0], stage);
  stage_acc<CH * GW_SC / 8, GW_SC / 8, GW_LD>(acc[1],
                                              stage + WG_ROWS * GW_LD);
}

// The block's tiles are t = blockIdx.x + i gridDim.x, i = 0, 1, ...; the
// producer loads every tile's k-steps in that order into one ring, and
// consumer warpgroup c takes the tiles with i % 2 == c whole (two 64-row
// halves on wgmma.m64n128k16), so one consumer's epilogue runs while the
// other's products keep the tensor cores busy.  The consumers take turns
// through two more mbarriers: tile i's products start once the other
// consumer has waited for all of tile i - 1's k-steps.  A ring slot's
// uses thus reach the barriers in order, and a wait on a slot's full
// barrier never sees a phase two uses old (the parity would match).
template <int KIND, bool GELU>
__global__ void __launch_bounds__(GW_THREADS, 1)
    gemm_wide_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw, Epilogue e,
                     int K) {
  extern __shared__ unsigned char gw_smem[];
  unsigned char* base =
      gw_smem + ((1024 - (smem_u32(gw_smem) & 1023)) & 1023);
  const uint32_t ring = smem_u32(base);
  float* staging = reinterpret_cast<float*>(base + GW_ST * GW_STAGE);
  const uint32_t full = ring + GW_ST * GW_STAGE + 2 * GW_STAGING;
  const uint32_t empty = full + GW_ST * 8;
  const uint32_t turn = empty + GW_ST * 8;   // turn + 8 c: consumer c's
  if (threadIdx.x == 0) {
    for (int s = 0; s < GW_ST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128);       // the consumer of that k-step
    }
    mbar_init(turn, 128);
    mbar_init(turn + 8, 128);
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles_n = (e.N + GW_BN - 1) / GW_BN;
  const int tiles = (e.M + GW_BM - 1) / GW_BM * tiles_n;
  const int nk = (K + GW_BK - 1) / GW_BK;
  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full, tile after tile
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      unsigned ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * GW_BM, n0 = t % tiles_n * GW_BN;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * GW_STAGE;
          mbar_expect_tx(full + 8 * s, GW_STAGE);
          tma_load_2d(st, &ta, full + 8 * s, kt * GW_BK, m0);
          tma_load_2d(st + GW_A, &tw, full + 8 * s, kt * GW_BK, n0);
          if (++s == GW_ST) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    regs_inc<232>();
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
    float* stage = staging + c * (GW_STAGING / 4);
    float acc[2][GW_BN / 2];
    for (int i = c;; i += 2) {
      const int t = blockIdx.x + i * gridDim.x;
      if (t >= tiles) break;
      const int m0 = t / tiles_n * GW_BM, n0 = t % tiles_n * GW_BN;
      prefetch_res<128>(e, m0, n0, GW_BM, GW_BN, tid);
      // this tile's k-steps follow the i * nk before it in the ring
      const long long pos = (long long)i * nk;
      int s = (int)(pos % GW_ST);
      unsigned ph = (unsigned)(pos / GW_ST) & 1u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < GW_BN / 2; ++j) acc[h][j] = 0.0f;
      // consumer c's j-th tile (i = 2 j + c) waits for the other's
      // (j - 1 + c)-th turn to end
      if (i > 0) mbar_wait(turn + 8 * c, (unsigned)((i - 1) / 2) & 1u);
      int prev = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(full + 8 * s, ph);
        const uint32_t st = ring + s * GW_STAGE;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wg_fence();
        ss_kstep(acc[0], st, st + GW_A);
        ss_kstep(acc[1], st + WG_ROWS * 128, st + GW_A);
        wg_commit();
        if (kt > 0) {
          wg_wait<1>();                   // the last step's products retired
          mbar_arrive(empty + 8 * prev);
        }
        prev = s;
        if (++s == GW_ST) {
          s = 0;
          ph ^= 1;
        }
      }
      mbar_arrive(turn + 8 * (1 - c));  // the other consumer's turn
      wg_wait0();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (nk > 0) mbar_arrive(empty + 8 * prev);
      // the epilogue, GW_SC columns at a time: the accumulators to the
      // staging tile, then 4 threads per row take 8 adjacent outputs of 4
      // rows 32 apart (epi_rows)
#pragma unroll 1
      for (int ch = 0; ch < GW_BN / GW_SC; ++ch) {
        switch (ch) {
          case 0: wide_stage<0>(acc, stage); break;
          case 1: wide_stage<1>(acc, stage); break;
          case 2: wide_stage<2>(acc, stage); break;
          default: wide_stage<3>(acc, stage); break;
        }
        named_sync(1 + c, 128);
        // thread tid: columns 8 (tid % 4) .. + 7 of rows tid / 4 + 32 p
        const int r0 = tid / 4, c8 = 8 * (tid % 4);
        float4 v[GW_BM / 32][2];
#pragma unroll
        for (int p = 0; p < GW_BM / 32; ++p) {
          const float* src = stage + (r0 + 32 * p) * GW_LD + c8;
          v[p][0] = *reinterpret_cast<const float4*>(src);
          v[p][1] = *reinterpret_cast<const float4*>(src + 4);
        }
        epi_rows<KIND, GELU>(e, m0 + r0, 32, e.M, n0 + ch * GW_SC + c8, v);
        named_sync(1 + c, 128);           // the staging tile is free again
      }
    }
  }
}
static_assert(GW_BN / GW_SC == 4, "wide_stage's cases cover the tile");
static_assert(GW_SMEM <= 232448, "fits the H100's shared memory per block");

// ---------------------------------------------------------------------------
// bf16, small M: split-K over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int GS_BM = 64, GS_BN = 128, GS_BK = 64, GS_ST = 4;
constexpr int GS_A = GS_BM * GS_BK * 2;
constexpr int GS_B = GS_BN * GS_BK * 2;
constexpr int GS_STAGE = GS_A + GS_B;
constexpr int GS_THREADS = 128;
constexpr int GS_MAX_RANKS = 8;                // the portable cluster size
constexpr int GS_LD = GS_BN + 8;               // partial tile row stride
constexpr size_t GS_SMEM = GS_ST * GS_STAGE + 1024;
static_assert(GS_BM * GS_LD * 4 <= GS_ST * GS_STAGE,
              "the f32 partial tile fits in the ring");

// Block (x, y, rank) of a cluster of `ranks` blocks along z: output tile
// (64 y, 128 x), k-steps [rank * steps_per_rank, ...) of 64.
template <int KIND, bool GELU>
__global__ void __launch_bounds__(GS_THREADS)
    gemm_split_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                      Epilogue e, int K, int steps_per_rank) {
  extern __shared__ unsigned char gs_smem[];
  float* part = reinterpret_cast<float*>(
      gs_smem + ((1024 - (smem_u32(gs_smem) & 1023)) & 1023));
  const uint32_t ring = smem_u32(part);
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), ranks = (int)cl.num_blocks();
  const int m0 = blockIdx.y * GS_BM, n0 = blockIdx.x * GS_BN;
  const int nk = (K + GS_BK - 1) / GS_BK;
  const int k_first = rank * steps_per_rank;
  const int steps = max(0, min(nk, k_first + steps_per_rank) - k_first);
  auto load = [&](int kt) {
    const int k0 = (k_first + kt) * GS_BK;
    const uint32_t st = ring + kt % GS_ST * GS_STAGE;
    load_tile<64, GS_BM, GS_THREADS>(st, A + k0, K, m0, e.M, K - k0);
    load_tile<64, GS_BN, GS_THREADS>(st + GS_A, W + k0, K, n0, e.N, K - k0);
  };
  prefetch_res<GS_THREADS>(e, m0, n0, GS_BM, GS_BN, threadIdx.x);
  // the ring runs GS_ST - 1 steps ahead: the slot a step's loads
  // overwrite was read by the products of the step before, which every
  // thread has waited for before the barrier that precedes the loads (the
  // weight bytes bound these shapes, so keeping loads in flight matters
  // more than overlapping a step's products with the next)
  for (int p = 0; p < GS_ST - 1; ++p) {
    if (p < steps) load(p);
    cp_commit();
  }
  float acc[GS_BN / 2];
#pragma unroll
  for (int i = 0; i < GS_BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < steps; ++kt) {
    cp_wait<GS_ST - 2>();
    fence_async_smem();
    __syncthreads();
    if (kt + GS_ST - 1 < steps) load(kt + GS_ST - 1);
    cp_commit();
    const uint32_t st = ring + kt % GS_ST * GS_STAGE;
    fence_regs(acc);
    wg_fence();
    ss_kstep(acc, st, st + GS_A);
    wg_commit();
    wg_wait0();
  }
  fence_regs(acc);
  // every rank's f32 partial tile to its own shared memory, rows GS_LD
  // floats apart; then each rank takes every ranks-th group of 8 of the
  // tile's rows, sums each output over the ranks in rank order (p0 + p1 +
  // ...) through distributed shared memory and applies the epilogue
  cp_wait<0>();
  __syncthreads();
  stage_acc<0, GS_BN / 8, GS_LD>(acc, part);
  cl.sync();
  // thread t of rank q: columns 8 (t % 16) .. + 7 of rows t / 16 + 8 q +
  // 8 ranks k, BATCH rows at a time
  constexpr int BATCH = 4;
  const int c8 = 8 * (threadIdx.x % 16), dr = 8 * ranks;
  for (int r0 = threadIdx.x / 16 + 8 * rank; r0 < GS_BM; r0 += BATCH * dr) {
    float4 v[BATCH][2];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (r0 + u * dr >= GS_BM) break;
      const int off = (r0 + u * dr) * GS_LD + c8;
      // every rank's partials of the row first (their latencies overlap),
      // then the sum in rank order
      float4 y[GS_MAX_RANKS][2];
#pragma unroll
      for (int q = 0; q < GS_MAX_RANKS; ++q)
        if (q < ranks)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            y[q][h] = *reinterpret_cast<const float4*>(
                cl.map_shared_rank(part, q) + off + 4 * h);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[u][h] = y[0][h];
#pragma unroll
        for (int q = 1; q < GS_MAX_RANKS; ++q)
          if (q < ranks) {
            v[u][h].x += y[q][h].x;
            v[u][h].y += y[q][h].y;
            v[u][h].z += y[q][h].z;
            v[u][h].w += y[q][h].w;
          }
      }
    }
    epi_rows<KIND, GELU>(e, m0 + r0, dr, m0 + GS_BM, n0 + c8, v);
  }
  cl.sync();                      // no block leaves while others read it
}

// ---------------------------------------------------------------------------
// f32: CUDA-core tiles (exact f32, no TF32)
// ---------------------------------------------------------------------------

constexpr int FB = 64, FK = 16;

__global__ void __launch_bounds__(256)
    gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    Epilogue e, int K) {
  __shared__ float As[FK][FB + 4];  // [k][m]
  __shared__ float Ws[FK][FB + 4];  // [k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FB, n0 = blockIdx.x * FB;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = threadIdx.x; i < FB * FK; i += blockDim.x) {
      int r = i / FK, c = i % FK;
      int gk = k0 + c;
      int gm = m0 + r, gn = n0 + r;
      As[c][r] = (gm < e.M && gk < K) ? A[(size_t)gm * K + gk] : 0.0f;
      Ws[c][r] = (gn < e.N && gk < K) ? W[(size_t)gn * K + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epi_store<float>(e, m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
}


// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no libcuda
static EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !p)
    return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f);
  return f;
}

// a row-major (rows, K) bf16 matrix as TMA boxes of 64 columns by
// box_rows rows in the 128-byte swizzle, zeros past its edges
static int tensor_map(CUtensorMap* map, const void* p, int rows, int K,
                      int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)GW_BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int KIND, bool GELU>
static int launch_wide(const bf16* a, const bf16* w, const Epilogue& e,
                       int K, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  CUtensorMap ta, tw;
  int rc = tensor_map(&ta, a, e.M, K, GW_BM);
  if (!rc) rc = tensor_map(&tw, w, e.N, K, GW_BN);
  if (rc) return rc;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = allow_smem((const void*)gemm_wide_kernel<KIND, GELU>, GW_SMEM,
                     smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((e.M + GW_BM - 1) / GW_BM) * ((e.N + GW_BN - 1) / GW_BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  gemm_wide_kernel<KIND, GELU><<<grid, GW_THREADS, GW_SMEM, s>>>(ta, tw, e,
                                                                K);
  return 0;
}

template <int KIND, bool GELU>
static int launch_split(const bf16* a, const bf16* w, const Epilogue& e,
                        int K, int ranks, cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  if (ranks < 1 || ranks > GS_MAX_RANKS) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem((const void*)gemm_split_kernel<KIND, GELU>,
                               GS_SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int nk = (K + GS_BK - 1) / GS_BK;
  const int steps_per_rank = (nk + ranks - 1) / ranks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((e.N + GS_BN - 1) / GS_BN, (e.M + GS_BM - 1) / GS_BM,
                     ranks);
  cfg.blockDim = dim3(GS_THREADS);
  cfg.dynamicSmemBytes = GS_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ranks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gemm_split_kernel<KIND, GELU>, a, w, e,
                                 K, steps_per_rank);
}

template <int KIND, bool GELU>
static int launch_bf16(const void* a, const void* w, const Epilogue& e,
                       int K, int split, cudaStream_t s) {
  const bf16* ab = static_cast<const bf16*>(a);
  const bf16* wb = static_cast<const bf16*>(w);
  return split == 0 ? launch_wide<KIND, GELU>(ab, wb, e, K, s)
                    : launch_split<KIND, GELU>(ab, wb, e, K, split, s);
}

static bool aligned(const void* p, uintptr_t bytes) {
  return !(reinterpret_cast<uintptr_t>(p) % bytes);
}

// split: 0 runs the bf16 product on gemm_wide_kernel, 1..8 on
// gemm_split_kernel with clusters of that many blocks (ops/gemm.py plan);
// the f32 kernel ignores it.
extern "C" int vc_gemm(const void* a, const void* w, const void* bias,
                       const void* res, void* out, void* pre, int M, int N,
                       int K, int dtype, int gelu, int f32_sum, int out_f32,
                       int bias_first, unsigned seed, unsigned thresh,
                       float inv, int which, int rows_per_image, int split,
                       void* stream) {
  if (bias_first && (f32_sum || gelu || rows_per_image <= 0))
    return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return 0;
  Epilogue e{static_cast<const float*>(bias), res, out, pre, M, N, gelu,
             f32_sum, out_f32, bias_first,
             Dropout{seed, thresh, inv, thresh != 0u || inv != 1.0f},
             static_cast<unsigned>(which), rows_per_image, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  if (dtype == VC_BF16) {
    // TMA and cp.async read 16-byte aligned rows (K % 8 == 0 is checked by
    // the wrapper)
    if (!aligned(a, 16) || !aligned(w, 16))
      return (int)cudaErrorMisalignedAddress;
    e.octs = !(N % 8) && aligned(bias, 16) && aligned(res, 16) &&
             aligned(pre, 16) && aligned(out, 16);
    if (f32_sum)
      rc = gelu ? launch_bf16<EPI_F32_SUM, true>(a, w, e, K, split, s)
                : launch_bf16<EPI_F32_SUM, false>(a, w, e, K, split, s);
    else if (bias_first)
      rc = launch_bf16<EPI_BIAS_FIRST, false>(a, w, e, K, split, s);
    else
      rc = gelu ? launch_bf16<EPI_ROUND, true>(a, w, e, K, split, s)
                : launch_bf16<EPI_ROUND, false>(a, w, e, K, split, s);
  } else if (dtype == VC_F32) {
    dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                         static_cast<const float*>(w), e, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch configuration of the bf16 kernels, for the measurement scripts
// ---------------------------------------------------------------------------

#define GEMM_KERNEL(kernel, threads, smem, KIND, GELU)                  \
  {#kernel "<" #KIND ", " #GELU ">", (const void*)kernel<KIND, GELU>, \
   threads, smem}
#define GEMM_KERNELS_OF(kernel, threads, smem)                          \
  GEMM_KERNEL(kernel, threads, smem, EPI_ROUND, false),                 \
      GEMM_KERNEL(kernel, threads, smem, EPI_ROUND, true),              \
      GEMM_KERNEL(kernel, threads, smem, EPI_F32_SUM, false),           \
      GEMM_KERNEL(kernel, threads, smem, EPI_F32_SUM, true),            \
      GEMM_KERNEL(kernel, threads, smem, EPI_BIAS_FIRST, false)
static const WgKernel GEMM_KERNELS[] = {
    GEMM_KERNELS_OF(gemm_wide_kernel, GW_THREADS, GW_SMEM),
    GEMM_KERNELS_OF(gemm_split_kernel, GS_THREADS, GS_SMEM),
};
#undef GEMM_KERNELS_OF
#undef GEMM_KERNEL

// Kernel `index` of the bf16 kernels and its launch configuration
// (wg_kernel_info, wgmma.cuh); -1 past the last kernel.
extern "C" int vc_gemm_kernel_info(int index, char* name, int len,
                                   int* info) {
  return wg_kernel_info(GEMM_KERNELS,
                        sizeof(GEMM_KERNELS) / sizeof(WgKernel), index, name,
                        len, info);
}
