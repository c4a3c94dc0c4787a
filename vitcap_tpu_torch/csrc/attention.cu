// attention: softmax(q . k^T * hd^-0.5 [+ bias]) . v, keys at or past
// l_actual masked, out a contiguous (B, Lp, H) with head h at columns
// [h * hd, (h + 1) * hd).  q, k and v are three per-head operands, each
// read by base pointer and batch, head and row strides (Operand,
// common.cuh): a fused (B, Lp, 3H) qkv slab is the case q = slab,
// k = slab + H, v = slab + 2H with row stride 3H and head stride hd; the
// packed train route (flash_attention_packed) passes separate q, k, v
// tensors or views of one; flash_attention (K9) passes (B, nH, L, dh)
// tensors or their views.  One kernel body per dtype serves them all.
// The bias is (B, 1 | nH, Lp, Lp) f32 (Bias, common.cuh; head stride 0
// for the head-broadcast one).
//
// What each kernel replaces:
// - attention_wgmma_kernel (bf16, two passes over the keys) replaces the
//   attention TPU kernels of vitcap_tpu/ops/fused_block.py:
//   _attn_pairbd_kernel / _attn_perhead_kernel (ViT, no bias, K2) and
//   _bert_attn_pairbd_kernel / _bert_attn_perhead_kernel (BERT prefill,
//   with the additive head-broadcast (B, 1, Lp, Lp) f32 bias, K4b); past
//   1024 padded tokens the attention of K10 (fused_block.py:125
//   _block_kernel, :470 _bert_kernel, whose q-tiled softmax is the same
//   function); with prob dropout the train forward of K8
//   (vitcap_tpu/ops/flash_attention.py:452 _fwd_packed_kernel / :484
//   _fwd_packed_pair_kernel, reached through flash_fwd_packed_slab :949 on
//   the slab and _flash_fwd_packed :670 on separate q, k, v); and K9's
//   forward up to 1024 padded tokens (flash_attention.py:846
//   flash_attention -> :189 _flash_fwd_onepass, :165 _onepass_kernel; any
//   bias: none, (B, 1, L, L) or per head).  The TPU kernels'
//   pair-blockdiagonal packing is an MXU trick and is not carried over.
// - attention_wgmma_online_kernel (bf16, the `online` mode) replaces K9's
//   q-tiled kernel past 1024 padded tokens (flash_attention.py:251
//   _flash_fwd_pallas -> :129 _kernel), which computes another function.
// - attention_kernel (f32, exact f32 on the CUDA cores, no TF32) serves
//   both functions in f32.
//
// Math of the two-pass function, as on the TPU: f32 scores, scale applied
// after the dot, bias added, keys >= l_actual masked (they contribute
// exactly 0: exp(-1e30 - m) underflows, so the kernels stop at l_actual),
// the max and the sum over the whole row, the unnormalised probabilities
// exp(s - m) rounded to the compute dtype for the product with v, and the
// output divided by max(l, 1e-30).  Attention-prob dropout (K8): the
// exp(s - m) of a dropped (query, key) pair is 0 and a kept one is
// multiplied by 1 / (1 - rate) in f32 before the rounding; the row sum l
// stays the undropped one.  The keep bit is vc_dropout_keep(query row, key
// column, seed, b * nh_total + head_offset + h: the global head, which is
// b * nh + h without tensor parallelism), the bits the backward
// (attention_bwd.cu) regenerates.
// Online function (K9 past 1024): q pre-scaled in its own dtype
// (round(q * round(scale)), exact at hd 64 where the scale is 2^-3), the
// scores q . k^T with no further scale, and the softmax online over key
// tiles of 128 from key 0: per tile m' = max(m, rowmax(s)), p = exp(s - m')
// rounded to the operand dtype for the product with v, corr = exp(m - m'),
// l = l * corr + sum(p) and acc = acc * corr + p . v in f32, in that order
// with no contraction (m starts at -1e30, masked keys at -1e30).
//
// What bounds them on the H100: 4 * Lp * L * hd flops per (image, head)
// (2 for q . k^T, 2 for p . v) against 4 * Lp * hd operand elements: at
// Lp 592 and hd 64 about 300 flops a byte, on the compute side of the
// card's balance point, and more so as Lp grows; the exp, max and sum of
// the softmax are the second cost, on the CUDA cores.  The two-pass kernel
// runs q . k^T twice (1.5x the tensor-core work of one pass), the price of
// rounding p against the row's final max.  A bias adds its f32 bytes
// (B * nH * Lp^2 * 4 per head, or B * Lp^2 * 4 once when broadcast): the
// per-head bias makes K9 bound by bytes.
//
// What the design does about it (bf16): a block of two warpgroups (256
// threads), each 64 query rows of one head, the two sharing every K and V
// tile, and both products on wgmma.  S = q . k^T is wgmma.m64n64k16 with
// q and the key tile in shared memory and S in registers; the softmax,
// the mask (on the tile that holds l_actual only), the bias, the dropout
// and the online correction run on each thread's own accumulator rows
// (rows 16 * warp + lane / 4 and that row + 8 of its warpgroup; a row's
// max and sum take two shuffles in the group of four lanes); the
// probabilities are converted in place to bf16 pairs, which is the
// A-operand layout of o += p . v, so p never leaves the registers, and v
// is the transposed B operand from shared memory (the building blocks,
// shared with attention_bwd.cu, are in wgmma.cuh).  No score, probability
// or accumulator goes through shared memory.  K and V tiles stream through
// a two-stage ring of cp.async copies written in the swizzle the wgmma
// descriptors name, so the next tile loads while the current one is in
// the products; pass 1 of the two-pass kernel loads only K.  Each kernel is
// built per head width HDP (ops/attention.py plan picks it): 64 (one
// panel of 64 columns, a 128-byte line a row, in the 128-byte swizzle),
// 80 and 96 (that panel, then a tail panel of 16 or 32 columns, 32- or
// 64-byte lines in the 32- or 64-byte swizzle; q . k^T in 5 or 6 k-steps
// of 16, the tail's with descriptors of its own swizzle, and p . v as a
// wgmma of N = 64 plus one of N = 16 or 32 over the tail: 37.5% and 25%
// less tensor-core work, shared memory and output accumulators than the
// 128-column instance, ViT-H/14's and the old ViT-S/16's heads) and 128
// (two panels).  Pass 1 finds the row max (without a bias, of the raw products,
// scaled once: rounding is monotonic); pass 2 forms p = exp(s - m) once,
// sums l from it (the undropped sum, as the plain version sums it) and
// multiplies by v, so the output accumulator needs no rescaling.  exp is
// ex2.approx of x * log2(e) (vc_exp).  The bias is read in the
// accumulator's own layout (each group of four lanes reads 32 contiguous
// bytes of one row as float2s) into registers, issued before the tile's
// q . k^T so its latency hides behind it, and the grid runs the heads
// fastest, so the 12 heads that read one head-broadcast bias tile run back
// to back and find it in L2.  The online kernel runs each 128-key tile's
// p . v into fresh register accumulators and folds them into the output
// accumulator as acc * corr + pv per element.  Head sizes are padded with
// zeros to the instance's width (16, 32, 64 or 128 on the CUDA cores),
// which leaves the dot products unchanged; ragged l_actual and Lp are
// masked in the kernel.
//
// f32: CUDA cores, one thread per query row with q and the output
// accumulator in registers, K/V tiles staged as f32 in shared memory
// (broadcast reads), online softmax over chunks of 16 keys (exact
// arithmetic, only the order of the f32 sums differs); in the online mode
// with the pre-scaled q (its chunks only reorder f32 sums).  Neither
// kernel's shared memory nor its grid depends on Lp beyond the number of
// query tiles, and every offset into the operands, the bias and the
// output is a size_t product, so the same kernels serve the long
// sequences (K10 at Lp 1152, B = 64: 85M bias entries) and 512-px
// training on separate q, k, v (Lp 1152 and 1104).
#include "wgmma.cuh"

// ---------------------------------------------------------------------------
// bf16: wgmma, two warpgroups of 64 query rows a block, the softmax in
// registers
// ---------------------------------------------------------------------------

constexpr int WG_KT = 64;         // keys per tile of the two-pass kernel
constexpr int ON_KT = 128;        // the online mode's key tile (the TPU TK)
constexpr float ON_NEG = -1e30f;  // its mask value and running-max start

// Dynamic shared memory, each tile 1024-byte aligned (the swizzle repeats
// every 8 rows of 128 bytes): the block's WG_Q q rows, then two stages of
// K, then two of V, each tile HDP / 64 panels of rows x 128 bytes.
template <int HDP, int KT>
struct WgSmem {
  static constexpr uint32_t Q = WG_Q * HDP * 2;
  static constexpr uint32_t T = KT * HDP * 2;
  static constexpr size_t BYTES = Q + 4 * T + 1024;  // + base alignment
};

// The output accumulators a thread holds for HDP head columns: NP
// panels of 64 columns (32 each) and the tail panel's TN (0, 8 or 16; an
// unused one when 0).
template <int HDP>
struct OutAcc {
  static constexpr int NP = HDP / 64, TN = Panels<HDP>::TAIL / 2;
  float o[NP][32];
  float ot[TN > 0 ? TN : 1];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int np = 0; np < NP; ++np)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[np][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < (TN > 0 ? TN : 1); ++e) ot[e] = 0.0f;
  }
  __device__ __forceinline__ void fence() {
#pragma unroll
    for (int np = 0; np < NP; ++np) fence_regs(o[np]);
    if constexpr (TN > 0) fence_regs(ot);
  }
};

// o / max(l, 1e-30) -> rows row0, row0 + 8 (those below Lp), columns below
// hd of head h in the (B, Lp, H) output, as bf16 pairs
template <int N>
__device__ __forceinline__ void store_cols(const float* o, int c0,
                                           const float (&den)[2],
                                           bf16* __restrict__ out, int b,
                                           int h, int Lp, int H, int hd,
                                           int row0, int cq) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = c0 + 8 * j + cq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (col < hd && r < Lp)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((size_t)b * Lp + r) * H + h * hd + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] / den[i],
                                  o[4 * j + 2 * i + 1] / den[i]);
    }
  }
}

template <int HDP>
__device__ __forceinline__ void store_out(const OutAcc<HDP>& acc,
                                          const float (&l)[2],
                                          bf16* __restrict__ out, int b,
                                          int h, int Lp, int H, int hd,
                                          int row0, int cq) {
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
#pragma unroll
  for (int np = 0; np < OutAcc<HDP>::NP; ++np)
    store_cols<64>(acc.o[np], 64 * np, den, out, b, h, Lp, H, hd, row0, cq);
  if constexpr (OutAcc<HDP>::TN > 0)
    store_cols<2 * OutAcc<HDP>::TN>(acc.ot, 64 * OutAcc<HDP>::NP, den, out,
                                    b, h, Lp, H, hd, row0, cq);
}

// Two passes over the keys: steps 0 .. nt - 1 find the row max over K
// tiles, steps nt .. 2 nt - 1 form p = exp(s - m), sum l and multiply by
// the V tiles.  K and V tiles load one step ahead through the two-stage
// ring.
template <int HDP, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS)
    attention_wgmma_kernel(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                           Bias bias, bf16* __restrict__ out, int Lp, int H,
                           int hd, int l_actual, float scale, Dropout drop) {
  constexpr int KT = WG_KT, NP = HDP / 64;
  using S = WgSmem<HDP, KT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + S::Q, sv = sk + 2 * S::T;
  const int h = blockIdx.x, q0 = blockIdx.y * WG_Q, b = blockIdx.z;
  const WgThread me(q0);
  const int arow = me.wg * WG_ROWS;  // this warpgroup's rows of the q tile
  const unsigned salt = drop.salt(b, h);  // the global head
  const bf16* kh = k.head(b, h);
  const bf16* vh = v.head(b, h);
  const BiasRows br(bias, b, h, me.row0, Lp);
  const int nt = (l_actual + KT - 1) / KT;

  auto issue = [&](int step) {
    if (step >= 2 * nt) return;
    const int k0 = (step < nt ? step : step - nt) * KT;
    const uint32_t st = (step & 1) * S::T;
    load_tile<HDP, KT>(sk + st, kh, k.sr, k0, l_actual, hd);
    if (step >= nt) load_tile<HDP, KT>(sv + st, vh, v.sr, k0, l_actual, hd);
  };
  load_tile<HDP, WG_Q>(sq, q.head(b, h), q.sr, q0, Lp, hd);
  issue(0);
  cp_commit();

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  OutAcc<HDP> acc;
  acc.zero();

  for (int step = 0; step < 2 * nt; ++step) {
    const bool pass2 = step >= nt;
    const int k0 = (pass2 ? step - nt : step) * KT, kc = k0 + me.cq;
    const bool edge = k0 + KT > l_actual;  // the tile holds masked keys
    const uint32_t st = (step & 1) * S::T;
    issue(step + 1);
    cp_commit();
    float bv[2][KT / 4];  // issued before the product, to hide its latency
    if (BIAS) load_bias<KT>(bv, br.row, kc, l_actual, br.vec, edge);
    cp_wait<1>();  // this step's K (and V)
    fence_async_smem();
    __syncthreads();
    float s[KT / 64][32];
    qk_product<HDP, KT>(s, sq, sk + st, arow);
    if (!pass2 && !BIAS) {
      // max(round(s * scale)) = round(max(s) * scale) for scale > 0
      finish_scores<KT, false, false>(s, bv, scale, kc, l_actual, -INFINITY,
                                      edge);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        m[i] = fmaxf(m[i], __fmul_rn(row_max<KT>(s, i, -INFINITY), scale));
      __syncthreads();  // the stage is free for the load two steps on
      continue;
    }
    finish_scores<KT, true, BIAS>(s, bv, scale, kc, l_actual, -INFINITY,
                                  edge);
    if (!pass2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) m[i] = row_max<KT>(s, i, m[i]);
    } else {
      uint32_t p[KT / 16][4];
#pragma unroll
      for (int n = 0; n < KT / 64; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float e0 = vc_exp(__fsub_rn(s[n][4 * j + 2 * i], m[i]));
            float e1 = vc_exp(__fsub_rn(s[n][4 * j + 2 * i + 1], m[i]));
            l[i] += e0 + e1;
            if (drop.on) {
              const unsigned r = me.row0 + 8 * i, c = kc + 64 * n + 8 * j;
              e0 = vc_dropout_keep(r, c, drop.seed, salt, drop.thresh)
                       ? e0 * drop.inv : 0.0f;
              e1 = vc_dropout_keep(r, c + 1, drop.seed, salt, drop.thresh)
                       ? e1 * drop.inv : 0.0f;
            }
            p[4 * n + j / 2][2 * (j % 2) + i] = pack_bf16(e0, e1);
          }
      acc.fence();
      wg_fence();
#pragma unroll
      for (int np = 0; np < NP; ++np)
        pv_product<KT>(acc.o[np], p, sv + st, np);
      if constexpr (OutAcc<HDP>::TN > 0)
        pv_tail<HDP, KT>(acc.ot, p, sv + st + NP * (KT * 128));
      wg_commit();
      wg_wait0();
      acc.fence();
    }
    __syncthreads();  // the stage is free for the load two steps on
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  store_out<HDP>(acc, l, out, b, h, Lp, H, hd, me.row0, me.cq);
}

// K9's q-tiled function past 1024: one pass over 128-key tiles, each with
// its own running max; the tile's p . v lands in fresh accumulators and
// is folded in as acc * corr + pv.
template <int HDP, bool BIAS>
__global__ void __launch_bounds__(WG_THREADS)
    attention_wgmma_online_kernel(Operand<bf16> q, Operand<bf16> k,
                                  Operand<bf16> v, Bias bias,
                                  bf16* __restrict__ out, int Lp, int H,
                                  int hd, int l_actual, float scale) {
  constexpr int KT = ON_KT, NP = HDP / 64;
  using S = WgSmem<HDP, KT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + S::Q, sv = sk + 2 * S::T;
  const int h = blockIdx.x, q0 = blockIdx.y * WG_Q, b = blockIdx.z;
  const WgThread me(q0);
  const int arow = me.wg * WG_ROWS;  // this warpgroup's rows of the q tile
  const bf16* kh = k.head(b, h);
  const bf16* vh = v.head(b, h);
  const BiasRows br(bias, b, h, me.row0, Lp);
  const int nt = (l_actual + KT - 1) / KT;

  auto issue = [&](int t) {
    if (t >= nt) return;
    const uint32_t st = (t & 1) * S::T;
    load_tile<HDP, KT>(sk + st, kh, k.sr, t * KT, l_actual, hd);
    load_tile<HDP, KT>(sv + st, vh, v.sr, t * KT, l_actual, hd);
  };
  load_tile<HDP, WG_Q>(sq, q.head(b, h), q.sr, q0, Lp, hd);
  cp_commit();
  issue(0);
  cp_commit();
  // q pre-scaled in bf16: round(q * round(scale)) (the product of two
  // bf16 values is exact in f32, so this is the bf16 multiply); the
  // elementwise pass does not care about the swizzle
  cp_wait<1>();
  __syncthreads();
  {
    const float sc = __bfloat162float(__float2bfloat16(scale));
    unsigned char* qs = smem_raw + (sq - smem_u32(smem_raw));
    for (int i = threadIdx.x; i < (int)(S::Q / 16); i += WG_THREADS) {
      uint4 w = *reinterpret_cast<uint4*>(qs + 16 * i);
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        e[c] = __floats2bfloat162_rn(__low2float(e[c]) * sc,
                                     __high2float(e[c]) * sc);
      *reinterpret_cast<uint4*>(qs + 16 * i) = w;
    }
  }

  float m[2] = {ON_NEG, ON_NEG}, l[2] = {0.0f, 0.0f};
  OutAcc<HDP> acc;
  acc.zero();

  for (int t = 0; t < nt; ++t) {
    const int kc = t * KT + me.cq;
    const bool edge = (t + 1) * KT > l_actual;
    const uint32_t st = (t & 1) * S::T;
    issue(t + 1);
    cp_commit();
    float bv[2][KT / 4];  // issued before the product, to hide its latency
    if (BIAS) load_bias<KT>(bv, br.row, kc, l_actual, br.vec, edge);
    cp_wait<1>();  // this tile's K and V
    fence_async_smem();
    __syncthreads();
    float s[KT / 64][32];
    qk_product<HDP, KT>(s, sq, sk + st, arow);
    finish_scores<KT, false, BIAS>(s, bv, 1.0f, kc, l_actual, ON_NEG, edge);
    float corr[2], part[2] = {0.0f, 0.0f};
    uint32_t p[KT / 16][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], row_max<KT>(s, i, ON_NEG));
      corr[i] = vc_exp(__fsub_rn(m[i], mn));
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < KT / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float e0 = vc_exp(__fsub_rn(s[n][4 * j + 2 * i], m[i]));
          const float e1 = vc_exp(__fsub_rn(s[n][4 * j + 2 * i + 1], m[i]));
          part[i] += e0 + e1;
          p[4 * n + j / 2][2 * (j % 2) + i] = pack_bf16(e0, e1);
        }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), quad_sum(part[i]));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      float pv[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) pv[e] = 0.0f;
      fence_regs(pv);
      wg_fence();
      pv_product<KT>(pv, p, sv + st, np);
      wg_commit();
      wg_wait0();
      fence_regs(pv);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        acc.o[np][e] =
            __fadd_rn(__fmul_rn(acc.o[np][e], corr[(e / 2) % 2]), pv[e]);
    }
    if constexpr (OutAcc<HDP>::TN > 0) {
      constexpr int TN = OutAcc<HDP>::TN;
      float pv[TN];
#pragma unroll
      for (int e = 0; e < TN; ++e) pv[e] = 0.0f;
      fence_regs(pv);
      wg_fence();
      pv_tail<HDP, KT>(pv, p, sv + st + NP * (KT * 128));
      wg_commit();
      wg_wait0();
      fence_regs(pv);
#pragma unroll
      for (int e = 0; e < TN; ++e)
        acc.ot[e] = __fadd_rn(__fmul_rn(acc.ot[e], corr[(e / 2) % 2]), pv[e]);
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }
  store_out<HDP>(acc, l, out, b, h, Lp, H, hd, me.row0, me.cq);
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, online softmax
// ---------------------------------------------------------------------------

constexpr int ATT_Q = 64;   // query rows per block (one per thread)
constexpr int ATT_K = 32;   // keys per shared-memory tile
constexpr int ATT_CH = 16;  // keys per online-softmax chunk

template <int HDP>
__global__ void __launch_bounds__(ATT_Q)
    attention_kernel(Operand<float> qo, Operand<float> ko, Operand<float> vo,
                     Bias bias, float* __restrict__ out, int Lp, int H,
                     int hd, int l_actual, float scale, Dropout drop,
                     int online) {
  __shared__ __align__(16) float Ks[ATT_K][HDP];
  __shared__ __align__(16) float Vs[ATT_K][HDP];
  const int b = blockIdx.z, h = blockIdx.y;
  const int row = blockIdx.x * ATT_Q + threadIdx.x;
  const bool active = row < Lp;
  const unsigned salt = drop.salt(b, h);
  const float* qh = qo.head(b, h);
  const float* kh = ko.head(b, h);
  const float* vh = vo.head(b, h);
  const float* brow = active ? bias.row(b, h, row, Lp) : nullptr;

  // online mode: q pre-scaled (one f32 rounding), no scale after the dot
  const float qscale = online ? scale : 1.0f;
  const float sscale = online ? 1.0f : scale;
  float q[HDP], o[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    q[d] = (active && d < hd) ? qh[(size_t)row * qo.sr + d] * qscale : 0.0f;
    o[d] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < l_actual; k0 += ATT_K) {
    __syncthreads();
    for (int i = threadIdx.x; i < ATT_K * HDP; i += ATT_Q) {
      const int r = i / HDP, d = i % HDP, kr = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (kr < l_actual && d < hd) {
        kv = kh[(size_t)kr * ko.sr + d];
        vv = vh[(size_t)kr * vo.sr + d];
      }
      Ks[r][d] = kv;
      Vs[r][d] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int nt = min(ATT_K, l_actual - k0);
    for (int c0 = 0; c0 < nt; c0 += ATT_CH) {
      float s[ATT_CH];
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < ATT_CH; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int d = 0; d < HDP; ++d) acc = fmaf(q[d], Ks[c0 + j][d], acc);
        float sv = acc * sscale;
        if (brow && c0 + j < nt) sv += brow[k0 + c0 + j];
        sv = (c0 + j < nt) ? sv : -INFINITY;
        s[j] = sv;
        mc = fmaxf(mc, sv);
      }
      if (mc > m) {
        const float f = expf(m - mc);  // 0 on the first chunk (m = -inf)
        l *= f;
#pragma unroll
        for (int d = 0; d < HDP; ++d) o[d] *= f;
        m = mc;
      }
#pragma unroll
      for (int j = 0; j < ATT_CH; ++j) {
        float p = expf(s[j] - m);
        l += p;
        if (drop.on)
          p = vc_dropout_keep(row, k0 + c0 + j, drop.seed, salt, drop.thresh)
                  ? p * drop.inv
                  : 0.0f;
#pragma unroll
        for (int d = 0; d < HDP; ++d) o[d] = fmaf(p, Vs[c0 + j][d], o[d]);
      }
    }
  }
  if (!active) return;
  const float den = fmaxf(l, 1e-30f);
  float* orow = out + ((size_t)b * Lp + row) * H + h * hd;
  for (int d = 0; d < hd; ++d) orow[d] = o[d] / den;
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

template <int HDP>
static int launch_cc(const Operand<float>* qkv, Bias bias, void* out, int B,
                     int Lp, int H, int nh, int l_actual, float scale,
                     Dropout drop, int online, cudaStream_t s) {
  dim3 grid((Lp + ATT_Q - 1) / ATT_Q, nh, B);
  attention_kernel<HDP><<<grid, ATT_Q, 0, s>>>(
      qkv[0], qkv[1], qkv[2], bias, static_cast<float*>(out), Lp, H, H / nh,
      l_actual, scale, drop, online);
  return 0;
}

// the bf16 kernels' grid: heads fastest, then query tiles, then images
static dim3 wg_grid(int B, int Lp, int nh) {
  return dim3(nh, (Lp + WG_Q - 1) / WG_Q, B);
}

template <int HDP, bool BIAS>
static int launch_wg(const Operand<bf16>* qkv, Bias bias, void* out, int B,
                     int Lp, int H, int nh, int l_actual, float scale,
                     Dropout drop, cudaStream_t s) {
  constexpr size_t bytes = WgSmem<HDP, WG_KT>::BYTES;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t e = allow_smem(
      (const void*)attention_wgmma_kernel<HDP, BIAS>, bytes, done);
  if (e != cudaSuccess) return (int)e;
  attention_wgmma_kernel<HDP, BIAS>
      <<<wg_grid(B, Lp, nh), WG_THREADS, bytes, s>>>(
          qkv[0], qkv[1], qkv[2], bias, static_cast<bf16*>(out), Lp, H,
          H / nh, l_actual, scale, drop);
  return 0;
}

template <int HDP, bool BIAS>
static int launch_online(const Operand<bf16>* qkv, Bias bias, void* out,
                         int B, int Lp, int H, int nh, int l_actual,
                         float scale, cudaStream_t s) {
  constexpr size_t bytes = WgSmem<HDP, ON_KT>::BYTES;
  static std::atomic<unsigned long long> done{0};
  const cudaError_t e = allow_smem(
      (const void*)attention_wgmma_online_kernel<HDP, BIAS>, bytes, done);
  if (e != cudaSuccess) return (int)e;
  attention_wgmma_online_kernel<HDP, BIAS>
      <<<wg_grid(B, Lp, nh), WG_THREADS, bytes, s>>>(
          qkv[0], qkv[1], qkv[2], bias, static_cast<bf16*>(out), Lp, H,
          H / nh, l_actual, scale);
  return 0;
}

template <int HDP>
static int launch_bf16(const Operand<bf16>* ops, Bias bs, void* out, int B,
                       int Lp, int H, int nh, int l_actual, float scale,
                       Dropout drop, int online, cudaStream_t s) {
  if (online)
    return bs.p ? launch_online<HDP, true>(ops, bs, out, B, Lp, H, nh,
                                           l_actual, scale, s)
                : launch_online<HDP, false>(ops, bs, out, B, Lp, H, nh,
                                            l_actual, scale, s);
  return bs.p ? launch_wg<HDP, true>(ops, bs, out, B, Lp, H, nh, l_actual,
                                     scale, drop, s)
              : launch_wg<HDP, false>(ops, bs, out, B, Lp, H, nh, l_actual,
                                      scale, drop, s);
}

// q, k, v: base pointers with batch, head and row strides in elements;
// bias: base pointer (or null) with batch and head strides, rows of Lp
// (the wrapper checks alignment and shapes); out: contiguous (B, Lp, H).
// online: K9's online softmax past 1024 (no dropout).  hdp: the bf16
// instance's head columns (64, 80, 96 or 128, at least hd;
// ops/attention.py plan), ignored in f32.
extern "C" int vc_attention(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* k, long long k_sb, long long k_sh, long long k_sr,
    const void* v, long long v_sb, long long v_sh, long long v_sr,
    const void* bias, long long bias_sb, long long bias_sh, void* out, int B,
    int Lp, int H, int nh, int l_actual, float scale, unsigned seed,
    unsigned thresh, float inv, int nh_total, int head_offset, int online,
    int hdp, int dtype, void* stream) {
  if (nh <= 0 || H % nh || head_offset < 0 || nh_total < nh + head_offset)
    return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, inv, thresh != 0u || inv != 1.0f,
                     (unsigned)nh_total, (unsigned)head_offset};
  const int hd = H / nh;
  if (hd % 8 || hd > 128 || H % 8) return (int)cudaErrorInvalidValue;
  if (online && drop.on) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias bs{static_cast<const float*>(bias), bias_sb, bias_sh};
  int rc = 0;
  if (dtype == VC_BF16) {
    const Operand<bf16> ops[3] = {
        {static_cast<const bf16*>(q), q_sb, q_sh, q_sr},
        {static_cast<const bf16*>(k), k_sb, k_sh, k_sr},
        {static_cast<const bf16*>(v), v_sb, v_sh, v_sr}};
    if (hdp < hd) return (int)cudaErrorInvalidValue;
#define VC_ATT_CASE(HDP)                                                   \
  case HDP:                                                                \
    rc = launch_bf16<HDP>(ops, bs, out, B, Lp, H, nh, l_actual, scale,     \
                          drop, online, s);                                \
    break;
    switch (hdp) {
      VC_ATT_CASE(64)
      VC_ATT_CASE(80)
      VC_ATT_CASE(96)
      VC_ATT_CASE(128)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef VC_ATT_CASE
  } else if (dtype == VC_F32) {
    const Operand<float> ops[3] = {
        {static_cast<const float*>(q), q_sb, q_sh, q_sr},
        {static_cast<const float*>(k), k_sb, k_sh, k_sr},
        {static_cast<const float*>(v), v_sb, v_sh, v_sr}};
    if (hd <= 16)
      rc = launch_cc<16>(ops, bs, out, B, Lp, H, nh, l_actual, scale, drop,
                         online, s);
    else if (hd <= 32)
      rc = launch_cc<32>(ops, bs, out, B, Lp, H, nh, l_actual, scale, drop,
                         online, s);
    else if (hd <= 64)
      rc = launch_cc<64>(ops, bs, out, B, Lp, H, nh, l_actual, scale, drop,
                         online, s);
    else
      rc = launch_cc<128>(ops, bs, out, B, Lp, H, nh, l_actual, scale, drop,
                          online, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch configuration of the bf16 kernels, for the measurement scripts
// ---------------------------------------------------------------------------

#define WG_KERNEL(kernel, HDP, BIAS, KT)                                 \
  {#kernel "<" #HDP ", " #BIAS ">", (const void*)kernel<HDP, BIAS>,       \
   WG_THREADS, WgSmem<HDP, KT>::BYTES}
static const WgKernel WG_KERNELS[] = {
    WG_KERNEL(attention_wgmma_kernel, 64, false, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 64, true, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 80, false, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 80, true, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 96, false, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 96, true, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 128, false, WG_KT),
    WG_KERNEL(attention_wgmma_kernel, 128, true, WG_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 64, false, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 64, true, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 80, false, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 80, true, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 96, false, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 96, true, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 128, false, ON_KT),
    WG_KERNEL(attention_wgmma_online_kernel, 128, true, ON_KT),
};
#undef WG_KERNEL

// Kernel `index` of the bf16 kernels and its launch configuration
// (wg_kernel_info, wgmma.cuh); -1 past the last kernel.
extern "C" int vc_attention_kernel_info(int index, char* name, int len,
                                        int* info) {
  return wg_kernel_info(WG_KERNELS, sizeof(WG_KERNELS) / sizeof(WgKernel),
                        index, name, len, info);
}
