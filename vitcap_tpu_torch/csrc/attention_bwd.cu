// attention_bwd: the gradient of softmax attention (with the optional
// additive (B, 1 | nH, Lp, Lp) f32 bias and attention-prob dropout) with
// respect to q, k and v, given the upstream gradient g.  q, k, v and g are
// per-head operands read by base pointer and batch, head and row strides
// (Operand, common.cuh): a fused (B, Lp, 3H) qkv slab is q = slab,
// k = slab + H, v = slab + 2H with row stride 3H, the packed train route
// passes separate tensors or views, flash_attention (K9) (B, nH, L, dh)
// tensors or views.  Outputs dq, dk, dv are contiguous (B, Lp, H) in the
// operands' dtype, head h at columns [h * hd, (h + 1) * hd).
//
// Replaces the one-pass recompute backward of K8,
// vitcap_tpu/ops/flash_attention.py:882 flash_bwd_packed_slab (the slab)
// and :734 _flash_bwd_packed (separate q, k, v), with their kernels :530
// _bwd_packed_pair_kernel / :600 _bwd_packed_kernel, and the one-pass
// backward of K9 up to 1024 padded tokens, :372 _flash_bwd_onepass (:324
// _bwd_onepass_kernel: the same math at rate 0, with a per-head bias or
// none).  Their math, per (image, head):
//   s = q k^T * scale + bias, keys >= l_actual masked;
//   p = exp(s - max) / max(l, 1e-30)        (f32, the undropped softmax)
//   pd = keep ? p / (1 - rate) : 0          (dropout regenerated)
//   dv = round(pd)^T g;  dp = g v^T, then keep ? dp / (1 - rate) : 0
//   r = sum_k dp p;  ds = round(p (dp - r))
//   dq = ds k * scale;  dk = ds^T q * scale
// with every product summed in f32 and round() the compute dtype.  The
// keep bit is vc_dropout_keep(query row, key column, seed, the global head
// b * nh_total + head_offset + h), the bits the forward (attention.cu)
// used.
//
// What bounds it on the H100: per (image, head) five products of Lp x L x
// hd (s, dp, dv, dq, dk), 10 Lp L hd flops against 7 Lp hd operand values
// (about 400 flops a byte at Lp 592, hd 64), far on the compute side of
// the card's balance point.  Beside the tensor cores, every (query, key)
// pair costs CUDA-core work in each kernel that forms p (the scale, the
// bias, exp, the dropout hash, p (dp - r), the bf16 packing), and the bias
// costs its bytes once per pass that forms s (B nH Lp L 4 bytes per pass,
// from L2 when it is broadcast over the heads).  The TPU kernel holds a
// whole (Lp x Lp) score block per head in VMEM; a Hopper block cannot, and
// dk/dv sum over every query while dq sums over every key, so two kernels,
// deterministic, with no atomics.
//
// What the design does about it (bf16): every product is
// wgmma.m64n64k16 (wgmma.cuh) with the accumulators in registers, and no
// score, dS or accumulator goes through shared memory.  The time is set by
// how well the tensor-core and CUDA-core phases of different blocks
// overlap, so a block is one warpgroup (128 threads) of 64 rows of one
// head, (a) holds three blocks per SM (__launch_bounds__(128, 3)) and (b)
// two, with no spills, 50-51 KB of shared memory a block.  Tried on the
// H100 against this design and slower on the flagship rows (PERF.md):
// blocks of two warpgroups sharing each streamed tile, as the forward has
// them (one block per SM, its warpgroups in lockstep at every tile's
// barrier); (a) at two blocks per SM (the biased rows); separate waits for
// S and dP, to overlap one product with the other's CUDA-core work; and
// keeping (a)'s keep bits in shared memory between its passes.  Without a
// bias the exponent is one fma of the raw product (exp_offset), which was
// faster on those rows.
// (a) query-major (dq and the f32 row statistics m, l, r): a statistics
//     pass over 64-key tiles forms S = q k^T and dP = g v^T (q, g and the
//     K, V tiles K-major in shared memory, the two products behind one
//     wait) and keeps m, l and r_acc = sum dp exp(s - m) online, both sums
//     rescaled by exp(m_old - m_new) when the max grows, r = r_acc / l at
//     the end (the TPU's r = sum dp p, not rowsum(g o)); a second pass
//     recomputes S and dP, forms ds = round(p (dp - r)) in place in the
//     accumulator registers as bf16 pairs, which are the A operand of
//     dq += ds K, the same K tile read MN-major.  5 products (6 before).
// (b) key-major (dk and dv), over 64-query tiles: S^T = k q^T and dP^T =
//     v g^T, p from the tile's m and 1 / max(l, 1e-30) (staged per query
//     column in shared memory, with r, one step ahead), the keep bits
//     regenerated, pd and ds as bf16 A fragments, dv += pd^T G and
//     dk += ds^T Q with G and Q read MN-major; dk and dv stay f32 register
//     accumulators over the whole loop.  4 products.
// The streamed tiles (K, V in (a); Q, G in (b)) load one step ahead
// through a two-stage ring of cp.async copies in the 128-byte swizzle; exp
// is ex2.approx (vc_exp) and each row takes one reciprocal of max(l,
// 1e-30); the mask runs on the tile that holds l_actual only; the grid
// runs the heads fastest, so the heads that read one head-broadcast bias
// run back to back and find it in L2.  (a) reads the bias as the forward
// does (a group of four lanes reads 32 contiguous bytes of one query
// row).  (b) needs it transposed (keys down the accumulator's rows) and
// reads it with the keys along the lanes: one load instruction of a warp
// reads four runs of 8 consecutive keys, 32 bytes of each of four query
// rows, so every 32-byte sector it touches is used whole when Lp is a
// multiple of 8 (the train lengths), with no staging through shared
// memory and no extra pass.  A (b) block whose keys all lie at or past
// l_actual only writes zeros; keys in [l_actual, Lp) get written zeros in
// dk and dv, and query rows in [l_actual, Lp) count in dk and dv as in the
// plain version.  Shared memory and registers do not depend on Lp; the
// grids have ceil(Lp / 64) blocks per head and every offset is a size_t
// product, so the same kernels serve 512-px training (Lp 1152 with
// l_actual 1025, Lp 1104 with the bias).  Head dims of 8-64 are padded
// with zeros to 64.
// f32 runs on the CUDA cores in exact f32 (no TF32), one thread per row.
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: wgmma, one warpgroup of 64 rows a block
// ---------------------------------------------------------------------------

constexpr int BW_HD = 64;        // head dims padded to 64 (one 128-byte line)
constexpr int BW_T = 64;         // keys per tile of (a), queries of (b)
constexpr int BW_ROWS = WG_ROWS;  // a block's own rows: one warpgroup
constexpr int BW_THREADS = 128;

// Dynamic shared memory of both kernels, each tile 1024-byte aligned: the
// block's own BW_ROWS rows of two operands ((a): q, g; (b): k, v), then two
// stages of each streamed operand ((a): K, V; (b): Q, G).
struct BwdSmem {
  static constexpr uint32_t ROWS = BW_ROWS * BW_HD * 2;
  static constexpr uint32_t T = BW_T * BW_HD * 2;
  static constexpr size_t BYTES = 2 * ROWS + 4 * T + 1024;  // + alignment
};

// acc * mul -> rows row0, row0 + 8 (those below Lp), columns below hd of
// head h in the contiguous (B, Lp, H) output, as bf16 pairs
__device__ __forceinline__ void store_rows(const float (&acc)[32], float mul,
                                           bf16* __restrict__ out, int b,
                                           int h, int Lp, int H, int hd,
                                           int row0, int cq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + cq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      if (col < hd && r < Lp)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((size_t)b * Lp + r) * H + h * hd + col) =
            __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * i], mul),
                                  __fmul_rn(acc[4 * j + 2 * i + 1], mul));
    }
  }
}

// dp with the dropout applied: keep ? dp / (1 - rate) : 0
__device__ __forceinline__ float dropped(float x, bool keep,
                                         const Dropout& drop) {
  return keep ? __fmul_rn(x, drop.inv) : 0.0f;
}

// Without a bias the exponent is one fma of the raw product: exp(s scale -
// m) / l = 2^(s (scale log2 e) + nb) with the row's offset nb = -(m log2 e
// + log2 max(l, 1e-30)).  It moves p by a few f32 ulps against the plain
// version's separate operations; the bf16 outputs stay at least 99%
// bit-equal.
__device__ __forceinline__ float exp_offset(float m, float l) {
  return -(m * VC_LOG2E + __log2f(fmaxf(l, 1e-30f)));
}

// (a): dq and the row statistics (m, l, r) of one (64-query block, head,
// image).  Steps 0 .. nt - 1 are the statistics pass over the 64-key
// tiles, steps nt .. 2 nt - 1 the ds . K pass; K and V tiles load one step
// ahead through the two-stage ring.  Three blocks per SM (at most 168
// registers a thread).
template <bool BIAS>
__global__ void __launch_bounds__(BW_THREADS, 3)
    attn_bwd_q_wgmma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                     Operand<bf16> g, Bias bias, bf16* __restrict__ dq,
                     float* __restrict__ mlr, int Lp, int H, int hd,
                     int l_actual, float scale, Dropout drop) {
  constexpr int KT = BW_T;
  using S = BwdSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sg = sq + S::ROWS, sk = sg + S::ROWS, sv = sk + 2 * S::T;
  const int h = blockIdx.x, q0 = blockIdx.y * BW_ROWS, b = blockIdx.z;
  const int nh = gridDim.x;
  const WgThread me(q0);
  const unsigned salt = drop.salt(b, h);
  const int nt = (l_actual + KT - 1) / KT;

  // the head and bias row pointers are formed where they are used: held
  // across the loop they cost the registers of a third block per SM
  auto issue = [&](int step) {
    if (step >= 2 * nt) return;
    const int k0 = (step < nt ? step : step - nt) * KT;
    const uint32_t st = (step & 1) * S::T;
    load_tile<BW_HD, KT, BW_THREADS>(sk + st, k.head(b, h), k.sr, k0,
                                     l_actual, hd);
    load_tile<BW_HD, KT, BW_THREADS>(sv + st, v.head(b, h), v.sr, k0,
                                     l_actual, hd);
  };
  load_tile<BW_HD, BW_ROWS, BW_THREADS>(sq, q.head(b, h), q.sr, q0, Lp, hd);
  load_tile<BW_HD, BW_ROWS, BW_THREADS>(sg, g.head(b, h), g.sr, q0, Lp, hd);
  issue(0);
  cp_commit();

  // m, l and r_acc of rows row0, row0 + 8 (l and r_acc over this thread's
  // columns until the end of the statistics pass), then 1 / max(l, 1e-30)
  // and, without a bias, the exponent's offset nb (exp_offset)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float r[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f}, nb[2] = {0.0f, 0.0f};
  const float sl2e = scale * VC_LOG2E;
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

  for (int step = 0; step < 2 * nt; ++step) {
    const bool pass2 = step >= nt;
    const int k0 = (pass2 ? step - nt : step) * KT, kc = k0 + me.cq;
    const bool edge = k0 + KT > l_actual;  // the tile holds masked keys
    const uint32_t st = (step & 1) * S::T;
    issue(step + 1);
    cp_commit();
    float bv[2][KT / 4];  // issued before the products, to hide its latency
    if (BIAS) {
      const BiasRows br(bias, b, h, me.row0, Lp);
      load_bias<KT>(bv, br.row, kc, l_actual, br.vec, edge);
    }
    cp_wait<1>();  // this step's K and V
    fence_async_smem();
    __syncthreads();
    float s[1][32], dp[1][32];
    fence_regs(s[0]);
    fence_regs(dp[0]);
    wg_fence();
    ss_issue<BW_HD, KT, BW_ROWS>(s, sq, sk + st);
    ss_issue<BW_HD, KT, BW_ROWS>(dp, sg, sv + st);
    wg_commit();
    wg_wait0();
    fence_regs(s[0]);
    fence_regs(dp[0]);
    // with a bias s scale + bias, rounded as the plain version rounds it;
    // without one the raw products (the scale goes into the exponent)
    finish_scores<KT, BIAS, BIAS>(s, bv, scale, kc, l_actual, -INFINITY,
                                  edge);
    if (!pass2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // max(round(s scale)) = round(max(s) scale) for scale > 0
        const float mn =
            BIAS ? row_max<KT>(s, i, m[i])
                 : fmaxf(m[i],
                         __fmul_rn(row_max<KT>(s, i, -INFINITY), scale));
        const float corr = vc_exp(__fsub_rn(m[i], mn));  // 0 on tile 0
        m[i] = mn;
        nb[i] = -(mn * VC_LOG2E);
        l[i] = __fmul_rn(l[i], corr);
        r[i] = __fmul_rn(r[i], corr);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = e / 4, i = (e / 2) % 2, c = e % 2;
        const float x = BIAS ? vc_exp(__fsub_rn(s[0][e], m[i]))
                             : vc_exp2(fmaf(s[0][e], sl2e, nb[i]));
        float d = dp[0][e];
        if (drop.on)
          d = dropped(d,
                      vc_dropout_keep(me.row0 + 8 * i, kc + 8 * j + c,
                                      drop.seed, salt, drop.thresh),
                      drop);
        l[i] = __fadd_rn(l[i], x);
        r[i] = __fmaf_rn(d, x, r[i]);
      }
    } else {
      uint32_t ds[KT / 16][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float y[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * i + c;
            const float p =
                BIAS ? __fmul_rn(vc_exp(__fsub_rn(s[0][e], m[i])), inv[i])
                     : vc_exp2(fmaf(s[0][e], sl2e, nb[i]));
            float d = dp[0][e];
            if (drop.on)
              d = dropped(d,
                          vc_dropout_keep(me.row0 + 8 * i, kc + 8 * j + c,
                                          drop.seed, salt, drop.thresh),
                          drop);
            y[c] = __fmul_rn(p, __fsub_rn(d, r[i]));
          }
          ds[j / 2][2 * (j % 2) + i] = pack_bf16(y[0], y[1]);
        }
      fence_regs(acc);
      wg_fence();
      pv_product<KT>(acc, ds, sk + st, 0);
      wg_commit();
      wg_wait0();
      fence_regs(acc);
    }
    if (step == nt - 1) {  // the statistics are complete
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = quad_sum(l[i]);
        inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
        nb[i] = exp_offset(m[i], l[i]);
        r[i] = __fmul_rn(quad_sum(r[i]), inv[i]);
      }
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  store_rows(acc, scale, dq, b, h, Lp, H, hd, me.row0, me.cq);
  if (me.cq == 0) {
    const size_t plane = (size_t)gridDim.z * nh * Lp;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = me.row0 + 8 * i;
      if (row < Lp) {
        const size_t at = ((size_t)b * nh + h) * Lp + row;
        mlr[at] = m[i];
        mlr[plane + at] = l[i];
        mlr[2 * plane + at] = r[i];
      }
    }
  }
}

// (b)'s bias: this thread's f32 bias at queries qc + 8 j + c (j < QT / 8,
// c < 2) of its keys key[i]: bv[i][2 j + c], from the head's (query, key)
// rows at bh (rows of Lp); 0 at queries past Lp and at masked keys (checked
// on an EDGE tile only).  Consecutive lane groups hold consecutive keys, so
// one load instruction of a warp reads four runs of 8 keys (32 bytes), one
// run per query row.
template <int QT, bool EDGE>
__device__ __forceinline__ void load_bias_t(float (&bv)[2][QT / 4],
                                            const float* bh, int Lp, int qc,
                                            const int (&key)[2],
                                            const bool (&kok)[2]) {
#pragma unroll
  for (int j = 0; j < QT / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int qq = qc + 8 * j + c;
      const float* row = bh + (size_t)qq * Lp;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        bv[i][2 * j + c] =
            !EDGE || (qq < Lp && kok[i]) ? __ldg(row + key[i]) : 0.0f;
    }
}

template <int QT>
__device__ __forceinline__ void load_bias_t(float (&bv)[2][QT / 4],
                                            const float* bh, int Lp, int qc,
                                            const int (&key)[2],
                                            const bool (&kok)[2],
                                            bool edge) {
  if (edge)
    load_bias_t<QT, true>(bv, bh, Lp, qc, key, kok);
  else
    load_bias_t<QT, false>(bv, bh, Lp, qc, key, kok);
}

// (b): dk and dv of one (64-key block, head, image), over the 64-query
// tiles of the head; Q and G tiles load one step ahead through the
// two-stage ring, the tile's m, 1 / max(l, 1e-30) and r with them.  A
// block whose keys all lie at or past l_actual only writes its zeros.
template <bool BIAS>
__global__ void __launch_bounds__(BW_THREADS)
    attn_bwd_kv_wgmma(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                      Operand<bf16> g, Bias bias,
                      const float* __restrict__ mlr, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Lp, int H, int hd,
                      int l_actual, float scale, Dropout drop) {
  constexpr int QT = BW_T;
  using S = BwdSmem;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(16) float stats[2][3][QT];  // per stage: m, 1/l, r
  const uint32_t sk = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sv = sk + S::ROWS, sq = sv + S::ROWS, sg = sq + 2 * S::T;
  const int h = blockIdx.x, kb0 = blockIdx.y * BW_ROWS, b = blockIdx.z;
  const int nh = gridDim.x;
  const WgThread me(kb0);  // rows are keys: row0 is the first of two keys
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.0f;
  if (kb0 >= l_actual) {
    store_rows(dka, scale, dk, b, h, Lp, H, hd, me.row0, me.cq);
    store_rows(dva, 1.0f, dv, b, h, Lp, H, hd, me.row0, me.cq);
    return;
  }
  const unsigned salt = drop.salt(b, h);
  const bf16* qh = q.head(b, h);
  const bf16* gh = g.head(b, h);
  const float* bh = bias.row(b, h, 0, Lp);  // null without a bias
  const size_t plane = (size_t)gridDim.z * nh * Lp;
  const float* mrow = mlr + ((size_t)b * nh + h) * Lp;
  const int nt = (Lp + QT - 1) / QT;
  const bool kedge = kb0 + BW_ROWS > l_actual;  // the block holds masked keys
  const float sl2e = scale * VC_LOG2E;
  const int key[2] = {me.row0, me.row0 + 8};
  const bool kok[2] = {key[0] < l_actual, key[1] < l_actual};
  const int ti = threadIdx.x;

  auto issue = [&](int t) {
    if (t >= nt) return;
    const uint32_t st = (t & 1) * S::T;
    load_tile<BW_HD, QT, BW_THREADS>(sq + st, qh, q.sr, t * QT, Lp, hd);
    load_tile<BW_HD, QT, BW_THREADS>(sg + st, gh, g.sr, t * QT, Lp, hd);
  };
  // query tile t's statistics: read at the top of a step, stored to their
  // stage at its end (without a bias the exponent's offset in m's place,
  // exp_offset); rows past Lp get 1/l = 0 (offset -inf) and r = 0, so
  // p = 0
  float nx[3] = {0.0f, 0.0f, 0.0f};
  auto fetch = [&](int t) {
    const int qi = t * QT + ti;
    if (t < nt && ti < QT && qi < Lp) {
      nx[0] = mrow[qi];
      nx[1] = mrow[plane + qi];
      nx[2] = mrow[2 * plane + qi];
    }
  };
  auto stash = [&](int t) {
    const int qi = t * QT + ti;
    if (t < nt && ti < QT) {
      const bool ok = qi < Lp;
      stats[t & 1][0][ti] = !ok ? (BIAS ? 0.0f : -INFINITY)
                                : BIAS ? nx[0] : exp_offset(nx[0], nx[1]);
      stats[t & 1][1][ti] = ok ? 1.0f / fmaxf(nx[1], 1e-30f) : 0.0f;
      stats[t & 1][2][ti] = ok ? nx[2] : 0.0f;
    }
  };
  load_tile<BW_HD, BW_ROWS, BW_THREADS>(sk, k.head(b, h), k.sr, kb0,
                                        l_actual, hd);
  load_tile<BW_HD, BW_ROWS, BW_THREADS>(sv, v.head(b, h), v.sr, kb0,
                                        l_actual, hd);
  issue(0);
  cp_commit();
  fetch(0);
  stash(0);

  for (int t = 0; t < nt; ++t) {
    const int q0 = t * QT, qc = q0 + me.cq;
    const bool qedge = q0 + QT > Lp;  // the tile holds rows past Lp
    const uint32_t st = (t & 1) * S::T;
    issue(t + 1);
    cp_commit();
    fetch(t + 1);
    float bv[2][QT / 4];  // issued before the products, to hide its latency
    if (BIAS) load_bias_t<QT>(bv, bh, Lp, qc, key, kok, qedge || kedge);
    cp_wait<1>();  // this step's Q and G
    fence_async_smem();
    __syncthreads();
    float s[1][32], dp[1][32];
    fence_regs(s[0]);
    fence_regs(dp[0]);
    wg_fence();
    ss_issue<BW_HD, QT, BW_ROWS>(s, sk, sq + st);
    ss_issue<BW_HD, QT, BW_ROWS>(dp, sv, sg + st);
    wg_commit();
    wg_wait0();
    fence_regs(s[0]);
    fence_regs(dp[0]);
    const float(&sm)[3][QT] = stats[t & 1];
    uint32_t pd[QT / 16][4], ds[QT / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + me.cq;
      const float2 mm = *reinterpret_cast<const float2*>(&sm[0][col]);
      const float2 il = *reinterpret_cast<const float2*>(&sm[1][col]);
      const float2 rr = *reinterpret_cast<const float2*>(&sm[2][col]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float yp[2], yd[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          float p;
          if (BIAS) {
            const float x =
                __fadd_rn(__fmul_rn(s[0][e], scale), bv[i][2 * j + c]);
            p = __fmul_rn(vc_exp(__fsub_rn(x, c ? mm.y : mm.x)),
                          c ? il.y : il.x);
          } else {
            p = vc_exp2(fmaf(s[0][e], sl2e, c ? mm.y : mm.x));
          }
          if (kedge && !kok[i]) p = 0.0f;
          float d = dp[0][e], pdv = p;
          if (drop.on) {
            const bool keep = vc_dropout_keep(q0 + col + c, key[i],
                                              drop.seed, salt, drop.thresh);
            d = dropped(d, keep, drop);
            pdv = dropped(p, keep, drop);
          }
          yp[c] = pdv;
          yd[c] = __fmul_rn(p, __fsub_rn(d, c ? rr.y : rr.x));
        }
        pd[j / 2][2 * (j % 2) + i] = pack_bf16(yp[0], yp[1]);
        ds[j / 2][2 * (j % 2) + i] = pack_bf16(yd[0], yd[1]);
      }
    }
    fence_regs(dka);
    fence_regs(dva);
    wg_fence();
    pv_product<QT>(dva, pd, sg + st, 0);
    pv_product<QT>(dka, ds, sq + st, 0);
    wg_commit();
    wg_wait0();
    fence_regs(dka);
    fence_regs(dva);
    stash(t + 1);
    __syncthreads();  // the stages are free for the loads two steps on
  }
  store_rows(dka, scale, dk, b, h, Lp, H, hd, me.row0, me.cq);
  store_rows(dva, 1.0f, dv, b, h, Lp, H, hd, me.row0, me.cq);
}

template <bool BIAS>
int launch_bf16(const Operand<bf16>* in, Bias bias, void* dq, void* dk,
                void* dv, float* mlr, int B, int Lp, int H, int nh,
                int l_actual, float scale, Dropout drop, cudaStream_t s) {
  static std::atomic<unsigned long long> done_q{0}, done_kv{0};
  cudaError_t e = allow_smem((const void*)attn_bwd_q_wgmma<BIAS>,
                             BwdSmem::BYTES, done_q);
  if (e == cudaSuccess)
    e = allow_smem((const void*)attn_bwd_kv_wgmma<BIAS>, BwdSmem::BYTES,
                   done_kv);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nh, (Lp + BW_ROWS - 1) / BW_ROWS, B);  // heads fastest
  attn_bwd_q_wgmma<BIAS><<<grid, BW_THREADS, BwdSmem::BYTES, s>>>(
      in[0], in[1], in[2], in[3], bias, static_cast<bf16*>(dq), mlr, Lp, H,
      H / nh, l_actual, scale, drop);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_bwd_kv_wgmma<BIAS><<<grid, BW_THREADS, BwdSmem::BYTES, s>>>(
      in[0], in[1], in[2], in[3], bias, mlr, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Lp, H, H / nh, l_actual, scale, drop);
  return 0;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, one thread per row, exact f32
// ---------------------------------------------------------------------------

constexpr int FR = 64;   // rows (queries or keys) per block, one per thread
constexpr int FT = 16;   // rows of the other side per shared-memory tile

// (a) in f32: q and g of the block's rows transposed in smem ([d][row],
// conflict-free), dq in registers, K/V tiles of FT keys
template <int D>
__global__ void __launch_bounds__(FR)
    attn_bwd_q_f32(Operand<float> q, Operand<float> k, Operand<float> v,
                   Operand<float> g, Bias bias, float* __restrict__ dq,
                   float* __restrict__ mlr, int Lp, int H, int hd,
                   int l_actual, float scale, Dropout drop) {
  __shared__ float qs[D][FR], gs[D][FR], ks[FT][D], vs[FT][D];
  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y;
  const int t = threadIdx.x, qrow = blockIdx.x * FR + t;
  const bool active = qrow < Lp;
  const unsigned salt = drop.salt(b, h);
  const float* qh = q.head(b, h);
  const float* kh = k.head(b, h);
  const float* vh = v.head(b, h);
  const float* gh = g.head(b, h);
  const float* brow = active ? bias.row(b, h, qrow, Lp) : nullptr;
  for (int d = 0; d < D; ++d) {
    const bool ok = active && d < hd;
    qs[d][t] = ok ? qh[(size_t)qrow * q.sr + d] : 0.0f;
    gs[d][t] = ok ? gh[(size_t)qrow * g.sr + d] : 0.0f;
  }
  auto load = [&](int k0) {
    __syncthreads();
    for (int i = t; i < FT * D; i += FR) {
      const int r = i / D, d = i % D, kr = k0 + r;
      const bool ok = kr < l_actual && d < hd;
      ks[r][d] = ok ? kh[(size_t)kr * k.sr + d] : 0.0f;
      vs[r][d] = ok ? vh[(size_t)kr * v.sr + d] : 0.0f;
    }
    __syncthreads();
  };
  auto score = [&](int k0, int j) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc = fmaf(qs[d][t], ks[j][d], acc);
    float sv = acc * scale;
    if (brow) sv += brow[k0 + j];
    return sv;
  };
  auto dprod = [&](int k0, int j) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc = fmaf(gs[d][t], vs[j][d], acc);
    if (drop.on)
      acc = vc_dropout_keep(qrow, k0 + j, drop.seed, salt, drop.thresh)
                ? acc * drop.inv
                : 0.0f;
    return acc;
  };

  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += FT) {
    load(k0);
    const int nt = min(FT, l_actual - k0);
    for (int j = 0; j < nt; ++j) {
      const float sv = score(k0, j);
      if (sv > m) {
        l *= expf(m - sv);
        m = sv;
      }
      l += expf(sv - m);
    }
  }
  const float den = fmaxf(l, 1e-30f);
  float r = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += FT) {
    load(k0);
    const int nt = min(FT, l_actual - k0);
    for (int j = 0; j < nt; ++j)
      r += dprod(k0, j) * (expf(score(k0, j) - m) / den);
  }
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += FT) {
    load(k0);
    const int nt = min(FT, l_actual - k0);
    for (int j = 0; j < nt; ++j) {
      const float p = expf(score(k0, j) - m) / den;
      const float ds = p * (dprod(k0, j) - r);
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, ks[j][d], acc[d]);
    }
  }
  if (!active) return;
  float* orow = dq + ((size_t)b * Lp + qrow) * H + h * hd;
  for (int d = 0; d < hd; ++d) orow[d] = acc[d] * scale;
  const size_t i = ((size_t)b * nh + h) * Lp + qrow;
  const size_t plane = (size_t)gridDim.z * nh * Lp;
  mlr[i] = m;
  mlr[plane + i] = l;
  mlr[2 * plane + i] = r;
}

// (b) in f32: k and v of the block's keys transposed in smem, dk and dv in
// registers, q/g tiles of FT query rows with their m, l, r
template <int D>
__global__ void __launch_bounds__(FR)
    attn_bwd_kv_f32(Operand<float> q, Operand<float> k, Operand<float> v,
                    Operand<float> g, Bias bias,
                    const float* __restrict__ mlr, float* __restrict__ dk,
                    float* __restrict__ dv, int Lp, int H, int hd,
                    int l_actual, float scale, Dropout drop) {
  __shared__ float ks[D][FR], vs[D][FR], qt[FT][D], gt[FT][D];
  __shared__ float sm_m[FT], sm_l[FT], sm_r[FT];
  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y;
  const int t = threadIdx.x, key = blockIdx.x * FR + t;
  const bool key_ok = key < l_actual;
  const unsigned salt = drop.salt(b, h);
  const float* qh = q.head(b, h);
  const float* gh = g.head(b, h);
  const float* bh = bias.row(b, h, 0, Lp);  // null without a bias
  const size_t plane = (size_t)gridDim.z * nh * Lp;
  const float* mrow = mlr + ((size_t)b * nh + h) * Lp;
  for (int d = 0; d < D; ++d) {
    const bool ok = key_ok && d < hd;
    ks[d][t] = ok ? k.head(b, h)[(size_t)key * k.sr + d] : 0.0f;
    vs[d][t] = ok ? v.head(b, h)[(size_t)key * v.sr + d] : 0.0f;
  }
  float ak[D], av[D];
#pragma unroll
  for (int d = 0; d < D; ++d) ak[d] = av[d] = 0.0f;
  for (int t0 = 0; t0 < Lp; t0 += FT) {
    __syncthreads();
    for (int i = t; i < FT * D; i += FR) {
      const int r = i / D, d = i % D, qr = t0 + r;
      const bool ok = qr < Lp && d < hd;
      qt[r][d] = ok ? qh[(size_t)qr * q.sr + d] : 0.0f;
      gt[r][d] = ok ? gh[(size_t)qr * g.sr + d] : 0.0f;
    }
    for (int i = t; i < FT; i += FR) {
      const bool ok = t0 + i < Lp;
      sm_m[i] = ok ? mrow[t0 + i] : 0.0f;
      sm_l[i] = ok ? mrow[plane + t0 + i] : 1.0f;
      sm_r[i] = ok ? mrow[2 * plane + t0 + i] : 0.0f;
    }
    __syncthreads();
    if (!key_ok) continue;
    const int nt = min(FT, Lp - t0);
    for (int j = 0; j < nt; ++j) {
      const int qg = t0 + j;
      float s = 0.0f, dp = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(ks[d][t], qt[j][d], s);
        dp = fmaf(vs[d][t], gt[j][d], dp);
      }
      s *= scale;
      if (bh) s += bh[(size_t)qg * Lp + key];
      const float p = expf(s - sm_m[j]) / fmaxf(sm_l[j], 1e-30f);
      float pd = p;
      if (drop.on) {
        const bool keep =
            vc_dropout_keep(qg, key, drop.seed, salt, drop.thresh);
        dp = keep ? dp * drop.inv : 0.0f;
        pd = keep ? p * drop.inv : 0.0f;
      }
      const float ds = p * (dp - sm_r[j]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        av[d] = fmaf(pd, gt[j][d], av[d]);
        ak[d] = fmaf(ds, qt[j][d], ak[d]);
      }
    }
  }
  if (key >= Lp) return;
  float* krow = dk + ((size_t)b * Lp + key) * H + h * hd;
  float* vrow = dv + ((size_t)b * Lp + key) * H + h * hd;
  for (int d = 0; d < hd; ++d) {
    krow[d] = ak[d] * scale;
    vrow[d] = av[d];
  }
}

template <int D>
void launch_f32(const Operand<float>* in, Bias bias, void* dq,
                void* dk, void* dv, float* mlr, int B, int Lp, int H, int nh,
                int l_actual, float scale, Dropout drop, cudaStream_t s) {
  const dim3 grid((Lp + FR - 1) / FR, nh, B);
  attn_bwd_q_f32<D><<<grid, FR, 0, s>>>(in[0], in[1], in[2], in[3], bias,
                                        static_cast<float*>(dq), mlr, Lp, H,
                                        H / nh, l_actual, scale, drop);
  attn_bwd_kv_f32<D><<<grid, FR, 0, s>>>(
      in[0], in[1], in[2], in[3], bias, mlr, static_cast<float*>(dk),
      static_cast<float*>(dv), Lp, H, H / nh, l_actual, scale, drop);
}

}  // namespace

// Two launches: (a) then (b), on one stream; mlr is (3, B, nh, Lp) f32
// scratch that (a) writes and (b) reads.  q, k, v, g: base pointers with
// batch, head and row strides in elements; bias: base pointer (or null)
// with batch and head strides, rows of Lp (the wrapper checks alignment
// and shapes); dq, dk, dv: contiguous (B, Lp, H).
extern "C" int vc_attention_bwd(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* k, long long k_sb, long long k_sh, long long k_sr,
    const void* v, long long v_sb, long long v_sh, long long v_sr,
    const void* g, long long g_sb, long long g_sh, long long g_sr,
    const void* bias, long long bias_sb, long long bias_sh, void* dq,
    void* dk, void* dv, void* mlr, int B, int Lp, int H, int nh,
    int l_actual, float scale, unsigned seed, unsigned thresh, float inv,
    int nh_total, int head_offset, int dtype, void* stream) {
  if (nh <= 0 || H % nh || head_offset < 0 || nh_total < nh + head_offset)
    return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  if (hd % 8 || hd > BW_HD) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, inv, thresh != 0u || inv != 1.0f,
                     (unsigned)nh_total, (unsigned)head_offset};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias bf{static_cast<const float*>(bias), bias_sb, bias_sh};
  float* m = static_cast<float*>(mlr);
  if (dtype == VC_BF16) {
    const Operand<bf16> in[4] = {
        {static_cast<const bf16*>(q), q_sb, q_sh, q_sr},
        {static_cast<const bf16*>(k), k_sb, k_sh, k_sr},
        {static_cast<const bf16*>(v), v_sb, v_sh, v_sr},
        {static_cast<const bf16*>(g), g_sb, g_sh, g_sr}};
    const int rc =
        bf.p ? launch_bf16<true>(in, bf, dq, dk, dv, m, B, Lp, H, nh,
                                 l_actual, scale, drop, s)
             : launch_bf16<false>(in, bf, dq, dk, dv, m, B, Lp, H, nh,
                                  l_actual, scale, drop, s);
    if (rc) return rc;
  } else if (dtype == VC_F32) {
    const Operand<float> in[4] = {
        {static_cast<const float*>(q), q_sb, q_sh, q_sr},
        {static_cast<const float*>(k), k_sb, k_sh, k_sr},
        {static_cast<const float*>(v), v_sb, v_sh, v_sr},
        {static_cast<const float*>(g), g_sb, g_sh, g_sr}};
    if (hd <= 16)
      launch_f32<16>(in, bf, dq, dk, dv, m, B, Lp, H, nh, l_actual, scale,
                     drop, s);
    else if (hd <= 32)
      launch_f32<32>(in, bf, dq, dk, dv, m, B, Lp, H, nh, l_actual, scale,
                     drop, s);
    else
      launch_f32<64>(in, bf, dq, dk, dv, m, B, Lp, H, nh, l_actual, scale,
                     drop, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// launch configuration of the bf16 kernels, for the measurement scripts
// ---------------------------------------------------------------------------

#define BW_KERNEL(kernel, BIAS)                                          \
  {#kernel "<" #BIAS ">", (const void*)kernel<BIAS>, BW_THREADS,           \
   BwdSmem::BYTES}
static const WgKernel BW_KERNELS[] = {
    BW_KERNEL(attn_bwd_q_wgmma, false),
    BW_KERNEL(attn_bwd_q_wgmma, true),
    BW_KERNEL(attn_bwd_kv_wgmma, false),
    BW_KERNEL(attn_bwd_kv_wgmma, true),
};
#undef BW_KERNEL

// Kernel `index` of the bf16 kernels and its launch configuration
// (wg_kernel_info, wgmma.cuh); -1 past the last kernel.
extern "C" int vc_attention_bwd_kernel_info(int index, char* name, int len,
                                            int* info) {
  return wg_kernel_info(BW_KERNELS, sizeof(BW_KERNELS) / sizeof(WgKernel),
                        index, name, len, info);
}
