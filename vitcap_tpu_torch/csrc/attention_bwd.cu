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
// keep bit is vc_dropout_keep(query row, key column, seed, b * nh + h), the
// bits the forward (attention.cu) used.
//
// What bounds it on the H100: per (image, head) the work is about
// 10 Lp^2 hd flops (5 products; this design recomputes s three and dp two
// extra times) against 7 Lp hd values moved, far above the card's
// ops-per-byte line, so the tensor cores' rate bounds the bf16 path.  The
// TPU kernel holds a whole (Lp x Lp) score block per head in VMEM; a Hopper
// block cannot, and dk/dv sum over every query while dq sums over every
// key.  So two kernels, deterministic, with no atomics:
// (a) query-major, one block per (64-query tile, head, image): three
//     passes over the keys (row max and sum; r; then ds and dq), writing
//     dq and the f32 row statistics m, l, r;
// (b) key-major, one block per (64-key tile, head, image): a loop over the
//     query tiles that recomputes p from m and l, regenerates the mask,
//     and accumulates dv and dk in registers.
// Shared memory and registers do not depend on Lp; the grids have
// ceil(Lp / 64) tiles and every offset is a size_t product, so the same
// kernels serve 512-px training (Lp 1152 with l_actual 1025, Lp 1104 with
// the bias; the work grows as Lp^2).
// bf16 runs on the tensor cores (WMMA bf16 16x16x16, head dims padded to
// 64); f32 on the CUDA cores in exact f32 (no TF32), one thread per row.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores (WMMA)
// ---------------------------------------------------------------------------

constexpr int HDP = 64;        // head dims padded to 64
constexpr int LD = HDP + 8;    // bf16 row stride of the operand tiles
constexpr int NTH = 128;       // 4 warps
constexpr int QB = 64;         // (a): query rows per block, 16 per warp
constexpr int KT = 32;         // (a): keys per tile
constexpr int KB = 64;         // (b): keys per block, 16 per warp
constexpr int QT = 32;         // (b): query rows per tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBt;  // B given as rows of B^T (a [n][k] tile)
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// rows [r0, r0 + nrows) of one head's hd columns -> smem tile of stride LD,
// zero beyond `valid` rows and beyond hd columns
__device__ __forceinline__ void load_head_rows(bf16* dst, const bf16* src,
                                               size_t ld_src, int r0,
                                               int nrows, int valid, int hd) {
  constexpr int chunks = HDP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < valid && c < hd)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * ld_src + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// a (16 x HDP, fragments) . bt^T for the NT rows of bt (a [n][d] smem tile)
// -> this warp's f32 scratch (stride ls), then each lane's `half` values of
// its (row = lane / 2, columns c0 = (lane % 2) * half ...) into out
template <int NT>
__device__ __forceinline__ void product_nt(const FragA* a, const bf16* bt,
                                           float* sw, int ls, float* out) {
  constexpr int HALF = NT / 2;
  const int lane = threadIdx.x % 32;
  const int row = lane / 2, c0 = (lane % 2) * HALF;
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      FragBt bf;
      wmma::load_matrix_sync(bf, bt + j * 16 * LD + kk * 16, LD);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(sw + j * 16, acc, ls, wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < HALF; ++c) out[c] = sw[row * ls + c0 + c];
  __syncwarp();
}

// acc[n] += a (16 x NT, bf16 smem, stride la) . b (NT x HDP smem tile)
template <int NT>
__device__ __forceinline__ void product_nn(FragC* acc, const bf16* a, int la,
                                           const bf16* b) {
#pragma unroll
  for (int j = 0; j < NT / 16; ++j) {
    FragA af;
    wmma::load_matrix_sync(af, a + j * 16, la);
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) {
      FragB bf;
      wmma::load_matrix_sync(bf, b + j * 16 * LD + n * 16, LD);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
}

// stores acc (16 x HDP) * mul to rows [r0, r0 + 16) of one head's columns
// of out (stride H), rows < nrows and columns < hd only
__device__ __forceinline__ void store_rows(const FragC* acc, float* sw,
                                           float mul, bf16* out, size_t ld,
                                           int r0, int nrows, int hd) {
  const int lane = threadIdx.x % 32;
  const int row = lane / 2, half = (lane % 2) * 8;
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    wmma::store_matrix_sync(sw, acc[n], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n * 16 + half + c;
      if (r0 + row < nrows && col < hd)
        out[(size_t)(r0 + row) * ld + col] =
            __float2bfloat16(sw[row * 16 + half + c] * mul);
    }
    __syncwarp();
  }
}

struct QSmem {
  bf16 q[QB * LD];
  bf16 g[QB * LD];
  bf16 k[KT * LD];
  bf16 v[KT * LD];
  float s[4][16 * (KT + 4)];  // per warp: f32 products, then bf16 ds
};

// (a): dq and the row statistics (m, l, r) of one (64-query tile, head,
// image)
__global__ void __launch_bounds__(NTH)
    attn_bwd_q_tc(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                  Operand<bf16> g, Bias bias, bf16* __restrict__ dq,
                  float* __restrict__ mlr, int Lp, int H, int hd,
                  int l_actual, float scale, Dropout drop) {
  constexpr int LS = KT + 4, LPB = KT + 8, HALF = KT / 2;
  static_assert(16 * LPB * sizeof(bf16) <= 16 * LS * sizeof(float),
                "ds must fit in the product scratch");
  __shared__ __align__(128) QSmem sm;
  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y;
  const int q0 = blockIdx.x * QB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane / 2, c0 = (lane % 2) * HALF;
  const int qrow = q0 + warp * 16 + row;
  const unsigned salt = b * nh + h;
  const bf16* kh = k.head(b, h);
  const bf16* vh = v.head(b, h);
  const float* brow = qrow < Lp ? bias.row(b, h, qrow, Lp) : nullptr;
  float* sw = sm.s[warp];
  bf16* dsw = reinterpret_cast<bf16*>(sw);

  load_head_rows(sm.q, q.head(b, h), q.sr, q0, QB, Lp, hd);
  load_head_rows(sm.g, g.head(b, h), g.sr, q0, QB, Lp, hd);
  __syncthreads();
  FragA qf[HDP / 16], gf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LD + kk * 16, LD);
    wmma::load_matrix_sync(gf[kk], sm.g + warp * 16 * LD + kk * 16, LD);
  }

  auto load_kv = [&](int k0, bool with_v) {
    __syncthreads();
    load_head_rows(sm.k, kh, k.sr, k0, KT, l_actual, hd);
    if (with_v) load_head_rows(sm.v, vh, v.sr, k0, KT, l_actual, hd);
    __syncthreads();
  };
  auto scores = [&](int k0, float* s) {
    product_nt<KT>(qf, sm.k, sw, LS, s);
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int kg = k0 + c0 + c;
      float sv = s[c] * scale;
      if (brow && kg < l_actual) sv += brow[kg];
      s[c] = kg < l_actual ? sv : -INFINITY;
    }
  };

  // pass 1: row max and sum over the valid keys
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    load_kv(k0, false);
    float s[HALF];
    scores(k0, s);
    float tm = -INFINITY;
#pragma unroll
    for (int c = 0; c < HALF; ++c) tm = fmaxf(tm, s[c]);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float mn = fmaxf(m, tm);
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) part += expf(s[c] - mn);
    l = l * expf(m - mn) + part;
    m = mn;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float den = fmaxf(l, 1e-30f);

  // p and the dropped dp of this lane's tile entries
  auto p_dp = [&](int k0, float* p, float* dp) {
    scores(k0, p);
    product_nt<KT>(gf, sm.v, sw, LS, dp);
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      p[c] = expf(p[c] - m) / den;
      if (drop.on)
        dp[c] = vc_dropout_keep(qrow, k0 + c0 + c, drop.seed, salt,
                                drop.thresh)
                    ? dp[c] * drop.inv
                    : 0.0f;
    }
  };

  // pass 2: r = sum_k dp p
  float r = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    load_kv(k0, true);
    float p[HALF], dp[HALF];
    p_dp(k0, p, dp);
#pragma unroll
    for (int c = 0; c < HALF; ++c) r += dp[c] * p[c];
  }
  r += __shfl_xor_sync(0xffffffffu, r, 1);

  // pass 3: ds = round(p (dp - r)), dq += ds k
  FragC dqf[HDP / 16];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) wmma::fill_fragment(dqf[n], 0.0f);
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    load_kv(k0, true);
    float p[HALF], dp[HALF];
    p_dp(k0, p, dp);
#pragma unroll
    for (int c = 0; c < HALF; ++c)
      dsw[row * LPB + c0 + c] = __float2bfloat16(p[c] * (dp[c] - r));
    __syncwarp();
    product_nn<KT>(dqf, dsw, LPB, sm.k);
    __syncwarp();
  }

  store_rows(dqf, sw, scale, dq + (size_t)b * Lp * H + h * hd, H,
             q0 + warp * 16, Lp, hd);
  if (lane % 2 == 0 && qrow < Lp) {
    const size_t i = ((size_t)b * nh + h) * Lp + qrow;
    const size_t plane = (size_t)gridDim.z * nh * Lp;
    mlr[i] = m;
    mlr[plane + i] = l;
    mlr[2 * plane + i] = r;
  }
}

struct KSmem {
  bf16 qg[2 * QT * LD];  // q rows, then g rows; first the K and V staging
  float m[QT], l[QT], r[QT];
  float s[4][16 * (QT + 8)];  // per warp: f32 products, then bf16 pd, ds
};

// (b): dk and dv of one (64-key tile, head, image)
__global__ void __launch_bounds__(NTH)
    attn_bwd_kv_tc(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                   Operand<bf16> g, Bias bias,
                   const float* __restrict__ mlr, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Lp, int H, int hd,
                   int l_actual, float scale, Dropout drop) {
  constexpr int LS = QT + 8, LPB = QT + 8, HALF = QT / 2;
  static_assert(2 * 16 * LPB * sizeof(bf16) <= 16 * LS * sizeof(float),
                "pd and ds must fit in the product scratch");
  static_assert(2 * QT >= KB, "K/V staging needs KB rows");
  __shared__ __align__(128) KSmem sm;
  const int b = blockIdx.z, h = blockIdx.y, nh = gridDim.y;
  const int kb0 = blockIdx.x * KB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = lane / 2, c0 = (lane % 2) * HALF;
  const int key = kb0 + warp * 16 + row;
  const unsigned salt = b * nh + h;
  const bf16* qh = q.head(b, h);
  const bf16* gh = g.head(b, h);
  const float* bh = bias.row(b, h, 0, Lp);  // null without a bias
  const size_t plane = (size_t)gridDim.z * nh * Lp;
  const float* mrow = mlr + ((size_t)b * nh + h) * Lp;
  float* sw = sm.s[warp];
  bf16* pdw = reinterpret_cast<bf16*>(sw);
  bf16* dsw = pdw + 16 * LPB;
  bf16* qs = sm.qg;
  bf16* gs = sm.qg + QT * LD;

  // this warp's 16 keys and values as A fragments, staged through qg
  FragA kf[HDP / 16], vf[HDP / 16];
  load_head_rows(sm.qg, k.head(b, h), k.sr, kb0, KB, l_actual, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wmma::load_matrix_sync(kf[kk], sm.qg + warp * 16 * LD + kk * 16, LD);
  __syncthreads();
  load_head_rows(sm.qg, v.head(b, h), v.sr, kb0, KB, l_actual, hd);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wmma::load_matrix_sync(vf[kk], sm.qg + warp * 16 * LD + kk * 16, LD);

  FragC dkf[HDP / 16], dvf[HDP / 16];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    wmma::fill_fragment(dkf[n], 0.0f);
    wmma::fill_fragment(dvf[n], 0.0f);
  }
  const bool key_ok = key < l_actual;
  for (int t0 = 0; t0 < Lp; t0 += QT) {
    __syncthreads();
    load_head_rows(qs, qh, q.sr, t0, QT, Lp, hd);
    load_head_rows(gs, gh, g.sr, t0, QT, Lp, hd);
    for (int i = threadIdx.x; i < QT; i += blockDim.x) {
      const bool ok = t0 + i < Lp;
      sm.m[i] = ok ? mrow[t0 + i] : 0.0f;
      sm.l[i] = ok ? mrow[plane + t0 + i] : 1.0f;
      sm.r[i] = ok ? mrow[2 * plane + t0 + i] : 0.0f;
    }
    __syncthreads();
    float s[HALF], dp[HALF];
    product_nt<QT>(kf, qs, sw, LS, s);   // s^T: (key, query)
    product_nt<QT>(vf, gs, sw, LS, dp);  // dp^T
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int qi = c0 + c, qg = t0 + qi;
      float p = 0.0f, d = dp[c], pd = 0.0f;
      if (key_ok && qg < Lp) {
        float sv = s[c] * scale;
        if (bh) sv += bh[(size_t)qg * Lp + key];
        p = expf(sv - sm.m[qi]) / fmaxf(sm.l[qi], 1e-30f);
        pd = p;
        if (drop.on) {
          const bool keep =
              vc_dropout_keep(qg, key, drop.seed, salt, drop.thresh);
          d = keep ? d * drop.inv : 0.0f;
          pd = keep ? p * drop.inv : 0.0f;
        }
      }
      pdw[row * LPB + qi] = __float2bfloat16(pd);
      dsw[row * LPB + qi] = __float2bfloat16(p * (d - sm.r[qi]));
    }
    __syncwarp();
    product_nn<QT>(dvf, pdw, LPB, gs);
    product_nn<QT>(dkf, dsw, LPB, qs);
    __syncwarp();
  }
  store_rows(dkf, sw, scale, dk + (size_t)b * Lp * H + h * hd, H,
             kb0 + warp * 16, Lp, hd);
  store_rows(dvf, sw, 1.0f, dv + (size_t)b * Lp * H + h * hd, H,
             kb0 + warp * 16, Lp, hd);
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
  const unsigned salt = b * nh + h;
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
  const unsigned salt = b * nh + h;
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
    int dtype, void* stream) {
  if (nh <= 0 || H % nh) return (int)cudaErrorInvalidValue;
  const int hd = H / nh;
  if (hd % 8 || hd > HDP) return (int)cudaErrorInvalidValue;
  const Dropout drop{seed, thresh, inv, thresh != 0u || inv != 1.0f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bias bf{static_cast<const float*>(bias), bias_sb, bias_sh};
  float* m = static_cast<float*>(mlr);
  if (dtype == VC_BF16) {
    const Operand<bf16> in[4] = {
        {static_cast<const bf16*>(q), q_sb, q_sh, q_sr},
        {static_cast<const bf16*>(k), k_sb, k_sh, k_sr},
        {static_cast<const bf16*>(v), v_sb, v_sh, v_sr},
        {static_cast<const bf16*>(g), g_sb, g_sh, g_sr}};
    attn_bwd_q_tc<<<dim3((Lp + QB - 1) / QB, nh, B), NTH, 0, s>>>(
        in[0], in[1], in[2], in[3], bf, static_cast<bf16*>(dq), m, Lp, H, hd,
        l_actual, scale, drop);
    attn_bwd_kv_tc<<<dim3((Lp + KB - 1) / KB, nh, B), NTH, 0, s>>>(
        in[0], in[1], in[2], in[3], bf, m, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Lp, H, hd, l_actual, scale, drop);
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
