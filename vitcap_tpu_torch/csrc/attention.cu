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
// Replaces the attention TPU kernels of vitcap_tpu/ops/fused_block.py:
// _attn_pairbd_kernel / _attn_perhead_kernel (ViT, no bias) and
// _bert_attn_pairbd_kernel / _bert_attn_perhead_kernel (BERT prefill, with
// the additive head-broadcast (B, 1, Lp, Lp) f32 bias).  The TPU kernels'
// pair-blockdiagonal packing is an MXU trick and is not carried over.
// It is also the forward of K9, vitcap_tpu/ops/flash_attention.py:846
// flash_attention: up to 1024 padded tokens its one-pass kernel (:189
// _flash_fwd_onepass, :165 _onepass_kernel) computes this same function
// (any bias: none, (B, 1, L, L) or per head (B, nH, L, L)); past 1024 its
// q-tiled kernel (:251 _flash_fwd_pallas, :129 _kernel) computes another
// one, which the `online` mode below reproduces.
//
// Math, as on the TPU: f32 scores, scale applied after the dot, bias added,
// keys >= l_actual masked (they contribute exactly 0: exp(-1e30 - m)
// underflows, so these kernels stop at l_actual), f32 softmax statistics,
// the unnormalised probabilities rounded to the compute dtype for the
// product with v, and the output divided by max(l, 1e-30).
//
// Attention-prob dropout (the train forward, vitcap_tpu/ops/
// flash_attention.py:452 _fwd_packed_kernel / :484 _fwd_packed_pair_kernel,
// K8, reached through flash_fwd_packed_slab :949 on the slab and
// _flash_fwd_packed :670 on separate q, k, v): the unnormalised exp(s - m)
// of a dropped (query, key) pair is 0 and a kept one is multiplied by
// 1 / (1 - rate) in f32 before the rounding; the row sum l stays the
// undropped one.  The keep bit is
// vc_dropout_keep(query row, key column, seed, b * nh + h), the bits the
// backward (attention_bwd.cu) regenerates.
//
// What bounds it on the H100: at Lp = 592, hd = 64 the work is
// 4 * Lp^2 * hd flops per (image, head) against only 3 * Lp * hd inputs,
// so it is compute-bound, and the exp/max work of the softmax is the second
// cost.  Two kernels, one block per (q-tile, head, image) each:
// - bf16 (the main path): tensor cores through WMMA bf16 16x16x16
//   fragments.  Four warps own 16 query rows each and share K/V tiles in
//   shared memory.  Two passes over the keys: the first finds each row's max
//   and sum, the second forms exp(s - max) once, so the output accumulator
//   stays in registers with no rescaling (the score product runs twice;
//   tensor-core flops are the cheap resource here).
// - f32 (exact f32, no TF32): CUDA cores, one thread per query row with q
//   and the output accumulator in registers, K/V tiles staged as f32 in
//   shared memory (broadcast reads), online softmax over chunks of 16 keys.
// Neither kernel's shared memory nor its grid depends on Lp beyond the
// number of query tiles, and every offset into the operands, the bias and
// the output is a size_t product, so the same kernels serve the TPU package's
// long-sequence whole-block kernels (K10: fused_block.py:125 _block_kernel,
// :470 _bert_kernel, Lp > 1024, e.g. 1152 at 512 px, B = 64: 85M bias
// entries), and 512-px training on separate q, k, v (Lp 1152 and 1104).
// There the work grows as Lp^2 and stays compute-bound.
// Online mode (K9 past 1024 padded tokens, vitcap_tpu/ops/
// flash_attention.py:129 _kernel): q is pre-scaled in its own dtype
// (round(q * round(scale)), exact at hd 64 where the scale is 2^-3, one
// rounding at hd 32), the scores are q . k^T with no further scale, and
// the softmax runs online over key tiles of 128 from key 0: per tile
// m' = max(m, rowmax(s)), p = exp(s - m') rounded to the operand dtype for
// the product with v, corr = exp(m - m'), l = l * corr + sum(p) and
// acc = acc * corr + p . v in f32 (m starts at -1e30).  bf16: WMMA
// accumulators have no row layout to rescale, so each tile's p . v lands
// in a fresh fragment, is staged in shared memory, and the lanes update
// an f32 accumulator there in the TPU kernel's order (dynamic shared
// memory, 111 KB at head dim 64).  f32: the CUDA-core kernel with the
// pre-scaled q (its online chunks of 16 keys only reorder f32 sums).
// Head sizes are padded up to a compiled size (64 or 128 on the tensor
// cores; 16, 32, 64 or 128 on the CUDA cores) with zeros, which leaves the
// dot products unchanged.
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

// ---------------------------------------------------------------------------
// bf16: tensor cores (WMMA), two-pass softmax
// ---------------------------------------------------------------------------

constexpr int TC_Q = 64;      // query rows per block: 4 warps x 16
constexpr int TC_THREADS = 128;

template <int HDP, int KT>
struct TcSmem {
  static constexpr int LD = HDP + 8;  // bf16 row stride (bank skew)
  static constexpr int LS = KT + 4;   // f32 score row stride
  static constexpr int LP = KT + 8;   // bf16 probability row stride
  bf16 q[TC_Q * LD];
  bf16 k[KT * LD];
  bf16 v[KT * LD];
  float s[4][16 * LS];  // per warp: scores, then bf16 probabilities in place
  static_assert(16 * LP * sizeof(bf16) <= 16 * LS * sizeof(float),
                "probabilities must fit in the score scratch");
};

// rows [r0, r0 + nrows) of one head's hd columns -> smem tile, zero-filled
// beyond `valid` rows and beyond hd columns
template <int HDP, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld_src, int r0, int nrows,
                                          int valid, int hd) {
  const int chunks = HDP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < valid && c < hd)
      val = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * ld_src + c));
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HDP, int KT>
__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_kernel(Operand<bf16> q, Operand<bf16> k, Operand<bf16> v,
                        Bias bias, bf16* __restrict__ out,
                        int Lp, int H, int hd, int l_actual, float scale,
                        Dropout drop) {
  using S = TcSmem<HDP, KT>;
  constexpr int LD = S::LD, LS = S::LS, LP = S::LP;
  constexpr int HALF = KT / 2;  // score columns per lane
  __shared__ __align__(128) S sm;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TC_Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* qh = q.head(b, h);
  const bf16* kh = k.head(b, h);
  const bf16* vh = v.head(b, h);
  float* sw = sm.s[warp];
  bf16* pw = reinterpret_cast<bf16*>(sw);  // probabilities, row stride LP
  // softmax ownership: lane -> (row, half of the key tile)
  const int row = lane / 2, c0 = (lane % 2) * HALF;
  const int qrow = q0 + warp * 16 + row;
  const unsigned salt = b * gridDim.y + h;  // global head b * nh + h
  const float* brow = qrow < Lp ? bias.row(b, h, qrow, Lp) : nullptr;

  load_rows<HDP, LD>(sm.q, qh, q.sr, q0, TC_Q, Lp, hd);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sm.q + warp * 16 * LD + kk * 16, LD);

  // this warp's scores for keys [k0, k0 + KT) -> its f32 scratch
  auto scores = [&](int k0, float* s) {
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sm.k + j * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, LS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      const int kg = k0 + c0 + c;
      float sv = sw[row * LS + c0 + c] * scale;
      if (brow && kg < l_actual) sv += brow[kg];
      s[c] = kg < l_actual ? sv : -INFINITY;
    }
    __syncwarp();
  };

  // pass 1: row max and sum of exp over all valid keys
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    __syncthreads();
    load_rows<HDP, LD>(sm.k, kh, k.sr, k0, KT, l_actual, hd);
    __syncthreads();
    float s[HALF];
    scores(k0, s);
    float tm = -INFINITY;
#pragma unroll
    for (int c = 0; c < HALF; ++c) tm = fmaxf(tm, s[c]);
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float mn = fmaxf(m, tm);  // finite from the first tile on
    float part = 0.0f;
#pragma unroll
    for (int c = 0; c < HALF; ++c) part += expf(s[c] - mn);
    l = l * expf(m - mn) + part;
    m = mn;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // pass 2: o = sum_k exp(s - m) v, probabilities rounded to bf16
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[HDP / 16];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) wmma::fill_fragment(of[n], 0.0f);
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    __syncthreads();
    load_rows<HDP, LD>(sm.k, kh, k.sr, k0, KT, l_actual, hd);
    load_rows<HDP, LD>(sm.v, vh, v.sr, k0, KT, l_actual, hd);
    __syncthreads();
    float s[HALF];
    scores(k0, s);
#pragma unroll
    for (int c = 0; c < HALF; ++c) {
      float p = expf(s[c] - m);
      if (drop.on)
        p = vc_dropout_keep(qrow, k0 + c0 + c, drop.seed, salt, drop.thresh)
                ? p * drop.inv
                : 0.0f;
      pw[row * LP + c0 + c] = __float2bfloat16(p);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, pw + j * 16, LP);
#pragma unroll
      for (int n = 0; n < HDP / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sm.v + j * 16 * LD + n * 16, LD);
        wmma::mma_sync(of[n], pf, vf, of[n]);
      }
    }
    __syncwarp();
  }

  // epilogue: stage each 16x16 output fragment, divide by the row sum
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    wmma::store_matrix_sync(sw, of[n], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = n * 16 + (lane % 2) * 8 + c;
      if (qrow < Lp && col < hd)
        out[((size_t)b * Lp + qrow) * H + h * hd + col] =
            __float2bfloat16(sw[row * 16 + (lane % 2) * 8 + c] / den);
    }
    __syncwarp();
  }
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
  const unsigned salt = b * gridDim.y + h;
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
// bf16 online mode: K9's q-tiled kernel past 1024 padded tokens
// ---------------------------------------------------------------------------

constexpr int ON_KT = 128;        // the TPU kernel's key tile (TK)
constexpr float ON_NEG = -1e30f;  // its mask value and running-max start

// dynamic shared memory layout (byte offsets, each 128-byte aligned)
template <int HDP>
struct OnSmem {
  static constexpr int LD = HDP + 8;     // bf16 operand row stride
  static constexpr int LS = ON_KT + 4;   // f32 score / staging row stride
  static constexpr int LP = ON_KT + 8;   // bf16 probability row stride
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)TC_Q * LD * 2;
  static constexpr size_t V = K + (size_t)ON_KT * LD * 2;
  static constexpr size_t S = V + (size_t)ON_KT * LD * 2;   // 4 warps
  static constexpr size_t P = S + (size_t)4 * 16 * LS * 4;
  static constexpr size_t A = P + (size_t)4 * 16 * LP * 2;
  static constexpr size_t BYTES = A + (size_t)4 * 16 * HDP * 4;
  static_assert(HDP <= LS, "the p . v staging must fit a score row");
};

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS)
    attention_tc_online_kernel(Operand<bf16> q, Operand<bf16> k,
                               Operand<bf16> v, Bias bias,
                               bf16* __restrict__ out, int Lp, int H, int hd,
                               int l_actual, float scale) {
  using S = OnSmem<HDP>;
  constexpr int LD = S::LD, LS = S::LS, LP = S::LP, KT = ON_KT;
  constexpr int HALF = KT / 2, DHALF = HDP / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::V);
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TC_Q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sw = reinterpret_cast<float*>(smem + S::S) + warp * 16 * LS;
  bf16* pw = reinterpret_cast<bf16*>(smem + S::P) + warp * 16 * LP;
  float* aw = reinterpret_cast<float*>(smem + S::A) + warp * 16 * HDP;
  // lane -> (row, half of the key tile and of the head columns)
  const int row = lane / 2, half = lane % 2;
  const int c0 = half * HALF, d0 = half * DHALF;
  const int qrow = q0 + warp * 16 + row;
  const float* brow = qrow < Lp ? bias.row(b, h, qrow, Lp) : nullptr;
  const bf16* kh = k.head(b, h);
  const bf16* vh = v.head(b, h);

  // q pre-scaled in bf16: round(q * round(scale)) (the product of two
  // bf16 values is exact in f32, so this is the bf16 multiply)
  const float sc = __bfloat162float(__float2bfloat16(scale));
  load_rows<HDP, LD>(qs, q.head(b, h), q.sr, q0, TC_Q, Lp, hd);
  for (int i = lane; i < 16 * HDP; i += 32) aw[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < TC_Q * HDP; i += blockDim.x) {
    bf16* e = qs + (i / HDP) * LD + i % HDP;
    *e = __float2bfloat16(__bfloat162float(*e) * sc);
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[HDP / 16];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qs + warp * 16 * LD + kk * 16, LD);

  float m = ON_NEG, l = 0.0f;
  for (int k0 = 0; k0 < l_actual; k0 += KT) {
    __syncthreads();
    load_rows<HDP, LD>(ks, kh, k.sr, k0, KT, l_actual, hd);
    load_rows<HDP, LD>(vs, vh, v.sr, k0, KT, l_actual, hd);
    __syncthreads();
    // s = (pre-scaled q) . k^T -> this warp's scratch
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + j * 16 * LD + kk * 16, LD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sw + j * 16, acc, LS, wmma::mem_row_major);
    }
    __syncwarp();
    // + bias, keys >= l_actual at -1e30; the tile's row max
    float tm = ON_NEG;
    for (int c = 0; c < HALF; ++c) {
      const int kg = k0 + c0 + c;
      float sv = sw[row * LS + c0 + c];
      if (brow && kg < l_actual) sv += brow[kg];
      sv = kg < l_actual ? sv : ON_NEG;
      sw[row * LS + c0 + c] = sv;
      tm = fmaxf(tm, sv);
    }
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    const float mn = fmaxf(m, tm);
    const float corr = expf(m - mn);
    float part = 0.0f;
    for (int c = 0; c < HALF; ++c) {
      const float p = expf(sw[row * LS + c0 + c] - mn);
      part += p;
      pw[row * LP + c0 + c] = __float2bfloat16(p);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    l = __fadd_rn(__fmul_rn(l, corr), part);
    m = mn;
    __syncwarp();
    // this tile's p . v in fresh fragments, staged over the scores
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> pv[HDP / 16];
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) wmma::fill_fragment(pv[n], 0.0f);
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, pw + j * 16, LP);
#pragma unroll
      for (int n = 0; n < HDP / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vs + j * 16 * LD + n * 16, LD);
        wmma::mma_sync(pv[n], pf, vf, pv[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n)
      wmma::store_matrix_sync(sw + n * 16, pv[n], LS, wmma::mem_row_major);
    __syncwarp();
    // acc = acc * corr + p . v, in f32 as the TPU kernel orders it
    for (int c = 0; c < DHALF; ++c)
      aw[row * HDP + d0 + c] =
          __fadd_rn(__fmul_rn(aw[row * HDP + d0 + c], corr),
                    sw[row * LS + d0 + c]);
    __syncwarp();
  }

  const float den = fmaxf(l, 1e-30f);
  for (int c = 0; c < DHALF; ++c) {
    const int col = d0 + c;
    if (qrow < Lp && col < hd)
      out[((size_t)b * Lp + qrow) * H + h * hd + col] =
          __float2bfloat16(aw[row * HDP + col] / den);
  }
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

template <int HDP, int KT>
static int launch_tc(const Operand<bf16>* qkv, Bias bias, void* out, int B,
                     int Lp, int H, int nh, int l_actual, float scale,
                     Dropout drop, cudaStream_t s) {
  dim3 grid((Lp + TC_Q - 1) / TC_Q, nh, B);
  attention_tc_kernel<HDP, KT><<<grid, TC_THREADS, 0, s>>>(
      qkv[0], qkv[1], qkv[2], bias, static_cast<bf16*>(out), Lp, H, H / nh,
      l_actual, scale, drop);
  return 0;
}

template <int HDP>
static int launch_online(const Operand<bf16>* qkv, Bias bias, void* out,
                         int B, int Lp, int H, int nh, int l_actual,
                         float scale, cudaStream_t s) {
  constexpr size_t bytes = OnSmem<HDP>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      attention_tc_online_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Lp + TC_Q - 1) / TC_Q, nh, B);
  attention_tc_online_kernel<HDP><<<grid, TC_THREADS, bytes, s>>>(
      qkv[0], qkv[1], qkv[2], bias, static_cast<bf16*>(out), Lp, H, H / nh,
      l_actual, scale);
  return 0;
}

// q, k, v: base pointers with batch, head and row strides in elements;
// bias: base pointer (or null) with batch and head strides, rows of Lp
// (the wrapper checks alignment and shapes); out: contiguous (B, Lp, H).
// online: K9's online softmax past 1024 (no dropout).
extern "C" int vc_attention(
    const void* q, long long q_sb, long long q_sh, long long q_sr,
    const void* k, long long k_sb, long long k_sh, long long k_sr,
    const void* v, long long v_sb, long long v_sh, long long v_sr,
    const void* bias, long long bias_sb, long long bias_sh, void* out, int B,
    int Lp, int H, int nh, int l_actual, float scale, unsigned seed,
    unsigned thresh, float inv, int online, int dtype, void* stream) {
  const Dropout drop{seed, thresh, inv, thresh != 0u || inv != 1.0f};
  if (nh <= 0 || H % nh) return (int)cudaErrorInvalidValue;
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
    if (online)
      rc = hd <= 64 ? launch_online<64>(ops, bs, out, B, Lp, H, nh,
                                        l_actual, scale, s)
                    : launch_online<128>(ops, bs, out, B, Lp, H, nh,
                                         l_actual, scale, s);
    else if (hd <= 64)
      rc = launch_tc<64, 64>(ops, bs, out, B, Lp, H, nh, l_actual, scale,
                             drop, s);
    else
      rc = launch_tc<128, 32>(ops, bs, out, B, Lp, H, nh, l_actual, scale,
                              drop, s);
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
