// decode_attention: the attention of one cached decode step, window
// [prev@t-1, MASK@t], for every beam of every image, one decoder layer.
//
// Replaces the attention half of the TPU kernel
// vitcap_tpu/ops/decode_step.py _kernel (the per-head loop of :145-206),
// reached through fused_decode_step; the dense products and post-LNs of that
// kernel go to the gemm and layer_norm kernels (ops/decode_step.py).
//
// Per (image b, head h) and each window row r of each beam j of b:
// - the prev row's k/v is written into the beam's caption cache at slot t-1;
// - q is scaled in the compute dtype: q * (hd^-0.5 rounded);
// - scores against the beam's caption cache at slots <= t-1 (f32 sums of
//   exact products), the MASK row's own key (products rounded to the compute
//   dtype, then summed in f32; the prev row does not see it) and the
//   image's context keys (f32 sums, plus the additive (B, S) f32 bias:
//   -10000 on invalid od slots);
// - one softmax through the shared max of the three sources; the
//   probabilities of the caption and context products are rounded to the
//   compute dtype, the MASK row's own term stays f32, the denominator sums
//   the unrounded f32 values;
// - the output divided by the denominator, rounded to the compute dtype.
// The step index t is read from device memory, so a launch does not depend
// on a host value.
//
// What bounds it on the H100: the context K/V, (B, S, H) each, is the
// traffic (2 * B * S * H elements per layer: 124 MB at the flagship's B=64,
// S=628, bf16; 212 MB at 512 px, S=1076), against about 4 * S * hd flops
// per window row: far below the card's ops-per-byte line, so device-memory
// bandwidth bounds it, and the kernel has to keep enough bytes in flight
// (about 20 KB per SM by Little's law at ~0.8 us of latency) and not wait
// on its own phases.
//
// Beam groups: an image's nb beams are taken as `groups` groups of
// g = nb / groups beams (plan() in ops/decode_step.py: g the largest
// divisor of nb up to 16, so greedy and beam-3 are one group and
// constrained beam search's 160 beams ten groups of 16).  A launch row is
// one group: its window rows, caption caches and outputs are those of
// rows [z g, (z + 1) g) of the batch, and its context and bias those of
// image z / groups, which every group of the image reads again (from L2
// or device memory).
//
// bf16 at hd 64 and 128: decode_attention_cluster_kernel.  Grid (ranks,
// heads, images x groups), a thread-block cluster of `ranks` blocks (at
// most 8) per (head, beam group), each rank a contiguous range of context
// keys (plan() in ops/decode_step.py picks ranks and the range from the
// shape, never from t: about 144 keys a rank, 5 ranks at S = 628, 8 at
// 1076); the last rank also takes the beams' caption keys (slots < t, slot
// t-1 read from the window), so the caption is one more key range whose
// scores are masked to their own beam.  A rank:
// - issues 16-byte cp.async loads of its K rows, each lane the chunks it
//   will itself read (so the scores wait on no barrier for K), the
//   context's in four commit groups by key iteration, then the caption's
//   and the MASK rows' own k and v, then every V row (zero-filled past
//   its keys), so the later K and the V bytes are in flight while the
//   first scores are computed: 33-37 KB a block at the flagship's shapes
//   (130-146 keys of 256 bytes), four blocks an SM (55 KB of shared
//   memory each); only the last rank reads t, after its context loads are
//   issued; the bias and the scaled q rows (f32) go to shared memory
//   while the rows fly;
// - computes its scores on the CUDA cores in one fixed order that the
//   plain version repeats (ops/decode_step.py decode_attention_plain):
//   four lanes a key, lane j the 16-byte chunks j, j + 4, ... of the head
//   dim, a chain of f32 FMAs from 0 over its elements (a bf16 x bf16
//   product is exact in f32, so an FMA rounds as a multiply and an add
//   do), the four partial sums joined by two shuffles as (p0 + p1) + (p2 +
//   p3); a pass per two beams (one at hd 128) holds their q rows in
//   registers, so each K unit is read and widened once for four rows; adds
//   the bias or the caption mask, keeps the scores in shared memory and
//   its per-row max.  The MASK row's own score takes the same order over
//   products rounded to bf16;
// - exchanges the per-row maxes with the other ranks: each rank writes
//   its maxes into every rank's shared memory (distributed shared memory)
//   and arrives on that rank's mbarrier, then waits on its own while its
//   V rows land.  No online rescaling: every probability is exp(s -
//   m_global) (expf, which torch.exp computes on a CUDA tensor) rounded
//   once, as the plain version rounds it, so a probability is bit-equal
//   to the plain version's (F9);
// - each warp turns its own scores into bf16 probabilities (the
//   denominator sums the f32 values: per lane, over a row's lanes, over
//   the warps in order) and the block forms its partial o^T = V^T P^T on
//   the tensor cores (V through ldmatrix.trans), the warps splitting the
//   head dimension;
// - the last rank adds the MASK row's own term (products rounded, f32
//   probability) and writes the prev rows' k/v into the caption caches;
// - every other rank pushes its partial outputs and denominators into the
//   last rank's shared memory (its dead K rows), each thread arriving on
//   the last rank's mbarrier after its own writes, and leaves at once; the
//   last rank sums the partials in rank order, divides, rounds once and
//   stores 16 bytes at a time.
// One launch per layer and step, no workspace, the same bits every call.
// What holds it back on the card (throwaway builds that stamped the
// global timer at each step): a block spends under half its life waiting
// for its K rows and the rest in a chain of dependent steps (scores, the
// exchange, the probabilities, P.V, the push) that four blocks an SM do
// not hide.  The scores on the CUDA cores cost about hd FMAs a (key,
// row), 430 a thread at the flagship's beam-3 shape; the first pass runs
// as its K rows land.
//
// f32, and bf16 at hd 8/16/32 (or a context too long for the cluster
// kernel's shared memory): decode_attention_simple_kernel, the first
// design: one block per (head, beam group) serves the group's 2 g window
// rows, the f32 scores and probabilities in shared memory, CUDA-core
// products.
#include <math.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

template <typename T>
__device__ __forceinline__ float rnd(float x) {  // round to T, back to f32
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// bf16, hd 64 and 128: the context split over a thread-block cluster
// ---------------------------------------------------------------------------

constexpr int DC_THREADS = 128;
constexpr int DC_WARPS = DC_THREADS / 32;
constexpr int DC_MAX_RANKS = 8;  // the portable cluster size
constexpr int DC_KEYS = 16;      // keys per group (mma's K of P.V)
constexpr int DC_LPK = 4;        // lanes a key in the score loop
constexpr int DC_KEYS_IT = DC_THREADS / DC_LPK;  // keys a block iteration
constexpr int DC_CTX_GROUPS = 4;  // commit groups of the context K rows
constexpr size_t DC_SMEM_LIMIT = 232448;  // a block's shared bytes, H100

// Shared memory of one block, in bytes, for NR tiles of 8 window rows (R
// of them used), `kmax` keys (a multiple of 16) and `ranks` ranks;
// ops/decode_step.py cluster_smem repeats it.  K, V and P rows are padded
// by 16 bytes (ldmatrix, and the score loop's 16-byte reads of eight keys,
// touch rows an odd number of 16-byte units apart: no bank conflicts); the
// q rows are f32, each lane's 16-byte reads the same for eight lanes.
// Once the scores are formed the K rows are dead, and on the last rank the
// other ranks push their partial outputs and denominators there.
struct DcLayout {
  int kst, sst, pst;  // K/V row, score row, P row strides (elements)
  size_t k, v, q, kvw, bs, s, p, stat, bar, total;  // byte offsets, size
  __host__ __device__ DcLayout(int hd, int nr, int kmax, int ranks, int R) {
    const int rows = 8 * nr, prows = rows > 16 ? rows : 16;
    kst = hd + 8;
    sst = kmax + 4;
    pst = kmax + 8;
    const size_t kbytes = (size_t)kmax * kst * 2;
    // on the last rank: the other ranks' partial outputs and sums
    const size_t recv = (size_t)(ranks - 1) * R * (hd + 1) * 4;
    k = 0;
    v = k + (kbytes > recv ? kbytes : recv);
    q = v + kbytes;
    kvw = q + (size_t)rows * hd * 4;   // the MASK rows' own k, then v
    bs = kvw + (size_t)rows * hd * 2;  // per key: bias, 0 or -inf
    s = bs + (size_t)kmax * 4;
    // the f32 scores, then (once they are probabilities) the partial
    // outputs: rows x hd floats
    p = s + (size_t)rows * (sst > hd ? sst : hd) * 4;
    stat = p + (size_t)prows * pst * 2;
    // per row: DC_WARPS partial maxes (then sums), local max, sum, self
    // score, its exp, and every rank's max
    bar = stat + (size_t)rows * (DC_WARPS + 4 + DC_MAX_RANKS) * 4;
    total = bar + 16;  // two mbarriers
  }
};

// distributed shared memory and cluster-scope barriers (sm_90)
__device__ __forceinline__ uint32_t cluster_addr(const void* local,
                                                 int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(local)), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// one arrival on a cluster rank's mbarrier, releasing this thread's writes
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}
// wait for phase 0 of a local mbarrier, acquiring the arrivals' writes
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nDC_WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra DC_WAIT_%=;\n}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b for one m16n8k16 step (bf16 operands): the tensor cores sum
// the 16 products from zero, and the f32 add to d is an IEEE one, so a
// long sum does not gather the tensor cores' alignment truncation step
// after step
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float c0, c1, c2, c3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(c0), "=f"(c1), "=f"(c2), "=f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
  d[0] += c0;
  d[1] += c1;
  d[2] += c2;
  d[3] += c3;
}

// The score loop's lane split (DC_LPK = 4 lanes a key): lane `lane` takes
// key lane % 8 of its warp's eight and quarter j = lane / 8 of the head
// dim, the 16-byte chunks j, j + 4, ... of the row.  Its partial sum
// shuffled over lanes 8 and 16 apart is (p0 + p1) + (p2 + p3) on every
// lane (IEEE addition commutes exactly).
__device__ __forceinline__ float quarter_sum(float p) {
  p += __shfl_xor_sync(0xffffffffu, p, 8);
  return p + __shfl_xor_sync(0xffffffffu, p, 16);
}

// the two f32 values of a bf16 pair (the low half is the lower element)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// wait until this thread's cp.async group `g` (0-4 of the cluster kernel's
// six) has landed
__device__ __forceinline__ void dc_wait_group(int g) {
  switch (g) {
    case 0: cp_wait<5>(); break;
    case 1: cp_wait<4>(); break;
    case 2: cp_wait<3>(); break;
    case 3: cp_wait<2>(); break;
    default: cp_wait<1>(); break;
  }
}

// Block (rank, h, b) of a cluster of `ranks` blocks along x: head h of
// beam group b, the beams [b nb, (b + 1) nb) of image b / groups.  Rank q takes
// the context keys [q kpr, min(S, (q + 1) kpr)), the last rank those from
// (ranks - 1) kpr to S and the caption keys c = j t + a of beam j, slot
// a < t.  kmax: the key capacity of the shared buffers (a multiple of 16,
// at least every rank's count).  NR: tiles of 8 window rows (2 nb <= 8 NR).
// The scores run on the CUDA cores in the fixed order of quarter_sum; P.V
// on the tensor cores, transposed, the head columns as mma's M and the
// window rows as its N = 8, so a group's few rows waste little: o^T = V^T
// P^T per 16 head columns.
template <int HD, int NR>
__global__ void __launch_bounds__(DC_THREADS, NR == 1 ? 4 : 2)
    decode_attention_cluster_kernel(const bf16* __restrict__ qkv, bf16* cap_k,
                                    bf16* cap_v, const bf16* __restrict__ ctx_k,
                                    const bf16* __restrict__ ctx_v,
                                    const float* __restrict__ bias,
                                    const int* __restrict__ t_ptr,
                                    bf16* __restrict__ out, int nb,
                                    int groups, int S, int A, int H,
                                    float scale, int kpr, int kmax) {
  constexpr int U = HD / 8;              // 16-byte units per head row
  constexpr int CPL = U / DC_LPK;        // units of a key a lane takes
  constexpr int EPL = 8 * CPL;           // elements of a key a lane takes
  constexpr int RP = 8 * NR;             // window rows, padded
  constexpr int MTW = HD / 16 / DC_WARPS;  // P.V tiles of 16 columns a warp
  static_assert(MTW >= 1, "a warp takes at least 16 head columns");
  static_assert(CPL >= 1 && U % DC_LPK == 0, "whole units a lane");
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), ranks = (int)cl.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z, bc = b / groups;
  const int R = 2 * nb;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the score loop's key of this lane in an iteration, and its quarter
  const int kown = 8 * warp + lane % 8, qj = lane / 8;
  const size_t H3 = 3 * (size_t)H;
  const bool last = rank == ranks - 1;
  const int c0 = min(S, rank * kpr);
  const int nctx = last ? S - c0 : min(S, c0 + kpr) - c0;

  extern __shared__ __align__(16) unsigned char dc_smem[];
  const DcLayout L(HD, NR, kmax, ranks, R);
  bf16* ks = reinterpret_cast<bf16*>(dc_smem + L.k);
  bf16* vs = reinterpret_cast<bf16*>(dc_smem + L.v);
  float* qf = reinterpret_cast<float*>(dc_smem + L.q);
  bf16* kvw = reinterpret_cast<bf16*>(dc_smem + L.kvw);
  float* bs = reinterpret_cast<float*>(dc_smem + L.bs);
  float* ss = reinterpret_cast<float*>(dc_smem + L.s);
  float* part = ss;  // the partial outputs, once the scores are spent
  bf16* ps = reinterpret_cast<bf16*>(dc_smem + L.p);
  float* red = reinterpret_cast<float*>(dc_smem + L.stat);
  float* m_loc = red + DC_WARPS * RP;
  float* l_loc = m_loc + RP;
  float* s_self = l_loc + RP;
  float* p_self = s_self + RP;
  float* m_all = p_self + RP;  // [rank][row]: pushed by every rank
  // on the last rank: pushed by rank q < ranks - 1, its partial outputs
  // [q][row < R][HD] and sums [q][row]
  float* recv_o = reinterpret_cast<float*>(dc_smem + L.k);
  float* recv_l = recv_o + (size_t)(ranks - 1) * R * HD;
  // mbarriers: every rank's maxes are here; (last rank) every other
  // rank's partials are here
  uint64_t* mb = reinterpret_cast<uint64_t*>(dc_smem + L.bar);
  if (tid == 0) {
    mbar_init(smem_u32(mb), ranks);
    mbar_init(smem_u32(mb + 1), ranks > 1 ? (ranks - 1) * DC_THREADS : 1);
    mbar_fence_init();
  }
  // every block's barriers initialised before any rank arrives on them
  // (the matching wait sits before the first remote access)
  cluster_arrive_relaxed();

  // window rows of group b: row r is window row r % 2 of beam r / 2; the
  // context is image bc's
  const bf16* win = qkv + (size_t)b * R * H3 + h * HD;
  const size_t cap0 = (size_t)b * nb * A * H + h * HD;  // beam 0, slot 0
  const bf16* kx = ctx_k + ((size_t)bc * S + c0) * H + h * HD;
  const bf16* vx = ctx_v + ((size_t)bc * S + c0) * H + h * HD;

  // 1. six cp.async groups: the context's K rows of key iterations 0, 1, 2
  //    and 3 on (each lane the units of its own keys that it reads in the
  //    score loop); the caption's K rows (last rank: slot t-1 from the
  //    window) and the MASK rows' own k and v; every V row.  Only the last
  //    rank reads t (the MASK row's position; prev sits at t - 1), after
  //    its context loads are issued, so no rank's loads wait on it.
  auto load_k = [&](int k, const bf16* src) {
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int u = qj + DC_LPK * m;
      cp_async16(smem_u32(ks + k * L.kst + 8 * u), src + 8 * u, 16);
    }
  };
  const int nit = (nctx + DC_KEYS_IT - 1) / DC_KEYS_IT;
  for (int grp = 0; grp < DC_CTX_GROUPS; ++grp) {
    const int it1 = grp < DC_CTX_GROUPS - 1 ? min(grp + 1, nit) : nit;
    for (int it = grp; it < it1; ++it) {
      const int k = it * DC_KEYS_IT + kown;
      if (k < nctx) load_k(k, kx + (size_t)k * H);
    }
    cp_commit();
  }
  const int t = last ? *t_ptr : 1;
  if (t < 1 || t > A) __trap();
  const int nk = nctx + (last ? nb * t : 0);
  const int nkp = (nk + DC_KEYS - 1) / DC_KEYS * DC_KEYS;
  const int G = nkp / DC_KEYS;
  // caption key c: beam c / t, slot c % t (slot t-1: the window's prev row)
  auto cap_src = [&](int c, int part_off, const bf16* cap) -> const bf16* {
    const int j = c / t, a = c % t;
    if (a == t - 1) return win + (size_t)2 * j * H3 + part_off;
    return cap + cap0 + ((size_t)j * A + a) * H;
  };
  for (int k = kown + (nctx > kown ? (nctx - kown + DC_KEYS_IT - 1) /
                                         DC_KEYS_IT * DC_KEYS_IT
                                   : 0);
       k < nk; k += DC_KEYS_IT)
    load_k(k, cap_src(k - nctx, H, cap_k));
  if (last)
    for (int i = tid; i < 2 * nb * U; i += DC_THREADS) {
      const int kv = i / (nb * U), j = i / U % nb, u = i % U;
      cp_async16(smem_u32(kvw + (kv * (RP / 2) + j) * HD + 8 * u),
                 win + (size_t)(2 * j + 1) * H3 + (1 + kv) * H + 8 * u, 16);
    }
  cp_commit();
  for (int i = tid; i < nkp * U; i += DC_THREADS) {
    const int k = i / U, u = i % U;
    const bf16* src = k < nctx ? vx + (size_t)k * H
                      : k < nk ? cap_src(k - nctx, 2 * H, cap_v)
                               : ctx_v;
    cp_async16(smem_u32(vs + k * L.kst + 8 * u), src + (k < nk ? 8 * u : 0),
               k < nk ? 16 : 0);
  }
  cp_commit();

  // 2. while those fly: per key the bias (context), 0 (caption) or -inf
  //    (past the keys); the scaled q rows, rounded to bf16, as f32; the
  //    last rank writes each beam's prev k/v into its caption cache (this
  //    launch reads slot t-1 from the window, never from the cache)
  for (int k = tid; k < nkp; k += DC_THREADS)
    bs[k] = k < nctx ? bias[(size_t)bc * S + c0 + k] : k < nk ? 0.0f
                                                             : -INFINITY;
  const float sc = rnd<bf16>(scale);
  for (int i = tid; i < R * U; i += DC_THREADS) {
    const int r = i / U, u = i % U;
    const uint4 w = *reinterpret_cast<const uint4*>(win + r * H3 + 8 * u);
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&w);
    float4* dst = reinterpret_cast<float4*>(qf + r * HD + 8 * u);
#pragma unroll
    for (int e = 0; e < 2; e++)
      dst[e] = make_float4(rnd<bf16>(bf16_lo(x[2 * e]) * sc),
                           rnd<bf16>(bf16_hi(x[2 * e]) * sc),
                           rnd<bf16>(bf16_lo(x[2 * e + 1]) * sc),
                           rnd<bf16>(bf16_hi(x[2 * e + 1]) * sc));
  }
  if (last) {
    for (int i = tid; i < 2 * nb * U; i += DC_THREADS) {
      const int kv = i / (nb * U), j = i / U % nb, u = i % U;
      const size_t dst = cap0 + ((size_t)j * A + (t - 1)) * H + 8 * u;
      const uint4 w = *reinterpret_cast<const uint4*>(
          win + (size_t)2 * j * H3 + (1 + kv) * H + 8 * u);
      *reinterpret_cast<uint4*>((kv ? cap_v : cap_k) + dst) = w;
    }
  }
  __syncthreads();

  // 3. scores, a pass per NBP beams from j0 (2 at hd 64, then 1 for an odd
  //    last beam; 1 at hd 128) over rows 2 j (prev) and 2 j + 1 (MASK) of
  //    each, their q quarters in registers; iteration it takes keys [32 it,
  //    32 it + 32), warp w the eight from 32 it + 8 w.  The first pass waits
  //    for each key's own cp.async group.  Caption keys of another beam are
  //    masked; lanes 8 w' .. 8 w' + 7 store the pass's row w'.
  auto pass = [&](int j0, auto beams) {
    constexpr int NBP = decltype(beams)::value;  // beams of this pass
    constexpr int NRW = 2 * NBP;
    const int r0 = 2 * j0;
    float qr[NRW][EPL];
#pragma unroll
    for (int w = 0; w < NRW; ++w)
#pragma unroll
      for (int m = 0; m < CPL; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * (qj + DC_LPK * m) + 4 * e;
          const float4 x =
              *reinterpret_cast<const float4*>(qf + (r0 + w) * HD + d);
          qr[w][8 * m + 4 * e] = x.x;
          qr[w][8 * m + 4 * e + 1] = x.y;
          qr[w][8 * m + 4 * e + 2] = x.z;
          qr[w][8 * m + 4 * e + 3] = x.w;
        }
    float mx[NRW];
#pragma unroll
    for (int w = 0; w < NRW; ++w) mx[w] = -INFINITY;
    for (int kb = 8 * warp; kb < nkp; kb += DC_KEYS_IT) {
      const int k = kb + lane % 8;
      if (j0 == 0)
        dc_wait_group(k < nctx ? min(kb / DC_KEYS_IT, DC_CTX_GROUPS - 1)
                               : DC_CTX_GROUPS);
      float a[NRW];
#pragma unroll
      for (int w = 0; w < NRW; ++w) a[w] = 0.0f;
      if (k < nk) {
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const uint4 u4 = *reinterpret_cast<const uint4*>(
              ks + k * L.kst + 8 * (qj + DC_LPK * m));
          const uint32_t x[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lo = bf16_lo(x[e]), hi = bf16_hi(x[e]);
#pragma unroll
            for (int w = 0; w < NRW; ++w) a[w] = fmaf(qr[w][8 * m + 2 * e], lo, a[w]);
#pragma unroll
            for (int w = 0; w < NRW; ++w)
              a[w] = fmaf(qr[w][8 * m + 2 * e + 1], hi, a[w]);
          }
        }
      }
      const float bk = bs[k];
      const int jb = k >= nctx && k < nk ? (k - nctx) / t : -1;
#pragma unroll
      for (int w = 0; w < NRW; ++w) {
        float s = quarter_sum(a[w]) + bk;
        if (jb >= 0 && jb != j0 + w / 2) s = -INFINITY;
        mx[w] = fmaxf(mx[w], s);
        if (qj == w) ss[(r0 + w) * L.sst + k] = s;
      }
    }
#pragma unroll
    for (int w = 0; w < NRW; ++w) {
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx[w] = fmaxf(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], o));
      if (lane == 8 * w) red[warp * RP + r0 + w] = mx[w];
    }
  };
  constexpr int MAXB = HD == 64 ? 2 : 1;  // beams a pass (q registers)
  int j = 0;
  for (; j + MAXB <= nb; j += MAXB)
    pass(j, std::integral_constant<int, MAXB>());
  if (MAXB == 2 && j < nb) pass(j, std::integral_constant<int, 1>());
  cp_wait<1>();  // every group but V: the last rank's MASK k and v too
  __syncthreads();

  // 4. beam j = 8 w + lane % 8 (warps 0 and 1): the MASK row's own score
  //    (last rank: products rounded to bf16, the score loop's order) and
  //    both rows' maxes over this rank's keys
  if (8 * warp < nb) {
    const int j = kown, r = 2 * j + 1;
    float p = 0.0f;
    if (last && j < nb) {
#pragma unroll
      for (int m = 0; m < CPL; ++m)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int d = 8 * (qj + DC_LPK * m) + e;
          p += rnd<bf16>(qf[r * HD + d] * to_f32(kvw[j * HD + d]));
        }
    }
    p = quarter_sum(p);
    if (qj == 0 && j < nb) {
      float m0 = red[2 * j], m1 = red[r];
#pragma unroll
      for (int w = 1; w < DC_WARPS; ++w) {
        m0 = fmaxf(m0, red[w * RP + 2 * j]);
        m1 = fmaxf(m1, red[w * RP + r]);
      }
      if (last) {
        s_self[r] = p;
        m1 = fmaxf(m1, p);
      }
      m_loc[2 * j] = m0;
      m_loc[r] = m1;
    }
  }
  __syncthreads();

  // 5. the global max of every row over the ranks: thread q pushes this
  //    rank's maxes into rank q's shared memory and arrives on its
  //    mbarrier; the V rows land meanwhile
  cluster_wait();  // every block of the cluster has started
  if (tid < ranks) {
    const uint32_t dst = cluster_addr(m_all + rank * RP, tid);
    for (int r = 0; r < R; ++r) st_cluster(dst + 4 * r, m_loc[r]);
    mbar_arrive_remote(cluster_addr(mb, tid));
  }
  cp_wait<0>();
  mbar_wait_cluster(smem_u32(mb));
  // rows past R take 0
  auto row_max = [&](int row) {
    float m = -INFINITY;
    for (int q = 0; q < ranks; ++q) m = fmaxf(m, m_all[q * RP + row]);
    return row < R ? m : 0.0f;
  };

  // 6. warp w's key groups w, w + 4, ... to probabilities: exp(s - m)
  //    rounded to bf16 for P (zero past the keys and the rows), the
  //    denominator's share from the f32 values (per lane, then over the
  //    lanes of a row, then over the warps in order); lane holds keys
  //    lane / 4 (+ 8) of a group and rows 2 (lane % 4) (+ 1) of each tile
  const int kl = lane / 4, rl = 2 * (lane % 4);  // a lane's key, row
  float mg[NR][2], ls[NR][2];
#pragma unroll
  for (int n = 0; n < NR; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mg[n][e] = row_max(8 * n + rl + e);
      ls[n][e] = 0.0f;
    }
#pragma unroll 2
  for (int g = warp; g < G; g += DC_WARPS)
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + rl + e % 2, k = g * DC_KEYS + kl + 8 * (e / 2);
        const float p =
            row < R ? expf(ss[row * L.sst + k] - mg[n][e % 2]) : 0.0f;
        ls[n][e % 2] += p;
        ps[row * L.pst + k] = __float2bfloat16(p);
      }
#pragma unroll
  for (int n = 0; n < NR; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = ls[n][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      ls[n][e] = l;
    }
  if (lane < 4)
#pragma unroll
    for (int n = 0; n < NR; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) red[warp * RP + 8 * n + rl + e] = ls[n][e];
  __syncthreads();
  if (tid < R) {
    float l = red[tid];
#pragma unroll
    for (int w = 1; w < DC_WARPS; ++w) l += red[w * RP + tid];
    if (last && tid % 2) {
      const float pe = expf(s_self[tid] - row_max(tid));
      p_self[tid] = pe;
      l += pe;
    }
    l_loc[tid] = l;
  }

  // 7. partial o^T = V^T P^T on the tensor cores: warp w takes the head
  //    columns [16 MTW w, 16 MTW (w + 1)), every key group
  const uint32_t vs_a = smem_u32(vs), ps_a = smem_u32(ps);
  {
    float o[MTW][NR][4] = {};
    for (int g = 0; g < G; ++g) {
      uint32_t pb[(NR + 1) / 2 * 2][2];  // P as the B operand, per row tile
#pragma unroll
      for (int n = 0; n < NR; n += 2) {
        uint32_t x[4];
        ldsm_x4(x, ps_a + ((8 * n + lane % 8 + 8 * (lane / 16)) * L.pst +
                           g * DC_KEYS + 8 * (lane / 8 % 2)) * 2);
        pb[n][0] = x[0];
        pb[n][1] = x[1];
        pb[n + 1][0] = x[2];
        pb[n + 1][1] = x[3];
      }
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        uint32_t va[4];
        const int d0 = 16 * (MTW * warp + m);
        ldsm_x4_t(va, vs_a + ((g * DC_KEYS + lane % 8 + 8 * (lane / 16)) *
                                  L.kst + d0 + 8 * (lane / 8 % 2)) * 2);
#pragma unroll
        for (int n = 0; n < NR; ++n) mma_add(o[m][n], va, pb[n][0], pb[n][1]);
      }
    }
#pragma unroll
    for (int m = 0; m < MTW; ++m)
#pragma unroll
      for (int n = 0; n < NR; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 8 * n + rl + e % 2;
          const int d = 16 * (MTW * warp + m) + kl + 8 * (e / 2);
          if (row < R) part[row * HD + d] = o[m][n][e];
        }
  }
  __syncthreads();
  // 8. + the MASK rows' own value (last rank), f32 probability
  if (last) {
    for (int i = tid; i < nb * HD; i += DC_THREADS) {
      const int j = i / HD, d = i % HD, r = 2 * j + 1;
      part[r * HD + d] += p_self[r] * to_f32(kvw[((RP / 2) + j) * HD + d]);
    }
    __syncthreads();
  }

  // 9. every other rank pushes its partial outputs and sums into the last
  //    rank's shared memory (its K rows, dead since its scores), each
  //    thread arriving on the last rank's mbarrier after its own writes,
  //    and leaves
  if (!last) {
    const uint32_t dst = cluster_addr(recv_o + (size_t)rank * R * HD,
                                      ranks - 1);
    for (int i = tid; i < R * HD / 4; i += DC_THREADS)
      st_cluster(dst + 16 * i, reinterpret_cast<const float4*>(part)[i]);
    if (tid < R)
      st_cluster(cluster_addr(recv_l + rank * R + tid, ranks - 1),
                 l_loc[tid]);
    mbar_arrive_remote(cluster_addr(mb + 1, ranks - 1));
    return;
  }

  // 10. the last rank: the partials summed in rank order (its own last),
  //     divided, rounded once, stored 16 bytes at a time
  if (ranks > 1) mbar_wait_cluster(smem_u32(mb + 1));
  for (int it = tid; it < R * U; it += DC_THREADS) {
    const int r = it / U, c8 = 8 * (it % U);
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
    float l = 0.0f;
    for (int q = 0; q < ranks; ++q) {
      const float* y = (q < ranks - 1 ? recv_o + (size_t)q * R * HD : part) +
                       r * HD + c8;
      const float4 y0 = *reinterpret_cast<const float4*>(y);
      const float4 y1 = *reinterpret_cast<const float4*>(y + 4);
      s0.x += y0.x; s0.y += y0.y; s0.z += y0.z; s0.w += y0.w;
      s1.x += y1.x; s1.y += y1.y; s1.z += y1.z; s1.w += y1.w;
      l += q < ranks - 1 ? recv_l[q * R + r] : l_loc[r];
    }
    uint4 w;
    __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&w);
    x[0] = __floats2bfloat162_rn(s0.x / l, s0.y / l);
    x[1] = __floats2bfloat162_rn(s0.z / l, s0.w / l);
    x[2] = __floats2bfloat162_rn(s1.x / l, s1.y / l);
    x[3] = __floats2bfloat162_rn(s1.z / l, s1.w / l);
    *reinterpret_cast<uint4*>(out + ((size_t)b * R + r) * H + h * HD + c8) =
        w;
  }
}

// ---------------------------------------------------------------------------
// f32, and bf16 at hd 8/16/32: the first design, one block per (head,
// beam group).  Scores use groups of lanes per key (one 16-byte load per lane,
// a shuffle reduction inside the group); the f32 scores and probabilities
// stay in shared memory (2 * nb * S floats); the value product gives each
// warp a share of the keys and each lane a slice of the head dimension,
// with the per-row sums of 16 rows at a time in registers, then one
// reduction through shared memory.
// ---------------------------------------------------------------------------

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_ROW_CHUNK = 16;  // window rows summed in registers at once

__device__ __forceinline__ void load_chunk(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ void load_chunk(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; i++) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int HD>
struct DaShape {
  static constexpr int VPL = HD >= 32 ? HD / 32 : 1;   // values per lane
  static constexpr int KPI = HD >= 32 ? 1 : 32 / HD;   // value keys per warp
};

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_simple_kernel(const T* __restrict__ qkv, T* cap_k,
                                   T* cap_v, const T* __restrict__ ctx_k,
                                   const T* __restrict__ ctx_v,
                                   const float* __restrict__ bias,
                                   const int* __restrict__ t_ptr,
                                   T* __restrict__ out, int nb, int groups,
                                   int S, int A, int H, float scale) {
  constexpr int EPL = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPK = HD / EPL;        // lanes per key in the score loop
  constexpr int KPW = 32 / LPK;        // keys per warp and iteration
  constexpr int VPL = DaShape<HD>::VPL;
  constexpr int KPI = DaShape<HD>::KPI;
  constexpr int DL = HD / VPL;         // lanes across the head dimension
  const int h = blockIdx.x, b = blockIdx.y, bc = b / groups;
  const int R = 2 * nb;
  const int t = *t_ptr;  // the MASK row's position; prev sits at t - 1
  if (t < 1 || t > A) __trap();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t H3 = 3 * (size_t)H;

  extern __shared__ float smem[];
  float* q_s = smem;               // R x HD: q * scale, rounded
  float* s_ctx = q_s + R * HD;     // R x S: scores, then probabilities
  float* s_cap = s_ctx + R * S;    // R x A: the same for the caption slots
  float* s_self = s_cap + R * A;   // R: the MASK row's own score, then exp
  float* den = s_self + R;         // R: softmax denominators
  float* red = den + R;            // (DA_WARPS * KPI) x R x HD partial sums

  // window rows of group b: row r is window row r % 2 of beam r / 2; the
  // context is image bc's
  const T* win = qkv + (size_t)b * R * H3;
  const size_t cap0 = (size_t)b * nb * A * H + h * HD;  // beam 0, slot 0
  const float sc = rnd<T>(scale);

  // 1. scaled q rows; each beam's prev k/v into its caption cache
  for (int i = tid; i < R * HD; i += DA_THREADS) {
    const int r = i / HD, d = i % HD;
    q_s[i] = rnd<T>(to_f32(win[r * H3 + h * HD + d]) * sc);
  }
  for (int i = tid; i < nb * HD; i += DA_THREADS) {
    const int j = i / HD, d = i % HD;
    const size_t src = 2 * j * H3 + h * HD + d;
    const size_t dst = cap0 + ((size_t)j * A + (t - 1)) * H + d;
    cap_k[dst] = win[src + H];
    cap_v[dst] = win[src + 2 * H];
  }
  __syncthreads();

  // 2a. context scores: a group of LPK lanes per key
  {
    const int g = lane / LPK, sub = lane % LPK;
    const T* kb = ctx_k + (size_t)bc * S * H + h * HD + sub * EPL;
    const float* bb = bias + (size_t)bc * S;
    for (int s0 = 0; s0 < S; s0 += DA_WARPS * KPW) {
      const int s = s0 + warp * KPW + g;
      float k[EPL];
      if (s < S) {
        load_chunk(kb + (size_t)s * H, k);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; e++) k[e] = 0.0f;
      }
      for (int r = 0; r < R; r++) {
        const float* q = q_s + r * HD + sub * EPL;
        float p = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; e++) p = fmaf(q[e], k[e], p);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, o);
        if (sub == 0 && s < S) s_ctx[r * S + s] = p + bb[s];
      }
    }
  }
  // 2b. caption scores at slots < t (the prev slot was written above)
  for (int i = tid; i < R * t; i += DA_THREADS) {
    const int r = i / t, a = i % t;
    const T* k = cap_k + cap0 + ((size_t)(r / 2) * A + a) * H;
    const float* q = q_s + r * HD;
    float p = 0.0f;
    for (int d = 0; d < HD; d++) p = fmaf(q[d], to_f32(k[d]), p);
    s_cap[r * A + a] = p;
  }
  // 2c. the MASK row's own key; the prev row does not see it
  for (int r = tid; r < R; r += DA_THREADS) {
    float p = -INFINITY;
    if (r % 2) {
      const T* k = win + r * H3 + H + h * HD;
      p = 0.0f;
      for (int d = 0; d < HD; d++) p += rnd<T>(q_s[r * HD + d] * to_f32(k[d]));
    }
    s_self[r] = p;
  }
  __syncthreads();

  // 3. softmax over the three sources through one max: a warp per row
  for (int r = warp; r < R; r += DA_WARPS) {
    float* pc = s_ctx + r * S;
    float* pa = s_cap + r * A;
    float m = s_self[r];
    for (int s = lane; s < S; s += 32) m = fmaxf(m, pc[s]);
    for (int a = lane; a < t; a += 32) m = fmaxf(m, pa[a]);
    m = warp_max(m);
    float l = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float p = expf(pc[s] - m);
      l += p;
      pc[s] = rnd<T>(p);
    }
    for (int a = lane; a < t; a += 32) {
      const float p = expf(pa[a] - m);
      l += p;
      pa[a] = rnd<T>(p);
    }
    l = warp_sum(l);
    if (lane == 0) {
      const float ps = expf(s_self[r] - m);
      den[r] = l + ps;
      s_self[r] = ps;
    }
  }
  __syncthreads();

  // 4. context values: keys over warps (and lane groups when HD < 32),
  //    a slice of the head dimension per lane, the sums of up to
  //    DA_ROW_CHUNK rows in registers.  More rows take another pass over V;
  //    up to DA_ROW_CHUNK rows (nb <= 8) call the body once with r0 = 0
  //    folded in, which ran faster than the chunk loop around it.
  const int d0 = (lane % DL) * VPL, sub = lane / DL;
  const T* vb = ctx_v + (size_t)bc * S * H + h * HD + d0;
  auto value_rows = [&](int r0, int rn) {
    float acc[DA_ROW_CHUNK][VPL];
#pragma unroll
    for (int r = 0; r < DA_ROW_CHUNK; r++)
#pragma unroll
      for (int e = 0; e < VPL; e++) acc[r][e] = 0.0f;
    const float* pr = s_ctx + (size_t)r0 * S;
    for (int s = warp * KPI + sub; s < S; s += DA_WARPS * KPI) {
      float v[VPL];
#pragma unroll
      for (int e = 0; e < VPL; e++) v[e] = to_f32(vb[(size_t)s * H + e]);
#pragma unroll
      for (int r = 0; r < DA_ROW_CHUNK; r++) {
        if (r < rn) {
          const float p = pr[r * S + s];
#pragma unroll
          for (int e = 0; e < VPL; e++) acc[r][e] = fmaf(p, v[e], acc[r][e]);
        }
      }
    }
    float* mine = red + ((size_t)(warp * KPI + sub) * R + r0) * HD;
#pragma unroll
    for (int r = 0; r < DA_ROW_CHUNK; r++)
      if (r < rn)
#pragma unroll
        for (int e = 0; e < VPL; e++) mine[r * HD + d0 + e] = acc[r][e];
  };
  if (R <= DA_ROW_CHUNK) {
    value_rows(0, R);
  } else {
    for (int r0 = 0; r0 < R; r0 += DA_ROW_CHUNK)
      value_rows(r0, min(R - r0, DA_ROW_CHUNK));
  }
  __syncthreads();

  // 5. + caption values + the MASK row's own value, normalise, store
  for (int i = tid; i < R * HD; i += DA_THREADS) {
    const int r = i / HD, d = i % HD;
    float o = 0.0f;
    for (int w = 0; w < DA_WARPS * KPI; w++) o += red[(size_t)w * R * HD + i];
    const T* vc = cap_v + cap0 + (size_t)(r / 2) * A * H + d;
    for (int a = 0; a < t; a++)
      o = fmaf(s_cap[r * A + a], to_f32(vc[(size_t)a * H]), o);
    if (r % 2) o = fmaf(s_self[r], to_f32(win[r * H3 + 2 * H + h * HD + d]), o);
    out[((size_t)b * R + r) * H + h * HD + d] = from_f32<T>(o / den[r]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int HD>
static size_t simple_smem(int nb, int S, int A) {
  const size_t R = 2 * nb;
  return sizeof(float) * (R * HD + R * S + R * A + 2 * R +
                          (size_t)DA_WARPS * DaShape<HD>::KPI * R * HD);
}

// tiles of 8 window rows for nb beams: 1, 2 or 4 (up to 16 beams)
static int row_tiles(int nb) { return nb <= 4 ? 1 : nb <= 8 ? 2 : 4; }

static size_t cluster_smem(int hd, int nb, int kmax, int ranks) {
  return DcLayout(hd, row_tiles(nb), kmax, ranks, 2 * nb).total;
}

template <int HD>
static const void* cluster_fn(int nr) {
  return nr == 1   ? (const void*)decode_attention_cluster_kernel<HD, 1>
         : nr == 2 ? (const void*)decode_attention_cluster_kernel<HD, 2>
                   : (const void*)decode_attention_cluster_kernel<HD, 4>;
}

template <typename T, int HD>
static int launch_simple(const void* qkv, void* cap_k, void* cap_v,
                         const void* ctx_k, const void* ctx_v,
                         const float* bias, const int* t, void* out, int B,
                         int nb, int groups, int S, int A, int H, int nh,
                         float scale, cudaStream_t s) {
  const size_t smem = simple_smem<T, HD>(nb, S, A);
  auto kern = decode_attention_simple_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(nh, B * groups), DA_THREADS, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(cap_k),
      static_cast<T*>(cap_v), static_cast<const T*>(ctx_k),
      static_cast<const T*>(ctx_v), bias, t, static_cast<T*>(out), nb,
      groups, S, A, H, scale);
  return (int)cudaGetLastError();
}

template <int HD, int NR>
static int launch_cluster(const void* qkv, void* cap_k, void* cap_v,
                          const void* ctx_k, const void* ctx_v,
                          const float* bias, const int* t, void* out, int B,
                          int nb, int groups, int S, int A, int H, int nh,
                          float scale, int ranks, int kpr, int kmax,
                          cudaStream_t s) {
  static std::atomic<unsigned long long> smem_set{0};
  const size_t smem = cluster_smem(HD, nb, kmax, ranks);
  if (smem > DC_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kern = decode_attention_cluster_kernel<HD, NR>;
  const cudaError_t e = allow_smem((const void*)kern, DC_SMEM_LIMIT, smem_set);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, nh, B * groups);
  cfg.blockDim = dim3(DC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const bf16*>(qkv), static_cast<bf16*>(cap_k),
      static_cast<bf16*>(cap_v), static_cast<const bf16*>(ctx_k),
      static_cast<const bf16*>(ctx_v), bias, t, static_cast<bf16*>(out), nb,
      groups, S, A, H, scale, kpr, kmax);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <int HD>
static int dispatch_cluster(const void* qkv, void* cap_k, void* cap_v,
                            const void* ctx_k, const void* ctx_v,
                            const float* bias, const int* t, void* out, int B,
                            int nb, int groups, int S, int A, int H, int nh,
                            float scale, int ranks, int kpr, int kmax,
                            cudaStream_t s) {
  if (ranks < 1 || ranks > DC_MAX_RANKS || kpr < 1 || kmax % DC_KEYS ||
      nb > 16)
    return (int)cudaErrorInvalidValue;
#define VC_DC_CASE(NR)                                                      \
  case NR:                                                                  \
    return launch_cluster<HD, NR>(qkv, cap_k, cap_v, ctx_k, ctx_v, bias, t, \
                                  out, B, nb, groups, S, A, H, nh, scale,   \
                                  ranks, kpr, kmax, s);
  switch (row_tiles(nb)) {
    VC_DC_CASE(1)
    VC_DC_CASE(2)
    default:
      VC_DC_CASE(4)
  }
#undef VC_DC_CASE
}

template <typename T>
static int dispatch_simple(int hd, const void* qkv, void* cap_k, void* cap_v,
                           const void* ctx_k, const void* ctx_v,
                           const float* bias, const int* t, void* out, int B,
                           int nb, int groups, int S, int A, int H, int nh,
                           float scale, cudaStream_t s) {
#define VC_DA_CASE(HD)                                                    \
  case HD:                                                                \
    return launch_simple<T, HD>(qkv, cap_k, cap_v, ctx_k, ctx_v, bias, t, \
                                out, B, nb, groups, S, A, H, nh, scale, s);
  switch (hd) {
    VC_DA_CASE(8)
    VC_DA_CASE(16)
    VC_DA_CASE(32)
    VC_DA_CASE(64)
    VC_DA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VC_DA_CASE
}

// nb beams an image, taken as `groups` groups of nb / groups beams, one
// launch row each.  ranks: 0 runs decode_attention_simple_kernel; 1..8
// (bf16 at hd 64 or 128 only) decode_attention_cluster_kernel with
// clusters of that many blocks, kpr context keys a rank and kmax keys of
// shared capacity (ops/decode_step.py plan).
extern "C" int vc_decode_attention(const void* qkv, void* cap_k, void* cap_v,
                                   const void* ctx_k, const void* ctx_v,
                                   const void* bias, const void* t, void* out,
                                   int B, int nb, int groups, int S, int A,
                                   int H, int nh, float scale, int dtype,
                                   int ranks, int kpr, int kmax,
                                   void* stream) {
  if (nb < 1 || groups < 1 || nb % groups || H % nh)
    return (int)cudaErrorInvalidValue;
  nb /= groups;  // beams of one launch row
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const int* tp = static_cast<const int*>(t);
  const int hd = H / nh;
  if (ranks > 0) {
    if (dtype != VC_BF16) return (int)cudaErrorInvalidValue;
    if (hd == 64)
      return dispatch_cluster<64>(qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp,
                                  out, B, nb, groups, S, A, H, nh, scale,
                                  ranks, kpr, kmax, s);
    if (hd == 128)
      return dispatch_cluster<128>(qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp,
                                   out, B, nb, groups, S, A, H, nh, scale,
                                   ranks, kpr, kmax, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == VC_F32)
    return dispatch_simple<float>(hd, qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp,
                                  out, B, nb, groups, S, A, H, nh, scale, s);
  if (dtype == VC_BF16)
    return dispatch_simple<bf16>(hd, qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp,
                                 out, B, nb, groups, S, A, H, nh, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel `index` of the cluster kernels (hd 64 and 128, at nb's row
// tiles) and the simple kernels (hd 64, bf16 and f32), with its launch
// configuration at a decode geometry (nb beams, S context keys, A caption
// slots; ranks and kmax, the cluster kernel's key capacity, from plan), as
// wg_kernel_info (wgmma.cuh) gives it; -1 past the last kernel.
extern "C" int vc_decode_attention_kernel_info(int index, char* name, int len,
                                               int* info, int nb, int S,
                                               int A, int ranks, int kmax) {
  const int nr = row_tiles(nb);
  char n64[64], n128[64];
  snprintf(n64, sizeof(n64), "decode_attention_cluster_kernel<64, %d>", nr);
  snprintf(n128, sizeof(n128), "decode_attention_cluster_kernel<128, %d>",
           nr);
  const WgKernel kernels[] = {
      {n64, cluster_fn<64>(nr), DC_THREADS,
       cluster_smem(64, nb, kmax, ranks)},
      {n128, cluster_fn<128>(nr), DC_THREADS,
       cluster_smem(128, nb, kmax, ranks)},
      {"decode_attention_simple_kernel<bf16, 64>",
       (const void*)decode_attention_simple_kernel<bf16, 64>, DA_THREADS,
       simple_smem<bf16, 64>(nb, S, A)},
      {"decode_attention_simple_kernel<float, 64>",
       (const void*)decode_attention_simple_kernel<float, 64>, DA_THREADS,
       simple_smem<float, 64>(nb, S, A)},
  };
  const int rc = wg_kernel_info(kernels, sizeof(kernels) / sizeof(WgKernel),
                                index, name, len, info);
  // wg_kernel_info set the kernel's shared-memory limit to this geometry's;
  // restore what the launches count on: DC_SMEM_LIMIT for the cluster
  // kernels (allow_smem sets it once), the default 48 KB for the simple
  // ones (launch_simple raises it past that per call)
  if (rc == 0)
    return (int)cudaFuncSetAttribute(
        kernels[index].fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        index < 2 ? (int)DC_SMEM_LIMIT : 48 * 1024);
  return rc;
}
