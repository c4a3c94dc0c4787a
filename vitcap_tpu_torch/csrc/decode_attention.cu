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
//
// What bounds it on the H100: the context K/V, (B, S, H) each, is the
// traffic (2 * B * S * H elements per layer, 124 MB at the flagship's B=64,
// S=628, bf16), against about 4 * S * hd flops per query row: far below the
// card's ops-per-byte line, so device-memory bandwidth bounds it.  Design:
// one block per (head, image) serves all 2 * nb query rows of that image's
// beams, so each image's context is read once and not once per beam.  Scores
// use groups of lanes per key (one 16-byte load per lane, a shuffle reduction
// inside the group); the f32 scores and probabilities stay in shared memory
// (2 * nb * S floats, so S up to about 3,500 at nb = 8); the value product
// gives each warp a share of the keys and each lane a slice of the head
// dimension, with the per-row sums of 16 rows at a time in registers, then
// one reduction through shared memory.  The step index t is
// read from device memory so the launch does not depend on a host value.
#include <math.h>

#include "common.cuh"

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

template <int HD>
struct DaShape {
  static constexpr int VPL = HD >= 32 ? HD / 32 : 1;   // values per lane
  static constexpr int KPI = HD >= 32 ? 1 : 32 / HD;   // value keys per warp
};

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS)
    decode_attention_kernel(const T* __restrict__ qkv, T* cap_k, T* cap_v,
                            const T* __restrict__ ctx_k,
                            const T* __restrict__ ctx_v,
                            const float* __restrict__ bias,
                            const int* __restrict__ t_ptr,
                            T* __restrict__ out, int nb, int S, int A, int H,
                            float scale) {
  constexpr int EPL = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPK = HD / EPL;        // lanes per key in the score loop
  constexpr int KPW = 32 / LPK;        // keys per warp and iteration
  constexpr int VPL = DaShape<HD>::VPL;
  constexpr int KPI = DaShape<HD>::KPI;
  constexpr int DL = HD / VPL;         // lanes across the head dimension
  const int h = blockIdx.x, b = blockIdx.y;
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

  // window rows of image b: row r is window row r % 2 of beam r / 2
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
    const T* kb = ctx_k + (size_t)b * S * H + h * HD + sub * EPL;
    const float* bb = bias + (size_t)b * S;
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
  const T* vb = ctx_v + (size_t)b * S * H + h * HD + d0;
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

template <typename T, int HD>
static int launch(const void* qkv, void* cap_k, void* cap_v,
                  const void* ctx_k, const void* ctx_v, const float* bias,
                  const int* t, void* out, int B, int nb, int S, int A, int H,
                  int nh, float scale, cudaStream_t s) {
  const int R = 2 * nb;
  const size_t smem =
      sizeof(float) * ((size_t)R * HD + (size_t)R * S + (size_t)R * A + 2 * R +
                       (size_t)DA_WARPS * DaShape<HD>::KPI * R * HD);
  auto kern = decode_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(nh, B), DA_THREADS, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<T*>(cap_k),
      static_cast<T*>(cap_v), static_cast<const T*>(ctx_k),
      static_cast<const T*>(ctx_v), bias, t, static_cast<T*>(out), nb, S, A,
      H, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int hd, const void* qkv, void* cap_k, void* cap_v,
                    const void* ctx_k, const void* ctx_v, const float* bias,
                    const int* t, void* out, int B, int nb, int S, int A,
                    int H, int nh, float scale, cudaStream_t s) {
#define VC_DA_CASE(HD)                                                      \
  case HD:                                                                  \
    return launch<T, HD>(qkv, cap_k, cap_v, ctx_k, ctx_v, bias, t, out, B, \
                         nb, S, A, H, nh, scale, s);
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

extern "C" int vc_decode_attention(const void* qkv, void* cap_k, void* cap_v,
                                   const void* ctx_k, const void* ctx_v,
                                   const void* bias, const void* t, void* out,
                                   int B, int nb, int S, int A, int H, int nh,
                                   float scale, int dtype, void* stream) {
  if (nb < 1 || H % nh) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  const int* tp = static_cast<const int*>(t);
  const int hd = H / nh;
  if (dtype == VC_F32)
    return dispatch<float>(hd, qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp, out, B,
                           nb, S, A, H, nh, scale, s);
  if (dtype == VC_BF16)
    return dispatch<bf16>(hd, qkv, cap_k, cap_v, ctx_k, ctx_v, bf, tp, out, B,
                          nb, S, A, H, nh, scale, s);
  return (int)cudaErrorInvalidValue;
}
