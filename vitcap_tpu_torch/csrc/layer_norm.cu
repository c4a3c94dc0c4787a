// layer_norm: per row, f32 mean and variance over an f32 or bf16 input,
// (x - mean) * rsqrt(var + eps) * scale + shift, stored in f32 or bf16.
//
// Replaces the LayerNorm sections of the TPU kernels in
// vitcap_tpu/ops/fused_block.py: LN1 in _qkv_kernel, LN2 in _tail_kernel
// and the two post-LNs of _bert_tail_kernel (which normalise the f32
// sublayer sum, so this kernel reads f32 there).
//
// What bounds it on the H100: a row of H = 768 is 1.5-3 KB in and out and
// needs a handful of flops per byte, so device-memory bandwidth bounds it
// (rows x H x (in + out bytes) over 3.35 TB/s); the encoder's 37,888-73,728
// rows are 58-340 MB a call.  Design: one warp per row, four rows per
// block (9,472-18,432 blocks at the encoder shapes; ops.layer_norm
// kernel_info() gives the resident blocks per SM).  The row is loaded once
// into registers, all of a lane's loads issued before the first use, in
// chunks of V consecutive values, chunk c at lane c % 32: V = 8 when both
// sides are bf16 (16-byte accesses: 3 loads and 3 stores a lane at H =
// 768), else V = 4 (16 bytes of f32, 8 of bf16), so each warp access
// covers a contiguous 256-512 bytes on either side.  The statistics are
// two-pass in f32 like the reference (mean, then the mean of squared
// deviations) from those registers, scale and shift are read as float4s,
// and the output is written the same way.  A row of up to 1024 values fits
// (LN_VALUES a lane).  An H that is not a multiple of 8, wider than that,
// or unaligned pointers take the scalar loop of the same kernel (three
// passes over the row in device memory, the later ones from L1); the
// wrapper (ops/layer_norm.py vector_path) picks it from H and the pointers.
//
// With stats (the train forward, K6 vitcap_tpu/ops/fused_block.py:1381
// _qkv_train_kernel / :1398 _tail_train_stats_kernel and the post-LNs of
// K7 :1095 _bert_tail_train_kernel) it also writes each row's f32 mean and
// rsig = 1 / sqrt(var + eps), which the analytic backward reads.
#include <type_traits>

#include "wgmma.cuh"  // WgKernel, wg_kernel_info (and common.cuh)

constexpr int LN_ROWS = 4;      // rows per block, a warp each
constexpr int LN_VALUES = 32;   // values a lane holds: H <= 32 * 32 = 1024

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V consecutive values to and from f32 registers, one access each: 16
// bytes for 8 bf16 or 4 f32, 8 bytes for 4 bf16
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  static_assert(V == 4, "f32 moves 4 values an access");
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

template <int V>
__device__ __forceinline__ void load_vec(const bf16* p, float* f) {
  typedef typename std::conditional<V == 8, uint4, uint2>::type W;
  const W u = *reinterpret_cast<const W*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < V / 2; i++) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  static_assert(V == 4, "f32 moves 4 values an access");
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

template <int V>
__device__ __forceinline__ void store_vec(bf16* p, const float* f) {
  typedef typename std::conditional<V == 8, uint4, uint2>::type W;
  W u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < V / 2; i++)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<W*>(p) = u;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(LN_ROWS * 32)
    layer_norm_kernel(const TI* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, TO* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rsig_out, int rows, int H,
                      float eps, int vec) {
  // values per chunk: 8 (16-byte accesses) when both sides are bf16, else
  // 4 (16 bytes of f32, 8 of bf16), so that a warp's accesses to each side
  // are contiguous
  constexpr int V = sizeof(TI) == 2 && sizeof(TO) == 2 ? 8 : 4;
  constexpr int NC = LN_VALUES / V;  // chunks a lane holds
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const TI* xr = x + (size_t)row * H;
  TO* yr = y + (size_t)row * H;
  float mean, rstd;
  if (vec) {
    // chunk c of the row (values V c .. V c + V - 1) at lane c % 32
    const int nc = H / V;
    float v[NC][V];
#pragma unroll
    for (int i = 0; i < NC; i++)
      if (lane + 32 * i < nc) load_vec<V>(xr + V * (lane + 32 * i), v[i]);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; i++)
      if (lane + 32 * i < nc)
#pragma unroll
        for (int e = 0; e < V; e++) s += v[i][e];
    mean = warp_sum(s) / H;
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NC; i++)
      if (lane + 32 * i < nc)
#pragma unroll
        for (int e = 0; e < V; e++) {
          const float d = v[i][e] - mean;
          q += d * d;
        }
    rstd = 1.0f / sqrtf(warp_sum(q) / H + eps);
#pragma unroll
    for (int i = 0; i < NC; i++) {
      const int c = V * (lane + 32 * i);
      if (c < H) {
        float gs[V], bs[V], o[V];
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          load_vec<4>(g + c + e, gs + e);
          load_vec<4>(b + c + e, bs + e);
        }
#pragma unroll
        for (int e = 0; e < V; e++)
          o[e] = (v[i][e] - mean) * rstd * gs[e] + bs[e];
        store_vec<V>(yr + c, o);
      }
    }
  } else {
    float s = 0.0f;
    for (int i = lane; i < H; i += 32) s += to_f32(xr[i]);
    mean = warp_sum(s) / H;
    float q = 0.0f;
    for (int i = lane; i < H; i += 32) {
      const float d = to_f32(xr[i]) - mean;
      q += d * d;
    }
    rstd = 1.0f / sqrtf(warp_sum(q) / H + eps);
    for (int i = lane; i < H; i += 32)
      yr[i] = from_f32<TO>((to_f32(xr[i]) - mean) * rstd * g[i] + b[i]);
  }
  if (mean_out && lane == 0) {
    mean_out[row] = mean;
    rsig_out[row] = rstd;
  }
}

template <typename TI, typename TO>
static void launch(const void* x, const float* g, const float* b, void* y,
                   float* mean, float* rsig, int rows, int H, float eps,
                   int vec, cudaStream_t s) {
  layer_norm_kernel<TI, TO><<<(rows + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0,
                              s>>>(static_cast<const TI*>(x), g, b,
                                   static_cast<TO*>(y), mean, rsig, rows, H,
                                   eps, vec);
}

// mean and rsig: (rows,) f32 outputs, both null when no stats are wanted;
// vec: 1 takes the registers and 16-byte accesses (H % 8 == 0, H <= 1024,
// x, g, b, y 16-byte aligned), 0 the scalar loop
extern "C" int vc_layer_norm(const void* x, const void* g, const void* b,
                             void* y, void* mean, void* rsig, int rows, int H,
                             float eps, int in_dtype, int out_dtype, int vec,
                             void* stream) {
  if ((mean == nullptr) != (rsig == nullptr)) return (int)cudaErrorInvalidValue;
  if (vec && (H % 8 || H > 32 * LN_VALUES)) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rsig);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (in_dtype == VC_F32 && out_dtype == VC_F32)
    launch<float, float>(x, gf, bf, y, mf, rf, rows, H, eps, vec, s);
  else if (in_dtype == VC_F32 && out_dtype == VC_BF16)
    launch<float, bf16>(x, gf, bf, y, mf, rf, rows, H, eps, vec, s);
  else if (in_dtype == VC_BF16 && out_dtype == VC_BF16)
    launch<bf16, bf16>(x, gf, bf, y, mf, rf, rows, H, eps, vec, s);
  else if (in_dtype == VC_BF16 && out_dtype == VC_F32)
    launch<bf16, float>(x, gf, bf, y, mf, rf, rows, H, eps, vec, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#define LN_KERNEL(TI, TO)                                                  \
  {"layer_norm_kernel<" #TI ", " #TO ">",                                  \
   (const void*)layer_norm_kernel<TI, TO>, LN_ROWS * 32, 0}
static const WgKernel LN_KERNELS[] = {
    LN_KERNEL(float, float), LN_KERNEL(float, bf16), LN_KERNEL(bf16, bf16),
    LN_KERNEL(bf16, float)};
#undef LN_KERNEL

// Kernel `index` of the four instances and its launch configuration
// (wg_kernel_info, wgmma.cuh); -1 past the last kernel.
extern "C" int vc_layer_norm_kernel_info(int index, char* name, int len,
                                         int* info) {
  return wg_kernel_info(LN_KERNELS, sizeof(LN_KERNELS) / sizeof(WgKernel),
                        index, name, len, info);
}
