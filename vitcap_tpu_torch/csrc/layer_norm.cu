// layer_norm: per row, f32 mean and variance over an f32 or bf16 input,
// (x - mean) * rsqrt(var + eps) * scale + shift, stored in f32 or bf16.
//
// Replaces the LayerNorm sections of the TPU kernels in
// vitcap_tpu/ops/fused_block.py: LN1 in _qkv_kernel, LN2 in _tail_kernel
// and the two post-LNs of _bert_tail_kernel (which normalise the f32
// sublayer sum, so this kernel reads f32 there).
//
// What bounds it on the H100: a row of H = 768 is 1.5-3 KB and needs a
// handful of flops per byte, so device-memory bandwidth bounds it.  Design:
// one warp per row, four rows per block; the row is read once from device
// memory (later passes hit L1), the statistics are two-pass in f32 like the
// reference (mean, then the mean of squared deviations), and the output
// is written once.
//
// With stats (the train forward, K6 vitcap_tpu/ops/fused_block.py:1381
// _qkv_train_kernel / :1398 _tail_train_stats_kernel and the post-LNs of
// K7 :1095 _bert_tail_train_kernel) it also writes each row's f32 mean and
// rsig = 1 / sqrt(var + eps), which the analytic backward reads.
#include "common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(128)
    layer_norm_kernel(const TI* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, TO* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rsig_out, int rows, int H,
                      float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= rows) return;
  const TI* xr = x + (size_t)row * H;
  TO* yr = y + (size_t)row * H;
  float s = 0.0f;
  for (int i = lane; i < H; i += 32) s += to_f32(xr[i]);
  const float mean = warp_sum(s) / H;
  float v = 0.0f;
  for (int i = lane; i < H; i += 32) {
    float d = to_f32(xr[i]) - mean;
    v += d * d;
  }
  const float rstd = 1.0f / sqrtf(warp_sum(v) / H + eps);
  if (mean_out && lane == 0) {
    mean_out[row] = mean;
    rsig_out[row] = rstd;
  }
  for (int i = lane; i < H; i += 32)
    yr[i] = from_f32<TO>((to_f32(xr[i]) - mean) * rstd * g[i] + b[i]);
}

template <typename TI, typename TO>
static void launch(const void* x, const float* g, const float* b, void* y,
                   float* mean, float* rsig, int rows, int H, float eps,
                   cudaStream_t s) {
  layer_norm_kernel<TI, TO><<<(rows + 3) / 4, 128, 0, s>>>(
      static_cast<const TI*>(x), g, b, static_cast<TO*>(y), mean, rsig, rows,
      H, eps);
}

// mean and rsig: (rows,) f32 outputs, both null when no stats are wanted
extern "C" int vc_layer_norm(const void* x, const void* g, const void* b,
                             void* y, void* mean, void* rsig, int rows, int H,
                             float eps, int in_dtype, int out_dtype,
                             void* stream) {
  if ((mean == nullptr) != (rsig == nullptr)) return (int)cudaErrorInvalidValue;
  float* mf = static_cast<float*>(mean);
  float* rf = static_cast<float*>(rsig);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  if (in_dtype == VC_F32 && out_dtype == VC_F32)
    launch<float, float>(x, gf, bf, y, mf, rf, rows, H, eps, s);
  else if (in_dtype == VC_F32 && out_dtype == VC_BF16)
    launch<float, bf16>(x, gf, bf, y, mf, rf, rows, H, eps, s);
  else if (in_dtype == VC_BF16 && out_dtype == VC_BF16)
    launch<bf16, bf16>(x, gf, bf, y, mf, rf, rows, H, eps, s);
  else if (in_dtype == VC_BF16 && out_dtype == VC_F32)
    launch<bf16, float>(x, gf, bf, y, mf, rf, rows, H, eps, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
