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
// output that the train backwards of K6 and K7 keep).
//
// Replaces the matrix products inside the TPU kernels of
// vitcap_tpu/ops/fused_block.py: _qkv_kernel (qkv), _tail_kernel (proj,
// fc1, fc2), _bert_qkv_kernel (fused q/k/v) and _bert_tail_kernel
// (out-dense, intermediate, output).  W keeps the torch Linear layout
// (out, in), so A and W are both K-contiguous.
//
// What bounds it on the H100: at the main path's shapes (M = B * 592,
// K, N in {768, 2304, 3072}) the products are far above the card's
// ops-per-byte line, so the tensor cores' issue rate bounds the bf16 path.
// This first version is a plain tiled kernel: 128x128x32 block tiles,
// 8 warps of 64x32, WMMA bf16 16x16x16 fragments (mma.sync underneath),
// a two-stage cp.async ring in shared memory, and the epilogue applied
// fragment by fragment through a small per-warp staging tile so the
// (M, N) result is written once.  wgmma/TMA come later.
// The f32 path is full f32 on the CUDA cores (no TF32), because f32 is the
// ModelConfig default and the parity contract is exact f32 arithmetic.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

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
};

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

template <typename T>
__device__ __forceinline__ void epi_store(const Epilogue& e, int row, int col,
                                          float v) {
  if (row >= e.M || col >= e.N) return;
  const size_t idx = (size_t)row * e.N + col;
  const T* res = static_cast<const T*>(e.res);
  if (e.f32_sum) {
    if (e.bias) v += e.bias[col];
    if (e.gelu) v = gelu_erf(rnd<T>(v));
    if (res) v += to_f32(res[idx]);
  } else if (e.bias_first) {
    v = rnd<T>(v);
    if (e.bias) v = rnd<T>(v + rnd<T>(e.bias[col]));
    if (e.drop.on) {
      const int img = row / e.rows_per_image;
      v = vc_dropout_keep(row - img * e.rows_per_image, col, e.drop.seed,
                          2u * img + e.which, e.drop.thresh)
              ? rnd<T>(v * rnd<T>(e.drop.inv))
              : 0.0f;
    }
    if (res) v = rnd<T>(to_f32(res[idx]) + v);
  } else {
    v = rnd<T>(v);
    if (res) v = rnd<T>(v + to_f32(res[idx]));
    if (e.bias) v = rnd<T>(v + rnd<T>(e.bias[col]));
    if (e.pre) static_cast<T*>(e.pre)[idx] = from_f32<T>(v);
    if (e.gelu) v = gelu_erf(v);
  }
  if (e.out_f32)
    static_cast<float*>(e.out)[idx] = v;
  else
    static_cast<T*>(e.out)[idx] = from_f32<T>(v);
}

// ---------------------------------------------------------------------------
// bf16: WMMA tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 32, LDS = BK + 8;  // +8: bank skew
constexpr int TILE_ELEMS = BM * LDS;                       // one stage, A or W

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows,
                                          int K, int r0, int k0) {
  // BM x BK tile as 16-byte chunks: 128 rows * 4 chunks = 512 chunks
  for (int i = threadIdx.x; i < BM * (BK / 8); i += blockDim.x) {
    int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    int gr = r0 + r, gk = k0 + c;
    bool p = gr < rows && gk < K;
    const bf16* g = p ? src + (size_t)gr * K + gk : src;
    cp_async16(dst + r * LDS + c, g, p);
  }
}

__global__ void __launch_bounds__(256)
    gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
                     Epilogue e, int K) {
  __shared__ __align__(128) unsigned char smem[4 * TILE_ELEMS * sizeof(bf16)];
  bf16* As = reinterpret_cast<bf16*>(smem);  // [2][BM][LDS]
  bf16* Ws = As + 2 * TILE_ELEMS;            // [2][BN][LDS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps, 64 x 32 each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int nk = (K + BK - 1) / BK;
  load_tile(As, A, e.M, K, m0, 0);
  load_tile(Ws, W, e.N, K, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile(As + (cur ^ 1) * TILE_ELEMS, A, e.M, K, m0, (kt + 1) * BK);
      load_tile(Ws + (cur ^ 1) * TILE_ELEMS, W, e.N, K, n0, (kt + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const bf16* a_s = As + cur * TILE_ELEMS;
    const bf16* w_s = Ws + cur * TILE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], w_s + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the operand ring is free now; each warp stages one 16x16
  // f32 fragment at a time and its 32 lanes write 8 outputs each
  float* cs = reinterpret_cast<float*>(smem) + warp * 256;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int t = lane; t < 256; t += 32)
        epi_store<bf16>(e, m0 + wm * 64 + i * 16 + t / 16,
                        n0 + wn * 32 + j * 16 + t % 16, cs[t]);
      __syncwarp();
    }
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

extern "C" int vc_gemm(const void* a, const void* w, const void* bias,
                       const void* res, void* out, void* pre, int M, int N,
                       int K, int dtype, int gelu, int f32_sum, int out_f32,
                       int bias_first, unsigned seed, unsigned thresh,
                       float inv, int which, int rows_per_image,
                       void* stream) {
  if (bias_first && (f32_sum || gelu || rows_per_image <= 0))
    return (int)cudaErrorInvalidValue;
  Epilogue e{static_cast<const float*>(bias), res, out, pre, M, N, gelu,
             f32_sum, out_f32, bias_first,
             Dropout{seed, thresh, inv, thresh != 0u || inv != 1.0f},
             static_cast<unsigned>(which), rows_per_image};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == VC_BF16) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    gemm_bf16_kernel<<<grid, 256, 0, s>>>(static_cast<const bf16*>(a),
                                          static_cast<const bf16*>(w), e, K);
  } else if (dtype == VC_F32) {
    dim3 grid((N + FB - 1) / FB, (M + FB - 1) / FB);
    gemm_f32_kernel<<<grid, 256, 0, s>>>(static_cast<const float*>(a),
                                         static_cast<const float*>(w), e, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
