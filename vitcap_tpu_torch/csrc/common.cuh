// Shared helpers for the hand-written Hopper kernels of vitcap_tpu_torch.
//
// Every entry point is a plain C function (bound with ctypes from
// vitcap_tpu_torch/ops/_build.py): pointers and the stream arrive as
// void*, the dtype as an int code, and the function returns
// cudaGetLastError() right after its launch so that a refused launch
// (bad grid, too much shared memory) is reported to the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes shared with the Python wrappers
#define VC_F32 0
#define VC_BF16 1

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like torch's cast
}

// Dropout keep bit at lattice point (r, c): murmur3-fmix32 over the
// coordinates, the seed (an int32 bit-cast to uint32) and a salt, all
// arithmetic mod 2^32; keep iff the hash >= thresh = min(rate * 2^32,
// 2^32 - 1).  Bit for bit vitcap_tpu/ops/flash_attention.py:40
// _dropout_keep, and vitcap_tpu_torch/ops/dropout.py keep_mask.
__device__ __forceinline__ bool vc_dropout_keep(unsigned r, unsigned c,
                                                unsigned seed, unsigned salt,
                                                unsigned thresh) {
  unsigned x = r * 0x9E3779B9u + c * 0x85EBCA6Bu + seed + salt * 0xC2B2AE35u;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

// the dropout parameters a kernel takes: rate 0 is thresh 0 (every bit
// kept) and inv 1.  Attention-prob dropout salts with the global head
// b * nh_total + head_offset + h: a tensor-parallel rank runs heads
// [head_offset, head_offset + nh) of nh_total, and draws the bits the
// unsplit model draws for them (nh_total = nh, head_offset = 0 without
// tensor parallelism).
struct Dropout {
  unsigned seed;
  unsigned thresh;
  float inv;  // 1 / (1 - rate), in f32
  int on;     // rate > 0
  unsigned nh_total;
  unsigned head_offset;
  __device__ __forceinline__ unsigned salt(unsigned b, unsigned h) const {
    return b * nh_total + head_offset + h;
  }
};

// A per-head operand read by base pointer and strides, in elements:
// element (b, h, row, col) of head h's (row, col) at
// p[b * sb + h * sh + row * sr + col].  A (B, L, H) tensor with head h at
// columns [h * hd, (h + 1) * hd) is the case sh = hd: a fused (B, Lp, 3H)
// qkv slab is three of them (p = slab, slab + H, slab + 2H; sb = 3 * H *
// Lp, sr = 3 * H); separate q, k, v tensors or views of one are others.
// A (B, nH, L, dh) tensor (the per-head layout of
// vitcap_tpu/ops/flash_attention.py flash_attention, K9) is sh = L * dh,
// sr = dh when contiguous, or any transposed view of a (B, L, H) one.  The
// wrappers check that p and every stride are 16-byte aligned.
template <typename T>
struct Operand {
  const T* p;
  long long sb, sh, sr;
  __device__ __forceinline__ const T* head(int b, int h) const {
    return p + (size_t)b * sb + (size_t)h * sh;
  }
};

// An additive f32 attention bias (B, 1 | nH, Lp, Lp), rows contiguous:
// row `row` of image b and head h at p + b * sb + h * sh + row * Lp; sh = 0
// broadcasts one (B, 1, Lp, Lp) mask over the heads.  p null: no bias.
struct Bias {
  const float* p;
  long long sb, sh;
  __device__ __forceinline__ const float* row(int b, int h, int r,
                                              int Lp) const {
    return p ? p + (size_t)b * sb + (size_t)h * sh + (size_t)r * Lp
             : nullptr;
  }
};
