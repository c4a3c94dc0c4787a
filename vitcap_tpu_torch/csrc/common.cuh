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
