// Shared helpers of the port's kernels: float32 <-> storage-type conversion.
// Storage types are float (dtype code 0) and __nv_bfloat16 (dtype code 1);
// all arithmetic is float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace i2l {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// x rounded to the storage type T and back: the rounding points of the TPU
// kernels, where they cast an intermediate to the compute type.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

}  // namespace i2l
