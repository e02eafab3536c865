// The pieces of the sampling draw that both vocab_sample_step kernels share (sample_step.cu, the
// CUDA-core kernel, and sample_step_tc.cu, the bf16 tensor-core one): the TPU kernels' uniform
// hash and the 64-bit sort key of a probability.
#pragma once

#include <cstdint>

namespace i2l {
namespace draw {

typedef unsigned long long u64;
constexpr float kUScale = (float)(1.0 - 2e-7);
constexpr float kUShift = (float)1e-7;
constexpr uint32_t kHashT = 0x9E3779B9u, kHashRow = 0x85EBCA6Bu, kHashCol = 0xC2B2AE35u;

// The TPU kernels' uniform draw for one hash input x (decode_step.py:698-714).
__device__ __forceinline__ float hash_uniform(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const float u = __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);  // exact: 24 bits
  return __fadd_rn(__fmul_rn(u, kUScale), kUShift);
}

// Hash input of a row's column 0: row r of the batch is row r % batch_tile of the tile whose
// seed is seed + r / batch_tile; column col adds col * kHashCol.
__device__ __forceinline__ uint32_t row_base(uint32_t seed, int row, int t, int batch_tile) {
  return seed + (uint32_t)(row / batch_tile) + (uint32_t)t * kHashT + (uint32_t)(row % batch_tile) * kHashRow;
}

// Sort key of a probability (non-negative, so its bits order as its value) and its column:
// descending keys give descending probabilities, ties lowest column first.
__device__ __forceinline__ u64 prob_key(float p, int col) {
  return ((u64)__float_as_uint(p) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)col);
}
__device__ __forceinline__ float key_prob(u64 k) { return __uint_as_float((uint32_t)(k >> 32)); }
__device__ __forceinline__ int key_col(u64 k) { return (int)(0xFFFFFFFFu - (uint32_t)k); }

}  // namespace draw
}  // namespace i2l
