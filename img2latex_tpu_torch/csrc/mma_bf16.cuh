// Tensor-core building blocks of the port's bf16 kernels (sm_80 and later PTX, built for sm_90a):
// ldmatrix, mma.sync m16n8k16 with bf16 operands and float32 sums, and cp.async with its
// commit/wait wrappers.  Included by greedy_decode.cu, grid_attend.cu (also through tile_mma.cuh),
// conv_pool.cu, conv1_pool_tc.cu, lstm_seq_tc.cu, and through tile_mma.cuh and vocab_slices.cuh by sample_step_tc.cu
// and beam_step_tc.cu.
//
// Fragment layout of mma.m16n8k16.row.col (PTX ISA, "Matrix Fragments for mma.m16n8k16"), for lane
// l, g = l / 4, q = l % 4:
//   A (16 x 16, row-major): a0 (g, 2q..2q+1), a1 (g + 8, 2q..), a2 (g, 2q + 8..), a3 (g + 8, 2q + 8..)
//   B (16 x 8, "col"):      b0 (k 2q..2q+1, n g), b1 (k 2q + 8.., n g)
//   C (16 x 8, float32):    c0, c1 (g, 2q..2q+1), c2, c3 (g + 8, 2q..2q+1)
// ldmatrix_x4 fills a0..a3 from a row-major tile in shared memory when lane l points at row l % 16,
// column 8 (l / 16); ldmatrix_x4_trans fills (b0, b1) of two n8 tiles from a k-major tile
// (n contiguous) when lane l points at k row (l % 8) + 8 ((l / 8) % 2) of the tile l / 16.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace i2l {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b for one 16 x 8 x 16 tile: bf16 operands, float32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy global -> shared; when !valid the 16 bytes are zero-filled and
// nothing is read (src must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// The same through L1: many rows of a block gather the same embedding row (every row holds the
// start token at the first step of a decode), and L1 serves the repeats.
__device__ __forceinline__ void cp_async_16_l1(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most n groups committed by this thread are still in flight.
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// Above 48 KB a kernel's dynamic shared memory must be allowed, once per device; `done` is the
// caller's per-kernel record of the devices already done.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, bool (&done)[16]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 16 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 16) done[dev] = true;
  return err;
}

}  // namespace i2l
