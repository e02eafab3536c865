// One block's 32-row x 64-column tile of C = A B on the tensor cores, for the bf16 row kernels
// whose product is small and whose epilogue is their own: vocab_argmax_step (greedy_decode.cu,
// A = h, B = W_out), the sampling and beam steps (sample_step_tc.cu, beam_step_tc.cu, through
// vocab_slices.cuh) and attention's hw = h @ W_h (grid_attend.cu).
//
// A (M x K) row-major, B (K x N) row-major (k-major, N contiguous), both bf16.  256 threads a
// block, 8 warps as 2 (rows) x 4 (columns) of 16 x 16 each: per k16 step a warp does one
// ldmatrix_x4 of A, one ldmatrix_x4_trans of B (two n8 tiles) and two mma.sync m16n8k16.  Both
// operands are staged untouched through a ring of cp.async 16-byte copies (rows padded by 16 bytes,
// so that ldmatrix meets no bank conflict).  Each 64-deep stage is summed by the tensor cores from
// zero and added to the running sums in IEEE float32, so that the tensor cores' additions (which
// truncate) run over 64 products at most (lstm_layer_step_tc_kernel's scheme, PERF.md §6).
//
// kAligned: K and N are multiples of 8 and both bases 16-byte aligned, so an 8-element chunk lies
// in one row: 16-byte copies, zero-filled past M, K and N.  Otherwise each element is loaded and
// stored alone, guarded.
//
// The caller's fragments (per lane, g = lane / 4, q = lane % 4, warp (wm, wn) = (warp / 4, warp % 4)):
//   acc[j][0..1] = C[row0 + wm 16 + g,     col0 + wn 16 + 8 j + 2 q + 0..1]
//   acc[j][2..3] = C[row0 + wm 16 + g + 8, col0 + wn 16 + 8 j + 2 q + 0..1]
#pragma once

#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace i2l {
namespace tile {

using bf16 = __nv_bfloat16;
constexpr int kWM = 2;                    // warps along rows
constexpr int kWN = 4;                    // warps along columns
constexpr int kThreads = 32 * kWM * kWN;  // 256
constexpr int kBM = 16 * kWM;             // rows a block: 32
constexpr int kBN = 16 * kWN;             // columns a block: 64
constexpr int kBK = 64;                   // depth of a stage
constexpr int kStages = 4;                // depth of the cp.async ring
constexpr int kAPitch = kBK + 8;
constexpr int kBPitch = kBN + 8;
constexpr int kAElems = kBM * kAPitch;
constexpr int kStageElems = kAElems + kBK * kBPitch;
constexpr int kSmemBytes = kStages * kStageElems * (int)sizeof(bf16);  // 55,296
constexpr int kAChunks = kBM * kBK / 8 / kThreads;                     // 16-byte chunks of A a thread copies a stage
constexpr int kBChunks = kBK * kBN / 8 / kThreads;                     // ... of B
static_assert(kAChunks * 8 * kThreads == kBM * kBK && kBChunks * 8 * kThreads == kBK * kBN,
              "a stage splits evenly over the threads");
static_assert((kStageElems * (int)sizeof(bf16)) % 16 == 0, "16-byte aligned stages");

template <bool kAligned>
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* __restrict__ A, const bf16* __restrict__ B,
                                           int M, int N, int K, int row0, int col0, int k0) {
  bf16* As = stage;
  bf16* Bs = stage + kAElems;
  const int tid = threadIdx.x;
  if (kAligned) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kBK / 8), kc = (e % (kBK / 8)) * 8;
      const int row = row0 + r, k = k0 + kc;
      const bool ok = row < M && k < K;
      cp_async_16(As + r * kAPitch + kc, ok ? A + (size_t)row * K + k : A, ok);
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int e = tid + i * kThreads;
      const int kr = e / (kBN / 8), nc = (e % (kBN / 8)) * 8;
      const int k = k0 + kr, col = col0 + nc;
      const bool ok = k < K && col < N;
      cp_async_16(Bs + kr * kBPitch + nc, ok ? B + (size_t)k * N + col : B, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kBK, kk = e % kBK;
      const int row = row0 + r, k = k0 + kk;
      As[r * kAPitch + kk] = row < M && k < K ? A[(size_t)row * K + k] : zero;
    }
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kr = e / kBN, n = e % kBN;
      const int k = k0 + kr, col = col0 + n;
      Bs[kr * kBPitch + n] = k < K && col < N ? B[(size_t)k * N + col] : zero;
    }
  }
}

// acc = the block's tile at (row0, col0) of A B, in the fragment layout above.  smem: kSmemBytes,
// 16-byte aligned.  Every thread of the block calls it; it returns with the ring drained and
// everyone past it, so the caller may reuse smem at once.
template <bool kAligned>
__device__ __forceinline__ void block_product(float (&acc)[2][4], bf16* smem, const bf16* __restrict__ A,
                                              const bf16* __restrict__ B, int M, int N, int K, int row0,
                                              int col0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / kWN, wn = warp % kWN;
  const int nk = (K + kBK - 1) / kBK;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage<kAligned>(smem + s * kStageElems, A, B, M, N, K, row0, col0, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and everyone is done with stage kt - 1
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage<kAligned>(smem + (nxt % kStages) * kStageElems, A, B, M, N, K, row0, col0, nxt * kBK);
    cp_async_commit();
    const bf16* As = smem + (kt % kStages) * kStageElems;
    const bf16* Bs = As + kAElems;
    float part[2][4] = {};  // this stage's sums, from zero
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, As + (wm * 16 + lane % 16) * kAPitch + kk + (lane / 16) * 8);
      ldmatrix_x4_trans(b, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * kBPitch + wn * 16 + (lane / 16) * 8);
      mma_bf16_16816(part[0], a, b[0], b[1]);
      mma_bf16_16816(part[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace tile
}  // namespace i2l
