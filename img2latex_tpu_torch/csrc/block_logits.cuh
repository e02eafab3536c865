// The CUDA-core vocab product of up to 16 rows in one block, into shared (or
// device) memory: logits[r][col] = h[row0 + r] @ W_out[:, col] + b_out[col]
// in float32, for the block kernels of beam_step.cu and sample_step.cu (the
// float32 route, the exactness oracle, and the bf16 shapes their tensor-core
// cluster kernels do not take; those use vocab_slices.cuh).
//
// The block's h rows are staged in shared memory once, k-major; W_out
// streams through a 32 x 128 shared tile with the next tile's 16-byte loads
// in flight in registers while the current one is used.  Each of the 256
// threads computes one row x 8 columns of a 128-column chunk on the CUDA
// cores.  W_out (H, Vp) must be 16-byte aligned with Vp a multiple of 128.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace i2l {
namespace logits {

constexpr int kThreads = 256;  // threads of a block that calls block_logits
constexpr int kRows = 16;      // rows a call at most
constexpr int BN = 128;        // columns a chunk
constexpr int BK = 32;         // depth of a W_out tile
constexpr int TN = 8;          // columns a thread, a chunk
constexpr int HS = kRows + 1;  // row stride of the staged h (k-major), padded against bank conflicts

// Floats of shared memory block_logits stages through: the h rows (rounded
// up to a multiple of 4, so what follows stays 16-byte aligned) and the
// W_out tile.
__host__ __device__ inline int staged_floats(int H) {
  const int Hp = (H + BK - 1) / BK * BK;
  return (Hp * HS + 3) / 4 * 4 + BK * BN;
}

// Loads of one W_out tile (BK x BN) into registers: two groups of 8
// consecutive columns a thread, converted to float32.  Rows past H give 0.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ w_out, int H, int Vp, int k0, int n0,
                                          float (&r)[2][TN]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int kk = g / (BN / TN), cg = g % (BN / TN);
    const int k = k0 + kk;
    if (k < H) {
      const T* p = w_out + (size_t)k * Vp + n0 + cg * TN;
      if constexpr (sizeof(T) == 2) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < TN; ++j) r[i][j] = to_f(v[j]);
      } else {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
        r[i][0] = a.x; r[i][1] = a.y; r[i][2] = a.z; r[i][3] = a.w;
        r[i][4] = b.x; r[i][5] = b.y; r[i][6] = b.z; r[i][7] = b.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j) r[i][j] = 0.f;
    }
  }
}

__device__ __forceinline__ void store_tile(float* ws, const float (&r)[2][TN]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int kk = g / (BN / TN), cg = g % (BN / TN);
    float4* d = reinterpret_cast<float4*>(ws + kk * BN + cg * TN);
    d[0] = make_float4(r[i][0], r[i][1], r[i][2], r[i][3]);
    d[1] = make_float4(r[i][4], r[i][5], r[i][6], r[i][7]);
  }
}

// out[r * Vp + col] = h[row0 + r] . W_out[:, col] + b_out[col] for r < R
// (R <= kRows), by all kThreads threads of the block.  `stage` is
// staged_floats(H) floats of 16-byte aligned shared memory.  Ends with the
// block synchronised: `out` is complete and `stage` free.
template <typename T>
__device__ void block_logits(const T* __restrict__ h, const T* __restrict__ w_out,
                             const float* __restrict__ b_out, int H, int Vp, int row0, int R,
                             float* stage, float* out) {
  const int Hp = (H + BK - 1) / BK * BK;
  float* hs = stage;
  float* ws = stage + (Hp * HS + 3) / 4 * 4;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  for (int e = tid; e < kRows * Hp; e += kThreads) {
    const int r = e / Hp, k = e % Hp;
    hs[k * HS + r] = (r < R && k < H) ? to_f(h[(size_t)(row0 + r) * H + k]) : 0.f;
  }
  const int nk = Hp / BK;
  const int ntiles = nk * (Vp / BN);
  float nxt[2][TN];
  load_tile(w_out, H, Vp, 0, 0, nxt);
  store_tile(ws, nxt);
  __syncthreads();
  float acc[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) acc[j] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int n0 = (i / nk) * BN, k0 = (i % nk) * BK;
    if (i + 1 < ntiles) load_tile(w_out, H, Vp, ((i + 1) % nk) * BK, ((i + 1) / nk) * BN, nxt);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float a = hs[(k0 + kk) * HS + ty];
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk * BN + tx * TN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk * BN + tx * TN + 4]);
      acc[0] = fmaf(a, b0.x, acc[0]);
      acc[1] = fmaf(a, b0.y, acc[1]);
      acc[2] = fmaf(a, b0.z, acc[2]);
      acc[3] = fmaf(a, b0.w, acc[3]);
      acc[4] = fmaf(a, b1.x, acc[4]);
      acc[5] = fmaf(a, b1.y, acc[5]);
      acc[6] = fmaf(a, b1.z, acc[6]);
      acc[7] = fmaf(a, b1.w, acc[7]);
    }
    if (i % nk == nk - 1) {  // the chunk's last tile: its logits are complete
      if (ty < R) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = n0 + tx * TN + j;
          out[(size_t)ty * Vp + col] = acc[j] + b_out[col];
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[j] = 0.f;
    }
    __syncthreads();
    if (i + 1 < ntiles) store_tile(ws, nxt);
    __syncthreads();
  }
}

}  // namespace logits
}  // namespace i2l
