// One additive-attention step over grid memory, for all rows.
//
// Replaces the attention of the TPU kernels
// img2latex_tpu/ops/pallas/grid_decode.py::pallas_full_grid_greedy_decode
// (pl.pallas_call at line 373) and ::pallas_full_grid_beam_decode
// (pl.pallas_call at line 561): grid_decode.py::_attend (lines 124-139),
// which the kernels' decode loops call every step from the previous
// top-layer h.  The rest of those loops is greedy_decode.cu's and
// beam_step.cu's kernels.
//
// Rows share memories: row b attends over memory row b / rows_per_mem (1
// for greedy; K for beam, whose K beams of a sample are adjacent rows, so
// U and the memory are never copied K times).  Per row b, with
// U = memory @ W_m + b_attn computed once per batch outside and
// m = b / rows_per_mem:
//   hw     = h_b @ W_h                   summed in float32, rounded to T
//   e_s    = tanh(U_ms + hw)             the sum and the tanh rounded to T
//   score_s = sum_a e_sa v_a             each product rounded to T, summed in float32
//   w      = softmax_s(score)            float32, rounded to T
//   ctx_b  = sum_s w_s mem_ms            each product rounded to T, summed in float32
// The rounding points are _attend's (where it casts to the compute type), so
// the kernel and its plain version round alike; in float32 they are exact.
//
// Bound: every step reads all of U and the memory, (A + E) S 2 bytes a row
// in bf16: at B = 512, S = 100, E = 256, A = 384 that is 65.5 MB a step, more
// than the 50 MB L2, so it is bound by device memory: about 19.6 us a step at
// 3.35 TB/s.  h @ W_h is only 2 B H A = 0.15 GFLOP a step.  With K beams a
// sample (rows_per_mem = K) the bound stays that of the memory, since each
// byte is needed once a step; this version gives each beam its own block,
// so a step asks for K times the memory's bytes, the K blocks of a sample
// being adjacent and finding its lines in L2 when they run close together.
//
// Two kernels, launched together by i2l_attend_step:
//   attend_hw_kernel   hw (B, A) = h @ W_h, a register-tiled product (16 rows x
//                      64 columns a block), so W_h (H x A, 295 KB in bf16) is
//                      read once per 16 rows from L2 (9.4 MB a step) and not
//                      once per row (512 x 295 KB = 151 MB of L2 reads a step).
//   attend_kernel      one block of 8 warps per row: the warps take the S
//                      slots in turn and stream U's row of each with 16-byte
//                      loads, a lane holding hw and v of its columns in
//                      registers, and reduce the score with shuffles; the
//                      softmax runs over the S scores in shared memory; then
//                      the warps stream the memory the same way, each lane
//                      summing its columns of ctx in float32 registers, and
//                      the warps' sums are added at the end.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- attend_hw_kernel: hw = h @ W_h ---------------------------------------
constexpr int P_BM = 16;  // rows per block: 192 blocks at B = 512, A = 384
constexpr int P_BN = 64;  // columns per block
constexpr int P_BK = 64;  // deep tiles: few load-then-sync rounds over H
constexpr int P_TM = 1;   // rows per thread
constexpr int P_TN = 4;   // columns per thread

template <typename T>
__global__ void __launch_bounds__(kThreads) attend_hw_kernel(
    const T* __restrict__ h, const T* __restrict__ w_h, T* __restrict__ hw, int B, int H, int A) {
  __shared__ __align__(16) float As[P_BK][P_BM + 4];
  __shared__ __align__(16) float Bs[P_BK][P_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * P_BM, col0 = blockIdx.x * P_BN;
  float acc[P_TM][P_TN] = {};
  for (int k0 = 0; k0 < H; k0 += P_BK) {
#pragma unroll
    for (int e = tid; e < P_BM * P_BK; e += kThreads) {
      const int r = e / P_BK, kk = e % P_BK;
      const int row = row0 + r, k = k0 + kk;
      As[kk][r] = (row < B && k < H) ? i2l::to_f(h[(size_t)row * H + k]) : 0.f;
    }
#pragma unroll
    for (int e = tid; e < P_BK * P_BN; e += kThreads) {
      const int kk = e / P_BN, n = e % P_BN;
      const int k = k0 + kk, col = col0 + n;
      Bs[kk][n] = (k < H && col < A) ? i2l::to_f(w_h[(size_t)k * A + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P_BK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * P_TN]);
      const float b[P_TN] = {b4.x, b4.y, b4.z, b4.w};
      float a[P_TM];
#pragma unroll
      for (int i = 0; i < P_TM; ++i) a[i] = As[kk][ty * P_TM + i];
#pragma unroll
      for (int i = 0; i < P_TM; ++i)
#pragma unroll
        for (int j = 0; j < P_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < P_TM; ++i) {
    const int row = row0 + ty * P_TM + i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < P_TN; ++j) {
      const int col = col0 + tx * P_TN + j;
      if (col < A) hw[(size_t)row * A + col] = i2l::from_f<T>(acc[i][j]);
    }
  }
}

// ---- attend_kernel: scores, softmax, context -------------------------------

// VEC consecutive values from p as float32: one 16-byte load where VEC
// values are 16 bytes (the caller has checked the alignment), else scalars.
// The loads are marked streaming (evict first): U and the memory are read
// once a step and are larger than L2, and should not evict the decoder's
// weights that the other kernels of the step read from L2.
template <typename T, int VEC>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float (&o)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = i2l::to_f(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = i2l::to_f(__ldcs(p + j));
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Block-wide sum (kMax = false) or max of one value a thread; every thread
// gets the result.  red holds kWarps floats.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red may be reused at once
  return r;
}

// Dynamic shared memory: scores (S), partial ctx (kWarps x E), all float32,
// then kWarps floats for the reductions.
//
// A lane owns VEC consecutive columns of a chunk of 32 VEC columns; for each
// chunk the warps take the S slots in turn (warp w: w, w + 8, ...), kUnroll
// slots at once so that several 16-byte loads are in flight.  A slot's
// score is summed over the chunks by the one warp that owns the slot.  The
// hw and v of a lane's columns and its context sums stay in registers.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4) attend_kernel(
    const T* __restrict__ hw, const T* __restrict__ v, const T* __restrict__ u,
    const T* __restrict__ mem, T* __restrict__ ctx, int S, int E, int A, int rows_per_mem) {
  constexpr int kUnroll = 2;
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;
  float* part = sc + S;
  float* red = part + kWarps * E;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  for (int s = tid; s < S; s += kThreads) sc[s] = 0.f;
  __syncthreads();

  // scores
  const int mb = b / rows_per_mem;  // the memory row this row attends over
  const T* u_b = u + (size_t)mb * S * A;
  for (int c0 = 0; c0 < A; c0 += 32 * VEC) {
    const int a0 = c0 + lane * VEC;
    const bool on = a0 < A;  // A % VEC == 0, so a lane's VEC columns are all in or all out
    float hw_r[VEC], v_r[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      hw_r[j] = on ? i2l::to_f(hw[(size_t)b * A + a0 + j]) : 0.f;
      v_r[j] = on ? i2l::to_f(v[a0 + j]) : 0.f;
    }
    for (int s0 = warp; s0 < S; s0 += kWarps * kUnroll) {
      float x[kUnroll][VEC];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int s = s0 + q * kWarps;
        if (on && s < S) load_f<T, VEC>(u_b + (size_t)s * A + a0, x[q]);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int s = s0 + q * kWarps;
        float acc = 0.f;
        if (on && s < S) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float e = i2l::round_to<T>(tanhf(i2l::round_to<T>(x[q][j] + hw_r[j])));
            acc += i2l::round_to<T>(e * v_r[j]);
          }
        }
        acc = warp_sum(acc);
        if (lane == 0 && s < S) sc[s] += acc;
      }
    }
  }
  __syncthreads();

  // softmax over the S slots, float32
  float m = -3.402823466e+38f;
  for (int s = tid; s < S; s += kThreads) m = fmaxf(m, sc[s]);
  m = block_reduce<true>(m, red);
  float z = 0.f;
  for (int s = tid; s < S; s += kThreads) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    z += e;
  }
  z = block_reduce<false>(z, red);
  for (int s = tid; s < S; s += kThreads) sc[s] = i2l::round_to<T>(sc[s] / z);
  __syncthreads();

  // context: each warp sums its slots into its own row of part
  const T* m_b = mem + (size_t)mb * S * E;
  for (int c0 = 0; c0 < E; c0 += 32 * VEC) {
    const int e0 = c0 + lane * VEC;
    const bool on = e0 < E;
    float acc[VEC] = {};
    for (int s0 = warp; s0 < S; s0 += kWarps * kUnroll) {
      float x[kUnroll][VEC];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int s = s0 + q * kWarps;
        if (on && s < S) load_f<T, VEC>(m_b + (size_t)s * E + e0, x[q]);
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int s = s0 + q * kWarps;
        if (on && s < S) {
          const float w = sc[s];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += i2l::round_to<T>(w * x[q][j]);
        }
      }
    }
    if (on) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) part[warp * E + e0 + j] = acc[j];
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += part[w * E + e];
    ctx[(size_t)b * E + e] = i2l::from_f<T>(acc);
  }
}

size_t attend_smem_bytes(int S, int E) {
  return sizeof(float) * ((size_t)S + (size_t)kWarps * E + kWarps);
}

template <typename T, int VEC>
cudaError_t launch_attend(const void* hw, const void* v, const void* u, const void* mem, void* ctx,
                          int B, int S, int E, int A, int rows_per_mem, cudaStream_t stream) {
  const size_t smem = attend_smem_bytes(S, E);
  auto kernel = attend_kernel<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, stream>>>(static_cast<const T*>(hw), static_cast<const T*>(v),
                                        static_cast<const T*>(u), static_cast<const T*>(mem),
                                        static_cast<T*>(ctx), S, E, A, rows_per_mem);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* h, const void* w_h, const void* v, const void* u, const void* mem,
                   void* hw, void* ctx, int B, int S, int E, int H, int A, int rows_per_mem,
                   cudaStream_t stream) {
  dim3 grid((A + P_BN - 1) / P_BN, (B + P_BM - 1) / P_BM);
  attend_hw_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_h), static_cast<T*>(hw), B, H, A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // 16-byte loads of U and memory rows need rows of whole 16-byte groups
  // and 16-byte aligned bases.
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = A % kVec == 0 && E % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(mem) % 16 == 0;
  return vec ? launch_attend<T, kVec>(hw, v, u, mem, ctx, B, S, E, A, rows_per_mem, stream)
             : launch_attend<T, 1>(hw, v, u, mem, ctx, B, S, E, A, rows_per_mem, stream);
}

}  // namespace

// One attention step for B rows.  h (B, H); w_h (H, A); v (A,); u
// (B / rows_per_mem, S, A); mem (B / rows_per_mem, S, E); hw (B, A)
// scratch; ctx (B, E) receives the context.  All in the compute type
// (dtype 0 float32, 1 bfloat16), contiguous; B a multiple of rows_per_mem.
extern "C" int i2l_attend_step(const void* h, const void* w_h, const void* v, const void* u,
                               const void* mem, void* hw, void* ctx, int B, int S, int E, int H,
                               int A, int rows_per_mem, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || E <= 0 || H <= 0 || A <= 0 || rows_per_mem <= 0 ||
      B % rows_per_mem != 0 || (B + P_BM - 1) / P_BM > 65535 ||
      attend_smem_bytes(S, E) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch<float>(h, w_h, v, u, mem, hw, ctx, B, S, E, H, A, rows_per_mem, s);
  if (dtype == i2l::kBF16)
    return (int)launch<__nv_bfloat16>(h, w_h, v, u, mem, hw, ctx, B, S, E, H, A, rows_per_mem, s);
  return (int)cudaErrorInvalidValue;
}
