// Whole greedy decode of the LSTM decoder (vector memory), one step at a time.
//
// Replaces the TPU kernel img2latex_tpu/ops/pallas/decode_step.py::pallas_full_greedy_decode
// (pl.pallas_call at line 523, early_exit=False, no scores); one step of it is
// decode_step.py::fused_decode_step (pl.pallas_call at line 176).
//
// The TPU kernel holds all decoder weights in VMEM for the 141 steps (about
// 11.5 MB in bf16 at E = H = 512, L = 2).  An H100 SM has 227 KB of shared
// memory, so here the weights stay in the 50 MB L2 and each step is L + 1
// launches of two kernels, driven by a host loop:
//
//   lstm_layer_step   gates = [emb[tok]; ctx] @ W_ih + h @ W_hh + b for one
//                     layer (the embedding is a row gather inside layer 0),
//                     fused with the gate math in float32; c and the new h
//                     are stored in the compute type, as on the TPU.
//   vocab_argmax_step logits = h @ W_out + b_out fused with the row argmax
//                     (lowest index wins ties), the PAD-after-END rule and
//                     the token store; logits never reach device memory.
//
// Bound: per row and step the products are 2 (2E + H) 4H + 2 H 4H + 2 H Vp
// FLOP = 11 MFLOP at E = H = Vp = 512, while the weights (11.5 MB in bf16)
// are shared by all rows: at batch 512 that is about 490 FLOP per byte of
// device memory, above the H100's ~295, so a large batch is bound by the
// tensor-core rate.  This first version multiplies on the CUDA cores in
// float32 (simple and exact for both storage types): its limit is the
// float32 FMA rate; moving the products to wgmma is later work.
//
// Both kernels are register-tiled products over shared-memory tiles, with
// 256 threads a block and float32 accumulation:
//   lstm_layer_step: a block takes 64 rows x 32 hidden units, i.e. the 128
//     gate columns {g H + j} of those units, so each thread ends holding all
//     four gates of its 4 rows x 2 units and can apply the cell update.
//   vocab_argmax_step: a block takes 16 rows and walks all Vp columns in
//     chunks of 128, each thread keeping a running (max, index) of its row;
//     the 16 threads of a row then reduce with warp shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---- lstm_layer_step ------------------------------------------------------
constexpr int L_BM = 64;          // rows per block
constexpr int L_HU = 32;          // hidden units per block
constexpr int L_BN = 4 * L_HU;    // gate columns per block
constexpr int L_BK = 16;          // depth of one shared-memory tile
constexpr int L_TM = 4;           // rows per thread
constexpr int L_TU = 2;           // hidden units per thread

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_layer_step_kernel(
    const int* __restrict__ tokens, const T* __restrict__ emb, int E0,
    const T* __restrict__ x1, int E1, const T* __restrict__ h_in,
    const T* __restrict__ w_ih, const T* __restrict__ w_hh, const float* __restrict__ bias,
    T* __restrict__ c, T* __restrict__ h_out, int B, int H) {
  // As is stored k-major with 4 floats of padding per row, which spreads the
  // transposing stores over the banks and keeps the float4 reads aligned.
  __shared__ __align__(16) float As[L_BK][L_BM + 4];
  __shared__ __align__(16) float Bs[L_BK][L_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * L_BM;
  const int j0 = blockIdx.x * L_HU;
  const int In = E0 + E1;
  const int K = In + H;
  const int G = 4 * H;

  float acc[L_TM][4][L_TU];
#pragma unroll
  for (int i = 0; i < L_TM; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int u = 0; u < L_TU; ++u) acc[i][g][u] = 0.f;

  for (int k0 = 0; k0 < K; k0 += L_BK) {
    // A tile (rows x depth): x = [emb[tok] | x1 | h_in] along k.
#pragma unroll
    for (int e = tid; e < L_BM * L_BK; e += kThreads) {
      const int r = e / L_BK, kk = e % L_BK;
      const int row = row0 + r, k = k0 + kk;
      float v = 0.f;
      if (row < B && k < K) {
        if (k < E0)
          v = i2l::to_f(emb[(size_t)tokens[row] * E0 + k]);
        else if (k < In)
          v = i2l::to_f(x1[(size_t)row * E1 + (k - E0)]);
        else
          v = i2l::to_f(h_in[(size_t)row * H + (k - In)]);
      }
      As[kk][r] = v;
    }
    // B tile (depth x gate columns): column n is gate n / 32 of unit j0 + n % 32.
#pragma unroll
    for (int e = tid; e < L_BK * L_BN; e += kThreads) {
      const int kk = e / L_BN, n = e % L_BN;
      const int g = n / L_HU, j = j0 + n % L_HU;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < K && j < H) {
        const T* wrow = k < In ? w_ih + (size_t)k * G : w_hh + (size_t)(k - In) * G;
        v = i2l::to_f(wrow[g * H + j]);
      }
      Bs[kk][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < L_BK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * L_TM]);
      const float a[L_TM] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 b2 = *reinterpret_cast<const float2*>(&Bs[kk][g * L_HU + tx * L_TU]);
#pragma unroll
        for (int i = 0; i < L_TM; ++i) {
          acc[i][g][0] = fmaf(a[i], b2.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(a[i], b2.y, acc[i][g][1]);
        }
      }
    }
    __syncthreads();
  }

  // Cell update, gate order (i, f, g, o); c in place, new h to h_out.
#pragma unroll
  for (int i = 0; i < L_TM; ++i) {
    const int row = row0 + ty * L_TM + i;
    if (row >= B) continue;
#pragma unroll
    for (int u = 0; u < L_TU; ++u) {
      const int j = j0 + tx * L_TU + u;
      if (j >= H) continue;
      const float gi = acc[i][0][u] + bias[j];
      const float gf = acc[i][1][u] + bias[H + j];
      const float gg = acc[i][2][u] + bias[2 * H + j];
      const float go = acc[i][3][u] + bias[3 * H + j];
      const size_t o = (size_t)row * H + j;
      const float c_new = sigmoidf_(gf) * i2l::to_f(c[o]) + sigmoidf_(gi) * tanhf(gg);
      const float h_new = sigmoidf_(go) * tanhf(c_new);
      c[o] = i2l::from_f<T>(c_new);
      h_out[o] = i2l::from_f<T>(h_new);
    }
  }
}

// ---- vocab_argmax_step ----------------------------------------------------
constexpr int V_BM = 16;   // rows per block (one per thread row)
constexpr int V_BN = 128;  // columns per chunk
constexpr int V_BK = 16;
constexpr int V_TN = 8;    // columns per thread per chunk

template <typename T>
__global__ void __launch_bounds__(kThreads) vocab_argmax_step_kernel(
    const T* __restrict__ h, const T* __restrict__ w_out, const float* __restrict__ b_out,
    int* __restrict__ tokens, int* __restrict__ finished, int* __restrict__ out, int t, int T_len,
    int B, int H, int Vp, int end_id, int pad_id) {
  __shared__ float As[V_BK][V_BM + 1];
  __shared__ __align__(16) float Bs[V_BK][V_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * V_BM;
  const int row = row0 + ty;

  float best = -3.402823466e+38f;  // -FLT_MAX; padded columns carry -1e30
  int best_idx = 0;
  for (int n0 = 0; n0 < Vp; n0 += V_BN) {
    float acc[V_TN];
#pragma unroll
    for (int n = 0; n < V_TN; ++n) acc[n] = 0.f;
    for (int k0 = 0; k0 < H; k0 += V_BK) {
      {
        const int r = tid / V_BK, kk = tid % V_BK;
        const int rr = row0 + r, k = k0 + kk;
        As[kk][r] = (rr < B && k < H) ? i2l::to_f(h[(size_t)rr * H + k]) : 0.f;
      }
#pragma unroll
      for (int e = tid; e < V_BK * V_BN; e += kThreads) {
        const int kk = e / V_BN, n = e % V_BN;
        const int k = k0 + kk, col = n0 + n;
        Bs[kk][n] = (k < H && col < Vp) ? i2l::to_f(w_out[(size_t)k * Vp + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < V_BK; ++kk) {
        const float a = As[kk][ty];
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * V_TN]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * V_TN + 4]);
        acc[0] = fmaf(a, b0.x, acc[0]);
        acc[1] = fmaf(a, b0.y, acc[1]);
        acc[2] = fmaf(a, b0.z, acc[2]);
        acc[3] = fmaf(a, b0.w, acc[3]);
        acc[4] = fmaf(a, b1.x, acc[4]);
        acc[5] = fmaf(a, b1.y, acc[5]);
        acc[6] = fmaf(a, b1.z, acc[6]);
        acc[7] = fmaf(a, b1.w, acc[7]);
      }
      __syncthreads();
    }
    // Columns are visited in increasing order, so a strict > keeps the lowest index.
#pragma unroll
    for (int n = 0; n < V_TN; ++n) {
      const int col = n0 + tx * V_TN + n;
      if (col < Vp) {
        const float v = acc[n] + b_out[col];
        if (v > best) {
          best = v;
          best_idx = col;
        }
      }
    }
  }
  // The 16 threads of a row are one half of a warp: reduce (max, lowest index).
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_idx, off);
    if (ov > best || (ov == best && oi < best_idx)) {
      best = ov;
      best_idx = oi;
    }
  }
  if (tx == 0 && row < B) {
    int tok = best_idx;
    if (finished != nullptr) {
      int f = finished[row];
      tok = f ? pad_id : tok;
      finished[row] = (f || tok == end_id) ? 1 : 0;
    }
    tokens[row] = tok;
    if (out != nullptr) out[(size_t)row * T_len + t] = tok;
  }
}

template <typename T>
cudaError_t launch_lstm(const void* tokens, const void* emb, int E0, const void* x1, int E1,
                        const void* h_in, const void* w_ih, const void* w_hh, const void* b,
                        void* c, void* h_out, int B, int H, cudaStream_t stream) {
  dim3 grid((H + L_HU - 1) / L_HU, (B + L_BM - 1) / L_BM);
  lstm_layer_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const int*>(tokens), static_cast<const T*>(emb), E0, static_cast<const T*>(x1),
      E1, static_cast<const T*>(h_in), static_cast<const T*>(w_ih), static_cast<const T*>(w_hh),
      static_cast<const float*>(b), static_cast<T*>(c), static_cast<T*>(h_out), B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vocab(const void* h, const void* w_out, const void* b_out, void* tokens,
                         void* finished, void* out, int t, int T_len, int B, int H, int Vp,
                         int end_id, int pad_id, cudaStream_t stream) {
  dim3 grid((B + V_BM - 1) / V_BM);
  vocab_argmax_step_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<int*>(tokens), static_cast<int*>(finished), static_cast<int*>(out), t, T_len, B,
      H, Vp, end_id, pad_id);
  return cudaGetLastError();
}

}  // namespace

// One LSTM layer, one step.  tokens (B,) int32 and emb (Vp, E0) for layer 0,
// both null (E0 = 0) above it; x1 (B, E1); h_in, c, h_out (B, H); w_ih
// (E0 + E1, 4H); w_hh (H, 4H); b (4H,) float32.  c is updated in place;
// h_out must not alias h_in.
extern "C" int i2l_lstm_layer_step(const void* tokens, const void* emb, int E0, const void* x1,
                                   int E1, const void* h_in, const void* w_ih, const void* w_hh,
                                   const void* b, void* c, void* h_out, int B, int H, int dtype,
                                   void* stream) {
  if (B <= 0 || H <= 0 || E1 <= 0 || E0 < 0 || (E0 > 0 && (tokens == nullptr || emb == nullptr)) ||
      (B + L_BM - 1) / L_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch_lstm<float>(tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out, B, H, s);
  if (dtype == i2l::kBF16)
    return (int)launch_lstm<__nv_bfloat16>(tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out,
                                           B, H, s);
  return (int)cudaErrorInvalidValue;
}

// Vocab product, argmax and token store for one step.  h (B, H); w_out (H, Vp);
// b_out (Vp,) float32; tokens (B,) int32 receives the token; finished (B,)
// int32 or null (no END rule); out (B, T_len) int32 or null, column t.
extern "C" int i2l_vocab_argmax_step(const void* h, const void* w_out, const void* b_out,
                                     void* tokens, void* finished, void* out, int t, int T_len,
                                     int B, int H, int Vp, int end_id, int pad_id, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || Vp <= 0 || t < 0 || t >= T_len || tokens == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch_vocab<float>(h, w_out, b_out, tokens, finished, out, t, T_len, B, H, Vp,
                                    end_id, pad_id, s);
  if (dtype == i2l::kBF16)
    return (int)launch_vocab<__nv_bfloat16>(h, w_out, b_out, tokens, finished, out, t, T_len, B, H,
                                            Vp, end_id, pad_id, s);
  return (int)cudaErrorInvalidValue;
}
