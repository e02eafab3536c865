// One LSTM layer's recurrence over a whole sequence, for training: forward and backward.
//
// Replaces the TPU kernels of img2latex_tpu/ops/pallas/lstm_train.py::lstm_seq_pallas:
// the forward (pl.pallas_call at line 103, _fwd_kernel :63) and the backward
// (pl.pallas_call at line 205, _bwd_kernel :131), tied together by the custom
// VJP _make_lstm_seq (:244).  The input projection x @ W_ih + b_ih + b_hh of
// all steps stays outside (one large product, as in the JAX package); these
// kernels run the recurrence only, with the TPU kernels' rounding points:
//
//   forward   g = h @ W_hh + gx_t with float32 sums, the gates in float32;
//             ys, cs and the activated gates ga are stored in the compute
//             type, and the next step reads its h and c back from ys and cs,
//             so the carries are rounded to the compute type between steps
//             as the TPU kernel's h_scr / c_scr are.
//   backward  the gate gradients are rebuilt from ga, cs and c_prev in
//             float32; dpre is stored in the compute type as dgates_x; the
//             next (earlier) step's dh = dpre @ W_hh^T is summed in float32
//             from that rounded dpre; dh and dc are carried in float32;
//             dW_hh = sum over steps and rows of h_prev^T dpre, in float32,
//             cast to W_hh's type at the end.
//
// These are the per-step kernels: float32 (the exactness oracle) runs them,
// and so does bf16 where a block's slice of W_hh does not fit in shared
// memory (ops/lstm_train.py::seq_plan); other bf16 widths run the
// cluster-persistent kernels of lstm_seq_tc.cu, and every bf16 dW_hh its
// tensor-core kernel.  The TPU kernel keeps W_hh (2 MB in bf16 at H = 512) in
// VMEM and walks the T steps inside one program per batch tile.  Here W_hh
// stays in the 50 MB L2, as in greedy_decode.cu's lstm_layer_step, and each
// step is one launch from a host loop, tiled over rows x hidden units with
// float32 CUDA-core products:
//
//   lstm_seq_fwd_step   a block takes 16*TM rows x 32 hidden units, i.e. the
//                       128 gate columns {g H + j} of those units, so each
//                       thread ends with all four gates of its TM rows x 2
//                       units and applies the cell update.  T launches.
//   lstm_seq_bwd_step   step t: a block takes 16*TM rows x 32 units of
//                       dh = dgates_x[t+1] @ W_hh^T (depth 4H; nothing at the
//                       last step), then the gate gradients of those units,
//                       writing dgates_x[t] and the dc carry in place.  T
//                       launches, plus one that writes dh0 and dc0.
//   lstm_seq_dw         float32 only: dW_hh = dgates_x^T @ [h0; ys[:-1]] over
//                       all T*B rows at once (64x64 output tiles; the rows
//                       split into a few chunks, each leaving a float32
//                       partial), then one launch that sums the partials.
//
// Bound (H100 SXM, bf16, T = 140, B = 128, H = 512, one layer): the forward
// moves ~186 MB (gx read, ys, cs, ga written; 0.055 ms) for 37.6 GFLOP
// (0.038 ms on the tensor cores); the backward 75 GFLOP (0.076 ms) and ~222
// MB.  The recurrence is serial over T, so neither bound is reachable; these
// kernels multiply on the CUDA cores in float32, and their limit is the
// per-step launch and the float32 FMA rate.
#include <algorithm>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int S_HU = 32;  // hidden units per block (16 threads x S_TU)
constexpr int S_TU = 2;   // hidden units per thread
constexpr int F_BK = 32;  // depth of one shared-memory tile: forward (depth H)
constexpr int B_BK = 64;  // and backward (depth 4H)

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// ---- forward, one step -----------------------------------------------------
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads) lstm_seq_fwd_kernel(
    const T* __restrict__ gx, const T* __restrict__ h_prev, const T* __restrict__ c_prev,
    const T* __restrict__ w_t, T* __restrict__ ys, T* __restrict__ cs, T* __restrict__ ga,
    int B, int H) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 4 * S_HU;
  __shared__ float As[F_BK][BM + 1];
  __shared__ __align__(16) float Bs[F_BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * S_HU;
  const int G = 4 * H;

  float acc[TM][4][S_TU];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int u = 0; u < S_TU; ++u) acc[i][g][u] = 0.f;

  // The next tile's loads are issued into registers before the current tile
  // is multiplied, so an L2 round trip overlaps the FMAs; the loops have
  // static trip counts, so every load of a tile is in flight at once.
  constexpr int NA = BM * F_BK / kThreads, NB = F_BK * BN / kThreads;
  static_assert((BM * F_BK) % kThreads == 0 && (F_BK * BN) % kThreads == 0, "whole tiles");
  float ra[NA], rb[NB];
  auto load = [&](int k0) {
#pragma unroll
    for (int it = 0; it < NA; ++it) {
      const int e = tid + it * kThreads;
      const int row = row0 + e / F_BK, k = k0 + e % F_BK;
      ra[it] = (row < B && k < H) ? i2l::to_f(h_prev[(size_t)row * H + k]) : 0.f;
    }
    // column n of the tile is gate n / 32 of unit j0 + n % 32; w_t is (H, 4H)
#pragma unroll
    for (int it = 0; it < NB; ++it) {
      const int e = tid + it * kThreads;
      const int n = e % BN, k = k0 + e / BN;
      const int g = n / S_HU, j = j0 + n % S_HU;
      rb[it] = (k < H && j < H) ? i2l::to_f(w_t[(size_t)k * G + g * H + j]) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < H; k0 += F_BK) {
#pragma unroll
    for (int it = 0; it < NA; ++it) {
      const int e = tid + it * kThreads;
      As[e % F_BK][e / F_BK] = ra[it];
    }
#pragma unroll
    for (int it = 0; it < NB; ++it) {
      const int e = tid + it * kThreads;
      Bs[e / BN][e % BN] = rb[it];
    }
    __syncthreads();
    if (k0 + F_BK < H) load(k0 + F_BK);
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 b2 = *reinterpret_cast<const float2*>(&Bs[kk][g * S_HU + tx * S_TU]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][g][0] = fmaf(a[i], b2.x, acc[i][g][0]);
          acc[i][g][1] = fmaf(a[i], b2.y, acc[i][g][1]);
        }
      }
    }
    __syncthreads();
  }

  // Cell update, gate order (i, f, g, o).
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= B) continue;
#pragma unroll
    for (int u = 0; u < S_TU; ++u) {
      const int j = j0 + tx * S_TU + u;
      if (j >= H) continue;
      const size_t gr = (size_t)row * G;
      const float gi = sigmoidf_(acc[i][0][u] + i2l::to_f(gx[gr + j]));
      const float gf = sigmoidf_(acc[i][1][u] + i2l::to_f(gx[gr + H + j]));
      const float gg = tanhf(acc[i][2][u] + i2l::to_f(gx[gr + 2 * H + j]));
      const float go = sigmoidf_(acc[i][3][u] + i2l::to_f(gx[gr + 3 * H + j]));
      const size_t o = (size_t)row * H + j;
      const float c2 = gf * i2l::to_f(c_prev[o]) + gi * gg;
      const float h2 = go * tanhf(c2);
      ys[o] = i2l::from_f<T>(h2);
      cs[o] = i2l::from_f<T>(c2);
      ga[gr + j] = i2l::from_f<T>(gi);
      ga[gr + H + j] = i2l::from_f<T>(gf);
      ga[gr + 2 * H + j] = i2l::from_f<T>(gg);
      ga[gr + 3 * H + j] = i2l::from_f<T>(go);
    }
  }
}

// ---- backward, one step (or the final dh0 / dc0) ---------------------------
// dh = dgx_next @ W_hh^T for this block's rows x units (w is W_hh in torch's
// (4H, H) layout, so the product reads it row-major); dgx_next null: dh = 0.
// With dy null the launch is the last one: dh0 = dh, dc0 = dc.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads) lstm_seq_bwd_kernel(
    const T* __restrict__ dgx_next, const T* __restrict__ w, const T* __restrict__ dy,
    const T* __restrict__ ga, const T* __restrict__ cs, const T* __restrict__ c_prev,
    float* __restrict__ dc, T* __restrict__ dgx, T* __restrict__ dh0, T* __restrict__ dc0,
    int B, int H) {
  constexpr int BM = 16 * TM;
  __shared__ float As[B_BK][BM + 1];
  __shared__ __align__(16) float Bs[B_BK][S_HU];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * S_HU;
  const int G = 4 * H;

  float acc[TM][S_TU];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < S_TU; ++u) acc[i][u] = 0.f;

  if (dgx_next != nullptr) {  // register-prefetched tiles, as in the forward
    constexpr int NA = BM * B_BK / kThreads, NB = B_BK * S_HU / kThreads;
    static_assert((BM * B_BK) % kThreads == 0 && (B_BK * S_HU) % kThreads == 0, "whole tiles");
    float ra[NA], rb[NB];
    auto load = [&](int k0) {
#pragma unroll
      for (int it = 0; it < NA; ++it) {
        const int e = tid + it * kThreads;
        const int row = row0 + e / B_BK, k = k0 + e % B_BK;
        ra[it] = (row < B && k < G) ? i2l::to_f(dgx_next[(size_t)row * G + k]) : 0.f;
      }
#pragma unroll
      for (int it = 0; it < NB; ++it) {
        const int e = tid + it * kThreads;
        const int j = j0 + e % S_HU, k = k0 + e / S_HU;
        rb[it] = (k < G && j < H) ? i2l::to_f(w[(size_t)k * H + j]) : 0.f;
      }
    };
    load(0);
    for (int k0 = 0; k0 < G; k0 += B_BK) {
#pragma unroll
      for (int it = 0; it < NA; ++it) {
        const int e = tid + it * kThreads;
        As[e % B_BK][e / B_BK] = ra[it];
      }
#pragma unroll
      for (int it = 0; it < NB; ++it) {
        const int e = tid + it * kThreads;
        Bs[e / S_HU][e % S_HU] = rb[it];
      }
      __syncthreads();
      if (k0 + B_BK < G) load(k0 + B_BK);
#pragma unroll
      for (int kk = 0; kk < B_BK; ++kk) {
        const float2 b2 = *reinterpret_cast<const float2*>(&Bs[kk][tx * S_TU]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = As[kk][ty * TM + i];
          acc[i][0] = fmaf(a, b2.x, acc[i][0]);
          acc[i][1] = fmaf(a, b2.y, acc[i][1]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= B) continue;
#pragma unroll
    for (int u = 0; u < S_TU; ++u) {
      const int j = j0 + tx * S_TU + u;
      if (j >= H) continue;
      const size_t o = (size_t)row * H + j;
      if (dy == nullptr) {
        dh0[o] = i2l::from_f<T>(acc[i][u]);
        dc0[o] = i2l::from_f<T>(dc[o]);
        continue;
      }
      const size_t gr = (size_t)row * G;
      const float gi = i2l::to_f(ga[gr + j]);
      const float gf = i2l::to_f(ga[gr + H + j]);
      const float gg = i2l::to_f(ga[gr + 2 * H + j]);
      const float go = i2l::to_f(ga[gr + 3 * H + j]);
      const float tc = tanhf(i2l::to_f(cs[o]));
      const float dh = i2l::to_f(dy[o]) + acc[i][u];
      const float d_o = dh * tc;
      const float dcv = dc[o] + dh * go * (1.f - tc * tc);
      const float di = dcv * gg;
      const float dg = dcv * gi;
      const float df = dcv * i2l::to_f(c_prev[o]);
      dc[o] = dcv * gf;
      dgx[gr + j] = i2l::from_f<T>(di * gi * (1.f - gi));
      dgx[gr + H + j] = i2l::from_f<T>(df * gf * (1.f - gf));
      dgx[gr + 2 * H + j] = i2l::from_f<T>(dg * (1.f - gg * gg));
      dgx[gr + 3 * H + j] = i2l::from_f<T>(d_o * go * (1.f - go));
    }
  }
}

// ---- dW_hh = dgates_x^T @ h_prev over all T*B rows --------------------------
constexpr int W_TILE = 64;  // output tile: 64 gate columns x 64 hidden units
constexpr int W_BM = 16;    // rows (time x batch) per shared-memory tile

// Row m of h_prev is h0[m] for m < B, else ys[m - B] (ys is (T, B, H)).
template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_seq_dw_kernel(
    const T* __restrict__ dgx, const T* __restrict__ h0, const T* __restrict__ ys,
    float* __restrict__ partial, int M, int B, int H, int m_per_split) {
  __shared__ __align__(16) float As[W_BM][W_TILE];  // dgx rows x gate columns
  __shared__ __align__(16) float Bs[W_BM][W_TILE];  // h_prev rows x hidden units
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * W_TILE;  // hidden units
  const int n0 = blockIdx.y * W_TILE;  // gate columns
  const int G = 4 * H;
  const int m_begin = blockIdx.z * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += W_BM) {
    static_assert((W_BM * W_TILE) % kThreads == 0, "whole tiles");
#pragma unroll
    for (int it = 0; it < W_BM * W_TILE / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int mm = e / W_TILE, col = e % W_TILE;
      const int m = m0 + mm;
      const bool in = m < m_end;
      const int n = n0 + col, k = k0 + col;
      As[mm][col] = (in && n < G) ? i2l::to_f(dgx[(size_t)m * G + n]) : 0.f;
      float hv = 0.f;
      if (in && k < H) hv = i2l::to_f(m < B ? h0[(size_t)m * H + k] : ys[(size_t)(m - B) * H + k]);
      Bs[mm][col] = hv;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < W_BM; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[mm][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[mm][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)blockIdx.z * G * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= G) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < H) out[(size_t)n * H + k] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lstm_seq_dw_reduce_kernel(
    const float* __restrict__ partial, int nsplit, long long n_elem, T* __restrict__ dw) {
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < n_elem;
       idx += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += partial[p * n_elem + idx];
    dw[idx] = i2l::from_f<T>(s);
  }
}

// Rows per thread: the largest of 4, 2, 1 that still gives one block per SM
// (132 on an H100), else 1.
int pick_tm(int B, int H) {
  const int units = (H + S_HU - 1) / S_HU;
  for (int tm : {4, 2}) {
    if ((long long)units * ((B + 16 * tm - 1) / (16 * tm)) >= 132) return tm;
  }
  return 1;
}

template <typename T, int TM>
cudaError_t launch_fwd(const void* gx, const void* h_prev, const void* c_prev, const void* w_t,
                       void* ys, void* cs, void* ga, int B, int H, cudaStream_t s) {
  dim3 grid((H + S_HU - 1) / S_HU, (B + 16 * TM - 1) / (16 * TM));
  lstm_seq_fwd_kernel<T, TM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(gx), static_cast<const T*>(h_prev), static_cast<const T*>(c_prev),
      static_cast<const T*>(w_t), static_cast<T*>(ys), static_cast<T*>(cs), static_cast<T*>(ga),
      B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dispatch(const void* gx, const void* h_prev, const void* c_prev, const void* w_t,
                         void* ys, void* cs, void* ga, int B, int H, cudaStream_t s) {
  switch (pick_tm(B, H)) {
    case 4: return launch_fwd<T, 4>(gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, s);
    case 2: return launch_fwd<T, 2>(gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, s);
    default: return launch_fwd<T, 1>(gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, s);
  }
}

template <typename T, int TM>
cudaError_t launch_bwd(const void* dgx_next, const void* w, const void* dy, const void* ga,
                       const void* cs, const void* c_prev, void* dc, void* dgx, void* dh0,
                       void* dc0, int B, int H, cudaStream_t s) {
  dim3 grid((H + S_HU - 1) / S_HU, (B + 16 * TM - 1) / (16 * TM));
  lstm_seq_bwd_kernel<T, TM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dgx_next), static_cast<const T*>(w), static_cast<const T*>(dy),
      static_cast<const T*>(ga), static_cast<const T*>(cs), static_cast<const T*>(c_prev),
      static_cast<float*>(dc), static_cast<T*>(dgx), static_cast<T*>(dh0), static_cast<T*>(dc0),
      B, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dispatch(const void* dgx_next, const void* w, const void* dy, const void* ga,
                         const void* cs, const void* c_prev, void* dc, void* dgx, void* dh0,
                         void* dc0, int B, int H, cudaStream_t s) {
  switch (pick_tm(B, H)) {
    case 4: return launch_bwd<T, 4>(dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0, B, H, s);
    case 2: return launch_bwd<T, 2>(dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0, B, H, s);
    default: return launch_bwd<T, 1>(dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0, B, H, s);
  }
}

template <typename T>
cudaError_t dw_dispatch(const void* dgx, const void* h0, const void* ys, void* partial, void* dw,
                        int M, int B, int H, int nsplit, cudaStream_t s) {
  const int G = 4 * H;
  int m_per_split = (M + nsplit - 1) / nsplit;
  m_per_split = (m_per_split + W_BM - 1) / W_BM * W_BM;
  dim3 grid((H + W_TILE - 1) / W_TILE, (G + W_TILE - 1) / W_TILE, nsplit);
  lstm_seq_dw_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(dgx), static_cast<const T*>(h0), static_cast<const T*>(ys),
      static_cast<float*>(partial), M, B, H, m_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_elem = (long long)G * H;
  const int blocks = (int)std::min<long long>((n_elem + kThreads - 1) / kThreads, 4096);
  lstm_seq_dw_reduce_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(partial), nsplit, n_elem, static_cast<T*>(dw));
  return cudaGetLastError();
}

bool bad_rows(int B, int H) {
  const int tm = pick_tm(B, H);
  return B <= 0 || H <= 0 || (B + 16 * tm - 1) / (16 * tm) > 65535;
}

}  // namespace

// Forward step t.  gx (B, 4H) = gates_x[t]; h_prev, c_prev (B, H): h0 / c0 at
// t = 0, else ys[t-1] / cs[t-1]; w_t (H, 4H) = W_hh^T; ys, cs (B, H) and ga
// (B, 4H) receive step t.  All in the compute type.
extern "C" int i2l_lstm_seq_fwd_step(const void* gx, const void* h_prev, const void* c_prev,
                                     const void* w_t, void* ys, void* cs, void* ga, int B, int H,
                                     int dtype, void* stream) {
  if (bad_rows(B, H)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32) return (int)fwd_dispatch<float>(gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, s);
  if (dtype == i2l::kBF16)
    return (int)fwd_dispatch<__nv_bfloat16>(gx, h_prev, c_prev, w_t, ys, cs, ga, B, H, s);
  return (int)cudaErrorInvalidValue;
}

// Backward step t: dgx_next (B, 4H) = dgates_x[t+1], null at t = T-1; w (4H, H)
// = W_hh; dy (B, H) the cotangent of ys[t] (with dhT added at t = T-1); ga,
// cs (step t) and c_prev (c0 or cs[t-1]); dc (B, H) float32 carry, in place;
// dgx (B, 4H) receives dgates_x[t].  With dy null this is the final launch:
// dgx_next = dgates_x[0], and dh0, dc0 (B, H) receive dh and dc.
extern "C" int i2l_lstm_seq_bwd_step(const void* dgx_next, const void* w, const void* dy,
                                     const void* ga, const void* cs, const void* c_prev, void* dc,
                                     void* dgx, void* dh0, void* dc0, int B, int H, int dtype,
                                     void* stream) {
  if (bad_rows(B, H) || w == nullptr || dc == nullptr ||
      (dy != nullptr && (ga == nullptr || cs == nullptr || c_prev == nullptr || dgx == nullptr)) ||
      (dy == nullptr && (dgx_next == nullptr || dh0 == nullptr || dc0 == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)bwd_dispatch<float>(dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0, B, H, s);
  if (dtype == i2l::kBF16)
    return (int)bwd_dispatch<__nv_bfloat16>(dgx_next, w, dy, ga, cs, c_prev, dc, dgx, dh0, dc0,
                                            B, H, s);
  return (int)cudaErrorInvalidValue;
}

// float32 dW_hh (4H, H) = sum over the M = T*B rows of dgates_x[m]^T
// h_prev[m].  dgx (T, B, 4H); h0 (B, H); ys (T, B, H); partial: nsplit * 4H *
// H floats of device scratch.  Two launches.  bf16 takes lstm_seq_tc.cu's
// i2l_lstm_seq_dw_tc.
extern "C" int i2l_lstm_seq_dw(const void* dgx, const void* h0, const void* ys, void* partial,
                               void* dw, int M, int B, int H, int nsplit, void* stream) {
  if (M <= 0 || B <= 0 || H <= 0 || M % B != 0 || nsplit <= 0 || nsplit > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dw_dispatch<float>(dgx, h0, ys, partial, dw, M, B, H, nsplit,
                                 static_cast<cudaStream_t>(stream));
}
