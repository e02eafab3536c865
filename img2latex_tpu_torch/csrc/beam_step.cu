// One beam-search step after the top LSTM layer, for all K·B rows.
//
// Replaces the body of the TPU kernels' beam loop after the LSTM,
// img2latex_tpu/ops/pallas/beam_decode.py::_beam_loop (lines 173-249), which
// both img2latex_tpu/ops/pallas/beam_decode.py::pallas_full_beam_decode
// (pl.pallas_call at line 335) and
// img2latex_tpu/ops/pallas/grid_decode.py::pallas_full_grid_beam_decode
// (pl.pallas_call at line 561) run; their LSTM is greedy_decode.cu's
// lstm_layer_step and the grid kernel's attention grid_attend.cu's
// attend_step with rows_per_mem = K.
//
// Rows are sample-major: row b K + k is beam k of sample b.  Per row r of
// sample b, with h the top layer's new h:
//   logits  = h_r @ W_out + b_out              float32; never stored to device memory
//   logp    = logits - (log(sum exp(logits - m)) + m)   m the row max
//   logp    = finished[r] ? (0 at PAD, -1e30 elsewhere) : logp
//   total   = score[r] + logp
// then over the K·Vp totals of sample b, K passes of (max, mask the winner
// with -1e30): the lowest flat index k Vp + v wins ties, as in _beam_loop.
// Pass n gives new beam n: its token v, parent k and score.  Then
//   finished[b K + n] = finished[b K + k] | (v == END)
// tokens, scores and finished are updated, column t of the (T, K·B) token and
// parent histories written, and every layer's h and c carries gathered from
// the parent row (h_src -> h_dst, c_src -> c_dst): the TPU kernel's one-hot
// P @ h (beam_decode.py:231-243).
//
// Design.  A block owns G = 16 / K whole samples (G·K <= 16 rows), so that
// the selection, the in-place update of scores and finished, and the carry
// gather need no other block: the gather goes out of place, from the buffer
// the LSTM wrote to the one the next step reads.  With several samples a
// block, W_out (H x Vp, 393 KB in bf16 at H = 384) is read from L2 once per
// 16 rows and not once per sample (B = 512, K = 5: 171 blocks, 67 MB of L2
// reads a step, against 201 MB at one sample a block).  The block's h rows
// are staged in shared memory once; W_out streams through a 32 x 128 shared
// tile with the next tile's 16-byte loads in flight in registers while the
// current one is used.  Each thread computes one row x 8 columns of a
// 128-column chunk in float32 on the CUDA cores, and the block's logits
// (<= 16 x Vp float32, 32 KB at Vp = 512) stay in shared memory for the
// log-softmax (16 threads a row, shuffles) and the selection (one warp a
// sample, K passes over its K·Vp totals).
//
// Bound: per step the product is 2 K B H Vp FLOP (1.0 GFLOP at B = 512,
// K = 5, H = 384, Vp = 512), about 1 us at the bf16 tensor-core rate, and the
// bytes are the h rows, W_out once, the carries gathered (read and written)
// and the small per-row arrays: ~10 MB, ~3 us at 3.35 TB/s.  This first
// version multiplies on the CUDA cores in float32 (the float32 FMA rate,
// 67 TFLOP/s, puts the product at ~15 us).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;     // rows a block at most (G samples x K beams)
constexpr int kMaxBeam = 16;  // a block holds at least one whole sample (ops/beam_decode.py: MAX_BEAM)
constexpr int BN = 128;       // columns a chunk
constexpr int BK = 32;        // depth of a W_out tile
constexpr int TN = 8;         // columns a thread, a chunk
constexpr int HS = kRows + 1; // row stride of the staged h (k-major), padded against bank conflicts
constexpr float kNeg = -1e30f;
constexpr float kLowest = -3.402823466e+38f;

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
        for (int j = 0; j < TN; ++j) r[i][j] = i2l::to_f(v[j]);
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

// Copy `n` elements of T; 16 bytes at a time where `vec` (both rows
// 16-byte aligned and n * sizeof(T) a multiple of 16).
template <typename T>
__device__ __forceinline__ void copy_row(T* __restrict__ dst, const T* __restrict__ src, int n,
                                         bool vec, int lane, int nlanes) {
  if (vec) {
    const int n16 = n * (int)sizeof(T) / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = lane; i < n16; i += nlanes) d[i] = s[i];
  } else {
    for (int i = lane; i < n; i += nlanes) dst[i] = src[i];
  }
}

// Dynamic shared memory (float32 unless named): hs[Hp][HS] the block's h
// rows k-major, ws[BK][BN] the W_out tile, tot[kRows][Vp] the logits and
// then the totals, and kRows each of old score, old finished (int), and
// the selection's value, token (int), parent (int) and source row (int).
template <typename T>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(
    const T* __restrict__ h, const T* __restrict__ w_out, const float* __restrict__ b_out,
    float* __restrict__ scores, int* __restrict__ finished, int* __restrict__ tokens,
    int* __restrict__ tok_hist, int* __restrict__ par_hist, const T* __restrict__ h_src,
    T* __restrict__ h_dst, const T* __restrict__ c_src, T* __restrict__ c_dst, int L, int B,
    int K, int G, int H, int Vp, int t, int end_id, int pad_id, bool vec_copy) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = (H + BK - 1) / BK * BK;
  float* hs = smem;
  float* ws = hs + Hp * HS + (4 - (Hp * HS) % 4) % 4;  // 16-byte aligned
  float* tot = ws + BK * BN;
  float* sc_old = tot + kRows * Vp;
  int* fin_old = reinterpret_cast<int*>(sc_old + kRows);
  float* sel_val = reinterpret_cast<float*>(fin_old + kRows);
  int* sel_tok = reinterpret_cast<int*>(sel_val + kRows);
  int* sel_par = sel_tok + kRows;
  int* src_row = sel_par + kRows;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int N = B * K;
  const int s0 = blockIdx.x * G;
  const int ns = min(G, B - s0);  // samples of this block
  const int R = ns * K;           // rows of this block
  const int row0 = s0 * K;

  // ---- stage h (k-major, zero past H and past R), old scores and finished
  for (int e = tid; e < kRows * Hp; e += kThreads) {
    const int r = e / Hp, k = e % Hp;
    hs[k * HS + r] = (r < R && k < H) ? i2l::to_f(h[(size_t)(row0 + r) * H + k]) : 0.f;
  }
  if (tid < R) {
    sc_old[tid] = scores[row0 + tid];
    fin_old[tid] = finished[row0 + tid];
  }

  // ---- logits = h @ W_out + b_out into tot ---------------------------------
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
          tot[ty * Vp + col] = acc[j] + b_out[col];
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[j] = 0.f;
    }
    __syncthreads();
    if (i + 1 < ntiles) store_tile(ws, nxt);
    __syncthreads();
  }

  // ---- log-softmax, END absorption, total = score + logp (16 threads a row)
  {
    const bool on = ty < R;
    float* row = tot + (on ? ty : 0) * Vp;
    float m = kLowest;
    for (int col = tx; col < Vp; col += 16) m = fmaxf(m, on ? row[col] : 0.f);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float z = 0.f;
    for (int col = tx; col < Vp; col += 16) z += on ? expf(row[col] - m) : 0.f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
    if (on) {
      const float lse = logf(z) + m;
      const float s = sc_old[ty];
      const bool fin = fin_old[ty] != 0;
      for (int col = tx; col < Vp; col += 16) {
        const float logp = fin ? (col == pad_id ? 0.f : kNeg) : row[col] - lse;
        row[col] = s + logp;
      }
    }
  }
  __syncthreads();

  // ---- per sample, K passes of (max, lowest flat index; mask with -1e30) --
  for (int g = warp; g < ns; g += kThreads / 32) {
    float* cand = tot + g * K * Vp;
    const int n_cand = K * Vp;
    for (int n = 0; n < K; ++n) {
      float best = kLowest;
      int idx = 0;
      for (int i = lane; i < n_cand; i += 32) {
        const float v = cand[i];
        if (v > best) {  // i ascends: a strict > keeps the lane's lowest index
          best = v;
          idx = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ob > best || (ob == best && oi < idx)) {
          best = ob;
          idx = oi;
        }
      }
      if (lane == 0) {
        sel_val[g * K + n] = best;
        sel_tok[g * K + n] = idx % Vp;
        sel_par[g * K + n] = idx / Vp;
        cand[idx] = kNeg;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- new beams: token, parent, score, finished, history ------------------
  if (tid < R) {
    const int g = tid / K;
    const int par = sel_par[tid], tok = sel_tok[tid];
    const int row = row0 + tid;
    src_row[tid] = row0 + g * K + par;
    scores[row] = sel_val[tid];
    finished[row] = (fin_old[g * K + par] != 0 || tok == end_id) ? 1 : 0;
    tokens[row] = tok;
    tok_hist[(size_t)t * N + row] = tok;
    par_hist[(size_t)t * N + row] = par;
  }
  __syncthreads();

  // ---- carries of every layer from the parent row: one warp a (layer, row) -
  const size_t layer = (size_t)N * H;
  for (int w = warp; w < 2 * L * R; w += kThreads / 32) {
    const int which = w / (L * R), l = (w / R) % L, r = w % R;
    const size_t src = l * layer + (size_t)src_row[r] * H, dst = l * layer + (size_t)(row0 + r) * H;
    if (which == 0)
      copy_row(h_dst + dst, h_src + src, H, vec_copy, lane, 32);
    else
      copy_row(c_dst + dst, c_src + src, H, vec_copy, lane, 32);
  }
}

size_t smem_bytes(int H, int Vp) {
  const size_t Hp = (H + BK - 1) / BK * BK;
  return sizeof(float) * (Hp * HS + 4 + BK * BN + (size_t)kRows * Vp + 6 * kRows);
}

template <typename T>
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* scores, void* finished,
                   void* tokens, void* tok_hist, void* par_hist, const void* h_src, void* h_dst,
                   const void* c_src, void* c_dst, int L, int B, int K, int H, int Vp, int t,
                   int end_id, int pad_id, cudaStream_t stream) {
  const int G = kRows / K;
  const size_t smem = smem_bytes(H, Vp);
  auto kernel = beam_step_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = (size_t)H * sizeof(T) % 16 == 0 && aligned(h_src) && aligned(h_dst) &&
                   aligned(c_src) && aligned(c_dst);
  kernel<<<(B + G - 1) / G, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<float*>(scores), static_cast<int*>(finished), static_cast<int*>(tokens),
      static_cast<int*>(tok_hist), static_cast<int*>(par_hist), static_cast<const T*>(h_src),
      static_cast<T*>(h_dst), static_cast<const T*>(c_src), static_cast<T*>(c_dst), L, B, K, G, H,
      Vp, t, end_id, pad_id, vec);
  return cudaGetLastError();
}

}  // namespace

// One beam step for B samples of K beams (N = B K rows, sample-major).
// h (N, H) the top layer's new h; w_out (H, Vp) with Vp a multiple of 128,
// 16-byte aligned; b_out (Vp,) float32; scores (N,) float32 and finished
// (N,) int32, updated in place; tokens (N,) int32 receives the new tokens;
// tok_hist and par_hist (T, N) int32 receive column t; h_src, c_src (L, N, H)
// the carries the LSTM left, h_dst, c_dst (L, N, H) receive them reindexed
// by parent (no aliasing).  All floating operands but b_out and scores in
// the compute type (dtype 0 float32, 1 bfloat16).
extern "C" int i2l_beam_step(const void* h, const void* w_out, const void* b_out, void* scores,
                             void* finished, void* tokens, void* tok_hist, void* par_hist,
                             const void* h_src, void* h_dst, const void* c_src, void* c_dst, int L,
                             int B, int K, int H, int Vp, int t, int end_id, int pad_id, int dtype,
                             void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxBeam || H <= 0 || L <= 0 || Vp <= 0 || Vp % BN != 0 || t < 0 ||
      pad_id < 0 || pad_id >= Vp || reinterpret_cast<uintptr_t>(w_out) % 16 != 0 ||
      smem_bytes(H, Vp) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch<float>(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, h_src,
                              h_dst, c_src, c_dst, L, B, K, H, Vp, t, end_id, pad_id, s);
  if (dtype == i2l::kBF16)
    return (int)launch<__nv_bfloat16>(h, w_out, b_out, scores, finished, tokens, tok_hist,
                                      par_hist, h_src, h_dst, c_src, c_dst, L, B, K, H, Vp, t,
                                      end_id, pad_id, s);
  return (int)cudaErrorInvalidValue;
}
