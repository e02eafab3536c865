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
//   logits  = h_r @ W_out + b_out              float32, kept in shared memory (below)
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
// Two kernels compute it, by route (ops/beam_decode.py::beam_plan names it):
//   block: beam_step_kernel below, on the CUDA cores; float32 (the exactness
//     oracle) and bf16 beams wider than 32;
//   cluster_tc: beam_step_tc.cu's bf16 kernel, row tiles of whole samples with
//     the product on the tensor cores and its columns split over a cluster.
//
// The block kernel.  A block owns G = 16 / K whole samples (G·K <= 16 rows)
// when K <= 16, and one sample when K > 16, so that the selection, the
// in-place update of scores and finished, and the carry gather need no other
// block: the gather goes out of place, from the buffer the LSTM wrote to the
// one the next step reads.  The product is block_logits.cuh's float32 one on
// the CUDA cores, 16 rows at a time (a sample of K > 16 beams takes
// ceil(K / 16) of them), and the block's logits (G·K x Vp float32, 32 KB at
// 16 rows and Vp = 512) stay in shared memory for the log-softmax (16
// threads a row, shuffles) and the selection (one warp a sample, K passes
// over its K·Vp totals; for K > 16 the whole block, each pass a block-wide
// reduction).  Where they do not fit the 227 KB of shared memory beside the
// staged h and W_out tile (K·Vp·4 bytes plus 24 a row), they and the per-row
// arrays go to a device-memory scratch the wrapper allocates (beam_plan's
// scratch_floats), so no beam width is refused below what device memory
// holds.
//
// Bound: per step the product is 2 K B H Vp FLOP (1.0 GFLOP at B = 512,
// K = 5, H = 384, Vp = 512), about 1 us at the bf16 tensor-core rate, and the
// bytes are the h rows, W_out once, the carries gathered (read and written)
// and the small per-row arrays: ~18 MB, ~5 us at 3.35 TB/s.
#include <cstdint>

#include "block_logits.cuh"

namespace i2l {
namespace beam_tc {
int launch_shape(int B, int K, int Vp, int (&dims)[4]);
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* scores, void* finished, void* tokens,
                   void* tok_hist, void* par_hist, const void* h_src, void* h_dst, const void* c_src, void* c_dst,
                   int L, int B, int K, int H, int Vp, int t, int end_id, int pad_id, cudaStream_t stream);
}  // namespace beam_tc
}  // namespace i2l

namespace {

using i2l::logits::kRows;  // rows a product call (G samples x K beams when K <= 16)
constexpr int kThreads = i2l::logits::kThreads;
constexpr float kNeg = -1e30f;
constexpr float kLowest = -3.402823466e+38f;
constexpr size_t kMaxSmem = 226 * 1024;  // of the 227 KB a block may opt in to, 1 KB left for static shared memory

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

// Rows a block: G whole samples of K beams.
__host__ __device__ inline int block_rows(int K) { return K <= kRows ? kRows / K * K : K; }

// The per-block work area (float32 unless named): tot[RB][Vp] the logits
// and then the totals, and RB each of old score, old finished (int), and the
// selection's value, token (int), parent (int) and source row (int).
inline size_t work_floats(int K, int Vp) { return (size_t)block_rows(K) * (Vp + 6); }

// Dynamic shared memory: the staging of block_logits, then the work area
// when `work` is null (else the work area of block b is work + b *
// work_floats).
template <typename T>
__global__ void __launch_bounds__(kThreads) beam_step_kernel(
    const T* __restrict__ h, const T* __restrict__ w_out, const float* __restrict__ b_out,
    float* __restrict__ scores, int* __restrict__ finished, int* __restrict__ tokens,
    int* __restrict__ tok_hist, int* __restrict__ par_hist, const T* __restrict__ h_src,
    T* __restrict__ h_dst, const T* __restrict__ c_src, T* __restrict__ c_dst, float* work, int L,
    int B, int K, int G, int H, int Vp, int t, int end_id, int pad_id, bool vec_copy) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_val[kThreads / 32];
  __shared__ int red_idx[kThreads / 32];
  const int RB = G * K;
  float* tot = work == nullptr ? smem + i2l::logits::staged_floats(H)
                               : work + (size_t)blockIdx.x * RB * (Vp + 6);
  float* sc_old = tot + (size_t)RB * Vp;
  int* fin_old = reinterpret_cast<int*>(sc_old + RB);
  float* sel_val = reinterpret_cast<float*>(fin_old + RB);
  int* sel_tok = reinterpret_cast<int*>(sel_val + RB);
  int* sel_par = sel_tok + RB;
  int* src_row = sel_par + RB;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int N = B * K;
  const int s0 = blockIdx.x * G;
  const int ns = min(G, B - s0);  // samples of this block
  const int R = ns * K;           // rows of this block
  const int row0 = s0 * K;

  // ---- old scores and finished; logits = h @ W_out + b_out, 16 rows a call
  for (int r = tid; r < R; r += kThreads) {
    sc_old[r] = scores[row0 + r];
    fin_old[r] = finished[row0 + r];
  }
  for (int g0 = 0; g0 < R; g0 += kRows)
    i2l::logits::block_logits(h, w_out, b_out, H, Vp, row0 + g0, min(kRows, R - g0), smem,
                              tot + (size_t)g0 * Vp);

  // ---- log-softmax, END absorption, total = score + logp (16 threads a row)
  for (int r0 = 0; r0 < R; r0 += kRows) {
    const int r = r0 + ty;
    const bool on = r < R;
    float* row = tot + (size_t)(on ? r : 0) * Vp;
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
      const float s = sc_old[r];
      const bool fin = fin_old[r] != 0;
      for (int col = tx; col < Vp; col += 16) {
        const float logp = fin ? (col == pad_id ? 0.f : kNeg) : row[col] - lse;
        row[col] = s + logp;
      }
    }
  }
  __syncthreads();

  // ---- per sample, K passes of (max, lowest flat index; mask with -1e30) --
  if (K <= kRows) {  // a warp a sample
    for (int g = warp; g < ns; g += kThreads / 32) {
      float* cand = tot + (size_t)g * K * Vp;
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
  } else {  // one sample: the whole block, a block-wide reduction a pass
    const int n_cand = K * Vp;
    for (int n = 0; n < K; ++n) {
      float best = kLowest;
      int idx = n_cand;
      for (int i = tid; i < n_cand; i += kThreads) {
        const float v = tot[i];
        if (v > best) {  // i ascends: a strict > keeps the thread's lowest index
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
        red_val[warp] = best;
        red_idx[warp] = idx;
      }
      __syncthreads();
      if (tid == 0) {
        for (int w = 1; w < kThreads / 32; ++w) {
          if (red_val[w] > best || (red_val[w] == best && red_idx[w] < idx)) {
            best = red_val[w];
            idx = red_idx[w];
          }
        }
        sel_val[n] = best;
        sel_tok[n] = idx % Vp;
        sel_par[n] = idx / Vp;
        tot[idx] = kNeg;
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // ---- new beams: token, parent, score, finished, history ------------------
  for (int r = tid; r < R; r += kThreads) {
    const int g = r / K;
    const int par = sel_par[r], tok = sel_tok[r];
    const int row = row0 + r;
    src_row[r] = row0 + g * K + par;
    scores[row] = sel_val[r];
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

// Shared memory of a block: the staging, and the work area where it fits.
size_t smem_bytes(int K, int H, int Vp, bool work_in_shared) {
  return sizeof(float) * ((size_t)i2l::logits::staged_floats(H) + (work_in_shared ? work_floats(K, Vp) : 0));
}

bool work_fits(int K, int H, int Vp) { return smem_bytes(K, H, Vp, true) <= kMaxSmem; }

int n_blocks(int B, int K) {
  const int G = block_rows(K) / K;
  return (B + G - 1) / G;
}

template <typename T>
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* scores, void* finished,
                   void* tokens, void* tok_hist, void* par_hist, const void* h_src, void* h_dst,
                   const void* c_src, void* c_dst, void* scratch, int L, int B, int K, int H, int Vp,
                   int t, int end_id, int pad_id, cudaStream_t stream) {
  const int G = block_rows(K) / K;
  const bool in_shared = work_fits(K, H, Vp);
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, H, Vp, in_shared);
  auto kernel = beam_step_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = (size_t)H * sizeof(T) % 16 == 0 && aligned(h_src) && aligned(h_dst) &&
                   aligned(c_src) && aligned(c_dst);
  kernel<<<n_blocks(B, K), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<float*>(scores), static_cast<int*>(finished), static_cast<int*>(tokens),
      static_cast<int*>(tok_hist), static_cast<int*>(par_hist), static_cast<const T*>(h_src),
      static_cast<T*>(h_dst), static_cast<const T*>(c_src), static_cast<T*>(c_dst),
      in_shared ? nullptr : static_cast<float*>(scratch), L, B, K, G, H, Vp, t, end_id, pad_id, vec);
  return cudaGetLastError();
}

enum Route { kBlock = 0, kClusterTC = 1 };

}  // namespace

// The launch of a beam step by `route` (0 the block kernel, 1 the bf16
// cluster kernel of beam_step_tc.cu) for B samples of K beams: dims = grid
// x, grid y, cluster size (1: none), rows a block's tile, floats of
// device-memory scratch.  Returns the dynamic shared memory a block, bytes,
// or -1 where the route does not take the shape.
extern "C" int i2l_beam_launch_shape(int B, int K, int H, int Vp, int route, long long* dims) {
  if (B <= 0 || K <= 0 || H <= 0 || Vp <= 0 || Vp % i2l::logits::BN != 0) return -1;
  if (route == kClusterTC) {
    int d[4];
    const int smem = i2l::beam_tc::launch_shape(B, K, Vp, d);
    if (smem < 0) return -1;
    const long long out[5] = {d[0], d[1], d[2], d[3], 0};
    for (int i = 0; i < 5; ++i) dims[i] = out[i];
    return smem;
  }
  if (route != kBlock || smem_bytes(K, H, Vp, false) > kMaxSmem) return -1;
  const bool fits = work_fits(K, H, Vp);
  const long long out[5] = {n_blocks(B, K), 1, 1, block_rows(K),
                            fits ? 0 : (long long)n_blocks(B, K) * (long long)work_floats(K, Vp)};
  for (int i = 0; i < 5; ++i) dims[i] = out[i];
  return (int)smem_bytes(K, H, Vp, fits);
}

// One beam step for B samples of K beams (N = B K rows, sample-major).
// h (N, H) the top layer's new h; w_out (H, Vp) with Vp a multiple of 128,
// 16-byte aligned; b_out (Vp,) float32; scores (N,) float32 and finished
// (N,) int32, updated in place; tokens (N,) int32 receives the new tokens;
// tok_hist and par_hist (T, N) int32 receive column t; h_src, c_src (L, N, H)
// the carries the LSTM left, h_dst, c_dst (L, N, H) receive them reindexed
// by parent (no aliasing); scratch: the launch shape's scratch floats, or
// null when that is 0.  All floating operands but b_out, scores and scratch
// in the compute type (dtype 0 float32, 1 bfloat16); route 0 the block
// kernel, 1 the cluster kernel (bf16 only).
extern "C" int i2l_beam_step(const void* h, const void* w_out, const void* b_out, void* scores,
                             void* finished, void* tokens, void* tok_hist, void* par_hist,
                             const void* h_src, void* h_dst, const void* c_src, void* c_dst,
                             void* scratch, int L, int B, int K, int H, int Vp, int t, int end_id,
                             int pad_id, int route, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || H <= 0 || L <= 0 || Vp <= 0 || Vp % i2l::logits::BN != 0 || t < 0 ||
      pad_id < 0 || pad_id >= Vp || reinterpret_cast<uintptr_t>(w_out) % 16 != 0 ||
      (long long)K * Vp > 0x7fffffffLL || smem_bytes(K, H, Vp, false) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kClusterTC)
    return dtype == i2l::kBF16 ? (int)i2l::beam_tc::launch(h, w_out, b_out, scores, finished, tokens, tok_hist,
                                                           par_hist, h_src, h_dst, c_src, c_dst, L, B, K, H, Vp, t,
                                                           end_id, pad_id, s)
                               : (int)cudaErrorInvalidValue;
  if (route != kBlock) return (int)cudaErrorInvalidValue;
  if (dtype == i2l::kF32)
    return (int)launch<float>(h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, h_src,
                              h_dst, c_src, c_dst, scratch, L, B, K, H, Vp, t, end_id, pad_id, s);
  if (dtype == i2l::kBF16)
    return (int)launch<__nv_bfloat16>(h, w_out, b_out, scores, finished, tokens, tok_hist,
                                      par_hist, h_src, h_dst, c_src, c_dst, scratch, L, B, K, H,
                                      Vp, t, end_id, pad_id, s);
  return (int)cudaErrorInvalidValue;
}
