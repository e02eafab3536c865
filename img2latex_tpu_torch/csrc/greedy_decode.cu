// Whole greedy decode of the LSTM decoder (vector memory), one step at a time.
//
// Replaces the TPU kernel img2latex_tpu/ops/pallas/decode_step.py::pallas_full_greedy_decode
// (pl.pallas_call at line 523; early_exit is the host loop's, the per-row
// scores are vocab_argmax_step's); one step of it is
// decode_step.py::fused_decode_step (pl.pallas_call at line 176).  The grid
// kernel grid_decode.py::pallas_full_grid_greedy_decode runs the same two
// kernels with its context from grid_attend.cu.
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
//                     (lowest index wins ties), the PAD-after-END rule, the
//                     token store and, when asked, the step's confidence
//                     signal (decode_step.py:327-372) added to a per-row
//                     score; logits never reach device memory.  Rounding
//                     points: decode_step.py:325's (compute-type operands,
//                     float32 sums, float32 bias and logits).
//
// Bound of lstm_layer_step: 2 B K 4H FLOP (K = E0 + E1 + H) on K 4H weights
// that all rows share.  At the vector width (B = 512, H = 512, K = 1536 and
// 1024) that is 2.7 GFLOP a launch (mean of the two layers) against ~5.8 MB,
// ~460 FLOP a byte, above the H100's ~295 in bf16: bound by operations,
// 0.0027 ms at 989 TFLOP/s; at the grid width (H = 384, K = 896 and 768)
// 0.0013 ms; at 2560 beam rows 5x the FLOP on nearly the same bytes.
//
// Two kernels compute it, by storage type:
//   float32: lstm_layer_step_kernel, products on the CUDA cores in float32
//     (exact for float32 storage: the oracle whose tokens must equal the
//     plain version's).  A block takes 64 rows x 32 hidden units, i.e. the
//     128 gate columns {g H + j} of those units, so each thread ends holding
//     all four gates of its 4 rows x 2 units and applies the cell update.
//   bf16: lstm_layer_step_tc_kernel, products on the tensor cores
//     (mma.sync m16n8k16, bf16 operands, float32 sums: what the TPU kernel's
//     MXU product with preferred_element_type=float32 computes, with the sums
//     in another order).  The same block tile, 64 rows x 32 units x 4 gates,
//     keeps the cell update in the epilogue, in registers: 8 warps as 2 (rows)
//     x 4 (units), a warp 32 rows x 8 units x 4 gates, i.e. 2 x 4 m16n8
//     tiles whose n8 tiles are the four gates of the same 8 units, so each
//     lane holds the four gates of 4 rows x 2 units.  A and B tiles are
//     staged in bf16, untouched, through a ring of cp.async 16-byte copies
//     (rows padded by 16 bytes so that ldmatrix meets no bank conflict);
//     layer 0's embedding gather is the A loader's source for k < E0 (read
//     through L1: rows that share a token, as all do at the first step, then
//     hit L1 instead of one L2 line), so x never reaches device memory.  Each
//     stage's products are summed by the tensor cores from zero and added to
//     the running sums in IEEE float32, so that the tensor cores' additions
//     (which truncate) run over 64 products at most, not all of K.
//     scripts/bf16_parting.py counts the bf16 decode rows that part from the
//     plain version's tokens on several data draws, for this tree and for
//     another (an earlier tree's CUDA-core kernel); PERF.md §6 has both.
//     Shapes whose rows are not 16-byte multiples (E0, E1 or H
//     not a multiple of 8, or an unaligned pointer) take the same kernel
//     with a guarded element-wise loader; rows past B and units past H are
//     masked, K is zero-filled past its end.
//     Tile and ring: at B = 512 the grid is 128 blocks (vector) or 96 (grid
//     width), under one wave of 132 SMs, so the depth of the load pipeline
//     matters more than reuse.  64 rows x 32 units keeps 8 warps a block and
//     the four gates of a unit in one block; 64-deep stages halve the ring's
//     barriers against 32-deep ones, and three of them (79,872 bytes of
//     dynamic shared memory) keep two stages in flight while one is summed.
//     Taller tiles (128 rows, 16 warps) or shorter ones (32 rows) were slower
//     at every shape of the main path when the tile was chosen.  What holds
//     it: 128 blocks on 132 SMs, each walking all of K alone, and the L2
//     traffic of reading each weight tile once a row block and each A tile
//     once a unit block, with 2 warps a scheduler to hide the ldmatrix and
//     mma latencies; a K split across a cluster (partial sums reduced through
//     distributed shared memory before the cell update), TMA multicast of the
//     weights and wgmma are the next steps (ROADMAP.md queue 2).
//     ptxas (sm_90a, CUDA 12.8): 128 registers (aligned loader) and 114
//     (guarded), no spills; the first build, one 32-deep 4-stage ring summed
//     in the tensor cores alone, 93 and 80.
// Bound of vocab_argmax_step: h (B x H) and W_out (H x Vp) read once, 2 B H Vp
// FLOP: at B = 512, H = 512, Vp = 512 about 1 MB and 0.27 GFLOP, 0.32 us
// over device memory; in practice a launch is bound by its latency chain
// (loads from L2, the product, the merges).  Two kernels, by storage type:
//   float32: vocab_argmax_step_kernel, a register-tiled float32 product on
//     the CUDA cores (exact, the oracle): a block takes 16 rows and walks all
//     Vp columns in chunks of 128, each thread keeping a running state of its
//     row over its columns; the 16 threads of a row then reduce with warp
//     shuffles.
//   bf16: vocab_argmax_step_tc_kernel, tensor cores and clusters.  A block
//     takes 32 rows x a 64-column slice (tile_mma.cuh: mma.sync m16n8k16 on
//     bf16 h and W_out staged by cp.async, float32 sums, each 64-deep stage
//     summed from zero and added in IEEE float32); the Vp / 64 slices of a
//     row tile are the blocks of one thread-block cluster (8 at Vp = 512, so
//     B = 512 gives 128 blocks where the float32 kernel has 32), more slices
//     than 8 are walked by each block in turn.  The epilogue adds b_out and
//     builds each row's state over the block's columns in registers and
//     shared memory; the cluster merges the blocks' states through
//     distributed shared memory (stat_combine: the lowest index wins a tie
//     across slices) and applies the END rule and the score signal.
// A row's state (RowStat): the best logit and its index, the runner-up (the
// largest logit outside the chosen column, a tie giving margin 0, as masking
// the argmax column does) and online sums of exp(l - max) and of
// exp(l - max) (l - max) for the logsumexp and the entropy.
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "tile_mma.cuh"

namespace cg = cooperative_groups;

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

// ---- lstm_layer_step, bf16, tensor cores ------------------------------------
// The block tile is T_WM x T_WN warps of 32 rows x 8 units (the head note says why this one).
using bf16 = __nv_bfloat16;
constexpr int T_WM = 2;                           // warps along rows
constexpr int T_WN = 4;                           // warps along hidden units
constexpr int T_THREADS = 32 * T_WM * T_WN;
constexpr int T_BM = 32 * T_WM;                   // rows per block
constexpr int T_HU = 8 * T_WN;                    // hidden units per block
constexpr int T_BN = 4 * T_HU;                    // gate columns per block
constexpr int T_BK = 64;                          // depth of one stage
constexpr int T_STAGES = 3;                       // depth of the cp.async ring
constexpr int T_APITCH = T_BK + 8;                // A row: 16 bytes of padding, ldmatrix rows on distinct banks
constexpr int T_BPITCH = T_BN + 8;                // B row: likewise
constexpr int T_A_ELEMS = T_BM * T_APITCH;
constexpr int T_STAGE_ELEMS = T_A_ELEMS + T_BK * T_BPITCH;
constexpr int T_SMEM = T_STAGES * T_STAGE_ELEMS * (int)sizeof(bf16);  // 79,872 bytes at 2 x 4 warps, 64 deep, 3 stages
static_assert(T_BK % 16 == 0 && T_STAGES >= 2, "k16 steps; a ring of at least two stages");
static_assert((T_STAGE_ELEMS * (int)sizeof(bf16)) % 16 == 0, "16-byte aligned stages");

constexpr int T_A_CHUNKS = T_BM * T_BK / 8 / T_THREADS;  // 16-byte chunks of A a thread copies a stage
constexpr int T_B_CHUNKS = T_BK * T_BN / 8 / T_THREADS;  // ... of B
static_assert(T_A_CHUNKS * 8 * T_THREADS == T_BM * T_BK && T_B_CHUNKS * 8 * T_THREADS == T_BK * T_BN,
              "the stage splits evenly over the threads");

// The A (rows x k) and B (k x gate columns) sources of one thread, fixed for the whole launch, so
// that staging a k-tile costs a few adds: loops with compile-time trip counts, no division.
// kAligned: every row of emb, x1, h_in, w_ih, w_hh starts on 16 bytes and E0, E1, H are multiples
// of 8, so an 8-element chunk lies inside one source row and one segment of k: 16-byte cp.async
// copies, zero-filled where out of range.  Otherwise element by element, each guarded.
struct LstmTcSrc {
  const int* tokens;
  const bf16 *emb, *x1, *h_in, *w_ih, *w_hh;
  int E0, E1, H, B, row0, j0;
};

template <bool kAligned>
__device__ __forceinline__ void lstm_tc_load(bf16* stage, int kt, const LstmTcSrc& a,
                                             const bf16* const (&arow)[T_A_CHUNKS][3], const int (&acol)[T_A_CHUNKS],
                                             const int (&bcol)[T_B_CHUNKS], const int (&bk)[T_B_CHUNKS]) {
  bf16* As = stage;
  bf16* Bs = stage + T_A_ELEMS;
  const int tid = threadIdx.x;
  const int In = a.E0 + a.E1, K = In + a.H, G = 4 * a.H, k0 = kt * T_BK;
  if (kAligned) {
#pragma unroll
    for (int i = 0; i < T_A_CHUNKS; ++i) {  // arow: the row's emb / x1 / h_in row, null past B
      const int k = k0 + acol[i];
      const bool ok = arow[i][0] != nullptr && k < K;
      const int e = tid + i * T_THREADS;
      bf16* dst = As + (e / (T_BK / 8)) * T_APITCH + acol[i];
      if (ok && k < a.E0)
        i2l::cp_async_16_l1(dst, arow[i][0] + k, true);
      else
        i2l::cp_async_16(dst, !ok ? a.x1 : k < In ? arow[i][1] + (k - a.E0) : arow[i][2] + (k - In), ok);
    }
#pragma unroll
    for (int i = 0; i < T_B_CHUNKS; ++i) {  // bcol: the chunk's gate column, -1 past H
      const int k = k0 + bk[i];
      const bool ok = bcol[i] >= 0 && k < K;
      const bf16* src = !ok ? a.w_hh : (k < In ? a.w_ih + (size_t)k * G : a.w_hh + (size_t)(k - In) * G) + bcol[i];
      const int e = tid + i * T_THREADS;
      i2l::cp_async_16(Bs + bk[i] * T_BPITCH + (e % (T_BN / 8)) * 8, src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll 4
    for (int i = 0; i < T_BM * T_BK / T_THREADS; ++i) {
      const int e = tid + i * T_THREADS;
      const int r = e / T_BK, kk = e % T_BK;
      const int row = a.row0 + r, k = k0 + kk;
      bf16 v = zero;
      if (row < a.B && k < K) {
        if (k < a.E0)
          v = a.emb[(size_t)a.tokens[row] * a.E0 + k];
        else if (k < In)
          v = a.x1[(size_t)row * a.E1 + (k - a.E0)];
        else
          v = a.h_in[(size_t)row * a.H + (k - In)];
      }
      As[r * T_APITCH + kk] = v;
    }
#pragma unroll 4
    for (int i = 0; i < T_BK * T_BN / T_THREADS; ++i) {
      const int e = tid + i * T_THREADS;
      const int kk = e / T_BN, n = e % T_BN;
      const int g = n / T_HU, j = a.j0 + n % T_HU, k = k0 + kk;
      bf16 v = zero;
      if (k < K && j < a.H) v = (k < In ? a.w_ih + (size_t)k * G : a.w_hh + (size_t)(k - In) * G)[g * a.H + j];
      Bs[kk * T_BPITCH + n] = v;
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(T_THREADS) lstm_layer_step_tc_kernel(
    const int* __restrict__ tokens, const bf16* __restrict__ emb, int E0,
    const bf16* __restrict__ x1, int E1, const bf16* __restrict__ h_in,
    const bf16* __restrict__ w_ih, const bf16* __restrict__ w_hh, const float* __restrict__ bias,
    bf16* __restrict__ c, bf16* __restrict__ h_out, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / T_WN, wn = warp % T_WN;  // rows wm * 32 .., units wn * 8 .. of the block tile
  const int row0 = blockIdx.y * T_BM, j0 = blockIdx.x * T_HU;
  const int nk = (E0 + E1 + H + T_BK - 1) / T_BK;
  const LstmTcSrc src{tokens, emb, x1, h_in, w_ih, w_hh, E0, E1, H, B, row0, j0};

  // This thread's chunk sources, once: A rows (the gather of layer 0 read here) and B columns.
  const bf16* arow[T_A_CHUNKS][3];
  int acol[T_A_CHUNKS], bcol[T_B_CHUNKS], bk[T_B_CHUNKS];
#pragma unroll
  for (int i = 0; i < T_A_CHUNKS; ++i) {
    const int e = tid + i * T_THREADS, row = row0 + e / (T_BK / 8);
    acol[i] = (e % (T_BK / 8)) * 8;
    const bool ok = kAligned && row < B;
    arow[i][0] = ok ? (E0 > 0 ? emb + (size_t)tokens[row] * E0 : x1) : nullptr;
    arow[i][1] = ok ? x1 + (size_t)row * E1 : nullptr;
    arow[i][2] = ok ? h_in + (size_t)row * H : nullptr;
  }
#pragma unroll
  for (int i = 0; i < T_B_CHUNKS; ++i) {
    const int e = tid + i * T_THREADS, nc = (e % (T_BN / 8)) * 8;
    const int j = j0 + nc % T_HU;
    bk[i] = e / (T_BN / 8);
    bcol[i] = j < H ? (nc / T_HU) * H + j : -1;
  }

  // [m16 tile][gate][fragment].  The tensor cores sum a stage's T_BK products (their float32
  // additions truncate); the stages' sums are added here in IEEE float32, so that the whole sum
  // stays as close to a float32 product's as the CUDA-core kernel's does.
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][g][e] = 0.f;

#pragma unroll
  for (int s = 0; s < T_STAGES - 1; ++s) {
    if (s < nk) lstm_tc_load<kAligned>(smem + s * T_STAGE_ELEMS, s, src, arow, acol, bcol, bk);
    i2l::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    i2l::cp_async_wait<T_STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();                     // ... everyone's; and everyone is done with tile kt - 1
    const int nxt = kt + T_STAGES - 1;
    if (nxt < nk) lstm_tc_load<kAligned>(smem + (nxt % T_STAGES) * T_STAGE_ELEMS, nxt, src, arow, acol, bcol, bk);
    i2l::cp_async_commit();
    const bf16* As = smem + (kt % T_STAGES) * T_STAGE_ELEMS;
    const bf16* Bs = As + T_A_ELEMS;
    float part[2][4][4];  // this stage's sums, from zero
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][g][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < T_BK; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        i2l::ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + lane % 16) * T_APITCH + kk + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p)  // gates 2p and 2p + 1 of units wn * 8 ..
        i2l::ldmatrix_x4_trans(
            b[p], Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * T_BPITCH + (2 * p + lane / 16) * T_HU + wn * 8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          i2l::mma_bf16_16816(part[mi][g], a[mi], b[g / 2][(g % 2) * 2], b[g / 2][(g % 2) * 2 + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][g][e] += part[mi][g][e];
  }
  i2l::cp_async_wait<0>();

  // Cell update, gate order (i, f, g, o); c in place, new h to h_out.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + wm * 32 + mi * 16 + lane / 4 + hf * 8;
      if (row >= B) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = j0 + wn * 8 + (lane % 4) * 2 + u;
        if (j >= H) continue;
        const int e = hf * 2 + u;
        const float gi = acc[mi][0][e] + bias[j];
        const float gf = acc[mi][1][e] + bias[H + j];
        const float gg = acc[mi][2][e] + bias[2 * H + j];
        const float go = acc[mi][3][e] + bias[3 * H + j];
        const size_t o = (size_t)row * H + j;
        const float c_new = sigmoidf_(gf) * __bfloat162float(c[o]) + sigmoidf_(gi) * tanhf(gg);
        const float h_new = sigmoidf_(go) * tanhf(c_new);
        c[o] = __float2bfloat16(c_new);
        h_out[o] = __float2bfloat16(h_new);
      }
    }
  }
}

// ---- vocab_argmax_step ----------------------------------------------------
constexpr int V_BM = 16;   // rows per block (one per thread row)
constexpr int V_BN = 128;  // columns per chunk
constexpr int V_BK = 16;
constexpr int V_TN = 8;    // columns per thread per chunk

// Running state of one row's logits, for the argmax and the score signals.
// z = sum exp(l - best), q = sum exp(l - best) (l - best), over the columns seen.
struct RowStat {
  float best, second, z, q;
  int idx;
};

__device__ __forceinline__ void stat_push(RowStat& st, float v, int col) {
  if (v > st.best) {  // columns come in increasing order: a strict > keeps the lowest index
    if (st.z > 0.f) {
      const float d = st.best - v, a = expf(d);
      st.q = a * (st.q + d * st.z);
      st.z = a * st.z;
    }
    st.z += 1.f;
    st.second = st.best;
    st.best = v;
    st.idx = col;
  } else {
    st.second = fmaxf(st.second, v);
    const float d = v - st.best, e = expf(d);
    st.z += e;
    st.q += e * d;
  }
}

// Merge another state of the same row into st: the larger best wins, the
// lower index on a tie, whatever the order the two states come in.  Without
// kScore only (best, idx) are kept.
template <bool kScore>
__device__ __forceinline__ void stat_combine(RowStat& st, const RowStat& o) {
  const bool other_wins = o.best > st.best || (o.best == st.best && o.idx < st.idx);
  if (kScore) {
    const float m = other_wins ? o.best : st.best;
    float z = 0.f, q = 0.f;
    if (st.z > 0.f) {
      const float d = st.best - m, a = expf(d);
      z += a * st.z;
      q += a * (st.q + d * st.z);
    }
    if (o.z > 0.f) {
      const float d = o.best - m, a = expf(d);
      z += a * o.z;
      q += a * (o.q + d * o.z);
    }
    st.z = z;
    st.q = q;
    st.second = fmaxf(fmaxf(st.second, o.second), other_wins ? st.best : o.best);
  }
  if (other_wins) {
    st.best = o.best;
    st.idx = o.idx;
  }
}

// Merge the state of the lane `off` away (every lane of the warp takes part).
template <bool kScore>
__device__ __forceinline__ void stat_merge(RowStat& st, int off) {
  RowStat o;
  o.best = __shfl_xor_sync(0xffffffffu, st.best, off);
  o.idx = __shfl_xor_sync(0xffffffffu, st.idx, off);
  if (kScore) {
    o.second = __shfl_xor_sync(0xffffffffu, st.second, off);
    o.z = __shfl_xor_sync(0xffffffffu, st.z, off);
    o.q = __shfl_xor_sync(0xffffffffu, st.q, off);
  }
  stat_combine<kScore>(st, o);
}

// Signal codes: 1 logp, 2 margin, 3 entropy, 4 margin + alpha logp.
__device__ __forceinline__ float stat_signal(const RowStat& st, int signal, float alpha) {
  const float lse = st.best + logf(st.z);
  const float logp = st.best - lse;  // the chosen token is the argmax
  const float margin = st.best - st.second;
  switch (signal) {
    case 1: return logp;
    case 2: return margin;
    case 3: return st.q / st.z - logf(st.z);
    default: return margin + alpha * logp;
  }
}

// One column's logit into a row's state (columns in increasing order).
template <bool kScore>
__device__ __forceinline__ void stat_add(RowStat& st, float v, int col) {
  if (kScore) {
    stat_push(st, v, col);
  } else if (v > st.best) {
    st.best = v;
    st.idx = col;
  }
}

// The state of no column: -FLT_MAX, so that padded columns (-1e30) still win
// over it and lose to real ones.
__device__ __forceinline__ RowStat stat_empty() { return RowStat{-3.402823466e+38f, -3.402823466e+38f, 0.f, 0.f, 0}; }

// The row's token from its state over all Vp columns: the PAD-after-END rule,
// the score signal on rows not yet finished, the stores.
template <bool kScore>
__device__ __forceinline__ void store_row(const RowStat& st, int row, int* __restrict__ tokens,
                                          int* __restrict__ finished, int* __restrict__ out,
                                          float* __restrict__ score, int signal, float alpha, int t,
                                          int T_len, int end_id, int pad_id) {
  int tok = st.idx;
  int f = 0;
  if (finished != nullptr) {
    f = finished[row];
    tok = f ? pad_id : tok;
    finished[row] = (f || tok == end_id) ? 1 : 0;
  }
  if (kScore && !f) score[row] += stat_signal(st, signal, alpha);
  tokens[row] = tok;
  if (out != nullptr) out[(size_t)row * T_len + t] = tok;
}

template <typename T, bool kScore>
__global__ void __launch_bounds__(kThreads) vocab_argmax_step_kernel(
    const T* __restrict__ h, const T* __restrict__ w_out, const float* __restrict__ b_out,
    int* __restrict__ tokens, int* __restrict__ finished, int* __restrict__ out,
    float* __restrict__ score, int signal, float alpha, int t, int T_len,
    int B, int H, int Vp, int end_id, int pad_id) {
  __shared__ float As[V_BK][V_BM + 1];
  __shared__ __align__(16) float Bs[V_BK][V_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * V_BM;
  const int row = row0 + ty;

  RowStat st = stat_empty();
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
#pragma unroll
    for (int n = 0; n < V_TN; ++n) {
      const int col = n0 + tx * V_TN + n;
      if (col < Vp) stat_add<kScore>(st, acc[n] + b_out[col], col);
    }
  }
  // The 16 threads of a row are one half of a warp: reduce (max, lowest index).
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) stat_merge<kScore>(st, off);
  if (tx == 0 && row < B)
    store_row<kScore>(st, row, tokens, finished, out, score, signal, alpha, t, T_len, end_id, pad_id);
}

// ---- vocab_argmax_step, bf16, tensor cores ----------------------------------
// Grid (C, ceil(B / 32)), clusters of C blocks along x: the C blocks of a cluster share a tile of
// 32 rows, block (rank) r takes the 64-column slices r, r + C, ... of the Vp / 64, C = min(8,
// slices).  After its slices each block holds one state a row in shared memory; the cluster then
// merges them through distributed shared memory, rank r finishing the rows i = r (mod C).
constexpr int VT_STAT_BYTES = (i2l::tile::kWN + 1) * i2l::tile::kBM * (int)sizeof(RowStat);
constexpr int VT_SMEM = i2l::tile::kSmemBytes + VT_STAT_BYTES;
constexpr int VT_MAX_CLUSTER = 8;  // the portable cluster size

template <bool kAligned, bool kScore>
__global__ void __launch_bounds__(i2l::tile::kThreads) vocab_argmax_step_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w_out, const float* __restrict__ b_out,
    int* __restrict__ tokens, int* __restrict__ finished, int* __restrict__ out,
    float* __restrict__ score, int signal, float alpha, int t, int T_len,
    int B, int H, int Vp, int end_id, int pad_id) {
  namespace tl = i2l::tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  RowStat* part = reinterpret_cast<RowStat*>(smem_raw + tl::kSmemBytes);  // [kWN][kBM]: a warp column's states
  RowStat* mine = part + tl::kWN * tl::kBM;                                 // [kBM]: this block's states
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / tl::kWN, wn = warp % tl::kWN, g = lane / 4, q = lane % 4;
  const int row0 = blockIdx.y * tl::kBM;
  const int slices = (Vp + tl::kBN - 1) / tl::kBN;

  RowStat run = stat_empty();  // thread tid < kBM: row row0 + tid over this block's slices
  for (int sl = rank; sl < slices; sl += C) {
    const int col0 = sl * tl::kBN;
    float acc[2][4];
    tl::block_product<kAligned>(acc, ring, h, w_out, B, Vp, H, row0, col0);
    // A lane holds rows g and g + 8 of its warp's 16 x 16 tile at columns 8 j + 2 q + u: in
    // increasing order for the lane; across lanes and warps the merges compare indices.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      RowStat st = stat_empty();
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = col0 + wn * 16 + j * 8 + 2 * q + u;
          if (col < Vp) stat_add<kScore>(st, acc[j][hf * 2 + u] + b_out[col], col);
        }
      stat_merge<kScore>(st, 1);  // the four lanes of a row
      stat_merge<kScore>(st, 2);
      if (q == 0) part[wn * tl::kBM + wm * 16 + hf * 8 + g] = st;
    }
    __syncthreads();
    if (tid < tl::kBM) {
#pragma unroll
      for (int w = 0; w < tl::kWN; ++w) stat_combine<kScore>(run, part[w * tl::kBM + tid]);
    }
    // part is written again only after the next block_product's barriers
  }
  if (tid < tl::kBM) mine[tid] = run;
  cluster.sync();  // every block's states are written and visible to the cluster
  if (tid < tl::kBM && tid % C == rank && row0 + tid < B) {
    RowStat st = stat_empty();
    for (int k = 0; k < C; ++k) stat_combine<kScore>(st, cluster.map_shared_rank(mine, k)[tid]);
    store_row<kScore>(st, row0 + tid, tokens, finished, out, score, signal, alpha, t, T_len, end_id, pad_id);
  }
  cluster.sync();  // no block leaves while another may still read its states
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

template <bool kAligned>
cudaError_t launch_lstm_tc(const void* tokens, const void* emb, int E0, const void* x1, int E1,
                           const void* h_in, const void* w_ih, const void* w_hh, const void* b,
                           void* c, void* h_out, int B, int H, cudaStream_t stream) {
  static bool done[16] = {};
  const cudaError_t err = i2l::allow_dynamic_smem(lstm_layer_step_tc_kernel<kAligned>, T_SMEM, done);
  if (err != cudaSuccess) return err;
  dim3 grid((H + T_HU - 1) / T_HU, (B + T_BM - 1) / T_BM);
  lstm_layer_step_tc_kernel<kAligned><<<grid, T_THREADS, T_SMEM, stream>>>(
      static_cast<const int*>(tokens), static_cast<const bf16*>(emb), E0, static_cast<const bf16*>(x1),
      E1, static_cast<const bf16*>(h_in), static_cast<const bf16*>(w_ih),
      static_cast<const bf16*>(w_hh), static_cast<const float*>(b), static_cast<bf16*>(c),
      static_cast<bf16*>(h_out), B, H);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t launch_vocab(const void* h, const void* w_out, const void* b_out, void* tokens,
                         void* finished, void* out, void* score, int signal, float alpha, int t,
                         int T_len, int B, int H, int Vp, int end_id, int pad_id,
                         cudaStream_t stream) {
  dim3 grid((B + V_BM - 1) / V_BM);
  auto kernel = score != nullptr ? vocab_argmax_step_kernel<T, true>
                                 : vocab_argmax_step_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<int*>(tokens), static_cast<int*>(finished), static_cast<int*>(out),
      static_cast<float*>(score), signal, alpha, t, T_len, B, H, Vp, end_id, pad_id);
  return cudaGetLastError();
}

// Grid (x, y) and cluster size (along x) of the bf16 vocab kernel.
void vocab_tc_grid(int B, int Vp, int (&dims)[3]) {
  const int slices = (Vp + i2l::tile::kBN - 1) / i2l::tile::kBN;
  const int C = slices < VT_MAX_CLUSTER ? slices : VT_MAX_CLUSTER;
  dims[0] = C;
  dims[1] = (B + i2l::tile::kBM - 1) / i2l::tile::kBM;
  dims[2] = C;
}

template <bool kAligned, bool kScore>
cudaError_t launch_vocab_tc(const void* h, const void* w_out, const void* b_out, void* tokens,
                            void* finished, void* out, void* score, int signal, float alpha, int t,
                            int T_len, int B, int H, int Vp, int end_id, int pad_id,
                            cudaStream_t stream) {
  static bool done[16] = {};
  auto kernel = vocab_argmax_step_tc_kernel<kAligned, kScore>;
  cudaError_t err = i2l::allow_dynamic_smem(kernel, VT_SMEM, done);
  if (err != cudaSuccess) return err;
  int dims[3];
  vocab_tc_grid(B, Vp, dims);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dims[0], dims[1]);
  cfg.blockDim = dim3(i2l::tile::kThreads);
  cfg.dynamicSmemBytes = VT_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = dims[2];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
                           static_cast<const float*>(b_out), static_cast<int*>(tokens),
                           static_cast<int*>(finished), static_cast<int*>(out), static_cast<float*>(score),
                           signal, alpha, t, T_len, B, H, Vp, end_id, pad_id);
  const cudaError_t last = cudaGetLastError();  // read (and cleared) either way
  return err != cudaSuccess ? err : last;
}

cudaError_t launch_vocab_bf16(const void* h, const void* w_out, const void* b_out, void* tokens,
                              void* finished, void* out, void* score, int signal, float alpha, int t,
                              int T_len, int B, int H, int Vp, int end_id, int pad_id,
                              cudaStream_t stream) {
  const bool aligned = H % 8 == 0 && Vp % 8 == 0 && aligned16(h) && aligned16(w_out);
  auto launch = aligned ? (score != nullptr ? launch_vocab_tc<true, true> : launch_vocab_tc<true, false>)
                        : (score != nullptr ? launch_vocab_tc<false, true> : launch_vocab_tc<false, false>);
  return launch(h, w_out, b_out, tokens, finished, out, score, signal, alpha, t, T_len, B, H, Vp, end_id,
                pad_id, stream);
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
      (B + L_BM - 1) / L_BM > 65535 || (B + T_BM - 1) / T_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch_lstm<float>(tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out, B, H, s);
  if (dtype == i2l::kBF16) {  // the tensor-core kernel; 16-byte copies where every row allows them
    const bool aligned = E0 % 8 == 0 && E1 % 8 == 0 && H % 8 == 0 && aligned16(emb) && aligned16(x1) &&
                         aligned16(h_in) && aligned16(w_ih) && aligned16(w_hh);
    return (int)(aligned ? launch_lstm_tc<true>(tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out, B, H, s)
                         : launch_lstm_tc<false>(tokens, emb, E0, x1, E1, h_in, w_ih, w_hh, b, c, h_out, B, H, s));
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 lstm_layer_step kernel, bytes (ptxas reports static only).
extern "C" int i2l_lstm_tc_smem_bytes() { return T_SMEM; }

// Vocab product, argmax and token store for one step.  h (B, H); w_out (H, Vp);
// b_out (Vp,) float32; tokens (B,) int32 receives the token; finished (B,)
// int32 or null (no END rule); out (B, T_len) int32 or null, column t;
// score (B,) float32 or null: the step's signal (1 logp, 2 margin,
// 3 entropy, 4 margin + alpha logp) is added on the rows not yet finished.
extern "C" int i2l_vocab_argmax_step(const void* h, const void* w_out, const void* b_out,
                                     void* tokens, void* finished, void* out, void* score,
                                     int signal, float alpha, int t, int T_len, int B, int H,
                                     int Vp, int end_id, int pad_id, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Vp <= 0 || t < 0 || t >= T_len || tokens == nullptr ||
      (score != nullptr && (signal < 1 || signal > 4)) ||
      (dtype == i2l::kBF16 && (B + i2l::tile::kBM - 1) / i2l::tile::kBM > 65535))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch_vocab<float>(h, w_out, b_out, tokens, finished, out, score, signal, alpha,
                                    t, T_len, B, H, Vp, end_id, pad_id, s);
  if (dtype == i2l::kBF16)  // the tensor-core kernel, clusters merging the column slices
    return (int)launch_vocab_bf16(h, w_out, b_out, tokens, finished, out, score, signal, alpha, t, T_len,
                                  B, H, Vp, end_id, pad_id, s);
  return (int)cudaErrorInvalidValue;
}

// The bf16 vocab kernel's launch for B rows and Vp columns: dims = grid x, grid y, cluster size
// (along x); returns its dynamic shared memory a block, bytes.
extern "C" int i2l_vocab_tc_launch_shape(int B, int Vp, int* dims) {
  int d[3];
  vocab_tc_grid(B, Vp, d);
  for (int i = 0; i < 3; ++i) dims[i] = d[i];
  return VT_SMEM;
}
