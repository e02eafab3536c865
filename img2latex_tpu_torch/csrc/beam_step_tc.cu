// beam_step in bf16 on the tensor cores: row tiles of whole samples, the vocab product's columns
// split over a thread-block cluster.
//
// Replaces, with beam_step.cu's CUDA-core kernel (float32, and K > 32), the body of the TPU
// kernels' beam loop after the LSTM, img2latex_tpu/ops/pallas/beam_decode.py::_beam_loop (lines
// 173-249), run by pallas_full_beam_decode (pl.pallas_call at beam_decode.py:335) and
// pallas_full_grid_beam_decode (pl.pallas_call at grid_decode.py:561).  It computes what
// beam_step.cu's header states (the log-softmax, END absorption, the K passes of (max, mask the
// winner with -1e30) over each sample's K·Vp totals, the updates, the histories and the carry
// gather); only the product's sums and the log-softmax's run in another order.
//
// Design.  A row tile holds G = floor(32 / K) whole samples, G·K of tile_mma.cuh's 32 rows (30 at
// K = 5); grid (C, ceil(B / G)), clusters of C = min(8, Vp / 64) blocks along the columns
// (vocab_slices.cuh; B = 512, K = 5: 86 tiles, 688 blocks).  Per block (rank r):
//   before the first cluster barrier: its slices' logits on the tensor cores; each row's partial
//     (max, sum of exp) over its columns; the old scores and finished of the tile's rows;
//   after it: each row's logsumexp from the C partials (in rank order); the totals of its own
//     columns in place, score + logp with the finished rule (0 at PAD, -1e30 elsewhere); per
//     sample its columns' K best in (value desc, flat index k Vp + v asc) order, by K passes that
//     each take the best candidate below the previous pick (a warp a sample), and the lowest flat
//     index whose total is >= -1e30;
//   after a second barrier: every block merges each sample's C x K candidates (so that every
//     block knows the parents), and the rank g % C writes sample g's new scores, finished, tokens
//     and history column; then the cluster gathers the 2 L carries of the tile's rows from their
//     parents, out of place, in 16-byte copies spread over all its blocks.
// The reference masks a winner with -1e30, not -inf, so once a sample's totals above -1e30 are
// used up a pass takes the lowest flat index among those at -1e30, which may be a pick made
// before: the totals above -1e30 come out in order, then every later pass picks (-1e30, the
// lowest flat index whose total is >= -1e30); if there is none, the first pass takes the largest
// total and every later one that same index at -1e30 (decode.py:227-239's topk_iterative does the
// same).  No block writes scores or finished before every block of the cluster has read them
// (first barrier); a third barrier keeps each block resident until no peer reads its candidates.
//
// Taken where the planner (ops/decode_step.py::beam_plan) and i2l_beam_launch_shape agree: bf16,
// K <= 32 and a block's slices within its shared memory; other bf16 shapes take beam_step.cu.
//
// Bound: the product is 2 K B H Vp FLOP (1.0 GFLOP at B = 512, K = 5, H = 384, Vp = 512), about
// 1 us at the bf16 tensor-core rate; the bytes are the h rows, W_out once, the carries gathered
// (read and written, 15.7 MB at the grid's shapes) and the per-row arrays: ~18 MB, ~5 us at
// 3.35 TB/s.
#include <cooperative_groups.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "vocab_slices.cuh"

namespace i2l {
namespace beam_tc {

namespace cg = cooperative_groups;
namespace sl = i2l::slices;
using bf16 = __nv_bfloat16;

constexpr int kMaxK = tile::kBM;   // a tile holds at least one whole sample
constexpr float kNeg = -1e30f;
constexpr int kMaxSmem = 224 * 1024;  // of the 227 KB a block may opt in to, the rest for static shared memory

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool kAligned>
__global__ void __launch_bounds__(tile::kThreads) beam_step_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w_out, const float* __restrict__ b_out,
    float* __restrict__ scores, int* __restrict__ finished, int* __restrict__ tokens, int* __restrict__ tok_hist,
    int* __restrict__ par_hist, const bf16* __restrict__ h_src, bf16* __restrict__ h_dst,
    const bf16* __restrict__ c_src, bf16* __restrict__ c_dst, int L, int B, int K, int G, int H, int Vp, int t,
    int end_id, int pad_id, int vec_copy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* lg = reinterpret_cast<float*>(smem_raw + tile::kSmemBytes);
  __shared__ float part_m[tile::kBM], part_z[tile::kBM], lse[tile::kBM], sc_old[tile::kBM];
  __shared__ int fin_old[tile::kBM], src_row[tile::kBM];
  __shared__ float cand_v[tile::kBM];  // sample g's K best of this block's columns at g K + n
  __shared__ int cand_i[tile::kBM];
  __shared__ int cand_min[tile::kBM];  // sample g's lowest flat index with a total >= -1e30 here
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int N = B * K;
  const int s0 = blockIdx.y * G;
  const int ns = min(G, B - s0);  // samples of this tile
  const int R = ns * K;           // rows of this tile
  const int row0 = s0 * K;
  const int nsl = (Vp / tile::kBN - rank + C - 1) / C;  // this block's slices
  const int ncol = nsl * tile::kBN;

  // ---- before the first barrier: old scores and finished, logits, partials -------
  if (tid < R) {
    sc_old[tid] = scores[row0 + tid];
    fin_old[tid] = finished[row0 + tid];
  }
  sl::block_slices<kAligned>(lg, ring, h, w_out, b_out, N, H, Vp, row0, rank, C);
  for (int r = warp; r < R; r += sl::kWarps) {  // a warp a row
    float m = -INFINITY;
    for (int n = 0; n < nsl; ++n)
      for (int c = lane; c < tile::kBN; c += 32) m = fmaxf(m, lg[n * sl::kSliceFloats + r * sl::kPitch + c]);
    m = warp_max(m);
    float z = 0.f;
    for (int n = 0; n < nsl; ++n)
      for (int c = lane; c < tile::kBN; c += 32) z += expf(lg[n * sl::kSliceFloats + r * sl::kPitch + c] - m);
    z = warp_sum(z);
    if (lane == 0) {
      part_m[r] = m;
      part_z[r] = z;
    }
  }
  cluster.sync();  // partials visible to the cluster; every block has read scores and finished

  // ---- each row's logsumexp; totals in place; per sample this block's K best --------
  if (tid < R) {
    float m = -INFINITY;
    for (int k = 0; k < C; ++k) m = fmaxf(m, cluster.map_shared_rank(part_m, k)[tid]);
    float z = 0.f;
    for (int k = 0; k < C; ++k)
      z += cluster.map_shared_rank(part_z, k)[tid] * expf(cluster.map_shared_rank(part_m, k)[tid] - m);
    lse[tid] = logf(z) + m;
  }
  __syncthreads();
  for (int e = tid; e < R * ncol; e += tile::kThreads) {
    const int r = e / ncol, n = (e % ncol) / tile::kBN, c = e % tile::kBN;
    const int col = (rank + n * C) * tile::kBN + c;
    float& x = lg[n * sl::kSliceFloats + r * sl::kPitch + c];
    const float logp = fin_old[r] ? (col == pad_id ? 0.f : kNeg) : x - lse[r];
    x = sc_old[r] + logp;
  }
  __syncthreads();
  for (int g = warp; g < ns; g += sl::kWarps) {
    float pv = INFINITY;
    int pi = -1, lowest = INT_MAX;
    for (int n = 0; n < K; ++n) {
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int k = 0; k < K; ++k)
        for (int j = 0; j < nsl; ++j)
          for (int c = lane; c < tile::kBN; c += 32) {  // flat indices ascend along this loop
            const float v = lg[j * sl::kSliceFloats + (g * K + k) * sl::kPitch + c];
            const int fi = k * Vp + (rank + j * C) * tile::kBN + c;
            if (n == 0 && v >= kNeg) lowest = min(lowest, fi);
            const bool below = v < pv || (v == pv && fi > pi);  // not picked yet
            if (below && v > bv) {
              bv = v;
              bi = fi;
            }
          }
      warp_best(bv, bi);
      pv = bv;
      pi = bi;
      if (lane == 0) {
        cand_v[g * K + n] = bv;
        cand_i[g * K + n] = bi;
      }
    }
    lowest = warp_min(lowest);
    if (lane == 0) cand_min[g] = lowest;
  }
  cluster.sync();  // every block's candidates visible to the cluster

  // ---- merge each sample's C x K candidates; the owner writes the new beams ---------
  for (int g = warp; g < ns; g += sl::kWarps) {
    float cv[sl::kMaxCluster];  // candidate lane + 32 j: rank (lane + 32 j) / K, pick (lane + 32 j) % K
    int ci[sl::kMaxCluster];
#pragma unroll
    for (int j = 0; j < sl::kMaxCluster; ++j) {
      const int e = lane + 32 * j;
      cv[j] = -INFINITY;
      ci[j] = INT_MAX;
      if (e < C * K) {
        cv[j] = cluster.map_shared_rank(cand_v, e / K)[g * K + e % K];
        ci[j] = cluster.map_shared_rank(cand_i, e / K)[g * K + e % K];
      }
    }
    const int lowest = warp_min(lane < C ? cluster.map_shared_rank(cand_min, lane)[g] : INT_MAX);
    float pv = INFINITY, my_v = 0.f;
    int pi = -1, first = 0, my_i = 0;
    for (int n = 0; n < K; ++n) {  // K passes in (value desc, flat index asc) order
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < sl::kMaxCluster; ++j) {
        const bool below = cv[j] < pv || (cv[j] == pv && ci[j] > pi);
        if (below && (cv[j] > bv || (cv[j] == bv && ci[j] < bi))) {
          bv = cv[j];
          bi = ci[j];
        }
      }
      warp_best(bv, bi);
      pv = bv;
      pi = bi;
      // the reference's pass n
      float val = bv;
      int idx = bi;
      if (!(bv > kNeg)) {  // the totals above -1e30 are used up
        if (lowest != INT_MAX) {
          val = kNeg;
          idx = lowest;
        } else if (n > 0) {  // none at or above -1e30: the first pick again, masked
          val = kNeg;
          idx = first;
        }
      }
      if (n == 0) first = idx;
      if (lane == n) {
        my_v = val;
        my_i = idx;
      }
    }
    if (lane < K) {
      const int par = my_i / Vp, tok = my_i % Vp, r = g * K + lane;
      src_row[r] = row0 + g * K + par;
      if (g % C == rank) {
        const int row = row0 + r;
        scores[row] = my_v;
        finished[row] = (fin_old[g * K + par] != 0 || tok == end_id) ? 1 : 0;
        tokens[row] = tok;
        tok_hist[(size_t)t * N + row] = tok;
        par_hist[(size_t)t * N + row] = par;
      }
    }
  }
  __syncthreads();
  cluster_arrive();  // done reading the peers' shared memory

  // ---- the carries of every layer from the parent rows, spread over the cluster ----
  const size_t layer = (size_t)N * H;
  const int per_row = vec_copy ? H / 8 : H;  // 16-byte pieces, or elements
  const int total = 2 * L * R * per_row;
  for (int e = rank * tile::kThreads + tid; e < total; e += C * tile::kThreads) {
    const int piece = e % per_row, rl = e / per_row;
    const int r = rl % R, l = (rl / R) % L, which = rl / (R * L);
    const size_t src = l * layer + (size_t)src_row[r] * H, dst = l * layer + (size_t)(row0 + r) * H;
    const bf16* from = which == 0 ? h_src : c_src;
    bf16* to = which == 0 ? h_dst : c_dst;
    if (vec_copy)
      reinterpret_cast<uint4*>(to + dst)[piece] = reinterpret_cast<const uint4*>(from + src)[piece];
    else
      to[dst + piece] = from[src + piece];
  }
  cluster_wait();  // no block leaves while another may still read its candidates
}

// The launch of this kernel for B samples of K beams at Vp columns: dims = grid x, grid y,
// cluster size (along x), rows a tile (G K); returns its dynamic shared memory a block, bytes, or
// -1 where it does not take the shape (K > 32, Vp not a multiple of 128, slices beyond a block's
// shared memory, too many row tiles).
int launch_shape(int B, int K, int Vp, int (&dims)[4]) {
  if (B <= 0 || K <= 0 || K > kMaxK || Vp <= 0 || Vp % 128 != 0 || sl::smem_bytes(Vp) > kMaxSmem) return -1;
  const int G = tile::kBM / K, tiles = (B + G - 1) / G;
  if (tiles > 65535) return -1;
  dims[0] = dims[2] = sl::cluster_size(Vp);
  dims[1] = tiles;
  dims[3] = G * K;
  return sl::smem_bytes(Vp);
}

template <bool kAligned>
cudaError_t launch_aligned(const int (&dims)[4], int smem, const void* h, const void* w_out, const void* b_out,
                           void* scores, void* finished, void* tokens, void* tok_hist, void* par_hist,
                           const void* h_src, void* h_dst, const void* c_src, void* c_dst, int L, int B, int K,
                           int H, int Vp, int t, int end_id, int pad_id, int vec, cudaStream_t stream) {
  static bool done[16] = {};
  return sl::launch_clusters(beam_step_tc_kernel<kAligned>, dims[2], dims[1], smem, kMaxSmem, done, stream,
                             static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
                             static_cast<const float*>(b_out), static_cast<float*>(scores),
                             static_cast<int*>(finished), static_cast<int*>(tokens), static_cast<int*>(tok_hist),
                             static_cast<int*>(par_hist), static_cast<const bf16*>(h_src),
                             static_cast<bf16*>(h_dst), static_cast<const bf16*>(c_src), static_cast<bf16*>(c_dst),
                             L, B, K, dims[3] / K, H, Vp, t, end_id, pad_id, vec);
}

// One bf16 beam step (the arguments of i2l_beam_step, no scratch).
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* scores, void* finished, void* tokens,
                   void* tok_hist, void* par_hist, const void* h_src, void* h_dst, const void* c_src, void* c_dst,
                   int L, int B, int K, int H, int Vp, int t, int end_id, int pad_id, cudaStream_t stream) {
  int dims[4];
  const int smem = launch_shape(B, K, Vp, dims);
  if (smem < 0) return cudaErrorInvalidValue;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = H % 8 == 0 && a16(h_src) && a16(h_dst) && a16(c_src) && a16(c_dst);
  auto fn = H % 8 == 0 && a16(h) && a16(w_out) ? launch_aligned<true> : launch_aligned<false>;
  return fn(dims, smem, h, w_out, b_out, scores, finished, tokens, tok_hist, par_hist, h_src, h_dst, c_src, c_dst,
            L, B, K, H, Vp, t, end_id, pad_id, vec, stream);
}

}  // namespace beam_tc
}  // namespace i2l
