// vocab_sample_step in bf16 on the tensor cores: the vocab product split over a thread-block
// cluster, then one warp a row for the filters and the draw.
//
// Replaces, with sample_step.cu's CUDA-core kernel (float32, and the bf16 shapes this kernel does
// not take), the token choice of the TPU sampling kernels,
// img2latex_tpu/ops/pallas/decode_step.py::_sample_next_token (line 555) with the uniform field
// of _make_sampler (lines 682-714), run each step by pallas_full_sample_decode (pl.pallas_call at
// decode_step.py:772) and pallas_full_grid_sample_decode (pl.pallas_call at grid_decode.py:665).
// It computes what sample_step.cu's header states, with the same rounding points and the same
// random stream bit for bit; only the product's sums run in another order.
//
// Design.  The product is vocab_slices.cuh's: grid (C, ceil(B / 32)), clusters of C = min(8,
// Vp / 64) blocks along the columns, each block holding its 64-column slices' float32 logits of
// the tile's 32 rows in shared memory (B = 512, Vp = 512: 128 blocks).  After a cluster barrier
// rank r finishes the rows i = r (mod C) of the tile, one warp a row.  The warp reads the row's Vp
// logits from the C blocks through distributed shared memory into registers, kN = Np / 32 a lane
// (Np = Vp rounded up to a power of two, padded with -inf), and everything after the product runs
// inside that warp, with shuffles and no block barrier:
//   top-k      top_k passes, each the best column below the previous pick in (value desc, index
//              asc) order (sample_step.cu's rule, no mask); the k-th pick's value is kth;
//   top-p      the softmax maximum and sum, the probabilities (0 outside top-k, renormalized),
//              their 64-bit keys (sample_draw.cuh), then the nucleus in the TPU kernel's
//              sequential float32 order, by one of two means: with top-k, which leaves few
//              nonzero probabilities, passes of the warp's largest key below the previous one
//              (the TPU kernel's extraction), each adding its probability, until the sum passes
//              top_p; without it, a bitonic sort of the row's Np keys in registers (in-lane
//              stages) and shuffles (stages across lanes), descending, lane l holding sorted
//              positions l kN .. l kN + kN - 1, then lane 0 adds its kN sorted probabilities to
//              the running sum, hands it to lane 1 by a shuffle, and so on, stopping once the sum
//              passes top_p; either way the last key kept bounds the nucleus;
//   draw       Gumbel-max over the kept columns with hash_uniform (the lowest column wins ties),
//              then the END/PAD rule and the stores.
// A second cluster barrier keeps every block resident until no peer reads its logits.
//
// Taken where the planner (ops/decode_step.py::sample_plan) and i2l_sample_launch_shape agree:
// bf16, Vp <= 1024 (the row's keys fit a warp's registers) and top_k <= 64 or top_k >= Vp (k
// passes of a warp); other bf16 shapes take sample_step.cu's kernel.
//
// Bound: the product is 2 B H Vp FLOP (0.27 GFLOP at B = H = Vp = 512), ~0.27 us at the bf16
// tensor-core rate; the bytes are h, W_out and the per-row arrays, ~1 MB, ~0.3 us at 3.35 TB/s.
// What a launch costs in practice is its latency chain: a block's 64-deep stages of the product,
// the cluster barrier, the row's distributed-shared-memory reads, then the warp's k passes, sort
// and scan.
#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "sample_draw.cuh"
#include "vocab_slices.cuh"

namespace i2l {
namespace sample_tc {

namespace cg = cooperative_groups;
namespace sl = i2l::slices;
using bf16 = __nv_bfloat16;
using draw::u64;

constexpr int kMaxVp = 1024;   // 32 keys a lane
constexpr int kMaxTopK = 64;   // the k passes a warp makes

// Descending bitonic sort of a warp's 32 kN keys, lane l holding positions l kN + s.
template <int kN>
__device__ __forceinline__ void warp_sort_desc(u64 (&key)[kN], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * kN; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < kN) {  // both positions in this lane
#pragma unroll
        for (int s = 0; s < kN; ++s) {
          if ((s & j) == 0) {
            const bool desc = ((lane * kN + s) & k) == 0;
            const u64 a = key[s], b = key[s | j];
            const u64 hi = a > b ? a : b, lo = a > b ? b : a;
            key[s] = desc ? hi : lo;
            key[s | j] = desc ? lo : hi;
          }
        }
      } else {  // the partner is lane ^ (j / kN), at the same s
        const int m = j / kN;
        const bool keep_hi = ((lane & m) == 0) == (((lane * kN) & k) == 0);
#pragma unroll
        for (int s = 0; s < kN; ++s) {
          const u64 o = __shfl_xor_sync(0xffffffffu, key[s], m);
          key[s] = keep_hi ? (key[s] > o ? key[s] : o) : (key[s] < o ? key[s] : o);
        }
      }
    }
  }
}

__device__ __forceinline__ u64 warp_max_u64(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <bool kAligned, int kN>
__global__ void __launch_bounds__(tile::kThreads) vocab_sample_step_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w_out, const float* __restrict__ b_out,
    int* __restrict__ tokens, int* __restrict__ finished, int* __restrict__ out, int t, int T_len, int B,
    int H, int Vp, int end_id, int pad_id, uint32_t seed, int top_k, float top_p, int batch_tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* lg = reinterpret_cast<float*>(smem_raw + tile::kSmemBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row0 = blockIdx.y * tile::kBM;

  sl::block_slices<kAligned>(lg, ring, h, w_out, b_out, B, H, Vp, row0, rank, C);
  cluster.sync();  // every slice of the tile is written and visible to the cluster

  const bool nucleus = top_p > 0.f;
  for (int i = rank + C * warp; i < tile::kBM && row0 + i < B; i += C * sl::kWarps) {
    const int row = row0 + i;
    float l[kN];  // column s 32 + lane
#pragma unroll
    for (int s = 0; s < kN; ++s) l[s] = s * 32 < Vp ? *sl::column(cluster, lg, i, s * 32 + lane, C) : -INFINITY;

    // ---- top-k: k picks in (value desc, index asc) order; kth the last ----
    float kth = -INFINITY;
    if (top_k > 0 && top_k < Vp) {
      float pv = INFINITY;
      int pi = -1;
      for (int n = 0; n < top_k; ++n) {
        float bv = -INFINITY;
        int bi = Vp;
#pragma unroll
        for (int s = 0; s < kN; ++s) {
          const int col = s * 32 + lane;
          const float v = l[s];
          const bool below = v < pv || (v == pv && col > pi);  // not picked yet
          if (below && v > bv) {  // col ascends with s: a strict > keeps the lowest index
            bv = v;
            bi = col;
          }
        }
        warp_best(bv, bi);
        pv = bv;
        pi = bi;
      }
      kth = pv;
    }

    const uint32_t base = draw::row_base(seed, row, t, batch_tile);
    float best = -INFINITY;
    int idx = Vp;
    if (nucleus) {
      // ---- probabilities, their keys, the nucleus ----------------------------
      float m = -INFINITY;
#pragma unroll
      for (int s = 0; s < kN; ++s) m = fmaxf(m, l[s]);
      m = warp_max(m);
      float p[kN];
      float z = 0.f;
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        p[s] = expf(l[s] - m);  // the -inf padding gives 0
        z += p[s];
      }
      z = warp_sum(z);
      float total = 0.f;
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        p[s] = p[s] / z;
        if (top_k > 0 && !(l[s] >= kth)) p[s] = 0.f;
        total += p[s];
      }
      total = warp_sum(total);
      const float denom = fmaxf(total, 1e-38f);
      u64 key[kN];
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const int col = s * 32 + lane;
        // renormalized between the filters, as the TPU kernel does; the padding's key is below
        // every column's
        key[s] = col < Vp ? draw::prob_key(top_k > 0 ? p[s] / denom : p[s], col) : 0ull;
      }
      // The nucleus: keys in descending order stay while the mass before them is <= top_p (the
      // first always stays), summed in float32 in that order; `last` is the last key kept.
      u64 last = ~0ull;
      if (top_k > 0 && top_k < Vp) {
        // top-k leaves few nonzero probabilities: take them in order by passes of the warp's
        // largest key below the previous one, as the TPU kernel extracts them, until the mass
        // passes top_p or only zeros are left (a zero is never drawn)
        u64 prev = ~0ull;
        float cum = 0.f;
        while (cum <= top_p) {
          u64 b = 0ull;
#pragma unroll
          for (int s = 0; s < kN; ++s)
            if (key[s] < prev && key[s] > b) b = key[s];
          b = warp_max_u64(b);
          if (!(draw::key_prob(b) > 0.f)) break;
          last = prev = b;
          cum = __fadd_rn(cum, draw::key_prob(b));
        }
      } else {
        // the whole row sorted; lane L adds its kN sorted positions to the running sum, then
        // hands it on
        warp_sort_desc<kN>(key, lane);
        float cum = 0.f;
        int cut = 0;
        for (int L = 0; L < 32 && L * kN < Vp; ++L) {
          float c = cum;
          int kept = cut;
          if (lane == L) {
#pragma unroll
            for (int s = 0; s < kN; ++s) {
              if (L * kN + s < Vp && c <= top_p) {
                kept = L * kN + s;
                c = __fadd_rn(c, draw::key_prob(key[s]));
              }
            }
          }
          cum = __shfl_sync(0xffffffffu, c, L);
          cut = __shfl_sync(0xffffffffu, kept, L);
          if (!(cum <= top_p)) break;  // no later position stays
        }
        u64 at_cut = 0ull;
#pragma unroll
        for (int s = 0; s < kN; ++s)
          if (lane * kN + s == cut) at_cut = key[s];
        last = warp_max_u64(at_cut);
      }
      // ---- the draw over the nucleus ----------------------------------------
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const float pk = draw::key_prob(key[s]);
        if (key[s] >= last && pk > 0.f) {
          const int col = draw::key_col(key[s]);
          const float u = draw::hash_uniform(base + (uint32_t)col * draw::kHashCol);
          const float v = __fadd_rn(logf(fmaxf(pk, 1e-38f)), -logf(-logf(u)));
          if (v > best || (v == best && col < idx)) {  // the keys' order is not the columns'
            best = v;
            idx = col;
          }
        }
      }
    } else {
      // ---- the draw over top-k --------------------------------------------------
#pragma unroll
      for (int s = 0; s < kN; ++s) {
        const int col = s * 32 + lane;
        if (col < Vp && l[s] >= kth) {
          const float u = draw::hash_uniform(base + (uint32_t)col * draw::kHashCol);
          const float v = __fadd_rn(l[s], -logf(-logf(u)));
          if (v > best) {  // col ascends with s: a strict > keeps the lowest index
            best = v;
            idx = col;
          }
        }
      }
    }
    warp_best(best, idx);
    if (lane == 0) {
      int tok = idx;
      if (finished != nullptr) {
        const int f = finished[row];
        tok = f ? pad_id : tok;
        finished[row] = (f || tok == end_id) ? 1 : 0;
      }
      tokens[row] = tok;
      if (out != nullptr) out[(size_t)row * T_len + t] = tok;
    }
  }
  cluster.sync();  // no block leaves while another may still read its logits
}

template <bool kAligned, int kN>
cudaError_t launch_n(const int (&dims)[4], int smem, const void* h, const void* w_out, const void* b_out,
                     void* tokens, void* finished, void* out, int t, int T_len, int B, int H, int Vp, int end_id,
                     int pad_id, uint32_t seed, int top_k, float top_p, int batch_tile, cudaStream_t stream) {
  static bool done[16] = {};
  return sl::launch_clusters(vocab_sample_step_tc_kernel<kAligned, kN>, dims[2], dims[1], smem,
                             sl::smem_bytes(kMaxVp), done, stream,
                             static_cast<const bf16*>(h), static_cast<const bf16*>(w_out),
                             static_cast<const float*>(b_out), static_cast<int*>(tokens),
                             static_cast<int*>(finished), static_cast<int*>(out), t, T_len, B, H, Vp, end_id,
                             pad_id, seed, top_k, top_p, batch_tile);
}

template <bool kAligned>
cudaError_t launch_aligned(const int (&dims)[4], int smem, const void* h, const void* w_out, const void* b_out,
                           void* tokens, void* finished, void* out, int t, int T_len, int B, int H, int Vp,
                           int end_id, int pad_id, uint32_t seed, int top_k, float top_p, int batch_tile,
                           cudaStream_t stream) {
  auto fn = Vp <= 128 ? launch_n<kAligned, 4>
            : Vp <= 256 ? launch_n<kAligned, 8>
            : Vp <= 512 ? launch_n<kAligned, 16>
                        : launch_n<kAligned, 32>;
  return fn(dims, smem, h, w_out, b_out, tokens, finished, out, t, T_len, B, H, Vp, end_id, pad_id, seed, top_k,
            top_p, batch_tile, stream);
}

// The launch of this kernel for B rows, Vp columns and top_k: dims = grid x, grid y, cluster size
// (along x), rows a tile; returns its dynamic shared memory a block, bytes, or -1 where it does
// not take the shape (Vp above 1024 or not a multiple of 128, 64 < top_k < Vp, or too many row
// tiles).
int launch_shape(int B, int Vp, int top_k, int (&dims)[4]) {
  const int tiles = (B + tile::kBM - 1) / tile::kBM;
  if (B <= 0 || Vp <= 0 || Vp % 128 != 0 || Vp > kMaxVp || top_k < 0 || (top_k > kMaxTopK && top_k < Vp) ||
      tiles > 65535)
    return -1;
  dims[0] = dims[2] = sl::cluster_size(Vp);
  dims[1] = tiles;
  dims[3] = tile::kBM;
  return sl::smem_bytes(Vp);
}

// One bf16 sampling step (the arguments of i2l_vocab_sample_step, no scratch).
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* tokens, void* finished, void* out,
                   int t, int T_len, int B, int H, int Vp, int end_id, int pad_id, uint32_t seed, int top_k,
                   float top_p, int batch_tile, cudaStream_t stream) {
  int dims[4];
  const int smem = launch_shape(B, Vp, top_k, dims);
  if (smem < 0) return cudaErrorInvalidValue;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  auto fn = H % 8 == 0 && a16(h) && a16(w_out) ? launch_aligned<true> : launch_aligned<false>;
  return fn(dims, smem, h, w_out, b_out, tokens, finished, out, t, T_len, B, H, Vp, end_id, pad_id, seed, top_k,
            top_p, batch_tile, stream);
}

}  // namespace sample_tc
}  // namespace i2l
