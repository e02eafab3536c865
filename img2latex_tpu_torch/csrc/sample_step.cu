// One sampling step after the top LSTM layer: the vocab product, then
// temperature, top-k and top-p filtering and a Gumbel-max draw, for all rows.
//
// Replaces the token choice of the TPU sampling kernels,
// img2latex_tpu/ops/pallas/decode_step.py::_sample_next_token (line 555)
// with the uniform field of _make_sampler (lines 682-714), which both
// img2latex_tpu/ops/pallas/decode_step.py::pallas_full_sample_decode
// (pl.pallas_call at line 772) and
// img2latex_tpu/ops/pallas/grid_decode.py::pallas_full_grid_sample_decode
// (pl.pallas_call at line 665) run each step; their LSTM is
// greedy_decode.cu's lstm_layer_step and the grid kernel's attention
// grid_attend.cu's attend_step.  It takes the place of vocab_argmax_step in
// the decode loop.  Per row r, with h the top layer's new h and the
// temperature already folded into W_out and b_out (ops/decode_step.py:
// fold_temperature):
//   l       = h_r @ W_out + b_out                     float32
//   top-k   (top_k > 0): kth = the k-th value of l in (value desc, index asc)
//           order, i.e. after k passes of (max, lowest index, mask one
//           column); kept: l >= kth, so every tie of the k-th value stays
//   top-p   (top_p > 0): p = exp(l - m) / sum exp(l - m); with top-k, p = 0
//           outside it and p /= max(sum p, 1e-38); the nucleus: tokens in
//           descending p, ties to the lowest index, summed sequentially in
//           float32 in that order; a token stays while the mass strictly
//           before it is <= top_p (the first always stays); p = 0 never drawn
//   draw    argmax over the kept columns of (top-p: log max(p, 1e-38); else
//           l) + -log(-log u), the lowest index winning ties
//   u       the TPU kernels' lowbias32 hash of (tile seed, t, row in tile,
//           column) in uint32: the top 24 bits x 2^-24, then x (1 - 2e-7) +
//           1e-7, rounded as the TPU kernel rounds (no fused multiply-add);
//           row r of the batch is row r % batch_tile of tile r / batch_tile,
//           whose seed is seed + r / batch_tile
// then the END/PAD rule, the token store and the out[:, t] column of
// vocab_argmax_step.  With the same logits the draws are the TPU kernels'
// bit for bit; sums in another order move a draw only where two perturbed
// scores, or the nucleus mass and top_p, are within a rounding step.
//
// Two kernels compute it, by route (ops/decode_step.py::sample_plan names it):
//   block: vocab_sample_step_kernel below, a block of 16 rows on the CUDA
//     cores; float32 (the exactness oracle) and the bf16 shapes the cluster
//     kernel does not take (Vp above 1024, 64 < top_k < Vp);
//   cluster_tc: sample_step_tc.cu's bf16 kernel, the product on the tensor
//     cores split over a cluster, then a warp a row.
//
// The block kernel.  A block owns 16 rows.  The product is block_logits.cuh's
// float32 one on the CUDA cores, and the block's logits (16 x Vp float32,
// 32 KB at Vp = 512) stay in shared memory; 16 threads (half a warp) serve a
// row: the top-k passes and the softmax sums are half-warp reductions (the k
// passes need no mask: each takes the best column below the previous pick in
// (value, index) order).  For top-p the row's probabilities become 64-bit
// keys (sample_draw.cuh: probability bits above the complemented index, so
// one descending order puts ties lowest index first), sorted by a bitonic
// sort of the block's rows in shared memory (16 x Np keys, Np = Vp rounded up
// to a power of two; 64 KB at Vp = 512), then one lane scans them in order,
// summing in float32 exactly as the TPU kernel's iterative extraction does,
// and leaves the key of the last kept token: a column is kept when its key is
// not below it.  That is one pass where the TPU kernel runs up to Vp
// extraction passes on the near-uniform rows random weights make.  Where the
// logits and keys do not fit the 227 KB of shared memory beside the staged h
// and W_out tile, they go to a device-memory scratch the wrapper allocates
// (sample_plan's scratch_floats).
//
// Bound: per step the product is 2 B H Vp FLOP (0.27 GFLOP at B = H = Vp =
// 512), ~0.27 us at the bf16 tensor-core rate, and the bytes are h, W_out and
// the per-row arrays, ~1 MB, ~0.3 us at 3.35 TB/s.
#include <cstdint>

#include "block_logits.cuh"
#include "sample_draw.cuh"

namespace i2l {
namespace sample_tc {
int launch_shape(int B, int Vp, int top_k, int (&dims)[4]);
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* tokens, void* finished, void* out,
                   int t, int T_len, int B, int H, int Vp, int end_id, int pad_id, uint32_t seed, int top_k,
                   float top_p, int batch_tile, cudaStream_t stream);
}  // namespace sample_tc
}  // namespace i2l

namespace {

using i2l::logits::kRows;
constexpr int kThreads = i2l::logits::kThreads;
constexpr size_t kMaxSmem = 226 * 1024;  // of the 227 KB a block may opt in to, 1 KB left for static shared memory
using i2l::draw::hash_uniform;
using i2l::draw::prob_key;
using i2l::draw::u64;

// (value, index) of the better of two candidates: the larger value, the lower
// index on ties.
__device__ __forceinline__ void half_warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__host__ __device__ inline size_t work_floats(int Vp, int Np, bool nucleus) {
  return (size_t)kRows * Vp + (nucleus ? 2 * (size_t)kRows * Np : 0);  // even: keys stay 8-byte aligned
}

inline size_t smem_bytes(int H, int Vp, int Np, bool nucleus, bool work_in_shared) {
  return sizeof(float) *
         ((size_t)i2l::logits::staged_floats(H) + (work_in_shared ? work_floats(Vp, Np, nucleus) : 0));
}

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Dynamic shared memory: the staging of block_logits, then the work area
// (lg[16][Vp] the logits and then the probabilities, keys[16][Np]) when
// `work` is null, else the work area of block b is work + b * work_floats.
template <typename T>
__global__ void __launch_bounds__(kThreads) vocab_sample_step_kernel(
    const T* __restrict__ h, const T* __restrict__ w_out, const float* __restrict__ b_out,
    int* __restrict__ tokens, int* __restrict__ finished, int* __restrict__ out, float* work,
    int t, int T_len, int B, int H, int Vp, int Np, int end_id, int pad_id, uint32_t seed,
    int top_k, float top_p, int batch_tile) {
  extern __shared__ __align__(16) float smem[];
  __shared__ u64 row_last[kRows];
  const bool nucleus = top_p > 0.f;
  float* lg = work == nullptr
                  ? smem + i2l::logits::staged_floats(H)
                  : work + (size_t)blockIdx.x * work_floats(Vp, Np, nucleus);
  u64* keys = reinterpret_cast<u64*>(lg + (size_t)kRows * Vp);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kRows;
  const int R = min(kRows, B - row0);
  const int row = row0 + ty;
  const bool on = ty < R;
  float* l = lg + (size_t)ty * Vp;

  i2l::logits::block_logits(h, w_out, b_out, H, Vp, row0, R, smem, lg);

  // ---- top-k: k picks in (value desc, index asc) order; kth the last -------
  float kth = -INFINITY;
  if (top_k > 0 && top_k < Vp) {
    float pv = INFINITY;
    int pi = -1;
    for (int n = 0; n < top_k; ++n) {
      float bv = -INFINITY;
      int bi = Vp;
      for (int col = tx; col < Vp; col += 16) {
        const float v = on ? l[col] : 0.f;
        const bool below = v < pv || (v == pv && col > pi);  // not picked yet
        if (below && v > bv) {  // col ascends: a strict > keeps the lowest index
          bv = v;
          bi = col;
        }
      }
      half_warp_best(bv, bi);
      pv = bv;
      pi = bi;
    }
    kth = pv;
  }

  // ---- top-p: probabilities, keys, sort, the nucleus scan -----------------
  if (nucleus) {
    float m = -INFINITY;
    for (int col = tx; col < Vp; col += 16) m = fmaxf(m, on ? l[col] : 0.f);
    m = half_warp_max(m);
    float z = 0.f;
    for (int col = tx; col < Vp; col += 16) z += on ? expf(l[col] - m) : 0.f;
    z = half_warp_sum(z);
    float total = 0.f;
    for (int col = tx; col < Vp; col += 16) {
      if (!on) continue;
      float p = expf(l[col] - m) / z;
      if (top_k > 0 && !(l[col] >= kth)) p = 0.f;
      l[col] = p;
      total += p;
    }
    total = half_warp_sum(total);
    const float denom = fmaxf(total, 1e-38f);
    u64* kr = keys + (size_t)ty * Np;
    for (int col = tx; col < Np; col += 16) {
      if (!on) continue;
      if (col >= Vp) {
        kr[col] = 0ull;  // below every column's key
        continue;
      }
      float p = l[col];
      if (top_k > 0) {  // renormalize between the filters, as the TPU kernel does
        p = p / denom;
        l[col] = p;
      }
      kr[col] = prob_key(p, col);
    }
    __syncthreads();
    // bitonic sort of each of the block's R rows, descending
    for (int k = 2; k <= Np; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = tid; q < R * (Np >> 1); q += kThreads) {
          const int r = q / (Np >> 1), i = q % (Np >> 1);
          const int x = ((i & ~(j - 1)) << 1) | (i & (j - 1)), y = x + j;
          u64* kr2 = keys + (size_t)r * Np;
          const u64 a = kr2[x], b = kr2[y];
          if ((x & k) == 0 ? a < b : a > b) {
            kr2[x] = b;
            kr2[y] = a;
          }
        }
        __syncthreads();
      }
    }
    if (on && tx == 0) {
      float cum = 0.f;
      u64 last = kr[0];
      for (int j = 0; j < Vp && cum <= top_p; ++j) {
        last = kr[j];
        cum = __fadd_rn(cum, __uint_as_float((uint32_t)(last >> 32)));
      }
      row_last[ty] = last;
    }
    __syncthreads();
  }

  // ---- the draw: Gumbel-max over the kept columns ---------------------------
  const uint32_t base = i2l::draw::row_base(seed, row, t, batch_tile);
  const u64 last = nucleus && on ? row_last[ty] : 0ull;
  float best = -INFINITY;
  int idx = Vp;
  for (int col = tx; col < Vp; col += 16) {
    if (!on) break;
    float s;
    if (nucleus) {
      const float p = l[col];
      if (!(p > 0.f) || prob_key(p, col) < last) continue;
      s = logf(fmaxf(p, 1e-38f));
    } else {
      s = l[col];
      if (!(s >= kth)) continue;
    }
    const float u = hash_uniform(base + (uint32_t)col * i2l::draw::kHashCol);
    const float v = __fadd_rn(s, -logf(-logf(u)));
    if (v > best) {  // col ascends: a strict > keeps the lowest index
      best = v;
      idx = col;
    }
  }
  half_warp_best(best, idx);
  if (tx == 0 && on) {
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

template <typename T>
cudaError_t launch(const void* h, const void* w_out, const void* b_out, void* tokens,
                   void* finished, void* out, void* scratch, int t, int T_len, int B, int H,
                   int Vp, int end_id, int pad_id, uint32_t seed, int top_k, float top_p,
                   int batch_tile, cudaStream_t stream) {
  const int Np = pow2_at_least(Vp);
  const bool nucleus = top_p > 0.f;
  const bool in_shared = smem_bytes(H, Vp, Np, nucleus, true) <= kMaxSmem;
  if (!in_shared && scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(H, Vp, Np, nucleus, in_shared);
  auto kernel = vocab_sample_step_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(B + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w_out), static_cast<const float*>(b_out),
      static_cast<int*>(tokens), static_cast<int*>(finished), static_cast<int*>(out),
      in_shared ? nullptr : static_cast<float*>(scratch), t, T_len, B, H, Vp, Np, end_id, pad_id,
      seed, top_k, top_p, batch_tile);
  return cudaGetLastError();
}

enum Route { kBlock = 0, kClusterTC = 1 };

// Floats of device-memory scratch the block kernel needs for B rows: 0 when
// a block's logits (and, with top-p on, its sort keys) fit in shared memory.
long long scratch_floats(int B, int H, int Vp, bool nucleus) {
  const int Np = pow2_at_least(Vp);
  if (smem_bytes(H, Vp, Np, nucleus, true) <= kMaxSmem) return 0;
  return (long long)((B + kRows - 1) / kRows) * (long long)work_floats(Vp, Np, nucleus);
}

}  // namespace

// The launch of a sampling step by `route` (0 the block kernel, 1 the bf16
// cluster kernel of sample_step_tc.cu): dims = grid x, grid y, cluster size
// (1: none), rows a block's tile, floats of device-memory scratch.  Returns
// the dynamic shared memory a block, bytes, or -1 where the route does not
// take the shape.
extern "C" int i2l_sample_launch_shape(int B, int H, int Vp, int top_k, int top_p_on, int route,
                                       long long* dims) {
  if (B <= 0 || H <= 0 || Vp <= 0 || Vp % i2l::logits::BN != 0 || top_k < 0) return -1;
  if (route == kClusterTC) {
    int d[4];
    const int smem = i2l::sample_tc::launch_shape(B, Vp, top_k, d);
    if (smem < 0) return -1;
    const long long out[5] = {d[0], d[1], d[2], d[3], 0};
    for (int i = 0; i < 5; ++i) dims[i] = out[i];
    return smem;
  }
  const bool nucleus = top_p_on != 0;
  const int Np = pow2_at_least(Vp);
  if (route != kBlock || smem_bytes(H, Vp, Np, nucleus, false) > kMaxSmem) return -1;
  const long long scratch = scratch_floats(B, H, Vp, nucleus);
  const long long out[5] = {(B + kRows - 1) / kRows, 1, 1, kRows, scratch};
  for (int i = 0; i < 5; ++i) dims[i] = out[i];
  return (int)smem_bytes(H, Vp, Np, nucleus, scratch == 0);
}

// One sampling step.  h (B, H); w_out (H, Vp) with Vp a multiple of 128,
// 16-byte aligned, and b_out (Vp,) float32, the temperature folded in;
// tokens (B,) int32 receives the token; finished (B,) int32 or null (no END
// rule); out (B, T_len) int32 or null, column t; scratch: the launch shape's
// scratch floats, or null when that is 0.  seed is the int32 seed of the
// first tile as its uint32 bits; top_k 0 or top_p 0 turn that filter off,
// one of them must be on.  h and w_out in the compute type (dtype 0 float32,
// 1 bfloat16); route 0 the block kernel, 1 the cluster kernel (bf16 only).
extern "C" int i2l_vocab_sample_step(const void* h, const void* w_out, const void* b_out,
                                     void* tokens, void* finished, void* out, void* scratch, int t,
                                     int T_len, int B, int H, int Vp, int end_id, int pad_id,
                                     int seed, int top_k, float top_p, int batch_tile, int route,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Vp <= 0 || Vp % i2l::logits::BN != 0 || Vp > (1 << 30) || t < 0 ||
      t >= T_len || tokens == nullptr || top_k < 0 || !(top_p >= 0.f) ||
      (top_k == 0 && top_p == 0.f) || batch_tile <= 0 ||
      reinterpret_cast<uintptr_t>(w_out) % 16 != 0 ||
      smem_bytes(H, Vp, pow2_at_least(Vp), top_p > 0.f, false) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t useed = (uint32_t)seed;
  if (route == kClusterTC)
    return dtype == i2l::kBF16 ? (int)i2l::sample_tc::launch(h, w_out, b_out, tokens, finished, out, t, T_len, B,
                                                             H, Vp, end_id, pad_id, useed, top_k, top_p,
                                                             batch_tile, s)
                               : (int)cudaErrorInvalidValue;
  if (route != kBlock) return (int)cudaErrorInvalidValue;
  if (dtype == i2l::kF32)
    return (int)launch<float>(h, w_out, b_out, tokens, finished, out, scratch, t, T_len, B, H, Vp,
                              end_id, pad_id, useed, top_k, top_p, batch_tile, s);
  if (dtype == i2l::kBF16)
    return (int)launch<__nv_bfloat16>(h, w_out, b_out, tokens, finished, out, scratch, t, T_len,
                                      B, H, Vp, end_id, pad_id, useed, top_k, top_p, batch_tile,
                                      s);
  return (int)cudaErrorInvalidValue;
}
