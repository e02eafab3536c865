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
// Bound: every step reads all of U and the memory once, (A + E) S 2 bytes a
// memory row in bf16: at B = 512, S = 100, E = 256, A = 384 that is 65.5 MB a
// step, more than the 50 MB L2, about 19.6 us at 3.35 TB/s.  The energies
// are a second floor: one precise tanhf and three roundings for each (row,
// slot, column), 19.7 M a step at greedy and 98.3 M with 5 beams a memory,
// at ~30 instructions each about 0.02 and 0.1 ms of the card's ~29.6 T
// lane-instructions a second.  h @ W_h is only 2 B H A FLOP.
//
// Two kernels, launched together by i2l_attend_step:
//   hw = h @ W_h:  bf16: attend_hw_tc_kernel, the tensor-core block product
//                  of tile_mma.cuh (32 rows x 64 columns a block, float32
//                  sums, each 64-deep stage added in IEEE float32), rounded
//                  to bf16.  float32: attend_hw_kernel, a register-tiled
//                  float32 product on the CUDA cores (exact).  W_h (H x A)
//                  is read once per 32 (16) rows from L2, not once per row.
//   attend_mem_kernel  one block per memory row m, serving all its
//                  rows_per_mem rows (in groups of up to kMaxGroup), so U and
//                  the memory are read once a step whatever the beam width.
//                  The warps take the S slots in turn and stream U's row of
//                  each slot once with evict-first loads, a batch of loads in
//                  flight while the previous batch is used, each U value
//                  serving every row of the group (hw and v from shared
//                  memory, bf16 pairs where the rows allow); a warp reduces
//                  its slot's scores with shuffles; the softmax runs a row a
//                  warp; the context pass reads the memory from shared
//                  memory, each thread summing a column of every row of the
//                  group.  The memory row's copy into shared memory
//                  (cp.async, evict-first) streams while the scores are
//                  computed: each warp issues its share once it is halfway
//                  through its slots (issued at block start, ahead of U's
//                  loads, it made the step slower on the H100).  Where
//                  the memory row and the rest would pass smem_target (the
//                  blocks an SM that the registers allow), it is read in
//                  tiles of slots.  The
//                  evict-first hints keep U and the memory, which are read
//                  once a step and exceed L2, from evicting the decoder
//                  weights the step's other kernels read from L2 (PERF.md §6).
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma_bf16.cuh"
#include "tile_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
using bf16 = __nv_bfloat16;

// ---- attend_hw_kernel: hw = h @ W_h, float32 --------------------------------
constexpr int P_BM = 16;  // rows per block
constexpr int P_BN = 64;  // columns per block
constexpr int P_BK = 64;  // deep tiles: few load-then-sync rounds over H
constexpr int P_TN = 4;   // columns per thread

__global__ void __launch_bounds__(kThreads) attend_hw_kernel(
    const float* __restrict__ h, const float* __restrict__ w_h, float* __restrict__ hw, int B, int H, int A) {
  __shared__ __align__(16) float As[P_BK][P_BM + 4];
  __shared__ __align__(16) float Bs[P_BK][P_BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * P_BM, col0 = blockIdx.x * P_BN;
  float acc[P_TN] = {};
  for (int k0 = 0; k0 < H; k0 += P_BK) {
#pragma unroll
    for (int e = tid; e < P_BM * P_BK; e += kThreads) {
      const int r = e / P_BK, kk = e % P_BK;
      const int row = row0 + r, k = k0 + kk;
      As[kk][r] = (row < B && k < H) ? h[(size_t)row * H + k] : 0.f;
    }
#pragma unroll
    for (int e = tid; e < P_BK * P_BN; e += kThreads) {
      const int kk = e / P_BN, n = e % P_BN;
      const int k = k0 + kk, col = col0 + n;
      Bs[kk][n] = (k < H && col < A) ? w_h[(size_t)k * A + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P_BK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * P_TN]);
      const float a = As[kk][ty];
      acc[0] = fmaf(a, b4.x, acc[0]);
      acc[1] = fmaf(a, b4.y, acc[1]);
      acc[2] = fmaf(a, b4.z, acc[2]);
      acc[3] = fmaf(a, b4.w, acc[3]);
    }
    __syncthreads();
  }
  const int row = row0 + ty;
  if (row >= B) return;
#pragma unroll
  for (int j = 0; j < P_TN; ++j) {
    const int col = col0 + tx * P_TN + j;
    if (col < A) hw[(size_t)row * A + col] = acc[j];
  }
}

// ---- attend_hw_tc_kernel: hw = h @ W_h, bf16, tensor cores ------------------
template <bool kAligned>
__global__ void __launch_bounds__(i2l::tile::kThreads) attend_hw_tc_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w_h, bf16* __restrict__ hw, int B, int H, int A) {
  namespace tl = i2l::tile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / tl::kWN, wn = warp % tl::kWN;
  const int row0 = blockIdx.y * tl::kBM, col0 = blockIdx.x * tl::kBN;
  float acc[2][4];
  tl::block_product<kAligned>(acc, reinterpret_cast<bf16*>(smem_raw), h, w_h, B, A, H, row0, col0);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + wm * 16 + hf * 8 + lane / 4;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = col0 + wn * 16 + j * 8 + (lane % 4) * 2 + u;
        if (col < A) hw[(size_t)row * A + col] = __float2bfloat16(acc[j][hf * 2 + u]);
      }
  }
}

// ---- attend_mem_kernel: scores, softmax, context ----------------------------
constexpr int kMaxGroup = 8;                  // rows of a memory served together
// Shared memory a block at most, for the blocks an SM that the registers allow: four with one row a
// group, three with more (228 KB an SM, 1 KB of it reserved a block).
int smem_target(int group) { return group == 1 ? 56 * 1024 - 256 : 75 * 1024 - 256; }
// Items (VEC columns of one slot of U) a lane loads in a batch: a batch is used while the next
// one loads.  One row a memory: 4 (8 was slower: registers); more rows: 1 (each U value feeds a
// tanh chain a row, and the tanh work, not the loads, sets the pace).
template <int kGroup> constexpr int kBatch = kGroup == 1 ? 4 : 1;
// bf16 rows of whole 16-byte groups: U, hw and v stay bf16 pairs in registers and shared memory.
template <typename T, bool kVec> constexpr bool kPacked = sizeof(T) == 2 && kVec;
template <typename T, bool kVec> using Hs = std::conditional_t<kPacked<T, kVec>, bf16, float>;

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// 16-byte asynchronous copy global -> shared, marked evict-first in L2.
__device__ __forceinline__ void cp_async_16_evict_first(void* dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(i2l::smem_u32(dst)),
               "l"(src), "l"(policy));
}

// VEC consecutive values of U from p as float32, one streaming (evict-first)
// load where they make 16 bytes (the caller has checked the alignment).
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

// One item of U in registers as loaded (streaming, evict-first): bf16 pairs where packed, else
// float32.
template <typename T, int VEC, bool kP>
struct UItem {
  float f[VEC];
  __device__ __forceinline__ void load(const T* __restrict__ p) { load_f<T, VEC>(p, f); }
};
template <>
struct UItem<bf16, 4, true> {
  uint2 w;
  __device__ __forceinline__ void load(const bf16* __restrict__ p) { w = __ldcs(reinterpret_cast<const uint2*>(p)); }
};

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t w) { return *reinterpret_cast<__nv_bfloat162*>(&w); }

// sum_j round(round(tanh(round(x_j + hw_j))) v_j) over an item's columns, from zero, in order.
// bf16 pairs: round(x + hw) is add.bf16x2 (both are bf16, so the float32 sum rounds to the same
// bf16), round(e v) is mul.bf16x2 (the product of two bf16 is exact in float32); tanhf and the
// sums are float32.
__device__ __forceinline__ void energy_pair(uint32_t xw, uint32_t hw, uint32_t vw, float& sum) {
  const float2 z = __bfloat1622float2(__hadd2(as_bf162(xw), as_bf162(hw)));
  const __nv_bfloat162 e = __floats2bfloat162_rn(tanhf(z.x), tanhf(z.y));
  const float2 q = __bfloat1622float2(__hmul2(e, as_bf162(vw)));
  sum += q.x;
  sum += q.y;
}

__device__ __forceinline__ float item_energy(const UItem<bf16, 4, true>& x, const bf16* hw, const bf16* v) {
  const uint2 h = *reinterpret_cast<const uint2*>(hw);
  const uint2 vv = *reinterpret_cast<const uint2*>(v);
  float sum = 0.f;
  energy_pair(x.w.x, h.x, vv.x, sum);
  energy_pair(x.w.y, h.y, vv.y, sum);
  return sum;
}

template <typename T, int VEC>
__device__ __forceinline__ float item_energy(const UItem<T, VEC, false>& x, const float* hw, const float* v) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float e = i2l::round_to<T>(tanhf(i2l::round_to<T>(x.f[j] + hw[j])));
    sum += i2l::round_to<T>(e * v[j]);
  }
  return sum;
}

// The next N items of a warp's U into x, from the cursor (ls, lc), which moves on: chunks of a
// slot in order, then the warp's next slot.
template <typename T, int VEC, typename Item, int N>
__device__ __forceinline__ void load_batch(Item (&x)[N], const T* __restrict__ u_m, int& ls, int& lc, int S,
                                           int nc, int lane, int A) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int a0 = lc * 32 * VEC + lane * VEC;
    if (ls < S && a0 < A) x[k].load(u_m + (size_t)ls * A + a0);
    if (++lc == nc) {
      lc = 0;
      ls += kWarps;
    }
  }
}

using i2l::warp_max;
using i2l::warp_sum;

// Slots s0 .. s0 + ns - 1 of a memory row into shared memory: 16-byte
// asynchronous copies (kVec: E a multiple of 16 bytes, base aligned), else
// element by element.  The caller commits and waits.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_mem(T* memt, const T* __restrict__ mem_m, int s0, int ns, int E,
                                          uint64_t policy) {
  const T* src = mem_m + (size_t)s0 * E;
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    const int n = ns * E / kPer;
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async_16_evict_first(memt + i * kPer, src + i * kPer, policy);
  } else {
    const int n = ns * E;
    for (int i = threadIdx.x; i < n; i += kThreads) memt[i] = __ldcs(src + i);
  }
}

// Shared memory of attend_mem_kernel, in this order: the memory tile (T, ST x E, padded to 16
// bytes); the group's hw (kGroup x A) and v (A), as Hs; then floats: the scores / weights
// (kGroup x S) and, where the memory takes more than one tile, the context's running sums
// (kGroup x E).  The whole memory row is one tile where the block stays within smem_target;
// else the tile is cut to fit it.
struct MemLayout {
  int slots_a_tile;  // ST
  size_t tile_bytes, bytes;
};

MemLayout mem_layout(int S, int E, int A, int group, int elem, int hs_elem) {
  const size_t row = (size_t)E * elem;
  size_t other = (size_t)hs_elem * ((size_t)group * A + A) + sizeof(float) * (size_t)group * S;
  MemLayout l{};
  l.slots_a_tile = S;
  const size_t target = (size_t)smem_target(group);
  if (((size_t)S * row + 15) / 16 * 16 + other > target) {
    other += sizeof(float) * (size_t)group * E;
    const size_t room = other < target ? target - other : 0;
    const size_t fit = room / row;
    l.slots_a_tile = fit < 1 ? 1 : fit < (size_t)S ? (int)fit : S;
  }
  l.tile_bytes = ((size_t)l.slots_a_tile * row + 15) / 16 * 16;
  l.bytes = l.tile_bytes + other;
  return l;
}

template <typename HS, typename T>
__device__ __forceinline__ HS to_hs(T v) {
  if constexpr (sizeof(HS) == 4) {
    return i2l::to_f(v);
  } else {
    return v;
  }
}

// One block a memory row m, serving rows m R .. m R + R - 1 (R = rows_per_mem) in groups of
// kGroup.  VEC: U values a lane loads at once (4 where kVec: rows of whole 16-byte groups and
// aligned bases; else 1).  Each (row, slot)'s score is summed in one order whatever the group
// size, so a row's context does not depend on how many rows share its memory.
template <typename T, int VEC, bool kVec, int kGroup>
__global__ void __launch_bounds__(kThreads, kGroup == 1 ? 4 : 3) attend_mem_kernel(
    const T* __restrict__ hw, const T* __restrict__ v, const T* __restrict__ u,
    const T* __restrict__ mem, T* __restrict__ ctx, int S, int E, int A, int R, int ST, int tile_bytes) {
  using HS = Hs<T, kVec>;
  using Item = UItem<T, VEC, kPacked<T, kVec>>;
  constexpr int NB = kBatch<kGroup>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* memt = reinterpret_cast<T*>(smem_raw);
  HS* hw_s = reinterpret_cast<HS*>(smem_raw + tile_bytes);
  HS* v_s = hw_s + kGroup * A;
  float* sc = reinterpret_cast<float*>(v_s + A);
  float* cpart = sc + kGroup * S;  // only where ST < S
  const int m = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const T* u_m = u + (size_t)m * S * A;
  const T* mem_m = mem + (size_t)m * S * E;
  const uint64_t policy = evict_first_policy();

  int loaded = -1;  // first slot of the memory tile in (or on its way to) shared memory; -1: none
  for (int a = tid; a < A; a += kThreads) v_s[a] = to_hs<HS>(v[a]);

  const int nc = (A + 32 * VEC - 1) / (32 * VEC);  // chunks of 32 VEC columns a slot
  for (int g0 = 0; g0 < R; g0 += kGroup) {
    const int nr = R - g0 < kGroup ? R - g0 : kGroup;
    const size_t b0 = (size_t)m * R + g0;  // the group's first row
    __syncthreads();  // the previous group is done with hw_s and sc
    for (int i = tid; i < kGroup * A; i += kThreads)
      hw_s[i] = i < nr * A ? to_hs<HS>(hw[b0 * A + i]) : to_hs<HS>(i2l::from_f<T>(0.f));
    __syncthreads();

    // scores: warp w takes slots w, w + kWarps, ...; lane l columns c 32 VEC + l VEC ..  The
    // items of a warp come NB at a time, the next batch's loads issued before the current one
    // is used; a batch's energies are straight-line code over every row of the group (rows past
    // the group's end compute on zeros and are dropped), summed an (item, row) at a time, then
    // added to the slot's running sums in order.
    float acc[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) acc[r] = 0.f;
    Item x[NB], xn[NB];
    int ls = warp, lc = 0;  // the next item to load
    int cs = warp, cc = 0;  // the next item to use
    load_batch<T, VEC>(x, u_m, ls, lc, S, nc, lane, A);
    while (cs < S) {  // the same for the whole warp
      load_batch<T, VEC>(xn, u_m, ls, lc, S, nc, lane, A);
      if (loaded < 0 && cs >= S / 2) {  // halfway: the memory's first tile streams in from here
        stage_mem<T, kVec>(memt, mem_m, 0, ST, E, policy);
        i2l::cp_async_commit();
        loaded = 0;
      }
      int is[NB], ic[NB];  // the batch's items: slot, chunk
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        is[k] = cs;
        ic[k] = cc;
        if (++cc == nc) {
          cc = 0;
          cs += kWarps;
        }
      }
      float part[NB][kGroup];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int a0 = ic[k] * 32 * VEC + lane * VEC;
        const bool on = is[k] < S && a0 < A;  // A % VEC == 0: a lane's VEC columns are all in or all out
        const int ac = on ? a0 : 0;
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float e = item_energy(x[k], hw_s + r * A + ac, v_s + ac);
          part[k][r] = on ? e : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (is[k] >= S) break;  // the same for the whole warp
#pragma unroll
        for (int r = 0; r < kGroup; ++r) acc[r] += part[k][r];
        if (ic[k] == nc - 1) {  // the slot's last chunk: its scores are whole
#pragma unroll
          for (int r = 0; r < kGroup; ++r) {
            const float tot = warp_sum(acc[r]);
            if (lane == 0) sc[r * S + is[k]] = tot;
            acc[r] = 0.f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) x[k] = xn[k];
    }
    if (loaded < 0) {  // a warp whose loop ended before it looked halfway, or had no slots
      stage_mem<T, kVec>(memt, mem_m, 0, ST, E, policy);
      i2l::cp_async_commit();
      loaded = 0;
    }
    __syncthreads();

    // softmax over the S slots, float32, a row a warp
    for (int r = warp; r < nr; r += kWarps) {
      float* row = sc + r * S;
      float mx = -3.402823466e+38f;
      for (int s = lane; s < S; s += 32) mx = fmaxf(mx, row[s]);
      mx = warp_max(mx);
      float z = 0.f;
      for (int s = lane; s < S; s += 32) {
        const float e = expf(row[s] - mx);
        row[s] = e;
        z += e;
      }
      z = warp_sum(z);
      for (int s = lane; s < S; s += 32) row[s] = i2l::round_to<T>(row[s] / z);
    }

    // context, a tile of slots at a time
    for (int s0 = 0; s0 < S; s0 += ST) {
      const int ns = S - s0 < ST ? S - s0 : ST;
      if (loaded != s0) {
        __syncthreads();  // everyone is done with the tile in shared memory
        stage_mem<T, kVec>(memt, mem_m, s0, ns, E, policy);
        i2l::cp_async_commit();
        loaded = s0;
      }
      i2l::cp_async_wait<0>();
      __syncthreads();  // the tile and the weights are in place
      // a thread sums columns t, t + kThreads, ... of every row of the group, slot by slot
      for (int e = tid; e < E; e += kThreads) {
        float cx[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) cx[r] = s0 == 0 || r >= nr ? 0.f : cpart[r * E + e];
        for (int s = 0; s < ns; ++s) {
          const float xm = i2l::to_f(memt[s * E + e]);
#pragma unroll
          for (int r = 0; r < kGroup; ++r) cx[r] += i2l::round_to<T>(sc[r * S + s0 + s] * xm);
        }
        if (s0 + ns == S) {
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r < nr) ctx[(b0 + r) * E + e] = i2l::from_f<T>(cx[r]);
        } else {
#pragma unroll
          for (int r = 0; r < kGroup; ++r)
            if (r < nr) cpart[r * E + e] = cx[r];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool vec_rows(int A, int E, const void* u, const void* mem) {
  return A % 8 == 0 && E % 8 == 0 && aligned16(u) && aligned16(mem);
}

// Rows a group: bf16 with 16-byte rows (the main path) takes an instantiation for every
// rows_per_mem up to kMaxGroup, so that no row is computed in vain; float32 and the guarded path
// take groups of 1 or kMaxGroup.
int group_of(int R, bool exact) { return R == 1 ? 1 : exact && R < kMaxGroup ? R : kMaxGroup; }

template <typename T, int VEC, bool kVec, int G>
cudaError_t launch_group(const void* hw, const void* v, const void* u, const void* mem, void* ctx, int B, int S,
                         int E, int A, int R, cudaStream_t stream) {
  const MemLayout l = mem_layout(S, E, A, G, (int)sizeof(T), (int)sizeof(Hs<T, kVec>));
  if (l.slots_a_tile < 1 || l.bytes > 227 * 1024) return cudaErrorInvalidValue;
  static bool done[16] = {};
  auto kernel = attend_mem_kernel<T, VEC, kVec, G>;
  const cudaError_t err = i2l::allow_dynamic_smem(kernel, 227 * 1024, done);
  if (err != cudaSuccess) return err;
  kernel<<<B / R, kThreads, l.bytes, stream>>>(static_cast<const T*>(hw), static_cast<const T*>(v),
                                              static_cast<const T*>(u), static_cast<const T*>(mem),
                                              static_cast<T*>(ctx), S, E, A, R, l.slots_a_tile,
                                              (int)l.tile_bytes);
  return cudaGetLastError();
}

template <typename T, int VEC, bool kVec>
cudaError_t launch_attend(const void* hw, const void* v, const void* u, const void* mem, void* ctx, int B, int S,
                          int E, int A, int R, cudaStream_t stream) {
  constexpr bool kExact = sizeof(T) == 2 && kVec;
#define I2L_GROUP(G) \
  case G:            \
    return launch_group<T, VEC, kVec, G>(hw, v, u, mem, ctx, B, S, E, A, R, stream);
  if constexpr (kExact) {
    switch (group_of(R, true)) {
      I2L_GROUP(1) I2L_GROUP(2) I2L_GROUP(3) I2L_GROUP(4) I2L_GROUP(5) I2L_GROUP(6) I2L_GROUP(7) I2L_GROUP(8)
    }
  } else {
    switch (group_of(R, false)) { I2L_GROUP(1) I2L_GROUP(8) }
  }
#undef I2L_GROUP
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* h, const void* w_h, const void* v, const void* u, const void* mem, void* hw,
                   void* ctx, int B, int S, int E, int H, int A, int R, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    dim3 grid((A + P_BN - 1) / P_BN, (B + P_BM - 1) / P_BM);
    attend_hw_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const float*>(h), static_cast<const float*>(w_h),
                                                    static_cast<float*>(hw), B, H, A);
    err = cudaGetLastError();
  } else {
    namespace tl = i2l::tile;
    static bool done[2][16] = {};
    const bool aligned = H % 8 == 0 && A % 8 == 0 && aligned16(h) && aligned16(w_h);
    auto kernel = aligned ? attend_hw_tc_kernel<true> : attend_hw_tc_kernel<false>;
    err = i2l::allow_dynamic_smem(kernel, tl::kSmemBytes, done[aligned]);
    if (err != cudaSuccess) return err;
    dim3 grid((A + tl::kBN - 1) / tl::kBN, (B + tl::kBM - 1) / tl::kBM);
    kernel<<<grid, tl::kThreads, tl::kSmemBytes, stream>>>(static_cast<const bf16*>(h), static_cast<const bf16*>(w_h),
                                                            static_cast<bf16*>(hw), B, H, A);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  // 8- or 16-byte loads of U, and 16-byte copies of the memory, need rows of
  // whole 16-byte groups and 16-byte aligned bases.
  const bool vec = vec_rows(A, E, u, mem);
  return vec ? launch_attend<T, 4, true>(hw, v, u, mem, ctx, B, S, E, A, R, stream)
             : launch_attend<T, 1, false>(hw, v, u, mem, ctx, B, S, E, A, R, stream);
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
      B % rows_per_mem != 0 || (B + P_BM - 1) / P_BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)launch<float>(h, w_h, v, u, mem, hw, ctx, B, S, E, H, A, rows_per_mem, s);
  if (dtype == i2l::kBF16)
    return (int)launch<__nv_bfloat16>(h, w_h, v, u, mem, hw, ctx, B, S, E, H, A, rows_per_mem, s);
  return (int)cudaErrorInvalidValue;
}

// The attention kernel's launch for B rows over memories of S slots (16-byte aligned operands):
// dims = blocks, rows a group, slots a shared-memory tile; returns its dynamic shared memory a
// block, bytes.
extern "C" int i2l_attend_launch_shape(int B, int S, int E, int A, int rows_per_mem, int dtype, int* dims) {
  const bool packed = dtype == i2l::kBF16 && A % 8 == 0 && E % 8 == 0;  // u and mem 16-byte aligned
  const int group = group_of(rows_per_mem, packed);
  const MemLayout l = mem_layout(S, E, A, group, dtype == i2l::kF32 ? 4 : 2, packed ? 2 : 4);
  dims[0] = B / rows_per_mem;
  dims[1] = group;
  dims[2] = l.slots_a_tile;
  return (int)l.bytes;
}
