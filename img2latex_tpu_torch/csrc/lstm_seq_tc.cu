// One LSTM layer's recurrence over a whole sequence, for training, in bf16 on Hopper: a
// cluster-persistent forward, a cluster-persistent backward recurrence and a tensor-core dW_hh.
//
// Replaces, for bf16, the TPU kernels of img2latex_tpu/ops/pallas/lstm_train.py::lstm_seq_pallas:
// the forward (pl.pallas_call at line 103, _fwd_kernel :63) and the backward (pl.pallas_call at
// line 205, _bwd_kernel :131, whose body also sums dW_hh at :169-175).  float32 keeps the per-step
// CUDA-core kernels of lstm_seq.cu (the exactness oracle), and so does a bf16 width whose slice
// does not fit in shared memory (ops/lstm_train.py::seq_plan names the route).  The rounding
// points are the TPU kernels', as in lstm_seq.cu:
//
//   forward   g = h @ W_hh + gx_t summed in float32, the gates in float32; h and c rounded to
//             bf16 between steps; ys, cs and the activated gates ga stored in bf16.
//   backward  dh and dc carried in float32; dpre rounded to bf16 before dh = dpre @ W_hh^T and
//             before dW_hh; dW_hh summed in float32, then cast; dhT joins dys[T-1] in bf16 (the
//             wrapper passes that sum as dy_last).
//   Each tensor-core stage of at most 64 products is summed from zero and added to the float32
//   sums in IEEE arithmetic (tile_mma.cuh's scheme), since the tensor cores' additions truncate.
//
// Design.  The rows of a batch tile depend only on each other, so one thread-block cluster owns
// R rows (16 or 32: one or two m16 tiles) for all T steps and no barrier spans the grid: clusters
// never wait on each other, and a batch with more row tiles than co-resident clusters runs in
// waves.  An H100 holds 7 clusters of 16 blocks at one block an SM (cudaOccupancyMaxActiveClusters;
// 14 where two fit), so seq_plan takes 32 rows where they run in fewer waves than 16; at H = 512,
// B = 128 that is one wave of 4 clusters instead of two of 8.  The C blocks of a cluster split the H hidden units, U = H / C each (C <=
// 16, the non-portable maximum; U a multiple of 8, at most 40), so a block owns the 4U gate
// columns of its units:
//
//   lstm_seq_fwd_tc_kernel  a block copies its columns of W_hh^T (H x 4U, k-major) into shared
//     memory once and keeps them for all T steps (128 KB at H = 512).  A step is (R x H) @
//     (H x 4U) on the tensor cores (mma.sync m16n8k16, h_{t-1} as A from shared memory, the
//     resident slice as B through ldmatrix.trans): a warp takes 8 units and one m16 tile, its
//     four n8 tiles the four gates of those units (lstm_layer_step_tc_kernel's layout), so the cell
//     update runs in registers, c stays in registers (rounded to bf16 each step) and gx_{t+1} is
//     loaded into registers while the block waits at the cluster barrier.  The block's bf16 h_t
//     slice goes into every cluster block's h buffer through distributed shared memory, then one
//     cluster barrier (arrive.release / wait.acquire) a step; the h buffer is doubled where it fits,
//     else single with a second barrier, whose arrive follows the product and whose wait precedes
//     the writes (H = 640).
//   lstm_seq_bwd_tc_kernel  a block computes the gate gradients of its units from dh, keeping the
//     float32 dc of its rows x U units in registers, so it holds dpre_t for its 4U gate columns.
//     The product dh_{t-1} = dpre_t @ W_hh is split by depth: the block multiplies its own dpre
//     slice (R x 4U, local) by its 4U rows of W_hh (4U x H, resident) into float32 partials of dh
//     for all H units and sends each block the columns of its units through distributed shared
//     memory, where they are summed in rank order.  The partials' buffer is doubled where it fits
//     (one cluster barrier a step), else single (32 rows at H = 512) with a second barrier around
//     the cell update.  dgates_x[t] goes to device memory; the operands of the next step (dys, ga,
//     cs, c_prev) are loaded into registers while the block waits.  A last sum gives dh0.
//   lstm_seq_dw_tc_kernel  dW_hh = dgates_x^T @ [h0; ys[:-1]] over all T*B rows after the
//     recurrence: 128 x 128 output tiles, 8 warps of 64 x 32, both operands staged untouched by
//     cp.async (dgates_x through ldmatrix.trans as A), the rows split into chunks that each leave
//     a float32 partial, then lstm_seq_dw_tc_reduce_kernel sums the partials in a fixed order and
//     casts, so the result is the same from run to run.
//
// Rows of W_hh's slices are stored without padding (H = 640's forward slice, 200 KB, would not fit
// with it) and their 16-byte chunks XOR-swizzled by row (swz), so that the 8 rows an ldmatrix
// phase reads fall in 8 distinct bank groups; the h buffers' and dpre slices' rows are padded by
// 16 bytes.
//
// Bound (H100 SXM, bf16, T = 140, B = 128, H = 512, one layer): the forward moves ~186 MB (gx
// read; ys, cs, ga written; 0.055 ms) for 37.6 GFLOP (0.038 ms); the backward 75 GFLOP (0.076 ms)
// and ~222 MB.  The recurrence is serial over T: what holds these kernels is a step's latency
// chain (the product, the cell update, the distributed shared memory exchange and the cluster
// barrier), 140 times; scripts/lstm_seq_parts.py times a step with parts removed.
#include <cooperative_groups.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"
#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int P_STAGE = 64;       // products a tensor-core stage sums from zero
constexpr int P_BWD_THREADS = 256;
constexpr int P_BWD_WARPS = P_BWD_THREADS / 32;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Rows a forward block's h buffer holds, and the depth of its product: H rounded up to a stage.
__host__ __device__ constexpr int fwd_depth(int H) { return round_up(H, P_STAGE); }

// Dynamic shared memory of a block, bytes (ops/lstm_train.py::_fwd_smem / _bwd_smem agree).
int fwd_smem(int H, int U, int R, int nbuf) {
  const int K = fwd_depth(H);
  return 2 * (K * 4 * U + nbuf * R * (K + 8) + R * U);
}
int bwd_smem(int H, int U, int R, int nbuf) { return 2 * (4 * U * H + R * (4 * U + 8)) + 4 * nbuf * R * H; }

// The chunk a 16-byte chunk c of row r is stored at, in rows of pw 4-byte words: the 8 rows an
// ldmatrix phase reads at one chunk then start in 8 distinct groups of 4 banks.  The XOR stays
// inside an aligned group of 8, 4 or 2 chunks, which the row always holds whole.
__host__ __device__ constexpr int swz(int pw, int r, int c) {
  return pw % 32 == 0 ? c ^ (r & 7)
         : pw % 32 == 16 ? c ^ ((r >> 1) & 3)
         : (pw % 32 == 8 || pw % 32 == 24) ? c ^ ((r >> 2) & 1)
         : c;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float lo_f(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);  // round to nearest even, a in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ void st32(bf16* p, uint32_t v) { *reinterpret_cast<uint32_t*>(p) = v; }

__device__ __forceinline__ void zero_smem(bf16* p, int elems, int tid, int nthreads) {
  for (int e = tid * 8; e < elems; e += nthreads * 8) *reinterpret_cast<uint4*>(p + e) = make_uint4(0, 0, 0, 0);
}

// ---- forward ------------------------------------------------------------------------------
// Grid (C, ceil(B / R)), clusters of C blocks along x, R = 16 MT rows a cluster; 4 U MT threads, a
// warp per 8 units and m16 tile.  gx (T, B, 4H); h0, c0 (B, H); w_t = W_hh^T (H, 4H); ys, cs
// (T, B, H); ga (T, B, 4H).
template <int U, int MT>
__global__ void __launch_bounds__(4 * U * MT) lstm_seq_fwd_tc_kernel(
    const bf16* __restrict__ gx, const bf16* __restrict__ h0, const bf16* __restrict__ c0,
    const bf16* __restrict__ w_t, bf16* __restrict__ ys, bf16* __restrict__ cs, bf16* __restrict__ ga,
    int T, int B, int H, int nbuf) {
  constexpr int NT = 4 * U * MT;
  constexpr int R = 16 * MT;
  constexpr int WN = 4 * U;   // gate columns of the block: the row length of Ws
  constexpr int WPW = WN / 2;  // ... in 4-byte words
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int K = fwd_depth(H), HP = K + 8;
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);  // [K][WN], column n = gate (n / U), unit n % U
  bf16* hbuf = Ws + (size_t)K * WN;              // [nbuf][R][HP]
  bf16* hs = hbuf + nbuf * R * HP;               // [R][U]: this block's new h
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, q = lane % 4;
  const int ug = warp % (U / 8), mi = warp / (U / 8);  // this warp's 8 units and m16 tile
  const int j0 = rank * U, row0 = blockIdx.y * R, G = 4 * H;
  const int ju = j0 + ug * 8 + 2 * q;  // this lane's units ju, ju + 1; its rows row0 + 16 mi + 8 hf + g

  for (int e = tid; e < K * (WN / 8); e += NT) {
    const int k = e / (WN / 8), c = e % (WN / 8), n = c * 8;
    const bool ok = k < H;
    i2l::cp_async_16(Ws + k * WN + swz(WPW, k, c) * 8, ok ? w_t + (size_t)k * G + (n / U) * H + j0 + n % U : w_t, ok);
  }
  for (int e = tid; e < R * (K / 8); e += NT) {
    const int r = e / (K / 8), kc = (e % (K / 8)) * 8, row = row0 + r;
    const bool ok = row < B && kc < H;
    i2l::cp_async_16(hbuf + r * HP + kc, ok ? h0 + (size_t)row * H + kc : h0, ok);
  }
  i2l::cp_async_commit();
  if (nbuf == 2) zero_smem(hbuf + R * HP, R * HP, tid, NT);  // its columns past H stay 0

  float c[2][2];
  uint32_t gxr[2][4];  // [row half][gate]: gx of units ju, ju + 1, bf16 pairs
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + 16 * mi + 8 * hf + g;
#pragma unroll
    for (int u = 0; u < 2; ++u) c[hf][u] = row < B ? i2l::to_f(c0[(size_t)row * H + ju + u]) : 0.f;
  }
  auto load_gx = [&](int t) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 16 * mi + 8 * hf + g;
      const bf16* src = gx + ((size_t)t * B + row) * G + ju;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) gxr[hf][gate] = row < B ? ld32(src + gate * H) : 0u;
    }
  };
  load_gx(0);
  i2l::cp_async_wait<0>();
  __syncthreads();
  cluster.sync();  // every block of the cluster has started and set up before any remote write

  for (int t = 0; t < T; ++t) {
    const bf16* A = hbuf + (t % nbuf) * R * HP + 16 * mi * HP;
    float acc[4][4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[gate][e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += P_STAGE) {
      float part[4][4];  // this stage's sums, from zero
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[gate][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < P_STAGE; kk += 16) {
        const int k = k0 + kk, kr = k + lane % 8 + ((lane / 8) % 2) * 8;
        uint32_t a[4], b[2][4];
        i2l::ldmatrix_x4(a, A + (lane % 16) * HP + k + (lane / 16) * 8);
#pragma unroll
        for (int p = 0; p < 2; ++p)  // gates 2p and 2p + 1 of this warp's 8 units
          i2l::ldmatrix_x4_trans(b[p], Ws + kr * WN + swz(WPW, kr, (2 * p + lane / 16) * (U / 8) + ug) * 8);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          i2l::mma_bf16_16816(part[gate], a, b[gate / 2][(gate % 2) * 2], b[gate / 2][(gate % 2) * 2 + 1]);
      }
#pragma unroll
      for (int gate = 0; gate < 4; ++gate)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gate][e] += part[gate][e];
    }
    if (nbuf == 1) cluster_arrive();  // this block is done reading the one h buffer

    // Cell update, gate order (i, f, g, o): fragment e = 2 hf + u is row 16 mi + 8 hf + g, unit ju + u.
    uint32_t yv[2], cv[2], av[2][4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float h2[2], c2[2], gv[4][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int e = 2 * hf + u;
        float x[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          x[gate] = acc[gate][e] + (u == 0 ? lo_f(gxr[hf][gate]) : hi_f(gxr[hf][gate]));
        gv[0][u] = sigmoidf_(x[0]);
        gv[1][u] = sigmoidf_(x[1]);
        gv[2][u] = tanhf(x[2]);
        gv[3][u] = sigmoidf_(x[3]);
        c2[u] = gv[1][u] * c[hf][u] + gv[0][u] * gv[2][u];
        h2[u] = gv[3][u] * tanhf(c2[u]);
      }
      yv[hf] = pack2(h2[0], h2[1]);
      cv[hf] = pack2(c2[0], c2[1]);
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) av[hf][gate] = pack2(gv[gate][0], gv[gate][1]);
      c[hf][0] = lo_f(cv[hf]);  // the carry rounded to bf16, as the TPU kernel's c_scr
      c[hf][1] = hi_f(cv[hf]);
      st32(hs + (16 * mi + 8 * hf + g) * U + ug * 8 + 2 * q, yv[hf]);
    }
    if (nbuf == 1) cluster_wait();  // every block is done reading it
    __syncthreads();
    if (t + 1 < T) {  // this block's h_t slice into every block's next buffer
      bf16* nxt = hbuf + ((t + 1) % nbuf) * R * HP;
      constexpr int PER_RANK = R * (U / 8);
      for (int e = tid; e < C * PER_RANK; e += NT) {
        const int dst = e / PER_RANK, r = (e % PER_RANK) / (U / 8), ch = e % (U / 8);
        const uint4 v = *reinterpret_cast<const uint4*>(hs + r * U + ch * 8);
        bf16* remote = cluster.map_shared_rank(nxt, dst);
        *reinterpret_cast<uint4*>(remote + r * HP + j0 + ch * 8) = v;
      }
    }
    cluster_arrive();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + 16 * mi + 8 * hf + g;
      if (row >= B) continue;
      const size_t o = ((size_t)t * B + row) * H + ju;
      st32(ys + o, yv[hf]);
      st32(cs + o, cv[hf]);
      bf16* a_out = ga + ((size_t)t * B + row) * G + ju;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) st32(a_out + gate * H, av[hf][gate]);
    }
    if (t + 1 < T) load_gx(t + 1);
    cluster_wait();
  }
}

// ---- backward recurrence --------------------------------------------------------------------
// Grid (C, ceil(B / R)), clusters of C blocks along x, R = 16 MT rows a cluster; 256 threads.
// dys (T, B, H); dy_last (B, H) = dys[T-1] + dhT in bf16; dcT (B, H); ga (T, B, 4H); cs (T, B, H);
// c0 (B, H); w = W_hh (4H, H); dgx (T, B, 4H), dh0, dc0 (B, H) out.
//
// A block owns the units j0 .. j0 + U: it computes their gate gradients, so it holds dpre_t for
// its 4U gate columns {gate H + j0 + u} itself.  The product dh_{t-1} = dpre_t @ W_hh is then
// split by depth instead of by output: the block multiplies its own 16 x 4U slice of dpre_t (in
// shared memory, no exchange) by its 4U rows of W_hh (4U x H, resident) into a float32 partial of
// dh for all H units, and sends each block the 16 x U columns of its units (distributed shared
// memory; double-buffered, one cluster barrier a step, else a second barrier between the reads
// of the partials and the next writes).  A block sums the C partials of its units in rank order, so
// the sums are the same from run to run.
template <int U, int MT>
__global__ void __launch_bounds__(P_BWD_THREADS) lstm_seq_bwd_tc_kernel(
    const bf16* __restrict__ dys, const bf16* __restrict__ dy_last, const bf16* __restrict__ dcT,
    const bf16* __restrict__ ga, const bf16* __restrict__ cs, const bf16* __restrict__ c0,
    const bf16* __restrict__ w, bf16* __restrict__ dgx, bf16* __restrict__ dh0, bf16* __restrict__ dc0,
    int T, int B, int H, int nbuf) {
  constexpr int NT = P_BWD_THREADS, NW = P_BWD_WARPS;
  constexpr int R = 16 * MT;
  constexpr int KD = 4 * U;                  // depth of the block's product: its gate columns
  constexpr int AP = KD + 8;                 // row pitch of its dpre slice
  constexpr int NPAIR = R * U / 2;           // (row, unit pair)s of the block
  constexpr int PP = (NPAIR + NT - 1) / NT;  // ... a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  bf16* Wg = reinterpret_cast<bf16*>(smem_raw);  // [KD][H]: row gate U + u = W_hh[gate H + j0 + u, :], swizzled
  bf16* ds = Wg + (size_t)KD * H;                // [R][AP]: dpre_t of the block's gate columns
  float* recv = reinterpret_cast<float*>(ds + R * AP);  // [nbuf][C][R][U]: partial dh from each rank
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, q = lane % 4;
  const int j0 = rank * U, row0 = blockIdx.y * R, G = 4 * H, pw = H / 2, ntile = H / 8;

  for (int e = tid; e < KD * ntile; e += NT) {
    const int k = e / ntile, c = e % ntile;
    i2l::cp_async_16(Wg + (size_t)k * H + swz(pw, k, c) * 8, w + (size_t)((k / U) * H + j0 + k % U) * H + c * 8, true);
  }
  i2l::cp_async_commit();

  // A thread's pairs: p = tid + i NT, row p / (U / 2), units 2 (p % (U / 2)) and + 1.
  float dc[PP][2], dhv[PP][2];
  uint32_t dyr[PP], gar[PP][4], csr[PP], cpr[PP];
  auto pair_row = [&](int i) { return (tid + i * NT) / (U / 2); };
  auto pair_unit = [&](int i) { return j0 + 2 * ((tid + i * NT) % (U / 2)); };
  auto pair_ok = [&](int i) { return tid + i * NT < NPAIR && row0 + pair_row(i) < B; };
#pragma unroll
  for (int i = 0; i < PP; ++i) {
    const size_t o = (size_t)(row0 + pair_row(i)) * H + pair_unit(i);
    const uint32_t v = pair_ok(i) ? ld32(dcT + o) : 0u;
    dc[i][0] = lo_f(v);
    dc[i][1] = hi_f(v);
  }
  auto load_ops = [&](int t) {
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const bool ok = pair_ok(i);
      const size_t row = row0 + pair_row(i), j = pair_unit(i);
      const size_t o = ((size_t)t * B + row) * H + j;
      dyr[i] = ok ? ld32(t == T - 1 ? dy_last + row * H + j : dys + o) : 0u;
      csr[i] = ok ? ld32(cs + o) : 0u;
      cpr[i] = ok ? ld32(t > 0 ? cs + o - (size_t)B * H : c0 + row * H + j) : 0u;
      const bf16* a = ga + ((size_t)t * B + row) * G + j;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) gar[i][gate] = ok ? ld32(a + gate * H) : 0u;
    }
  };
  load_ops(T - 1);
  i2l::cp_async_wait<0>();
  __syncthreads();
  cluster.sync();  // every block of the cluster has started before any remote write
  // The XOR of this lane's ldmatrix row of Wg: its rows are k + lane % 8 + 8 ((lane / 8) % 2) with k a
  // multiple of 16, and swz depends only on the row mod 8.
  const int xr = swz(pw, lane % 8, 0);

  for (int it = 0; it <= T; ++it) {
#pragma unroll
    for (int i = 0; i < PP; ++i) dhv[i][0] = dhv[i][1] = 0.f;
    if (it > 0) {  // dh = the C ranks' partials of this block's units, in rank order
      const float* rb = recv + ((it - 1) % nbuf) * C * R * U;
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        if (tid + i * NT >= NPAIR) continue;
        const int off = pair_row(i) * U + pair_unit(i) - j0;
        for (int src = 0; src < C; ++src) {
          const float2 v = *reinterpret_cast<const float2*>(rb + src * R * U + off);
          dhv[i][0] += v.x;
          dhv[i][1] += v.y;
        }
      }
    }
    if (it == T) {  // dh0 = dpre_0 @ W_hh, dc0 = the carry
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        if (!pair_ok(i)) continue;
        const size_t o = (size_t)(row0 + pair_row(i)) * H + pair_unit(i);
        st32(dh0 + o, pack2(dhv[i][0], dhv[i][1]));
        st32(dc0 + o, pack2(dc[i][0], dc[i][1]));
      }
      break;
    }
    if (nbuf == 1) cluster_arrive();  // this block is done reading the one buffer of partials
    const int t = T - 1 - it;
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      float dp[4][2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        auto half = [&](uint32_t v) { return u == 0 ? lo_f(v) : hi_f(v); };
        const float gi = half(gar[i][0]), gf = half(gar[i][1]), gg = half(gar[i][2]), go = half(gar[i][3]);
        const float tc = tanhf(half(csr[i]));
        const float dh = half(dyr[i]) + dhv[i][u];
        const float d_o = dh * tc;
        const float dcv = dc[i][u] + dh * go * (1.f - tc * tc);
        const float di = dcv * gg, dg = dcv * gi, df = dcv * half(cpr[i]);
        dc[i][u] = dcv * gf;
        dp[0][u] = di * gi * (1.f - gi);
        dp[1][u] = df * gf * (1.f - gf);
        dp[2][u] = dg * (1.f - gg * gg);
        dp[3][u] = d_o * go * (1.f - go);
      }
      if (tid + i * NT >= NPAIR) continue;
      const int r = pair_row(i), jl = pair_unit(i) - j0;
      const bool store = row0 + r < B;
      bf16* out = dgx + ((size_t)t * B + row0 + r) * G + j0 + jl;
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const uint32_t v = pack2(dp[gate][0], dp[gate][1]);
        st32(ds + r * AP + gate * U + jl, v);
        if (store) st32(out + gate * H, v);
      }
    }
    __syncthreads();
    if (nbuf == 1) cluster_wait();  // every block is done reading it

    // The partial dh_{t-1} = dpre_t[:, block's columns] @ W_hh[block's rows, :], four n8 tiles (32
    // units) at a time, each tile sent to the block that owns its units.
    float* slot = recv + (it % nbuf) * C * R * U + rank * R * U;  // this rank's slot, in every block
    for (int t0 = warp * 4; t0 < ntile; t0 += NW * 4) {
      float acc[MT][4][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < KD; k0 += P_STAGE) {
        float part[MT][4][4];  // this stage's sums, from zero
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < P_STAGE; kk += 16) {
          const int k = k0 + kk;
          if (k >= KD) break;
          const int kr = k + lane % 8 + ((lane / 8) % 2) * 8;
          uint32_t a[MT][4];
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) i2l::ldmatrix_x4(a[mi], ds + (16 * mi + lane % 16) * AP + k + (lane / 16) * 8);
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            if (t0 + 2 * p >= ntile) continue;
            uint32_t b[4];
            i2l::ldmatrix_x4_trans(b, Wg + (size_t)kr * H + ((t0 + 2 * p + lane / 16) ^ xr) * 8);
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) {
              i2l::mma_bf16_16816(part[mi][2 * p], a[mi], b[0], b[1]);
              i2l::mma_bf16_16816(part[mi][2 * p + 1], a[mi], b[2], b[3]);
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][n][e] += part[mi][n][e];
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int tile = t0 + n;
          if (tile >= ntile) continue;
          // Lanes q and q ^ 1 trade halves: even q sends row g's 4 columns 2q .. 2q + 3, odd q row
          // g + 8's columns 2q - 2 .. 2q + 1, one 16-byte store each.
          const bool odd = q & 1;
          const float x0 = acc[mi][n][0], x1 = acc[mi][n][1], x2 = acc[mi][n][2], x3 = acc[mi][n][3];
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : x2, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : x3, 1);
          const float4 v = odd ? make_float4(r0, r1, x2, x3) : make_float4(x0, x1, r0, r1);
          const int unit = tile * 8, row = 16 * mi + (odd ? g + 8 : g);
          float* remote = cluster.map_shared_rank(slot, unit / U);
          *reinterpret_cast<float4*>(remote + row * U + unit % U + (odd ? 2 * q - 2 : 2 * q)) = v;
        }
    }
    cluster_arrive();
    if (t > 0) load_ops(t - 1);
    cluster_wait();
  }
}

// ---- dW_hh on the tensor cores --------------------------------------------------------------
constexpr int D_BM = 128;  // gate columns (rows of dW_hh) a block
constexpr int D_BN = 128;  // hidden units (columns of dW_hh) a block
constexpr int D_BK = 64;   // rows (time x batch) a stage: the products summed from zero
constexpr int D_STAGES = 3;
constexpr int D_THREADS = 256;  // 8 warps as 2 (gate columns, 64 each) x 4 (units, 32 each)
constexpr int D_PITCH = 128 + 8;
constexpr int D_OP_ELEMS = D_BK * D_PITCH;
constexpr int D_STAGE_ELEMS = 2 * D_OP_ELEMS;
constexpr int D_SMEM = D_STAGES * D_STAGE_ELEMS * (int)sizeof(bf16);  // 104,448
constexpr int D_CHUNKS = D_BK * (D_BM / 8) / D_THREADS;               // 16-byte chunks an operand, a thread
static_assert(D_CHUNKS * 8 * D_THREADS == D_BK * D_BM && D_BM == D_BN, "a stage splits evenly");

// Row m of h_prev is h0[m] for m < B, else ys[m - B] (ys is (T, B, H)).
template <bool kAligned>
__device__ __forceinline__ void dw_load_stage(bf16* stage, const bf16* __restrict__ dgx, const bf16* __restrict__ h0,
                                              const bf16* __restrict__ ys, int m0, int m_end, int B, int H,
                                              int n0, int k0) {
  bf16* As = stage;  // [64 rows][128 gate columns]
  bf16* Bs = stage + D_OP_ELEMS;  // [64 rows][128 units]
  const int G = 4 * H, tid = threadIdx.x;
  if (kAligned) {
#pragma unroll
    for (int i = 0; i < D_CHUNKS; ++i) {
      const int e = tid + i * D_THREADS, r = e / (D_BM / 8), cc = (e % (D_BM / 8)) * 8, m = m0 + r;
      const bool oka = m < m_end && n0 + cc < G;
      i2l::cp_async_16(As + r * D_PITCH + cc, oka ? dgx + (size_t)m * G + n0 + cc : dgx, oka);
      const bool okb = m < m_end && k0 + cc < H;
      const bf16* hrow = m < B ? h0 + (size_t)m * H : ys + (size_t)(m - B) * H;
      i2l::cp_async_16(Bs + r * D_PITCH + cc, okb ? hrow + k0 + cc : h0, okb);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll 4
    for (int i = 0; i < D_BK * D_BM / D_THREADS; ++i) {
      const int e = tid + i * D_THREADS, r = e / D_BM, col = e % D_BM, m = m0 + r;
      As[r * D_PITCH + col] = m < m_end && n0 + col < G ? dgx[(size_t)m * G + n0 + col] : zero;
      const bf16* hrow = m < B ? h0 + (size_t)m * H : ys + (size_t)(m - B) * H;
      Bs[r * D_PITCH + col] = m < m_end && k0 + col < H ? hrow[k0 + col] : zero;
    }
  }
}

// Grid (ceil(H / 128), ceil(4H / 128), nsplit): the block's tile of dW_hh over rows
// [z m_per_split, (z + 1) m_per_split) into partial[z] (4H, H) float32.
template <bool kAligned>
__global__ void __launch_bounds__(D_THREADS) lstm_seq_dw_tc_kernel(
    const bf16* __restrict__ dgx, const bf16* __restrict__ h0, const bf16* __restrict__ ys,
    float* __restrict__ partial, int M, int B, int H, int m_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, q = lane % 4, G = 4 * H;
  const int k0 = blockIdx.x * D_BN, n0 = blockIdx.y * D_BM;
  const int m_begin = blockIdx.z * m_per_split, m_end = min(M, m_begin + m_per_split);
  const int ns = m_end > m_begin ? (m_end - m_begin + D_BK - 1) / D_BK : 0;

  float acc[4][4][4];  // [m16 tile: gate columns][n8 tile: units][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s < ns) dw_load_stage<kAligned>(smem + s * D_STAGE_ELEMS, dgx, h0, ys, m_begin + s * D_BK, m_end, B, H, n0, k0);
    i2l::cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    i2l::cp_async_wait<D_STAGES - 2>();
    __syncthreads();
    const int nxt = s + D_STAGES - 1;
    if (nxt < ns)
      dw_load_stage<kAligned>(smem + (nxt % D_STAGES) * D_STAGE_ELEMS, dgx, h0, ys, m_begin + nxt * D_BK, m_end, B,
                              H, n0, k0);
    i2l::cp_async_commit();
    const bf16* As = smem + (s % D_STAGES) * D_STAGE_ELEMS;
    const bf16* Bs = As + D_OP_ELEMS;
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D_BK; kk += 16) {
      uint32_t a[4][4], b[2][4];
      // A = dgx^T: stored [row][gate column], so ldmatrix.trans gives the row-major fragment
#pragma unroll
      for (int i = 0; i < 4; ++i)
        i2l::ldmatrix_x4_trans(a[i], As + (kk + lane % 8 + 8 * (lane / 16)) * D_PITCH + wm * 64 + i * 16 +
                                         8 * ((lane / 8) % 2));
#pragma unroll
      for (int p = 0; p < 2; ++p)
        i2l::ldmatrix_x4_trans(b[p], Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * D_PITCH + wn * 32 + p * 16 +
                                         (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          i2l::mma_bf16_16816(part[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  i2l::cp_async_wait<0>();

  float* out = partial + (size_t)blockIdx.z * G * H;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = n0 + wm * 64 + i * 16 + g + 8 * hf;
      if (n >= G) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int k = k0 + wn * 32 + j * 8 + 2 * q + u;
          if (k < H) out[(size_t)n * H + k] = acc[i][j][2 * hf + u];
        }
    }
}

__global__ void __launch_bounds__(256) lstm_seq_dw_tc_reduce_kernel(const float* __restrict__ partial, int nsplit,
                                                                    long long n_elem, bf16* __restrict__ dw) {
  for (long long idx = (long long)blockIdx.x * 256 + threadIdx.x; idx < n_elem; idx += (long long)gridDim.x * 256) {
    float s = 0.f;
    for (int p = 0; p < nsplit; ++p) s += partial[p * n_elem + idx];
    dw[idx] = __float2bfloat16(s);
  }
}

// ---- launches -------------------------------------------------------------------------------
using FwdKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, bf16*, bf16*, bf16*, int, int, int,
                           int);

template <int MT>
FwdKernel fwd_kernel_mt(int U) {
  switch (U) {
    case 8: return lstm_seq_fwd_tc_kernel<8, MT>;
    case 16: return lstm_seq_fwd_tc_kernel<16, MT>;
    case 24: return lstm_seq_fwd_tc_kernel<24, MT>;
    case 32: return lstm_seq_fwd_tc_kernel<32, MT>;
    case 40: return lstm_seq_fwd_tc_kernel<40, MT>;
    default: return nullptr;
  }
}
using BwdKernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*, const bf16*, const bf16*,
                           const bf16*, bf16*, bf16*, bf16*, int, int, int, int);

// The forward for U units a block and R = 16 or 32 rows a cluster.
FwdKernel fwd_kernel(int U, int R) {
  return R == 16 ? fwd_kernel_mt<1>(U) : R == 32 ? fwd_kernel_mt<2>(U) : nullptr;
}

template <int MT>
BwdKernel bwd_kernel_mt(int U) {
  switch (U) {
    case 8: return lstm_seq_bwd_tc_kernel<8, MT>;
    case 16: return lstm_seq_bwd_tc_kernel<16, MT>;
    case 24: return lstm_seq_bwd_tc_kernel<24, MT>;
    case 32: return lstm_seq_bwd_tc_kernel<32, MT>;
    case 40: return lstm_seq_bwd_tc_kernel<40, MT>;
    default: return nullptr;
  }
}

// The backward recurrence for U units a block and R = 16 or 32 rows a cluster.
BwdKernel bwd_kernel(int U, int R) {
  return R == 16 ? bwd_kernel_mt<1>(U) : R == 32 ? bwd_kernel_mt<2>(U) : nullptr;
}

// The launch of a persistent kernel: grid (C, ceil(B / R)), clusters of C along x.  Sets the
// kernel's shared-memory and cluster-size attributes; a refused launch returns its error.
struct PersistLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cudaSuccess;
  int smem = -1;

  template <typename Kernel>
  PersistLaunch(Kernel kernel, int smem_bytes, int threads, int B, int C, int R, cudaStream_t s) : smem(smem_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && C > 8) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cfg.gridDim = dim3(C, (B + R - 1) / R);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// H = C U with U one of the instantiated widths, C at most 16, R = 16 or 32 rows a cluster, nbuf
// 1 or 2.
bool persist_shape_ok(int B, int H, int C, int R, int nbuf, int dir) {
  if (B <= 0 || H <= 0 || C <= 0 || C > 16 || H % C != 0 || (nbuf != 1 && nbuf != 2)) return false;
  if (dir == 0 ? fwd_kernel(H / C, R) == nullptr : bwd_kernel(H / C, R) == nullptr) return false;
  return (B + R - 1) / R <= 65535;
}

bool aligned16(const void* p) { return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kAligned>
cudaError_t dw_launch(const void* dgx, const void* h0, const void* ys, void* partial, void* dw, int M, int B, int H,
                      int nsplit, cudaStream_t s) {
  auto kernel = lstm_seq_dw_tc_kernel<kAligned>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, D_SMEM);
  if (err != cudaSuccess) return err;
  int m_per_split = (M + nsplit - 1) / nsplit;
  m_per_split = (m_per_split + D_BK - 1) / D_BK * D_BK;
  dim3 grid((H + D_BN - 1) / D_BN, (4 * H + D_BM - 1) / D_BM, nsplit);
  kernel<<<grid, D_THREADS, D_SMEM, s>>>(static_cast<const bf16*>(dgx), static_cast<const bf16*>(h0),
                                         static_cast<const bf16*>(ys), static_cast<float*>(partial), M, B, H,
                                         m_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_elem = 4LL * H * H;
  const int blocks = (int)((n_elem + 255) / 256 < 4096 ? (n_elem + 255) / 256 : 4096);
  lstm_seq_dw_tc_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(partial), nsplit, n_elem,
                                                      static_cast<bf16*>(dw));
  return cudaGetLastError();
}

}  // namespace

// The persistent launch for B rows at width H, C blocks a cluster, R rows a cluster and nbuf
// exchange buffers, dir 0 (forward) or 1 (backward recurrence): returns its dynamic shared memory
// a block in bytes, or -1 when the shape is not one the kernels take; dims[0] receives
// cudaOccupancyMaxActiveClusters for that launch (0 when the query fails), dims[1] the clusters
// the launch has (row tiles), dims[2] the threads a block.
extern "C" int i2l_lstm_seq_persist_shape(int B, int H, int C, int R, int nbuf, int dir, int* dims) {
  if ((dir != 0 && dir != 1) || !persist_shape_ok(B, H, C, R, nbuf, dir)) return -1;
  const int U = H / C;
  const int smem = dir == 0 ? fwd_smem(H, U, R, nbuf) : bwd_smem(H, U, R, nbuf);
  const int threads = dir == 0 ? 4 * U * (R / 16) : P_BWD_THREADS;
  dims[0] = 0;
  dims[1] = (B + R - 1) / R;
  dims[2] = threads;
  int n = 0;
  cudaError_t err;
  if (dir == 0) {
    PersistLaunch l(fwd_kernel(U, R), smem, threads, B, C, R, nullptr);
    err = l.err == cudaSuccess ? cudaOccupancyMaxActiveClusters(&n, fwd_kernel(U, R), &l.cfg) : l.err;
  } else {
    PersistLaunch l(bwd_kernel(U, R), smem, threads, B, C, R, nullptr);
    err = l.err == cudaSuccess ? cudaOccupancyMaxActiveClusters(&n, bwd_kernel(U, R), &l.cfg) : l.err;
  }
  if (err == cudaSuccess) dims[0] = n;
  cudaGetLastError();  // a refused query leaves no error behind
  return smem;
}

// Forward over T steps in one launch, bf16: gx (T, B, 4H); h0, c0 (B, H); w_t = W_hh^T (H, 4H);
// ys, cs (T, B, H) and ga (T, B, 4H) receive every step.  Every pointer 16-byte aligned.
extern "C" int i2l_lstm_seq_fwd_persist(const void* gx, const void* h0, const void* c0, const void* w_t, void* ys,
                                        void* cs, void* ga, int T, int B, int H, int C, int R, int nbuf,
                                        void* stream) {
  if (T <= 0 || !persist_shape_ok(B, H, C, R, nbuf, 0)) return (int)cudaErrorInvalidValue;
  for (const void* p : {gx, h0, c0, w_t, (const void*)ys, (const void*)cs, (const void*)ga})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int U = H / C;
  PersistLaunch l(fwd_kernel(U, R), fwd_smem(H, U, R, nbuf), 4 * U * (R / 16), B, C, R,
                  static_cast<cudaStream_t>(stream));
  if (l.err != cudaSuccess) return (int)l.err;
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, fwd_kernel(U, R), static_cast<const bf16*>(gx), static_cast<const bf16*>(h0),
                                       static_cast<const bf16*>(c0), static_cast<const bf16*>(w_t),
                                       static_cast<bf16*>(ys), static_cast<bf16*>(cs), static_cast<bf16*>(ga), T, B, H,
                                       nbuf);
  const cudaError_t last = cudaGetLastError();  // read (and cleared) either way
  return (int)(err != cudaSuccess ? err : last);
}

// Backward recurrence over T steps in one launch, bf16: dys (T, B, H); dy_last (B, H) = dys[T-1]
// + dhT rounded to bf16; dcT (B, H); ga (T, B, 4H), cs (T, B, H), c0 (B, H) from the forward; w
// = W_hh (4H, H); dgx (T, B, 4H), dh0 and dc0 (B, H) receive dgates_x, dh0 and dc0.
extern "C" int i2l_lstm_seq_bwd_persist(const void* dys, const void* dy_last, const void* dcT, const void* ga,
                                        const void* cs, const void* c0, const void* w, void* dgx, void* dh0, void* dc0,
                                        int T, int B, int H, int C, int R, int nbuf, void* stream) {
  if (T <= 0 || !persist_shape_ok(B, H, C, R, nbuf, 1)) return (int)cudaErrorInvalidValue;
  for (const void* p : {dys, dy_last, dcT, ga, cs, c0, w, (const void*)dgx, (const void*)dh0, (const void*)dc0})
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int U = H / C;
  PersistLaunch l(bwd_kernel(U, R), bwd_smem(H, U, R, nbuf), P_BWD_THREADS, B, C, R, static_cast<cudaStream_t>(stream));
  if (l.err != cudaSuccess) return (int)l.err;
  cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, bwd_kernel(U, R), static_cast<const bf16*>(dys), static_cast<const bf16*>(dy_last),
      static_cast<const bf16*>(dcT), static_cast<const bf16*>(ga), static_cast<const bf16*>(cs),
      static_cast<const bf16*>(c0), static_cast<const bf16*>(w), static_cast<bf16*>(dgx), static_cast<bf16*>(dh0),
      static_cast<bf16*>(dc0), T, B, H, nbuf);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// dW_hh (4H, H) = sum over the M = T*B rows of dgates_x[m]^T h_prev[m] on the tensor cores, bf16
// operands, float32 sums, cast to bf16.  dgx (T, B, 4H); h0 (B, H); ys (T, B, H); partial: nsplit
// * 4H * H floats of device scratch.  Two launches: the partials, their sum.
extern "C" int i2l_lstm_seq_dw_tc(const void* dgx, const void* h0, const void* ys, void* partial, void* dw, int M,
                                  int B, int H, int nsplit, void* stream) {
  if (M <= 0 || B <= 0 || H <= 0 || M % B != 0 || nsplit <= 0 || nsplit > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = H % 8 == 0 && aligned16(dgx) && aligned16(h0) && (M == B || aligned16(ys));
  return (int)(aligned ? dw_launch<true>(dgx, h0, ys, partial, dw, M, B, H, nsplit, s)
                       : dw_launch<false>(dgx, h0, ys, partial, dw, M, B, H, nsplit, s));
}
