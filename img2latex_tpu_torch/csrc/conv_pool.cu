// conv3x3 (SAME, zero padding) + optional float32 bias + ReLU + maxpool 2x2, fused, any Cin.
//
// Replaces two TPU kernels, one function in two layouts (a template parameter):
//  * img2latex_tpu/ops/pallas/conv_cf.py::fused_convblock_cf (pl.pallas_call at line 170):
//    x (B, Cin, H, W) -> (B, Cout, H/2, W/2), channel-first in and out, with a bias: encoder
//    blocks 2..n of the hardware.pallas_chain path;
//  * img2latex_tpu/ops/pallas/conv_pool.py::fused_conv_relu_pool (pl.pallas_call at line 101):
//    x (B, H, W, Cin) -> (B, H/2, W/2, Cout), channels-last in and out, no bias.
// As there, only the pooled map is written: the full-resolution conv output never reaches device
// memory.  The TPU kernels' 16-tap parity bundle and (4 Cout, 16 Cin) tap matrix are VMEM and MXU
// artefacts and are not copied: this kernel computes the function.
//
// Bound: at the chain path's block 2, (512, 32, 32, 400) -> (512, 64, 16, 200) in bf16, the work is
// 2 x 9 x 32 x 64 x 32 x 400 x 512 = 2.42e11 FLOP against ~0.42 GB read and written, ~580 FLOP a
// byte, above the H100's ~295: bound by operations (0.244 ms at 989 TFLOP/s bf16); block 3,
// (512, 64, 16, 200) -> (512, 128, 8, 100), does the same FLOP on fewer bytes.
//
// Rounding: the conv of the compute-type values summed in float32, then the max over the four
// phases, the bias (max and a constant add commute under rounding to nearest, and so do max, the
// ReLU and the monotone cast), the ReLU, one cast to the storage type.  Offsets are 64-bit:
// B x Cin x H x W is 2.1e8 at B = 512 and 1.3e9 at B = 3072.  Two kernels, by storage type:
//
// float32 (conv_pool_kernel, the exact oracle, bit-equal to the float32 plain version at the chain's
// shapes): products on the CUDA cores.  One block per (image, tile of 4 x 16 pooled pixels, tile
// of 64 output channels), 256 threads.  A thread owns one pooled pixel and 16 channels: 64 float32
// sums, the four conv outputs of its 2x2 pool window for each channel.  The input tile with its +-1
// halo (10 x 34 pixels, zero outside the image: the SAME padding) and the float32 taps of a chunk
// of 8 input channels are staged in shared memory; each thread reads its 4x4 window once per input
// channel, and the taps of its 16 channels as float4 broadcasts.
//
// bf16 (conv_pool_tc_kernel): an implicit GEMM on the tensor cores, mma.sync m16n8k16 with bf16
// operands and float32 sums (the TPU kernels' patch-matrix jnp.dot with preferred_element_type
// float32; only the order of the sums differs).  The same block tile: M = the 8 x 32 conv pixels
// of 4 x 16 pooled ones, N = 64 output channels, K = 9 taps x Cin, walked in stages of 16 input
// channels (one k16 step a tap).  A stage holds the input tile with its halo, 10 x 34 pixels,
// channel-innermost (16 channels and 16 bytes of padding a pixel, so that the 8 rows of an
// ldmatrix fall on distinct banks) for both layouts, NCHW transposed while it is staged, and the
// stage's 144 x 64 taps (k-major, read with ldmatrix.trans).  An A fragment is 16 consecutive conv
// pixels of one row at one tap: ldmatrix takes an address per row, so the halo tile serves all nine
// taps with no patch matrix.  Channels past Cin are zero in shared memory.  The taps come from the
// wrapper as bf16 (Cin16, 3, 3, Cout64), Cin padded with zeros to a multiple of 16 and Cout to one
// of 64, so their copies are unguarded 16-byte cp.async; the NHWC input goes by 16-byte cp.async
// too where Cin is a multiple of 8, NCHW by 4-byte column pairs, otherwise by guarded element
// loads.  Two stages (72 KB of dynamic shared memory) and 128 registers at most let two blocks share
// an SM, so one block's staging overlaps the other's products.  8 warps; warp w takes conv rows 2 (w / 2) and
// 2 (w / 2) + 1, columns 16 (w % 2) .. + 15, and all 64 channels: 2 x 8 m16n8 tiles, 64 float32 sums
// a lane.  The 2x2 max is taken on the accumulators: the two rows are the lane's own pair of m16
// tiles, the two columns a lane and the lane 4 away (one shuffle).  The pooled 4 x 16 x 64 tile
// then goes through shared memory, so that both layouts store it coalesced.  NCHW is staged by
// 4-byte loads of column pairs (the transpose costs it ~1.3 ms over NHWC's cp.async at the chain's
// shapes; a third stage gained nothing measurable).  ptxas (sm_90a, CUDA 12.8): 128
// registers in every instantiation, 16 bytes of spill in the NHWC cp.async one (the first build: 8
// there, 24 in the NHWC element one); 74,112 bytes of dynamic shared memory.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kTH = 4;    // pooled rows of a tile
constexpr int kTW = 16;   // pooled columns of a tile
constexpr int kTC = 64;   // output channels of a tile
constexpr int kCK = 8;    // input channels staged at a time
constexpr int kCPT = 16;  // output channels of a thread
constexpr int kPix = kTH * kTW;
constexpr int kThreads = kPix * (kTC / kCPT);  // 256
constexpr int kIR = 2 * kTH + 2;               // input rows of a tile, halo included
constexpr int kIC = 2 * kTW + 2;               // input columns of a tile, halo included

template <typename T, bool kNHWC>
__global__ void __launch_bounds__(kThreads) conv_pool_kernel(
    const T* __restrict__ x, const float* __restrict__ taps, const float* __restrict__ bias,
    T* __restrict__ out, int Cin, int H, int W, int Cout, int tiles_w) {
  __shared__ float s_in[kCK][kIR][kIC];
  __shared__ __align__(16) float s_w[kCK][9][kTC];

  const int H2 = H / 2, W2 = W / 2;
  const int ph0 = (blockIdx.x / tiles_w) * kTH;
  const int pw0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kTC;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int pix = t % kPix, grp = t / kPix;
  const int lh = pix / kTW, lw = pix % kTW;
  const int r0 = 2 * ph0 - 1, c0 = 2 * pw0 - 1;  // image row and column of the tile's first input
  const T* xb = x + (size_t)b * Cin * H * W;

  float acc[kCPT][4];
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
#pragma unroll
    for (int p = 0; p < 4; ++p) acc[c][p] = 0.f;
  }

  for (int ci0 = 0; ci0 < Cin; ci0 += kCK) {
    const int nck = min(kCK, Cin - ci0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < kCK * kIR * kIC; i += kThreads) {
      int ci, r, c;
      if (kNHWC) {  // channels fastest: neighbouring threads read neighbouring addresses
        ci = i % kCK;
        c = (i / kCK) % kIC;
        r = i / (kCK * kIC);
      } else {  // columns fastest
        c = i % kIC;
        r = (i / kIC) % kIR;
        ci = i / (kIC * kIR);
      }
      const int row = r0 + r, col = c0 + c;
      float v = 0.f;
      if (ci < nck && row >= 0 && row < H && col >= 0 && col < W) {
        const size_t off = kNHWC ? ((size_t)row * W + col) * Cin + (ci0 + ci)
                                 : ((size_t)(ci0 + ci) * H + row) * W + col;
        v = i2l::to_f(xb[off]);
      }
      s_in[ci][r][c] = v;
    }
    for (int i = t; i < kCK * 9 * kTC; i += kThreads) {
      const int j = i % kTC, k = (i / kTC) % 9, ci = i / (kTC * 9);
      const int co = co0 + j;
      s_w[ci][k][j] = (ci < nck && co < Cout) ? taps[((size_t)(ci0 + ci) * 9 + k) * Cout + co] : 0.f;
    }
    __syncthreads();

    for (int ci = 0; ci < nck; ++ci) {
      float win[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int s = 0; s < 4; ++s) win[r][s] = s_in[ci][2 * lh + r][2 * lw + s];
      }
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float* wrow = &s_w[ci][u * 3 + v][grp * kCPT];
#pragma unroll
          for (int q = 0; q < kCPT; q += 4) {
            const float4 w4 = *reinterpret_cast<const float4*>(wrow + q);
            const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
#pragma unroll
              for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int d = 0; d < 2; ++d)
                  acc[q + e][a * 2 + d] = fmaf(wv[e], win[a + u][d + v], acc[q + e][a * 2 + d]);
              }
            }
          }
        }
      }
    }
  }

  const int ph = ph0 + lh, pw = pw0 + lw;
  if (ph >= H2 || pw >= W2) return;
  const size_t plane = (size_t)H2 * W2;
#pragma unroll
  for (int c = 0; c < kCPT; ++c) {
    const int co = co0 + grp * kCPT + c;
    if (co >= Cout) break;
    const float best = fmaxf(fmaxf(acc[c][0], acc[c][1]), fmaxf(acc[c][2], acc[c][3]));
    const float y = fmaxf(best + (bias != nullptr ? bias[co] : 0.f), 0.f);
    const size_t off = kNHWC ? (((size_t)b * H2 + ph) * W2 + pw) * Cout + co
                             : ((size_t)b * Cout + co) * plane + (size_t)ph * W2 + pw;
    out[off] = i2l::from_f<T>(y);
  }
}

// ---- bf16, tensor cores -------------------------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int M_CK = 16;                          // input channels of a stage
constexpr int M_TAPS = 9 * M_CK;                  // k rows of a stage
constexpr int M_PIX = kIR * kIC;                  // staged input pixels, halo included
constexpr int M_IPITCH = M_CK + 8;                // bf16 a staged pixel: 48 bytes
constexpr int M_WPITCH = kTC + 8;                 // bf16 a staged tap row: 144 bytes
constexpr int M_IN_ELEMS = M_PIX * M_IPITCH;
constexpr int M_STAGE_ELEMS = M_IN_ELEMS + M_TAPS * M_WPITCH;
constexpr int M_STAGES = 2;                       // depth of the cp.async ring
constexpr int M_SMEM = M_STAGES * M_STAGE_ELEMS * (int)sizeof(bf16);  // 74,112 bytes at 2 stages
constexpr int M_OPITCH = kTC + 8;                 // the pooled tile in shared memory, [pixel][channel]
static_assert(kPix * M_OPITCH <= M_STAGE_ELEMS, "the pooled tile fits a stage");
static_assert(kPix * kTC % kThreads == 0, "the pooled tile splits evenly over the threads");
static_assert(kThreads == 256 && kTH == 4 && kTW == 16, "warp w takes conv rows 2 (w / 2) + {0, 1}");

// Stage input channels [ci0, ci0 + M_CK) of the tile and their taps into `stage`.  Every loop has a
// compile-time trip count (the last pass guarded), so that staging compiles to straight-line code.
template <bool kNHWC, bool kVec>
__device__ __forceinline__ void conv_tc_load(bf16* stage, const bf16* xb, const bf16* taps, int ci0,
                                             int Cin, int H, int W, int Cout_p, int co0, int r0,
                                             int c0) {
  const int t = threadIdx.x;
  bf16* s_in = stage;
  bf16* s_w = stage + M_IN_ELEMS;
  // taps (Cin16, 9, Cout64): k row tap * M_CK + ci of the stage is taps row (ci0 + ci) * 9 + tap
  constexpr int kW = M_TAPS * (kTC / 8);
#pragma unroll
  for (int i = 0; i < (kW + kThreads - 1) / kThreads; ++i) {
    const int e = t + i * kThreads;
    if (kW % kThreads == 0 || e < kW) {
      const int kr = e / (kTC / 8), cc = (e % (kTC / 8)) * 8;
      const int tap = kr / M_CK, ci = kr % M_CK;
      i2l::cp_async_16(s_w + kr * M_WPITCH + cc, taps + ((size_t)(ci0 + ci) * 9 + tap) * Cout_p + co0 + cc, true);
    }
  }
  if (kVec && !kNHWC) {  // NCHW: pairs of columns, 4-byte loads along each row of each channel
    // pair p holds image columns c0 - 1 + 2p and c0 + 2p (even and odd: W is even, so a pair is inside
    // the image or outside it whole), i.e. tile columns 2p - 1 and 2p
    constexpr int kPairs = kIC / 2 + 1, kN = M_CK * kIR * kPairs, kU = 4;
    constexpr int kIters = (kN + kThreads - 1) / kThreads;
#pragma unroll 1
    for (int i0 = 0; i0 < kIters; i0 += kU) {
      uint32_t v[kU];
      int dst[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = t + (i0 + u) * kThreads;
        const int pr = e % kPairs, r = (e / kPairs) % kIR, ci = e / (kPairs * kIR);
        const int row = r0 + r, col = c0 - 1 + 2 * pr, ch = ci0 + ci;
        v[u] = 0u;
        dst[u] = e < kN ? (r * kIC + 2 * pr) * M_IPITCH + ci : -1;  // tile column 2p (the high half)
        if (e < kN && row >= 0 && row < H && col >= 0 && col < W && ch < Cin)
          v[u] = *reinterpret_cast<const uint32_t*>(xb + ((size_t)ch * H + row) * W + col);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (dst[u] < 0) continue;
        const int pr = (t + (i0 + u) * kThreads) % kPairs;
        if (pr > 0) s_in[dst[u] - M_IPITCH] = __ushort_as_bfloat16((unsigned short)(v[u] & 0xffffu));
        if (pr < kPairs - 1) s_in[dst[u]] = __ushort_as_bfloat16((unsigned short)(v[u] >> 16));
      }
    }
  } else if (kVec) {  // NHWC, Cin a multiple of 8: two 16-byte chunks a pixel
    constexpr int kX = M_PIX * 2;
#pragma unroll
    for (int i = 0; i < (kX + kThreads - 1) / kThreads; ++i) {
      const int e = t + i * kThreads;
      if (kX % kThreads == 0 || e < kX) {
        const int px = e / 2, half = e % 2;
        const int row = r0 + px / kIC, col = c0 + px % kIC, ch = ci0 + half * 8;
        const bool ok = row >= 0 && row < H && col >= 0 && col < W && ch < Cin;
        const bf16* src = ok ? xb + ((size_t)row * W + col) * Cin + ch : xb;
        i2l::cp_async_16(s_in + px * M_IPITCH + half * 8, src, ok);
      }
    }
  } else {  // element by element, 8 loads in flight a thread; NCHW reads along rows, NHWC along channels
    constexpr int kN = M_PIX * M_CK, kU = 8, kIters = (kN + kThreads - 1) / kThreads;
#pragma unroll 1
    for (int i0 = 0; i0 < kIters; i0 += kU) {
      bf16 v[kU];
      int dst[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = t + (i0 + u) * kThreads;
        int px, ci;
        if (kNHWC) {
          ci = e % M_CK;
          px = e / M_CK;
        } else {
          px = e % M_PIX;
          ci = e / M_PIX;
        }
        const int row = r0 + px / kIC, col = c0 + px % kIC, ch = ci0 + ci;
        v[u] = __float2bfloat16(0.f);
        dst[u] = e < kN ? px * M_IPITCH + ci : -1;
        if (e < kN && row >= 0 && row < H && col >= 0 && col < W && ch < Cin)
          v[u] = xb[kNHWC ? ((size_t)row * W + col) * Cin + ch : ((size_t)ch * H + row) * W + col];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (dst[u] >= 0) s_in[dst[u]] = v[u];
    }
  }
}

template <bool kNHWC, bool kVec>
__global__ void __launch_bounds__(kThreads, 2) conv_pool_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ taps, const float* __restrict__ bias,
    bf16* __restrict__ out, int Cin, int H, int W, int Cout, int tiles_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int H2 = H / 2, W2 = W / 2;
  const int ph0 = (blockIdx.x / tiles_w) * kTH;
  const int pw0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kTC;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wr = warp / 2, wc = warp % 2;  // conv rows 2 wr, 2 wr + 1; conv columns 16 wc ..
  const int r0 = 2 * ph0 - 1, c0 = 2 * pw0 - 1;
  const int Cout_p = (Cout + kTC - 1) / kTC * kTC;
  const int nk = (Cin + M_CK - 1) / M_CK;
  const bf16* xb = x + (size_t)b * Cin * H * W;

  float acc[2][kTC / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < kTC / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.f;

#pragma unroll
  for (int st = 0; st < M_STAGES - 1; ++st) {
    if (st < nk)
      conv_tc_load<kNHWC, kVec>(smem + st * M_STAGE_ELEMS, xb, taps, st * M_CK, Cin, H, W, Cout_p, co0, r0, c0);
    i2l::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    i2l::cp_async_wait<M_STAGES - 2>();  // stage kt has landed (this thread's copies) ...
    __syncthreads();                     // ... and everyone's; and everyone is done with stage kt - 1
    const int nxt = kt + M_STAGES - 1;
    if (nxt < nk)  // into the slot of stage kt - 1
      conv_tc_load<kNHWC, kVec>(smem + (nxt % M_STAGES) * M_STAGE_ELEMS, xb, taps, nxt * M_CK, Cin, H, W,
                                  Cout_p, co0, r0, c0);
    i2l::cp_async_commit();
    const bf16* s_in = smem + (kt % M_STAGES) * M_STAGE_ELEMS;
    const bf16* s_w = s_in + M_IN_ELEMS;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int u = tap / 3, v = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // 16 conv pixels of row 2 wr + mi at tap (u, v)
        i2l::ldmatrix_x4(a[mi], s_in + ((2 * wr + mi + u) * kIC + 16 * wc + lane % 16 + v) * M_IPITCH +
                                    (lane / 16) * 8);
#pragma unroll
      for (int nj = 0; nj < kTC / 16; ++nj) {  // n8 tiles 2 nj and 2 nj + 1
        uint32_t bq[4];
        i2l::ldmatrix_x4_trans(bq, s_w + (tap * M_CK + lane % 8 + ((lane / 8) % 2) * 8) * M_WPITCH + nj * 16 +
                                       (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          i2l::mma_bf16_16816(acc[mi][2 * nj], a[mi], bq[0], bq[1]);
          i2l::mma_bf16_16816(acc[mi][2 * nj + 1], a[mi], bq[2], bq[3]);
        }
      }
    }
  }
  i2l::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages before the pooled tile overwrites stage 0

  // 2x2 max: rows 2 wr and 2 wr + 1 are this lane's two m16 tiles; columns 2p and 2p + 1 are
  // pixel rows g and g + 1 of a tile, lanes l and l + 4.  Then bias, ReLU, one cast, into the
  // pooled tile [4 x 16 pixels][64 channels] in shared memory (stage 0).
  bf16* s_out = smem;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int n = 0; n < kTC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float m = fmaxf(acc[0][n][e], acc[1][n][e]);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      const int col = g + (e / 2) * 8;  // conv column within the warp's 16
      const int cl = n * 8 + 2 * q + e % 2;
      if ((g & 1) == 0) {
        const int co = co0 + cl;
        const float y = fmaxf(m + ((bias != nullptr && co < Cout) ? bias[co] : 0.f), 0.f);
        s_out[(wr * kTW + 8 * wc + col / 2) * M_OPITCH + cl] = __float2bfloat16(y);
      }
    }
  }
  __syncthreads();
  const size_t plane = (size_t)H2 * W2;
#pragma unroll 4
  for (int i = 0; i < kPix * kTC / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    int px, cl;
    if (kNHWC) {  // channels fastest
      cl = e % kTC;
      px = e / kTC;
    } else {  // pooled columns fastest
      px = e % kPix;
      cl = e / kPix;
    }
    const int ph = ph0 + px / kTW, pw = pw0 + px % kTW, co = co0 + cl;
    if (ph >= H2 || pw >= W2 || co >= Cout) continue;
    const size_t off = kNHWC ? (((size_t)b * H2 + ph) * W2 + pw) * Cout + co
                             : ((size_t)b * Cout + co) * plane + (size_t)ph * W2 + pw;
    out[off] = s_out[px * M_OPITCH + cl];
  }
}

template <typename T, bool kNHWC>
cudaError_t launch(const void* x, const void* taps, const void* bias, void* out, int B, int Cin, int H,
                   int W, int Cout, cudaStream_t stream) {
  const int tiles_w = (W / 2 + kTW - 1) / kTW, tiles_h = (H / 2 + kTH - 1) / kTH;
  dim3 grid(tiles_w * tiles_h, (Cout + kTC - 1) / kTC, B);
  conv_pool_kernel<T, kNHWC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<const float*>(bias),
      static_cast<T*>(out), Cin, H, W, Cout, tiles_w);
  return cudaGetLastError();
}

template <bool kNHWC, bool kVec>
cudaError_t launch_tc(const void* x, const void* taps, const void* bias, void* out, int B, int Cin, int H,
                      int W, int Cout, cudaStream_t stream) {
  static bool done[16] = {};
  const cudaError_t err = i2l::allow_dynamic_smem(conv_pool_tc_kernel<kNHWC, kVec>, M_SMEM, done);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W / 2 + kTW - 1) / kTW, tiles_h = (H / 2 + kTH - 1) / kTH;
  dim3 grid(tiles_w * tiles_h, (Cout + kTC - 1) / kTC, B);
  conv_pool_tc_kernel<kNHWC, kVec><<<grid, kThreads, M_SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(taps), static_cast<const float*>(bias),
      static_cast<bf16*>(out), Cin, H, W, Cout, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the bf16 conv-pool kernel, bytes (ptxas reports static only).
extern "C" int i2l_conv_tc_smem_bytes() { return M_SMEM; }

// x: (B, Cin, H, W) (nhwc = 0) or (B, H, W, Cin) (nhwc = 1) of dtype; taps: for float32 (Cin, 3, 3,
// Cout) float32, for bf16 (Cin16, 3, 3, Cout64) bf16, Cin16 and Cout64 Cin and Cout rounded up to
// multiples of 16 and 64, zero-padded; bias: (Cout,) float32, or null for none; out: (B, Cout, H/2,
// W/2) or (B, H/2, W/2, Cout) of dtype.
extern "C" int i2l_conv_pool(const void* x, const void* taps, const void* bias, void* out, int B, int Cin,
                             int H, int W, int Cout, int nhwc, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Cin <= 0 || H < 2 || W < 2 || (H & 1) || (W & 1) || Cout <= 0 ||
      (long long)((W / 2 + kTW - 1) / kTW) * ((H / 2 + kTH - 1) / kTH) > 0x7fffffffLL ||
      (Cout + kTC - 1) / kTC > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)(nhwc ? launch<float, true>(x, taps, bias, out, B, Cin, H, W, Cout, s)
                      : launch<float, false>(x, taps, bias, out, B, Cin, H, W, Cout, s));
  if (dtype == i2l::kBF16) {  // the tensor-core kernel; vector staging where the layout allows it
    const uintptr_t a = reinterpret_cast<uintptr_t>(x);
    if (!nhwc)
      return (int)((a & 3) == 0 ? launch_tc<false, true>(x, taps, bias, out, B, Cin, H, W, Cout, s)
                                : launch_tc<false, false>(x, taps, bias, out, B, Cin, H, W, Cout, s));
    return (int)(Cin % 8 == 0 && (a & 15) == 0 ? launch_tc<true, true>(x, taps, bias, out, B, Cin, H, W, Cout, s)
                                               : launch_tc<true, false>(x, taps, bias, out, B, Cin, H, W, Cout, s));
  }
  return (int)cudaErrorInvalidValue;
}
