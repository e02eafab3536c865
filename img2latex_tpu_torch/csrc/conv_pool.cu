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
// (512, 64, 16, 200) -> (512, 128, 8, 100), does the same FLOP on fewer bytes.  This first kernel
// runs its products on the CUDA cores in float32 (67 TFLOP/s at most), so it cannot come near that
// bound; tensor-core products on bf16 tiles (mma.sync, wgmma) are the next step.
//
// Design: one block per (image, tile of 4 x 16 pooled pixels, tile of 64 output channels), 256
// threads.  A thread owns one pooled pixel and 16 channels: 64 float32 sums, the four conv outputs
// of its 2x2 pool window for each channel.  The input tile with its +-1 halo (10 x 34 pixels, zero
// outside the image: the SAME padding) and the taps of a chunk of 8 input channels are staged in
// shared memory in float32; each thread reads its 4x4 window once per input channel, and the taps
// of its 16 channels as float4 broadcasts (the 32 threads of a warp share a channel group).  Then
// the max over the four phases, the bias (max and a constant add commute under rounding to nearest,
// and so do max, the ReLU and the monotone cast), the ReLU, one cast to the storage type.  Offsets
// are 64-bit: B x Cin x H x W is 2.1e8 at B = 512 and 1.3e9 at B = 3072.
#include "common.cuh"

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

}  // namespace

// x: (B, Cin, H, W) (nhwc = 0) or (B, H, W, Cin) (nhwc = 1) of dtype; taps: (Cin, 3, 3, Cout)
// float32; bias: (Cout,) float32, or null for none; out: (B, Cout, H/2, W/2) or (B, H/2, W/2, Cout)
// of dtype.
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
  if (dtype == i2l::kBF16)
    return (int)(nhwc ? launch<__nv_bfloat16, true>(x, taps, bias, out, B, Cin, H, W, Cout, s)
                      : launch<__nv_bfloat16, false>(x, taps, bias, out, B, Cin, H, W, Cout, s));
  return (int)cudaErrorInvalidValue;
}
