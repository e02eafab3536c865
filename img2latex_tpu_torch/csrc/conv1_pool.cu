// conv3x3 (Cin = 1, SAME, zero padding) + bias + ReLU + maxpool 2x2, fused.
//
// Replaces the TPU kernels img2latex_tpu/ops/pallas/conv1_phase.py::fused_conv1_pool
// (pl.pallas_call at line 208) and conv1_lane.py::conv1_lane_relu_pool (pl.pallas_call
// at line 96: the same op without the bias, written channels-last).  As there, only
// the pooled map is written: the full-resolution conv output never reaches device
// memory.
//
// The CUDA-core kernel: float32 (the exactness oracle) and bf16 with Cout not a multiple of 8.
// bf16 with Cout a multiple of 8 runs on the tensor cores (conv1_pool_tc.cu);
// ops/conv1_phase.py::conv1_plan names the route.
//
// Layout: x (B, H, W) -- the NHWC input with its single channel -- in; out
// (B, Cout, H/2, W/2) NCHW, the layout of the next block's conv2d and of the
// channel-first chain, or (B, H/2, W/2, Cout) NHWC (a template parameter).
//
// Bound: per 64x800 image in bf16 the kernel reads 102 KB and writes
// 32 x 32 x 400 x 2 B = 819 KB, against 2 x 9 x 32 x 64 x 800 = 29.5 MFLOP:
// about 32 FLOP per byte, far below the H100's ~295 (bf16) -- it is bound by
// device-memory bandwidth.
//
// Design: one thread per pooled pixel.  It reads its 4x4 input window once
// (rows 2ph-1..2ph+2, cols 2pw-1..2pw+2), then for each channel computes the
// four conv outputs of the 2x2 pool window in float32, takes their max, adds
// the bias (max and a constant add commute), applies ReLU and stores.  The
// taps and biases sit in shared memory, read as broadcasts.  Neighbouring
// threads take neighbouring pw, so each channel's NCHW store is coalesced; an
// NHWC store writes a thread's Cout channels to consecutive addresses.
#include "common.cuh"

namespace {

constexpr int kMaxCout = 128;
constexpr int kThreads = 128;

template <typename T, bool kNHWC>
__global__ void __launch_bounds__(kThreads) conv1_pool_kernel(
    const T* __restrict__ x, const float* __restrict__ taps, const float* __restrict__ bias,
    T* __restrict__ out, int H, int W, int Cout) {
  __shared__ float s_taps[kMaxCout * 9];
  __shared__ float s_bias[kMaxCout];
  for (int i = threadIdx.x; i < Cout * 9; i += blockDim.x) s_taps[i] = taps[i];
  for (int i = threadIdx.x; i < Cout; i += blockDim.x) s_bias[i] = bias[i];
  __syncthreads();

  const int H2 = H / 2, W2 = W / 2;
  const int pw = blockIdx.x * blockDim.x + threadIdx.x;
  const int ph = blockIdx.y;
  const int b = blockIdx.z;
  if (pw >= W2) return;

  const T* xb = x + (size_t)b * H * W;
  float win[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 2 * ph - 1 + r;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int col = 2 * pw - 1 + s;
      win[r][s] = (row >= 0 && row < H && col >= 0 && col < W) ? i2l::to_f(xb[(size_t)row * W + col]) : 0.f;
    }
  }

  const size_t plane = (size_t)H2 * W2;
  // channel c of this pixel lies at ob[c * stride]
  const size_t stride = kNHWC ? 1 : plane;
  T* ob = kNHWC ? out + (((size_t)b * H2 + ph) * W2 + pw) * Cout
                : out + (size_t)b * Cout * plane + (size_t)ph * W2 + pw;
  for (int c = 0; c < Cout; ++c) {
    const float* k = s_taps + c * 9;
    float best = -3.402823466e+38f;  // -FLT_MAX; the sums are finite
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < 3; ++u) {
#pragma unroll
          for (int v = 0; v < 3; ++v) acc = fmaf(k[u * 3 + v], win[a + u][d + v], acc);
        }
        best = fmaxf(best, acc);
      }
    }
    ob[(size_t)c * stride] = i2l::from_f<T>(fmaxf(best + s_bias[c], 0.f));
  }
}

template <typename T, bool kNHWC>
cudaError_t launch(const void* x, const void* taps, const void* bias, void* out, int B, int H,
                   int W, int Cout, cudaStream_t stream) {
  const int W2 = W / 2;
  dim3 grid((W2 + kThreads - 1) / kThreads, H / 2, B);
  conv1_pool_kernel<T, kNHWC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(taps), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W, Cout);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W) of dtype; taps: (Cout, 9) float32 (row-major 3x3 per channel);
// bias: (Cout,) float32; out: (B, Cout, H/2, W/2) (nhwc = 0) or (B, H/2, W/2, Cout) (nhwc = 1)
// of dtype.
extern "C" int i2l_conv1_pool(const void* x, const void* taps, const void* bias, void* out, int B,
                              int H, int W, int Cout, int nhwc, int dtype, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || (H & 1) || (W & 1) || Cout <= 0 || Cout > kMaxCout ||
      H / 2 > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == i2l::kF32)
    return (int)(nhwc ? launch<float, true>(x, taps, bias, out, B, H, W, Cout, s)
                      : launch<float, false>(x, taps, bias, out, B, H, W, Cout, s));
  if (dtype == i2l::kBF16)
    return (int)(nhwc ? launch<__nv_bfloat16, true>(x, taps, bias, out, B, H, W, Cout, s)
                      : launch<__nv_bfloat16, false>(x, taps, bias, out, B, H, W, Cout, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* i2l_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
