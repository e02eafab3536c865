// conv3x3 (Cin = 1, SAME, zero padding) + bias + ReLU + maxpool 2x2 on the tensor cores, bf16.
//
// Replaces, for bf16 with Cout a multiple of 8, the TPU kernels
// img2latex_tpu/ops/pallas/conv1_phase.py::fused_conv1_pool (pl.pallas_call at line 208) and
// conv1_lane.py::conv1_lane_relu_pool (pl.pallas_call at line 96: no bias, channels-last), in
// both output layouts (a template parameter): x (B, H, W) -- the NHWC input with its single
// channel -- in, (B, Cout, H/2, W/2) or (B, H/2, W/2, Cout) out.  conv1_pool.cu's CUDA-core kernel
// keeps float32 (the exactness oracle) and the other bf16 shapes; ops/conv1_phase.py::conv1_plan
// names the route.
//
// Arithmetic: the TPU kernel's (conv1_phase.py:84-139), not its layout (its parity planes and
// 128-lane column padding are VMEM artefacts).  A pooled pixel's 4x4 input window (rows
// 2ph-1..2ph+2, cols 2pw-1..2pw+2, zero outside the image), as a row of K = 16 (k = 4s + t), times
// the packed taps (16, 4 Cout) -- column p Cout + c holds channel c's 3x3 taps embedded in the
// window at pool phase p = 2a + b (ops/conv1_phase.py::pack_conv1_taps) -- gives the four conv
// outputs of the pool window at once: one mma.m16n8k16 k-step, no padding.  Then the float32 max
// over the four phases, the float32 bias, ReLU and one rounding to bf16.  That equals bias, ReLU,
// rounding, then the pool (conv1_pool_plain): a constant add and a rounding to nearest are
// monotone, so the max commutes with both.  The 9 non-zero products are exact in float32 and the
// 7 zero taps add exact zeros: the sums differ from the plain version's only in their order.
//
// Bound: at (512, 64, 800, 1) -> 32 channels the kernel reads 52 MB and writes 419 MB, 0.141 ms at
// 3.35 TB/s; the product is 6.55 M mma.sync (~0.03 ms of tensor-core time).  The CUDA-core kernel
// spends 1152 fmaf a pooled pixel (7.55 G in all, ~0.26 ms to dispatch alone); here a pooled pixel
// costs ~10 lane-instructions.  Measured on an H100 SXM at 700 W (scripts/conv1_parts.py):
// 0.195 ms NCHW, 0.189 NHWC (the CUDA-core kernel 0.52 / 2.57; writing 419 MB alone, zero_, 0.128);
// without its global stores 0.157 / 0.146, without the product 0.193 / 0.177: the staging, the
// window loads and the epilogue of 16 warps an SM, not the bytes, set the pace.  ptxas (sm_90a,
// CUDA 12.8): 115 (NCHW) / 84 (NHWC) registers, no spill; 33,664 bytes of dynamic shared memory.
//
// Design.  A block is 4 warps and one band of `rows` pooled rows of one image (grid (bands, B)).
// It stages the band's 2 rows + 2 halo input rows in shared memory with cp.async (16 bytes where
// W is a multiple of 8, else 4), unshifted, each behind 16 bytes of zeros and followed by zeros;
// a halo row outside the image is zero.  The row pitch is 16 words mod 32, so the two window rows
// a load instruction touches fall on disjoint banks.  A warp's item is a span of kSpan x 16
// pooled pixels of one row and a chunk of up to 32 channels; the warp walks its items with the
// chunk's B fragments in registers (32 at 32 channels, loaded again only when the chunk changes:
// Cout > 32).  For each 16-pixel m16 tile of the span:
//  * A: a lane's register holds the window elements (2pw-1+t, 2pw+t), t = 0 or 2, of one row: an
//    odd start, so two aligned words of the staged row joined by a funnel shift.
//  * For each group of 8 channels, one mma a phase; the four phases of a channel land in the same
//    accumulator slot of the four tiles, so the phase max is three fmaxf, then the bias, ReLU and
//    a cvt to bf16x2, all in registers.
// The warp stages the span's result in shared memory (16-byte chunks XOR-swizzled, so that its
// writes and the reads back are free of bank conflicts; NCHW first pairs two pixels of a channel
// through one shuffle) and writes it with 16-byte stores: NHWC one run of 16 kSpan pixels x 64
// bytes, NCHW 32 runs of 16 kSpan pixels x 2 bytes, a whole 128-byte line a channel at kSpan = 4.
// NCHW with W/2 not a multiple of 8 stores element by element.
#include "common.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCout = 128;
constexpr int kMaxRows = 16;               // pooled rows a band, at most
constexpr int kPadWords = 4;               // 16 bytes of zeros before a staged row's data
constexpr int kSpan = 4;                   // 16-pixel m16 tiles a warp's item
constexpr int kRun = 2 * kSpan;            // 16-byte chunks of an NCHW channel's run in an item
constexpr int kStageWords = kSpan * 16 * 32 / 2;  // a warp's staged result: 16 kSpan pixels x 32 channels
static_assert(kSpan == 1 || kSpan == 2 || kSpan == 4, "an item's NCHW run is 2, 4 or 8 chunks");
constexpr int kMaxSmem = 232448;           // an H100 block's shared memory
constexpr int kMaxW = 1 << 16;

// 32-bit words of a staged input row: the pad, then data, then zeros past the last pixel tile's
// reads (word 4 + 16 tiles), rounded up to 16 mod 32.
__host__ __device__ inline int row_words(int W) {
  const int tiles = (W / 2 + 15) / 16;
  const int need = 16 * tiles + kPadWords + 1;
  return need + ((16 - need) % 32 + 32) % 32;
}

__host__ __device__ inline int smem_bytes(int W, int rows) {
  return 4 * (kWarps * kStageWords + (2 * rows + 2) * row_words(W));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(i2l::smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// The XOR of the chunks of NCHW channel c's run in a warp's stage: the 8 channels that one store
// instruction writes (8j .. 8j + 7, the same chunk of each) land on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int nchw_swizzle(int c) { return (c >> (kRun == 2 ? 2 : kRun == 4 ? 1 : 0)) & (kRun - 1); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool kNHWC>
__global__ void __launch_bounds__(kThreads, 4) conv1_pool_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const uint32_t* __restrict__ packed, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int H, int W, int Cout, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int H2 = H / 2, W2 = W / 2;
  const int P = row_words(W);
  const int ph0 = blockIdx.x * rows;
  const int b = blockIdx.y;
  const int nrows = min(rows, H2 - ph0);  // pooled rows of this band
  const int in_rows = 2 * nrows + 2;      // local row i is image row 2 ph0 - 1 + i
  uint32_t* stage = smem + warp * kStageWords;
  uint32_t* in = smem + kWarps * kStageWords;

  // ---- stage the band's input rows ----
  const int pad = P - W2;  // zero words of a row: kPadWords before the data, the rest after it
  for (int i = threadIdx.x; i < in_rows * pad; i += kThreads) {
    const int r = i / pad, k = i - r * pad;
    in[r * P + (k < kPadWords ? k : W2 + k)] = 0u;
  }
  const __nv_bfloat16* xb = x + (size_t)b * H * W;
  if ((W & 7) == 0) {
    const int per_row = W / 8;  // 16-byte chunks
    for (int i = threadIdx.x; i < in_rows * per_row; i += kThreads) {
      const int r = i / per_row, k = i - r * per_row;
      const int row = 2 * ph0 - 1 + r;
      const bool valid = row >= 0 && row < H;  // else zero-filled: the SAME padding
      i2l::cp_async_16(in + r * P + kPadWords + 4 * k, valid ? xb + (size_t)row * W + 8 * k : xb, valid);
    }
  } else {
    for (int i = threadIdx.x; i < in_rows * W2; i += kThreads) {
      const int r = i / W2, k = i - r * W2;
      const int row = 2 * ph0 - 1 + r;
      const bool valid = row >= 0 && row < H;
      cp_async_4(in + r * P + kPadWords + k, valid ? xb + (size_t)row * W + 2 * k : xb, valid);
    }
  }
  i2l::cp_async_commit();
  i2l::cp_async_wait<0>();
  __syncthreads();

  // ---- items: (chunk of 32 channels, pooled row, span of kSpan tiles of 16 pooled pixels) ----
  const int tiles = (W2 + 15) / 16;
  const int spans = (tiles + kSpan - 1) / kSpan;
  const int per_chunk = nrows * spans;
  const int items = (Cout + 31) / 32 * per_chunk;  // chunk-major: a warp reloads B at most once a chunk
  const bool aligned = (W2 & 7) == 0;  // NCHW runs start on 16-byte boundaries
  uint32_t bf[4][4][2];  // B fragments [phase][group of 8 channels][k half]
  float bs[4][2];        // the bias of the lane's two channels of each group
  int cur = -1, c0 = 0, ng = 0;
  for (int item = warp; item < items; item += kWarps) {
    const int chunk = item / per_chunk;
    const int rem = item - chunk * per_chunk;
    const int r = rem / spans;
    const int px0 = 16 * kSpan * (rem - r * spans);  // the span's first pooled pixel
    if (chunk != cur) {
      cur = chunk;
      c0 = 32 * chunk;
      ng = min(4, (Cout - c0) / 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < ng) {
          // b0 = (k 2q..2q+1, n g), b1 = (k 2q+8.., n g): words q and q + 4 of packed row n
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const uint32_t* row = packed + (size_t)(p * Cout + c0 + 8 * j + g) * 8;
            bf[p][j][0] = __ldg(row + q);
            bf[p][j][1] = __ldg(row + q + 4);
          }
          bs[j][0] = __ldg(bias + c0 + 8 * j + 2 * q);
          bs[j][1] = __ldg(bias + c0 + 8 * j + 2 * q + 1);
        }
      }
    }

#pragma unroll
    for (int t = 0; t < kSpan; ++t) {
      const int pw0 = px0 + 16 * t;
      if (pw0 >= W2) break;
      // A (m = pixel pw0 + m, k = 4s + t'): a0 (m g, s = q/2), a1 (m g + 8, s = q/2), a2 (m g, s =
      // q/2 + 2), a3 (m g + 8, s = q/2 + 2); each at t' = 2 (q % 2), 2 (q % 2) + 1.  Image col c is
      // staged element 2 kPadWords + c, so the pair (2pw - 1 + t', 2pw + t') is the high half of word
      // kPadWords + pw + q % 2 - 1 and the low half of the next.
      const uint32_t* top = in + (2 * r + (q >> 1)) * P + kPadWords + pw0 + g + (q & 1);
      const uint32_t* bot = top + 2 * P;
      uint32_t a[4];
      a[0] = __funnelshift_r(top[-1], top[0], 16);
      a[1] = __funnelshift_r(top[7], top[8], 16);
      a[2] = __funnelshift_r(bot[-1], bot[0], 16);
      a[3] = __funnelshift_r(bot[7], bot[8], 16);

#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < ng) {
          float acc[4][4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            acc[p][0] = acc[p][1] = acc[p][2] = acc[p][3] = 0.f;
            i2l::mma_bf16_16816(acc[p], a, bf[p][j][0], bf[p][j][1]);
          }
          // slot e: pixel g (e < 2) or g + 8, channel 8j + 2q + e % 2 of the chunk
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = fmaxf(fmaxf(fmaxf(acc[0][e], acc[1][e]), fmaxf(acc[2][e], acc[3][e])) + bs[j][e & 1], 0.f);
          const uint32_t lo = pack_bf16(v[0], v[1]);  // pixel g: channels 2q, 2q + 1 of the group
          const uint32_t hi = pack_bf16(v[2], v[3]);  // pixel g + 8
          if (kNHWC) {
            // [pixel][4 chunks of 8 channels], chunk j at j ^ (pixel / 2 % 4)
            const int sw = 4 * (j ^ ((g >> 1) & 3));
            stage[16 * (16 * t + g) + sw + q] = lo;
            stage[16 * (16 * t + g + 8) + sw + q] = hi;
          } else {
            // [channel][kRun chunks of 8 pixels], chunk h at h ^ nchw_swizzle(channel).  Lanes g and
            // g ^ 1 swap a channel: g even then holds channel 2q of pixels (g, g + 1) and (g + 8,
            // g + 9), g odd channel 2q + 1 of pixels (g - 1, g) and (g + 7, g + 8).
            const int odd = g & 1;
            const uint32_t got = __shfl_xor_sync(0xffffffffu, __byte_perm(lo, hi, odd ? 0x5410 : 0x7632), 4);
            const uint32_t w0 = odd ? __byte_perm(got, lo, 0x7610) : __byte_perm(lo, got, 0x5410);
            const uint32_t w1 = odd ? __byte_perm(got, hi, 0x7632) : __byte_perm(hi, got, 0x7610);
            const int c = 8 * j + 2 * q + odd;
            const int sw = nchw_swizzle(c);
            stage[4 * (kRun * c + ((2 * t) ^ sw)) + (g >> 1)] = w0;
            stage[4 * (kRun * c + ((2 * t + 1) ^ sw)) + (g >> 1)] = w1;
          }
        }
      }
    }
    __syncwarp();

    const int ph = ph0 + r;
    if (kNHWC) {
#pragma unroll
      for (int i = 0; i < 2 * kSpan; ++i) {
        const int k = 32 * i + lane, p = k >> 2, jj = k & 3;
        if (jj < ng && px0 + p < W2) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage + 4 * (4 * p + (jj ^ ((p >> 1) & 3))));
          *reinterpret_cast<uint4*>(out + ((size_t)(b * H2 + ph) * W2 + px0 + p) * Cout + c0 + 8 * jj) = v;
        }
      }
    } else if (aligned) {
#pragma unroll
      for (int i = 0; i < 2 * kSpan; ++i) {
        const int k = 32 * i + lane, c = k / kRun, h = k % kRun;
        if (c < 8 * ng && px0 + 8 * h < W2) {
          const uint4 v = *reinterpret_cast<const uint4*>(stage + 4 * (kRun * c + (h ^ nchw_swizzle(c))));
          *reinterpret_cast<uint4*>(out + (((size_t)b * Cout + c0 + c) * H2 + ph) * W2 + px0 + 8 * h) = v;
        }
      }
    } else {
      const __nv_bfloat16* st = reinterpret_cast<const __nv_bfloat16*>(stage);
#pragma unroll 4
      for (int i = 0; i < 16 * kSpan; ++i) {
        const int e = 32 * i + lane, c = e / (16 * kSpan), px = e % (16 * kSpan);
        if (c < 8 * ng && px0 + px < W2)
          out[(((size_t)b * Cout + c0 + c) * H2 + ph) * W2 + px0 + px] =
              st[8 * (kRun * c + ((px >> 3) ^ nchw_swizzle(c))) + (px & 7)];
      }
    }
    __syncwarp();  // the stage is read before the next item writes it
  }
}

bool valid_shape(int B, int H, int W, int Cout, int rows) {
  return B > 0 && B <= 65535 && H >= 2 && W >= 2 && W <= kMaxW && !(H & 1) && !(W & 1) && Cout > 0 &&
         Cout <= kMaxCout && !(Cout & 7) && rows >= 1 && rows <= kMaxRows && smem_bytes(W, rows) <= kMaxSmem;
}

template <bool kNHWC>
cudaError_t launch(const void* x, const void* packed, const void* bias, void* out, int B, int H, int W,
                   int Cout, int rows, cudaStream_t stream) {
  static bool done[16] = {};
  const int smem = smem_bytes(W, rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = i2l::allow_dynamic_smem(conv1_pool_tc_kernel<kNHWC>, kMaxSmem, done);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((H / 2 + rows - 1) / rows, B);
  conv1_pool_tc_kernel<kNHWC><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), H, W, Cout, rows);
  return cudaGetLastError();
}

}  // namespace

// x: (B, H, W) bf16; packed: (4 Cout, 16) bf16, ops/conv1_phase.py::pack_conv1_taps of the bf16
// weights; bias: (Cout,) float32; out: (B, Cout, H/2, W/2) (nhwc = 0) or (B, H/2, W/2, Cout)
// (nhwc = 1) bf16; rows: pooled rows a block (ops/conv1_phase.py::conv1_plan).
extern "C" int i2l_conv1_pool_tc(const void* x, const void* packed, const void* bias, void* out, int B, int H,
                                 int W, int Cout, int nhwc, int rows, void* stream) {
  if (!valid_shape(B, H, W, Cout, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(nhwc ? launch<true>(x, packed, bias, out, B, H, W, Cout, rows, s)
                    : launch<false>(x, packed, bias, out, B, H, W, Cout, rows, s));
}

// The launch i2l_conv1_pool_tc makes: dims = (grid x, grid y, threads); returns the dynamic shared
// memory a block in bytes, or -1 where the kernel does not take the shape.
extern "C" int i2l_conv1_tc_launch_shape(int B, int H, int W, int Cout, int rows, int* dims) {
  if (!valid_shape(B, H, W, Cout, rows)) return -1;
  dims[0] = (H / 2 + rows - 1) / rows;
  dims[1] = B;
  dims[2] = kThreads;
  return smem_bytes(W, rows);
}
