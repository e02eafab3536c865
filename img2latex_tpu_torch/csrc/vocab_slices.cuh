// The vocab product of the bf16 row kernels that need a row's whole logits at once
// (sample_step_tc.cu, beam_step_tc.cu), split over a thread-block cluster.
//
// Grid (C, row tiles), clusters of C = min(8, Vp / 64) blocks along x.  The blocks of a cluster
// share a tile of 32 rows; block (rank) r takes the 64-column slices r, r + C, ... of the Vp / 64
// (tile_mma.cuh's 32 x 64 tensor-core product), adds b_out and keeps the float32 logits of each
// slice in its own shared memory (a 32 x 72 float tile, rows padded by 8 floats so that the
// fragments' float2 stores meet no more than the two wavefronts they need).  After a cluster
// barrier any block reads any column of the tile through distributed shared memory.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "tile_mma.cuh"

namespace i2l {
namespace slices {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kMaxCluster = 8;                     // the portable cluster size
constexpr int kPitch = tile::kBN + 8;              // floats a row of a slice tile
constexpr int kSliceFloats = tile::kBM * kPitch;   // 2304: 9,216 bytes a slice
constexpr int kWarps = tile::kThreads / 32;

__host__ __device__ inline int cluster_size(int Vp) {
  const int s = Vp / tile::kBN;
  return s < kMaxCluster ? s : kMaxCluster;
}

// Slices a block holds (the first rank's count, the most any rank has).
__host__ __device__ inline int slices_a_block(int Vp) {
  const int s = Vp / tile::kBN, C = cluster_size(Vp);
  return (s + C - 1) / C;
}

// Dynamic shared memory of a block: the product's cp.async ring, then its slices' logits.
__host__ __device__ inline int smem_bytes(int Vp) {
  return tile::kSmemBytes + slices_a_block(Vp) * kSliceFloats * (int)sizeof(float);
}

// logits of this block's slices: lg + n kSliceFloats holds slice rank + n C, row i of the tile
// at i kPitch, column c of the slice at c.  Rows past M are 0 + b_out.  Every thread of the
// block calls it; it returns with the block synchronised.
template <bool kAligned>
__device__ __forceinline__ void block_slices(float* lg, bf16* ring, const bf16* __restrict__ A,
                                             const bf16* __restrict__ w_out, const float* __restrict__ b_out,
                                             int M, int H, int Vp, int row0, int rank, int C) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / tile::kWN, wn = warp % tile::kWN, g = lane / 4, q = lane % 4;
  for (int sl = rank, n = 0; sl < Vp / tile::kBN; sl += C, ++n) {
    float acc[2][4];
    tile::block_product<kAligned>(acc, ring, A, w_out, M, Vp, H, row0, sl * tile::kBN);
    float* dst = lg + n * kSliceFloats + (wm * 16 + g) * kPitch;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = wn * 16 + j * 8 + 2 * q;
      const float b0 = b_out[sl * tile::kBN + c], b1 = b_out[sl * tile::kBN + c + 1];
      *reinterpret_cast<float2*>(dst + c) = make_float2(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<float2*>(dst + 8 * kPitch + c) = make_float2(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
  __syncthreads();
}

// Address of column col of tile row i, in the block of the cluster that holds it.
__device__ __forceinline__ const float* column(cg::cluster_group& cluster, float* lg, int i, int col, int C) {
  const int sl = col / tile::kBN;
  return cluster.map_shared_rank(lg, sl % C) + (sl / C) * kSliceFloats + i * kPitch + col % tile::kBN;
}

// Launch of a cluster kernel: grid (C, tiles), clusters of C along x, smem bytes of dynamic shared
// memory (the kernel is allowed max_smem, the most any of its launches takes, once a device).
// Returns the launch error, or the error a refused launch left behind.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int C, int tiles, int smem, int max_smem, bool (&done)[16],
                            cudaStream_t stream, Args... args) {
  cudaError_t err = allow_dynamic_smem(kernel, max_smem, done);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, tiles);
  cfg.blockDim = dim3(tile::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // read (and cleared) either way
  return err != cudaSuccess ? err : last;
}

}  // namespace slices
}  // namespace i2l
