// Helpers shared by the flash-attention kernels (forward and backward): the
// head width and tile of the f32 kernels, their tile loader, and the scalar
// helpers the bf16 kernels take beside hopper.cuh (bf16 rounding, the max
// across the 4 lanes of a quad, which hold one accumulator row between
// them). No kernel of the port runs warp-level mma.sync any more.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pcdms {

constexpr int kD = 64;             // head_dim
constexpr int kTile = 64;          // rows of a q / k tile in shared memory

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// the 4 lanes of a quad hold one accumulator row between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// rows [row0, row0 + kTile) of a (len, D) f32 matrix -> unpadded shared
// tile, zero-filled past len
template <int D = kD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int len) {
  constexpr int kChunks = D / 4;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D +
                                             col);
    *reinterpret_cast<float4*>(dst + r * D + col) = val;
  }
}

}  // namespace pcdms
