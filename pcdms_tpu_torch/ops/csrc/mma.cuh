// Helpers shared by the f32 flash-attention kernels (forward and backward)
// and the fused GroupNorm + SiLU + conv3x3 kernel (mma_bf16, ldmatrix).
//
// The warp-level tensor-core product is mma.sync m16n8k16 (bf16 in, f32
// accumulate); a warp's accumulator tile c[e] holds row g (e < 2) or g + 8
// (e >= 2) and column 2 * t4 + (e & 1) of an 8-column tile, with g = lane /
// 4 and t4 = lane % 4. The bf16 attention kernels use the wgmma wrappers of
// hopper.cuh instead; of this file they take the scalar helpers.

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a . b, m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const __nv_bfloat16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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
