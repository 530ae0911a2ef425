// Tile helpers shared by the flash-attention kernels (forward and backward)
// and the fused GroupNorm + SiLU + conv3x3 kernel (mma_bf16, ldmatrix).
//
// Layout conventions: a (len, D) bf16 matrix (head_dim D = 64, or 80 for the
// short-kv kernel) is staged in shared memory as rows padded to D + 8
// elements (144 B at 64, 176 B at 80), which keeps both the 32-bit fragment
// loads and ldmatrix free of bank conflicts. The helpers take D as a
// template argument that defaults to 64. The tensor-core product is
// mma.sync m16n8k16 (bf16 in, f32 accumulate); a warp's
// accumulator tile c[nt][e] holds row g (e < 2) or g + 8 (e >= 2) and
// column nt * 8 + 2 * t4 + (e & 1), with g = lane / 4 and t4 = lane % 4.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pcdms {

constexpr int kD = 64;             // head_dim
constexpr int kTile = 64;          // rows of a q / k tile in shared memory
constexpr int kStride = kD + 8;    // padded bf16 row in shared memory

template <int D>
__host__ __device__ constexpr int stride_of() { return D + 8; }

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + kTile) of a (len, D) bf16 matrix -> padded shared
// tile, zero-filled past len (so masked rows multiply zeros, never garbage)
template <int D = kD>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int len) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += blockDim.x) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D +
                                            col);
    *reinterpret_cast<uint4*>(dst + r * stride_of<D>() + col) = val;
  }
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

// A fragments of 16 rows x D of a (len, D) bf16 matrix in global memory
// (D / 16 k-steps), rows r0 = row0 + g and r1 = r0 + 8, zero past len
template <int D = kD>
__device__ __forceinline__ void load_a_frags(uint32_t a[][4],
                                             const __nv_bfloat16* src,
                                             int row0, int len, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
  const bool live0 = r0 < len, live1 = r1 < len;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + t4 * 2;
    a[kc][0] = live0 ? ld32(src + (size_t)r0 * D + c) : 0u;
    a[kc][1] = live1 ? ld32(src + (size_t)r1 * D + c) : 0u;
    a[kc][2] = live0 ? ld32(src + (size_t)r0 * D + c + 8) : 0u;
    a[kc][3] = live1 ? ld32(src + (size_t)r1 * D + c + 8) : 0u;
  }
}

// c[nt] = a . tile^T for a warp's 16 rows (k = D) against the 64 rows of a
// padded shared tile (16 x 64 result, f32)
template <int D = kD>
__device__ __forceinline__ void mma_abt(float c[8][4], const uint32_t a[][4],
                                        const __nv_bfloat16* tile, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const __nv_bfloat16* p = tile + (nt * 8 + g) * stride_of<D>() +
                               kc * 16 + t4 * 2;
      mma_bf16(c[nt], a[kc], ld32(p), ld32(p + 8));
    }
  }
}

// a 16 x 64 f32 accumulator tile, rounded to bf16 and re-packed in
// registers as the A operand (16 x 64, k = the tile's columns) of a
// following product
__device__ __forceinline__ void pack_a(uint32_t a[4][4], const float c[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc += a . tile for a (16 x 64) A operand against a padded shared tile of
// 64 rows x D (k = the tile's rows), B fragments via ldmatrix.trans, two
// 8-column d tiles per x4 load
template <int D = kD>
__device__ __forceinline__ void mma_ab(float acc[][4], const uint32_t a[4][4],
                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      const int row = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int col = (dp * 2 + (lane >> 4)) * 8;
      ldmatrix_x4_trans(b, tile + row * stride_of<D>() + col);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// write a warp's 16 x 64 f32 accumulator (rows r0 = row0 + g, r1 = r0 + 8)
// times `mul` to a (len, kD) bf16 matrix, rows past len skipped
__device__ __forceinline__ void store_acc_bf16(__nv_bfloat16* dst,
                                               const float acc[8][4],
                                               int row0, int len, float mul0,
                                               float mul1, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (r0 < len)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * kD + c) =
          pack_bf16(acc[dt][0] * mul0, acc[dt][1] * mul0);
    if (r1 < len)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r1 * kD + c) =
          pack_bf16(acc[dt][2] * mul1, acc[dt][3] * mul1);
  }
}

}  // namespace pcdms
