// Flash-attention forward for Hopper (sm_90a): three variants of one kernel.
//
// Replaces the Pallas TPU kernels of pcdms_tpu/ops/flash_attention.py:
//   * FROZEN  -> _flash_kernel_frozen (l.154-204) with its XLA m0 prepass
//                (_flash_attention_3d l.272-280): the per-row max is fixed
//                in advance, m0 = max(first <=128 scores) + 24 (exp2 domain),
//                so the inner loop is subtract, exp2, P.V; no rescale.
//   * ONLINE  -> _flash_kernel (l.71-151): running max and alpha-rescale,
//                optionally with the score tile demoted to bf16 before
//                max / exp2 (PCDMS_EXP_BF16, l.122-133).
//   * SHORTKV -> _shortkv_kernel (l.316-333): one-pass softmax with the exact
//                row max; here a first pass over all (<= 384) keys finds it.
// All compute softmax(q.k^T * scale) . v over (B*H, L, 64), non-causal, in
// the exp2 domain with f32 scores, f32 accumulators and an f32 row-sum; the
// output is acc / max(l, 1e-30). Keys past kv_len are masked to -1e30.
//
// What bounds it on this card: at the UNet's level 0 (L = 8192, d = 64) the
// work is 4.L^2.d flops and L^2 exp2 per (batch, head): about 1.37 TFLOP and
// 5.4 G exp2 at batch 8 with CFG (B.H = 80), i.e. about 1.39 ms at 989 TF/s
// dense bf16 and about 1.4 ms at the ~3.9 T/s special-function rate, against
// a few MB of q/k/v/o traffic. It is bound by operations (tensor core and
// exp2), never by bytes: each k/v tile is reused by all 64 q rows of a block.
//
// What the design does about it (a simple, correct first version):
//   * bf16: one block owns 64 q rows (4 warps x 16 rows) and loops over k/v
//     tiles of 64 keys staged in shared memory. Q.K^T and P.V run on the
//     tensor cores (mma.sync m16n8k16 bf16, f32 accumulate); the score tile
//     never leaves registers and P is re-packed in registers as the A
//     operand of P.V (the FlashAttention-2 layout). V's B fragments come
//     from ldmatrix.trans. Rows are padded to 72 elements (144 B) so both
//     the K loads and ldmatrix are free of bank conflicts.
//   * P is kept in bf16, never fp16: with the frozen m0 = rowmax + 24, the
//     first keys' weights are <= 2^-24, which fp16 would flush.
//   * f32 (a spot-check route, not the main path): one thread per q row with
//     FMA dot products against f32 k/v tiles in shared memory, so f32 inputs
//     keep full f32 precision (tensor-core TF32 would not).
//   * Not yet done (later work): wgmma, TMA, a multi-stage k/v pipeline and
//     warp specialisation.
//
// The plain-C entries return cudaGetLastError(); they never synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head_dim
constexpr int kBlockQ = 64;        // q rows per block
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kStride = kD + 8;    // padded bf16 row in shared memory
constexpr int kThreadsBf16 = 128;  // 4 warps x 16 q rows
constexpr int kThreadsF32 = kBlockQ;
constexpr float kNegInf = -1e30f;
constexpr float kFrozenMargin = 24.0f;
constexpr int kFrozenKeys = 128;

enum Mode { kFrozen = 0, kOnline = 1, kShortKv = 2 };

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

// rows [row0, row0 + kBlockK) of a (len, kD) bf16 matrix -> shared tile,
// zero-filled past len (so masked keys multiply zeros, never garbage)
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int row0, int len) {
  for (int c = threadIdx.x; c < kBlockK * (kD / 8); c += blockDim.x) {
    const int r = c >> 3, col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * kD +
                                            col);
    *reinterpret_cast<uint4*>(dst + r * kStride + col) = val;
  }
}

// One warp's 16 x 64 score tile, exp2 domain, masked past `limit`.
// s[nt][e]: row g (e < 2) or g + 8 (e >= 2), key k0 + nt*8 + 2*t4 + (e & 1).
__device__ __forceinline__ void tile_scores(float s[8][4],
                                            const uint32_t qa[4][4],
                                            const __nv_bfloat16* ks, int k0,
                                            int limit, float scale_log2,
                                            int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const __nv_bfloat16* p = ks + (nt * 8 + g) * kStride + kc * 16 + t4 * 2;
      mma_bf16(s[nt], qa[kc], ld32(p), ld32(p + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
      s[nt][e] = key < limit ? s[nt][e] * scale_log2 : kNegInf;
    }
  }
}

template <int MODE, bool EXP_BF16>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int lq, int lk,
                   float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * kStride];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  q += (size_t)bh * lq * kD;
  o += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g, r1 = r0 + 8;
  const bool live0 = r0 < lq, live1 = r1 < lq;

  // Q as mma A fragments (16 rows x 64 d per warp), zero past lq
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qa[kc][0] = live0 ? ld32(q + (size_t)r0 * kD + c) : 0u;
    qa[kc][1] = live1 ? ld32(q + (size_t)r1 * kD + c) : 0u;
    qa[kc][2] = live0 ? ld32(q + (size_t)r0 * kD + c + 8) : 0u;
    qa[kc][3] = live1 ? ld32(q + (size_t)r1 * kD + c + 8) : 0u;
  }

  float m[2] = {kNegInf, kNegInf};
  if (MODE != kOnline) {
    // first pass: the row max over the first 128 keys (frozen) or all keys
    // (short kv); q.k^T only
    const int limit = MODE == kFrozen ? min(lk, kFrozenKeys) : lk;
    for (int k0 = 0; k0 < limit; k0 += kBlockK) {
      __syncthreads();
      load_tile_bf16(ks, k, k0, lk);
      __syncthreads();
      float s[8][4];
      tile_scores(s, qa, ks, k0, limit, scale_log2, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
        m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
      }
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    if (MODE == kFrozen) {
      m[0] += kFrozenMargin;
      m[1] += kFrozenMargin;
    }
  }

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l[2] = {0.f, 0.f};  // this lane's share of the row-sums

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();
    load_tile_bf16(ks, k, k0, lk);
    load_tile_bf16(vs, v, k0, lk);
    __syncthreads();

    float s[8][4];
    tile_scores(s, qa, ks, k0, lk, scale_log2, lane);

    if (MODE == kOnline) {
      float mc[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (EXP_BF16) s[nt][e] = round_bf16(s[nt][e]);
          mc[e >> 1] = fmaxf(mc[e >> 1], s[nt][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mc[r]));
        const float alpha = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < 8; ++dt) {
          acc[dt][2 * r] *= alpha;
          acc[dt][2 * r + 1] *= alpha;
        }
      }
    }

    // P = exp2(s - m) in bf16 (the A operand of P.V); the row-sum adds the
    // same rounded weights the numerator uses
    const float mb[2] = {round_bf16(m[0]), round_bf16(m[1])};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p;
        if (MODE == kOnline && EXP_BF16)
          p = round_bf16(exp2f(round_bf16(s[nt][e] - mb[e >> 1])));
        else
          p = round_bf16(exp2f(s[nt][e] - m[e >> 1]));
        s[nt][e] = p;
        l[e >> 1] += p;
      }
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    // acc += P . V: B fragments of V (keys x d) via ldmatrix.trans, two
    // 8-column d tiles per x4 load
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        const int key = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (dp * 2 + (lane >> 4)) * 8;
        ldmatrix_x4_trans(b, vs + key * kStride + col);
        mma_bf16(acc[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (live0)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * kD + c) =
          pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    if (live1)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * kD + c) =
          pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

// rows [row0, row0 + kBlockK) of a (len, kD) f32 matrix -> shared tile
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int len) {
  for (int c = threadIdx.x; c < kBlockK * (kD / 4); c += blockDim.x) {
    const int r = c >> 4, col = (c & 15) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < len)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * kD +
                                             col);
    *reinterpret_cast<float4*>(dst + r * kD + col) = val;
  }
}

template <int MODE, bool EXP_BF16>
__global__ void __launch_bounds__(kThreadsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int lq,
                  int lk, float scale_log2) {
  __shared__ __align__(16) float ks[kBlockK * kD];
  __shared__ __align__(16) float vs[kBlockK * kD];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool live = row < lq;
  q += (size_t)bh * lq * kD;
  o += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = live ? q[(size_t)row * kD + d] : 0.f;

  float m = kNegInf;
  if (MODE != kOnline) {
    const int limit = MODE == kFrozen ? min(lk, kFrozenKeys) : lk;
    for (int k0 = 0; k0 < limit; k0 += kBlockK) {
      __syncthreads();
      load_tile_f32(ks, k, k0, lk);
      __syncthreads();
      const int n = min(kBlockK, limit - k0);
      for (int j = 0; j < n; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) s = fmaf(qr[d], ks[j * kD + d], s);
        m = fmaxf(m, s * scale_log2);
      }
    }
    if (MODE == kFrozen) m += kFrozenMargin;
  }

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();
    load_tile_f32(ks, k, k0, lk);
    load_tile_f32(vs, v, k0, lk);
    __syncthreads();
    const int n = min(kBlockK, lk - k0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) s = fmaf(qr[d], ks[j * kD + d], s);
      s *= scale_log2;
      float p;
      if (MODE == kOnline) {
        if (EXP_BF16) s = round_bf16(s);
        if (s > m) {
          const float alpha = exp2f(m - s);
          m = s;
          l *= alpha;
#pragma unroll
          for (int d = 0; d < kD; ++d) acc[d] *= alpha;
        }
        p = EXP_BF16 ? round_bf16(exp2f(round_bf16(s - round_bf16(m))))
                     : exp2f(s - m);
      } else {
        p = exp2f(s - m);
      }
      l += p;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vs[j * kD + d], acc[d]);
    }
  }

  if (live) {
    const float ls = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < kD; ++d) o[(size_t)row * kD + d] = acc[d] / ls;
  }
}

template <int MODE, bool EXP_BF16>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int lq, int lk, float scale_log2, int is_bf16, void* stream) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_fwd_bf16<MODE, EXP_BF16><<<grid, kThreadsBf16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lq, lk, scale_log2);
  else
    flash_fwd_f32<MODE, EXP_BF16><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lq, lk,
        scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (bh, lq | lk, 64), bf16 (is_bf16 = 1) or f32.
// scale_log2 = softmax scale * log2(e).
extern "C" int pcdms_flash_frozen(const void* q, const void* k, const void* v,
                                  void* o, int bh, int lq, int lk,
                                  float scale_log2, int is_bf16,
                                  void* stream) {
  return launch<kFrozen, false>(q, k, v, o, bh, lq, lk, scale_log2, is_bf16,
                                stream);
}

extern "C" int pcdms_flash_online(const void* q, const void* k, const void* v,
                                  void* o, int bh, int lq, int lk,
                                  float scale_log2, int is_bf16, int exp_bf16,
                                  void* stream) {
  if (exp_bf16)
    return launch<kOnline, true>(q, k, v, o, bh, lq, lk, scale_log2, is_bf16,
                                 stream);
  return launch<kOnline, false>(q, k, v, o, bh, lq, lk, scale_log2, is_bf16,
                                stream);
}

extern "C" int pcdms_flash_shortkv(const void* q, const void* k,
                                   const void* v, void* o, int bh, int lq,
                                   int lk, float scale_log2, int is_bf16,
                                   void* stream) {
  return launch<kShortKv, false>(q, k, v, o, bh, lq, lk, scale_log2, is_bf16,
                                 stream);
}
