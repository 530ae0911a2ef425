// Flash-attention forward for Hopper (sm_90a): four variants of one kernel.
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
//                It alone also takes head_dim 80 (CLIP ViT-H's 16 heads of
//                80): the JAX kernel takes any head_dim, padding v to d_aug
//                (l.338-350); here the kernel is a template on D, and D = 80
//                is five mma k-steps of 16 for Q.K^T and ten 8-column
//                tiles for P.V.
// and of pcdms_tpu/ops/flash_attention_bwd.py:
//   * ONLINE with an lse output -> _fwd_lse_kernel (l.53-92): the training
//                forward, which also writes L = m + log2(l) per row for the
//                backward kernels (flash_attention_bwd.cu).
// All compute softmax(q.k^T * scale) . v over (B*H, L, D), non-causal, in
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

#include "mma.cuh"

namespace {

using namespace pcdms;

constexpr int kBlockQ = 64;        // q rows per block
constexpr int kBlockK = kTile;     // keys per shared-memory tile
constexpr int kThreadsBf16 = 128;  // 4 warps x 16 q rows
constexpr int kThreadsF32 = kBlockQ;
constexpr float kFrozenMargin = 24.0f;
constexpr int kFrozenKeys = 128;

enum Mode { kFrozen = 0, kOnline = 1, kShortKv = 2 };

// One warp's 16 x 64 score tile, exp2 domain, masked past `limit`.
// s[nt][e]: row g (e < 2) or g + 8 (e >= 2), key k0 + nt*8 + 2*t4 + (e & 1).
template <int D>
__device__ __forceinline__ void tile_scores(float s[8][4],
                                            const uint32_t qa[][4],
                                            const __nv_bfloat16* ks, int k0,
                                            int limit, float scale_log2,
                                            int lane) {
  const int t4 = lane & 3;
  mma_abt<D>(s, qa, ks, lane);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
      s[nt][e] = key < limit ? s[nt][e] * scale_log2 : kNegInf;
    }
  }
}

template <int MODE, bool EXP_BF16, int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o,
                   float* __restrict__ lse, int lq, int lk,
                   float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * stride_of<D>()];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * stride_of<D>()];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  q += (size_t)bh * lq * D;
  o += (size_t)bh * lq * D;
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;
  const int r0 = blockIdx.x * kBlockQ + warp * 16 + g, r1 = r0 + 8;
  const bool live0 = r0 < lq, live1 = r1 < lq;

  // Q as mma A fragments (16 rows x D per warp), zero past lq
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, q, blockIdx.x * kBlockQ + warp * 16, lq, lane);

  float m[2] = {kNegInf, kNegInf};
  if (MODE != kOnline) {
    // first pass: the row max over the first 128 keys (frozen) or all keys
    // (short kv); q.k^T only
    const int limit = MODE == kFrozen ? min(lk, kFrozenKeys) : lk;
    for (int k0 = 0; k0 < limit; k0 += kBlockK) {
      __syncthreads();
      load_tile_bf16<D>(ks, k, k0, lk);
      __syncthreads();
      float s[8][4];
      tile_scores<D>(s, qa, ks, k0, limit, scale_log2, lane);
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

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float l[2] = {0.f, 0.f};  // this lane's share of the row-sums

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();
    load_tile_bf16<D>(ks, k, k0, lk);
    load_tile_bf16<D>(vs, v, k0, lk);
    __syncthreads();

    float s[8][4];
    tile_scores<D>(s, qa, ks, k0, lk, scale_log2, lane);

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
        for (int dt = 0; dt < D / 8; ++dt) {
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
    pack_a(pa, s);
    mma_ab<D>(acc, pa, vs, lane);   // acc += P . V
  }

  const float l0 = fmaxf(quad_sum(l[0]), 1e-30f);
  const float l1 = fmaxf(quad_sum(l[1]), 1e-30f);
  if (lse != nullptr && t4 == 0) {
    // per-row log2-sum-exp2 L = m + log2(l), which the backward reads
    lse += (size_t)bh * lq;
    if (live0) lse[r0] = m[0] + log2f(l0);
    if (live1) lse[r1] = m[1] + log2f(l1);
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + t4 * 2;
    if (live0)
      *reinterpret_cast<uint32_t*>(o + (size_t)r0 * D + c) =
          pack_bf16(acc[dt][0] / l0, acc[dt][1] / l0);
    if (live1)
      *reinterpret_cast<uint32_t*>(o + (size_t)r1 * D + c) =
          pack_bf16(acc[dt][2] / l1, acc[dt][3] / l1);
  }
}

template <int MODE, bool EXP_BF16, int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int lq, int lk, float scale_log2) {
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int bh = blockIdx.y;
  const int row = blockIdx.x * kBlockQ + threadIdx.x;
  const bool live = row < lq;
  q += (size_t)bh * lq * D;
  o += (size_t)bh * lq * D;
  k += (size_t)bh * lk * D;
  v += (size_t)bh * lk * D;

  float qr[D];
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = live ? q[(size_t)row * D + d] : 0.f;

  float m = kNegInf;
  if (MODE != kOnline) {
    const int limit = MODE == kFrozen ? min(lk, kFrozenKeys) : lk;
    for (int k0 = 0; k0 < limit; k0 += kBlockK) {
      __syncthreads();
      load_tile_f32<D>(ks, k, k0, lk);
      __syncthreads();
      const int n = min(kBlockK, limit - k0);
      for (int j = 0; j < n; ++j) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
        m = fmaxf(m, s * scale_log2);
      }
    }
    if (MODE == kFrozen) m += kFrozenMargin;
  }

  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float l = 0.f;

  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();
    load_tile_f32<D>(ks, k, k0, lk);
    load_tile_f32<D>(vs, v, k0, lk);
    __syncthreads();
    const int n = min(kBlockK, lk - k0);
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j * D + d], s);
      s *= scale_log2;
      float p;
      if (MODE == kOnline) {
        if (EXP_BF16) s = round_bf16(s);
        if (s > m) {
          const float alpha = exp2f(m - s);
          m = s;
          l *= alpha;
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] *= alpha;
        }
        p = EXP_BF16 ? round_bf16(exp2f(round_bf16(s - round_bf16(m))))
                     : exp2f(s - m);
      } else {
        p = exp2f(s - m);
      }
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j * D + d], acc[d]);
    }
  }

  if (live) {
    const float ls = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) o[(size_t)row * D + d] = acc[d] / ls;
    if (lse != nullptr) lse[(size_t)bh * lq + row] = m + log2f(ls);
  }
}

template <int MODE, bool EXP_BF16, int D = kD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int lq, int lk, float scale_log2, int is_bf16,
           void* stream) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    flash_fwd_bf16<MODE, EXP_BF16, D><<<grid, kThreadsBf16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lse, lq, lk, scale_log2);
  else
    flash_fwd_f32<MODE, EXP_BF16, D><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, lq, lk,
        scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: contiguous (bh, lq | lk, 64), bf16 (is_bf16 = 1) or f32
// (head_dim 64 or 80 for the short-kv entry, which takes it as an argument).
// scale_log2 = softmax scale * log2(e).
extern "C" int pcdms_flash_frozen(const void* q, const void* k, const void* v,
                                  void* o, int bh, int lq, int lk,
                                  float scale_log2, int is_bf16,
                                  void* stream) {
  return launch<kFrozen, false>(q, k, v, o, nullptr, bh, lq, lk,
                                scale_log2, is_bf16, stream);
}

extern "C" int pcdms_flash_online(const void* q, const void* k, const void* v,
                                  void* o, int bh, int lq, int lk,
                                  float scale_log2, int is_bf16, int exp_bf16,
                                  void* stream) {
  if (exp_bf16)
    return launch<kOnline, true>(q, k, v, o, nullptr, bh, lq, lk,
                                 scale_log2, is_bf16, stream);
  return launch<kOnline, false>(q, k, v, o, nullptr, bh, lq, lk,
                                scale_log2, is_bf16, stream);
}

extern "C" int pcdms_flash_shortkv(const void* q, const void* k,
                                   const void* v, void* o, int bh, int lq,
                                   int lk, float scale_log2, int is_bf16,
                                   int head_dim, void* stream) {
  if (head_dim == 80)
    return launch<kShortKv, false, 80>(q, k, v, o, nullptr, bh, lq, lk,
                                       scale_log2, is_bf16, stream);
  if (head_dim != kD) return static_cast<int>(cudaErrorInvalidValue);
  return launch<kShortKv, false>(q, k, v, o, nullptr, bh, lq, lk,
                                 scale_log2, is_bf16, stream);
}

// The online variant that also writes lse (bh, lq) f32: the per-row
// log2-sum-exp2 L = m + log2(l) of the exp2-domain scores (the training
// forward, replacing _fwd_lse_kernel of pcdms_tpu/ops/flash_attention_bwd.py).
extern "C" int pcdms_flash_fwd_lse(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int lq, int lk, float scale_log2,
                                   int is_bf16, void* stream) {
  return launch<kOnline, false>(q, k, v, o, static_cast<float*>(lse), bh, lq,
                                lk, scale_log2, is_bf16, stream);
}
