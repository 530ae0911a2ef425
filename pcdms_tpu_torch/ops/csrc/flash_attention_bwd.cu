// Flash-attention backward for Hopper (sm_90a): the dq and dk/dv kernels.
//
// Replace the Pallas TPU kernels of pcdms_tpu/ops/flash_attention_bwd.py:
//   * DQ  -> _dq_kernel (l.154-183): dq = scale . sum_j dS_ij k_j
//   * DKV -> _dkv_kernel (l.190-227): dv = sum_i P_ij dO_i and
//            dk = scale . sum_i dS_ij q_i
// with P = exp2(q.k^T . scale . log2(e) - L) rebuilt from the forward's
// per-row L = m + log2(l) (pcdms_flash_fwd_lse in flash_attention.cu), no
// online rescale, and dS = P o (dO.v^T - D), D = rowsum(dO o O) computed by
// the caller (a torch reduction, as the JAX package leaves it to XLA).
// P (for dv) and dS are rounded to the input dtype before their products,
// as in JAX; scores, P, D and every accumulator stay f32.
//
// What bounds it on this card: per (batch, head) the two kernels do five
// L_q x L_k x 64 products (S and dP in both, dS.K in dq, P^T.dO and dS^T.Q
// in dk/dv; S and dP are recomputed once each): 7 . 2 . Lq . Lk . 64 flops
// issued, 5 of them needed, and Lq . Lk exp2 per kernel, against a few MB
// of q/k/v/o/dO/dq/dk/dv traffic. At the training shapes (L up to 8192)
// it is bound by operations, never by bytes.
//
// What the design does about it (a simple, correct first version):
//   * The dq / dk-dv split needs no atomics and is deterministic, as in
//     JAX: dq owns q tiles and loops over k tiles, dk/dv own k tiles and
//     loop over q tiles.
//   * bf16: 4 warps x 16 rows per block; the block's own rows (q for dq,
//     k and v for dk/dv) live in registers as mma A fragments; the looped
//     operand's 64-row tiles are staged in padded shared memory. All
//     products are mma.sync m16n8k16 (bf16 in, f32 accumulate). dk/dv
//     computes the transposed tiles S^T = K.Q^T and dP^T = V.dO^T directly,
//     so P^T and dS^T sit in the C fragments with the key as row and are
//     re-packed in registers as the A operand of P^T.dO and dS^T.Q, the way
//     the forward re-packs P for P.V; L and D then index columns.
//   * Ragged edges: tiles are zero-filled past the length; keys past lk
//     (dq) and q rows past lq (dk/dv) get P = 0 explicitly, so no padded
//     row or column contributes and no uninitialised value is read.
//   * f32 (--mixed_precision no): FMA kernels, two threads per row, each
//     holding every other element of the row; the dot products are summed
//     across the pair by one shuffle.
//   * Not yet done (later work): wgmma, TMA, pipelining, and one fused
//     kernel that recomputes S and dP once for both outputs.
//
// The plain-C entries return cudaGetLastError(); they never synchronise.

#include "mma.cuh"

namespace {

using namespace pcdms;

constexpr int kThreads = 128;   // 4 warps x 16 rows (bf16); 2 per row (f32)
constexpr int kHalf = kD / 2;   // elements of a row held by one f32 thread

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    flash_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dq, int lq, int lk,
                  float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kStride];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  q += (size_t)bh * lq * kD;
  dout += (size_t)bh * lq * kD;
  dq += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;
  lse += (size_t)bh * lq;
  dsum += (size_t)bh * lq;
  const int row0 = blockIdx.x * kTile + warp * 16;
  const int r0 = row0 + g, r1 = r0 + 8;

  uint32_t qa[4][4], da[4][4];   // this warp's q and dO rows
  load_a_frags(qa, q, row0, lq, lane);
  load_a_frags(da, dout, row0, lq, lane);
  const float ell[2] = {r0 < lq ? lse[r0] : 0.f, r1 < lq ? lse[r1] : 0.f};
  const float dd[2] = {r0 < lq ? dsum[r0] : 0.f, r1 < lq ? dsum[r1] : 0.f};

  float acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  for (int kt0 = 0; kt0 < lk; kt0 += kTile) {
    __syncthreads();
    load_tile_bf16(ks, k, kt0, lk);
    load_tile_bf16(vs, v, kt0, lk);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt(s, qa, ks, lane);    // S = Q.K^T
    mma_abt(dp, da, vs, lane);   // dP = dO.V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + nt * 8 + 2 * t4 + (e & 1);
        const float p =
            key < lk ? exp2f(s[nt][e] * scale_log2 - ell[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dd[e >> 1]);   // dS
      }
    }
    uint32_t dsa[4][4];
    pack_a(dsa, dp);
    mma_ab(acc, dsa, ks, lane);   // acc += dS.K
  }
  store_acc_bf16(dq, acc, row0, lq, scale, scale, lane);
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int lq, int lk,
                   float scale_log2, float scale) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kStride];
  __shared__ float ls[kTile], dsm[kTile];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  q += (size_t)bh * lq * kD;
  dout += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;
  dk += (size_t)bh * lk * kD;
  dv += (size_t)bh * lk * kD;
  lse += (size_t)bh * lq;
  dsum += (size_t)bh * lq;
  const int key0 = blockIdx.x * kTile + warp * 16;

  uint32_t ka[4][4], va[4][4];   // this warp's k and v rows
  load_a_frags(ka, k, key0, lk, lane);
  load_a_frags(va, v, key0, lk, lane);

  float dka[8][4], dva[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;
  }

  for (int qt0 = 0; qt0 < lq; qt0 += kTile) {
    __syncthreads();
    load_tile_bf16(qs, q, qt0, lq);
    load_tile_bf16(dos, dout, qt0, lq);
    for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
      const bool live = qt0 + c < lq;
      ls[c] = live ? lse[qt0 + c] : 0.f;
      dsm[c] = live ? dsum[qt0 + c] : 0.f;
    }
    __syncthreads();

    // P^T (keys x q rows), masked past lq
    float pt[8][4];
    mma_abt(pt, ka, qs, lane);   // S^T = K.Q^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        pt[nt][e] = qt0 + col < lq
                        ? exp2f(pt[nt][e] * scale_log2 - ls[col])
                        : 0.f;
      }
    }
    uint32_t a[4][4];
    pack_a(a, pt);
    mma_ab(dva, a, dos, lane);   // dv += P^T.dO

    float dpt[8][4];
    mma_abt(dpt, va, dos, lane);   // dP^T = V.dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t4 + (e & 1);
        dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - dsm[col]);   // dS^T
      }
    }
    pack_a(a, dpt);
    mma_ab(dka, a, qs, lane);   // dk += dS^T.Q
  }
  store_acc_bf16(dk, dka, key0, lk, scale, scale, lane);
  store_acc_bf16(dv, dva, key0, lk, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// f32, FMA: thread 2r + h of a block owns elements h, h + 2, ... of row r
// ---------------------------------------------------------------------------

__device__ __forceinline__ float pair_dot(const float a[kHalf],
                                          const float* row, int half) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) s = fmaf(a[i], row[2 * i + half], s);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

__global__ void __launch_bounds__(kThreads)
    flash_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, float* __restrict__ dq,
                 int lq, int lk, float scale_log2, float scale) {
  __shared__ __align__(16) float ks[kTile * kD];
  __shared__ __align__(16) float vs[kTile * kD];

  const int bh = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int row = blockIdx.x * kTile + (threadIdx.x >> 1);
  const bool live = row < lq;
  q += (size_t)bh * lq * kD;
  dout += (size_t)bh * lq * kD;
  dq += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;

  float qr[kHalf], dor[kHalf], acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    qr[i] = live ? q[(size_t)row * kD + 2 * i + half] : 0.f;
    dor[i] = live ? dout[(size_t)row * kD + 2 * i + half] : 0.f;
    acc[i] = 0.f;
  }
  const float ell = live ? lse[(size_t)bh * lq + row] : 0.f;
  const float dd = live ? dsum[(size_t)bh * lq + row] : 0.f;

  for (int kt0 = 0; kt0 < lk; kt0 += kTile) {
    __syncthreads();
    load_tile_f32(ks, k, kt0, lk);
    load_tile_f32(vs, v, kt0, lk);
    __syncthreads();
    const int n = min(kTile, lk - kt0);
    for (int j = 0; j < n; ++j) {
      const float s = pair_dot(qr, ks + j * kD, half);
      const float dp = pair_dot(dor, vs + j * kD, half);
      const float ds = exp2f(s * scale_log2 - ell) * (dp - dd);
#pragma unroll
      for (int i = 0; i < kHalf; ++i)
        acc[i] = fmaf(ds, ks[j * kD + 2 * i + half], acc[i]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      dq[(size_t)row * kD + 2 * i + half] = acc[i] * scale;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum, float* __restrict__ dk,
                  float* __restrict__ dv, int lq, int lk, float scale_log2,
                  float scale) {
  __shared__ __align__(16) float qs[kTile * kD];
  __shared__ __align__(16) float dos[kTile * kD];
  __shared__ float ls[kTile], dsm[kTile];

  const int bh = blockIdx.y;
  const int half = threadIdx.x & 1;
  const int key = blockIdx.x * kTile + (threadIdx.x >> 1);
  const bool live = key < lk;
  q += (size_t)bh * lq * kD;
  dout += (size_t)bh * lq * kD;
  k += (size_t)bh * lk * kD;
  v += (size_t)bh * lk * kD;
  dk += (size_t)bh * lk * kD;
  dv += (size_t)bh * lk * kD;
  lse += (size_t)bh * lq;
  dsum += (size_t)bh * lq;

  float kr[kHalf], vr[kHalf], dka[kHalf], dva[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    kr[i] = live ? k[(size_t)key * kD + 2 * i + half] : 0.f;
    vr[i] = live ? v[(size_t)key * kD + 2 * i + half] : 0.f;
    dka[i] = dva[i] = 0.f;
  }

  for (int qt0 = 0; qt0 < lq; qt0 += kTile) {
    __syncthreads();
    load_tile_f32(qs, q, qt0, lq);
    load_tile_f32(dos, dout, qt0, lq);
    for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
      const bool in = qt0 + c < lq;
      ls[c] = in ? lse[qt0 + c] : 0.f;
      dsm[c] = in ? dsum[qt0 + c] : 0.f;
    }
    __syncthreads();
    const int n = min(kTile, lq - qt0);   // q rows past lq never enter
    for (int j = 0; j < n; ++j) {
      const float p = exp2f(pair_dot(kr, qs + j * kD, half) * scale_log2 -
                            ls[j]);
      const float ds = p * (pair_dot(vr, dos + j * kD, half) - dsm[j]);
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        dva[i] = fmaf(p, dos[j * kD + 2 * i + half], dva[i]);
        dka[i] = fmaf(ds, qs[j * kD + 2 * i + half], dka[i]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      dk[(size_t)key * kD + 2 * i + half] = dka[i] * scale;
      dv[(size_t)key * kD + 2 * i + half] = dva[i];
    }
  }
}

}  // namespace

// q, dout: (bh, lq, 64); k, v: (bh, lk, 64), contiguous, bf16 (is_bf16 = 1)
// or f32; lse, dsum: (bh, lq) f32; dq like q, dk / dv like k.
// scale_log2 = softmax scale * log2(e).
extern "C" int pcdms_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dsum, void* dq, int bh, int lq,
                              int lk, float scale_log2, float scale,
                              int is_bf16, void* stream) {
  const dim3 grid((lq + kTile - 1) / kTile, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  if (is_bf16)
    flash_dq_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), l, d,
        static_cast<__nv_bfloat16*>(dq), lq, lk, scale_log2, scale);
  else
    flash_dq_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dq), lq, lk, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcdms_flash_dkv(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dsum, void* dk, void* dv, int bh,
                               int lq, int lk, float scale_log2, float scale,
                               int is_bf16, void* stream) {
  const dim3 grid((lk + kTile - 1) / kTile, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  if (is_bf16)
    flash_dkv_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<const __nv_bfloat16*>(dout), l, d,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lq,
        lk, scale_log2, scale);
  else
    flash_dkv_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
        static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, scale_log2,
        scale);
  return static_cast<int>(cudaGetLastError());
}
