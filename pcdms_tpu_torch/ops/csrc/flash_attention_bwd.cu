// Flash-attention backward for Hopper (sm_90a): the dq and dk/dv kernels.
//
// Replace the Pallas TPU kernels of pcdms_tpu/ops/flash_attention_bwd.py:
//   * DQ  -> _dq_kernel (l.154-187): dq = scale . sum_j dS_ij k_j
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
// they are bound by operations, never by bytes: the tensor cores must stay
// fed, which on Hopper only wgmma does, and every tile that a block re-reads
// comes from L2, so the copy must run ahead of the arithmetic.
//
// What the design does about it (bf16):
//   * The dq / dk-dv split needs no atomics and is deterministic, as in
//     JAX: dq owns q rows and loops over k / v tiles, dk/dv own keys and
//     loop over q / dO tiles.
//   * Warp specialisation. A block is one producer warpgroup and two
//     consumer warpgroups of 64 rows each: 128 rows a block, one block an
//     SM. setmaxnreg moves the producer's registers to the consumers (40
//     against 232).
//   * A ring in shared memory. One thread of the producer brings the block's
//     own rows (q and dO, or k and v) once, and the looped tiles (dq: k and
//     v, 128 rows a stage, 3 stages; dk/dv: q and dO, 64 rows a stage, 4
//     stages, since its two output accumulators leave no registers for 128-
//     wide S and dP) by TMA,
//     128-byte swizzled, through three-dimensional tensor maps (64, L, BH)
//     that zero-fill past a head's length; each stage has a full and an
//     empty mbarrier. dk/dv's per-column L and D ride in the same stage,
//     copied by the producer warp with 4-byte cp.async that arrive on the
//     stage's full barrier (a head's row of L starts at no 16-byte boundary
//     when Lq is ragged, so no bulk copy can fetch it).
//   * wgmma for every product, f32 accumulators in registers. S = Q.K^T and
//     dP = dO.V^T read both operands from shared memory (K-major); dS, and
//     in dk/dv P^T and dS^T (computed transposed, keys as rows, so that L
//     and D index columns), are re-packed in registers as the A operand,
//     and the same k (or q / dO) tile is read again MN-major (trans-b) as
//     the B operand of dS.K, P^T.dO and dS^T.Q.
//   * Fewer, longer batches of products. Trip j of a consumer queues the
//     second products of tile j - 1 (dS.K; P^T.dO and dS^T.Q) together with
//     S and dP of tile j, so the tensor cores get one long batch per tile
//     and a tile's stage is released one trip later. S is committed and
//     waited for before dP, so a warpgroup's exp2 runs under its own dP
//     product; its dS arithmetic runs under the other warpgroup's products
//     as far as the two drift apart.
//   * Ragged edges: TMA fills rows past the length with zeros, and keys past
//     lk (dq) and q rows past lq (dk/dv) get P = 0 by a select, never by a
//     multiplication (exp2(0 - L) is not 0, and 0 x Inf is NaN); only a
//     tile that crosses the length pays for the select.
//   * Epilogue: the accumulators go to bf16 through the block's own-row
//     buffer (swizzled, conflict-free) and out in 16-byte stores, rows past
//     the length skipped.
//   * Host side: the C entry encodes the four tensor maps of a launch from
//     the pointers it is given and passes them by value (__grid_constant__);
//     the dq and dk/dv launches of one backward need the same four, so the
//     last eight are kept per host thread (hp::MapCache).
//   * f32 (--mixed_precision no): FMA kernels, two threads per row, each
//     holding every other element of the row; the dot products are summed
//     across the pair by one shuffle.
//   * Not done: one fused kernel that recomputes S and dP once for both
//     outputs (it needs atomics for dq and is not deterministic), 2-CTA
//     clusters with multicast, and a persistent grid.
//
// The plain-C entries launch and return cudaGetLastError(); they never
// synchronise.

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pcdms;
namespace hp = pcdms::hopper;

constexpr int kThreads = 128;   // f32 kernels: 2 threads per row
constexpr int kHalf = kD / 2;   // elements of a row held by one f32 thread

// ---------------------------------------------------------------------------
// bf16: TMA ring -> wgmma, warp-specialised
// ---------------------------------------------------------------------------

// the block's shape (two consumer warpgroups of 64 rows and one producer)
// and the helpers it shares with the forward kernels
using hp::kBlockRows;
using hp::kBlockThreads;
using hp::kConsumers;
using hp::kSlice;
using hp::kWg;
using hp::Ring;
using hp::ex2;
using hp::shared_storage;
using hp::store_slice;

constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kDqTile = 128, kDqStages = 3;    // k / v rows a stage
constexpr int kDkvTile = 64, kDkvStages = 4;   // q / dO rows a stage

struct DqSmem {
  __nv_bfloat16 q[kBlockRows * 64], dout[kBlockRows * 64];   // own rows
  __nv_bfloat16 k[kDqStages][kDqTile * 64], v[kDqStages][kDqTile * 64];
  uint64_t own, full[kDqStages], empty[kDqStages];
};

struct DkvSmem {
  __nv_bfloat16 k[kBlockRows * 64], v[kBlockRows * 64];      // own keys
  __nv_bfloat16 q[kDkvStages][kSlice], dout[kDkvStages][kSlice];
  float lse[kDkvStages][kDkvTile], dsum[kDkvStages][kDkvTile];
  uint64_t own, full[kDkvStages], empty[kDkvStages];
};

// P of one 64 x KT tile from S, in place. kMasked: keys from `lk` on get
// P = 0.
template <int KT, bool kMasked>
__device__ __forceinline__ void dq_tile_probs(float (&s)[KT / 2],
                                              const float (&ell)[2],
                                              float scale_log2, int key0,
                                              int lk) {
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    s[i] = ex2(s[i] * scale_log2 - ell[(i >> 1) & 1]);
    if (kMasked && key0 + (i >> 2) * 8 + (i & 1) >= lk) s[i] = 0.f;
  }
}

// dS = P o (dP - D) of the tile, packed as the A operand of dS.K
template <int KT>
__device__ __forceinline__ void dq_tile_ds(uint32_t (&a)[KT / 16][4],
                                           const float (&p)[KT / 2],
                                           float (&dp)[KT / 2],
                                           const float (&dd)[2]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
    for (int i = 8 * kk; i < 8 * kk + 8; ++i)
      dp[i] = p[i] * (dp[i] - dd[(i >> 1) & 1]);
    hp::pack_a(a[kk], dp, kk);
  }
}

// P^T of one 64 x 64 tile from S^T, in place and packed as the A operand of
// P^T.dO. kMasked: q rows (columns here) from `lq` on get P = 0.
template <bool kMasked>
__device__ __forceinline__ void dkv_tile_probs(uint32_t (&ap)[4][4],
                                               float (&pt)[32],
                                               const float* ls,
                                               float scale_log2, int col0,
                                               int lq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + nt * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        pt[i] = ex2(pt[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (kMasked && col0 + nt * 8 + (e & 1) >= lq) pt[i] = 0.f;
      }
    }
    hp::pack_a(ap[kk], pt, kk);
  }
}

// dS^T = P^T o (dP^T - D) of the tile, packed as the A operand of dS^T.Q
__device__ __forceinline__ void dkv_tile_ds(uint32_t (&ads)[4][4],
                                            const float (&pt)[32],
                                            float (&dpt)[32],
                                            const float* dsm) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 2 * kk; nt < 2 * kk + 2; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(dsm + nt * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * nt + e;
        dpt[i] = pt[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
    hp::pack_a(ads[kk], dpt, kk);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_dq_bf16(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dq, int lq, int lk,
                  float scale_log2, float scale) {
  constexpr int KT = kDqTile, ST = kDqStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DqSmem& sm = shared_storage<DqSmem>(smem_raw);

  const int tid = threadIdx.x, wg = tid / kWg;
  const int bh = blockIdx.y, row0 = blockIdx.x * kBlockRows;
  const int n_tiles = (lk + KT - 1) / KT;

  if (tid == 0) {
    hp::mbar_init(&sm.own, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      // one arrival a consumer warp
      hp::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    hp::reg_dealloc<kProducerRegs>();
    if (tid == kConsumers * kWg) {
      hp::mbar_arrive_expect_tx(&sm.own, 2 * kConsumers * hp::kBoxBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        hp::tma_load_rows(sm.q + c * kSlice, &map_q, &sm.own, row0 + c * 64,
                          bh);
        hp::tma_load_rows(sm.dout + c * kSlice, &map_do, &sm.own,
                          row0 + c * 64, bh);
      }
      Ring ring;
      for (int j = 0; j < n_tiles; ++j) {
        hp::mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        hp::mbar_arrive_expect_tx(&sm.full[ring.stage],
                                  2 * (KT / 64) * hp::kBoxBytes);
#pragma unroll
        for (int c = 0; c < KT / 64; ++c) {
          hp::tma_load_rows(sm.k[ring.stage] + c * kSlice, &map_k,
                            &sm.full[ring.stage], j * KT + c * 64, bh);
          hp::tma_load_rows(sm.v[ring.stage] + c * kSlice, &map_v,
                            &sm.full[ring.stage], j * KT + c * 64, bh);
        }
        ring.advance<ST>();
      }
    }
  } else {
    // ---- consumers: 64 q rows a warpgroup ----
    hp::reg_alloc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wg_row0 = row0 + wg * 64;
    const int r0 = wg_row0 + warp * 16 + g, r1 = r0 + 8;
    const float* lse_h = lse + (size_t)bh * lq;
    const float* dsum_h = dsum + (size_t)bh * lq;
    const float ell[2] = {r0 < lq ? lse_h[r0] : 0.f,
                          r1 < lq ? lse_h[r1] : 0.f};
    const float dd[2] = {r0 < lq ? dsum_h[r0] : 0.f,
                         r1 < lq ? dsum_h[r1] : 0.f};

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    const uint64_t q_desc = hp::make_desc(sm.q + wg * kSlice);
    const uint64_t do_desc = hp::make_desc(sm.dout + wg * kSlice);
    hp::mbar_wait(&sm.own, 0);

    // Trip j queues dq += dS.K of tile j - 1 and S, dP of tile j as one
    // batch, then computes dS of tile j.
    float s[KT / 2], dp[KT / 2];
    uint32_t a[KT / 16][4];
    uint64_t k_prev = 0;
    int prev_stage = 0;
    Ring ring;
    for (int j = 0; j < n_tiles; ++j) {
      hp::mbar_wait(&sm.full[ring.stage], ring.phase);
      const uint64_t k_desc = hp::make_desc(sm.k[ring.stage]);
      const uint64_t v_desc = hp::make_desc(sm.v[ring.stage]);

      hp::fence_acc(acc);
      hp::fence_acc(s);
      hp::fence_acc(dp);
      hp::wgmma_fence();
      if (j > 0) {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)   // acc += dS.K
          hp::wgmma_rs(acc, a[kk], k_prev + kk * hp::kStepMN);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // S = Q.K^T
        hp::wgmma_ss(s, q_desc + kk * hp::kStepK, k_desc + kk * hp::kStepK,
                     kk > 0);
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // dP = dO.V^T
        hp::wgmma_ss(dp, do_desc + kk * hp::kStepK, v_desc + kk * hp::kStepK,
                     kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // S is there: exp2 runs under dP's product
      hp::fence_acc(acc);
      hp::fence_acc(s);

      if (j > 0) {   // tile j - 1 is spent
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&sm.empty[prev_stage]);
      }
      const int key0 = j * KT + 2 * t4;
      if (j * KT + KT > lk)
        dq_tile_probs<KT, true>(s, ell, scale_log2, key0, lk);
      else
        dq_tile_probs<KT, false>(s, ell, scale_log2, key0, lk);
      hp::wgmma_wait<0>();
      hp::fence_acc(dp);
      dq_tile_ds<KT>(a, s, dp, dd);
      k_prev = k_desc;
      prev_stage = ring.stage;
      ring.advance<ST>();
    }
    hp::fence_acc(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)   // the last tile's dS.K
      hp::wgmma_rs(acc, a[kk], k_prev + kk * hp::kStepMN);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(acc);

    // every product of this warpgroup that read its q slice has finished
    hp::named_barrier(1 + wg, kWg);
    store_slice(dq + (size_t)bh * lq * 64, sm.q + wg * kSlice, acc, scale,
                scale, wg_row0, lq, warp, lane);
  }
}

__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_dkv_bf16(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int lq, int lk,
                   float scale_log2, float scale) {
  constexpr int KT = kDkvTile, ST = kDkvStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  DkvSmem& sm = shared_storage<DkvSmem>(smem_raw);

  const int tid = threadIdx.x, wg = tid / kWg;
  const int bh = blockIdx.y, key0 = blockIdx.x * kBlockRows;
  const int n_tiles = (lq + KT - 1) / KT;

  if (tid == 0) {
    hp::mbar_init(&sm.own, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      // the TMA thread's expect-tx arrival + one cp.async arrival a lane
      hp::mbar_init(&sm.full[s], 1 + 32);
      hp::mbar_init(&sm.empty[s], kConsumers * 4);
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one warp; lane 0 issues the TMA copies, every lane
    // copies two of the stage's 64 L and D values ----
    hp::reg_dealloc<kProducerRegs>();
    if (tid < kConsumers * kWg + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        hp::mbar_arrive_expect_tx(&sm.own, 2 * kConsumers * hp::kBoxBytes);
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) {
          hp::tma_load_rows(sm.k + c * kSlice, &map_k, &sm.own,
                            key0 + c * 64, bh);
          hp::tma_load_rows(sm.v + c * kSlice, &map_v, &sm.own,
                            key0 + c * 64, bh);
        }
      }
      const float* lse_h = lse + (size_t)bh * lq;
      const float* dsum_h = dsum + (size_t)bh * lq;
      Ring ring;
      for (int j = 0; j < n_tiles; ++j) {
        hp::mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&sm.full[ring.stage], 2 * hp::kBoxBytes);
          hp::tma_load_rows(sm.q[ring.stage], &map_q, &sm.full[ring.stage],
                            j * KT, bh);
          hp::tma_load_rows(sm.dout[ring.stage], &map_do,
                            &sm.full[ring.stage], j * KT, bh);
        }
#pragma unroll
        for (int c = lane; c < KT; c += 32) {
          const int row = j * KT + c;
          const bool live = row < lq;
          hp::cp_async_f32(&sm.lse[ring.stage][c], lse_h + (live ? row : 0),
                           live);
          hp::cp_async_f32(&sm.dsum[ring.stage][c], dsum_h + (live ? row : 0),
                           live);
        }
        hp::cp_async_mbar_arrive(&sm.full[ring.stage]);
        ring.advance<ST>();
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumers: 64 keys a warpgroup, tiles transposed (keys as
    // rows, q rows as columns) ----
    hp::reg_alloc<kConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int t4 = lane & 3;
    const int wg_key0 = key0 + wg * 64;

    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    const uint64_t k_desc = hp::make_desc(sm.k + wg * kSlice);
    const uint64_t v_desc = hp::make_desc(sm.v + wg * kSlice);
    hp::mbar_wait(&sm.own, 0);

    // Trip j queues dv += P^T.dO and dk += dS^T.Q of tile j - 1 and S^T,
    // dP^T of tile j as one batch, then computes P^T and dS^T of tile j.
    float pt[32], dpt[32];
    uint32_t ap[4][4], ads[4][4];
    uint64_t q_prev = 0, do_prev = 0;
    int prev_stage = 0;
    Ring ring;
    for (int j = 0; j < n_tiles; ++j) {
      hp::mbar_wait(&sm.full[ring.stage], ring.phase);
      const uint64_t q_desc = hp::make_desc(sm.q[ring.stage]);
      const uint64_t do_desc = hp::make_desc(sm.dout[ring.stage]);

      hp::fence_acc(dva);
      hp::fence_acc(dka);
      hp::fence_acc(pt);
      hp::fence_acc(dpt);
      hp::wgmma_fence();
      if (j > 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // dv += P^T.dO
          hp::wgmma_rs(dva, ap[kk], do_prev + kk * hp::kStepMN);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // dk += dS^T.Q
          hp::wgmma_rs(dka, ads[kk], q_prev + kk * hp::kStepMN);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // S^T = K.Q^T
        hp::wgmma_ss(pt, k_desc + kk * hp::kStepK, q_desc + kk * hp::kStepK,
                     kk > 0);
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // dP^T = V.dO^T
        hp::wgmma_ss(dpt, v_desc + kk * hp::kStepK,
                     do_desc + kk * hp::kStepK, kk > 0);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // S^T is there: exp2 runs under dP^T's product
      hp::fence_acc(dva);
      hp::fence_acc(dka);
      hp::fence_acc(pt);

      if (j > 0) {   // tile j - 1 is spent
        __syncwarp();
        if (lane == 0) hp::mbar_arrive(&sm.empty[prev_stage]);
      }
      const float* ls = sm.lse[ring.stage] + 2 * t4;
      const float* dsm = sm.dsum[ring.stage] + 2 * t4;
      const int col0 = j * KT + 2 * t4;
      if (j * KT + KT > lq)
        dkv_tile_probs<true>(ap, pt, ls, scale_log2, col0, lq);
      else
        dkv_tile_probs<false>(ap, pt, ls, scale_log2, col0, lq);
      hp::wgmma_wait<0>();
      hp::fence_acc(dpt);
      dkv_tile_ds(ads, pt, dpt, dsm);
      q_prev = q_desc;
      do_prev = do_desc;
      prev_stage = ring.stage;
      ring.advance<ST>();
    }
    hp::fence_acc(dva);
    hp::fence_acc(dka);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // the last tile's P^T.dO and dS^T.Q
      hp::wgmma_rs(dva, ap[kk], do_prev + kk * hp::kStepMN);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hp::wgmma_rs(dka, ads[kk], q_prev + kk * hp::kStepMN);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(dva);
    hp::fence_acc(dka);

    // every product of this warpgroup that read its k / v slices has
    // finished
    hp::named_barrier(1 + wg, kWg);
    store_slice(dk + (size_t)bh * lk * 64, sm.k + wg * kSlice, dka, scale,
                scale, wg_key0, lk, warp, lane);
    store_slice(dv + (size_t)bh * lk * 64, sm.v + wg * kSlice, dva, 1.f,
                1.f, wg_key0, lk, warp, lane);
  }
}

// the four tensor maps of a backward launch (hp::MapCache keeps the last
// few: the dq and dk/dv launches of one backward need the same four)
struct Maps {
  CUtensorMap q, k, v, dout;
  bool encode(const void* q_, const void* k_, const void* v_,
              const void* do_, int bh, int lq, int lk) {
    static thread_local hp::MapCache cache;
    return cache.get(&q, q_, bh, lq) && cache.get(&k, k_, bh, lk) &&
           cache.get(&v, v_, bh, lk) && cache.get(&dout, do_, bh, lq);
  }
};

cudaError_t launch_dq_bf16(const Maps& m, const float* lse,
                           const float* dsum, __nv_bfloat16* dq, int bh,
                           int lq, int lk, float scale_log2, float scale,
                           cudaStream_t st) {
  constexpr int smem = sizeof(DqSmem) + 1024;
  static bool allowed[64] = {};
  cudaError_t err = hp::allow_smem(flash_dq_bf16, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockRows - 1) / kBlockRows, bh);
  flash_dq_bf16<<<grid, kBlockThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, lse, dsum, dq, lq, lk, scale_log2, scale);
  return cudaGetLastError();
}

cudaError_t launch_dkv_bf16(const Maps& m, const float* lse,
                            const float* dsum, __nv_bfloat16* dk,
                            __nv_bfloat16* dv, int bh, int lq, int lk,
                            float scale_log2, float scale, cudaStream_t st) {
  constexpr int smem = sizeof(DkvSmem) + 1024;
  static bool allowed[64] = {};
  cudaError_t err = hp::allow_smem(flash_dkv_bf16, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((lk + kBlockRows - 1) / kBlockRows, bh);
  flash_dkv_bf16<<<grid, kBlockThreads, smem, st>>>(
      m.q, m.k, m.v, m.dout, lse, dsum, dk, dv, lq, lk, scale_log2, scale);
  return cudaGetLastError();
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

// q, dout: (bh, lq, 64); k, v: (bh, lk, 64), contiguous, 16-byte aligned,
// bf16 (is_bf16 = 1) or f32; lse, dsum: (bh, lq) f32; dq like q, dk / dv
// like k. scale_log2 = softmax scale * log2(e).
extern "C" int pcdms_flash_dq(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* dsum, void* dq, int bh, int lq,
                              int lk, float scale_log2, float scale,
                              int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  if (is_bf16) {
    Maps maps;
    if (!maps.encode(q, k, v, dout, bh, lq, lk))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_dq_bf16(maps, l, d, static_cast<__nv_bfloat16*>(dq), bh, lq,
                       lk, scale_log2, scale, st));
  }
  const dim3 grid((lq + kTile - 1) / kTile, bh);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dsum);
  if (is_bf16) {
    Maps maps;
    if (!maps.encode(q, k, v, dout, bh, lq, lk))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_dkv_bf16(
        maps, l, d, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), bh, lq, lk, scale_log2, scale, st));
  }
  const dim3 grid((lk + kTile - 1) / kTile, bh);
  flash_dkv_f32<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), l, d,
      static_cast<float*>(dk), static_cast<float*>(dv), lq, lk, scale_log2,
      scale);
  return static_cast<int>(cudaGetLastError());
}
