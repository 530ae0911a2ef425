// Flash-attention forward for Hopper (sm_90a).
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
// the exp2 domain with f32 scores, f32 accumulators and an f32 row-sum of
// the bf16-rounded weights that P.V uses; the output is acc / max(l, 1e-30).
// Keys past kv_len never enter a max and weigh 0.
//
// What bounds FROZEN and ONLINE on this card: per (batch, head) 4.L^2.64
// flops on the tensor cores and L^2 exp2 on the special-function unit (16 a
// clock an SM), against a few MB of q/k/v/o traffic. At the UNet's level 0
// (L = 8192, B.H = 10) that is 0.17 ms of products at 989 TF/s and about as
// long of exp2: the kernels are bound by operations, never by bytes, and are
// only fast where products and exp2 run at the same time.
//
// What the design does about it (bf16 FROZEN / ONLINE, one kernel template):
//   * Warp specialisation, as in flash_attention_bwd.cu: a block is two
//     consumer warpgroups of 64 q rows each and one producer warpgroup (one
//     thread issues TMA); setmaxnreg moves the producer's registers to the
//     consumers. 128 q rows a block, one block an SM.
//   * A TMA ring: the block's q rows once, then stages of 128 keys of k and
//     v (four stages, 144 KB with q), 128-byte swizzled, through
//     three-dimensional tensor maps (64, L, BH) that zero-fill past a head's
//     length, a full and an empty mbarrier a stage.
//   * wgmma for both products. S (64 x 128 f32, in registers) = Q.K^T reads
//     both operands from shared memory; P is re-packed in registers as the A
//     operand of O += P.V, with v read MN-major from the same stage.
//   * Two S buffers a consumer (64 + 64 registers beside O's 32 and P's
//     32; setmaxnreg gives a consumer 240). Trip j queues O += P.V of tile
//     j - 1 and S of tile j + 1 as one batch, turns S of tile j (there since
//     the trip before) into P while the batch runs, and waits for the batch
//     only then: a warpgroup's arithmetic runs under its own products as
//     well as under the other warpgroup's, and no product is in flight
//     across the loop's edge (ptxas serialises the products otherwise).
//     ONLINE rescales O after the wait.
//   * The row-sums come off the tensor cores: l += P.1 against one k-step
//     of ones in shared memory (m64n8k16 beside each k-step of P.V). They add
//     the bf16-rounded P that P.V uses, cost no unpacking and no adds, and
//     arrive whole in every lane of a quad.
//   * The softmax step is the stage: one running-max update per 128 keys
//     (the plain version walks the same step, _BLOCK_K of
//     ops/flash_attention.py; the Pallas kernel it is tested against steps
//     by 128 as well). A 64-key step inside the stage would double the max
//     reductions and rescales for nothing.
//   * FROZEN needs no prepass: tile 0 is the first 128 keys, so m0 is its
//     row max + 24 and the same S goes on to P.
//   * Little arithmetic per score: the row max is taken of the raw products
//     and scaled once (scale > 0: the max commutes with the scaling), then
//     one FMA and one ex2.approx per score, one reciprocal per row at the
//     end; only the tile that crosses lk pays for the mask's select.
//   * Epilogue: O / l goes to bf16 through the block's own q buffer
//     (swizzled, conflict-free) and out in 16-byte stores; rows past lq are
//     skipped; lse is written by one lane of each quad.
//   * What is left: with the products alone the kernel runs at 97 % of the
//     tensor cores' rate, and the k / v copies from L2 cost it next to
//     nothing; the arithmetic alone takes longer than the products, and its
//     time is the exp2 unit's plus the other instructions', not the larger
//     of the two, so moving part of the exp2 to a polynomial on the FMA
//     units made the kernel slower at every share tried. Two consumers are
//     all the registers allow. Not done: 2-CTA clusters with multicast, a
//     persistent grid.
// SHORTKV (bf16) keeps the warp-level design: one block owns 64 q rows (4
// warps x 16 rows) and loops over 64-key tiles staged in padded shared
// memory, mma.sync m16n8k16, P re-packed in registers, V through
// ldmatrix.trans. It is bound by launch and bytes at its shapes.
// f32 (a spot-check route, not the main path): one thread per q row with FMA
// dot products against f32 k/v tiles in shared memory, so f32 inputs keep
// full f32 precision (tensor-core TF32 would not).
// P is kept in bf16, never fp16: with the frozen m0 = rowmax + 24, the
// first keys' weights are <= 2^-24, which fp16 would flush.
//
// The plain-C entries return cudaGetLastError(); they never synchronise.

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace pcdms;
namespace hp = pcdms::hopper;

constexpr int kBlockQ = 64;        // q rows per block (short-kv, f32)
constexpr int kBlockK = kTile;     // keys per shared-memory tile (same)
constexpr int kThreadsBf16 = 128;  // short-kv: 4 warps x 16 q rows
constexpr int kThreadsF32 = kBlockQ;
constexpr float kFrozenMargin = 24.0f;
constexpr int kFrozenKeys = 128;

enum Mode { kFrozen = 0, kOnline = 1, kShortKv = 2 };

// ---------------------------------------------------------------------------
// bf16 frozen / online: TMA ring -> wgmma, warp-specialised
// ---------------------------------------------------------------------------

using hp::kBlockRows;
using hp::kBlockThreads;
using hp::kConsumers;
using hp::kSlice;
using hp::kWg;

constexpr int kFwdKeys = 128, kFwdStages = 4;   // k / v rows a stage
// two S buffers, O and P are 192 registers of a consumer thread: the
// producer keeps fewer than in the backward kernels
constexpr int kFwdProducerRegs = 24, kFwdConsumerRegs = 240;
static_assert(kFwdKeys == kFrozenKeys, "frozen m0 is tile 0's row max");

struct FwdSmem {
  __nv_bfloat16 q[kBlockRows * 64];   // own rows; the epilogue's staging
  __nv_bfloat16 k[kFwdStages][kFwdKeys * 64], v[kFwdStages][kFwdKeys * 64];
  __nv_bfloat16 ones[16 * 64];        // one k-step of 1.0: P . 1 = row-sums
  uint64_t own, full[kFwdStages], empty[kFwdStages];
};

// One 64 x 128 tile of a warpgroup, in place: raw products q.k -> softmax
// weights exp2(s . scale_log2 - m), still f32. s[i] is row (i >> 1) & 1 of
// the thread's two, key key0 + (i >> 2) * 8 + (i & 1). kFirst: the tile sets
// m (FROZEN: its row max + 24, for good). ONLINE: m becomes the running max
// and alpha = exp2(m_old - m_new). kMasked: keys from lk on weigh 0 and
// enter no max.
template <int MODE, bool EXP_BF16, bool kFirst, bool kMasked>
__device__ __forceinline__ void fwd_tile_probs(float (&s)[kFwdKeys / 2],
                                               float (&m)[2],
                                               float (&alpha)[2],
                                               float scale_log2, int key0,
                                               int lk) {
  constexpr int N = kFwdKeys / 2;
  if (EXP_BF16) {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = round_bf16(s[i] * scale_log2);
  }
  if (kMasked) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (key0 + (i >> 2) * 8 + (i & 1) >= lk) s[i] = kNegInf;
  }
  if (MODE == kOnline || kFirst) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < N; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // scale_log2 > 0: the max of the scaled scores is the scaled max
      const float t = EXP_BF16 ? quad_max(mx[r])
                               : quad_max(mx[r]) * scale_log2;
      if (MODE == kFrozen) {
        m[r] = t + kFrozenMargin;
      } else {
        const float m_new = kFirst ? t : fmaxf(m[r], t);
        alpha[r] = kFirst ? 1.f : hp::ex2(m[r] - m_new);
        m[r] = m_new;
      }
    }
  }
  if (EXP_BF16) {
    // m is a max of bf16 values: subtracting it is subtracting its rounding
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = hp::ex2(round_bf16(s[i] - m[(i >> 1) & 1]));
  } else {
    const float neg_m[2] = {-m[0], -m[1]};
#pragma unroll
    for (int i = 0; i < N; ++i)
      s[i] = hp::ex2(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
  }
}

// the tile's weights rounded to bf16 as the A operand of P.V
__device__ __forceinline__ void fwd_pack_probs(
    uint32_t (&p)[kFwdKeys / 16][4], const float (&s)[kFwdKeys / 2]) {
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) hp::pack_a(p[kk], s, kk);
}

// a consumer thread's share of its warpgroup's 64 rows (two rows of each 16)
struct FwdRows {
  float acc[32];                   // O, unnormalised
  uint32_t p[kFwdKeys / 16][4];    // P of the tile whose P.V is queued
  float m[2], alpha[2];
  float l[4];                      // the row-sums, as P . 1: l[0] and l[2]
};

// queues S = Q.K^T against a 128-key k stage
__device__ __forceinline__ void fwd_queue_scores(float (&s)[kFwdKeys / 2],
                                                 uint64_t q_desc,
                                                 const __nv_bfloat16* k) {
  const uint64_t k_desc = hp::make_desc(k);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_ss(s, q_desc + kk * hp::kStepK, k_desc + kk * hp::kStepK,
                 kk > 0);
}

// queues O += P.V against a 128-key v stage, read MN-major, and l += P.1:
// the row-sums of the rounded weights that P.V uses come off the tensor
// cores as well
__device__ __forceinline__ void fwd_queue_pv(FwdRows& r,
                                             const __nv_bfloat16* v,
                                             uint64_t ones_desc) {
  const uint64_t v_desc = hp::make_desc(v);
#pragma unroll
  for (int kk = 0; kk < kFwdKeys / 16; ++kk) {
    hp::wgmma_rs(r.acc, r.p[kk], v_desc + kk * hp::kStepMN);
    hp::wgmma_rs(r.l, r.p[kk], ones_desc);
  }
}

// tile j of a consumer, S -> P in place
template <int MODE, bool EXP_BF16, bool kFirst>
__device__ __forceinline__ void fwd_softmax_tile(float (&s)[kFwdKeys / 2],
                                                 FwdRows& r, float scale_log2,
                                                 int j, int t4, int lk) {
  const int key0 = j * kFwdKeys + 2 * t4;
  if (j * kFwdKeys + kFwdKeys > lk)   // only the last tile can cross lk
    fwd_tile_probs<MODE, EXP_BF16, kFirst, true>(s, r.m, r.alpha, scale_log2,
                                                 key0, lk);
  else
    fwd_tile_probs<MODE, EXP_BF16, kFirst, false>(s, r.m, r.alpha,
                                                  scale_log2, key0, lk);
}

// Trip j >= 1 of a consumer. On entry S of tile j is in s_cur, P of tile
// j - 1 in r.p, and no product is in flight. The trip queues O += P.V of
// tile j - 1 and S of tile j + 1 (into s_next) as one batch, turns S of tile
// j into P while the batch runs, and packs P once the batch has finished.
// Past the last tile, S is taken of whatever the stage holds and never
// read: the batch is the same on every trip.
template <int MODE, bool EXP_BF16>
__device__ __forceinline__ void fwd_trip(FwdSmem& sm, FwdRows& r,
                                         float (&s_cur)[kFwdKeys / 2],
                                         float (&s_next)[kFwdKeys / 2],
                                         uint64_t q_desc, uint64_t ones_desc,
                                         int j, int n_tiles, int lk,
                                         float scale_log2, int lane) {
  constexpr int ST = kFwdStages;
  if (j + 1 < n_tiles)
    hp::mbar_wait(&sm.full[(j + 1) % ST], ((j + 1) / ST) & 1);
  hp::fence_acc(r.acc);
  hp::fence_acc(r.l);
  hp::fence_frag(r.p);
  hp::fence_acc(s_next);
  hp::wgmma_fence();
  fwd_queue_pv(r, sm.v[(j - 1) % ST], ones_desc);
  fwd_queue_scores(s_next, q_desc, sm.k[(j + 1) % ST]);
  hp::wgmma_commit();
  fwd_softmax_tile<MODE, EXP_BF16, false>(s_cur, r, scale_log2, j, lane & 3,
                                          lk);
  hp::wgmma_wait<0>();   // P.V has read p and written acc; S is there
  hp::fence_acc(r.acc);
  hp::fence_acc(r.l);
  hp::fence_frag(r.p);
  hp::fence_acc(s_next);
  __syncwarp();          // tile j - 1 is spent
  if (lane == 0) hp::mbar_arrive(&sm.empty[(j - 1) % ST]);
  if (MODE == kOnline) {
#pragma unroll
    for (int i = 0; i < 32; ++i) r.acc[i] *= r.alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) r.l[i] *= r.alpha[(i >> 1) & 1];
  }
  fwd_pack_probs(r.p, s_cur);
}

template <int MODE, bool EXP_BF16>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int lq, int lk, float scale_log2) {
  constexpr int KT = kFwdKeys, ST = kFwdStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  FwdSmem& sm = hp::shared_storage<FwdSmem>(smem_raw);

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
  for (int i = tid; i < 16 * 64 / 2; i += kBlockThreads)
    reinterpret_cast<uint32_t*>(sm.ones)[i] = 0x3f803f80u;   // bf16 1.0 x 2
  hp::fence_proxy_async();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    hp::reg_dealloc<kFwdProducerRegs>();
    if (tid == kConsumers * kWg) {
      hp::mbar_arrive_expect_tx(&sm.own, kConsumers * hp::kBoxBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
        hp::tma_load_rows(sm.q + c * kSlice, &map_q, &sm.own, row0 + c * 64,
                          bh);
      hp::Ring ring;
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
    hp::reg_alloc<kFwdConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wg_row0 = row0 + wg * 64;
    const int r0 = wg_row0 + warp * 16 + g, r1 = r0 + 8;

    FwdRows r;
#pragma unroll
    for (int i = 0; i < 32; ++i) r.acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) r.l[i] = 0.f;
    float sa[KT / 2], sb[KT / 2];   // S of the even and of the odd tiles

    const uint64_t q_desc = hp::make_desc(sm.q + wg * kSlice);
    const uint64_t ones_desc = hp::make_desc(sm.ones);
    hp::mbar_wait(&sm.own, 0);

    // S of tiles 0 and 1 (of whatever stage 1 holds if there is one tile:
    // never read); tile 0 sets m
    hp::mbar_wait(&sm.full[0], 0);
    if (n_tiles > 1) hp::mbar_wait(&sm.full[1], 0);
    hp::fence_acc(sa);
    hp::fence_acc(sb);
    hp::wgmma_fence();
    fwd_queue_scores(sa, q_desc, sm.k[0]);
    fwd_queue_scores(sb, q_desc, sm.k[1]);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(sa);
    hp::fence_acc(sb);
    fwd_softmax_tile<MODE, EXP_BF16, true>(sa, r, scale_log2, 0, t4, lk);
    fwd_pack_probs(r.p, sa);
    for (int j = 1; j < n_tiles; j += 2) {
      fwd_trip<MODE, EXP_BF16>(sm, r, sb, sa, q_desc, ones_desc, j, n_tiles,
                               lk, scale_log2, lane);
      if (j + 1 < n_tiles)
        fwd_trip<MODE, EXP_BF16>(sm, r, sa, sb, q_desc, ones_desc, j + 1,
                                 n_tiles, lk, scale_log2, lane);
    }
    hp::fence_acc(r.acc);
    hp::fence_acc(r.l);
    hp::fence_frag(r.p);
    hp::wgmma_fence();
    fwd_queue_pv(r, sm.v[(n_tiles - 1) % ST], ones_desc);   // the last tile
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(r.acc);
    hp::fence_acc(r.l);
    hp::fence_frag(r.p);

    const float l0 = fmaxf(r.l[0], 1e-30f), l1 = fmaxf(r.l[2], 1e-30f);
    if (lse != nullptr && t4 == 0) {
      // per-row log2-sum-exp2 L = m + log2(l), which the backward reads
      float* lse_h = lse + (size_t)bh * lq;
      if (r0 < lq) lse_h[r0] = r.m[0] + log2f(l0);
      if (r1 < lq) lse_h[r1] = r.m[1] + log2f(l1);
    }
    // every product of this warpgroup that read its q slice has finished
    hp::named_barrier(1 + wg, kWg);
    hp::store_slice(o + (size_t)bh * lq * 64, sm.q + wg * kSlice, r.acc,
                    1.f / l0, 1.f / l1, wg_row0, lq, warp, lane);
  }
}

// the three tensor maps of a launch; hp::MapCache keeps the last few per
// host thread
struct FwdMaps {
  CUtensorMap q, k, v;
  bool encode(const void* q_, const void* k_, const void* v_, int bh, int lq,
              int lk) {
    static thread_local hp::MapCache cache;
    return cache.get(&q, q_, bh, lq) && cache.get(&k, k_, bh, lk) &&
           cache.get(&v, v_, bh, lk);
  }
};

template <int MODE, bool EXP_BF16>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            __nv_bfloat16* o, float* lse, int bh, int lq,
                            int lk, float scale_log2, cudaStream_t st) {
  // the row max is taken before the scaling
  if (!(scale_log2 > 0.f)) return cudaErrorInvalidValue;
  FwdMaps maps;
  if (!maps.encode(q, k, v, bh, lq, lk)) return cudaErrorInvalidValue;
  constexpr int smem = sizeof(FwdSmem) + 1024;
  static bool allowed[64] = {};
  cudaError_t err =
      hp::allow_smem(flash_fwd_bf16<MODE, EXP_BF16>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBlockRows - 1) / kBlockRows, bh);
  flash_fwd_bf16<MODE, EXP_BF16><<<grid, kBlockThreads, smem, st>>>(
      maps.q, maps.k, maps.v, o, lse, lq, lk, scale_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 short-kv: mma.sync, 64 q rows a block
// ---------------------------------------------------------------------------

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

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_shortkv_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int lq, int lk,
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

  // first pass: the row max over all keys; q.k^T only
  float m[2] = {kNegInf, kNegInf};
  for (int k0 = 0; k0 < lk; k0 += kBlockK) {
    __syncthreads();
    load_tile_bf16<D>(ks, k, k0, lk);
    __syncthreads();
    float s[8][4];
    tile_scores<D>(s, qa, ks, k0, lk, scale_log2, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
      m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
    }
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);

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

    // P = exp2(s - m) in bf16 (the A operand of P.V); the row-sum adds the
    // same rounded weights the numerator uses
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = round_bf16(exp2f(s[nt][e] - m[e >> 1]));
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

// ---------------------------------------------------------------------------
// f32, FMA: one thread per q row
// ---------------------------------------------------------------------------

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
  if (!is_bf16) {
    flash_fwd_f32<MODE, EXP_BF16, D><<<grid, kThreadsF32, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, lq, lk,
        scale_log2);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (MODE == kShortKv) {
    flash_shortkv_bf16<D><<<grid, kThreadsBf16, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        lq, lk, scale_log2);
    return static_cast<int>(cudaGetLastError());
  } else {
    return static_cast<int>(launch_fwd_bf16<MODE, EXP_BF16>(
        q, k, v, static_cast<__nv_bfloat16*>(o), lse, bh, lq, lk, scale_log2,
        st));
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, lq | lk, 64), 16-byte aligned, bf16 (is_bf16
// = 1) or f32 (head_dim 64 or 80 for the short-kv entry, which takes it as
// an argument). scale_log2 = softmax scale * log2(e), positive for the bf16
// frozen / online / LSE kernel, any for the f32 and short-kv kernels.
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
