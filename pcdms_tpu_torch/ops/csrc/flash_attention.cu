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
//                row max; here a first sweep over all (<= 512) keys finds it.
//                It alone also takes head_dim 80 (CLIP ViT-H's 16 heads of
//                80): the JAX kernel takes any head_dim, padding v to d_aug
//                (l.338-350); here one template serves 64 and 80.
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
// SHORTKV, bf16, head_dim 64 and 80: bound by bytes. At the UNet's level 0
// (10 x 8192 q rows, 258 keys, head_dim 64) q and o are 21 MB against 0.66
// MB of k and v and 5 GFLOP, so the kernel has to stream q in and o out at
// the memory's rate and keep everything else off that stream. The design:
//   * Persistent: one block an SM walks a contiguous run of (head, 128-row
//     q tile) pairs (skv_run_edge), warp-specialised as above (two
//     consumer warpgroups of 64 rows, one producer thread issuing TMA).
//   * K and V resident: on a new head the producer loads all of its k and
//     v (<= 512 keys, 128 KB; 160 KB at head_dim 80) by TMA once, and
//     reloads only where the run crosses into the next head, once the
//     consumers have released them.
//   * q streamed a pair ahead through two stages; the epilogue (O / l to
//     bf16 through the pair's own q buffer) overlaps the next pair's load.
//   * Two sweeps over the resident tiles on wgmma: sweep 1 takes the exact
//     row max of the scaled scores (any scale); sweep 2 turns S into P =
//     exp2(s - m), rounded to bf16, and runs O += P.V and l += P.1 against
//     the tile of ones. With a tail of <= 16 keys (257 and 258 keys: two
//     full tiles) S of all three tiles stays in registers from sweep 1 (64
//     + 64 + 8 of a consumer's 240), so nothing is recomputed; otherwise
//     the tail's and the last full tile's stay. Each tile's exp2 runs
//     under the P.V of the tile before it.
//   * The tail: keys past the last full 128 go through a narrower product
//     (16, 64 or 128 keys, a template argument): at 258 keys the third tile
//     costs a 16-key product, not a 128-key one. Keys from lk on (zeros by
//     TMA) are -inf in the max and exactly 0 in P.
//   * head_dim 80 (CLIP ViT-H, 257 keys): a row of 160 bytes is wider than
//     a 128-byte-swizzled TMA box, so each row is split in two. Its first
//     64 columns keep the head_dim-64 layout, maps and descriptors; its
//     last 16 come through a second tensor map over the same tensor
//     (column 64 on, 32-byte swizzle) into a region of their own
//     (hopper.cuh). Q.K^T takes a fifth k-step on the 16-column parts;
//     P.V splits N: each k-step of P meets the 64-column part of v
//     (m64n64k16 into O's 32 registers) and the 16-column part (m64n16k16
//     into 8 more). The epilogue stages the 16 columns through their own
//     q buffer. Shared memory: 204 KB of the 227.
//   * What is left (PERF.md): at 258 keys the products, the exp2 and the
//     FP32 arithmetic each take about as long as the bytes, and the two
//     consumer warpgroups overlap them poorly.
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

constexpr int kBlockQ = 64;        // q rows per block (f32)
constexpr int kBlockK = kTile;     // keys per shared-memory tile (f32)
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

// the last few tensor maps of the forward launches, per host thread
hp::MapCache& fwd_map_cache() {
  static thread_local hp::MapCache cache;
  return cache;
}

// the three tensor maps of a launch
struct FwdMaps {
  CUtensorMap q, k, v;
  bool encode(const void* q_, const void* k_, const void* v_, int bh, int lq,
              int lk) {
    hp::MapCache& cache = fwd_map_cache();
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
// bf16 short-kv, head_dim 64 and 80: persistent, K / V resident, TMA -> wgmma
// ---------------------------------------------------------------------------

constexpr int kSkvTileKeys = 128;                // keys of a full tile
constexpr int kSkvMaxKeys = 4 * kSkvTileKeys;    // K / V resident: lk <= 512
constexpr int kSkvQStages = 2;                   // q streamed a pair ahead
// setmaxnreg.inc draws only on what the producer's .dec gives back: the
// consumers' gain over the launch's 168 registers must not exceed it, or
// they wait for registers for ever
constexpr int kSkvProducerRegs = 24, kSkvConsumerRegs = 240;
constexpr int kLaunchRegs = 65536 / kBlockThreads / 8 * 8;
static_assert(kConsumers * (kSkvConsumerRegs - kLaunchRegs) <=
                  kLaunchRegs - kSkvProducerRegs,
              "the producer must give back what the consumers take");
using hp::kCols16;

// head_dim 80: the last 16 columns of q, k and v, each 32-byte swizzled
// (hopper.cuh), beside the first 64 in the head_dim-64 layout
template <int X>
struct SkvCols16 {
  alignas(1024) __nv_bfloat16 q[kSkvQStages][kBlockRows * X];
  alignas(1024) __nv_bfloat16 k[kSkvMaxKeys * X], v[kSkvMaxKeys * X];
};
template <>
struct SkvCols16<0> {};

template <int D>
struct SkvSmem {
  // a pair's q rows; its epilogue's staging once the products are done
  __nv_bfloat16 q[kSkvQStages][kBlockRows * 64];
  // one head's k and v, kept until the block's run reaches the next head
  __nv_bfloat16 k[kSkvMaxKeys * 64], v[kSkvMaxKeys * 64];
  __nv_bfloat16 ones[16 * 64];
  uint64_t q_full[kSkvQStages], q_empty[kSkvQStages];
  uint64_t k_full, v_full, kv_empty;
  SkvCols16<D - 64> x;   // head_dim 80: columns 64-79
};
static_assert(sizeof(SkvSmem<80>) + 1024 <= 232448,
              "q, k and v of 512 keys at head_dim 80 fit a block");

// The (head, q tile) pairs [edge(b), edge(b + 1)) are block b's run, pair
// i = head * q_tiles + tile: contiguous, so that a block reloads k and v
// only where its run crosses into the next head (shortkv_plan in
// ops/flash_attention.py walks the same runs).
__device__ __forceinline__ int skv_run_edge(int b, int pairs) {
  return static_cast<int>(static_cast<long long>(b) * pairs / gridDim.x);
}

// A consumer thread's share of its warpgroup's 64 rows: S of a full tile
// (of two with a 16-key tail: 204 registers with the rest at head_dim 64,
// 212 at 80), S of the tail, O unnormalised (its columns past 64 in ox),
// P of one tile, the row-sums as P . 1 (l[0] and l[2]). S[i] is row
// (i >> 1) & 1 of the thread's two, key key0 + (i >> 2) * 8 + (i & 1) of
// its tile, key0 = 2 * (lane % 4).
template <int TW, int D>
struct SkvRows {
  float s[kSkvTileKeys / 2];
  float s2[TW == 16 ? kSkvTileKeys / 2 : 1];
  float st[TW / 2];
  float acc[32];
  float ox[D > 64 ? (D - 64) / 2 : 1];
  float l[4];
  uint32_t p[kSkvTileKeys / 16][4];

  // pins every register the products read or write, so that the compiler
  // moves no access across the start or the wait of a batch
  __device__ __forceinline__ void fence() {
    hp::fence_acc(s);
    hp::fence_acc(s2);
    hp::fence_acc(st);
    hp::fence_acc(acc);
    if constexpr (D > 64) hp::fence_acc(ox);
    hp::fence_acc(l);
    hp::fence_frag(p);
  }
  __device__ __forceinline__ void open() {
    fence();
    hp::wgmma_fence();
  }
  __device__ __forceinline__ void close() {
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    fence();
  }
};

// a pair's q slice as wgmma operands: its first 64 columns and, at head_dim
// 80, its last 16
struct SkvQ {
  uint64_t q, qx;
};

// queues S = Q.K^T (64 x 2N) against the 2N keys from key `first` on: four
// k-steps of the 64-column parts, at head_dim 80 a fifth of the 16-column
// parts
template <int D, int N>
__device__ __forceinline__ void skv_queue_scores(float (&s)[N], SkvQ q,
                                                 const SkvSmem<D>& sm,
                                                 int first) {
  const uint64_t k_desc = hp::make_desc(sm.k + first * 64);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_ss(s, q.q + kk * hp::kStepK, k_desc + kk * hp::kStepK,
                 kk > 0);
  if constexpr (D > 64)
    hp::wgmma_ss(s, q.qx, hp::make_desc16(sm.x.k + first * kCols16), true);
}

// queues O += P.V and l += P.1 over the W keys from key `first` on, v read
// MN-major, P from registers; at head_dim 80 each k-step's P also meets v's
// last 16 columns (m64n16k16 into ox)
template <int W, int TW, int D>
__device__ __forceinline__ void skv_queue_pv(SkvRows<TW, D>& r,
                                             const SkvSmem<D>& sm, int first,
                                             uint64_t ones_desc) {
  const uint64_t v_desc = hp::make_desc(sm.v + first * 64);
  [[maybe_unused]] uint64_t vx_desc = 0;
  if constexpr (D > 64) vx_desc = hp::make_desc16(sm.x.v + first * kCols16);
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    hp::wgmma_rs(r.acc, r.p[kk], v_desc + kk * hp::kStepMN);
    if constexpr (D > 64)
      hp::wgmma_rs(r.ox, r.p[kk], vx_desc + kk * hp::kStep16MN);
    hp::wgmma_rs(r.l, r.p[kk], ones_desc);
  }
}

// the row max of a tile's scores, scaled first (any sign of scale), into m;
// kMasked: keys from lk on (zeros by TMA, which would score 0) enter no max
template <bool kMasked, int N>
__device__ __forceinline__ void skv_tile_max(const float (&s)[N],
                                             float (&m)[2], float scale_log2,
                                             int key0, int lk) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i] * scale_log2;
    if (kMasked && key0 + (i >> 2) * 8 + (i & 1) >= lk) x = kNegInf;
    m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], x);
  }
}

// S -> P = exp2(s . scale_log2 - m) in place, exactly 0 from lk on
template <bool kMasked, int N>
__device__ __forceinline__ void skv_tile_exp(float (&s)[N],
                                             const float (&neg_m)[2],
                                             float scale_log2, int key0,
                                             int lk) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float x = hp::ex2(fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]));
    s[i] = kMasked && key0 + (i >> 2) * 8 + (i & 1) >= lk ? 0.f : x;
  }
}

// P rounded to bf16 as the A operand of P.V
template <int N>
__device__ __forceinline__ void skv_pack(uint32_t (&p)[kSkvTileKeys / 16][4],
                                         const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) hp::pack_a(p[kk], s, kk);
}

// Queues P.V of the tile whose P is packed (keys from `first` on), turns
// `next` (S of the tile after it) into P while the products run, and packs
// it once they are done.
template <int W, bool kMaskedNext, int TW, int D, int N>
__device__ __forceinline__ void skv_pv_exp(SkvRows<TW, D>& r,
                                           const SkvSmem<D>& sm, int first,
                                           uint64_t ones_desc,
                                           float (&next)[N],
                                           const float (&neg_m)[2],
                                           float scale_log2, int key0,
                                           int lk) {
  r.open();
  skv_queue_pv<W>(r, sm, first, ones_desc);
  hp::wgmma_commit();
  skv_tile_exp<kMaskedNext>(next, neg_m, scale_log2, key0, lk);
  hp::wgmma_wait<0>();
  r.fence();
  skv_pack(r.p, next);
}

// TW: keys of the tail tile, the last (lk - 1) % 128 + 1 keys rounded up
// to 16, 64 or 128; the n_full tiles before it are 128 keys and unmasked.
// D: head_dim, 64 or 80 (map_qx, map_kx and map_vx map the last 16 columns
// at 80 and are not read at 64).
template <int TW, int D>
__global__ void __launch_bounds__(kBlockThreads, 1)
    flash_shortkv_hopper(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_qx,
                         const __grid_constant__ CUtensorMap map_kx,
                         const __grid_constant__ CUtensorMap map_vx,
                         __nv_bfloat16* __restrict__ o, int lq, int lk,
                         int q_tiles, int pairs, float scale_log2) {
  constexpr int KT = kSkvTileKeys, QS = kSkvQStages;
  constexpr bool kWide = D > 64;
  // bytes a copy of 64 rows brings, all column parts
  constexpr uint32_t kRowsBytes =
      hp::kBoxBytes + (kWide ? hp::kBox16Bytes : 0);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  SkvSmem<D>& sm = hp::shared_storage<SkvSmem<D>>(smem_raw);

  const int tid = threadIdx.x, wg = tid / kWg;
  const int begin = skv_run_edge(blockIdx.x, pairs);
  const int end = skv_run_edge(blockIdx.x + 1, pairs);
  const int n_full = (lk - 1) / KT;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < QS; ++s) {
      hp::mbar_init(&sm.q_full[s], 1);
      hp::mbar_init(&sm.q_empty[s], kConsumers * 4);   // a consumer warp
    }
    hp::mbar_init(&sm.k_full, 1);
    hp::mbar_init(&sm.v_full, 1);
    hp::mbar_init(&sm.kv_empty, kConsumers * 4);
    hp::mbar_fence_init();
  }
  for (int i = tid; i < 16 * 64 / 2; i += kBlockThreads)
    reinterpret_cast<uint32_t*>(sm.ones)[i] = 0x3f803f80u;   // bf16 1.0 x 2
  hp::fence_proxy_async();
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: q a pair ahead, k and v once a head ----
    hp::reg_dealloc<kSkvProducerRegs>();
    if (tid == kConsumers * kWg) {
      const int boxes = (lk + hp::kBoxRows - 1) / hp::kBoxRows;
      hp::Ring ring;
      int head = -1;
      uint32_t loads = 0;
      for (int i = begin; i < end; ++i) {
        const int h = i / q_tiles, row0 = (i - h * q_tiles) * kBlockRows;
        hp::mbar_wait(&sm.q_empty[ring.stage], ring.phase ^ 1);
        hp::mbar_arrive_expect_tx(&sm.q_full[ring.stage],
                                  kConsumers * kRowsBytes);
#pragma unroll
        for (int c = 0; c < kConsumers; ++c) {
          hp::tma_load_rows(sm.q[ring.stage] + c * kSlice, &map_q,
                            &sm.q_full[ring.stage], row0 + c * 64, h);
          if constexpr (kWide)
            hp::tma_load_rows(sm.x.q[ring.stage] + c * 64 * kCols16,
                              &map_qx, &sm.q_full[ring.stage], row0 + c * 64,
                              h, 64);
        }
        ring.advance<QS>();
        if (h != head) {
          // every consumer warp is done with the last head's k and v
          hp::mbar_wait(&sm.kv_empty, (loads & 1) ^ 1);
          hp::mbar_arrive_expect_tx(&sm.k_full, boxes * kRowsBytes);
          for (int b = 0; b < boxes; ++b) {
            hp::tma_load_rows(sm.k + b * kSlice, &map_k, &sm.k_full,
                              b * hp::kBoxRows, h);
            if constexpr (kWide)
              hp::tma_load_rows(sm.x.k + b * 64 * kCols16, &map_kx,
                                &sm.k_full, b * hp::kBoxRows, h, 64);
          }
          hp::mbar_arrive_expect_tx(&sm.v_full, boxes * kRowsBytes);
          for (int b = 0; b < boxes; ++b) {
            hp::tma_load_rows(sm.v + b * kSlice, &map_v, &sm.v_full,
                              b * hp::kBoxRows, h);
            if constexpr (kWide)
              hp::tma_load_rows(sm.x.v + b * 64 * kCols16, &map_vx,
                                &sm.v_full, b * hp::kBoxRows, h, 64);
          }
          head = h;
          ++loads;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows of each pair a warpgroup ----
    hp::reg_alloc<kSkvConsumerRegs>();
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int t4 = lane & 3;
    const uint64_t ones_desc = hp::make_desc(sm.ones);
    const int tail = n_full * KT;   // the tail's first key
    const int key0 = 2 * t4, tail0 = tail + key0;

    SkvRows<TW, D> r;
    hp::Ring ring;
    int head = -1;
    uint32_t loads = 0;
    for (int i = begin; i < end; ++i) {
      const int h = i / q_tiles, row0 = (i - h * q_tiles) * kBlockRows;
      if (h != head) {
        if (head >= 0) {   // every product of this warp has finished
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(&sm.kv_empty);
        }
        head = h;
        ++loads;
      }
      const uint32_t kv_phase = (loads - 1) & 1;
      __nv_bfloat16* q_slice = sm.q[ring.stage] + wg * kSlice;
      SkvQ q{hp::make_desc(q_slice), 0};
      if constexpr (kWide)
        q.qx = hp::make_desc16(sm.x.q[ring.stage] + wg * 64 * kCols16);
      hp::mbar_wait(&sm.k_full, kv_phase);
      hp::mbar_wait(&sm.q_full[ring.stage], ring.phase);

      // sweep 1: the exact row max over every key below lk. The S of the
      // tail and of the last full tile (with a 16-key tail, of the last two)
      // stay in registers, and sweep 2 starts from them; each tile's max is
      // taken under the next tile's product.
      float m[2] = {kNegInf, kNegInf};
      if constexpr (TW == 16) {
        if (n_full == 0) {
          r.open();
          skv_queue_scores(r.st, q, sm, tail);
          r.close();
          skv_tile_max<true>(r.st, m, scale_log2, tail0, lk);
        } else {
          r.open();
          skv_queue_scores(r.st, q, sm, tail);
          skv_queue_scores(r.s, q, sm, 0);
          r.close();
          if (n_full == 1) {
            skv_tile_max<true>(r.st, m, scale_log2, tail0, lk);
            skv_tile_max<false>(r.s, m, scale_log2, key0, lk);
          } else {
            r.open();
            skv_queue_scores(r.s2, q, sm, KT);
            hp::wgmma_commit();
            skv_tile_max<true>(r.st, m, scale_log2, tail0, lk);
            skv_tile_max<false>(r.s, m, scale_log2, key0, lk);
            hp::wgmma_wait<0>();
            r.fence();
            if (n_full == 3) {   // tile 2 takes tile 0's registers
              r.open();
              skv_queue_scores(r.s, q, sm, 2 * KT);
              hp::wgmma_commit();
              skv_tile_max<false>(r.s2, m, scale_log2, key0, lk);
              hp::wgmma_wait<0>();
              r.fence();
              skv_tile_max<false>(r.s, m, scale_log2, key0, lk);
            } else {
              skv_tile_max<false>(r.s2, m, scale_log2, key0, lk);
            }
          }
        }
      } else {
        r.open();
        skv_queue_scores(r.st, q, sm, tail);
        r.close();
        skv_tile_max<true>(r.st, m, scale_log2, tail0, lk);
        for (int j = 0; j < n_full; ++j) {
          r.open();
          skv_queue_scores(r.s, q, sm, j * KT);
          r.close();
          skv_tile_max<false>(r.s, m, scale_log2, key0, lk);
        }
      }
      const float neg_m[2] = {-quad_max(m[0]), -quad_max(m[1])};

      // sweep 2: P and O += P.V from the last full tile down to tile 0,
      // then the tail; the exp2 of each tile runs under the P.V of the one
      // before it, where its S is at hand
#pragma unroll
      for (int e = 0; e < 32; ++e) r.acc[e] = 0.f;
      if constexpr (kWide) {
#pragma unroll
        for (int e = 0; e < (D - 64) / 2; ++e) r.ox[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) r.l[e] = 0.f;
      hp::mbar_wait(&sm.v_full, kv_phase);
      const float c = scale_log2;
      if constexpr (TW == 16) {
        if (n_full == 3) {   // s: S of tile 2, s2: of tile 1
          skv_tile_exp<false>(r.s, neg_m, c, key0, lk);
          skv_pack(r.p, r.s);
          r.open();
          skv_queue_pv<KT>(r, sm, 2 * KT, ones_desc);
          skv_queue_scores(r.s, q, sm, 0);
          hp::wgmma_commit();
          skv_tile_exp<false>(r.s2, neg_m, c, key0, lk);
          hp::wgmma_wait<0>();
          r.fence();
          skv_pack(r.p, r.s2);
          skv_pv_exp<KT, false>(r, sm, KT, ones_desc, r.s, neg_m, c, key0,
                                lk);
          skv_pv_exp<KT, true>(r, sm, 0, ones_desc, r.st, neg_m, c, tail0,
                               lk);
        } else if (n_full == 2) {   // s: S of tile 0, s2: of tile 1
          skv_tile_exp<false>(r.s2, neg_m, c, key0, lk);
          skv_pack(r.p, r.s2);
          skv_pv_exp<KT, false>(r, sm, KT, ones_desc, r.s, neg_m, c, key0,
                                lk);
          skv_pv_exp<KT, true>(r, sm, 0, ones_desc, r.st, neg_m, c, tail0,
                               lk);
        } else if (n_full == 1) {
          skv_tile_exp<false>(r.s, neg_m, c, key0, lk);
          skv_pack(r.p, r.s);
          skv_pv_exp<KT, true>(r, sm, 0, ones_desc, r.st, neg_m, c, tail0,
                               lk);
        } else {
          skv_tile_exp<true>(r.st, neg_m, c, tail0, lk);
          skv_pack(r.p, r.st);
        }
      } else if (n_full > 0) {
        skv_tile_exp<false>(r.s, neg_m, c, key0, lk);
        skv_pack(r.p, r.s);
        for (int j = n_full - 1; j > 0; --j) {   // tile j - 1's S again
          r.open();
          skv_queue_pv<KT>(r, sm, j * KT, ones_desc);
          skv_queue_scores(r.s, q, sm, (j - 1) * KT);
          r.close();
          skv_tile_exp<false>(r.s, neg_m, c, key0, lk);
          skv_pack(r.p, r.s);
        }
        skv_pv_exp<KT, true>(r, sm, 0, ones_desc, r.st, neg_m, c, tail0, lk);
      } else {
        skv_tile_exp<true>(r.st, neg_m, c, tail0, lk);
        skv_pack(r.p, r.st);
      }
      r.open();
      skv_queue_pv<TW>(r, sm, tail, ones_desc);
      r.close();

      // epilogue: O / l to bf16 through this warpgroup's q slice (and, at
      // head_dim 80, its 16-column slice), rows past lq skipped; the slices
      // are the stage's again once every consumer warp has arrived
      const float l0 = fmaxf(r.l[0], 1e-30f), l1 = fmaxf(r.l[2], 1e-30f);
      __nv_bfloat16* o_h = o + (size_t)h * lq * D;
      hp::named_barrier(1 + wg, kWg);
      hp::store_slice(o_h, q_slice, r.acc, 1.f / l0, 1.f / l1,
                      row0 + wg * 64, lq, warp, lane, D);
      if constexpr (kWide)
        hp::store_slice16(o_h + 64, sm.x.q[ring.stage] + wg * 64 * kCols16,
                          r.ox, 1.f / l0, 1.f / l1, row0 + wg * 64, lq, warp,
                          lane, D);
      hp::fence_proxy_async();   // before the stage's next TMA copy
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&sm.q_empty[ring.stage]);
      ring.advance<QS>();
    }
  }
}

// the six tensor maps of a short-kv launch: q, k and v (at head_dim 80
// their first 64 columns) and, at 80, their last 16 (at 64 copies of the
// first three, never read)
template <int D>
struct SkvMaps {
  CUtensorMap q, k, v, qx, kx, vx;
  bool encode(const void* q_, const void* k_, const void* v_, int bh,
              int lq, int lk) {
    hp::MapCache& cache = fwd_map_cache();
    if (!(cache.get(&q, q_, bh, lq, D) && cache.get(&k, k_, bh, lk, D) &&
          cache.get(&v, v_, bh, lk, D)))
      return false;
    if constexpr (D == 64) {
      qx = q;
      kx = k;
      vx = v;
      return true;
    }
    return cache.get(&qx, q_, bh, lq, D, kCols16) &&
           cache.get(&kx, k_, bh, lk, D, kCols16) &&
           cache.get(&vx, v_, bh, lk, D, kCols16);
  }
};

template <int TW, int D>
cudaError_t launch_shortkv_tail(const SkvMaps<D>& maps, __nv_bfloat16* o,
                                int bh, int lq, int lk, float scale_log2,
                                int sms, cudaStream_t st) {
  constexpr int smem = sizeof(SkvSmem<D>) + 1024;
  static bool allowed[64] = {};
  cudaError_t err =
      hp::allow_smem(flash_shortkv_hopper<TW, D>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int q_tiles = (lq + kBlockRows - 1) / kBlockRows;
  const int pairs = bh * q_tiles, grid = sms < pairs ? sms : pairs;
  flash_shortkv_hopper<TW, D><<<grid, kBlockThreads, smem, st>>>(
      maps.q, maps.k, maps.v, maps.qx, maps.kx, maps.vx, o, lq, lk, q_tiles,
      pairs, scale_log2);
  return cudaGetLastError();
}

// one persistent block an SM (sms of them at most), any softmax scale
template <int D>
cudaError_t launch_shortkv_bf16(const void* q, const void* k, const void* v,
                                __nv_bfloat16* o, int bh, int lq, int lk,
                                float scale_log2, int sms, cudaStream_t st) {
  if (lk > kSkvMaxKeys || sms < 1) return cudaErrorInvalidValue;
  SkvMaps<D> maps;
  if (!maps.encode(q, k, v, bh, lq, lk)) return cudaErrorInvalidValue;
  const int tail = lk - (lk - 1) / kSkvTileKeys * kSkvTileKeys;   // 1..128
  if (tail <= 16)
    return launch_shortkv_tail<16>(maps, o, bh, lq, lk, scale_log2, sms, st);
  if (tail <= 64)
    return launch_shortkv_tail<64>(maps, o, bh, lq, lk, scale_log2, sms, st);
  return launch_shortkv_tail<128>(maps, o, bh, lq, lk, scale_log2, sms, st);
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
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int lq, int lk, float scale_log2,
               cudaStream_t st) {
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  flash_fwd_f32<MODE, EXP_BF16, D><<<grid, kThreadsF32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, lq, lk,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// frozen / online / LSE forward: the f32 kernel or the bf16 wgmma one
template <int MODE, bool EXP_BF16>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int lq, int lk, float scale_log2, int is_bf16,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_f32<MODE, EXP_BF16>(q, k, v, o, lse, bh, lq, lk,
                                      scale_log2, st);
  return static_cast<int>(launch_fwd_bf16<MODE, EXP_BF16>(
      q, k, v, static_cast<__nv_bfloat16*>(o), lse, bh, lq, lk, scale_log2,
      st));
}

}  // namespace

// q, k, v, o: contiguous (bh, lq | lk, 64), 16-byte aligned, bf16 (is_bf16
// = 1) or f32 (head_dim 64 or 80 for the short-kv entry, which takes it as
// an argument, with lk <= 512 for bf16, and sms, the grid's bound: one
// persistent block an SM). scale_log2 = softmax scale * log2(e),
// positive for the bf16 frozen / online / LSE kernel, any for the f32 and
// short-kv kernels.
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
                                   int head_dim, int sms, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim != kD && head_dim != 80)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16)
    return head_dim == 80
               ? launch_f32<kShortKv, false, 80>(q, k, v, o, nullptr, bh, lq,
                                                 lk, scale_log2, st)
               : launch_f32<kShortKv, false>(q, k, v, o, nullptr, bh, lq, lk,
                                             scale_log2, st);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  return static_cast<int>(
      head_dim == 80
          ? launch_shortkv_bf16<80>(q, k, v, ob, bh, lq, lk, scale_log2, sms,
                                    st)
          : launch_shortkv_bf16<64>(q, k, v, ob, bh, lq, lk, scale_log2, sms,
                                    st));
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
