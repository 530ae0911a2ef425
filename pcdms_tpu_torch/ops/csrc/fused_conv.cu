// Fused GroupNorm-affine + SiLU + conv3x3 + bias (+ time embedding |
// + residual) for Hopper (sm_90a), NCHW in and out.
//
// Replaces the Pallas TPU kernel _fused_kernel of
// pcdms_tpu/ops/fused_conv.py (l.67-124, called at l.190 through
// gn_silu_conv3x3 l.227):
//
//   y[b] = conv3x3(act(x[b] * a[b] + c[b])) + bias (+ temb[b] | + res[b])
//
// where a, c are the GroupNorm statistics and affine folded to per-(B, C)
// f32 coefficients (computed outside, as JAX computes them in XLA), act is
// SiLU (or the identity under apply_act = 0), and the padding border is zero
// AFTER the activation. Rounding points are the TPU kernel's: the affine and
// SiLU in f32, the activated value rounded to x's dtype before the products,
// f32 accumulation, bias then the time embedding (mode 1) or the residual
// (mode 2) added in f32, one final rounding to x's dtype.
//
// What bounds it on this card: 2.B.H.W.Cin.Cout.9 flops against x, y, the
// weight and the residual each moved once. At every UNet shape but the
// smallest at 8x16 that is operations (989 TF/s bf16): the level-0
// 320->320 conv at batch 2 (64x128 pixels) is 30.2 GFLOP, 0.0305 ms, against
// 33 MB, 0.0099 ms at 3.35 TB/s; so the tensor cores, fed from shared
// memory, set the pace, and every x element costs an affine, an exp and a
// divide before it reaches them.
//
// What the design does about it (bf16; warp-specialised as the attention
// kernels: two consumer warpgroups, one producer thread issuing TMA):
//   * An implicit GEMM, M = output pixels, N = Cout, K = 9 Cin. A block
//     owns an 8 x 16 tile of output pixels of one image (128 rows: 64 a
//     consumer warpgroup, one image row of the tile a warp) and 160 output
//     channels (wgmma's n160; the UNet's 320, 640 and 1280 are multiples),
//     and walks Cin in chunks of 64 channels, the 9 taps of a chunk in turn.
//   * Each x element is activated once per (block, chunk), not once per
//     tap: the consumers load the chunk's haloed window, 10 x 18 pixels x 64
//     channels, with ordinary loads along W (the threads must pass each
//     element through registers to activate it; TMA could not map NCHW x
//     where W * 2 bytes is not a multiple of 16 anyway), apply a, c and SiLU
//     in f32, round to bf16, write 0 where the window leaves the image
//     (after the activation: SiLU(c) is not 0) or passes Cin, and store
//     [pixel][64 channels] rows of 128 bytes, 128-byte XOR-swizzled (chunk
//     q of row r at q ^ (r & 7)). 180 window pixels for 128 outputs: 1.4
//     activations of an element per block, where the first design made 9.
//     The window is double-buffered: chunk k + 1 is activated while chunk
//     k's products run, one slot of (pixel, 8 channels) items a tap, each
//     slot's loads issued two taps ahead.
//   * Products on wgmma m64n160k16 with A from registers: for tap (dy, dx)
//     the A row of output pixel (i, j) is window pixel (i + dy, j + dx), a
//     start that no shared-memory descriptor can express, so each lane
//     gives ldmatrix.x4 its own row's address (conflict-free: 8 consecutive
//     window pixels cover the 8 swizzle positions).
//   * Weights by TMA: the wrapper's (Cout, 3, 3, Cin) weight is a
//     three-dimensional map (Cin, 9, Cout) with box (64, 1, 160), so a
//     chunk past Cin and a block past Cout arrive as zeros, tap by tap; one
//     producer thread keeps a ring of six (chunk, tap) tiles full under full
//     / empty mbarriers, read K-major (trans-b = 0).
//   * Split-K where the grid is small: with fewer (tile, N block, image)
//     blocks than half the SMs, the wrapper splits the chunks over `split`
//     blocks, which write f32 partial sums to a workspace; a second kernel
//     sums them in a fixed order (deterministic), adds bias and temb or the
//     residual, and rounds once.
//   * The epilogue stages the f32 tile through shared memory as
//     [channel][pixel] (the window and ring, idle by then) and writes y, and
//     reads the residual, 8 pixels (16 bytes) at a time along W where W is a
//     multiple of 8.
//   * What is left (PERF.md): every block reads the whole weight of its
//     160 channels from L2 (236 MB at level 0; with products and
//     activation removed the kernel still takes 0.033 ms, about 7 TB/s),
//     and the activation hides under the products only in part. Not done:
//     2-CTA clusters sharing each weight tile by multicast, a product in
//     flight across taps (each warpgroup waits for its tap's products; the
//     other warpgroup's fill the gap), a persistent grid.
// f32 (a spot-check route, not the main path): an FMA kernel with the same
// prologue per tap, so f32 keeps full precision.
//
// The plain-C entry returns cudaGetLastError(); it never synchronises.

#include "hopper.cuh"

namespace {

namespace hp = pcdms::hopper;
using hp::kBlockThreads;
using hp::kConsumers;
using hp::kWg;

constexpr int kThreads = 256;        // the f32 kernel's block

// SiLU in f32 with the fast exp and divide: their error (a few ulp of f32)
// is far below the bf16 rounding that follows, and within the f32 route's
// 2e-5 bar
__device__ __forceinline__ float act_value(float v, int act) {
  return act ? __fdividef(v, 1.f + __expf(-v)) : v;
}

// ---------------------------------------------------------------------------
// bf16: activated window + TMA weight ring -> wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kTileH = 8, kTileW = 16;             // output pixels a block
constexpr int kPixels = kTileH * kTileW;
constexpr int kWinW = kTileW + 2;                  // the haloed window
constexpr int kWinRows = (kTileH + 2) * kWinW;     // 180 pixels
constexpr int kChunk = 64;                         // input channels a chunk
constexpr int kBlockN = 160;                       // output channels a block
constexpr int kTaps = 9;
constexpr int kStages = 6;                         // weight ring
constexpr int kConsumerThreads = kConsumers * kWg;
constexpr int kItems = kWinRows * (kChunk / 8);    // (pixel, 8 channels)
constexpr int kSlots = (kItems + kConsumerThreads - 1) / kConsumerThreads;
constexpr int kStageLd = kPixels + 4;              // f32 staging row: the
                                                   // accumulator's writes
                                                   // are conflict-free
constexpr int kWTileBytes = kBlockN * hp::kRowBytes;
// the consumers' gain over the launch's 168 registers must not exceed what
// the producer gives back, or setmaxnreg.inc waits for ever
constexpr int kConvProducerRegs = 24, kConvConsumerRegs = 240;
constexpr int kConvLaunchRegs = 65536 / kBlockThreads / 8 * 8;
static_assert((kConvLaunchRegs - kConvProducerRegs) * kWg >=
                  (kConvConsumerRegs - kConvLaunchRegs) * kConsumerThreads,
              "setmaxnreg: the consumers take more than the producer frees");
static_assert(kPixels == hp::kBlockRows && kTileW == 16,
              "a warp's 16 rows are one image row of the tile");
static_assert(kSlots + 2 <= kTaps,
              "slot s is activated at tap s; slots 0 and 1 of the chunk "
              "after next are loaded at the last two taps");

struct ConvLoop {
  uint8_t x[2][kWinRows * hp::kRowBytes];   // activated windows
  uint8_t w[kStages][kWTileBytes];          // weight ring
};
struct ConvSmem {
  union {
    ConvLoop loop;
    float out[kBlockN * kStageLd];          // the epilogue's staging
  };
  uint64_t full[kStages], empty[kStages];
};
static_assert(2 * kWinRows * hp::kRowBytes % 1024 == 0 &&
                  kWTileBytes % 1024 == 0,
              "every ring stage is 1024-byte aligned (128-byte swizzle)");
static_assert(sizeof(ConvSmem) + 1024 <= 232448,
              "shared memory of one block on an H100");

// Block (tile, N block, image * split + z). The consumers activate the
// window of chunk k + 1 while chunk k's products run; the producer thread
// brings the weight tiles of the block's chunks, tap by tap.
__global__ void __launch_bounds__(kBlockThreads, 1)
    fused_conv_hopper(const __grid_constant__ CUtensorMap map_w,
                      const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const float* __restrict__ c,
                      const float* __restrict__ bias,
                      const __nv_bfloat16* __restrict__ extra,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                      int cin, int cout, int h, int wd, int tiles_w,
                      int split, int mode, int act, int vec) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  ConvSmem& sm = hp::shared_storage<ConvSmem>(smem_raw);

  const int tid = threadIdx.x, wg = tid / kWg;
  const int h0 = blockIdx.x / tiles_w * kTileH;
  const int w0 = blockIdx.x % tiles_w * kTileW;
  const int n0 = blockIdx.y * kBlockN;
  const int b = blockIdx.z / split, z = blockIdx.z % split;
  const int hw = h * wd;
  const int chunks = (cin + kChunk - 1) / kChunk;
  const int k_begin = z * chunks / split, k_end = (z + 1) * chunks / split;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&sm.full[s], 1);
      hp::mbar_init(&sm.empty[s], kConsumers * 4);   // a consumer warp each
    }
    hp::mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the weight ring full ----
    hp::reg_dealloc<kConvProducerRegs>();
    if (tid == kConsumers * kWg) {
      hp::Ring ring;
      for (int k = k_begin; k < k_end; ++k)
        for (int tap = 0; tap < kTaps; ++tap) {
          hp::mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
          hp::mbar_arrive_expect_tx(&sm.full[ring.stage], kWTileBytes);
          hp::tma_load_3d(sm.loop.w[ring.stage], &map_w,
                          &sm.full[ring.stage], k * kChunk, tap, n0);
          ring.advance<kStages>();
        }
    }
    return;
  }

  // ---- consumers: 64 output pixels a warpgroup, 160 channels ----
  hp::reg_alloc<kConvConsumerRegs>();
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const __nv_bfloat16* xb = x + (size_t)b * cin * hw;
  const float* ab = a + (size_t)b * cin;
  const float* cb = c + (size_t)b * cin;

  // this thread's slots of the window: item i = tid + 256 s is window pixel
  // i % kWinRows (consecutive lanes on consecutive pixels: coalesced loads
  // along W, conflict-free 16-byte stores) and channels [8 (i / kWinRows),
  // + 8) of a chunk. src: the pixel's offset in the image, -1 outside it
  // (stored as 0), -2 for no item; dst: its byte offset in a window buffer
  int src[kSlots], oct[kSlots];
  uint32_t dst[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int i = tid + s * kConsumerThreads;
    const int r = i % kWinRows, o = i / kWinRows;
    const int gh = h0 - 1 + r / kWinW, gw = w0 - 1 + r % kWinW;
    const bool inside = gh >= 0 && gh < h && gw >= 0 && gw < wd;
    src[s] = i >= kItems ? -2 : inside ? gh * wd + gw : -1;
    oct[s] = o * 8;
    dst[s] = r * hp::kRowBytes + ((o ^ (r & 7)) << 4);
  }
  // raw x of the slot being prefetched, two buffers: slot s uses s & 1
  __nv_bfloat16 raw[2][8];
  auto load = [&](__nv_bfloat16(&v)[8], int s, int k) {
    const int ch = k * kChunk + oct[s];
    if (src[s] >= 0 && ch < cin) {
      const __nv_bfloat16* p = xb + (size_t)ch * hw + src[s];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = p[(size_t)e * hw];
    }
  };
  // activated, rounded to bf16, 0 outside the image or past cin
  auto store = [&](const __nv_bfloat16(&v)[8], int s, int k, uint8_t* win) {
    if (src[s] == -2) return;
    const int ch = k * kChunk + oct[s];
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (src[s] >= 0 && ch < cin) {
      const float4 a0 = *reinterpret_cast<const float4*>(ab + ch);
      const float4 a1 = *reinterpret_cast<const float4*>(ab + ch + 4);
      const float4 c0 = *reinterpret_cast<const float4*>(cb + ch);
      const float4 c1 = *reinterpret_cast<const float4*>(cb + ch + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
      float f[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        f[e] = act_value(__bfloat162float(v[e]) * av[e] + cv[e], act);
      out = make_uint4(hp::pack2_bf16(f[0], f[1]), hp::pack2_bf16(f[2], f[3]),
                       hp::pack2_bf16(f[4], f[5]), hp::pack2_bf16(f[6], f[7]));
    }
    *reinterpret_cast<uint4*>(win + dst[s]) = out;
  };

  // the block's first chunk into window 0, the same slot pipeline as below
  load(raw[0], 0, k_begin);
  load(raw[1], 1, k_begin);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    store(raw[s & 1], s, k_begin, sm.loop.x[0]);
    if (s + 2 < kSlots) load(raw[s & 1], min(s + 2, kSlots - 1), k_begin);
  }
  if (k_begin + 1 < k_end) {
    load(raw[0], 0, k_begin + 1);
    load(raw[1], 1, k_begin + 1);
  }
  hp::named_barrier(1, kConsumerThreads);

  float acc[kBlockN / 2];
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) acc[i] = 0.f;
  // the lane's A row at tap (0, 0): its warp's tile row, its column; lanes
  // 16-31 read the same rows at channel + 8
  const int row0 = (wg * 4 + warp) * kWinW + (lane & 15);
  const int half = lane >> 4;
  const uint32_t win_u32[2] = {hp::smem_u32(sm.loop.x[0]),
                               hp::smem_u32(sm.loop.x[1])};
  hp::Ring ring;
  for (int k = k_begin; k < k_end; ++k) {
    const int buf = (k - k_begin) & 1;
    const uint32_t win = buf ? win_u32[1] : win_u32[0];
    uint8_t* next = sm.loop.x[buf ^ 1];
    const bool has_next = k + 1 < k_end, has_next2 = k + 2 < k_end;
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int r = row0 + (tap / 3) * kWinW + tap % 3;
      uint32_t frag[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::ldmatrix_x4(frag[kk], win + r * hp::kRowBytes +
                                      (((2 * kk + half) ^ (r & 7)) << 4));
      hp::mbar_wait(&sm.full[ring.stage], ring.phase);
      const uint64_t w_desc = hp::make_desc(sm.loop.w[ring.stage]);
      hp::fence_acc(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hp::wgmma_rs_k160(acc, frag[kk], w_desc + kk * hp::kStepK);
      hp::wgmma_commit();
      // while the products run: slot `tap` of the next chunk, and the
      // loads two slots on
      if (has_next && tap < kSlots) {
        store(raw[tap & 1], min(tap, kSlots - 1), k + 1, next);
        if (tap + 2 < kSlots)
          load(raw[tap & 1], min(tap + 2, kSlots - 1), k + 1);
      }
      if (has_next2 && tap >= kTaps - 2)
        load(raw[tap == kTaps - 1], tap == kTaps - 1, k + 2);
      hp::wgmma_wait<0>();
      hp::fence_acc(acc);
      hp::fence_frag(frag);
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&sm.empty[ring.stage]);
      ring.advance<kStages>();
    }
    // the next window is written, this one read, by both warpgroups
    hp::named_barrier(1, kConsumerThreads);
  }

  // ---- epilogue: every product and copy is done; the staging reuses the
  // windows and the ring ----
  const int g = lane >> 2, t4 = lane & 3;
  const int m = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sm.out[(8 * nt + 2 * t4 + (e & 1)) * kStageLd + m + 8 * (e >> 1)] =
          acc[4 * nt + e];
  hp::named_barrier(1, kConsumerThreads);
  const int batch = gridDim.z / split;
  for (int it = tid; it < kBlockN * kPixels / 8; it += kConsumerThreads) {
    const int n = it / (kPixels / 8), q = it % (kPixels / 8);
    const int co = n0 + n, gh = h0 + q / 2, gw = w0 + (q & 1) * 8;
    if (co >= cout || gh >= h || gw >= wd) continue;
    const float4 s0 = *reinterpret_cast<const float4*>(
        sm.out + n * kStageLd + q * 8);
    const float4 s1 = *reinterpret_cast<const float4*>(
        sm.out + n * kStageLd + q * 8 + 4);
    float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const size_t o = ((size_t)b * cout + co) * hw + (size_t)gh * wd + gw;
    const int cnt = min(8, wd - gw);
    if (ws != nullptr) {
      // split-K: this block's f32 partial sums, [z][b][co][pixel]
      float* p = ws + (size_t)z * batch * cout * hw + o;
      if (vec) {
        *reinterpret_cast<float4*>(p) = s0;
        *reinterpret_cast<float4*>(p + 4) = s1;
      } else {
        for (int j = 0; j < cnt; ++j) p[j] = v[j];
      }
      continue;
    }
    const float bn = bias[co];
    const float tn = mode == 1 ? __bfloat162float(extra[(size_t)b * cout + co])
                               : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] += bn;
      if (mode == 1) v[j] += tn;
    }
    if (vec) {
      if (mode == 2) {
        const uint4 rv = *reinterpret_cast<const uint4*>(extra + o);
        const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += __bfloat162float(rb[j]);
      }
      *reinterpret_cast<uint4*>(y + o) =
          make_uint4(hp::pack2_bf16(v[0], v[1]), hp::pack2_bf16(v[2], v[3]),
                     hp::pack2_bf16(v[4], v[5]), hp::pack2_bf16(v[6], v[7]));
    } else {
      for (int j = 0; j < cnt; ++j) {
        float u = v[j];
        if (mode == 2) u += __bfloat162float(extra[o + j]);
        y[o + j] = __float2bfloat16(u);
      }
    }
  }
}

// split-K: y = the partial sums of the `split` blocks added in order 0, 1,
// ..., then + bias (+ temb | + residual) in f32, one rounding
__global__ void fused_conv_reduce(const float* __restrict__ ws,
                                  const float* __restrict__ bias,
                                  const __nv_bfloat16* __restrict__ extra,
                                  __nv_bfloat16* __restrict__ y, int split,
                                  int cout, int hw, long total, int mode) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < split; ++s) v += ws[s * total + i];
    const long bc = i / hw;   // b * cout + channel
    v += bias[bc % cout];
    if (mode == 1)
      v += __bfloat162float(extra[bc]);
    else if (mode == 2)
      v += __bfloat162float(extra[i]);
    y[i] = __float2bfloat16(v);
  }
}

// the last few weight maps, per host thread
hp::MapCache& conv_map_cache() {
  static thread_local hp::MapCache cache;
  return cache;
}

cudaError_t launch_bf16(const void* x, const float* a, const float* c,
                        const void* weight, const float* bias,
                        const void* extra, void* y, float* ws, int batch,
                        int cin, int cout, int h, int w, int mode, int act,
                        int split, cudaStream_t st) {
  using T = __nv_bfloat16;
  const int chunks = (cin + kChunk - 1) / kChunk;
  if (split < 1 || split > chunks || (split > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!conv_map_cache().get(&map, weight, {cin, kTaps, cout},
                            {kChunk, 1, kBlockN}))
    return cudaErrorInvalidValue;
  constexpr int smem = sizeof(ConvSmem) + 1024;
  static bool allowed[64] = {};
  cudaError_t err = hp::allow_smem(fused_conv_hopper, smem, allowed);
  if (err != cudaSuccess) return err;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const long tiles = (long)((h + kTileH - 1) / kTileH) * tiles_w;
  const long n_blocks = (cout + kBlockN - 1) / kBlockN;
  const long gz = (long)batch * split;
  if (tiles > 0x7fffffffL || n_blocks > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  const int vec = w % 8 == 0 && ((reinterpret_cast<uintptr_t>(y) |
                                  reinterpret_cast<uintptr_t>(extra) |
                                  reinterpret_cast<uintptr_t>(ws)) & 15) == 0;
  fused_conv_hopper<<<dim3(tiles, n_blocks, gz), kBlockThreads, smem, st>>>(
      map, static_cast<const T*>(x), a, c, bias, static_cast<const T*>(extra),
      static_cast<T*>(y), ws, cin, cout, h, w, tiles_w, split, mode, act,
      vec);
  if (split == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long total = (long)batch * cout * h * w;
  const long want = (total + 255) / 256;
  const int blocks = (int)(want < 132L * 16 ? want : 132L * 16);
  fused_conv_reduce<<<blocks, 256, 0, st>>>(
      ws, bias, static_cast<const T*>(extra), static_cast<T*>(y), split, cout,
      h * w, total, mode);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32, FMA
// ---------------------------------------------------------------------------

// f32: 64 pixels x 64 output channels per block, 16 channels per K step,
// each thread a 4 x 4 patch with FMA, so f32 keeps full precision
constexpr int kFBM = 64, kFBN = 64, kFBK = 16;

__global__ void __launch_bounds__(kThreads)
    fused_conv_f32(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ c, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ extra, float* __restrict__ y,
                   int cin, int cout, int h, int wd, int mode, int act) {
  __shared__ float As[kFBK][kFBM];
  __shared__ float Bs[kFBK][kFBN + 1];

  const int b = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * kFBM, n0 = blockIdx.y * kFBN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  x += (size_t)b * cin * hw;
  a += (size_t)b * cin;
  c += (size_t)b * cin;

  const int lm = tid % kFBM, lk0 = tid / kFBM;   // A loader: 4 rows a pass
  const int p = m0 + lm;
  const bool pvalid = p < hw;
  const int ph = pvalid ? p / wd : 0, pw = pvalid ? p % wd : 0;
  const int bk = tid % kFBK, bn0 = tid / kFBK;   // B loader: 16 rows a pass

  float acc[4][4] = {};
  for (int tap = 0; tap < 9; ++tap) {
    const int hs = ph + tap / 3 - 1, ws = pw + tap % 3 - 1;
    const bool inside = pvalid && hs >= 0 && hs < h && ws >= 0 && ws < wd;
    const float* xp = x + (inside ? hs * wd + ws : 0);
    for (int c0 = 0; c0 < cin; c0 += kFBK) {
      __syncthreads();
      for (int k = lk0; k < kFBK; k += kThreads / kFBM) {
        const int ch = c0 + k;
        float v = 0.f;
        if (inside && ch < cin)
          v = act_value(xp[(size_t)ch * hw] * a[ch] + c[ch], act);
        As[k][lm] = v;
      }
      for (int n = bn0; n < kFBN; n += kThreads / kFBK) {
        const int co = n0 + n, ch = c0 + bk;
        Bs[bk][n] = (co < cout && ch < cin)
                        ? w[((size_t)co * 9 + tap) * cin + ch] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kFBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }

  y += (size_t)b * cout * hw;
  if (mode == 2) extra += (size_t)b * cout * hw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m >= hw || n >= cout) continue;
      float v = acc[i][j] + bias[n];
      if (mode == 1)
        v += extra[(size_t)b * cout + n];
      else if (mode == 2)
        v += extra[(size_t)n * hw + m];
      y[(size_t)n * hw + m] = v;
    }
  }
}

}  // namespace

// x: (batch, cin, h, w) contiguous, bf16 (is_bf16 = 1) or f32; a, c:
// (batch, cin) f32, 16-byte aligned; weight: (cout, 3, 3, cin) in x's dtype;
// bias: (cout,) f32; extra: temb (batch, cout) for mode 1, residual (batch,
// cout, h, w) for mode 2 (both in x's dtype), unused for mode 0; y: (batch,
// cout, h, w); workspace: (split, batch, cout, h, w) f32 for a bf16 call
// with split > 1, else null (split 1; the f32 kernel takes split 1 only).
// cin must be a multiple of 8 (16-byte weight rows).
extern "C" int pcdms_fused_gn_silu_conv(const void* x, const void* a,
                                        const void* c, const void* weight,
                                        const void* bias, const void* extra,
                                        void* y, void* workspace, int batch,
                                        int cin, int cout, int h, int w,
                                        int mode, int act, int is_bf16,
                                        int split, void* stream) {
  if (cin % 8 != 0 || mode < 0 || mode > 2 || batch < 1 || cin < 1 ||
      cout < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16)
    return static_cast<int>(launch_bf16(x, af, cf, weight, bf, extra, y,
                                        static_cast<float*>(workspace), batch,
                                        cin, cout, h, w, mode, act, split,
                                        st));
  if (split != 1 || workspace != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((hw + kFBM - 1) / kFBM, (cout + kFBN - 1) / kFBN, batch);
  fused_conv_f32<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), af, cf,
      static_cast<const float*>(weight), bf,
      static_cast<const float*>(extra), static_cast<float*>(y), cin, cout,
      h, w, mode, act);
  return static_cast<int>(cudaGetLastError());
}
