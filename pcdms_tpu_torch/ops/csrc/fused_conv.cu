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
// memory, set the pace.
//
// What the design does about it (a simple, correct first version):
//   * an implicit GEMM: M = output pixels of one batch item (a tile never
//     straddles two items: blockIdx.z is the item), N = Cout, K = 9.Cin
//     walked tap by tap, 32 input channels at a time;
//   * the prologue applies a, c and SiLU to each x element as it is staged
//     in shared memory (as [k][m], pixels contiguous, so the global loads of
//     one channel coalesce along the NCHW row) and writes 0 for a tap that
//     falls outside the image; A fragments come from ldmatrix.trans;
//   * the weight is re-laid by the wrapper to (Cout, 3, 3, Cin), K-major, so
//     one tap's 32 channels of one output channel are 64 contiguous bytes;
//   * bf16 products on mma.sync m16n8k16 with f32 accumulators; f32 inputs
//     (a spot-check route) take an FMA kernel with the same prologue;
//   * the next K step's operands are fetched into registers while the
//     current step's products run (one stage of software pipelining), and
//     the tile shrinks (128x128, 64x128, 64x64) until the grid fills two
//     waves of the 132 SMs, since the 16x32 and 8x16 levels have few pixels;
//   * no VMEM-style fit rule: x and the weight stream through shared memory
//     tile by tile, so every shape runs; the wrapper raises only where a
//     shape is outside the domain (Cin a multiple of 8).
//   * Not yet done (later work): wgmma, TMA, a multi-stage pipeline, split-K
//     for the small levels, activating each x element once instead of once
//     per tap, a shared-memory staged (coalesced) epilogue.
//
// The plain-C entry returns cudaGetLastError(); it never synchronises.

#include "mma.cuh"

namespace {

using namespace pcdms;

constexpr int kBK = 32;              // input channels per K step
constexpr int kThreads = 256;        // 8 warps: 4 along M x 2 along N
constexpr int kBStride = kBK + 8;    // Bs[n][k] row, 80 B: conflict-free
                                     // 32-bit fragment loads

// SiLU in f32 with the fast exp and divide: their error (a few ulp of f32)
// is far below the bf16 rounding that follows, and within the f32 route's
// 2e-5 bar
__device__ __forceinline__ float act_value(float v, int act) {
  return act ? __fdividef(v, 1.f + __expf(-v)) : v;
}

// A block covers BM = 64 * MT pixels (MT m16 tiles per warp along M) and
// BN = 16 * NT output channels (NT n8 tiles per warp along N). The K loop
// walks (tap, 32-channel chunk) steps; the next step's x, a, c and weight
// values are fetched into registers while the tensor cores work on the
// current step in shared memory, so the global loads' latency overlaps
// the products.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads)
    fused_conv_bf16(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ a, const float* __restrict__ c,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ extra,
                    __nv_bfloat16* __restrict__ y, int cin, int cout, int h,
                    int wd, int mode, int act) {
  constexpr int BM = 64 * MT, BN = 16 * NT;
  constexpr int AStride = BM + 8;    // As[k][m] row; 16-byte aligned and
                                     // conflict-free for ldmatrix
  constexpr int kRowsPerPass = kThreads / BM;      // A channel rows a pass
  constexpr int kAPer = kBK / kRowsPerPass;        // A values per thread
  constexpr int kBPer = BN * (kBK / 8) / kThreads;  // 16-byte B loads
  __shared__ __align__(16) __nv_bfloat16 As[kBK * AStride];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * kBStride];

  const int b = blockIdx.z;
  const int hw = h * wd;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  x += (size_t)b * cin * hw;
  a += (size_t)b * cin;
  c += (size_t)b * cin;

  // this thread's pixel for the A tile, and its first channel row
  const int lm = tid % BM, lk0 = tid / BM;
  const int p = m0 + lm;
  const bool pvalid = p < hw;
  const int ph = pvalid ? p / wd : 0, pw = pvalid ? p % wd : 0;
  const int nc = (cin + kBK - 1) / kBK, steps = 9 * nc;

  // the register stage: raw x with its a, c (all 0 where the tap falls
  // outside the image or past cin, so the activation gives 0), and weights
  __nv_bfloat16 xr[kAPer];
  float ar[kAPer], cr[kAPer];
  uint4 br[kBPer];

  auto fetch = [&](int step) {
    const int tap = step / nc, c0 = (step - tap * nc) * kBK;
    const int hs = ph + tap / 3 - 1, ws = pw + tap % 3 - 1;
    const bool inside = pvalid && hs >= 0 && hs < h && ws >= 0 && ws < wd;
    const __nv_bfloat16* xp = x + (inside ? hs * wd + ws : 0);
#pragma unroll
    for (int j = 0; j < kAPer; ++j) {
      const int ch = c0 + lk0 + j * kRowsPerPass;
      const bool ok = inside && ch < cin;
      xr[j] = ok ? xp[(size_t)ch * hw] : __float2bfloat16(0.f);
      ar[j] = ok ? a[ch] : 0.f;
      cr[j] = ok ? c[ch] : 0.f;
    }
    const __nv_bfloat16* wp = w + (size_t)tap * cin;
#pragma unroll
    for (int v = 0; v < kBPer; ++v) {
      const int i = tid + v * kThreads;
      const int co = n0 + i / (kBK / 8), ch = c0 + (i % (kBK / 8)) * 8;
      br[v] = (co < cout && ch < cin)
                  ? *reinterpret_cast<const uint4*>(wp + (size_t)co * 9 * cin +
                                                    ch)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  fetch(0);
  for (int step = 0; step < steps; ++step) {
    __syncthreads();   // the previous step's products are done with smem
    // A: activated, rounded to bf16 (0 outside the image); B: as loaded
#pragma unroll
    for (int j = 0; j < kAPer; ++j)
      As[(lk0 + j * kRowsPerPass) * AStride + lm] = __float2bfloat16(
          act_value(__bfloat162float(xr[j]) * ar[j] + cr[j], act));
#pragma unroll
    for (int v = 0; v < kBPer; ++v) {
      const int i = tid + v * kThreads;
      *reinterpret_cast<uint4*>(Bs + (i / (kBK / 8)) * kBStride +
                                (i % (kBK / 8)) * 8) = br[v];
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[MT][4];
      const int j = lane >> 3, r = lane & 7;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4_trans(af[mt], As + (kk + (j >> 1) * 8 + r) * AStride +
                                      wm * 16 * MT + mt * 16 + (j & 1) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* bp =
            Bs + (wn * 8 * NT + nt * 8 + g) * kBStride + kk + t4 * 2;
        const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

  // epilogue: + bias (+ temb | + residual) in f32, one rounding, NCHW
  y += (size_t)b * cout * hw;
  if (mode == 2) extra += (size_t)b * cout * hw;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 * MT + mt * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 8 * NT + nt * 8 + 2 * t4 + (e & 1);
        if (m >= hw || n >= cout) continue;
        float v = acc[mt][nt][e] + bias[n];
        if (mode == 1)
          v += __bfloat162float(extra[(size_t)b * cout + n]);
        else if (mode == 2)
          v += __bfloat162float(extra[(size_t)n * hw + m]);
        y[(size_t)n * hw + m] = __float2bfloat16(v);
      }
    }
  }
}

template <int MT, int NT>
long n_blocks(int batch, int hw, int cout) {
  return (long)((hw + 64 * MT - 1) / (64 * MT)) *
         ((cout + 16 * NT - 1) / (16 * NT)) * batch;
}

template <int MT, int NT>
void launch_bf16(const void* x, const float* a, const float* c,
                 const void* weight, const float* bias, const void* extra,
                 void* y, int batch, int cin, int cout, int h, int w,
                 int mode, int act, cudaStream_t st) {
  using T = __nv_bfloat16;
  const dim3 grid((h * w + 64 * MT - 1) / (64 * MT),
                  (cout + 16 * NT - 1) / (16 * NT), batch);
  fused_conv_bf16<MT, NT><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), a, c, static_cast<const T*>(weight), bias,
      static_cast<const T*>(extra), static_cast<T*>(y), cin, cout, h, w,
      mode, act);
}

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
// (batch, cin) f32; weight: (cout, 3, 3, cin) in x's dtype; bias: (cout,)
// f32; extra: temb (batch, cout) for mode 1, residual (batch, cout, h, w)
// for mode 2 (both in x's dtype), unused for mode 0; y: (batch, cout, h, w).
// cin must be a multiple of 8 (16-byte weight loads).
extern "C" int pcdms_fused_gn_silu_conv(const void* x, const void* a,
                                        const void* c, const void* weight,
                                        const void* bias, const void* extra,
                                        void* y, int batch, int cin, int cout,
                                        int h, int w, int mode, int act,
                                        int is_bf16, void* stream) {
  if (cin % 8 != 0 || mode < 0 || mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  const float* af = static_cast<const float*>(a);
  const float* cf = static_cast<const float*>(c);
  const float* bf = static_cast<const float*>(bias);
  if (is_bf16) {
    // the largest tile that still gives two waves of blocks on 132 SMs:
    // 128 x 128 at 64x128 pixels, 64 x 128 at 32x64, 64 x 64 below
    constexpr long kTwoWaves = 2 * 132;
    if (n_blocks<2, 8>(batch, hw, cout) >= kTwoWaves)
      launch_bf16<2, 8>(x, af, cf, weight, bf, extra, y, batch, cin, cout, h,
                        w, mode, act, st);
    else if (n_blocks<1, 8>(batch, hw, cout) >= kTwoWaves)
      launch_bf16<1, 8>(x, af, cf, weight, bf, extra, y, batch, cin, cout, h,
                        w, mode, act, st);
    else
      launch_bf16<1, 4>(x, af, cf, weight, bf, extra, y, batch, cin, cout, h,
                        w, mode, act, st);
  } else {
    const dim3 grid((hw + kFBM - 1) / kFBM, (cout + kFBN - 1) / kFBN, batch);
    fused_conv_f32<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), af, cf,
        static_cast<const float*>(weight), bf,
        static_cast<const float*>(extra), static_cast<float*>(y), cin, cout,
        h, w, mode, act);
  }
  return static_cast<int>(cudaGetLastError());
}
