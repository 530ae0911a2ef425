// Hopper (sm_90a) building blocks for the attention kernels (forward and
// backward) and the fused GroupNorm + SiLU + conv3x3 kernel: the tensor map
// a TMA copy needs, mbarriers, TMA loads, ldmatrix, wgmma descriptors and
// the wgmma products (bf16 in, f32 accumulate), as thin PTX wrappers; and
// what the warp-specialised kernels share: the block's shape, the ring
// position, the swizzled epilogue and, on the host, the cache of tensor
// maps and the shared-memory opt-in.
//
// Layout conventions
//
// * Shared-memory tiles. A (rows, 64) bf16 tile is stored as rows of 128
//   bytes, row r at byte r * 128 of a 1024-byte aligned base, with the
//   128-byte swizzle: the 16-byte chunk c of row r lies at chunk
//   c ^ (r & 7). That is what a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B
//   writes and what a wgmma descriptor with layout type 1 (B128) reads; the
//   swizzle is a function of the address bits (bits 4-6 ^= bits 7-9), which
//   is why the base must be 1024-byte aligned. Eight rows form one 1024-byte
//   swizzle atom.
// * Tensor maps. A (BH, L, 64) tensor is mapped as three dimensions
//   (64, L, BH), innermost first, box (64, 64, 1): one copy brings 64 rows
//   of one head, and rows past L are filled with zeros by the hardware (a
//   two-dimensional map over BH * L rows would bring the next head's rows
//   instead). A copy always counts the whole box, 8192 bytes, on its
//   mbarrier, however many rows were out of range. The conv weight, re-laid
//   to (Cout, 3, 3, Cin), is mapped as (Cin, 9, Cout), box (64, 1, 160):
//   one copy brings one tap's 64 input channels of 160 output channels, as
//   160 rows of 128 bytes, zeros past Cin (never the next tap's channels)
//   and past Cout.
// * Rows of 80 (160 bytes: more than a 128-byte-swizzled box may span).
//   A (BH, L, 80) tensor has two maps over the same (80, L, BH)
//   dimensions: box (64, 64, 1) with the 128-byte swizzle brings the first
//   64 columns as above (the copy's column coordinate is 0), and box
//   (16, 64, 1) with the 32-byte swizzle the last 16 (column coordinate
//   64): rows of 32 bytes, the 16-byte chunk c of row r at c ^ ((r >> 2) &
//   1) (bit 4 ^= bit 7), 2048 bytes a copy. Such a 16-column tile is read
//   by wgmma through descriptors of layout type 3 (B32) with SBO = 256, the
//   distance between 8-row groups: K-major (Q and K of S = Q.K^T: one
//   k-step of 16 columns is the whole row) and MN-major (V of P.V: the 16
//   columns are N, 8 keys lie 32 bytes apart, the next 8 at SBO; the
//   k-step of 16 keys advances the start by 512 bytes, descriptor + 32; the
//   leading byte offset, the next 16 columns, is never reached at N = 16).
// * K-major operand (the product contracts over the tile's 64 columns: the
//   A operand of S = Q.K^T, and K as its B operand): descriptor start = the
//   tile's (or the 64-row slice's) address, stride byte offset (SBO) = 1024,
//   the distance between 8-row groups; the leading byte offset is not used
//   by a swizzled K-major layout. The k-step of 16 columns advances the
//   start address by 32 bytes (descriptor + 2).
// * MN-major operand (the product contracts over the tile's rows: K as the
//   B operand of dS.K, read with trans-b = 1): the 64 columns are one
//   128-byte row, 8 rows of k lie 128 bytes apart and the next 8 at SBO =
//   1024; the leading byte offset (the next 64 columns) is never reached at
//   N = 64. The k-step of 16 rows advances the start address by 2048 bytes
//   (descriptor + 128).
// * A operand from shared memory through registers (the conv: each lane's
//   row of A starts at its own window pixel, which no descriptor can
//   express): ldmatrix_x4 with lanes 0-15 on the 16 rows of a warp at
//   column c and lanes 16-31 on the same rows at column c + 8 gives the
//   four registers of a k-step, as below.
// * Register fragments. The f32 accumulator of m64nNk16 holds, in thread
//   (warp w, lane) of the warpgroup, d[4 * nt + e] = row 16 w + lane / 4
//   (+ 8 if e >= 2), column 8 nt + 2 (lane % 4) + (e & 1): per warp the
//   m16n8 accumulator layout. An A operand from registers is four 32-bit
//   registers per k-step of 16, a[kk] = {d[8kk], d[8kk+1]}, {d[8kk+2],
//   d[8kk+3]}, {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]} packed to bf16
//   pairs, so an accumulator becomes the A operand of the next product
//   without leaving the thread (pack_a).
// * Barrier phases. An mbarrier starts in phase 0; mbar_wait(bar, p)
//   returns once the phase of parity p has completed. A ring stage has a
//   `full` barrier (the producer's expect-tx arrival plus the bytes of its
//   copies) and an `empty` barrier (one arrival per consumer warp). Both
//   sides keep (stage, phase) and flip phase when the stage wraps; the
//   consumer waits full[stage] with `phase`, the producer waits
//   empty[stage] with `phase ^ 1`, which passes at once on the first lap.
// * Proxies. TMA and wgmma use the asynchronous proxy. Data that a TMA copy
//   wrote is visible to wgmma after the mbarrier wait. Shared memory that
//   threads wrote and wgmma or a TMA store then reads needs
//   fence.proxy.async.shared::cta first (fence_proxy_async: the forward's
//   tile of ones; the epilogues write and read their staging buffer with
//   ordinary loads and stores and need none). wgmma_fence() orders register accesses (accumulators, A
//   fragments) before the next batch of products.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace pcdms {
namespace hopper {

constexpr int kRowBytes = 128;           // one 64-element bf16 row
constexpr int kBoxRows = 64;             // rows of one TMA copy
constexpr int kBoxBytes = kBoxRows * kRowBytes;
// the last 16 columns of an 80-wide row, 32-byte swizzled
constexpr int kCols16 = 16;
constexpr int kBox16Bytes = kBoxRows * kCols16 * 2;

// the warp-specialised block: consumer warpgroups of 64 rows each, then one
// producer warpgroup whose registers setmaxnreg moves to the consumers
constexpr int kWg = 128;                 // threads of a warpgroup
constexpr int kSlice = 64 * 64;          // elements of a 64-row slice
constexpr int kConsumers = 2;            // consumer warpgroups of a block
constexpr int kBlockRows = kConsumers * 64;
constexpr int kBlockThreads = (kConsumers + 1) * kWg;

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda at first use (the process
// has it loaded once a CUDA context exists), so that the library links
// against nothing but the runtime; nullptr if it is not to be had
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    void* p = lib ? dlsym(lib, "cuTensorMapEncodeTiled") : nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// the map of a contiguous bf16 tensor of three dimensions `dims`, innermost
// first, box `box`: box[0] columns of 64 with the 128-byte swizzle or of 16
// with the 32-byte swizzle, box[1] and box[2] up to 256 each; zeros outside
// the tensor; false if the encoding is refused. A (bh, len, width) tensor
// of the attention kernels is dims {width, len, bh}, box {64 or 16, 64, 1};
// the conv weight (Cout, 3, 3, Cin) is dims {Cin, 9, Cout}, box {64, 1, N}
inline bool make_tensor_map(CUtensorMap* map, const void* base,
                            const int (&dims)[3], const int (&box)[3]) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return false;
  // the encoding needs a context current on this host thread, which a
  // thread that has launched nothing yet lacks (a server's engine thread
  // whose tensors came from the caching allocator's reuse): cudaSetDevice
  // binds the device's primary context to the calling thread
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaSetDevice(device) != cudaSuccess)
    return false;
  const cuuint64_t gdims[3] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                               (cuuint64_t)dims[2]};
  const cuuint64_t strides[2] = {gdims[0] * 2, gdims[0] * gdims[1] * 2};
  const cuuint32_t gbox[3] = {(cuuint32_t)box[0], (cuuint32_t)box[1],
                              (cuuint32_t)box[2]};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), gdims, strides, gbox, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of a launch. Encoding one costs the host about as much as
// a launch, and the launches of one forward or backward need the same few,
// so the last few are kept per host thread, keyed by everything that
// defines them (a map holds the address, the shape, the box and the
// swizzle, never the data): a map of 64-wide rows is never returned for an
// 80-wide tensor on the same storage, nor a 16-column box for a 64-column
// one, nor a conv weight's map for another Cin or Cout.
struct MapCache {
  static constexpr int kSlots = 8;
  struct Slot {
    const void* base = nullptr;
    int dims[3] = {0, 0, 0}, box[3] = {0, 0, 0};
    CUtensorMap map;
  } slots[kSlots];
  int next = 0;

  // copies the map out: a later miss may overwrite the slot
  bool get(CUtensorMap* out, const void* base, const int (&dims)[3],
           const int (&box)[3]) {
    for (const Slot& s : slots)
      if (s.base == base && s.dims[0] == dims[0] && s.dims[1] == dims[1] &&
          s.dims[2] == dims[2] && s.box[0] == box[0] &&
          s.box[1] == box[1] && s.box[2] == box[2]) {
        *out = s.map;
        return true;
      }
    if (!make_tensor_map(out, base, dims, box)) return false;
    Slot& s = slots[next];
    next = (next + 1) % kSlots;
    s.base = base;
    for (int i = 0; i < 3; ++i) {
      s.dims[i] = dims[i];
      s.box[i] = box[i];
    }
    s.map = *out;
    return true;
  }

  // a (bh, len, width) tensor of the attention kernels, 64-row boxes of
  // box_cols columns
  bool get(CUtensorMap* out, const void* base, int bh, int len,
           int width = 64, int box_cols = 64) {
    return get(out, base, {width, len, bh}, {box_cols, kBoxRows, 1});
  }
};

// opts the kernel in to its dynamic shared memory, once per device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, bool (&done)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < 64 && done[device])) return err;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

// ---------------------------------------------------------------------------
// device: addresses, barriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory, moved up to the 1024-byte boundary the swizzle
// needs
template <typename Smem>
__device__ __forceinline__ Smem& shared_storage(uint8_t* raw) {
  const uint32_t pad = (1024u - (smem_u32(raw) & 1023u)) & 1023u;
  return *reinterpret_cast<Smem*>(raw + pad);
}

// ring position: stage and the parity of its current lap
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int ST>
  __device__ __forceinline__ void advance() {
    if (++stage == ST) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any other thread or the TMA unit uses a barrier
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// returns once the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one arrival on `bar` once every cp.async this thread has issued so far
// has landed; counted in the barrier's initial count (noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared, or 4 zero bytes when `live` is false
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// the box of a three-dimensional map at coordinates (c0, c1, c2), innermost
// first -> swizzled bytes at dst, counted on `bar`; what lies outside the
// tensor arrives as zeros, and the whole box is counted
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// rows [row, row + 64) of head `bh` -> one box of swizzled bytes at dst
// (8192, or 2048 for a 16-column box), counted on `bar`, from column `col`
// on; rows past the tensor's length arrive as zeros
__device__ __forceinline__ void tma_load_rows(void* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int row,
                                              int bh, int col = 0) {
  tma_load_3d(dst, map, bar, col, row, bh);
}

// four 8 x 8 bf16 matrices from shared memory, not transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes), and register j of
// lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix
// j. With lanes 0-15 on rows 0-15 of a 16 x 16 tile at column 0 and lanes
// 16-31 on the same rows at column 8, that is the A fragment of a k-step
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// makes what threads wrote to shared memory visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// barrier `id` (1-15) among `threads` threads, e.g. one warpgroup
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile (or 64-row slice) at `p`
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t addr = (smem_u32(p) & 0x3FFFFu) >> 4;
  return addr | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

constexpr uint64_t kStepK = 32 >> 4;       // K-major: 16 columns on
constexpr uint64_t kStepMN = 2048 >> 4;    // MN-major: 16 rows on

// descriptor of a 32-byte-swizzled tile of 16 columns (layout type 3,
// SBO = 256: eight 32-byte rows), 256-byte aligned, at `p`
__device__ __forceinline__ uint64_t make_desc16(const void* p) {
  const uint64_t addr = (smem_u32(p) & 0x3FFFFu) >> 4;
  return addr | (uint64_t(1) << 16) | (uint64_t(256 >> 4) << 32) |
         (uint64_t(3) << 62);
}

constexpr uint64_t kStep16MN = 512 >> 4;   // MN-major: 16 rows on

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

#define PCDMS_ACC8(d, o)                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define PCDMS_ACC32(d, o)                                                 \
  PCDMS_ACC8(d, o), PCDMS_ACC8(d, o + 8), PCDMS_ACC8(d, o + 16),          \
      PCDMS_ACC8(d, o + 24)

#define PCDMS_R32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define PCDMS_R64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

#define PCDMS_R80                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}"

// d (64 x 64) = or += A (64 x 16, shared, K-major) . B^T (64 x 16, shared,
// K-major); `accumulate` false overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PCDMS_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : PCDMS_ACC32(d, 0)
      : "l"(a), "l"(b), "r"((int)accumulate));
}

// the same with a 16-row B tile: d is 64 x 16
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a,
                                         uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : PCDMS_ACC8(d, 0)
      : "l"(a), "l"(b), "r"((int)accumulate));
}

// the same with a 128-row B tile: d is 64 x 128
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PCDMS_R64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : PCDMS_ACC32(d, 0), PCDMS_ACC32(d, 32)
      : "l"(a), "l"(b), "r"((int)accumulate));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 rows x 64 columns of a
// shared tile, MN-major: trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PCDMS_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : PCDMS_ACC32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16) += A (64 x 16, registers) . B (16 rows x 16 columns of a
// shared tile, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n"
      "}\n"
      : PCDMS_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 8) += A (64 x 16, registers) . B (16 rows x 8 columns, MN-major):
// against a tile of ones, d holds A's row-sums in every column
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 160) += A (64 x 16, registers) . B^T (160 rows x 16 columns of a
// shared tile, K-major: trans-b = 0), the conv's weight tile of 160 output
// channels read along its input channels
__device__ __forceinline__ void wgmma_rs_k160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 " PCDMS_R80
      ", {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : PCDMS_ACC32(d, 0), PCDMS_ACC32(d, 32), PCDMS_ACC8(d, 64),
        PCDMS_ACC8(d, 72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// pins an accumulator between the asynchronous products and the code that
// reads or writes it, so that the compiler moves neither across a wait
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for an A operand in registers: a product that is still running
// reads it, so it must stay where it is until the wait
template <int kN>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int i = 0; i < kN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack2_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk (16 columns) of an accumulator, rounded to bf16, as the A
// operand of the next product
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* d,
                                       int kk) {
  a[0] = pack2_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack2_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack2_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack2_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// a warp's 16 x 64 part of a warpgroup's f32 accumulator, rows g and g + 8
// of each 16 times `mul_lo` and `mul_hi`, as bf16 through `slice` (the
// warpgroup's 64 x 64 swizzled buffer) to rows [row0, row0 + 64) of a
// (len, ld) matrix, its first 64 columns; rows past len are not written.
// Each warp touches only its own 16 rows of the slice.
__device__ __forceinline__ void store_slice(__nv_bfloat16* dst,
                                            __nv_bfloat16* slice,
                                            const float (&acc)[32],
                                            float mul_lo, float mul_hi,
                                            int row0, int len, int warp,
                                            int lane, int ld = 64) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r = warp * 16 + g;   // r and r + 8 share (r & 7) = g
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = ((nt ^ g) << 3) + 2 * t4;
    *reinterpret_cast<uint32_t*>(slice + r * 64 + col) =
        pack2_bf16(acc[4 * nt] * mul_lo, acc[4 * nt + 1] * mul_lo);
    *reinterpret_cast<uint32_t*>(slice + (r + 8) * 64 + col) =
        pack2_bf16(acc[4 * nt + 2] * mul_hi, acc[4 * nt + 3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = i * 32 + lane;
    const int rl = warp * 16 + (idx >> 3), chunk = idx & 7;
    const uint4 val = *reinterpret_cast<const uint4*>(
        slice + rl * 64 + ((chunk ^ (rl & 7)) << 3));
    if (row0 + rl < len)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + rl) * ld + chunk * 8) =
          val;
  }
}

// The same for a warp's 16 x 16 part of a 64 x 16 accumulator (the last 16
// columns of an 80-wide row), through `slice` (the warpgroup's 64 x 16
// buffer, 32-byte swizzled: chunk c of row r at c ^ ((r >> 2) & 1)) to
// columns [0, 16) of rows [row0, row0 + 64) of a (len, ld) matrix at dst.
__device__ __forceinline__ void store_slice16(__nv_bfloat16* dst,
                                              __nv_bfloat16* slice,
                                              const float (&acc)[8],
                                              float mul_lo, float mul_hi,
                                              int row0, int len, int warp,
                                              int lane, int ld) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r = warp * 16 + g;   // r and r + 8 share (r >> 2) & 1
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = ((nt ^ ((r >> 2) & 1)) << 3) + 2 * t4;
    *reinterpret_cast<uint32_t*>(slice + r * kCols16 + col) =
        pack2_bf16(acc[4 * nt] * mul_lo, acc[4 * nt + 1] * mul_lo);
    *reinterpret_cast<uint32_t*>(slice + (r + 8) * kCols16 + col) =
        pack2_bf16(acc[4 * nt + 2] * mul_hi, acc[4 * nt + 3] * mul_hi);
  }
  __syncwarp();
  const int rl = warp * 16 + (lane >> 1), chunk = lane & 1;
  const uint4 val = *reinterpret_cast<const uint4*>(
      slice + rl * kCols16 + ((chunk ^ ((rl >> 2) & 1)) << 3));
  if (row0 + rl < len)
    *reinterpret_cast<uint4*>(dst + (size_t)(row0 + rl) * ld + chunk * 8) =
        val;
}

}  // namespace hopper
}  // namespace pcdms
