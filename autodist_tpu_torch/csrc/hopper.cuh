// Hopper (sm_90a) building blocks for the flash-attention kernels: mbarrier
// rings, TMA tensor loads, cp.async copies that arrive on an mbarrier,
// shared-memory matrix descriptors and warpgroup matrix products (wgmma),
// written as inline PTX. Host side: 4-D tensor maps
// over (d, s, h, b) built with cuTensorMapEncodeTiled, found through
// cudaGetDriverEntryPoint so nothing links against libcuda.
//
// Shared-memory tiles are stored as TMA's 128-byte swizzle writes them: a
// bf16 tile of R rows and 64 columns (128 bytes a row) is one "chunk" of
// R * 128 bytes, 1024-byte aligned; a 128-column tile is two chunks. For
// wgmma both operand kinds use the same chunks:
//   * K-major (the reduction dimension along the row, e.g. Q and K in
//     Q K^T): rows in groups of 8 at a stride of 1024 bytes; the k16 step j
//     of a chunk starts 32 j bytes into it (the hardware applies the swizzle
//     to the address it computes, so the base must be 1024-byte aligned);
//   * MN-major (the output dimension along the row, V in P V): 8 reduction
//     rows at 128 bytes, groups of 8 at 1024 bytes; the k16 step j starts
//     16 * 128 j bytes into the chunk. One instruction covers one chunk's 64
//     columns, so the stride between chunks is never read.
// The descriptor carries 1024 bytes in both of its stride fields, which is
// the 8-row group stride under either field's reading.
//
// Accumulator layout of wgmma m64nNk16 (f32): thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, c = t % 4, holds for each 8-column n tile j
// d[4j + 0, 1] = row 16w + g, cols 8j + 2c, +1 and d[4j + 2, 3] = row
// 16w + g + 8, same cols. The register A operand of m64n*k16 has the layout
// of mma.sync's A: a0 (row 16w + g, k 2c, +1), a1 (row + 8), a2 (k + 8),
// a3 (row + 8, k + 8). So the accumulators of n tiles 2j, 2j + 1, packed to
// bf16, are the A operand of k step j (flash_common.cuh: acc_to_a).
#pragma once

#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>

namespace {
namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers (shared-memory addresses as 32-bit integers)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect ``bytes`` from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity ``parity`` has completed. A fresh barrier
// is in phase 0, and the phase before it (parity 1) counts as completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier over ``threads`` threads (id 0 is __syncthreads'): wait
// for it, or only count this thread's arrival.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The box of ``map`` at coordinates (c0, c1, c2, c3) into shared memory at
// ``dst``; completion is counted in bytes on ``bar``. Coordinates past the
// tensor's extent read as zero.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// cp.async (per-thread copies, for short rows that TMA cannot address: a
// row of ``n`` f32 starting at an arbitrary element is neither 16-byte
// aligned nor, at a ragged edge, inside the tensor)

// 4 bytes from global ``src`` into shared ``dst``; with ``bytes`` = 0
// nothing is read and ``dst`` gets zeros.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// One arrival on ``bar`` once every cp.async this thread issued so far has
// landed. The arrival is not added to the barrier's expected count
// (.noinc): its init count must include it.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma

// Descriptor of a 128-byte-swizzled operand starting at shared address
// ``addr`` (see the header comment for the strides).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  constexpr uint64_t kStride = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kStride << 16) |
         (kStride << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence, wait or issue around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HOPPER_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, f32) (+)= A (64 x 16, shared, K-major) . B (16 x 128, shared,
// K-major). ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24),
        HOPPER_D8(32), HOPPER_D8(40), HOPPER_D8(48), HOPPER_D8(56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with N = 64.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 128)
    wgmma_ss_n128(d, a, b, accumulate);
  else
    wgmma_ss_n64(d, a, b, accumulate);
}

// d (64 x 64, f32) += A (64 x 16, registers) . B (16 x 64, shared,
// MN-major).
__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_D8

// Register budget of a warp-specialised block: the producer warpgroup gives
// registers back, the consumer warpgroups take them.
template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// Host: tensor maps

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

__host__ inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiledFn>(ptr);
  }();
  return fn;
}

// A bf16 tensor (b, h, s, d) with element strides (sb, sh, ss, 1) as a 4-D
// map over (d, s, h, b), read in boxes of 64 columns x ``box_rows`` rows with
// 128-byte swizzle; rows past s read as zero. The base must be 16-byte
// aligned and the strides multiples of 8 elements.
__host__ inline cudaError_t bf16_map(CUtensorMap* map, const void* base,
                                     int b, int h, int s, int d,
                                     long long sb, long long sh, long long ss,
                                     int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
}  // namespace
