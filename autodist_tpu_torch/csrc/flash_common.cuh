// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// tile sizes, the bf16 tensor-core fragment helpers (ldmatrix, mma.sync
// m16n8k16) and the tile loader. Each .cu file is its own translation unit
// and shared library; ops/build.py hashes this header with every .cu file
// that includes it, so an edit here rebuilds both.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 row-major, 4 registers of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8,
//     cols 2t+8, 2t+9);
//   B 16x8 column-major, 2 registers: b0 (k rows 2t, 2t+1, col g), b1 (k
//     rows 2t+8, 2t+9, col g);
//   C 16x8 f32, 4 registers: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row
//     g+8, cols 2t, 2t+1).
// So the accumulators of two neighbouring n8 tiles, packed to bf16, are the
// A fragment of one k16 step: {c[2j][0,1], c[2j][2,3], c[2j+1][0,1],
// c[2j+1][2,3]}.
#pragma once

#include <cstdint>
#include <mutex>
#include <set>
#include <utility>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;    // q rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 128;   // threads per block (4 warps of 16 rows)
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 2^x in one MUFU.EX2 (exp2f adds range fix-ups around it); subnormal
// results flush to 0, and 2^-inf is +0.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// which lands in r[i]: thread l holds row l / 4, cols 2 (l % 4), +1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// The same, transposed: thread l holds rows 2 (l % 4), +1 of col l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a . b for one 16x8x16 tile: a row-major (4 regs), b column-major
// (2 regs), c f32 (4 regs).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k step j from the f32 accumulators of n tiles 2j, 2j+1,
// rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The low half of the same values: bf16(x - float(bf16(x))). A product
// with hi and then lo fragments of x carries ~16 bits of x's mantissa
// instead of 8, for two tensor-core instructions instead of one.
__device__ __forceinline__ float bf16_residual(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void acc_to_a_lo(uint32_t (&a)[4],
                                            const float (&c0)[4],
                                            const float (&c1)[4]) {
  a[0] = pack_bf16(bf16_residual(c0[0]), bf16_residual(c0[1]));
  a[1] = pack_bf16(bf16_residual(c0[2]), bf16_residual(c0[3]));
  a[2] = pack_bf16(bf16_residual(c1[0]), bf16_residual(c1[1]));
  a[3] = pack_bf16(bf16_residual(c1[2]), bf16_residual(c1[3]));
}

// Row-major 64-row tile in shared memory with row pitch LD (bf16 elements):
// A fragment of the warp's 16 rows starting at row0, k step kk.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile,
                                       int row0, int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
}

// B fragments of the product X . T^T where T is a row-major tile [n][k]:
// n tiles 2np (b[0], b[1]) and 2np + 1 (b[2], b[3]), k step kk.
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const uint16_t* tile, int np,
                                            int kk) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
}

// B fragments of the product X . T where T is a row-major tile [k][n]:
// k step ks, n tiles 2dp (b[0], b[1]) and 2dp + 1 (b[2], b[3]).
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const uint16_t* tile, int ks,
                                             int dp) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(b, tile + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               LD + dp * 16 + (lane >> 4) * 8);
}

// Stage a 64 x D bf16 tile (rows past ``rows`` zero) into shared memory
// with row pitch D + 8. ``vec``: 16-byte loads are aligned.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          long long row_stride, int rows,
                                          bool vec) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < BQ * CPR; e += NT) {
    const int r = e / CPR, c = (e % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const uint16_t* s = src + r * row_stride + c;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(s);
      } else {
        __align__(16) uint16_t tmp[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) tmp[j] = s[j];
        val = *reinterpret_cast<const uint4*>(tmp);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// Stage a 64 x D f32 tile (rows past ``rows`` zero): ``row_major`` into
// dst[r * pitch + j], else transposed into dst[j * pitch + r].
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long row_stride, int rows,
                                              int pitch, bool row_major) {
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int r = e / D, j = e % D;
    const float x = r < rows ? src[r * row_stride + j] : 0.f;
    dst[row_major ? r * pitch + j : j * pitch + r] = x;
  }
}

// Raises a kernel's dynamic shared-memory limit to ``smem`` once per
// (kernel, device), not on every launch.
__host__ inline cudaError_t allow_smem(const void* kernel, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

// The current device's SM count (a persistent grid's size), read once per
// device.
__host__ inline cudaError_t sm_count(int* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static int counts[64] = {};
  if (dev < 64 && counts[dev] > 0) {
    *n = counts[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) counts[dev] = *n;
  return err;
}

template <typename P>
cudaError_t launch_kernel(void (*kernel)(P), int smem, dim3 grid,
                          cudaStream_t stream, const P& p, int threads = NT) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// 16-byte tile loads need 16-byte aligned base pointers and row strides
// that are multiples of 8 bf16 elements.
__host__ inline bool aligned16(const void* const* ptrs, int n_ptrs,
                               const long long* strides, int n_strides) {
  for (int i = 0; i < n_ptrs; ++i)
    if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace
