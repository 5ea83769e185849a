// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel autodist_tpu/ops/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd). Same function: blockwise
// online-softmax attention o = softmax(q.k^T / sqrt(d) [+ causal]) . v with
// f32 accumulation, emitting o and the per-row logsumexp. Causal masking is
// at global positions (q_offset + i >= k_offset + j); a key tile that no
// row of the q tile can see is never loaded; masked entries contribute
// exactly 0; a row that sees no key gets o = 0 and lse = -1e30.
//
// What bounds it on an H100: at BERT-base's shape (b=8, h=12, s=512, d=64,
// bf16) the bytes of q/k/v/o/lse take ~7.6 us at 3.35 TB/s and the
// 6.4 GFLOP ~6.5 us on the bf16 tensor cores, so the ideal kernel is
// memory-bound, with compute close behind. What the design does about it:
// the (sq x sk) score matrix never reaches device memory (each warp keeps
// its 16 x 64 score tile in registers), q is read once per block, k/v once
// per (q tile, visible k tile), and causal tiles past the diagonal are
// skipped. This first version is simple, not fast: one K/V tile in flight
// (no cp.async / TMA pipelining) and mma.sync rather than wgmma, so it is
// bound by load latency and sits well above that floor.
//
// Design: one block of 128 threads (4 warps) per (64-row q tile,
// batch*head). The TPU's sequential k grid dimension is a loop inside the
// block over 64-key tiles staged in shared memory.
//
// * bf16 inputs (the zoo's path): tensor cores through
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each warp owns 16 q rows;
//   S = Q K^T lands in the mma accumulators, the online softmax runs on
//   them in registers (a row is spread over the 4 threads of a quad:
//   max/sum by two shuffles), and P, rounded to bf16, is fed straight back
//   as the A operand of P V (the accumulator layout of two n8 tiles is the
//   A layout of one k16 step). With an f32 output (the training path, whose
//   backward takes delta = rowsum(do * o) from it) P enters as a pair of
//   bf16 operands, hi and the residual lo, so o keeps ~16 bits of P. Q, K, V tiles are read with ldmatrix from
//   rows padded by 16 bytes, so the 8 rows of each 8x8 matrix hit distinct
//   banks.
// * f32 inputs (the tiny test configs): plain f32 FMAs, so the products
//   keep f32 precision (tensor cores would round to tf32). Two threads
//   share a q row: each owns 32 of the tile's 64 score columns and d/2 of
//   the row's output columns.
//
// Rows and columns past sq / sk are masked here, so any sequence length
// works.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int h, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int causal, q_offset, k_offset;
  float scale;
  int vec;  // bf16 tiles: rows are 16-byte aligned, load 16 bytes at once
};

// Number of 64-key tiles a q tile must visit: all of them, or under causal
// masking the ones whose first key the tile's last row reaches.
__device__ __forceinline__ int visible_tiles(const Params& p, int q0,
                                             int rows) {
  int n_kt = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const long long span =
        (long long)p.q_offset + q0 + rows - 1 - (long long)p.k_offset;
    n_kt = span < 0 ? 0 : (int)min((long long)n_kt, span / BK + 1);
  }
  return n_kt;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16; helpers in flash_common.cuh)

template <typename TO, int D>
__global__ void __launch_bounds__(NT) flash_fwd_mma_kernel(Params p) {
  extern __shared__ __align__(16) uint16_t smem_h[];
  constexpr int LD = D + 8;  // 16-byte pad: ldmatrix rows hit distinct banks
  constexpr int KSTEPS = D / 16;
  uint16_t* Qs = smem_h;       // [BQ][LD]
  uint16_t* Ks = Qs + BQ * LD;  // [BK][LD]
  uint16_t* Vs = Ks + BK * LD;  // [BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // row group of the mma fragments
  const int t = lane & 3;   // thread in group
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, p.sq - q0);

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + bi * p.q_sb +
                       hi * p.q_sh + (long long)q0 * p.q_ss;
  const uint16_t* kp = static_cast<const uint16_t*>(p.k) + bi * p.k_sb +
                       hi * p.k_sh;
  const uint16_t* vp = static_cast<const uint16_t*>(p.v) + bi * p.v_sb +
                       hi * p.v_sh;
  load_tile<D>(Qs, qp, p.q_ss, rows, p.vec);
  __syncthreads();
  uint32_t qf[KSTEPS][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);

  const int n_kt = visible_tiles(p, q0, rows);
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  // Global positions of this thread's two rows (g and g + 8).
  const long long qpos = (long long)p.q_offset + q0 + warp * 16 + g;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int cols = min(BK, p.sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, kp + (long long)k0 * p.k_ss, p.k_ss, cols, p.vec);
    load_tile<D>(Vs, vp + (long long)k0 * p.v_ss, p.v_ss, cols, p.vec);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; s[j][e] is row g + 8 * (e >> 1),
    // key j * 8 + 2 * t + (e & 1).
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    float mt[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const bool vis =
            c < cols &&
            (!p.causal || qpos + 8 * r >= (long long)p.k_offset + k0 + c);
        const float x = vis ? s[j][e] * p.scale : NEG;
        s[j][e] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // Masked entries contribute exactly 0, never exp(-1e30 - m).
        const int r = e >> 1;
        const float x = s[j][e];
        const float pv = x > 0.5f * NEG ? expf(x - m[r]) : 0.f;
        s[j][e] = pv;
        l[r] += pv;
      }
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    // O += P V: P's accumulators of n-tiles 2ks, 2ks + 1 are the A
    // fragment of key step ks; V comes in transposed by ldmatrix. For an
    // f32 output P also enters as its bf16 residual (hi + lo, ~16 bits):
    // the training path's backward takes delta = rowsum(do * o) from that
    // output, and one rounding of P would show in it.
    constexpr bool kSplitP = std::is_same<TO, float>::value;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4], alo[4];
      acc_to_a(a, s[2 * ks], s[2 * ks + 1]);
      if constexpr (kSplitP) acc_to_a_lo(alo, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, Vs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LD +
                   dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        if constexpr (kSplitP) {
          mma_bf16(acc[2 * dp], alo, b[0], b[1]);
          mma_bf16(acc[2 * dp + 1], alo, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = warp * 16 + g + 8 * r;
    if (row < rows) {
      // 1e-30, not 1e-38 (a subnormal guard flushes to zero), and a finite
      // lse sentinel, not -inf (combines subtract lse values).
      const float denom = fmaxf(l[r], 1e-30f);
      TO* orow = static_cast<TO*>(p.o) + bi * p.o_sb + hi * p.o_sh +
                 (long long)(q0 + row) * p.o_ss;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        orow[i * 8 + 2 * t] = from_f<TO>(acc[i][2 * r] / denom);
        orow[i * 8 + 2 * t + 1] = from_f<TO>(acc[i][2 * r + 1] / denom);
      }
      if (t == 0)
        p.lse[(long long)bh * p.sq + q0 + row] =
            l[r] > 0.f ? m[r] + logf(denom) : NEG;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores

template <int D>
constexpr int simt_smem_floats() {
  return BQ * (D + 1) + D * (BK + 4) + BK * D + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(Params p) {
  extern __shared__ float smem_f[];
  constexpr int QS = D + 1;   // odd stride: the 16 rows of a warp hit 16 banks
  constexpr int KS = BK + 4;  // keeps float4 rows aligned
  constexpr int PS = BK + 1;
  constexpr int HD = D / 2;   // output columns per thread
  float* Qs = smem_f;         // [BQ][QS]  q tile
  float* Kt = Qs + BQ * QS;   // [D][KS]   k tile, transposed
  float* Vs = Kt + D * KS;    // [BK][D]   v tile
  float* Ps = Vs + BK * D;    // [BQ][PS]  probabilities of the tile

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, p.sq - q0);

  const float* qp = static_cast<const float*>(p.q) + bi * p.q_sb +
                    hi * p.q_sh + (long long)q0 * p.q_ss;
  const float* kp = static_cast<const float*>(p.k) + bi * p.k_sb +
                    hi * p.k_sh;
  const float* vp = static_cast<const float*>(p.v) + bi * p.v_sb +
                    hi * p.v_sh;

  for (int e = tid; e < BQ * D; e += NT) {
    const int rr = e / D, j = e % D;
    Qs[rr * QS + j] = rr < rows ? qp[rr * p.q_ss + j] : 0.f;
  }

  const int n_kt = visible_tiles(p, q0, rows);
  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;
  const long long q_pos = (long long)p.q_offset + q0 + r;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int cols = min(BK, p.sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BK * D; e += NT) {
      const int c = e / D, j = e % D;
      float kv = 0.f, vv = 0.f;
      if (c < cols) {
        kv = kp[(long long)(k0 + c) * p.k_ss + j];
        vv = vp[(long long)(k0 + c) * p.v_ss + j];
      }
      Kt[j * KS + c] = kv;
      Vs[c * D + j] = vv;
    }
    __syncthreads();

    // s[4i+u] is column c = 4 * (2i + half) + u of this tile.
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      const float qv = Qs[r * QS + j];
      const float4* krow = reinterpret_cast<const float4*>(Kt + j * KS);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float4 kk = krow[2 * i + half];
        s[4 * i + 0] = fmaf(qv, kk.x, s[4 * i + 0]);
        s[4 * i + 1] = fmaf(qv, kk.y, s[4 * i + 1]);
        s[4 * i + 2] = fmaf(qv, kk.z, s[4 * i + 2]);
        s[4 * i + 3] = fmaf(qv, kk.w, s[4 * i + 3]);
      }
    }

    float mt = NEG;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * (2 * i + half) + u;
        const bool vis =
            c < cols && (!p.causal || q_pos >= (long long)p.k_offset + k0 + c);
        const float x = vis ? s[4 * i + u] * p.scale : NEG;
        s[4 * i + u] = x;
        mt = fmaxf(mt, x);
      }
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // Masked entries contribute exactly 0, never exp(-1e30 - m).
        const float x = s[4 * i + u];
        const float pv = x > 0.5f * NEG ? expf(x - m_new) : 0.f;
        ls += pv;
        Ps[r * PS + 4 * (2 * i + half) + u] = pv;
      }
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // the row's two halves of P are written

#pragma unroll
    for (int i = 0; i < HD; ++i) acc[i] *= alpha;
    for (int c = 0; c < cols; ++c) {
      const float pc = Ps[r * PS + c];
      const float4* vrow = reinterpret_cast<const float4*>(Vs + c * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 vv = vrow[2 * i + half];
        acc[4 * i + 0] = fmaf(pc, vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(pc, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(pc, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(pc, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (r < rows) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + bi * p.o_sb + hi * p.o_sh +
                  (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        orow[4 * (2 * i + half) + u] = acc[4 * i + u] / denom;
    }
    if (half == 0)
      p.lse[(long long)bh * p.sq + q0 + r] = l > 0.f ? m + logf(denom) : NEG;
  }
}

// ---------------------------------------------------------------------------
// launch

template <typename TO, int D>
cudaError_t launch_mma(const Params& p, dim3 grid, cudaStream_t stream) {
  return launch_kernel(flash_fwd_mma_kernel<TO, D>,
                       3 * BQ * (D + 8) * (int)sizeof(uint16_t), grid, stream,
                       p);
}

template <int D>
cudaError_t launch_simt(const Params& p, dim3 grid, cudaStream_t stream) {
  return launch_kernel(flash_fwd_simt_kernel<D>,
                       simt_smem_floats<D>() * (int)sizeof(float), grid,
                       stream, p);
}

template <typename TO>
cudaError_t launch_mma_d(const Params& p, dim3 grid, int d,
                         cudaStream_t stream) {
  switch (d) {
    case 16: return launch_mma<TO, 16>(p, grid, stream);
    case 32: return launch_mma<TO, 32>(p, grid, stream);
    case 64: return launch_mma<TO, 64>(p, grid, stream);
    case 128: return launch_mma<TO, 128>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_simt_d(const Params& p, dim3 grid, int d,
                          cudaStream_t stream) {
  switch (d) {
    case 16: return launch_simt<16>(p, grid, stream);
    case 32: return launch_simt<32>(p, grid, stream);
    case 64: return launch_simt<64>(p, grid, stream);
    case 128: return launch_simt<128>(p, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype tags: 0 = float32, 1 = bfloat16. Pointers and the stream come in
// as void*; the strides are in elements, d's stride must be 1. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int autodist_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b,
    int h, int sq, int sk, int d, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int q_offset, int k_offset,
    int in_dtype, int out_dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  p.scale = (float)(1.0 / sqrt((double)d));
  p.vec = 0;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0) return (int)launch_simt_d(p, grid, d, st);
  if (in_dtype != 1 || (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  // 16-byte tile loads need 16-byte aligned rows.
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                v_sb, v_sh, v_ss};
  p.vec = ((uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
           (uintptr_t)v % 16 == 0);
  for (long long s : strides) p.vec = p.vec && (s % 8 == 0);
  if (out_dtype == 1)
    return (int)launch_mma_d<__nv_bfloat16>(p, grid, d, st);
  return (int)launch_mma_d<float>(p, grid, d, st);
}
