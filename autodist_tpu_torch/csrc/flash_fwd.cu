// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel autodist_tpu/ops/flash_attention.py:
// _fwd_kernel (launched by _flash_fwd). Same function: blockwise
// online-softmax attention o = softmax(q.k^T / sqrt(d) [+ causal]) . v with
// f32 accumulation, emitting o and the per-row logsumexp. Causal masking is
// at global positions (q_offset + i >= k_offset + j); a key tile that no
// row of the q tile can see is never loaded; masked entries contribute
// exactly 0; a row that sees no key gets o = 0 and lse = -1e30. No atomics:
// a repeat is bitwise identical.
//
// What bounds it on an H100: at BERT-base's serving shape (b=8, h=12,
// s=512, d=64, bf16) the bytes of q/k/v/o/lse take ~7.6 us at 3.35 TB/s and
// the 6.4 GFLOP ~6.5 us on the bf16 tensor cores, so the ideal kernel is
// memory-bound with compute close behind: the loads must overlap the
// products, and the products must run at wgmma's rate.
//
// Routes, chosen by input type and head dim (no fallback between them):
//
// * bf16, d = 64 or 128 (every zoo transformer): flash_fwd_wgmma_kernel.
//   Persistent blocks (one per SM) of three warpgroups walk work items of
//   (128-row q tile, batch * head). A producer warp issues TMA loads
//   (hopper.cuh) of each item's Q tile and of its visible K/V tiles into a
//   two-stage ring in shared memory, with mbarrier full/empty handshakes,
//   so loads run ahead of compute, across items too; TMA reads q/k/v
//   through 4-D (d, s, h, b) tensor maps with the caller's strides (the
//   model's (b, h, s, d) views of (b, s, h, d) memory need no copy) and
//   fills rows past s with zeros. Two consumer warpgroups own 64 q rows
//   each: S = Q K^T is a wgmma from shared memory (both operands K-major,
//   128-byte swizzle), the online softmax runs on the accumulators in
//   registers in base 2 (exp2 with scale * log2 e folded in), masking only
//   the ragged last tile and tiles that cross the causal diagonal, and
//   O += P V is a wgmma with P from registers (S's accumulator layout is
//   the register-A layout) and V an MN-major operand in shared memory.
//   S of tile j and P V of tile j - 1 are in flight together, and the two
//   warpgroups take turns issuing them (named barriers), so softmax runs
//   under products. setmaxnreg moves registers from the producer to the
//   consumers. K/V tiles hold 128 keys at d = 64 and 64 keys at d = 128
//   (shared memory). The epilogue stages o in shared memory and writes
//   16-byte vectors.
//   With an f32 o (training: the backward takes delta = rowsum(do * o)
//   from it) P enters P V as a bf16 pair, hi and the residual lo, so o
//   keeps ~16 bits of P, and the same epilogue also writes o rounded to
//   bf16 (the model's activation), so no separate cast runs.
// * bf16, d = 16 or 32 (the tiny test configs): flash_fwd_mma_kernel,
//   mma.sync.m16n8k16, one block of 4 warps per 64-row q tile; each warp
//   owns 16 rows, P feeds P V as the A fragment, K/V staged through
//   registers with ldmatrix reads from 16-byte padded rows.
// * f32 inputs (the tiny test configs): flash_fwd_simt_kernel, plain f32
//   FMAs so the products keep f32 precision (tensor cores would round to
//   tf32); two threads share a q row.
//
// Rows and columns past sq / sk are masked, so any sequence length works.
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  __nv_bfloat16* o_lowp;  // with an f32 o: o rounded to bf16 too, or null
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
      const long long at = bi * p.o_sb + hi * p.o_sh +
                           (long long)(q0 + row) * p.o_ss;
      TO* orow = static_cast<TO*>(p.o) + at;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float o0 = acc[i][2 * r] / denom;
        const float o1 = acc[i][2 * r + 1] / denom;
        orow[i * 8 + 2 * t] = from_f<TO>(o0);
        orow[i * 8 + 2 * t + 1] = from_f<TO>(o1);
        if (p.o_lowp != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(p.o_lowp + at + i * 8 + 2 * t) =
              __floats2bfloat162_rn(o0, o1);
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
// bf16, d = 64 or 128: a TMA producer and two wgmma consumer warpgroups

template <int D, bool kF32Out>
struct WgCfg {
  static constexpr int kBQ = 128;                 // q rows per block
  static constexpr int kBK = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int kStages = 2;               // K/V ring depth
  static constexpr int kChunks = D / 64;          // 64-column (128 B) chunks
  static constexpr int kQChunk = kBQ * 128;       // bytes of one Q chunk
  static constexpr int kKVChunk = kBK * 128;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // K or V, one stage
  static constexpr int kP32 = D + 4;  // staging pitches (elements): the 8
  static constexpr int kP16 = D + 8;  // rows of a quad group hit 32 banks
  // Byte offsets from the 1024-byte-aligned base of shared memory.
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kO32 = kV + kStages * kKVBytes;
  static constexpr int kO16 = kO32 + (kF32Out ? kBQ * kP32 * 4 : 0);
  static constexpr int kBar = kO16 + kBQ * kP16 * 2;
  // q_full, q_empty, k_full[kStages], v_full[kStages], kv_empty[kStages];
  // 1024 bytes of slack to align the base.
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
};

struct WgParams {
  CUtensorMap tq, tk, tv;  // bf16 (d, s, h, b) maps (hopper::bf16_map)
  void* o;                 // (b, h, sq, d) contiguous: bf16, or f32
  __nv_bfloat16* o_lowp;   // with an f32 o: o rounded to bf16, or null
  float* lse;              // (b, h, sq) contiguous
  int h, sq, sk;
  int n_qt, n_items;  // q tiles per (b, h); work items = n_qt * b * h
  int causal, q_offset, k_offset;
  float scale_log2;  // log2(e) / sqrt(d): scores go straight to exp2
};

// Work item ``item`` of a persistent block: (batch * head, first q row).
// The q tiles of one head are neighbours (its K/V stay in L2), the last
// tile first (under causal masking it visits the most keys).
__device__ __forceinline__ void wg_item(const WgParams& p, int item, int bq,
                                        int& bh, int& q0) {
  bh = item / p.n_qt;
  q0 = (p.n_qt - 1 - (item - bh * p.n_qt)) * bq;
}

// Number of key tiles of ``bk`` keys that rows up to ``q_last`` (an index
// into this call's q) must visit.
__device__ __forceinline__ int visible_key_tiles(const WgParams& p, int bk,
                                                 int q_last) {
  int n = (p.sk + bk - 1) / bk;
  if (p.causal) {
    const long long span =
        (long long)p.q_offset + q_last - (long long)p.k_offset;
    n = span < 0 ? 0 : (int)min((long long)n, span / bk + 1);
  }
  return n;
}

// Persistent blocks of 384 threads, one per SM, each walking work items of
// (128-row q tile, batch * head): warpgroups 0 and 1 consume (64 q rows
// each), warpgroup 2 produces (one thread issues every TMA load; the rest of
// it exits after giving its registers away). The K/V ring and Q's buffer
// carry over from item to item, so the next item's loads run under this
// item's last products and its epilogue.
template <int D, bool kF32Out>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ WgParams p) {
  using C = WgCfg<D, kF32Out>;
  constexpr int BK = C::kBK;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + C::kK, sV = base + C::kV;
  const uint32_t q_full = base + C::kBar;
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;        // + 8 * stage
  const uint32_t v_full = k_full + 8 * S;     // + 8 * stage
  const uint32_t kv_empty = v_full + 8 * S;   // + 8 * stage

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 256);  // every consumer thread
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, 256);  // every consumer thread
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q once, then K and V of each visible tile into the ring.
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&p.tq);
      hopper::prefetch_map(&p.tk);
      hopper::prefetch_map(&p.tv);
      int n_loaded = 0;  // K/V tiles through the ring so far
      for (int item = blockIdx.x, it = 0; item < p.n_items;
           item += gridDim.x, ++it) {
        int bh, q0;
        wg_item(p, item, C::kBQ, bh, q0);
        const int bi = bh / p.h;
        const int hi = bh - bi * p.h;
        const int n_kt =
            visible_key_tiles(p, BK, min(q0 + C::kBQ, p.sq) - 1);
        // Round r of a barrier waits for the consumers' release of round
        // r - 1; round 0 passes at once.
        auto load_kv = [&](int kt) {
          const int s = n_loaded % S;
          hopper::mbar_wait(kv_empty + 8 * s, ((n_loaded / S) & 1) ^ 1);
          hopper::mbar_expect_tx(k_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            hopper::tma_load_4d(sK + s * C::kKVBytes + c * C::kKVChunk,
                                &p.tk, k_full + 8 * s, 64 * c, kt * BK, hi,
                                bi);
          hopper::mbar_expect_tx(v_full + 8 * s, C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c)
            hopper::tma_load_4d(sV + s * C::kKVBytes + c * C::kKVChunk,
                                &p.tv, v_full + 8 * s, 64 * c, kt * BK, hi,
                                bi);
          ++n_loaded;
        };
        // The item's first K/V tile goes ahead of its Q, whose buffer is
        // free only once the consumers finish the previous item.
        if (n_kt > 0) load_kv(0);
        hopper::mbar_wait(q_empty, (it & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          hopper::tma_load_4d(sQ + c * C::kQChunk, &p.tq, q_full, 64 * c, q0,
                              hi, bi);
        for (int kt = 1; kt < n_kt; ++kt) load_kv(kt);
      }
    }
  } else {
    // Consumer warpgroup wg: q rows rq0 .. rq0 + 63 of the tile.
    hopper::regs_alloc<240>();
    if (wg == 1) hopper::named_arrive(3, 256);  // warpgroup 0 goes first
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int g = (t & 31) >> 2;
    const int c4 = t & 3;
    float* st32 = reinterpret_cast<float*>(smem + C::kO32) + wg * 64 * C::kP32;
    __nv_bfloat16* st16 =
        reinterpret_cast<__nv_bfloat16*>(smem + C::kO16) + wg * 64 * C::kP16;
    int n_used = 0;  // K/V tiles through the ring before this item
    for (int item = blockIdx.x, it = 0; item < p.n_items;
         item += gridDim.x, ++it) {
      int bh, q0;
      wg_item(p, item, C::kBQ, bh, q0);
      const int n_kt = visible_key_tiles(p, BK, min(q0 + C::kBQ, p.sq) - 1);
      const int rq0 = q0 + 64 * wg;
      const int rows = min(64, p.sq - rq0);  // <= 0: nothing to write
      const int nkt_w = rows > 0 ? visible_key_tiles(p, BK, rq0 + rows - 1) : 0;
      // Global position of this thread's first row (the second is + 8).
      const long long qpos = (long long)p.q_offset + rq0 + warp * 16 + g;

      float o[C::kChunks][32];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};  // row max of s * scale_log2
      float l[2] = {0.f, 0.f};  // this thread's share of the row sums

      hopper::mbar_wait(q_full, it & 1);
      // Tiles 0 .. nkt_w - 1 are visible here; the first n_plain of them
      // need no mask (masking is monotone: the ragged last tile and the
      // tiles from the causal diagonal on).
      auto needs_mask = [&](int kt) {
        const int k0 = kt * BK;
        return k0 + BK > p.sk ||
               (p.causal && (long long)p.q_offset + rq0 <
                                (long long)p.k_offset + k0 + BK - 1);
      };
      int n_plain = 0;
      while (n_plain < nkt_w && !needs_mask(n_plain)) ++n_plain;
      auto stage = [&](int kt) { return (n_used + kt) % S; };
      auto parity = [&](int kt) { return (uint32_t)((n_used + kt) / S) & 1; };
      auto release = [&](int kt) {
        hopper::mbar_arrive(kv_empty + 8 * stage(kt));
      };

      // Turns: each warpgroup issues its products in its own turn and
      // passes the turn on, so one warpgroup's softmax runs under the
      // other's products. Both take n_kt + 1 turns an item.
      auto take_turn = [&] { hopper::named_sync(3 + wg, 256); };
      auto pass_turn = [&] { hopper::named_arrive(3 + (1 - wg), 256); };

      float sc[BK / 2];                        // S, then P, of one tile
      uint32_t pa[BK / 16][4];                 // P of the previous tile
      uint32_t pl[kF32Out ? BK / 16 : 1][4];   // and its bf16 residual
      float alpha[2];

      // S = Q K^T over d in k16 steps: both operands K-major.
      auto issue_s = [&](int kt) {
        const uint32_t sk_base = sK + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t chunk = kk / 4, off = (kk % 4) * 32;
          hopper::wgmma_ss<BK>(
              sc,
              hopper::sw128_desc(sQ + chunk * C::kQChunk + wg * 64 * 128 +
                                 off),
              hopper::sw128_desc(sk_base + chunk * C::kKVChunk + off),
              kk > 0);
        }
        hopper::wgmma_commit();
      };
      // O += P V: P is the register A operand; V an MN-major B, one wgmma
      // per 64-column chunk. With an f32 o, P also enters as its bf16
      // residual (hi + lo, ~16 bits of P): the backward's
      // delta = rowsum(do * o) needs it.
      auto issue_pv = [&](int kt) {
        const uint32_t sv_base = sV + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            const uint64_t dv = hopper::sw128_desc(
                sv_base + c * C::kKVChunk + ks * 16 * 128);
            hopper::wgmma_rs_n64_mn(o[c], pa[ks], dv);
            if constexpr (kF32Out) hopper::wgmma_rs_n64_mn(o[c], pl[ks], dv);
          }
        hopper::wgmma_commit();
      };
      // Online softmax of tile kt in base 2 on sc (a row lives on the 4
      // threads of a quad); a masked score is -inf and its p exactly 0.
      auto softmax = [&](int kt, auto masked) {
        if constexpr (decltype(masked)::value) {
          const int k0 = kt * BK;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + j * 8 + 2 * c4 + (e & 1);
              const bool vis =
                  col < p.sk &&
                  (!p.causal ||
                   qpos + 8 * (e >> 1) >= (long long)p.k_offset + col);
              if (!vis) sc[4 * j + e] = -INFINITY;
            }
        }
        // Four partial maxima and sums a row: short dependency chains (two
        // warps share a scheduler here, so latency is not hidden).
        float mp[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) mp[r][u] = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mp[e >> 1][j & 3] = fmaxf(mp[e >> 1][j & 3], sc[4 * j + e]);
        float mx[2], neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(fmaxf(mp[r][0], mp[r][1]), fmaxf(mp[r][2], mp[r][3]));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
          // A row with nothing visible yet keeps m = -inf; exponentiate
          // against 0 then, so that -inf - m never makes a NaN.
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          alpha[r] = ex2_ftz(m[r] - m_use);
          m[r] = m_new;
          l[r] *= alpha[r];
          neg_m[r] = -m_use;
        }
        float ls[2][4] = {};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pv =
                ex2_ftz(fmaf(sc[4 * j + e], p.scale_log2, neg_m[e >> 1]));
            sc[4 * j + e] = pv;
            ls[e >> 1][j & 3] += pv;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] += (ls[r][0] + ls[r][1]) + (ls[r][2] + ls[r][3]);
      };
      // O holds every tile before kt: rescale it, and keep tile kt's P as
      // the next product's A operand.
      auto rescale_and_pack = [&] {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[c][4 * j] *= alpha[0];
            o[c][4 * j + 1] *= alpha[0];
            o[c][4 * j + 2] *= alpha[1];
            o[c][4 * j + 3] *= alpha[1];
          }
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          pa[ks][0] = pack_bf16(sc[8 * ks + 0], sc[8 * ks + 1]);
          pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
          pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
          pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
          if constexpr (kF32Out) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pl[ks][i] = pack_bf16(bf16_residual(sc[8 * ks + 2 * i]),
                                    bf16_residual(sc[8 * ks + 2 * i + 1]));
          }
        }
      };
      auto zero_sc = [&] {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        hopper::fence_regs(sc);
      };
      auto fence_o = [&] {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) hopper::fence_regs(o[c]);
      };
      // Step kt: S of tile kt and P V of tile kt - 1 in flight together;
      // the softmax of tile kt runs under P V.
      auto step = [&](int kt, auto masked) {
        hopper::mbar_wait(k_full + 8 * stage(kt), parity(kt));
        hopper::mbar_wait(v_full + 8 * stage(kt - 1), parity(kt - 1));
        zero_sc();
        fence_o();
        take_turn();
        hopper::wgmma_fence();
        issue_s(kt);
        issue_pv(kt - 1);
        pass_turn();
        hopper::wgmma_wait<1>();  // groups complete in order: S is done
        hopper::fence_regs(sc);
        softmax(kt, masked);
        hopper::wgmma_wait<0>();
        fence_o();
        hopper::fence_regs(pa);
        if constexpr (kF32Out) hopper::fence_regs(pl);
        release(kt - 1);
        rescale_and_pack();
      };
      using Plain = std::integral_constant<bool, false>;
      using Masked = std::integral_constant<bool, true>;

      if (nkt_w > 0) {
        hopper::mbar_wait(k_full + 8 * stage(0), parity(0));
        zero_sc();
        take_turn();
        hopper::wgmma_fence();
        issue_s(0);
        pass_turn();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        if (n_plain > 0)
          softmax(0, Plain());
        else
          softmax(0, Masked());
        rescale_and_pack();
        for (int kt = 1; kt < n_plain; ++kt) step(kt, Plain());
        for (int kt = max(n_plain, 1); kt < nkt_w; ++kt) step(kt, Masked());
        // Drain: P V of the last visible tile.
        hopper::mbar_wait(v_full + 8 * stage(nkt_w - 1), parity(nkt_w - 1));
        fence_o();
        take_turn();
        hopper::wgmma_fence();
        issue_pv(nkt_w - 1);
        pass_turn();
        hopper::wgmma_wait<0>();
        fence_o();
        hopper::fence_regs(pa);
        if constexpr (kF32Out) hopper::fence_regs(pl);
        release(nkt_w - 1);
      } else {
        take_turn();  // the drain's turn
        pass_turn();
      }
      // Tiles no row here can see: wait for them, give them back, and take
      // their turns.
      for (int kt = nkt_w; kt < n_kt; ++kt) {
        hopper::mbar_wait(k_full + 8 * stage(kt), parity(kt));
        hopper::mbar_wait(v_full + 8 * stage(kt), parity(kt));
        release(kt);
        take_turn();
        pass_turn();
      }
      n_used += n_kt;
      hopper::mbar_arrive(q_empty);  // the next item's Q may load

      // Epilogue: o = acc / l and lse per row; o is staged in shared memory
      // and leaves in 16-byte row-contiguous stores (the bf16 copy rounded
      // from the same f32 values).
      constexpr float kLn2 = 0.6931471805599453f;
      hopper::named_sync(1 + wg, 128);  // the last item's staging is read
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = warp * 16 + g + 8 * r;
        // 1e-30, not 1e-38 (a subnormal guard flushes to zero), and a finite
        // lse sentinel, not -inf (combines subtract lse values).
        const float denom = fmaxf(l[r], 1e-30f);
        const float inv = 1.f / denom;
        if (c4 == 0 && row < rows)
          p.lse[(long long)bh * p.sq + rq0 + row] =
              l[r] > 0.f ? m[r] * kLn2 + logf(denom) : NEG;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c * 64 + j * 8 + 2 * c4;
            const float v0 = o[c][4 * j + 2 * r] * inv;
            const float v1 = o[c][4 * j + 2 * r + 1] * inv;
            if constexpr (kF32Out)
              *reinterpret_cast<float2*>(st32 + row * C::kP32 + col) =
                  make_float2(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(st16 + row * C::kP16 + col) =
                __floats2bfloat162_rn(v0, v1);
          }
      }
      hopper::named_sync(1 + wg, 128);  // this warpgroup's staging is full
      const long long row0 = (long long)bh * p.sq + rq0;
      __nv_bfloat16* o16 =
          kF32Out ? p.o_lowp : static_cast<__nv_bfloat16*>(p.o);
      if (o16 != nullptr) {
        for (int e = t; e < 64 * (D / 8); e += 128) {
          const int row = e / (D / 8), col = (e % (D / 8)) * 8;
          if (row < rows)
            *reinterpret_cast<uint4*>(o16 + (row0 + row) * D + col) =
                *reinterpret_cast<const uint4*>(st16 + row * C::kP16 + col);
        }
      }
      if constexpr (kF32Out) {
        float* o32 = static_cast<float*>(p.o);
        for (int e = t; e < 64 * (D / 4); e += 128) {
          const int row = e / (D / 4), col = (e % (D / 4)) * 4;
          if (row < rows)
            *reinterpret_cast<float4*>(o32 + (row0 + row) * D + col) =
                *reinterpret_cast<const float4*>(st32 + row * C::kP32 + col);
        }
      }
    }
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

template <int D, bool kF32Out>
cudaError_t launch_wgmma(const WgParams& p, dim3 grid, cudaStream_t stream) {
  return launch_kernel(flash_fwd_wgmma_kernel<D, kF32Out>,
                       WgCfg<D, kF32Out>::kBytes, grid, stream, p, 384);
}

template <int D>
cudaError_t launch_wgmma_d(const Params& p, int b, bool f32_out,
                           cudaStream_t stream) {
  constexpr int BQ_W = WgCfg<D, false>::kBQ;
  constexpr int BK_W = WgCfg<D, false>::kBK;
  WgParams w;
  cudaError_t err = hopper::bf16_map(&w.tq, p.q, b, p.h, p.sq, D, p.q_sb,
                                     p.q_sh, p.q_ss, BQ_W);
  if (err == cudaSuccess)
    err = hopper::bf16_map(&w.tk, p.k, b, p.h, p.sk, D, p.k_sb, p.k_sh,
                           p.k_ss, BK_W);
  if (err == cudaSuccess)
    err = hopper::bf16_map(&w.tv, p.v, b, p.h, p.sk, D, p.v_sb, p.v_sh,
                           p.v_ss, BK_W);
  if (err != cudaSuccess) return err;
  w.o = p.o;
  w.o_lowp = p.o_lowp;
  w.lse = p.lse;
  w.h = p.h;
  w.sq = p.sq;
  w.sk = p.sk;
  w.causal = p.causal;
  w.q_offset = p.q_offset;
  w.k_offset = p.k_offset;
  w.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  w.n_qt = (p.sq + BQ_W - 1) / BQ_W;
  w.n_items = w.n_qt * b * p.h;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const dim3 grid(min(w.n_items, sms));
  return f32_out ? launch_wgmma<D, true>(w, grid, stream)
                 : launch_wgmma<D, false>(w, grid, stream);
}

}  // namespace

// Routes, by input type and head dim:
//   bf16, d = 64 or 128: flash_fwd_wgmma_kernel (TMA + wgmma). q, k and v
//     need 16-byte aligned bases and strides that are multiples of 8
//     elements (the wrapper copies other inputs); o (and o_lowp) must be
//     contiguous (b, h, sq, d);
//   bf16, d = 16 or 32: flash_fwd_mma_kernel (mma.sync);
//   f32 (f32 out): flash_fwd_simt_kernel.
// dtype tags: 0 = float32, 1 = bfloat16. ``o_lowp`` (null, or with bf16
// inputs and an f32 o) receives o rounded to bf16 as well. Pointers and the
// stream come in as void*; the strides are in elements, d's stride must be
// 1. Returns the cudaError_t of the launch (0 on success).
extern "C" int autodist_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* o_lowp,
    void* lse, int b, int h, int sq, int sk, int d, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, int causal, int q_offset,
    int k_offset, int in_dtype, int out_dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.o_lowp = static_cast<__nv_bfloat16*>(o_lowp);
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
  if (in_dtype == 0 && out_dtype == 0 && o_lowp == nullptr)
    return (int)launch_simt_d(p, grid, d, st);
  if (in_dtype != 1 || (out_dtype != 0 && out_dtype != 1) ||
      (o_lowp != nullptr && out_dtype != 0))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[3] = {q, k, v};
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                v_sb, v_sh, v_ss};
  p.vec = aligned16(ptrs, 3, strides, 9);
  if (d == 64 || d == 128) {
    if (!p.vec) return (int)cudaErrorInvalidValue;
    return (int)(d == 64 ? launch_wgmma_d<64>(p, b, out_dtype == 0, st)
                         : launch_wgmma_d<128>(p, b, out_dtype == 0, st));
  }
  if (out_dtype == 1)
    return (int)launch_mma_d<__nv_bfloat16>(p, grid, d, st);
  return (int)launch_mma_d<float>(p, grid, d, st);
}
