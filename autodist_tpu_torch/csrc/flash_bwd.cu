// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two Pallas TPU kernels of autodist_tpu/ops/flash_attention.py
// launched by _flash_bwd: _bwd_dq_kernel (:219) and _bwd_dkv_kernel (:258).
// Same function, the FlashAttention-2 backward from the forward's saved
// logsumexp: with s = q.k^T / sqrt(d) masked causally at global positions
// (q_offset + i >= k_offset + j),
//   p  = exp(s - lse) where visible, exactly 0 where masked,
//   dp = do . v^T,   ds = p * (dp - delta) / sqrt(d),
//   dq = ds . k,     dk = ds^T . q,     dv = p^T . do,
// all accumulated in f32 and written as f32. delta = rowsum(do * o) comes
// in from the caller, as in the JAX package. A row that sees no key
// (lse = -1e30) contributes exactly 0 to every output.
//
// What bounds it on an H100: at BERT-base's training shape (b=32, h=12,
// s=128, d=64, bf16) the dq kernel must read q, k, v, do (bf16) plus lse
// and delta and write dq (f32): 38 MB, 11.4 us at 3.35 TB/s, against
// 2.4 GFLOP, 2.4 us on the bf16 tensor cores; the dk/dv kernel moves
// 51 MB (15.1 us) for 3.2 GFLOP. Both are memory-bound at that shape. What
// the design does about it: the (sq x sk) score and probability matrices
// never reach device memory (each warp keeps its 16 x 64 tiles in
// registers), every block reads its own q/do (or k/v) tile once, and causal
// tiles that the mask empties are skipped. This first version is simple,
// not fast: one tile in flight (no cp.async / TMA pipelining), mma.sync
// rather than wgmma, and each kernel recomputes s and dp (as the Pallas
// pair does), so it is bound by load latency and recomputation.
//
// Design: the Pallas split into two kernels, which needs no atomics (and
// is therefore deterministic). The TPU's sequential grid axis, which
// carries the accumulators, is a loop inside one block of 128 threads.
// * flash_bwd_dq: one block per (64-row q tile, batch*head), looping over
//   64-key tiles; each warp owns 16 q rows.
// * flash_bwd_dkv: one block per (64-key tile, batch*head), looping over
//   64-row q tiles; each warp owns 16 keys and computes the transposed
//   tiles s^T = k.q^T and dp^T = v.do^T directly, so p^T and ds^T are
//   already in the accumulator layout that the next products take as
//   their A operand (no transposition of a register tile).
// * bf16 inputs (the zoo's path): tensor cores through mma.sync.m16n8k16
//   (bf16 in, f32 accumulate; helpers in flash_common.cuh). p is rounded
//   to bf16 as the A operand of p^T.do, as FlashAttention-2 does (the
//   Pallas kernel keeps it in f32). ds is not: each row of ds sums to 0
//   (sum_j p_ij (dp_ij - delta_i) = 0), which cancels the component that
//   all keys (queries) share out of dq (dk), and one bf16 rounding of ds
//   breaks that cancellation. At BERT-base's initialization, where the
//   true q/k gradients are ~1e-5, one rounding left the q/k projection
//   gradients off by up to 1.3x their largest entry. So ds enters ds.k and
//   ds^T.q as a pair of bf16 operands, hi = bf16(ds) and lo = bf16(ds -
//   hi), two tensor-core products that carry ~16 bits of its mantissa.
//   Operands that a product needs transposed (k in ds.k, do in p^T.do, q
//   in ds^T.q) come in through ldmatrix.trans.
// * f32 inputs (the tiny test configs): plain f32 FMAs, so the products
//   keep f32 precision (tensor cores would round to tf32). Two threads
//   share a row of the tile as in the forward.
//
// Rows and columns past sq / sk are masked here, so any sequence length
// works. d in {16, 32, 64, 128}; b * h <= 65535 (grid y).
#include <cmath>
#include <cstdint>

#include "flash_common.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b*h, sq) contiguous
  const float* delta;  // (b*h, sq) contiguous
  float* dq;           // (b*h, sq, d) contiguous
  float* dk;           // (b*h, sk, d) contiguous
  float* dv;           // (b*h, sk, d) contiguous
  int h, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // strides of do
  int causal, q_offset, k_offset;
  float scale;
  int vec;  // bf16 tiles: rows are 16-byte aligned, load 16 bytes at once
};

// Number of 64-key tiles the q tile at q0 (``rows`` rows) must visit: all,
// or under causal masking those whose first key its last row reaches.
__device__ __forceinline__ int visible_k_tiles(const BwdParams& p, int q0,
                                               int rows) {
  int n_kt = (p.sk + BK - 1) / BK;
  if (p.causal) {
    const long long span =
        (long long)p.q_offset + q0 + rows - 1 - (long long)p.k_offset;
    n_kt = span < 0 ? 0 : (int)min((long long)n_kt, span / BK + 1);
  }
  return n_kt;
}

// Under causal masking, whether the q tile at qq0 (``qrows`` rows) reaches
// the key tile starting at k0 at all.
__device__ __forceinline__ bool q_tile_visible(const BwdParams& p, int qq0,
                                               int qrows, int k0) {
  return !p.causal || (long long)p.q_offset + qq0 + qrows - 1 >=
                          (long long)p.k_offset + k0;
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base, int bi, int hi,
                                             long long sb, long long sh) {
  return static_cast<const T*>(base) + bi * sb + hi * sh;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_mma_kernel(BwdParams p) {
  extern __shared__ __align__(16) uint16_t smem_bwd_h[];
  constexpr int LD = D + 8;  // 16-byte pad: ldmatrix rows hit distinct banks
  constexpr int KSTEPS = D / 16;
  uint16_t* Qs = smem_bwd_h;     // [BQ][LD] q tile
  uint16_t* Os = Qs + BQ * LD;   // [BQ][LD] do tile
  uint16_t* Ks = Os + BQ * LD;   // [BK][LD]
  uint16_t* Vs = Ks + BK * LD;   // [BK][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, p.sq - q0);

  const uint16_t* kp = head_ptr<uint16_t>(p.k, bi, hi, p.k_sb, p.k_sh);
  const uint16_t* vp = head_ptr<uint16_t>(p.v, bi, hi, p.v_sb, p.v_sh);
  load_tile<D>(Qs, head_ptr<uint16_t>(p.q, bi, hi, p.q_sb, p.q_sh) +
                       (long long)q0 * p.q_ss, p.q_ss, rows, p.vec);
  load_tile<D>(Os, head_ptr<uint16_t>(p.dout, bi, hi, p.o_sb, p.o_sh) +
                       (long long)q0 * p.o_ss, p.o_ss, rows, p.vec);

  // This thread's two rows (g and g + 8 of the warp's 16).
  float lse_r[2], dlt_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    const long long at = (long long)bh * p.sq + q0 + row;
    lse_r[r] = row < rows ? p.lse[at] : 0.f;
    dlt_r[r] = row < rows ? p.delta[at] : 0.f;
  }
  const long long qpos = (long long)p.q_offset + q0 + warp * 16 + g;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int n_kt = visible_k_tiles(p, q0, rows);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int cols = min(BK, p.sk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, kp + (long long)k0 * p.k_ss, p.k_ss, cols, p.vec);
    load_tile<D>(Vs, vp + (long long)k0 * p.v_ss, p.v_ss, cols, p.vec);
    __syncthreads();

    // s = q k^T and dp = do v^T; [j][e] is row g + 8 (e >> 1), key
    // j * 8 + 2t + (e & 1).
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, Qs, warp * 16, kk);
      load_a<LD>(oa, Os, warp * 16, kk);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b[4];
        load_b_rows<LD>(b, Ks, np, kk);
        mma_bf16(s[2 * np], qa, b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
        load_b_rows<LD>(b, Vs, np, kk);
        mma_bf16(dp[2 * np], oa, b[0], b[1]);
        mma_bf16(dp[2 * np + 1], oa, b[2], b[3]);
      }
    }

    // ds in place of s.
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const bool vis =
            c < cols &&
            (!p.causal || qpos + 8 * r >= (long long)p.k_offset + k0 + c);
        const float pv = vis ? expf(s[j][e] * p.scale - lse_r[r]) : 0.f;
        s[j][e] = pv * (dp[j][e] - dlt_r[r]) * p.scale;
      }
    }

    // dq += ds k: ds's accumulators are the A fragments, as a bf16 pair
    // (hi + lo); k comes in transposed.
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4], alo[4];
      acc_to_a(a, s[2 * ks], s[2 * ks + 1]);
      acc_to_a_lo(alo, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        load_b_trans<LD>(b, Ks, ks, dd);
        mma_bf16(acc[2 * dd], a, b[0], b[1]);
        mma_bf16(acc[2 * dd], alo, b[0], b[1]);
        mma_bf16(acc[2 * dd + 1], a, b[2], b[3]);
        mma_bf16(acc[2 * dd + 1], alo, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row < rows) {
      float* out = p.dq + ((long long)bh * p.sq + q0 + row) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        out[i * 8 + 2 * t] = acc[i][2 * r];
        out[i * 8 + 2 * t + 1] = acc[i][2 * r + 1];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_mma_kernel(BwdParams p) {
  extern __shared__ __align__(16) uint16_t smem_bwd_h[];
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  uint16_t* Ks = smem_bwd_h;     // [BK][LD] k tile
  uint16_t* Vs = Ks + BK * LD;   // [BK][LD] v tile
  uint16_t* Qs = Vs + BK * LD;   // [BQ][LD] q tile
  uint16_t* Os = Qs + BQ * LD;   // [BQ][LD] do tile
  float* Ls = reinterpret_cast<float*>(Os + BQ * LD);  // [BQ] lse
  float* Dl = Ls + BQ;                                 // [BQ] delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int k0 = blockIdx.x * BK;
  const int cols = min(BK, p.sk - k0);

  load_tile<D>(Ks, head_ptr<uint16_t>(p.k, bi, hi, p.k_sb, p.k_sh) +
                       (long long)k0 * p.k_ss, p.k_ss, cols, p.vec);
  load_tile<D>(Vs, head_ptr<uint16_t>(p.v, bi, hi, p.v_sb, p.v_sh) +
                       (long long)k0 * p.v_ss, p.v_ss, cols, p.vec);
  const uint16_t* qp = head_ptr<uint16_t>(p.q, bi, hi, p.q_sb, p.q_sh);
  const uint16_t* op = head_ptr<uint16_t>(p.dout, bi, hi, p.o_sb, p.o_sh);
  const float* lse = p.lse + (long long)bh * p.sq;
  const float* delta = p.delta + (long long)bh * p.sq;
  // Global position of this thread's first key (the second is 8 later).
  const long long kpos = (long long)p.k_offset + k0 + warp * 16 + g;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  const int n_qt = (p.sq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int qq0 = qt * BQ;
    const int qrows = min(BQ, p.sq - qq0);
    if (!q_tile_visible(p, qq0, qrows, k0)) continue;  // uniform per block
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Qs, qp + (long long)qq0 * p.q_ss, p.q_ss, qrows, p.vec);
    load_tile<D>(Os, op + (long long)qq0 * p.o_ss, p.o_ss, qrows, p.vec);
    if (threadIdx.x < BQ) {
      const int i = threadIdx.x;
      Ls[i] = i < qrows ? lse[qq0 + i] : 0.f;
      Dl[i] = i < qrows ? delta[qq0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T; [j][e] is key g + 8 (e >> 1) of the
    // warp, q row j * 8 + 2t + (e & 1) of the tile.
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, Ks, warp * 16, kk);
      load_a<LD>(va, Vs, warp * 16, kk);
#pragma unroll
      for (int np = 0; np < BQ / 16; ++np) {
        uint32_t b[4];
        load_b_rows<LD>(b, Qs, np, kk);
        mma_bf16(st[2 * np], ka, b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka, b[2], b[3]);
        load_b_rows<LD>(b, Os, np, kk);
        mma_bf16(dpt[2 * np], va, b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }

    // p^T in place of s^T, ds^T in place of dp^T.
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = j * 8 + 2 * t + (e & 1);
        const bool vis =
            c < qrows &&
            (!p.causal || (long long)p.q_offset + qq0 + c >= kpos + 8 * r);
        const float pv = vis ? expf(st[j][e] * p.scale - Ls[c]) : 0.f;
        dpt[j][e] = pv * (dpt[j][e] - Dl[c]) * p.scale;
        st[j][e] = pv;
      }
    }

    // dv += p^T do and dk += ds^T q: the accumulators are the A fragments
    // (k dimension = q rows; ds^T as a bf16 pair, hi + lo); do and q come
    // in transposed.
#pragma unroll
    for (int ks = 0; ks < BQ / 16; ++ks) {
      uint32_t a[4];
      acc_to_a(a, st[2 * ks], st[2 * ks + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        load_b_trans<LD>(b, Os, ks, dd);
        mma_bf16(dv[2 * dd], a, b[0], b[1]);
        mma_bf16(dv[2 * dd + 1], a, b[2], b[3]);
      }
      uint32_t alo[4];
      acc_to_a(a, dpt[2 * ks], dpt[2 * ks + 1]);
      acc_to_a_lo(alo, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t b[4];
        load_b_trans<LD>(b, Qs, ks, dd);
        mma_bf16(dk[2 * dd], a, b[0], b[1]);
        mma_bf16(dk[2 * dd], alo, b[0], b[1]);
        mma_bf16(dk[2 * dd + 1], a, b[2], b[3]);
        mma_bf16(dk[2 * dd + 1], alo, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = warp * 16 + g + 8 * r;
    if (key < cols) {
      const long long at = ((long long)bh * p.sk + k0 + key) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        p.dk[at + i * 8 + 2 * t] = dk[i][2 * r];
        p.dk[at + i * 8 + 2 * t + 1] = dk[i][2 * r + 1];
        p.dv[at + i * 8 + 2 * t] = dv[i][2 * r];
        p.dv[at + i * 8 + 2 * t + 1] = dv[i][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores. Thread 2r + half owns row r of the tile and
// the score columns 4 (2i + half) + u, i < 8, u < 4 (and the same pattern
// over the d output columns).

template <int D>
constexpr int dq_simt_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * D * (BK + 4) + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_simt_kernel(BwdParams p) {
  extern __shared__ float smem_bwd_f[];
  constexpr int QS = D + 1;   // odd stride: the 16 rows of a warp hit 16 banks
  constexpr int KS = BK + 4;  // keeps float4 rows aligned
  constexpr int PS = BK + 1;
  constexpr int HD = D / 2;
  float* Qs = smem_bwd_f;     // [BQ][QS] q tile
  float* Os = Qs + BQ * QS;   // [BQ][QS] do tile
  float* Kt = Os + BQ * QS;   // [D][KS]  k tile, transposed
  float* Vt = Kt + D * KS;    // [D][KS]  v tile, transposed
  float* Ss = Vt + D * KS;    // [BQ][PS] ds of the tile

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int q0 = blockIdx.x * BQ;
  const int rows = min(BQ, p.sq - q0);

  const float* kp = head_ptr<float>(p.k, bi, hi, p.k_sb, p.k_sh);
  const float* vp = head_ptr<float>(p.v, bi, hi, p.v_sb, p.v_sh);
  load_tile_f32<D>(Qs, head_ptr<float>(p.q, bi, hi, p.q_sb, p.q_sh) +
                           (long long)q0 * p.q_ss, p.q_ss, rows, QS, true);
  load_tile_f32<D>(Os, head_ptr<float>(p.dout, bi, hi, p.o_sb, p.o_sh) +
                           (long long)q0 * p.o_ss, p.o_ss, rows, QS, true);
  const long long at = (long long)bh * p.sq + q0 + r;
  const float lse_r = r < rows ? p.lse[at] : 0.f;
  const float dlt_r = r < rows ? p.delta[at] : 0.f;
  const long long q_pos = (long long)p.q_offset + q0 + r;

  float acc[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) acc[i] = 0.f;

  const int n_kt = visible_k_tiles(p, q0, rows);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const int cols = min(BK, p.sk - k0);
    __syncthreads();
    load_tile_f32<D>(Kt, kp + (long long)k0 * p.k_ss, p.k_ss, cols, KS,
                     false);
    load_tile_f32<D>(Vt, vp + (long long)k0 * p.v_ss, p.v_ss, cols, KS,
                     false);
    __syncthreads();

    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      const float qv = Qs[r * QS + j];
      const float ov = Os[r * QS + j];
      const float4* krow = reinterpret_cast<const float4*>(Kt + j * KS);
      const float4* vrow = reinterpret_cast<const float4*>(Vt + j * KS);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float4 kk = krow[2 * i + half];
        const float4 vv = vrow[2 * i + half];
        s[4 * i + 0] = fmaf(qv, kk.x, s[4 * i + 0]);
        s[4 * i + 1] = fmaf(qv, kk.y, s[4 * i + 1]);
        s[4 * i + 2] = fmaf(qv, kk.z, s[4 * i + 2]);
        s[4 * i + 3] = fmaf(qv, kk.w, s[4 * i + 3]);
        dp[4 * i + 0] = fmaf(ov, vv.x, dp[4 * i + 0]);
        dp[4 * i + 1] = fmaf(ov, vv.y, dp[4 * i + 1]);
        dp[4 * i + 2] = fmaf(ov, vv.z, dp[4 * i + 2]);
        dp[4 * i + 3] = fmaf(ov, vv.w, dp[4 * i + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * (2 * i + half) + u;
        const bool vis =
            c < cols && (!p.causal || q_pos >= (long long)p.k_offset + k0 + c);
        const float pv = vis ? expf(s[4 * i + u] * p.scale - lse_r) : 0.f;
        Ss[r * PS + c] = pv * (dp[4 * i + u] - dlt_r) * p.scale;
      }
    }
    __syncwarp();  // the row's two halves of ds are written

    for (int c = 0; c < cols; ++c) {
      const float dsv = Ss[r * PS + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[4 * i + u] =
              fmaf(dsv, Kt[(4 * (2 * i + half) + u) * KS + c], acc[4 * i + u]);
      }
    }
  }

  if (r < rows) {
    float* out = p.dq + ((long long)bh * p.sq + q0 + r) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) out[4 * (2 * i + half) + u] = acc[4 * i + u];
    }
  }
}

template <int D>
constexpr int dkv_simt_smem_floats() {
  return 2 * BK * (D + 1) + 2 * D * (BQ + 4) + 2 * BQ + 2 * BK * (BQ + 1);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_simt_kernel(BwdParams p) {
  extern __shared__ float smem_bwd_f[];
  constexpr int KS = D + 1;
  constexpr int QS = BQ + 4;
  constexpr int PS = BQ + 1;
  constexpr int HD = D / 2;
  float* Ks = smem_bwd_f;     // [BK][KS] k tile
  float* Vs = Ks + BK * KS;   // [BK][KS] v tile
  float* Qt = Vs + BK * KS;   // [D][QS]  q tile, transposed
  float* Ot = Qt + D * QS;    // [D][QS]  do tile, transposed
  float* Ls = Ot + D * QS;    // [BQ]     lse
  float* Dl = Ls + BQ;        // [BQ]     delta
  float* Pt = Dl + BQ;        // [BK][PS] p^T of the tile
  float* St = Pt + BK * PS;   // [BK][PS] ds^T of the tile

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh - bi * p.h;
  const int k0 = blockIdx.x * BK;
  const int cols = min(BK, p.sk - k0);

  load_tile_f32<D>(Ks, head_ptr<float>(p.k, bi, hi, p.k_sb, p.k_sh) +
                           (long long)k0 * p.k_ss, p.k_ss, cols, KS, true);
  load_tile_f32<D>(Vs, head_ptr<float>(p.v, bi, hi, p.v_sb, p.v_sh) +
                           (long long)k0 * p.v_ss, p.v_ss, cols, KS, true);
  const float* qp = head_ptr<float>(p.q, bi, hi, p.q_sb, p.q_sh);
  const float* op = head_ptr<float>(p.dout, bi, hi, p.o_sb, p.o_sh);
  const float* lse = p.lse + (long long)bh * p.sq;
  const float* delta = p.delta + (long long)bh * p.sq;
  const long long k_pos = (long long)p.k_offset + k0 + r;

  float dk[HD], dv[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) dk[i] = dv[i] = 0.f;

  const int n_qt = (p.sq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int qq0 = qt * BQ;
    const int qrows = min(BQ, p.sq - qq0);
    if (!q_tile_visible(p, qq0, qrows, k0)) continue;  // uniform per block
    __syncthreads();
    load_tile_f32<D>(Qt, qp + (long long)qq0 * p.q_ss, p.q_ss, qrows, QS,
                     false);
    load_tile_f32<D>(Ot, op + (long long)qq0 * p.o_ss, p.o_ss, qrows, QS,
                     false);
    if (tid < BQ) {
      Ls[tid] = tid < qrows ? lse[qq0 + tid] : 0.f;
      Dl[tid] = tid < qrows ? delta[qq0 + tid] : 0.f;
    }
    __syncthreads();

    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < D; ++j) {
      const float kv = Ks[r * KS + j];
      const float vv = Vs[r * KS + j];
      const float4* qrow = reinterpret_cast<const float4*>(Qt + j * QS);
      const float4* orow = reinterpret_cast<const float4*>(Ot + j * QS);
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const float4 qq = qrow[2 * i + half];
        const float4 oo = orow[2 * i + half];
        s[4 * i + 0] = fmaf(kv, qq.x, s[4 * i + 0]);
        s[4 * i + 1] = fmaf(kv, qq.y, s[4 * i + 1]);
        s[4 * i + 2] = fmaf(kv, qq.z, s[4 * i + 2]);
        s[4 * i + 3] = fmaf(kv, qq.w, s[4 * i + 3]);
        dp[4 * i + 0] = fmaf(vv, oo.x, dp[4 * i + 0]);
        dp[4 * i + 1] = fmaf(vv, oo.y, dp[4 * i + 1]);
        dp[4 * i + 2] = fmaf(vv, oo.z, dp[4 * i + 2]);
        dp[4 * i + 3] = fmaf(vv, oo.w, dp[4 * i + 3]);
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = 4 * (2 * i + half) + u;
        const bool vis = c < qrows &&
                         (!p.causal || (long long)p.q_offset + qq0 + c >= k_pos);
        const float pv = vis ? expf(s[4 * i + u] * p.scale - Ls[c]) : 0.f;
        Pt[r * PS + c] = pv;
        St[r * PS + c] = pv * (dp[4 * i + u] - Dl[c]) * p.scale;
      }
    }
    __syncwarp();  // the row's two halves of p^T and ds^T are written

    for (int c = 0; c < qrows; ++c) {
      const float pc = Pt[r * PS + c];
      const float sc = St[r * PS + c];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jd = 4 * (2 * i + half) + u;
          dv[4 * i + u] = fmaf(pc, Ot[jd * QS + c], dv[4 * i + u]);
          dk[4 * i + u] = fmaf(sc, Qt[jd * QS + c], dk[4 * i + u]);
        }
      }
    }
  }

  if (r < cols) {
    const long long at = ((long long)bh * p.sk + k0 + r) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        p.dk[at + 4 * (2 * i + half) + u] = dk[4 * i + u];
        p.dv[at + 4 * (2 * i + half) + u] = dv[4 * i + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <int D>
cudaError_t launch_dq(const BwdParams& p, bool bf16, dim3 grid,
                      cudaStream_t stream) {
  if (bf16)
    return launch_kernel(flash_bwd_dq_mma_kernel<D>,
                         4 * BQ * (D + 8) * (int)sizeof(uint16_t), grid,
                         stream, p);
  return launch_kernel(flash_bwd_dq_simt_kernel<D>,
                       dq_simt_smem_floats<D>() * (int)sizeof(float), grid,
                       stream, p);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, bool bf16, dim3 grid,
                       cudaStream_t stream) {
  if (bf16)
    return launch_kernel(flash_bwd_dkv_mma_kernel<D>,
                         4 * BQ * (D + 8) * (int)sizeof(uint16_t) +
                             2 * BQ * (int)sizeof(float),
                         grid, stream, p);
  return launch_kernel(flash_bwd_dkv_simt_kernel<D>,
                       dkv_simt_smem_floats<D>() * (int)sizeof(float), grid,
                       stream, p);
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      int h, int sq, int sk, int d, const long long* strides,
                      int causal, int q_offset, int k_offset, int dtype) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = p.dk = p.dv = nullptr;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  p.scale = (float)(1.0 / sqrt((double)d));
  const void* ptrs[4] = {q, k, v, dout};
  p.vec = dtype == 1 && aligned16(ptrs, 4, strides, 12);
  return p;
}

}  // namespace

// dtype tags: 0 = float32, 1 = bfloat16 (q, k, v and do share it). Pointers
// and the stream come in as void*; strides (in elements) are those of q,
// k, v and do over (batch, head, seq), the head dimension's stride must be
// 1. lse and delta are contiguous f32 (b, h, sq); the outputs contiguous
// f32. Each returns the cudaError_t of its launch (0 on success).
extern "C" int autodist_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int q_offset, int k_offset, int dtype,
    void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  BwdParams p = make_params(q, k, v, dout, lse, delta, h, sq, sk, d, strides,
                            causal, q_offset, k_offset, dtype);
  p.dq = static_cast<float*>(dq);
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (d) {
    case 16: return (int)launch_dq<16>(p, bf16, grid, st);
    case 32: return (int)launch_dq<32>(p, bf16, grid, st);
    case 64: return (int)launch_dq<64>(p, bf16, grid, st);
    case 128: return (int)launch_dq<128>(p, bf16, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int autodist_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int sq, int sk, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int q_offset, int k_offset, int dtype,
    void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  BwdParams p = make_params(q, k, v, dout, lse, delta, h, sq, sk, d, strides,
                            causal, q_offset, k_offset, dtype);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  const dim3 grid((sk + BK - 1) / BK, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (d) {
    case 16: return (int)launch_dkv<16>(p, bf16, grid, st);
    case 32: return (int)launch_dkv<32>(p, bf16, grid, st);
    case 64: return (int)launch_dkv<64>(p, bf16, grid, st);
    case 128: return (int)launch_dkv<128>(p, bf16, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
