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
// all accumulated in f32 and written as f32 or, on request, rounded once to
// bf16 (round to nearest even, bitwise what Tensor.to gives; the training
// path takes its gradients so, with no cast kernel after). delta =
// rowsum(do * o) comes in from the caller, as in the JAX package. A row
// that sees no key (lse = -1e30) contributes exactly 0 to every output.
// Two kernels as in the Pallas pair: no atomics, so a repeat is bitwise
// identical.
//
// What bounds it on an H100: at BERT-base's training shape (b=32, h=12,
// s=128, d=64, bf16) the dq kernel must read q, k, v, do (bf16) plus lse
// and delta, 25.6 MB, and write dq: 38.1 MB in all with an f32 dq (11.4 us
// at 3.35 TB/s), 31.9 MB with a bf16 one (9.5 us), against 2.4 GFLOP (2.4
// us on the bf16 tensor cores); the dk/dv kernel moves 50.7 / 38.1 MB
// (15.1 / 11.4 us) for 3.2 GFLOP (3.3 us). At serving's bucket (b=8,
// s=512) the bytes are the same and the products 4x: 9.8 / 13.0 us, so
// with bf16 outputs both kernels are bound by the tensor cores there. The
// kernels must keep loads in flight under the products and the products at
// wgmma's rate; the (sq x sk) score and probability matrices never reach
// device memory.
//
// Routes, chosen by input type and head dim (no fallback between them):
//
// * bf16, the main path: flash_bwd_dkv_wgmma_kernel (d = 64) and
//   flash_bwd_dq_wgmma_kernel (d = 64, 128). Persistent blocks, one per SM,
//   of three warpgroups; the third produces, the first two consume. All
//   tiles come in by TMA (hopper.cuh) through 4-D (d, s, h, b) maps with
//   the caller's strides, rows past s read as zeros, into 128-byte-swizzled
//   shared memory, where one tile serves both as a K-major and an MN-major
//   wgmma operand: each q, do, k and v tile is loaded once and read both
//   ways.
//   - dk/dv: a work item is (128-key tile, b*h); each consumer warpgroup
//     owns 64 keys. K and V are loaded once per item into one of two
//     buffers (the next item's load runs under this one); tiles of 64 q
//     rows of Q and dO stream through a two-stage ring, with their lse and
//     delta (cp.async by the producer warp, arriving on the same mbarrier:
//     a row of lse is neither 16-byte aligned nor, at the ragged edge,
//     inside the tensor, so TMA cannot fetch it). Per q tile: S^T = K Q^T
//     and dP^T = V dO^T as wgmmas from shared memory, P^T and dS^T in
//     registers, then dV += P^T dO and dK += dS^T Q as wgmmas with A from
//     registers (the accumulator layout is the register-A layout) and B
//     MN-major. S^T / dP^T of tile j and the dV / dK products of tile j - 1
//     are in flight together.
//   - dq: a work item is (128-row q tile, b*h), 64 rows per consumer
//     warpgroup; Q, dO, lse and delta are loaded once per item, tiles of 64
//     keys of K and V stream through a two-stage ring. Per key tile: S = Q
//     K^T and dP = dO V^T from shared memory, dS in registers, dQ += dS K
//     with K MN-major; S / dP of tile j fly with dS K of tile j - 1.
//   - p is rounded once to bf16 as the A operand of p^T.do (as
//     FlashAttention-2; the Pallas kernel keeps it in f32). ds is not: each
//     row of ds sums to 0 (sum_j p_ij (dp_ij - delta_i) = 0), which cancels
//     the component that all keys (queries) share out of dq (dk), and one
//     bf16 rounding of ds breaks that cancellation. At BERT-base's
//     initialization, where the true q/k gradients are ~1e-5, one rounding
//     left the q/k projection gradients off by up to 1.3x their largest
//     entry. So ds enters ds.k and ds^T.q as a pair of bf16 operands, hi =
//     bf16(ds) and lo = bf16(ds - hi), two products that carry ~16 bits.
//   - Only tiles that the causal diagonal crosses or that hold the ragged
//     edge are masked, in a compile-time variant of the step, so no
//     run-time branch sits between a wgmma and its wait (ptxas would
//     serialise every wgmma); causal tiles that the mask empties are never
//     loaded. The exponent is one FMA and ex2 (scale and lse pre-multiplied
//     by log2 e).
//   - The epilogue stages the accumulators in shared memory (rounded to the
//     output type) and stores 16-byte row vectors; the next item's loads
//     run under it.
//   - dk/dv at d = 128 stays on mma.sync: its dK and dV accumulators alone
//     take 128 registers a thread at d = 128, S^T and dP^T 64 more and the
//     A operands 48, which leaves nothing of setmaxnreg's 240 for
//     addresses.
// * bf16, d = 16 or 32 (the tiny test configs), and dk/dv at d = 128:
//   mma.sync.m16n8k16 (flash_common.cuh), 4 warps of 16 rows a block, one
//   tile in flight. flash_bwd_dq_mma_kernel takes a 64-row q tile over
//   64-key tiles; flash_bwd_dkv_mma_kernel a 64-key tile over 64-row q
//   tiles, computing s^T = k.q^T and dp^T = v.do^T directly so that p^T and
//   ds^T are already in the accumulator layout the next products take as A
//   operands. Operands needed transposed come in through ldmatrix.trans.
// * f32 inputs (the tiny test configs): plain f32 FMAs, so the products
//   keep f32 precision (tensor cores would round to tf32); f32 outputs.
//
// Rows and columns past sq / sk are masked (or read as zeros and never
// stored), so any sequence length works. d in {16, 32, 64, 128}; b * h <=
// 65535 (grid y of the one-tile-per-block kernels).
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (b*h, sq) contiguous
  const float* delta;  // (b*h, sq) contiguous
  void* dq;            // (b*h, sq, d) contiguous, f32 or bf16
  void* dk;            // (b*h, sk, d) contiguous, f32 or bf16
  void* dv;            // (b*h, sk, d) contiguous, f32 or bf16
  int h, sq, sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;  // strides of do
  int causal, q_offset, k_offset;
  float scale;
  int vec;  // bf16 tiles: rows are 16-byte aligned, load 16 bytes at once
};

// Number of key tiles of ``bk`` keys that rows up to ``q_last`` (an index
// into this call's q) must visit: all, or under causal masking those whose
// first key the row reaches. ``P``: BwdParams or WgParams.
template <typename P>
__device__ __forceinline__ int key_tiles(const P& p, int bk, int q_last) {
  int n = (p.sk + bk - 1) / bk;
  if (p.causal) {
    const long long span =
        (long long)p.q_offset + q_last - (long long)p.k_offset;
    n = span < 0 ? 0 : (int)min((long long)n, span / bk + 1);
  }
  return n;
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
// bf16, d = 16 / 32 (and dk/dv at d = 128): tensor cores (mma.sync m16n8k16)

template <typename TO, int D>
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

  const int n_kt = key_tiles(p, BK, q0 + rows - 1);
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
      TO* out = static_cast<TO*>(p.dq) + ((long long)bh * p.sq + q0 + row) * D;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        out[i * 8 + 2 * t] = from_f<TO>(acc[i][2 * r]);
        out[i * 8 + 2 * t + 1] = from_f<TO>(acc[i][2 * r + 1]);
      }
    }
  }
}

template <typename TO, int D>
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
      TO* dko = static_cast<TO*>(p.dk) + at;
      TO* dvo = static_cast<TO*>(p.dv) + at;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        dko[i * 8 + 2 * t] = from_f<TO>(dk[i][2 * r]);
        dko[i * 8 + 2 * t + 1] = from_f<TO>(dk[i][2 * r + 1]);
        dvo[i * 8 + 2 * t] = from_f<TO>(dv[i][2 * r]);
        dvo[i * 8 + 2 * t + 1] = from_f<TO>(dv[i][2 * r + 1]);
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

  const int n_kt = key_tiles(p, BK, q0 + rows - 1);
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
    float* out =
        static_cast<float*>(p.dq) + ((long long)bh * p.sq + q0 + r) * D;
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
        static_cast<float*>(p.dk)[at + 4 * (2 * i + half) + u] = dk[4 * i + u];
        static_cast<float*>(p.dv)[at + 4 * (2 * i + half) + u] = dv[4 * i + u];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, TMA producer + two wgmma consumer warpgroups

struct WgParams {
  CUtensorMap tq, tk, tv, tdo;  // bf16 (d, s, h, b) maps (hopper::bf16_map)
  const float* lse;             // (b, h, sq) contiguous
  const float* delta;           // (b, h, sq) contiguous
  void* out0;                   // dq, or dk: (b, h, s, d) contiguous
  void* out1;                   // dv (dk/dv kernel)
  int h, sq, sk;
  int n_tiles, n_items;  // item tiles per (b, h); items = n_tiles * b * h
  int causal, q_offset, k_offset;
  float scale;       // 1 / sqrt(d)
  float scale_log2;  // log2(e) / sqrt(d): scores go straight to exp2
};

constexpr float kLog2e = 1.4426950408889634f;

// The first q tile of ``bq`` rows that sees key ``k_first`` (an index into
// this call's k), or the number of q tiles when none does.
__device__ __forceinline__ int first_q_tile(const WgParams& p, int bq,
                                            int k_first) {
  if (!p.causal) return 0;
  const long long need =
      (long long)p.k_offset + k_first - (long long)p.q_offset;
  if (need <= 0) return 0;
  if (need >= p.sq) return (p.sq + bq - 1) / bq;
  return (int)(need / bq);
}

template <typename TO, int D>
constexpr int stage_pitch() {  // elements: the 8 rows of a quad group hit
  return std::is_same<TO, float>::value ? D + 4 : D + 8;  // 32 banks
}

// A consumer warpgroup's 64 x D f32 accumulators (wgmma layout; acc[c]
// holds columns 64c .. 64c + 63) into shared memory at row pitch P,
// rounded to TO.
template <typename TO, int D, int P>
__device__ __forceinline__ void stage_acc(TO* st,
                                          const float (&acc)[D / 64][32],
                                          int warp, int g, int c4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * c4;
        const float v0 = acc[c][4 * j + 2 * r];
        const float v1 = acc[c][4 * j + 2 * r + 1];
        if constexpr (std::is_same<TO, float>::value)
          *reinterpret_cast<float2*>(st + row * P + col) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(st + row * P + col) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
}

// Rows 0 .. rows - 1 of a staged 64 x D tile into ``out`` (row stride D) as
// 16-byte row-contiguous vectors; ``t`` is the thread in the warpgroup.
template <typename TO, int D, int P>
__device__ __forceinline__ void store_rows(TO* out, const TO* st, int rows,
                                           int t) {
  constexpr int V = 16 / (int)sizeof(TO);
  constexpr int PER_ROW = D / V;
  for (int e = t; e < 64 * PER_ROW; e += 128) {
    const int row = e / PER_ROW, col = (e % PER_ROW) * V;
    if (row < rows)
      *reinterpret_cast<uint4*>(out + (long long)row * D + col) =
          *reinterpret_cast<const uint4*>(st + row * P + col);
  }
}

using Plain = std::integral_constant<bool, false>;
using Masked = std::integral_constant<bool, true>;

// --- dq ---------------------------------------------------------------------

template <typename TO, int D>
struct DqCfg {
  static constexpr int kBQ = 128;             // q rows per item
  static constexpr int kBK = 64;              // keys per K/V tile
  static constexpr int kStages = 2;           // K/V ring depth
  static constexpr int kChunks = D / 64;      // 64-column (128 B) chunks
  static constexpr int kQChunk = kBQ * 128;   // bytes of one Q chunk
  static constexpr int kKChunk = kBK * 128;
  static constexpr int kQBytes = kChunks * kQChunk;   // Q or dO
  static constexpr int kKVBytes = kChunks * kKChunk;  // K or V, one stage
  static constexpr int kPitch = stage_pitch<TO, D>();
  // Byte offsets from the 1024-byte-aligned base of shared memory.
  static constexpr int kO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kSt = kV + kStages * kKVBytes;
  static constexpr int kBar = kSt + kBQ * kPitch * (int)sizeof(TO);
  // q_full, q_empty, kv_full[kStages], kv_empty[kStages]; 1024 bytes of
  // slack to align the base.
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
};

// Persistent blocks of 384 threads, one per SM, each walking work items of
// (128-row q tile, batch * head), the q tiles of one head neighbours, the
// last first (under causal masking it visits the most keys): warpgroups 0
// and 1 consume (64 q rows each), one thread of warpgroup 2 issues every
// TMA load. Q/dO's buffer and the K/V ring carry over from item to item.
template <typename TO, int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ WgParams p) {
  using C = DqCfg<TO, D>;
  constexpr int BK = C::kBK;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sQ = base, sO = base + C::kO;
  const uint32_t sK = base + C::kK, sV = base + C::kV;
  const uint32_t q_full = base + C::kBar;
  const uint32_t q_empty = q_full + 8;
  const uint32_t kv_full = q_empty + 8;       // + 8 * stage
  const uint32_t kv_empty = kv_full + 8 * S;  // + 8 * stage

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 256);  // every consumer thread
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(kv_full + 8 * s, 1);
      hopper::mbar_init(kv_empty + 8 * s, 256);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  auto item_tile = [&](int item, int& bh, int& q0) {
    bh = item / p.n_tiles;
    q0 = (p.n_tiles - 1 - (item - bh * p.n_tiles)) * C::kBQ;
  };

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q and dO once an item, then K and V of each visible key
    // tile into the ring.
    hopper::regs_dealloc<24>();
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&p.tq);
      hopper::prefetch_map(&p.tdo);
      hopper::prefetch_map(&p.tk);
      hopper::prefetch_map(&p.tv);
      int n_loaded = 0;  // K/V tiles through the ring so far
      for (int item = blockIdx.x, it = 0; item < p.n_items;
           item += gridDim.x, ++it) {
        int bh, q0;
        item_tile(item, bh, q0);
        const int bi = bh / p.h;
        const int hi = bh - bi * p.h;
        const int n_kt = key_tiles(p, BK, min(q0 + C::kBQ, p.sq) - 1);
        // Round r of a barrier waits for the consumers' release of round
        // r - 1; round 0 passes at once.
        auto load_kv = [&](int kt) {
          const int s = n_loaded % S;
          hopper::mbar_wait(kv_empty + 8 * s, ((n_loaded / S) & 1) ^ 1);
          hopper::mbar_expect_tx(kv_full + 8 * s, 2 * C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            hopper::tma_load_4d(sK + s * C::kKVBytes + c * C::kKChunk, &p.tk,
                                kv_full + 8 * s, 64 * c, kt * BK, hi, bi);
            hopper::tma_load_4d(sV + s * C::kKVBytes + c * C::kKChunk, &p.tv,
                                kv_full + 8 * s, 64 * c, kt * BK, hi, bi);
          }
          ++n_loaded;
        };
        // The item's first K/V tile goes ahead of its Q and dO, whose
        // buffer is free only once the consumers finish the previous item.
        if (n_kt > 0) load_kv(0);
        hopper::mbar_wait(q_empty, (it & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, 2 * C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          hopper::tma_load_4d(sQ + c * C::kQChunk, &p.tq, q_full, 64 * c, q0,
                              hi, bi);
          hopper::tma_load_4d(sO + c * C::kQChunk, &p.tdo, q_full, 64 * c,
                              q0, hi, bi);
        }
        for (int kt = 1; kt < n_kt; ++kt) load_kv(kt);
      }
    }
  } else {
    // Consumer warpgroup wg: q rows rq0 .. rq0 + 63 of the item.
    hopper::regs_alloc<240>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int g = (t & 31) >> 2;
    const int c4 = t & 3;
    TO* st = reinterpret_cast<TO*>(smem + C::kSt) + wg * 64 * C::kPitch;
    int n_used = 0;  // K/V tiles through the ring before this item
    for (int item = blockIdx.x, it = 0; item < p.n_items;
         item += gridDim.x, ++it) {
      int bh, q0;
      item_tile(item, bh, q0);
      const int n_kt = key_tiles(p, BK, min(q0 + C::kBQ, p.sq) - 1);
      const int rq0 = q0 + 64 * wg;
      const int rows = min(64, p.sq - rq0);  // <= 0: nothing to write
      const int nkt_w = rows > 0 ? key_tiles(p, BK, rq0 + rows - 1) : 0;
      // Global position of this thread's first row (the second is + 8).
      const long long qpos = (long long)p.q_offset + rq0 + 16 * warp + g;
      // lse (times -log2 e) and delta of the two rows; rows past sq read
      // zeros (their q and do rows are zero, so they add nothing).
      float nl[2], dlt[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rq0 + 16 * warp + g + 8 * r;
        const long long at = (long long)bh * p.sq + row;
        nl[r] = row < p.sq ? -p.lse[at] * kLog2e : 0.f;
        dlt[r] = row < p.sq ? p.delta[at] : 0.f;
      }

      float dq[C::kChunks][32];
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;

      hopper::mbar_wait(q_full, it & 1);
      // Tiles 0 .. nkt_w - 1 are visible here; the first n_plain of them
      // need no mask (the ragged last tile and the tiles from the causal
      // diagonal on do).
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

      float s[32], dp[32];      // S and dP of one tile, then dS in s
      uint32_t dsh[4][4];       // dS of the previous tile, rounded to bf16
      uint32_t dsl[4][4];       // and its bf16 residual

      // S = Q K^T and dP = dO V^T over d in k16 steps, both K-major.
      auto issue_sdp = [&](int kt) {
        const uint32_t kb = sK + stage(kt) * C::kKVBytes;
        const uint32_t vb = sV + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t chunk = kk / 4, off = (kk % 4) * 32;
          hopper::wgmma_ss_n64(
              s, hopper::sw128_desc(sQ + chunk * C::kQChunk + wg * 8192 + off),
              hopper::sw128_desc(kb + chunk * C::kKChunk + off), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t chunk = kk / 4, off = (kk % 4) * 32;
          hopper::wgmma_ss_n64(
              dp, hopper::sw128_desc(sO + chunk * C::kQChunk + wg * 8192 + off),
              hopper::sw128_desc(vb + chunk * C::kKChunk + off), kk > 0);
        }
        hopper::wgmma_commit();
      };
      // dQ += dS K: dS the register A operand (hi and lo), K an MN-major B,
      // one wgmma per 64-column chunk.
      auto issue_dq = [&](int kt) {
        const uint32_t kb = sK + stage(kt) * C::kKVBytes;
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            const uint64_t b =
                hopper::sw128_desc(kb + c * C::kKChunk + ks * 16 * 128);
            hopper::wgmma_rs_n64_mn(dq[c], dsh[ks], b);
            hopper::wgmma_rs_n64_mn(dq[c], dsl[ks], b);
          }
        hopper::wgmma_commit();
      };
      // dS = P (dP - delta) / sqrt(d) in place of S; a masked P is exactly 0.
      auto grad_scores = [&](int kt, auto masked) {
        const int k0 = kt * BK;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float pv = ex2_ftz(fmaf(s[4 * j + e], p.scale_log2, nl[r]));
            if constexpr (decltype(masked)::value) {
              const int col = k0 + 8 * j + 2 * c4 + (e & 1);
              const bool vis =
                  col < p.sk &&
                  (!p.causal ||
                   qpos + 8 * r >= (long long)p.k_offset + col);
              if (!vis) pv = 0.f;
            }
            s[4 * j + e] = pv * (dp[4 * j + e] - dlt[r]) * p.scale;
          }
      };
      auto pack = [&] {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = s[8 * ks + 2 * i], b = s[8 * ks + 2 * i + 1];
            dsh[ks][i] = pack_bf16(a, b);
            dsl[ks][i] = pack_bf16(bf16_residual(a), bf16_residual(b));
          }
      };
      auto zero_sdp = [&] {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
      };
      auto fence_dq = [&] {
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) hopper::fence_regs(dq[c]);
      };
      // Step kt: S / dP of tile kt and dS K of tile kt - 1 in flight
      // together; tile kt's dS is computed under the second.
      auto step = [&](int kt, auto masked) {
        hopper::mbar_wait(kv_full + 8 * stage(kt), parity(kt));
        zero_sdp();
        fence_dq();
        hopper::wgmma_fence();
        issue_sdp(kt);
        issue_dq(kt - 1);
        hopper::wgmma_wait<1>();  // groups complete in order: S, dP done
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        grad_scores(kt, masked);
        hopper::wgmma_wait<0>();
        fence_dq();
        hopper::fence_regs(dsh);
        hopper::fence_regs(dsl);
        release(kt - 1);
        pack();
      };

      if (nkt_w > 0) {
        hopper::mbar_wait(kv_full + 8 * stage(0), parity(0));
        zero_sdp();
        hopper::wgmma_fence();
        issue_sdp(0);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (n_plain > 0)
          grad_scores(0, Plain());
        else
          grad_scores(0, Masked());
        pack();
        for (int kt = 1; kt < n_plain; ++kt) step(kt, Plain());
        for (int kt = max(n_plain, 1); kt < nkt_w; ++kt) step(kt, Masked());
        // Drain: dS K of the last visible tile.
        fence_dq();
        hopper::wgmma_fence();
        issue_dq(nkt_w - 1);
        hopper::wgmma_wait<0>();
        fence_dq();
        hopper::fence_regs(dsh);
        hopper::fence_regs(dsl);
        release(nkt_w - 1);
      }
      // Tiles no row here can see: wait for them and give them back.
      for (int kt = nkt_w; kt < n_kt; ++kt) {
        hopper::mbar_wait(kv_full + 8 * stage(kt), parity(kt));
        release(kt);
      }
      n_used += n_kt;
      hopper::mbar_arrive(q_empty);  // the next item's Q and dO may load

      // Epilogue: dq staged in shared memory, then 16-byte row stores.
      hopper::named_sync(1 + wg, 128);  // the last item's staging is read
      stage_acc<TO, D, C::kPitch>(st, dq, warp, g, c4);
      hopper::named_sync(1 + wg, 128);  // this warpgroup's staging is full
      store_rows<TO, D, C::kPitch>(
          static_cast<TO*>(p.out0) + ((long long)bh * p.sq + rq0) * D, st,
          rows, t);
    }
  }
}

// --- dk / dv (d = 64) -------------------------------------------------------

template <typename TO>
struct DkvCfg {
  static constexpr int D = 64;
  static constexpr int kBK = 128;       // keys per item
  static constexpr int kBQ = 64;        // q rows per ring tile
  static constexpr int kStages = 2;     // Q / dO / lse / delta ring depth
  static constexpr int kKVBufs = 2;     // K / V buffers (item parity)
  static constexpr int kKVBytes = kBK * 128;  // K or V of one item
  static constexpr int kQBytes = kBQ * 128;   // Q or dO of one tile
  static constexpr int kPitch = stage_pitch<TO, D>();
  // Byte offsets from the 1024-byte-aligned base of shared memory.
  static constexpr int kK = 0;
  static constexpr int kV = kKVBufs * kKVBytes;
  static constexpr int kQ = 2 * kKVBufs * kKVBytes;
  static constexpr int kO = kQ + kStages * kQBytes;
  static constexpr int kL = kO + kStages * kQBytes;   // lse [kStages][kBQ]
  static constexpr int kDl = kL + kStages * kBQ * 4;  // delta, the same
  static constexpr int kSt = kDl + kStages * kBQ * 4;  // dk rows, then dv
  static constexpr int kBar = kSt + 2 * kBK * kPitch * (int)sizeof(TO);
  // full[kStages], empty[kStages], kv_full[kKVBufs], kv_empty[kKVBufs];
  // 1024 bytes of slack to align the base.
  static constexpr int kBytes = kBar + 16 * (kStages + kKVBufs) + 1024;
};

// Persistent blocks of 384 threads, one per SM, each walking work items of
// (128-key tile, batch * head): warpgroups 0 and 1 consume (64 keys each),
// warp 8 produces (lane 0 issues the TMA loads, all 32 lanes copy lse and
// delta with cp.async). Under causal masking a q tile is loaded only if
// the item's first key sees it; a warpgroup whose keys start later passes
// over the tiles it cannot see.
template <typename TO, int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ WgParams p) {
  static_assert(D == 64, "dk/dv on the TMA route: d = 64 (see above)");
  using C = DkvCfg<TO>;
  constexpr int BQ = C::kBQ;
  constexpr int S = C::kStages;
  constexpr int KB = C::kKVBufs;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sK = base + C::kK, sV = base + C::kV;
  const uint32_t sQ = base + C::kQ, sO = base + C::kO;
  const uint32_t sL = base + C::kL, sD = base + C::kDl;
  const uint32_t full = base + C::kBar;        // + 8 * stage
  const uint32_t empty = full + 8 * S;         // + 8 * stage
  const uint32_t kv_full = empty + 8 * S;      // + 8 * buffer
  const uint32_t kv_empty = kv_full + 8 * KB;  // + 8 * buffer
  const int n_qt = (p.sq + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // The TMA arrival and the producer warp's 32 cp.async arrivals.
      hopper::mbar_init(full + 8 * s, 33);
      hopper::mbar_init(empty + 8 * s, 256);  // every consumer thread
    }
    for (int b = 0; b < KB; ++b) {
      hopper::mbar_init(kv_full + 8 * b, 1);
      hopper::mbar_init(kv_empty + 8 * b, 256);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hopper::regs_dealloc<40>();
    if (threadIdx.x < 288) {  // warp 8
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        hopper::prefetch_map(&p.tq);
        hopper::prefetch_map(&p.tdo);
        hopper::prefetch_map(&p.tk);
        hopper::prefetch_map(&p.tv);
      }
      int n_loaded = 0;  // q tiles through the ring so far
      for (int item = blockIdx.x, it = 0; item < p.n_items;
           item += gridDim.x, ++it) {
        const int bh = item / p.n_tiles;
        const int k0 = (item - bh * p.n_tiles) * C::kBK;
        const int bi = bh / p.h;
        const int hi = bh - bi * p.h;
        const int qt_lo = first_q_tile(p, BQ, k0);
        const float* lse = p.lse + (long long)bh * p.sq;
        const float* delta = p.delta + (long long)bh * p.sq;
        auto load_q = [&](int qt) {
          const int s = n_loaded % S;
          const uint32_t bar = full + 8 * s;
          hopper::mbar_wait(empty + 8 * s, ((n_loaded / S) & 1) ^ 1);
          if (lane == 0) {
            hopper::mbar_expect_tx(bar, 2 * C::kQBytes);
            hopper::tma_load_4d(sQ + s * C::kQBytes, &p.tq, bar, 0, qt * BQ,
                                hi, bi);
            hopper::tma_load_4d(sO + s * C::kQBytes, &p.tdo, bar, 0, qt * BQ,
                                hi, bi);
          }
          for (int r = lane; r < BQ; r += 32) {
            const int row = qt * BQ + r;
            const bool ok = row < p.sq;  // past sq: zeros
            const uint32_t at = (uint32_t)(s * BQ + r) * 4;
            hopper::cp_async_4(sL + at, lse + (ok ? row : 0), ok ? 4 : 0);
            hopper::cp_async_4(sD + at, delta + (ok ? row : 0), ok ? 4 : 0);
          }
          hopper::cp_async_mbar_arrive(bar);
          ++n_loaded;
        };
        // The item's first q tile goes ahead of its K and V, whose buffer
        // is free only once the consumers finish the item two back.
        if (qt_lo < n_qt) load_q(qt_lo);
        const int b = it % KB;
        hopper::mbar_wait(kv_empty + 8 * b, ((it / KB) & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_expect_tx(kv_full + 8 * b, 2 * C::kKVBytes);
          hopper::tma_load_4d(sK + b * C::kKVBytes, &p.tk, kv_full + 8 * b, 0,
                              k0, hi, bi);
          hopper::tma_load_4d(sV + b * C::kKVBytes, &p.tv, kv_full + 8 * b, 0,
                              k0, hi, bi);
        }
        for (int qt = qt_lo + 1; qt < n_qt; ++qt) load_q(qt);
      }
    }
  } else {
    // Consumer warpgroup wg: keys kw0 .. kw0 + 63 of the item.
    hopper::regs_alloc<232>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int g = (t & 31) >> 2;
    const int c4 = t & 3;
    const float* Ls = reinterpret_cast<const float*>(smem + C::kL);
    const float* Ds = reinterpret_cast<const float*>(smem + C::kDl);
    TO* st_k = reinterpret_cast<TO*>(smem + C::kSt) + wg * 64 * C::kPitch;
    TO* st_v = st_k + C::kBK * C::kPitch;
    int n_used = 0;  // q tiles through the ring before this item
    for (int item = blockIdx.x, it = 0; item < p.n_items;
         item += gridDim.x, ++it) {
      const int bh = item / p.n_tiles;
      const int k0 = (item - bh * p.n_tiles) * C::kBK;
      const int qt_lo = first_q_tile(p, BQ, k0);
      const int n_t = n_qt - qt_lo;  // tiles through the ring this item
      const int kw0 = k0 + 64 * wg;
      const int skip = first_q_tile(p, BQ, kw0) - qt_lo;
      // Global position of this thread's first key (the second is + 8).
      const long long kpos = (long long)p.k_offset + kw0 + 16 * warp + g;
      const int kb = it % KB;
      const uint32_t sKw = sK + kb * C::kKVBytes + wg * 8192;
      const uint32_t sVw = sV + kb * C::kKVBytes + wg * 8192;

      float dk[1][32], dv[1][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[0][i] = dv[0][i] = 0.f;

      auto stage = [&](int i) { return (n_used + i) % S; };
      auto parity = [&](int i) { return (uint32_t)((n_used + i) / S) & 1; };
      auto release = [&](int i) {
        hopper::mbar_arrive(empty + 8 * stage(i));
      };
      auto first_row = [&](int i) { return (qt_lo + i) * BQ; };
      auto ragged = [&](int i) { return first_row(i) + BQ > p.sq; };
      // Ring tile i needs a mask when it is ragged or the causal diagonal
      // crosses it (some row sits before this warpgroup's last key).
      auto needs_mask = [&](int i) {
        return ragged(i) ||
               (p.causal && (long long)p.q_offset + first_row(i) <
                                (long long)p.k_offset + kw0 + 63);
      };

      float sT[32], dpT[32];  // S^T, dP^T of one tile, then P^T, dS^T
      uint32_t pa[4][4];      // P^T of the previous tile, bf16
      uint32_t dsh[4][4];     // dS^T of the previous tile, bf16
      uint32_t dsl[4][4];     // and its bf16 residual

      // S^T = K Q^T and dP^T = V dO^T over d in k16 steps, both K-major.
      auto issue_ss = [&](int i) {
        const uint32_t q = sQ + stage(i) * C::kQBytes;
        const uint32_t o = sO + stage(i) * C::kQBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n64(sT, hopper::sw128_desc(sKw + 32 * kk),
                               hopper::sw128_desc(q + 32 * kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss_n64(dpT, hopper::sw128_desc(sVw + 32 * kk),
                               hopper::sw128_desc(o + 32 * kk), kk > 0);
        hopper::wgmma_commit();
      };
      // dV += P^T dO and dK += dS^T Q (hi and lo): A from registers, dO and
      // Q MN-major, k16 steps over the tile's q rows.
      auto issue_rs = [&](int i) {
        const uint32_t q = sQ + stage(i) * C::kQBytes;
        const uint32_t o = sO + stage(i) * C::kQBytes;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint64_t bo = hopper::sw128_desc(o + ks * 16 * 128);
          const uint64_t bq = hopper::sw128_desc(q + ks * 16 * 128);
          hopper::wgmma_rs_n64_mn(dv[0], pa[ks], bo);
          hopper::wgmma_rs_n64_mn(dk[0], dsh[ks], bq);
          hopper::wgmma_rs_n64_mn(dk[0], dsl[ks], bq);
        }
        hopper::wgmma_commit();
      };
      // P^T in place of S^T and dS^T in place of dP^T; a q row's lse and
      // delta come from the ring; a masked P is exactly 0.
      auto grad_scores = [&](int i, auto masked) {
        const float* L = Ls + stage(i) * BQ;
        const float* Dd = Ds + stage(i) * BQ;
        const int q0 = first_row(i);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * c4;
          const float2 l = *reinterpret_cast<const float2*>(L + col);
          const float2 dd = *reinterpret_cast<const float2*>(Dd + col);
          const float nl[2] = {-l.x * kLog2e, -l.y * kLog2e};
          const float dlt[2] = {dd.x, dd.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float pv =
                ex2_ftz(fmaf(sT[4 * j + e], p.scale_log2, nl[e & 1]));
            if constexpr (decltype(masked)::value) {
              const int qr = q0 + col + (e & 1);
              const bool vis =
                  qr < p.sq && (!p.causal || (long long)p.q_offset + qr >=
                                                 kpos + 8 * (e >> 1));
              if (!vis) pv = 0.f;
            }
            dpT[4 * j + e] = pv * (dpT[4 * j + e] - dlt[e & 1]) * p.scale;
            sT[4 * j + e] = pv;
          }
        }
      };
      auto pack = [&] {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pa[ks][i] = pack_bf16(sT[8 * ks + 2 * i], sT[8 * ks + 2 * i + 1]);
            const float a = dpT[8 * ks + 2 * i], b = dpT[8 * ks + 2 * i + 1];
            dsh[ks][i] = pack_bf16(a, b);
            dsl[ks][i] = pack_bf16(bf16_residual(a), bf16_residual(b));
          }
      };
      auto zero_ss = [&] {
#pragma unroll
        for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
        hopper::fence_regs(sT);
        hopper::fence_regs(dpT);
      };
      auto fence_acc = [&] {
        hopper::fence_regs(dk[0]);
        hopper::fence_regs(dv[0]);
      };
      auto fence_a = [&] {
        hopper::fence_regs(pa);
        hopper::fence_regs(dsh);
        hopper::fence_regs(dsl);
      };
      // Step i: S^T / dP^T of tile i and the dV / dK products of tile i - 1
      // in flight together; tile i's P^T and dS^T are computed under the
      // second.
      auto step = [&](int i, auto masked) {
        hopper::mbar_wait(full + 8 * stage(i), parity(i));
        zero_ss();
        fence_acc();
        hopper::wgmma_fence();
        issue_ss(i);
        issue_rs(i - 1);
        hopper::wgmma_wait<1>();  // groups complete in order: S^T, dP^T
        hopper::fence_regs(sT);
        hopper::fence_regs(dpT);
        grad_scores(i, masked);
        hopper::wgmma_wait<0>();
        fence_acc();
        fence_a();
        release(i - 1);
        pack();
      };

      hopper::mbar_wait(kv_full + 8 * kb, (it / KB) & 1);
      // Tiles before this warpgroup's first visible one: wait, give back.
      for (int i = 0; i < skip; ++i) {
        hopper::mbar_wait(full + 8 * stage(i), parity(i));
        release(i);
      }
      if (skip < n_t) {
        // Masks: tiles [skip, e1) cross the causal diagonal, [e1, e2) need
        // none, [e2, n_t) is the ragged last tile (masking is monotone up
        // to that one).
        int e1 = skip;
        while (e1 < n_t && needs_mask(e1)) ++e1;
        const int e2 = (e1 < n_t && ragged(n_t - 1)) ? n_t - 1 : n_t;
        hopper::mbar_wait(full + 8 * stage(skip), parity(skip));
        zero_ss();
        hopper::wgmma_fence();
        issue_ss(skip);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sT);
        hopper::fence_regs(dpT);
        if (e1 > skip || e2 <= skip)
          grad_scores(skip, Masked());
        else
          grad_scores(skip, Plain());
        pack();
        for (int i = skip + 1; i < e1; ++i) step(i, Masked());
        for (int i = max(e1, skip + 1); i < e2; ++i) step(i, Plain());
        for (int i = max(e2, skip + 1); i < n_t; ++i) step(i, Masked());
        // Drain: the dV / dK products of the last tile.
        fence_acc();
        hopper::wgmma_fence();
        issue_rs(n_t - 1);
        hopper::wgmma_wait<0>();
        fence_acc();
        fence_a();
        release(n_t - 1);
      }
      hopper::mbar_arrive(kv_empty + 8 * kb);  // K / V of item it + 2 may load
      n_used += n_t;

      // Epilogue: dk and dv staged in shared memory, then 16-byte row
      // stores; keys past sk are not written.
      hopper::named_sync(1 + wg, 128);  // the last item's staging is read
      stage_acc<TO, D, C::kPitch>(st_k, dk, warp, g, c4);
      stage_acc<TO, D, C::kPitch>(st_v, dv, warp, g, c4);
      hopper::named_sync(1 + wg, 128);  // this warpgroup's staging is full
      const int rows = min(64, p.sk - kw0);
      const long long at = ((long long)bh * p.sk + kw0) * D;
      store_rows<TO, D, C::kPitch>(static_cast<TO*>(p.out0) + at, st_k, rows,
                                   t);
      store_rows<TO, D, C::kPitch>(static_cast<TO*>(p.out1) + at, st_v, rows,
                                   t);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

template <int D>
cudaError_t launch_dq_simt(const BwdParams& p, dim3 grid,
                           cudaStream_t stream) {
  return launch_kernel(flash_bwd_dq_simt_kernel<D>,
                       dq_simt_smem_floats<D>() * (int)sizeof(float), grid,
                       stream, p);
}

template <int D>
cudaError_t launch_dkv_simt(const BwdParams& p, dim3 grid,
                            cudaStream_t stream) {
  return launch_kernel(flash_bwd_dkv_simt_kernel<D>,
                       dkv_simt_smem_floats<D>() * (int)sizeof(float), grid,
                       stream, p);
}

template <typename TO, int D>
cudaError_t launch_dq_mma(const BwdParams& p, dim3 grid, cudaStream_t stream) {
  return launch_kernel(flash_bwd_dq_mma_kernel<TO, D>,
                       4 * BQ * (D + 8) * (int)sizeof(uint16_t), grid, stream,
                       p);
}

template <typename TO, int D>
cudaError_t launch_dkv_mma(const BwdParams& p, dim3 grid,
                           cudaStream_t stream) {
  return launch_kernel(flash_bwd_dkv_mma_kernel<TO, D>,
                       4 * BQ * (D + 8) * (int)sizeof(uint16_t) +
                           2 * BQ * (int)sizeof(float),
                       grid, stream, p);
}

// The tensor maps and scalars of a TMA / wgmma launch: q and do read in
// boxes of ``q_rows`` rows, k and v of ``k_rows``; ``n_tiles`` tiles of
// ``tile_rows`` rows along the item axis (q for dq, k for dk/dv).
cudaError_t make_wg(WgParams* w, const BwdParams& p, int b, int d, int q_rows,
                    int k_rows, int tile_rows, int axis_len) {
  cudaError_t err = hopper::bf16_map(&w->tq, p.q, b, p.h, p.sq, d, p.q_sb,
                                     p.q_sh, p.q_ss, q_rows);
  if (err == cudaSuccess)
    err = hopper::bf16_map(&w->tdo, p.dout, b, p.h, p.sq, d, p.o_sb, p.o_sh,
                           p.o_ss, q_rows);
  if (err == cudaSuccess)
    err = hopper::bf16_map(&w->tk, p.k, b, p.h, p.sk, d, p.k_sb, p.k_sh,
                           p.k_ss, k_rows);
  if (err == cudaSuccess)
    err = hopper::bf16_map(&w->tv, p.v, b, p.h, p.sk, d, p.v_sb, p.v_sh,
                           p.v_ss, k_rows);
  if (err != cudaSuccess) return err;
  w->lse = p.lse;
  w->delta = p.delta;
  w->h = p.h;
  w->sq = p.sq;
  w->sk = p.sk;
  w->causal = p.causal;
  w->q_offset = p.q_offset;
  w->k_offset = p.k_offset;
  w->scale = p.scale;
  w->scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  w->n_tiles = (axis_len + tile_rows - 1) / tile_rows;
  w->n_items = w->n_tiles * b * p.h;
  return cudaSuccess;
}

template <typename P>
cudaError_t launch_persistent(void (*kernel)(P), int smem, const P& w,
                              cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  return launch_kernel(kernel, smem, dim3(min(w.n_items, sms)), stream, w,
                       384);
}

template <typename TO, int D>
cudaError_t launch_dq_wgmma(const BwdParams& p, int b, cudaStream_t stream) {
  using C = DqCfg<TO, D>;
  WgParams w;
  const cudaError_t err =
      make_wg(&w, p, b, D, C::kBQ, C::kBK, C::kBQ, p.sq);
  if (err != cudaSuccess) return err;
  w.out0 = p.dq;
  w.out1 = nullptr;
  return launch_persistent(flash_bwd_dq_wgmma_kernel<TO, D>, C::kBytes, w,
                           stream);
}

template <typename TO>
cudaError_t launch_dkv_wgmma(const BwdParams& p, int b, cudaStream_t stream) {
  using C = DkvCfg<TO>;
  WgParams w;
  const cudaError_t err =
      make_wg(&w, p, b, C::D, C::kBQ, C::kBK, C::kBK, p.sk);
  if (err != cudaSuccess) return err;
  w.out0 = p.dk;
  w.out1 = p.dv;
  return launch_persistent(flash_bwd_dkv_wgmma_kernel<TO, 64>, C::kBytes, w,
                           stream);
}

template <typename TO>
cudaError_t route_dq(const BwdParams& p, int b, int d, dim3 grid,
                     cudaStream_t st) {
  switch (d) {
    case 16: return launch_dq_mma<TO, 16>(p, grid, st);
    case 32: return launch_dq_mma<TO, 32>(p, grid, st);
    case 64: return launch_dq_wgmma<TO, 64>(p, b, st);
    case 128: return launch_dq_wgmma<TO, 128>(p, b, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TO>
cudaError_t route_dkv(const BwdParams& p, int b, int d, dim3 grid,
                      cudaStream_t st) {
  switch (d) {
    case 16: return launch_dkv_mma<TO, 16>(p, grid, st);
    case 32: return launch_dkv_mma<TO, 32>(p, grid, st);
    case 64: return launch_dkv_wgmma<TO>(p, b, st);
    case 128: return launch_dkv_mma<TO, 128>(p, grid, st);
    default: return cudaErrorInvalidValue;
  }
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

// The TMA / wgmma routes read q, k, v and do through tensor maps: 16-byte
// aligned bases, strides that are multiples of 8 elements.
bool needs_tma(int d, bool dkv) { return dkv ? d == 64 : d == 64 || d == 128; }

// Whether (input dtype, output dtype) is a pair the kernels write: f32 in,
// f32 out; bf16 in, f32 or bf16 out.
bool dtypes_ok(int dtype, int out_dtype) {
  return dtype == 0 ? out_dtype == 0
                    : dtype == 1 && (out_dtype == 0 || out_dtype == 1);
}

}  // namespace

// Routes, by input type and head dim:
//   bf16, d = 64: flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_wgmma_kernel;
//   bf16, d = 128: flash_bwd_dq_wgmma_kernel and flash_bwd_dkv_mma_kernel;
//   bf16, d = 16 or 32: the mma.sync kernels; f32: the FMA kernels.
// The TMA routes need q, k, v and do with 16-byte aligned bases and strides
// that are multiples of 8 elements (the wrapper copies other inputs).
// dtype tags: 0 = float32, 1 = bfloat16 (q, k, v and do share it);
// out_dtype: 0 = float32, 1 = bfloat16 (bf16 inputs only), rounded to
// nearest even from the f32 accumulators. Pointers and the stream come in
// as void*; strides (in elements) are those of q, k, v and do over (batch,
// head, seq), the head dimension's stride must be 1. lse and delta are
// contiguous f32 (b, h, sq); the outputs contiguous (b, h, s, d) and b, h,
// sq, sk all positive. Each returns the cudaError_t of its launch (0 on
// success).
extern "C" int autodist_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int h, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int q_offset, int k_offset, int dtype,
    int out_dtype, void* stream) {
  if (!dtypes_ok(dtype, out_dtype)) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  BwdParams p = make_params(q, k, v, dout, lse, delta, h, sq, sk, d, strides,
                            causal, q_offset, k_offset, dtype);
  p.dq = dq;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 16: return (int)launch_dq_simt<16>(p, grid, st);
      case 32: return (int)launch_dq_simt<32>(p, grid, st);
      case 64: return (int)launch_dq_simt<64>(p, grid, st);
      case 128: return (int)launch_dq_simt<128>(p, grid, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (needs_tma(d, false) && !p.vec) return (int)cudaErrorInvalidValue;
  return (int)(out_dtype == 0
                   ? route_dq<float>(p, b, d, grid, st)
                   : route_dq<__nv_bfloat16>(p, b, d, grid, st));
}

extern "C" int autodist_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int h,
    int sq, int sk, int d, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int causal, int q_offset, int k_offset, int dtype,
    int out_dtype, void* stream) {
  if (!dtypes_ok(dtype, out_dtype)) return (int)cudaErrorInvalidValue;
  const long long strides[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                 v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  BwdParams p = make_params(q, k, v, dout, lse, delta, h, sq, sk, d, strides,
                            causal, q_offset, k_offset, dtype);
  p.dk = dk;
  p.dv = dv;
  const dim3 grid((sk + BK - 1) / BK, b * h);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 16: return (int)launch_dkv_simt<16>(p, grid, st);
      case 32: return (int)launch_dkv_simt<32>(p, grid, st);
      case 64: return (int)launch_dkv_simt<64>(p, grid, st);
      case 128: return (int)launch_dkv_simt<128>(p, grid, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (needs_tma(d, true) && !p.vec) return (int)cudaErrorInvalidValue;
  return (int)(out_dtype == 0
                   ? route_dkv<float>(p, b, d, grid, st)
                   : route_dkv<__nv_bfloat16>(p, b, d, grid, st));
}
