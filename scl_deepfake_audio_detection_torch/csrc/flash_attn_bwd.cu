// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, as on the TPU, so that no output needs atomics and dq, dk and
// dv are deterministic:
// - flash_attn_bwd_dq replaces `_flash_bwd_dq_kernel` (launched by
//   `_flash_backward`, scl_deepfake_audio_detection_tpu/ops/attention.py):
//   one block per (batch*head, 64-row q tile) streams 64-key K/V tiles;
//   P = exp(S - L), dP = dO V^T, dS = P * (dP - D) rounded to K's dtype,
//   dq = dS K with fp32 accumulation.
// - flash_attn_bwd_dkv replaces `_flash_bwd_dkv_kernel` (same launcher):
//   one block per (batch*head, 64-key tile) streams 64-row q/dO tiles in the
//   transposed frame; P^T = exp(S^T - L), dV = P^T dO (P^T in dO's dtype),
//   dP^T = V dO^T, dS^T = P^T * (dP^T - D) in q's dtype, dK = dS^T Q.
// L is the forward's per-row logsumexp and D = rowsum(dO * O) in fp32; the
// caller computes D (an elementwise product and a reduction, which XLA also
// ran outside the Pallas kernels).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the XLS-R 300M train
// shape [22 * 16, 199, 64] bf16: dq reads q, dO, K, V, L, D and writes dq
// (45.4 MB, 13.6 us) for 6 * BH * T^2 * D = 5.35 GFLOP (5.4 us); dkv reads
// q, dO, K, V, L, D and writes dK, dV (54.4 MB, 16.2 us) for 8 * BH * T^2 * D
// = 7.14 GFLOP (7.2 us).  Both are memory-bound.  S, P and dS never leave
// the chip, and every input tile leaves device memory once per block that
// streams it.
//
// Two bodies, one contract (as csrc/flash_attn_fwd.cu):
// - bf16 (the training path): mma.sync m16n8k16 with fp32 accumulation.
//   Four warps own 16 rows each.  The S and dP accumulators have the layout
//   of the A operand of the next product, so P and dS are rounded to bf16 in
//   registers and never staged.  The B operands that need the tile's
//   columns (K in dq = dS K, dO and Q in dkv) are gathered two bf16 values at
//   a time from the row-major tile in shared memory.
// - fp32 (the golden checks and tests): scalar FMA from shared memory.
// TMA staging, wgmma and ldmatrix are later work.
//
// Layout: q, k, v, dout, dq, dk, dv are [BH, T, D] contiguous; lse and delta
// are [BH, T] fp32.  The kernels mask q rows >= T and keys >= kv_len
// themselves; the caller pads nothing.  Rows of dK and dV at keys >= kv_len
// are written as exact zeros.  D is a multiple of 8 up to 128; bf16 pointers
// are 16-byte aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fp32 bodies

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block, seen as a 16 x 16 grid
constexpr int TG = 16;        // side of that thread grid
constexpr int RPT = BQ / TG;  // tile rows per thread
constexpr int CPT = BK / TG;  // tile columns per thread in the score products
static_assert(BQ == BK, "the fp32 bodies index q and key tiles alike");

// Rows [r0, r0 + 64) of a [nrows, d] fp32 matrix into dst [64][d + 1]; rows
// >= nrows are zero.
__device__ __forceinline__ void stage_f32(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int nrows, int d, int tid) {
  const int dp = d + 1;
  for (int i = tid; i < 64 * d; i += NT) {
    const int r = i / d, c = i % d;
    dst[r * dp + c] = (r0 + r < nrows) ? src[(size_t)(r0 + r) * d + c] : 0.f;
  }
}

// NJ = ceil(D / 16): output columns per thread.
template <int NJ>
__global__ void __launch_bounds__(NT)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, int t, int d, int kv_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;                  // [BQ][dp]
  float* gs = qs + BQ * dp;          // [BQ][dp] dO
  float* ks = gs + BQ * dp;          // [BK][dp]
  float* vs = ks + BK * dp;          // [BK][dp]
  float* ps = vs + BK * dp;          // [BQ][BK + 1] dS
  float* l_s = ps + BQ * (BK + 1);   // [BQ] L (+inf past T)
  float* d_s = l_s + BQ;             // [BQ] D (0 past T)

  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * t * d;
  const size_t sbase = (size_t)blockIdx.y * t;
  const int n_kv = min(kv_len, t);

  stage_f32(qs, q + base, q0, t, d, tid);
  stage_f32(gs, dout + base, q0, t, d, tid);
  if (tid < BQ) {
    const bool live = q0 + tid < t;
    l_s[tid] = live ? lse[sbase + q0 + tid] : INFINITY;
    d_s[tid] = live ? delta[sbase + q0 + tid] : 0.f;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // q, dO and stats staged; the previous dS and K consumed
    stage_f32(ks, k + base, k0, n_kv, d, tid);
    stage_f32(vs, v + base, k0, n_kv, d, tid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: thread (ty, tx) owns rows ty + 16 i, keys tx + 16 j.
    float s[RPT][CPT], dpv[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < d; ++c) {
      float qv[RPT], gv[RPT], kv[CPT], vv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = qs[(ty + TG * i) * dp + c];
        gv[i] = gs[(ty + TG * i) * dp + c];
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        kv[j] = ks[(tx + TG * j) * dp + c];
        vv[j] = vs[(tx + TG * j) * dp + c];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dpv[i][j] = fmaf(gv[i], vv[j], dpv[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TG * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + TG * j;
        const float p = (k0 + col < n_kv) ? expf(s[i][j] - l_s[r]) : 0.f;
        ps[r * (BK + 1) + col] = p * (dpv[i][j] - d_s[r]);
      }
    }
    __syncthreads();

    // dq += dS K: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j.
    const int kmax = min(BK, n_kv - k0);
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ps[(ty + TG * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + TG * j;
        const float kk = col < d ? ks[c * dp + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TG * i;
    if (q0 + r >= t) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + TG * j;
      if (col < d) dq[base + (size_t)(q0 + r) * d + col] = acc[i][j];
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(NT)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, int t, int d,
                   int kv_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* ks = smem;                  // [BK][dp]
  float* vs = ks + BK * dp;          // [BK][dp]
  float* qs = vs + BK * dp;          // [BQ][dp]
  float* gs = qs + BQ * dp;          // [BQ][dp] dO
  float* pt = gs + BQ * dp;          // [BK][BQ + 1] P^T
  float* st = pt + BK * (BQ + 1);    // [BK][BQ + 1] dS^T
  float* l_s = st + BK * (BQ + 1);   // [BQ]
  float* d_s = l_s + BQ;             // [BQ]

  const int tid = threadIdx.x, tx = tid % TG, ty = tid / TG;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)blockIdx.y * t * d;
  const size_t sbase = (size_t)blockIdx.y * t;
  const int n_kv = min(kv_len, t);

  float ak[RPT][NJ], av[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  if (k0 < n_kv) {  // a tile of dead keys keeps its zero gradients
    stage_f32(ks, k + base, k0, n_kv, d, tid);
    stage_f32(vs, v + base, k0, n_kv, d, tid);
    for (int q0 = 0; q0 < t; q0 += BQ) {
      __syncthreads();  // K, V staged; the previous q tile consumed
      stage_f32(qs, q + base, q0, t, d, tid);
      stage_f32(gs, dout + base, q0, t, d, tid);
      if (tid < BQ) {
        const bool live = q0 + tid < t;
        l_s[tid] = live ? lse[sbase + q0 + tid] : INFINITY;
        d_s[tid] = live ? delta[sbase + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: thread (ty, tx) owns keys ty + 16 i,
      // q rows tx + 16 j.
      float s[RPT][CPT], dpv[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = dpv[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < d; ++c) {
        float kv[RPT], vv[RPT], qv[CPT], gv[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          kv[i] = ks[(ty + TG * i) * dp + c];
          vv[i] = vs[(ty + TG * i) * dp + c];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          qv[j] = qs[(tx + TG * j) * dp + c];
          gv[j] = gs[(tx + TG * j) * dp + c];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dpv[i][j] = fmaf(vv[i], gv[j], dpv[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = ty + TG * i;
        const bool live = k0 + r < n_kv;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int col = tx + TG * j;
          const float p = live ? expf(s[i][j] - l_s[col]) : 0.f;
          pt[r * (BQ + 1) + col] = p;
          st[r * (BQ + 1) + col] = p * (dpv[i][j] - d_s[col]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: thread (ty, tx) owns keys ty + 16 i,
      // columns tx + 16 j.
      const int qmax = min(BQ, t - q0);
#pragma unroll 4
      for (int c = 0; c < qmax; ++c) {
        float pv[RPT], sv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          pv[i] = pt[(ty + TG * i) * (BQ + 1) + c];
          sv[i] = st[(ty + TG * i) * (BQ + 1) + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + TG * j;
          const float gg = col < d ? gs[c * dp + col] : 0.f;
          const float qq = col < d ? qs[c * dp + col] : 0.f;
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            av[i][j] = fmaf(pv[i], gg, av[i][j]);
            ak[i][j] = fmaf(sv[i], qq, ak[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = k0 + ty + TG * i;
    if (r >= t) continue;
    const bool live = r < n_kv;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + TG * j;
      if (col < d) {
        dk[base + (size_t)r * d + col] = live ? ak[i][j] : 0.f;
        dv[base + (size_t)r * d + col] = live ? av[i][j] : 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 bodies

constexpr int MR = 64;   // rows of the block's own tile: 4 warps x 16 rows
constexpr int MS = 64;   // rows of each streamed tile
constexpr int MT = 128;  // threads per block
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values one column apart in consecutive rows: lo in the low half.
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment), fp32 sum.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + 64) of a [nrows, d] matrix into dst [64][DP + 8], 16 bytes a
// thread; rows >= nrows and columns >= d are zero.
template <int DP>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int r0, int nrows, int d, int tid) {
  constexpr int C8 = DP / 8;
  for (int i = tid; i < 64 * C8; i += MT) {
    const int r = i / C8, c = (i % C8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = val;
  }
}

// A fragments of rows [16 warp, 16 warp + 16) of a staged tile, over the
// whole depth DP.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&f)[DP / 16][4], const bf16* tile,
                                       int warp, int g, int c) {
  constexpr int KS = DP + 8;
  const bf16* row = tile + (warp * 16 + g) * KS + 2 * c;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    f[kk][0] = ld32(row + kk * 16);
    f[kk][1] = ld32(row + 8 * KS + kk * 16);
    f[kk][2] = ld32(row + kk * 16 + 8);
    f[kk][3] = ld32(row + 8 * KS + kk * 16 + 8);
  }
}

// acc [16 x DP] += a (16 x 64, A fragments per 16-row k-step) * tile (a
// staged [64][DP + 8] tile read as the 64 x DP B operand).  B is needed
// down the tile's columns, so each register gathers two rows of one column.
template <int DP>
__device__ __forceinline__ void mma_a_tile(float (&acc)[DP / 8][4],
                                           const uint32_t (&a)[MS / 16][4],
                                           const bf16* tile, int g, int c) {
  constexpr int KS = DP + 8;
#pragma unroll
  for (int i = 0; i < MS / 16; ++i) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const bf16* col = tile + (16 * i + 2 * c) * KS + 8 * n + g;
      mma_bf16(acc[n], a[i], pack2(col[0], col[KS]), pack2(col[8 * KS], col[9 * KS]));
    }
  }
}

// [16 x 64] = a (16 x DP fragments) * tile^T (the 64 staged rows as columns),
// as n-tiles of 8 columns.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&out)[MS / 8][4],
                                        const uint32_t (&a)[DP / 16][4],
                                        const bf16* tile, int g, int c) {
  constexpr int KS = DP + 8;
#pragma unroll
  for (int j = 0; j < MS / 8; ++j) {
    out[j][0] = out[j][1] = out[j][2] = out[j][3] = 0.f;
    const bf16* row = tile + (8 * j + g) * KS + 2 * c;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      mma_bf16(out[j], a[kk], ld32(row + kk * 16), ld32(row + kk * 16 + 8));
  }
}

// DP = D rounded up to 16 (the product depth); the padding columns are zero.
//
// mma.sync m16n8k16 fragments, with g = lane / 4 and c = lane % 4:
//   A (16x16): regs {row g, k 2c..2c+1}, {row g+8, same}, {row g, k 2c+8..},
//              {row g+8, k 2c+8..};
//   B (16x8):  regs {k 2c..2c+1, n g}, {k 2c+8..2c+9, n g};
//   C (16x8):  {row g, n 2c}, {row g, n 2c+1}, {row g+8, n 2c}, {row g+8, n 2c+1}.
// n-tiles 2i and 2i + 1 of a C result are k-step i of an A operand.
template <int DP>
__global__ void __launch_bounds__(MT)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dq, int t, int d, int kv_len) {
  constexpr int NKK = DP / 16, NS = MS / 8, NO = DP / 8;
  __shared__ __align__(16) bf16 ks[MS * (DP + 8)];
  __shared__ __align__(16) bf16 vs[MS * (DP + 8)];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * MR;
  const size_t base = (size_t)blockIdx.y * t * d;
  const size_t sbase = (size_t)blockIdx.y * t;
  const int n_kv = min(kv_len, t);

  // q and dO through the K and V buffers into registers, once.
  stage_tile<DP>(ks, q + base, q0, t, d, tid);
  stage_tile<DP>(vs, dout + base, q0, t, d, tid);
  __syncthreads();
  uint32_t qf[NKK][4], gf[NKK][4];
  load_a<DP>(qf, ks, warp, g, c);
  load_a<DP>(gf, vs, warp, g, c);

  // this thread's two rows, g and g + 8; rows past T get P = 0
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float l0 = r0 < t ? lse[sbase + r0] : INFINITY;
  const float l1 = r1 < t ? lse[sbase + r1] : INFINITY;
  const float d0 = r0 < t ? delta[sbase + r0] : 0.f;
  const float d1 = r1 < t ? delta[sbase + r1] : 0.f;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += MS) {
    __syncthreads();  // fragments taken; the previous tile is consumed
    stage_tile<DP>(ks, k + base, k0, n_kv, d, tid);
    stage_tile<DP>(vs, v + base, k0, n_kv, d, tid);
    __syncthreads();

    float s[NS][4], dp[NS][4];
    mma_abt<DP>(s, qf, ks, g, c);
    mma_abt<DP>(dp, gf, vs, g, c);

    // dS = P * (dP - D), rounded to bf16 as the A operand of dS K.
    uint32_t dsf[MS / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = k0 + 8 * j + 2 * c + e < n_kv;
        const float p0 = live ? expf(s[j][e] - l0) : 0.f;
        const float p1 = live ? expf(s[j][2 + e] - l1) : 0.f;
        ds[e] = p0 * (dp[j][e] - d0);
        ds[2 + e] = p1 * (dp[j][2 + e] - d1);
      }
      dsf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
      dsf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_a_tile<DP>(acc, dsf, ks, g, c);
  }

#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= d) break;
    const int col = 8 * n + 2 * c;
    if (r0 < t)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)r0 * d + col) =
          pack_bf16(acc[n][0], acc[n][1]);
    if (r1 < t)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)r1 * d + col) =
          pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <int DP>
__global__ void __launch_bounds__(MT)
bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int t, int d,
                    int kv_len) {
  constexpr int NKK = DP / 16, NS = MS / 8, NO = DP / 8;
  __shared__ __align__(16) bf16 qs[MS * (DP + 8)];
  __shared__ __align__(16) bf16 gs[MS * (DP + 8)];
  __shared__ float l_s[MS];
  __shared__ float d_s[MS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = blockIdx.x * MR;
  const size_t base = (size_t)blockIdx.y * t * d;
  const size_t sbase = (size_t)blockIdx.y * t;
  const int n_kv = min(kv_len, t);
  // this thread's two keys, g and g + 8
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const bool live0 = r0 < n_kv, live1 = r1 < n_kv;

  float ak[NO][4], av[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  if (k0 < n_kv) {  // a tile of dead keys keeps its zero gradients
    // K and V through the q and dO buffers into registers, once.
    stage_tile<DP>(qs, k + base, k0, n_kv, d, tid);
    stage_tile<DP>(gs, v + base, k0, n_kv, d, tid);
    __syncthreads();
    uint32_t kf[NKK][4], vf[NKK][4];
    load_a<DP>(kf, qs, warp, g, c);
    load_a<DP>(vf, gs, warp, g, c);

    for (int q0 = 0; q0 < t; q0 += MS) {
      __syncthreads();  // fragments taken; the previous q tile is consumed
      stage_tile<DP>(qs, q + base, q0, t, d, tid);
      stage_tile<DP>(gs, dout + base, q0, t, d, tid);
      if (tid < MS) {
        const bool live = q0 + tid < t;
        l_s[tid] = live ? lse[sbase + q0 + tid] : INFINITY;
        d_s[tid] = live ? delta[sbase + q0 + tid] : 0.f;
      }
      __syncthreads();

      // P^T = exp(S^T - L) over this thread's keys and the tile's q rows
      // 8 j + 2 c + e; dV += P^T dO with P^T rounded to bf16.
      float p[NS][4];
      mma_abt<DP>(p, kf, qs, g, c);
      uint32_t pf[MS / 16][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = l_s[8 * j + 2 * c + e];
          p[j][e] = live0 ? expf(p[j][e] - l) : 0.f;
          p[j][2 + e] = live1 ? expf(p[j][2 + e] - l) : 0.f;
        }
        pf[j / 2][(j % 2) * 2] = pack_bf16(p[j][0], p[j][1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
      }
      mma_a_tile<DP>(av, pf, gs, g, c);

      // dS^T = P^T * (dP^T - D) with dP^T = V dO^T; dK += dS^T Q.
      float dp[NS][4];
      mma_abt<DP>(dp, vf, gs, g, c);
      uint32_t sf[MS / 16][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dd = d_s[8 * j + 2 * c + e];
          ds[e] = p[j][e] * (dp[j][e] - dd);
          ds[2 + e] = p[j][2 + e] * (dp[j][2 + e] - dd);
        }
        sf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      mma_a_tile<DP>(ak, sf, qs, g, c);
    }
  }

  const bf16 zero = __float2bfloat16(0.f);
  const uint32_t zz = pack2(zero, zero);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= d) break;
    const int col = 8 * n + 2 * c;
    if (r0 < t) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)r0 * d + col) =
          live0 ? pack_bf16(ak[n][0], ak[n][1]) : zz;
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)r0 * d + col) =
          live0 ? pack_bf16(av[n][0], av[n][1]) : zz;
    }
    if (r1 < t) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)r1 * d + col) =
          live1 ? pack_bf16(ak[n][2], ak[n][3]) : zz;
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)r1 * d + col) =
          live1 ? pack_bf16(av[n][2], av[n][3]) : zz;
    }
  }
}

// ---------------------------------------------------------------- launchers

size_t dq_f32_smem(int d) {
  return sizeof(float) * ((size_t)4 * 64 * (d + 1) + (size_t)BQ * (BK + 1) + 2 * BQ);
}

size_t dkv_f32_smem(int d) {
  return sizeof(float) * ((size_t)4 * 64 * (d + 1) + (size_t)2 * BK * (BQ + 1) + 2 * BQ);
}

template <int NJ>
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v, const float* g,
                          const float* lse, const float* delta, float* dq, int bh, int t,
                          int d, int kv_len, cudaStream_t stream) {
  const size_t smem = dq_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  bwd_dq_f32_kernel<NJ><<<grid, NT, smem, stream>>>(q, k, v, g, lse, delta, dq, t, d, kv_len);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_dkv_f32(const float* q, const float* k, const float* v, const float* g,
                           const float* lse, const float* delta, float* dk, float* dv,
                           int bh, int t, int d, int kv_len, cudaStream_t stream) {
  const size_t smem = dkv_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BK - 1) / BK, bh);
  bwd_dkv_f32_kernel<NJ><<<grid, NT, smem, stream>>>(q, k, v, g, lse, delta, dk, dv, t, d,
                                                     kv_len);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                           const float* lse, const float* delta, bf16* dq, int bh, int t,
                           int d, int kv_len, cudaStream_t stream) {
  const dim3 grid((t + MR - 1) / MR, bh);
  bwd_dq_bf16_kernel<DP><<<grid, MT, 0, stream>>>(q, k, v, g, lse, delta, dq, t, d, kv_len);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                            const float* lse, const float* delta, bf16* dk, bf16* dv,
                            int bh, int t, int d, int kv_len, cudaStream_t stream) {
  const dim3 grid((t + MR - 1) / MR, bh);
  bwd_dkv_bf16_kernel<DP><<<grid, MT, 0, stream>>>(q, k, v, g, lse, delta, dk, dv, t, d,
                                                   kv_len);
  return cudaGetLastError();
}

// One case per D rounded up to 16: NJ = D16 / 16 for fp32, DP = D16 for bf16.
#define DISPATCH_D(d, CASE)               \
  switch (((d) + 15) / 16) {              \
    case 1: CASE(1, 16);                  \
    case 2: CASE(2, 32);                  \
    case 3: CASE(3, 48);                  \
    case 4: CASE(4, 64);                  \
    case 5: CASE(5, 80);                  \
    case 6: CASE(6, 96);                  \
    case 7: CASE(7, 112);                 \
    case 8: CASE(8, 128);                 \
    default: return cudaErrorInvalidValue; \
  }

bool bad_shape(int bh, int t, int d, int kv_len) {
  return d <= 0 || d > 128 || d % 8 != 0 || t <= 0 || bh <= 0 || bh > 65535 || kv_len <= 0;
}

}  // namespace

// Both return a cudaError_t: 0 when the launch was accepted.  dtype 0 =
// fp32, 1 = bf16.  The Python wrapper validates shapes, dtypes, alignment
// and devices.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int bh, int t, int d, int kv_len, int dtype,
                                 void* stream) {
  if (bad_shape(bh, t, d, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fg = static_cast<const float*>(dout);
    float* fdq = static_cast<float*>(dq);
#define CASE(nj, dp) return (int)launch_dq_f32<nj>(fq, fk, fv, fg, l, dl, fdq, bh, t, d, kv_len, s)
    DISPATCH_D(d, CASE)
#undef CASE
  }
  if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v), *bg = static_cast<const bf16*>(dout);
    bf16* bdq = static_cast<bf16*>(dq);
#define CASE(nj, dp) return (int)launch_dq_bf16<dp>(bq, bk, bv, bg, l, dl, bdq, bh, t, d, kv_len, s)
    DISPATCH_D(d, CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int bh, int t, int d, int kv_len,
                                  int dtype, void* stream) {
  if (bad_shape(bh, t, d, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fg = static_cast<const float*>(dout);
    float *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
#define CASE(nj, dp) \
  return (int)launch_dkv_f32<nj>(fq, fk, fv, fg, l, dl, fdk, fdv, bh, t, d, kv_len, s)
    DISPATCH_D(d, CASE)
#undef CASE
  }
  if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v), *bg = static_cast<const bf16*>(dout);
    bf16 *bdk = static_cast<bf16*>(dk), *bdv = static_cast<bf16*>(dv);
#define CASE(nj, dp) \
  return (int)launch_dkv_bf16<dp>(bq, bk, bv, bg, l, dl, bdk, bdv, bh, t, d, kv_len, s)
    DISPATCH_D(d, CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
