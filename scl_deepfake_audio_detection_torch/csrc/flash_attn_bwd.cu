// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Two kernels, as on the TPU, so that no output needs atomics and dq, dk and
// dv are deterministic:
// - flash_attn_bwd_dq replaces `_flash_bwd_dq_kernel` (launched by
//   `_flash_backward`, scl_deepfake_audio_detection_tpu/ops/attention.py):
//   one block per (batch*head, 64-row q tile) first sums D = rowsum(dO * O)
//   in fp32 from its dO and O tiles and writes it out, then streams 64-key
//   K/V tiles; P = exp(S - L), dP = dO V^T, dS = P * (dP - D) rounded to K's
//   dtype, dq = dS K with fp32 accumulation.
// - flash_attn_bwd_dkv replaces `_flash_bwd_dkv_kernel` (same launcher):
//   one block per (batch*head, 64-key tile) streams 64-row q/dO tiles in the
//   transposed frame; P^T = exp(S^T - L), dV = P^T dO (P^T in dO's dtype),
//   dP^T = V dO^T, dS^T = P^T * (dP^T - D) in q's dtype, dK = dS^T Q.
// L is the forward's per-row logsumexp.  dk/dv reads the D that dq wrote, so
// it is launched after dq on the same stream.  (The JAX package computed D
// outside its kernels and left the product and reduction to XLA to fuse;
// eager PyTorch would run them as four launches of their own.)
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the XLS-R 300M train
// shape [22 * 16, 199, 64] bf16: dq reads q, dO, O, K, V, L and writes dq
// and D (54.4 MB, 16.2 us) for 6 * BH * T^2 * D = 5.35 GFLOP (5.4 us); dkv
// reads q, dO, K, V, L, D and writes dK, dV (54.4 MB, 16.2 us) for
// 8 * BH * T^2 * D = 7.14 GFLOP (7.2 us).  Both are memory-bound.  S, P and
// dS never leave the chip, and every input tile leaves device memory once
// per block that streams it.
//
// Two bodies, one contract (as csrc/flash_attn_fwd.cu):
// - bf16 (the training path), both kernels designed for Hopper: TMA staging
//   into a ring, wgmma for every product with the S and dP accumulators
//   rounded to bf16 in registers as the register operand of the next
//   product, and the operands needed down a tile's columns read as MN-major
//   wgmma operands straight from their TMA tiles (see bwd_dq_bf16_kernel
//   and bwd_dkv_bf16_kernel).
// - fp32 (the golden checks and tests): scalar FMA from shared memory.
//
// Layout: q, k, v, o, dout, dq, dk, dv are [BH, T, D] contiguous; lse and
// delta are [BH, T] fp32.  The kernels mask q rows >= T and keys >= kv_len
// themselves; the caller pads nothing.  Rows of dK and dV at keys >= kv_len
// are written as exact zeros.  D is a multiple of 8 up to 128; bf16 pointers
// are 16-byte aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  float* __restrict__ delta, float* __restrict__ dq, int t, int d,
                  int kv_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* qs = smem;                  // [BQ][dp]
  float* gs = qs + BQ * dp;          // [BQ][dp] dO
  float* ks = gs + BQ * dp;          // [BK][dp]; O until D is summed
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
  stage_f32(ks, o + base, q0, t, d, tid);
  if (tid < BQ) l_s[tid] = q0 + tid < t ? lse[sbase + q0 + tid] : INFINITY;
  __syncthreads();
  // D = rowsum(dO * O), one row a thread, out to global memory for dk/dv
  if (tid < BQ) {
    float sum = 0.f;
    for (int c = 0; c < d; ++c) sum = fmaf(gs[tid * dp + c], ks[tid * dp + c], sum);
    const bool live = q0 + tid < t;
    d_s[tid] = live ? sum : 0.f;
    if (live) delta[sbase + q0 + tid] = sum;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // L and D stored, O summed; the previous dS and K consumed
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
constexpr int MT = 128;  // threads per block: one warpgroup
constexpr float LOG2E = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc + the dot product of 8 bf16 values at a with 8 at b (16 bytes each, in
// shared memory), in fp32: each product of two bf16 values is exact in fp32.
__device__ __forceinline__ float dot8(const uint8_t* a, const uint8_t* b, float acc) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fx = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(fx.x, fy.x, acc);
    acc = fmaf(fx.y, fy.y, acc);
  }
  return acc;
}

// dq, designed for Hopper, with D = rowsum(dO * O) computed on the way.  One
// warpgroup per (batch*head, 64-row q tile), no atomics.
// - Copies: the block's q, dO and O tiles arrive once by TMA; the head's K
//   and V tiles stream through a ring of DQ_STAGES slots by TMA, so tile
//   j + 1 is in flight while tile j is multiplied.  O is needed only for D,
//   so it lands in slot 1's K tile, and tile 1 follows once D is summed:
//   six tiles of shared memory instead of seven fit four blocks on an SM at
//   D <= 64 instead of three (9 % faster at the train shape, PERF.md).  L
//   (fp32 rows of T values, not 16-byte aligned per head as TMA needs)
//   comes by plain loads.
// - D: each thread owns rows g and g + 8 of its warp, as the wgmma
//   accumulators lay them out; it sums dO * O in fp32 over every fourth
//   16-byte chunk of those rows in the swizzled tiles, and its quad adds the
//   four partial sums.  D stays in registers for the thread's dS and goes
//   out to global memory for dk/dv.
// - Products, all wgmma: S = q K^T and dP = dO V^T with both operands in
//   shared memory (q, K, dO, V all K-major), committed as two groups, so
//   P = exp(S - L) is computed while dP is still on the tensor cores (5 %
//   faster, PERF.md; `pin` holds S and dP in place across the waits); dq +=
//   dS K with dS rounded to bf16 in registers from the accumulators and K
//   read as an MN-major operand straight from its TMA tile, so no operand
//   is gathered column by column.
// - Masking: rows past T take L = +inf (P = 0) and D = 0, never TMA's zero
//   fill of L; keys >= kv_len take P = 0; n8 blocks and k16 steps that hold
//   only dead keys are skipped, and a warp whose 16 rows all lie past T
//   takes no exponentials.  dq leaves through the q tile (free after the
//   last S) and a TMA store, which drops the rows past T and columns past D.
constexpr int DQ_STAGES = 2;

template <int DP>
constexpr size_t dq_smem_bytes() {
  // q and dO tiles, then per slot a K and a V tile (O in slot 1's K tile)
  return (size_t)(2 + 2 * DQ_STAGES) * ((DP + 63) / 64) * hopper::TILE_BYTES + 1024;
}

// D <= 64 fits four blocks on an SM (at most 128 registers a thread).
template <int DP>
__global__ void __launch_bounds__(MT, DP <= 64 ? 4 : 1)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap omap,
                   const __grid_constant__ CUtensorMap gmap,
                   const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
                   float* __restrict__ delta, int t, int d, int n_kv) {
  using namespace hopper;
  constexpr int NC = (DP + 63) / 64;     // 64-column chunks of a tile
  constexpr int TILE = NC * TILE_BYTES;  // one 64-row tile over the whole depth
  constexpr int NKS = DP / 16;           // k16 steps of the score products
  constexpr int NS = 8;                  // n8 blocks of a 64-key score tile
  constexpr int NO = 32 * NC;            // dq accumulators: 64 rows x 64 NC
  constexpr int N16 = DP / 8;            // 16-byte chunks of a row up to DP
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[DQ_STAGES];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* gs = qs + TILE;                // dO
  uint8_t* ks = gs + TILE;                // [DQ_STAGES] K tiles
  uint8_t* vs = ks + DQ_STAGES * TILE;    // [DQ_STAGES] V tiles
  uint8_t* os = ks + TILE;                // O, in slot 1's K tile until D is summed

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * MR, bh = blockIdx.y;
  const int n_kt = (n_kv + MS - 1) / MS;
  // this thread's two rows of the tile, rr and rr + 8
  const int rr = warp * 16 + g, r0 = q0 + rr, r1 = r0 + 8;
  const bool warp_dead = q0 + warp * 16 >= t;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) mbar_init(&kv_full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();  // barriers ready
  auto load_kv_tile = [&](int j, int s) {
    mbar_expect_tx(&kv_full[s], 2 * TILE);
    tma_load_rows<NC>(ks + s * TILE, &kmap, &kv_full[s], MS * j, bh);
    tma_load_rows<NC>(vs + s * TILE, &vmap, &kv_full[s], MS * j, bh);
  };
  if (tid == 0) {
    mbar_expect_tx(&q_full, 3 * TILE);
    tma_load_rows<NC>(qs, &qmap, &q_full, q0, bh);
    tma_load_rows<NC>(gs, &gmap, &q_full, q0, bh);
    tma_load_rows<NC>(os, &omap, &q_full, q0, bh);
    load_kv_tile(0, 0);
  }
  // L log2(e) of this thread's rows; rows past T take +inf, so P = 0
  const float l0 = r0 < t ? lse[(size_t)bh * t + r0] * LOG2E : INFINITY;
  const float l1 = r1 < t ? lse[(size_t)bh * t + r1] * LOG2E : INFINITY;
  mbar_wait(&q_full, 0);

  // D = rowsum(dO * O): chunks c, c + 4, ... of rows rr and rr + 8 (TMA
  // zero-filled the columns past D), then the sum over the quad
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int i = 0; i < (N16 + 3) / 4; ++i) {
    const int col = 8 * (c + 4 * i);
    if (col < DP) {
      d0 = dot8(gs + swizzled(rr, col), os + swizzled(rr, col), d0);
      d1 = dot8(gs + swizzled(rr + 8, col), os + swizzled(rr + 8, col), d1);
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  d0 = r0 < t ? d0 : 0.f;
  d1 = r1 < t ? d1 : 0.f;
  __syncthreads();  // every thread has read O: slot 1 is free
  if (tid == 0 && n_kt > 1) {
    fence_proxy_async();
    load_kv_tile(1, 1);
  }
  if (c == 0) {
    if (r0 < t) delta[(size_t)bh * t + r0] = d0;
    if (r1 < t) delta[(size_t)bh * t + r1] = d1;
  }

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % DQ_STAGES, k0 = MS * j;
    const uint8_t* kt = ks + s * TILE;
    const uint8_t* vt = vs + s * TILE;
    mbar_wait(&kv_full[s], (j / DQ_STAGES) & 1);

    float sacc[32], pacc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)  // the first steps overwrite sacc and pacc
      wgmma_ss_n64(sacc, desc_k(qs, kk), desc_k(kt, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) wgmma_ss_n64(pacc, desc_k(gs, kk), desc_k(vt, kk), kk > 0);
    wgmma_commit();
    pin(pacc);
    wgmma_wait<1>();  // S is done; dP runs on under the exponentials
    pin(sacc);
    // P = exp(S - L) = exp2(S log2 e - L log2 e) in place in sacc; dead keys
    // and the rows of a dead warp give 0
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = k0 + 8 * jj + 2 * c + e < n_kv && !warp_dead;
        sacc[4 * jj + e] = live ? exp2f(fmaf(sacc[4 * jj + e], LOG2E, -l0)) : 0.f;
        sacc[4 * jj + 2 + e] = live ? exp2f(fmaf(sacc[4 * jj + 2 + e], LOG2E, -l1)) : 0.f;
      }
    wgmma_wait<0>();
    pin(pacc);

    // dS = P * (dP - D) over this thread's rows and the tile's keys
    // 8 jj + 2 c + e, rounded to bf16 as the A operand of dS K.  An n8 block
    // of dead keys, or a warp whose rows all lie past T (both uniform across
    // the warp), has dS = 0.
    uint32_t sf[4][4];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      if (k0 + 8 * jj >= n_kv || warp_dead) {
        sf[jj / 2][(jj % 2) * 2] = sf[jj / 2][(jj % 2) * 2 + 1] = 0u;
        continue;
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ds[e] = sacc[4 * jj + e] * (pacc[4 * jj + e] - d0);
        ds[2 + e] = sacc[4 * jj + 2 + e] * (pacc[4 * jj + 2 + e] - d1);
      }
      sf[jj / 2][(jj % 2) * 2] = pack_bf16(ds[0], ds[1]);
      sf[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (k0 + 16 * kk >= n_kv) break;  // dS = 0 for the rest of the tile
      if constexpr (NC == 1)
        wgmma_rs_n64(acc, sf[kk], desc_mn(kt, kk), 1);
      else
        wgmma_rs_n128(acc, sf[kk], desc_mn(kt, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();

    __syncthreads();  // every warp is done with slot s
    if (tid == 0 && j + DQ_STAGES < n_kt) {
      fence_proxy_async();
      load_kv_tile(j + DQ_STAGES, s);
    }
  }

  // dq through the q tile, whose last reader (the last S) is done, then out
  // by TMA, which drops the rows past T and columns past D.
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(qs + swizzled(rr, col)) = pack_bf16(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(qs + swizzled(rr + 8, col)) =
        pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) tma_store_rows<NC>(&dqmap, qs, q0, bh);
}

// dk/dv, designed for Hopper.  One warpgroup per (batch*head, 64-key tile),
// no atomics, as before.
// - Copies: the block's K and V tiles arrive once by TMA; the q and dO tiles
//   of the head stream through a ring of DKV_STAGES slots by TMA, so tile
//   i + 1 is in flight while tile i is multiplied.  L and D (fp32 rows of T
//   values, not 16-byte aligned per head as TMA needs) are loaded one tile
//   ahead into registers by plain loads, issued before the score products
//   and stored to shared memory after them.
// - Products, all wgmma: S^T = K q^T and dP^T = V dO^T with both operands in
//   shared memory (K, V, q and dO all K-major); dV += P^T dO and dK += dS^T
//   q with P^T and dS^T rounded to bf16 in registers from the accumulators
//   and dO and q read as MN-major operands straight from their TMA tiles,
//   so no operand is gathered column by column.
// - Masking: rows of q past T take L = +inf (P = 0) and D = 0 where L and D
//   are loaded, and keys >= kv_len take P = 0; n8 blocks and k16 steps that
//   hold only such rows or keys are skipped.  dK and dV leave through the K
//   and V tiles and a TMA store, with the rows of dead keys exact zeros.
constexpr int DKV_STAGES = 2;

template <int DP>
constexpr size_t dkv_smem_bytes() {
  // K and V tiles, then per slot a q and a dO tile; then two slots of 64 L
  // and 64 D values
  return (size_t)(2 + 2 * DKV_STAGES) * ((DP + 63) / 64) * hopper::TILE_BYTES +
         2 * 2 * 64 * sizeof(float) + 1024;
}

// D <= 64 fits three blocks on an SM (at most 168 registers a thread).
template <int DP>
__global__ void __launch_bounds__(MT, DP <= 64 ? 3 : 1)
bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap dkmap,
                    const __grid_constant__ CUtensorMap dvmap, const float* __restrict__ lse,
                    const float* __restrict__ delta, int t, int d, int n_kv) {
  using namespace hopper;
  constexpr int NC = (DP + 63) / 64;     // 64-column chunks of a tile
  constexpr int TILE = NC * TILE_BYTES;  // one 64-row tile over the whole depth
  constexpr int NKS = DP / 16;           // k16 steps of the score products
  constexpr int NS = 8;                  // n8 blocks of a 64-column score tile
  constexpr int NO = 32 * NC;            // dK, dV accumulators: 64 keys x 64 NC
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, q_full[DKV_STAGES];
  uint8_t* ks = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* vs = ks + TILE;
  uint8_t* qs = vs + TILE;                 // [DKV_STAGES] q tiles
  uint8_t* gs = qs + DKV_STAGES * TILE;    // [DKV_STAGES] dO tiles
  // [2][64] L, then [2][64] D, by tile parity: tile i's L sits at stats + 64 (i % 2)
  float* stats = reinterpret_cast<float*>(gs + DKV_STAGES * TILE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int k0 = blockIdx.x * MR, bh = blockIdx.y;
  const int n_qt = (t + MS - 1) / MS;
  // this thread's two keys, g and g + 8
  const int r0 = k0 + warp * 16 + g, r1 = r0 + 8;
  const bool live0 = r0 < n_kv, live1 = r1 < n_kv;
  const bool warp_dead = k0 + warp * 16 >= n_kv;

  float ak[NO], av[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) ak[i] = av[i] = 0.f;

  if (k0 < n_kv) {  // a tile of dead keys keeps its zero gradients
    auto load_q_tile = [&](int i, int s) {
      mbar_expect_tx(&q_full[s], 2 * TILE);
      tma_load_rows<NC>(qs + s * TILE, &qmap, &q_full[s], MS * i, bh);
      tma_load_rows<NC>(gs + s * TILE, &gmap, &q_full[s], MS * i, bh);
    };
    // Thread j < 64 holds L log2(e) of q row j of a tile, thread 64 + j its
    // D; rows past T hold +inf and 0.
    const float* src = tid < 64 ? lse : delta;
    const float pad = tid < 64 ? INFINITY : 0.f;
    const float scale = tid < 64 ? LOG2E : 1.f;
    auto load_stat = [&](int i) {
      const int row = MS * i + tid % 64;
      return row < t ? src[(size_t)bh * t + row] * scale : pad;
    };
    stats[tid % 64 + 128 * (tid / 64)] = load_stat(0);
    if (tid == 0) {
      mbar_init(&kv_full, 1);
      for (int s = 0; s < DKV_STAGES; ++s) mbar_init(&q_full[s], 1);
      mbar_fence_init();
    }
    __syncthreads();  // barriers ready; tile 0's L and D stored
    if (tid == 0) {
      mbar_expect_tx(&kv_full, 2 * TILE);
      tma_load_rows<NC>(ks, &kmap, &kv_full, k0, bh);
      tma_load_rows<NC>(vs, &vmap, &kv_full, k0, bh);
      for (int i = 0; i < min(n_qt, DKV_STAGES); ++i) load_q_tile(i, i);
    }
    mbar_wait(&kv_full, 0);

    for (int i = 0; i < n_qt; ++i) {
      const int s = i % DKV_STAGES, q0 = MS * i;
      uint8_t* qt = qs + s * TILE;
      uint8_t* gt = gs + s * TILE;
      const float* lt = stats + 64 * (i % 2);
      const float* dt = lt + 128;
      const float next = i + 1 < n_qt ? load_stat(i + 1) : 0.f;
      mbar_wait(&q_full[s], (i / DKV_STAGES) & 1);

      float sacc[32], pacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)  // the first steps overwrite sacc and pacc
        wgmma_ss_n64(sacc, desc_k(ks, kk), desc_k(qt, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) wgmma_ss_n64(pacc, desc_k(vs, kk), desc_k(gt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      // tile i - 1 read the other half before the barrier that closed it
      stats[tid % 64 + 128 * (tid / 64) + 64 * ((i + 1) % 2)] = next;

      // P^T = exp(S^T - L) = exp2(S^T log2 e - L log2 e) and dS^T = P^T *
      // (dP^T - D) over this thread's keys and the tile's q rows 8 j + 2 c +
      // e, both rounded to bf16.  An n8 block of q rows past T, or a warp
      // whose 16 keys are all dead (both uniform across the warp), has P = 0
      // and takes no exponentials.
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (q0 + 8 * j >= t || warp_dead) {
          pf[j / 2][(j % 2) * 2] = pf[j / 2][(j % 2) * 2 + 1] = 0u;
          sf[j / 2][(j % 2) * 2] = sf[j / 2][(j % 2) * 2 + 1] = 0u;
          continue;
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * c + e;
          const float l = lt[col], dd = dt[col];
          p[e] = live0 ? exp2f(fmaf(sacc[4 * j + e], LOG2E, -l)) : 0.f;
          p[2 + e] = live1 ? exp2f(fmaf(sacc[4 * j + 2 + e], LOG2E, -l)) : 0.f;
          ds[e] = p[e] * (pacc[4 * j + e] - dd);
          ds[2 + e] = p[2 + e] * (pacc[4 * j + 2 + e] - dd);
        }
        pf[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        sf[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        sf[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (q0 + 16 * kk >= t) break;  // P^T = dS^T = 0 for the rest of the tile
        if constexpr (NC == 1) {
          wgmma_rs_n64(av, pf[kk], desc_mn(gt, kk), 1);
          wgmma_rs_n64(ak, sf[kk], desc_mn(qt, kk), 1);
        } else {
          wgmma_rs_n128(av, pf[kk], desc_mn(gt, kk), 1);
          wgmma_rs_n128(ak, sf[kk], desc_mn(qt, kk), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();

      __syncthreads();  // every warp is done with slot s; tile i + 1's L, D stored
      if (tid == 0 && i + DKV_STAGES < n_qt) {
        fence_proxy_async();
        load_q_tile(i + DKV_STAGES, s);
      }
    }
  }

  // dK and dV through the K and V tiles (free once the last products are
  // done), then out by TMA, which drops the rows past T and columns past D;
  // the rows of dead keys are written as exact zeros.
  const uint32_t zz = 0u;  // two bf16 zeros
  const int rr = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(ks + swizzled(rr, col)) =
        live0 ? pack_bf16(ak[4 * n], ak[4 * n + 1]) : zz;
    *reinterpret_cast<uint32_t*>(vs + swizzled(rr, col)) =
        live0 ? pack_bf16(av[4 * n], av[4 * n + 1]) : zz;
    *reinterpret_cast<uint32_t*>(ks + swizzled(rr + 8, col)) =
        live1 ? pack_bf16(ak[4 * n + 2], ak[4 * n + 3]) : zz;
    *reinterpret_cast<uint32_t*>(vs + swizzled(rr + 8, col)) =
        live1 ? pack_bf16(av[4 * n + 2], av[4 * n + 3]) : zz;
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    tma_store_rows<NC>(&dkmap, ks, k0, bh);
    tma_store_rows<NC>(&dvmap, vs, k0, bh);
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
cudaError_t launch_dq_f32(const float* q, const float* k, const float* v, const float* o,
                          const float* g, const float* lse, float* delta, float* dq, int bh,
                          int t, int d, int kv_len, cudaStream_t stream) {
  const size_t smem = dq_f32_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  bwd_dq_f32_kernel<NJ><<<grid, NT, smem, stream>>>(q, k, v, o, g, lse, delta, dq, t, d,
                                                    kv_len);
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
cudaError_t launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                           const bf16* g, const float* lse, float* delta, bf16* dq, int bh,
                           int t, int d, int kv_len, cudaStream_t stream) {
  const int n_kv = min(kv_len, t);
  cudaError_t err = hopper::bind_device();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, omap, gmap, dqmap;
  if (!hopper::map_rows(&qmap, q, bh, t, t, d) || !hopper::map_rows(&kmap, k, bh, n_kv, t, d) ||
      !hopper::map_rows(&vmap, v, bh, n_kv, t, d) || !hopper::map_rows(&omap, o, bh, t, t, d) ||
      !hopper::map_rows(&gmap, g, bh, t, t, d) || !hopper::map_rows(&dqmap, dq, bh, t, t, d))
    return cudaErrorInvalidValue;
  constexpr size_t smem = dq_smem_bytes<DP>();
  err = hopper::allow_smem<bwd_dq_bf16_kernel<DP>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + MR - 1) / MR, bh);
  bwd_dq_bf16_kernel<DP><<<grid, MT, smem, stream>>>(qmap, kmap, vmap, omap, gmap, dqmap, lse,
                                                     delta, t, d, n_kv);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* g,
                            const float* lse, const float* delta, bf16* dk, bf16* dv,
                            int bh, int t, int d, int kv_len, cudaStream_t stream) {
  const int n_kv = min(kv_len, t);
  cudaError_t err = hopper::bind_device();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, gmap, dkmap, dvmap;
  if (!hopper::map_rows(&qmap, q, bh, t, t, d) || !hopper::map_rows(&kmap, k, bh, n_kv, t, d) ||
      !hopper::map_rows(&vmap, v, bh, n_kv, t, d) || !hopper::map_rows(&gmap, g, bh, t, t, d) ||
      !hopper::map_rows(&dkmap, dk, bh, t, t, d) || !hopper::map_rows(&dvmap, dv, bh, t, t, d))
    return cudaErrorInvalidValue;
  constexpr size_t smem = dkv_smem_bytes<DP>();
  err = hopper::allow_smem<bwd_dkv_bf16_kernel<DP>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + MR - 1) / MR, bh);
  bwd_dkv_bf16_kernel<DP><<<grid, MT, smem, stream>>>(qmap, kmap, vmap, gmap, dkmap, dvmap, lse,
                                                      delta, t, d, n_kv);
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
// and devices.  flash_attn_bwd_dq writes D (delta) as well as dq;
// flash_attn_bwd_dkv reads that D, so it runs after dq on the same stream.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* delta, void* dq,
                                 int bh, int t, int d, int kv_len, int dtype, void* stream) {
  if (bad_shape(bh, t, d, kv_len)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fo = static_cast<const float*>(o),
                *fg = static_cast<const float*>(dout);
    float* fdq = static_cast<float*>(dq);
#define CASE(nj, dp) \
  return (int)launch_dq_f32<nj>(fq, fk, fv, fo, fg, l, dl, fdq, bh, t, d, kv_len, s)
    DISPATCH_D(d, CASE)
#undef CASE
  }
  if (dtype == 1) {
    const bf16 *bq = static_cast<const bf16*>(q), *bk = static_cast<const bf16*>(k),
               *bv = static_cast<const bf16*>(v), *bo = static_cast<const bf16*>(o),
               *bg = static_cast<const bf16*>(dout);
    bf16* bdq = static_cast<bf16*>(dq);
#define CASE(nj, dp) \
  return (int)launch_dq_bf16<dp>(bq, bk, bv, bo, bg, l, dl, bdq, bh, t, d, kv_len, s)
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
