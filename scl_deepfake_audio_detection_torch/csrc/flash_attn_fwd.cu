// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `_flash_kernel` launched by `_flash_forward`
// (scl_deepfake_audio_detection_tpu/ops/attention.py): online softmax over
// key tiles with fp32 running max, sum and accumulator, keys at or beyond
// `kv_len` masked, P rounded to the V dtype before the PV product, outputs
// O in the q dtype and the per-row logsumexp in fp32.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16) at the XLS-R 300M eval
// shape [16, 16, 201, 64] bf16: 4*B*H*T*T*D = 2.65 GFLOP (2.7 us) against
// 26.5 MB of q, k, v, O and LSE (7.9 us), so it is memory-bound at ~7.9 us:
// the design has to read each byte of K and V from device memory once per
// head and keep the load latency under the tensor-core work.
//
// Two bodies, one contract:
// - bf16 (the eval and training paths), designed for Hopper:
//   * one block per (batch*head, 128 q rows), two consumer warpgroups of
//     64 q rows each (measured faster than one block of 4 warpgroups per
//     head at both main-path shapes, PERF.md);
//   * K and V arrive by TMA (csrc/hopper.cuh) in 64-key tiles into a ring
//     of STAGES = 4 slots, one mbarrier per slot.  A head of T <= 256 has at
//     most 4 key tiles, so each block loads its head's whole K and V once,
//     up front, and computes its q tiles from that one copy (at
//     128 < T <= 256 a head has two blocks, so two loads: one cluster of
//     the two with K/V multicast into both measured slower, PERF.md).
//     Longer heads stream through the ring, each slot refilled once all the
//     block's warpgroups have released it;
//   * TMA zero-fills the rows past kv_len (the K/V maps end there) and past
//     T, and the columns past D, so loads need no masking; keys >= kv_len
//     are masked to -inf in registers;
//   * S = Q K^T is a wgmma with both operands in shared memory (Q and K
//     K-major); P is rounded to bf16 in registers straight from the S
//     accumulator, which has the layout of wgmma's register A operand; O +=
//     P V is a wgmma with P from registers and V as an MN-major operand
//     read from its TMA tile as it is, so V is never transposed;
//   * each warpgroup keeps two key tiles in flight: the tensor cores run
//     tile i - 1's P V while the warpgroup computes tile i's softmax (exp
//     as exp2 with log2 e folded into one FFMA);
//   * O goes out through the warpgroup's Q tile and a TMA store, which drops
//     the rows past T and the columns past D.
// - fp32 (the golden checks and tests): scalar FMA from shared memory,
//   since the tensor cores have no full-precision fp32 product.
//
// Layout: q, k, v, o are [BH, T, D] contiguous; lse is [BH, T].
// The kernel masks q rows >= T and keys >= kv_len itself; the caller pads
// nothing.  D is a multiple of 8 up to 128; bf16 pointers are 16-byte
// aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- fp32 body

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 64;     // keys per streamed tile
constexpr int NT = 256;    // threads per block, seen as a 16 x 16 grid
constexpr int TG = 16;     // side of that thread grid
constexpr int RPT = BQ / TG;  // q rows per thread in the S and PV products
constexpr int CPT = BK / TG;  // keys per thread in the S product

// NJ = ceil(D / 16): output columns per thread in the PV product.
template <int NJ>
__global__ void __launch_bounds__(NT)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int t, int d, int kv_len) {
  extern __shared__ float smem[];
  const int dp = d + 1;  // odd row stride: column walks hit distinct banks
  float* qs = smem;                   // [BQ][dp]
  float* ks = qs + BQ * dp;           // [BK][dp]
  float* vs = ks + BK * dp;           // [BK][d]
  float* ps = vs + BK * d;            // [BQ][BK + 1] scores, then P
  float* m_s = ps + BQ * (BK + 1);    // [BQ] running max
  float* l_s = m_s + BQ;              // [BQ] running sum
  float* a_s = l_s + BQ;              // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid % TG;
  const int ty = tid / TG;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)blockIdx.y * t * d;

  for (int i = tid; i < BQ * d; i += NT) {
    const int r = i / d, c = i % d;
    qs[r * dp + c] = (q0 + r < t) ? q[base + (size_t)(q0 + r) * d + c] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[RPT][NJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int n_kv = min(kv_len, t);
  for (int k0 = 0; k0 < n_kv; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's P and V are consumed
    for (int i = tid; i < BK * d; i += NT) {
      const int r = i / d, c = i % d;
      const bool live = k0 + r < n_kv;
      const size_t g = base + (size_t)(k0 + r) * d + c;
      ks[r * dp + c] = live ? k[g] : 0.f;
      vs[r * d + c] = live ? v[g] : 0.f;
    }
    __syncthreads();

    // S = Q K^T: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j.
    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + TG * i) * dp + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + TG * j) * dp + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = tx + TG * j;
        ps[(ty + TG * i) * (BK + 1) + col] = (k0 + col < n_kv) ? s[i][j] : -INFINITY;
      }
    __syncthreads();

    // Online softmax: each warp takes BQ / 8 rows, each lane two keys.
    // Every tile holds at least one live key, so the new max is finite.
    const int warp = tid / 32, lane = tid % 32;
    for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
      const int r = warp * (BQ / (NT / 32)) + rr;
      float* prow = ps + r * (BK + 1);
      const float x0 = prow[lane], x1 = prow[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      prow[lane] = p0;
      prow[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V: thread (ty, tx) owns rows ty + 16 i and
    // output columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = a_s[ty + TG * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
    const int kmax = min(BK, n_kv - k0);
#pragma unroll 4
    for (int c = 0; c < kmax; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty + TG * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + TG * j;
        const float vv = col < d ? vs[c * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TG * i;
    if (q0 + r >= t) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + TG * j;
      if (col < d) o[base + (size_t)(q0 + r) * d + col] = acc[i][j] / l;
    }
  }
  if (tid < BQ && q0 + tid < t)
    lse[(size_t)blockIdx.y * t + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int NJ>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o,
                       float* lse, int bh, int t, int d, int kv_len,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (d + 1) + (size_t)BK * (d + 1) +
                       (size_t)BK * d + (size_t)BQ * (BK + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_f32_kernel<NJ><<<grid, NT, smem, stream>>>(q, k, v, o, lse, t, d, kv_len);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 body

typedef __nv_bfloat16 bf16;

constexpr int NW = 2;      // consumer warpgroups per block
constexpr int STAGES = 4;  // K/V tiles held at once
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Dynamic shared memory: NW Q tiles, then STAGES K tiles and STAGES V
// tiles, each 64 rows over ceil(DP / 64) chunks, plus slack to align them.
template <int DP>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(NW + 2 * STAGES) * ((DP + 63) / 64) * hopper::TILE_BYTES + 1024;
}

// DP = D rounded up to 16 (the depth of Q K^T); the padding columns are zero.
template <int DP>
__global__ void __launch_bounds__(NW * 128, DP <= 64 ? 2 : 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      float* __restrict__ lse, int t, int d, int n_kv) {
  using namespace hopper;
  constexpr int NC = (DP + 63) / 64;   // 64-column chunks of a tile
  constexpr int TILE = NC * TILE_BYTES;  // one 64-row tile over the whole depth
  constexpr int NKS = DP / 16;         // k16 steps of Q K^T
  constexpr int NS = 8;                // n8 blocks of S (64 keys)
  constexpr int NO = 32 * NC;          // O accumulators: 64 rows x 64 NC columns
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, kv_full[STAGES], kv_empty[STAGES];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + NW * TILE;
  uint8_t* vs = ks + STAGES * TILE;

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.y, row0 = blockIdx.x * NW * 64;
  const int n_kt = (n_kv + 63) / 64;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], NW * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&q_full, NW * TILE);
    for (int w = 0; w < NW; ++w)
      tma_load_rows<NC>(qs + w * TILE, &qmap, &q_full, row0 + 64 * w, bh);
    for (int i = 0; i < min(n_kt, STAGES); ++i) {
      mbar_expect_tx(&kv_full[i], 2 * TILE);
      tma_load_rows<NC>(ks + i * TILE, &kmap, &kv_full[i], 64 * i, bh);
      tma_load_rows<NC>(vs + i * TILE, &vmap, &kv_full[i], 64 * i, bh);
    }
  }

  uint8_t* my_q = qs + wg * TILE;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // running max (of the raw scores) and this thread's partial sums of rows
  // g and g + 8; the sums are reduced over the quad at the end
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(&q_full, 0);

  // S of tile i into sacc, on the tensor cores, left in flight.
  auto issue_s = [&](float (&sacc)[32], int i) {
    const int s = i % STAGES;
    mbar_wait(&kv_full[s], (i / STAGES) & 1);
    pin(sacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk)  // the first step overwrites sacc
      wgmma_ss_n64(sacc, desc_k(my_q, kk), desc_k(ks + s * TILE, kk), kk > 0);
    wgmma_commit();
    pin(sacc);
  };
  // acc += P V of tile i, left in flight.
  auto issue_pv = [&](uint32_t (&pf)[4][4], int i) {
    const uint8_t* vt = vs + (i % STAGES) * TILE;
    pin(acc);
    pin(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (NC == 1)
        wgmma_rs_n64(acc, pf[kk], desc_mn(vt, kk), 1);
      else
        wgmma_rs_n128(acc, pf[kk], desc_mn(vt, kk), 1);
    }
    wgmma_commit();
    pin(acc);
    pin(pf);
  };
  // Tile i's slot goes back once this warpgroup's P V of it is done; the
  // block's first thread refills it once every consumer warp has.
  auto release = [&](int i) {
    const int s = i % STAGES;
    if (lane == 0) mbar_arrive(&kv_empty[s]);
    if (tid == 0 && i + STAGES < n_kt) {
      mbar_wait(&kv_empty[s], (i / STAGES) & 1);
      mbar_expect_tx(&kv_full[s], 2 * TILE);
      tma_load_rows<NC>(ks + s * TILE, &kmap, &kv_full[s], 64 * (i + STAGES), bh);
      tma_load_rows<NC>(vs + s * TILE, &vmap, &kv_full[s], 64 * (i + STAGES), bh);
    }
    __syncwarp();
  };
  // Online softmax of tile i's scores: updates the running max and sums,
  // writes P (rounded to bf16, as the A operand of P V) and returns the
  // rescale factors of the rows' earlier sums in al0, al1.  Reads the S
  // accumulator and never writes it.
  auto softmax = [&](const float (&sacc_in)[32], uint32_t (&pf)[4][4], int i, float& al0,
                     float& al1) {
    const int k0 = 64 * i;
    // Mask dead keys (only the last tile has any); every tile holds a live
    // key, so each row max is finite.
    float sacc[32];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool dead = k0 + 8 * j + 2 * c + e >= n_kv;
        sacc[4 * j + e] = dead ? -INFINITY : sacc_in[4 * j + e];
        sacc[4 * j + 2 + e] = dead ? -INFINITY : sacc_in[4 * j + 2 + e];
      }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    // a row's 64 scores are spread over the four lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // exp(x - m) as exp2(x log2 e - m log2 e), one FFMA and one MUFU op
    const float ms0 = mn0 * LOG2E, ms1 = mn1 * LOG2E;
    al0 = exp2f(fmaf(m0, LOG2E, -ms0));
    al1 = exp2f(fmaf(m1, LOG2E, -ms1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p00 = exp2f(fmaf(sacc[4 * j], LOG2E, -ms0));
      const float p01 = exp2f(fmaf(sacc[4 * j + 1], LOG2E, -ms0));
      const float p10 = exp2f(fmaf(sacc[4 * j + 2], LOG2E, -ms1));
      const float p11 = exp2f(fmaf(sacc[4 * j + 3], LOG2E, -ms1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
  };

  // Two tiles in flight: while the tensor cores run tile i - 1's P V, the
  // warpgroup computes tile i's softmax; acc is rescaled once that P V is
  // done.  pf holds the P in flight, pn the next one.
  float sacc[32], al0, al1;
  uint32_t pf[4][4], pn[4][4];
  issue_s(sacc, 0);
  wgmma_wait<0>();
  pin(sacc);
  softmax(sacc, pf, 0, al0, al1);
  for (int i = 1; i < n_kt; ++i) {
    issue_s(sacc, i);
    issue_pv(pf, i - 1);
    wgmma_wait<1>();  // S of tile i is done
    pin(sacc);
    softmax(sacc, pn, i, al0, al1);
    wgmma_wait<0>();  // P V of tile i - 1 is done
    pin(acc);
    pin(pf);
    release(i - 1);
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      acc[4 * j] *= al0;
      acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1;
      acc[4 * j + 3] *= al1;
    }
    move(pf, pn);  // only pf is ever a wgmma operand
  }
  issue_pv(pf, n_kt - 1);
  wgmma_wait<0>();  // the last tile's slot is never refilled
  pin(acc);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // O through this warpgroup's Q tile, whose last reader (the last S) is
  // done, then out by TMA, which drops the rows past T and columns past D.
  const int rr = warp * 16 + g, r0 = row0 + wg * 64 + rr;
#pragma unroll
  for (int n = 0; n < NO / 4; ++n) {
    const int col = 8 * n + 2 * c;
    *reinterpret_cast<uint32_t*>(my_q + swizzled(rr, col)) =
        pack_bf16(acc[4 * n] / l0, acc[4 * n + 1] / l0);
    *reinterpret_cast<uint32_t*>(my_q + swizzled(rr + 8, col)) =
        pack_bf16(acc[4 * n + 2] / l1, acc[4 * n + 3] / l1);
  }
  fence_proxy_async();
  warpgroup_sync(1 + wg);
  if (tid % 128 == 0) tma_store_rows<NC>(&omap, my_q, row0 + wg * 64, bh);
  if (c == 0) {
    if (r0 < t) lse[(size_t)bh * t + r0] = m0 + logf(l0);
    if (r0 + 8 < t) lse[(size_t)bh * t + r0 + 8] = m1 + logf(l1);
  }
}

template <int DP>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int bh, int t, int d, int kv_len,
                        cudaStream_t stream) {
  const int n_kv = min(kv_len, t);
  cudaError_t err = hopper::bind_device();
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, omap;
  if (!hopper::map_rows(&qmap, q, bh, t, t, d) || !hopper::map_rows(&kmap, k, bh, n_kv, t, d) ||
      !hopper::map_rows(&vmap, v, bh, n_kv, t, d) || !hopper::map_rows(&omap, o, bh, t, t, d))
    return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<DP>();
  err = hopper::allow_smem<flash_fwd_bf16_kernel<DP>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + NW * 64 - 1) / (NW * 64), bh);
  flash_fwd_bf16_kernel<DP><<<grid, NW * 128, smem, stream>>>(qmap, kmap, vmap, omap, lse, t,
                                                              d, n_kv);
  return cudaGetLastError();
}

#define FLASH_ARGS q, k, v, o, lse, bh, t, d, kv_len, stream

cudaError_t dispatch_f32(const float* q, const float* k, const float* v, float* o,
                         float* lse, int bh, int t, int d, int kv_len,
                         cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch_f32<1>(FLASH_ARGS);
    case 2: return launch_f32<2>(FLASH_ARGS);
    case 3: return launch_f32<3>(FLASH_ARGS);
    case 4: return launch_f32<4>(FLASH_ARGS);
    case 5: return launch_f32<5>(FLASH_ARGS);
    case 6: return launch_f32<6>(FLASH_ARGS);
    case 7: return launch_f32<7>(FLASH_ARGS);
    case 8: return launch_f32<8>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                          float* lse, int bh, int t, int d, int kv_len,
                          cudaStream_t stream) {
  switch ((d + 15) / 16) {
    case 1: return launch_bf16<16>(FLASH_ARGS);
    case 2: return launch_bf16<32>(FLASH_ARGS);
    case 3: return launch_bf16<48>(FLASH_ARGS);
    case 4: return launch_bf16<64>(FLASH_ARGS);
    case 5: return launch_bf16<80>(FLASH_ARGS);
    case 6: return launch_bf16<96>(FLASH_ARGS);
    case 7: return launch_bf16<112>(FLASH_ARGS);
    case 8: return launch_bf16<128>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
}

#undef FLASH_ARGS

}  // namespace

// Returns a cudaError_t: 0 when the launch was accepted.  dtype 0 = fp32,
// 1 = bf16.  The Python wrapper validates shapes, dtypes, alignment and
// devices.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int t, int d,
                              int kv_len, int dtype, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || t <= 0 || bh <= 0 || kv_len <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return (int)dispatch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                             static_cast<const float*>(v), static_cast<float*>(o), l,
                             bh, t, d, kv_len, s);
  if (dtype == 1)
    return (int)dispatch_bf16(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), static_cast<bf16*>(o), l,
                              bh, t, d, kv_len, s);
  return (int)cudaErrorInvalidValue;
}
