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
// 26.5 MB of q, k, v, O and LSE (7.9 us), so it is memory-bound at ~7.9 us.
// Each block owns a 64-row q tile and streams 64-key K/V tiles through
// shared memory, so S and P never leave the chip and every input byte
// leaves device memory once per q tile.
//
// Two bodies, one contract:
// - bf16 (the eval path): tensor cores through mma.sync m16n8k16 with fp32
//   accumulation.  Four warps own 16 q rows each; S comes out of the QK^T
//   product in exactly the register layout that the PV product takes as its
//   A operand, so P is rounded to bf16 in registers and never staged.
// - fp32 (the golden checks and tests): scalar FMA from shared memory,
//   since the tensor cores have no full-precision fp32 product.
// TMA staging and wgmma are later work.
//
// Layout: q, k, v, o are [BH, T, D] contiguous; lse is [BH, T].
// The kernel masks q rows >= T and keys >= kv_len itself; the caller pads
// nothing.  D is a multiple of 8 up to 128; bf16 pointers are 16-byte
// aligned (the wrapper checks both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

constexpr int MQ = 64;         // q rows per block: 4 warps x 16 rows
constexpr int MK = 64;         // keys per streamed tile (== MQ: Q is staged in the K buffer)
constexpr int MT = 128;        // threads per block
static_assert(MQ == 64 && MK == 64, "stage_tile moves 64-row tiles");
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// thread; rows >= nrows and columns >= d are zero.  With `transpose` the
// tile lands as dst [DP][64 + 8] (column c of the source is row c of dst).
template <int DP, bool transpose>
__device__ __forceinline__ void stage_tile(bf16* __restrict__ dst,
                                           const bf16* __restrict__ src,
                                           int r0, int nrows, int d, int tid) {
  constexpr int C8 = DP / 8;
  for (int i = tid; i < 64 * C8; i += MT) {
    const int r = i / C8, c = (i % C8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * d + c);
    if (!transpose) {
      *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = val;
    } else {
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[(c + 2 * j) * (64 + 8) + r] = __ushort_as_bfloat16((unsigned short)(w[j] & 0xffffu));
        dst[(c + 2 * j + 1) * (64 + 8) + r] = __ushort_as_bfloat16((unsigned short)(w[j] >> 16));
      }
    }
  }
}

// DP = D rounded up to 16 (the product depth); the padding columns are zero.
//
// mma.sync m16n8k16 fragments, with g = lane / 4 and c = lane % 4:
//   A (16x16): regs {row g, k 2c..2c+1}, {row g+8, same}, {row g, k 2c+8..},
//              {row g+8, k 2c+8..};
//   B (16x8):  regs {k 2c..2c+1, n g}, {k 2c+8..2c+9, n g};
//   C (16x8):  {row g, n 2c}, {row g, n 2c+1}, {row g+8, n 2c}, {row g+8, n 2c+1}.
// Shared-memory rows are padded by 8 bf16 (16 bytes), so the eight rows a
// fragment load touches fall in distinct banks.
template <int DP>
__global__ void __launch_bounds__(MT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int t, int d, int kv_len) {
  constexpr int KS = DP + 8;  // row stride of the Q / K tile
  constexpr int VS = MK + 8;  // row stride of the transposed V tile
  constexpr int NKK = DP / 16;  // k-steps of QK^T
  constexpr int NS = MK / 8;    // n-tiles of S
  constexpr int NO = DP / 8;    // n-tiles of O
  __shared__ __align__(16) bf16 ks[MK * KS];
  __shared__ __align__(16) bf16 vts[DP * VS];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int q0 = blockIdx.x * MQ;
  const size_t base = (size_t)blockIdx.y * t * d;
  const int n_kv = min(kv_len, t);

  // Q through the K buffer into registers, once.
  stage_tile<DP, false>(ks, q + base, q0, t, d, tid);
  __syncthreads();
  uint32_t qf[NKK][4];
  {
    const bf16* row = ks + (warp * 16 + g) * KS + 2 * c;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      qf[kk][0] = ld32(row + kk * 16);
      qf[kk][1] = ld32(row + 8 * KS + kk * 16);
      qf[kk][2] = ld32(row + kk * 16 + 8);
      qf[kk][3] = ld32(row + 8 * KS + kk * 16 + 8);
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // running max and sum of this thread's two rows, g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n_kv; k0 += MK) {
    __syncthreads();  // Q fragments taken; the previous tile is consumed
    stage_tile<DP, false>(ks, k + base, k0, n_kv, d, tid);
    stage_tile<DP, true>(vts, v + base, k0, n_kv, d, tid);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = ks + (8 * j + g) * KS + 2 * c;
#pragma unroll
      for (int kk = 0; kk < NKK; ++kk)
        mma_bf16(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // Mask dead keys; every tile holds a live key, so each row max is finite.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + 8 * j + 2 * c + e >= n_kv) s[j][e] = s[j][2 + e] = -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    // a row's 64 scores are spread over the four lanes of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P in fp32 for the row sums, rounded to bf16 as the A operand of PV:
    // n-tiles 2i and 2i + 1 of S are k-step i of the PV product.
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pf[MK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p00 = expf(s[j][0] - mn0), p01 = expf(s[j][1] - mn0);
      const float p10 = expf(s[j][2] - mn1), p11 = expf(s[j][3] - mn1);
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      pf[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
#pragma unroll
    for (int i = 0; i < MK / 16; ++i) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const bf16* vrow = vts + (8 * n + g) * VS + 16 * i + 2 * c;
        mma_bf16(acc[n], pf[i], ld32(vrow), ld32(vrow + 8));
      }
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (8 * n >= d) break;
    const int col = 8 * n + 2 * c;
    if (r0 < t)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * d + col) =
          pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < t)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * d + col) =
          pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
  if (c == 0) {
    if (r0 < t) lse[(size_t)blockIdx.y * t + r0] = m0 + logf(l0);
    if (r1 < t) lse[(size_t)blockIdx.y * t + r1] = m1 + logf(l1);
  }
}

template <int DP>
cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                        float* lse, int bh, int t, int d, int kv_len,
                        cudaStream_t stream) {
  const dim3 grid((t + MQ - 1) / MQ, bh);
  flash_fwd_bf16_kernel<DP><<<grid, MT, 0, stream>>>(q, k, v, o, lse, t, d, kv_len);
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
