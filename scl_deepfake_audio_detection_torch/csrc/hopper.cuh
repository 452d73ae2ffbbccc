// Hopper (sm_90a) building blocks shared by the port's bf16 attention kernels:
// TMA tensor maps and loads, mbarriers, and warpgroup matrix multiplies
// (wgmma) in raw PTX.  Header-only; each kernel source includes it.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a tile
// is R rows of 64 bf16 (128 bytes), grouped in 8-row atoms of 1024 bytes,
// and the 16-byte chunk j of row r sits at chunk position j ^ (r % 8).  A
// head dimension D above 64 is held as two such tiles ("chunks"), columns
// [0, 64) and [64, 128); TMA zero-fills the columns past D and the rows past
// the tensor's extent.  Every tile starts on a 1024-byte boundary, so the
// wgmma descriptors below need no base offset.
//
// wgmma descriptors for those tiles (128-byte swizzle, layout type 1):
// - K-major (the reduction dimension contiguous: Q and K in S = Q K^T, q and
//   dO in S^T = K q^T): 8-row groups 1024 bytes apart (SBO); one k16 step
//   is 32 bytes along the row, so step j of chunk c starts at
//   tile + c * chunk_bytes + 32 j.
// - MN-major (the output dimension contiguous: V in O = P V, dO and q in
//   dV = P^T dO and dK = dS^T q): 8 reduction rows per 1024-byte group
//   (SBO), and the second 64-column chunk LBO bytes after the first; one
//   k16 step is 16 rows, 2048 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int SWIZZLE_ROW = 128;          // bytes of one swizzled row: 64 bf16
constexpr int TILE_BYTES = 64 * SWIZZLE_ROW;  // a 64-row, 64-column bf16 tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase with the given parity has completed.  A wait that
// outlasts ~10 s of SM clock traps, so a barrier that never completes ends
// the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > 20000000000LL) __trap();
  }
}

// Orders this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) writes to the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ TMA loads

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Rows [r0, r0 + 64) of head `bh` of a [BH, T, D] map into NC chunk tiles.
template <int NC>
__device__ __forceinline__ void tma_load_rows(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int r0, int bh) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tma_load_3d(dst + c * TILE_BYTES, map, bar, 64 * c, r0, bh);
}

// NC chunk tiles out to rows [r0, r0 + 64) of head `bh`; TMA drops the rows
// and columns that fall outside the map.  Waits until the tiles have been
// read, so that the shared memory may be reused or released.
template <int NC>
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map, const uint8_t* src,
                                               int r0, int bh) {
#pragma unroll
  for (int c = 0; c < NC; ++c) tma_store_3d(map, src + c * TILE_BYTES, 64 * c, r0, bh);
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Byte offset of element (row, col) of a 64-row tile in the swizzled layout
// above, for col < 128 (two chunks).
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return (col / 64) * TILE_BYTES + row * SWIZZLE_ROW + ((((col % 64) / 8) ^ (row % 8)) * 16) +
         (col % 8) * 2;
}

// Barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------------ wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled operand.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// K-major operand: k16 step `ks` of a [64-row, NC-chunk] tile.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int ks) {
  return desc(tile + (ks / 4) * TILE_BYTES + (ks % 4) * 32, 16, 1024);
}

// MN-major operand: k16 step `ks` (rows 16 ks .. 16 ks + 15) of a 64-row tile
// whose 64-column chunks lie TILE_BYTES apart.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int ks) {
  return desc(tile + ks * 16 * SWIZZLE_ROW, TILE_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers at this point of the program.  A wgmma reads its register
// operand and accumulators, and writes the accumulators, after the compiler
// considers the instruction done; without a pin the compiler may move
// arithmetic on those registers above the wait that retires the wgmma, or
// reuse the operand's registers early, and ptxas then serializes every
// wgmma of the kernel (C7513) to stay correct.  Called around each group of
// wgmmas and after the wait that retires it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// dst = src through moves the compiler cannot see through, so that a later
// wgmma reading dst reads dst's registers and never src's.  A register
// operand prepared while an earlier wgmma is in flight goes into src; were
// src itself forwarded to a wgmma (as the compiler does with a plain copy
// after the last loop iteration), ptxas would find that wgmma's operand
// written inside an open pipeline stage and serialize the kernel (C7513).
template <int N>
__device__ __forceinline__ void move(uint32_t (&dst)[N][4], const uint32_t (&src)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("mov.b32 %0, %1;" : "=r"(dst[i][j]) : "r"(src[i][j]));
}

// The accumulators below have the per-warp layout of mma.sync m16n8k16's C
// fragment, repeated over n8 blocks: warp w of the warpgroup owns rows
// 16 w .. 16 w + 15; with g = lane / 4 and c = lane % 4, d[4 j + e] is row
// g, column 8 j + 2 c + e and d[4 j + 2 + e] is row g + 8, same column.  The
// register A operand has m16n8k16's A layout, so n8 blocks 2 i and 2 i + 1
// of an accumulator, rounded to bf16, are its k16 step i.

// d[64 x 64] += A (smem, K-major) * B (smem, K-major), one k16 step.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A (registers, m16n8k16 A layout per warp) * B (smem,
// MN-major), one k16 step.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d[64 x 128] += A (registers, m16n8k16 A layout per warp) * B (smem,
// MN-major), one k16 step.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}


// ------------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, a driver API, found through the runtime so that
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Makes the primary context of the runtime's current device current to the
// calling thread.  cuTensorMapEncodeTiled fails in a thread with no current
// context, such as PyTorch's autograd worker when a kernel launch is the
// first CUDA work it does; every launcher that encodes maps calls this
// first.
inline cudaError_t bind_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// A [bh, rows, d] view of a contiguous bf16 [bh, t, d] tensor (rows <= t),
// read in boxes of 64 rows x 64 columns with the 128-byte swizzle; rows
// past `rows` and columns past d come in as zeros.
inline bool map_rows(CUtensorMap* map, const void* base, int bh, int rows, int t, int d) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// Set once per device, at the first launch, so that a launch captured in a
// CUDA graph makes no attribute call.
template <auto kernel>
cudaError_t allow_smem(size_t bytes) {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace hopper
