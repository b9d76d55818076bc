// Hopper (sm_90a) building blocks of the attention kernels (the cores in
// attention_fwd.cuh and attention_bwd.cuh): mbarriers, TMA tile loads
// through 3-D tensor maps, wgmma on 128-byte swizzled shared tiles, and the
// host-side tensor map encoding.
//
// Shared tiles. A tile of R rows x HD bf16 columns (HD = 64 or 128) is
// HD / 64 64-column "halves" of R x 128 bytes each (half h at byte
// h * R * 128), each filled by one TMA box with CU_TENSOR_MAP_SWIZZLE_128B:
// the 16-byte chunk c of row r lies at r * 128 + ((c ^ (r % 8)) * 16).
// Every tile starts on a 1024-byte boundary, so the swizzle (address bits
// 4-6 xor bits 7-9) is the same whether TMA, wgmma or store_swizzled
// addresses the tile. At HD = 64 a tile is a single half: K-major k-steps
// all fall in half 0, and an MN-major operand of 64 columns uses no LBO.
//
// wgmma descriptors on such a tile (desc()):
//   K-major operand (the product runs along the 128 columns, e.g. Q and K
//   of Q K^T): rows in groups of 8 at a stride of 1024 bytes (SBO); k-step
//   kk of 16 columns starts at half kk / 4, byte (kk % 4) * 32 of the row.
//   MN-major operand (the product runs down the rows, e.g. V of P V with
//   the transposed-B flag): k-step kk of 16 rows starts at byte kk * 2048;
//   8-row groups 1024 bytes apart (SBO); the second 64 columns one half
//   further (LBO = R * 128).
//
// Register fragments (warp w of the warpgroup, g = lane / 4, t = lane % 4):
//   accumulator of m64nN: d[4j + e] at row 16w + g + 8 * (e / 2), column
//   8j + 2t + e % 2, so an accumulator pair is one interleaved rotary pair;
//   bf16 A fragment of m64k16: a0 (row g, k 2t..2t+1), a1 (g + 8, 2t..),
//   a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..), the mma.sync layout: the
//   accumulator of a product over 16 columns packs into the A fragment of
//   the next product without shuffles.
//
// Tensor maps are encoded on the host through the driver entry point
// cuTensorMapEncodeTiled, fetched with the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the libraries link no -lcuda. An
// encoding costs microseconds of host time, as much as a whole call at the
// block experts' lengths, so each host thread keeps its last maps (a map is
// a pure function of its key); the shared memory attribute is likewise set
// once per kernel and device.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// Generic-proxy stores to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------------- TMA

// Box (c0 = column, c1 = row, c2 = b*h) of a 3-D tensor map into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Every 64-column half of rows [row, row + rows) of head bh into a tile of
// HD columns.
template <int HD = 128>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int row, int bh) {
#pragma unroll
  for (int h = 0; h < HD / 64; ++h)
    tma_load_3d(dst + h * rows * 128, map, bar, 64 * h, row, bh);
}

// Store 16 bytes as chunk `chunk` (0..HD/8-1) of row r of a swizzled tile
// of R rows (the layout TMA writes).
__device__ __forceinline__ void store_swizzled(unsigned char* tile, int R, int r,
                                               int chunk, uint4 v) {
  const int half = chunk >> 3, c = chunk & 7;
  *reinterpret_cast<uint4*>(tile + half * R * 128 + r * 128 + ((c ^ (r & 7)) << 4)) = v;
}

// -------------------------------------------------------------------- wgmma

// Matrix descriptor of a 128-byte swizzled operand at shared address addr.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: k-step kk of a tile of R rows whose first used row is
// `row0` (a multiple of 8).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int R, int row0, int kk) {
  return desc(tile + (kk >> 2) * R * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// MN-major operand: k-step kk (rows 16kk..16kk+15) of a tile of R rows.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int R, int kk) {
  return desc(tile + kk * 2048, R * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving register accesses across the asynchronous
// wgmma that reads or writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
  }
}

// 2^x in one MUFU.EX2 (flushes results below 2^-126 to zero, far below a
// bf16 P's resolution; exp2f adds a denormal fix-up around it).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments of a product over the columns of an m64nN accumulator:
// k-step kk takes columns 16kk..16kk+15, rounded to bf16.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&d)[KS * 8]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
      a[kk][e] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void mma_n128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void mma_n64_ss(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A in registers (a bf16 A
// fragment), B MN-major in shared memory (the transposed-B flag).
__device__ __forceinline__ void mma_n128_rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (one 64-column half: no LBO).
__device__ __forceinline__ void mma_n64_rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x HD] (+)= A[64 x 16] B[16 x HD] for HD = 64 or 128: A in registers,
// B MN-major (k-step kk of a tile of R rows).
template <int HD>
__device__ __forceinline__ void mma_rs_mn(float (&d)[HD / 2], const uint32_t (&a)[4],
                                          uint32_t tile, int R, int kk) {
  if constexpr (HD == 128) mma_n128_rs_mn(d, a, desc_mn(tile, R, kk), 1);
  else mma_n64_rs_mn(d, a, desc_mn(tile, R, kk), 1);
}

// ---------------------------------------------------------- host: tensor maps

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Error codes of the C entry points beyond CUDA's own.
constexpr int ERR_NO_ENCODE = 90001;   // driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 90002;      // the driver refused a tensor map

struct MapKey {
  const void* base;
  int BH, S, box_rows, d;
  bool operator==(const MapKey& o) const {
    return base == o.base && BH == o.BH && S == o.S && box_rows == o.box_rows && d == o.d;
  }
};
constexpr int MAP_CACHE = 32;     // maps kept per host thread

// Map of a bf16 [BH, S, d] tensor (d = 64 or 128): boxes of `box_rows` rows
// x 64 columns of one head, 128-byte swizzle. Rows past S read as zeros
// (never the next head's rows).
inline int rows_map(CUtensorMap* map, const void* base, int BH, int S, int box_rows,
                    int d = 128) {
  thread_local MapKey keys[MAP_CACHE] = {};
  thread_local CUtensorMap maps[MAP_CACHE];
  thread_local int next = 0;
  const MapKey key{base, BH, S, box_rows, d};
  for (int i = 0; i < MAP_CACHE; ++i) {
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_ENCODE;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % MAP_CACHE;
  return 0;
}

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes), once per
// kernel and device in each host thread.
inline cudaError_t max_smem(const void* kernel, int bytes) {
  constexpr int N = 64;
  thread_local const void* done[N] = {};
  thread_local int dev_of[N];
  thread_local int n = 0;
  int dev = 0;
  const cudaError_t g = cudaGetDevice(&dev);
  if (g != cudaSuccess) return g;
  for (int i = 0; i < n; ++i) {
    if (done[i] == kernel && dev_of[i] == dev) return cudaSuccess;
  }
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && n < N) {
    done[n] = kernel;
    dev_of[n] = dev;
    ++n;
  }
  return e;
}

}  // namespace hop
