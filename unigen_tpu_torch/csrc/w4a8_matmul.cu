// W4A8 dequant-matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel `_w4a8_kernel` / `w4a8_matmul_pallas`
// (unigen_tpu/ops/pallas/quant_matmul.py:57 and :83).
//
//   out[m, n] = OutT( (float(acc[m, n]) * xs[m]) * ws[n] )
//   acc[m, n] = sum_k xq[m, k] * w[k, n]            (exact int32)
//
// xq int8 [M, K] (per-token quantized activations), xs f32 [M, 1],
// wq4 int8 [K/2, N] holding int4 codes HALF-PAIRED along K: packed row j
// carries source row j in its low nibble and source row j + K/2 in its high
// nibble (ops/quant.pack_int4), ws f32 [1, N]. OutT is bf16 or fp32.
//
// What bounds it on the H100: at the main path's token rows (M = 1024,
// 2048, 3072; K = 3072..15360) the int8 tensor-core operations, 2*M*N*K at
// 1979 TOP/s (19.5 us at M=2048, K=N=3072). At M = 2 (the AdaLN and
// embedder linears) the packed weight read, 0.5 B/param (the 18432-wide
// AdaLN weight is 28 MB, 8.5 us at 3.35 TB/s).
//
// Design (w4a8_wgmma_kernel): one block of 384 threads per BM x 128 output
// tile (BM = 256 for token rows, 64 for short M), three warpgroups. Warpgroup 2 is the
// producer: one thread keeps TMA loads in flight through a ring of stages
// under full/empty mbarriers. A stage is 128 packed weight rows: the xq
// tiles of columns [p0, p0+128) (the low half) and [K/2+p0, K/2+p0+128)
// (the high half), BM x 128 bytes each, and the packed weight tile
// [128 rows x 128 columns] as it lies in memory, all three with the
// 128-byte swizzle. For 8-bit types wgmma takes only K-major operands, and
// the weight is N-contiguous, so the two consumer warpgroups convert: each
// thread reads a 4 (k) x 16 (n) block of packed bytes, transposes it 4 x 4
// bytes at a time with byte permutes, splits the nibbles, sign-extends
// them, and writes the low and the high plane K-major into two swizzled
// [128 n x 128 k] tiles (double-buffered). The consumers convert stage
// s + 1 while their wgmma on stage s runs. Per stage each warpgroup issues
// 4 m64nNk32 s8 products of the low plane against the low xq tile and 4 of
// the high plane against the high xq tile: the two dots of the Pallas
// kernel. At BM = 256 warpgroup w takes rows 128w..128w+127 of the tile
// (two m64n128 products a k-step), so each converted plane feeds 256 rows
// and each packed byte is read from L2 once per 256 rows; at BM = 64 it
// takes columns 64w..64w+63 (m64n64).
// Tails need no masks in the loop: TMA fills boxes past the tensor's edge
// with zeros. A low-half xq box that runs past K/2 reads high-half columns,
// but they meet packed rows past K/2, which read as zeros, so they add
// nothing; a high-half box past K reads zeros.
// Short M splits K: grid z takes a contiguous range of stages and writes
// its int32 partial sums to a workspace; w4a8_reduce_kernel adds the
// splits in a fixed order (int32 sums are exact in any order) and runs the
// epilogue. The epilogue multiplies in the order of the plain version with
// round-to-nearest intrinsics, so every route is bit-identical to it.
// At BM = 256 the consumers hold 128 accumulators a thread, so setmaxnreg
// moves registers from the producer (24/240: the kernel must enter with
// exactly 168 registers at 384 threads, or setmaxnreg.inc never returns);
// the BM = 64 instantiation fits in 168 and moves none. On an H100,
// 256-row tiles measured faster than 128-row ones at every token-row shape
// of the FLUX path.
//
// w4a8_general_kernel, the first (mma.sync) design, serves the shapes TMA
// cannot address: a K or N that is not a multiple of 16 (a row stride of
// a 2-D tensor map must be a multiple of 16 bytes). The wrapper picks it by
// shape before launching; no main-path shape reaches it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ void store_out(float* out, size_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t i,
                                          float v) {
  out[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float epilogue(int acc, float xrow, float wcol) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), xrow), wcol);
}

// Two neighbouring outputs (col even, N even: 4- or 8-byte aligned).
__device__ __forceinline__ void store_pair(float* out, size_t i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, size_t i, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------------------ wgmma kernel

constexpr int WG_THREADS = 384;     // consumers: warpgroups 0, 1; producer: 2
constexpr int BN = 128;             // output columns per block
constexpr int BKP = 128;            // packed rows (k of each plane) per stage
constexpr int PACKED_TILE = BKP * BN;
constexpr int PLANE = BN * BKP;     // one converted plane, [BN n x BKP k]

// BM = 256: warpgroup w takes rows 128w..128w+127 (two m64n128 tiles, 128
// accumulators a thread: registers move from the producer with
// setmaxnreg); BM = 64: warpgroup w takes columns 64w..64w+63 (m64n64).
template <int BM>
struct Tile {
  static constexpr bool WIDE = BM == 256;
  static constexpr int STAGES = WIDE ? 2 : 4;
  static constexpr int A_TILE = BM * BKP;              // one xq half per stage
  static constexpr int STAGE = 2 * A_TILE + PACKED_TILE;
  static constexpr int MT = WIDE ? 2 : 1;              // m64 tiles a warpgroup
  static constexpr int NW = WIDE ? 128 : 64;           // columns a warpgroup
  static constexpr int ACC = NW / 2;                   // accumulators a tile
};

// Dynamic shared memory: alignment slack, the ring, two pairs of planes,
// the barriers.
template <int BM>
__host__ __device__ constexpr int wgmma_smem() {
  return 1024 + Tile<BM>::STAGES * Tile<BM>::STAGE + 4 * PLANE + 128;
}

// D[64 x 64] (+)= A[64 x 32] B[32 x 64], s8 x s8 -> s32, A and B K-major in
// shared memory.
__device__ __forceinline__ void mma_s8_n64(int (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 x s8 -> s32, A and B K-major in
// shared memory.
__device__ __forceinline__ void mma_s8_n128(int (&d)[64], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// Box (c0 = column, c1 = row) of a 2-D tensor map into shared memory;
// completion counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(hop::smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(hop::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Per byte of v (each in 0..15): the 4-bit two's complement value as int8.
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  return ((v ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// One stage's packed tile (TMA layout: byte (k, n) at k * 128 + ((n / 16)
// ^ (k % 8)) * 16 + n % 16) into the low and high planes (byte (n, k) at
// n * 128 + ((k / 16) ^ (n % 8)) * 16 + k % 16, the layout TMA would give a
// K-major tile). Consumer warp cw (0..7), lane l: packed rows 4l..4l+3,
// columns 16c..16c+15 with c = (l + cw) % 8. Both the 16-byte reads and
// the 4-byte writes of a warp fall on distinct banks.
__device__ __forceinline__ void convert(const unsigned char* packed, unsigned char* lo,
                                        unsigned char* hi, int cw, int lane) {
  const int c = (lane + cw) & 7;
  uint32_t w[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 4 * lane + i;
    const uint4 v = *reinterpret_cast<const uint4*>(packed + k * 128 + ((c ^ (k & 7)) << 4));
    w[i][0] = v.x;
    w[i][1] = v.y;
    w[i][2] = v.z;
    w[i][3] = v.w;
  }
  const int kc = lane >> 2, kb = (lane & 3) * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // transpose the 4 x 4 bytes: col[jj] holds rows 4l..4l+3 of column
    // 16c + 4j + jj
    const uint32_t t0 = __byte_perm(w[0][j], w[1][j], 0x5140);
    const uint32_t t1 = __byte_perm(w[0][j], w[1][j], 0x7362);
    const uint32_t t2 = __byte_perm(w[2][j], w[3][j], 0x5140);
    const uint32_t t3 = __byte_perm(w[2][j], w[3][j], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                             __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = 16 * c + 4 * j + jj;
      const int off = n * 128 + ((kc ^ (n & 7)) << 4) + kb;
      *reinterpret_cast<uint32_t*>(lo + off) = sext4(col[jj] & 0x0F0F0F0Fu);
      *reinterpret_cast<uint32_t*>(hi + off) = sext4((col[jj] >> 4) & 0x0F0F0F0Fu);
    }
  }
}

// Both planes' products of one stage for this warpgroup (issued, not
// committed): rows row0.. of the xq tiles (MT tiles of 64), columns col0..
// of the planes.
template <int BM>
__device__ __forceinline__ void issue_stage(int (&acc)[Tile<BM>::MT][Tile<BM>::ACC],
                                            uint32_t a_lo, uint32_t a_hi, uint32_t b_lo,
                                            uint32_t b_hi, int row0, int col0) {
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    const uint32_t b = (plane ? b_hi : b_lo) + col0 * 128;
#pragma unroll
    for (int mt = 0; mt < Tile<BM>::MT; ++mt) {
      const uint32_t a = (plane ? a_hi : a_lo) + (row0 + 64 * mt) * 128;
#pragma unroll
      for (int kk = 0; kk < BKP / 32; ++kk) {
        const uint64_t da = hop::desc(a + kk * 32, 16, 1024);
        const uint64_t db = hop::desc(b + kk * 32, 16, 1024);
        if constexpr (Tile<BM>::NW == 128) mma_s8_n128(acc[mt], da, db, 1);
        else mma_s8_n64(acc[mt], da, db, 1);
      }
    }
  }
}

// partial == nullptr: write out; else write the int32 sums of split
// blockIdx.z to partial[z, M, N].
template <typename OutT, int BM>
__global__ void __launch_bounds__(WG_THREADS, 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap bmap,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  OutT* __restrict__ out, int* __restrict__ partial, int M, int N,
                  int K) {
  using T = Tile<BM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* planes = base + T::STAGES * T::STAGE;    // [2][lo, hi]
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + 4 * PLANE);
  uint64_t* empty = full + T::STAGES;

  const int half = K / 2;
  const int total = (half + BKP - 1) / BKP;
  const int s0 = blockIdx.z * total / gridDim.z;
  const int nst = (blockIdx.z + 1) * total / gridDim.z - s0;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    if constexpr (T::WIDE) hop::setmaxnreg_dec<24>();
    if (tid == 0) {
      for (int t = 0; t < nst; ++t) {
        const int s = t % T::STAGES, use = t / T::STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* st = base + s * T::STAGE;
        const int p0 = (s0 + t) * BKP;
        hop::mbar_arrive_expect_tx(&full[s], T::STAGE);
        tma_load_2d(st, &amap, &full[s], p0, m0);
        tma_load_2d(st + T::A_TILE, &amap, &full[s], half + p0, m0);
        tma_load_2d(st + 2 * T::A_TILE, &bmap, &full[s], n0, p0);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  if constexpr (T::WIDE) hop::setmaxnreg_inc<240>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int cw = wg * 4 + warp;                       // consumer warp 0..7
  const int row0 = T::WIDE ? 128 * wg : 0;            // this warpgroup's rows
  const int col0 = T::WIDE ? 0 : 64 * wg;             // and columns

  int acc[T::MT][T::ACC];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int i = 0; i < T::ACC; ++i) acc[mt][i] = 0;
  }

  if (nst > 0) {
    hop::mbar_wait(&full[0], 0);
    convert(base + 2 * T::A_TILE, planes, planes + PLANE, cw, lane);
    hop::fence_proxy_async();
    hop::named_sync(1, 256);
  }
  for (int t = 0; t < nst; ++t) {
    const int s = t % T::STAGES;
    const uint32_t st = hop::smem_u32(base + s * T::STAGE);
    const uint32_t pl = hop::smem_u32(planes + (t & 1) * 2 * PLANE);
    hop::wg_fence();
    issue_stage<BM>(acc, st, st + T::A_TILE, pl, pl + PLANE, row0, col0);
    hop::wg_commit();
    if (t + 1 < nst) {
      // convert the next stage while this one's products run
      const int sn = (t + 1) % T::STAGES;
      hop::mbar_wait(&full[sn], ((t + 1) / T::STAGES) & 1);
      unsigned char* next = planes + ((t + 1) & 1) * 2 * PLANE;
      convert(base + sn * T::STAGE + 2 * T::A_TILE, next, next + PLANE, cw, lane);
      hop::fence_proxy_async();
    }
    hop::wg_wait<0>();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) fence_acc(acc[mt]);
    if (tid == 0) hop::mbar_arrive(&empty[s]);
    // the next planes are written and this stage's are no longer read
    hop::named_sync(1, 256);
  }

  // epilogue: rows g and g + 8 of this warp's 16 in each m64 tile,
  // columns 8j + 2tig (+1)
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row0 + 64 * mt + warp * 16 + g + h * 8;
      if (row >= M) continue;
      const int* a = acc[mt];
      if (partial != nullptr) {
        int* prow = partial + ((size_t)blockIdx.z * M + row) * N;
#pragma unroll
        for (int j = 0; j < T::NW / 8; ++j) {
          const int col = n0 + col0 + 8 * j + 2 * tig;
          if (col < N)
            *reinterpret_cast<int2*>(prow + col) = make_int2(a[4 * j + 2 * h],
                                                             a[4 * j + 2 * h + 1]);
        }
      } else {
        const float xrow = xs[row];
#pragma unroll
        for (int j = 0; j < T::NW / 8; ++j) {
          const int col = n0 + col0 + 8 * j + 2 * tig;
          if (col < N)
            store_pair(out, (size_t)row * N + col, epilogue(a[4 * j + 2 * h], xrow, ws[col]),
                       epilogue(a[4 * j + 2 * h + 1], xrow, ws[col + 1]));
        }
      }
    }
  }
}

// Sum the splits of partial [S, M, N] in order and run the epilogue; two
// neighbouring columns a thread.
template <typename OutT>
__global__ void __launch_bounds__(256)
w4a8_reduce_kernel(const int* __restrict__ partial, int S, const float* __restrict__ xs,
                   const float* __restrict__ ws, OutT* __restrict__ out, int M, int N) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 2;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  int a = 0, b = 0;
  for (int s = 0; s < S; ++s) {
    const int2 v = *reinterpret_cast<const int2*>(partial + s * mn + i);
    a += v.x;
    b += v.y;
  }
  const int row = (int)(i / N), col = (int)(i % N);
  const float xrow = xs[row];
  store_pair(out, i, epilogue(a, xrow, ws[col]), epilogue(b, xrow, ws[col + 1]));
}

// Map of an int8 [rows, cols] row-major tensor (cols a multiple of 16):
// boxes of box_rows x 128 bytes, 128-byte swizzle, zeros past the edges.
// Kept per host thread by (base, rows, cols, box_rows): the weight's map is
// encoded once per weight.
struct Map2Key {
  const void* base;
  int rows, cols, box_rows;
  bool operator==(const Map2Key& o) const {
    return base == o.base && rows == o.rows && cols == o.cols && box_rows == o.box_rows;
  }
};

int bytes_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  thread_local Map2Key keys[hop::MAP_CACHE] = {};
  thread_local CUtensorMap maps[hop::MAP_CACHE];
  thread_local int next = 0;
  const Map2Key key{base, rows, cols, box_rows};
  for (int i = 0; i < hop::MAP_CACHE; ++i) {
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  }
  hop::EncodeTiledFn fn = hop::encode_tiled();
  if (fn == nullptr) return hop::ERR_NO_ENCODE;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return hop::ERR_ENCODE;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % hop::MAP_CACHE;
  return 0;
}

template <typename OutT, int BM>
int launch_wgmma(const void* xq, const void* xs, const void* wq4, const void* ws, void* out,
                 void* partial, int M, int N, int K, int split, cudaStream_t stream) {
  CUtensorMap amap, bmap;
  int err = bytes_map(&amap, xq, M, K, BM);
  if (err == 0) err = bytes_map(&bmap, wq4, K / 2, N, BKP);
  if (err != 0) return err;
  constexpr int smem = wgmma_smem<BM>();
  auto kernel = w4a8_wgmma_kernel<OutT, BM>;
  cudaError_t e = hop::max_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, split);
  kernel<<<grid, WG_THREADS, smem, stream>>>(
      amap, bmap, static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<OutT*>(out), split > 1 ? static_cast<int*>(partial) : nullptr, M, N, K);
  e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return static_cast<int>(e);
  const size_t pairs = (size_t)M * N / 2;
  w4a8_reduce_kernel<OutT><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
      static_cast<const int*>(partial), split, static_cast<const float*>(xs),
      static_cast<const float*>(ws), static_cast<OutT*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- general kernel
//
// The first design, for the shapes TMA cannot address: one 256-thread
// block per 128 x 128 output tile; eight warps of 64 x 32 run
// mma.sync.m16n8k32 s8 -> s32. Each stage takes 32 packed rows: the block
// reads them once as packed bytes, splits the two nibble planes in
// registers and stores both, sign-extended and transposed to k-contiguous
// rows, in shared memory; the low plane meets xq[:, p0 : p0+32] and the
// high plane xq[:, K/2+p0 : K/2+p0+32]. The next stage's global loads go
// to registers while the current stage computes. Edges in M, N and K are
// masked with zeros, so any M, N and any even K work.

constexpr int GBM = 128;
constexpr int GBN = 128;
constexpr int TK = 32;            // packed rows per stage
constexpr int LDS = 2 * TK + 16;  // shared row stride in bytes (conflict-free)
constexpr int GTHREADS = 256;      // the general kernel

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Registers holding one stage of global data before it goes to shared.
struct Stage {
  uint4 a[2];       // two 16-byte pieces of xq rows
  uint32_t b[4];    // 4 packed rows x 4 columns of wq4
};

__device__ __forceinline__ void load_stage(Stage& st, const int8_t* xq,
                                           const int8_t* wq4, int M, int N,
                                           int K, int m0, int n0, int p0,
                                           bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  const int half = K / 2;
  // A: 128 rows x 4 pieces (low 0-15, low 16-31, high 0-15, high 16-31)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GTHREADS;
    const int r = c >> 2, part = c & 3;
    const int row = m0 + r;
    const int idx = p0 + (part & 1) * 16;           // packed index of byte 0
    const int col = (part < 2 ? 0 : half) + idx;    // xq column of byte 0
    if (row < M && vec_a && idx + 16 <= half) {
      st.a[i] = *reinterpret_cast<const uint4*>(xq + (size_t)row * K + col);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (row < M && idx + j < half)
          w[j >> 2] |= (uint32_t)(uint8_t)xq[(size_t)row * K + col + j]
                       << (8 * (j & 3));
      st.a[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // B: 8 groups of 4 packed rows x 32 groups of 4 columns
  const int rg = tid >> 5, cg = tid & 31;
  const int col = n0 + cg * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + rg * 4 + j;
    if (p < half && vec_b && col + 4 <= N) {
      st.b[j] = *reinterpret_cast<const uint32_t*>(wq4 + (size_t)p * N + col);
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (p < half && col + c < N)
          w |= (uint32_t)(uint8_t)wq4[(size_t)p * N + col + c] << (8 * c);
      st.b[j] = w;
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, uint8_t* As,
                                            uint8_t* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GTHREADS;
    const int r = c >> 2, part = c & 3;
    *reinterpret_cast<uint4*>(As + r * LDS + part * 16) = st.a[i];
  }
  // split nibbles, sign-extend, transpose to Bs[n][k] (k contiguous)
  const int rg = tid >> 5, cg = tid & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t byte = (uint8_t)(st.b[j] >> (8 * c));
      const int8_t l = (int8_t)(uint8_t)(byte << 4) >> 4;  // low, sign-extended
      const int8_t h = (int8_t)byte >> 4;                  // high, arithmetic
      lo |= (uint32_t)(uint8_t)l << (8 * j);
      hi |= (uint32_t)(uint8_t)h << (8 * j);
    }
    uint8_t* dst = Bs + (cg * 4 + c) * LDS + rg * 4;
    *reinterpret_cast<uint32_t*>(dst) = lo;
    *reinterpret_cast<uint32_t*>(dst + TK) = hi;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(GTHREADS)
w4a8_general_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ wq4, const float* __restrict__ ws,
            OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[GBM * LDS];
  __shared__ __align__(16) uint8_t Bs[GBN * LDS];

  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps of 64 x 32
  const int half = K / 2;
  const bool vec_a = (K % 32) == 0;
  const bool vec_b = (N % 4) == 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Stage st;
  load_stage(st, xq, wq4, M, N, K, m0, n0, 0, vec_a, vec_b);
  store_stage(st, As, Bs);
  __syncthreads();

  const int nstages = (half + TK - 1) / TK;
  for (int s = 0; s < nstages; ++s) {
    const bool more = s + 1 < nstages;
    if (more)
      load_stage(st, xq, wq4, M, N, K, m0, n0, (s + 1) * TK, vec_a, vec_b);
#pragma unroll
    for (int ks = 0; ks < 2 * TK; ks += 32) {     // low plane, high plane
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* base = As + (wm * 64 + mi * 16 + g) * LDS + ks + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
      store_stage(st, As, Bs);
      __syncthreads();
    }
  }

  // epilogue: (float(acc) * xs[row]) * ws[col], round to nearest
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + mi * 16 + g + hr * 8;
      if (row >= M) continue;
      const float xrow = xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < N) {
            const float v = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][hr * 2 + e]), xrow),
                ws[col + e]);
            store_out(out, (size_t)row * N + col + e, v);
          }
        }
      }
    }
  }
}


typedef int (*WgmmaFn)(const void*, const void*, const void*, const void*, void*, void*, int,
                       int, int, int, cudaStream_t);

WgmmaFn pick(int bm, int out_bf16) {
  if (bm == 64) return out_bf16 ? launch_wgmma<__nv_bfloat16, 64> : launch_wgmma<float, 64>;
  if (bm == 256) return out_bf16 ? launch_wgmma<__nv_bfloat16, 256> : launch_wgmma<float, 256>;
  return nullptr;
}

}  // namespace

// The Hopper kernel: K and N multiples of 16, xq and wq4 on 16-byte
// boundaries (the wrapper checks). bm = 256 or 64 rows a block; split >= 1
// ranges of K (split > 1: partial is an int32 [split, M, N] workspace and
// the reduce kernel follows on the same stream). Returns the first error
// (cudaErrorInvalidValue for another bm or split).
extern "C" int w4a8_matmul(const void* xq, const void* xs, const void* wq4, const void* ws,
                           void* out, void* partial, int M, int N, int K, int bm, int split,
                           int out_bf16, void* stream) {
  const WgmmaFn fn = pick(bm, out_bf16);
  const int stages = (K / 2 + BKP - 1) / BKP;
  if (fn == nullptr || split < 1 || split > stages || (split > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return fn(xq, xs, wq4, ws, out, partial, M, N, K, split,
            reinterpret_cast<cudaStream_t>(stream));
}

// The general kernel: any M, N and even K.
extern "C" int w4a8_general(const void* xq, const void* xs, const void* wq4, const void* ws,
                            void* out, int M, int N, int K, int out_bf16, void* stream) {
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16) {
    w4a8_general_kernel<__nv_bfloat16><<<grid, GTHREADS, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(wq4), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    w4a8_general_kernel<float><<<grid, GTHREADS, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(wq4), static_cast<const float*>(ws),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
