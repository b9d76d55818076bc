// Pieces shared by the attention kernels (the fused RoPE forward and
// backward, and the rope-free forward and backward): the bf16 tensor-core
// product, bf16 packing, loads and stores of bf16 or fp32 rows, and the
// staging of a tile of rows into shared memory, rotated in fp32 and rounded
// to bf16 where tables are given. The head dim is 128 for the RoPE kernels
// (attn::D); stage_rows and the fragment loads also take 64 (the rope-free
// kernels' SD3 heads) through the shared row stride ld_of<HD>().
//
// mma.sync.m16n8k16 fragment layout (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 fp32:       c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// A C fragment pair (c0, c1) holds one interleaved rotary pair, so rotating
// or counter-rotating an accumulator is thread-local.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int D = 128;       // head dim of the RoPE kernels
constexpr int LD = D + 8;    // shared row stride in bf16 (conflict-free)

// Shared row stride in bf16 for head dim HD: 16 bytes of padding keep the
// fragment loads of the eight rows a quad group reads on distinct banks.
template <int HD>
__host__ __device__ constexpr int ld_of() { return HD + 8; }

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment of rows [r0, r0+16) and k columns [k0, k0+16) of a row-major
// shared tile of row stride LDS.
template <int LDS = LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const __nv_bfloat16* base = tile + (r0 + g) * LDS + k0 + t * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 8);
}

// B fragment where k runs along a shared tile's row (k = column index):
// B[k][n] = tile[n0 + n][k0 + k], i.e. the product with tile^T.
template <int LDS = LD>
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int n0,
                                            int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const __nv_bfloat16* base = tile + (n0 + g) * LDS + k0 + t * 2;
  b0 = *reinterpret_cast<const uint32_t*>(base);
  b1 = *reinterpret_cast<const uint32_t*>(base + 8);
}

// B fragment where k runs down a shared tile's rows (k = row index):
// B[k][n] = tile[k0 + k][n0 + n], i.e. the product with the tile itself.
template <int LDS = LD>
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile, int k0,
                                            int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const __nv_bfloat16* p = tile + (k0 + t * 2) * LDS + n0 + g;
  b0 = pack_raw(p[0], p[LDS]);
  b1 = pack_raw(p[8 * LDS], p[9 * LDS]);
}

// Eight consecutive elements of a bf16 or fp32 row, as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(v[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// Store one output pair (columns col, col+1) as bf16 or fp32.
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x*cos + rotate_pairs(x)*sin of eight elements at table offset `off`, in
// fp32 with separate roundings (as the plain version), packed to bf16.
__device__ __forceinline__ uint4 rotate8(const float (&xv)[8], const float* cos,
                                         const float* sin, size_t off) {
  const float4 c0 = *reinterpret_cast<const float4*>(cos + off);
  const float4 c1 = *reinterpret_cast<const float4*>(cos + off + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(sin + off);
  const float4 s1 = *reinterpret_cast<const float4*>(sin + off + 4);
  const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  uint32_t w[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const float x0 = xv[2 * p], x1 = xv[2 * p + 1];
    const float o0 = __fadd_rn(__fmul_rn(x0, cs[2 * p]), __fmul_rn(-x1, sn[2 * p]));
    const float o1 = __fadd_rn(__fmul_rn(x1, cs[2 * p + 1]),
                               __fmul_rn(x0, sn[2 * p + 1]));
    w[p] = pack_bf16(o0, o1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stage rows [r0, r0+ROWS) of x (row length HD, bf16 or fp32) into shared
// memory as bf16 with row stride ld_of<HD>(), rotated by the table rows when
// cos != nullptr (then rounded to bf16, as the plain version rounds). bf16
// rows without rotation are copied as they are; fp32 rows are rounded to
// bf16, the tensor cores' operand type. Rows at or past n are zeros, so a
// ragged tail never feeds 0 x garbage (NaN) to a product.
template <int ROWS, int THREADS, typename T, int HD = D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const T* x,
                                           const float* cos, const float* sin,
                                           int r0, int n) {
  constexpr int ldh = ld_of<HD>();
  for (int c = threadIdx.x; c < ROWS * HD / 8; c += THREADS) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    const int row = r0 + r;
    const size_t off = (size_t)row * HD + col;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < n) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        packed = *reinterpret_cast<const uint4*>(x + off);
        if (cos != nullptr) {
          const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&packed);
          float xv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = __bfloat162float(v[i]);
          packed = rotate8(xv, cos, sin, off);
        }
      } else {
        float xv[8];
        load8(x + off, xv);
        if (cos != nullptr) {
          packed = rotate8(xv, cos, sin, off);
        } else {
          packed = make_uint4(pack_bf16(xv[0], xv[1]), pack_bf16(xv[2], xv[3]),
                              pack_bf16(xv[4], xv[5]), pack_bf16(xv[6], xv[7]));
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * ldh + col) = packed;
  }
}

// Counter-rotate one accumulator pair (x0, x1) at table row `row`, columns
// (col, col+1): rotate(x, cos, -sin), the transpose of the pair's rotation
// (exact because the tables are constant within each pair).
__device__ __forceinline__ void counter_rotate(float& x0, float& x1,
                                               const float* cos,
                                               const float* sin, int row,
                                               int col) {
  const float2 c = *reinterpret_cast<const float2*>(cos + (size_t)row * D + col);
  const float2 s = *reinterpret_cast<const float2*>(sin + (size_t)row * D + col);
  const float o0 = x0 * c.x + x1 * s.x;
  const float o1 = x1 * c.y - x0 * s.y;
  x0 = o0;
  x1 = o1;
}

}  // namespace attn
