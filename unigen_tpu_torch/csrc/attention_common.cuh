// Pieces shared by the attention kernels: bf16 packing, loads and stores of
// bf16 or fp32 rows, the rotation of eight elements by their rotary tables
// and the counter-rotation of an accumulator pair. The head dim of the RoPE
// kernels is 128 (attn::D); the rope-free kernels also take 64.
//
// The wgmma accumulator fragment (hopper.cuh) keeps the columns 2t, 2t + 1
// of a row in one thread, so an accumulator pair holds one interleaved
// rotary pair: rotating or counter-rotating it is thread-local.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr int D = 128;       // head dim of the RoPE kernels

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// Eight floats rounded to bf16, packed.
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
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
