// Fused RoPE + non-causal attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_attn_rope_kernel` behind
// `flash_attention_rope` (unigen_tpu/ops/pallas/flash_attention.py:128 and
// :262).
//
//   out = softmax( rot(q) . rot(k)^T / sqrt(D) ) . v
//
// q [BH, Sq, D], k and v [BH, Skv, D] in bf16, D = 128; cos/sin [Sq, D] and
// kcos/ksin [Skv, D] in f32. rot() is the interleaved-pair rotation
// x*cos + rotate_pairs(x)*sin with rotate_pairs(x0, x1, ..) = (-x1, x0, ..),
// taken in fp32 and rounded to bf16 before the QK^T product, as the Pallas
// kernel does. K-side tables may carry identity rows (cos=1, sin=0) for
// KV-append keys; they are just table rows here.
//
// What bounds it on the H100: the two bf16 products, 4*Sq*Skv*D flops per
// (b, h). At the main path's S=1536, BH=24 that is 29 GFLOP, ~29 us at
// 989 TFLOP/s, against ~38 MB moved (~11 us at 3.35 TB/s): compute-bound.
//
// Design (simple first version): the TPU kernel keeps the whole K/V of a
// (b, h) in VMEM and runs one exact softmax; 2560 x 128 bf16 K+V is 1.3 MB
// and does not fit a block's 227 KB of shared memory. So this is an online-
// softmax (flash) schedule: one 128-thread block per (b*h, 64-row Q tile),
// four warps of 16 rows each. The block rotates its Q tile once into
// registers (mma A fragments), then walks the KV length in 64-row tiles:
// each K tile is rotated as it is staged in shared memory, V is copied
// beside it, S = QK^T and O += P.V run on the tensor cores with
// mma.sync.m16n8k16 bf16 -> f32. The running max, sum and the fp32 O
// accumulator stay in registers; P is rounded to bf16 for the P.V product.
// The ragged KV tail is masked to -inf, Q rows past Sq are not stored.
// Because every block re-rotates K, rotation work is Skv*D per Q tile, small
// next to the 2*64*Skv*D product flops of the tile.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;
constexpr int BQ = 64;       // 4 warps x 16 rows
constexpr int BKV = 64;
constexpr int LD = D + 8;    // shared row stride in bf16 (conflict-free)
constexpr int THREADS = 128;

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

// Stage rows [r0, r0+64) of x (row length D) into shared memory, rotated by
// the table rows when cos != nullptr. Rows at or past n are zeros.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* x,
                                           const float* cos, const float* sin,
                                           int r0, int n) {
  for (int c = threadIdx.x; c < 64 * D / 8; c += THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    const int row = r0 + r;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < n) {
      packed = *reinterpret_cast<const uint4*>(x + (size_t)row * D + col);
      if (cos != nullptr) {
        const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&packed);
        const float4 c0 = *reinterpret_cast<const float4*>(cos + (size_t)row * D + col);
        const float4 c1 = *reinterpret_cast<const float4*>(cos + (size_t)row * D + col + 4);
        const float4 s0 = *reinterpret_cast<const float4*>(sin + (size_t)row * D + col);
        const float4 s1 = *reinterpret_cast<const float4*>(sin + (size_t)row * D + col + 4);
        const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sn[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        uint32_t w[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float x0 = __bfloat162float(xv[2 * p]);
          const float x1 = __bfloat162float(xv[2 * p + 1]);
          // x*cos + rot*sin with separate roundings, as the plain version
          const float o0 = __fadd_rn(__fmul_rn(x0, cs[2 * p]),
                                     __fmul_rn(-x1, sn[2 * p]));
          const float o1 = __fadd_rn(__fmul_rn(x1, cs[2 * p + 1]),
                                     __fmul_rn(x0, sn[2 * p + 1]));
          w[p] = pack_bf16(o0, o1);
        }
        packed = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + col) = packed;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_rope_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const float* __restrict__ qcos,
                  const float* __restrict__ qsin,
                  const float* __restrict__ kcos,
                  const float* __restrict__ ksin,
                  __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                  float scale_log2) {
  // Ks doubles as the Q staging buffer before the first K tile.
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * D;

  // rotated Q tile -> A fragments of this warp's 16 rows
  stage_rows(Ks, qb, qcos, qsin, q0, Sq);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* base = Ks + (warp * 16 + g) * LD + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < Skv; j0 += BKV) {
    __syncthreads();                         // previous tile fully consumed
    stage_rows(Ks, kb, kcos, ksin, j0, Skv);
    stage_rows(Vs, vb, nullptr, nullptr, j0, Skv);
    __syncthreads();

    // S = Q K^T for 16 x 64 per warp (log2-scaled logits)
    float s[BKV / 8][4];
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* base = Ks + (nb * 8 + g) * LD + kk * 16 + tig * 2;
        mma_bf16(s[nb], qa[kk], *reinterpret_cast<const uint32_t*>(base),
                 *reinterpret_cast<const uint32_t*>(base + 8));
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nb * 8 + tig * 2 + (e & 1);
        s[nb][e] = col < Skv ? s[nb][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);   // finite: j0 < Skv
      alpha[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = exp2f(s[nb][e] - m_run[e >> 1]);
        rs[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 2);
      l_run[h] = l_run[h] * alpha[h] + rs[h];
    }
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= alpha[0]; o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1]; o[nd][3] *= alpha[1];
    }

    // O += P V, P rounded to bf16 straight from the S fragments
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow = Vs + (kk * 16 + tig * 2) * LD + g;
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        const __nv_bfloat16* vp = vrow + nd * 8;
        const uint32_t b0 = pack_raw(vp[0], vp[LD]);
        const uint32_t b1 = pack_raw(vp[8 * LD], vp[9 * LD]);
        mma_bf16(o[nd], pa, b0, b1);
      }
    }
  }

  // normalise and store rows g and g+8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + h * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[h];
    __nv_bfloat16* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(orow + nd * 8 + tig * 2) =
          pack_bf16(o[nd][2 * h] * inv, o[nd][2 * h + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int flash_attention_rope(const void* q, const void* k, const void* v,
                                    const void* qcos, const void* qsin,
                                    const void* kcos, const void* ksin,
                                    void* out, int BH, int Sq, int Skv,
                                    float scale_log2, void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_rope_kernel<<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<const float*>(kcos),
      static_cast<const float*>(ksin), static_cast<__nv_bfloat16*>(out), Sq, Skv,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}
