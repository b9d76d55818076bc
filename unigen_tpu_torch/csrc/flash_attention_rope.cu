// Fused RoPE + non-causal attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel `_attn_rope_kernel` behind
// `flash_attention_rope` (unigen_tpu/ops/pallas/flash_attention.py:128 and
// :262).
//
//   out = softmax( rot(q) . rot(k)^T / sqrt(D) ) . v
//
// q [BH, Sq, D], k and v [BH, Skv, D] in bf16 (or fp32: the Trainer's fp32
// activations; rounded to bf16 where they are staged, out written in fp32),
// D = 128; cos/sin [Sq, D] and kcos/ksin [Skv, D] in f32. rot() is the interleaved-pair rotation
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
// Under autograd the kernel also writes the fp32 row log-sum-exp
// lse = ln(sum_j exp(s_j / sqrt(D))) [BH, Sq] from its running max and sum,
// the counterpart of the Pallas `_lse_rope_kernel` (:841): the backward
// (flash_attention_rope_bwd.cu) recomputes P = exp(s / sqrt(D) - lse) from it.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::D;
using attn::LD;
using attn::mma_bf16;
using attn::pack_bf16;
using attn::pack_raw;

constexpr int BQ = 64;       // 4 warps x 16 rows
constexpr int BKV = 64;
constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const T* x,
                                           const float* cos, const float* sin,
                                           int r0, int n) {
  attn::stage_rows<64, THREADS>(dst, x, cos, sin, r0, n);
}

// T = __nv_bfloat16 or float: the dtype of q, k, v and out; the products run
// on bf16 operands either way.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_rope_kernel(const T* __restrict__ q,
                  const T* __restrict__ k,
                  const T* __restrict__ v,
                  const float* __restrict__ qcos,
                  const float* __restrict__ qsin,
                  const float* __restrict__ kcos,
                  const float* __restrict__ ksin,
                  T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv,
                  float scale_log2) {
  // Ks doubles as the Q staging buffer before the first K tile.
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)bh * Skv * D;
  const T* vb = v + (size_t)bh * Skv * D;

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
    if (lse != nullptr && tig == 0)      // logits were scaled by log2(e)
      lse[(size_t)bh * Sq + row] = (m_run[h] + log2f(l_run[h])) * 0.69314718f;
    T* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      attn::store2(orow + nd * 8 + tig * 2, o[nd][2 * h] * inv,
                   o[nd][2 * h + 1] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* qcos,
           const void* qsin, const void* kcos, const void* ksin, void* out,
           void* lse, int BH, int Sq, int Skv, float scale_log2,
           void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_rope_kernel<T><<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<const float*>(kcos),
      static_cast<const float*>(ksin), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 != 0: q, k, v and out are fp32, else bf16.
extern "C" int flash_attention_rope(const void* q, const void* k, const void* v,
                                    const void* qcos, const void* qsin,
                                    const void* kcos, const void* ksin,
                                    void* out, void* lse, int BH, int Sq,
                                    int Skv, float scale_log2, int fp32,
                                    void* stream) {
  return fp32 ? launch<float>(q, k, v, qcos, qsin, kcos, ksin, out, lse, BH,
                              Sq, Skv, scale_log2, stream)
              : launch<__nv_bfloat16>(q, k, v, qcos, qsin, kcos, ksin, out, lse,
                                      BH, Sq, Skv, scale_log2, stream);
}
