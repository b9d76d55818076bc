// Non-causal attention without rotary for Hopper (sm_90a), plain C interface.
//
// Replaces two Pallas kernels of unigen_tpu/ops/pallas/flash_attention.py:
// `_attn_kernel` (:109) behind `flash_attention` (:162), the full-KV-in-VMEM
// schedule, and `_stream_kernel` (:399) behind `flash_attention_streaming`
// (:523), the online-softmax KV-blocked schedule the TPU takes past 2560
// keys. Both compute
//
//   out = softmax( q . k^T / sqrt(D) ) . v
//
// with fp32 logits and softmax, P rounded to the value dtype for the second
// product and fp32 accumulation. q [BH, Sq, D], k and v [BH, Skv, D] in bf16
// (or fp32, rounded to bf16 where they are staged, out written in fp32),
// D = 64 (the SD3 heads) or 128. Sq and Skv are any lengths >= 1: SD3's are
// ragged (1357, 2381, 4429, 8525, the MoE capacity 683).
//
// What bounds it on the H100: the two bf16 products, 4*Sq*Skv*D flops per
// (b, h). At SD3's joint length 1357 with B*H = 96 that is 45 GFLOP, ~46 us
// at 989 TFLOP/s, against ~67 MB of q, k, v, out (~20 us at 3.35 TB/s):
// compute-bound at every shape of the SD3 and FLUX paths.
//
// Design (simple first version, the schedule of flash_attention_rope.cu
// without the rotation): one 128-thread block per (b*h, 64-row Q tile), four
// warps of 16 rows each. The Q tile is staged once and kept in registers as
// mma A fragments; the block walks the KV length in 64-row tiles, K and V
// copied into shared memory, S = QK^T and O += P.V on the tensor cores with
// mma.sync.m16n8k16 bf16 -> f32, the running max, sum and the fp32 O
// accumulator in registers. One kernel serves both TPU schedules: the TPU's
// full-KV form exists because VMEM holds a whole K/V, which 227 KB of shared
// memory does not. Ragged edges: K/V rows past Skv are staged as zeros and
// their logits masked to -inf before the running max; a tile wholly past Skv
// is never visited (the loop ends at Skv); Q rows past Sq are staged as
// zeros and never stored.
// Under autograd the kernel also writes the fp32 row log-sum-exp
// lse = ln(sum_j exp(s_j / sqrt(D))) [BH, Sq] from its running max and sum,
// the counterpart of the Pallas `_lse_kernel` (:815): the backward
// (flash_attention_bwd.cu) recomputes P = exp(s / sqrt(D) - lse) from it.
// Not yet: cp.async/TMA double buffering, wgmma, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::mma_bf16;
using attn::pack_bf16;
using attn::pack_raw;

constexpr int BQ = 64;       // 4 warps x 16 rows
constexpr int BKV = 64;
constexpr int THREADS = 128;

// T = __nv_bfloat16 or float: the dtype of q, k, v and out; HD = 64 or 128.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Skv, float scale_log2) {
  constexpr int LD = attn::ld_of<HD>();
  // Ks doubles as the Q staging buffer before the first K tile.
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * LD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const T* qb = q + (size_t)bh * Sq * HD;
  const T* kb = k + (size_t)bh * Skv * HD;
  const T* vb = v + (size_t)bh * Skv * HD;

  // Q tile -> A fragments of this warp's 16 rows
  attn::stage_rows<BQ, THREADS, T, HD>(Ks, qb, nullptr, nullptr, q0, Sq);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* base = Ks + (warp * 16 + g) * LD + kk * 16 + tig * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < Skv; j0 += BKV) {
    __syncthreads();                         // previous tile fully consumed
    attn::stage_rows<BKV, THREADS, T, HD>(Ks, kb, nullptr, nullptr, j0, Skv);
    attn::stage_rows<BKV, THREADS, T, HD>(Vs, vb, nullptr, nullptr, j0, Skv);
    __syncthreads();

    // S = Q K^T for 16 x 64 per warp (log2-scaled logits)
    float s[BKV / 8][4];
#pragma unroll
    for (int nb = 0; nb < BKV / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
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
    for (int nd = 0; nd < HD / 8; ++nd) {
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
      for (int nd = 0; nd < HD / 8; ++nd) {
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
    T* orow = out + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      attn::store2(orow + nd * 8 + tig * 2, o[nd][2 * h] * inv,
                   o[nd][2 * h + 1] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int BH, int Sq, int Skv, float scale_log2, void* stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_kernel<T, HD><<<grid, THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 != 0: q, k, v and out are fp32, else bf16. D must be 64 or 128
// (cudaErrorInvalidValue otherwise). lse [BH, Sq] f32, or nullptr when no
// gradient is recorded.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, int BH, int Sq, int Skv,
                               int D, float scale_log2, int fp32, void* stream) {
  if (D == 64)
    return fp32 ? launch<float, 64>(q, k, v, out, lse, BH, Sq, Skv, scale_log2,
                                    stream)
                : launch<__nv_bfloat16, 64>(q, k, v, out, lse, BH, Sq, Skv,
                                            scale_log2, stream);
  if (D == 128)
    return fp32 ? launch<float, 128>(q, k, v, out, lse, BH, Sq, Skv, scale_log2,
                                     stream)
                : launch<__nv_bfloat16, 128>(q, k, v, out, lse, BH, Sq, Skv,
                                             scale_log2, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
