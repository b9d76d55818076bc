// Backward of the rope-free non-causal attention for Hopper (sm_90a), plain
// C interface: two kernels, dQ and dK/dV.
//
// Replaces the Pallas backward kernels behind `_flash_bwd`
// (unigen_tpu/ops/pallas/flash_attention.py:243) and `_flash_stream_bwd`
// (:540), both schedules:
//   full-KV    `_attn_bwd_kernel` (:646, skv <= 2048 at D=128 on the TPU),
//   kv-blocked `_dq_blk_kernel` (:882) and `_dkv_blk_kernel` (:930), whose
//   LSE pass `_lse_kernel` (:815) is the forward kernel's lse output here
//   (flash_attention.cu).
// The TPU split by VMEM size is TPU tuning; one Hopper design serves both.
//
// With q, k rounded to bf16 exactly as the forward stages them,
// s = q k^T / sqrt(D), P = exp(s - lse), Drow = rowsum(dO*O):
//   dP = dO v^T,  dS = P * (dP - Drow) / sqrt(D)
//   dq = dS k,    dk = dS^T q,    dv = P^T dO
// q, dO [BH, Sq, D], k, v [BH, Skv, D] bf16, or all fp32 (staged as bf16
// like the forward's operands, gradients written in fp32), D = 64 (SD3's
// heads) or 128 (FLUX's); lse, Drow [BH, Sq] f32 (Drow is a torch
// elementwise pass in the wrapper, as XLA computes it in JAX); dq, dk, dv in
// the inputs' dtype. Sq and Skv are any lengths >= 1 (the FLUX block
// experts' capacity 171 is ragged).
//
// What bounds it on the H100: the bf16 products. The JAX count is
// 10*Sq*Skv*D flops per (b, h); this design recomputes S and dP in both
// kernels, 14*Sq*Skv*D in all: at S=1536, BH=24, D=128 the 10x count is
// 73 us at 989 TFLOP/s against ~50 MB moved (~15 us at 3.35 TB/s),
// compute-bound; the experts' 171 keys are launch-bound.
//
// Design (simple first version: flash_attention_rope_bwd.cu without the
// rotation and counter-rotation, templated on the head dim as the rope-free
// forward is; mma.sync bf16 -> f32):
// - dK/dV: one 128-thread block per (b*h, 64-row KV tile), four warps of 16
//   KV rows. The K and V tiles stay in shared memory; the block walks Q in
//   32-row tiles (Q, dO, lse and Drow staged in shared memory) and computes
//   S^T = k q^T and dP^T = v dO^T per warp, then dv += P^T dO and
//   dk += dS^T q with P and dS rounded to bf16 for the tensor cores. dk, dv
//   accumulate in fp32 registers: 2 x 16 rows x D / 32 lanes, 128 floats a
//   thread at D=128 (the build line prints ptxas' registers and spills).
// - dQ: one block per (b*h, 64-row Q tile); Q in registers (mma A
//   fragments), dO in shared memory; the block walks KV in 32-row tiles and
//   accumulates dq += dS k.
// Separate kernels need no atomics, so every run gives the same bits.
// Ragged Sq and Skv are masked (P = 0 outside; rows past the end are staged
// as zeros and never stored). Not yet: cp.async/TMA, wgmma, warp
// specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using attn::load_a;
using attn::load_b_cols;
using attn::load_b_rows;
using attn::mma_bf16;
using attn::pack_bf16;

constexpr int THREADS = 128;   // 4 warps x 16 rows
constexpr int BROW = 64;       // rows a block owns (KV rows / Q rows)
constexpr int BSTEP = 32;      // rows of the other side per inner step
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
constexpr int dkv_smem() {
  return (2 * BROW + 2 * BSTEP) * attn::ld_of<HD>() * 2 + 2 * BSTEP * 4;
}

// T = __nv_bfloat16 or float: the dtype of q, k, v, dO and the gradients;
// HD = 64 or 128.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ drow, T* __restrict__ dk,
                     T* __restrict__ dv, int Sq, int Skv, float scale,
                     float scale_log2) {
  constexpr int LD = attn::ld_of<HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BROW * LD;
  __nv_bfloat16* Qs = Vs + BROW * LD;
  __nv_bfloat16* dOs = Qs + BSTEP * LD;
  float* lse2_s = reinterpret_cast<float*>(dOs + BSTEP * LD);
  float* drow_s = lse2_s + BSTEP;

  const int bh = blockIdx.y, kv0 = blockIdx.x * BROW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;                 // this warp's rows in the tile
  const T* qb = q + (size_t)bh * Sq * HD;
  const T* dob = dout + (size_t)bh * Sq * HD;

  attn::stage_rows<BROW, THREADS, T, HD>(Ks, k + (size_t)bh * Skv * HD, nullptr,
                                         nullptr, kv0, Skv);
  attn::stage_rows<BROW, THREADS, T, HD>(Vs, v + (size_t)bh * Skv * HD, nullptr,
                                         nullptr, kv0, Skv);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;
  }

  for (int q0 = 0; q0 < Sq; q0 += BSTEP) {
    __syncthreads();                        // previous Q tile consumed
    attn::stage_rows<BSTEP, THREADS, T, HD>(Qs, qb, nullptr, nullptr, q0, Sq);
    attn::stage_rows<BSTEP, THREADS, T, HD>(dOs, dob, nullptr, nullptr, q0, Sq);
    if (threadIdx.x < BSTEP) {
      const int row = q0 + threadIdx.x;
      const bool in = row < Sq;
      lse2_s[threadIdx.x] = in ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
      drow_s[threadIdx.x] = in ? drow[(size_t)bh * Sq + row] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T: 16 KV rows x 32 Q columns per warp
    float s[BSTEP / 8][4], dp[BSTEP / 8][4];
#pragma unroll
    for (int nb = 0; nb < BSTEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, Ks, wr, kk * 16);
      load_a<LD>(va, Vs, wr, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BSTEP / 8; ++nb) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, Qs, nb * 8, kk * 16);
        mma_bf16(s[nb], ka, b0, b1);
        load_b_rows<LD>(b0, b1, dOs, nb * 8, kk * 16);
        mma_bf16(dp[nb], va, b0, b1);
      }
    }
    // P^T = exp(s - lse[col]) and dS^T = P^T (dP^T - Drow[col]) / sqrt(D)
#pragma unroll
    for (int nb = 0; nb < BSTEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + tig * 2 + (e & 1);
        const float p = q0 + c < Sq
            ? exp2f(s[nb][e] * scale_log2 - lse2_s[c]) : 0.f;
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - drow_s[c]) * scale;
      }
    }
    // dv += P^T dO, dk += dS^T q (P, dS rounded to bf16 A fragments)
#pragma unroll
    for (int kk = 0; kk < BSTEP / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, dOs, kk * 16, nd * 8);
        mma_bf16(acc_v[nd], pa, b0, b1);
        load_b_cols<LD>(b0, b1, Qs, kk * 16, nd * 8);
        mma_bf16(acc_k[nd], da, b0, b1);
      }
    }
  }

  // store rows g and g+8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kv0 + wr + g + h * 8;
    if (row >= Skv) continue;
    T* dkrow = dk + ((size_t)bh * Skv + row) * HD;
    T* dvrow = dv + ((size_t)bh * Skv + row) * HD;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const int col = nd * 8 + tig * 2;
      attn::store2(dkrow + col, acc_k[nd][2 * h], acc_k[nd][2 * h + 1]);
      attn::store2(dvrow + col, acc_v[nd][2 * h], acc_v[nd][2 * h + 1]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ drow, T* __restrict__ dq,
                    int Sq, int Skv, float scale, float scale_log2) {
  constexpr int LD = attn::ld_of<HD>();
  // dOs doubles as the Q staging buffer before dO is staged.
  __shared__ __align__(16) __nv_bfloat16 dOs[BROW * LD];
  __shared__ __align__(16) __nv_bfloat16 Ks[BSTEP * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BSTEP * LD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BROW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = warp * 16;
  const T* kb = k + (size_t)bh * Skv * HD;
  const T* vb = v + (size_t)bh * Skv * HD;

  attn::stage_rows<BROW, THREADS, T, HD>(dOs, q + (size_t)bh * Sq * HD, nullptr,
                                         nullptr, q0, Sq);
  __syncthreads();
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) load_a<LD>(qa[kk], dOs, wr, kk * 16);
  __syncthreads();
  attn::stage_rows<BROW, THREADS, T, HD>(dOs, dout + (size_t)bh * Sq * HD,
                                         nullptr, nullptr, q0, Sq);

  float lse2[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + h * 8;
    lse2[h] = row < Sq ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
    dr[h] = row < Sq ? drow[(size_t)bh * Sq + row] : 0.f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j0 = 0; j0 < Skv; j0 += BSTEP) {
    __syncthreads();                        // previous KV tile consumed
    attn::stage_rows<BSTEP, THREADS, T, HD>(Ks, kb, nullptr, nullptr, j0, Skv);
    attn::stage_rows<BSTEP, THREADS, T, HD>(Vs, vb, nullptr, nullptr, j0, Skv);
    __syncthreads();

    // S = q k^T and dP = dO v^T: 16 Q rows x 32 KV columns per warp
    float s[BSTEP / 8][4], dp[BSTEP / 8][4];
#pragma unroll
    for (int nb = 0; nb < BSTEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t doa[4];
      load_a<LD>(doa, dOs, wr, kk * 16);
#pragma unroll
      for (int nb = 0; nb < BSTEP / 8; ++nb) {
        uint32_t b0, b1;
        load_b_rows<LD>(b0, b1, Ks, nb * 8, kk * 16);
        mma_bf16(s[nb], qa[kk], b0, b1);
        load_b_rows<LD>(b0, b1, Vs, nb * 8, kk * 16);
        mma_bf16(dp[nb], doa, b0, b1);
      }
    }
#pragma unroll
    for (int nb = 0; nb < BSTEP / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j0 + nb * 8 + tig * 2 + (e & 1);
        const int h = e >> 1;
        const float p = col < Skv ? exp2f(s[nb][e] * scale_log2 - lse2[h]) : 0.f;
        dp[nb][e] = p * (dp[nb][e] - dr[h]) * scale;
      }
    }
    // dq += dS k (dS rounded to bf16 A fragments)
#pragma unroll
    for (int kk = 0; kk < BSTEP / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd) {
        uint32_t b0, b1;
        load_b_cols<LD>(b0, b1, Ks, kk * 16, nd * 8);
        mma_bf16(acc[nd], da, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + h * 8;
    if (row >= Sq) continue;
    T* dqrow = dq + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      attn::store2(dqrow + nd * 8 + tig * 2, acc[nd][2 * h], acc[nd][2 * h + 1]);
  }
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* drow, void* dk, void* dv, int BH,
               int Sq, int Skv, float scale, float scale_log2, void* stream) {
  constexpr int smem = dkv_smem<HD>();      // 52,480 bytes at D=128
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Skv + BROW - 1) / BROW, BH);
  flash_bwd_dkv_kernel<T, HD><<<grid, THREADS, smem,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* drow, void* dq, int BH, int Sq,
              int Skv, float scale, float scale_log2, void* stream) {
  const dim3 grid((Sq + BROW - 1) / BROW, BH);
  flash_bwd_dq_kernel<T, HD><<<grid, THREADS, 0,
                               reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<T*>(dq), Sq, Skv, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 != 0: q, k, v, dout and the gradients are fp32, else bf16. D must be
// 64 or 128 (cudaErrorInvalidValue otherwise).
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dk, void* dv, int BH, int Sq,
    int Skv, int D, float scale, float scale_log2, int fp32, void* stream) {
  auto fn = D == 64 ? (fp32 ? launch_dkv<float, 64> : launch_dkv<__nv_bfloat16, 64>)
          : D == 128 ? (fp32 ? launch_dkv<float, 128> : launch_dkv<__nv_bfloat16, 128>)
          : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, dout, lse, drow, dk, dv, BH, Sq, Skv, scale, scale_log2,
            stream);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* drow, void* dq, int BH, int Sq, int Skv,
    int D, float scale, float scale_log2, int fp32, void* stream) {
  auto fn = D == 64 ? (fp32 ? launch_dq<float, 64> : launch_dq<__nv_bfloat16, 64>)
          : D == 128 ? (fp32 ? launch_dq<float, 128> : launch_dq<__nv_bfloat16, 128>)
          : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(q, k, v, dout, lse, drow, dq, BH, Sq, Skv, scale, scale_log2, stream);
}
