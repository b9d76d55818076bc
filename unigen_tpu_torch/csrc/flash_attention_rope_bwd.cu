// Backward of the fused RoPE + non-causal attention for Hopper (sm_90a),
// plain C interface: two kernels, dK/dV and dQ.
//
// Replaces the Pallas backward kernels behind `_flash_rope_bwd`
// (unigen_tpu/ops/pallas/flash_attention.py:341), both schedules:
//   full-KV   `_attn_bwd_rope_kernel` (:670, skv <= 2048 on the TPU),
//   kv-blocked `_dq_blk_rope_kernel` (:904) and `_dkv_blk_rope_kernel`
//   (:958), whose LSE pass `_lse_rope_kernel` (:841) is the forward
//   kernel's lse output here (flash_attention_rope.cu).
// The TPU split by VMEM size is TPU tuning; one Hopper design serves both.
//
// With qr = rot(q), kr = rot(k) rounded to bf16 exactly as the forward
// rotates them, s = qr kr^T / sqrt(D), P = exp(s - lse), Drow = rowsum(dO*O):
//   dP = dO v^T,  dS = P * (dP - Drow) / sqrt(D)
//   dqr = dS kr,  dkr = dS^T qr,  dv = P^T dO
// and dq = rot^T(dqr), dk = rot^T(dkr): the counter-rotation
// rotate(., cos, -sin), exact because the tables are constant within each
// pair (identity rows of KV-append keys included).
// Inputs: qr, kr from the rotation pass (rope_rotate in
// flash_attention_rope.cu, one launch per backward call), v and dO in bf16
// (for fp32 activations rounded by the same launch), all [BH, S, D];
// lse, Drow [BH, Sq] f32 (Drow is a torch elementwise pass in the wrapper,
// as XLA computes it in JAX); tables f32; dq, dk, dv in the activations'
// dtype (bf16 or fp32), accumulated in fp32.
//
// What bounds it on the H100: the bf16 products. The JAX count is
// 10*Sq*Skv*D flops per (b, h); two kernels without atomics recompute S and
// dP, 14*Sq*Skv*D in all: at S=1536, BH=24 the 10x count is 73 us at 989
// TFLOP/s against ~60 MB moved (~18 us at 3.35 TB/s), compute-bound.
//
// Design: warpgroups 0 and 1 compute, warpgroup 2 is the producer (one
// thread issues TMA loads of 128-byte swizzled tiles under mbarriers;
// setmaxnreg moves its registers to the consumers).
// - dK/dV: one block per (b*h, 128 KV rows), 64 per consumer warpgroup. The
//   kr and v tiles are loaded once; 64-row tiles of qr and dO stream through
//   a 3-stage ring, with their lse and Drow rows copied by the producer warp.
//   Per tile: S^T = kr qr^T and dP^T = v dO^T (wgmma m64n64k16, both
//   operands in shared memory), P^T and dS^T in registers, then
//   dv += P^T dO and dkr += dS^T qr (wgmma m64n128k16, P^T and dS^T rounded
//   to bf16 A fragments in registers, dO and qr read MN-major). dk and dv
//   accumulate in fp32 registers; dk is counter-rotated in fp32 on the way
//   out (an accumulator pair is one rotary pair).
// - dQ: one block per (b*h, 128 Q rows); qr and dO loaded once; 64-row
//   tiles of kr and v through a 3-stage ring; S and dP by wgmma from shared
//   memory, dS in registers, dqr += dS kr (register-A wgmma, kr MN-major,
//   left in flight while the next tile's S and dP are issued),
//   counter-rotated on the way out.
// Separate kernels need no atomics, so every run gives the same bits.
// Ragged Sq and Skv: TMA reads rows past the end as zeros and P is masked
// to 0 there; rows past the end are never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using attn::counter_rotate;
using attn::D;

constexpr int THREADS = 384;      // consumers: warpgroups 0, 1; producer: 2
constexpr int BROW = 128;         // rows a block owns (KV rows / Q rows)
constexpr int BSTEP = 64;         // rows of the other side per step
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int OWN_BYTES = BROW * D * 2;      // 32 KB: a 128-row tile
constexpr int STEP_BYTES = BSTEP * D * 2;    // 16 KB: a 64-row tile

// dK/dV: kr, v (own) + STAGES x (qr, dO, lse, Drow) + barriers
constexpr int DKV_SMEM = 1024 + 2 * OWN_BYTES + STAGES * (2 * STEP_BYTES) +
                         STAGES * 2 * BSTEP * 4 + 64;
// dQ: qr, dO (own) + STAGES x (kr, v) + barriers
constexpr int DQ_SMEM = 1024 + 2 * OWN_BYTES + STAGES * 2 * STEP_BYTES + 64;

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_rope_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse,
                          const float* __restrict__ drow,
                          const float* __restrict__ kcos,
                          const float* __restrict__ ksin,
                          T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Skv,
                          float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1k(smem_raw);
  unsigned char* Vs = Ks + OWN_BYTES;
  unsigned char* Qs = Vs + OWN_BYTES;                   // stage s at s * STEP_BYTES
  unsigned char* dOs = Qs + STAGES * STEP_BYTES;
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * STEP_BYTES);  // [STAGES][BSTEP]
  float* drow_s = lse_s + STAGES * BSTEP;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(drow_s + STAGES * BSTEP);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, kv0 = blockIdx.x * BROW;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int ntiles = (Sq + BSTEP - 1) / BSTEP;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 32);      // the producer warp's lanes
      hop::mbar_init(&empty[s], 2);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hop::setmaxnreg_dec<24>();
    if (tid < 32) {
      const int lane = tid;
      if (lane == 0) {
        hop::mbar_arrive_expect_tx(kv_full, 2 * OWN_BYTES);
        hop::tma_tile(Ks, &kmap, kv_full, BROW, kv0, bh);
        hop::tma_tile(Vs, &vmap, kv_full, BROW, kv0, bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES, q0 = t * BSTEP;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        for (int i = lane; i < BSTEP; i += 32) {
          const int row = q0 + i;
          const bool in = row < Sq;
          lse_s[s * BSTEP + i] = in ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
          drow_s[s * BSTEP + i] = in ? drow[(size_t)bh * Sq + row] : 0.f;
        }
        if (lane == 0) {
          hop::mbar_arrive_expect_tx(&full[s], 2 * STEP_BYTES);
          hop::tma_tile(Qs + s * STEP_BYTES, &qmap, &full[s], BSTEP, q0, bh);
          hop::tma_tile(dOs + s * STEP_BYTES, &domap, &full[s], BSTEP, q0, bh);
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::setmaxnreg_inc<240>();
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64;                  // this warpgroup's KV rows
    const uint32_t k_addr = hop::smem_u32(Ks), v_addr = hop::smem_u32(Vs);

    float acc_k[64], acc_v[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_k[i] = acc_v[i] = 0.f;
    hop::mbar_wait(kv_full, 0);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES, q0 = t * BSTEP;
      hop::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t q_addr = hop::smem_u32(Qs + s * STEP_BYTES);
      const uint32_t do_addr = hop::smem_u32(dOs + s * STEP_BYTES);
      const float* lse2 = lse_s + s * BSTEP;
      const float* dr = drow_s + s * BSTEP;

      // S^T = kr qr^T and dP^T = v dO^T: 64 KV rows x 64 Q columns
      float st[32], dpt[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::mma_n64_ss(st, hop::desc_k(k_addr, BROW, r0, kk),
                        hop::desc_k(q_addr, BSTEP, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::mma_n64_ss(dpt, hop::desc_k(v_addr, BROW, r0, kk),
                        hop::desc_k(do_addr, BSTEP, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(st);
      hop::fence_regs(dpt);

      // P^T = exp(s - lse[col]) (0 past Sq), dS^T * sqrt(D) =
      // P^T (dP^T - Drow[col]); the 1 / sqrt(D) is applied to dk at the end
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int c = 8 * (i >> 2) + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dr + c);
        const float p0 = hop::ex2(fmaf(st[i], scale_log2, -l2.x));
        const float p1 = hop::ex2(fmaf(st[i + 1], scale_log2, -l2.y));
        dpt[i] = p0 * (dpt[i] - d2.x);
        dpt[i + 1] = p1 * (dpt[i + 1] - d2.y);
        st[i] = p0;
        st[i + 1] = p1;
      }
      if (q0 + BSTEP > Sq) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (q0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= Sq) st[i] = dpt[i] = 0.f;
        }
      }
      uint32_t pa[BSTEP / 16][4], da[BSTEP / 16][4];
      hop::pack_a<BSTEP / 16>(pa, st);
      hop::pack_a<BSTEP / 16>(da, dpt);

      // dv += P^T dO, dkr += dS^T qr
      hop::fence_regs(acc_v);
      hop::fence_regs(acc_k);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BSTEP / 16; ++kk)
        hop::mma_n128_rs_mn(acc_v, pa[kk], hop::desc_mn(do_addr, BSTEP, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BSTEP / 16; ++kk)
        hop::mma_n128_rs_mn(acc_k, da[kk], hop::desc_mn(q_addr, BSTEP, kk), 1);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(acc_v);
      hop::fence_regs(acc_k);
      hop::fence_regs(pa);
      hop::fence_regs(da);
      if (tid == 0) hop::mbar_arrive(&empty[s]);
    }

    // counter-rotate dk in fp32 and store rows g and g + 8 of this warp
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kv0 + r0 + warp * 16 + g + h * 8;
      if (row >= Skv) continue;
      T* dkrow = dk + ((size_t)bh * Skv + row) * D;
      T* dvrow = dv + ((size_t)bh * Skv + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        float x0 = acc_k[4 * j + 2 * h] * scale, x1 = acc_k[4 * j + 2 * h + 1] * scale;
        counter_rotate(x0, x1, kcos, ksin, row, col);
        attn::store2(dkrow + col, x0, x1);
        attn::store2(dvrow + col, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_rope_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const float* __restrict__ lse,
                         const float* __restrict__ drow,
                         const float* __restrict__ qcos,
                         const float* __restrict__ qsin,
                         T* __restrict__ dq, int Sq, int Skv,
                         float scale, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1k(smem_raw);
  unsigned char* dOs = Qs + OWN_BYTES;
  unsigned char* Ks = dOs + OWN_BYTES;        // stage s at s * 2 * STEP_BYTES, V after K
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(Ks + STAGES * 2 * STEP_BYTES);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * BROW;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int ntiles = (Skv + BSTEP - 1) / BSTEP;

  if (threadIdx.x == 0) {
    hop::mbar_init(qd_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hop::setmaxnreg_dec<24>();
    if (tid == 0) {
      hop::mbar_arrive_expect_tx(qd_full, 2 * OWN_BYTES);
      hop::tma_tile(Qs, &qmap, qd_full, BROW, q0, bh);
      hop::tma_tile(dOs, &domap, qd_full, BROW, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* kt = Ks + s * 2 * STEP_BYTES;
        hop::mbar_arrive_expect_tx(&full[s], 2 * STEP_BYTES);
        hop::tma_tile(kt, &kmap, &full[s], BSTEP, t * BSTEP, bh);
        hop::tma_tile(kt + STEP_BYTES, &vmap, &full[s], BSTEP, t * BSTEP, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::setmaxnreg_inc<240>();
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64;                  // this warpgroup's Q rows
    const uint32_t q_addr = hop::smem_u32(Qs), do_addr = hop::smem_u32(dOs);

    float lse2[2], dr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + warp * 16 + g + h * 8;
      lse2[h] = row < Sq ? lse[(size_t)bh * Sq + row] * LOG2E : 0.f;
      dr[h] = row < Sq ? drow[(size_t)bh * Sq + row] : 0.f;
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    hop::mbar_wait(qd_full, 0);

    // Per KV tile t: S and dP, then dS, then dqr += dS kr issued and left in
    // flight; the next tile's S and dP queue behind it, and one wait retires
    // both (then tile t's stage is released).
    uint32_t da[BSTEP / 16][4];
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES, j0 = t * BSTEP;
      hop::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t k_addr = hop::smem_u32(Ks + s * 2 * STEP_BYTES);
      const uint32_t v_addr = k_addr + STEP_BYTES;

      // S = qr kr^T and dP = dO v^T: 64 Q rows x 64 KV columns
      float sc[32], dp[32];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::mma_n64_ss(sc, hop::desc_k(q_addr, BROW, r0, kk),
                        hop::desc_k(k_addr, BSTEP, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::mma_n64_ss(dp, hop::desc_k(do_addr, BROW, r0, kk),
                        hop::desc_k(v_addr, BSTEP, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sc);
      hop::fence_regs(dp);
      hop::fence_regs(acc);
      hop::fence_regs(da);
      if (t > 0 && tid == 0) hop::mbar_arrive(&empty[(t - 1) % STAGES]);

      // dS * sqrt(D) = P (dP - Drow), 0 past Skv; the 1 / sqrt(D) is
      // applied to dq at the end
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        dp[i] = hop::ex2(fmaf(sc[i], scale_log2, -lse2[h])) * (dp[i] - dr[h]);
      }
      if (j0 + BSTEP > Skv) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (j0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= Skv) dp[i] = 0.f;
        }
      }
      hop::pack_a<BSTEP / 16>(da, dp);

      // dqr += dS kr
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BSTEP / 16; ++kk)
        hop::mma_n128_rs_mn(acc, da[kk], hop::desc_mn(k_addr, BSTEP, kk), 1);
      hop::wg_commit();
    }
    hop::wg_wait<0>();
    hop::fence_regs(acc);
    hop::fence_regs(da);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + r0 + warp * 16 + g + h * 8;
      if (row >= Sq) continue;
      T* dqrow = dq + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tig;
        float x0 = acc[4 * j + 2 * h] * scale, x1 = acc[4 * j + 2 * h + 1] * scale;
        counter_rotate(x0, x1, qcos, qsin, row, col);
        attn::store2(dqrow + col, x0, x1);
      }
    }
  }
}

// The four tensor maps of a backward kernel: qr and dO in boxes of q_box
// rows, kr and v in boxes of kv_box rows.
int maps(CUtensorMap (&m)[4], const void* qr, const void* kr, const void* v,
         const void* dout, int BH, int Sq, int Skv, int q_box, int kv_box) {
  int err = hop::rows_map(&m[0], qr, BH, Sq, q_box);
  if (err == 0) err = hop::rows_map(&m[1], kr, BH, Skv, kv_box);
  if (err == 0) err = hop::rows_map(&m[2], v, BH, Skv, kv_box);
  if (err == 0) err = hop::rows_map(&m[3], dout, BH, Sq, q_box);
  return err;
}

template <typename T>
int launch_dkv(const void* qr, const void* kr, const void* v, const void* dout,
               const void* lse, const void* drow, const void* kcos,
               const void* ksin, void* dk, void* dv, int BH, int Sq, int Skv,
               float scale, float scale_log2, void* stream) {
  CUtensorMap m[4];
  const int err = maps(m, qr, kr, v, dout, BH, Sq, Skv, BSTEP, BROW);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_rope_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DKV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Skv + BROW - 1) / BROW, BH);
  flash_rope_bwd_dkv_kernel<T><<<grid, THREADS, DKV_SMEM,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<const float*>(kcos),
      static_cast<const float*>(ksin), static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* qr, const void* kr, const void* v, const void* dout,
              const void* lse, const void* drow, const void* qcos,
              const void* qsin, void* dq, int BH, int Sq, int Skv, float scale,
              float scale_log2, void* stream) {
  CUtensorMap m[4];
  const int err = maps(m, qr, kr, v, dout, BH, Sq, Skv, BROW, BSTEP);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_rope_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BROW - 1) / BROW, BH);
  flash_rope_bwd_dq_kernel<T><<<grid, THREADS, DQ_SMEM,
                                reinterpret_cast<cudaStream_t>(stream)>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<T*>(dq), Sq, Skv, scale,
      scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qr, kr, v, dout: bf16 [BH, S, D], 16-byte aligned (the rotation pass's
// outputs, and v, dO as given or rounded by the same pass); the gradients
// are fp32 where fp32 != 0, else bf16.
extern "C" int flash_attention_rope_bwd_dkv(
    const void* qr, const void* kr, const void* v, const void* dout,
    const void* lse, const void* drow, const void* kcos, const void* ksin,
    void* dk, void* dv, int BH, int Sq, int Skv, float scale, float scale_log2,
    int fp32, void* stream) {
  return (fp32 ? launch_dkv<float> : launch_dkv<__nv_bfloat16>)(
      qr, kr, v, dout, lse, drow, kcos, ksin, dk, dv, BH, Sq, Skv, scale,
      scale_log2, stream);
}

extern "C" int flash_attention_rope_bwd_dq(
    const void* qr, const void* kr, const void* v, const void* dout,
    const void* lse, const void* drow, const void* qcos, const void* qsin,
    void* dq, int BH, int Sq, int Skv, float scale, float scale_log2, int fp32,
    void* stream) {
  return (fp32 ? launch_dq<float> : launch_dq<__nv_bfloat16>)(
      qr, kr, v, dout, lse, drow, qcos, qsin, dq, BH, Sq, Skv, scale,
      scale_log2, stream);
}
