// The attention backward for Hopper (sm_90a) shared by the RoPE backward
// (flash_attention_rope_bwd.cu, rows 5r/6r) and the rope-free one
// (flash_attention_bwd.cu, rows 5p/6p): a dK/dV and a dQ kernel core.
//
// With q, k the bf16 operands of the forward's product (rotated, for RoPE),
// s = q k^T / sqrt(D), P = exp(s - lse), Drow = rowsum(dO*O):
//   dP = dO v^T,  dS = P * (dP - Drow) / sqrt(D)
//   dq = dS k,    dk = dS^T q,    dv = P^T dO
// and, for RoPE, the gradients of the unrotated q and k are the
// counter-rotations rotate(., cos, -sin) of dq and dk, taken in fp32 in the
// epilogues (exact because the tables are constant within each pair).
// Inputs: q, k, v, dO bf16 [BH, S, HD] (HD = 64 or 128), 16-byte aligned,
// read by TMA; lse, Drow [BH, Sq] f32; the gradients are written in T
// (bf16 or fp32) and accumulated in fp32.
//
// Design: warpgroups 0 and 1 compute, warpgroup 2 is the producer (one
// thread issues TMA loads of 128-byte swizzled tiles under mbarriers;
// setmaxnreg 24/240 moves its registers to the consumers: the kernels must
// enter with exactly 168 registers at 384 threads).
// - dK/dV: one block per (b*h, 128 KV rows), 64 per consumer warpgroup. The
//   k and v tiles are loaded once; 64-row tiles of q and dO stream through
//   a 3-stage ring, with their lse and Drow rows copied by the producer warp.
//   Per tile: S^T = k q^T and dP^T = v dO^T (wgmma m64n64k16, both
//   operands in shared memory), P^T and dS^T in registers, then
//   dv += P^T dO and dk += dS^T q (wgmma m64nHDk16, P^T and dS^T rounded
//   to bf16 A fragments in registers, dO and q read MN-major). dk and dv
//   accumulate in fp32 registers.
// - dQ: one block per (b*h, 128 Q rows); q and dO loaded once; 64-row
//   tiles of k and v through a 3-stage ring; S and dP by wgmma from shared
//   memory, dS in registers, dq += dS k (register-A wgmma, k MN-major, left
//   in flight while the next tile's S and dP are issued).
// 1/sqrt(D) is applied in the epilogues. Separate kernels need no atomics,
// so every run gives the same bits. Ragged Sq and Skv: TMA reads rows past
// the end as zeros and P is masked to 0 there; rows past the end are never
// stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BWD_THREADS = 384;  // consumers: warpgroups 0, 1; producer: 2
constexpr int BROW = 128;         // rows a block owns (KV rows / Q rows)
constexpr int BSTEP = 64;         // rows of the other side per step
constexpr int BWD_STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct BwdTiles {
  static constexpr int OWN = BROW * HD * 2;      // a 128-row tile
  static constexpr int STEP = BSTEP * HD * 2;    // a 64-row tile
  // dK/dV: k, v (own) + STAGES x (q, dO, lse, Drow) + barriers
  static constexpr int DKV_SMEM = 1024 + 2 * OWN + BWD_STAGES * (2 * STEP) +
                                  BWD_STAGES * 2 * BSTEP * 4 + 64;
  // dQ: q, dO (own) + STAGES x (k, v) + barriers
  static constexpr int DQ_SMEM = 1024 + 2 * OWN + BWD_STAGES * 2 * STEP + 64;
};

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// TMA loads of the block's own 128-row tile in boxes of BOX rows (the box
// height of the tensor map: 128, or 64 where both kernels share one set of
// maps).
template <int HD, int BOX>
__device__ __forceinline__ void load_own(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int b = 0; b < BROW / BOX; ++b)
    hop::tma_tile<HD>(dst + b * BOX * 128, map, bar, BROW, row + b * BOX, bh);
}

// The dK/dV kernel of one block; kcos/ksin are read only under ROPE; the k
// and v maps have boxes of OWN_BOX rows, the q and dO maps of BSTEP.
template <typename T, int HD, bool ROPE, int OWN_BOX>
__device__ __forceinline__ void dkv_core(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                         const CUtensorMap* vmap, const CUtensorMap* domap,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ drow,
                                         const float* __restrict__ kcos,
                                         const float* __restrict__ ksin,
                                         T* __restrict__ dk, T* __restrict__ dv, int Sq,
                                         int Skv, float scale, float scale_log2) {
  constexpr int OWN_BYTES = BwdTiles<HD>::OWN, STEP_BYTES = BwdTiles<HD>::STEP;
  constexpr int STAGES = BWD_STAGES;
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
        load_own<HD, OWN_BOX>(Ks, kmap, kv_full, kv0, bh);
        load_own<HD, OWN_BOX>(Vs, vmap, kv_full, kv0, bh);
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
          hop::tma_tile<HD>(Qs + s * STEP_BYTES, qmap, &full[s], BSTEP, q0, bh);
          hop::tma_tile<HD>(dOs + s * STEP_BYTES, domap, &full[s], BSTEP, q0, bh);
        } else {
          hop::mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  hop::setmaxnreg_inc<240>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = wg * 64;                  // this warpgroup's KV rows
  const uint32_t k_addr = hop::smem_u32(Ks), v_addr = hop::smem_u32(Vs);

  float acc_k[HD / 2], acc_v[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  hop::mbar_wait(kv_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, q0 = t * BSTEP;
    hop::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t q_addr = hop::smem_u32(Qs + s * STEP_BYTES);
    const uint32_t do_addr = hop::smem_u32(dOs + s * STEP_BYTES);
    const float* lse2 = lse_s + s * BSTEP;
    const float* dr = drow_s + s * BSTEP;

    // S^T = k q^T and dP^T = v dO^T: 64 KV rows x 64 Q columns
    float st[32], dpt[32];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hop::mma_n64_ss(st, hop::desc_k(k_addr, BROW, r0, kk),
                      hop::desc_k(q_addr, BSTEP, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
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

    // dv += P^T dO, dk += dS^T q
    hop::fence_regs(acc_v);
    hop::fence_regs(acc_k);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BSTEP / 16; ++kk) hop::mma_rs_mn<HD>(acc_v, pa[kk], do_addr, BSTEP, kk);
#pragma unroll
    for (int kk = 0; kk < BSTEP / 16; ++kk) hop::mma_rs_mn<HD>(acc_k, da[kk], q_addr, BSTEP, kk);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc_v);
    hop::fence_regs(acc_k);
    hop::fence_regs(pa);
    hop::fence_regs(da);
    if (tid == 0) hop::mbar_arrive(&empty[s]);
  }

  // store rows g and g + 8 of this warp (dk counter-rotated in fp32 for RoPE)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = kv0 + r0 + warp * 16 + g + h * 8;
    if (row >= Skv) continue;
    T* dkrow = dk + ((size_t)bh * Skv + row) * HD;
    T* dvrow = dv + ((size_t)bh * Skv + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      float x0 = acc_k[4 * j + 2 * h] * scale, x1 = acc_k[4 * j + 2 * h + 1] * scale;
      if constexpr (ROPE) attn::counter_rotate(x0, x1, kcos, ksin, row, col);
      attn::store2(dkrow + col, x0, x1);
      attn::store2(dvrow + col, acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// The dQ kernel of one block; qcos/qsin are read only under ROPE; the q and
// dO maps have boxes of OWN_BOX rows, the k and v maps of BSTEP.
template <typename T, int HD, bool ROPE, int OWN_BOX>
__device__ __forceinline__ void dq_core(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, const CUtensorMap* domap,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ drow,
                                        const float* __restrict__ qcos,
                                        const float* __restrict__ qsin,
                                        T* __restrict__ dq, int Sq, int Skv, float scale,
                                        float scale_log2) {
  constexpr int OWN_BYTES = BwdTiles<HD>::OWN, STEP_BYTES = BwdTiles<HD>::STEP;
  constexpr int STAGES = BWD_STAGES;
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
      load_own<HD, OWN_BOX>(Qs, qmap, qd_full, q0, bh);
      load_own<HD, OWN_BOX>(dOs, domap, qd_full, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* kt = Ks + s * 2 * STEP_BYTES;
        hop::mbar_arrive_expect_tx(&full[s], 2 * STEP_BYTES);
        hop::tma_tile<HD>(kt, kmap, &full[s], BSTEP, t * BSTEP, bh);
        hop::tma_tile<HD>(kt + STEP_BYTES, vmap, &full[s], BSTEP, t * BSTEP, bh);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
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
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  hop::mbar_wait(qd_full, 0);

  // Per KV tile t: S and dP, then dS, then dq += dS k issued and left in
  // flight; the next tile's S and dP queue behind it, and one wait retires
  // both (then tile t's stage is released).
  uint32_t da[BSTEP / 16][4];
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, j0 = t * BSTEP;
    hop::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t k_addr = hop::smem_u32(Ks + s * 2 * STEP_BYTES);
    const uint32_t v_addr = k_addr + STEP_BYTES;

    // S = q k^T and dP = dO v^T: 64 Q rows x 64 KV columns
    float sc[32], dp[32];
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hop::mma_n64_ss(sc, hop::desc_k(q_addr, BROW, r0, kk),
                      hop::desc_k(k_addr, BSTEP, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
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

    // dq += dS k
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BSTEP / 16; ++kk) hop::mma_rs_mn<HD>(acc, da[kk], k_addr, BSTEP, kk);
    hop::wg_commit();
  }
  hop::wg_wait<0>();
  hop::fence_regs(acc);
  hop::fence_regs(da);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + warp * 16 + g + h * 8;
    if (row >= Sq) continue;
    T* dqrow = dq + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      float x0 = acc[4 * j + 2 * h] * scale, x1 = acc[4 * j + 2 * h + 1] * scale;
      if constexpr (ROPE) attn::counter_rotate(x0, x1, qcos, qsin, row, col);
      attn::store2(dqrow + col, x0, x1);
    }
  }
}

// The four tensor maps of a backward kernel: q and dO in boxes of q_box
// rows, k and v in boxes of kv_box rows.
inline int bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                    const void* dout, int BH, int Sq, int Skv, int q_box, int kv_box,
                    int HD) {
  int err = hop::rows_map(&m[0], q, BH, Sq, q_box, HD);
  if (err == 0) err = hop::rows_map(&m[1], k, BH, Skv, kv_box, HD);
  if (err == 0) err = hop::rows_map(&m[2], v, BH, Skv, kv_box, HD);
  if (err == 0) err = hop::rows_map(&m[3], dout, BH, Sq, q_box, HD);
  return err;
}

}  // namespace
