// The attention forward for Hopper (sm_90a) shared by the RoPE forward
// (flash_attention_rope.cu, kernel 1) and the rope-free one
// (flash_attention.cu, rows 3/4); both take their bf16 K and V from the
// rotation pass (rotate.cuh) where they are rotated or fp32.
//
// The core (fwd_core): one block per (b*h, 128 query rows), three
// warpgroups. Warpgroups 0 and 1 compute 64 query rows each; warpgroup 2 is
// the producer, one thread of which keeps TMA loads of 128-key K and V tiles
// (128 x HD bf16, 128-byte swizzle) in flight through a ring of STAGES
// stages under full/empty mbarriers. setmaxnreg moves registers from the
// producer to the consumers (24/240: the kernel must enter with exactly 168
// registers at 384 threads, or setmaxnreg.inc never returns). The Q tile is
// rotated by the consumers in the prologue (RoPE), rounded by them (fp32
// q), or loaded by the producer with TMA (bf16 q, rope-free). Per KV tile:
//   S = Q K^T    wgmma m64n128k16, both operands in shared memory;
//   the online softmax in registers in the log2 domain, one FMA and one
//   MUFU.EX2 per logit (ragged key tail masked to -inf; TMA fills rows
//   past Skv with zeros);
//   O += P V     wgmma m64nHDk16, P rounded to bf16 in registers (the
//   accumulator packs into the A fragment), V read MN-major (transposed B).
// O is rescaled only when a row max moved. Q rows past Sq are zeros and
// never stored. Under autograd the kernel also writes the fp32 row
// log-sum-exp lse = ln(sum_j exp(s_j / sqrt(D))) [BH, Sq] from its running
// max and sum: the backward recomputes P = exp(s / sqrt(D) - lse) from it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "rotate.cuh"

namespace {

// --------------------------------------------------------------------- core

constexpr int FWD_THREADS = 384;     // consumers: warpgroups 0, 1; producer: 2
constexpr int FWD_BQ = 128;          // query rows per block
constexpr int FWD_BKV = 128;         // keys per K/V tile

// Dynamic shared memory of the core: the Q tile, STAGES x (K, V), barriers.
template <int HD, int STAGES>
__host__ __device__ constexpr int fwd_smem() {
  return 1024 + FWD_BQ * HD * 2 * (1 + 2 * STAGES) + 128;
}

// The online softmax of one 64 x 128 logit tile in place (sc becomes P) on
// rows g (h = 0) and g + 8 (h = 1) of this warp, in the log2 domain: the
// running max m_run is of the scaled logits, and p = 2^(s * scale_log2 -
// m_run) is one FMA and one MUFU.EX2. A tile that holds keys at or past
// Skv has them masked to -inf first. Returns whether a row max moved in
// this warp (alpha != 1).
__device__ __forceinline__ bool online_softmax(float (&sc)[64], int j0, int Skv, int tig,
                                               float scale_log2, float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2]) {
  if (j0 + FWD_BKV > Skv) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (j0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= Skv) sc[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float rs[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffff, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h] * scale_log2);   // finite: j0 < Skv
    alpha[h] = hop::ex2(m_run[h] - m_new);
    m_run[h] = m_new;
    neg_m[h] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = hop::ex2(fmaf(sc[i], scale_log2, neg_m[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 2);
    l_run[h] = l_run[h] * alpha[h] + rs[h];
  }
  return __any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f);
}

// S = Q K^T for this warpgroup's 64 rows against one 128-key tile (issued,
// not committed).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr, int r0,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hop::mma_n128_ss(sc, hop::desc_k(q_addr, FWD_BQ, r0, kk),
                     hop::desc_k(k_addr, FWD_BKV, 0, kk), kk > 0);
}

// O += P V over one 128-key tile (issued, not committed).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&pa)[FWD_BKV / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < FWD_BKV / 16; ++kk) hop::mma_rs_mn<HD>(o, pa[kk], v_addr, FWD_BKV, kk);
}

// The forward of one block. T = __nv_bfloat16 or float: the dtype of q and
// out (K and V are bf16 tiles of kmap, vmap); HD = 64 or 128. ROPE: Q is
// rotated by qcos/qsin in the prologue; else fp32 Q is rounded there and
// bf16 Q is loaded from qmap by TMA.
template <typename T, int HD, bool ROPE, int STAGES>
__device__ __forceinline__ void fwd_core(const CUtensorMap* kmap, const CUtensorMap* vmap,
                                         const CUtensorMap* qmap, const T* __restrict__ q,
                                         const float* __restrict__ qcos,
                                         const float* __restrict__ qsin,
                                         T* __restrict__ out, float* __restrict__ lse,
                                         int Sq, int Skv, float scale_log2) {
  constexpr bool Q_TMA = !ROPE && std::is_same_v<T, __nv_bfloat16>;
  constexpr int TILE = FWD_BQ * HD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + TILE;                      // stage s at s * 2 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + TILE * (1 + 2 * STAGES));
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * FWD_BQ;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int ntiles = (Skv + FWD_BKV - 1) / FWD_BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 2);
    }
    if constexpr (Q_TMA) hop::mbar_init(q_full, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hop::setmaxnreg_dec<24>();
    if (tid == 0) {
      if constexpr (Q_TMA) {
        hop::mbar_arrive_expect_tx(q_full, TILE);
        hop::tma_tile<HD>(Qs, qmap, q_full, FWD_BQ, q0, bh);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* kt = Ks + s * 2 * TILE;
        hop::mbar_arrive_expect_tx(&full[s], 2 * TILE);
        hop::tma_tile<HD>(kt, kmap, &full[s], FWD_BKV, t * FWD_BKV, bh);
        hop::tma_tile<HD>(kt + TILE, vmap, &full[s], FWD_BKV, t * FWD_BKV, bh);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  hop::setmaxnreg_inc<240>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = wg * 64;                       // this warpgroup's Q rows

  if constexpr (Q_TMA) {
    hop::mbar_wait(q_full, 0);
  } else {
    // rotate (RoPE) or round (fp32) this warpgroup's 64 Q rows into the
    // swizzled Q tile
    const T* qb = q + (size_t)bh * Sq * HD;
    for (int c = tid; c < 64 * (HD / 8); c += 128) {
      const int r = r0 + c / (HD / 8), chunk = c % (HD / 8);
      const int row = q0 + r;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (row < Sq) {
        const size_t off = (size_t)row * HD + chunk * 8;
        float xv[8];
        attn::load8(qb + off, xv);
        if constexpr (ROPE) packed = attn::rotate8(xv, qcos, qsin, off);
        else packed = attn::pack8(xv);
      }
      hop::store_swizzled(Qs, FWD_BQ, r, chunk, packed);
    }
    hop::fence_proxy_async();
    hop::named_sync(1 + wg, 128);
  }

  const uint32_t q_addr = hop::smem_u32(Qs);
  const uint32_t ks_addr = hop::smem_u32(Ks);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float alpha[2];

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    hop::mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t k_addr = ks_addr + s * 2 * TILE;
    const uint32_t v_addr = k_addr + TILE;

    float sc[64];
    hop::wg_fence();
    issue_qk<HD>(sc, q_addr, r0, k_addr);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);

    if (online_softmax(sc, t * FWD_BKV, Skv, tig, scale_log2, m_run, l_run, alpha)) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }

    // O += P V, P rounded to bf16 straight from the S accumulator
    uint32_t pa[FWD_BKV / 16][4];
    hop::pack_a<FWD_BKV / 16>(pa, sc);
    hop::fence_regs(o);
    hop::wg_fence();
    issue_pv<HD>(o, pa, v_addr);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(o);
    hop::fence_regs(pa);
    if (tid == 0) hop::mbar_arrive(&empty[s]);
  }

  // normalise and store rows g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + warp * 16 + g + h * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[h];
    if (lse != nullptr && tig == 0)      // logits were scaled by log2(e)
      lse[(size_t)bh * Sq + row] = (m_run[h] + log2f(l_run[h])) * 0.69314718f;
    T* orow = out + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      attn::store2(orow + 8 * j + 2 * tig, o[4 * j + 2 * h] * inv,
                   o[4 * j + 2 * h + 1] * inv);
  }
}

}  // namespace
