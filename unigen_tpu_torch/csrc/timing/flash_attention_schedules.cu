// Timing-only variants of the rope-free attention forward (flash_attention.cu)
// at head dim 64, bf16, plain C interface. The port never builds or calls
// this library: `python3 chip_smoke.py --schedules` builds it and times each
// variant against the production kernel on the same inputs (PERF.md, rows
// 3/4), so the choice of the production schedule stays reproducible.
//
// schedule = 10 * ring stages + overlap:
//   20, 30, 40  the production core (attention_fwd.cuh) with a ring of 2, 3
//               or 4 K/V stages (20 is the production kernel's schedule);
//   21, 31, 41  FlashAttention-3's intra-warpgroup overlap with 2, 3 or 4
//               stages: tile t's S product is issued together with tile
//               t-1's P V, and the softmax of tile t runs while P V is in
//               flight. The softmax writes P to registers of its own: a
//               non-wgmma write to a wgmma operand while a product is in
//               flight makes ptxas serialise the products (C7513/C7515).
// All run 384 threads with setmaxnreg 24/240, like the production kernel,
// so each must also enter with 168 registers (chip_smoke checks ptxas).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../attention_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int HD = 64;
constexpr int TILE = FWD_BQ * HD * 2;

// The online softmax of one 64 x 128 logit tile sc into p (a separate
// array), as online_softmax in attention_fwd.cuh. MASK: the tile holds keys
// at or past Skv, which read as -inf.
template <bool MASK>
__device__ __forceinline__ bool softmax_into(const float (&sc)[64], float (&p)[64], int j0,
                                             int Skv, int tig, float scale_log2,
                                             float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2]) {
  auto logit = [&](int i) {
    return MASK && j0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= Skv ? -INFINITY : sc[i];
  };
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], logit(i));
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
    p[i] = hop::ex2(fmaf(logit(i), scale_log2, neg_m[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += p[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 1);
    rs[h] += __shfl_xor_sync(0xffffffff, rs[h], 2);
    l_run[h] = l_run[h] * alpha[h] + rs[h];
  }
  return __any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f);
}

template <int STAGES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_stages_kernel(const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap qmap, bf16* __restrict__ out,
                    int Sq, int Skv, float scale_log2) {
  fwd_core<bf16, HD, false, STAGES>(&kmap, &vmap, &qmap, nullptr, nullptr, nullptr, out,
                                    nullptr, Sq, Skv, scale_log2);
}

// fwd_core's block (bf16 Q by TMA, no lse) with the overlapped main loop.
template <int STAGES>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_overlap_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap qmap, bf16* __restrict__ out,
                     int Sq, int Skv, float scale_log2) {
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
    hop::mbar_init(q_full, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------------ producer
    hop::setmaxnreg_dec<24>();
    if (tid == 0) {
      hop::mbar_arrive_expect_tx(q_full, TILE);
      hop::tma_tile<HD>(Qs, &qmap, q_full, FWD_BQ, q0, bh);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* kt = Ks + s * 2 * TILE;
        hop::mbar_arrive_expect_tx(&full[s], 2 * TILE);
        hop::tma_tile<HD>(kt, &kmap, &full[s], FWD_BKV, t * FWD_BKV, bh);
        hop::tma_tile<HD>(kt + TILE, &vmap, &full[s], FWD_BKV, t * FWD_BKV, bh);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumers
  hop::setmaxnreg_inc<240>();
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r0 = wg * 64;                       // this warpgroup's Q rows
  hop::mbar_wait(q_full, 0);

  const uint32_t q_addr = hop::smem_u32(Qs);
  const uint32_t ks_addr = hop::smem_u32(Ks);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float alpha[2];

  // tile 0: S and its softmax (O is still zero: no rescale)
  uint32_t pa[FWD_BKV / 16][4];
  {
    float sc[64];
    hop::mbar_wait(&full[0], 0);
    hop::wg_fence();
    issue_qk<HD>(sc, q_addr, r0, ks_addr);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(sc);
    online_softmax(sc, 0, Skv, tig, scale_log2, m_run, l_run, alpha);
    hop::pack_a<FWD_BKV / 16>(pa, sc);
  }
  for (int t = 1; t < ntiles; ++t) {
    const int s = t % STAGES, sp = (t - 1) % STAGES;
    hop::mbar_wait(&full[s], (t / STAGES) & 1);
    // S_t = Q K_t^T and O += P_{t-1} V_{t-1}, the softmax of S_t under the
    // second product into registers that no product reads or writes; P_t is
    // packed once both are done
    float sc[64], pf[64];
    hop::fence_regs(o);
    hop::fence_regs(pa);
    hop::wg_fence();
    issue_qk<HD>(sc, q_addr, r0, ks_addr + s * 2 * TILE);
    hop::wg_commit();
    issue_pv<HD>(o, pa, ks_addr + sp * 2 * TILE + TILE);
    hop::wg_commit();
    hop::wg_wait<1>();
    hop::fence_regs(sc);
    const int j0 = t * FWD_BKV;
    const bool moved =
        j0 + FWD_BKV > Skv
            ? softmax_into<true>(sc, pf, j0, Skv, tig, scale_log2, m_run, l_run, alpha)
            : softmax_into<false>(sc, pf, j0, Skv, tig, scale_log2, m_run, l_run, alpha);
    hop::wg_wait<0>();
    hop::fence_regs(o);
    hop::fence_regs(pa);
    if (tid == 0) hop::mbar_arrive(&empty[sp]);
    if (moved) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    }
    hop::pack_a<FWD_BKV / 16>(pa, pf);
  }
  const int sl = (ntiles - 1) % STAGES;
  hop::fence_regs(o);
  hop::fence_regs(pa);
  hop::wg_fence();
  issue_pv<HD>(o, pa, ks_addr + sl * 2 * TILE + TILE);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::fence_regs(o);
  hop::fence_regs(pa);
  if (tid == 0) hop::mbar_arrive(&empty[sl]);

  // normalise and store rows g and g + 8 of this warp
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + warp * 16 + g + h * 8;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[h];
    bf16* orow = out + ((size_t)bh * Sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      attn::store2(orow + 8 * j + 2 * tig, o[4 * j + 2 * h] * inv,
                   o[4 * j + 2 * h + 1] * inv);
  }
}

template <int STAGES, bool OVERLAP>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq,
           int Skv, float scale_log2, void* stream) {
  CUtensorMap kmap, vmap, qmap;
  int err = hop::rows_map(&kmap, k, BH, Skv, FWD_BKV, HD);
  if (err == 0) err = hop::rows_map(&vmap, v, BH, Skv, FWD_BKV, HD);
  if (err == 0) err = hop::rows_map(&qmap, q, BH, Sq, FWD_BQ, HD);
  if (err != 0) return err;
  constexpr int smem = fwd_smem<HD, STAGES>();
  auto kernel = OVERLAP ? flash_overlap_kernel<STAGES> : flash_stages_kernel<STAGES>;
  const cudaError_t e = hop::max_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, BH);
  kernel<<<grid, FWD_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, static_cast<bf16*>(out), Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [BH, Sq, 64], k and v [BH, Skv, 64], out [BH, Sq, 64], all bf16 and
// 16-byte aligned; schedule one of those above (cudaErrorInvalidValue
// otherwise). Returns the first error.
extern "C" int flash_attention_schedule(const void* q, const void* k, const void* v,
                                        void* out, int BH, int Sq, int Skv, int schedule,
                                        float scale_log2, void* stream) {
  int (*fn)(const void*, const void*, const void*, void*, int, int, int, float, void*);
  switch (schedule) {
    case 20: fn = launch<2, false>; break;
    case 30: fn = launch<3, false>; break;
    case 40: fn = launch<4, false>; break;
    case 21: fn = launch<2, true>; break;
    case 31: fn = launch<3, true>; break;
    case 41: fn = launch<4, true>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return fn(q, k, v, out, BH, Sq, Skv, scale_log2, stream);
}
