// Fused RoPE + non-causal attention for Hopper (sm_90a), plain C interface:
// the rotation pass and the attention forward.
//
// Replaces the Pallas kernel `_attn_rope_kernel` behind
// `flash_attention_rope` (unigen_tpu/ops/pallas/flash_attention.py:128 and
// :262) and its long-KV twin `_stream_rope_kernel` (:416).
//
//   out = softmax( rot(q) . rot(k)^T / sqrt(D) ) . v
//
// q [BH, Sq, D] bf16 (or fp32: the Trainer's fp32 activations; out is then
// written in fp32), D = 128; cos/sin [Sq, D] and kcos/ksin [Skv, D] f32.
// rot() is the interleaved-pair rotation x*cos + rotate_pairs(x)*sin with
// rotate_pairs(x0, x1, ..) = (-x1, x0, ..), taken in fp32 and rounded to
// bf16 before the QK^T product, as the Pallas kernel does. K-side tables may
// carry identity rows (cos=1, sin=0) for KV-append keys.
//
// The rotation pass (rope_rotate) is the TPU kernel's K hoist: the Pallas
// kernel rotates K once per head at program_id(1) == 0 and keeps it in VMEM
// (flash_attention.py:134-137). Blocks on the card run in parallel, so here
// it is a pass of its own: kr = rot(k) into a bf16 [BH, Skv, D] buffer, and
// for fp32 inputs v rounded to bf16, so the core reads only bf16 tiles. The
// backward (flash_attention_rope_bwd.cu) takes its rotated q and k, and its
// bf16 v and dO, from one launch of the same pass. One launch does up to four
// such jobs (grid.y).
//
// What bounds the core on the H100: the two bf16 products, 4*Sq*Skv*D flops
// per (b, h): 29 GFLOP at the main path's S=1536, BH=24, ~29 us at 989
// TFLOP/s, against ~11 us of bytes at 3.35 TB/s. The pass is bytes-bound:
// K read, tables read, kr written.
//
// Design of the core: one block per (b*h, 128 query rows), three
// warpgroups. Warpgroups 0 and 1 compute 64 query rows each; warpgroup 2 is
// the producer, one thread of which keeps TMA loads of 128-key K and V
// tiles (128 x 128 bf16, 128-byte swizzle, two 64-column boxes each) in
// flight through a 2-stage ring under full/empty mbarriers. setmaxnreg moves
// registers from the producer to the consumers. Each consumer rotates its
// own Q rows once in the prologue (the TPU kernel's per-Q-block rotation,
// :139) into the swizzled Q tile, then per KV tile:
//   S = Q K^T    wgmma m64n128k16, both operands in shared memory;
//   the online softmax in registers in the log2 domain, one FMA and one
//   MUFU.EX2 per logit (ragged key tail masked to -inf; TMA fills rows
//   past Skv with zeros);
//   O += P V     wgmma m64n128k16, P rounded to bf16 in registers (the
//   accumulator packs into the A fragment), V read MN-major (transposed B).
// Q rows past Sq are staged as zeros and never stored. Shared memory: the Q
// tile 32 KB + 2 stages x (K + V) 128 KB.
// Under autograd the kernel also writes the fp32 row log-sum-exp
// lse = ln(sum_j exp(s_j / sqrt(D))) [BH, Sq] from its running max and sum,
// the counterpart of the Pallas `_lse_rope_kernel` (:841): the backward
// recomputes P = exp(s / sqrt(D) - lse) from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using attn::D;
using attn::pack_bf16;

// ------------------------------------------------------------- rotation pass

constexpr int ROT_THREADS = 256;
constexpr int MAX_JOBS = 4;

// One job: dst = bf16(rot(src)) with the table rows of each sequence
// position, or bf16(src) when cos is null. src is [BH, rows, D], bf16 or
// fp32.
struct RotJob {
  const void* src;
  __nv_bfloat16* dst;
  const float* cos;
  const float* sin;
  int rows;
  int fp32;
};

struct RotJobs {
  RotJob job[MAX_JOBS];
};

// The same arithmetic as attn::stage_rows, so kr is bit-identical to a K
// tile rotated while it is staged.
__global__ void __launch_bounds__(ROT_THREADS)
rope_rotate_kernel(RotJobs jobs, int BH) {
  const RotJob jb = jobs.job[blockIdx.y];
  const size_t chunks = (size_t)BH * jb.rows * (D / 8);
  for (size_t c = (size_t)blockIdx.x * ROT_THREADS + threadIdx.x; c < chunks;
       c += (size_t)gridDim.x * ROT_THREADS) {
    const size_t off = c * 8;
    float xv[8];
    if (jb.fp32) attn::load8(static_cast<const float*>(jb.src) + off, xv);
    else attn::load8(static_cast<const __nv_bfloat16*>(jb.src) + off, xv);
    uint4 packed;
    if (jb.cos != nullptr) {
      const size_t toff = ((c / (D / 8)) % jb.rows) * D + (c % (D / 8)) * 8;
      packed = attn::rotate8(xv, jb.cos, jb.sin, toff);
    } else {
      packed = make_uint4(pack_bf16(xv[0], xv[1]), pack_bf16(xv[2], xv[3]),
                          pack_bf16(xv[4], xv[5]), pack_bf16(xv[6], xv[7]));
    }
    *reinterpret_cast<uint4*>(jb.dst + off) = packed;
  }
}

// --------------------------------------------------------------------- core

constexpr int BQ = 128;              // query rows per block
constexpr int BKV = 128;             // keys per K/V tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;         // consumers: warpgroups 0, 1; producer: 2
constexpr int TILE_BYTES = 128 * D * 2;                   // 32 KB
constexpr int SMEM_BYTES = 1024 + TILE_BYTES * (1 + 2 * STAGES) + 64;

// T = __nv_bfloat16 or float: the dtype of q and out; kr and v are bf16.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_rope_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const T* __restrict__ q,
                  const float* __restrict__ qcos,
                  const float* __restrict__ qsin,
                  T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv,
                  float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;
  unsigned char* Ks = Qs + TILE_BYTES;                     // stage s at s * 2 tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + TILE_BYTES * (1 + 2 * STAGES));
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int ntiles = (Skv + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
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
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, use = t / STAGES;
        if (use > 0) hop::mbar_wait(&empty[s], (use - 1) & 1);
        unsigned char* kt = Ks + s * 2 * TILE_BYTES;
        hop::mbar_arrive_expect_tx(&full[s], 2 * TILE_BYTES);
        hop::tma_tile(kt, &kmap, &full[s], BKV, t * BKV, bh);
        hop::tma_tile(kt + TILE_BYTES, &vmap, &full[s], BKV, t * BKV, bh);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hop::setmaxnreg_inc<240>();
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int r0 = wg * 64;                     // this warpgroup's Q rows

    // rotate this warpgroup's 64 Q rows into the swizzled Q tile
    const T* qb = q + (size_t)bh * Sq * D;
    for (int c = tid; c < 64 * (D / 8); c += 128) {
      const int r = r0 + c / (D / 8), chunk = c % (D / 8);
      const int row = q0 + r;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (row < Sq) {
        const size_t off = (size_t)row * D + chunk * 8;
        float xv[8];
        attn::load8(qb + off, xv);
        packed = attn::rotate8(xv, qcos, qsin, off);
      }
      hop::store_swizzled(Qs, BQ, r, chunk, packed);
    }
    hop::fence_proxy_async();
    hop::named_sync(1 + wg, 128);

    const uint32_t q_addr = hop::smem_u32(Qs);
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES, j0 = t * BKV;
      hop::mbar_wait(&full[s], (t / STAGES) & 1);
      const uint32_t k_addr = hop::smem_u32(Ks + s * 2 * TILE_BYTES);
      const uint32_t v_addr = k_addr + TILE_BYTES;

      // S = Q K^T: 64 x 128 per warpgroup
      float sc[64];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::mma_n128_ss(sc, hop::desc_k(q_addr, BQ, r0, kk),
                         hop::desc_k(k_addr, BKV, 0, kk), kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(sc);

      // online softmax on rows g (h = 0) and g + 8 (h = 1) of this warp, in
      // the log2 domain: the running max m_run is of the scaled logits, and
      // p = 2^(s * scale_log2 - m_run) is one FMA and one MUFU.EX2
      if (j0 + BKV > Skv) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (j0 + 8 * (i >> 2) + 2 * tig + (i & 1) >= Skv) sc[i] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], rs[2] = {0.f, 0.f}, neg_m[2];
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
      // rescale O only where a row max moved (else alpha is exactly 1)
      if (__any_sync(0xffffffff, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      }

      // O += P V, P rounded to bf16 straight from the S accumulator
      uint32_t pa[BKV / 16][4];
      hop::pack_a<BKV / 16>(pa, sc);
      hop::fence_regs(o);
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        hop::mma_n128_rs_mn(o, pa[kk], hop::desc_mn(v_addr, BKV, kk), 1);
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
      T* orow = out + ((size_t)bh * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        attn::store2(orow + 8 * j + 2 * tig, o[4 * j + 2 * h] * inv,
                     o[4 * j + 2 * h + 1] * inv);
    }
  }
}

// One launch of the rotation pass over jobs[0..njobs).
int launch_rotate(const RotJobs& jobs, int njobs, int BH, void* stream) {
  size_t most = 0;
  for (int i = 0; i < njobs; ++i) {
    const size_t chunks = (size_t)BH * jobs.job[i].rows * (D / 8);
    most = chunks > most ? chunks : most;
  }
  size_t blocks = (most + ROT_THREADS - 1) / ROT_THREADS;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  rope_rotate_kernel<<<dim3((unsigned)blocks, njobs), ROT_THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(jobs, BH);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* kr, const void* v, const void* qcos,
           const void* qsin, void* out, void* lse, int BH, int Sq, int Skv,
           float scale_log2, void* stream) {
  CUtensorMap kmap, vmap;
  int err = hop::rows_map(&kmap, kr, BH, Skv, BKV);
  if (err == 0) err = hop::rows_map(&vmap, v, BH, Skv, BKV);
  if (err != 0) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_rope_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_rope_kernel<T><<<grid, THREADS, SMEM_BYTES,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const T*>(q), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Up to four rotation jobs in one launch: job i writes dst[i] (bf16
// [BH, rows[i], D]) from src[i] (bf16, or fp32 where fp32[i] != 0), rotated
// by cos[i]/sin[i] ([rows[i], D] f32) or only rounded where cos[i] is null.
extern "C" int rope_rotate(const void* const* src, void* const* dst,
                           const void* const* cos, const void* const* sin,
                           const int* rows, const int* fp32, int njobs, int BH,
                           void* stream) {
  if (njobs < 1 || njobs > MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  RotJobs jobs = {};
  for (int i = 0; i < njobs; ++i)
    jobs.job[i] = RotJob{src[i], static_cast<__nv_bfloat16*>(dst[i]),
                         static_cast<const float*>(cos[i]),
                         static_cast<const float*>(sin[i]), rows[i], fp32[i]};
  return launch_rotate(jobs, njobs, BH, stream);
}

// The forward: the rotation pass (kr = rot(k) into the bf16 buffer kr, and
// for fp32 inputs v rounded into the bf16 buffer vb), then the attention
// kernel on kr and v (or vb). q, k, v and out are fp32 where fp32 != 0, else
// bf16 (then vb is unused and v must be 16-byte aligned); all [BH, S, D].
// Two launches; returns the first error.
extern "C" int flash_attention_rope(const void* q, const void* k, const void* v,
                                    const void* qcos, const void* qsin,
                                    const void* kcos, const void* ksin,
                                    void* kr, void* vb, void* out, void* lse,
                                    int BH, int Sq, int Skv, float scale_log2,
                                    int fp32, void* stream) {
  RotJobs jobs = {};
  jobs.job[0] = RotJob{k, static_cast<__nv_bfloat16*>(kr),
                       static_cast<const float*>(kcos),
                       static_cast<const float*>(ksin), Skv, fp32};
  jobs.job[1] = RotJob{v, static_cast<__nv_bfloat16*>(vb), nullptr, nullptr, Skv, 1};
  const int err = launch_rotate(jobs, fp32 ? 2 : 1, BH, stream);
  if (err != 0) return err;
  return fp32 ? launch<float>(q, kr, vb, qcos, qsin, out, lse, BH, Sq, Skv,
                              scale_log2, stream)
              : launch<__nv_bfloat16>(q, kr, v, qcos, qsin, out, lse, BH, Sq,
                                      Skv, scale_log2, stream);
}
