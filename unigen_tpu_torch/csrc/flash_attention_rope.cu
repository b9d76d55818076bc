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
// Design: the core of attention_fwd.cuh (wgmma on TMA-loaded K/V tiles, a
// producer warpgroup, two consumer warpgroups, 2-stage ring), each consumer
// rotating its own 64 Q rows once in the prologue (the TPU kernel's
// per-Q-block rotation, :139) into the swizzled Q tile. Shared memory: the
// Q tile 32 KB + 2 stages x (K + V) 128 KB. Under autograd the kernel also
// writes the row log-sum-exp, the counterpart of the Pallas
// `_lse_rope_kernel` (:841).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_fwd.cuh"

namespace {

constexpr int STAGES = 2;
constexpr int SMEM_BYTES = fwd_smem<attn::D, STAGES>();

// T = __nv_bfloat16 or float: the dtype of q and out; kr and v are bf16.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_rope_kernel(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const T* __restrict__ q,
                  const float* __restrict__ qcos,
                  const float* __restrict__ qsin,
                  T* __restrict__ out,
                  float* __restrict__ lse, int Sq, int Skv,
                  float scale_log2) {
  fwd_core<T, attn::D, true, STAGES>(&kmap, &vmap, &kmap, q, qcos, qsin, out, lse, Sq,
                                     Skv, scale_log2);
}

template <typename T>
int launch(const void* q, const void* kr, const void* v, const void* qcos,
           const void* qsin, void* out, void* lse, int BH, int Sq, int Skv,
           float scale_log2, void* stream) {
  CUtensorMap kmap, vmap;
  int err = hop::rows_map(&kmap, kr, BH, Skv, FWD_BKV);
  if (err == 0) err = hop::rows_map(&vmap, v, BH, Skv, FWD_BKV);
  if (err != 0) return err;
  const cudaError_t e =
      hop::max_smem(reinterpret_cast<const void*>(flash_rope_kernel<T>), SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, BH);
  flash_rope_kernel<T><<<grid, FWD_THREADS, SMEM_BYTES,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, static_cast<const T*>(q), static_cast<const float*>(qcos),
      static_cast<const float*>(qsin), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Up to four rotation jobs in one launch: job i writes dst[i] (bf16
// [BH, rows[i], d[i]]) from src[i] (bf16, or fp32 where fp32[i] != 0),
// rotated by cos[i]/sin[i] ([rows[i], D] f32; d[i] must be D) or only
// rounded where cos[i] is null (d[i] = 64 or 128).
extern "C" int rope_rotate(const void* const* src, void* const* dst,
                           const void* const* cos, const void* const* sin,
                           const int* rows, const int* d, const int* fp32, int njobs,
                           int BH, void* stream) {
  if (njobs < 1 || njobs > MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  RotJobs jobs = {};
  for (int i = 0; i < njobs; ++i) {
    if (cos[i] != nullptr ? d[i] != attn::D : d[i] % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    jobs.job[i] = RotJob{src[i], static_cast<__nv_bfloat16*>(dst[i]),
                         static_cast<const float*>(cos[i]),
                         static_cast<const float*>(sin[i]), rows[i], d[i], fp32[i]};
  }
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
                       static_cast<const float*>(ksin), Skv, attn::D, fp32};
  jobs.job[1] = RotJob{v, static_cast<__nv_bfloat16*>(vb), nullptr, nullptr, Skv,
                       attn::D, 1};
  const int err = launch_rotate(jobs, fp32 ? 2 : 1, BH, stream);
  if (err != 0) return err;
  return fp32 ? launch<float>(q, kr, vb, qcos, qsin, out, lse, BH, Sq, Skv,
                              scale_log2, stream)
              : launch<__nv_bfloat16>(q, kr, v, qcos, qsin, out, lse, BH, Sq,
                                      Skv, scale_log2, stream);
}
