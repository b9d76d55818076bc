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
// With q, k the bf16 operands of the forward's product, s = q k^T / sqrt(D),
// P = exp(s - lse), Drow = rowsum(dO*O):
//   dP = dO v^T,  dS = P * (dP - Drow) / sqrt(D)
//   dq = dS k,    dk = dS^T q,    dv = P^T dO
// Inputs: q, dO [BH, Sq, D], k, v [BH, Skv, D] in bf16, 16-byte aligned
// (as given, or fp32 activations rounded to bf16 buffers by one launch of
// the rounding pass, rotate.cuh, from the same C call), D = 64 (SD3's
// heads) or 128 (FLUX's); lse, Drow [BH, Sq]
// f32 (Drow is a torch elementwise pass in the wrapper, as XLA computes it
// in JAX); dq, dk, dv in the activations' dtype (bf16 or fp32), accumulated
// in fp32. Sq and Skv are any lengths >= 1 (the FLUX block experts'
// capacity 171 is ragged).
//
// What bounds it on the H100: the bf16 products. The JAX count is
// 10*Sq*Skv*D flops per (b, h); the two kernels recompute S and dP,
// 14*Sq*Skv*D in all: at S=1536, BH=24, D=128 the 10x count is 73 us at
// 989 TFLOP/s against ~50 MB moved (~15 us at 3.35 TB/s), compute-bound;
// the experts' 171 keys are launch-bound.
//
// Design: the dK/dV and dQ cores of attention_bwd.cuh, 5r/6r's
// (flash_attention_rope_bwd.cu) without the counter-rotation, templated on
// the head dim: wgmma on TMA-loaded 128-byte swizzled tiles, a producer
// warpgroup and two consumer warpgroups, 3-stage rings, no atomics (every
// run gives the same bits). At D = 64 a tile is one 64-column half and the
// dk, dv accumulators halve. One C call encodes four tensor maps with
// 64-row boxes (the kernels load their own 128-row tiles as two boxes), so
// both kernels share them: the block experts' 171-key calls are bound by
// such host work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"
#include "rotate.cuh"

namespace {

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap domap,
                     const float* __restrict__ lse, const float* __restrict__ drow,
                     T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv,
                     float scale, float scale_log2) {
  dkv_core<T, HD, false, BSTEP>(&qmap, &kmap, &vmap, &domap, lse, drow, nullptr, nullptr,
                                dk, dv, Sq, Skv, scale, scale_log2);
}

template <typename T, int HD>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse, const float* __restrict__ drow,
                    T* __restrict__ dq, int Sq, int Skv, float scale,
                    float scale_log2) {
  dq_core<T, HD, false, BSTEP>(&qmap, &kmap, &vmap, &domap, lse, drow, nullptr, nullptr,
                               dq, Sq, Skv, scale, scale_log2);
}

// The kernels whose outputs are given (dk and dv, dq), on the maps m of the
// bf16 operands.
template <typename T, int HD>
int launch(const CUtensorMap (&m)[4], const void* lse, const void* drow, void* dq,
           void* dk, void* dv, int BH, int Sq, int Skv, float scale, float scale_log2,
           void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(drow);
  if (dk != nullptr) {
    constexpr int smem = BwdTiles<HD>::DKV_SMEM;
    const cudaError_t e =
        hop::max_smem(reinterpret_cast<const void*>(flash_bwd_dkv_kernel<T, HD>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dkv_kernel<T, HD><<<dim3((Skv + BROW - 1) / BROW, BH), BWD_THREADS, smem,
                                  st>>>(m[0], m[1], m[2], m[3], l, d, static_cast<T*>(dk),
                                        static_cast<T*>(dv), Sq, Skv, scale, scale_log2);
    const cudaError_t le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
  }
  if (dq != nullptr) {
    constexpr int smem = BwdTiles<HD>::DQ_SMEM;
    const cudaError_t e =
        hop::max_smem(reinterpret_cast<const void*>(flash_bwd_dq_kernel<T, HD>), smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_bwd_dq_kernel<T, HD><<<dim3((Sq + BROW - 1) / BROW, BH), BWD_THREADS, smem,
                                 st>>>(m[0], m[1], m[2], m[3], l, d, static_cast<T*>(dq), Sq,
                                       Skv, scale, scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The rope-free backward: where qb is given, one launch of the rounding pass
// first writes q, k, v, dout (fp32) to the bf16 buffers qb, kb, vb, dob,
// else q, k, v, dout are the bf16 operands (16-byte aligned); then the
// dK/dV kernel where dk (and dv) is given and the dQ kernel where dq is
// given, on one set of tensor maps. The gradients are fp32 where fp32 != 0,
// else bf16. D must be 64 or 128 (cudaErrorInvalidValue otherwise).
// Returns the first error.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* qb, void* kb, void* vb,
                                   void* dob, const void* lse, const void* drow, void* dq,
                                   void* dk, void* dv, int BH, int Sq, int Skv, int D,
                                   float scale, float scale_log2, int fp32, void* stream) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (qb != nullptr) {
    RotJobs jobs = {};
    const void* src[4] = {q, k, v, dout};
    void* dst[4] = {qb, kb, vb, dob};
    const int rows[4] = {Sq, Skv, Skv, Sq};
    for (int i = 0; i < 4; ++i)
      jobs.job[i] = RotJob{src[i], static_cast<__nv_bfloat16*>(dst[i]), nullptr, nullptr,
                           rows[i], D, 1};
    const int err = launch_rotate(jobs, 4, BH, stream);
    if (err != 0) return err;
    q = qb;
    k = kb;
    v = vb;
    dout = dob;
  }
  CUtensorMap m[4];
  const int err = bwd_maps(m, q, k, v, dout, BH, Sq, Skv, BSTEP, BSTEP, D);
  if (err != 0) return err;
  auto fn = D == 64 ? (fp32 ? launch<float, 64> : launch<__nv_bfloat16, 64>)
                    : (fp32 ? launch<float, 128> : launch<__nv_bfloat16, 128>);
  return fn(m, lse, drow, dq, dk, dv, BH, Sq, Skv, scale, scale_log2, stream);
}
