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
// Design: the dK/dV and dQ cores of attention_bwd.cuh (wgmma on TMA-loaded
// tiles, a producer warpgroup, 3-stage rings, no atomics) at D = 128, with
// dk and dq counter-rotated in fp32 on the way out (an accumulator pair is
// one rotary pair).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_bwd.cuh"

namespace {

using attn::D;
constexpr int DKV_SMEM = BwdTiles<D>::DKV_SMEM;
constexpr int DQ_SMEM = BwdTiles<D>::DQ_SMEM;

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
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
  dkv_core<T, D, true, BROW>(&qmap, &kmap, &vmap, &domap, lse, drow, kcos, ksin, dk, dv, Sq,
                       Skv, scale, scale_log2);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, 1)
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
  dq_core<T, D, true, BROW>(&qmap, &kmap, &vmap, &domap, lse, drow, qcos, qsin, dq, Sq, Skv,
                      scale, scale_log2);
}

template <typename T>
int launch_dkv(const void* qr, const void* kr, const void* v, const void* dout,
               const void* lse, const void* drow, const void* kcos,
               const void* ksin, void* dk, void* dv, int BH, int Sq, int Skv,
               float scale, float scale_log2, void* stream) {
  CUtensorMap m[4];
  const int err = bwd_maps(m, qr, kr, v, dout, BH, Sq, Skv, BSTEP, BROW, D);
  if (err != 0) return err;
  const cudaError_t e =
      hop::max_smem(reinterpret_cast<const void*>(flash_rope_bwd_dkv_kernel<T>), DKV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Skv + BROW - 1) / BROW, BH);
  flash_rope_bwd_dkv_kernel<T><<<grid, BWD_THREADS, DKV_SMEM,
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
  const int err = bwd_maps(m, qr, kr, v, dout, BH, Sq, Skv, BROW, BSTEP, D);
  if (err != 0) return err;
  const cudaError_t e =
      hop::max_smem(reinterpret_cast<const void*>(flash_rope_bwd_dq_kernel<T>), DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BROW - 1) / BROW, BH);
  flash_rope_bwd_dq_kernel<T><<<grid, BWD_THREADS, DQ_SMEM,
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
