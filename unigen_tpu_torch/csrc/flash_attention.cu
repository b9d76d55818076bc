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
// with fp32 logits and softmax, P rounded to bf16 for the second product
// and fp32 accumulation. q [BH, Sq, D], k and v [BH, Skv, D] in bf16 (or
// fp32: k and v are rounded to bf16 buffers by one launch of the rounding
// pass, q is rounded in the core's prologue, out is written in fp32), D = 64
// (the SD3 heads) or 128. Sq and Skv are any lengths >= 1: SD3's are ragged
// (1357, 2381, 4429, 8525, the MoE capacity 683).
//
// What bounds it on the H100: the two bf16 products, 4*Sq*Skv*D flops per
// (b, h). At SD3's joint length 1357 with B*H = 96 that is 45 GFLOP, ~46 us
// at 989 TFLOP/s, against ~67 MB of q, k, v, out (~20 us at 3.35 TB/s):
// compute-bound at every shape of the SD3 and FLUX paths. At D = 64 the
// exponentials weigh as much as the products: 1.8e8 logits at that shape
// take ~48 us of MUFU.EX2 at 16 per clock per SM.
//
// Design: the core of attention_fwd.cuh, kernel 1's (flash_attention_rope.cu)
// without the rotation: bf16 Q, K and V by TMA into 128-byte swizzled tiles,
// a producer warpgroup and two consumer warpgroups, S and P V by wgmma, one
// FMA + ex2 per logit, O rescaled only when a row max moves. One kernel
// serves both TPU schedules: the TPU's full-KV form exists because VMEM
// holds a whole K/V, which 227 KB of shared memory does not. The ring has
// two stages at both head dims: at D = 64, 3 and 4 stages and
// FlashAttention-3's overlap of one tile's softmax with the previous
// tile's P V measured no faster (PERF.md, rows 3/4;
// timing/flash_attention_schedules.cu). Under autograd the kernel also
// writes the row log-sum-exp, the counterpart of the Pallas `_lse_kernel`
// (:815).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_fwd.cuh"

namespace {

constexpr int STAGES = 2;

template <typename T, int HD>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap,
             const __grid_constant__ CUtensorMap qmap,
             const T* __restrict__ q, T* __restrict__ out,
             float* __restrict__ lse, int Sq, int Skv, float scale_log2) {
  fwd_core<T, HD, false, STAGES>(&kmap, &vmap, &qmap, q, nullptr, nullptr, out, lse, Sq,
                                 Skv, scale_log2);
}

// kt, vt: bf16 K and V (as given, or the rounding pass's buffers).
template <typename T, int HD>
int launch(const void* q, const void* kt, const void* vt, void* out, void* lse, int BH,
           int Sq, int Skv, float scale_log2, void* stream) {
  CUtensorMap kmap, vmap, qmap;
  int err = hop::rows_map(&kmap, kt, BH, Skv, FWD_BKV, HD);
  if (err == 0) err = hop::rows_map(&vmap, vt, BH, Skv, FWD_BKV, HD);
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (err == 0) err = hop::rows_map(&qmap, q, BH, Sq, FWD_BQ, HD);
  } else {
    qmap = kmap;                    // unused: fp32 q is rounded by the consumers
  }
  if (err != 0) return err;
  constexpr int smem = fwd_smem<HD, STAGES>();
  auto kernel = flash_kernel<T, HD>;
  const cudaError_t e = hop::max_smem(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + FWD_BQ - 1) / FWD_BQ, BH);
  kernel<<<grid, FWD_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      kmap, vmap, qmap, static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Skv, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

typedef int (*LaunchFn)(const void*, const void*, const void*, void*, void*, int, int,
                        int, float, void*);

LaunchFn pick(int fp32, int D) {
  if (D == 64) return fp32 ? launch<float, 64> : launch<__nv_bfloat16, 64>;
  if (D == 128) return fp32 ? launch<float, 128> : launch<__nv_bfloat16, 128>;
  return nullptr;
}

}  // namespace

// fp32 != 0: q, k, v and out are fp32 (k and v are first rounded into the
// bf16 buffers kb and vb, one launch of the rounding pass), else bf16 (kb
// and vb unused; q, k, v 16-byte aligned). D must be 64 or 128
// (cudaErrorInvalidValue otherwise). lse [BH, Sq] f32, or nullptr when no
// gradient is recorded. Returns the first error.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* kb,
                               void* vb, void* out, void* lse, int BH, int Sq, int Skv,
                               int D, float scale_log2, int fp32, void* stream) {
  const LaunchFn fn = pick(fp32, D);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (fp32) {
    RotJobs jobs = {};
    jobs.job[0] = RotJob{k, static_cast<__nv_bfloat16*>(kb), nullptr, nullptr, Skv, D, 1};
    jobs.job[1] = RotJob{v, static_cast<__nv_bfloat16*>(vb), nullptr, nullptr, Skv, D, 1};
    const int err = launch_rotate(jobs, 2, BH, stream);
    if (err != 0) return err;
    return fn(q, kb, vb, out, lse, BH, Sq, Skv, scale_log2, stream);
  }
  return fn(q, k, v, out, lse, BH, Sq, Skv, scale_log2, stream);
}
