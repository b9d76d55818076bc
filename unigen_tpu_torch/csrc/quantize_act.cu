// Per-token int8 activation quantization for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces `_quantize_act` (unigen_tpu/ops/quant.py:75), which is not a
// Pallas kernel: XLA fuses it with the op that produces x. Per row m of x
// [M, K] (bf16 or fp32):
//
//   amax  = max_k |x[m, k]|
//   xs[m] = amax > 0 ? amax / 127 : 1
//   xq[m, k] = int8( clamp( rint(x[m, k] / xs[m]), -127, 127 ) )
//
// with IEEE divisions (__fdiv_rn: a reciprocal times x would change the
// last bit, and with it the code at ties) and round half to even (rintf,
// as torch.round and jnp.round), so for finite x it is bit-identical to
// the plain version. Built without --use_fast_math.
//
// What bounds it on the H100: the bytes, 2 or 4 in and 1 out per element
// (M=2048, K=3072 in bf16: 18.9 MB, 5.6 us at 3.35 TB/s).
//
// Design: one 256-thread block per row. When a row is a whole number of
// 16-byte vectors of x (K a multiple of 8 for bf16, of 4 for fp32) and x
// starts on a 16-byte boundary, each thread loads up to NV vectors once
// into registers (NV = 16 covers K = 32768 bf16 or 16384 fp32), the block
// takes the row max by warp shuffles and shared memory, and each thread
// writes its codes from the same registers (8 or 4 bytes a vector). Other
// rows take the same arithmetic one element at a time, reading x twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < THREADS / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffff, v, o));
  return __shfl_sync(0xffffffff, v, 0);
}

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
}

__device__ __forceinline__ int code(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The values of one 16-byte vector as floats (bf16 widens exactly).
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack4(const int (&c)[4]) {
  return (c[0] & 0xFF) | (c[1] & 0xFF) << 8 | (c[2] & 0xFF) << 16 | (uint32_t)(c[3] & 0xFF) << 24;
}

// NV > 0: the vector path with NV vectors a thread; NV == 0: element by
// element.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                    float* __restrict__ xs, int K) {
  __shared__ float red[THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = xq + (size_t)blockIdx.x * K;
  float amax = 0.f, s;
  if constexpr (NV > 0) {
    constexpr int EPV = 16 / sizeof(T);           // values a vector
    const int nvec = K / EPV;
    uint4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      v[i] = idx < nvec ? reinterpret_cast<const uint4*>(xr)[idx] : make_uint4(0, 0, 0, 0);
      float f[EPV];
      unpack(v[i], f);
#pragma unroll
      for (int e = 0; e < EPV; ++e) amax = fmaxf(amax, fabsf(f[e]));
    }
    s = scale_of(block_max(amax, red));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx >= nvec) continue;
      float f[EPV];
      unpack(v[i], f);
      int c[EPV];
#pragma unroll
      for (int e = 0; e < EPV; ++e) c[e] = code(f[e], s);
      if constexpr (EPV == 8) {
        const int lo[4] = {c[0], c[1], c[2], c[3]}, hi[4] = {c[4], c[5], c[6], c[7]};
        reinterpret_cast<uint2*>(qr)[idx] = make_uint2(pack4(lo), pack4(hi));
      } else {
        reinterpret_cast<uint32_t*>(qr)[idx] = pack4(c);
      }
    }
  } else {
    for (int k = threadIdx.x; k < K; k += THREADS) amax = fmaxf(amax, fabsf(to_float(xr[k])));
    s = scale_of(block_max(amax, red));
    for (int k = threadIdx.x; k < K; k += THREADS)
      qr[k] = static_cast<int8_t>(code(to_float(xr[k]), s));
  }
  if (threadIdx.x == 0) xs[blockIdx.x] = s;
}

template <typename T>
int launch(const void* x, void* xq, void* xs, int M, int K, cudaStream_t stream) {
  constexpr int EPV = 16 / sizeof(T);
  const int nvec = K / EPV;
  const bool vec = K % EPV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   nvec <= 16 * THREADS;
  const int need = (nvec + THREADS - 1) / THREADS;
  void (*kernel)(const T*, int8_t*, float*, int) = &quantize_act_kernel<T, 0>;
  if (vec) {
    kernel = need <= 1 ? &quantize_act_kernel<T, 1>
             : need <= 2 ? &quantize_act_kernel<T, 2>
             : need <= 4 ? &quantize_act_kernel<T, 4>
             : need <= 8 ? &quantize_act_kernel<T, 8>
                         : &quantize_act_kernel<T, 16>;
  }
  kernel<<<M, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(xq),
                                    static_cast<float*>(xs), K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] bf16 (fp32 != 0: fp32), xq int8 [M, K] and xs f32 [M] on
// 16-byte boundaries (the wrapper allocates them). Returns the launch's
// error.
extern "C" int quantize_act(const void* x, void* xq, void* xs, int M, int K, int fp32,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return fp32 ? launch<float>(x, xq, xs, M, K, s) : launch<__nv_bfloat16>(x, xq, xs, M, K, s);
}
