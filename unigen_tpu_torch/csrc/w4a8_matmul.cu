// W4A8 dequant-matmul for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas kernel `_w4a8_kernel` / `w4a8_matmul_pallas`
// (unigen_tpu/ops/pallas/quant_matmul.py:57 and :83).
//
//   out[m, n] = bf16( (float(acc[m, n]) * xs[m]) * ws[n] )
//   acc[m, n] = sum_k xq[m, k] * w[k, n]            (exact int32)
//
// xq int8 [M, K] (per-token quantized activations), xs f32 [M, 1],
// wq4 int8 [K/2, N] holding int4 codes HALF-PAIRED along K: packed row j
// carries source row j in its low nibble and source row j + K/2 in its high
// nibble (ops/quant.pack_int4), ws f32 [1, N].
//
// What bounds it on the H100: at the main path's token rows (M = b * 512 to
// b * 1536, K = 3072..15360) the work is int8 tensor-core operations
// (2*M*N*K at 1979 TOP/s, e.g. 15 us at M=1536, K=N=3072). At M = b (the
// temb and AdaLN linears) it is the packed weight read (0.5 B/param, the
// 18432-wide AdaLN weight is 28 MB, ~8 us at 3.35 TB/s).
//
// Design (simple first version): one 256-thread block per 128x128 output
// tile; eight warps of 64x32 run mma.sync.m16n8k32 s8 -> s32 on the tensor
// cores. Each stage takes 32 packed rows: the block reads them once as
// packed bytes (the weight stays at 0.5 B/param in device memory), splits
// the two nibble planes in registers and stores both, sign-extended and
// transposed to k-contiguous rows, in shared memory. The low plane meets
// xq[:, p0 : p0+32] and the high plane xq[:, K/2+p0 : K/2+p0+32], the same
// half-pairing the Pallas kernel exploits, so one stage is 64 deep in k.
// The next stage's global loads go to registers while the current stage
// computes. Edges in M, N and K are masked with zeros, so any M, N and any
// even K work. The epilogue multiplies in the order of the plain version,
// with round-to-nearest intrinsics, so the result is bit-identical.
// Not yet: wgmma, TMA, a deeper pipeline, split-K for the M = b rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int TK = 32;            // packed rows per stage
constexpr int LDS = 2 * TK + 16;  // shared row stride in bytes (conflict-free)
constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* out, size_t i, float v) {
  out[i] = v;
}
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t i,
                                          float v) {
  out[i] = __float2bfloat16_rn(v);
}

// Registers holding one stage of global data before it goes to shared.
struct Stage {
  uint4 a[2];       // two 16-byte pieces of xq rows
  uint32_t b[4];    // 4 packed rows x 4 columns of wq4
};

__device__ __forceinline__ void load_stage(Stage& st, const int8_t* xq,
                                           const int8_t* wq4, int M, int N,
                                           int K, int m0, int n0, int p0,
                                           bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  const int half = K / 2;
  // A: 128 rows x 4 pieces (low 0-15, low 16-31, high 0-15, high 16-31)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, part = c & 3;
    const int row = m0 + r;
    const int idx = p0 + (part & 1) * 16;           // packed index of byte 0
    const int col = (part < 2 ? 0 : half) + idx;    // xq column of byte 0
    if (row < M && vec_a && idx + 16 <= half) {
      st.a[i] = *reinterpret_cast<const uint4*>(xq + (size_t)row * K + col);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (row < M && idx + j < half)
          w[j >> 2] |= (uint32_t)(uint8_t)xq[(size_t)row * K + col + j]
                       << (8 * (j & 3));
      st.a[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // B: 8 groups of 4 packed rows x 32 groups of 4 columns
  const int rg = tid >> 5, cg = tid & 31;
  const int col = n0 + cg * 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + rg * 4 + j;
    if (p < half && vec_b && col + 4 <= N) {
      st.b[j] = *reinterpret_cast<const uint32_t*>(wq4 + (size_t)p * N + col);
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (p < half && col + c < N)
          w |= (uint32_t)(uint8_t)wq4[(size_t)p * N + col + c] << (8 * c);
      st.b[j] = w;
    }
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, uint8_t* As,
                                            uint8_t* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, part = c & 3;
    *reinterpret_cast<uint4*>(As + r * LDS + part * 16) = st.a[i];
  }
  // split nibbles, sign-extend, transpose to Bs[n][k] (k contiguous)
  const int rg = tid >> 5, cg = tid & 31;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t byte = (uint8_t)(st.b[j] >> (8 * c));
      const int8_t l = (int8_t)(uint8_t)(byte << 4) >> 4;  // low, sign-extended
      const int8_t h = (int8_t)byte >> 4;                  // high, arithmetic
      lo |= (uint32_t)(uint8_t)l << (8 * j);
      hi |= (uint32_t)(uint8_t)h << (8 * j);
    }
    uint8_t* dst = Bs + (cg * 4 + c) * LDS + rg * 4;
    *reinterpret_cast<uint32_t*>(dst) = lo;
    *reinterpret_cast<uint32_t*>(dst + TK) = hi;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
w4a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ wq4, const float* __restrict__ ws,
            OutT* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) uint8_t As[BM * LDS];
  __shared__ __align__(16) uint8_t Bs[BN * LDS];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // 2 x 4 warps of 64 x 32
  const int half = K / 2;
  const bool vec_a = (K % 32) == 0;
  const bool vec_b = (N % 4) == 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  Stage st;
  load_stage(st, xq, wq4, M, N, K, m0, n0, 0, vec_a, vec_b);
  store_stage(st, As, Bs);
  __syncthreads();

  const int nstages = (half + TK - 1) / TK;
  for (int s = 0; s < nstages; ++s) {
    const bool more = s + 1 < nstages;
    if (more)
      load_stage(st, xq, wq4, M, N, K, m0, n0, (s + 1) * TK, vec_a, vec_b);
#pragma unroll
    for (int ks = 0; ks < 2 * TK; ks += 32) {     // low plane, high plane
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint8_t* base = As + (wm * 64 + mi * 16 + g) * LDS + ks + tig * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* base = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + tig * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(base);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (more) {
      store_stage(st, As, Bs);
      __syncthreads();
    }
  }

  // epilogue: (float(acc) * xs[row]) * ws[col], round to nearest
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + wm * 64 + mi * 16 + g + hr * 8;
      if (row >= M) continue;
      const float xrow = xs[row];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn * 32 + ni * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < N) {
            const float v = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][hr * 2 + e]), xrow),
                ws[col + e]);
            store_out(out, (size_t)row * N + col + e, v);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int w4a8_matmul(const void* xq, const void* xs, const void* wq4,
                           const void* ws, void* out, int M, int N, int K,
                           int out_bf16, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (out_bf16) {
    w4a8_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(wq4), static_cast<const float*>(ws),
        static_cast<__nv_bfloat16*>(out), M, N, K);
  } else {
    w4a8_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(wq4), static_cast<const float*>(ws),
        static_cast<float*>(out), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}
