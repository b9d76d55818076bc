// The rotation pass of the attention kernels for Hopper (sm_90a): up to
// four jobs per launch (grid.y), each dst = bf16(rot(src)) with the table
// rows of each sequence position (head dim 128), or bf16(src) when cos is
// null (a rounding job: elementwise, any head dim that is a multiple of 8).
// src is [BH, rows, d], bf16 or fp32. It is the TPU kernel's K hoist for
// the RoPE attention, and the rounding of fp32 operands to the tensor
// cores' type for both kinds (the attention cores read bf16 tiles by TMA).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int ROT_THREADS = 256;
constexpr int MAX_JOBS = 4;

struct RotJob {
  const void* src;
  __nv_bfloat16* dst;
  const float* cos;    // [rows, 128] f32, or null: round only
  const float* sin;
  int rows;
  int d;               // row length: 128 where cos is given, else 64 or 128
  int fp32;
};

struct RotJobs {
  RotJob job[MAX_JOBS];
};

// The same arithmetic as the RoPE forward's Q prologue, so kr is
// bit-identical to a K tile rotated while it is staged.
__global__ void __launch_bounds__(ROT_THREADS)
rope_rotate_kernel(RotJobs jobs, int BH) {
  constexpr int D = attn::D;
  const RotJob jb = jobs.job[blockIdx.y];
  const size_t chunks = (size_t)BH * jb.rows * (jb.d / 8);
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
      packed = attn::pack8(xv);
    }
    *reinterpret_cast<uint4*>(jb.dst + off) = packed;
  }
}

// One launch of the rotation pass over jobs[0..njobs).
inline int launch_rotate(const RotJobs& jobs, int njobs, int BH, void* stream) {
  size_t most = 0;
  for (int i = 0; i < njobs; ++i) {
    const size_t chunks = (size_t)BH * jobs.job[i].rows * (jobs.job[i].d / 8);
    most = chunks > most ? chunks : most;
  }
  size_t blocks = (most + ROT_THREADS - 1) / ROT_THREADS;
  blocks = blocks < 132 * 8 ? blocks : 132 * 8;
  rope_rotate_kernel<<<dim3((unsigned)blocks, njobs), ROT_THREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(jobs, BH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
