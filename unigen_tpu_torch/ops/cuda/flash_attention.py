"""Fused RoPE + attention: the CUDA kernel ``csrc/flash_attention_rope.cu``
and its plain PyTorch version.

Replaces ``unigen_tpu/ops/pallas/flash_attention.py``
(``flash_attention_rope`` -> ``_attn_rope_kernel``): non-causal
softmax(rot(q) rot(k)^T / sqrt(D)) v with interleaved-pair rotary taken in
fp32 and rounded to the input dtype before the product. cos/sin [Sq, D] are
the Q-side tables, kcos/ksin [Skv, D] the K-side ones (identity rows for
KV-append keys). The kernel takes bf16 q, k, v [B, H, S, 128].
"""

from __future__ import annotations

import ctypes
import math

import torch

from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.rope import apply_rotary

KERNEL = "flash_attention_rope"
HEAD_DIM = 128
launches = 0      # kernel launches, counted by the wrapper; reset by callers


def flash_attention_rope_ref(q, k, v, cos, sin, kcos, ksin) -> torch.Tensor:
    """Plain version: rotate (fp32, rounded to the input dtype), then the
    fp32-softmax attention of ``ops/attention.sdpa_ref``."""
    from unigen_tpu_torch.ops.attention import sdpa_ref
    return sdpa_ref(apply_rotary(q, cos, sin), apply_rotary(k, kcos, ksin), v)


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.flash_attention_rope
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q, k, v, cos, sin, kcos, ksin):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_rope: tensors on {dev} are neither "
                         "CPU nor CUDA")
    for name, t, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("cos", cos, torch.float32),
                           ("sin", sin, torch.float32),
                           ("kcos", kcos, torch.float32),
                           ("ksin", ksin, torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"flash_attention_rope: {name} must be a contiguous "
                             f"{dtype} tensor on {dev}, got {t.dtype} on {t.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash_attention_rope: q, k, v must be [B, H, S, D] "
                         "with k and v of one shape")
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or d != HEAD_DIM:
        raise ValueError(f"flash_attention_rope: head dim must be {HEAD_DIM} and "
                         f"q {tuple(q.shape)} must match k {tuple(k.shape)}")
    skv = k.shape[2]
    if cos.shape != (sq, d) or sin.shape != (sq, d) \
            or kcos.shape != (skv, d) or ksin.shape != (skv, d):
        raise ValueError("flash_attention_rope: tables must be [Sq, D] and [Skv, D]")


def flash_attention_rope(q, k, v, cos, sin, kcos, ksin) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D]; cos/sin [Sq,D], kcos/ksin [Skv,D] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch) or raise."""
    if q.device.type == "cpu":
        return flash_attention_rope_ref(q, k, v, cos, sin, kcos, ksin)
    _check(q, k, v, cos, sin, kcos, ksin)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    out = torch.empty_like(q)
    if b * h * sq == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention_rope: empty key sequence")
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    err = _lib().flash_attention_rope(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), kcos.data_ptr(), ksin.data_ptr(), out.data_ptr(),
        b * h, sq, skv, scale_log2,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, KERNEL)
    global launches
    launches += 1
    return out
