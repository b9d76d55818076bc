"""Scaled dot-product attention: plain math and the dispatch to the kernel.

Port of ``unigen_tpu/ops/attention.py``. ``sdpa_ref`` is the plain version
of ``sdpa_xla`` (fp32 logits and softmax, probabilities cast to the value
dtype for the second product); ``sdpa_xla`` is the same function under the
JAX package's name, for the text towers' masked attention, which is plain
XLA there and reaches no kernel. ``sdpa`` with rope tables runs the fused
RoPE attention, without rope the rope-free attention: each a
``torch.autograd.Function`` whose forward and backward are the CUDA kernels
on the card and the plain versions on the CPU. The TPU's split between
full-KV and streaming kernels at 2560 keys has no counterpart: the card's
kernels take any length.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from unigen_tpu_torch.ops.cuda import flash_attention as fa


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q, k, v: [B, H, S, Dh] -> [B, H, Sq, Dh]. Softmax in float32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(q.dtype)


sdpa_xla = sdpa_ref


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         rope=None) -> torch.Tensor:
    """rope: (cos, sin) [S, D] tables, or (cos, sin, kcos, ksin) with
    separate K-side tables (the KV-append convention)."""
    if rope is None:
        return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    cos, sin = rope[0], rope[1]
    kcos, ksin = (rope[2], rope[3]) if len(rope) == 4 else (cos, sin)
    tables = [t.to(torch.float32).contiguous() for t in (cos, sin, kcos, ksin)]
    return fa.flash_attention_rope(q.contiguous(), k.contiguous(),
                                   v.contiguous(), *tables)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*Dh] -> [B, H, S, Dh]."""
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, Dh] -> [B, S, H*Dh]."""
    b, h, s, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * dh)
