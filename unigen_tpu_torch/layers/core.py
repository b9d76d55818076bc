"""Parameter primitives: linear / layer norm / RMS norm / MLP.

Port of ``unigen_tpu/layers/core.py``. ``init_*`` builds a param dict in the
JAX layout (weights [in, out]); the apply functions are plain functions.
Every init takes ``gen`` (a ``torch.Generator`` or None), ``device`` and
``dtype``; on the meta device it only fixes shapes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from unigen_tpu_torch.utils import promote


def _uniform(shape, bound: float, *, gen, device, dtype) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=dtype).uniform_(
        -bound, bound, generator=gen)


# ---------------------------------------------------------------- linear

def init_linear(in_dim: int, out_dim: int, *, bias: bool = True, gen=None,
                device=None, dtype=torch.float32, zero: bool = False) -> dict:
    """Torch-default init U(-k, k), k = 1/sqrt(in_dim); ``zero=True`` gives
    the ControlNet-style zero-init gate linear."""
    if zero:
        p = {"w": torch.zeros(in_dim, out_dim, device=device, dtype=dtype)}
        if bias:
            p["b"] = torch.zeros(out_dim, device=device, dtype=dtype)
        return p
    k = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform((in_dim, out_dim), k, gen=gen, device=device, dtype=dtype)}
    if bias:
        p["b"] = _uniform((out_dim,), k, gen=gen, device=device, dtype=dtype)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "w_q" in p:     # W8A8 serving path
        from unigen_tpu_torch.ops.quant import int8_matmul
        y = int8_matmul(x, p["w_q"], p["w_scale"])
    elif "w_q4" in p:  # W4A8 serving path (nibble-packed)
        from unigen_tpu_torch.ops.quant import int4_matmul
        y = int4_matmul(x, p["w_q4"], p["w_scale"])
    else:
        x, w = promote(x, p["w"])
        y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------- norms

def layer_norm(x: torch.Tensor, *, eps: float = 1e-6,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the last axis, stats in float32."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def init_rms_norm(dim: int, *, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def rms_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 statistics (qk-norm in MMDiT attention)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# ---------------------------------------------------------------- mlp

def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def init_mlp(dim: int, *, mult: int = 4, out_dim: Optional[int] = None,
             gen=None, device=None, dtype=torch.float32) -> dict:
    """FeedForward with gelu-approximate (MMDiT blocks)."""
    hidden = dim * mult
    kw = dict(gen=gen, device=device, dtype=dtype)
    return {"fc1": init_linear(dim, hidden, **kw),
            "fc2": init_linear(hidden, out_dim or dim, **kw)}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], gelu_tanh(linear(p["fc1"], x)))
