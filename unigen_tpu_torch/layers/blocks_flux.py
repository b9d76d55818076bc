"""FLUX MMDiT blocks, double-stream and single-stream.

Port of ``unigen_tpu/layers/blocks_flux.py``. One implementation serves the
frozen base stacks and the control stacks; ``context_first`` picks the
stream order (base: context first; control RoPE blocks: sample first).
temb may be [B, D] or token-wise [B, S, D].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unigen_tpu_torch.layers.adaln import (adaln_zero, adaln_zero_single,
                                           init_adaln, modulate)
from unigen_tpu_torch.layers.attention import init_joint_attention, joint_attention
from unigen_tpu_torch.layers.core import (gelu_tanh, init_linear, init_mlp,
                                          layer_norm, linear, mlp)


def init_flux_double_block(dim: int, heads: int, head_dim: int, **kw) -> dict:
    return {
        "norm1": init_adaln(dim, 6, **kw),
        "norm1_context": init_adaln(dim, 6, **kw),
        "attn": init_joint_attention(dim, heads, head_dim, context=True,
                                     qk_norm="rms_norm", **kw),
        "ff": init_mlp(dim, **kw),
        "ff_context": init_mlp(dim, **kw),
    }


def flux_double_block(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                      temb: torch.Tensor, rope: Optional[Tuple] = None, *,
                      heads: int, context_first: bool = True,
                      context_out: bool = True
                      ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Returns (ctx_out, x_out), the diffusers FluxTransformerBlock order.
    ``context_out=False`` returns (None, x_out) and skips every operation
    whose only consumer is ctx_out (the context's attention output
    projection, gates, norm and ``ff_context``); x_out keeps its bits."""
    nx, g_msa, s_mlp, sc_mlp, g_mlp = adaln_zero(p["norm1"], x, temb)
    nc, cg_msa, cs_mlp, csc_mlp, cg_mlp = adaln_zero(p["norm1_context"], ctx, temb)

    attn_x, attn_c = joint_attention(p["attn"], nx, nc, heads=heads, rope=rope,
                                     context_first=context_first,
                                     context_out=context_out)
    x = x + g_msa * attn_x
    x = x + g_mlp * mlp(p["ff"], modulate(layer_norm(x), s_mlp, sc_mlp))
    if not context_out:
        return None, x

    ctx = ctx + cg_msa * attn_c
    ctx = ctx + cg_mlp * mlp(p["ff_context"], modulate(layer_norm(ctx), cs_mlp, csc_mlp))
    return ctx, x


def init_flux_single_block(dim: int, heads: int, head_dim: int, *,
                           mlp_ratio: int = 4, **kw) -> dict:
    return {
        "norm": init_adaln(dim, 3, **kw),
        "attn": init_joint_attention(dim, heads, head_dim, context=False,
                                     pre_only=True, qk_norm="rms_norm", **kw),
        "proj_mlp": init_linear(dim, dim * mlp_ratio, **kw),
        "proj_out": init_linear(dim + dim * mlp_ratio, dim, **kw),
    }


def flux_single_block(p: dict, x: torch.Tensor, temb: torch.Tensor,
                      rope: Optional[Tuple] = None, *, heads: int) -> torch.Tensor:
    """Parallel attention + MLP with a fused output projection."""
    nx, g = adaln_zero_single(p["norm"], x, temb)
    mlp_h = gelu_tanh(linear(p["proj_mlp"], nx))
    attn_h, _ = joint_attention(p["attn"], nx, None, heads=heads, rope=rope)
    return x + g * linear(p["proj_out"], torch.cat([attn_h, mlp_h], dim=-1))
