"""SD3 MMDiT blocks: the joint double-stream block (with optional dual
attention) and the self-attention-only single block.

Port of ``unigen_tpu/layers/blocks_sd3.py``. They serve the frozen SD3.5
base stack, the control stack, the shared expert and the block experts.
SD3 attention concatenates the sample stream FIRST (unlike FLUX); a
``context_pre_only`` block (no ``ff_context``) normalizes the context with
AdaLN-continuous and returns no context. temb may be [B, D] or token-wise
[B, S, D].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unigen_tpu_torch.layers.adaln import (adaln_continuous, adaln_sd35x,
                                           adaln_zero, init_adaln, modulate)
from unigen_tpu_torch.layers.attention import init_joint_attention, joint_attention
from unigen_tpu_torch.layers.core import init_mlp, layer_norm, mlp


def init_sd3_joint_block(dim: int, heads: int, head_dim: int, *,
                         context_pre_only: bool = False,
                         qk_norm: Optional[str] = None,
                         use_dual_attention: bool = False,
                         condition_kv: bool = False, **kw) -> dict:
    p = {
        "norm1": init_adaln(dim, 9 if use_dual_attention else 6, **kw),
        "norm1_context": init_adaln(dim, 2 if context_pre_only else 6, **kw),
        "attn": init_joint_attention(dim, heads, head_dim, context=True,
                                     context_pre_only=context_pre_only,
                                     qk_norm=qk_norm, condition_kv=condition_kv,
                                     **kw),
        "ff": init_mlp(dim, **kw),
    }
    if not context_pre_only:
        p["ff_context"] = init_mlp(dim, **kw)
    if use_dual_attention:
        p["attn2"] = init_joint_attention(dim, heads, head_dim, context=False,
                                          qk_norm=qk_norm, **kw)
    return p


def sd3_joint_block(p: dict, x: torch.Tensor, ctx: torch.Tensor,
                    temb: torch.Tensor, rope: Optional[Tuple] = None, *,
                    heads: int,
                    condition_kv_states: Optional[torch.Tensor] = None,
                    context_out: bool = True
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Returns (ctx_out, x_out); ctx_out is None for a context_pre_only
    block, and with ``context_out=False``, which skips every operation whose
    only consumer is ctx_out (the context's attention output projection,
    gates, norm and ``ff_context``); x_out keeps its bits.
    ``condition_kv_states`` feeds the KV-append condition attention
    (cn2base_method="CrossAttn")."""
    dual = "attn2" in p
    if dual:
        nx, g_msa, s_mlp, sc_mlp, g_mlp, nx2, g_msa2 = adaln_sd35x(p["norm1"], x, temb)
    else:
        nx, g_msa, s_mlp, sc_mlp, g_mlp = adaln_zero(p["norm1"], x, temb)

    context_pre_only = "ff_context" not in p
    if context_pre_only:
        nc = adaln_continuous(p["norm1_context"], ctx, temb)
    else:
        nc, cg_msa, cs_mlp, csc_mlp, cg_mlp = adaln_zero(p["norm1_context"], ctx, temb)

    attn_x, attn_c = joint_attention(p["attn"], nx, nc, heads=heads, rope=rope,
                                     context_first=False,
                                     condition_kv_states=condition_kv_states,
                                     context_out=context_out)
    x = x + g_msa * attn_x
    if dual:
        attn_x2, _ = joint_attention(p["attn2"], nx2, None, heads=heads, rope=rope)
        x = x + g_msa2 * attn_x2
    x = x + g_mlp * mlp(p["ff"], modulate(layer_norm(x), s_mlp, sc_mlp))

    if context_pre_only or not context_out:
        return None, x
    ctx = ctx + cg_msa * attn_c
    ctx = ctx + cg_mlp * mlp(p["ff_context"], modulate(layer_norm(ctx), cs_mlp, csc_mlp))
    return ctx, x


def init_sd3_single_block(dim: int, heads: int, head_dim: int, *,
                          qk_norm: Optional[str] = None, **kw) -> dict:
    return {
        "norm1": init_adaln(dim, 6, **kw),
        "attn": init_joint_attention(dim, heads, head_dim, context=False,
                                     qk_norm=qk_norm, **kw),
        "ff": init_mlp(dim, **kw),
    }


def sd3_single_block(p: dict, x: torch.Tensor, temb: torch.Tensor,
                     rope: Optional[Tuple] = None, *, heads: int) -> torch.Tensor:
    nx, g_msa, s_mlp, sc_mlp, g_mlp = adaln_zero(p["norm1"], x, temb)
    attn_x, _ = joint_attention(p["attn"], nx, None, heads=heads, rope=rope)
    x = x + g_msa * attn_x
    return x + g_mlp * mlp(p["ff"], modulate(layer_norm(x), s_mlp, sc_mlp))
