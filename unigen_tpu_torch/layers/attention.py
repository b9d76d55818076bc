"""MMDiT joint attention over concatenated streams.

Port of ``unigen_tpu/layers/attention.py``: the FLUX double block (sample +
context streams, qk RMSNorm, context first or sample first), the single
block (sample stream only, pre_only) and KV-append condition attention
(condition tokens give keys/values only; their keys get identity rotation
rows so one fused kernel call still serves the whole product).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unigen_tpu_torch.layers.core import init_linear, init_rms_norm, linear, rms_norm
from unigen_tpu_torch.ops.attention import merge_heads, sdpa, split_heads


def init_joint_attention(dim: int, heads: int, head_dim: int, *,
                         context: bool = True, context_pre_only: bool = False,
                         pre_only: bool = False,
                         qk_norm: Optional[str] = "rms_norm",
                         added_qk_norm: Optional[str] = None,
                         condition_kv: bool = False, gen=None, device=None,
                         dtype=torch.float32) -> dict:
    inner = heads * head_dim
    kw = dict(gen=gen, device=device, dtype=dtype)
    nkw = dict(device=device, dtype=dtype)
    p = {"to_q": init_linear(dim, inner, **kw),
         "to_k": init_linear(dim, inner, **kw),
         "to_v": init_linear(dim, inner, **kw)}
    if qk_norm == "rms_norm":
        p["norm_q"] = init_rms_norm(head_dim, **nkw)
        p["norm_k"] = init_rms_norm(head_dim, **nkw)
    if not pre_only:
        p["to_out"] = init_linear(inner, dim, **kw)
    if context:
        p["add_q"] = init_linear(dim, inner, **kw)
        p["add_k"] = init_linear(dim, inner, **kw)
        p["add_v"] = init_linear(dim, inner, **kw)
        aqk = qk_norm if added_qk_norm is None else added_qk_norm
        if aqk == "rms_norm":
            p["norm_added_q"] = init_rms_norm(head_dim, **nkw)
            p["norm_added_k"] = init_rms_norm(head_dim, **nkw)
        if not context_pre_only:
            p["to_add_out"] = init_linear(inner, dim, **kw)
    if condition_kv:
        p["condition_k"] = init_linear(dim, inner, **kw)
        p["condition_v"] = init_linear(dim, inner, **kw)
        if qk_norm == "rms_norm":
            p["condition_k_norm"] = init_rms_norm(head_dim, **nkw)
    return p


def joint_attention(p: dict, x: torch.Tensor, ctx: Optional[torch.Tensor] = None,
                    *, heads: int, rope: Optional[Tuple] = None,
                    context_first: bool = True,
                    condition_kv_states: Optional[torch.Tensor] = None,
                    context_out: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (x_out, ctx_out); ctx_out is None without a context stream,
    for a context_pre_only module, or with ``context_out=False`` (the
    caller discards it: its output projection is skipped, while the
    context's q/k/v still enter the attention). rope: (cos, sin) over the
    concatenated sequence in concat order."""
    sx = x.shape[1]
    q = split_heads(linear(p["to_q"], x), heads)
    k = split_heads(linear(p["to_k"], x), heads)
    v = split_heads(linear(p["to_v"], x), heads)
    if "norm_q" in p:
        q = rms_norm(p["norm_q"], q)
        k = rms_norm(p["norm_k"], k)

    if ctx is not None:
        cq = split_heads(linear(p["add_q"], ctx), heads)
        ck = split_heads(linear(p["add_k"], ctx), heads)
        cv = split_heads(linear(p["add_v"], ctx), heads)
        if "norm_added_q" in p:
            cq = rms_norm(p["norm_added_q"], cq)
            ck = rms_norm(p["norm_added_k"], ck)
        first, second = ((cq, ck, cv), (q, k, v)) if context_first \
            else ((q, k, v), (cq, ck, cv))
        q, k, v = (torch.cat([a, b], dim=2) for a, b in zip(first, second))

    fused_rope = rope
    if condition_kv_states is not None:
        if rope is not None:
            # appended condition keys stay unrotated: identity K-table rows
            cos, sin = rope
            n_app = condition_kv_states.shape[1]
            kcos = torch.cat([cos, cos.new_ones(n_app, cos.shape[-1])])
            ksin = torch.cat([sin, sin.new_zeros(n_app, sin.shape[-1])])
            fused_rope = (cos, sin, kcos, ksin)
        dk = split_heads(linear(p["condition_k"], condition_kv_states), heads)
        dv = split_heads(linear(p["condition_v"], condition_kv_states), heads)
        if "condition_k_norm" in p:
            dk = rms_norm(p["condition_k_norm"], dk)
        k = torch.cat([k, dk], dim=2)
        v = torch.cat([v, dv], dim=2)

    out = merge_heads(sdpa(q, k, v, rope=fused_rope))

    if ctx is None:
        if "to_out" in p:
            out = linear(p["to_out"], out)
        return out, None

    if context_first:
        ctx_out, x_out = out[:, :ctx.shape[1]], out[:, ctx.shape[1]:]
    else:
        x_out, ctx_out = out[:, :sx], out[:, sx:]
    if "to_out" in p:
        x_out = linear(p["to_out"], x_out)
    if not context_out or "to_add_out" not in p:
        return x_out, None
    return x_out, linear(p["to_add_out"], ctx_out)
