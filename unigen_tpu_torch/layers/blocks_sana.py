"""SANA blocks (port of ``unigen_tpu/layers/blocks_sana.py``): ReLU linear
attention, cross-attention to the caption with a [B, Sctx] padding mask,
the GLUMBConv feed-forward, the AdaLayerNormSingle time embedding and the
per-block scale/shift table.

None of it reaches a Pallas kernel in JAX, and none of it is a kernel
here: the linear attention is three fp32 products (``kv = relu(k)^T v``,
the normaliser ``relu(q) . sum(relu(k))`` and ``relu(q) kv``), the
cross-attention is the plain masked attention (``sdpa_xla``), and the
depthwise 3x3 convolution is ``F.conv2d`` with one group per channel. The
linears go through ``layers.core.linear``, so a quantized serving tree runs
the W4A8 / W8A8 kernels. The modulation tensor may be [B, 6D] or
token-wise [B, S, 6D] (the MoE-dispatch case).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import init_linear, layer_norm, linear
from unigen_tpu_torch.layers.embeddings import timestep_sinusoidal
from unigen_tpu_torch.ops.attention import merge_heads, sdpa_xla, split_heads


# ------------------------------------------------------------ time embed

def init_adaln_single(dim: int, *, gen=None, device=None,
                      dtype=torch.float32) -> dict:
    kw = dict(gen=gen, device=device, dtype=dtype)
    return {"timestep": {"fc1": init_linear(256, dim, **kw),
                         "fc2": init_linear(dim, dim, **kw)},
            "linear": init_linear(dim, 6 * dim, **kw)}


def adaln_single(p: dict, timestep: torch.Tensor, dtype=torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """timestep [B] (in the units the caller passes) -> (proj [B, 6D],
    embedded [B, D])."""
    feat = timestep_sinusoidal(timestep.to(torch.float32)).to(dtype)
    embedded = linear(p["timestep"]["fc2"],
                      F.silu(linear(p["timestep"]["fc1"], feat)))
    return linear(p["linear"], F.silu(embedded)), embedded


# ------------------------------------------------------------ linear attention

def init_linear_attention(dim: int, heads: int, head_dim: int, **kw) -> dict:
    inner = heads * head_dim
    return {"to_q": init_linear(dim, inner, bias=False, **kw),
            "to_k": init_linear(dim, inner, bias=False, **kw),
            "to_v": init_linear(dim, inner, bias=False, **kw),
            "to_out": init_linear(inner, dim, **kw)}


def relu_linear_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """q, k, v [B, H, S, D] -> fp32 [B, H, S, D]: relu(q) [relu(k)^T v] /
    (relu(q) . sum_s relu(k) + 1e-15), all in fp32."""
    q = torch.relu(q.to(torch.float32))
    k = torch.relu(k.to(torch.float32))
    v = v.to(torch.float32)
    kv = torch.einsum("bhsd,bhse->bhde", k, v)
    z = torch.einsum("bhsd,bhd->bhs", q, k.sum(dim=2))
    return torch.einsum("bhsd,bhde->bhse", q, kv) / (z[..., None] + 1e-15)


def linear_attention(p: dict, x: torch.Tensor, *, heads: int) -> torch.Tensor:
    """SanaLinearAttnProcessor: the ReLU-kernel linear attention, cast back
    to the activation dtype before ``to_out``."""
    q = split_heads(linear(p["to_q"], x), heads)
    k = split_heads(linear(p["to_k"], x), heads)
    v = split_heads(linear(p["to_v"], x), heads)
    out = relu_linear_attention(q, k, v)
    return linear(p["to_out"], merge_heads(out.to(x.dtype)))


def init_cross_attention(dim: int, heads: int, head_dim: int,
                         kv_dim: Optional[int] = None, **kw) -> dict:
    inner = heads * head_dim
    kv_dim = kv_dim or dim
    return {"to_q": init_linear(dim, inner, **kw),
            "to_k": init_linear(kv_dim, inner, **kw),
            "to_v": init_linear(kv_dim, inner, **kw),
            "to_out": init_linear(inner, dim, **kw)}


def cross_attention(p: dict, x: torch.Tensor, ctx: torch.Tensor, *, heads: int,
                    ctx_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of x to the caption ``ctx``; ``ctx_mask`` [B, Sctx] (bool
    or 0/1) hides the padding keys (a row with no key left attends to all
    of them evenly, as the -1e30 fill of the JAX function gives)."""
    q = split_heads(linear(p["to_q"], x), heads)
    k = split_heads(linear(p["to_k"], ctx), heads)
    v = split_heads(linear(p["to_v"], ctx), heads)
    mask = None if ctx_mask is None else (ctx_mask != 0)[:, None, None, :]
    return linear(p["to_out"], merge_heads(sdpa_xla(q, k, v, mask)))


# ------------------------------------------------------------ GLUMBConv FF

def init_glumb_conv(dim: int, mlp_ratio: float = 2.5, *, gen=None, device=None,
                    dtype=torch.float32) -> dict:
    hidden = int(dim * mlp_ratio)
    kw = dict(gen=gen, device=device, dtype=dtype)
    p = {"inverted": init_linear(dim, 2 * hidden, **kw)}
    kd = torch.empty((3, 3, 1, 2 * hidden), device=device, dtype=dtype)
    p["depth"] = {"w": kd.uniform_(-1.0 / 3.0, 1.0 / 3.0, generator=gen),
                  "b": torch.zeros(2 * hidden, device=device, dtype=dtype)}
    p["point"] = init_linear(hidden, dim, bias=False, **kw)
    return p


def depthwise_conv(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME-padded depthwise cross-correlation of NHWC ``y`` [B, h, w, C] with
    an HWIO kernel [k, k, 1, C] (one group per channel), plus the bias ->
    [B, h, w, C]. The NCHW view of ``y`` is channels-last in memory, which
    the convolution keeps."""
    k = w.shape[0]
    out = F.conv2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None,
                   padding=(k - 1) // 2, groups=y.shape[-1])
    return out.permute(0, 2, 3, 1) + b


def glumb_conv(p: dict, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, S = h*w, C] inverted-residual GLU conv block (fused MBConv)."""
    b, s, _ = x.shape
    y = F.silu(linear(p["inverted"], x)).reshape(b, h, w, -1)
    y = depthwise_conv(y, p["depth"]["w"], p["depth"]["b"]).reshape(b, s, -1)
    main, gate = y.chunk(2, dim=-1)
    return linear(p["point"], main * F.silu(gate))


# ------------------------------------------------------------ block

def init_sana_block(dim: int, heads: int, head_dim: int, *, cross_heads: int,
                    cross_head_dim: int, mlp_ratio: float = 2.5, gen=None,
                    device=None, dtype=torch.float32) -> dict:
    kw = dict(gen=gen, device=device, dtype=dtype)
    table = torch.empty((6, dim), device=device, dtype=dtype)
    return {
        "scale_shift_table": table.normal_(generator=gen) / dim ** 0.5,
        "attn1": init_linear_attention(dim, heads, head_dim, **kw),
        "attn2": init_cross_attention(dim, cross_heads, cross_head_dim, **kw),
        "ff": init_glumb_conv(dim, mlp_ratio, **kw),
    }


def _mod6(table: torch.Tensor, temb: torch.Tensor):
    """table [6, D] + temb [B, 6D] or [B, S, 6D] -> six tensors that
    broadcast over [B, S, D]."""
    d = table.shape[-1]
    lead = (temb.shape[0], 1) if temb.dim() == 2 else tuple(temb.shape[:2])
    mods = table[None, None] + temb.reshape(lead + (6, d))
    return [mods[..., i, :] for i in range(6)]


def sana_block(p: dict, x: torch.Tensor, ctx: Optional[torch.Tensor],
               temb: torch.Tensor, h: int, w: int, *, heads: int,
               cross_heads: int,
               ctx_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SanaTransformerBlock: linear self-attention -> caption
    cross-attention -> GLUMBConv, modulated by the block's scale/shift table
    plus the projected timestep."""
    s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = _mod6(p["scale_shift_table"], temb)
    nx = layer_norm(x) * (1 + sc_msa) + s_msa
    x = x + g_msa * linear_attention(p["attn1"], nx, heads=heads)
    if ctx is not None:
        x = x + cross_attention(p["attn2"], x, ctx, heads=cross_heads,
                                ctx_mask=ctx_mask)
    nx = layer_norm(x) * (1 + sc_mlp) + s_mlp
    return x + g_mlp * glumb_conv(p["ff"], nx, h, w)
