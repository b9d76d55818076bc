"""FLUX.1 MMDiT backbone (port of ``unigen_tpu/models/flux.py``).

Blocks are stored stacked (leading block axis) as in the JAX tree; the
``lax.scan`` over them becomes a Python loop over block views.
"""

from __future__ import annotations

from typing import Optional

import torch

from unigen_tpu_torch.config import FluxBackboneConfig
from unigen_tpu_torch.layers.adaln import adaln_continuous, init_adaln
from unigen_tpu_torch.layers.blocks_flux import (flux_double_block,
                                                 flux_single_block,
                                                 init_flux_double_block,
                                                 init_flux_single_block)
from unigen_tpu_torch.layers.core import init_linear, linear
from unigen_tpu_torch.layers.embeddings import (combined_time_text,
                                                init_combined_time_text)
from unigen_tpu_torch.ops.rope import rope_multi_axis
from unigen_tpu_torch.utils import index_params, init_stacked, remat_wrap


def init_flux_params(cfg: FluxBackboneConfig, *, gen=None, device=None,
                     dtype=torch.float32) -> dict:
    d, heads, hd = cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim
    kw = dict(gen=gen, device=device, dtype=dtype)
    return {
        "x_embedder": init_linear(cfg.in_channels, d, **kw),
        "context_embedder": init_linear(cfg.joint_attention_dim, d, **kw),
        "time_text_embed": init_combined_time_text(
            d, cfg.pooled_projection_dim, guidance=cfg.guidance_embeds, **kw),
        "double_blocks": init_stacked(
            cfg.num_layers, lambda: init_flux_double_block(d, heads, hd, **kw)),
        "single_blocks": init_stacked(
            cfg.num_single_layers, lambda: init_flux_single_block(d, heads, hd, **kw)),
        "norm_out": init_adaln(d, 2, **kw),
        "proj_out": init_linear(d, cfg.out_channels, **kw),
    }


def flux_rope(cfg: FluxBackboneConfig, ids: torch.Tensor):
    """(cos, sin) tables for id rows [S, 3] with the backbone axes_dim."""
    return rope_multi_axis(ids, cfg.axes_dims_rope, float(cfg.rope_theta))


def flux_embed_inputs(params: dict, cfg: FluxBackboneConfig, hidden, encoder,
                      pooled, timestep, guidance):
    """Shared input embedding -> (h, enc, temb); the x1000 timestep scaling
    happens here."""
    h = linear(params["x_embedder"], hidden)
    enc = linear(params["context_embedder"], encoder)
    g = None if guidance is None else guidance.to(torch.float32) * 1000.0
    temb = combined_time_text(params["time_text_embed"],
                              timestep.to(torch.float32) * 1000.0,
                              pooled, g, dtype=hidden.dtype)
    return h, enc, temb


def flux_forward(params: dict, cfg: FluxBackboneConfig, hidden, encoder,
                 pooled, timestep, img_ids, txt_ids,
                 guidance: Optional[torch.Tensor] = None, *,
                 remat=False) -> torch.Tensor:
    """Plain (no control branch) forward: packed latent prediction [B, S, C];
    ``remat`` is ``utils.remat_wrap``'s policy for each block."""
    h, enc, temb = flux_embed_inputs(params, cfg, hidden, encoder, pooled,
                                     timestep, guidance)
    rope = flux_rope(cfg, torch.cat([txt_ids, img_ids], dim=0))
    heads = cfg.num_attention_heads

    def double_body(h, enc, i):
        enc, h = flux_double_block(index_params(params["double_blocks"], i),
                                   h, enc, temb, rope, heads=heads)
        return h, enc

    def single_body(stream, i):
        return flux_single_block(index_params(params["single_blocks"], i),
                                 stream, temb, rope, heads=heads)

    double_body = remat_wrap(double_body, remat)
    single_body = remat_wrap(single_body, remat)
    for i in range(cfg.num_layers):
        h, enc = double_body(h, enc, i)
    stream = torch.cat([enc, h], dim=1)
    for i in range(cfg.num_single_layers):
        stream = single_body(stream, i)
    h = adaln_continuous(params["norm_out"], stream[:, enc.shape[1]:], temb)
    return linear(params["proj_out"], h)
