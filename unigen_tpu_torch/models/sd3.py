"""SD3 / SD3.5 MMDiT backbone (port of ``unigen_tpu/models/sd3.py``).

Conv patch embed with the cropped sincos table, the combined timestep and
pooled-text embedding (timestep on the raw 0..1000 scale), the caption
projection, N joint blocks (dual attention on the configured layers, the
last block context-pre-only), the AdaLN-continuous head and unpatchify.
Blocks are stored as the JAX tree stores them: a ``dual_blocks`` stack, a
``plain_blocks`` stack and the ``last_block``.
"""

from __future__ import annotations

import torch

from unigen_tpu_torch.config import SD3BackboneConfig
from unigen_tpu_torch.layers.adaln import adaln_continuous, init_adaln
from unigen_tpu_torch.layers.blocks_sd3 import init_sd3_joint_block, sd3_joint_block
from unigen_tpu_torch.layers.core import init_linear, linear
from unigen_tpu_torch.layers.embeddings import (combined_time_text,
                                                init_combined_time_text,
                                                init_patch_embed, patch_embed)
from unigen_tpu_torch.ops.packing import unpatchify
from unigen_tpu_torch.utils import index_params, stack_params


def init_sd3_params(cfg: SD3BackboneConfig, *, gen=None, device=None,
                    dtype=torch.float32) -> dict:
    d = cfg.inner_dim
    kw = dict(gen=gen, device=device, dtype=dtype)
    dual = set(cfg.dual_attention_layers)
    dual_idx = [i for i in range(cfg.num_layers) if i in dual]
    plain_idx = [i for i in range(cfg.num_layers) if i not in dual]
    blocks = [init_sd3_joint_block(
        d, cfg.num_attention_heads, cfg.attention_head_dim,
        context_pre_only=(i == cfg.num_layers - 1), qk_norm=cfg.qk_norm,
        use_dual_attention=(i in dual), **kw) for i in range(cfg.num_layers)]
    p = {
        "pos_embed": init_patch_embed(cfg.patch_size, cfg.in_channels, d,
                                      cfg.pos_embed_max_size,
                                      cfg.sample_size // cfg.patch_size, **kw),
        "time_text_embed": init_combined_time_text(d, cfg.pooled_projection_dim, **kw),
        "context_embedder": init_linear(cfg.joint_attention_dim, d, **kw),
        "dual_blocks": (stack_params([blocks[i] for i in dual_idx])
                        if dual_idx else None),
        "plain_blocks": (stack_params([blocks[i] for i in plain_idx[:-1]])
                         if len(plain_idx) > 1 else None),
        "last_block": blocks[cfg.num_layers - 1],
        "norm_out": init_adaln(d, 2, **kw),
        "proj_out": init_linear(d, cfg.patch_size ** 2 * cfg.out_channels, **kw),
    }
    return {k: v for k, v in p.items() if v is not None}


def sd3_block_list(params: dict, cfg: SD3BackboneConfig) -> list:
    """The ordered per-block parameter views."""
    dual = sorted(cfg.dual_attention_layers)
    plain = [i for i in range(cfg.num_layers) if i not in set(dual)]
    out = [None] * cfg.num_layers
    if "dual_blocks" in params:
        for j, i in enumerate(dual):
            out[i] = index_params(params["dual_blocks"], j)
    if "plain_blocks" in params:
        for j, i in enumerate(plain[:-1]):
            out[i] = index_params(params["plain_blocks"], j)
    out[cfg.num_layers - 1] = params["last_block"]
    return out


def sd3_embed_inputs(params: dict, cfg: SD3BackboneConfig, hidden, encoder,
                     pooled, timestep):
    """hidden [B,C,H,W] -> tokens; timestep on the 0..1000 scale (no x1000,
    unlike FLUX)."""
    h = patch_embed(params["pos_embed"], hidden, cfg.patch_size,
                    cfg.pos_embed_max_size)
    enc = linear(params["context_embedder"], encoder)
    temb = combined_time_text(params["time_text_embed"],
                              timestep.to(torch.float32), pooled, dtype=h.dtype)
    return h, enc, temb


def sd3_forward(params: dict, cfg: SD3BackboneConfig, hidden: torch.Tensor,
                encoder: torch.Tensor, pooled: torch.Tensor,
                timestep: torch.Tensor) -> torch.Tensor:
    """The plain base forward (no control) -> [B, out_ch, H, W]."""
    height, width = hidden.shape[2:]
    h, enc, temb = sd3_embed_inputs(params, cfg, hidden, encoder, pooled, timestep)
    for block in sd3_block_list(params, cfg):
        enc_out, h = sd3_joint_block(block, h, enc, temb,
                                     heads=cfg.num_attention_heads)
        enc = enc_out if enc_out is not None else enc
    h = linear(params["proj_out"], adaln_continuous(params["norm_out"], h, temb))
    return unpatchify(h, height // cfg.patch_size, width // cfg.patch_size,
                      cfg.patch_size, cfg.out_channels)
