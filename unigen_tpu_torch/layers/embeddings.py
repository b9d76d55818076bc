"""Timestep, pooled-text, SANA caption and SD3 patch embedders (port of
``unigen_tpu/layers/embeddings.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import gelu_tanh, init_linear, linear
from unigen_tpu_torch.ops.packing import (cropped_pos_embed, patchify,
                                          sincos_2d_pos_embed)


def timestep_sinusoidal(t: torch.Tensor, dim: int = 256, *,
                        max_period: float = 10000.0,
                        flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal features [B, dim] of (already scaled) timesteps [B], fp32;
    flip_sin_to_cos=True gives [cos | sin]."""
    half = dim // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    emb = t.to(torch.float32)[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def init_timestep_embedder(in_dim: int, dim: int, **kw) -> dict:
    return {"fc1": init_linear(in_dim, dim, **kw),
            "fc2": init_linear(dim, dim, **kw)}


def timestep_embedder(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["fc2"], F.silu(linear(p["fc1"], x)))


def pixart_text_projection(p: dict, x: torch.Tensor) -> torch.Tensor:
    """diffusers ``PixArtAlphaTextProjection`` at its default GELU(tanh), the
    SANA caption projection (not ``timestep_embedder``'s SiLU)."""
    return linear(p["fc2"], gelu_tanh(linear(p["fc1"], x)))


def init_combined_time_text(dim: int, pooled_dim: int, *,
                            guidance: bool = False, **kw) -> dict:
    """CombinedTimestep(Guidance)TextProjEmbeddings."""
    p = {"timestep": init_timestep_embedder(256, dim, **kw),
         "text": init_timestep_embedder(pooled_dim, dim, **kw)}
    if guidance:
        p["guidance"] = init_timestep_embedder(256, dim, **kw)
    return p


def combined_time_text(p: dict, timestep: torch.Tensor, pooled: torch.Tensor,
                       guidance: Optional[torch.Tensor] = None,
                       dtype=torch.float32) -> torch.Tensor:
    """temb [B, dim]. ``timestep``/``guidance`` are already x1000-scaled."""
    emb = timestep_embedder(p["timestep"], timestep_sinusoidal(timestep).to(dtype))
    if "guidance" in p and guidance is not None:
        emb = emb + timestep_embedder(p["guidance"],
                                      timestep_sinusoidal(guidance).to(dtype))
    return emb + timestep_embedder(p["text"], pooled.to(dtype))


# ---------------------------------------------------------------- SD3 patch embed

def init_patch_embed(patch_size: int, in_channels: int, embed_dim: int,
                     pos_embed_max_size: int, base_size: int, *,
                     pos_embed_type: str = "sincos", gen=None, device=None,
                     dtype=torch.float32) -> dict:
    """The conv patch embedder as a linear over patchified pixels, plus the
    [max_size**2, D] sincos table (kept in fp32 whatever ``dtype``)."""
    p = {"proj": init_linear(in_channels * patch_size * patch_size, embed_dim,
                             gen=gen, device=device, dtype=dtype)}
    if pos_embed_type == "sincos":
        p["pos_embed"] = sincos_2d_pos_embed(embed_dim, pos_embed_max_size,
                                             base_size, device=device)
    return p


def patch_embed(p: dict, x: torch.Tensor, patch_size: int,
                pos_embed_max_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, S, D] plus the center-cropped position table."""
    hp, wp = x.shape[2] // patch_size, x.shape[3] // patch_size
    tokens = linear(p["proj"], patchify(x, patch_size))
    if "pos_embed" in p:
        pos = cropped_pos_embed(p["pos_embed"], pos_embed_max_size, hp, wp)
        tokens = tokens + pos.to(tokens.dtype)[None]
    return tokens
