"""AdaLayerNorm family with per-sample [B, D] or token-wise [B, S, D] temb.

Port of ``unigen_tpu/layers/adaln.py``. Chunk orders match the checkpoints:
  zero      (6): shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp
  single    (3): shift_msa, scale_msa, gate_msa
  continuous(2): scale, shift            <- scale FIRST
  sd35x     (9): shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp,
                 shift_msa2, scale_msa2, gate_msa2
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import init_linear, layer_norm, linear


def init_adaln(dim: int, n_chunks: int, *, cond_dim=None, **kw) -> dict:
    return {"linear": init_linear(cond_dim or dim, n_chunks * dim, **kw)}


def _mod(p: dict, temb: torch.Tensor, n: int):
    emb = linear(p["linear"], F.silu(temb))
    parts = torch.chunk(emb, n, dim=-1)
    if temb.dim() == 2:        # per-sample: broadcast over the sequence
        parts = tuple(x[:, None, :] for x in parts)
    return parts


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor
             ) -> torch.Tensor:
    return x * (1 + scale) + shift


def adaln_zero(p: dict, x: torch.Tensor, temb: torch.Tensor
               ) -> Tuple[torch.Tensor, ...]:
    """Returns (normed_x, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""
    s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp = _mod(p, temb, 6)
    return modulate(layer_norm(x), s_msa, sc_msa), g_msa, s_mlp, sc_mlp, g_mlp


def adaln_zero_single(p: dict, x: torch.Tensor, temb: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (normed_x, gate_msa)."""
    s_msa, sc_msa, g_msa = _mod(p, temb, 3)
    return modulate(layer_norm(x), s_msa, sc_msa), g_msa


def adaln_continuous(p: dict, x: torch.Tensor, temb: torch.Tensor
                     ) -> torch.Tensor:
    """AdaLayerNormContinuous (final norm_out): scale chunked FIRST."""
    scale, shift = _mod(p, temb, 2)
    return modulate(layer_norm(x), shift, scale)


def adaln_sd35x(p: dict, x: torch.Tensor, temb: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """SD35AdaLayerNormZeroX (dual attention): returns (normed_x, gate_msa,
    shift_mlp, scale_mlp, gate_mlp, normed_x2, gate_msa2)."""
    s_msa, sc_msa, g_msa, s_mlp, sc_mlp, g_mlp, s2, sc2, g2 = _mod(p, temb, 9)
    normed = layer_norm(x)
    return (modulate(normed, s_msa, sc_msa), g_msa, s_mlp, sc_mlp, g_mlp,
            modulate(normed, s2, sc2), g2)


def gate(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Apply a gate that is already sequence-broadcastable (from ``_mod``)."""
    return g * x
