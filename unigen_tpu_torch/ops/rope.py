"""Rotary position embeddings with FLUX multi-axis semantics.

Port of ``unigen_tpu/ops/rope.py``: per-axis 1-D frequencies from integer
position ids, cos/sin repeated for interleaved pairs, concatenated across
axes; the rotation runs in float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def rope_freqs_1d(pos: torch.Tensor, dim: int, theta: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each [S, dim], every angle repeated for its pair."""
    assert dim % 2 == 0, dim
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=pos.device) / dim))
    angles = pos.to(torch.float32)[:, None] * freqs[None, :]
    cos = torch.repeat_interleave(torch.cos(angles), 2, dim=-1)
    sin = torch.repeat_interleave(torch.sin(angles), 2, dim=-1)
    return cos, sin


def rope_multi_axis(ids: torch.Tensor, axes_dim: Sequence[int],
                    theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tables for ids [S, n_axes]; each column drives axes_dim[i] channels.
    Returns (cos, sin), each [S, sum(axes_dim)] float32."""
    assert ids.shape[-1] == len(axes_dim), (ids.shape, axes_dim)
    parts = [rope_freqs_1d(ids[:, i], d, theta) for i, d in enumerate(axes_dim)]
    return (torch.cat([c for c, _ in parts], dim=-1),
            torch.cat([s for _, s in parts], dim=-1))


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """x [..., S, D] with cos/sin [S, D]: x*cos + rotate_pairs(x)*sin, where
    rotate_pairs maps (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...).
    Computed in float32 and cast back to x.dtype."""
    xf = x.to(torch.float32)
    xr = xf.reshape(*xf.shape[:-1], -1, 2)
    rotated = torch.stack([-xr[..., 1], xr[..., 0]], dim=-1).reshape(xf.shape)
    return (xf * cos + rotated * sin).to(x.dtype)
