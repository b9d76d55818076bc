"""Latent packing and position ids (FLUX 2x2 patch packing).

Port of ``unigen_tpu/ops/packing.py`` (the FLUX part).
"""

from __future__ import annotations

import torch


def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/2)*(W/2), C*4]."""
    b, c, h, w = latents.shape
    x = latents.reshape(b, c, h // 2, 2, w // 2, 2)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(latents: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, (h/2)*(w/2), C*4] -> [B, C, h, w]; h, w are latent-grid dims."""
    b, s, c4 = latents.shape
    c = c4 // 4
    x = latents.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, c, h, w)


def prepare_latent_image_ids(h_half: int, w_half: int, offset_w: float = 0.0,
                             device=None) -> torch.Tensor:
    """Position ids for packed latents: [(h/2)*(w/2), 3] with (0, row, col)."""
    ids = torch.zeros(h_half, w_half, 3, dtype=torch.float32, device=device)
    ids[..., 1] += torch.arange(h_half, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] += (torch.arange(w_half, dtype=torch.float32, device=device)[None, :]
                    + offset_w)
    return ids.reshape(h_half * w_half, 3)
