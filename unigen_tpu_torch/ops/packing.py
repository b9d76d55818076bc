"""Latent packing and position ids (FLUX 2x2 patch packing), and the SD3
patchify and sincos position table.

Port of ``unigen_tpu/ops/packing.py`` (the FLUX and SD3 parts).
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


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] (SD3 patch embedding input)."""
    b, c, h, w = x.shape
    p = patch_size
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def unpatchify(x: torch.Tensor, h_patches: int, w_patches: int,
               patch_size: int, out_channels: int) -> torch.Tensor:
    """[B, S, p*p*C] -> [B, C, h_patches*p, w_patches*p] (``nhwpqc->nchpwq``)."""
    b, p = x.shape[0], patch_size
    x = x.reshape(b, h_patches, w_patches, p, p, out_channels)
    x = x.permute(0, 5, 1, 3, 2, 4)
    return x.reshape(b, out_channels, h_patches * p, w_patches * p)


def _sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[M, embed_dim] = [sin | cos] of pos x omega, in float32."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32,
                         device=pos.device) / (embed_dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d_pos_embed(embed_dim: int, grid_size: int, base_size: int,
                        interpolation_scale: float = 1.0,
                        device=None) -> torch.Tensor:
    """2-D sincos table [grid_size**2, embed_dim] (diffusers PatchEmbed):
    the first half of the channels encodes H, the second W; positions are
    rescaled by base_size/grid_size."""
    grid = (torch.arange(grid_size, dtype=torch.float32, device=device)
            / (grid_size / base_size) / interpolation_scale)
    gw, gh = torch.meshgrid(grid, grid, indexing="xy")   # w goes first
    emb_h = _sincos_1d(embed_dim // 2, gw)
    emb_w = _sincos_1d(embed_dim // 2, gh)
    return torch.cat([emb_h, emb_w], dim=1)


def cropped_pos_embed(table: torch.Tensor, max_size: int, h_patches: int,
                      w_patches: int) -> torch.Tensor:
    """Center-crop a [max_size**2, D] sincos table to [h*w, D]."""
    top = (max_size - h_patches) // 2
    left = (max_size - w_patches) // 2
    t = table.reshape(max_size, max_size, -1)
    t = t[top:top + h_patches, left:left + w_patches]
    return t.reshape(h_patches * w_patches, -1)
