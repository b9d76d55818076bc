"""AutoencoderKL, the FLUX/SD3 image VAE (port of
``unigen_tpu/models/vae.py``): conv_in, down/up blocks of ResnetBlock2D,
a mid-block with single-head attention, GroupNorm + SiLU heads, and the
(shift_factor, scaling_factor) latent normalisation.

The tree keeps the JAX layout, so ``io/from_jax.tree_from_numpy`` carries a
JAX tree bit for bit: HWIO conv kernels (``conv`` permutes them to OIHW
for ``F.conv2d``), ``down``/``up`` block lists, NCHW activations. None of
it is a Pallas kernel in JAX: convolutions, GroupNorm and the mid-block's
attention (an einsum there) are plain PyTorch here. The VAE runs at its
own parameter dtype (fp32 by default) and casts its inputs to it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 16               # FLUX/SD3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611          # FLUX
    shift_factor: float = 0.1159            # FLUX (SD3: 0.0609 / 1.5305)

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def tiny_vae_config(**kw) -> VAEConfig:
    base = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                norm_num_groups=4, scaling_factor=1.0, shift_factor=0.0)
    base.update(kw)
    return VAEConfig(**base)


# ------------------------------------------------------------ primitives

def _uniform(shape, bound, kw):
    return torch.empty(shape, device=kw["device"], dtype=kw["dtype"]).uniform_(
        -bound, bound, generator=kw["gen"])


def init_conv(in_ch, out_ch, k=3, **kw) -> dict:
    bound = 1.0 / math.sqrt(in_ch * k * k)
    return {"w": _uniform((k, k, in_ch, out_ch), bound, kw),
            "b": _uniform((out_ch,), bound, kw)}


def conv(p, x, *, stride=1, padding="same"):
    """NCHW x HWIO kernel; "same" pads (k-1)/2 a side, "valid" none."""
    w = p["w"].permute(3, 2, 0, 1)
    pad = (w.shape[-1] - 1) // 2 if padding == "same" else 0
    return F.conv2d(x, w, p["b"], stride=stride, padding=pad)


def init_group_norm(ch, *, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(ch, device=device, dtype=dtype),
            "bias": torch.zeros(ch, device=device, dtype=dtype)}


def _at_least_fp32(x):
    return x.to(torch.promote_types(x.dtype, torch.float32))


def group_norm(p, x, groups: int, eps: float = 1e-6):
    """Statistics and normalisation in fp32 (fp64 for fp64 inputs), cast to
    x's dtype, then the affine."""
    y = F.group_norm(_at_least_fp32(x), groups, eps=eps).to(x.dtype)
    return y * p["scale"][None, :, None, None] + p["bias"][None, :, None, None]


def init_resnet(in_ch, out_ch, **kw) -> dict:
    gn = dict(device=kw["device"], dtype=kw["dtype"])
    p = {"norm1": init_group_norm(in_ch, **gn), "conv1": init_conv(in_ch, out_ch, **kw),
         "norm2": init_group_norm(out_ch, **gn), "conv2": init_conv(out_ch, out_ch, **kw)}
    if in_ch != out_ch:
        p["shortcut"] = init_conv(in_ch, out_ch, k=1, **kw)
    return p


def resnet(p, x, groups):
    h = conv(p["conv1"], F.silu(group_norm(p["norm1"], x, groups)))
    h = conv(p["conv2"], F.silu(group_norm(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = conv(p["shortcut"], x)
    return x + h


def init_attn_block(ch, **kw) -> dict:
    bound = 1.0 / math.sqrt(ch)

    def lin():
        return {"w": _uniform((ch, ch), bound, kw), "b": _uniform((ch,), bound, kw)}
    return {"norm": init_group_norm(ch, device=kw["device"], dtype=kw["dtype"]),
            "q": lin(), "k": lin(), "v": lin(), "o": lin()}


def attn_block(p, x, groups):
    """Single-head self-attention over the H*W positions, fp32 (or fp64)
    logits."""
    b, c, h, w = x.shape
    t = group_norm(p["norm"], x, groups).reshape(b, c, h * w).transpose(1, 2)
    q, k, v = (t @ p[n]["w"] + p[n]["b"] for n in ("q", "k", "v"))
    logits = (_at_least_fp32(q) @ _at_least_fp32(k).transpose(1, 2)) / math.sqrt(c)
    o = torch.softmax(logits, dim=-1).to(v.dtype) @ v
    o = o @ p["o"]["w"] + p["o"]["b"]
    return x + o.transpose(1, 2).reshape(b, c, h, w)


# ------------------------------------------------------------ encoder/decoder

def init_vae_params(cfg: VAEConfig, *, gen=None, device=None,
                    dtype=torch.float32) -> dict:
    """Random VAE tree in the JAX layout (torch-default uniform convs and
    linears, GroupNorm scale 1 and bias 0), drawn from ``gen`` on
    ``device``."""
    kw = dict(gen=gen, device=device, dtype=dtype)
    gn = dict(device=device, dtype=dtype)
    chs = cfg.block_out_channels
    enc = {"conv_in": init_conv(cfg.in_channels, chs[0], **kw), "down": []}
    in_ch = chs[0]
    for i, out_ch in enumerate(chs):
        block = {"resnets": [init_resnet(in_ch if j == 0 else out_ch, out_ch, **kw)
                             for j in range(cfg.layers_per_block)]}
        if i < len(chs) - 1:
            block["down"] = init_conv(out_ch, out_ch, **kw)
        enc["down"].append(block)
        in_ch = out_ch
    enc["mid"] = {"res1": init_resnet(chs[-1], chs[-1], **kw),
                  "attn": init_attn_block(chs[-1], **kw),
                  "res2": init_resnet(chs[-1], chs[-1], **kw)}
    enc["norm_out"] = init_group_norm(chs[-1], **gn)
    enc["conv_out"] = init_conv(chs[-1], 2 * cfg.latent_channels, **kw)

    rev = list(reversed(chs))
    dec = {"conv_in": init_conv(cfg.latent_channels, rev[0], **kw),
           "mid": {"res1": init_resnet(rev[0], rev[0], **kw),
                   "attn": init_attn_block(rev[0], **kw),
                   "res2": init_resnet(rev[0], rev[0], **kw)},
           "up": []}
    in_ch = rev[0]
    for i, out_ch in enumerate(rev):
        block = {"resnets": [init_resnet(in_ch if j == 0 else out_ch, out_ch, **kw)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["up"] = init_conv(out_ch, out_ch, **kw)
        dec["up"].append(block)
        in_ch = out_ch
    dec["norm_out"] = init_group_norm(rev[-1], **gn)
    dec["conv_out"] = init_conv(rev[-1], cfg.in_channels, **kw)
    return {"encoder": enc, "decoder": dec}


def vae_encode(params: dict, cfg: VAEConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] in [-1, 1] -> normalised latents [B, C, H/8, W/8]:
    the posterior mean (the pipeline's deterministic encode). The pixels are
    cast to the VAE's parameter dtype first."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    x = conv(enc["conv_in"], pixels.to(enc["conv_in"]["w"].dtype))
    for block in enc["down"]:
        for r in block["resnets"]:
            x = resnet(r, x, g)
        if "down" in block:
            # the diffusers downsampler pads (0, 1, 0, 1), then a stride-2
            # VALID conv
            x = conv(block["down"], F.pad(x, (0, 1, 0, 1)), stride=2, padding="valid")
    x = resnet(enc["mid"]["res1"], x, g)
    x = attn_block(enc["mid"]["attn"], x, g)
    x = resnet(enc["mid"]["res2"], x, g)
    x = conv(enc["conv_out"], F.silu(group_norm(enc["norm_out"], x, g)))
    mean = x[:, :cfg.latent_channels]
    return (mean - cfg.shift_factor) * cfg.scaling_factor


def vae_decode(params: dict, cfg: VAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """Normalised latents -> pixels [B, 3, H, W] (about [-1, 1]), at the
    VAE's parameter dtype."""
    g = cfg.norm_num_groups
    dec = params["decoder"]
    z = latents.to(dec["conv_in"]["w"].dtype) / cfg.scaling_factor + cfg.shift_factor
    x = conv(dec["conv_in"], z)
    x = resnet(dec["mid"]["res1"], x, g)
    x = attn_block(dec["mid"]["attn"], x, g)
    x = resnet(dec["mid"]["res2"], x, g)
    for block in dec["up"]:
        for r in block["resnets"]:
            x = resnet(r, x, g)
        if "up" in block:
            x = conv(block["up"], F.interpolate(x, scale_factor=2, mode="nearest"))
    return conv(dec["conv_out"], F.silu(group_norm(dec["norm_out"], x, g)))
