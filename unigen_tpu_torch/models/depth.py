"""Depth-Anything (a DINOv2 backbone and the DPT neck and head), the depth
condition's synthesizer and the FD-DINOv2 tower (port of
``unigen_tpu/models/depth.py``).

The reference renders its "depth" conditions with transformers'
``depth-anything-small-hf`` pipeline (src/condition.py:52-60). This is the
same graph on the parameter tree of the JAX package: the DINOv2-S/14
encoder, the DPT reassemble and fusion neck, the 3-conv relative-depth
head. Weights load through ``io/torch_bridge.load_depth_anything``.

Everything runs in fp32 on plain PyTorch, as JAX computes it outside
Pallas: NCHW convolutions with torch OIHW weights (``F.conv2d``); the
stride = kernel ConvTranspose as an exact einsum upsample; torch-style
bilinear resizes in both ``align_corners`` conventions through precomputed
gather weights (JAX's rule, not ``F.interpolate``'s); the attention as
``matmul`` and ``softmax`` in fp32. The position embedding is resized off
its native grid bilinearly, as JAX does (transformers uses bicubic).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.core import layer_norm


@dataclass(frozen=True)
class DepthAnythingConfig:
    # DINOv2 backbone
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    layerscale: bool = True
    out_indices: Tuple[int, ...] = (9, 10, 11, 12)  # hidden_states indices
    # DPT neck / head
    neck_hidden_sizes: Tuple[int, ...] = (48, 96, 192, 384)
    reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    max_depth: float = 1.0


def tiny_depth_config(**overrides) -> DepthAnythingConfig:
    base = dict(hidden_size=32, num_layers=4, num_heads=2, patch_size=14,
                out_indices=(1, 2, 3, 4), neck_hidden_sizes=(8, 16, 24, 32),
                fusion_hidden_size=16, head_hidden_size=8)
    base.update(overrides)
    return DepthAnythingConfig(**base)


# ------------------------------------------------------------ torch-style ops

def conv2d(p: dict, x: torch.Tensor, *, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """NCHW convolution with torch OIHW weights in ``p['w']``."""
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def conv_transpose_exact(p: dict, x: torch.Tensor, factor: int) -> torch.Tensor:
    """ConvTranspose2d with kernel_size == stride == factor (no overlap) as an
    exact einsum upsample; ``p['w']`` keeps torch's [in, out, f, f]."""
    b_, _, h, w = x.shape
    out = torch.einsum("bchw,cofg->bohfwg", x, p["w"])
    out = out.reshape(b_, -1, h * factor, w * factor)
    return out + p["b"][None, :, None, None]


def _resize_axis_weights(n_in: int, n_out: int, align_corners: bool, device):
    """Source rows (i0, i1) and the weight of i1 for each output row, in
    float32 as JAX computes them."""
    if n_out == 1:
        idx0 = torch.zeros((1,), dtype=torch.long, device=device)
        return idx0, idx0, torch.zeros((1,), dtype=torch.float32, device=device)
    pos = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners:
        src = pos * (n_in - 1) / (n_out - 1)
    else:
        src = (pos + 0.5) * n_in / n_out - 0.5
        src = torch.clamp(src, 0.0, n_in - 1)
    i0 = torch.clamp(torch.floor(src).to(torch.long), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return i0, i1, src - i0.to(torch.float32)


def interpolate_bilinear(x: torch.Tensor, size: Tuple[int, int], *,
                         align_corners: bool) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (torch's two corner
    conventions: DPT resizes with align_corners=True on upsamples and False
    when it matches a residual's size)."""
    h_out, w_out = int(size[0]), int(size[1])
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    i0, i1, wy = _resize_axis_weights(h_in, h_out, align_corners, x.device)
    rows = (x[:, :, i0, :] * (1 - wy)[None, None, :, None]
            + x[:, :, i1, :] * wy[None, None, :, None])
    j0, j1, wx = _resize_axis_weights(w_in, w_out, align_corners, x.device)
    return (rows[:, :, :, j0] * (1 - wx)[None, None, None, :]
            + rows[:, :, :, j1] * wx[None, None, None, :])


# ------------------------------------------------------------ DINOv2 encoder

def _attention(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    hd = d // heads

    def proj(name, v):
        return (v @ p[name]["w"] + p[name]["b"]).reshape(b, s, heads, hd).transpose(1, 2)

    q, k, v = proj("q", x), proj("k", x), proj("v", x)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / (hd ** 0.5)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v)
    out = out.transpose(1, 2).reshape(b, s, d)
    return out @ p["out"]["w"] + p["out"]["b"]


def _dinov2_layer(p: dict, x: torch.Tensor, heads: int) -> torch.Tensor:
    h = layer_norm(x, weight=p["norm1"]["scale"], bias=p["norm1"]["bias"])
    h = _attention(p["attn"], h, heads)
    if "ls1" in p:
        h = h * p["ls1"]
    x = x + h
    h = layer_norm(x, weight=p["norm2"]["scale"], bias=p["norm2"]["bias"])
    h = F.gelu(h @ p["fc1"]["w"] + p["fc1"]["b"])
    h = h @ p["fc2"]["w"] + p["fc2"]["b"]
    if "ls2" in p:
        h = h * p["ls2"]
    return x + h


def _backbone(p: dict, cfg: DepthAnythingConfig, pixels: torch.Tensor
              ) -> Tuple[List[torch.Tensor], int, int]:
    """pixels [B, 3, H, W] -> the selected hidden states [B, 1 + N, C] after
    the shared final LayerNorm (cls kept; the neck drops it) and the patch
    grid."""
    b, _, h, w = pixels.shape
    ph, pw = h // cfg.patch_size, w // cfg.patch_size
    tokens = conv2d(p["patch_embed"], pixels, stride=cfg.patch_size)
    tokens = tokens.reshape(b, cfg.hidden_size, ph * pw).transpose(1, 2)
    cls = p["cls_token"].expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, tokens], dim=1)

    pos = p["pos_embed"]  # [1, 1 + N0, C]
    n0 = pos.shape[1] - 1
    g0 = int(round(n0 ** 0.5))
    if (g0, g0) != (ph, pw):
        # bilinear off the native grid, as the JAX package does
        grid = pos[:, 1:].reshape(1, g0, g0, -1).permute(0, 3, 1, 2)
        grid = interpolate_bilinear(grid, (ph, pw), align_corners=False)
        grid = grid.permute(0, 2, 3, 1).reshape(1, ph * pw, -1)
        pos = torch.cat([pos[:, :1], grid], dim=1)
    x = x + pos

    selected = {}
    if 0 in cfg.out_indices:
        selected[0] = x
    for i, lp in enumerate(p["layers"]):
        x = _dinov2_layer(lp, x, cfg.num_heads)
        if (i + 1) in cfg.out_indices:
            selected[i + 1] = x
    outs = [layer_norm(selected[i], weight=p["norm"]["scale"], bias=p["norm"]["bias"])
            for i in sorted(selected)]
    return outs, ph, pw


# ------------------------------------------------------------ DPT neck + head

def _preact_residual(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], torch.relu(x), padding=1)
    h = conv2d(p["conv2"], torch.relu(h), padding=1)
    return h + x


def _fusion_layer(p: dict, x: torch.Tensor, residual, size) -> torch.Tensor:
    if residual is not None:
        if residual.shape != x.shape:
            residual = interpolate_bilinear(residual, x.shape[2:], align_corners=False)
        x = x + _preact_residual(p["res1"], residual)
    x = _preact_residual(p["res2"], x)
    target = size if size is not None else (x.shape[2] * 2, x.shape[3] * 2)
    x = interpolate_bilinear(x, target, align_corners=True)
    return conv2d(p["proj"], x)


def depth_forward(params: dict, cfg: DepthAnythingConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] (ImageNet-normalised) -> relative depth [B, H', W'] with
    H' = 14 * (H // 14)."""
    hidden, ph, pw = _backbone(params["backbone"], cfg, pixels)

    # reassemble: drop cls, to an NCHW grid, project, resize by the factor
    feats = []
    for i, (hs, factor) in enumerate(zip(hidden, cfg.reassemble_factors)):
        grid = hs[:, 1:].reshape(hs.shape[0], ph, pw, -1).permute(0, 3, 1, 2)
        rp = params["reassemble"][i]
        grid = conv2d(rp["proj"], grid)
        if factor > 1:
            grid = conv_transpose_exact(rp["resize"], grid, int(factor))
        elif factor < 1:
            grid = conv2d(rp["resize"], grid, stride=int(1 / factor), padding=1)
        feats.append(conv2d({"w": params["neck_convs"][i]["w"]}, grid, padding=1))

    # fusion, deepest first: the first layer takes the deepest feature alone,
    # each later one fuses the running state with the next feature
    fused = None
    feats_r = feats[::-1]
    for idx, fp in enumerate(params["fusion"]):
        size = feats_r[idx + 1].shape[2:] if idx + 1 < len(feats_r) else None
        if idx == 0:
            fused = _fusion_layer(fp, feats_r[idx], None, size)
        else:
            fused = _fusion_layer(fp, fused, feats_r[idx], size)

    d = conv2d(params["head"]["conv1"], fused, padding=1)
    d = interpolate_bilinear(d, (ph * cfg.patch_size, pw * cfg.patch_size),
                             align_corners=True)
    d = torch.relu(conv2d(params["head"]["conv2"], d, padding=1))
    d = conv2d(params["head"]["conv3"], d)
    d = torch.relu(d) * cfg.max_depth
    return d[:, 0]


def dinov2_features(params: dict, cfg: DepthAnythingConfig,
                    pixels: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] (ImageNet-normalised) -> the final layer's CLS embedding
    [B, hidden], the FD-DINOv2 feature vector (the deepest selected hidden
    state is the last layer's whenever ``out_indices`` ends at
    ``num_layers``, as in every Depth-Anything config)."""
    hidden, _, _ = _backbone(params["backbone"], cfg, pixels)
    return hidden[-1][:, 0]


def depth_to_condition_image(depth: torch.Tensor) -> torch.Tensor:
    """Relative depth [B, H, W] -> a [B, 3, H, W] image in [0, 255] (each
    image normalised by its own range, as transformers' depth pipeline)."""
    dmin = torch.amin(depth, dim=(-2, -1), keepdim=True)
    dmax = torch.amax(depth, dim=(-2, -1), keepdim=True)
    norm = (depth - dmin) / torch.clamp(dmax - dmin, min=1e-8) * 255.0
    return norm[:, None].expand(-1, 3, -1, -1)
