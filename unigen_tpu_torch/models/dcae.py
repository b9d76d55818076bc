"""DC-AE, the deep-compression autoencoder that is SANA's latent codec (port
of ``unigen_tpu/models/dcae.py``).

Residual autoencoding: every resolution change carries a non-parametric
shortcut (pixel-unshuffle and channel-group averaging down, channel
duplication and pixel-shuffle up), and so do the latent projections.
Early stages are ResBlocks (conv3x3 -> silu -> conv3x3 -> RMSNorm, residual);
the deep ones are EfficientViT blocks (LiteMLA: a 1x1 qkv conv, a depthwise
5x5 multi-scale branch, ReLU linear attention over both, a 1x1 projection
and RMSNorm; then the GLUMBConv feed-forward). Encode is deterministic and
scales by ``scaling_factor``; decode divides it back out.

NCHW activations and HWIO kernels, as ``models/vae.py`` (whose ``conv``
this module uses). None of it is a kernel: convolutions and the fp32 linear
attention are plain PyTorch. The codec runs at its own parameter dtype:
encode casts the pixels to it, decode casts the latents to it.

``save_dcae_native`` / ``load_dcae_native`` read and write JAX's native
files: ``dcae_native.npz`` with the leaves as ``leaf_0000``, ... in JAX's
canonical pytree order (dict keys sorted, lists in index order) and
``dcae_config.json``. The port rebuilds that order from the config, so a
JAX save loads here and a save from here loads in JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unigen_tpu_torch.layers.blocks_sana import depthwise_conv, relu_linear_attention
from unigen_tpu_torch.models.vae import conv, init_conv


@dataclass(frozen=True)
class DCAEConfig:
    in_channels: int = 3
    latent_channels: int = 32
    # one width per stage; the resolution halves between stages
    widths: Tuple[int, ...] = (128, 256, 512, 512, 1024, 1024)
    encoder_depths: Tuple[int, ...] = (2, 2, 2, 3, 3, 3)
    decoder_depths: Tuple[int, ...] = (3, 3, 3, 3, 3, 3)
    # stages with index >= attention_start use EfficientViT blocks
    attention_start: int = 3
    head_dim: int = 32
    mlp_ratio: float = 4.0
    scaling_factor: float = 0.41407          # SANA dc-ae-f32c32

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.widths) - 1)


def tiny_dcae_config(**kw) -> DCAEConfig:
    base = dict(latent_channels=4, widths=(8, 16, 32), encoder_depths=(1, 1, 1),
                decoder_depths=(1, 1, 1), attention_start=2, head_dim=8,
                mlp_ratio=2.0, scaling_factor=1.0)
    base.update(kw)
    return DCAEConfig(**base)


# ---------------------------------------------------- space<->channel moves

def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*r*r, H/r, W/r] (torch PixelUnshuffle order)."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * r * r, h // r, w // r)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C*r*r, H, W] -> [B, C, H*r, W*r] (torch PixelShuffle order)."""
    b, c, h, w = x.shape
    co = c // (r * r)
    x = x.reshape(b, co, r, r, h, w)
    return x.permute(0, 1, 4, 2, 5, 3).reshape(b, co, h * r, w * r)


def channel_average(x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """Group-average C -> out_ch (the non-parametric down shortcut)."""
    b, c, h, w = x.shape
    if c % out_ch:
        raise ValueError(f"channel_average: {c} channels into {out_ch}")
    return x.reshape(b, out_ch, c // out_ch, h, w).mean(dim=2)


def channel_duplicate(x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """Repeat each channel out_ch / C times (the non-parametric up shortcut)."""
    c = x.shape[1]
    if out_ch % c:
        raise ValueError(f"channel_duplicate: {c} channels into {out_ch}")
    return x.repeat_interleave(out_ch // c, dim=1)


# ---------------------------------------------------- norms / blocks

def _uniform(shape, bound, gen, device, dtype):
    return torch.empty(shape, device=device, dtype=dtype).uniform_(
        -bound, bound, generator=gen)


def init_rms2d(ch: int, *, device=None, dtype=torch.float32) -> dict:
    return {"scale": torch.ones(ch, device=device, dtype=dtype)}


def rms2d(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the channel axis of NCHW, in fp32."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt((xf * xf).mean(dim=1, keepdim=True) + eps)
    return (xf * p["scale"][None, :, None, None]).to(x.dtype)


def init_res_block(ch: int, **kw) -> dict:
    return {"conv1": init_conv(ch, ch, **kw), "conv2": init_conv(ch, ch, **kw),
            "norm": init_rms2d(ch, device=kw["device"], dtype=kw["dtype"])}


def res_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(conv(p["conv1"], x))
    return x + rms2d(p["norm"], conv(p["conv2"], h))


def init_lite_mla(ch: int, **kw) -> dict:
    dev, dt = kw["device"], kw["dtype"]
    return {"qkv": init_conv(ch, 3 * ch, k=1, **kw),
            "aggreg": {"w": _uniform((5, 5, 1, 3 * ch), 0.2, kw["gen"], dev, dt),
                       "b": torch.zeros(3 * ch, device=dev, dtype=dt)},
            "proj": init_conv(2 * ch, ch, k=1, **kw),
            "norm": init_rms2d(ch, device=dev, dtype=dt)}


def _nchw_depthwise(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SAME depthwise conv of NCHW ``x`` with the HWIO [k, k, 1, C] kernel."""
    return depthwise_conv(x.permute(0, 2, 3, 1), p["w"], p["b"]).permute(0, 3, 1, 2)


def lite_mla(p: dict, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, c, h, w = x.shape
    qkv = conv(p["qkv"], x)                                   # [B, 3C, H, W]
    ms = _nchw_depthwise(qkv, p["aggreg"])                    # the 5x5 scale

    def attend(maps):
        def heads(t):
            return t.reshape(b, c // head_dim, head_dim, h * w).transpose(2, 3)
        qm, km, vm = maps.chunk(3, dim=1)
        o = relu_linear_attention(heads(qm), heads(km), heads(vm))
        return o.transpose(2, 3).reshape(b, c, h, w).to(x.dtype)

    out = torch.cat([attend(qkv), attend(ms)], dim=1)        # [B, 2C, H, W]
    return x + rms2d(p["norm"], conv(p["proj"], out))


def init_glumb2d(ch: int, mlp_ratio: float, **kw) -> dict:
    hidden = int(ch * mlp_ratio)
    dev, dt = kw["device"], kw["dtype"]
    return {"inverted": init_conv(ch, 2 * hidden, k=1, **kw),
            "depth": {"w": _uniform((3, 3, 1, 2 * hidden), 1 / 3, kw["gen"], dev, dt),
                      "b": torch.zeros(2 * hidden, device=dev, dtype=dt)},
            "point": init_conv(hidden, ch, k=1, **kw),
            "norm": init_rms2d(ch, device=dev, dtype=dt)}


def glumb2d(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = _nchw_depthwise(F.silu(conv(p["inverted"], x)), p["depth"])
    main, gate = y.chunk(2, dim=1)
    return x + rms2d(p["norm"], conv(p["point"], main * F.silu(gate)))


def init_vit_block(ch: int, cfg: "DCAEConfig", **kw) -> dict:
    return {"attn": init_lite_mla(ch, **kw),
            "ff": init_glumb2d(ch, cfg.mlp_ratio, **kw)}


def vit_block(p: dict, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    return glumb2d(p["ff"], lite_mla(p["attn"], x, head_dim))


# ---------------------------------------------------- resolution changes

def downsample(p: dict, x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """conv3x3 stride 2 on the (0, 1, 0, 1)-padded input, plus the
    pixel-unshuffle + channel-average shortcut."""
    main = conv(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2, padding="valid")
    return main + channel_average(pixel_unshuffle(x, 2), out_ch)


def upsample(p: dict, x: torch.Tensor, out_ch: int) -> torch.Tensor:
    """conv3x3 to 4*out_ch and pixel-shuffle, plus the duplicate-and-shuffle
    shortcut (widths never more than halve between decoder stages, so
    4*out_ch is a multiple of the input width)."""
    main = pixel_shuffle(conv(p["conv"], x), 2)
    return main + pixel_shuffle(channel_duplicate(x, 4 * out_ch), 2)


# ---------------------------------------------------- encoder / decoder

def _init_stage(width: int, depth: int, is_vit: bool, cfg: DCAEConfig, **kw) -> list:
    if is_vit:
        return [init_vit_block(width, cfg, **kw) for _ in range(depth)]
    return [init_res_block(width, **kw) for _ in range(depth)]


def _run_stage(blocks: list, x: torch.Tensor, is_vit: bool, cfg: DCAEConfig):
    for bp in blocks:
        x = vit_block(bp, x, cfg.head_dim) if is_vit else res_block(bp, x)
    return x


def init_dcae_params(cfg: DCAEConfig, *, gen=None, device=None,
                     dtype=torch.float32) -> dict:
    """A random DC-AE tree in JAX's layout (torch-default uniform convs,
    RMS scales one, uniform depthwise kernels)."""
    kw = dict(gen=gen, device=device, dtype=dtype)
    ws = cfg.widths
    enc = {"conv_in": init_conv(cfg.in_channels, ws[0], **kw), "stages": [],
           "downs": [], "conv_out": init_conv(ws[-1], cfg.latent_channels, **kw)}
    for i, w in enumerate(ws):
        enc["stages"].append(_init_stage(w, cfg.encoder_depths[i],
                                         i >= cfg.attention_start, cfg, **kw))
        if i < len(ws) - 1:
            enc["downs"].append({"conv": init_conv(w, ws[i + 1], **kw)})
    rws = list(reversed(ws))
    rdepths = list(reversed(cfg.decoder_depths))
    n = len(ws)
    dec = {"conv_in": init_conv(cfg.latent_channels, rws[0], **kw), "stages": [],
           "ups": [], "norm_out": init_rms2d(rws[-1], device=device, dtype=dtype),
           "conv_out": init_conv(rws[-1], cfg.in_channels, **kw)}
    for i, w in enumerate(rws):
        dec["stages"].append(_init_stage(w, rdepths[i], (n - 1 - i) >= cfg.attention_start,
                                         cfg, **kw))
        if i < n - 1:
            dec["ups"].append({"conv": init_conv(w, 4 * rws[i + 1], **kw)})
    return {"encoder": enc, "decoder": dec}


def dcae_encode(params: dict, cfg: DCAEConfig, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, H, W] in [-1, 1] -> latents [B, C, H/f, W/f] times the
    scaling factor, at the codec's parameter dtype."""
    enc = params["encoder"]
    ws = cfg.widths
    x = conv(enc["conv_in"], pixels.to(enc["conv_in"]["w"].dtype))
    for i in range(len(ws)):
        x = _run_stage(enc["stages"][i], x, i >= cfg.attention_start, cfg)
        if i < len(ws) - 1:
            x = downsample(enc["downs"][i], x, ws[i + 1])
    z = conv(enc["conv_out"], x) + channel_average(x, cfg.latent_channels)
    return z * cfg.scaling_factor


def dcae_decode(params: dict, cfg: DCAEConfig, latents: torch.Tensor) -> torch.Tensor:
    """latents -> pixels [B, 3, H, W], the inverse of ``dcae_encode``'s
    scaling, at the codec's parameter dtype."""
    dec = params["decoder"]
    rws = list(reversed(cfg.widths))
    n = len(rws)
    z = latents.to(dec["conv_in"]["w"].dtype) / cfg.scaling_factor
    x = conv(dec["conv_in"], z) + channel_duplicate(z, rws[0])
    for i in range(n):
        x = _run_stage(dec["stages"][i], x, (n - 1 - i) >= cfg.attention_start, cfg)
        if i < n - 1:
            x = upsample(dec["ups"][i], x, rws[i + 1])
    return conv(dec["conv_out"], F.silu(rms2d(dec["norm_out"], x)))


# ---------------------------------------------------- native files

def _canonical_leaves(tree: Any) -> List[Any]:
    """The leaves in JAX's canonical pytree order: dict keys sorted, lists
    and tuples in index order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _canonical_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _canonical_leaves(v)]
    return [tree]


def _fill_canonical(tree: Any, leaves) -> Any:
    """A tree of ``tree``'s structure with ``leaves`` (an iterator) taken in
    the canonical order."""
    if isinstance(tree, dict):
        filled = {k: _fill_canonical(tree[k], leaves) for k in sorted(tree)}
        return {k: filled[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill_canonical(v, leaves) for v in tree)
    return next(leaves)


def save_dcae_native(path: str, params: dict, cfg: DCAEConfig) -> None:
    """Write ``dcae_native.npz`` (the leaves in canonical order, as float32
    for bf16 leaves) and ``dcae_config.json`` under ``path``."""
    os.makedirs(path, exist_ok=True)

    def host(t):
        t = t.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(os.path.join(path, "dcae_native.npz"),
             **{f"leaf_{i:04d}": host(t)
                for i, t in enumerate(_canonical_leaves(params))})
    with open(os.path.join(path, "dcae_config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


def has_dcae_native(path: str) -> bool:
    return os.path.isfile(os.path.join(path, "dcae_native.npz"))


def load_dcae_native(path: str, *, dtype=torch.float32, device=None):
    """Inverse of ``save_dcae_native`` -> (params, cfg) on ``device`` (CUDA
    unless "cpu" is named). The structure comes from the saved config, so a
    leaf count or shape that disagrees with it raises."""
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(device)
    with open(os.path.join(path, "dcae_config.json")) as f:
        raw = json.load(f)
    for k in ("widths", "encoder_depths", "decoder_depths"):
        raw[k] = tuple(raw[k])
    cfg = DCAEConfig(**raw)
    struct = init_dcae_params(cfg, device="meta")
    metas = _canonical_leaves(struct)
    with np.load(os.path.join(path, "dcae_native.npz")) as z:
        names = sorted(z.files)
        if len(names) != len(metas):
            raise ValueError(f"dcae_native.npz has {len(names)} leaves, the config "
                             f"implies {len(metas)}")
        leaves = []
        for name, meta in zip(names, metas):
            a = z[name]
            if tuple(a.shape) != tuple(meta.shape):
                raise ValueError(f"{name}: shape {a.shape}, expected {tuple(meta.shape)}")
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # bfloat16 raw
                t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(np.ascontiguousarray(a))
            leaves.append(t.to(dev, dtype))
    return _fill_canonical(struct, iter(leaves)), cfg
