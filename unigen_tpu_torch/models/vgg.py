"""VGG16 feature tower (torchvision cfg "D" ``features``), the DISTS and
FD-VGG backbone (port of ``unigen_tpu/models/vgg.py``).

The parameter tree is the JAX package's: a list of ``{"w": [O, I, 3, 3],
"b": [O]}`` convolutions, one per conv of cfg "D" (64,64,M,128,128,M,
256,256,256,M,512,512,512,M,512,512,512,M; 3x3, pad 1, ReLU). Everything
runs in fp32 NCHW through ``F.conv2d``, as JAX's ``lax.conv`` does.

Two pooling modes:

* ``pool="max"``: torchvision's 2x2 max pool (FD-VGG features).
* ``pool="l2"``: DISTS's Hanning-windowed L2 pool (Ding et al.,
  arXiv:2004.07728): sqrt of a depthwise 3x3 normalised Hanning window over
  x², stride 2, padding 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: torchvision cfg "D" channel plan; "M" marks a pooling site
VGG16_CFG: Tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                    512, 512, 512, "M", 512, 512, 512, "M")

#: ImageNet normalisation (torchvision transforms; the DISTS repo)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def _conv3x3(p: dict, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, p["w"].to(x.dtype), p["b"].to(x.dtype), padding=1)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _hann_window() -> np.ndarray:
    """The normalised 3x3 outer product of ``np.hanning(5)[1:-1]``."""
    win = np.hanning(5)[1:-1]
    w2 = np.outer(win, win)
    return (w2 / w2.sum()).astype(np.float32)


def _l2_pool(x: torch.Tensor) -> torch.Tensor:
    """Hanning-windowed L2 pooling: sqrt(conv(x², w)), depthwise, stride 2,
    padding 1, floored at 1e-12 under the root."""
    c = x.shape[1]
    k = torch.as_tensor(_hann_window(), dtype=x.dtype, device=x.device)
    k = k[None, None].expand(c, 1, 3, 3)
    sq = F.conv2d(x * x, k, stride=2, padding=1, groups=c)
    return torch.sqrt(torch.clamp(sq, min=1e-12))


def init_vgg16_params(generator: torch.Generator, dtype=torch.float32,
                      device=None) -> List[dict]:
    """Random conv params (He-normal weights, zero biases) drawn from
    ``generator`` on its device (or ``device``)."""
    dev = torch.device(device) if device is not None else generator.device
    params = []
    c_in = 3
    for c in VGG16_CFG:
        if c == "M":
            continue
        scale = float(np.sqrt(2.0 / (9 * c_in)))
        w = torch.randn((c, c_in, 3, 3), generator=generator, device=dev) * scale
        params.append({"w": w.to(dtype), "b": torch.zeros((c,), dtype=dtype, device=dev)})
        c_in = c
    return params


def load_vgg16_features(sd: Dict[str, torch.Tensor], *, prefix: str = "features.",
                        dtype=torch.float32, device=None) -> List[dict]:
    """torchvision ``vgg16().state_dict()`` (or its ``features.`` subset) ->
    the conv list. Strict: every ``features.{i}.weight/bias`` of cfg "D"
    must be there with its shape."""
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(device)
    params = []
    idx = 0
    c_in = 3
    for c in VGG16_CFG:
        if c == "M":
            idx += 1                         # the pool takes a slot
            continue
        w = torch.as_tensor(sd[f"{prefix}{idx}.weight"])
        b = torch.as_tensor(sd[f"{prefix}{idx}.bias"])
        if tuple(w.shape) != (c, c_in, 3, 3) or tuple(b.shape) != (c,):
            raise ValueError(f"{prefix}{idx}: shapes {tuple(w.shape)}, {tuple(b.shape)}; "
                             f"cfg D expects {(c, c_in, 3, 3)}, {(c,)}")
        params.append({"w": w.to(dev, dtype), "b": b.to(dev, dtype)})
        c_in = c
        idx += 2                             # conv + relu
    return params


def vgg16_stages(params: List[dict], pixels: torch.Tensor, *,
                 pool: str = "max") -> List[torch.Tensor]:
    """pixels [B, 3, H, W] in [0, 1] -> the 5 relu-stage outputs (relu1_2,
    relu2_2, relu3_3, relu4_3, relu5_3) of the ImageNet-normalised input.
    ``pool``: "max" (torchvision) or "l2" (DISTS)."""
    if pool not in ("max", "l2"):
        raise ValueError(f"pool must be 'max' or 'l2'; got {pool!r}")
    dev, dt = pixels.device, pixels.dtype
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=dt, device=dev)[None, :, None, None]
    std = torch.as_tensor(IMAGENET_STD, dtype=dt, device=dev)[None, :, None, None]
    x = (pixels - mean) / std
    stages = []
    pi = 0
    pool_fn = _max_pool if pool == "max" else _l2_pool
    for c in VGG16_CFG:
        if c == "M":
            stages.append(x)                 # the output before the pool
            x = pool_fn(x)
        else:
            x = torch.relu(_conv3x3(params[pi], x))
            pi += 1
    return stages


def vgg16_fid_features(params: List[dict], pixels: torch.Tensor) -> torch.Tensor:
    """Global-average-pooled relu5_3 [B, 512], the FD-VGG feature vector."""
    return vgg16_stages(params, pixels, pool="max")[-1].mean(dim=(2, 3))

