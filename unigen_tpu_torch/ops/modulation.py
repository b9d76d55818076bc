"""StyleGAN-style weight modulation as matmuls on pre-scaled inputs
(port of ``unigen_tpu/ops/modulation.py``):
y[n, o] = sum_i W[i, o] * s[n, i] * x[n, i]  ==  (s * x) @ W."""

from __future__ import annotations

from typing import Optional

import torch

from unigen_tpu_torch.utils import promote


def batched_modulated_linear(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Expert-batched form: x [E, C, I], w [E, I, O], s [E, C, I] -> [E, C, O]."""
    y = torch.bmm(*promote(x * s, w))
    if b is not None:
        y = y + b[:, None, :]
    return y
