"""Flow-matching Euler scheduler, the inference part (port of
``unigen_tpu/pipelines/scheduling.py``): static or dynamic sigma shifting and
the Euler step prev = x + (sigma_next - sigma) * v."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class FlowMatchConfig:
    num_train_timesteps: int = 1000
    shift: float = 1.0                   # schnell: 1.0; SD3.5/dev: 3.0
    use_dynamic_shifting: bool = False   # FLUX.1-dev: True
    base_shift: float = 0.5
    max_shift: float = 1.15
    base_image_seq_len: int = 256
    max_image_seq_len: int = 4096


def calculate_shift(image_seq_len: int, cfg: FlowMatchConfig) -> float:
    m = (cfg.max_shift - cfg.base_shift) / (cfg.max_image_seq_len - cfg.base_image_seq_len)
    return image_seq_len * m + cfg.base_shift - m * cfg.base_image_seq_len


def inference_sigmas(cfg: FlowMatchConfig, num_steps: int,
                     image_seq_len: Optional[int] = None,
                     mu: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigmas [n+1] with a terminal 0, timesteps [n] = sigma*1000), float32
    on the CPU (a host-side table, as in the JAX scan)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    if cfg.use_dynamic_shifting:
        if mu is None:
            assert image_seq_len is not None, "dynamic shifting needs seq len"
            mu = calculate_shift(image_seq_len, cfg)
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = cfg.shift * sigmas / (1.0 + (cfg.shift - 1.0) * sigmas)
    timesteps = sigmas * cfg.num_train_timesteps
    sigmas = np.concatenate([sigmas, [0.0]])
    return (torch.as_tensor(sigmas, dtype=torch.float32),
            torch.as_tensor(timesteps, dtype=torch.float32))


def euler_step(sample: torch.Tensor, model_output: torch.Tensor,
               sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
    """x_{t-1} = x_t + (sigma_next - sigma) * v, in fp32, cast back."""
    out = sample.to(torch.float32) + (sigma_next - sigma) * model_output.to(torch.float32)
    return out.to(sample.dtype)
