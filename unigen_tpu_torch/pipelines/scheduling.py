"""Flow-matching Euler scheduler and the SD3-style training draws (port of
``unigen_tpu/pipelines/scheduling.py``): static or dynamic sigma shifting,
the Euler step prev = x + (sigma_next - sigma) * v, the training sigma
table, the forward noising process, the timestep density and the loss
weighting. Random draws come from an explicit ``torch.Generator``."""

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


def time_shift_static(shift: float, sigma: np.ndarray) -> np.ndarray:
    return shift * sigma / (1.0 + (shift - 1.0) * sigma)


def training_sigmas(cfg: FlowMatchConfig) -> np.ndarray:
    """The scheduler's full training sigma table (descending, length N),
    float32 on the host."""
    timesteps = np.linspace(1, cfg.num_train_timesteps, cfg.num_train_timesteps)[::-1]
    sigmas = timesteps / cfg.num_train_timesteps
    if not cfg.use_dynamic_shifting:
        sigmas = time_shift_static(cfg.shift, sigmas)
    return sigmas.astype(np.float32)


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
        sigmas = time_shift_static(cfg.shift, sigmas)
    timesteps = sigmas * cfg.num_train_timesteps
    sigmas = np.concatenate([sigmas, [0.0]])
    return (torch.as_tensor(sigmas, dtype=torch.float32),
            torch.as_tensor(timesteps, dtype=torch.float32))


def euler_step(sample: torch.Tensor, model_output: torch.Tensor,
               sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
    """x_{t-1} = x_t + (sigma_next - sigma) * v, in fp32, cast back."""
    out = sample.to(torch.float32) + (sigma_next - sigma) * model_output.to(torch.float32)
    return out.to(sample.dtype)


def scale_noise(sample: torch.Tensor, noise: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
    """Forward process z_t = (1 - sigma) x + sigma z1, computed in fp32 and
    returned in the SAMPLE's dtype: an fp32 sigma must not promote bf16
    latents, and with them the whole training forward and backward, to fp32
    (the JAX package's round-5 fault, ``scheduling.py:84-96``)."""
    sigma = sigma.to(torch.float32).reshape((-1,) + (1,) * (sample.dim() - 1))
    out = (1.0 - sigma) * sample.to(torch.float32) + sigma * noise.to(torch.float32)
    return out.to(sample.dtype)


def sample_timestep_density(generator: Optional[torch.Generator], batch: int,
                            scheme: str = "none", *, logit_mean: float = 0.0,
                            logit_std: float = 1.0, mode_scale: float = 1.29,
                            device=None) -> torch.Tensor:
    """u in (0, 1) per sample, fp32 [batch] (compute_density_for_timestep_
    sampling), drawn from ``generator``."""
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    if scheme == "logit_normal":
        return torch.sigmoid(torch.randn(batch, **kw) * logit_std + logit_mean)
    u = torch.rand(batch, **kw)
    if scheme == "mode":
        return 1.0 - u - mode_scale * (torch.cos(math.pi * u / 2.0) ** 2 - 1.0 + u)
    return u


def loss_weighting(sigmas: torch.Tensor, scheme: str = "none") -> torch.Tensor:
    """compute_loss_weighting_for_sd3."""
    if scheme == "sigma_sqrt":
        return (sigmas ** -2.0).to(torch.float32)
    if scheme == "cosmap":
        bot = 1.0 - 2.0 * sigmas + 2.0 * sigmas ** 2
        return 2.0 / (math.pi * bot)
    return torch.ones_like(sigmas)
