"""The per-step training log line (port of the two functions of
``unigen_tpu/observability.py`` that the training loop uses)."""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu").numpy()
    return np.asarray(v)


def expert_histogram(expert_counts) -> Dict[str, float]:
    """Load-balance metrics from the MoE expert_counts output."""
    c = _to_numpy(expert_counts).astype(np.float64)
    total = max(c.sum(), 1.0)
    frac = c / total
    e = len(c)
    return {
        "moe/tokens": float(total),
        "moe/max_expert_frac": float(frac.max()),
        "moe/empty_experts": int((c == 0).sum()),
        # 1.0 = perfectly balanced, e = fully collapsed
        "moe/imbalance": float(e * np.square(frac).sum()),
    }


def log_step_metrics(logger: logging.Logger, step: int,
                     metrics: Dict[str, Any]) -> None:
    """Reference-style per-step scalar line (train.py:687-695)."""
    scalars = {}
    for k, v in metrics.items():
        arr = _to_numpy(v)
        if arr.ndim == 0:
            scalars[k] = float(arr)
        elif k == "expert_counts":
            scalars.update(expert_histogram(arr))
    logger.info("step %d | %s", step,
                " ".join(f"{k}={v:.5g}" for k, v in scalars.items()))
