"""Logging for training (port of the parts of ``unigen_tpu/observability.py``
that the training loop and its entry point use): the crash-proof log
handler, ``setup_logging``, ``param_report`` and the per-step line. The
port runs one process, so it is always rank 0; ``profile`` and
``assert_replica_consistency`` wait for ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import logging
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch


class SafeStreamHandler(logging.StreamHandler):
    """Never lets a logging failure (a broken pipe) kill training."""

    def emit(self, record):
        try:
            super().emit(record)
        except Exception:
            pass


def setup_logging(work_dir: Optional[str] = None, *, level=logging.INFO,
                  name: str = "unigen_tpu_torch") -> logging.Logger:
    """The ``name`` logger at ``level`` on stderr, and into
    ``{work_dir}/train.log`` when a work_dir is given (reference
    train.py:219-239)."""
    logger = logging.getLogger(name)
    logger.handlers.clear()
    handler = SafeStreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(asctime)s [p0] %(name)s: %(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)
    if work_dir:
        fh = logging.FileHandler(f"{work_dir}/train.log")
        fh.setFormatter(handler.formatter)
        logger.addHandler(fh)
    return logger


def param_report(tree: Any, name: str = "model") -> Dict[str, float]:
    """Parameter and byte counts of a tree, printed and returned."""
    from unigen_tpu_torch.utils import param_bytes, tree_leaves
    stats = {"params": sum(t.numel() for t in tree_leaves(tree)),
             "gbytes": param_bytes(tree) / 1e9}
    print(f"{name}: {stats['params'] / 1e6:.1f}M params, {stats['gbytes']:.2f} GB")
    return stats


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
