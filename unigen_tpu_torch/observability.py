"""Logging, tracing and profiling (port of ``unigen_tpu/observability.py``):
the crash-proof log handler, ``setup_logging``, ``debug_print``,
``param_report``, the per-step line, ``phase`` (a named range in profiler
traces) and ``profile`` (a ``torch.profiler`` trace written as a Chrome
trace). The port runs one process, so it is always rank 0;
``assert_replica_consistency`` waits for the port of the parallel layer
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
from typing import Any, Dict, Iterator, Optional

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


def debug_print(*args, **kw) -> None:
    """Process-0-only print (the port's one process is process 0)."""
    print(*args, **kw)


def param_report(tree: Any, name: str = "model") -> Dict[str, float]:
    """Parameter and byte counts of a tree, printed and returned."""
    from unigen_tpu_torch.utils import param_bytes, param_count
    stats = {"params": param_count(tree), "gbytes": param_bytes(tree) / 1e9}
    debug_print(f"{name}: {stats['params'] / 1e6:.1f}M params, "
                f"{stats['gbytes']:.2f} GB")
    return stats


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """A named range in ``torch.profiler`` traces (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: str, *, enabled: bool = True) -> Iterator[None]:
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA where a
    device is present) and write it into ``log_dir`` as the Chrome trace
    ``trace.json`` (the counterpart of JAX's ``jax.profiler`` trace)."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
