"""The serving caches of the denoise loop (port of
``unigen_tpu/pipelines/caching.py``): the drift rule of the adaptive
refresh, the full-model output cache, the three-level hybrid cache, the
named quality profiles, the cache mode that both pipelines resolve from
``generate``'s knobs, and the prompt-embedding LRU.

The JAX scans (``lax.scan`` over the steps, ``lax.cond``/``lax.switch``
between refresh and replay) become Python loops and branches. An adaptive
decision reads one drift scalar on the host per step: a device-to-host
sync a step, the straightforward port of a data-dependent branch. The step
counts come back as Python ints.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Hashable, Optional

import numpy as np
import torch

from unigen_tpu_torch.pipelines import scheduling


def rel_change(lat: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Mean |lat - ref| / mean |ref| as a float32 scalar on the latents'
    device (the L1 relative drift the adaptive rules threshold on)."""
    a, b = lat.to(torch.float32), ref.to(torch.float32)
    return (a - b).abs().mean() / (b.abs().mean() + 1e-8)


def _drifted(lat, ref, threshold) -> bool:
    """rel_change(lat, ref) > threshold, both float32; reads the drift on
    the host."""
    return bool(rel_change(lat, ref).item() > float(np.float32(threshold)))


def refresh_decision(i: int, lat: torch.Tensor, lat_ref: torch.Tensor,
                     threshold: float) -> bool:
    """Refresh at step 0, afterwards whenever the latent has drifted more
    than ``threshold`` since the last refresh."""
    return i == 0 or _drifted(lat, lat_ref, threshold)


def _hold(p1, p0, i, i1, i0, order: int, slope_first: bool):
    """The replayed prediction: the last one (order 0), or the line through
    the last two refreshed ones at step i (order 1, once two exist). The
    step scalars ride as tensors in p1's dtype on its device, and the two
    scans keep the JAX package's two orders of operations."""
    if order < 1 or i0 < 0:
        return p1

    def scalar(v):
        return torch.tensor(v, dtype=p1.dtype, device=p1.device)
    dt, gap = scalar(max(i1 - i0, 1)), scalar(i - i1)
    if slope_first:
        return p1 + gap * ((p1 - p0) / dt)
    return p1 + gap * (p1 - p0) / dt


def model_cache_scan(full_pred: Callable, latents: torch.Tensor, sigmas,
                     num_steps: int, *, cache_interval: int = 1,
                     adaptive: bool = False, threshold: Optional[float] = None,
                     order: int = 0):
    """Full-model output caching: refresh steps call ``full_pred(lat, i)``
    (the exact guided forward), replay steps skip the transformer and reuse
    the cached prediction, zero-order (``order=0``) or extrapolated from the
    two most recent refreshed predictions (``order=1``). Refresh every
    ``cache_interval``-th step, or with ``adaptive`` whenever the latent
    drifted past ``threshold`` since the input of the last refreshed step.
    Returns ``(latents, n_refresh)``."""
    p1 = p0 = None
    i1 = i0 = -1
    lat_ref, n_ref = latents, 0
    for i in range(num_steps):
        refresh = (refresh_decision(i, latents, lat_ref, threshold) if adaptive
                   else i % cache_interval == 0)
        if refresh:
            pred = full_pred(latents, i)
            p1, p0, i1, i0 = pred, p1, i, i1
            lat_ref, n_ref = latents, n_ref + 1
        else:
            pred = _hold(p1, p0, i, i1, i0, order, slope_first=True)
        latents = scheduling.euler_step(latents, pred, sigmas[i], sigmas[i + 1])
    return latents, n_ref


def hybrid_cache_scan(full_fwd: Callable, base_fwd: Callable,
                      latents: torch.Tensor, sigmas, num_steps: int, *,
                      control_interval: int = 1, model_interval: int = 1,
                      order: int = 0, adaptive: bool = False,
                      control_threshold: Optional[float] = None,
                      model_threshold: Optional[float] = None):
    """The three-level hybrid cache. Per step i:

    - **full** (``i % control_interval == 0``): ``full_fwd(lat, i) ->
      (pred, residuals)`` refreshes the control-residual and the prediction
      caches;
    - **base** (else ``i % model_interval == 0``): ``base_fwd(lat, i,
      residuals) -> pred``, the base transformer replaying the cached
      control residuals, refreshes the prediction cache;
    - **skip** (otherwise): the cached prediction is replayed as in
      ``model_cache_scan``.

    ``adaptive`` replaces the intervals with drift thresholds: full when the
    latent drifted past ``control_threshold`` since the input of the last
    full step (and at step 0), else base when it drifted past
    ``model_threshold`` since the last prediction refresh, else skip.
    Step 0 is always full, so no residual cache is needed before it (the
    JAX scan's ``residuals_init`` carry). Returns ``(latents, n_full,
    n_base)``."""
    res = None
    p1 = p0 = None
    i1 = i0 = -1
    full_ref = pred_ref = latents
    n_full = n_base = 0
    for i in range(num_steps):
        if adaptive:
            level = (2 if refresh_decision(i, latents, full_ref, control_threshold)
                     else 1 if _drifted(latents, pred_ref, model_threshold) else 0)
        else:
            level = (2 if i % control_interval == 0
                     else 1 if i % model_interval == 0 else 0)
        if level == 2:
            pred, res = full_fwd(latents, i)
            full_ref = latents
        elif level == 1:
            pred = base_fwd(latents, i, res)
        else:
            pred = _hold(p1, p0, i, i1, i0, order, slope_first=False)
        if level:
            p1, p0, i1, i0 = pred, p1, i, i1
            pred_ref = latents
            n_full += level == 2
            n_base += level == 1
        latents = scheduling.euler_step(latents, pred, sigmas[i], sigmas[i + 1])
    return latents, n_full, n_base


# Serving operating points per family, as the JAX package's table
# (CACHE.json, docs/SERVING.md; measured there on a TPU). "balanced": the
# hybrid three-level cache (flux with int8 residuals); "fast": the
# full-model cache at interval 4 with first-order replay, which needs
# ``min_steps`` denoise steps and otherwise degrades to "balanced".
PROFILE_TABLES = {
    "flux": {"balanced": dict(control_cache_interval=4,
                              model_cache_interval=2,
                              residual_cache_bits=8),
             "fast": dict(model_cache_interval=4, model_cache_order=1,
                          min_steps=8)},
    "sd3": {"balanced": dict(control_cache_interval=8,
                             model_cache_interval=2),
            "fast": dict(model_cache_interval=4, model_cache_order=1,
                         min_steps=8)},
    "sana": {"balanced": dict(control_cache_interval=4,
                              model_cache_interval=2),
             "fast": dict(model_cache_interval=4, model_cache_order=1,
                          min_steps=8)},
}


def quality_profile_knobs(profile: Optional[str], table: dict, explicit: dict,
                          num_steps: Optional[int] = None) -> dict:
    """The cache knobs of a named serving profile. ``"exact"`` (and None)
    means no caching; mixing a profile with explicit knobs (any value of
    ``explicit`` off its default) is an error; a profile whose
    ``min_steps`` exceeds ``num_steps`` degrades to "balanced" with a
    warning."""
    if profile is None:
        return {}
    for k, v in explicit.items():
        if v not in (1, 0.0, False, 0):
            raise ValueError(
                f"quality_profile={profile!r} sets the cache knobs itself; "
                f"drop the explicit {k}={v!r} (or drop the profile)")
    if profile == "exact":
        return {}
    if profile not in table:
        raise ValueError(f"unknown quality_profile {profile!r}; expected "
                         f"one of {['exact'] + sorted(table)}")
    knobs = dict(table[profile])
    min_steps = knobs.pop("min_steps", 0)
    if num_steps is not None and num_steps < min_steps:
        fallback = dict(table["balanced"])
        fallback.pop("min_steps", None)
        warnings.warn(
            f"quality_profile={profile!r} needs >= {min_steps} denoise "
            f"steps to hold the 0.99 SSIM gate (got {num_steps}); "
            "degrading to 'balanced' — pass explicit cache knobs to "
            "override", stacklevel=3)
        return fallback
    return knobs


@dataclass(frozen=True)
class CacheMode:
    """The resolved cache knobs of one ``generate`` call."""
    interval: int = 1            # control or model cache refresh interval
    threshold: float = 0.0       # adaptive control or model cache threshold
    adaptive: bool = False
    cfg_cache: bool = False
    model_cache: bool = False
    order: int = 0
    hybrid_interval: int = 1     # the hybrid's base (model) interval
    hybrid_adaptive: bool = False
    control_threshold: float = 0.0
    model_threshold: float = 0.0
    bits: int = 16

    @property
    def hybrid(self) -> bool:
        return self.hybrid_interval > 1 or self.hybrid_adaptive

    @property
    def exact(self) -> bool:
        return self.interval <= 1 and not self.adaptive and not self.hybrid


def resolve_cache_mode(num_steps: int, *, control_cache_interval: int = 1,
                       control_cache_threshold: float = 0.0,
                       cfg_cache: bool = False, model_cache_interval: int = 1,
                       model_cache_threshold: float = 0.0,
                       model_cache_order: int = 0, residual_cache_bits: int = 16,
                       quality_profile: Optional[str] = None,
                       family: str = "flux") -> CacheMode:
    """The cache knobs of ``generate`` (and a quality profile) -> the mode,
    with the JAX pipeline's ValueErrors for the combinations it refuses.
    ``family`` picks the profile table ("flux" or "sd3"); as in the JAX SD3
    pipeline, an sd3 profile sets no residual bits and may be combined
    with ``residual_cache_bits``."""
    explicit = dict(control_cache_interval=control_cache_interval,
                    control_cache_threshold=control_cache_threshold,
                    cfg_cache=cfg_cache,
                    model_cache_interval=model_cache_interval,
                    model_cache_threshold=model_cache_threshold,
                    model_cache_order=model_cache_order)
    if residual_cache_bits != 16 and family == "flux":
        explicit["residual_cache_bits"] = residual_cache_bits
    knobs = quality_profile_knobs(
        quality_profile, PROFILE_TABLES[family], explicit,
        num_steps=num_steps)
    residual_cache_bits = knobs.get("residual_cache_bits", residual_cache_bits)
    control_cache_interval = knobs.get("control_cache_interval",
                                       control_cache_interval)
    model_cache_interval = knobs.get("model_cache_interval", model_cache_interval)
    model_cache_order = knobs.get("model_cache_order", model_cache_order)

    model_cache = model_cache_interval > 1 or model_cache_threshold > 0.0
    hybrid_interval = 1
    hybrid_adaptive = model_cache_threshold > 0.0 and control_cache_threshold > 0.0
    if hybrid_adaptive:
        if model_cache_interval > 1 or control_cache_interval > 1:
            raise ValueError("adaptive hybrid caching (both thresholds > 0) "
                             "takes thresholds only; leave the intervals at 1")
        if cfg_cache:
            raise ValueError("cfg_cache does not compose with hybrid caching "
                             "(skip steps already bypass the negative stream)")
        if control_cache_threshold <= model_cache_threshold:
            raise ValueError(
                "adaptive hybrid caching requires control_cache_threshold > "
                "model_cache_threshold (below it, full refreshes fire before "
                "base ever would and the schedule degenerates to the adaptive "
                f"model cache), got c={control_cache_threshold} "
                f"m={model_cache_threshold}")
        model_cache, interval, threshold = False, 1, 0.0
    elif model_cache_interval > 1 and control_cache_interval > 1:
        if control_cache_threshold > 0.0 or model_cache_threshold > 0.0:
            raise ValueError("hybrid caching takes both intervals OR both "
                             "thresholds, not a mix")
        if cfg_cache:
            raise ValueError("cfg_cache does not compose with hybrid caching "
                             "(skip steps already bypass the negative stream)")
        if (control_cache_interval <= model_cache_interval
                or control_cache_interval % model_cache_interval):
            raise ValueError(
                "hybrid caching requires model_cache_interval < "
                "control_cache_interval and control_cache_interval a multiple "
                "of model_cache_interval (every full step must fall on a base "
                f"boundary), got c={control_cache_interval} "
                f"m={model_cache_interval}")
        model_cache, hybrid_interval = False, model_cache_interval
        interval, threshold = control_cache_interval, 0.0
    elif model_cache:
        if control_cache_interval > 1 or control_cache_threshold > 0.0:
            raise ValueError("the model cache composes with the control cache "
                             "only via fixed intervals on both (hybrid mode); "
                             "thresholds are mutually exclusive with it")
        if cfg_cache:
            raise ValueError("cfg_cache composes with the control cache only; "
                             "the model cache already skips the negative "
                             "stream on replay steps")
        interval, threshold = model_cache_interval, model_cache_threshold
    else:
        interval, threshold = control_cache_interval, control_cache_threshold
    adaptive = threshold > 0.0 and not hybrid_adaptive
    if cfg_cache and control_cache_interval <= 1 and not adaptive:
        raise ValueError("cfg_cache requires control_cache_interval > 1 or "
                         "control_cache_threshold > 0 (it rides the same "
                         "refresh schedule)")
    if residual_cache_bits not in (4, 8, 16):
        raise ValueError(f"residual_cache_bits must be 4, 8 or 16, got "
                         f"{residual_cache_bits}")
    if residual_cache_bits < 16 and model_cache and not (
            hybrid_interval > 1 or hybrid_adaptive):
        raise ValueError("residual_cache_bits<16 quantizes the control-residual "
                         "cache; the pure model cache has none (use a "
                         "control-cache or hybrid mode)")
    return CacheMode(interval=interval, threshold=threshold, adaptive=adaptive,
                     cfg_cache=cfg_cache, model_cache=model_cache,
                     order=model_cache_order, hybrid_interval=hybrid_interval,
                     hybrid_adaptive=hybrid_adaptive,
                     control_threshold=control_cache_threshold,
                     model_threshold=model_cache_threshold,
                     bits=residual_cache_bits)


class PromptLRU:
    """LRU over prompt-encoding results (``prompt_cache_size`` of the
    pipeline): serving repeats the negative prompt and the condition task
    name on every request. Keys hold everything the result depends on
    besides the fixed encoder weights; ``capacity`` 0 computes every time.
    ``hits`` and ``misses`` count the lookups."""

    def __init__(self, capacity: int = 0):
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self._d: OrderedDict = OrderedDict()

    def get_or(self, key: Hashable, compute: Callable[[], Any]) -> Any:
        if self.capacity <= 0:
            return compute()
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        val = compute()
        self.misses += 1
        self._d[key] = val
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        return val
