"""Step-level continuous batching for diffusion serving (port of
``unigen_tpu/serving_steps.py``).

``MicroBatchServer`` (serving.py) batches whole requests: a request that
arrives mid-batch waits for the previous batch's whole denoise.
``StepServer`` batches single denoise steps instead: each tick advances up
to ``batch_size`` in-flight images by one Euler step, each at its own step
index (per-sample timestep, sigma, conditioning scale and guidance), and
new requests take free slots between ticks, so admission waits at most one
tick and utilization under mixed load is active slots / batch_size.

Requirements: ``MoEConfig.batch_mode="per_sample"``, so the router keeps
batch rows independent (under global routing a pad row could take expert
capacity from a real one).

Families: **flux** (token-packed latents, VAE codec), **sana** (NCHW
latents through the caller's latent codec, e.g. the DC-AE of
``load_sana_pipeline``, with a per-slot Gemma padding mask; no guidance:
SANA denoises without CFG, so a ``guidance_scale`` on a request raises)
and **sd3** (each slot owns one latent and a stacked (neg, pos) pair of
text and pooled rows; the family forward duplicates the gathered latents
into a 2m batch and applies the guidance combine ``neg + g * (pos - neg)``
inside the call, so the per-slot caches hold the guided prediction as the
one-shot pipeline's model cache does). ``mesh=`` waits for the parallel
slice (ROADMAP Queue 1 item 8) and raises ``NotImplementedError``.

The per-slot caches compose with continuous batching as in the JAX server:
``model_cache_interval=k`` refreshes a slot's cached prediction every k-th
own step and replays it in between (order 0 or 1); both intervals give the
hybrid three-level schedule (full / base with control-residual replay /
prediction replay); ``model_cache_threshold`` / ``control_cache_threshold``
replace the intervals with the adaptive drift rules, each slot's drift
([B] float32) computed on the card every tick and read on the host, either
at once (``adaptive_lag=0``) or two ticks later from pinned host memory
behind a CUDA event (``adaptive_lag=1``: the one-shot rule evaluated one
step late, with no extra refreshes). Refreshing slots are gathered into the
smallest size of the ladder 1, 2, 4, ..., ``batch_size`` (pads repeat a
real slot), so a tick's forward runs at the refresh count, not the slot
count.

Where JAX compiles one program per gathered size and keeps every array
immutable, the port runs each tick eagerly and keeps the same discipline
by construction: latents, the prediction caches and the admitted rows get
a new tensor each tick (``index_copy``, never in place), so a retired row
handed to the decoder or a tick still on the card can never see a later
write; only the per-slot control-residual cache is written in place
(``index_copy_``), and a base forward gathers its rows before the full
forward of the same tick writes them. All work runs on the device's
current stream in launch order: the caller's thread runs the VAE encode in
``submit``, the worker runs the ticks, the retirer runs the VAE decode.
The worker lets at most two ticks run ahead of the card (a CUDA event per
tick), so admission stays within one tick.
"""

from __future__ import annotations

import collections
import functools
import heapq
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models import vae as vae_lib
from unigen_tpu_torch.models.sana import sana_unigen_forward
from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
from unigen_tpu_torch.models.unigen_sd3 import unigen_sd3_forward
from unigen_tpu_torch.ops.packing import (pack_latents, prepare_latent_image_ids,
                                          unpack_latents)
from unigen_tpu_torch.ops.quant import residual_buffer
from unigen_tpu_torch.pipelines import scheduling
from unigen_tpu_torch.utils import resolve_device, tree_map

log = logging.getLogger(__name__)


def _require(ok: bool, msg: str = ""):
    """The JAX server's knob assertions, kept as AssertionErrors with the
    same messages (and raised under ``python -O`` too)."""
    if not ok:
        raise AssertionError(msg)


# The VAE ends of a server, bound to its VAE tree by ``functools.partial``:
# a bound method or a lambda over the server would make a reference cycle,
# and a closed server would then hold its trees until the collector runs.

def _flux_encode(vae_params, vae_cfg, dtype, px):
    return pack_latents(vae_lib.vae_encode(vae_params, vae_cfg, px)).to(dtype)


def _flux_decode(vae_params, vae_cfg, lh, lw, lat):
    return vae_lib.vae_decode(vae_params, vae_cfg,
                              unpack_latents(lat.to(torch.float32), lh, lw)).clamp(-1, 1)


def _sd3_encode(vae_params, vae_cfg, dtype, px):
    return vae_lib.vae_encode(vae_params, vae_cfg, px).to(dtype)


def _sd3_decode(vae_params, vae_cfg, lat):
    return vae_lib.vae_decode(vae_params, vae_cfg, lat.to(torch.float32)).clamp(-1, 1)


def _ae_encode(ae_encode, dtype, px):
    return ae_encode(px).to(dtype)


def _ae_decode(ae_decode, lat):
    return ae_decode(lat.to(torch.float32)).clamp(-1, 1)


class AdmissionRejected(RuntimeError):
    """Raised by :meth:`StepServer.submit` when admission control sheds the
    request (queue full under ``max_waiters``, or ``wait=False`` with no
    free slot). Callers that shed load catch this (and ``TimeoutError`` for
    an expired admission window) rather than bare ``RuntimeError``."""


@dataclass
class _Slot:
    future: Optional[Future] = None
    step: int = 0                      # next step index to run
    payload: Optional[dict] = None     # admission rows, applied at tick start
    # per-request knobs (host side; every per-step value is gathered from
    # the host each tick, so requests can mix schedules freely)
    num_steps: int = 0
    guidance: float = 0.0
    sched: Any = None                  # [num_steps] conditioning scale
    sigmas: Any = None                 # [num_steps + 1]
    timesteps: Any = None              # [num_steps], in the forward's units
    t_submit: float = 0.0              # admission wall clock (latency stats)

    @property
    def free(self) -> bool:
        return self.future is None


class StepServer:
    """Continuous step-level batching over one UniGen forward, on one device
    (CUDA unless ``device`` names the CPU)."""

    def __init__(self, cfg: UniGenConfig, params, vae_cfg=None,
                 vae_params=None, *,
                 ae_encode=None, ae_decode=None, ae_downscale: int = 32,
                 batch_size: int = 8, num_inference_steps: int = 4,
                 height: int = 512, width: int = 512,
                 guidance_scale: float = 3.5,
                 scheduler: Optional[scheduling.FlowMatchConfig] = None,
                 model_cache_interval: int = 1, model_cache_order: int = 0,
                 control_cache_interval: int = 1,
                 model_cache_threshold: float = 0.0,
                 control_cache_threshold: float = 0.0,
                 adaptive_lag: int = 0,
                 residual_cache_bits: int = 16,
                 max_waiters: Optional[int] = None,
                 multi_tick: int = 1,
                 mesh=None,
                 dtype: torch.dtype = torch.bfloat16,
                 device=None):
        _require(cfg.family in ("flux", "sana", "sd3"),
                 f"unknown family {cfg.family!r}")
        _require(cfg.control.moe.batch_mode == "per_sample",
                 "StepServer needs per-sample MoE routing (row independence)")
        _require(model_cache_interval >= 1 and model_cache_order in (0, 1))
        _require(control_cache_interval >= 1)
        _require(residual_cache_bits in (4, 8, 16),
                 "residual_cache_bits: 16 (bf16 exact), 8 (int8 per-token "
                 "quantized — HALF the per-slot residual-cache HBM; the slot-"
                 "count constraint at full topology / 1024²), or 4 "
                 "(nibble-packed int4 — QUARTER the bf16 residency)")
        self.res_bits = residual_cache_bits
        # adaptive drift thresholds (the one-shot pipelines' rules, per
        # slot): a slot refreshes when its latent drifted past the threshold
        # since its own last refresh; per-slot step 0 always refreshes
        self.thr_m = float(model_cache_threshold)
        self.thr_c = float(control_cache_threshold)
        self._adaptive = self.thr_m > 0.0 or self.thr_c > 0.0
        _require(self.thr_m >= 0.0 and self.thr_c >= 0.0)
        # adaptive_lag=1: tick T decides from the drift vector computed
        # after tick T-2 (one step stale), so the host never waits on the
        # tick in flight; a row whose slot refreshed after that vector was
        # computed reads drift 0 (its stale value would double-fire), which
        # also covers startup and new occupants
        self.adaptive_lag = int(adaptive_lag)
        _require(self.adaptive_lag in (0, 1))
        _require(self.adaptive_lag == 0 or self._adaptive,
                 "adaptive_lag needs an adaptive threshold")
        if self._adaptive:
            _require(model_cache_interval == 1 and control_cache_interval == 1,
                     "adaptive thresholds replace the fixed intervals (both "
                     "intervals OR both thresholds, never a mix)")
        if self.thr_m > 0.0 and self.thr_c > 0.0:
            _require(self.thr_c > self.thr_m,
                     "adaptive hybrid needs control_cache_threshold > "
                     "model_cache_threshold (below it, full refreshes fire "
                     "before base ever would)")
        if control_cache_interval > 1 and model_cache_interval > 1:
            # hybrid three-level schedule per slot: every full step must fall
            # on a base boundary
            _require(model_cache_interval < control_cache_interval
                     and control_cache_interval % model_cache_interval == 0,
                     "hybrid needs model_cache_interval < control_cache_interval "
                     "with the latter a multiple of the former")
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.params = tree_map(lambda t: t.to(dev), params)
        self.vae_cfg = vae_cfg
        self.vae_params = (None if vae_params is None
                           else tree_map(lambda t: t.to(dev), vae_params))
        self.family = cfg.family
        self.B = B = batch_size
        self.num_steps = num_inference_steps
        self.height, self.width = height, width
        self.dtype = dtype
        # timestep units differ per family: the flux and sana forwards take
        # 0..1 (timesteps / 1000, divided as the pipelines divide: the JAX
        # server multiplies by 1e-3, one float32 ulp off at some steps), sd3
        # the raw scheduler timesteps
        self._t_div = np.float32(1.0 if self.family == "sd3" else 1000.0)
        if self.family == "flux":
            bb = cfg.flux
            vs = vae_cfg.downscale
            lh, lw = 2 * (height // (vs * 2)), 2 * (width // (vs * 2))
            self.s_img = (lh // 2) * (lw // 2)
            seq_for_sigmas = self.s_img
            lat_shape = (B, self.s_img, bb.in_channels)
            self._img_ids = prepare_latent_image_ids(lh // 2, lw // 2, device=dev)
            sch = scheduler or scheduling.FlowMatchConfig(shift=1.0)
            self._encode = functools.partial(_flux_encode, self.vae_params,
                                             vae_cfg, dtype)
            self._decode = functools.partial(_flux_decode, self.vae_params,
                                             vae_cfg, lh, lw)
        elif self.family == "sd3":
            bb = cfg.sd3
            _require(cfg.control.use_encoder_hidden_states,
                     "sd3 StepServer runs the interleaved UniGenSD3 forward")
            vs = vae_cfg.downscale
            lh, lw = height // vs, width // vs
            self.s_img = (lh // bb.patch_size) * (lw // bb.patch_size)
            seq_for_sigmas = None       # the sd3 pipeline: static-shift sigmas
            lat_shape = (B, bb.in_channels, lh, lw)
            self._img_ids = None
            sch = scheduler or scheduling.FlowMatchConfig(shift=3.0)
            self._encode = functools.partial(_sd3_encode, self.vae_params,
                                             vae_cfg, dtype)
            self._decode = functools.partial(_sd3_decode, self.vae_params,
                                             vae_cfg)
        else:
            bb = cfg.sana
            _require(ae_encode is not None and ae_decode is not None,
                     "sana StepServer needs the DC-AE codec (ae_encode/ae_decode"
                     " callables, e.g. from load_sana_pipeline)")
            lh, lw = height // ae_downscale, width // ae_downscale
            self.s_img = (lh // bb.patch_size) * (lw // bb.patch_size)
            # the sana pipeline passes the raw latent area (before
            # patchify) as image_seq_len; so does the server
            seq_for_sigmas = lh * lw
            lat_shape = (B, bb.in_channels, lh, lw)
            self._img_ids = None
            sch = scheduler or scheduling.FlowMatchConfig(shift=3.0)
            # the codec callables carry their own trees (load_sana_pipeline
            # binds them); JAX threads ``ae_params`` through its jit, which
            # the eager port has no use for
            self._encode = functools.partial(_ae_encode, ae_encode, dtype)
            self._decode = functools.partial(_ae_decode, ae_decode)
        if mesh is not None:
            raise NotImplementedError(
                "StepServer(mesh=...) waits for the port of unigen_tpu/parallel "
                "(ROADMAP Queue 1 item 8)")
        self._lh, self._lw = lh, lw
        # per-request schedules: the (sigmas, timesteps) pair per step count
        # (the image_seq_len of the dynamic shift is fixed by the server's
        # resolution, so each schedule equals the one-shot pipeline's)
        self._sch, self._seq_for_sigmas = sch, seq_for_sigmas
        self._sched_cache: Dict[int, tuple] = {}
        self._sigmas, self._timesteps = self._schedule_for(num_inference_steps)
        self._guidance_scale = guidance_scale
        self._txt_ids = None

        def zeros(shape):
            return torch.zeros(shape, dtype=dtype, device=dev)
        # device state: full-slot tensors, replaced (never written) per tick
        self._lat = zeros(lat_shape)
        self._cond = zeros(lat_shape)
        self._embeds = None                     # [B, T, D] set on first admit
        self._mask = None                       # [B, T] int32 (sana)
        # sd3 slots stack the (neg, pos) CFG pair on axis 1 of the stream rows
        self._pooled = zeros((B, 2, bb.pooled_projection_dim)
                             if self.family == "sd3"
                             else (B, bb.pooled_projection_dim))
        self._cond_pooled = zeros((B, bb.pooled_projection_dim))
        self._slots: List[_Slot] = [_Slot() for _ in range(B)]
        self.cache_k = int(model_cache_interval)
        self.cache_order = int(model_cache_order)
        self.cache_c = int(control_cache_interval)
        if self._adaptive:
            # per-slot drift references: the input latent of each slot's last
            # full / prediction refresh
            self._ref_full = zeros(lat_shape) if self.thr_c > 0 else None
            self._ref_pred = zeros(lat_shape)
            if self.adaptive_lag:
                # (tick_seq, d_full, d_pred, event): drift vectors copied to
                # host memory after each tick's commit, read two ticks later
                self._pending_drift = collections.deque()
                self._tick_seq = 0
                # tick seq of each slot's last full / prediction refresh
                self._seq_full = np.full((B,), -1, np.int64)
                self._seq_pred = np.full((B,), -1, np.int64)
        if self.cache_k > 1 or self.cache_c > 1 or self._adaptive:
            # per-slot prediction cache: p1 = the latest refreshed prediction,
            # p0 = the one before; the refresh step indices stay on the host
            self._p1 = zeros(lat_shape)
            self._p0 = zeros(lat_shape)
            self._i1 = np.full((B,), -1, np.int64)
            self._i0 = np.full((B,), -1, np.int64)
        # per-slot control-residual cache (the hybrid's middle level): the
        # family forward's residual tree with the slot axis at position 1,
        # allocated at the first admission (flux needs the text length)
        self._res = None
        # gathered sizes of the refresh subset: powers of two and B
        self._sizes = sorted({1 << p for p in range(B.bit_length())
                              if (1 << p) <= B} | {B})
        self._lock = threading.Lock()
        self._closed = False
        self._stats = dict(submitted=0, retired=0, failed=0, cancelled=0,
                           rejected=0, timed_out=0,
                           ticks=0, ticks_replay=0, ticks_fused=0,
                           rows_full=0, rows_base=0,
                           rows_refresh=0, rows_pad=0, active_row_steps=0)
        # backpressure: with wait=True at most this many submitters queue for
        # a slot; beyond it submit() raises at once (None = unbounded)
        self.max_waiters = None if max_waiters is None else int(max_waiters)
        _require(self.max_waiters is None or self.max_waiters >= 1)
        self._work = threading.Condition(self._lock)
        # priority admission: contending submitters hold a (-priority,
        # arrival) ticket; a free slot goes to the heap top
        self._wait_heap: List[tuple] = []
        self._ticket_seq = itertools.count()
        # end-to-end request latencies and retirement times over a sliding
        # window of 2048 requests (percentiles and a throughput gauge)
        self._lat_samples: collections.deque = collections.deque(maxlen=2048)
        self._retire_times: collections.deque = collections.deque(maxlen=2048)
        # multi_tick=K (exact mode only): at full occupancy run up to K exact
        # ticks back to back with no host bookkeeping between them; the
        # window never crosses a retirement (K is capped by the least
        # remaining steps), so waiters admit at the tick they would under
        # single ticks; a cancel mid-window frees its slot up to K-1 ticks late
        self.multi_tick = int(multi_tick)
        _require(self.multi_tick >= 1)
        if self.multi_tick > 1:
            _require(not (self.cache_k > 1 or self.cache_c > 1 or self._adaptive),
                     "multi_tick fuses EXACT ticks only (cache/adaptive "
                     "schedules decide per-tick row subsets on the host)")
        self._t_len = None
        # retirement (VAE decode and the copy to the host) runs on its own
        # thread so the step loop never waits on it
        self._retire_q: "queue.Queue" = queue.Queue()
        self._retirer = threading.Thread(target=self._retire_loop, daemon=True)
        self._retirer.start()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ program

    def _schedule_for(self, n_steps: int):
        """(sigmas [n+1], the forward's timesteps [n]) as float32 numpy for a
        request's step count (cached; cheap per admission)."""
        if n_steps not in self._sched_cache:
            sig, tst = scheduling.inference_sigmas(
                self._sch, n_steps, image_seq_len=self._seq_for_sigmas)
            self._sched_cache[n_steps] = (sig.numpy(), tst.numpy() / self._t_div)
        return self._sched_cache[n_steps]

    def stats(self) -> dict:
        """Serving counters (snapshot): submitted/retired/failed requests,
        ticks (ticks_replay = ticks that skipped the transformer), forward
        rows by kind (full / base-with-control-replay / plain refresh),
        rows_pad (gather padding), mean_occupancy = active_row_steps /
        (ticks * batch_size), latency_ms (submit -> image percentiles over
        the last 2048 requests, slot-queue wait included) and
        throughput_img_s (the retire rate over the same window). Load
        shedding: ``timed_out`` (admission-timeout expiries) and
        ``rejected`` (max_waiters rejections)."""
        with self._lock:
            s = dict(self._stats)
            samples = list(self._lat_samples)
            times = list(self._retire_times)
        s["mean_occupancy"] = (s["active_row_steps"]
                               / (s["ticks"] * self.B) if s["ticks"] else 0.0)
        if samples:
            arr = np.sort(np.asarray(samples, np.float64))
            s["latency_ms"] = {
                "n": int(arr.size),
                "p50": round(float(np.percentile(arr, 50)), 1),
                "p95": round(float(np.percentile(arr, 95)), 1),
                "max": round(float(arr[-1]), 1)}
        if len(times) >= 2 and times[-1] > times[0]:
            s["throughput_img_s"] = round(
                (len(times) - 1) / (times[-1] - times[0]), 3)
        return s

    def warmup(self, t_len: int, rounds: int = 2) -> int:
        """Run the serving ladder once before real traffic: admits ``rounds
        * batch_size`` zero requests with blocking admission (the staggered
        phases interleave the per-slot schedules, so every gathered size,
        the replay and update paths and both codec directions run), then
        :meth:`prewarm_multi_tick`. Nothing is compiled here; the run warms
        what the card's first calls pay for: the kernels' loading and
        tensor maps, cuDNN's algorithm choice in the VAE, cuBLAS handles
        and the caching allocator's pools. ``t_len`` is the serving text
        length (flux 512, sd3 77+256, sana 300). Slot state is rewritten on
        admission, so a warmed server serves like a fresh one. Returns the
        number of warm-up requests run."""
        bb = self.cfg.backbone
        emb_dim = (bb.caption_channels if self.family == "sana"
                   else bb.joint_attention_dim)
        req = dict(
            prompt_embeds=np.zeros((1, t_len, emb_dim), np.float32),
            pooled=np.zeros((1, bb.pooled_projection_dim), np.float32),
            cond_pooled=np.zeros((1, bb.pooled_projection_dim), np.float32),
            control_pixels=np.zeros((1, 3, self.height, self.width), np.float32))
        if self.family == "sana":
            req["prompt_mask"] = np.ones((1, t_len), np.int32)
        futs = [self.submit(**req, wait=True)
                for _ in range(max(1, rounds) * self.B)]
        for f in futs:
            f.result()
        self.prewarm_multi_tick()
        return len(futs)

    @torch.no_grad()
    def prewarm_multi_tick(self) -> int:
        """Run every multi-tick window size (K = 2..multi_tick) once on the
        current state and discard the result: full-occupancy windows may
        never occur under blocking warm-up admissions. A no-op before the
        first admission (the state needs the text length) or when
        multi_tick <= 1. Returns the number of window sizes run."""
        if self.multi_tick <= 1 or self._t_len is None:
            return 0
        with self._work:
            state = self._state()
        for k in range(2, self.multi_tick + 1):
            zeros = torch.zeros((k, self.B), dtype=torch.float32, device=self.device)
            self._multi_step(state, zeros, zeros, zeros, zeros, zeros[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self.multi_tick - 1

    @staticmethod
    def _bsig(x, lat):
        """Broadcast a per-sample [m] vector against the latent layout."""
        return x.reshape((-1,) + (1,) * (lat.dim() - 1))

    def _res_pack(self, new):
        """Forward-output residuals -> cache-row layout. sd3 captures at batch
        2m ([neg rows | pos rows]); the cache keeps the CFG pair on its own
        axis ([n, m, 2, ...]) so the slot axis stays at position 1."""
        if self.family != "sd3":
            return new
        return tree_map(lambda r: r.reshape((r.shape[0], 2, r.shape[1] // 2)
                                            + tuple(r.shape[2:])).transpose(1, 2),
                        new)

    def _res_unpack(self, rows):
        """Inverse of :meth:`_res_pack` (cache rows -> forward batch)."""
        if self.family != "sd3":
            return rows
        return tree_map(lambda r: r.transpose(1, 2).reshape(
            (r.shape[0], r.shape[1] * 2) + tuple(r.shape[3:])), rows)

    def _fwd(self, lat, cond, embeds, mask, pooled, cpool, t_now, scale, g, **kw):
        """The family forward over gathered rows, shared by the exact step,
        the model-cache refresh and the hybrid full/base forwards -> the
        forward's (pred, losses, outs). ``t_now``, ``scale`` and ``g`` are
        float32 [m] vectors on the device: flux feeds ``g`` to the guidance
        embedder; sd3 runs the duplicated 2m CFG batch and returns the
        guided prediction ``neg + g * (pos - neg)``, so everything
        downstream (Euler, caches) sees one prediction per slot; sana takes
        the per-row padding ``mask`` [m, T] and ignores ``g``."""
        cfg, dtype = self.cfg, self.dtype
        if self.family == "sana":
            return sana_unigen_forward(
                self.params, cfg, lat, cond, embeds, pooled, cpool, t_now.to(dtype),
                mask, conditioning_scale=scale[:, None, None].to(dtype), **kw)
        if self.family == "flux":
            if self._txt_ids is None or self._txt_ids.shape[0] != embeds.shape[1]:
                self._txt_ids = torch.zeros(embeds.shape[1], 3, device=self.device)
            return unigen_flux_forward(
                self.params, cfg, lat, cond, embeds, pooled, cpool,
                t_now.to(dtype), self._img_ids, self._txt_ids, self._img_ids,
                g.to(dtype) if cfg.flux.guidance_embeds else None,
                # in the activation dtype: an fp32 per-sample scale would
                # promote the bf16 residuals
                conditioning_scale=scale[:, None, None].to(dtype), **kw)

        # the (neg, pos) duplication inside the call: embeds/pooled carry
        # the stacked pair on axis 1, lat/cond/cond_pooled serve both
        def two(t):
            return torch.cat([t, t])
        if "control_residuals" in kw:
            kw["control_residuals"] = self._res_unpack(kw["control_residuals"])
        pred2, losses, outs = unigen_sd3_forward(
            self.params, cfg, two(lat), two(cond),
            torch.cat([embeds[:, 0], embeds[:, 1]]),
            torch.cat([pooled[:, 0], pooled[:, 1]]), two(cpool),
            two(t_now).to(dtype),
            conditioning_scale=two(scale)[:, None, None].to(dtype), **kw)
        neg, pos = pred2.chunk(2)
        pred = neg + self._bsig(g, pred2).to(pred2.dtype) * (pos - neg)
        if "control_residuals" in outs:
            outs["control_residuals"] = self._res_pack(outs["control_residuals"])
        return pred, losses, outs

    def _state(self) -> dict:
        """The state tensors a tick reads (snapshot under the lock)."""
        return dict(lat=self._lat, cond=self._cond, embeds=self._embeds,
                    mask=self._mask, pooled=self._pooled, cpool=self._cond_pooled)

    def _exact_step(self, st, lat, t_now, s_now, s_next, scale, g):
        """One exact tick over all B rows: forward, then Euler."""
        pred, _, _ = self._fwd(lat, st["cond"], st["embeds"], st.get("mask"),
                               st["pooled"], st["cpool"], t_now, scale, g)
        return scheduling.euler_step(lat, pred, self._bsig(s_now, lat),
                                     self._bsig(s_next, lat))

    def _multi_step(self, st, t_mat, s_mat, sn_mat, sc_mat, g):
        """K exact ticks back to back from per-tick [K, B] rows (every slot's
        future steps are known); the values equal K single ticks."""
        lat = st["lat"]
        for j in range(t_mat.shape[0]):
            lat = self._exact_step(st, lat, t_mat[j], s_mat[j], sn_mat[j],
                                   sc_mat[j], g)
        return lat

    def _gathered(self, st, idx, t_r, sc_r, g_r, **kw):
        """The family forward over the slots ``idx`` (gathered rows)."""
        mask = st.get("mask")          # the sana family's alone
        return self._fwd(st["lat"].index_select(0, idx),
                         st["cond"].index_select(0, idx),
                         st["embeds"].index_select(0, idx),
                         None if mask is None else mask.index_select(0, idx),
                         st["pooled"].index_select(0, idx),
                         st["cpool"].index_select(0, idx), t_r, sc_r, g_r, **kw)

    def _update(self, lat, p1, p0, fresh, idx, gap, dt, s_now, s_next):
        """Scatter fresh predictions into the per-slot cache, form every
        slot's prediction and Euler-step all rows. The replay expression
        ``p1 + gap * ((p1 - p0) / dt)`` is ``model_cache_scan``'s order-1
        arithmetic (gap and dt in the cache dtype); refreshing slots ride it
        with gap 0, dt 1, so their prediction is the fresh one."""
        bsig = self._bsig
        refreshed = torch.zeros(self.B, dtype=torch.bool,
                                device=lat.device).index_fill_(0, idx, True)
        p0n = torch.where(bsig(refreshed, p1), p1, p0)
        p1n = p1.index_copy(0, idx, fresh.to(p1.dtype))
        slope = (p1n - p0n) / bsig(dt, p1).to(p1.dtype)
        pred = p1n + bsig(gap, p1).to(p1.dtype) * slope
        lat_n = scheduling.euler_step(lat, pred, bsig(s_now, lat),
                                      bsig(s_next, lat))
        return lat_n, p1n, p0n

    def _replay(self, lat, p1, p0, gap, dt, s_now, s_next):
        """All-replay tick: no forward, the (extrapolated) cached predictions
        through one Euler step."""
        bsig = self._bsig
        slope = (p1 - p0) / bsig(dt, p1).to(p1.dtype)
        pred = p1 + bsig(gap, p1).to(p1.dtype) * slope
        return scheduling.euler_step(lat, pred, bsig(s_now, lat),
                                     bsig(s_next, lat))

    @staticmethod
    def _drift(lat, ref):
        """Per-slot relative L1 drift ([B] float32): caching.rel_change row
        by row."""
        a, b = lat.to(torch.float32), ref.to(torch.float32)
        dims = tuple(range(1, lat.dim()))
        return (a - b).abs().mean(dims) / (b.abs().mean(dims) + 1e-8)

    def _to_host(self, vecs):
        """Copy drift vectors to host memory without waiting: pinned buffers
        and a CUDA event on the card (read after ``event.synchronize()``),
        plain copies on the CPU."""
        if self.device.type != "cuda":
            return [None if v is None else v.clone() for v in vecs], None
        out = []
        for v in vecs:
            if v is None:
                out.append(None)
                continue
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            out.append(h)
        event = torch.cuda.Event()
        event.record()
        return out, event

    def _lagged_drift(self, active):
        """Decision inputs under ``adaptive_lag=1``: the drift vectors copied
        after tick T-2 (that tick has run by now, so reading them does not
        stall on tick T-1). A row whose slot refreshed after they were
        computed reads 0 (replay/base): its stale pre-refresh drift would
        double-fire. Every admission's forced full at its step 0 stamps its
        refresh seq ahead of all older vectors, so a previous occupant's
        drift never leaks into a decision. Net: the one-shot adaptive rule
        evaluated one step late, with no extra refreshes."""
        hseq, hf, hp = -1, None, None
        if len(self._pending_drift) >= 2:
            hseq, (hf, hp), event = self._pending_drift.popleft()
            if event is not None:
                event.synchronize()
        inf = np.float32(np.inf)
        d_full = d_pred = None
        if self.thr_c > 0:
            d_full = (np.array(hf.numpy(), np.float32) if hf is not None
                      else np.full((self.B,), inf, np.float32))
        if self.thr_m > 0:
            d_pred = (np.array(hp.numpy(), np.float32) if hp is not None
                      else np.full((self.B,), inf, np.float32))
        for i, s in active:
            if d_full is not None and self._seq_full[i] > hseq:
                d_full[i] = 0.0
            if d_pred is not None and self._seq_pred[i] > hseq:
                d_pred[i] = 0.0
        return d_full, d_pred

    def _vec(self, x, dtype=np.float32):
        """A host array (a copy) as a tensor on the device, without a stream
        sync: on the card it goes through pinned memory with
        ``non_blocking=True`` (the caching host allocator keeps the buffer
        until the copy has run). A blocking copy from pageable memory would
        synchronize the stream, so the worker would wait for the tick in
        flight before it builds the next one, and the run-ahead window
        would never fill. Callers stack a tick's vectors into one array."""
        host = torch.from_numpy(np.array(x, dtype))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _padded(self, rows):
        """``rows`` padded to the smallest size of the ladder by repeating the
        first (its duplicate scatter writes the same value)."""
        m = next(sz for sz in self._sizes if sz >= len(rows))
        return np.asarray((rows + [rows[0]] * m)[:m], np.int64)

    def _plan(self, rows, scale, gvec):
        """The gathered forward of the slots ``rows`` -> (index tensor,
        timesteps, scales, guidances) on the device, and the pad count."""
        idx = self._padded(rows)
        m = len(idx)
        t_r = [self._slots[i].timesteps[self._slots[i].step] for i in idx]
        return ((self._vec(idx, np.int64),
                 *self._vec(np.stack([t_r, scale[idx], gvec[idx]])).unbind(0)),
                m - len(rows))

    def _prepare_cached_tick(self, active, s_now, s_next, scale, gvec,
                             drift=None):
        """Called under the lock: snapshot device and host state into a thunk
        that runs one model-cache tick outside the lock. A slot refreshes on
        its own schedule (``step % k == 0``, so admissions refresh at step
        0) or, adaptive, when its latent drifted past the model threshold
        since its last refresh. Refreshing slots run in the smallest
        gathered size that fits. The thunk returns ``(new_lat, commit)``;
        ``commit`` (run under the lock once the tick ran cleanly) publishes
        the prediction cache and the refresh indices, so a failed tick
        leaves the cache untouched."""
        k, order, B = self.cache_k, self.cache_order, self.B
        if drift is not None:
            thr = np.float32(self.thr_m)
            refresh = [i for i, s in active
                       if self._i1[i] < 0 or drift[i] > thr]
        else:
            refresh = [i for i, s in active
                       if s.step % k == 0 or self._i1[i] < 0]
        rset = set(refresh)
        # replay coefficients (model_cache_scan): order 0, or fewer than two
        # refreshes, holds p1 (gap 0); order 1 extrapolates by
        # (step - i1) / max(i1 - i0, 1)
        gap = np.zeros((B,), np.float32)
        dt = np.ones((B,), np.float32)
        i1n, i0n = self._i1.copy(), self._i0.copy()
        for i, s in active:
            if i in rset:
                i0n[i] = i1n[i]
                i1n[i] = s.step
            elif order >= 1 and self._i0[i] >= 0:
                gap[i] = s.step - self._i1[i]
                dt[i] = max(self._i1[i] - self._i0[i], 1)
        st = self._state()
        p1, p0 = self._p1, self._p0
        s_now_j, s_next_j, gap_j, dt_j = self._vec(
            np.stack([s_now, s_next, gap, dt])).unbind(0)

        if not refresh:
            self._stats["ticks_replay"] += 1

            def tick():
                return self._replay(st["lat"], p1, p0, gap_j, dt_j, s_now_j,
                                    s_next_j), None
            return tick

        (idx, t_r, sc_r, g_r), pad = self._plan(refresh, scale, gvec)
        self._stats["rows_refresh"] += len(refresh)
        self._stats["rows_pad"] += pad
        adaptive = drift is not None
        ref_pred = self._ref_pred if adaptive else None
        seq = self._tick_seq if adaptive and self.adaptive_lag else None
        refresh_arr = np.asarray(refresh, np.int64)

        def tick():
            fresh = self._gathered(st, idx, t_r, sc_r, g_r)[0]
            new_lat, p1n, p0n = self._update(st["lat"], p1, p0, fresh, idx, gap_j,
                                             dt_j, s_now_j, s_next_j)
            # adaptive: the drift reference tracks the input latent of the
            # refreshing step (model_cache_scan's lat_ref)
            ref_n = (ref_pred.index_copy(0, idx, st["lat"].index_select(0, idx))
                     if adaptive else None)

            def commit():
                self._p1, self._p0 = p1n, p0n
                self._i1, self._i0 = i1n, i0n
                if adaptive:
                    self._ref_pred = ref_n
                if seq is not None:
                    self._seq_pred[refresh_arr] = seq
            return new_lat, commit
        return tick

    def _prepare_hybrid_tick(self, active, s_now, s_next, scale, gvec,
                             drift_full=None, drift_pred=None):
        """Per-slot three-level schedule (hybrid_cache_scan): FULL on the
        slot's own c-boundary (or before its first refresh), BASE with
        control-residual replay on its k-boundary (every non-full step when
        k == 1, the pure control cache), prediction replay otherwise.
        Adaptive: FULL when the slot drifted past the control threshold
        since its last full step, then BASE when it drifted past the model
        threshold since its last prediction refresh (every non-full step
        when only the control threshold is set). Full and base slots run
        their own gathered forwards; the fresh predictions of both merge
        into one update. Same thunk/commit contract as
        :meth:`_prepare_cached_tick`; the residual rows of full slots are
        written in place during the tick."""
        c, k, order = self.cache_c, self.cache_k, self.cache_order
        B = self.B
        adaptive = drift_full is not None
        if adaptive:
            thr_c = np.float32(self.thr_c)
            full_l = [i for i, s in active
                      if self._i1[i] < 0 or drift_full[i] > thr_c]
            fset = set(full_l)
            if self.thr_m > 0:
                thr_m = np.float32(self.thr_m)
                base_l = [i for i, s in active
                          if i not in fset and drift_pred[i] > thr_m]
            else:
                base_l = [i for i, s in active if i not in fset]
        else:
            full_l = [i for i, s in active
                      if s.step % c == 0 or self._i1[i] < 0]
            fset = set(full_l)
            base_l = [i for i, s in active
                      if i not in fset and (k == 1 or s.step % k == 0)]
        gap = np.zeros((B,), np.float32)
        dt = np.ones((B,), np.float32)
        i1n, i0n = self._i1.copy(), self._i0.copy()
        refreshing = fset | set(base_l)
        for i, s in active:
            if i in refreshing:
                i0n[i] = i1n[i]
                i1n[i] = s.step
            elif order >= 1 and self._i0[i] >= 0:
                gap[i] = s.step - self._i1[i]
                dt[i] = max(self._i1[i] - self._i0[i], 1)
        st = self._state()
        p1, p0 = self._p1, self._p0
        res = self._res
        s_now_j, s_next_j, gap_j, dt_j = self._vec(
            np.stack([s_now, s_next, gap, dt])).unbind(0)

        if not full_l and not base_l:
            self._stats["ticks_replay"] += 1

            def tick():
                return self._replay(st["lat"], p1, p0, gap_j, dt_j, s_now_j,
                                    s_next_j), None
            return tick

        self._stats["rows_full"] += len(full_l)
        self._stats["rows_base"] += len(base_l)

        def plan(lst):
            out, pad = self._plan(lst, scale, gvec)
            self._stats["rows_pad"] += pad
            return out

        full_plan = plan(full_l) if full_l else None
        base_plan = plan(base_l) if base_l else None
        comb = full_l + base_l
        n_ref, idx_u = len(comb), self._padded(comb)
        m_u, idx_u = len(idx_u), self._vec(idx_u, np.int64)
        nf, nb = len(full_l), len(base_l)
        seq = self._tick_seq if adaptive and self.adaptive_lag else None
        full_arr = np.asarray(full_l, np.int64)
        comb_arr = np.asarray(comb, np.int64)
        ref_full_b = self._ref_full if adaptive else None
        ref_pred_b = self._ref_pred if adaptive else None
        bits = self.res_bits

        def tick():
            # base FIRST: it gathers the old residual rows, which the full
            # forward then overwrites in place; launch order on the stream
            # orders the two
            fresh_b = None
            if base_plan is not None:
                idx, t_r, sc_r, g_r = base_plan
                fresh_b = self._gathered(
                    st, idx, t_r, sc_r, g_r,
                    control_residuals=tree_map(lambda r: r.index_select(1, idx), res))[0]
            rows = []
            if full_plan is not None:
                idx, t_r, sc_r, g_r = full_plan
                fresh_f, _, outs = self._gathered(st, idx, t_r, sc_r, g_r,
                                                  return_control_residuals=True,
                                                  control_residuals_bits=bits)
                tree_map(lambda r, nw: r.index_copy_(1, idx, nw), res,
                         outs["control_residuals"])
                rows.append(fresh_f[:nf])
            if fresh_b is not None:
                rows.append(fresh_b[:nb])
            fresh = rows[0] if len(rows) == 1 else torch.cat(rows)
            if fresh.shape[0] < m_u:      # pad by repeating a real row: its
                fresh = torch.cat(        # duplicate scatter is a no-op
                    [fresh, fresh[:1].expand((m_u - n_ref,) + tuple(fresh.shape[1:]))])
            new_lat, p1n, p0n = self._update(st["lat"], p1, p0, fresh, idx_u, gap_j,
                                             dt_j, s_now_j, s_next_j)
            # adaptive: the drift references track the input latent of each
            # refreshing step (pred ref on full OR base)
            lat = st["lat"]
            reff_n = (ref_full_b.index_copy(0, full_plan[0],
                                            lat.index_select(0, full_plan[0]))
                      if adaptive and full_plan is not None else ref_full_b)
            refp_n = (ref_pred_b.index_copy(0, idx_u, lat.index_select(0, idx_u))
                      if adaptive else None)

            def commit():
                self._p1, self._p0 = p1n, p0n
                self._i1, self._i0 = i1n, i0n
                if adaptive:
                    self._ref_full = reff_n
                    self._ref_pred = refp_n
                if seq is not None:
                    if full_arr.size:
                        self._seq_full[full_arr] = seq
                    self._seq_pred[comb_arr] = seq
            return new_lat, commit
        return tick

    # ------------------------------------------------------------ client

    @torch.no_grad()
    def submit(self, *, prompt_embeds, pooled, cond_pooled, control_pixels,
               prompt_mask=None, neg_embeds=None, neg_pooled=None,
               conditioning_scale: float = 1.0,
               guidance_scale: Optional[float] = None,
               num_inference_steps: Optional[int] = None,
               control_guidance_start: float = 0.0,
               control_guidance_end: float = 1.0,
               seed: int = 0, latents=None, wait: bool = False,
               priority: int = 0,
               timeout: Optional[float] = None) -> Future:
        """Admit one request (leading dim 1 on every array; numpy arrays or
        tensors). Returns a Future resolving to a uint8 image [1, H, W, 3]
        (a CPU tensor). wait=True blocks until a slot frees instead of
        raising. ``prompt_mask`` [1, T] is the sana padding mask (all ones
        by default). ``neg_embeds``/``neg_pooled`` are the sd3 negative
        stream (zeros by default, the one-shot pipeline's default). Without
        ``latents`` the noise is drawn from a ``torch.Generator`` on the
        server's device seeded with ``seed`` (the port pipeline's draw; it
        cannot equal the JAX server's PRNG).

        Per-request knobs (each defaults to the server's value; one server
        mixes them freely):
          * ``guidance_scale``: flux guidance embedding / sd3 CFG combine
            coefficient (a per-row vector); sana has no guidance, and a
            value raises.
          * ``num_inference_steps``: the request's own schedule; the slot
            retires at its own step count.
          * ``control_guidance_start``/``end``: the conditioning-scale
            keep-window: the control branch is on for steps with start <=
            i/n and (i+1)/n <= end.
          * ``priority``: admission priority under contention (higher wins,
            FIFO within a priority); a freed slot goes to the best waiter.
            Slots in flight are never evicted. A ``wait=False`` submit
            raises rather than overtake a waiting request.
          * ``timeout``: admission deadline in seconds for ``wait=True``:
            past it the submit raises ``TimeoutError`` and its ticket leaves
            the queue. With ``max_waiters`` set, a submit beyond that many
            queued waiters raises ``AdmissionRejected`` at once, unless its
            priority strictly beats every queued waiter's. ``timeout``
            with ``wait=False`` raises ``ValueError``."""
        fut: Future = Future()
        if self.family == "sana" and guidance_scale is not None:
            raise ValueError("sana denoises without guidance; "
                             "guidance_scale is not a sana request knob")
        if timeout is not None and not wait:
            raise ValueError("timeout= only bounds the wait=True admission "
                             "window; a wait=False submit returns (or "
                             "sheds) immediately, so a timeout would be "
                             "silently meaningless")
        n_steps = (self.num_steps if num_inference_steps is None
                   else int(num_inference_steps))
        _require(n_steps >= 1)
        sig, tst = self._schedule_for(n_steps)
        keep = np.array([
            1.0 - float((i / n_steps < control_guidance_start)
                        or ((i + 1) / n_steps > control_guidance_end))
            for i in range(n_steps)], np.float32)
        sched = np.float32(conditioning_scale) * keep
        g = (self._guidance_scale if guidance_scale is None
             else float(guidance_scale))
        dev, dt = self.device, self.dtype
        embeds = torch.as_tensor(prompt_embeds).to(dev, dt)
        _require(embeds.shape[0] == 1, "one sample per request")
        pooled = torch.as_tensor(pooled).to(dev, dt)
        if self.family == "sd3":
            # stack the (neg, pos) CFG pair on axis 1: one slot, two rows
            neg_e = (torch.zeros_like(embeds) if neg_embeds is None
                     else torch.as_tensor(neg_embeds).to(dev, dt))
            neg_p = (torch.zeros_like(pooled) if neg_pooled is None
                     else torch.as_tensor(neg_pooled).to(dev, dt))
            embeds = torch.stack([neg_e[0], embeds[0]])[None]   # [1, 2, T, D]
            pooled = torch.stack([neg_p[0], pooled[0]])[None]   # [1, 2, D]
        cond_lat = self._encode(torch.as_tensor(control_pixels).to(dev, torch.float32))
        if latents is None:
            latents = torch.randn((1,) + tuple(self._lat.shape[1:]),
                                  generator=torch.Generator(device=dev).manual_seed(seed),
                                  device=dev, dtype=dt)
        else:
            latents = torch.as_tensor(latents).to(dev, dt)
        cond_pooled = torch.as_tensor(cond_pooled).to(dev, dt)
        if self.family == "sana":
            prompt_mask = (torch.ones((1, embeds.shape[1]), dtype=torch.int32, device=dev)
                           if prompt_mask is None else
                           torch.as_tensor(prompt_mask).to(dev, torch.int32))
        with self._work:
            if self._closed:
                raise RuntimeError("server is closed")
            if (wait and self.max_waiters is not None
                    and len(self._wait_heap) >= self.max_waiters
                    # a request that strictly beats the best queued waiter
                    # may still enqueue (heap entries are (-prio, seq))
                    and not (self._wait_heap
                             and -int(priority) < self._wait_heap[0][0])):
                self._stats["rejected"] += 1
                raise AdmissionRejected(
                    f"admission queue full ({self.max_waiters} waiters); "
                    "back off and retry")
            ticket = (-int(priority), next(self._ticket_seq))
            heapq.heappush(self._wait_heap, ticket)
            idx = None
            deadline = (None if timeout is None
                        else time.monotonic() + float(timeout))
            expired = False
            try:
                while not self._closed:
                    idx = next((i for i, s in enumerate(self._slots)
                                if s.free), None)
                    if idx is not None and self._wait_heap[0] == ticket:
                        break
                    idx = None
                    if not wait:
                        break
                    if deadline is None:
                        self._work.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            expired = True
                            break
                        self._work.wait(remaining)
            finally:
                if self._wait_heap[0] == ticket:
                    heapq.heappop(self._wait_heap)
                else:
                    self._wait_heap.remove(ticket)
                    heapq.heapify(self._wait_heap)
                if self._wait_heap:
                    # the new heap top may be eligible for a free slot
                    self._work.notify_all()
            if idx is None:
                if self._closed:
                    raise RuntimeError("server closed")
                if expired:
                    self._stats["timed_out"] += 1
                    raise TimeoutError(
                        f"no slot freed within {timeout}s admission window")
                raise AdmissionRejected("no free slot; back off and retry")
            if self._embeds is None:
                self._allocate(embeds)
            _require(tuple(embeds.shape[1:]) == tuple(self._embeds.shape[1:]),
                     "all requests must share the text sequence length")
            # the row writes wait for the worker at tick start: made here
            # they could interleave with a tick that is being dispatched
            payload = dict(lat=latents, cond=cond_lat, embeds=embeds,
                           pooled=pooled, cond_pooled=cond_pooled)
            if self.family == "sana":
                payload["mask"] = prompt_mask
            self._slots[idx] = _Slot(
                future=fut, step=0, payload=payload, num_steps=n_steps,
                guidance=g, sched=sched, sigmas=sig, timesteps=tst,
                t_submit=time.perf_counter())
            self._stats["submitted"] += 1
            self._work.notify()
        return fut

    def _allocate(self, embeds):
        """First admission (lock held): the text rows, and the residual cache
        where a control cache is on (at 16 bits the activation dtype, at 8
        or 4 quantized codes with a float32 scale a token; the slot axis is
        at position 1 in every leaf)."""
        B, dev = self.B, self.device
        self._embeds = torch.zeros((B,) + tuple(embeds.shape[1:]), dtype=self.dtype,
                                   device=dev)
        if self.family == "sana":
            self._mask = torch.zeros((B, embeds.shape[1]), dtype=torch.int32, device=dev)
        t_len = embeds.shape[2] if self.family == "sd3" else embeds.shape[1]
        self._t_len = t_len
        if not (self.cache_c > 1 or self.thr_c > 0):
            return

        def buf(shape):
            return residual_buffer(shape, self.res_bits, self.dtype, device=dev)
        if self.family == "flux":
            bb = self.cfg.flux
            d_inner = bb.num_attention_heads * bb.attention_head_dim
            # (doubles on the image stream, singles on [txt | img])
            self._res = (buf((bb.num_layers, B, self.s_img, d_inner)),
                         buf((bb.num_single_layers, B, t_len + self.s_img, d_inner)))
        elif self.family == "sd3":
            # raw control-block outputs for both CFG halves (axis 2)
            bb = self.cfg.sd3
            self._res = buf((bb.num_layers, B, 2, self.s_img, bb.inner_dim))
        else:
            bb = self.cfg.sana
            self._res = buf((bb.num_layers, B, self.s_img, bb.inner_dim))

    def _sweep_cancelled(self):
        """Free slots whose future was cancelled (lock held). ``Future.cancel()``
        is the cancellation API: the server never marks futures running, so
        a cancel succeeds any time before the result lands, and the slot is
        reclaimed at the next tick boundary."""
        freed = False
        for i, s in enumerate(self._slots):
            if s.future is not None and s.future.cancelled():
                self._slots[i] = _Slot()
                self._stats["cancelled"] += 1
                freed = True
        if freed:
            self._work.notify_all()   # wake blocking submits

    def close(self):
        with self._work:
            self._closed = True
            self._work.notify()
        self._worker.join()
        self._retire_q.put(None)
        self._retirer.join()

    def drain(self):
        """Block until every admitted request has resolved."""
        futs = [s.future for s in self._slots if s.future is not None]
        for f in futs:
            try:
                f.result()
            except BaseException:   # incl. CancelledError (not an Exception)
                pass

    # ------------------------------------------------------------ worker

    def _apply_admissions(self):
        """Write admitted rows into the state (lock held, at tick start):
        each write makes a new tensor, so a tick still on the card and a
        retired row keep what they read."""
        rows = [(i, s.payload) for i, s in enumerate(self._slots)
                if s.payload is not None]
        if not rows:
            return
        idx = self._vec([i for i, _ in rows], np.int64)

        def put(state, key):
            return state.index_copy(0, idx, torch.cat([p[key] for _, p in rows]))
        self._lat = put(self._lat, "lat")
        self._cond = put(self._cond, "cond")
        self._embeds = put(self._embeds, "embeds")
        if self._mask is not None:
            self._mask = put(self._mask, "mask")
        self._pooled = put(self._pooled, "pooled")
        self._cond_pooled = put(self._cond_pooled, "cond_pooled")
        for i, _ in rows:
            if self.cache_k > 1 or self.cache_c > 1 or self._adaptive:
                self._i1[i] = self._i0[i] = -1
            if self._adaptive and self.adaptive_lag:
                self._seq_full[i] = self._seq_pred[i] = -1
            self._slots[i].payload = None

    @torch.no_grad()
    def _loop(self):
        cuda = self.device.type == "cuda"
        inflight = collections.deque()   # one CUDA event per recent tick
        while True:
            with self._work:
                self._sweep_cancelled()
                while not self._closed and all(s.free for s in self._slots):
                    self._work.wait()
                    self._sweep_cancelled()
                if self._closed and all(s.free for s in self._slots):
                    return
                self._apply_admissions()
                active = [(i, s) for i, s in enumerate(self._slots)
                          if not s.free]
                t_now = np.zeros((self.B,), np.float32)
                s_now = np.zeros((self.B,), np.float32)
                s_next = np.zeros((self.B,), np.float32)
                scale = np.zeros((self.B,), np.float32)
                gvec = np.zeros((self.B,), np.float32)
                for i, s in active:
                    t_now[i] = s.timesteps[s.step]
                    s_now[i] = s.sigmas[s.step]
                    s_next[i] = s.sigmas[s.step + 1]
                    scale[i] = s.sched[s.step]
                    gvec[i] = s.guidance
                cached = (self.cache_k > 1 or self.cache_c > 1
                          or self._adaptive)
                # exact-mode multi-tick window: full occupancy, never
                # crossing a retirement (queued waiters admit at the same
                # tick either way; only a mid-schedule cancel frees its slot
                # up to K-1 ticks later than single ticks would)
                multi_k = 1
                if (not cached and self.multi_tick > 1
                        and len(active) == self.B):
                    rem = min(s.num_steps - s.step for _, s in active)
                    multi_k = max(1, min(self.multi_tick, rem))
                    if multi_k > 1:
                        self._stats["ticks_fused"] += 1
                self._stats["ticks"] += multi_k
                self._stats["active_row_steps"] += len(active) * multi_k
                d_full = d_pred = None
                if self._adaptive:
                    if self.adaptive_lag:
                        # one-tick-stale vectors (never waits on the tick in
                        # flight; see _lagged_drift)
                        d_full, d_pred = self._lagged_drift(active)
                    else:
                        # read at once: waits for the previous tick
                        if self.thr_c > 0:
                            d_full = self._drift(self._lat, self._ref_full).cpu().numpy()
                        if self.thr_m > 0:
                            d_pred = self._drift(self._lat, self._ref_pred).cpu().numpy()
                if self.cache_c > 1 or self.thr_c > 0:
                    tick = self._prepare_hybrid_tick(active, s_now, s_next,
                                                     scale, gvec,
                                                     drift_full=d_full,
                                                     drift_pred=d_pred)
                elif self.cache_k > 1 or self.thr_m > 0:
                    tick = self._prepare_cached_tick(active, s_now, s_next,
                                                     scale, gvec, drift=d_pred)
                else:
                    self._stats["rows_refresh"] += len(active) * multi_k
                    self._stats["rows_pad"] += (self.B - len(active)) * multi_k
                    st = self._state()
                    if multi_k > 1:
                        # per-tick rows [K, B] from the slots' known schedules
                        mats = np.zeros((4, multi_k, self.B), np.float32)
                        for i, s in active:
                            for j in range(multi_k):
                                mats[:, j, i] = (s.timesteps[s.step + j],
                                                 s.sigmas[s.step + j],
                                                 s.sigmas[s.step + j + 1],
                                                 s.sched[s.step + j])
                        mats_j, g_j = self._vec(mats), self._vec(gvec)

                        def tick(st=st, mats_j=mats_j, g_j=g_j):
                            return self._multi_step(st, *mats_j, g_j), None
                    else:
                        vecs = self._vec(np.stack([t_now, s_now, s_next, scale,
                                                   gvec])).unbind(0)

                        def tick(st=st, vecs=vecs):
                            return self._exact_step(st, st["lat"], *vecs), None
            # ---- run the tick OUTSIDE the lock (submissions land between
            # ticks; they only touch slots that are free)
            t_tick = time.perf_counter()
            try:
                new_lat, commit = tick()
            except Exception as e:
                # free the slots and rebuild the state first, then fail the
                # futures outside the lock: a caller woken by the failure
                # finds its slot free, and a done-callback may submit
                with self._work:
                    failed = [s.future for _, s in active]
                    for i, _ in active:
                        self._slots[i] = _Slot()
                        self._stats["failed"] += 1
                    if self._adaptive and self.adaptive_lag:
                        # pending vectors describe the state before the
                        # failure; the next decisions force refreshes
                        self._pending_drift.clear()
                        self._seq_full[:] = self._seq_pred[:] = -1
                    if self._res is not None:
                        # a failed full forward may have written part of the
                        # residual rows: rebuild the buffers and force full
                        # refreshes on the next admissions
                        self._res = tree_map(torch.zeros_like, self._res)
                        self._i1[:] = self._i0[:] = -1
                    self._work.notify_all()   # wake blocking submits
                for fut in failed:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            # bounded run-ahead: at most two ticks queued on the card
            if cuda:
                event = torch.cuda.Event()
                event.record()
                inflight.append(event)
                if len(inflight) > 2:
                    inflight.popleft().synchronize()
            if log.isEnabledFor(logging.DEBUG):
                log.debug("tick%s %dact steps=%s %.0fms",
                          f" x{multi_k}" if multi_k > 1 else "", len(active),
                          [s.step for _, s in active],
                          (time.perf_counter() - t_tick) * 1000)
            with self._work:
                self._lat = new_lat
                if commit is not None:
                    commit()
                if self._adaptive and self.adaptive_lag:
                    # this tick's drift vectors against the post-commit
                    # references, read two ticks later
                    hf = (self._drift(self._lat, self._ref_full)
                          if self.thr_c > 0 else None)
                    hp = (self._drift(self._lat, self._ref_pred)
                          if self.thr_m > 0 else None)
                    vecs, event = self._to_host([hf, hp])
                    self._pending_drift.append((self._tick_seq, vecs, event))
                    self._tick_seq += 1
                for i, s in active:
                    s.step += multi_k
                    if s.step >= s.num_steps:
                        # the finished row: a view of this tick's new tensor,
                        # which no later write touches
                        self._retire_q.put((new_lat[i:i + 1], s.future,
                                            s.t_submit))
                        self._slots[i] = _Slot()
                        self._stats["retired"] += 1
                        self._work.notify_all()   # wake blocking submits

    @torch.no_grad()
    def _retire_loop(self):
        while True:
            item = self._retire_q.get()
            if item is None:
                return
            lat_row, fut, t_sub = item
            try:
                px = self._decode(lat_row)
                img = ((px.to(torch.float32).permute(0, 2, 3, 1) + 1.0)
                       * 127.5).round().to(torch.uint8).cpu()
                if not fut.done():
                    # recorded before the result lands, so stats() read by
                    # the woken caller already counts this request
                    now = time.perf_counter()
                    with self._lock:
                        self._lat_samples.append((now - t_sub) * 1000.0)
                        self._retire_times.append(now)
                    fut.set_result(img)
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)


class MultiResolutionStepServer:
    """Mixed-resolution step serving: one parameter tree, one StepServer
    bucket per output resolution.

    Each resolution needs its own slot state (latents, stream rows,
    prediction and residual caches); the expensive tenant is the weight
    tree, which every bucket shares (moved to the device once here; the
    buckets' ``.to`` is then a no-op). Bucket workers issue their ticks on
    the same stream, so the card interleaves them; each keeps its own
    two-tick run-ahead window.

    ``buckets`` maps a resolution, an int (square) or an ``(h, w)`` pair, to
    per-bucket ``StepServer`` overrides (``batch_size`` usually: fewer slots
    at high resolutions). Other keyword arguments are shared server
    defaults. ``submit`` routes by ``resolution=``, or by ``control_pixels``'
    trailing [..., H, W] shape (every calling path resizes the control image
    to the output resolution)."""

    def __init__(self, cfg: UniGenConfig, params, vae_cfg=None,
                 vae_params=None, *, buckets, mesh=None, device=None, **common):
        _require(bool(buckets), "need at least one resolution bucket")
        if mesh is not None:
            raise NotImplementedError(
                "MultiResolutionStepServer(mesh=...) waits for the port of "
                "unigen_tpu/parallel (ROADMAP Queue 1 item 8)")
        dev = resolve_device(device)
        params = tree_map(lambda t: t.to(dev), params)
        if vae_params is not None:
            vae_params = tree_map(lambda t: t.to(dev), vae_params)
        self.servers: Dict[tuple, StepServer] = {}
        for key in sorted(buckets, key=self._norm):
            h, w = self._norm(key)
            kw = dict(common)
            kw.update(buckets[key] or {})
            self.servers[(h, w)] = StepServer(
                cfg, params, vae_cfg, vae_params, height=h, width=w,
                device=dev, **kw)

    @staticmethod
    def _norm(key) -> tuple:
        return (key, key) if isinstance(key, int) else tuple(key)

    def _bucket(self, resolution, control_pixels) -> StepServer:
        if resolution is None:
            shape = getattr(control_pixels, "shape", None)
            _require(shape is not None and len(shape) >= 2,
                     "cannot infer the resolution bucket without control_pixels")
            resolution = (int(shape[-2]), int(shape[-1]))
        key = self._norm(resolution)
        if key not in self.servers:
            raise KeyError(
                f"no bucket for resolution {key}; serving "
                f"{sorted(self.servers)} — resize the control image to a "
                f"served resolution or add the bucket")
        return self.servers[key]

    def submit(self, *, resolution=None, **request) -> Future:
        """Admit one request into the bucket for ``resolution`` (int or (h,
        w); from ``control_pixels`` when omitted). Other keywords are
        ``StepServer.submit``'s."""
        srv = self._bucket(resolution, request.get("control_pixels"))
        return srv.submit(**request)

    def warmup(self, t_len: int, rounds: int = 2) -> int:
        """Every bucket's StepServer.warmup, one after the other. Returns the
        total number of warm-up requests."""
        return sum(srv.warmup(t_len, rounds=rounds)
                   for srv in self.servers.values())

    def stats(self) -> dict:
        """Per-bucket snapshots keyed '<h>x<w>' and a 'total' row summing the
        count fields; rates and distributions (mean_occupancy, latency_ms,
        throughput_img_s) stay per bucket."""
        out: Dict[str, Any] = {}
        total: Dict[str, float] = {}
        for (h, w), srv in self.servers.items():
            s = srv.stats()
            out[f"{h}x{w}"] = s
            for k, v in s.items():
                if (k not in ("mean_occupancy", "throughput_img_s")
                        and isinstance(v, (int, float))):
                    total[k] = total.get(k, 0) + v
        out["total"] = total
        return out

    def drain(self):
        for srv in self.servers.values():
            srv.drain()

    def close(self):
        for srv in self.servers.values():
            srv.close()
