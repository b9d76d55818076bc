"""UniGenFluxPipeline: controllable text-to-image inference (port of
``unigen_tpu/pipelines/flux.py``). VAE-encode the control image(s), pack
latents and ids, run the flow-matching Euler loop (an optional true-CFG
second stream per step) under one of the serving caches, unpack and
VAE-decode to uint8 images. Prompt encoding (CLIP pooled + T5 sequence)
is a separate call whose results an optional LRU keeps.

Where JAX compiles one program per call shape, the port runs the loop
eagerly; the caches of ``pipelines/caching.py`` pick, step by step, a full
forward (capturing the control residuals where a cache needs them), a
base forward replaying them, or a replay of the last prediction. Every
FLUX forward goes through ``unigen_flux_forward`` and so through the
port's kernels on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models import vae as vae_lib
from unigen_tpu_torch.models.clip_text import CLIPTextConfig, clip_encode
from unigen_tpu_torch.models.t5_text import T5Config, t5_encode
from unigen_tpu_torch.models.text_encoder import tokenize
from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
from unigen_tpu_torch.ops.packing import (pack_latents, prepare_latent_image_ids,
                                          unpack_latents)
from unigen_tpu_torch.pipelines import caching, scheduling
from unigen_tpu_torch.pipelines.caching import CacheMode, resolve_cache_mode
from unigen_tpu_torch.utils import resolve_device, tree_map


@dataclass
class UniGenFluxPipeline:
    """Configs and parameter trees on one device (CUDA unless ``device``
    names the CPU); the text towers and tokenizers are optional when the
    caller passes embeddings."""
    cfg: UniGenConfig
    params: dict                                # base, control
    vae_cfg: vae_lib.VAEConfig = field(default_factory=vae_lib.VAEConfig)
    vae_params: Optional[dict] = None
    clip_cfg: Optional[CLIPTextConfig] = None
    clip_params: Optional[dict] = None
    t5_cfg: Optional[T5Config] = None
    t5_params: Optional[dict] = None
    scheduler: scheduling.FlowMatchConfig = field(
        default_factory=lambda: scheduling.FlowMatchConfig(
            shift=1.0, use_dynamic_shifting=False))
    tokenizer: Any = None                       # CLIP tokenizer
    tokenizer_2: Any = None                     # T5 tokenizer
    dtype: torch.dtype = torch.bfloat16
    prompt_cache_size: int = 0                  # > 0: LRU of prompt encodings
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for name in ("params", "vae_params", "clip_params", "t5_params"):
            tree = getattr(self, name)
            if tree is not None:
                setattr(self, name, tree_map(lambda t: t.to(self.device), tree))
        self._prompt_cache = caching.PromptLRU(self.prompt_cache_size)
        self.last_cache_refreshes = None
        self._lora = None               # models/lora.LoraSwitcher when loaded

    # ------------------------------------------------------------ LoRA experts

    def load_lora(self, adapters_or_dir, adapter_names=None) -> None:
        """Attach per-condition LoRA experts (the reference's
        lora_switching_module and load_model_hook): a directory in the
        reference's per-adapter layout ({dir}/{name}/pytorch_lora_weights.
        safetensors) or an adapters dict of models/lora. Works on fp and
        quantized serving trees (dequant, add, requant)."""
        from unigen_tpu_torch.models.lora import LoraSwitcher
        if isinstance(adapters_or_dir, str):
            from unigen_tpu_torch.io import torch_bridge as tb
            adapters = tb.load_lora_adapters(adapters_or_dir, self.params, adapter_names,
                                             dtype=torch.float32, device=self.device)
        else:
            adapters = adapters_or_dir
        self._lora = LoraSwitcher(adapters, self.params)

    def set_condition_adapter(self, names, scale: float = 1.0) -> None:
        """Fold exactly ``names`` (a name, a list, or None to disable all)
        into the live weights, the reference's run-time PEFT scaling flips
        made a refold; shapes and dtypes never change."""
        if self._lora is None:
            raise ValueError("call load_lora() first")
        self.params = self._lora.switch(self.params, names, scale)

    def shard(self, mesh) -> None:
        raise NotImplementedError("multi-card serving waits for the port of "
                                  "unigen_tpu/parallel (the parallel slice)")

    def _auto_switch(self, condition_prompt) -> None:
        """Per-call expert selection by condition type: one condition type
        with an adapter of its name selects it; unknown types and mixed
        batches leave the current fold as it is."""
        if self._lora is None:
            return
        names = ([condition_prompt] if isinstance(condition_prompt, str)
                 else list(dict.fromkeys(condition_prompt)))
        if len(names) == 1 and names[0] in self._lora.adapters:
            self.set_condition_adapter(names[0])

    # ------------------------------------------------------------ text

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      max_sequence_length: int = 512):
        """-> (t5_embeds [B, T, d_model], clip_pooled [B, D]) in the
        pipeline's dtype, through the prompt LRU."""
        if self.tokenizer is None or self.clip_params is None:
            raise ValueError("text encoders not loaded; pass prompt_embeds directly")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)

        def compute():
            clip_len = min(77, self.clip_cfg.max_position_embeddings)
            pooled = clip_encode(self.clip_params, self.clip_cfg,
                                 tokenize(self.tokenizer, prompts, clip_len))[2]
            embeds = t5_encode(self.t5_params, self.t5_cfg,
                               tokenize(self.tokenizer_2, prompts, max_sequence_length))
            return embeds.to(self.dtype), pooled.to(self.dtype)

        return self._prompt_cache.get_or(
            ("prompt", tuple(prompts), max_sequence_length), compute)

    @torch.no_grad()
    def encode_condition_prompt(self, condition_prompt: Union[str, Sequence[str]]):
        """CLIP's pooled embedding of the condition task name(s), through the
        prompt LRU."""
        if self.tokenizer is None or self.clip_params is None:
            raise ValueError("text encoders not loaded; pass cond_pooled directly")
        prompts = ([condition_prompt] if isinstance(condition_prompt, str)
                   else list(condition_prompt))

        def compute():
            clip_len = min(77, self.clip_cfg.max_position_embeddings)
            return clip_encode(self.clip_params, self.clip_cfg,
                               tokenize(self.tokenizer, prompts, clip_len))[2].to(self.dtype)

        return self._prompt_cache.get_or(("cond", tuple(prompts)), compute)

    # ------------------------------------------------------------ core

    def encode_control(self, control_pixels: torch.Tensor, offsets, lh: int, lw: int):
        """Control pixels [B, 3, H, W] (or [K, B, 3, H, W]) -> packed control
        latents in the pipeline's dtype and their ids, shifted by the
        per-condition width offsets."""
        def one(px, off):
            lat = pack_latents(vae_lib.vae_encode(self.vae_params, self.vae_cfg, px))
            return lat, prepare_latent_image_ids(lh // 2, lw // 2, off, device=self.device)
        if control_pixels.dim() == 5:
            lats, ids = zip(*(one(px, off) for px, off in zip(control_pixels, offsets)))
            lat, ids = torch.stack(lats), torch.stack(ids)
        else:
            lat, ids = one(control_pixels, offsets)
        return lat.to(self.dtype), ids

    def denoise(self, mode: CacheMode, latents, fwd, streams, sigmas, num_steps: int,
                true_cfg_scale: float):
        """The Euler loop under ``mode``. ``fwd(lat, i, embeds, pooled,
        **cache)`` is one FLUX forward -> (pred, add_outputs); ``streams``
        holds (embeds, pooled) of the prompt and, under true CFG, of the
        negative prompt. Sets ``last_cache_refreshes``."""
        do_cfg = len(streams) == 2

        def combine(preds):
            if do_cfg:
                return preds[1] + true_cfg_scale * (preds[0] - preds[1])
            return preds[0]

        def full_pred(lat, i):
            return combine([fwd(lat, i, *s)[0] for s in streams])

        def capture(lat, i, stream):
            pred, outs = fwd(lat, i, *stream, return_control_residuals=True,
                             control_residuals_bits=mode.bits)
            return pred, outs["control_residuals"]

        if mode.exact:
            for i in range(num_steps):
                latents = scheduling.euler_step(latents, full_pred(latents, i),
                                                sigmas[i], sigmas[i + 1])
            self.last_cache_refreshes = None
            return latents
        if mode.model_cache:
            latents, n = caching.model_cache_scan(
                full_pred, latents, sigmas, num_steps, cache_interval=mode.interval,
                adaptive=mode.adaptive, threshold=mode.threshold, order=mode.order)
            self.last_cache_refreshes = n
            return latents
        if mode.hybrid:
            def full_fwd(lat, i):
                preds, res = zip(*(capture(lat, i, s) for s in streams))
                return combine(preds), res

            def base_fwd(lat, i, res):
                return combine([fwd(lat, i, *s, control_residuals=r)[0]
                                for s, r in zip(streams, res)])

            latents, n_full, n_base = caching.hybrid_cache_scan(
                full_fwd, base_fwd, latents, sigmas, num_steps,
                control_interval=mode.interval, model_interval=mode.hybrid_interval,
                order=mode.order, adaptive=mode.hybrid_adaptive,
                control_threshold=mode.control_threshold,
                model_threshold=mode.model_threshold)
            self.last_cache_refreshes = (n_full, n_base)
            return latents

        # the control-residual cache: the control branch runs on refresh
        # steps, its cached per-block adds are replayed in between (times the
        # step's conditioning scale); with cfg_cache a replay step runs only
        # the positive stream and reuses the cached guidance delta
        use_cfg_cache = mode.cfg_cache and do_cfg
        caches, delta, lat_ref, n_ref = [None] * len(streams), None, latents, 0
        for i in range(num_steps):
            refresh = (caching.refresh_decision(i, latents, lat_ref, mode.threshold)
                       if mode.adaptive else i % mode.interval == 0)
            if refresh:
                preds, caches = zip(*(capture(latents, i, s) for s in streams))
                if use_cfg_cache:
                    delta = preds[0] - preds[1]
                    pred = preds[1] + true_cfg_scale * delta
                else:
                    pred = combine(preds)
                lat_ref, n_ref = latents, n_ref + 1
            elif use_cfg_cache:
                pos = fwd(latents, i, *streams[0], control_residuals=caches[0])[0]
                pred = pos + (true_cfg_scale - 1.0) * delta
            else:
                pred = combine([fwd(latents, i, *s, control_residuals=r)[0]
                                for s, r in zip(streams, caches)])
            latents = scheduling.euler_step(latents, pred, sigmas[i], sigmas[i + 1])
        self.last_cache_refreshes = n_ref
        return latents

    def decode(self, latents: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
        """Packed latents -> uint8 images [B, H, W, 3] on the host: decoded
        in fp32, clipped to [-1, 1], scaled to 0..255 and rounded."""
        pixels = vae_lib.vae_decode(self.vae_params, self.vae_cfg,
                                    unpack_latents(latents.to(torch.float32), lh, lw))
        imgs = pixels.to(torch.float32).clamp(-1.0, 1.0).permute(0, 2, 3, 1)
        return ((imgs + 1.0) * 127.5).round().to(torch.uint8).cpu()

    @torch.no_grad()
    def generate(self, *, prompt_embeds, pooled, cond_pooled, control_pixels,
                 height: int = 512, width: int = 512, num_inference_steps: int = 4,
                 guidance_scale: float = 3.5, true_cfg_scale: float = 1.0,
                 neg_embeds=None, neg_pooled=None, conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0,
                 subject_offset: Union[bool, Sequence[bool]] = False,
                 seed: int = 0, latents=None,
                 control_cache_interval: int = 1,
                 control_cache_threshold: float = 0.0,
                 cfg_cache: bool = False,
                 model_cache_interval: int = 1,
                 model_cache_threshold: float = 0.0,
                 model_cache_order: int = 0,
                 residual_cache_bits: int = 16,
                 quality_profile: Optional[str] = None) -> torch.Tensor:
        """Single- or multi-condition generation from embeddings; returns
        uint8 images [B, H, W, 3] as a CPU tensor.

        ``control_pixels`` [B, 3, H, W] (or [K, B, 3, H, W] for K joint
        conditions, with ``cond_pooled`` [K, B, D]) in [-1, 1].
        ``latents`` [B, S, C] are used as given; without them they are drawn
        from a ``torch.Generator`` seeded with ``seed`` on the pipeline's
        device, a draw that cannot equal the JAX pipeline's PRNG.
        The conditioning scale is 0 on steps outside
        [control_guidance_start, control_guidance_end] of the schedule;
        ``subject_offset`` shifts a condition's width ids by the latent width
        / 2.

        The cache knobs are the JAX pipeline's (``resolve_cache_mode`` holds
        its rules): ``control_cache_interval`` > 1 or
        ``control_cache_threshold`` > 0, the control-residual cache (fixed or
        adaptive refresh), with ``cfg_cache`` under true CFG;
        ``model_cache_interval`` > 1 or ``model_cache_threshold`` > 0, the
        full-model output cache, ``model_cache_order`` 0 or 1; both intervals,
        or both thresholds, the three-level hybrid; ``residual_cache_bits``
        16, 8 or 4 for the control-residual cache; ``quality_profile``
        "exact", "balanced" or "fast" in place of the knobs ("fast" under
        its ``min_steps`` degrades to "balanced" with a warning). The step
        counts taken land in ``last_cache_refreshes``: an int, (n_full,
        n_base) for the hybrid, None for the exact loop."""
        mode = resolve_cache_mode(
            num_inference_steps, control_cache_interval=control_cache_interval,
            control_cache_threshold=control_cache_threshold, cfg_cache=cfg_cache,
            model_cache_interval=model_cache_interval,
            model_cache_threshold=model_cache_threshold,
            model_cache_order=model_cache_order,
            residual_cache_bits=residual_cache_bits, quality_profile=quality_profile)
        dev, dt, bb = self.device, self.dtype, self.cfg.flux
        steps = num_inference_steps
        schedule = conditioning_scale * np.array([
            1.0 - float((i / steps < control_guidance_start)
                        or ((i + 1) / steps > control_guidance_end))
            for i in range(steps)], np.float32)
        vs = self.vae_cfg.downscale
        lh, lw = 2 * (height // (vs * 2)), 2 * (width // (vs * 2))
        sigmas, timesteps = scheduling.inference_sigmas(
            self.scheduler, steps, image_seq_len=(lh // 2) * (lw // 2))

        prompt_embeds, pooled, cond_pooled = (torch.as_tensor(x).to(dev, dt) for x in
                                              (prompt_embeds, pooled, cond_pooled))
        control_pixels = torch.as_tensor(control_pixels).to(dev)
        b = prompt_embeds.shape[0]
        if latents is None:
            latents = torch.randn((b, (lh // 2) * (lw // 2), bb.in_channels),
                                  generator=torch.Generator(device=dev).manual_seed(seed),
                                  device=dev, dtype=dt)
        else:
            latents = torch.as_tensor(latents).to(dev, dt)
        streams = [(prompt_embeds, pooled)]
        if true_cfg_scale > 1.0:
            if neg_embeds is None:
                neg_embeds, neg_pooled = (torch.zeros_like(prompt_embeds),
                                          torch.zeros_like(pooled))
            streams.append(tuple(torch.as_tensor(x).to(dev, dt)
                                 for x in (neg_embeds, neg_pooled)))
        # the subject condition's id offset is half the LATENT width; each of
        # K joint conditions keeps its own flag
        if control_pixels.dim() == 5:
            k = control_pixels.shape[0]
            flags = (list(subject_offset) if not isinstance(subject_offset, bool)
                     else [subject_offset] * k)
            if len(flags) != k:
                raise ValueError(f"subject_offset: expected {k} per-condition "
                                 f"flags, got {flags}")
            offsets = [lw / 2.0 if f else 0.0 for f in flags]
        else:
            flag = (any(subject_offset) if not isinstance(subject_offset, bool)
                    else subject_offset)
            offsets = lw / 2.0 if flag else 0.0

        control_lat, cond_ids = self.encode_control(control_pixels, offsets, lh, lw)
        img_ids = prepare_latent_image_ids(lh // 2, lw // 2, device=dev)
        txt_ids = torch.zeros(prompt_embeds.shape[1], 3, device=dev)
        guidance = (torch.full((b,), guidance_scale, dtype=dt, device=dev)
                    if bb.guidance_embeds else None)

        def fwd(lat, i, embeds, pool, **cache):
            t = torch.full((b,), float(timesteps[i] / 1000.0), dtype=dt, device=dev)
            pred, _, outs = unigen_flux_forward(
                self.params, self.cfg, lat, control_lat, embeds, pool, cond_pooled,
                t, img_ids, txt_ids, cond_ids, guidance,
                conditioning_scale=float(schedule[i]), **cache)
            return pred, outs

        latents = self.denoise(mode, latents, fwd, streams, sigmas, steps,
                               true_cfg_scale)
        return self.decode(latents, lh, lw)

    # ------------------------------------------------------------ public API

    def __call__(self, prompt: Union[str, Sequence[str]],
                 condition_prompt: Union[str, Sequence[str]], control_image,
                 negative_prompt: Optional[Union[str, Sequence[str]]] = None,
                 max_sequence_length: int = 512, **kw) -> torch.Tensor:
        """Single-condition call from prompt strings; ``control_image``
        [B, 3, H, W] in [-1, 1] is cast to the pipeline's dtype; ``kw`` are
        ``generate``'s other arguments. A "subject" condition prompt turns
        on the subject id offset."""
        self._auto_switch(condition_prompt)
        embeds, pooled = self.encode_prompt(prompt, max_sequence_length)
        cond_pooled = self.encode_condition_prompt(condition_prompt)
        neg_embeds = neg_pooled = None
        if negative_prompt is not None and kw.get("true_cfg_scale", 1.0) > 1.0:
            neg_embeds, neg_pooled = self.encode_prompt(negative_prompt,
                                                        max_sequence_length)
        subject = ("subject" == condition_prompt if isinstance(condition_prompt, str)
                   else any(cp == "subject" for cp in condition_prompt))
        return self.generate(
            prompt_embeds=embeds, pooled=pooled, cond_pooled=cond_pooled,
            control_pixels=torch.as_tensor(control_image).to(self.device, self.dtype),
            neg_embeds=neg_embeds, neg_pooled=neg_pooled, subject_offset=subject,
            **kw)

    def multi_condition_call(self, prompt: Union[str, Sequence[str]],
                             condition_prompts: Sequence[str],
                             control_images: Sequence, max_sequence_length: int = 512,
                             **kw) -> torch.Tensor:
        """Joint control by several conditions: one pooled embedding and one
        control image per condition, stacked on a leading axis; ``kw`` are
        ``generate``'s other arguments (subject offsets per condition by
        default). With LoRA experts loaded, every present condition's adapter
        is folded in at once (the reference's enable_lora takes a list)."""
        if self._lora is not None:
            present = [cp for cp in dict.fromkeys(condition_prompts)
                       if cp in self._lora.adapters]
            if present:
                self.set_condition_adapter(present)
        embeds, pooled = self.encode_prompt(prompt, max_sequence_length)
        cond_pooled = torch.stack([self.encode_condition_prompt(cp)
                                   for cp in condition_prompts])
        control = torch.stack([torch.as_tensor(ci).to(self.device, self.dtype)
                               for ci in control_images])
        kw.setdefault("subject_offset", [cp == "subject" for cp in condition_prompts])
        return self.generate(prompt_embeds=embeds, pooled=pooled,
                             cond_pooled=cond_pooled, control_pixels=control, **kw)
