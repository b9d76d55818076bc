"""UniGenSanaPipeline: controllable generation on the SANA family (port of
``unigen_tpu/pipelines/sana.py``). Encode the control image with the
latent codec, run the flow-matching Euler loop through
``sana_unigen_forward``, decode.

Text encoding is split as in JAX: the prompt sequence and its padding
mask come from Gemma-2 (SANA's encoder), the pooled prompt and condition
embeddings from CLIP-L (SANA's pooled_projection_dim of 768). The
autoencoder is pluggable: ``ae_encode`` / ``ae_decode`` callables and
``ae_downscale`` (the DC-AE f32c32 by default; any latent codec with the
right channel count drives the pipeline).

Where JAX compiles one program per call shape, the port runs the loop
eagerly under the cache modes of ``pipelines/caching.py`` with the sana
profile table: the control-residual cache (fixed or adaptive, bf16 / int8
/ int4 residuals), the full-model output cache of order 0 or 1, the fixed
and the fully adaptive hybrid. SANA denoises without guidance. The
forward takes the scheduler's timesteps / 1000, as the JAX pipeline
passes them. Every transformer call goes through ``sana_unigen_forward``
and so through the port's kernels on the card wherever the tree is
quantized.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models.clip_text import CLIPTextConfig, clip_encode
from unigen_tpu_torch.models.gemma_text import GemmaConfig, gemma_encode
from unigen_tpu_torch.models.sana import sana_unigen_forward
from unigen_tpu_torch.models.text_encoder import tokenize
from unigen_tpu_torch.models.unigen_sd3 import conditioning_schedule
from unigen_tpu_torch.pipelines import caching, scheduling
from unigen_tpu_torch.pipelines.caching import CacheMode, resolve_cache_mode
from unigen_tpu_torch.utils import resolve_device, tree_map


@dataclass
class UniGenSanaPipeline:
    """Configs and parameter trees on one device (CUDA unless ``device``
    names the CPU). ``ae_encode`` maps pixels [B, 3, H, W] to latents
    [B, C, H/f, W/f] and ``ae_decode`` back; both run on the pipeline's
    device (``load_sana_pipeline`` binds them to a DC-AE tree). The text
    towers and tokenizers are optional when the caller passes embeddings."""
    cfg: UniGenConfig
    params: dict                                # base, control
    ae_encode: Callable
    ae_decode: Callable
    ae_downscale: int = 32                      # DC-AE f32c32
    gemma_cfg: Optional[GemmaConfig] = None
    gemma_params: Optional[dict] = None
    clip_cfg: Optional[CLIPTextConfig] = None
    clip_params: Optional[dict] = None
    tokenizer: Any = None                       # Gemma tokenizer
    tokenizer_clip: Any = None
    scheduler: scheduling.FlowMatchConfig = field(
        default_factory=lambda: scheduling.FlowMatchConfig(
            shift=3.0, use_dynamic_shifting=False))   # SANA's flow shift
    dtype: torch.dtype = torch.float32
    prompt_cache_size: int = 0                  # > 0: LRU of prompt encodings
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for name in ("params", "gemma_params", "clip_params"):
            tree = getattr(self, name)
            if tree is not None:
                setattr(self, name, tree_map(lambda t: t.to(self.device), tree))
        self._prompt_cache = caching.PromptLRU(self.prompt_cache_size)
        self.last_cache_refreshes = None

    # ------------------------------------------------------------ text

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      max_sequence_length: int = 300):
        """-> (Gemma-2 last hidden states [B, T, caption_channels] in the
        pipeline's dtype, the tokenizer's padding mask [B, T] int32), through
        the prompt LRU."""
        if self.tokenizer is None or self.gemma_params is None:
            raise ValueError("Gemma not loaded; pass prompt_embeds and prompt_mask "
                             "directly")
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)

        def compute():
            ids = self.tokenizer(prompts, padding="max_length",
                                 max_length=max_sequence_length, truncation=True,
                                 return_tensors="np")
            mask = torch.as_tensor(np.asarray(ids.attention_mask, np.int32),
                                   device=self.device)
            embeds = gemma_encode(self.gemma_params, self.gemma_cfg,
                                  np.asarray(ids.input_ids), mask)
            return embeds.to(self.dtype), mask

        return self._prompt_cache.get_or(
            ("prompt", tuple(prompts), max_sequence_length), compute)

    @torch.no_grad()
    def encode_pooled(self, text: Union[str, Sequence[str]]) -> torch.Tensor:
        """CLIP-L's pooled embedding of a prompt or a condition task name, in
        the pipeline's dtype, through the prompt LRU."""
        if self.tokenizer_clip is None or self.clip_params is None:
            raise ValueError("CLIP not loaded; pass pooled / cond_pooled directly")
        prompts = [text] if isinstance(text, str) else list(text)

        def compute():
            clip_len = min(77, self.clip_cfg.max_position_embeddings)
            ids = tokenize(self.tokenizer_clip, prompts, clip_len)
            return clip_encode(self.clip_params, self.clip_cfg, ids)[2].to(self.dtype)

        return self._prompt_cache.get_or(("pooled", tuple(prompts)), compute)

    # ------------------------------------------------------------ core

    def encode_control(self, control_pixels: torch.Tensor) -> torch.Tensor:
        """Control pixels [B, 3, H, W] in [-1, 1], cast to the pipeline's
        dtype (as the JAX program casts them), -> control latents in the
        pipeline's dtype."""
        px = torch.as_tensor(control_pixels).to(self.device, self.dtype)
        return self.ae_encode(px).to(self.dtype)

    def denoise(self, mode: CacheMode, latents, fwd, sigmas, num_steps: int):
        """The Euler loop under ``mode``; ``fwd(lat, i, **cache)`` is one
        SANA forward -> (pred, add_outputs). Sets ``last_cache_refreshes``."""
        def capture(lat, i):
            pred, outs = fwd(lat, i, return_control_residuals=True,
                             control_residuals_bits=mode.bits)
            return pred, outs["control_residuals"]

        if mode.exact:
            for i in range(num_steps):
                latents = scheduling.euler_step(latents, fwd(latents, i)[0],
                                                sigmas[i], sigmas[i + 1])
            self.last_cache_refreshes = None
            return latents
        if mode.model_cache:
            latents, n = caching.model_cache_scan(
                lambda lat, i: fwd(lat, i)[0], latents, sigmas, num_steps,
                cache_interval=mode.interval, adaptive=mode.adaptive,
                threshold=mode.threshold, order=mode.order)
            self.last_cache_refreshes = n
            return latents
        if mode.hybrid:
            latents, n_full, n_base = caching.hybrid_cache_scan(
                capture, lambda lat, i, res: fwd(lat, i, control_residuals=res)[0],
                latents, sigmas, num_steps, control_interval=mode.interval,
                model_interval=mode.hybrid_interval, order=mode.order,
                adaptive=mode.hybrid_adaptive, control_threshold=mode.control_threshold,
                model_threshold=mode.model_threshold)
            self.last_cache_refreshes = (n_full, n_base)
            return latents

        # the control-residual cache: the control branch runs on refresh
        # steps, the cached raw control outputs are replayed in between
        res, lat_ref, n_ref = None, latents, 0
        for i in range(num_steps):
            refresh = (caching.refresh_decision(i, latents, lat_ref, mode.threshold)
                       if mode.adaptive else i % mode.interval == 0)
            if refresh:
                pred, res = capture(latents, i)
                lat_ref, n_ref = latents, n_ref + 1
            else:
                pred = fwd(latents, i, control_residuals=res)[0]
            latents = scheduling.euler_step(latents, pred, sigmas[i], sigmas[i + 1])
        self.last_cache_refreshes = n_ref
        return latents

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents -> uint8 images [B, H, W, 3] on the host: decoded from fp32
        latents, clipped to [-1, 1], scaled to 0..255 and rounded."""
        pixels = self.ae_decode(latents.to(torch.float32))
        imgs = pixels.to(torch.float32).clamp(-1.0, 1.0).permute(0, 2, 3, 1)
        return ((imgs + 1.0) * 127.5).round().to(torch.uint8).cpu()

    @torch.no_grad()
    def generate(self, *, prompt_embeds, prompt_mask, pooled, cond_pooled,
                 control_pixels, height: int = 512, width: int = 512,
                 num_inference_steps: int = 20, conditioning_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0, seed: int = 0, latents=None,
                 control_cache_interval: int = 1,
                 control_cache_threshold: float = 0.0,
                 model_cache_interval: int = 1,
                 model_cache_threshold: float = 0.0,
                 model_cache_order: int = 0,
                 residual_cache_bits: int = 16,
                 quality_profile: Optional[str] = None) -> torch.Tensor:
        """Generation from embeddings; returns uint8 images [B, H, W, 3] as a
        CPU tensor. ``prompt_mask`` [B, T] is the Gemma padding mask;
        ``control_pixels`` [B, 3, H, W] in [-1, 1] are cast to the
        pipeline's dtype before the codec (as in JAX); ``latents``
        [B, C, H/f, W/f] are used as given, else drawn from a
        ``torch.Generator`` seeded with ``seed`` on the pipeline's device (a
        draw that cannot equal the JAX pipeline's PRNG). The conditioning
        scale is 0 on steps outside [control_guidance_start,
        control_guidance_end].

        The cache knobs are the JAX pipeline's with its refusals
        (``resolve_cache_mode``, sana profiles: "balanced" the hybrid
        (c=4, m=2), "fast" the order-1 model cache at interval 4 from 8
        steps up). The step counts taken land in ``last_cache_refreshes``:
        an int, (n_full, n_base) for the hybrid, None for the exact loop."""
        mode = resolve_cache_mode(
            num_inference_steps, control_cache_interval=control_cache_interval,
            control_cache_threshold=control_cache_threshold,
            model_cache_interval=model_cache_interval,
            model_cache_threshold=model_cache_threshold,
            model_cache_order=model_cache_order,
            residual_cache_bits=residual_cache_bits, quality_profile=quality_profile,
            family="sana")
        dev, dt, bb = self.device, self.dtype, self.cfg.sana
        steps = num_inference_steps
        schedule = conditioning_schedule(steps, conditioning_scale,
                                         control_guidance_start, control_guidance_end)
        lh, lw = height // self.ae_downscale, width // self.ae_downscale
        # the raw latent area (before patchify) is the schedule's sequence
        # length, as in JAX
        sigmas, timesteps = scheduling.inference_sigmas(self.scheduler, steps,
                                                        image_seq_len=lh * lw)
        prompt_embeds, pooled, cond_pooled = (torch.as_tensor(x).to(dev, dt) for x in
                                              (prompt_embeds, pooled, cond_pooled))
        prompt_mask = torch.as_tensor(prompt_mask).to(dev)
        b = prompt_embeds.shape[0]
        if latents is None:
            latents = torch.randn((b, bb.in_channels, lh, lw),
                                  generator=torch.Generator(device=dev).manual_seed(seed),
                                  device=dev, dtype=dt)
        else:
            latents = torch.as_tensor(latents).to(dev, dt)
        control_lat = self.encode_control(control_pixels)

        def fwd(lat, i, **cache):
            t = torch.full((b,), float(timesteps[i] / 1000.0), dtype=dt, device=dev)
            pred, _, outs = sana_unigen_forward(
                self.params, self.cfg, lat, control_lat, prompt_embeds, pooled,
                cond_pooled, t, prompt_mask, conditioning_scale=float(schedule[i]),
                **cache)
            return pred, outs

        latents = self.denoise(mode, latents, fwd, sigmas, steps)
        return self.decode(latents)

    # ------------------------------------------------------------ public API

    def __call__(self, prompt: Union[str, Sequence[str]], condition_prompt: str,
                 control_image, max_sequence_length: int = 300, **kw) -> torch.Tensor:
        """Generation from prompt strings: Gemma for the sequence and its
        mask, CLIP-L for the pooled prompt and condition embeddings (one
        condition prompt serves every prompt of the batch); ``kw`` are
        ``generate``'s other arguments."""
        embeds, mask = self.encode_prompt(prompt, max_sequence_length)
        cond_pooled = self.encode_pooled(condition_prompt)
        if cond_pooled.shape[0] == 1:          # one condition for the whole batch
            cond_pooled = cond_pooled.expand(embeds.shape[0], -1)
        return self.generate(
            prompt_embeds=embeds, prompt_mask=mask, pooled=self.encode_pooled(prompt),
            cond_pooled=cond_pooled, control_pixels=control_image, **kw)
