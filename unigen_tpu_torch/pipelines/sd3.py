"""UniGenSD3Pipeline: SD3.5 controllable inference (port of
``unigen_tpu/pipelines/sd3.py``). Classifier-free guidance by [negative;
positive] duplication on the batch axis, the SD3 flow-matching schedule
(shift 3), the conditioning-scale keep-window (``control_guidance_start``
/ ``_end``), unpacked [B, C, H, W] latents, and prompts through the
CLIP-L + CLIP-G (+ T5-XXL) stack with the condition task name's pooled
embedding from both CLIPs.

Where JAX compiles one program per call shape, the port runs the loop
eagerly, as ``pipelines/flux.py`` does, under the same cache modes
(``pipelines.caching.resolve_cache_mode`` with the sd3 profile table): the
control-residual cache (fixed or adaptive, bf16 / int8 / int4 residuals),
with ``cfg_cache`` the positive stream alone on replay steps reusing the
cached guidance delta; the full-model output cache of order 0 or 1; the
fixed and the fully adaptive hybrid. Every transformer call goes through
``unigen_sd3_forward`` and so through the port's kernels on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models import vae as vae_lib
from unigen_tpu_torch.models.text_encoder import encode_pooled_only, sd3_encode_prompt
from unigen_tpu_torch.models.unigen_sd3 import conditioning_schedule, unigen_sd3_forward
from unigen_tpu_torch.pipelines import caching, scheduling
from unigen_tpu_torch.pipelines.caching import CacheMode, resolve_cache_mode
from unigen_tpu_torch.utils import resolve_device, tree_map


def _batch_slice(res, start: int):
    """Rows ``start:`` of a stacked residual cache [n_blocks, B, S, D] (or of
    each leaf of a quantized one)."""
    if isinstance(res, dict):
        return {k: v[:, start:] for k, v in res.items()}
    return res[:, start:]


@dataclass
class UniGenSD3Pipeline:
    """Configs and parameter trees on one device (CUDA unless ``device``
    names the CPU). ``text_encoders`` is optional when the caller passes
    embeddings: {"clip_l": (params, cfg, tokenizer), "clip_g": (params,
    cfg, tokenizer), "t5": (params, cfg, tokenizer) or None}."""
    cfg: UniGenConfig
    params: dict                                # base, control
    vae_cfg: vae_lib.VAEConfig = field(default_factory=lambda: vae_lib.VAEConfig(
        scaling_factor=1.5305, shift_factor=0.0609))
    vae_params: Optional[dict] = None
    scheduler: scheduling.FlowMatchConfig = field(
        default_factory=lambda: scheduling.FlowMatchConfig(shift=3.0))
    text_encoders: Any = None
    dtype: torch.dtype = torch.float32
    prompt_cache_size: int = 0                  # > 0: LRU of prompt encodings
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

        def to_dev(tree):
            return None if tree is None else tree_map(lambda t: t.to(self.device), tree)
        self.params = to_dev(self.params)
        self.vae_params = to_dev(self.vae_params)
        if self.text_encoders:
            self.text_encoders = {
                k: None if v is None else (to_dev(v[0]),) + tuple(v[1:])
                for k, v in self.text_encoders.items()}
        self._prompt_cache = caching.PromptLRU(self.prompt_cache_size)
        self.last_cache_refreshes = None

    def shard(self, mesh) -> None:
        raise NotImplementedError("multi-card serving waits for the port of "
                                  "unigen_tpu/parallel (the parallel slice)")

    # ------------------------------------------------------------ text

    @torch.no_grad()
    def encode_prompt(self, prompt: Union[str, Sequence[str]],
                      max_sequence_length: int = 256):
        """-> (context [B, 77 + T, joint_dim], pooled [B, 2048]) in the
        pipeline's dtype through the triple-encoder stack (the zero-T5 block
        without T5), through the prompt LRU."""
        if not self.text_encoders:
            raise ValueError("text encoders not loaded; pass prompt_embeds directly")
        te = self.text_encoders
        clip_l, clip_l_cfg, tok_l = te["clip_l"]
        clip_g, clip_g_cfg, tok_g = te["clip_g"]
        t5_params, t5_cfg, tok_t5 = te.get("t5") or (None, None, None)
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)

        def compute():
            ctx, pooled = sd3_encode_prompt(
                clip_l, clip_l_cfg, clip_g, clip_g_cfg, t5_params, t5_cfg, tok_l,
                tok_g, tok_t5, prompts, max_sequence_length,
                pad_to_dim=self.cfg.sd3.joint_attention_dim)
            return ctx.to(self.dtype), pooled.to(self.dtype)

        return self._prompt_cache.get_or(
            ("prompt", tuple(prompts), max_sequence_length), compute)

    @torch.no_grad()
    def encode_condition_prompt(self, condition_prompt: Union[str, Sequence[str]]):
        """The pooled embedding of the condition task name(s): CLIP-L's and
        CLIP-G's side by side, through the prompt LRU."""
        if not self.text_encoders:
            raise ValueError("text encoders not loaded; pass cond_pooled directly")
        clip_l, clip_l_cfg, tok_l = self.text_encoders["clip_l"]
        clip_g, clip_g_cfg, tok_g = self.text_encoders["clip_g"]
        prompts = ([condition_prompt] if isinstance(condition_prompt, str)
                   else list(condition_prompt))

        def compute():
            return torch.cat([encode_pooled_only(clip_l, clip_l_cfg, tok_l, prompts),
                              encode_pooled_only(clip_g, clip_g_cfg, tok_g, prompts)],
                             dim=-1).to(self.dtype)

        return self._prompt_cache.get_or(("cond", tuple(prompts)), compute)

    # ------------------------------------------------------------ core

    def encode_control(self, control_pixels: torch.Tensor) -> torch.Tensor:
        """Control pixels [B, 3, H, W] in [-1, 1] -> control latents in the
        pipeline's dtype."""
        return vae_lib.vae_encode(self.vae_params, self.vae_cfg,
                                  control_pixels).to(self.dtype)

    def denoise(self, mode: CacheMode, latents, fwd, fwd_pos, sigmas, num_steps: int,
                guidance_scale: float):
        """The Euler loop under ``mode``. ``fwd(lat, i, **cache)`` is one SD3
        forward on the CFG-duplicated batch -> (raw pred, add_outputs);
        ``fwd_pos(lat, i, residuals)`` the positive stream alone replaying
        its half of the residual cache (the cfg_cache replay step). Sets
        ``last_cache_refreshes``."""
        do_cfg = guidance_scale > 1.0
        b = latents.shape[0]

        def combine(raw):
            if not do_cfg:
                return raw
            neg, pos = raw[:b], raw[b:]
            return neg + guidance_scale * (pos - neg)

        def capture(lat, i):
            raw, outs = fwd(lat, i, return_control_residuals=True,
                            control_residuals_bits=mode.bits)
            return raw, outs["control_residuals"]

        if mode.exact:
            for i in range(num_steps):
                latents = scheduling.euler_step(latents, combine(fwd(latents, i)[0]),
                                                sigmas[i], sigmas[i + 1])
            self.last_cache_refreshes = None
            return latents
        if mode.model_cache:
            latents, n = caching.model_cache_scan(
                lambda lat, i: combine(fwd(lat, i)[0]), latents, sigmas, num_steps,
                cache_interval=mode.interval, adaptive=mode.adaptive,
                threshold=mode.threshold, order=mode.order)
            self.last_cache_refreshes = n
            return latents
        if mode.hybrid:
            def full_fwd(lat, i):
                raw, res = capture(lat, i)
                return combine(raw), res

            latents, n_full, n_base = caching.hybrid_cache_scan(
                full_fwd, lambda lat, i, res: combine(fwd(lat, i, control_residuals=res)[0]),
                latents, sigmas, num_steps, control_interval=mode.interval,
                model_interval=mode.hybrid_interval, order=mode.order,
                adaptive=mode.hybrid_adaptive, control_threshold=mode.control_threshold,
                model_threshold=mode.model_threshold)
            self.last_cache_refreshes = (n_full, n_base)
            return latents

        # the control-residual cache: one cache over the CFG-duplicated batch;
        # with cfg_cache a replay step runs the positive stream alone on its
        # half of the cache and reuses the guidance delta of the last refresh
        use_cfg_cache = mode.cfg_cache and do_cfg
        res, delta, lat_ref, n_ref = None, None, latents, 0
        for i in range(num_steps):
            refresh = (caching.refresh_decision(i, latents, lat_ref, mode.threshold)
                       if mode.adaptive else i % mode.interval == 0)
            if refresh:
                raw, res = capture(latents, i)
                pred = combine(raw)
                if use_cfg_cache:
                    delta = raw[b:] - raw[:b]
                lat_ref, n_ref = latents, n_ref + 1
            elif use_cfg_cache:
                pos = fwd_pos(latents, i, _batch_slice(res, b))
                pred = pos + (guidance_scale - 1.0) * delta
            else:
                pred = combine(fwd(latents, i, control_residuals=res)[0])
            latents = scheduling.euler_step(latents, pred, sigmas[i], sigmas[i + 1])
        self.last_cache_refreshes = n_ref
        return latents

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents [B, C, h, w] -> uint8 images [B, H, W, 3] on the host:
        decoded in fp32, clipped to [-1, 1], scaled to 0..255 and rounded."""
        pixels = vae_lib.vae_decode(self.vae_params, self.vae_cfg,
                                    latents.to(torch.float32))
        imgs = pixels.to(torch.float32).clamp(-1.0, 1.0).permute(0, 2, 3, 1)
        return ((imgs + 1.0) * 127.5).round().to(torch.uint8).cpu()

    @torch.no_grad()
    def generate(self, *, prompt_embeds, pooled, cond_pooled, control_pixels,
                 neg_embeds=None, neg_pooled=None, height: int = 512, width: int = 512,
                 num_inference_steps: int = 28, guidance_scale: float = 7.0,
                 conditioning_scale: float = 1.0, control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0, seed: int = 0, latents=None,
                 control_cache_interval: int = 1,
                 control_cache_threshold: float = 0.0,
                 cfg_cache: bool = False,
                 model_cache_interval: int = 1,
                 model_cache_threshold: float = 0.0,
                 model_cache_order: int = 0,
                 residual_cache_bits: int = 16,
                 quality_profile: Optional[str] = None) -> torch.Tensor:
        """Generation from embeddings; returns uint8 images [B, H, W, 3] as a
        CPU tensor. ``control_pixels`` [B, 3, H, W] in [-1, 1]; the negative
        embeddings default to zeros (both, when ``neg_embeds`` is None);
        ``latents`` [B, C, H/8, W/8] are used as given, else drawn from a
        ``torch.Generator`` seeded with ``seed`` on the pipeline's device (a
        draw that cannot equal the JAX pipeline's PRNG). The conditioning
        scale is 0 on steps outside [control_guidance_start,
        control_guidance_end] of the schedule.

        The cache knobs are the JAX pipeline's, with its refusals
        (``resolve_cache_mode``, sd3 profiles: "balanced" the hybrid
        (c=8, m=2), "fast" the order-1 model cache at interval 4 from 8
        steps up); ``cfg_cache`` needs the control cache and guidance > 1.
        The step counts taken land in ``last_cache_refreshes``: an int,
        (n_full, n_base) for the hybrid, None for the exact loop."""
        mode = resolve_cache_mode(
            num_inference_steps, control_cache_interval=control_cache_interval,
            control_cache_threshold=control_cache_threshold, cfg_cache=cfg_cache,
            model_cache_interval=model_cache_interval,
            model_cache_threshold=model_cache_threshold,
            model_cache_order=model_cache_order,
            residual_cache_bits=residual_cache_bits, quality_profile=quality_profile,
            family="sd3")
        dev, dt, bb = self.device, self.dtype, self.cfg.sd3
        steps = num_inference_steps
        schedule = conditioning_schedule(steps, conditioning_scale,
                                         control_guidance_start, control_guidance_end)
        vs = self.vae_cfg.downscale
        lh, lw = height // vs, width // vs
        sigmas, timesteps = scheduling.inference_sigmas(self.scheduler, steps)

        prompt_embeds, pooled, cond_pooled = (torch.as_tensor(x).to(dev, dt) for x in
                                              (prompt_embeds, pooled, cond_pooled))
        b = prompt_embeds.shape[0]
        if latents is None:
            latents = torch.randn((b, bb.in_channels, lh, lw),
                                  generator=torch.Generator(device=dev).manual_seed(seed),
                                  device=dev, dtype=dt)
        else:
            latents = torch.as_tensor(latents).to(dev, dt)
        if neg_embeds is None:
            neg_embeds, neg_pooled = torch.zeros_like(prompt_embeds), torch.zeros_like(pooled)
        else:
            neg_embeds, neg_pooled = (torch.as_tensor(x).to(dev, dt)
                                      for x in (neg_embeds, neg_pooled))
        control_lat = self.encode_control(torch.as_tensor(control_pixels).to(dev))
        do_cfg = guidance_scale > 1.0
        if do_cfg:
            embeds = torch.cat([neg_embeds, prompt_embeds])
            pool = torch.cat([neg_pooled, pooled])
            cpool = torch.cat([cond_pooled, cond_pooled])
            ctrl = torch.cat([control_lat, control_lat])
        else:
            embeds, pool, cpool, ctrl = prompt_embeds, pooled, cond_pooled, control_lat

        def fwd(lat, i, **cache):
            lat_in = torch.cat([lat, lat]) if do_cfg else lat
            t = torch.full((lat_in.shape[0],), float(timesteps[i]), dtype=dt, device=dev)
            pred, _, outs = unigen_sd3_forward(
                self.params, self.cfg, lat_in, ctrl, embeds, pool, cpool, t,
                conditioning_scale=float(schedule[i]), **cache)
            return pred, outs

        def fwd_pos(lat, i, residuals):
            t = torch.full((lat.shape[0],), float(timesteps[i]), dtype=dt, device=dev)
            return unigen_sd3_forward(
                self.params, self.cfg, lat, control_lat, prompt_embeds, pooled,
                cond_pooled, t, conditioning_scale=float(schedule[i]),
                control_residuals=residuals)[0]

        latents = self.denoise(mode, latents, fwd, fwd_pos, sigmas, steps, guidance_scale)
        return self.decode(latents)

    # ------------------------------------------------------------ public API

    def __call__(self, prompt: Union[str, Sequence[str]],
                 condition_prompt: Union[str, Sequence[str]], control_image,
                 negative_prompt: Optional[Union[str, Sequence[str]]] = None,
                 max_sequence_length: int = 256, **kw) -> torch.Tensor:
        """Single-condition call from prompt strings: CFG by negative /
        positive duplication, ``control_image`` [B, 3, H, W] in [-1, 1] cast
        to the pipeline's dtype; ``kw`` are ``generate``'s other arguments."""
        embeds, pooled = self.encode_prompt(prompt, max_sequence_length)
        cond_pooled = self.encode_condition_prompt(condition_prompt)
        neg_embeds = neg_pooled = None
        if negative_prompt is not None:
            neg_embeds, neg_pooled = self.encode_prompt(negative_prompt,
                                                        max_sequence_length)
        return self.generate(
            prompt_embeds=embeds, pooled=pooled, cond_pooled=cond_pooled,
            control_pixels=torch.as_tensor(control_image).to(self.device, self.dtype),
            neg_embeds=neg_embeds, neg_pooled=neg_pooled, **kw)
