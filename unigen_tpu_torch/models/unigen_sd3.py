"""UniGenSD3: the interleaved condition-weaving control branch over a frozen
SD3.5 backbone (port of ``unigen_tpu/models/unigen_sd3.py``, the plain
serving forward), and ``UniGenSD3``, the module at the port's entry.

  per base block i: base joint block -> control joint block
  table[i] = int(i / (n_base / n_cn)) on the live base hidden and the fixed
  control context, with the condition temb -> hidden += zero_linear(cn_out)
  * scale.

The MoE preprocess (condition patch embed, control embedders, block-expert
MoE with global routing, the shared-expert weave) runs once, after base
block 0. ``cn2base_method="CrossAttn"`` also feeds each control output as
KV-append condition tokens into the NEXT base block's attention, whose
``condition_k``/``condition_v`` projections live in ``control["cross_kv"]``.
Timesteps are on the 0..1000 scale. ``control_residuals`` /
``return_control_residuals`` replay and capture the control blocks'
outputs for the step caches.

``unigen_base_forward`` is the UniGenBase variant (a separate control
branch): two preprocess weave blocks, the MoE and the n_cn control blocks
run once and give per-block residuals (after the add linear, unscaled),
which the base pass adds, or attends to under ``CrossAttn``, at
int(i / interval), times the scale. Its step cache is that residual stack;
a replay runs the base pass alone. Its control tree comes from
``init_unigen_sd3_control(..., base_variant=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.layers.adaln import adaln_continuous
from unigen_tpu_torch.layers.blocks_sd3 import (init_sd3_joint_block,
                                                init_sd3_single_block,
                                                sd3_joint_block, sd3_single_block)
from unigen_tpu_torch.layers.core import init_linear, init_rms_norm, linear
from unigen_tpu_torch.layers.embeddings import (combined_time_text,
                                                init_combined_time_text,
                                                init_patch_embed, patch_embed)
from unigen_tpu_torch.models import moe as moe_lib
from unigen_tpu_torch.models.sd3 import (init_sd3_params, sd3_block_list,
                                         sd3_embed_inputs)
from unigen_tpu_torch.models.unigen_flux import control_block_index_table
from unigen_tpu_torch.ops.quant import (dequantize_residual, quantize_residual,
                                        residual_at, stack_residuals)
from unigen_tpu_torch.ops.packing import unpatchify
from unigen_tpu_torch.pipelines import scheduling
from unigen_tpu_torch.utils import (index_params, init_stacked, resolve_device,
                                    tree_map)


# the SD3.5 scheduler config (the JAX pipeline's default): static shift 3
SD3_SCHEDULER = scheduling.FlowMatchConfig(shift=3.0)


def _n_control(cfg: UniGenConfig) -> int:
    return cfg.control.num_layers or cfg.sd3.num_layers


def init_unigen_sd3_control(cfg: UniGenConfig, *, gen=None, device=None,
                            dtype=torch.float32,
                            base_params: Optional[dict] = None,
                            base_variant: bool = False) -> dict:
    """The adapter tree of the interleaved UniGenSD3 (the context embedder
    maps d -> d); warm-started from ``base_params`` when given. With
    ``base_variant`` the UniGenBase tree: the context embedder maps
    joint_dim -> d, the two ``preprocess_block`` weave blocks exist, the
    control blocks are single blocks (``single_control_blocks``) when
    ``use_encoder_hidden_states`` is off, and ``use_pos_embed`` adds the
    target stream's own patch embed."""
    bb, cc = cfg.sd3, cfg.control
    d, heads, hd = bb.inner_dim, bb.num_attention_heads, bb.attention_head_dim
    n_cn = _n_control(cfg)
    kw = dict(gen=gen, device=device, dtype=dtype)
    modulated = cc.use_modulate or cc.use_rope
    joint_control = cc.use_encoder_hidden_states or not base_variant
    p: Dict[str, Any] = {
        "pos_embed_input": init_patch_embed(
            bb.patch_size, bb.in_channels + cc.extra_conditioning_channels, d,
            bb.pos_embed_max_size, bb.sample_size // bb.patch_size,
            pos_embed_type=(None if cc.use_rope else "sincos"), **kw),
        "time_text_embed": init_combined_time_text(d, bb.pooled_projection_dim, **kw),
        "condition_embed": init_combined_time_text(d, bb.pooled_projection_dim, **kw),
        "context_embedder": init_linear(
            bb.joint_attention_dim if base_variant else d, d, **kw),
        ("joint_blocks" if joint_control else "single_control_blocks"): init_stacked(
            n_cn, (lambda: init_sd3_joint_block(d, heads, hd, qk_norm=bb.qk_norm, **kw))
            if joint_control else
            (lambda: init_sd3_single_block(d, heads, hd, qk_norm=bb.qk_norm, **kw))),
        "add_blocks": init_stacked(n_cn, lambda: init_linear(d, d, zero=True, **kw)),
        "moe": moe_lib.init_moe_params(
            d, bb.pooled_projection_dim, cc.moe.num_experts(cfg.condition_nums),
            modulated=modulated,
            expert_block_init=None if modulated else (
                lambda: init_sd3_single_block(d, heads, hd, qk_norm=bb.qk_norm, **kw)),
            **kw),
    }
    if cc.use_shared_expert:
        p["shared_expert"] = {
            "weave_cond": init_sd3_joint_block(d, heads, hd, qk_norm=bb.qk_norm, **kw),
            "weave_text": init_sd3_joint_block(d, heads, hd, context_pre_only=True,
                                               use_dual_attention=True,
                                               qk_norm=bb.qk_norm, **kw),
        }
    if base_variant and cc.use_pos_embed:
        # the target stream's own trainable patch embed
        p["pos_embed"] = init_patch_embed(
            bb.patch_size, bb.in_channels, d, bb.pos_embed_max_size,
            bb.sample_size // bb.patch_size,
            pos_embed_type=(None if cc.use_rope else "sincos"), **kw)
    if base_variant:
        p["preprocess_block"] = {
            "b0": init_sd3_joint_block(d, heads, hd, qk_norm=bb.qk_norm, **kw),
            "b1": init_sd3_joint_block(d, heads, hd, qk_norm=bb.qk_norm, **kw)}
    if cc.cn2base_method == "CrossAttn":
        # trainable KV-append projections on every base block's attention
        def cross():
            out = {"condition_k": init_linear(d, heads * hd, **kw),
                   "condition_v": init_linear(d, heads * hd, **kw)}
            if bb.qk_norm == "rms_norm":
                out["condition_k_norm"] = init_rms_norm(hd, device=device, dtype=dtype)
            return out
        p["cross_kv"] = [cross() for _ in range(bb.num_layers)]
    if cc.use_transformer_params and base_params is not None:
        p = warm_start_sd3_control(p, base_params)
    return p


def warm_start_sd3_control(control: dict, base: dict) -> dict:
    """Both time embedders copy the base's; the context embedder and the
    condition patch projection copy the base's where the shapes agree. The
    control blocks keep their own init (the reference's strict=False
    load)."""
    control = dict(control)
    control["time_text_embed"] = tree_map(torch.clone, base["time_text_embed"])
    control["condition_embed"] = tree_map(torch.clone, base["time_text_embed"])
    if control["context_embedder"]["w"].shape == base["context_embedder"]["w"].shape:
        control["context_embedder"] = tree_map(torch.clone, base["context_embedder"])
    if "pos_embed" in base and "proj" in control["pos_embed_input"]:
        if (control["pos_embed_input"]["proj"]["w"].shape
                == base["pos_embed"]["proj"]["w"].shape):
            control["pos_embed_input"] = dict(control["pos_embed_input"])
            control["pos_embed_input"]["proj"] = tree_map(
                torch.clone, base["pos_embed"]["proj"])
    if "pos_embed" in control and "pos_embed" in base:
        control["pos_embed"] = dict(control["pos_embed"])
        control["pos_embed"]["proj"] = tree_map(torch.clone, base["pos_embed"]["proj"])
    return control


def init_unigen_sd3_params(cfg: UniGenConfig, *, gen=None, device=None,
                           dtype=torch.float32, base_variant: bool = False) -> dict:
    base = init_sd3_params(cfg.sd3, gen=gen, device=device, dtype=dtype)
    control = init_unigen_sd3_control(cfg, gen=gen, device=device, dtype=dtype,
                                      base_params=base, base_variant=base_variant)
    return {"base": base, "control": control}


def _moe_with_weave_sd3(ctrl: dict, cfg: UniGenConfig, h0, cond_tokens,
                        control_enc, control_temb, cond_temb, pooled,
                        condition_pooled, *, training=False) -> moe_lib.MoEOutput:
    """Route + block experts, then the shared-expert weave: [img] <-> cond
    (condition temb), then [img | cond] <-> text (control temb, the
    context-pre-only dual block)."""
    bb, cc = cfg.sd3, cfg.control
    heads = bb.num_attention_heads
    streams = {"temb": control_temb, "condition_temb": cond_temb,
               "pooled": pooled, "condition_pooled": condition_pooled}
    out = moe_lib.moe_apply(ctrl["moe"], cc, cc.moe.num_experts(cfg.condition_nums),
                            h0, cond_tokens, streams, block_apply=sd3_single_block,
                            heads=heads, training=training)
    exp_h, exp_c = out.expert_hidden, out.expert_condition
    if "shared_expert" in ctrl:
        cond_states, hidden_states = sd3_joint_block(
            ctrl["shared_expert"]["weave_cond"], h0, cond_tokens, cond_temb,
            heads=heads)
        _, hc = sd3_joint_block(
            ctrl["shared_expert"]["weave_text"],
            torch.cat([hidden_states, cond_states], dim=1), control_enc,
            control_temb, heads=heads)
        s = hidden_states.shape[1]
        exp_h = hc[:, :s] + exp_h
        exp_c = hc[:, s:] + exp_c
    return moe_lib.MoEOutput(exp_h, exp_c, out.aux_loss, out.expert_counts)


class SD3Preprocess(NamedTuple):
    moe_hidden: torch.Tensor
    control_enc: torch.Tensor
    control_temb: torch.Tensor
    cond_temb: torch.Tensor
    aux_loss: torch.Tensor
    expert_counts: torch.Tensor


def _preprocess_sd3(ctrl: dict, cfg: UniGenConfig, h0, enc0, condition, pooled,
                    condition_pooled, timestep, *, training=False) -> SD3Preprocess:
    bb, cc = cfg.sd3, cfg.control
    dtype = h0.dtype
    cond_tokens = patch_embed(ctrl["pos_embed_input"], condition,
                              bb.patch_size, bb.pos_embed_max_size)
    ctrl_pooled = pooled if cc.use_pooled_prompt_embeds else torch.zeros_like(pooled)
    t = timestep.to(torch.float32)
    control_temb = combined_time_text(ctrl["time_text_embed"], t, ctrl_pooled,
                                      dtype=dtype)
    cond_temb = combined_time_text(ctrl["condition_embed"], t, condition_pooled,
                                   dtype=dtype)
    control_enc = linear(ctrl["context_embedder"], enc0)
    out = _moe_with_weave_sd3(ctrl, cfg, h0, cond_tokens, control_enc,
                              control_temb, cond_temb, pooled, condition_pooled,
                              training=training)
    return SD3Preprocess(out.expert_hidden + out.expert_condition, control_enc,
                         control_temb, cond_temb, out.aux_loss, out.expert_counts)


def unigen_sd3_forward(params: dict, cfg: UniGenConfig, hidden, condition,
                       encoder, pooled, condition_pooled, timestep, *,
                       conditioning_scale=1.0, training: bool = False,
                       control_residuals=None,
                       return_control_residuals: bool = False,
                       control_residuals_bits: int = 16):
    """The interleaved UniGenSD3 forward: hidden and condition [B, C, H, W],
    encoder [B, T, joint_dim], timestep [B] on 0..1000 -> (pred
    [B, out_ch, H, W], add_losses, add_outputs).

    Control-residual step caching, as ``unigen_flux_forward``'s: the cache
    is each base block's RAW control block output ``cn_out`` (before the add
    linear, unscaled), stacked [n_base, B, S_img, D], so one cache serves
    the ``add`` and the ``CrossAttn`` merges; ``return_control_residuals``
    captures it (quantized per block when ``control_residuals_bits`` < 16),
    ``control_residuals`` replays it, skipping the MoE preprocess and every
    control joint block but not the add linears."""
    reuse = control_residuals is not None
    if reuse and return_control_residuals:
        raise ValueError("pass either control_residuals or "
                         "return_control_residuals, not both")
    if control_residuals_bits not in (4, 8, 16):
        raise ValueError(f"control_residuals_bits must be 4, 8 or 16, "
                         f"got {control_residuals_bits}")
    base, ctrl = params["base"], params["control"]
    bb, cc = cfg.sd3, cfg.control
    if not cc.use_encoder_hidden_states:
        raise ValueError("UniGenSD3 (interleaved) requires "
                         "use_encoder_hidden_states=True")
    heads = bb.num_attention_heads
    height, width = hidden.shape[2:]
    # an fp32 scale must not promote the bf16 residual stream
    scale = torch.as_tensor(conditioning_scale, dtype=hidden.dtype,
                            device=hidden.device)

    h, enc, temb = sd3_embed_inputs(base, bb, hidden, encoder, pooled, timestep)
    table = control_block_index_table(bb.num_layers, _n_control(cfg))
    cross = cc.cn2base_method == "CrossAttn"
    pre, cond_kv, cn_ys = None, None, []
    for i, block in enumerate(sd3_block_list(base, bb)):
        if cross and "cross_kv" in ctrl:
            block = {**block, "attn": {**block["attn"], **ctrl["cross_kv"][i]}}
        enc_out, h = sd3_joint_block(block, h, enc, temb, heads=heads,
                                     condition_kv_states=cond_kv)
        enc = enc_out if enc_out is not None else enc
        if reuse:
            cn_out = residual_at(control_residuals, i)
            if isinstance(cn_out, dict):
                cn_out = dequantize_residual(cn_out, h.dtype)
        else:
            if pre is None:
                pre = _preprocess_sd3(ctrl, cfg, h, enc, condition, pooled,
                                      condition_pooled, timestep, training=training)
                cn_in = pre.moe_hidden
            else:
                cn_in = h
            _, cn_out = sd3_joint_block(index_params(ctrl["joint_blocks"], table[i]),
                                        cn_in, pre.control_enc, pre.cond_temb,
                                        heads=heads, context_out=False)
            if return_control_residuals:
                cn_ys.append(cn_out if control_residuals_bits == 16 else
                             quantize_residual(cn_out, control_residuals_bits))
        if cross:
            cond_kv = cn_out
        h = h + linear(index_params(ctrl["add_blocks"], table[i]), cn_out) * scale

    h = linear(base["proj_out"], adaln_continuous(base["norm_out"], h, temb))
    out = unpatchify(h, height // bb.patch_size, width // bb.patch_size,
                     bb.patch_size, bb.out_channels)
    if reuse:
        return (out, {"moe_loss": torch.zeros((), dtype=torch.float32,
                                              device=out.device)},
                {"expert_counts": None})
    add_outputs = {"expert_counts": pre.expert_counts}
    if return_control_residuals:
        add_outputs["control_residuals"] = stack_residuals(cn_ys)
    return (out, {"moe_loss": pre.aux_loss * cc.moe.aux_loss_weight}, add_outputs)


def unigen_base_forward(params: dict, cfg: UniGenConfig, hidden, condition, encoder,
                        pooled, condition_pooled, timestep, *,
                        conditioning_scale=1.0, training: bool = False,
                        control_residuals=None,
                        return_control_residuals: bool = False,
                        control_residuals_bits: int = 16):
    """The UniGenBase forward: the control branch runs once (a trainable or
    the base's patch embed of the target, the condition patch embed, the
    preprocess weave text <-> hidden then [hidden | text] <-> condition, the
    MoE with the shared-expert weave, the n_cn control blocks, each followed
    by its add linear) and gives the residual stack [n_cn, B, S, D]; the
    base pass consumes residual int(i / interval) at base block i, times
    the scale. Arguments and outputs as ``unigen_sd3_forward``'s.

    The step cache is that post-add-linear, unscaled stack (at 16, 8 or 4
    bits); ``control_residuals`` replays it through the base pass alone, so
    a replay picks up the live conditioning scale."""
    reuse = control_residuals is not None
    if reuse and return_control_residuals:
        raise ValueError("pass either control_residuals or "
                         "return_control_residuals, not both")
    if control_residuals_bits not in (4, 8, 16):
        raise ValueError(f"control_residuals_bits must be 4, 8 or 16, "
                         f"got {control_residuals_bits}")
    scale = torch.as_tensor(conditioning_scale, dtype=hidden.dtype,
                            device=hidden.device)
    if reuse:
        n = (next(iter(control_residuals.values())).shape[0]
             if isinstance(control_residuals, dict) else control_residuals.shape[0])
        residuals = []
        for i in range(n):
            r = residual_at(control_residuals, i)
            residuals.append(dequantize_residual(r, hidden.dtype)
                             if isinstance(r, dict) else r)
        out = _base_pass_sd3(params, cfg, hidden, encoder, pooled, timestep,
                             residuals, scale)
        return (out, {"moe_loss": torch.zeros((), dtype=torch.float32,
                                              device=out.device)},
                {"expert_counts": None})

    base, ctrl = params["base"], params["control"]
    bb, cc = cfg.sd3, cfg.control
    heads, dtype = bb.num_attention_heads, hidden.dtype
    ctrl_hidden = patch_embed(ctrl.get("pos_embed", base["pos_embed"]), hidden,
                              bb.patch_size, bb.pos_embed_max_size)
    cond_tokens = patch_embed(ctrl["pos_embed_input"], condition, bb.patch_size,
                              bb.pos_embed_max_size)
    ctrl_pooled = pooled if cc.use_pooled_prompt_embeds else torch.zeros_like(pooled)
    t = timestep.to(torch.float32)
    control_temb = combined_time_text(ctrl["time_text_embed"], t, ctrl_pooled,
                                      dtype=dtype)
    cond_temb = combined_time_text(ctrl["condition_embed"], t, condition_pooled,
                                   dtype=dtype)
    control_enc = linear(ctrl["context_embedder"], encoder)

    # the preprocess weave: text <-> hidden, then [hidden | text] <-> condition
    pb = ctrl["preprocess_block"]
    control_enc, ctrl_hidden = sd3_joint_block(pb["b0"], ctrl_hidden, control_enc,
                                               control_temb, heads=heads)
    s_h = ctrl_hidden.shape[1]
    cond_tokens, he = sd3_joint_block(pb["b1"],
                                      torch.cat([ctrl_hidden, control_enc], dim=1),
                                      cond_tokens, cond_temb, heads=heads)
    ctrl_hidden, control_enc = he[:, :s_h], he[:, s_h:]

    moe_out = _moe_with_weave_sd3(ctrl, cfg, ctrl_hidden, cond_tokens, control_enc,
                                  control_temb, cond_temb, pooled, condition_pooled,
                                  training=training)
    x = moe_out.expert_hidden + moe_out.expert_condition
    residuals = []
    for i in range(_n_control(cfg)):
        if cc.use_encoder_hidden_states:
            control_enc, x = sd3_joint_block(index_params(ctrl["joint_blocks"], i), x,
                                             control_enc, control_temb, heads=heads)
        else:
            x = sd3_single_block(index_params(ctrl["single_control_blocks"], i), x,
                                 control_temb, heads=heads)
        residuals.append(linear(index_params(ctrl["add_blocks"], i), x))

    out = _base_pass_sd3(params, cfg, hidden, encoder, pooled, timestep, residuals,
                         scale)
    add_outputs: Dict[str, Any] = {"expert_counts": moe_out.expert_counts}
    if return_control_residuals:
        add_outputs["control_residuals"] = stack_residuals(
            residuals if control_residuals_bits == 16 else
            [quantize_residual(r, control_residuals_bits) for r in residuals])
    return out, {"moe_loss": moe_out.aux_loss * cc.moe.aux_loss_weight}, add_outputs


def _base_pass_sd3(params: dict, cfg: UniGenConfig, hidden, encoder, pooled,
                   timestep, residuals, scale):
    """The frozen base pass of ``unigen_base_forward``: residual
    int(i / interval) times ``scale`` added after base block i, or appended
    as condition keys and values of its attention under ``CrossAttn``."""
    base, ctrl = params["base"], params["control"]
    bb, cc = cfg.sd3, cfg.control
    heads = bb.num_attention_heads
    height, width = hidden.shape[2:]
    interval = bb.num_layers / _n_control(cfg)
    cross = cc.cn2base_method == "CrossAttn"
    h, enc, temb = sd3_embed_inputs(base, bb, hidden, encoder, pooled, timestep)
    for i, block in enumerate(sd3_block_list(base, bb)):
        res = residuals[int(i / interval)] * scale
        if cross and "cross_kv" in ctrl:
            block = {**block, "attn": {**block["attn"], **ctrl["cross_kv"][i]}}
        enc_out, h = sd3_joint_block(block, h, enc, temb, heads=heads,
                                     condition_kv_states=res if cross else None)
        enc = enc_out if enc_out is not None else enc
        if not cross:
            h = h + res
    h = linear(base["proj_out"], adaln_continuous(base["norm_out"], h, temb))
    return unpatchify(h, height // bb.patch_size, width // bb.patch_size,
                      bb.patch_size, bb.out_channels)


def conditioning_schedule(num_steps: int, conditioning_scale: float = 1.0,
                          start: float = 0.0, end: float = 1.0) -> np.ndarray:
    """Per-step conditioning scale (the pipeline's ``controlnet_keep``): 0
    for steps outside [start, end] of the denoise, fp32."""
    keep = np.array([1.0 - float((i / num_steps < start)
                                 or ((i + 1) / num_steps > end))
                     for i in range(num_steps)], np.float32)
    return (conditioning_scale * keep).astype(np.float32)


class UniGenSD3(nn.Module):
    """The port's SD3 entry: holds a parameter tree on one device and runs
    the forward and the classifier-free-guided Euler denoise. ``device``
    defaults to CUDA and must be named "cpu" to run on the CPU."""

    def __init__(self, cfg: UniGenConfig, params: dict, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        if cfg.family != "sd3":
            raise ValueError(f"UniGenSD3 needs an sd3 config, got {cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = tree_map(lambda t: t.to(self.device), params)

    def forward(self, hidden, condition, encoder, pooled, condition_pooled,
                timestep, *, conditioning_scale=1.0):
        return unigen_sd3_forward(self.params, self.cfg, hidden, condition,
                                  encoder, pooled, condition_pooled, timestep,
                                  conditioning_scale=conditioning_scale)

    @torch.no_grad()
    def denoise(self, latents, condition, encoder, pooled, cond_pooled,
                neg_encoder=None, neg_pooled=None, *, num_steps: int = 28,
                guidance_scale: float = 7.0, conditioning_scale: float = 1.0,
                control_guidance_start: float = 0.0,
                control_guidance_end: float = 1.0) -> torch.Tensor:
        """The no-cache serving program of the JAX SD3 pipeline on latents
        and condition latents [B, C, H, W]: with guidance > 1 the [neg; pos]
        pair rides on the batch axis (the negative embeddings default to
        zeros) and pred = neg + g * (pos - neg); ``num_steps`` Euler steps on
        the shifted sigmas, the timestep sigma*1000 rounded to the model
        dtype, the conditioning scale following the start/end window."""
        dev, dt = self.device, self.dtype
        latents, condition, encoder, pooled, cond_pooled = (
            torch.as_tensor(x).to(dev, dt)
            for x in (latents, condition, encoder, pooled, cond_pooled))
        b = latents.shape[0]
        do_cfg = guidance_scale > 1.0
        if do_cfg:
            neg_encoder = (torch.zeros_like(encoder) if neg_encoder is None
                           else torch.as_tensor(neg_encoder).to(dev, dt))
            neg_pooled = (torch.zeros_like(pooled) if neg_pooled is None
                          else torch.as_tensor(neg_pooled).to(dev, dt))
            encoder = torch.cat([neg_encoder, encoder])
            pooled = torch.cat([neg_pooled, pooled])
            cond_pooled = torch.cat([cond_pooled, cond_pooled])
            condition = torch.cat([condition, condition])
        sig, timesteps = scheduling.inference_sigmas(SD3_SCHEDULER, num_steps)
        schedule = conditioning_schedule(num_steps, conditioning_scale,
                                         control_guidance_start, control_guidance_end)
        for i in range(num_steps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t = torch.full((lat_in.shape[0],), float(timesteps[i]), dtype=dt,
                           device=dev)
            pred, _, _ = self.forward(lat_in, condition, encoder, pooled,
                                      cond_pooled, t,
                                      conditioning_scale=float(schedule[i]))
            if do_cfg:
                neg, pos = pred[:b], pred[b:]
                pred = neg + guidance_scale * (pos - neg)
            latents = scheduling.euler_step(latents, pred, sig[i], sig[i + 1])
        return latents
