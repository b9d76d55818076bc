"""UniGenFlux: condition-weaving control branch + MoE expert modulation over
a frozen FLUX.1 backbone (port of ``unigen_tpu/models/unigen_flux.py``, the
plain serving forward), and ``UniGenFlux``, the module at the port's entry.

  x_embed / context_embed / time_text_embed
  base double block 0
  -> preprocess_moe: control embedders, MoE route + experts, the consis
     module (optional), shared-expert condition weave (2 joint blocks)
  -> control double block 0 on (expert_h + expert_c), gated zero-linear add
  19x [base double -> control double (idx i*n_cn//19) -> gated add]
  stream = [txt | img]
  38x [base single -> control single (idx i//2) -> overall_add | single_add]
  AdaLN-continuous out -> proj

Control blocks run sample-first, with rope under ``use_rope`` and without
it otherwise (the shared-expert weave follows the same flag); with
``use_rope = use_modulate = False`` (the reference's shipped unigen.yaml)
each MoE expert is a pair of FLUX single blocks with token-wise temb,
else a pair of modulated linears. Every control block reads the fixed
control context; multi-condition inputs carry a leading condition
axis, and their expert outputs and condition tembs are summed.
``remat`` checkpoints each double and single body (base block + control
block + gated add) as the JAX scan bodies are; ``training`` routes the MoE
with its training capacity. ``control_residuals`` /
``return_control_residuals`` replay and capture the control branch's
per-block adds for the pipeline's step caches.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.layers.adaln import adaln_continuous
from unigen_tpu_torch.layers.blocks_flux import (flux_double_block,
                                                 flux_single_block,
                                                 init_flux_double_block,
                                                 init_flux_single_block)
from unigen_tpu_torch.layers.core import init_linear, linear
from unigen_tpu_torch.layers.embeddings import (combined_time_text,
                                                init_combined_time_text)
from unigen_tpu_torch.models import moe as moe_lib
from unigen_tpu_torch.models.flux import (flux_embed_inputs, flux_rope,
                                          init_flux_params)
from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
from unigen_tpu_torch.ops.quant import (dequantize_residual, quantize_residual,
                                        residual_at, stack_residuals)
from unigen_tpu_torch.pipelines import scheduling
from unigen_tpu_torch.utils import (index_params, init_stacked, remat_wrap,
                                    resolve_device, tree_map)


def control_block_index_table(n_base: int, n_control: int) -> list:
    """Reference mapping: int(i / (n_base / n_control))."""
    interval = n_base / n_control
    return [min(int(i / interval), n_control - 1) for i in range(n_base)]


def init_unigen_flux_control(cfg: UniGenConfig, *, gen=None, device=None,
                             dtype=torch.float32,
                             base_params: Optional[dict] = None) -> dict:
    """The adapter tree; warm-started from ``base_params`` when given
    (control double/single blocks, both time embedders and x_embedder copy
    the base; the context embedder does not)."""
    bb, cc = cfg.flux, cfg.control
    d, heads, hd = bb.inner_dim, bb.num_attention_heads, bb.attention_head_dim
    n_cn = bb.num_layers // cc.single_control_dev
    n_cn_single = bb.num_single_layers // cc.single_control_dev
    kw = dict(gen=gen, device=device, dtype=dtype)
    modulated = cc.use_modulate or cc.use_rope
    p: Dict[str, Any] = {
        "x_embedder": init_linear(bb.in_channels, d, **kw),
        "time_text_embed": init_combined_time_text(
            d, bb.pooled_projection_dim, guidance=bb.guidance_embeds, **kw),
        "condition_embed": init_combined_time_text(
            d, bb.pooled_projection_dim, guidance=bb.guidance_embeds, **kw),
        "context_embedder": init_linear(d, d, **kw),
        "double_blocks": init_stacked(
            n_cn, lambda: init_flux_double_block(d, heads, hd, **kw)),
        "add_double": init_stacked(
            n_cn, lambda: init_linear(d, d, zero=True, **kw)),
        "moe": moe_lib.init_moe_params(
            d, bb.pooled_projection_dim,
            cc.moe.num_experts(cfg.condition_nums), modulated=modulated,
            expert_block_init=(None if modulated else
                               lambda: init_flux_single_block(d, heads, hd, **kw)),
            **kw),
    }
    if cc.use_single_trans_blocks:
        p["single_blocks"] = init_stacked(
            n_cn_single, lambda: init_flux_single_block(d, heads, hd, **kw))
        p["add_single"] = init_stacked(
            n_cn_single, lambda: init_linear(d, d, zero=True, **kw))
    if cc.use_shared_expert:
        p["shared_expert"] = {
            "weave_cond": init_flux_double_block(d, heads, hd, **kw),
            "weave_text": init_flux_double_block(d, heads, hd, **kw),
        }
    if cc.use_consis_module:
        p["consis"] = {"block0": init_flux_double_block(d, heads, hd, **kw),
                       "block1": init_flux_double_block(d, heads, hd, **kw)}
    if cc.use_transformer_params and base_params is not None:
        p["x_embedder"] = tree_map(torch.clone, base_params["x_embedder"])
        p["time_text_embed"] = tree_map(torch.clone, base_params["time_text_embed"])
        p["condition_embed"] = tree_map(torch.clone, base_params["time_text_embed"])
        p["double_blocks"] = tree_map(lambda x: x[:n_cn].clone(),
                                      base_params["double_blocks"])
        if "single_blocks" in p:
            p["single_blocks"] = tree_map(lambda x: x[:n_cn_single].clone(),
                                          base_params["single_blocks"])
    return p


def init_unigen_flux_params(cfg: UniGenConfig, *, gen=None, device=None,
                            dtype=torch.float32) -> dict:
    base = init_flux_params(cfg.flux, gen=gen, device=device, dtype=dtype)
    control = init_unigen_flux_control(cfg, gen=gen, device=device, dtype=dtype,
                                       base_params=base)
    return {"base": base, "control": control}


class PreprocessOutput(NamedTuple):
    moe_hidden: torch.Tensor       # control-block-0 input
    control_enc: torch.Tensor      # fixed control context stream
    control_temb: torch.Tensor
    block_temb: torch.Tensor       # condition temb (summed over conditions)
    aux_loss: torch.Tensor
    expert_counts: torch.Tensor


def _moe_with_weave(ctrl: dict, cfg: UniGenConfig, h0, cond_h, control_enc,
                    control_temb, cond_temb, pooled, condition_pooled,
                    img_ids, cond_ids, txt_ids, training=False,
                    rts_uniform=None) -> moe_lib.MoEOutput:
    """Route + experts, then the consis module, then the shared-expert
    weave."""
    bb, cc = cfg.flux, cfg.control
    heads = bb.num_attention_heads
    streams = {"temb": control_temb, "condition_temb": cond_temb,
               "pooled": pooled, "condition_pooled": condition_pooled}
    out = moe_lib.moe_apply(ctrl["moe"], cc, cc.moe.num_experts(cfg.condition_nums),
                            h0, cond_h, streams, block_apply=flux_single_block,
                            heads=heads, training=training, rts_uniform=rts_uniform)
    exp_h, exp_c = out.expert_hidden, out.expert_condition

    if "consis" in ctrl:
        # the reference runs consis_module[0] for BOTH calls
        # (UniGenTransformer.py:994,998); block1 exists for the checkpoint's
        # shape only. Both calls discard the context stream.
        block0 = ctrl["consis"]["block0"]
        rope_cc = flux_rope(bb, torch.cat([cond_ids, cond_ids])) if cc.use_rope else None
        _, consis_c = flux_double_block(block0, exp_c, cond_h, cond_temb, rope_cc,
                                        heads=heads, context_first=False,
                                        context_out=False)
        rope_hc = (flux_rope(bb, torch.cat([img_ids, cond_ids, img_ids]))
                   if cc.use_rope else None)
        _, hc = flux_double_block(block0, torch.cat([exp_h, consis_c], dim=1), h0,
                                  control_temb, rope_hc, heads=heads,
                                  context_first=False, context_out=False)
        s = exp_h.shape[1]
        exp_h = exp_h + hc[:, :s]
        exp_c = exp_c + hc[:, s:]

    if "shared_expert" in ctrl:
        # weave 1: img stream <-> condition context (temb = condition temb)
        rope1 = flux_rope(bb, torch.cat([img_ids, cond_ids])) if cc.use_rope else None
        cond_states, hidden_states = flux_double_block(
            ctrl["shared_expert"]["weave_cond"], h0, cond_h, cond_temb, rope1,
            heads=heads, context_first=False)
        # weave 2: [img | cond] stream <-> text context (temb = control temb)
        rope2 = (flux_rope(bb, torch.cat([img_ids, cond_ids, txt_ids]))
                 if cc.use_rope else None)
        _, hc = flux_double_block(
            ctrl["shared_expert"]["weave_text"],
            torch.cat([hidden_states, cond_states], dim=1), control_enc,
            control_temb, rope2, heads=heads, context_first=False,
            context_out=False)
        s = hidden_states.shape[1]
        exp_h = hc[:, :s] + exp_h
        exp_c = hc[:, s:] + exp_c
    return moe_lib.MoEOutput(exp_h, exp_c, out.aux_loss, out.expert_counts)


def preprocess_moe(ctrl: dict, cfg: UniGenConfig, h0, enc0, condition,
                   pooled, condition_pooled, timestep, guidance,
                   img_ids, txt_ids, condition_ids, *,
                   training=False, rts_uniform=None) -> PreprocessOutput:
    """Single ([B,Sc,C] condition) and multi ([K,B,Sc,C]) condition modes."""
    cc = cfg.control
    dtype = h0.dtype
    ctrl_pooled = pooled if cc.use_pooled_prompt_embeds else torch.zeros_like(pooled)
    t1000 = timestep.to(torch.float32) * 1000.0
    g1000 = None if guidance is None else guidance.to(torch.float32) * 1000.0
    control_temb = combined_time_text(ctrl["time_text_embed"], t1000,
                                      ctrl_pooled, g1000, dtype=dtype)
    control_enc = linear(ctrl["context_embedder"], enc0)

    multi = condition.dim() == 4
    conds = condition if multi else condition[None]
    cond_pooleds = condition_pooled if multi else condition_pooled[None]
    cond_id_list = condition_ids if multi else condition_ids[None]

    moe_hidden = torch.zeros_like(h0)
    block_temb = torch.zeros_like(control_temb)
    out = None
    for k in range(conds.shape[0]):
        cond_h = linear(ctrl["x_embedder"], conds[k])
        cond_temb = combined_time_text(ctrl["condition_embed"], t1000,
                                       cond_pooleds[k], g1000, dtype=dtype)
        out = _moe_with_weave(ctrl, cfg, h0, cond_h, control_enc, control_temb,
                              cond_temb, pooled, cond_pooleds[k], img_ids,
                              cond_id_list[k], txt_ids, training=training,
                              rts_uniform=rts_uniform)
        moe_hidden = moe_hidden + out.expert_hidden + out.expert_condition
        block_temb = block_temb + cond_temb
    # aux loss and counts of the last condition (reference behavior)
    return PreprocessOutput(moe_hidden, control_enc, control_temb, block_temb,
                            out.aux_loss, out.expert_counts)


def unigen_flux_forward(params: dict, cfg: UniGenConfig, hidden, condition,
                        encoder, pooled, condition_pooled, timestep, img_ids,
                        txt_ids, condition_ids, guidance=None, *,
                        conditioning_scale: float = 1.0, remat=False,
                        training: bool = False,
                        rts_uniform=None,
                        control_residuals=None,
                        return_control_residuals: bool = False,
                        control_residuals_bits: int = 16):
    """Full UniGenFlux forward -> (pred [B, S, C], add_losses, add_outputs).
    condition/condition_pooled/condition_ids may carry a leading condition
    axis for multi-condition control. ``remat`` is ``utils.remat_wrap``'s
    policy for the block bodies; ``training`` selects the MoE's training
    capacity, and its random token selection under ``use_rts`` reads the
    uniform draw ``rts_uniform`` (``models/moe.moe_apply``).

    Control-residual step caching (the serving caches of the pipeline):
      * ``return_control_residuals=True`` also returns the UNSCALED
        per-block control adds in ``add_outputs["control_residuals"]`` as
        ``(dbl [n_base, B, S_img, D], sgl [n_single, B, S_txt + S_img, D])``;
        with ``control_residuals_bits`` 8 or 4 each block's add is quantized
        as it is made (``ops/quant.quantize_residual``), so each leaf is a
        ``{"q"/"q4", "s"}`` dict of stacks.
      * ``control_residuals=(dbl, sgl)`` skips the MoE preprocess and every
        control block and adds the cached residuals, times the CURRENT
        conditioning scale, at the same sites; quantized leaves are
        dequantized per block. ``moe_loss`` is then zero and
        ``expert_counts`` None.
    Replaying bf16 residuals captured at the same state gives the plain
    forward's bits."""
    reuse = control_residuals is not None
    if reuse and return_control_residuals:
        raise ValueError("pass either control_residuals or "
                         "return_control_residuals, not both")
    if control_residuals_bits not in (4, 8, 16):
        raise ValueError(f"control_residuals_bits must be 4, 8 or 16, "
                         f"got {control_residuals_bits}")
    base, ctrl = params["base"], params["control"]
    bb, cc = cfg.flux, cfg.control
    heads = bb.num_attention_heads
    single_ctrl = cc.use_single_trans_blocks and "single_blocks" in ctrl
    if return_control_residuals and not single_ctrl:
        raise ValueError("control-residual caching requires the single-block "
                         "control path")
    # an fp32 scale must not promote the bf16 residual stream
    scale = torch.as_tensor(conditioning_scale, dtype=hidden.dtype,
                            device=hidden.device)
    def capture(r):
        return r if control_residuals_bits == 16 else quantize_residual(
            r, control_residuals_bits)

    def replayed(res, i):
        r = residual_at(res, i)
        return dequantize_residual(r, hidden.dtype) if isinstance(r, dict) else r

    h, enc, temb = flux_embed_inputs(base, bb, hidden, encoder, pooled,
                                     timestep, guidance)
    rope_base = flux_rope(bb, torch.cat([txt_ids, img_ids]))
    rope_cn_double = flux_rope(bb, torch.cat([img_ids, txt_ids])) if cc.use_rope else None
    rope_single = rope_base if cc.use_rope else None

    n_base = bb.num_layers
    cn_table = control_block_index_table(n_base, n_base // cc.single_control_dev)

    enc, h = flux_double_block(index_params(base["double_blocks"], 0), h, enc,
                               temb, rope_base, heads=heads)
    dbl_ys, sgl_ys = [], []
    if reuse:
        dbl_res, sgl_res = control_residuals
        pre = None
        h = h + replayed(dbl_res, 0) * scale

        def double_body(h, enc, i):
            enc, h = flux_double_block(index_params(base["double_blocks"], i), h,
                                       enc, temb, rope_base, heads=heads)
            return h + replayed(dbl_res, i) * scale, enc
    else:
        pre = preprocess_moe(ctrl, cfg, h, enc, condition, pooled,
                             condition_pooled, timestep, guidance, img_ids,
                             txt_ids, condition_ids, training=training,
                             rts_uniform=rts_uniform)
        _, cn_out = flux_double_block(index_params(ctrl["double_blocks"], 0),
                                      pre.moe_hidden, pre.control_enc,
                                      pre.block_temb, rope_cn_double,
                                      heads=heads, context_first=False,
                                      context_out=False)
        res = linear(index_params(ctrl["add_double"], 0), cn_out)
        if return_control_residuals:
            dbl_ys.append(capture(res))
        h = h + res * scale

        def double_body(h, enc, i):
            enc, h = flux_double_block(index_params(base["double_blocks"], i), h,
                                       enc, temb, rope_base, heads=heads)
            j = cn_table[i]
            _, cn_out = flux_double_block(index_params(ctrl["double_blocks"], j), h,
                                          pre.control_enc, pre.block_temb,
                                          rope_cn_double, heads=heads,
                                          context_first=False, context_out=False)
            res = linear(index_params(ctrl["add_double"], j), cn_out)
            if return_control_residuals:
                dbl_ys.append(capture(res))
            return h + res * scale, enc

    double_body = remat_wrap(double_body, remat)
    for i in range(1, n_base):
        h, enc = double_body(h, enc, i)

    stream = torch.cat([enc, h], dim=1)
    enc_len = enc.shape[1]
    n_s = bb.num_single_layers

    def single_add(stream, zc):
        if cc.single_block_control_method == "overall_add":
            return stream + zc
        # single_add: image section only
        return torch.cat([stream[:, :enc_len], stream[:, enc_len:] + zc[:, enc_len:]],
                         dim=1)

    if single_ctrl and reuse:
        def single_body(stream, i):
            stream = flux_single_block(index_params(base["single_blocks"], i),
                                       stream, temb, rope_base, heads=heads)
            return single_add(stream, replayed(sgl_res, i) * scale)
    elif single_ctrl:
        cn_s_table = control_block_index_table(n_s, n_s // cc.single_control_dev)

        def single_body(stream, i):
            stream = flux_single_block(index_params(base["single_blocks"], i),
                                       stream, temb, rope_base, heads=heads)
            j = cn_s_table[i]
            cn_out = flux_single_block(index_params(ctrl["single_blocks"], j),
                                       stream, pre.block_temb, rope_single,
                                       heads=heads)
            res = linear(index_params(ctrl["add_single"], j), cn_out)
            if return_control_residuals:
                sgl_ys.append(capture(res))
            return single_add(stream, res * scale)
    else:
        def single_body(stream, i):
            return flux_single_block(index_params(base["single_blocks"], i),
                                     stream, temb, rope_base, heads=heads)

    single_body = remat_wrap(single_body, remat)
    for i in range(n_s):
        stream = single_body(stream, i)

    h = adaln_continuous(base["norm_out"], stream[:, enc_len:], temb)
    pred = linear(base["proj_out"], h)
    if reuse:
        return (pred, {"moe_loss": torch.zeros((), dtype=torch.float32,
                                               device=pred.device)},
                {"expert_counts": None})
    add_outputs = {"expert_counts": pre.expert_counts}
    if return_control_residuals:
        add_outputs["control_residuals"] = (stack_residuals(dbl_ys),
                                            stack_residuals(sgl_ys))
    return pred, {"moe_loss": pre.aux_loss * cc.moe.aux_loss_weight}, add_outputs


class UniGenFlux(nn.Module):
    """The port's entry: holds a parameter tree on one device and runs the
    forward and the flow-matching Euler denoise. ``device`` defaults to
    CUDA and must be named "cpu" to run on the CPU."""

    def __init__(self, cfg: UniGenConfig, params: dict, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.params = tree_map(lambda t: t.to(self.device), params)

    def forward(self, hidden, condition, encoder, pooled, condition_pooled,
                timestep, img_ids, txt_ids, condition_ids, guidance=None, *,
                conditioning_scale: float = 1.0):
        return unigen_flux_forward(
            self.params, self.cfg, hidden, condition, encoder, pooled,
            condition_pooled, timestep, img_ids, txt_ids, condition_ids,
            guidance, conditioning_scale=conditioning_scale)

    @torch.no_grad()
    def denoise(self, latents, condition, encoder, pooled, cond_pooled, *,
                num_steps: int = 4, latent_hw: Optional[Tuple[int, int]] = None,
                sched: scheduling.FlowMatchConfig = scheduling.FlowMatchConfig(shift=1.0)
                ) -> torch.Tensor:
        """The serving program: ``num_steps`` Euler steps of the forward on
        packed latents [B, S, C] of a latent grid ``latent_hw`` = (lh, lw)
        (S = lh/2 * lw/2; square when not given), text ids zero, condition
        ids = image ids. Inputs are cast to the model dtype on the model's
        device; the timestep is rounded to that dtype, as the reference
        denoise does."""
        dev, dt = self.device, self.dtype
        latents, condition, encoder, pooled, cond_pooled = (
            torch.as_tensor(x).to(dev, dt)
            for x in (latents, condition, encoder, pooled, cond_pooled))
        b, s = latents.shape[:2]
        if latent_hw is None:
            half = math.isqrt(s)
            latent_hw = (2 * half, 2 * half)
        lh, lw = latent_hw
        if (lh // 2) * (lw // 2) != s:
            raise ValueError(f"latent grid {lh}x{lw} does not pack to S={s} tokens; "
                             "pass latent_hw=(lh, lw)")
        img_ids = prepare_latent_image_ids(lh // 2, lw // 2, device=dev)
        txt_ids = torch.zeros(encoder.shape[-2], 3, device=dev)
        sig, _ = scheduling.inference_sigmas(sched, num_steps)
        for i in range(num_steps):
            t = torch.full((b,), float(sig[i]), dtype=dt, device=dev)
            pred, _, _ = self.forward(latents, condition, encoder, pooled,
                                      cond_pooled, t, img_ids, txt_ids, img_ids)
            latents = scheduling.euler_step(latents, pred, sig[i], sig[i + 1])
        return latents
