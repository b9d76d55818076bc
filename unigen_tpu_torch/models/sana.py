"""SANA linear-attention DiT backbone and the SANAUniGen control branch
(port of ``unigen_tpu/models/sana.py``).

The backbone: a patch embed (patch 1, no position table), AdaLayerNormSingle
time embedding, the PixArt caption projection and RMS caption norm, N blocks
of [linear self-attention -> caption cross-attention -> GLUMBConv], the
scale/shift-table output norm and unpatchify.

The control branch interleaves 1:1 by default: after base block i, control
block ``table[i]`` runs on the live base hidden with the control caption
stream and the control time projection, and its output passes a zero-init
add linear into the base stream, times the conditioning scale. The MoE
preprocess runs once, after base block 0 (modulated experts: SANA block
experts cannot take token-wise temb); the shared expert is one SANA block
over [hidden | condition] as a (2*hp) x wp grid, so its depthwise
convolution crosses the seam between the two halves, as in JAX. The second
shared block exists for checkpoint parity and is unused.

Timesteps are in the units the caller passes (the JAX pipeline and server
pass the scheduler's timesteps / 1000).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from unigen_tpu_torch.config import ControlConfig, SanaBackboneConfig, UniGenConfig
from unigen_tpu_torch.layers.blocks_sana import (adaln_single, init_adaln_single,
                                                 init_sana_block, sana_block)
from unigen_tpu_torch.layers.core import (init_linear, init_rms_norm, layer_norm,
                                          linear, rms_norm)
from unigen_tpu_torch.layers.embeddings import pixart_text_projection
from unigen_tpu_torch.models import moe as moe_lib
from unigen_tpu_torch.models.unigen_flux import control_block_index_table
from unigen_tpu_torch.ops.packing import patchify, unpatchify
from unigen_tpu_torch.ops.quant import (dequantize_residual, quantize_residual,
                                        residual_at, stack_residuals)
from unigen_tpu_torch.utils import index_params, init_stacked, tree_map


def _block_init(bb: SanaBackboneConfig, **kw):
    return lambda: init_sana_block(
        bb.inner_dim, bb.num_attention_heads, bb.attention_head_dim,
        cross_heads=bb.num_cross_attention_heads,
        cross_head_dim=bb.cross_attention_head_dim, mlp_ratio=bb.mlp_ratio, **kw)


def init_sana_params(cfg: SanaBackboneConfig, *, gen=None, device=None,
                     dtype=torch.float32) -> dict:
    d = cfg.inner_dim
    kw = dict(gen=gen, device=device, dtype=dtype)
    table = torch.empty((2, d), device=device, dtype=dtype)
    return {
        "patch_embed": init_linear(cfg.in_channels * cfg.patch_size ** 2, d, **kw),
        "time_embed": init_adaln_single(d, **kw),
        "caption_projection": {"fc1": init_linear(cfg.caption_channels, d, **kw),
                               "fc2": init_linear(d, d, **kw)},
        "caption_norm": init_rms_norm(d, device=device, dtype=dtype),
        "blocks": init_stacked(cfg.num_layers, _block_init(cfg, **kw)),
        "scale_shift_table": table.normal_(generator=gen) / d ** 0.5,
        "proj_out": init_linear(d, cfg.patch_size ** 2 * cfg.out_channels, **kw),
    }


def sana_embed_inputs(params: dict, cfg: SanaBackboneConfig, hidden, encoder,
                      timestep):
    """-> (tokens [B, S, D], caption [B, T, D], time projection [B, 6D],
    embedded time [B, D])."""
    h = linear(params["patch_embed"], patchify(hidden, cfg.patch_size))
    proj_t, embedded_t = adaln_single(params["time_embed"], timestep, dtype=h.dtype)
    enc = pixart_text_projection(params["caption_projection"], encoder)
    enc = rms_norm(params["caption_norm"], enc, eps=1e-5)
    return h, enc, proj_t, embedded_t


def _output(base: dict, cfg: SanaBackboneConfig, h, emb_t, hp: int, wp: int):
    mods = base["scale_shift_table"][None] + emb_t[:, None, :]
    shift, scale = mods[:, 0][:, None, :], mods[:, 1][:, None, :]
    h = linear(base["proj_out"], layer_norm(h) * (1 + scale) + shift)
    return unpatchify(h, hp, wp, cfg.patch_size, cfg.out_channels)


def sana_forward(params: dict, cfg: SanaBackboneConfig, hidden, encoder, timestep,
                 encoder_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """hidden [B, C, H, W], encoder [B, T, caption_channels], timestep [B]
    -> prediction [B, out_channels, H, W]."""
    hp, wp = hidden.shape[2] // cfg.patch_size, hidden.shape[3] // cfg.patch_size
    h, enc, proj_t, emb_t = sana_embed_inputs(params, cfg, hidden, encoder, timestep)
    for i in range(cfg.num_layers):
        h = sana_block(index_params(params["blocks"], i), h, enc, proj_t, hp, wp,
                       heads=cfg.num_attention_heads,
                       cross_heads=cfg.num_cross_attention_heads,
                       ctx_mask=encoder_mask)
    return _output(params, cfg, h, emb_t, hp, wp)


# ------------------------------------------------------------ SANAUniGen

def init_sana_unigen_control(cfg: UniGenConfig, *, gen=None, device=None,
                             dtype=torch.float32,
                             base_params: Optional[dict] = None) -> dict:
    """The control tree; with ``use_transformer_params`` and a base tree the
    condition patch embed, the condition time embed and the control blocks
    start as copies of the base's (the first n_cn blocks)."""
    bb: SanaBackboneConfig = cfg.sana
    cc: ControlConfig = cfg.control
    d = bb.inner_dim
    n_cn = cc.num_layers or bb.num_layers
    kw = dict(gen=gen, device=device, dtype=dtype)
    blk = _block_init(bb, **kw)
    p: Dict[str, Any] = {
        "pos_embed_input": init_linear(bb.in_channels * bb.patch_size ** 2, d, **kw),
        "condition_embed": init_adaln_single(d, **kw),
        "context_embedder": init_linear(d, d, **kw),
        "blocks": init_stacked(n_cn, blk),
        "add_blocks": init_stacked(n_cn, lambda: init_linear(d, d, zero=True, **kw)),
        "moe": moe_lib.init_moe_params(d, bb.pooled_projection_dim,
                                       cc.moe.num_experts(cfg.condition_nums),
                                       modulated=True, **kw),
    }
    if cc.use_shared_expert:
        p["shared_expert"] = {"block0": blk(), "block1": blk()}
    if cc.use_transformer_params and base_params is not None:
        p["pos_embed_input"] = tree_map(torch.clone, base_params["patch_embed"])
        p["condition_embed"] = tree_map(torch.clone, base_params["time_embed"])
        p["blocks"] = tree_map(lambda x: x[:n_cn].clone(), base_params["blocks"])
    return p


def init_sana_unigen_params(cfg: UniGenConfig, *, gen=None, device=None,
                            dtype=torch.float32) -> dict:
    base = init_sana_params(cfg.sana, gen=gen, device=device, dtype=dtype)
    return {"base": base,
            "control": init_sana_unigen_control(cfg, gen=gen, device=device,
                                                dtype=dtype, base_params=base)}


class SanaPreprocess(NamedTuple):
    moe_hidden: torch.Tensor
    control_enc: torch.Tensor
    cond_temb: torch.Tensor
    aux_loss: torch.Tensor
    expert_counts: torch.Tensor


def _n_control(ctrl: dict) -> int:
    """The control depth from the add-linear stack in any weight form (fp
    ``w``, or the quantized ``w_q`` / ``w_q4``: the stack axis leads)."""
    ab = ctrl["add_blocks"]
    return next(ab[k] for k in ("w", "w_q", "w_q4") if k in ab).shape[0]


def _preprocess(ctrl: dict, cfg: UniGenConfig, h, enc, condition, pooled,
                condition_pooled, timestep, encoder_mask, hp: int, wp: int, *,
                training: bool):
    bb, cc = cfg.sana, cfg.control
    cond_tokens = linear(ctrl["pos_embed_input"], patchify(condition, bb.patch_size))
    cond_proj_t, _ = adaln_single(ctrl["condition_embed"], timestep, dtype=h.dtype)
    control_enc = linear(ctrl["context_embedder"], enc)
    streams = {"temb": cond_proj_t, "condition_temb": cond_proj_t,
               "pooled": pooled, "condition_pooled": condition_pooled}
    out = moe_lib.moe_apply(ctrl["moe"], cc, cc.moe.num_experts(cfg.condition_nums),
                            h, cond_tokens, streams, training=training)
    exp_h, exp_c = out.expert_hidden, out.expert_condition
    if "shared_expert" in ctrl:
        hc = torch.cat([h, cond_tokens], dim=1)
        hc = sana_block(ctrl["shared_expert"]["block0"], hc, control_enc, cond_proj_t,
                        2 * hp, wp, heads=bb.num_attention_heads,
                        cross_heads=bb.num_cross_attention_heads,
                        ctx_mask=encoder_mask)
        s = h.shape[1]
        exp_h = hc[:, :s] + exp_h
        exp_c = hc[:, s:] + exp_c
    return SanaPreprocess(exp_h + exp_c, control_enc, cond_proj_t, out.aux_loss,
                          out.expert_counts)


def sana_unigen_forward(params: dict, cfg: UniGenConfig, hidden, condition, encoder,
                        pooled, condition_pooled, timestep,
                        encoder_mask: Optional[torch.Tensor] = None, *,
                        conditioning_scale=1.0, training: bool = False,
                        control_residuals=None,
                        return_control_residuals: bool = False,
                        control_residuals_bits: int = 16):
    """hidden and condition [B, C, H, W], encoder [B, T, caption_channels],
    pooled / condition_pooled [B, pooled_projection_dim], timestep [B],
    encoder_mask [B, T] -> (pred [B, out_channels, H, W], add_losses,
    add_outputs).

    Control-residual step caching: the cache is each base block's raw
    control block output (before the add linear, unscaled), stacked
    [n_base, B, S, D]; ``return_control_residuals`` captures it (quantized
    per block when ``control_residuals_bits`` < 16), ``control_residuals``
    replays it, skipping the MoE preprocess and every control block but not
    the add linears. A replay at the capture's state gives the plain
    forward's bits."""
    reuse = control_residuals is not None
    if reuse and return_control_residuals:
        raise ValueError("pass either control_residuals or "
                         "return_control_residuals, not both")
    if control_residuals_bits not in (4, 8, 16):
        raise ValueError(f"control_residuals_bits must be 4, 8 or 16, "
                         f"got {control_residuals_bits}")
    base, ctrl = params["base"], params["control"]
    bb = cfg.sana
    # an fp32 scale must not promote the bf16 residual stream
    scale = torch.as_tensor(conditioning_scale, dtype=hidden.dtype, device=hidden.device)
    hp, wp = hidden.shape[2] // bb.patch_size, hidden.shape[3] // bb.patch_size
    heads, xheads = bb.num_attention_heads, bb.num_cross_attention_heads
    table = control_block_index_table(bb.num_layers, _n_control(ctrl))

    h, enc, proj_t, emb_t = sana_embed_inputs(base, bb, hidden, encoder, timestep)
    pre, cn_ys = None, []
    for i in range(bb.num_layers):
        h = sana_block(index_params(base["blocks"], i), h, enc, proj_t, hp, wp,
                       heads=heads, cross_heads=xheads, ctx_mask=encoder_mask)
        if reuse:
            cn_out = residual_at(control_residuals, i)
            if isinstance(cn_out, dict):
                cn_out = dequantize_residual(cn_out, hidden.dtype)
        else:
            if pre is None:
                pre = _preprocess(ctrl, cfg, h, enc, condition, pooled,
                                  condition_pooled, timestep, encoder_mask, hp,
                                  wp, training=training)
                cn_in = pre.moe_hidden
            else:
                cn_in = h
            cn_out = sana_block(index_params(ctrl["blocks"], table[i]), cn_in,
                                pre.control_enc, pre.cond_temb, hp, wp, heads=heads,
                                cross_heads=xheads, ctx_mask=encoder_mask)
            if return_control_residuals:
                cn_ys.append(cn_out if control_residuals_bits == 16 else
                             quantize_residual(cn_out, control_residuals_bits))
        h = h + linear(index_params(ctrl["add_blocks"], table[i]), cn_out) * scale

    out = _output(base, bb, h, emb_t, hp, wp)
    if reuse:
        return (out, {"moe_loss": torch.zeros((), dtype=torch.float32,
                                              device=out.device)},
                {"expert_counts": None})
    add_outputs = {"expert_counts": pre.expert_counts}
    if return_control_residuals:
        add_outputs["control_residuals"] = stack_residuals(cn_ys)
    return (out, {"moe_loss": pre.aux_loss * cfg.control.moe.aux_loss_weight},
            add_outputs)
