"""Checkpoint bridge for the SD3 / SD3.5 and SANA transformers and their
UniGen adapters (port of ``unigen_tpu/io/torch_bridge_sd3.py``; the same
conventions as ``io/torch_bridge``).
"""

from __future__ import annotations

from typing import Optional

import torch

from unigen_tpu_torch.config import SanaBackboneConfig, SD3BackboneConfig
from unigen_tpu_torch.io.torch_bridge import (_gate_prefix, _lin, _modulated_experts,
                                              _Put, _rms, _stack)
from unigen_tpu_torch.utils import resolve_device


def _conv1x1_lin(sd, name, put: _Put, *, bias: bool = True):
    """A 1x1 Conv2d read as a linear: [out, in, 1, 1] (or [out, in]) ->
    {"w": [in, out]}."""
    w = sd[f"{name}.weight"]
    if w.dim() == 4:
        if tuple(w.shape[-2:]) != (1, 1):
            raise ValueError(f"{name}: not a 1x1 conv {tuple(w.shape)}")
        w = w[:, :, 0, 0]
    p = {"w": put(w, perm=(1, 0))}
    if bias and f"{name}.bias" in sd:
        p["b"] = put(sd[f"{name}.bias"])
    return p


def _patch_proj(sd, name, put: _Put, inner_dim: int):
    """A PatchEmbed's Conv2d [D, C, p, p] -> the patchify linear [C*p*p, D]."""
    return {"w": put(sd[f"{name}.weight"].reshape(inner_dim, -1), perm=(1, 0)),
            "b": put(sd[f"{name}.bias"])}


def _sd3_attn(sd, p, put, *, context: bool, context_pre_only: bool = False,
              qk_norm: Optional[str] = None):
    a = {"to_q": _lin(sd, f"{p}.to_q", put), "to_k": _lin(sd, f"{p}.to_k", put),
         "to_v": _lin(sd, f"{p}.to_v", put), "to_out": _lin(sd, f"{p}.to_out.0", put)}
    if qk_norm and f"{p}.norm_q.weight" in sd:
        a["norm_q"] = _rms(sd, f"{p}.norm_q", put)
        a["norm_k"] = _rms(sd, f"{p}.norm_k", put)
    if context:
        a.update({"add_q": _lin(sd, f"{p}.add_q_proj", put),
                  "add_k": _lin(sd, f"{p}.add_k_proj", put),
                  "add_v": _lin(sd, f"{p}.add_v_proj", put)})
        if qk_norm and f"{p}.norm_added_q.weight" in sd:
            a["norm_added_q"] = _rms(sd, f"{p}.norm_added_q", put)
            a["norm_added_k"] = _rms(sd, f"{p}.norm_added_k", put)
        if not context_pre_only:
            a["to_add_out"] = _lin(sd, f"{p}.to_add_out", put)
    return a


def _sd3_block(sd, p, put, *, dual: bool, last: bool, qk_norm):
    out = {
        "norm1": {"linear": _lin(sd, f"{p}.norm1.linear", put)},
        "norm1_context": {"linear": _lin(sd, f"{p}.norm1_context.linear", put)},
        "attn": _sd3_attn(sd, f"{p}.attn", put, context=True, context_pre_only=last,
                          qk_norm=qk_norm),
        "ff": {"fc1": _lin(sd, f"{p}.ff.net.0.proj", put),
               "fc2": _lin(sd, f"{p}.ff.net.2", put)},
    }
    if not last:
        out["ff_context"] = {"fc1": _lin(sd, f"{p}.ff_context.net.0.proj", put),
                             "fc2": _lin(sd, f"{p}.ff_context.net.2", put)}
    if dual:
        out["attn2"] = _sd3_attn(sd, f"{p}.attn2", put, context=False, qk_norm=qk_norm)
    return out


def _time_text(sd, p, put):
    return {"timestep": {"fc1": _lin(sd, f"{p}.timestep_embedder.linear_1", put),
                         "fc2": _lin(sd, f"{p}.timestep_embedder.linear_2", put)},
            "text": {"fc1": _lin(sd, f"{p}.text_embedder.linear_1", put),
                     "fc2": _lin(sd, f"{p}.text_embedder.linear_2", put)}}


def load_sd3_transformer(sd, cfg: SD3BackboneConfig, *, dtype=torch.bfloat16,
                         device=None) -> dict:
    """diffusers SD3Transformer2DModel state dict -> the models/sd3 tree (dual
    blocks and the other non-last blocks stacked apart, the last block on
    its own; the position table fp32)."""
    put = _Put(resolve_device(device), dtype)
    dual = set(cfg.dual_attention_layers)
    n = cfg.num_layers

    def block(i):
        return _sd3_block(sd, f"transformer_blocks.{i}", put, dual=i in dual,
                          last=i == n - 1, qk_norm=cfg.qk_norm)
    dual_idx = [i for i in range(n) if i in dual]
    plain_idx = [i for i in range(n) if i not in dual]
    p = {
        "pos_embed": {"proj": _patch_proj(sd, "pos_embed.proj", put, cfg.inner_dim),
                      "pos_embed": put(sd["pos_embed.pos_embed"][0], torch.float32)},
        "time_text_embed": _time_text(sd, "time_text_embed", put),
        "context_embedder": _lin(sd, "context_embedder", put),
        "last_block": block(n - 1),
        "norm_out": {"linear": _lin(sd, "norm_out.linear", put)},
        "proj_out": _lin(sd, "proj_out", put),
    }
    if dual_idx:
        p["dual_blocks"] = _stack(len(dual_idx), lambda j: block(dual_idx[j]))
    if len(plain_idx) > 1:
        p["plain_blocks"] = _stack(len(plain_idx) - 1, lambda j: block(plain_idx[j]))
    return p


def load_sd3_unigen_adapter(sd, cfg: SD3BackboneConfig, n_cn: int, num_experts: int,
                            *, dtype=torch.bfloat16, modulated: bool = False,
                            device=None) -> dict:
    """The reference UniGenSD3 trainable_control_modules state dict (names
    rooted at control_* / moe / shared_expert) -> the control tree; the
    block experts are pairs of SD3 single blocks unless ``modulated``."""
    put = _Put(resolve_device(device), dtype)
    d = cfg.inner_dim
    ctrl = {
        "pos_embed_input": {"proj": _patch_proj(sd, "control_pos_embed_input.proj",
                                                put, d)},
        "time_text_embed": _time_text(sd, "control_time_text_embed", put),
        "condition_embed": _time_text(sd, "control_condition_embed", put),
        "context_embedder": _lin(sd, "control_context_embedder", put),
        "joint_blocks": _stack(n_cn, lambda i: _sd3_block(
            sd, f"control_transformer_blocks.{i}", put, dual=False, last=False,
            qk_norm=cfg.qk_norm)),
        "add_blocks": _stack(n_cn, lambda i: _lin(sd, f"controlnet_add_blocks.{i}", put)),
    }
    if "control_pos_embed_input.pos_embed" in sd:
        ctrl["pos_embed_input"]["pos_embed"] = put(
            sd["control_pos_embed_input.pos_embed"][0], torch.float32)
    if "control_pos_embed.proj.weight" in sd:
        # use_pos_embed=True: a trainable target-stream PatchEmbed
        ctrl["pos_embed"] = {"proj": _patch_proj(sd, "control_pos_embed.proj", put, d)}
        if "control_pos_embed.pos_embed" in sd:
            ctrl["pos_embed"]["pos_embed"] = put(sd["control_pos_embed.pos_embed"][0],
                                                 torch.float32)

    prefix = _gate_prefix(sd)
    moe = {"gate": {"w": put(sd[prefix + "gate.wg.weight"], torch.float32, (1, 0))}}
    if modulated:
        moe["experts"] = _modulated_experts(sd, prefix, put, num_experts)
    else:
        def single_block(name):
            return {"norm1": {"linear": _lin(sd, f"{name}.norm1.linear", put)},
                    "attn": _sd3_attn(sd, f"{name}.attn", put, context=False,
                                      qk_norm=cfg.qk_norm),
                    "ff": {"fc1": _lin(sd, f"{name}.ff.net.0.proj", put),
                           "fc2": _lin(sd, f"{name}.ff.net.2", put)}}
        moe["experts"] = {
            "hid_block": _stack(num_experts, lambda e: single_block(
                f"{prefix}experts.deepspeed_experts.{e}.0")),
            "cond_block": _stack(num_experts, lambda e: single_block(
                f"{prefix}experts.deepspeed_experts.{e}.1")),
        }
    ctrl["moe"] = moe
    if "shared_expert.0.norm1.linear.weight" in sd:
        ctrl["shared_expert"] = {
            "weave_cond": _sd3_block(sd, "shared_expert.0", put, dual=False, last=False,
                                     qk_norm=cfg.qk_norm),
            "weave_text": _sd3_block(sd, "shared_expert.1", put, dual=True, last=True,
                                     qk_norm=cfg.qk_norm),
        }
    return ctrl


# ------------------------------------------------------------ SANA

def _sana_block(sd, p, put):
    """A diffusers SanaTransformerBlock: the GLUMBConv's 1x1 convs read as
    linears, its depthwise [2H, 1, 3, 3] kernel as HWIO [3, 3, 1, 2H]."""
    return {
        "scale_shift_table": put(sd[f"{p}.scale_shift_table"]),
        "attn1": {"to_q": _lin(sd, f"{p}.attn1.to_q", put),
                  "to_k": _lin(sd, f"{p}.attn1.to_k", put),
                  "to_v": _lin(sd, f"{p}.attn1.to_v", put),
                  "to_out": _lin(sd, f"{p}.attn1.to_out.0", put)},
        "attn2": {"to_q": _lin(sd, f"{p}.attn2.to_q", put),
                  "to_k": _lin(sd, f"{p}.attn2.to_k", put),
                  "to_v": _lin(sd, f"{p}.attn2.to_v", put),
                  "to_out": _lin(sd, f"{p}.attn2.to_out.0", put)},
        "ff": {"inverted": _conv1x1_lin(sd, f"{p}.ff.conv_inverted", put),
               "depth": {"w": put(sd[f"{p}.ff.conv_depth.weight"], perm=(2, 3, 1, 0)),
                         "b": put(sd[f"{p}.ff.conv_depth.bias"])},
               "point": _conv1x1_lin(sd, f"{p}.ff.conv_point", put, bias=False)},
    }


def _adaln_single(sd, p, put):
    return {"timestep": {"fc1": _lin(sd, f"{p}.emb.timestep_embedder.linear_1", put),
                         "fc2": _lin(sd, f"{p}.emb.timestep_embedder.linear_2", put)},
            "linear": _lin(sd, f"{p}.linear", put)}


def load_sana_transformer(sd, cfg: SanaBackboneConfig, *, dtype=torch.bfloat16,
                          device=None) -> dict:
    """diffusers SanaTransformer2DModel state dict -> the models/sana tree."""
    put = _Put(resolve_device(device), dtype)
    return {
        "patch_embed": _patch_proj(sd, "patch_embed.proj", put, cfg.inner_dim),
        "time_embed": _adaln_single(sd, "time_embed", put),
        "caption_projection": {"fc1": _lin(sd, "caption_projection.linear_1", put),
                               "fc2": _lin(sd, "caption_projection.linear_2", put)},
        "caption_norm": _rms(sd, "caption_norm", put),
        "blocks": _stack(cfg.num_layers,
                         lambda i: _sana_block(sd, f"transformer_blocks.{i}", put)),
        "scale_shift_table": put(sd["scale_shift_table"]),
        "proj_out": _lin(sd, "proj_out", put),
    }


def load_sana_unigen_adapter(sd, cfg: SanaBackboneConfig, n_cn: int, num_experts: int,
                             *, dtype=torch.bfloat16, device=None) -> dict:
    """The reference SANAUniGen trainable_control_modules state dict (names
    rooted at control_* / moe / shared_expert) -> the control tree; the
    modulated experts where the checkpoint has them."""
    put = _Put(resolve_device(device), dtype)
    ctrl = {
        "pos_embed_input": _patch_proj(sd, "control_pos_embed_input.proj", put,
                                       cfg.inner_dim),
        "condition_embed": _adaln_single(sd, "control_condition_embed", put),
        "context_embedder": _lin(sd, "control_context_embedder", put),
        "blocks": _stack(n_cn, lambda i: _sana_block(
            sd, f"control_transformer_blocks.{i}", put)),
        "add_blocks": _stack(n_cn, lambda i: _lin(sd, f"controlnet_add_blocks.{i}", put)),
    }
    prefix = _gate_prefix(sd)
    moe = {"gate": {"w": put(sd[prefix + "gate.wg.weight"], torch.float32, (1, 0))}}
    if f"{prefix}experts.deepspeed_experts.0.0.0.weight" in sd:
        moe["experts"] = _modulated_experts(sd, prefix, put, num_experts)
    ctrl["moe"] = moe
    if "shared_expert.0.scale_shift_table" in sd:
        ctrl["shared_expert"] = {"block0": _sana_block(sd, "shared_expert.0", put),
                                 "block1": _sana_block(sd, "shared_expert.1", put)}
    return ctrl
