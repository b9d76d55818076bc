"""Condition-expert MoE (port of ``unigen_tpu/models/moe.py``).

A GShard router on (hidden + condition) routes every stream with one set of
slots: top-1 with the gather dispatch (``fast_dispatch``, the serving path),
or top-1/top-2 with the dense einsum dispatch. Each expert is either a pair
of modulated linears computed as batched matmuls over the expert axis
(``use_rope or use_modulate``), or a pair of single transformer blocks with
token-wise temb (the reference's shipped control config, ``use_rope =
use_modulate = False``: FLUX single blocks or SD3 ones, by the caller's
``block_apply``): the JAX ``vmap`` over the expert axis becomes a loop over
the experts, one block call per expert and stream, each on [1, capacity]
tokens. ``batch_mode="per_sample"`` routes each sample with its own
capacity (the JAX ``vmap`` over samples becomes a loop over the batch);
``"global"`` routes all B*S tokens with one capacity ceil(B*S/E), so a
sample's output depends on its batch mates, as in JAX. ``training`` routes
with ``capacity_factor`` instead of ``eval_capacity_factor`` and, under
``use_rts`` with top-1, keeps the tokens of highest priority under the
uniform draw ``rts_uniform`` (the reference's gate): [S, E] over one
routing group's S tokens, shared by every sample of per-sample routing and
every condition, as the JAX package's one key is.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from unigen_tpu_torch.config import ControlConfig
from unigen_tpu_torch.layers.core import init_linear
from unigen_tpu_torch.ops import gating
from unigen_tpu_torch.ops.modulation import batched_modulated_linear
from unigen_tpu_torch.utils import index_params, init_stacked, promote


class MoEOutput(NamedTuple):
    expert_hidden: torch.Tensor      # [B, S, D]
    expert_condition: torch.Tensor   # [B, S, D]
    aux_loss: torch.Tensor           # scalar
    expert_counts: torch.Tensor      # [E]


def init_moe_params(dim: int, pooled_dim: int, num_experts: int, *,
                    modulated: bool = True,
                    expert_block_init: Optional[Callable[[], dict]] = None,
                    gen=None, device=None, dtype=torch.float32) -> dict:
    """modulated=True: each expert is two [Linear(d, d), Linear(pooled, d)]
    pairs. Otherwise each expert is a pair of single transformer blocks
    built by ``expert_block_init``. The router gate stays fp32."""
    kw = dict(gen=gen, device=device, dtype=dtype)
    p = {"gate": init_linear(dim, num_experts, bias=False, gen=gen,
                             device=device, dtype=torch.float32)}
    if modulated:
        def stack_lin(i, o):
            return init_stacked(num_experts, lambda: init_linear(i, o, **kw))
        p["experts"] = {"cond_mod": stack_lin(dim, dim),
                        "cond_pool": stack_lin(pooled_dim, dim),
                        "hid_mod": stack_lin(dim, dim),
                        "hid_pool": stack_lin(pooled_dim, dim)}
    else:
        assert expert_block_init is not None
        p["experts"] = {"hid_block": init_stacked(num_experts, expert_block_init),
                        "cond_block": init_stacked(num_experts, expert_block_init)}
    return p


def _expert_compute_modulated(experts: dict, routed: Dict[str, torch.Tensor]):
    """cond'   = W_c (.) Lc(cond_pooled) @ cond + b_c
       hidden' = W_h (.) Lh(pooled) @ (hidden + cond') + b_h
    on dispatched [E, C, *] inputs."""
    s_c = (torch.bmm(*promote(routed["condition_pooled"], experts["cond_pool"]["w"]))
           + experts["cond_pool"]["b"][:, None, :])
    cond_out = batched_modulated_linear(routed["condition"],
                                        experts["cond_mod"]["w"], s_c,
                                        experts["cond_mod"]["b"])
    s_h = (torch.bmm(*promote(routed["pooled"], experts["hid_pool"]["w"]))
           + experts["hid_pool"]["b"][:, None, :])
    hid_out = batched_modulated_linear(routed["hidden"] + cond_out,
                                       experts["hid_mod"]["w"], s_h,
                                       experts["hid_mod"]["b"])
    return hid_out, cond_out


def _expert_compute_blocks(experts: dict, routed: Dict[str, torch.Tensor], *,
                           block_apply: Callable, heads: int):
    """Per-expert single-transformer-block experts on dispatched [E, C, *]
    inputs, with the token-wise temb [E, C, D] of each stream."""
    hid, cond = [], []
    for e in range(routed["hidden"].shape[0]):
        hid.append(block_apply(index_params(experts["hid_block"], e),
                               routed["hidden"][e:e + 1],
                               routed["temb"][e:e + 1], heads=heads))
        cond.append(block_apply(index_params(experts["cond_block"], e),
                                routed["condition"][e:e + 1],
                                routed["condition_temb"][e:e + 1], heads=heads))
    return torch.cat(hid), torch.cat(cond)


def rts_tokens(cfg: ControlConfig, batch: int, seq_len: int) -> int:
    """Rows of the random token selection draw: the tokens of one routing
    group (a sample under per-sample routing, the batch under global)."""
    return seq_len if cfg.moe.batch_mode == "per_sample" else batch * seq_len


def moe_apply(params: dict, cfg: ControlConfig, num_experts: int,
              hidden: torch.Tensor, condition: torch.Tensor,
              streams: Dict[str, torch.Tensor], *,
              block_apply: Optional[Callable] = None,
              heads: Optional[int] = None,
              training: bool = False,
              rts_uniform: Optional[torch.Tensor] = None) -> MoEOutput:
    """Route on (hidden + condition), dispatch all streams, run the experts,
    combine. ``streams`` holds condition_pooled/pooled and the temb streams,
    which are routed alongside; block experts (``block_apply``, ``heads``)
    read the routed temb and condition_temb. Training top-1 under
    ``use_rts`` needs ``rts_uniform`` [rts_tokens, E]."""
    rts = training and cfg.moe.use_rts and cfg.moe.top_k == 1
    if rts and rts_uniform is None:
        raise ValueError("random token selection (use_rts in training) needs the "
                         "uniform draw rts_uniform")
    b, s, d = hidden.shape
    if cfg.moe.batch_mode == "per_sample" and b > 1:
        outs = [moe_apply(params, cfg, num_experts, hidden[i:i + 1],
                          condition[i:i + 1],
                          {k: v[i:i + 1] for k, v in streams.items()},
                          block_apply=block_apply, heads=heads,
                          training=training, rts_uniform=rts_uniform)
                for i in range(b)]
        return MoEOutput(torch.cat([o.expert_hidden for o in outs]),
                         torch.cat([o.expert_condition for o in outs]),
                         torch.stack([o.aux_loss for o in outs]).mean(),
                         torch.stack([o.expert_counts for o in outs]).sum(dim=0))

    choice = (hidden + condition).reshape(-1, d)
    logits = torch.matmul(*promote(choice.to(torch.float32), params["gate"]["w"]))
    cap_factor = cfg.moe.capacity_factor if training else cfg.moe.eval_capacity_factor
    capacity = (b * s if not cfg.moe.drop_tokens else gating.compute_capacity(
        b * s, num_experts, cap_factor, cfg.moe.min_capacity))
    if cfg.moe.top_k == 2:
        gate_out = gating.top2_gate(logits, capacity)
    else:
        gate_out = gating.top1_gate(logits, capacity, uniform=rts_uniform,
                                    use_rts=rts)

    routed = {"hidden": hidden, "condition": condition, **streams}
    fast = cfg.moe.fast_dispatch and gate_out.expert_idx is not None
    if fast:
        routed, dest = gating.dispatch_streams_gather(gate_out, capacity,
                                                      num_experts, s, routed)
    else:
        routed = gating.dispatch_streams(gate_out.dispatch_mask, s, routed)
    if "cond_mod" in params["experts"]:
        hid_out, cond_out = _expert_compute_modulated(params["experts"], routed)
    else:
        hid_out, cond_out = _expert_compute_blocks(
            params["experts"], routed, block_apply=block_apply, heads=heads)
    if fast:
        out_h = gating.combine_gather(gate_out, dest, hid_out, hidden.dtype)
        out_c = gating.combine_gather(gate_out, dest, cond_out, hidden.dtype)
    else:
        out_h = gating.combine(gate_out.combine_weights, hid_out, hidden.dtype)
        out_c = gating.combine(gate_out.combine_weights, cond_out, hidden.dtype)
    return MoEOutput(out_h.reshape(b, s, d), out_c.reshape(b, s, d),
                     gate_out.aux_loss, gate_out.expert_counts)
