"""GShard top-1 gating with a static capacity, and the gather-based
dispatch/combine (port of ``unigen_tpu/ops/gating.py``, the top-1 serving
path; top-2 and random token selection wait for a later slice).

Capacity keeps the first ``capacity`` tokens per expert in token order;
dropped tokens combine to zeros. Every [B, S, C'] stream is routed by the
same slots; [B, C'] streams are broadcast per token first; streams with
another sequence length pass through.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F


class GateOutput(NamedTuple):
    combine_weights: torch.Tensor  # [S, E, C] float
    dispatch_mask: torch.Tensor    # [S, E, C] bool
    aux_loss: torch.Tensor         # scalar
    expert_counts: torch.Tensor    # [E] int32 (pre-capacity counts)
    expert_idx: torch.Tensor       # [S] int32 chosen expert
    slot: torch.Tensor             # [S] int32 slot within expert
    gate_scalar: torch.Tensor      # [S] fp32 gate prob (0 if dropped)
    kept: torch.Tensor             # [S] fp32 in {0, 1}


def compute_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                     min_capacity: int) -> int:
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)


def top1_gate(logits: torch.Tensor, capacity: int, *,
              used_token: Optional[torch.Tensor] = None) -> GateOutput:
    """Top-1 gate over logits [S, E] with token-order capacity drops."""
    e = logits.shape[1]
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx, e).to(torch.float32)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None]

    expert_counts = mask1.sum(dim=0).to(torch.int32)
    aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * e

    positions = torch.cumsum(mask1, dim=0) - mask1       # 0-based slot per expert
    keep = mask1 * (positions < capacity).to(torch.float32)
    locations = torch.cumsum(keep, dim=0) - keep
    loc_s = (locations * keep).sum(dim=-1).to(torch.int32)
    gate_s = (gates * keep).sum(dim=-1)
    kept_any = keep.sum(dim=-1)

    loc_onehot = F.one_hot(loc_s.long(), capacity).to(torch.float32) * kept_any[:, None]
    combine = gate_s[:, None, None] * keep[:, :, None] * loc_onehot[:, None, :]
    return GateOutput(combine, combine > 0, aux, expert_counts,
                      idx.to(torch.int32), loc_s, gate_s * kept_any, kept_any)


def dispatch_slots(gate: GateOutput, capacity: int, num_experts: int):
    """-> (slot_token [E*C] with S as the empty-slot sentinel, dest [S] flat
    slot id, E*C for dropped tokens)."""
    s = gate.expert_idx.shape[0]
    trash = num_experts * capacity
    dest = torch.where(gate.kept > 0,
                       gate.expert_idx.long() * capacity + gate.slot.long(),
                       torch.full_like(gate.expert_idx, trash, dtype=torch.long))
    slot_token = torch.full((trash + 1,), s, dtype=torch.long,
                            device=dest.device)
    slot_token[dest] = torch.arange(s, device=dest.device)
    return slot_token[:trash], dest


def dispatch_gather(slot_token: torch.Tensor, tokens: torch.Tensor,
                    capacity: int, num_experts: int) -> torch.Tensor:
    """[E*C] x [S, M] -> [E, C, M]; empty slots read a zero row."""
    pad = torch.cat([tokens, tokens.new_zeros(1, tokens.shape[-1])])
    return pad[slot_token].reshape(num_experts, capacity, tokens.shape[-1])


def combine_gather(gate: GateOutput, dest: torch.Tensor,
                   expert_out: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """[S] x [E, C, M] -> [S, M]: gate_prob[s] * expert_out[dest[s]];
    dropped tokens read the zero pad row."""
    e, c, m = expert_out.shape
    pad = torch.cat([expert_out.reshape(e * c, m), expert_out.new_zeros(1, m)])
    out = pad[dest] * gate.gate_scalar[:, None].to(expert_out.dtype)
    return out.to(out_dtype) if out_dtype is not None else out


def dispatch_streams_gather(gate: GateOutput, capacity: int, num_experts: int,
                            seq_len: int, streams: Dict[str, Any]):
    """Route every compatible stream by the gate's slots; also returns
    ``dest`` for ``combine_gather``."""
    slot_token, dest = dispatch_slots(gate, capacity, num_experts)
    out = {}
    for name, v in streams.items():
        if not isinstance(v, torch.Tensor):
            out[name] = v
        elif v.dim() == 2:        # [B, C'] -> broadcast per token
            b, c = v.shape
            vv = v[:, None, :].expand(b, seq_len, c).reshape(-1, c)
            out[name] = dispatch_gather(slot_token, vv, capacity, num_experts)
        elif v.dim() == 3:
            out[name] = v if v.shape[1] != seq_len else dispatch_gather(
                slot_token, v.reshape(-1, v.shape[-1]), capacity, num_experts)
        else:
            raise ValueError(f"MoE dispatch got bad stream {name}: {tuple(v.shape)}")
    return out, dest
