"""GShard top-k gating with a static capacity, and the multi-stream dispatch
and combine (port of ``unigen_tpu/ops/gating.py``).

  * ``top1_gate``: capacity keeps the first ``capacity`` tokens per expert
    in token order, or, with random token selection (``use_rts``, the
    reference's training gate), the tokens of highest uniform priority;
    dropped tokens combine to zeros.
  * ``top2_gate``: GShard's second choice, with DeepSpeed's offset of the
    second choice's slots by the first choice's pre-capacity count.
  * the gather dispatch (``dispatch_streams_gather``/``combine_gather``,
    top-1) moves rows; the dense one (``dispatch_streams``/``combine``)
    contracts the [S, E, C] masks with ``torch.einsum``, as XLA computes
    it outside any Pallas kernel.

Every [B, S, C'] stream is routed by the same slots; [B, C'] streams are
broadcast per token first; streams with another sequence length pass
through. The random token selection's draw is an input (``uniform``), so
that a caller can feed the JAX package's own draw.
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
    # token-level routing of top-1 (None from top2_gate), for the gather path
    expert_idx: Optional[torch.Tensor] = None   # [S] int32 chosen expert
    slot: Optional[torch.Tensor] = None         # [S] int32 slot within expert
    gate_scalar: Optional[torch.Tensor] = None  # [S] fp32 gate prob (0 if dropped)
    kept: Optional[torch.Tensor] = None         # [S] fp32 in {0, 1}


def compute_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                     min_capacity: int) -> int:
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)


def top1_gate(logits: torch.Tensor, capacity: int, *,
              used_token: Optional[torch.Tensor] = None,
              uniform: Optional[torch.Tensor] = None,
              use_rts: bool = False) -> GateOutput:
    """Top-1 gate over logits [S, E]. Capacity keeps the first ``capacity``
    tokens per expert in token order, or with ``use_rts`` and a ``uniform``
    draw [S, E] in [0, 1) those of the highest priority ``mask * uniform``
    (random token selection); ties keep token order, as JAX's stable
    argsort does."""
    e = logits.shape[1]
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    idx = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx, e).to(torch.float32)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None]

    expert_counts = mask1.sum(dim=0).to(torch.int32)
    aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * e

    if use_rts and uniform is not None:
        priority = mask1 * uniform.to(torch.float32)
        order = torch.argsort(-priority, dim=0, stable=True)   # [S, E]
        ranks = torch.argsort(order, dim=0, stable=True)       # rank of each token
        keep = (ranks < capacity).to(torch.float32) * mask1
    else:
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


def top2_gate(logits: torch.Tensor, capacity: int) -> GateOutput:
    """Top-2 gate (GShard) over logits [S, E]: the second expert is the
    best of the rest (the JAX function's Gumbel-sampled second choice is
    an option no caller sets); the two kept gate values are renormalised.
    The second choice's slots start after the expert's pre-capacity top-1
    count (DeepSpeed), so an expert whose top-1 demand fills it admits no
    second choices."""
    e = logits.shape[1]
    logits = logits.to(torch.float32)
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, e).to(torch.float32)
    idx2 = torch.argmax(torch.where(mask1 > 0, torch.full_like(logits, -math.inf), logits),
                        dim=-1)
    mask2 = F.one_hot(idx2, e).to(torch.float32)

    aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * e

    pos1 = torch.cumsum(mask1, dim=0) - mask1
    keep1 = mask1 * (pos1 < capacity).to(torch.float32)
    pos2 = torch.cumsum(mask2, dim=0) - mask2 + mask1.sum(dim=0, keepdim=True)
    keep2 = mask2 * (pos2 < capacity).to(torch.float32)

    g1 = (gates * keep1).sum(dim=-1)
    g2 = (gates * keep2).sum(dim=-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom

    def part(g, keep, pos):
        loc = (pos * keep).sum(dim=-1).long()
        return (g[:, None, None] * keep[:, :, None]
                * F.one_hot(loc, capacity).to(torch.float32)[:, None, :]
                * keep.sum(dim=-1)[:, None, None])
    combine = part(g1, keep1, pos1) + part(g2, keep2, pos2)
    counts = (mask1 + mask2).sum(dim=0).to(torch.int32)
    return GateOutput(combine, combine > 0, aux, counts)


def dispatch(mask: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """[S, E, C] x [S, M] -> [E, C, M]."""
    return torch.einsum("sec,sm->ecm", mask.to(tokens.dtype), tokens)


def combine(weights: torch.Tensor, expert_out: torch.Tensor,
            out_dtype=None) -> torch.Tensor:
    """[S, E, C] x [E, C, M] -> [S, M]."""
    out = torch.einsum("sec,ecm->sm", weights.to(expert_out.dtype), expert_out)
    return out.to(out_dtype) if out_dtype is not None else out


def _route(streams: Dict[str, Any], seq_len: int, move) -> Dict[str, Any]:
    """The streams contract: ``move`` each [S_tok, M] view of a [B, C']
    (broadcast per token) or [B, seq_len, C'] stream; anything else passes
    through."""
    out = {}
    for name, v in streams.items():
        if not isinstance(v, torch.Tensor):
            out[name] = v
        elif v.dim() == 2:        # [B, C'] -> broadcast per token
            b, c = v.shape
            out[name] = move(v[:, None, :].expand(b, seq_len, c).reshape(-1, c))
        elif v.dim() == 3:
            out[name] = v if v.shape[1] != seq_len else move(v.reshape(-1, v.shape[-1]))
        else:
            raise ValueError(f"MoE dispatch got bad stream {name}: {tuple(v.shape)}")
    return out


def dispatch_streams(dispatch_mask: torch.Tensor, seq_len: int,
                     streams: Dict[str, Any]) -> Dict[str, Any]:
    """Route every compatible stream by one dense mask [B * seq_len, E, C]
    -> {name: [E, C, M] or the passthrough}."""
    return _route(streams, seq_len, lambda t: dispatch(dispatch_mask, t))


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
    out = _route(streams, seq_len,
                 lambda t: dispatch_gather(slot_token, t, capacity, num_experts))
    return out, dest
