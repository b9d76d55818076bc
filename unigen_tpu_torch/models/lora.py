"""Per-condition LoRA experts folded into the weights (port of
``unigen_tpu/models/lora.py``).

The reference switches adapters at run time by zeroing the PEFT scaling of
the ones not selected (src/lora_switching_module.py:4-39). Here the selected
adapter's delta is folded into the frozen weights instead, W' = W + scale *
(A @ B), so a forward sees one dense (or re-quantized) weight per linear.

  init_lora_adapters(params, targets, rank, adapter_names, gen=...)
  fold_adapter(params, adapters, name, scale)   fp ``w`` leaves and quantized
                                                ``w_q``/``w_q4`` nodes alike
                                                (dequant, add, requant)
  fold_for_training(params, lora, scale)        differentiable in a/b: every
                                                targeted linear becomes a
                                                floating ``w``
  LoraSwitcher(adapters, params)                switching that always refolds
                                                from pristine copies (no drift)
  enable_lora(...)                              yields the folded tree

An adapter is ``{dotted_path: {"a": [..., in, r], "b": [..., r, out]}}``;
stacked blocks carry per-block factors. A re-quantized node is rounded as
the JAX function that makes it runs: ``fold_adapter`` runs eagerly there,
``LoraSwitcher`` folds under ``jax.jit``, where XLA fuses the dequantize-
and-add into one multiply-add and divides the scales by the fp32
reciprocal (``fold_linear_node(jit=True)``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence, Tuple, Union

import torch

from unigen_tpu_torch.ops import quant
from unigen_tpu_torch.utils import tree_leaves_with_path

_QUANT_KEYS = ("w_q", "w_q4", "w_scale")

# The default trainable surface of LoRA fine-tuning: the control branch's
# attention and feed-forward linears, and the zero-init add gates. The gates
# must be in it: the control branch reaches the output only through them, so
# at step 0 every factor inside a control block gets exactly zero gradient
# and the interior opens once the gates move. Patterns are substrings of
# dotted paths.
DEFAULT_LORA_TARGETS = (
    "control.add_double", "control.add_single",
    "control.double_blocks.attn", "control.double_blocks.ff",
    "control.single_blocks.attn", "control.single_blocks.proj_mlp",
    "control.single_blocks.proj_out",
)


def _match(names: Tuple[str, ...], patterns: Sequence[str]) -> bool:
    joined = ".".join(names)
    return any(pat in joined for pat in patterns)


def init_lora_adapters(params, targets: Sequence[str], rank: int,
                       adapter_names: Sequence[str], *, gen=None,
                       dtype=torch.float32, device=None) -> Dict[str, Dict[str, dict]]:
    """{adapter: {path: {"a": [..., in, r], "b": [..., r, out]}}} for every
    fp ``w`` leaf whose path matches a target: ``a`` gaussian over sqrt(in),
    ``b`` zero (the delta starts at 0), drawn from ``gen`` in path order."""
    leaves = sorted((names, leaf) for names, leaf in tree_leaves_with_path(params)
                    if names and names[-1] == "w" and _match(names[:-1], targets))
    adapters: Dict[str, Dict[str, dict]] = {}
    for name in adapter_names:
        adapters[name] = {}
        for names, leaf in leaves:
            *lead, in_dim, out_dim = leaf.shape
            dev = leaf.device if device is None else device
            a = torch.randn((*lead, in_dim, rank), generator=gen, dtype=dtype,
                            device=dev) / math.sqrt(in_dim)
            b = torch.zeros((*lead, rank, out_dim), dtype=dtype, device=dev)
            adapters[name][".".join(names[:-1])] = {"a": a, "b": b}
    return adapters


def _delta(ab: dict, scale: float, device) -> torch.Tensor:
    a = ab["a"].to(device, torch.float32)
    b = ab["b"].to(device, torch.float32)
    return scale * torch.matmul(a, b)


def _codes(node: dict) -> torch.Tensor:
    return node["w_q"] if "w_q" in node else quant.unpack_int4(node["w_q4"])


def _dequantized(node: dict) -> torch.Tensor:
    return _codes(node).to(torch.float32) * node["w_scale"]


def fold_linear_node(node: dict, ab: dict, scale: float = 1.0, *,
                     jit: bool = False) -> dict:
    """One LoRA delta folded into one linear: an fp ``{"w"}`` adds it in
    ``w``'s dtype; a quantized ``{"w_q" | "w_q4", "w_scale"}`` is
    dequantized, the delta added, and quantized again with fresh scales.
    ``jit`` rounds as XLA compiles the JAX function: codes x scale + delta
    as one fused multiply-add (computed in fp64, where the product is exact,
    and rounded once) and the scales by the fp32 reciprocal
    (``ops/quant._scale``); without it, as the function runs eagerly."""
    out = dict(node)
    if "w" in node:
        w = node["w"]
        out["w"] = w + _delta(ab, scale, w.device).to(w.dtype)
        return out
    if "w_q" not in node and "w_q4" not in node:
        raise ValueError(f"not a linear param dict: {sorted(node)}")
    delta = _delta(ab, scale, node["w_scale"].device)
    if jit:
        w = (_codes(node).to(torch.float64) * node["w_scale"].to(torch.float64)
             + delta.to(torch.float64)).to(torch.float32)
    else:
        w = _dequantized(node) + delta
    requant = quant.quantize_weight if "w_q" in node else quant.quantize_weight_int4
    out.update(requant(w, reciprocal=jit))
    return out


def _is_linear_node(node) -> bool:
    return isinstance(node, dict) and any(k in node for k in ("w", "w_q", "w_q4"))


def fold_adapter(params, adapters: Dict[str, Dict[str, dict]], name: str,
                 scale: float = 1.0):
    """``params`` with the named adapter folded into its linears (a new
    tree; untouched subtrees are shared)."""
    lora = adapters[name]

    def walk(node, path):
        if _is_linear_node(node):
            key = ".".join(path)
            return fold_linear_node(node, lora[key], scale) if key in lora else node
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return node

    return walk(params, ())


def fold_for_training(params, lora: Dict[str, dict], scale: float = 1.0):
    """The differentiable fold of LoRA training (the QLoRA recipe): every
    targeted linear becomes ``{"w": W_frozen + scale * (A @ B), ...}``, the
    frozen weight entering as a constant. A quantized node is dequantized
    and never re-quantized (rounding has no gradient): its ``w`` takes the
    bias's dtype, or bf16 without a bias, so it leaves the W4A8/W8A8 path
    for a plain product. Untouched subtrees are shared."""
    def fold(node, ab):
        out = {k: v for k, v in node.items() if k not in _QUANT_KEYS}
        if "w" in node:
            w, out_dtype = node["w"].to(torch.float32), node["w"].dtype
        elif "w_q" in node or "w_q4" in node:
            w = _dequantized(node)
            bias = node.get("b")
            out_dtype = bias.dtype if isinstance(bias, torch.Tensor) else torch.bfloat16
        else:
            raise ValueError(f"not a linear param dict: {sorted(node)}")
        out["w"] = (w + _delta(ab, scale, w.device)).to(out_dtype)
        return out

    folded = params
    for path, ab in lora.items():
        folded = tree_set(folded, path, fold(tree_get(folded, path), ab))
    return folded


def fold_condition_experts(params, adapters, condition_type: str, scale: float = 1.0):
    """Per-condition expert selection: the condition type names the adapter."""
    if condition_type not in adapters:
        raise KeyError(f"no LoRA adapter for condition '{condition_type}' "
                       f"(have {sorted(adapters)})")
    return fold_adapter(params, adapters, condition_type, scale)


# ------------------------------------------------------------ path utilities

def tree_get(tree, dotted: str):
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def tree_set(tree, dotted: str, value):
    """A tree with ``dotted`` replaced: the dicts along the path are
    shallow-copied, every other subtree is shared."""
    parts = dotted.split(".")

    def go(node, i):
        out = dict(node)
        out[parts[i]] = value if i == len(parts) - 1 else go(node[parts[i]], i + 1)
        return out

    return go(tree, 0)


# ------------------------------------------------------------ switching

class LoraSwitcher:
    """Run-time adapter switching over a live (possibly quantized) tree.

    A pristine copy of every linear any adapter touches is kept at
    construction; ``switch`` refolds each from it, so switching is exact
    (no fold/unfold drift in bf16, one quantization of W + delta in
    int8/int4), nodes the new adapter does not touch go back to pristine,
    and untouched subtrees are shared. Shapes and dtypes never change.
    ``pristine="device"`` holds references to the original tensors;
    ``"host"`` keeps CPU copies, for a tight card."""

    def __init__(self, adapters: Dict[str, Dict[str, dict]], params, *,
                 pristine: str = "device"):
        if pristine not in ("device", "host"):
            raise ValueError(f"pristine must be 'device' or 'host', got {pristine!r}")
        self.adapters = adapters
        self.active: Tuple[Tuple[str, float], ...] = ()
        self._pristine: Dict[str, Dict[str, torch.Tensor]] = {}
        for p in sorted({p for lora in adapters.values() for p in lora}):
            node = tree_get(params, p)
            if not _is_linear_node(node):
                raise KeyError(f"LoRA path '{p}' does not name a linear node")
            keep = {k: v for k, v in node.items() if k != "b"}
            self._pristine[p] = (keep if pristine == "device" else
                                 {k: v.to("cpu", copy=True) for k, v in keep.items()})

    @property
    def names(self) -> List[str]:
        return sorted(self.adapters)

    def switch(self, params, names: Union[str, Sequence[str], None],
               scale: float = 1.0):
        """``params`` with exactly ``names`` folded in (None or [] restores
        the pristine weights)."""
        names = [] if names is None else [names] if isinstance(names, str) else list(names)
        for n in names:
            if n not in self.adapters:
                raise KeyError(f"no LoRA adapter '{n}' (have {self.names})")
        want = tuple((n, scale) for n in names)
        if want == self.active:
            return params
        for path, kept in self._pristine.items():
            node = tree_get(params, path)
            dev = next(iter(node.values())).device
            folded = dict(node, **{k: v.to(dev) for k, v in kept.items()})
            for n in names:
                ab = self.adapters[n].get(path)
                if ab is not None:
                    folded = fold_linear_node(folded, ab, scale, jit=True)
            params = tree_set(params, path, folded)
        self.active = want
        return params


@contextlib.contextmanager
def enable_lora(params, adapters, names: Sequence[str], scale: float = 1.0):
    """Yields ``params`` with the selected adapters folded in (the others
    contribute nothing, as the reference's zeroed scalings); the input tree
    is never changed, so there is nothing to restore."""
    folded = params
    for name in names:
        folded = fold_adapter(folded, adapters, name, scale)
    yield folded


def merge_for_export(adapters: Dict[str, Dict[str, dict]], name: str
                     ) -> Dict[str, torch.Tensor]:
    """One adapter flattened to {path.lora_a / path.lora_b: tensor}."""
    flat = {}
    for path, ab in adapters[name].items():
        flat[f"{path}.lora_a"] = ab["a"]
        flat[f"{path}.lora_b"] = ab["b"]
    return flat
