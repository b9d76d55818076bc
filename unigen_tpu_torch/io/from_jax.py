"""Carry a JAX parameter tree into the port, and build the serving tree
directly on the card.

``tree_from_numpy`` takes the nested dict of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives and returns the port's tree with
the same keys, dtypes and shapes: bf16 (``ml_dtypes.bfloat16``) becomes
``torch.bfloat16`` bit for bit, int8 codes stay int8. This module never
imports JAX.

``init_quantized_serving_params`` is the counterpart of the reference
bench's direct quantized init: the W4A8 serving tree's shapes come from the
port's own init and quantize run on the meta device, and each leaf is filled
on the target device (uniform int8 codes, ``w_scale`` in [1e-4, 1e-3],
float leaves N(0, 0.02)), so the bf16 source tree is never built.
"""

from __future__ import annotations

import numpy as np
import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.ops.quant import quantize_unigen_serving
from unigen_tpu_torch.utils import resolve_device, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # owned and writable
    if a.dtype.name == "bfloat16":          # ml_dtypes: same 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree, device=None):
    """Nested dict (or list/tuple) of numpy arrays -> the same structure of
    tensors on ``device`` (CUDA unless "cpu" is named)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def init_quantized_serving_params(cfg: UniGenConfig, device=None,
                                  generator: torch.Generator = None,
                                  dtype=torch.bfloat16) -> dict:
    """Random W4A8 serving tree of ``quantize_unigen_serving(init(cfg))``'s
    exact structure, filled leaf by leaf on ``device``."""
    dev = resolve_device(device)
    shapes = quantize_unigen_serving(
        init_unigen_flux_params(cfg, device="meta", dtype=dtype))

    def fill(leaf_path, meta):
        out = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        if not meta.dtype.is_floating_point:
            return out.random_(-127, 128, generator=generator)
        if leaf_path == "w_scale":
            return out.uniform_(1e-4, 1e-3, generator=generator)
        return out.normal_(0.0, 0.02, generator=generator)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v)
                for k, v in node.items()}
    return walk(shapes)
