"""Carry a JAX parameter tree into the port, and build the serving tree
directly on the card.

``tree_from_numpy`` takes the nested dict of numpy arrays that
``jax.tree.map(np.asarray, params)`` gives and returns the port's tree with
the same keys, dtypes and shapes: bf16 (``ml_dtypes.bfloat16``) becomes
``torch.bfloat16`` bit for bit, int8 codes stay int8, lists (the VAE's
block lists) stay lists, and None leaves (the two halves of
``split_trainable``) stay None. The UniGen, VAE, CLIP and T5 trees of the
JAX package all move this way; the port's ``init_vae_params``,
``init_clip_params`` and ``init_t5_params`` fill the same layouts on a
device directly. ``opt_state_from_optax`` does
the same for an optax ``MultiSteps(chain(clip_by_global_norm, adamw))``
state (or the chain alone) after ``jax.tree.map(np.asarray, state)``,
giving the port's ``train_step.OptState``. This module never imports JAX.

``init_quantized_serving_params`` is the counterpart of the reference
bench's direct quantized init: the W4A8 serving tree's shapes come from the
port's own init and quantize run on the meta device, and each leaf is filled
on the target device (uniform int8 codes, ``w_scale`` in [1e-4, 1e-3],
float leaves N(0, 0.02)), so the bf16 source tree is never built.
``init_sd3_serving_params`` does the same for the bf16 UniGen-SD3 tree
(the interleaved one, or the UniGenBase variant's), and
``init_sana_serving_params`` for the bf16 UniGen-SANA tree. The Gemma-2
and DC-AE trees of the JAX package move by ``tree_from_numpy`` as the
others do (Gemma's layers are a list, the DC-AE's stages lists of lists),
and so do the evaluation towers: VGG16's list of ``{"w", "b"}``
convolutions and the Depth-Anything tree (its layers, reassemble, neck and
fusion stages lists of dicts).
"""

from __future__ import annotations

import numpy as np
import torch

from unigen_tpu_torch.config import UniGenConfig
from unigen_tpu_torch.models.sana import init_sana_unigen_params
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.models.unigen_sd3 import init_unigen_sd3_params
from unigen_tpu_torch.ops.packing import sincos_2d_pos_embed
from unigen_tpu_torch.ops.quant import quantize_unigen_serving
from unigen_tpu_torch.train.train_step import OptState
from unigen_tpu_torch.utils import resolve_device, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # owned and writable
    if a.dtype.name == "bfloat16":          # ml_dtypes: same 16 bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tree_from_numpy(tree, device=None):
    """Nested dict (or list/tuple) of numpy arrays, None leaves allowed ->
    the same structure of tensors on ``device`` (CUDA unless "cpu" is named)."""
    dev = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, dev), tree)


def _states(node):
    """Every optax state record inside nested tuples, depth first."""
    if hasattr(node, "_fields"):
        yield node
        for v in node:
            if isinstance(v, tuple):
                yield from _states(v)
    elif isinstance(node, tuple):
        for v in node:
            yield from _states(v)


def opt_state_from_optax(state, device=None) -> OptState:
    """An optax state with numpy leaves -> ``OptState`` on ``device``: the
    adam moments and count, the schedule count (always equal to the adam
    count in this chain), and MultiSteps' mini_step, gradient_step and
    accumulated gradients where present."""
    dev = resolve_device(device)
    multi = getattr(state, "mini_step", None) is not None
    inner = state.inner_opt_state if multi else state
    adam = [s for s in _states(inner) if "mu" in s._fields]
    counts = {int(s.count) for s in _states(inner) if "count" in s._fields}
    if len(adam) != 1 or len(counts) != 1:
        raise ValueError("expected one adam state and one shared count in the "
                         f"optax chain, got {len(adam)} and {sorted(counts)}")
    out = OptState(count=counts.pop(), mu=tree_from_numpy(adam[0].mu, dev),
                   nu=tree_from_numpy(adam[0].nu, dev))
    if multi:
        out = out._replace(mini_step=int(state.mini_step),
                           gradient_step=int(state.gradient_step),
                           acc_grads=tree_from_numpy(state.acc_grads, dev))
    return out


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


def _filled(shapes, dev, gen, table=None):
    """Each leaf of a meta tree on ``dev``: ``pos_embed`` the given table,
    a norm ``scale`` one, any other N(0, 0.02) in its dtype."""
    def fill(name, meta):
        if name == "pos_embed":
            return table.clone()
        out = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        return out.fill_(1.0) if name == "scale" else out.normal_(
            0.0, 0.02, generator=gen)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return fill(name, node)
    return walk(shapes)


def init_sd3_serving_params(cfg: UniGenConfig, seed: int = 0, device=None,
                            dtype=torch.bfloat16, base_variant: bool = False) -> dict:
    """Random UniGen-SD3 serving tree in the exact layout of
    ``init_unigen_sd3_params(cfg, dtype=dtype, base_variant=base_variant)``
    (shapes from the meta device), filled leaf by leaf on ``device`` from
    ``seed``: the sincos position tables computed (fp32), norm scales one,
    every other leaf N(0, 0.02) in its dtype (the router gate stays fp32;
    the zero-init add linears are filled too, so the control branch reaches
    the output)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"           # shapes only
           else torch.Generator(device=dev).manual_seed(seed))
    bb = cfg.sd3
    table = sincos_2d_pos_embed(bb.inner_dim, bb.pos_embed_max_size,
                                bb.sample_size // bb.patch_size, device=dev)
    return _filled(init_unigen_sd3_params(cfg, device="meta", dtype=dtype,
                                          base_variant=base_variant), dev, gen, table)


def init_sana_serving_params(cfg: UniGenConfig, seed: int = 0, device=None,
                             dtype=torch.bfloat16) -> dict:
    """Random UniGen-SANA serving tree in the exact layout of
    ``init_sana_unigen_params(cfg, dtype=dtype)``, filled leaf by leaf on
    ``device`` from ``seed`` as ``init_sd3_serving_params`` fills (the
    zero-init add linears too; the router gate fp32)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    return _filled(init_sana_unigen_params(cfg, device="meta", dtype=dtype), dev, gen)
