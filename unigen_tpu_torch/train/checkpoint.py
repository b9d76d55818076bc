"""Checkpoints and resume (port of ``unigen_tpu/train/checkpoint.py``).

The JAX package's directory layout, with ``torch.save`` in place of orbax:

  {work_dir}/
    step_{N:08d}/adapter      the trainable tree (a LoRA adapter in LoRA mode)
    step_{N:08d}/opt_state    the optimizer state (``train_step.OptState``)
    step_{N:08d}/meta.json    {"step": N, ...}
    step_{N:08d}/generator    the Trainer's random-generator state
    latest                    the resume pointer, "step_{N:08d}"

The frozen backbone is not saved: it comes back from the pretrained files,
as the reference's save hook persists only ``trainable_control_modules``.
The generator state is the port's addition: the JAX Trainer re-seeds its
key at construction and saves none, so a resumed JAX run repeats the first
steps' noise and timesteps; the reference's ``accelerator.save_state``
saves its RNG states. Files are read back with ``weights_only=True``.

The adapter exports keep the reference's formats: a flat name -> array
``.npz`` with the reference's module names, and one torch
``{module}_weights_{idx}.bin`` per trainable control module (hook.py:16-21).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from unigen_tpu_torch.train.train_step import OptState
from unigen_tpu_torch.utils import index_params, tree_leaves_with_path


def _ckpt_dir(work_dir: str, step: int) -> str:
    return os.path.join(work_dir, f"step_{step:08d}")


def _on_cpu(tree):
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree.detach().to("cpu") if isinstance(tree, torch.Tensor) else tree


def save_train_state(work_dir: str, step: int, control, opt_state: OptState,
                     extra: Optional[Dict[str, Any]] = None,
                     generator_state: Optional[torch.Tensor] = None) -> str:
    """Write step ``step``'s directory, then point ``latest`` at it."""
    path = _ckpt_dir(work_dir, step)
    os.makedirs(path, exist_ok=True)
    torch.save(_on_cpu(control), os.path.join(path, "adapter"))
    torch.save(_on_cpu(opt_state._asdict()), os.path.join(path, "opt_state"))
    if generator_state is not None:
        torch.save(generator_state.to("cpu"), os.path.join(path, "generator"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    with open(os.path.join(work_dir, "latest"), "w") as f:
        f.write(f"step_{step:08d}")
    return path


def latest_step(work_dir: str) -> Optional[int]:
    tag = os.path.join(work_dir, "latest")
    if not os.path.exists(tag):
        return None
    with open(tag) as f:
        name = f.read().strip()
    try:
        return int(name.split("_")[-1])
    except ValueError:
        return None


def _check_like(got, like, what: str):
    """Raise unless ``got`` has ``like``'s paths, shapes and dtypes."""
    want = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves_with_path(like)
            if isinstance(t, torch.Tensor)}
    have = {p: (tuple(t.shape), t.dtype) for p, t in tree_leaves_with_path(got)
            if isinstance(t, torch.Tensor)}
    if want != have:
        bad = sorted(".".join(p) for p in set(want) ^ set(have))
        bad += sorted(".".join(p) for p in set(want) & set(have) if want[p] != have[p])
        raise ValueError(f"{what} does not match the live state at {bad[:8]}")


def restore_train_state(work_dir: str, control_like=None,
                        opt_state_like: Optional[OptState] = None,
                        step: Optional[int] = None, *, map_location=None
                        ) -> Optional[Tuple[Any, OptState, Dict[str, Any]]]:
    """(control, opt_state, meta) of ``step`` (default: ``latest``), loaded
    onto ``map_location``; None when there is nothing to resume. The
    ``*_like`` trees, when given, must match what was saved (paths, shapes,
    dtypes). ``meta["generator_state"]`` holds the generator's state where
    one was saved."""
    step = step if step is not None else latest_step(work_dir)
    if step is None:
        return None
    path = _ckpt_dir(work_dir, step)
    if not os.path.isdir(path):
        return None

    def load(name):
        return torch.load(os.path.join(path, name), map_location=map_location,
                          weights_only=True)
    control = load("adapter")
    opt_state = OptState(**load("opt_state"))
    if control_like is not None:
        _check_like(control, control_like, "the checkpoint's adapter")
    if opt_state_like is not None:
        _check_like(opt_state._asdict(), opt_state_like._asdict(),
                    "the checkpoint's optimizer state")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if os.path.exists(os.path.join(path, "generator")):
        meta["generator_state"] = torch.load(os.path.join(path, "generator"),
                                             map_location="cpu", weights_only=True)
    return control, opt_state, meta


# ------------------------------------------------------------ adapter exports

def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def reference_state_dict(control) -> Dict[str, np.ndarray]:
    """The control tree under the reference's module names (the inverse of
    ``io/torch_bridge.load_unigen_adapter``): Linear weights [out, in],
    RMSNorm weights, stacked blocks split per index. bf16 leaves come out
    as float32 (numpy has no bfloat16)."""
    flat: Dict[str, np.ndarray] = {}

    def lin(name, p):
        flat[f"{name}.weight"] = _np(p["w"]).T
        if "b" in p:
            flat[f"{name}.bias"] = _np(p["b"])

    def time_text(name, p):
        lin(f"{name}.timestep_embedder.linear_1", p["timestep"]["fc1"])
        lin(f"{name}.timestep_embedder.linear_2", p["timestep"]["fc2"])
        lin(f"{name}.text_embedder.linear_1", p["text"]["fc1"])
        lin(f"{name}.text_embedder.linear_2", p["text"]["fc2"])
        if "guidance" in p:
            lin(f"{name}.guidance_embedder.linear_1", p["guidance"]["fc1"])
            lin(f"{name}.guidance_embedder.linear_2", p["guidance"]["fc2"])

    def attn(name, sub):
        pairs = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v",
                 "to_out": "to_out.0", "add_q": "add_q_proj",
                 "add_k": "add_k_proj", "add_v": "add_v_proj",
                 "to_add_out": "to_add_out"}
        for ours, theirs in pairs.items():
            if ours in sub:
                lin(f"{name}.{theirs}", sub[ours])
        for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            if n in sub:
                flat[f"{name}.{n}.weight"] = _np(sub[n]["scale"])

    def dbl(name, sub):
        lin(f"{name}.norm1.linear", sub["norm1"]["linear"])
        lin(f"{name}.norm1_context.linear", sub["norm1_context"]["linear"])
        attn(f"{name}.attn", sub["attn"])
        lin(f"{name}.ff.net.0.proj", sub["ff"]["fc1"])
        lin(f"{name}.ff.net.2", sub["ff"]["fc2"])
        lin(f"{name}.ff_context.net.0.proj", sub["ff_context"]["fc1"])
        lin(f"{name}.ff_context.net.2", sub["ff_context"]["fc2"])

    lin("control_x_embedder", control["x_embedder"])
    lin("control_context_embedder", control["context_embedder"])
    time_text("control_time_text_embed", control["time_text_embed"])
    time_text("control_condition_embed", control["condition_embed"])
    for i in range(control["add_double"]["w"].shape[0]):
        dbl(f"control_joint_trans_blocks.{i}", index_params(control["double_blocks"], i))
        lin(f"controlnet_add_joint_blocks.{i}", index_params(control["add_double"], i))
    if "single_blocks" in control:
        for i in range(control["add_single"]["w"].shape[0]):
            sub = index_params(control["single_blocks"], i)
            name = f"control_single_trans_blocks.{i}"
            lin(f"{name}.norm.linear", sub["norm"]["linear"])
            attn(f"{name}.attn", sub["attn"])
            lin(f"{name}.proj_mlp", sub["proj_mlp"])
            lin(f"{name}.proj_out", sub["proj_out"])
            lin(f"controlnet_add_single_blocks.{i}", index_params(control["add_single"], i))
    flat["moe.moe_layer.gate.wg.weight"] = _np(control["moe"]["gate"]["w"]).T
    ex = control["moe"].get("experts", {})
    if "cond_mod" in ex:
        for e in range(ex["cond_mod"]["w"].shape[0]):
            for pair, mod, pool in ((0, "cond_mod", "cond_pool"), (1, "hid_mod", "hid_pool")):
                root = f"moe.moe_layer.experts.deepspeed_experts.{e}.{pair}"
                lin(f"{root}.0", index_params(ex[mod], e))
                lin(f"{root}.1", index_params(ex[pool], e))
    if "shared_expert" in control:
        for i, k in enumerate(("weave_cond", "weave_text")):
            dbl(f"shared_expert.{i}", control["shared_expert"][k])
    return flat


def export_adapter_torch_compatible(control, path: str) -> None:
    """The adapter as a flat name -> array ``.npz`` under the reference's
    module names, so it round-trips with the reference ecosystem."""
    np.savez(path, **reference_state_dict(control))


def export_adapter_reference_shards(control, work_dir: str) -> List[str]:
    """The adapter in the reference's shard format: one torch
    ``{module}_weights_{idx}.bin`` per trainable control module, modules in
    sorted order (hook.py:16-21), loadable by ``io/torch_bridge.
    load_adapter_checkpoint``. -> the written paths."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, arr in reference_state_dict(control).items():
        groups.setdefault(key.split(".")[0], {})[key] = torch.from_numpy(
            np.ascontiguousarray(arr))
    os.makedirs(work_dir, exist_ok=True)
    paths = []
    for idx, (module, sd) in enumerate(sorted(groups.items())):
        p = os.path.join(work_dir, f"{module}_weights_{idx}.bin")
        torch.save(sd, p)
        paths.append(p)
    return paths
