"""Checkpoint bridge: diffusers / transformers checkpoint directories -> the
port's parameter trees (port of ``unigen_tpu/io/torch_bridge.py``).

  read_safetensors        the safetensors format, read by this module itself
                          (no ``safetensors`` package): an 8-byte
                          little-endian header length, a JSON header (dtype,
                          shape, ``data_offsets``; ``__metadata__`` skipped),
                          the raw bytes. The file is memory-mapped and each
                          tensor is a view of it (``torch.frombuffer``), so
                          the host reads a tensor's pages only when a
                          converter moves it, and never holds an fp32 copy.
  write_safetensors       the same format written (the LoRA exports)
  read_checkpoint_dir     sorted ``*.safetensors`` shards if any, else every
                          ``*.bin`` through ``torch.load(weights_only=True)``
  load_flux_transformer   diffusers FluxTransformer2DModel -> models/flux tree
  load_unigen_adapter     the reference's trainable_control_modules state
                          dict -> the models/unigen_flux control tree
  load_adapter_checkpoint the reference's three adapter layouts
  load_lora_adapters      the reference's per-adapter PEFT LoRA files
  export_lora_adapters_reference  and back
  load_clip_text          transformers CLIPTextModel(WithProjection)
  load_t5_encoder         transformers T5EncoderModel
  load_vae                diffusers AutoencoderKL
  load_gemma_text         transformers Gemma2Model (SANA's prompt encoder)

Conventions, as the JAX package's: a Linear [out, in] -> {"w": [in, out]},
LayerNorm weight/bias -> scale/bias, RMSNorm weight -> scale, Conv2d OIHW
-> HWIO (the layout ``models/vae.conv`` takes). Each leaf moves to
``device`` in its stored dtype and is transposed and cast there; a stack of
blocks is filled one block at a time, so the device holds the stack and one
block. With ``strict=True`` the FLUX loaders raise on any checkpoint key that
mapped to nothing. This module never imports JAX.
"""

from __future__ import annotations

import glob as globlib
import json
import mmap
import os
import re
import struct
import zipfile
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from unigen_tpu_torch.utils import resolve_device, tree_map

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


# ------------------------------------------------------------ raw readers

def _read_one_safetensors(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        # copy-on-write: a writable view for frombuffer, the file untouched
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    start = 8 + n
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype "
                             f"{info['dtype']!r}")
        shape = tuple(info["shape"])
        lo, hi = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if hi - lo != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} holds {hi - lo} bytes, "
                             f"its shape {shape} and dtype need {count * itemsize}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=start + lo).view(shape)
    return out


def read_safetensors(paths) -> Dict[str, torch.Tensor]:
    """One file, a list of files, or a glob pattern -> {name: tensor}, each
    tensor a CPU view of its memory-mapped file in its stored dtype."""
    if isinstance(paths, str):
        paths = sorted(globlib.glob(paths)) if any(c in paths for c in "*?") else [paths]
    out: Dict[str, torch.Tensor] = {}
    for path in paths:
        out.update(_read_one_safetensors(path))
    return out


def write_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> int:
    """Write ``tensors`` in the safetensors format: the 8-byte little-endian
    header length, the JSON header (names in sorted order, each with its
    dtype name, shape and ``data_offsets``), padded with spaces to a
    multiple of 8 bytes, then the raw bytes, each tensor right after the
    last. -> bytes written."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    blobs, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in names:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        blobs.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in blobs:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return 8 + len(raw) + offset


def read_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A ``torch.save``d state dict (``"state_dict"`` unwrapped), loaded with
    ``weights_only=True``; memory-mapped where the file is a zip archive."""
    sd = torch.load(path, map_location="cpu", weights_only=True,
                    mmap=zipfile.is_zipfile(path))
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def read_checkpoint_dir(path: str) -> Dict[str, torch.Tensor]:
    """A model directory: its sorted safetensors shards, or else every
    pytorch bin in it."""
    st = sorted(globlib.glob(os.path.join(path, "*.safetensors")))
    if st:
        return read_safetensors(st)
    out: Dict[str, torch.Tensor] = {}
    for b in sorted(globlib.glob(os.path.join(path, "*.bin"))):
        out.update(read_torch_bin(b))
    return out


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:      # bfloat16 stored raw
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# ------------------------------------------------------------ leaf converters

class _Put:
    """Moves checkpoint tensors to the device in their stored dtype, then
    transposes and casts there into a new contiguous tensor."""

    def __init__(self, device, dtype):
        self.device, self.dtype = device, dtype

    def __call__(self, t: torch.Tensor, dtype=None, perm=None) -> torch.Tensor:
        x = t.to(self.device)
        if perm is not None:
            x = x.permute(*perm)
        # one copy casts and lays the tensor out contiguously, off the file
        return torch.empty(x.shape, dtype=dtype or self.dtype, device=x.device).copy_(x)


def _lin(sd, name, put: _Put):
    p = {"w": put(sd[f"{name}.weight"], perm=(1, 0))}
    if f"{name}.bias" in sd:
        p["b"] = put(sd[f"{name}.bias"])
    return p


def _ln(sd, name, put: _Put):
    return {"scale": put(sd[f"{name}.weight"]), "bias": put(sd[f"{name}.bias"])}


def _rms(sd, name, put: _Put):
    return {"scale": put(sd[f"{name}.weight"])}


def _conv(sd, name, put: _Put):
    return {"w": put(sd[f"{name}.weight"], perm=(2, 3, 1, 0)),
            "b": put(sd[f"{name}.bias"])}


def _stack(n: int, block: Callable[[int], dict]) -> dict:
    """``block(i)`` for i < n stacked on a leading axis, filled one block at
    a time into the preallocated stack."""
    first = block(0)
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        tree_map(lambda o, t: o[i].copy_(t), out, first if i == 0 else block(i))
        first = None
    return out


class _TrackingSD:
    """A read-only view of a state dict that records which keys the mapping
    consumed, for the strict audit."""

    def __init__(self, sd):
        self._sd = sd
        self.used = set()

    def __getitem__(self, k):
        self.used.add(k)
        return self._sd[k]

    def __contains__(self, k):
        return k in self._sd

    def __iter__(self):
        return iter(self._sd)

    def unmapped(self):
        return sorted(set(self._sd) - self.used)


def _check_strict(tracker: _TrackingSD, what: str):
    left = tracker.unmapped()
    if left:
        head = ", ".join(left[:12])
        more = f" (+{len(left) - 12} more)" if len(left) > 12 else ""
        raise ValueError(f"strict {what} load: {len(left)} checkpoint key(s) mapped "
                         f"to nothing: {head}{more}")


# ------------------------------------------------------------ FLUX

def _flux_attn(sd, p, put, *, context: bool, pre_only: bool = False):
    a = {"to_q": _lin(sd, f"{p}.to_q", put), "to_k": _lin(sd, f"{p}.to_k", put),
         "to_v": _lin(sd, f"{p}.to_v", put),
         "norm_q": _rms(sd, f"{p}.norm_q", put),
         "norm_k": _rms(sd, f"{p}.norm_k", put)}
    if not pre_only:
        a["to_out"] = _lin(sd, f"{p}.to_out.0", put)
    if context:
        a.update({"add_q": _lin(sd, f"{p}.add_q_proj", put),
                  "add_k": _lin(sd, f"{p}.add_k_proj", put),
                  "add_v": _lin(sd, f"{p}.add_v_proj", put),
                  "norm_added_q": _rms(sd, f"{p}.norm_added_q", put),
                  "norm_added_k": _rms(sd, f"{p}.norm_added_k", put),
                  "to_add_out": _lin(sd, f"{p}.to_add_out", put)})
    return a


def _flux_double_block(sd, p, put):
    return {
        "norm1": {"linear": _lin(sd, f"{p}.norm1.linear", put)},
        "norm1_context": {"linear": _lin(sd, f"{p}.norm1_context.linear", put)},
        "attn": _flux_attn(sd, f"{p}.attn", put, context=True),
        "ff": {"fc1": _lin(sd, f"{p}.ff.net.0.proj", put),
               "fc2": _lin(sd, f"{p}.ff.net.2", put)},
        "ff_context": {"fc1": _lin(sd, f"{p}.ff_context.net.0.proj", put),
                       "fc2": _lin(sd, f"{p}.ff_context.net.2", put)},
    }


def _flux_single_block(sd, p, put):
    return {
        "norm": {"linear": _lin(sd, f"{p}.norm.linear", put)},
        "attn": _flux_attn(sd, f"{p}.attn", put, context=False, pre_only=True),
        "proj_mlp": _lin(sd, f"{p}.proj_mlp", put),
        "proj_out": _lin(sd, f"{p}.proj_out", put),
    }


def _time_text(sd, p, put, guidance: bool):
    out = {"timestep": {"fc1": _lin(sd, f"{p}.timestep_embedder.linear_1", put),
                        "fc2": _lin(sd, f"{p}.timestep_embedder.linear_2", put)},
           "text": {"fc1": _lin(sd, f"{p}.text_embedder.linear_1", put),
                    "fc2": _lin(sd, f"{p}.text_embedder.linear_2", put)}}
    if guidance and f"{p}.guidance_embedder.linear_1.weight" in sd:
        out["guidance"] = {"fc1": _lin(sd, f"{p}.guidance_embedder.linear_1", put),
                           "fc2": _lin(sd, f"{p}.guidance_embedder.linear_2", put)}
    return out


def load_flux_transformer(sd, num_layers: int = 19, num_single_layers: int = 38, *,
                          dtype=torch.bfloat16, strict: bool = False,
                          device=None) -> dict:
    put = _Put(resolve_device(device), dtype)
    if strict:
        sd = _TrackingSD(sd)
    guidance = "time_text_embed.guidance_embedder.linear_1.weight" in sd
    tree = {
        "x_embedder": _lin(sd, "x_embedder", put),
        "context_embedder": _lin(sd, "context_embedder", put),
        "time_text_embed": _time_text(sd, "time_text_embed", put, guidance),
        "double_blocks": _stack(num_layers, lambda i: _flux_double_block(
            sd, f"transformer_blocks.{i}", put)),
        "single_blocks": _stack(num_single_layers, lambda i: _flux_single_block(
            sd, f"single_transformer_blocks.{i}", put)),
        "norm_out": {"linear": _lin(sd, "norm_out.linear", put)},
        "proj_out": _lin(sd, "proj_out", put),
    }
    if strict:
        _check_strict(sd, "FLUX transformer")
    return tree


# ------------------------------------------------------------ UniGen adapter

def _gate_prefix(sd) -> str:
    gate_key = next(k for k in sd if k.endswith("gate.wg.weight"))
    return gate_key[: -len("gate.wg.weight")]


def _modulated_experts(sd, prefix, put, num_experts):
    def expert(pair, idx):
        return _stack(num_experts, lambda e: _lin(
            sd, f"{prefix}experts.deepspeed_experts.{e}.{pair}.{idx}", put))
    return {"cond_mod": expert(0, 0), "cond_pool": expert(0, 1),
            "hid_mod": expert(1, 0), "hid_pool": expert(1, 1)}


def load_unigen_adapter(sd, *, n_cn: int, n_cn_single: int, num_experts: int,
                        dtype=torch.bfloat16, guidance: bool = False,
                        strict: bool = False, device=None) -> dict:
    """The reference's trainable_control_modules state dict (names rooted at
    control_* / moe / shared_expert / consis_module) -> the control tree;
    the router gate stays fp32."""
    put = _Put(resolve_device(device), dtype)
    if strict:
        sd = _TrackingSD(sd)
    ctrl = {
        "x_embedder": _lin(sd, "control_x_embedder", put),
        "context_embedder": _lin(sd, "control_context_embedder", put),
        "time_text_embed": _time_text(sd, "control_time_text_embed", put, guidance),
        "condition_embed": _time_text(sd, "control_condition_embed", put, guidance),
        "double_blocks": _stack(n_cn, lambda i: _flux_double_block(
            sd, f"control_joint_trans_blocks.{i}", put)),
        "add_double": _stack(n_cn, lambda i: _lin(
            sd, f"controlnet_add_joint_blocks.{i}", put)),
    }
    if "control_single_trans_blocks.0.norm.linear.weight" in sd:
        ctrl["single_blocks"] = _stack(n_cn_single, lambda i: _flux_single_block(
            sd, f"control_single_trans_blocks.{i}", put))
        ctrl["add_single"] = _stack(n_cn_single, lambda i: _lin(
            sd, f"controlnet_add_single_blocks.{i}", put))

    # deepspeed layout: moe.moe_layer.gate.wg.weight [E, d];
    # experts.deepspeed_experts.{e}.{0: cond, 1: hid}.{0: mod, 1: pool}
    prefix = _gate_prefix(sd)
    moe = {"gate": {"w": put(sd[prefix + "gate.wg.weight"], torch.float32, (1, 0))}}
    if f"{prefix}experts.deepspeed_experts.0.0.0.weight" in sd:
        moe["experts"] = _modulated_experts(sd, prefix, put, num_experts)
    ctrl["moe"] = moe

    if "shared_expert.0.norm1.linear.weight" in sd:
        ctrl["shared_expert"] = {
            "weave_cond": _flux_double_block(sd, "shared_expert.0", put),
            "weave_text": _flux_double_block(sd, "shared_expert.1", put),
        }
    if "consis_module.0.norm1.linear.weight" in sd:
        ctrl["consis"] = {
            "block0": _flux_double_block(sd, "consis_module.0", put),
            "block1": _flux_double_block(sd, "consis_module.1", put),
        }
    if strict:
        _check_strict(sd, "UniGen adapter")
    return ctrl


def read_adapter_checkpoint(work_dir: str) -> Dict[str, torch.Tensor]:
    """The adapter state dict from any of its layouts: the reference's
    ``{module}_weights_{idx}.bin`` shards (keys prefixed with their module
    where they lack it), a safetensors / pytorch-bin directory, or ``.npz``
    exports (one file or a directory of them)."""
    sd: Dict[str, torch.Tensor] = {}
    if os.path.isfile(work_dir) and work_dir.endswith(".npz"):
        npzs = [work_dir]
    else:
        npzs = sorted(globlib.glob(os.path.join(work_dir, "*.npz")))
    if npzs:
        for n in npzs:
            with np.load(n) as z:
                sd.update({k: _from_numpy(z[k]) for k in z.files})
        return sd
    bins = sorted(globlib.glob(os.path.join(work_dir, "*_weights_*.bin")))
    if bins:
        for b in bins:
            module = re.match(r"(.+)_weights_\d+\.bin", os.path.basename(b)).group(1)
            for k, v in read_torch_bin(b).items():
                sd[k if k.startswith(module) else f"{module}.{k}"] = v
        return sd
    return read_checkpoint_dir(work_dir)


def load_adapter_checkpoint(work_dir: str, **kw) -> dict:
    """``load_unigen_adapter`` of ``read_adapter_checkpoint(work_dir)``."""
    return load_unigen_adapter(read_adapter_checkpoint(work_dir), **kw)


# ------------------------------------------------------------ LoRA adapters
#
# The reference saves per-adapter LoRA weights with
# FluxPipeline.save_lora_weights into {dir}/{adapter_name}/ (hook.py:29-45)
# and restores them with set_peft_model_state_dict (hook.py:48-76): keys
# ``transformer.{module}.lora_A.weight`` [r, in] / ``lora_B.weight`` [out, r].
# They map onto models/lora adapters {dotted_path: {"a", "b"}} with stacked
# per-block factors ([L, in, r] / [L, r, out]) rooted at base. / control.

_LORA_DOUBLE_SUB = {
    "norm1.linear": "norm1.linear",
    "norm1_context.linear": "norm1_context.linear",
    "attn.to_q": "attn.to_q", "attn.to_k": "attn.to_k", "attn.to_v": "attn.to_v",
    "attn.add_q_proj": "attn.add_q", "attn.add_k_proj": "attn.add_k",
    "attn.add_v_proj": "attn.add_v",
    "attn.to_out.0": "attn.to_out", "attn.to_add_out": "attn.to_add_out",
    "ff.net.0.proj": "ff.fc1", "ff.net.2": "ff.fc2",
    "ff_context.net.0.proj": "ff_context.fc1", "ff_context.net.2": "ff_context.fc2",
}
_LORA_SINGLE_SUB = {
    "norm.linear": "norm.linear",
    "attn.to_q": "attn.to_q", "attn.to_k": "attn.to_k", "attn.to_v": "attn.to_v",
    "proj_mlp": "proj_mlp", "proj_out": "proj_out",
}
# SD3 joint blocks (torch_bridge_sd3._sd3_block naming; attn2 = the
# SD3.5X dual-attention branch) and SANA blocks
_LORA_SD3_SUB = {
    "norm1.linear": "norm1.linear",
    "norm1_context.linear": "norm1_context.linear",
    "attn.to_q": "attn.to_q", "attn.to_k": "attn.to_k", "attn.to_v": "attn.to_v",
    "attn.add_q_proj": "attn.add_q", "attn.add_k_proj": "attn.add_k",
    "attn.add_v_proj": "attn.add_v",
    "attn.to_out.0": "attn.to_out", "attn.to_add_out": "attn.to_add_out",
    "attn2.to_q": "attn2.to_q", "attn2.to_k": "attn2.to_k",
    "attn2.to_v": "attn2.to_v", "attn2.to_out.0": "attn2.to_out",
    "ff.net.0.proj": "ff.fc1", "ff.net.2": "ff.fc2",
    "ff_context.net.0.proj": "ff_context.fc1",
    "ff_context.net.2": "ff_context.fc2",
}
_LORA_SANA_SUB = {
    "attn1.to_q": "attn1.to_q", "attn1.to_k": "attn1.to_k",
    "attn1.to_v": "attn1.to_v", "attn1.to_out.0": "attn1.to_out",
    "attn2.to_q": "attn2.to_q", "attn2.to_k": "attn2.to_k",
    "attn2.to_v": "attn2.to_v", "attn2.to_out.0": "attn2.to_out",
    "ff.conv_inverted": "ff.inverted", "ff.conv_point": "ff.point",
}
# torch stacked-module prefix -> CANDIDATE (jax stack path, within-block map)
# pairs; the loader keeps the first candidate whose stack exists in the
# target param tree (the same torch name means different stacks per family:
# flux `transformer_blocks` = double stream, SANA's = linear-attn blocks,
# SD3 control's = joint blocks)
_LORA_STACKS = {
    "transformer_blocks": [("base.double_blocks", _LORA_DOUBLE_SUB),
                           ("base.blocks", _LORA_SANA_SUB)],
    "single_transformer_blocks": [("base.single_blocks", _LORA_SINGLE_SUB)],
    "control_joint_trans_blocks": [("control.double_blocks", _LORA_DOUBLE_SUB)],
    "control_single_trans_blocks": [("control.single_blocks", _LORA_SINGLE_SUB)],
    "control_transformer_blocks": [("control.joint_blocks", _LORA_SD3_SUB),
                                   ("control.blocks", _LORA_SANA_SUB)],
}
# torch stacked modules that ARE a bare linear per block (no within-block
# tail): the zero-init ControlNet add gates (UniGenTransformer.py:118-123,
# :755-773) — LoRA on these is what opens the control branch's gradient
# path in LoRA training (the gates start at exactly 0, so factors inside
# control blocks get zero grad until the gate moves)
_LORA_STACK_LINEARS = {
    "controlnet_add_joint_blocks": "control.add_double",
    "controlnet_add_single_blocks": "control.add_single",
}
# torch non-stacked module prefix -> (jax path prefix, within map or None)
_LORA_FLAT = {
    "shared_expert.0": ("control.shared_expert.weave_cond", _LORA_DOUBLE_SUB),
    "shared_expert.1": ("control.shared_expert.weave_text", _LORA_DOUBLE_SUB),
    "consis_module.0": ("control.consis.block0", _LORA_DOUBLE_SUB),
    "consis_module.1": ("control.consis.block1", _LORA_DOUBLE_SUB),
    "x_embedder": ("base.x_embedder", None),
    "context_embedder": ("base.context_embedder", None),
    "proj_out": ("base.proj_out", None),
    "control_x_embedder": ("control.x_embedder", None),
    "control_context_embedder": ("control.context_embedder", None),
}


def _node_exists(params, dotted: str) -> bool:
    node = params
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return False
        node = node[part]
    return True


def _lora_torch_to_jax(module: str, params=None):
    """torch module path -> (dotted tree path, block index or None). A torch
    stack name that means different stacks per family (``transformer_blocks``:
    FLUX double blocks or SANA blocks) resolves against ``params`` when
    given."""
    candidates = []
    for prefix, options in _LORA_STACKS.items():
        if module.startswith(prefix + "."):
            idx, _, tail = module[len(prefix) + 1:].partition(".")
            if idx.isdigit():
                candidates += [(f"{stack}.{sub[tail]}", int(idx))
                               for stack, sub in options if tail in sub]
    for prefix, stack in _LORA_STACK_LINEARS.items():
        if module.startswith(prefix + ".") and module[len(prefix) + 1:].isdigit():
            candidates.append((stack, int(module[len(prefix) + 1:])))
    for prefix, (path, sub) in _LORA_FLAT.items():
        if module == prefix and sub is None:
            candidates.append((path, None))
        elif sub is not None and module.startswith(prefix + "."):
            tail = module[len(prefix) + 1:]
            if tail in sub:
                candidates.append((f"{path}.{sub[tail]}", None))
    if params is None:
        return candidates[0] if candidates else (None, None)
    for path, idx in candidates:
        if _node_exists(params, path):
            return path, idx
    return None, None


def _weight_shape(params, dotted: str):
    node = params
    for part in dotted.split("."):
        node = node[part]
    if "w" in node:
        return tuple(node["w"].shape)
    if "w_q" in node:
        return tuple(node["w_q"].shape)
    if "w_q4" in node:                       # the packed in-dim is halved
        s = node["w_q4"].shape
        return tuple(s[:-2]) + (s[-2] * 2, s[-1])
    raise KeyError(f"no weight under {dotted}")


def load_lora_adapters(input_dir: str, params: dict,
                       adapter_names: Optional[List[str]] = None, *,
                       dtype=torch.float32, strict: bool = True, device=None
                       ) -> Dict[str, Dict[str, dict]]:
    """Per-adapter LoRA directories (the reference's load_model_hook layout,
    hook.py:48-76: ``{input_dir}/{name}/pytorch_lora_weights.safetensors``
    with ``transformer.``-prefixed PEFT keys) -> a models/lora adapters dict
    for ``fold_adapter`` / ``LoraSwitcher``. A module's ``.alpha`` (PEFT's
    rank scaling) is folded into ``b`` as alpha/rank; the blocks of a stack
    that an adapter leaves out get zero factors. ``params`` gives the stack
    depths and weight shapes; with ``strict`` a key that maps to nothing
    raises. Factors land on ``device`` (CUDA unless "cpu" is named)."""
    dev = resolve_device(device)
    if adapter_names is None:
        adapter_names = sorted(
            d for d in os.listdir(input_dir)
            if os.path.isfile(os.path.join(input_dir, d, "pytorch_lora_weights.safetensors")))
        if not adapter_names:
            raise FileNotFoundError(f"no */pytorch_lora_weights.safetensors under {input_dir}")

    adapters: Dict[str, Dict[str, dict]] = {}
    for name in adapter_names:
        sd = read_checkpoint_dir(os.path.join(input_dir, name))
        per_path: Dict[str, dict] = {}       # tree path -> {idx | None: {a, b, alpha}}
        unmapped = []
        for key, val in sd.items():
            k = key[len("transformer."):] if key.startswith("transformer.") else key
            for suffix, part in ((".lora_A.weight", "a"), (".lora_B.weight", "b"),
                                 (".alpha", "alpha")):
                if k.endswith(suffix):
                    module = k[: -len(suffix)]
                    break
            else:
                unmapped.append(key)
                continue
            path, idx = _lora_torch_to_jax(module, params)
            if path is None:
                unmapped.append(key)
                continue
            per_path.setdefault(path, {}).setdefault(idx, {})[part] = val
        if strict and unmapped:
            raise ValueError(f"LoRA adapter '{name}': {len(unmapped)} key(s) "
                             f"mapped to nothing: {', '.join(unmapped[:8])}"
                             + (f" (+{len(unmapped) - 8} more)" if len(unmapped) > 8 else ""))

        lora: Dict[str, dict] = {}
        for path, blocks in per_path.items():
            shape = _weight_shape(params, path)
            ranks = {b["a"].shape[0] for b in blocks.values() if "a" in b}
            if len(ranks) != 1:
                raise ValueError(f"{path}: LoRA ranks {ranks} within one stack")
            r = ranks.pop()
            in_dim, out_dim = shape[-2], shape[-1]

            def factors(blk):
                # torch A [r, in] -> a [in, r]; B [out, r] -> b [r, out];
                # PEFT scales the delta by alpha / r: folded into b
                a = blk["a"].to(torch.float32).t()
                b = blk["b"].to(torch.float32).t()
                if "alpha" in blk:
                    b = b * (float(blk["alpha"]) / r)
                if tuple(a.shape) != (in_dim, r) or tuple(b.shape) != (r, out_dim):
                    raise ValueError(f"{path}: LoRA {tuple(a.shape)}/{tuple(b.shape)} "
                                     f"against the weight {shape}")
                return a, b

            if len(shape) == 3:
                a_stack = torch.zeros((shape[0], in_dim, r), dtype=torch.float32)
                b_stack = torch.zeros((shape[0], r, out_dim), dtype=torch.float32)
                for idx, blk in blocks.items():
                    if idx is None or idx >= shape[0]:
                        raise ValueError(f"{path}: block index {idx} against the "
                                         f"stack depth {shape[0]}")
                    a_stack[idx], b_stack[idx] = factors(blk)
            else:
                (idx, blk), = blocks.items()
                if idx is not None:
                    raise ValueError(f"{path}: unexpected block index {idx}")
                a_stack, b_stack = factors(blk)
            lora[path] = {"a": a_stack.to(dev, dtype), "b": b_stack.to(dev, dtype)}
        adapters[name] = lora
    return adapters


def _torch_lora_module(path: str, idx) -> str:
    """Inverse of ``_lora_torch_to_jax``: a tree path (and block index) ->
    the reference's torch module name."""
    for prefix, stack in _LORA_STACK_LINEARS.items():
        if path == stack:
            return f"{prefix}.{idx}"
    for prefix, options in _LORA_STACKS.items():
        for stack, sub in options:
            if path.startswith(stack + "."):
                inv = {j: t for t, j in sub.items()}
                return f"{prefix}.{idx}.{inv[path[len(stack) + 1:]]}"
    for prefix, (root, sub) in _LORA_FLAT.items():
        if path == root and sub is None:
            return prefix
        if sub is not None and path.startswith(root + "."):
            inv = {j: t for t, j in sub.items()}
            return f"{prefix}.{inv[path[len(root) + 1:]]}"
    raise KeyError(f"no torch name for LoRA path '{path}'")


def export_lora_adapters_reference(adapters: Dict[str, Dict[str, dict]],
                                   output_dir: str) -> List[str]:
    """Adapters in the reference's per-adapter layout (hook.py:41-45):
    ``{output_dir}/{name}/pytorch_lora_weights.safetensors`` with
    ``transformer.``-prefixed PEFT keys in fp32, written by
    ``write_safetensors``. A stack's all-zero per-block factors (blocks the
    adapter never touched) are left out, as PEFT's target_modules does.
    -> the written paths."""
    written = []
    for name, lora in adapters.items():
        sd = {}
        for path, ab in lora.items():
            a = ab["a"].detach().to("cpu", torch.float32)
            b = ab["b"].detach().to("cpu", torch.float32)
            blocks = range(a.shape[0]) if a.dim() == 3 else [None]
            for i in blocks:
                ai, bi = (a, b) if i is None else (a[i], b[i])
                if i is not None and not (ai.any() or bi.any()):
                    continue
                m = _torch_lora_module(path, i)
                sd[f"transformer.{m}.lora_A.weight"] = ai.t().contiguous()
                sd[f"transformer.{m}.lora_B.weight"] = bi.t().contiguous()
        adapter_dir = os.path.join(output_dir, name)
        os.makedirs(adapter_dir, exist_ok=True)
        path = os.path.join(adapter_dir, "pytorch_lora_weights.safetensors")
        write_safetensors(sd, path)
        written.append(path)
    return written


# ------------------------------------------------------------ CLIP / T5 / VAE

def load_clip_text(sd, num_layers: int = 12, *, dtype=torch.float32,
                   device=None) -> dict:
    put = _Put(resolve_device(device), dtype)
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""

    def layer(i):
        p = f"{pre}encoder.layers.{i}"
        return {"ln1": _ln(sd, f"{p}.layer_norm1", put),
                "q": _lin(sd, f"{p}.self_attn.q_proj", put),
                "k": _lin(sd, f"{p}.self_attn.k_proj", put),
                "v": _lin(sd, f"{p}.self_attn.v_proj", put),
                "o": _lin(sd, f"{p}.self_attn.out_proj", put),
                "ln2": _ln(sd, f"{p}.layer_norm2", put),
                "fc1": _lin(sd, f"{p}.mlp.fc1", put),
                "fc2": _lin(sd, f"{p}.mlp.fc2", put)}

    out = {"token_embedding": put(sd[f"{pre}embeddings.token_embedding.weight"]),
           "position_embedding": put(sd[f"{pre}embeddings.position_embedding.weight"]),
           "layers": _stack(num_layers, layer),
           "final_ln": _ln(sd, f"{pre}final_layer_norm", put)}
    if "text_projection.weight" in sd:
        out["text_projection"] = {"w": put(sd["text_projection.weight"], perm=(1, 0))}
    return out


def load_t5_encoder(sd, num_layers: int = 24, *, dtype=torch.bfloat16,
                    device=None) -> dict:
    put = _Put(resolve_device(device), dtype)

    def layer(i):
        p = f"encoder.block.{i}.layer"
        return {"ln1": _rms(sd, f"{p}.0.layer_norm", put),
                "q": _lin(sd, f"{p}.0.SelfAttention.q", put),
                "k": _lin(sd, f"{p}.0.SelfAttention.k", put),
                "v": _lin(sd, f"{p}.0.SelfAttention.v", put),
                "o": _lin(sd, f"{p}.0.SelfAttention.o", put),
                "ln2": _rms(sd, f"{p}.1.layer_norm", put),
                "wi_0": _lin(sd, f"{p}.1.DenseReluDense.wi_0", put),
                "wi_1": _lin(sd, f"{p}.1.DenseReluDense.wi_1", put),
                "wo": _lin(sd, f"{p}.1.DenseReluDense.wo", put)}

    return {"token_embedding": put(sd["shared.weight"]),
            "rel_bias": put(sd["encoder.block.0.layer.0.SelfAttention."
                               "relative_attention_bias.weight"]),
            "layers": _stack(num_layers, layer),
            "final_ln": _rms(sd, "encoder.final_layer_norm", put)}


def load_vae(sd, block_out_channels=(128, 256, 512, 512), layers_per_block: int = 2,
             *, dtype=torch.float32, device=None) -> dict:
    put = _Put(resolve_device(device), dtype)
    n = len(block_out_channels)

    def attn(p):
        return {"norm": _ln(sd, f"{p}.group_norm", put),
                "q": _lin(sd, f"{p}.to_q", put), "k": _lin(sd, f"{p}.to_k", put),
                "v": _lin(sd, f"{p}.to_v", put), "o": _lin(sd, f"{p}.to_out.0", put)}

    def res(p):
        out = {"norm1": _ln(sd, f"{p}.norm1", put), "conv1": _conv(sd, f"{p}.conv1", put),
               "norm2": _ln(sd, f"{p}.norm2", put), "conv2": _conv(sd, f"{p}.conv2", put)}
        if f"{p}.conv_shortcut.weight" in sd:
            out["shortcut"] = _conv(sd, f"{p}.conv_shortcut", put)
        return out

    def half(name, blocks, n_res, sample):
        tree = {"conv_in": _conv(sd, f"{name}.conv_in", put), blocks: [],
                "mid": {"res1": res(f"{name}.mid_block.resnets.0"),
                        "attn": attn(f"{name}.mid_block.attentions.0"),
                        "res2": res(f"{name}.mid_block.resnets.1")},
                "norm_out": _ln(sd, f"{name}.conv_norm_out", put),
                "conv_out": _conv(sd, f"{name}.conv_out", put)}
        kind = "down" if blocks == "down" else "up"
        for i in range(n):
            p = f"{name}.{kind}_blocks.{i}"
            block = {"resnets": [res(f"{p}.resnets.{j}") for j in range(n_res)]}
            if f"{p}.{sample}.0.conv.weight" in sd:
                block[kind] = _conv(sd, f"{p}.{sample}.0.conv", put)
            tree[blocks].append(block)
        return tree

    return {"encoder": half("encoder", "down", layers_per_block, "downsamplers"),
            "decoder": half("decoder", "up", layers_per_block + 1, "upsamplers")}


# ------------------------------------------------------------ Gemma-2 (SANA)

def load_gemma_text(sd, num_layers: int = 26, *, dtype=torch.float32,
                    device=None) -> dict:
    """transformers Gemma2Model state dict -> the models/gemma_text tree (a
    list of layers, as JAX keeps it)."""
    put = _Put(resolve_device(device), dtype)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""

    def layer(i):
        p = f"{pre}layers.{i}"
        return {"input_ln": _rms(sd, f"{p}.input_layernorm", put),
                "post_attn_ln": _rms(sd, f"{p}.post_attention_layernorm", put),
                "pre_ff_ln": _rms(sd, f"{p}.pre_feedforward_layernorm", put),
                "post_ff_ln": _rms(sd, f"{p}.post_feedforward_layernorm", put),
                "attn": {"q": _lin(sd, f"{p}.self_attn.q_proj", put),
                         "k": _lin(sd, f"{p}.self_attn.k_proj", put),
                         "v": _lin(sd, f"{p}.self_attn.v_proj", put),
                         "o": _lin(sd, f"{p}.self_attn.o_proj", put)},
                "gate": _lin(sd, f"{p}.mlp.gate_proj", put),
                "up": _lin(sd, f"{p}.mlp.up_proj", put),
                "down": _lin(sd, f"{p}.mlp.down_proj", put)}

    return {"embed": put(sd[f"{pre}embed_tokens.weight"]),
            "layers": [layer(i) for i in range(num_layers)],
            "final_ln": _rms(sd, f"{pre}norm", put)}
