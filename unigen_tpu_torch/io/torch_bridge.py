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
  read_checkpoint_dir     sorted ``*.safetensors`` shards if any, else every
                          ``*.bin`` through ``torch.load(weights_only=True)``
  load_flux_transformer   diffusers FluxTransformer2DModel -> models/flux tree
  load_unigen_adapter     the reference's trainable_control_modules state
                          dict -> the models/unigen_flux control tree
  load_adapter_checkpoint the reference's three adapter layouts
  load_clip_text          transformers CLIPTextModel(WithProjection)
  load_t5_encoder         transformers T5EncoderModel
  load_vae                diffusers AutoencoderKL

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
from typing import Callable, Dict

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
