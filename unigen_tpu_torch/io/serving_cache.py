"""Quantized serving-tree persistence (port of
``unigen_tpu/io/serving_cache.py``): save the W4A8 serving tree once, so a
restart loads the small quantized tree instead of quantizing the bf16
checkpoint again.

Layout::

  {dir}/
    tree.pt      torch.save of the nested dict of CPU tensors (lists,
                 tuples and None leaves kept)
    meta.json    {"format": "unigen-serving-tree", "quantize": ...,
                  "config": <caller fingerprint>}

The JAX package writes an orbax payload under the same ``meta.json``
schema; a JAX tree reaches this format through
``io/from_jax.tree_from_numpy(..., device="cpu")`` and
:func:`save_serving_tree`. On load the format, the quantization mode and
the caller's config fingerprint are checked, so a cache written for
another topology or policy refuses to load rather than give wrong weights.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from unigen_tpu_torch.utils import resolve_device, tree_map

FORMAT = "unigen-serving-tree"
TREE_FILE = "tree.pt"


def save_serving_tree(tree, path: str, *, quantize: str,
                      config_fingerprint: Optional[Dict[str, Any]] = None
                      ) -> str:
    """Persist a (quantized) serving tree: leaves are copied to the host one
    at a time, then written with ``torch.save``."""
    host = tree_map(lambda t: t.detach().cpu(), tree)
    os.makedirs(path, exist_ok=True)
    torch.save(host, os.path.join(path, TREE_FILE))
    meta = {"format": FORMAT, "quantize": quantize,
            "config": config_fingerprint or {}}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def has_serving_tree(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(os.path.join(path, "meta.json"))


def load_serving_tree(path: str, *, quantize: str,
                      config_fingerprint: Optional[Dict[str, Any]] = None,
                      device=None) -> Tuple[Any, Dict[str, Any]]:
    """Restore a tree saved by :func:`save_serving_tree` onto ``device``
    (CUDA unless "cpu" is named) -> (tree, meta). Checks the format, the
    quantization mode and the config fingerprint first; the file is
    memory-mapped and the leaves move to the device one at a time."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: not a serving-tree cache "
                         f"(format={meta.get('format')!r})")
    if meta.get("quantize") != quantize:
        raise ValueError(
            f"{path}: cache was quantized as {meta.get('quantize')!r}, "
            f"caller wants {quantize!r} — refusing to load; delete the "
            "cache dir or change the policy")
    want = config_fingerprint or {}
    got = meta.get("config", {})
    mismatched = {k: (got.get(k), v) for k, v in want.items()
                  if got.get(k) != v}
    if mismatched:
        raise ValueError(
            f"{path}: cache topology mismatch {mismatched} — the cache was "
            "written for a different model config; delete it or point "
            "serving_cache elsewhere")
    dev = resolve_device(device)
    host = torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                      weights_only=True, mmap=True)
    return tree_map(lambda t: t.to(dev), host), meta
