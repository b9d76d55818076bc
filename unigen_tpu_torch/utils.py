"""Parameter-tree utilities and the device rule.

A parameter tree is a nested dict of tensors in the JAX package's layout;
stacked blocks carry a leading block axis and are indexed, not copied.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller names the CPU.
    There is no silent fallback: without CUDA, only ``device="cpu"`` works."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "unigen_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def tree_map(fn: Callable, tree: Any) -> Any:
    """Map ``fn`` over the tensor leaves of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, path + (str(i),))
    else:
        yield path, tree


def index_params(tree: Any, i: int) -> Any:
    """Block ``i`` of a stacked tree, as views (no copy)."""
    return tree_map(lambda x: x[i], tree)


def stack_params(trees) -> Any:
    if isinstance(trees[0], dict):
        return {k: stack_params([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def init_stacked(n: int, init_fn: Callable[[], Any]) -> Any:
    """Initialise ``n`` blocks (each call draws from the shared generator the
    caller closed over) and stack them on a leading block axis."""
    return stack_params([init_fn() for _ in range(n)])


def param_bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size()
               for _, x in tree_leaves_with_path(tree))
