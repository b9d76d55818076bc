"""Parameter-tree utilities, the device rule and the remat policy.

A parameter tree is a nested dict of tensors in the JAX package's layout;
stacked blocks carry a leading block axis and are indexed, not copied.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Iterator, Tuple

import torch
import torch.utils.checkpoint


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: the outputs of the weight
    products (``mm``, ``addmm``, the int8 ``_int_mm``) are saved; batched
    products (``bmm``/``baddbmm``: attention-sized einsums with batch dims)
    and everything elementwise are recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default, aten._int_mm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn: Callable, remat) -> Callable:
    """Rematerialisation of a block body (``unigen_tpu/utils.remat_wrap``).

    False/None/"none" runs ``fn`` as it is. True/"full" checkpoints each call
    (``torch.utils.checkpoint``, non-reentrant): only the body's inputs
    survive the forward and the whole body runs again in the backward, the
    memory floor. "dots" checkpoints selectively (``_dots_policy``): the
    weight products' outputs are saved and the rest runs again. A CUDA
    kernel of the port is a ctypes call that the dispatcher does not see,
    so both policies run it again, as JAX's recomputes a ``pallas_call``.
    The body draws no random numbers, so the RNG state is not saved."""
    if remat in (False, None, "none"):
        return fn
    if remat not in (True, "full", "dots"):
        raise ValueError(f"remat must be bool, 'none', 'full' or 'dots'; "
                         f"got {remat!r}")
    kw = {}
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    def checkpointed(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    return checkpointed


def promote(*tensors: torch.Tensor):
    """The operands of a product cast to their common dtype: torch's products
    refuse mixed dtypes where jnp's promote (bf16 x fp32 -> fp32), as when
    fp32 trainable leaves meet bf16 activations."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller names the CPU.
    There is no silent fallback: without CUDA, only ``device="cpu"`` works."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "unigen_tpu_torch runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the tensor leaves of nested dicts/lists/tuples, with
    the matching leaves of ``rest`` as further arguments. None leaves (the
    frozen side of ``ops/quant.split_trainable``) stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


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


def tree_leaves(tree: Any) -> list:
    """The tensor leaves in the tree's order, None leaves left out."""
    return [x for _, x in tree_leaves_with_path(tree) if x is not None]


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
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
