"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py):
inputs are made with numpy from a fixed seed and handed to both the JAX
function and its port; trees cross as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from unigen_tpu_torch.io.from_jax import tree_from_numpy


def to_torch_tree(tree):
    """A JAX parameter tree -> the port's tree on the CPU."""
    return tree_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def to_jax_tree(tree):
    """A port tree of CPU tensors (dicts and lists) -> the same leaves as
    JAX arrays: the port's inits are fast where JAX's eager inits of the
    tiny trees take seconds, so several tests draw a tree here and hand it
    to JAX (each holds the layout against JAX's init by ``jax.eval_shape``
    or by its own JAX calls)."""
    if isinstance(tree, dict):
        return {k: to_jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax_tree(v) for v in tree]
    return jnp.asarray(tree.numpy())


def pair(a, dtype=np.float32):
    """The same numpy values as (jax array, torch tensor)."""
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def assert_close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


def assert_equal(got, want):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(g, np.asarray(want))


def rel_l2(got, want) -> float:
    g, w = as_np(got).astype(np.float64), as_np(want).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))
