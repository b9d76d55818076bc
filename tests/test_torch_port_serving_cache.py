"""The port's serving-tree cache (``unigen_tpu_torch/io/serving_cache.py``)
on the CPU: a quantized tiny tree round-trips bit for bit (the port's own
W4A8 serving tree, and a JAX one carried by ``tree_from_numpy``), and each
refusal of the JAX module raises with its message."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unigen_tpu.ops.quant import quantize_tree as j_quantize_tree
from unigen_tpu_torch import presets
from unigen_tpu_torch.io.from_jax import tree_from_numpy
from unigen_tpu_torch.io.serving_cache import (has_serving_tree, load_serving_tree,
                                               save_serving_tree)
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.ops.quant import quantize_tree
from unigen_tpu_torch.utils import tree_leaves_with_path

FINGERPRINT = {"family": "flux", "num_layers": 2, "num_single_layers": 4}


def _assert_same_tree(got, want):
    got, want = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.device.type == "cpu"
        assert torch.equal(g.view(torch.uint8) if g.dtype.is_floating_point else g,
                           w.view(torch.uint8) if w.dtype.is_floating_point else w), path


def _w4a8(params, quantize):
    """The serving policy's layout (base W4, control stacks W4, the rest W8)
    at the tiny widths: every linear of 16 or more features quantized."""
    ctrl = params["control"]
    return {"base": quantize(params["base"], min_dim=16, bits=4),
            "control": {k: quantize(v, min_dim=16, bits=4 if k in (
                "double_blocks", "single_blocks") else 8) for k, v in ctrl.items()}}


def _port_tree():
    params = init_unigen_flux_params(presets.tiny(), gen=torch.Generator().manual_seed(0),
                                     device="cpu", dtype=torch.bfloat16)
    return _w4a8(params, quantize_tree)


def _jax_tree():
    """A JAX tree of the serving layouts (a W4 linear, a stacked W4 block
    axis, a W8 linear, an unquantized router gate, bf16 biases) quantized by
    the JAX package and carried by tree_from_numpy."""
    rng = np.random.default_rng(0)

    def lin(*shape):
        return {"w": jnp.asarray(rng.standard_normal(shape), jnp.bfloat16),
                "b": jnp.asarray(rng.standard_normal(shape[-1]), jnp.bfloat16)}
    tree = {"base": j_quantize_tree({"proj": lin(32, 48), "blocks": lin(3, 32, 64)},
                                    min_dim=16, bits=4),
            "control": j_quantize_tree({"embed": lin(24, 32), "gate": lin(32, 4)},
                                       min_dim=16, bits=8)}
    return tree_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("source", ["port", "jax"])
def test_quantized_tree_round_trips_bit_for_bit(tmp_path, source):
    tree = _port_tree() if source == "port" else _jax_tree()
    leaves = dict(tree_leaves_with_path(tree))
    assert any(t.dtype == torch.int8 for t in leaves.values())
    assert any(t.dtype == torch.bfloat16 for t in leaves.values())
    path = str(tmp_path / "cache")
    assert not has_serving_tree(path)
    assert save_serving_tree(tree, path, quantize="w4a8",
                             config_fingerprint=FINGERPRINT) == path
    assert has_serving_tree(path) and not has_serving_tree(None)
    got, meta = load_serving_tree(path, quantize="w4a8",
                                  config_fingerprint=FINGERPRINT, device="cpu")
    assert meta == {"format": "unigen-serving-tree", "quantize": "w4a8",
                    "config": FINGERPRINT}
    _assert_same_tree(got, tree)
    # a subset of the fingerprint is enough to match
    load_serving_tree(path, quantize="w4a8", config_fingerprint={"family": "flux"},
                      device="cpu")


def test_refusals(tmp_path):
    tree = {"w": torch.arange(6, dtype=torch.int8).reshape(2, 3)}
    path = str(tmp_path / "cache")
    save_serving_tree(tree, path, quantize="w4a8", config_fingerprint=FINGERPRINT)
    with pytest.raises(ValueError, match="cache was quantized as 'w4a8', caller "
                                         "wants 'w8a8'"):
        load_serving_tree(path, quantize="w8a8", device="cpu")
    with pytest.raises(ValueError, match="cache topology mismatch"):
        load_serving_tree(path, quantize="w4a8", device="cpu",
                          config_fingerprint=dict(FINGERPRINT, num_layers=19))
    with open(tmp_path / "cache" / "meta.json", "w") as f:
        f.write('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a serving-tree cache"):
        load_serving_tree(path, quantize="w4a8", device="cpu")
    if not torch.cuda.is_available():
        save_serving_tree(tree, path, quantize="w4a8")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_serving_tree(path, quantize="w4a8")
