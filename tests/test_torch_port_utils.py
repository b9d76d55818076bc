"""The port's presets, tree utilities and observability helpers against the
JAX package: every FLUX and SD3 preset equal field for field,
``param_count`` / ``cast_tree`` / ``unstack_params`` on the same tree, and
``profile`` writing a Chrome trace in which ``phase`` names its range."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import to_jax_tree
from unigen_tpu import presets as j_presets
from unigen_tpu import utils as j_utils
from unigen_tpu_torch import observability, presets as t_presets
from unigen_tpu_torch import utils as t_utils


@pytest.mark.parametrize("name,kw", [
    ("flux_schnell", {}), ("flux_schnell", dict(condition_types=("depth", "canny"),
                                                use_rope=False)),
    ("flux_dev", {}), ("flux_dev", dict(single_control_dev=1)), ("flux_mini", {}),
    ("flux_bench", {}), ("flux_full", {}), ("flux_train_bench", {}),
    ("flux_train_bench", dict(shared_expert=False)), ("sd35_medium", {}), ("tiny", {})])
def test_presets_equal_jax_field_for_field(name, kw):
    got = dataclasses.asdict(getattr(t_presets, name)(**kw))
    want = dataclasses.asdict(getattr(j_presets, name)(**kw))
    assert got == want


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"blocks": {"w": torch.randn(3, 4, 5, generator=g),
                       "codes": torch.randint(-8, 8, (3, 5), generator=g, dtype=torch.int8)},
            "head": [torch.randn(2, generator=g), torch.randn(2, 2, generator=g)]}


def test_param_count_cast_tree_and_unstack_match_jax():
    tree = _tree()
    jtree = to_jax_tree(tree)
    assert t_utils.param_count(tree) == j_utils.param_count(jtree) == 3 * 20 + 15 + 2 + 4
    got = t_utils.cast_tree(tree, torch.bfloat16)
    want = j_utils.cast_tree(jtree, jnp.bfloat16)
    assert got["blocks"]["codes"].dtype == torch.int8 and got["head"][0].dtype == torch.bfloat16
    for path, g in t_utils.tree_leaves_with_path(got):
        w = want
        for k in path:
            w = w[int(k)] if isinstance(w, list) else w[k]
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    blocks = t_utils.unstack_params(tree["blocks"], 3)
    jblocks = j_utils.unstack_params(jtree["blocks"], 3)
    assert len(blocks) == len(jblocks) == 3
    for b, jb in zip(blocks, jblocks):
        for k in ("w", "codes"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert blocks[1]["w"].data_ptr() == tree["blocks"]["w"][1].data_ptr()     # views


def test_profile_writes_a_chrome_trace_with_the_phase(tmp_path, capsys):
    with observability.profile(str(tmp_path / "trace")):
        with observability.phase("unigen_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "unigen_phase" for e in trace["traceEvents"])
    with observability.profile(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    observability.debug_print("hello", 3)
    stats = observability.param_report(_tree(), "tree")
    assert stats["params"] == 81 and "hello 3" in capsys.readouterr().out
