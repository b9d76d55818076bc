"""The port's serving entry on the CPU: MicroBatchServer over the denoise,
the device rule, the import rule (no JAX, no JAX package), weights carried
across bit for bit, and the W4A8 serving tree's layout against the JAX
package's."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.io.from_jax import (init_quantized_serving_params,
                                          tree_from_numpy)
from unigen_tpu_torch.models.unigen_flux import (UniGenFlux,
                                                 init_unigen_flux_params)
from unigen_tpu_torch.serving import MicroBatchServer
from unigen_tpu_torch.utils import param_bytes, tree_leaves_with_path

REPO = Path(__file__).resolve().parents[1]


def _tiny_model():
    cfg = t_presets.tiny()
    cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, moe=dataclasses.replace(cfg.control.moe,
                                             batch_mode="per_sample")))
    params = init_unigen_flux_params(cfg, gen=torch.Generator().manual_seed(0),
                                     device="cpu")
    return cfg, UniGenFlux(cfg, params, device="cpu", dtype=torch.float32)


def test_micro_batch_server_splits_and_matches_direct_denoise():
    cfg, model = _tiny_model()
    bb = cfg.flux
    rng = np.random.default_rng(0)

    def request():
        mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
        return dict(latents=mk(1, 16, bb.in_channels),
                    condition=mk(1, 16, bb.in_channels),
                    encoder=mk(1, 6, bb.joint_attention_dim),
                    pooled=mk(1, bb.pooled_projection_dim),
                    cond_pooled=mk(1, bb.pooled_projection_dim))

    reqs = [request() for _ in range(5)]
    srv = MicroBatchServer(lambda x: model.denoise(**x, num_steps=2),
                           batch_size=2, max_wait_ms=200)
    try:
        outs = [f.result(timeout=120) for f in [srv.submit(**r) for r in reqs]]
    finally:
        srv.close()
    assert srv.stats.batches == 3 and srv.stats.padded_samples == 1
    for r, out in zip(reqs, outs):
        want = model.denoise(**r, num_steps=2)
        assert out.shape == (1, 16, bb.in_channels) and out.device.type == "cpu"
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def test_entry_points_need_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_presets.tiny()
    params = init_unigen_flux_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        UniGenFlux(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        tree_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        init_quantized_serving_params(cfg)
    assert UniGenFlux(cfg, params, device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import unigen_tpu_torch
        for m in pkgutil.walk_packages(unigen_tpu_torch.__path__, "unigen_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        bad = sorted(n for n in sys.modules if n == "jax" or n.startswith("jax.")
                     or n.startswith("jaxlib") or n == "unigen_tpu"
                     or n.startswith("unigen_tpu."))
        print(len([n for n in sys.modules if n.startswith("unigen_tpu_torch")]), bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 20       # every module was imported


def test_tree_from_numpy_keeps_bits_and_dtypes():
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {"a": {"w": jnp.asarray(f32, jnp.bfloat16),
                  "w_q4": jnp.asarray(rng.integers(-128, 128, (4, 5)), jnp.int8)},
            "s": jnp.asarray(f32)}
    out = tree_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["a"]["w_q4"].dtype == torch.int8 and out["s"].dtype == torch.float32
    np.testing.assert_array_equal(
        out["a"]["w"].view(torch.int16).numpy(),
        np.asarray(tree["a"]["w"]).view(np.int16))
    np.testing.assert_array_equal(out["a"]["w_q4"].numpy(), np.asarray(tree["a"]["w_q4"]))
    np.testing.assert_array_equal(out["s"].numpy(), f32)
    assert np.asarray(tree["a"]["w"]).dtype == ml_dtypes.bfloat16


def test_serving_tree_layout_matches_jax_package():
    """The port's W4A8 serving tree has the JAX tree's paths, shapes and
    dtypes at real width (flux_bench), and flux_full comes to 9.44 GiB."""
    from unigen_tpu import presets as j_presets
    from unigen_tpu.models.unigen_flux import init_unigen_flux_params as j_init
    from unigen_tpu.ops.quant import quantize_unigen_serving as j_quant
    jcfg = j_presets.flux_bench()
    want = jax.eval_shape(lambda k: j_quant(j_init(k, jcfg, dtype=jnp.bfloat16)),
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p, simple=True, separator="."):
            (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(want)}
    got = init_quantized_serving_params(t_presets.flux_bench(), device="meta")
    got = {".".join(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tree_leaves_with_path(got)}
    assert got == want
    full = init_quantized_serving_params(t_presets.flux_full(), device="meta")
    assert round(param_bytes(full) / 2**30, 2) == 9.44
