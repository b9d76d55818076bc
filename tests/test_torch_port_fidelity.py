"""The port's quantization-fidelity tool (``python -m
unigen_tpu_torch.cli.measure_fidelity``) on the CPU: its flags and refusals
against ``scripts/measure_fidelity.py``'s; ``fidelity`` bit for bit against
the JAX script's; ``liven_gates`` touching the leaves the JAX script's
touches; and ``main --ckpt --ssim --cache-interval 2 --model-cache`` on the
tiny FLUX directory of ``tests/test_from_pretrained.py`` against the JAX
script's ``main`` on the same directory and the same batch and VAE, run in
process (below the quantizers' ``min_dim`` of 512 every path is the bf16
tree, so the quantized paths differ from bf16 through the cache alone).
SD3 and SANA are held the same way in
``tests/test_torch_port_fidelity_jax.py``; the cache flags against the
pipelines' own cache modes in ``tests/test_torch_port_fidelity_cache.py``."""

import argparse
import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from tests.torch_port_helpers import to_jax_tree
from unigen_tpu_torch import presets as tpresets
from unigen_tpu_torch.cli import measure_fidelity as mf
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.utils import tree_leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_measure_fidelity",
                                                  ROOT / "scripts" / "measure_fidelity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Parsed(Exception):
    pass


def _jax_flags(monkeypatch, argv):
    """The namespace the JAX script's own parser gives ``argv`` (its main
    builds the parser; stopped right after parsing)."""
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            _jax_script().main(argv)
    return vars(e.value.args[0])


@pytest.mark.parametrize("argv", [
    [],
    ["--ssim", "--res", "512", "--family", "sd3", "--out", "o.json", "--ckpt", "c",
     "--adapter", "a", "--cache-interval", "4", "--cfg-cache"],
    ["--full-topology", "--cache-threshold", "0.2", "--model-cache", "--model-cache-order",
     "1", "--subject", "--routing", "global"],
    ["--family", "sana", "--cache-interval", "4", "--hybrid-model-interval", "2"]])
def test_flags_match_scripts_measure_fidelity(monkeypatch, argv):
    """Every flag and default of the JAX script, plus ``--device`` (cuda
    unless named)."""
    got = vars(mf.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == _jax_flags(monkeypatch, argv)


@pytest.mark.parametrize("argv", [
    ["--hybrid-model-interval", "2"],
    ["--cache-interval", "4", "--hybrid-model-interval", "3"],
    ["--cache-interval", "4", "--hybrid-model-interval", "2", "--model-cache"],
    ["--cache-interval", "4", "--hybrid-model-interval", "2", "--cache-threshold", "0.1"],
    ["--family", "sd3", "--subject"]])
def test_refusals_match_scripts_measure_fidelity(argv):
    """The JAX script's p.error refusals, before anything is built."""
    with pytest.raises(SystemExit) as port:
        mf.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_:
        _jax_script().main(argv)
    assert port.value.code == jax_.value.code == 2


def test_sd3_cache_refusals(tmp_path):
    """SD3's two replays of one step (--model-cache with --cfg-cache) are the
    pipelines' ValueError where the JAX script asserts."""
    args = mf.parse_args(["--family", "sd3", "--ssim", "--cache-interval", "2",
                          "--model-cache", "--cfg-cache", "--device", "cpu"])
    with pytest.raises(ValueError, match="cfg_cache composes with the control cache only"):
        mf.sd3_setup(args, torch.device("cpu"), init_fn=lambda: None,
                     batch={}, vae_params={})


def test_fidelity_bit_for_bit():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((2, 7, 5)).astype(np.float32)
    r = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    jax_script = _jax_script()
    assert mf.fidelity(a, r) == jax_script._fidelity(a, r)
    assert mf.fidelity(r, r) == jax_script._fidelity(r, r)


def test_liven_gates_touches_the_jax_leaves():
    """The gate linears (add_double, add_single) and nothing else change;
    their new values are N(0, 0.02) in the leaf's dtype, as the JAX
    script's."""
    cfg = tpresets.tiny()
    tree = init_unigen_flux_params(cfg, gen=torch.Generator().manual_seed(0))
    before = {p: t.clone() for p, t in tree_leaves_with_path(tree)}
    j_before = to_jax_tree(tree)
    j_after = _jax_script()._liven_gates(j_before)
    after = dict(tree_leaves_with_path(mf.liven_gates(tree, torch.Generator().manual_seed(77))))
    j_after = dict(tree_leaves_with_path(
        jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), j_after)))
    changed = {p for p in before if not torch.equal(before[p], after[p])}
    j_changed = {p for p in before if not torch.equal(before[p], j_after[p])}
    assert changed == j_changed
    assert changed and {p[1] for p in changed} == {"add_double", "add_single"}
    for p in changed:
        assert after[p].dtype == before[p].dtype
        assert 0.01 < float(after[p].std()) < 0.03


def test_ckpt_json_equals_jax_script(fake_ckpt, tmp_path, capsys, monkeypatch):  # noqa: F811
    """--family flux --ckpt --ssim --cache-interval 2 --model-cache on the
    tiny directory, the port handed the JAX script's batch and VAE: its JSON
    against the JAX script's (``held`` of
    ``tests/test_torch_port_fidelity_jax.py``; 4 bf16 steps in two
    frameworks: within two codes), and its --out file the printed line."""
    from tests.test_torch_port_fidelity_jax import held, run_both
    argv = ["--ckpt", fake_ckpt, "--res", "64", "--ssim", "--cache-interval", "2",
            "--model-cache"]
    port, jax_line, pairs = run_both(argv, tmp_path, capsys, monkeypatch)
    held(port, jax_line, pairs, codes=2)
    assert set(port["host"]) == {"bf16", "w8a8", "w4a8_serving"}


def test_full_topology_merges_into_out_only(fake_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """--full-topology merges its section as full_depth into --out and keeps
    the file's other keys; without --out no file is written."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "fid.json"
    out.write_text(json.dumps({"proxy": 1}) + "\n")
    monkeypatch.setattr(mf, "flux_config", lambda args: tpresets.tiny())
    monkeypatch.setattr(mf, "run_paths", lambda args, setup: {
        p: {"fwd": np.ones(3, np.float32)} for p in setup.paths})
    argv = ["--full-topology", "--device", "cpu", "--res", "32"]
    res = mf.main(argv + ["--out", str(out)])
    merged = json.loads(out.read_text())
    assert merged["proxy"] == 1 and merged["full_depth"] == res["json"]
    assert "full_depth_topology" in res["json"]
    mf.main(argv)
    assert sorted(x.name for x in tmp_path.iterdir()) == ["fid.json"]


def test_w4a8_error_on_gaussian_weights_is_jaxs(capsys):
    """One 512-wide W4A8 linear (per-channel int4 weights, per-token int8
    activations) on 256 N(0, 1) tokens, against the float64 product of the
    same bf16 values: on N(0, 0.02) weights, the draw of chip_smoke.py's
    random checkpoint directories, and on U(±1/sqrt(512)), the port's
    linear init. The port's relative L2 error equals the JAX package's on
    each (the int4 codes agree bit for bit, the errors within 1e-3 of each
    other), and the Gaussian draw reads more than 1.5 times the uniform
    one's: the absmax scale of a row of Gaussian weights sits on its
    outliers, so most codes fall in a few of the 15 levels. A stack of such
    layers compounds the gap."""
    import jax.numpy as jnp

    import unigen_tpu.ops.quant as j_quant
    from unigen_tpu_torch.ops import quant as t_quant
    rng = np.random.default_rng(0)
    k = 1 / np.sqrt(512)
    x = torch.from_numpy(rng.standard_normal((256, 512)).astype(np.float32)).bfloat16()
    draws = {"gaussian": 0.02 * rng.standard_normal((512, 512)),
             "uniform": rng.uniform(-k, k, (512, 512))}
    rel = {}
    for name, w in draws.items():
        w = torch.from_numpy(w.astype(np.float32)).bfloat16()
        ref = x.double() @ w.double()
        q = t_quant.quantize_weight_int4(w)
        port = t_quant.int4_matmul(x, q["w_q4"], q["w_scale"]).double()
        jx, jw = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (x, w))
        jq = j_quant.quantize_weight_int4(jw)
        assert np.array_equal(np.asarray(jq["w_q4"]), q["w_q4"].numpy())
        j_out = torch.from_numpy(np.asarray(j_quant.int4_matmul(
            jx, jq["w_q4"], jq["w_scale"]).astype(jnp.float32))).double()
        rel[name] = [float((y - ref).norm() / ref.norm()) for y in (port, j_out)]
        assert abs(rel[name][0] - rel[name][1]) <= 1e-3 * rel[name][1], (name, rel[name])
    with capsys.disabled():
        print(f"\nW4A8 rel_err at width 512 (port, JAX): {rel}")
    assert rel["gaussian"][0] > 1.5 * rel["uniform"][0]
