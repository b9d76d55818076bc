"""The port's profiling tools on the CPU: ``cli.profile_forward``'s eight
phases at the tiny preset against the JAX package's functions composed as
``scripts/profile_forward.py:105-226`` composes them (1e-5 in fp32, the same
numpy tree and inputs for both); both tools' flags against the environment
variables and defaults of the JAX scripts they replace;
``model_flops_per_forward`` against ``bench.model_flops_per_forward``;
``cli.profile_train --preset tiny --device cpu``: its rows and keys, each
policy's first step equal to ``make_train_step``, an out-of-memory error as
a row and any other error raised, and the peak table's refusal of a card
it lacks."""

import json
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tests.torch_port_helpers import assert_close, normal, to_jax_tree
from unigen_tpu import presets as jpresets
from unigen_tpu.layers.blocks_flux import flux_double_block, flux_single_block
from unigen_tpu.layers.core import linear
from unigen_tpu.models.flux import flux_embed_inputs, flux_rope
from unigen_tpu.models.unigen_flux import (control_block_index_table, preprocess_moe,
                                           unigen_flux_forward)
from unigen_tpu.ops.attention import sdpa
from unigen_tpu.utils import index_params
from unigen_tpu_torch import presets as tpresets
from unigen_tpu_torch.cli import profile_forward as pf
from unigen_tpu_torch.cli import profile_train as pt
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, HW, T = 2, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _env_defaults(script):
    """{variable: default} of the ``os.environ.get`` reads of a JAX script."""
    text = (ROOT / "scripts" / script).read_text()
    return dict(re.findall(r'os\.environ\.get\("(UNIGEN_\w+)", "([^"]*)"\)', text))


def test_profile_forward_flags_replace_the_environment():
    env = _env_defaults("profile_forward.py")
    args = pf.parse_args([])
    assert args.preset == env["UNIGEN_BENCH_PRESET"] == "proxy"
    assert args.quant == env["UNIGEN_BENCH_QUANT"] == "bf16"
    assert args.batches == [int(env["UNIGEN_PROFILE_BATCH"])] == [2]
    assert args.res == int(env["UNIGEN_BENCH_RES"]) == 512
    assert args.phases == list(pf.PHASES) and args.out is None and args.device == "cuda"
    assert set(env) == {"UNIGEN_BENCH_PRESET", "UNIGEN_BENCH_QUANT", "UNIGEN_PROFILE_BATCHES",
                        "UNIGEN_PROFILE_BATCH", "UNIGEN_BENCH_RES", "UNIGEN_PROFILE_PHASES"}
    args = pf.parse_args(["--batches", "1,2,4", "--phases", "attn,full", "--preset", "full",
                          "--quant", "w4a8", "--out", "x.json", "--device", "cpu"])
    assert args.batches == [1, 2, 4] and args.phases == ["attn", "full"]
    for bad in (["--phases", "attn,nope"], ["--batches", "a"], ["--quant", "w4"]):
        with pytest.raises(SystemExit):
            pf.parse_args(bad)


def test_profile_train_flags_replace_the_environment():
    env = _env_defaults("profile_train.py")
    args = pt.parse_args([])
    assert args.preset == env["UNIGEN_BENCH_PRESET"] == "full"
    assert args.remats == env["UNIGEN_TRAIN_REMATS"].split(",") == ["full", "dots"]
    assert args.batch == int(env["UNIGEN_BENCH_TRAIN_BATCH"]) == 1
    assert args.res == int(env["UNIGEN_BENCH_RES"]) == 512
    assert args.accum == int(env["UNIGEN_BENCH_TRAIN_ACCUM"]) == 1
    assert args.out is None and args.device == "cuda"
    with pytest.raises(SystemExit):
        pt.parse_args(["--remats", "full,sometimes"])


# ---------------------------------------------------------------- the phases

@pytest.fixture(scope="module")
def world():
    """The tiny fp32 tree and one batch of phase inputs, as both packages
    take them."""
    cfg = tpresets.tiny()
    jcfg = jpresets.tiny()
    params = init_unigen_flux_params(cfg, gen=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    bb = cfg.flux
    s = HW * HW
    heads, hd = bb.num_attention_heads, bb.attention_head_dim
    raw = dict(hidden=normal(rng, B, s, bb.in_channels),
               condition=normal(rng, B, s, bb.in_channels),
               encoder=normal(rng, B, T, bb.joint_attention_dim),
               pooled=normal(rng, B, bb.pooled_projection_dim),
               cond_pooled=normal(rng, B, bb.pooled_projection_dim),
               q=normal(rng, B, heads, T + s, hd), k=normal(rng, B, heads, T + s, hd),
               v=normal(rng, B, heads, T + s, hd),
               timestep=np.full((B,), 0.5, np.float32))
    ids = np.zeros((HW, HW, 3), np.float32)
    ids[..., 1] += np.arange(HW)[:, None]
    ids[..., 2] += np.arange(HW)[None, :]
    raw.update(img_ids=ids.reshape(s, 3), txt_ids=np.zeros((T, 3), np.float32))
    x = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
    jx = {k: jnp.asarray(v) for k, v in raw.items()}
    return cfg, jcfg, params, to_jax_tree(params), x, jx


def _jax_phase(name, params, cfg, x):
    """The JAX script's composition of phase ``name``
    (scripts/profile_forward.py:105-226), as Python loops over the blocks."""
    bb, cc = cfg.flux, cfg.control
    heads = bb.num_attention_heads
    base, ctrl = params["base"], params["control"]
    ids_i, ids_t = x["img_ids"], x["txt_ids"]

    def embed():
        return flux_embed_inputs(base, bb, x["hidden"], x["encoder"], x["pooled"],
                                 x["timestep"], None)
    rope_base = flux_rope(bb, jnp.concatenate([ids_t, ids_i], axis=0))
    if name == "embed":
        h, enc, temb = embed()
        return h, enc, temb, rope_base[0]
    if name == "attn":
        out_x = jnp.zeros((B, x["q"].shape[2], x["q"].shape[3]), x["q"].dtype)
        for _ in range(bb.num_layers + bb.num_single_layers):
            q_i = x["q"] + jnp.asarray(1e-6, x["q"].dtype) * out_x[:, None]
            out_x = sdpa(q_i, x["k"], x["v"], impl="auto", rope=rope_base).mean(axis=1)
        return out_x
    h, enc, temb = embed()
    if name in ("double", "double_cn"):
        n_cn = bb.num_layers // cc.single_control_dev
        table = control_block_index_table(bb.num_layers, n_cn)
        rope_cn = flux_rope(bb, jnp.concatenate([ids_i, ids_t], axis=0))
        control_enc = linear(ctrl["context_embedder"], enc)
        for i in range(bb.num_layers):
            enc, h = flux_double_block(index_params(base["double_blocks"], i), h, enc, temb,
                                       rope_base, heads=heads)
            if name == "double_cn":
                _, cn_out = flux_double_block(index_params(ctrl["double_blocks"], table[i]),
                                              h, control_enc, temb, rope_cn, heads=heads,
                                              context_first=False)
                h = h + linear(index_params(ctrl["add_double"], table[i]), cn_out)
        return h
    if name == "moe":
        return preprocess_moe(ctrl, cfg, h, enc, x["condition"], x["pooled"],
                              x["cond_pooled"], x["timestep"], None, ids_i, ids_t,
                              ids_i).moe_hidden
    if name in ("single", "single_cn"):
        n = bb.num_single_layers
        table = control_block_index_table(n, n // cc.single_control_dev)
        stream = jnp.concatenate([enc, h], axis=1)
        for i in range(n):
            stream = flux_single_block(index_params(base["single_blocks"], i), stream, temb,
                                       rope_base, heads=heads)
            if name == "single_cn":
                cn_out = flux_single_block(index_params(ctrl["single_blocks"], table[i]),
                                           stream, temb, rope_base, heads=heads)
                stream = stream + linear(index_params(ctrl["add_single"], table[i]), cn_out)
        return stream
    pred, _, _ = unigen_flux_forward(
        params, cfg, hidden=x["hidden"], condition=x["condition"], encoder=x["encoder"],
        pooled=x["pooled"], condition_pooled=x["cond_pooled"], timestep=x["timestep"],
        img_ids=ids_i, txt_ids=ids_t, condition_ids=ids_i, attn_impl="auto")
    return pred


@pytest.mark.parametrize("name", pf.PHASES)
def test_phase_matches_jax_composition(world, name):
    cfg, jcfg, params, jparams, x, jx = world
    with torch.no_grad():
        got = pf.PHASE_FNS[name](params, cfg, x)
    want = _jax_phase(name, jparams, jcfg, jx)
    if name == "embed":
        for g, w in zip(got, want):
            assert_close(g, w, 1e-5)
    else:
        assert_close(got, want, 1e-5)


def test_profile_forward_main_tiny(world, tmp_path, capsys, monkeypatch):
    """The sweep form on a handed-in tree (one timed call a phase): every
    phase at each batch, the control differences, per-image scaling, the
    --out file equal to the printed line; the full phase's output is the
    forward's."""
    monkeypatch.setattr(pf, "BURSTS", 1)
    monkeypatch.setattr(pf, "CALLS", 1)
    cfg, _, params, _, _, _ = world
    out = tmp_path / "p.json"
    res = pf.main(["--preset", "tiny", "--batches", "1,2", "--res", "64", "--device", "cpu",
                   "--out", str(out)], params=params)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert res["json"] == json.loads(line) == json.loads(
        out.read_text())
    sweep = res["json"]["sweep"]
    assert [e["batch"] for e in sweep] == [1, 2]
    for e in sweep:
        assert set(e["phase_ms"]) == set(pf.PHASES) | {"control_double_ms",
                                                       "control_single_ms"}
        assert set(e["first_call_s"]) == set(pf.PHASES)
    lo, hi = sweep[0]["phase_ms_per_img"], sweep[1]["phase_ms_per_img"]
    assert res["json"]["per_img_scaling"] == {      # a difference can time at or below 0
        k: round(hi[k] / lo[k], 3) for k in hi if lo[k] > 0}
    x = pf.make_inputs(cfg, 2, 64, torch.device("cpu"))
    with torch.no_grad():
        assert torch.equal(res["outputs"][2]["full"], pf.full_phase(params, cfg, x))


# ---------------------------------------------------------------- FLOPs, train

@pytest.mark.parametrize("preset", ["tiny", "flux_bench", "flux_full"])
def test_model_flops_matches_bench(preset):
    cfg, jcfg = getattr(tpresets, preset)(), getattr(jpresets, preset)()
    for s_img, s_txt in ((1024, 512), (256, 512), (16, 8)):
        assert (pt.model_flops_per_forward(cfg, s_img, s_txt, s_img)
                == bench.model_flops_per_forward(jcfg, s_img, s_txt, s_img))


def test_profile_train_tiny(tmp_path, capsys, monkeypatch):
    """Each policy's row with every key (one timed call a program); each
    first step's loss equals one make_train_step call on the same state and
    inputs; no MFU on the CPU; the JSON written only where --out says."""
    monkeypatch.setattr(pt, "BURSTS", 1)
    monkeypatch.setattr(pt, "CALLS", 1)
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.train import train_step as ts
    out = tmp_path / "t.json"
    rep = pt.main(["--preset", "tiny", "--remats", "full,dots,none", "--device", "cpu",
                   "--out", str(out)])
    assert json.loads(out.read_text()) == rep
    assert rep["peak_ops"] is None and rep["res"] == 64
    assert rep["flops_step_model"] == 3 * pt.model_flops_per_forward(
        tpresets.tiny(), 16, 8, 16)
    cfg = tpresets.tiny()
    params = pt.init_trees(cfg, "tiny", torch.device("cpu"))
    trainable, frozen = pt.split(params, "tiny")
    batch, draws, _, _ = pt.make_batch(cfg, "tiny", 1, 512, torch.device("cpu"))
    assert list(rep["policies"]) == ["full", "dots", "none"]
    for policy, row in rep["policies"].items():
        assert set(row) == {"fwd_ms", "fwd_bwd_ms", "step_ms", "bwd_ms", "opt_ms",
                            "first_step_loss", "samples_per_sec"}
        assert row["bwd_ms"] == round(row["fwd_bwd_ms"] - row["fwd_ms"], 1)
        tcfg = TrainConfig(train_batch_size=1, remat=policy)
        _, m = ts.make_train_step(cfg, tcfg)(ts.init_train_state(trainable, tcfg), frozen,
                                             batch, draws=draws)
        assert float(m["step_loss"]) == row["first_step_loss"]
    capsys.readouterr()
    pt.main(["--preset", "tiny", "--remats", "none", "--device", "cpu"])
    assert sorted(x.name for x in tmp_path.iterdir()) == ["t.json"]


def test_profile_train_oom_is_a_row_and_other_errors_raise(monkeypatch):
    calls = []

    def oom(*a, **k):
        calls.append(1)
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")
    monkeypatch.setattr(pt, "profile_policy", oom)
    rep = pt.main(["--preset", "tiny", "--remats", "none,full", "--device", "cpu"])
    assert set(rep["policies"]) == {"none", "full"} and len(calls) == 2
    assert all(r["error"].startswith("OutOfMemoryError") for r in rep["policies"].values())

    def broken(*a, **k):
        raise RuntimeError("a fault")
    monkeypatch.setattr(pt, "profile_policy", broken)
    with pytest.raises(RuntimeError, match="a fault"):
        pt.main(["--preset", "tiny", "--remats", "full", "--device", "cpu"])


def test_peak_table():
    assert pt.peak_ops("NVIDIA H100 80GB HBM3") == 1979e12
    with pytest.raises(KeyError, match="no int8 peak"):
        pt.peak_ops("NVIDIA A100-SXM4-80GB")
    assert 394e12 not in pt.INT8_PEAK_OPS.values()
