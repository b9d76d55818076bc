"""LoRA in the port (``models/lora.py``, LoRA training in ``train/
train_step.py``, the LoRA half of ``io/torch_bridge.py``, ``UniGenFlux
Pipeline.load_lora`` and ``load_flux_pipeline(lora_dir=...)``) against the
JAX package on the CPU, at the tiny preset. The factors are drawn
differently in the two packages (a torch generator, a JAX key), so JAX's
adapters cross to the port as numpy.

Tolerances: fp folds, gradients and the training losses within the repo's
2e-3 (``tests/test_torch_e2e_golden.py:359``), gradients as relative L2;
re-quantized int8/int4 codes and scales bit for bit (the eager fold divides
as JAX's eager one does; the switcher follows what XLA compiles under
``jax.jit``: one fused multiply-add, the reciprocal scale); files, names and
loaded factors bit for bit; uint8 images within one code."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from torch_port_helpers import normal, rel_l2, to_torch_tree
from unigen_tpu import config as j_config
from unigen_tpu.io import torch_bridge as j_tb
from unigen_tpu.models import lora as j_lora
from unigen_tpu.models import vae as j_vae
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.pipelines import loading as j_load
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu.pipelines.flux import UniGenFluxPipeline as JPipe
from unigen_tpu.train import train_step as j_ts
from unigen_tpu_torch import config as t_config
from unigen_tpu_torch.io import torch_bridge as t_tb
from unigen_tpu_torch.models import lora as t_lora
from unigen_tpu_torch.models import vae as t_vae
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.pipelines import loading as t_load
from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline as TPipe
from unigen_tpu_torch.train import train_step as t_ts
from unigen_tpu_torch.utils import tree_leaves, tree_leaves_with_path

B, C, LAT, T = 2, 4, 8, 6
# a zero-init add gate (the only factors with live gradients at step 0) and
# interior linears whose gradient opens once the gate moves, as the JAX
# package's tests/test_lora_training.py takes them
TARGETS = ("control.add_double", "control.add_single",
           "control.double_blocks.attn.to_q", "control.single_blocks.proj_mlp")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@functools.lru_cache(maxsize=None)
def _world():
    """(JAX cfg, port cfg, JAX fp32 tree): the tiny preset, per-sample
    routing."""
    moe = dict(batch_mode="per_sample")
    jc = j_config.UniGenConfig(family="flux", flux=j_config.tiny_flux_config(),
                               condition_types=("canny",),
                               control=j_config.ControlConfig(moe=j_config.MoEConfig(**moe)))
    tc = t_config.UniGenConfig(family="flux", flux=t_config.tiny_flux_config(),
                               condition_types=("canny",),
                               control=t_config.ControlConfig(moe=t_config.MoEConfig(**moe)))
    # the port's init (a tenth of a second, where JAX's eager init of the
    # tiny preset takes ten), handed to JAX as arrays: the same layout
    p = init_unigen_flux_params(tc, gen=torch.Generator().manual_seed(0), device="cpu")
    return jc, tc, jax.tree.map(lambda t: jnp.asarray(t.numpy()), p,
                                is_leaf=lambda t: isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _frozen(kind):
    """The JAX tree with its control branch fp ("fp"), int8 ("int8"), int4
    ("int4") or under the W4A8 serving policy ("w4a8"), with the gate
    lowered to 16 so the tiny linears take it; quantized by the port's
    ``quantize_tree``, which gives the JAX function's eager bits
    (``tests/test_torch_port_ops.py``) in a fraction of its time here."""
    _, _, p = _world()
    if kind == "fp":
        return p
    q = functools.partial(t_quant.quantize_tree, min_dim=16)
    tp = to_torch_tree(p)
    if kind == "w4a8":
        tq = {"base": q(tp["base"], bits=4),
              "control": {k: q(v, bits=4 if k in ("double_blocks", "single_blocks") else 8)
                          for k, v in tp["control"].items()}}
    else:
        tq = {"base": tp["base"], "control": q(tp["control"], bits=8 if kind == "int8" else 4)}
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tq,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _adapters(targets=TARGETS, names=("canny", "depth"), rank=2):
    """JAX adapters with nonzero ``b`` factors drawn with numpy."""
    _, _, p = _world()
    ad = j_lora.init_lora_adapters(jax.random.PRNGKey(1), p, targets=list(targets),
                                   rank=rank, adapter_names=list(names))
    g = np.random.default_rng(9)
    return {n: {path: {"a": ab["a"], "b": jnp.asarray(
        0.05 * g.standard_normal(ab["b"].shape).astype(np.float32))}
        for path, ab in lora.items()} for n, lora in ad.items()}


def _node_equal(t_node, j_node):
    for k, v in j_node.items():
        np.testing.assert_array_equal(t_node[k].numpy(), np.asarray(v), err_msg=k)


def test_init_lora_adapters_paths_and_shapes_match_jax():
    """The same target paths, factor shapes and dtypes from
    DEFAULT_LORA_TARGETS; ``b`` starts at zero, ``a`` at N(0, 1/in)."""
    _, _, p = _world()
    want = j_lora.init_lora_adapters(jax.random.PRNGKey(1), p,
                                     targets=j_lora.DEFAULT_LORA_TARGETS, rank=3,
                                     adapter_names=["x"])["x"]
    got = t_lora.init_lora_adapters(to_torch_tree(p), t_lora.DEFAULT_LORA_TARGETS, 3, ["x"],
                                    gen=torch.Generator().manual_seed(1))["x"]
    assert t_lora.DEFAULT_LORA_TARGETS == j_lora.DEFAULT_LORA_TARGETS
    assert sorted(got) == sorted(want)
    for path, ab in want.items():
        for k in ("a", "b"):
            assert tuple(got[path][k].shape) == ab[k].shape
            assert got[path][k].dtype == torch.float32
        assert not got[path]["b"].any() and got[path]["a"].any()
    a = got["control.add_single"]["a"]
    assert abs(float(a.std()) * a.shape[-2] ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_fold_adapter_matches_jax(kind):
    """The eager fold: fp weights within 2e-3; re-quantized codes and scales
    bit for bit (0 codes differ). ``fold_condition_experts`` and
    ``enable_lora`` fold the same."""
    jt, ad = _frozen(kind), _adapters()
    want = j_lora.fold_adapter(jt, ad, "canny", scale=0.7)
    tt, tad = to_torch_tree(jt), to_torch_tree(ad)
    got = t_lora.fold_adapter(tt, tad, "canny", scale=0.7)
    for path in ad["canny"]:
        g, w = t_lora.tree_get(got, path), t_lora.tree_get(want, path)
        if kind == "fp":
            np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]), rtol=2e-3, atol=2e-3)
        else:
            _node_equal(g, w)
    other = "control.double_blocks.attn.to_k"
    assert t_lora.tree_get(got, other) is t_lora.tree_get(tt, other)
    same = t_lora.fold_condition_experts(tt, tad, "canny", scale=0.7)
    with t_lora.enable_lora(tt, tad, ["canny"], scale=0.7) as folded:
        for path in ad["canny"]:
            for tree in (same, folded):
                for k, v in t_lora.tree_get(got, path).items():
                    assert torch.equal(t_lora.tree_get(tree, path)[k], v)
    with pytest.raises(KeyError, match="no LoRA adapter"):
        t_lora.fold_condition_experts(tt, tad, "seg")


@pytest.mark.parametrize("pristine", ["device", "host"])
def test_lora_switcher_matches_jax_and_cycles_without_drift(pristine):
    """On the int4 tree: the switcher's fold equals JAX's jitted one bit for
    bit; cycling canny -> depth -> both -> none -> canny gives canny's bits
    again and none gives the pristine tree (no drift, no stacked
    requantization)."""
    jt, ad = _frozen("int4"), _adapters()
    want = j_lora.LoraSwitcher(ad, jt).switch(jt, "canny")
    tt = to_torch_tree(jt)
    sw = t_lora.LoraSwitcher(to_torch_tree(ad), tt, pristine=pristine)
    first = sw.switch(tt, "canny")
    for path in ad["canny"]:
        _node_equal(t_lora.tree_get(first, path), t_lora.tree_get(want, path))
    live = first
    for names in ("depth", ["canny", "depth"], None, "canny"):
        live = sw.switch(live, names)
        if names is None:
            for path in ad["canny"]:
                for k, v in t_lora.tree_get(tt, path).items():
                    assert torch.equal(t_lora.tree_get(live, path)[k], v)
    assert sw.switch(live, "canny") is live                # already active
    for path in ad["canny"]:
        for k, v in t_lora.tree_get(first, path).items():
            assert torch.equal(t_lora.tree_get(live, path)[k], v)
    assert t_lora.merge_for_export(sw.adapters, "canny").keys() == \
        j_lora.merge_for_export(ad, "canny").keys()


@pytest.mark.parametrize("kind", ["fp", "int8", "int4"])
def test_fold_for_training_gradients_match_jax(kind):
    """d/d(a, b) of sum(folded w * R) over every target, against
    ``jax.grad`` of JAX's fold, within 2e-3 relative L2; the folded nodes
    drop their codes and take the bias's dtype."""
    jt, ad = _frozen(kind), _adapters()
    rng = np.random.default_rng(3)
    weights = {p: normal(rng, *(t_lora.tree_get(to_torch_tree(jt), p)["b"].shape[:-1]
                                + (ad["canny"][p]["a"].shape[-2],
                                   ad["canny"][p]["b"].shape[-1])))
               for p in ad["canny"]}

    def j_loss(lora):
        folded = j_lora.fold_for_training(jt, lora, scale=0.5)
        return sum(jnp.sum(j_lora.tree_get(folded, p)["w"].astype(jnp.float32) * r)
                   for p, r in weights.items())
    want = jax.grad(j_loss)(ad["canny"])
    lora = {p: {k: v.detach().requires_grad_() for k, v in ab.items()}
            for p, ab in to_torch_tree(ad["canny"]).items()}
    folded = t_lora.fold_for_training(to_torch_tree(jt), lora, scale=0.5)
    loss = sum((t_lora.tree_get(folded, p)["w"].float() * torch.from_numpy(r)).sum()
               for p, r in weights.items())
    loss.backward()
    for p in weights:
        node = t_lora.tree_get(folded, p)
        assert not any(k in node for k in ("w_q", "w_q4", "w_scale"))
        assert node["w"].dtype == torch.float32
        for k in ("a", "b"):
            assert rel_l2(lora[p][k].grad, want[p][k]) <= 2e-3, (p, k)


def _batch(seed):
    bb = j_config.tiny_flux_config()
    rng = np.random.default_rng(seed)
    raw = dict(latents=normal(rng, B, C, LAT, LAT),
               condition_latents=normal(rng, B, C, LAT, LAT),
               prompt_embeds=normal(rng, B, T, bb.joint_attention_dim),
               pooled=normal(rng, B, bb.pooled_projection_dim),
               condition_pooled=normal(rng, B, bb.pooled_projection_dim))
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def _jax_draws(key, latents):
    r_noise, r_t, _ = jax.random.split(key, 3)
    return t_ts.Draws(torch.from_numpy(np.array(jax.random.normal(r_noise, latents.shape))),
                      torch.from_numpy(np.array(j_sched.sample_timestep_density(
                          r_t, latents.shape[0], "none"))))


@pytest.mark.parametrize("kind", ["fp", "w4a8"])
def test_lora_train_step_matches_jax_over_two_updates(kind, monkeypatch):
    """``make_train_step`` in LoRA mode over the frozen control branch (fp,
    or W4A8 under the serving policy: the targeted linears are dequantized
    into the fold), two updates fed JAX's draws: losses and grad norms
    within 2e-3, the factors after each update within 2e-3; at step 0 only
    the add gates' factors move, at step 1 all do; the optimizer state holds
    factors only. The step calls each kernel entry point as
    ``chip_smoke.expected_train_launches(..., lora=True)`` of the folded tree
    says: the targeted linears left the W4A8 count, and the frozen MoE
    preprocess's attention calls get no backward."""
    import chip_smoke
    from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm
    jc, tc, _ = _world()
    jt = _frozen(kind)
    ad = j_lora.init_lora_adapters(jax.random.PRNGKey(1), _world()[2], targets=list(TARGETS),
                                   rank=2, adapter_names=["canny"])["canny"]
    kw = dict(max_train_steps=4, train_batch_size=B, remat="full", lora_rank=2,
              lora_targets=TARGETS, learning_rate=1e-3, lr_warmup_steps=0,
              lr_scheduler="constant")
    jtc, ttc = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    j_base = {"base": jt["base"], "control_frozen": jt["control"]}
    t_base = {"base": to_torch_tree(jt["base"]), "control_frozen": to_torch_tree(jt["control"])}
    jstate = j_ts.init_train_state(ad, jtc)
    tstate = t_ts.init_train_state(to_torch_tree(ad), ttc)
    j_step, t_step = jax.jit(j_ts.make_train_step(jc, jtc)), t_ts.make_train_step(tc, ttc)
    calls = {}

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        return wrapper
    for mod, name, key in ((t_fa, "flash_attention_rope_fwd", "flash_attention_rope"),
                           (t_fa, "flash_attention_rope_bwd", "flash_attention_rope_bwd_dq"),
                           (t_qm, "w4a8_matmul", "w4a8_matmul"),
                           (t_qm, "quantize_act", "quantize_act")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    jbatch, tbatch = _batch(2)
    for i in range(2):
        key = jax.random.PRNGKey(5 + i)
        jstate, jm = j_step(jstate, j_base, jbatch, key)
        calls.clear()
        tstate, tm = t_step(tstate, t_base, tbatch, draws=_jax_draws(key, jbatch["latents"]))
        for k in ("step_loss", "flow_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-3)
        for path, ab in jstate.control.items():
            for k in ("a", "b"):
                np.testing.assert_allclose(tstate.control[path][k].numpy(), np.asarray(ab[k]),
                                           rtol=2e-3, atol=2e-3)
            moved = float(tstate.control[path]["b"].abs().max()) > 0
            assert moved == (i == 1 or path.startswith("control.add_")), (i, path)
    shapes = {tuple(x.shape) for x in tree_leaves(tstate.control)}
    assert all(tuple(x.shape) in shapes for x in tree_leaves(tstate.opt_state.mu))
    folded = t_lora.fold_for_training({"base": t_base["base"],
                                       "control": t_base["control_frozen"]}, tstate.control)
    want = chip_smoke.expected_train_launches(folded, tc, B, lora=True)
    assert calls == {k: want[k] for k in calls}
    assert calls["flash_attention_rope_bwd_dq"] < \
        chip_smoke.expected_train_launches(folded, tc, B)["flash_attention_rope_bwd_dq"]
    if kind == "w4a8":
        whole = chip_smoke.expected_train_launches(to_torch_tree(jt), tc, B)["w4a8_matmul"]
        assert 0 < want["w4a8_matmul"] < whole


def test_lora_export_and_load_both_directions(tmp_path):
    """JAX's export read by the port's loader gives JAX's loaded factors;
    the port's export holds JAX's file's names and arrays (read by
    ``safetensors.numpy``) and JAX's loader reads it back to the adapters
    exported. A PEFT ``.alpha`` is folded into ``b`` as alpha / rank in both
    packages; a key that maps to nothing raises under ``strict``."""
    from safetensors.numpy import load_file, save_file
    _, _, p = _world()
    ad = _adapters()
    j_tb.export_lora_adapters_reference(ad, str(tmp_path / "jax"))
    t_tb.export_lora_adapters_reference(to_torch_tree(ad), str(tmp_path / "port"))
    for name in ad:
        jf = load_file(str(tmp_path / "jax" / name / "pytorch_lora_weights.safetensors"))
        tf = load_file(str(tmp_path / "port" / name / "pytorch_lora_weights.safetensors"))
        assert sorted(jf) == sorted(tf)
        for k in jf:
            assert jf[k].dtype == tf[k].dtype and np.array_equal(jf[k], tf[k]), k
    tp = to_torch_tree(p)
    got = t_tb.load_lora_adapters(str(tmp_path / "jax"), tp, device="cpu")
    want = j_tb.load_lora_adapters(str(tmp_path / "jax"), p)
    back = j_tb.load_lora_adapters(str(tmp_path / "port"), p)
    assert sorted(got) == sorted(want) == sorted(ad)
    for name in ad:
        assert sorted(got[name]) == sorted(want[name]) == sorted(ad[name])
        for path in ad[name]:
            for k in ("a", "b"):
                np.testing.assert_array_equal(got[name][path][k].numpy(),
                                              np.asarray(want[name][path][k]))
                np.testing.assert_array_equal(np.asarray(back[name][path][k]),
                                              np.asarray(ad[name][path][k]))
    sd = load_file(str(tmp_path / "jax" / "canny" / "pytorch_lora_weights.safetensors"))
    sd["transformer.controlnet_add_single_blocks.0.alpha"] = np.asarray(4.0, np.float32)
    os.makedirs(tmp_path / "alpha" / "canny")
    save_file(sd, str(tmp_path / "alpha" / "canny" / "pytorch_lora_weights.safetensors"))
    ja = j_tb.load_lora_adapters(str(tmp_path / "alpha"), p)["canny"]["control.add_single"]
    ta = t_tb.load_lora_adapters(str(tmp_path / "alpha"), tp, device="cpu")["canny"][
        "control.add_single"]
    np.testing.assert_array_equal(ta["b"].numpy(), np.asarray(ja["b"]))
    assert not np.array_equal(ta["b"].numpy(), np.asarray(ad["canny"]["control.add_single"]["b"]))
    sd["transformer.nowhere.lora_A.weight"] = np.zeros((2, 2), np.float32)
    save_file(sd, str(tmp_path / "alpha" / "canny" / "pytorch_lora_weights.safetensors"))
    with pytest.raises(ValueError, match="mapped to nothing"):
        t_tb.load_lora_adapters(str(tmp_path / "alpha"), tp, device="cpu")


def test_safetensors_writer_every_dtype(tmp_path):
    """The port's writer against the ``safetensors`` package: every dtype,
    a 0-d and an empty tensor; read back by both readers."""
    from safetensors.torch import load_file
    g = torch.Generator().manual_seed(0)
    tensors = {f"t_{dt}".replace("torch.", ""): (torch.randn(3, 5, generator=g) * 50).to(dt)
               for dt in t_tb.SAFETENSORS_DTYPES.values()}
    tensors["scalar"] = torch.tensor(2.5)
    tensors["empty"] = torch.zeros(0, 4, dtype=torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    n = t_tb.write_safetensors(tensors, path)
    assert n == os.path.getsize(path)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    for reader in (load_file, t_tb.read_safetensors):
        back = reader(path)
        assert back.keys() == tensors.keys()
        for k, v in tensors.items():
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def _pipes(params_j, params_t):
    jv, tv = j_vae.tiny_vae_config(), t_vae.tiny_vae_config()
    vp = j_vae.init_vae_params(jax.random.PRNGKey(3), jv)
    jc, tc, _ = _world()
    return (JPipe(cfg=jc, params=params_j, vae_cfg=jv, vae_params=vp, dtype=jnp.float32),
            TPipe(cfg=tc, params=params_t, vae_cfg=tv, vae_params=to_torch_tree(vp),
                  dtype=torch.float32, device="cpu"))


def test_pipeline_load_lora_generate_matches_jax():
    """``load_lora`` of an adapters dict, ``set_condition_adapter`` and
    ``generate`` on the int8 tree (live add gates) in both pipelines: the
    switched trees bit for bit, the images within one uint8 code; the
    condition call's ``_auto_switch`` and ``multi_condition_call`` select
    adapters as JAX's do."""
    _, _, p = _world()
    rng = np.random.default_rng(100)
    control = dict(p["control"])
    for k in ("add_double", "add_single"):
        w = control[k]["w"]
        control[k] = dict(control[k], w=jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32)))
    tq = t_quant.quantize_tree(to_torch_tree(control), min_dim=16)
    jt = {"base": p["base"], "control": jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), tq, is_leaf=lambda t: isinstance(t, torch.Tensor))}
    ad = _adapters()
    jpipe, tpipe = _pipes(jt, to_torch_tree(jt))
    jpipe.load_lora(ad)
    tpipe.load_lora(to_torch_tree(ad))
    jpipe.set_condition_adapter("canny", scale=2.0)
    tpipe.set_condition_adapter("canny", scale=2.0)
    for path in ad["canny"]:
        _node_equal(t_lora.tree_get(tpipe.params, path), t_lora.tree_get(jpipe.params, path))
    x = dict(prompt_embeds=normal(rng, 1, T, 32), pooled=normal(rng, 1, 24),
             cond_pooled=normal(rng, 1, 24),
             control_pixels=rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32),
             latents=normal(rng, 1, 64, 16))
    jimg = jpipe.generate(**{k: jnp.asarray(v) for k, v in x.items()}, height=32, width=32,
                          num_inference_steps=2)
    timg = tpipe.generate(**x, height=32, width=32, num_inference_steps=2)
    assert np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1
    tpipe._auto_switch("depth")
    assert tpipe._lora.active == (("depth", 1.0),)
    tpipe._auto_switch(["depth", "seg"])                  # mixed: unchanged
    assert tpipe._lora.active == (("depth", 1.0),)
    tpipe.set_condition_adapter(None)
    for path in ad["canny"]:
        for k, v in t_lora.tree_get(to_torch_tree(jt), path).items():
            assert torch.equal(t_lora.tree_get(tpipe.params, path)[k], v)


def test_load_flux_pipeline_lora_dir_matches_jax(fake_ckpt, tmp_path,  # noqa: F811
                                                 monkeypatch):
    """``load_flux_pipeline(lora_dir=...)`` on a random FLUX directory and
    adapters written in the reference's layout: the port's pipeline holds
    the loaded factors of JAX's, and both fold them into the same tree (a
    W4A8 serving tree with the gate lowered to 16: bit for bit)."""
    fp = t_load.load_flux_pipeline(fake_ckpt, dtype=torch.float32, device="cpu").params
    ad = t_lora.init_lora_adapters(fp, t_lora.DEFAULT_LORA_TARGETS, 2, ["canny"],
                                   gen=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    for ab in ad["canny"].values():
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=g)
    t_tb.export_lora_adapters_reference(ad, str(tmp_path))
    for mod in (j_quant, t_quant):
        monkeypatch.setattr(mod, "quantize_tree_streaming", functools.partial(
            mod.quantize_tree_streaming, min_dim=16))
    jp = j_load.load_flux_pipeline(fake_ckpt, dtype=jnp.float32, quantize="w4a8",
                                   lora_dir=str(tmp_path))
    tp = t_load.load_flux_pipeline(fake_ckpt, dtype=torch.float32, quantize="w4a8",
                                   lora_dir=str(tmp_path), device="cpu")
    assert sorted(tp._lora.adapters) == sorted(jp._lora.adapters) == ["canny"]
    for path, ab in jp._lora.adapters["canny"].items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(tp._lora.adapters["canny"][path][k].numpy(),
                                          np.asarray(ab[k]))
    jp.set_condition_adapter("canny")
    tp.set_condition_adapter("canny")
    assert any(p[-1] == "w_q4" for p, _ in tree_leaves_with_path(tp.params["control"]))
    for path in ad["canny"]:
        _node_equal(t_lora.tree_get(tp.params, path), t_lora.tree_get(jp.params, path))
