"""The serving caches of the port against the JAX package on the CPU: the
residual quantization (``ops/quant.quantize_residual``,
``dequantize_residual``, ``residual_buffer``), control-residual capture and
replay in the UniGen-FLUX and UniGen-SD3 forwards at the tiny presets, the
cache loops of ``pipelines/caching.py`` on a cheap deterministic
prediction, the quality profiles and the prompt LRU.

Tolerances: the residual quantization bit for bit; capture and replay
within rtol=atol=2e-3 in fp32 (the repo's golden); a replay of its own
capture at the same state equal to the plain forward bit for bit; the cache
loops within 1e-6 with the same step counts. Quantized replays stay within
``chip_smoke.REPLAY_REL_L2`` of the exact prediction, in both frameworks:
the bound the card's replay check holds."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import assert_close, normal, rel_l2, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.models import unigen_flux as j_flux
from unigen_tpu.models import unigen_sd3 as j_sd3
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.ops.packing import prepare_latent_image_ids
from unigen_tpu.pipelines import caching as j_caching
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.models import unigen_flux as t_flux
from unigen_tpu_torch.models import unigen_sd3 as t_sd3
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.pipelines import caching as t_caching

TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- residuals

def _residual_rows():
    """Random rows, a zero row, rows at +-amax, and rows of .5 ties (amax 127
    and 7 make the int8 and int4 scales exactly 1)."""
    rng = np.random.default_rng(11)
    d = 32
    rows = [normal(rng, 4, d), np.zeros((1, d), np.float32)]
    amax = np.full((1, d), -0.25, np.float32)
    amax[0, 3], amax[0, 17] = 3.0, -3.0
    rows.append(amax)
    for top in (127.0, 7.0):
        ties = (rng.integers(-6, 6, size=(2, d)) + 0.5).astype(np.float32)
        ties[:, 0] = top
        rows.append(ties)
    return np.concatenate(rows).reshape(2, 5, d)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_residual_bit_identical_to_jax(bits, dtype):
    r = _residual_rows()
    jr = jnp.asarray(r, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tr = torch.from_numpy(r).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jd, td = j_quant.quantize_residual(jr, bits), t_quant.quantize_residual(tr, bits)
    assert sorted(jd) == sorted(td)
    for k in jd:
        assert td[k].dtype == {"q": torch.int8, "q4": torch.int8, "s": torch.float32}[k]
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]))
    for out in (jnp.float32, jnp.bfloat16):
        want = j_quant.dequantize_residual(jd, out)
        got = t_quant.dequantize_residual(
            td, torch.float32 if out == jnp.float32 else torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_residual_buffer_matches_jax(bits):
    shape = (3, 2, 5, 8)
    jb = j_quant.residual_buffer(shape, bits, jnp.bfloat16)
    tb = t_quant.residual_buffer(shape, bits, torch.bfloat16)
    if bits == 16:
        jb, tb = {"x": jb}, {"x": tb}
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype).split(".")[-1] == str(jb[k].dtype)
        assert not tb[k].float().abs().sum()


# ---------------------------------------------------------------- FLUX

FLUX = jcfg.tiny_flux_config()
HW, T = 4, 6


@functools.lru_cache(maxsize=None)
def _flux_params():
    jc = jcfg.UniGenConfig(family="flux", flux=FLUX, condition_types=("canny",))
    p = j_flux.init_unigen_flux_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(100)
    for k in ("add_double", "add_single"):
        w = p["control"][k]["w"]
        p["control"][k]["w"] = jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return jc, t_presets.tiny(("canny",)), p, to_torch_tree(p)


def _flux_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    ids = np.array(prepare_latent_image_ids(HW, HW))
    return dict(hidden=normal(rng, b, HW * HW, FLUX.in_channels),
                condition=normal(rng, b, HW * HW, FLUX.in_channels),
                encoder=normal(rng, b, T, FLUX.joint_attention_dim),
                pooled=normal(rng, b, FLUX.pooled_projection_dim),
                condition_pooled=normal(rng, b, FLUX.pooled_projection_dim),
                timestep=np.full((b,), 0.7, np.float32),
                img_ids=ids, txt_ids=np.zeros((T, 3), np.float32), condition_ids=ids)


_j_flux_forward = jax.jit(j_flux.unigen_flux_forward, static_argnums=(1,),
                          static_argnames=("return_control_residuals",
                                           "control_residuals_bits"))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np_tree(x):
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_flux_capture_matches_jax(bits):
    """Captured residuals (unscaled, block 0 + the double scan, then the
    single scan) and the prediction against JAX's; capture leaves the
    prediction's bits as they are."""
    jc, tc, jp, tp = _flux_params()
    batch = _flux_batch(1)
    jpred, _, jo = _j_flux_forward(jp, jc, **_jb(batch), conditioning_scale=0.8,
                                   return_control_residuals=True,
                                   control_residuals_bits=bits)
    plain, _, _ = t_flux.unigen_flux_forward(tp, tc, **_tb(batch), conditioning_scale=0.8)
    tpred, _, to = t_flux.unigen_flux_forward(
        tp, tc, **_tb(batch), conditioning_scale=0.8, return_control_residuals=True,
        control_residuals_bits=bits)
    assert torch.equal(tpred, plain)
    assert_close(tpred, jpred, TOL)
    for j, t in zip(jo["control_residuals"], to["control_residuals"]):
        j, t = _np_tree(j), _np_tree(t)
        if bits == 16:
            assert t.shape == j.shape
            assert_close(t, j, TOL)
        else:
            assert sorted(t) == sorted(j)
            assert_close(t["s"], j["s"], TOL)
            assert_close(t_quant.dequantize_residual(
                {k: torch.from_numpy(v) for k, v in t.items()}, torch.float32),
                j_quant.dequantize_residual(j, jnp.float32), 2 * TOL)
    dbl, sgl = to["control_residuals"]
    lead = (lambda x: x["s"].shape[:3]) if bits < 16 else (lambda x: x.shape[:3])
    assert tuple(lead(dbl)) == (FLUX.num_layers, 2, HW * HW)
    assert tuple(lead(sgl)) == (FLUX.num_single_layers, 2, T + HW * HW)


def test_flux_replay_same_state_is_exact_and_matches_jax_elsewhere():
    jc, tc, jp, tp = _flux_params()
    batch = _flux_batch(2)
    pred0, losses0, outs0 = t_flux.unigen_flux_forward(
        tp, tc, **_tb(batch), return_control_residuals=True)
    res = outs0["control_residuals"]
    pred1, losses1, outs1 = t_flux.unigen_flux_forward(tp, tc, **_tb(batch),
                                                       control_residuals=res)
    assert torch.equal(pred1, pred0)
    assert float(losses1["moe_loss"]) == 0.0 and outs1["expert_counts"] is None
    assert float(losses0["moe_loss"]) != 0.0

    # another state and scale: the port's replay of its residuals against
    # JAX's replay of the same residuals
    other = dict(_flux_batch(3), timestep=np.full((2,), 0.3, np.float32))
    jpred, jl, jo = _j_flux_forward(jp, jc, **_jb(other), conditioning_scale=0.6,
                                    control_residuals=tuple(jnp.asarray(r.numpy())
                                                            for r in res))
    tpred, _, _ = t_flux.unigen_flux_forward(tp, tc, **_tb(other), conditioning_scale=0.6,
                                             control_residuals=res)
    assert_close(tpred, jpred, TOL)
    assert float(jl["moe_loss"]) == 0.0 and jo["expert_counts"] is None


@pytest.mark.parametrize("bits", [8, 4])
def test_flux_quantized_replay_within_the_card_bound(bits):
    """Replaying int8/int4 residuals at the capture's state: JAX's and the
    port's predictions against the exact one, both within
    chip_smoke.REPLAY_REL_L2[bits], and against each other within 2e-3."""
    jc, tc, jp, tp = _flux_params()
    batch = _flux_batch(4)
    exact, _, outs = t_flux.unigen_flux_forward(
        tp, tc, **_tb(batch), return_control_residuals=True, control_residuals_bits=bits)
    tpred, _, _ = t_flux.unigen_flux_forward(tp, tc, **_tb(batch),
                                             control_residuals=outs["control_residuals"])
    _, _, jo = _j_flux_forward(jp, jc, **_jb(batch), return_control_residuals=True,
                               control_residuals_bits=bits)
    jpred, _, _ = _j_flux_forward(jp, jc, **_jb(batch),
                                  control_residuals=jo["control_residuals"])
    bound = chip_smoke.REPLAY_REL_L2[bits]
    assert 0 < rel_l2(tpred, exact) <= bound
    assert rel_l2(jpred, exact) <= bound
    assert_close(tpred, jpred, TOL)


def test_flux_capture_needs_the_single_block_path():
    jc, tc, _, tp = _flux_params()
    tc = dataclasses.replace(tc, control=dataclasses.replace(
        tc.control, use_single_trans_blocks=False))
    with pytest.raises(ValueError, match="single-block control path"):
        t_flux.unigen_flux_forward(tp, tc, **_tb(_flux_batch(5)),
                                   return_control_residuals=True)
    with pytest.raises(ValueError, match="either"):
        t_flux.unigen_flux_forward(tp, tc, **_tb(_flux_batch(5)),
                                   return_control_residuals=True,
                                   control_residuals=(None, None))


# ---------------------------------------------------------------- SD3

SD3 = jcfg.tiny_sd3_config()


@functools.lru_cache(maxsize=None)
def _sd3_params(cn2base):
    kw = dict(use_rope=False, cn2base_method=cn2base)
    jc = jcfg.UniGenConfig(family="sd3", sd3=SD3, condition_types=("depth",),
                           control=jcfg.ControlConfig(**kw))
    tc = tcfg.UniGenConfig(family="sd3", sd3=tcfg.tiny_sd3_config(),
                           condition_types=("depth",), control=tcfg.ControlConfig(**kw))
    p = j_sd3.init_unigen_sd3_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(100)
    w = p["control"]["add_blocks"]["w"]
    p["control"]["add_blocks"]["w"] = jnp.asarray(
        rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return jc, tc, p, to_torch_tree(p)


def _sd3_batch(seed, t):
    rng = np.random.default_rng(seed)
    return dict(hidden=normal(rng, 2, SD3.in_channels, 8, 8),
                condition=normal(rng, 2, SD3.in_channels, 8, 8),
                encoder=normal(rng, 2, 6, SD3.joint_attention_dim),
                pooled=normal(rng, 2, SD3.pooled_projection_dim),
                condition_pooled=normal(rng, 2, SD3.pooled_projection_dim),
                timestep=np.array([t, t / 2], np.float32))


_j_sd3_forward = jax.jit(j_sd3.unigen_sd3_forward, static_argnums=(1,),
                         static_argnames=("return_control_residuals",
                                          "control_residuals_bits"))


@pytest.mark.parametrize("cn2base,bits", [("add", 16), ("CrossAttn", 16), ("add", 8)])
def test_sd3_capture_and_replay_match_jax(cn2base, bits):
    """The raw control-block outputs captured, the prediction unperturbed,
    a replay of bf16 residuals at the same state bit-identical, and a replay
    at another state and scale against JAX's replay of the same residuals."""
    jc, tc, jp, tp = _sd3_params(cn2base)
    batch = _sd3_batch(6, 700.0)
    jpred, _, jo = _j_sd3_forward(jp, jc, **_jb(batch), return_control_residuals=True,
                                  control_residuals_bits=bits)
    plain, _, _ = t_sd3.unigen_sd3_forward(tp, tc, **_tb(batch))
    tpred, _, to = t_sd3.unigen_sd3_forward(tp, tc, **_tb(batch),
                                            return_control_residuals=True,
                                            control_residuals_bits=bits)
    assert torch.equal(tpred, plain)
    assert_close(tpred, jpred, TOL)
    res = to["control_residuals"]
    if bits == 16:
        assert tuple(res.shape) == (SD3.num_layers, 2, 16, SD3.inner_dim)
        assert_close(res, jo["control_residuals"], TOL)
        again, losses, outs = t_sd3.unigen_sd3_forward(tp, tc, **_tb(batch),
                                                       control_residuals=res)
        assert torch.equal(again, plain)
        assert float(losses["moe_loss"]) == 0.0 and outs["expert_counts"] is None
    else:
        assert_close(t_quant.dequantize_residual(res, torch.float32),
                     j_quant.dequantize_residual(jo["control_residuals"], jnp.float32),
                     2 * TOL)
    other = _sd3_batch(7, 300.0)
    jres = jax.tree.map(lambda x: jnp.asarray(x.numpy()), res)
    jpred, _, _ = _j_sd3_forward(jp, jc, **_jb(other), conditioning_scale=0.6,
                                 control_residuals=jres)
    tpred, _, _ = t_sd3.unigen_sd3_forward(tp, tc, **_tb(other), conditioning_scale=0.6,
                                           control_residuals=res)
    assert_close(tpred, jpred, TOL)


# ---------------------------------------------------------------- cache loops

def _scan_inputs():
    rng = np.random.default_rng(21)
    lat = normal(rng, 2, 12, 8)
    w = normal(rng, 8, 8, scale=0.4)
    sig = np.array(j_sched.inference_sigmas(j_sched.FlowMatchConfig(shift=3.0), 8)[0])
    return lat, w, sig


def _preds(w):
    """A cheap deterministic prediction of (latents, step) in each framework."""
    def jpred(lat, i):
        return jnp.tanh(lat @ w) * (1.0 + 0.1 * i)

    tw = torch.from_numpy(w)

    def tpred(lat, i):
        return torch.tanh(lat @ tw) * (1.0 + 0.1 * i)
    return jpred, tpred


@pytest.mark.parametrize("interval,threshold,order", [
    (2, 0.0, 0), (3, 0.0, 1), (4, 0.0, 1), (1, 0.15, 0), (1, 0.15, 1), (1, 0.4, 1)])
def test_model_cache_scan_matches_jax(interval, threshold, order):
    lat, w, sig = _scan_inputs()
    jpred, tpred = _preds(w)
    adaptive = threshold > 0
    jl, jn = j_caching.model_cache_scan(
        jpred, jnp.asarray(lat), sig, 8, cache_interval=interval, adaptive=adaptive,
        threshold=jnp.float32(threshold) if adaptive else None, order=order)
    tl, tn = t_caching.model_cache_scan(
        tpred, torch.from_numpy(lat), torch.from_numpy(sig), 8, cache_interval=interval,
        adaptive=adaptive, threshold=threshold if adaptive else None, order=order)
    assert isinstance(tn, int) and tn == int(jn)
    assert 1 <= tn <= 8
    assert_close(tl, jl, 1e-6)


@pytest.mark.parametrize("c,m,cth,mth,order", [
    (4, 2, 0.0, 0.0, 0), (4, 2, 0.0, 0.0, 1), (6, 3, 0.0, 0.0, 1),
    (1, 1, 0.5, 0.1, 0), (1, 1, 0.5, 0.1, 1), (1, 1, 0.3, 0.05, 1)])
def test_hybrid_cache_scan_matches_jax(c, m, cth, mth, order):
    """Full steps return the prediction and a residual (the step index);
    base steps use the residual."""
    lat, w, sig = _scan_inputs()
    jpred, tpred = _preds(w)
    adaptive = cth > 0

    def jfull(lat, i):
        return jpred(lat, i), jnp.asarray(i, jnp.float32)

    def jbase(lat, i, res):
        return jpred(lat, i) + 0.01 * res

    def tfull(lat, i):
        return tpred(lat, i), torch.tensor(float(i))

    def tbase(lat, i, res):
        return tpred(lat, i) + 0.01 * res

    kw = dict(control_interval=c, model_interval=m, order=order, adaptive=adaptive)
    jout = j_caching.hybrid_cache_scan(
        jfull, jbase, jnp.asarray(lat), sig, 8, residuals_init=jnp.float32(0), **kw,
        control_threshold=jnp.float32(cth) if adaptive else None,
        model_threshold=jnp.float32(mth) if adaptive else None)
    tout = t_caching.hybrid_cache_scan(
        tfull, tbase, torch.from_numpy(lat), torch.from_numpy(sig), 8, **kw, control_threshold=cth if adaptive else None,
        model_threshold=mth if adaptive else None)
    assert (tout[1], tout[2]) == (int(jout[1]), int(jout[2]))
    assert tout[1] >= 1 and all(isinstance(n, int) for n in tout[1:])
    assert_close(tout[0], jout[0], 1e-6)


def test_refresh_decision_and_rel_change_match_jax():
    rng = np.random.default_rng(22)
    a, b = normal(rng, 3, 7), normal(rng, 3, 7)
    r = float(t_caching.rel_change(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(r - float(j_caching.rel_change(jnp.asarray(a), jnp.asarray(b)))) <= 1e-6
    for i, th in ((0, 10.0), (1, r * 0.9), (2, r * 1.1)):
        want = bool(j_caching.refresh_decision(jnp.asarray(i), jnp.asarray(a),
                                               jnp.asarray(b), jnp.float32(th)))
        assert t_caching.refresh_decision(i, torch.from_numpy(a), torch.from_numpy(b),
                                          th) == want


# ---------------------------------------------------------------- profiles, LRU

@pytest.mark.parametrize("profile,explicit,steps", [
    (None, {}, 4), ("exact", {}, 4), ("balanced", {}, 4), ("fast", {}, 8),
    ("fast", {}, 4), ("balanced", {"model_cache_interval": 1}, 28)])
def test_quality_profile_knobs_match_jax(profile, explicit, steps):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = j_caching.quality_profile_knobs(profile, j_caching.PROFILE_TABLES["flux"],
                                               explicit, num_steps=steps)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_caching.quality_profile_knobs(profile, t_caching.PROFILE_TABLES["flux"],
                                              explicit, num_steps=steps)
    assert got == want and len(tw) == len(jw)
    assert t_caching.PROFILE_TABLES == j_caching.PROFILE_TABLES


@pytest.mark.parametrize("profile,explicit", [
    ("balanced", {"control_cache_interval": 2}),
    ("fast", {"control_cache_threshold": 0.2}),
    ("turbo", {})])
def test_quality_profile_errors_match_jax(profile, explicit):
    for lib in (j_caching, t_caching):
        with pytest.raises(ValueError):
            lib.quality_profile_knobs(profile, lib.PROFILE_TABLES["flux"], explicit)


def test_prompt_lru_counts_match_jax():
    keys = ["a", "a", "b", "c", "a", "b", "b", "d", "c"]
    for cap in (0, 2, 3):
        j, t = j_caching.PromptLRU(cap), t_caching.PromptLRU(cap)
        jv = [j.get_or(k, lambda k=k: k + "!") for k in keys]
        tv = [t.get_or(k, lambda k=k: k + "!") for k in keys]
        assert tv == jv and (t.hits, t.misses) == (j.hits, j.misses)
