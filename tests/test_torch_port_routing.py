"""The routing the port took over in this slice, against the JAX package on
the CPU: ``top1_gate`` with random token selection fed JAX's own uniform
draw (experts overflowing their capacity), ``top2_gate`` with DeepSpeed's
second-choice offset, the dense einsum ``dispatch``/``combine``, and
``moe_apply`` with top-2, with the dense top-1 path and with random token
selection in training (per-sample and global). Then the consis module in a
UniGen-FLUX forward and in a training step's gradients (fed JAX's draws,
the MoE's included), and ``remat="dots"``: the same gradients as "full"
and "none", and the kernel calls of ``chip_smoke.expected_train_launches``.

Tolerances: masks, slots, kept flags, expert choices and counts bit for
bit; gate weights within 1e-6; fp32 model outputs within the repo's 2e-3
(``tests/test_torch_e2e_golden.py:359``); gradients within 2e-3 relative
L2."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import as_np, normal, rel_l2, to_torch_tree
from unigen_tpu import config as j_config
from unigen_tpu.models import moe as j_moe
from unigen_tpu.models.unigen_flux import init_unigen_flux_params as j_init
from unigen_tpu.models.unigen_flux import unigen_flux_forward as j_fwd
from unigen_tpu.ops import gating as j_gating
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu.train import train_step as j_ts
from unigen_tpu_torch import config as t_config
from unigen_tpu_torch.models import moe as t_moe
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward as t_fwd
from unigen_tpu_torch.ops import gating as t_gating
from unigen_tpu_torch.train import train_step as t_ts
from unigen_tpu_torch.utils import tree_leaves, tree_map

B, C, LAT, T = 2, 4, 8, 6            # 8x8 latents -> 16 packed tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _logits(seed, s, e, hot=0, bias=2.0):
    """Logits [s, e] leaning to expert ``hot``, so that it overflows."""
    x = np.random.default_rng(seed).standard_normal((s, e)).astype(np.float32)
    x[:, hot] += bias
    return x


def _gates_equal(t, j):
    np.testing.assert_array_equal(t.dispatch_mask.numpy(), np.asarray(j.dispatch_mask))
    np.testing.assert_array_equal(t.expert_counts.numpy(), np.asarray(j.expert_counts))
    np.testing.assert_allclose(t.combine_weights.numpy(), np.asarray(j.combine_weights),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(t.aux_loss), float(j.aux_loss), rtol=1e-6)


@pytest.mark.parametrize("capacity", [3, 7, 40])
def test_top1_rts_matches_jax_on_its_draw(capacity):
    """Random token selection keeps, per expert, the ``capacity`` tokens of
    highest uniform priority: on JAX's own draw the port keeps the same
    tokens in the same slots, with the hot expert over capacity (3, 7) and
    not (40)."""
    logits = _logits(0, 40, 4)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (40, 4)))
    j = j_gating.top1_gate(jnp.asarray(logits), capacity, rng=key, use_rts=True)
    t = t_gating.top1_gate(torch.from_numpy(logits), capacity,
                           uniform=torch.from_numpy(u), use_rts=True)
    _gates_equal(t, j)
    for name in ("expert_idx", "slot", "kept"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_allclose(t.gate_scalar.numpy(), np.asarray(j.gate_scalar), atol=1e-6)
    kept_hot = int(t.kept[t.expert_idx == 0].sum())
    assert kept_hot == min(capacity, int(t.expert_counts[0]))
    if capacity < int(t.expert_counts[0]):       # RTS is not token order here
        order = t_gating.top1_gate(torch.from_numpy(logits), capacity)
        assert not torch.equal(order.kept, t.kept)


@pytest.mark.parametrize("capacity", [4, 12])
def test_top2_gate_and_dense_dispatch_combine_match_jax(capacity):
    """Top-2 with the second choice's slots offset by the pre-capacity top-1
    count (capacity 4: the hot expert admits no second choices), then the
    dense einsum dispatch and combine of random tokens."""
    logits = _logits(1, 24, 5, hot=2)
    j = j_gating.top2_gate(jnp.asarray(logits), capacity)
    t = t_gating.top2_gate(torch.from_numpy(logits), capacity)
    _gates_equal(t, j)
    assert t.expert_idx is None and j.expert_idx is None
    toks = normal(np.random.default_rng(2), 24, 8)
    jd = j_gating.dispatch(j.dispatch_mask, jnp.asarray(toks))
    td = t_gating.dispatch(t.dispatch_mask, torch.from_numpy(toks))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-3, atol=2e-3)
    eo = normal(np.random.default_rng(3), *td.shape)
    np.testing.assert_allclose(
        t_gating.combine(t.combine_weights, torch.from_numpy(eo)).numpy(),
        np.asarray(j_gating.combine(j.combine_weights, jnp.asarray(eo))),
        rtol=2e-3, atol=2e-3)


MOE_CASES = {
    "top2_dense": dict(top_k=2, fast_dispatch=False),
    "top1_dense": dict(fast_dispatch=False),
    "rts_per_sample": dict(use_rts=True, batch_mode="per_sample", training=True),
    "rts_global": dict(use_rts=True, training=True),
    "rts_dense_global": dict(use_rts=True, fast_dispatch=False, training=True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """``moe_apply`` with modulated experts on [2, 16, 64] streams: expert
    outputs within 2e-3, counts bit for bit. Training routes with the
    training capacity (1 slot over the minimum here, so tokens drop), and
    random token selection reads JAX's draw (one [tokens, E] uniform that
    every sample of per-sample routing shares, as JAX's one key is)."""
    kw = dict(MOE_CASES[case])
    training = kw.pop("training", False)
    moe = dict(capacity_factor=1.0, eval_capacity_factor=1.0, min_capacity=1, **kw)
    jc = j_config.ControlConfig(moe=j_config.MoEConfig(**moe))
    tc = t_config.ControlConfig(moe=t_config.MoEConfig(**moe))
    e, d, pd, s = 6, 64, 24, 16
    jp = j_moe.init_moe_params(jax.random.PRNGKey(0), d, pd, e)
    tp = to_torch_tree(jp)
    rng = np.random.default_rng(4)
    hid, cond = normal(rng, B, s, d), normal(rng, B, s, d)
    streams = {"pooled": normal(rng, B, pd), "condition_pooled": normal(rng, B, pd)}
    key = jax.random.PRNGKey(7)
    rows = t_moe.rts_tokens(tc, B, s)
    u = np.array(jax.random.uniform(key, (rows, e)))
    jo = j_moe.moe_apply(jp, jc, e, jnp.asarray(hid), jnp.asarray(cond),
                         {k: jnp.asarray(v) for k, v in streams.items()},
                         rng=key, training=training)
    to = t_moe.moe_apply(tp, tc, e, torch.from_numpy(hid), torch.from_numpy(cond),
                         {k: torch.from_numpy(v) for k, v in streams.items()},
                         training=training,
                         rts_uniform=torch.from_numpy(u) if kw.get("use_rts") else None)
    for got, want in ((to.expert_hidden, jo.expert_hidden),
                      (to.expert_condition, jo.expert_condition)):
        np.testing.assert_allclose(as_np(got), np.asarray(want), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(to.expert_counts.numpy(), np.asarray(jo.expert_counts))
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss), rtol=1e-5)
    if kw.get("use_rts"):
        with pytest.raises(ValueError, match="rts_uniform"):
            t_moe.moe_apply(tp, tc, e, torch.from_numpy(hid), torch.from_numpy(cond),
                            {k: torch.from_numpy(v) for k, v in streams.items()},
                            training=True)


# ---------------------------------------------------------------- consis

def _consis_configs(**moe_kw):
    """A tiny UniGen config with the consis module, per-sample routing and a
    training capacity (3 slots for 16 tokens over 6 experts) that drops."""
    moe = dict(capacity_factor=1.0, eval_capacity_factor=1.5, min_capacity=1,
               batch_mode="per_sample", **moe_kw)
    jc = j_config.UniGenConfig(
        family="flux", flux=j_config.tiny_flux_config(),
        control=j_config.ControlConfig(use_consis_module=True,
                                       moe=j_config.MoEConfig(**moe)))
    tc = t_config.UniGenConfig(
        family="flux", flux=t_config.tiny_flux_config(),
        control=t_config.ControlConfig(use_consis_module=True,
                                       moe=t_config.MoEConfig(**moe)))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _consis_params():
    """An fp32 tree with live add gates (so the control branch, and the
    consis module in it, reaches the output), drawn by the port's init (a
    tenth of a second, where JAX's eager init of the tiny preset takes
    ten) and handed to JAX as arrays; the JAX init makes the same tree
    layout."""
    _, tc = _consis_configs()
    p = tree_map(lambda t: jnp.asarray(t.numpy()), init_unigen_flux_params(
        tc, gen=torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(100)
    for k in ("add_double", "add_single"):
        w = p["control"][k]["w"]
        p["control"][k]["w"] = jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    assert set(p["control"]["consis"]) == {"block0", "block1"}
    return p


def test_consis_tree_layout_matches_jax():
    """The port's init of the consis config has JAX's tree layout (paths,
    shapes, dtypes), by ``jax.eval_shape`` of JAX's init."""
    jc, _ = _consis_configs()
    want = jax.eval_shape(lambda k: j_init(k, jc), jax.random.PRNGKey(0))
    got = _consis_params()
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _batch(rng):
    bb = j_config.tiny_flux_config()
    raw = dict(latents=normal(rng, B, C, LAT, LAT),
               condition_latents=normal(rng, B, C, LAT, LAT),
               prompt_embeds=normal(rng, B, T, bb.joint_attention_dim),
               pooled=normal(rng, B, bb.pooled_projection_dim),
               condition_pooled=normal(rng, B, bb.pooled_projection_dim))
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def test_consis_forward_matches_jax():
    """The serving forward with the consis module (block0 run twice, on the
    condition stream and on [expert hidden | consis condition], its keys
    three image grids long): the prediction within 2e-3 of JAX."""
    jc, tc = _consis_configs()
    jp = _consis_params()
    rng = np.random.default_rng(5)
    s = (LAT // 2) ** 2
    ids = np.stack([np.zeros(s), np.arange(s) // 4, np.arange(s) % 4], -1).astype(np.float32)
    hid, cond = normal(rng, B, s, 16), normal(rng, B, s, 16)
    enc = normal(rng, B, T, 32)
    pooled, cpool = normal(rng, B, 24), normal(rng, B, 24)
    args = dict(timestep=np.full((B,), 0.5, np.float32), img_ids=ids,
                txt_ids=np.zeros((T, 3), np.float32), condition_ids=ids)
    jpred, _, jout = jax.jit(j_fwd, static_argnums=(1,))(
        jp, jc, jnp.asarray(hid), jnp.asarray(cond), jnp.asarray(enc), jnp.asarray(pooled),
        jnp.asarray(cpool), **{k: jnp.asarray(v) for k, v in args.items()})
    tpred, _, tout = t_fwd(to_torch_tree(jp), tc, torch.from_numpy(hid),
                           torch.from_numpy(cond), torch.from_numpy(enc),
                           torch.from_numpy(pooled), torch.from_numpy(cpool),
                           **{k: torch.from_numpy(v) for k, v in args.items()})
    np.testing.assert_allclose(as_np(tpred), np.asarray(jpred), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(tout["expert_counts"].numpy(),
                                  np.asarray(jout["expert_counts"]))
    # the consis module changes the prediction
    plain = dataclasses.replace(tc, control=dataclasses.replace(tc.control,
                                                                use_consis_module=False))
    other = t_fwd({"base": to_torch_tree(jp["base"]),
                   "control": {k: v for k, v in to_torch_tree(jp["control"]).items()
                               if k != "consis"}}, plain, torch.from_numpy(hid),
                  torch.from_numpy(cond), torch.from_numpy(enc), torch.from_numpy(pooled),
                  torch.from_numpy(cpool),
                  **{k: torch.from_numpy(v) for k, v in args.items()})[0]
    assert rel_l2(other, tpred) > 1e-3


def test_consis_rts_train_step_gradients_match_jax():
    """One training loss and its gradients over the whole fp32 control tree
    (consis blocks included) with random token selection in the gate: the
    port fed JAX's noise, timestep density and MoE uniform (the third key of
    the step's split) against ``jax.value_and_grad`` of JAX's loss. Loss
    within 2e-3; every gradient within 2e-3 relative L2; block1 gets none
    (the reference uses block0 for both calls)."""
    jc, tc = _consis_configs(use_rts=True)
    jp = _consis_params()
    kw = dict(remat="full", lr_scheduler="constant")
    jt, tt = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    jbatch, tbatch = _batch(np.random.default_rng(6))
    key = jax.random.PRNGKey(11)
    loss_fn = j_ts.make_loss_builder(jc, jt)(jp["base"], jbatch, key)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp["control"])

    r_noise, r_t, r_moe = jax.random.split(key, 3)
    shape = t_ts.rts_draw_shape(tc, tuple(tbatch["latents"].shape))
    assert shape == ((LAT // 2) ** 2, 6)
    draws = t_ts.Draws(
        torch.from_numpy(np.array(jax.random.normal(r_noise, jbatch["latents"].shape))),
        torch.from_numpy(np.array(j_sched.sample_timestep_density(r_t, B, "none"))),
        torch.from_numpy(np.array(jax.random.uniform(r_moe, shape))))
    t_loss_fn = t_ts.make_loss_builder(tc, tt)(to_torch_tree(jp["base"]), tbatch, draws)
    control = tree_map(lambda x: x.detach().requires_grad_(), to_torch_tree(jp["control"]))
    tloss, taux = t_loss_fn(control)
    flat = tree_leaves(control)
    grads = torch.autograd.grad(tloss, flat, allow_unused=True)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(taux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    want = dict(zip([jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jgrads)[0]],
                    jax.tree.leaves(jgrads)))
    got = {}
    for (path, _), g in zip(_paths(control), grads):
        got[path] = torch.zeros(()) if g is None else g
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w)
        if "block1" in path or not np.abs(w).max() > 0:
            assert float(got[path].abs().max()) == 0, path
            continue
        assert rel_l2(got[path], w) <= 2e-3, path
    assert any("consis" in p and np.abs(np.asarray(w)).max() > 0 for p, w in want.items())


def _paths(tree, path=()):
    """(JAX keystr of each leaf's path, leaf) in the port tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield "".join(f"['{p}']" for p in path), tree


# ---------------------------------------------------------------- remat "dots"

def test_remat_dots_gradients_and_kernel_calls(monkeypatch):
    """``remat="dots"`` saves the weight products and runs the rest again:
    on a W4A8 split micro-step (fp32) its gradients equal "full"'s and
    "none"'s, and it calls every kernel entry point as often as "full" does
    (a ctypes kernel is run again under either policy), which is what
    ``chip_smoke.expected_train_launches(..., remat=...)`` says; "none"
    runs no body twice."""
    import chip_smoke
    from unigen_tpu_torch.ops import quant as t_quant
    from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm
    calls = {}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return wrapper
    for mod, name, key in ((t_fa, "flash_attention_rope_fwd", "flash_attention_rope"),
                           (t_fa, "flash_attention_rope_bwd", "flash_attention_rope_bwd_dq"),
                           (t_qm, "w4a8_matmul", "w4a8_matmul"),
                           (t_qm, "quantize_act", "quantize_act")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    _, tc = _consis_configs()
    fp = to_torch_tree(_consis_params())
    q = functools.partial(t_quant.quantize_tree, min_dim=16)
    params = {"base": q(fp["base"], bits=4),
              "control": {k: q(v, bits=4 if k in ("double_blocks", "single_blocks") else 8)
                          for k, v in fp["control"].items()}}
    trainable, frozen = t_quant.split_trainable(params["control"])
    _, tbatch = _batch(np.random.default_rng(7))
    draws = t_ts.draw(tbatch, torch.Generator().manual_seed(0))
    grads = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        loss_fn = t_ts.make_loss_builder(tc, t_config.TrainConfig(remat=remat))(
            {"base": params["base"], "control_frozen": frozen}, tbatch, draws)
        leaves = tree_map(lambda x: x.detach().requires_grad_(), trainable)
        loss, _ = loss_fn(leaves)
        flat = tree_leaves(leaves)
        grads[remat] = [torch.zeros_like(x) if g is None else g for x, g in zip(
            flat, torch.autograd.grad(loss, flat, allow_unused=True))]
        want = chip_smoke.expected_train_launches(params, tc, B, remat=remat)
        assert calls == {k: want[k] for k in calls}, remat
    assert calls["w4a8_matmul"] > 0
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
