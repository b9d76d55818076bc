"""The training pieces of the port against the JAX package on the CPU: the
attention backwards' plain versions (RoPE and rope-free) against both Pallas
backward schedules and the streaming entry's VJP (interpret mode), the
straight-through quantized matmuls under each backward policy,
split_trainable/merge_split, the learning-rate schedules, the clip + AdamW +
MultiSteps update against optax, and the training draws of the scheduler.
Inputs are made with numpy from fixed seeds."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import assert_close, normal, pair, to_torch_tree
from unigen_tpu import config as j_config
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.ops.rope import rope_multi_axis
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu.train import train_step as j_ts
from unigen_tpu_torch import config as t_config
from unigen_tpu_torch.io.from_jax import opt_state_from_optax, tree_from_numpy
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
from unigen_tpu_torch.pipelines import scheduling as t_sched
from unigen_tpu_torch.train import train_step as t_ts
from unigen_tpu_torch.utils import tree_leaves, tree_map


@pytest.fixture()
def flash_mod(monkeypatch):
    """The JAX package's Pallas attention reloaded in interpret mode."""
    monkeypatch.setenv("UNIGEN_PALLAS_INTERPRET", "1")
    import unigen_tpu.ops.pallas.flash_attention as fa
    importlib.reload(fa)
    yield fa
    monkeypatch.delenv("UNIGEN_PALLAS_INTERPRET")
    importlib.reload(fa)


def _tables(sq, skv, n_identity):
    """Q tables over sq rows; K tables over skv rows whose last n_identity
    rows are identity (cos=1, sin=0), the KV-append convention."""
    r = np.arange(max(sq, skv))
    ids = np.stack([np.zeros_like(r), r // 8, r % 8], -1).astype(np.float32)
    cos, sin = (np.array(t) for t in rope_multi_axis(jnp.asarray(ids), (16, 56, 56)))
    kcos, ksin = cos[:skv].copy(), sin[:skv].copy()
    kcos[skv - n_identity:], ksin[skv - n_identity:] = 1.0, 0.0
    return cos[:sq].copy(), sin[:sq].copy(), kcos, ksin


@pytest.mark.parametrize("schedule,sq,skv,n_identity", [
    ("full_kv", 150, 260, 40), ("kv_blocked", 200, 300, 70)])
def test_attention_backward_plain_matches_pallas(flash_mod, monkeypatch,
                                                 schedule, sq, skv, n_identity):
    """The plain backward, and autograd through the port's Function on CPU
    tensors, against the JAX VJP of flash_attention_rope: the full-KV Pallas
    backward, and the kv-blocked one forced with small blocks. fp32, the
    JAX kernel tests' rtol 2e-4 / atol 2e-5."""
    if schedule == "kv_blocked":
        monkeypatch.setattr(flash_mod, "_bwd_supported", lambda *a: False)
        monkeypatch.setattr(flash_mod, "BQ_BWD_BLK", 128)
        monkeypatch.setattr(flash_mod, "BK_BWD_BLK", 128)
    rng = np.random.default_rng(7)
    tabs = [pair(t) for t in _tables(sq, skv, n_identity)]
    jt, tt = [j for j, _ in tabs], [t for _, t in tabs]
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        pair(normal(rng, 1, 2, s, 128)) for s in (sq, skv, skv, sq))
    want = jax.grad(lambda *a: jnp.sum(flash_mod.flash_attention_rope(*a, *jt) * jg),
                    (0, 1, 2))(jq, jk, jv)
    out = t_fa.flash_attention_rope_ref(tq, tk, tv, *tt)
    got = t_fa.flash_attention_rope_bwd_ref(tq, tk, tv, out, tg, *tt)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    via_autograd = torch.autograd.grad(t_fa.flash_attention_rope(*leaves, *tt),
                                       leaves, tg)
    for a, b, w in zip(got, via_autograd, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("entry,schedule,d,sq,skv", [
    ("flash_attention", "full_kv", 64, 150, 260),
    ("flash_attention", "full_kv", 128, 171, 171),
    ("flash_attention", "kv_blocked", 64, 200, 300),
    ("flash_attention", "kv_blocked", 128, 200, 300),
    ("flash_attention_streaming", "kv_blocked", 64, 150, 260),
    ("flash_attention_streaming", "kv_blocked", 128, 200, 300)])
def test_rope_free_backward_plain_matches_pallas(flash_mod, monkeypatch, entry,
                                                 schedule, d, sq, skv):
    """Rows 5p and 6p: the plain rope-free backward, and autograd through the
    port's Function on CPU tensors, against the JAX VJP of flash_attention
    (the full-KV Pallas backward, or the kv-blocked one forced with small
    blocks) and of flash_attention_streaming (always kv-blocked), at both
    head dims and ragged lengths (171: a FLUX block expert's capacity).
    fp32, the JAX kernel tests' rtol 2e-4 / atol 2e-5."""
    if schedule == "kv_blocked":
        monkeypatch.setattr(flash_mod, "_bwd_supported", lambda *a: False)
        monkeypatch.setattr(flash_mod, "BQ_BWD_BLK", 128)
        monkeypatch.setattr(flash_mod, "BK_BWD_BLK", 128)
    rng = np.random.default_rng(13)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (
        pair(normal(rng, 1, 2, s, d)) for s in (sq, skv, skv, sq))
    assert flash_mod._bwd_supported(jq, jk, jv) == (schedule == "full_kv")
    fn = getattr(flash_mod, entry)
    want = jax.grad(lambda *a: jnp.sum(fn(*a) * jg), (0, 1, 2))(jq, jk, jv)
    got = t_fa.flash_attention_bwd_ref(tq, tk, tv, t_fa.flash_attention_ref(tq, tk, tv), tg)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    out = t_fa.flash_attention(*leaves)
    assert isinstance(out.grad_fn, t_fa._FlashAttention._backward_cls)
    via_autograd = torch.autograd.grad(out, leaves, tg)
    for a, b, w in zip(got, via_autograd, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), rtol=2e-4, atol=2e-5)


def test_attention_backward_plain_is_autograd_of_plain_forward():
    """The plain backward (fp32 math, D from the saved output) equals
    torch.autograd of the plain forward, identity K rows included."""
    rng = np.random.default_rng(8)
    tt = [torch.from_numpy(t) for t in _tables(40, 72, 8)]
    q, k, v = (torch.from_numpy(normal(rng, 2, 2, s, 128)).requires_grad_()
               for s in (40, 72, 72))
    g = torch.from_numpy(normal(rng, 2, 2, 40, 128))
    out = t_fa.flash_attention_rope_ref(q, k, v, *tt)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = t_fa.flash_attention_rope_bwd_ref(q.detach(), k.detach(), v.detach(),
                                            out.detach(), g, *tt)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    out = t_fa.flash_attention_ref(q, k, v)
    want = torch.autograd.grad(out, (q, k, v), g)
    got = t_fa.flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                       out.detach(), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("policy,dtype", [("f32", "float32"), ("bf16", "float32"),
                                          ("bf16", "bfloat16"), ("int8", "float32")])
def test_straight_through_gradient_matches_jax(monkeypatch, bits, policy, dtype):
    """dx of the W8A8 and W4A8 matmuls against the JAX custom_vjp under the
    same backward policy (UNIGEN_QUANT_BWD on the JAX side, the argument of
    quant_backward on the port's). Both sides run the same roundings, so the
    limit is a few fp32 ulps of the product (1e-5), one bf16 ulp (1e-2) for
    bf16 activations; the weight and its scale get no gradient, and the
    policy is the one in scope when the product was recorded."""
    monkeypatch.setenv("UNIGEN_QUANT_BWD", policy)
    rng = np.random.default_rng(9)
    jw, tw = pair(normal(rng, 64, 48, scale=0.05))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x, g = normal(rng, 2, 5, 64), normal(rng, 2, 5, 48)
    jq = (j_quant.quantize_weight if bits == 8 else j_quant.quantize_weight_int4)(jw)
    tq = (t_quant.quantize_weight if bits == 8 else t_quant.quantize_weight_int4)(tw)
    jfn = j_quant.int8_matmul if bits == 8 else j_quant.int4_matmul
    tfn = t_quant.int8_matmul if bits == 8 else t_quant.int4_matmul
    wkey = "w_q" if bits == 8 else "w_q4"
    want = jax.grad(lambda a: jnp.sum(jfn(a, jq[wkey], jq["w_scale"]).astype(
        jnp.float32) * jnp.asarray(g)))(jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    with t_quant.quant_backward(policy):
        out = tfn(tx, tq[wkey], tq["w_scale"])
    (got,) = torch.autograd.grad(out, tx, torch.from_numpy(g).to(out.dtype))
    assert got.dtype == tdt
    assert_close(got, want, 1e-2 if dtype == "bfloat16" else 1e-5)
    assert (got.abs().max() > 0 and out.grad_fn is not None
            and t_quant._policy[0] == "bf16")


def test_split_trainable_and_merge_match_jax():
    """The quantized control tree splits into the JAX package's trainable and
    frozen halves (same None leaves) and merges back to the whole."""
    from unigen_tpu.models.unigen_flux import init_unigen_flux_params
    jcfg = j_config.UniGenConfig(family="flux", flux=j_config.tiny_flux_config())
    p = jax.jit(init_unigen_flux_params, static_argnums=(1,))(jax.random.PRNGKey(0), jcfg)
    ctrl = j_quant.quantize_tree(p["control"], bits=4, min_dim=16)
    jt, jf = j_quant.split_trainable(ctrl)
    tt, tf = t_quant.split_trainable(to_torch_tree(ctrl))
    carried = tree_from_numpy(jax.tree.map(np.asarray, jt), device="cpu")

    def shape_of(tree):
        if isinstance(tree, dict):
            return {k: shape_of(v) for k, v in tree.items()}
        return None if tree is None else tuple(tree.shape)
    assert shape_of(tt) == shape_of(carried)
    assert shape_of(tf) == shape_of(tree_from_numpy(jax.tree.map(np.asarray, jf),
                                                    device="cpu"))
    assert shape_of(t_quant.merge_split(tt, tf)) == shape_of(to_torch_tree(ctrl))
    n_j = sum(int(x.size) for x in jax.tree.leaves(jt))
    assert sum(x.numel() for x in tree_leaves(tt)) == n_j


@pytest.mark.parametrize("kind", ["constant", "constant_with_warmup", "linear",
                                  "polynomial", "cosine", "cosine_with_restarts"])
def test_lr_schedules_match_optax(kind):
    kw = dict(learning_rate=3e-4, lr_scheduler=kind, lr_warmup_steps=4,
              max_train_steps=13)
    want = j_ts.lr_schedule(j_config.TrainConfig(**kw))
    got = t_ts.lr_schedule(t_config.TrainConfig(**kw))
    for step in range(16):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-12)


@pytest.mark.parametrize("accum", [1, 3])
def test_clip_adamw_multisteps_match_optax(accum):
    """Six micro-steps of the port's optimizer against optax from a state
    carried across after two micro-steps (bias correction and the
    accumulation phase past zero). Gradients alternate between clipped and
    unclipped norms. fp32; 1e-6 relative."""
    kw = dict(learning_rate=1e-2, lr_scheduler="cosine", lr_warmup_steps=2,
              max_train_steps=10, gradient_accumulation_steps=accum,
              adam_weight_decay=0.1, max_grad_norm=1.0)
    tx = j_ts.make_optimizer(j_config.TrainConfig(**kw))
    opt = t_ts.AdamW(t_config.TrainConfig(**kw))
    rng = np.random.default_rng(10)
    params = {"a": {"w": normal(rng, 3, 4), "frozen": None}, "b": normal(rng, 5)}
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    grads = [{"a": {"w": normal(rng, 3, 4, scale=s), "frozen": None},
              "b": normal(rng, 5, scale=s)} for s in (0.1, 2.0) * 4]
    for i in range(8):
        if i == 2:     # carry the JAX state across
            tp = tree_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
            ts = opt_state_from_optax(jax.tree.map(np.asarray, js), device="cpu")
        jg = jax.tree.map(jnp.asarray, grads[i])
        upd, js = tx.update(jg, js, jp)
        jp = optax.apply_updates(jp, upd)
        if i >= 2:
            tg = tree_from_numpy(grads[i], device="cpu")
            tu, ts = opt.update(tg, ts, tp)
            tp = t_ts.apply_updates(tp, tu)
            for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-7)
    assert ts.count == int(opt_state_from_optax(jax.tree.map(np.asarray, js),
                                                device="cpu").count)


def test_training_sigmas_and_weighting_match_jax():
    cfg = dict(shift=3.0)
    np.testing.assert_array_equal(
        t_sched.training_sigmas(t_sched.FlowMatchConfig(**cfg)),
        j_sched.training_sigmas(j_sched.FlowMatchConfig(**cfg)))
    sig = np.linspace(0.05, 1.0, 7).astype(np.float32)
    for scheme in ("none", "sigma_sqrt", "cosmap"):
        assert_close(t_sched.loss_weighting(torch.from_numpy(sig), scheme),
                     j_sched.loss_weighting(jnp.asarray(sig), scheme), 1e-6)


def test_scale_noise_keeps_bf16_sample():
    """z_t = (1 - sigma) x + sigma z1 in fp32, returned in the sample's dtype:
    an fp32 sigma must not promote bf16 latents (the JAX round-5 fault)."""
    rng = np.random.default_rng(11)
    x, z = normal(rng, 2, 4, 8, 8), normal(rng, 2, 4, 8, 8)
    sig = np.array([0.3, 0.9], np.float32)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        want = j_sched.scale_noise(jnp.asarray(x, jdt), jnp.asarray(z, jdt),
                                   jnp.asarray(sig))
        got = t_sched.scale_noise(torch.from_numpy(x).to(tdt),
                                  torch.from_numpy(z).to(tdt), torch.from_numpy(sig))
        assert got.dtype == tdt and want.dtype == jdt
        assert_close(got, want, 1e-2 if tdt == torch.bfloat16 else 1e-6)


@pytest.mark.parametrize("scheme", ["none", "logit_normal", "mode"])
def test_timestep_density_draws_from_the_generator(scheme):
    """u [B] fp32 from the explicit generator: the same seed gives the same
    draws; each scheme's transform is JAX's on the same underlying draw."""
    u = t_sched.sample_timestep_density(torch.Generator().manual_seed(3), 64, scheme)
    again = t_sched.sample_timestep_density(torch.Generator().manual_seed(3), 64, scheme)
    assert u.dtype == torch.float32 and u.shape == (64,) and torch.equal(u, again)
    base = torch.Generator().manual_seed(3)
    raw = (torch.randn if scheme == "logit_normal" else torch.rand)(64, generator=base)
    if scheme == "logit_normal":
        want = jax.nn.sigmoid(jnp.asarray(raw.numpy()))
    elif scheme == "mode":
        r = jnp.asarray(raw.numpy())
        want = 1.0 - r - 1.29 * (jnp.cos(jnp.pi * r / 2.0) ** 2 - 1.0 + r)
    else:
        want = raw.numpy()
    assert_close(u, want, 1e-6)


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_flux_full_trainable_count_matches_jax(control):
    """The full-width fine-tune trains the float leaves of the W4A8 control
    tree: the port's split_trainable of its serving tree counts as many
    elements as the JAX package's on eval_shape, the number chip_smoke.py
    holds the card run to. With the shipped control values (block experts:
    12 FLUX single blocks, left float by the serving policy) the whole
    serving tree also has the JAX tree's paths, shapes and dtypes."""
    import chip_smoke
    from unigen_tpu import presets as j_presets
    from unigen_tpu.models.unigen_flux import init_unigen_flux_params as j_init
    from unigen_tpu_torch import presets as t_presets
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    from unigen_tpu_torch.utils import tree_leaves_with_path
    jcfg, tcfg = j_presets.flux_full(), t_presets.flux_full()
    if control == "blocks":
        jcfg, tcfg = chip_smoke.shipped_control(jcfg), chip_smoke.shipped_control(tcfg)
    shapes = jax.eval_shape(lambda k: j_quant.quantize_unigen_serving(
        j_init(k, jcfg, dtype=jnp.bfloat16)), jax.random.PRNGKey(0))
    want = sum(int(x.size) for x in jax.tree.leaves(
        j_quant.split_trainable(shapes["control"])[0]))
    tree = init_quantized_serving_params(tcfg, device="meta")
    got = sum(x.numel() for x in tree_leaves(
        t_quant.split_trainable(tree["control"])[0]))
    assert got == want == {"rope": chip_smoke.FLUX_FULL_TRAINABLE,
                           "blocks": chip_smoke.FLUX_FULL_BLOCKS_TRAINABLE}[control]
    if control == "blocks":
        layout = {jax.tree_util.keystr(p, simple=True, separator="."):
                  (tuple(x.shape), str(x.dtype))
                  for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
        assert layout == {".".join(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                          for p, x in tree_leaves_with_path(tree)}
        assert tree["control"]["moe"]["experts"]["hid_block"]["proj_out"]["w"].dtype \
            == torch.bfloat16


def test_remat_full_keeps_values_and_gradients():
    """remat "full" checkpoints each block body: the backbone's output and
    its parameter gradients equal those without remat (fp32, CPU), and under
    no_grad it runs the bodies as they are."""
    from unigen_tpu_torch.models.flux import flux_forward, init_flux_params
    cfg = t_config.tiny_flux_config()
    params = init_flux_params(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    leaves = tree_map(lambda x: x.requires_grad_(), params)
    rng = np.random.default_rng(12)
    ids = torch.from_numpy(np.stack([np.zeros(16), np.arange(16) // 4,
                                     np.arange(16) % 4], -1).astype(np.float32))
    args = (torch.from_numpy(normal(rng, 2, 16, cfg.in_channels)),
            torch.from_numpy(normal(rng, 2, 5, cfg.joint_attention_dim)),
            torch.from_numpy(normal(rng, 2, cfg.pooled_projection_dim)),
            torch.tensor([0.3, 0.8]), ids, torch.zeros(5, 3))
    outs, grads = [], []
    for remat in ("none", "full"):
        out = flux_forward(leaves, cfg, *args, remat=remat)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out.square().sum(), tree_leaves(leaves)))
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-6, atol=1e-6)
    for a, b in zip(grads[1], grads[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        torch.testing.assert_close(flux_forward(leaves, cfg, *args, remat="full"),
                                   outs[0], rtol=1e-6, atol=1e-6)
