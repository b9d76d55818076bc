"""The port's training step and Trainer against the JAX package on the CPU,
at the tiny preset: ``make_train_step`` over two optimizer updates of two
micro-steps each, started from a JAX state past step 0 and fed the JAX
step's own noise and timestep draws; the W4A8 split fine-tune in bf16 (the
bench's run_full) and with the Trainer's fp32 upcast; ``Trainer`` with stub
encoders; and the expected kernel-call counts of a remat training step that
``chip_smoke.py`` checks on the card. The two-update run and the call count
also run with the reference's shipped control values (rope-free control
attention, block experts: ``chip_smoke.shipped_control``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import normal, rel_l2, to_torch_tree
from unigen_tpu import config as j_config
from unigen_tpu.models.unigen_flux import init_unigen_flux_params as j_init
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu.train import loop as j_loop
from unigen_tpu.train import train_step as j_ts
from unigen_tpu_torch import config as t_config
from unigen_tpu_torch.io.from_jax import opt_state_from_optax, tree_from_numpy
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm
from unigen_tpu_torch.train import loop as t_loop
from unigen_tpu_torch.train import train_step as t_ts
from unigen_tpu_torch.utils import tree_leaves, tree_map

B, C, LAT, T = 2, 4, 8, 6            # 8x8 latents -> 16 packed tokens


def _configs(control="rope"):
    """One tiny UniGen config in both packages: per-sample MoE whose training
    capacity (4 slots for 16 tokens over 6 experts) is above the eval one
    (3), so ``training`` decides which tokens drop. ``control="blocks"``
    takes the reference's shipped control values."""
    import chip_smoke
    moe = dict(capacity_factor=1.5, eval_capacity_factor=1.0, min_capacity=1,
               batch_mode="per_sample")
    jc = j_config.UniGenConfig(
        family="flux", flux=j_config.tiny_flux_config(),
        control=j_config.ControlConfig(moe=j_config.MoEConfig(**moe)))
    tc = t_config.UniGenConfig(
        family="flux", flux=t_config.tiny_flux_config(),
        control=t_config.ControlConfig(moe=t_config.MoEConfig(**moe)))
    if control == "blocks":
        return chip_smoke.shipped_control(jc), chip_smoke.shipped_control(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_fp32_params(jc):
    """The JAX fp32 tree of ``jc`` whose zero-init add linears carry random
    values, built once per config (eagerly: the same values as under jit,
    in a third of the time at this size)."""
    p = j_init(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(100)
    for k in ("add_double", "add_single"):
        w = p["control"][k]["w"]
        p["control"][k]["w"] = jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return p


def _jax_params(jc, dtype=jnp.float32):
    """A fresh tree of ``_jax_fp32_params(jc)`` in ``dtype``; a bf16 tree
    keeps the router gate fp32, as the package's bf16 init does."""
    p = _jax_fp32_params(jc)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "gate" in jax.tree_util.keystr(path) else x.astype(dtype), p)


def _batch(rng, jdt=jnp.float32, tdt=torch.float32):
    bb = j_config.tiny_flux_config()
    raw = dict(latents=normal(rng, B, C, LAT, LAT),
               condition_latents=normal(rng, B, C, LAT, LAT),
               prompt_embeds=normal(rng, B, T, bb.joint_attention_dim),
               pooled=normal(rng, B, bb.pooled_projection_dim),
               condition_pooled=normal(rng, B, bb.pooled_projection_dim))
    return ({k: jnp.asarray(v, jdt) for k, v in raw.items()},
            {k: torch.from_numpy(v).to(tdt) for k, v in raw.items()})


def _jax_draws(rng_key, latents, scheme):
    """The draws make_loss_builder takes from its key (train_step.py:124-130)."""
    r_noise, r_t, _ = jax.random.split(rng_key, 3)
    u = j_sched.sample_timestep_density(r_t, latents.shape[0], scheme)
    noise = jax.random.normal(r_noise, latents.shape, latents.dtype)
    return t_ts.Draws(torch.from_numpy(np.array(noise, np.float32)).to(
        torch.bfloat16 if latents.dtype == jnp.bfloat16 else torch.float32),
        torch.from_numpy(np.array(u)))


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_train_step_matches_jax_over_two_updates(control):
    """fp32, remat "full", accumulation 2, the cosmap weighting: three JAX
    micro-steps, then the JAX state carried across (adam count 1, one
    gradient accumulated) and four more micro-steps on both sides. Loss and
    grad norm within the repo's 2e-3; the parameter updates within 1e-2
    relative L2 (Adam's normalised update turns fp32 noise in near-zero
    gradients into sign flips of single elements); the parameters within
    2e-3 (lr 1e-4 bounds those flips). With block experts the rope-free
    attention backward carries every control gradient."""
    jc, tc = _configs(control)
    kw = dict(learning_rate=1e-4, lr_scheduler="constant", gradient_accumulation_steps=2,
              remat="full", weighting_scheme="cosmap", max_grad_norm=1.0)
    jt, tt = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    jp = _jax_params(jc)
    jbatch, tbatch = _batch(np.random.default_rng(1))
    j_step = jax.jit(j_ts.make_train_step(jc, jt))
    t_step = t_ts.make_train_step(tc, tt)
    state = j_ts.init_train_state(jp["control"], jt)
    keys = [jax.random.PRNGKey(200 + i) for i in range(7)]
    for i in range(3):
        state, _ = j_step(state, jp["base"], jbatch, keys[i])
    np_state = jax.tree.map(np.asarray, state)
    t_state = t_ts.TrainState(tree_from_numpy(np_state.control, device="cpu"),
                              opt_state_from_optax(np_state.opt_state, device="cpu"),
                              int(np_state.step))
    assert (t_state.opt_state.count, t_state.opt_state.mini_step) == (1, 1)
    t_base = to_torch_tree(jp["base"])
    for i in range(3, 7):
        before = jax.tree.map(np.asarray, state.control)
        state, jm = j_step(state, jp["base"], jbatch, keys[i])
        t_before = t_state.control
        t_state, tm = t_step(t_state, t_base, tbatch,
                             draws=_jax_draws(keys[i], jbatch["latents"], "cosmap"))
        for k in ("step_loss", "flow_loss", "moe_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=2e-3)
        np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                      np.asarray(jm["expert_counts"]))
        if i % 2 == 0:
            continue                         # accumulation step: no update
        got = torch.cat([(a - b).flatten() for a, b in zip(
            tree_leaves(t_state.control), tree_leaves(t_before))])
        want = np.concatenate([(np.asarray(a) - b).ravel() for a, b in zip(
            jax.tree.leaves(state.control), jax.tree.leaves(before))])
        assert np.abs(want).max() > 0
        assert rel_l2(got, want) <= 1e-2
    assert t_state.step == int(state.step) == 7
    for a, b in zip(tree_leaves(t_state.control), jax.tree.leaves(state.control)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-3)


@functools.lru_cache(maxsize=None)
def _w4a8_params(dtype_name, control="rope"):
    """The serving policy at tiny width (min_dim 16 so the tiny linears take
    it): W4 base and control block stacks, W8 for the other control pieces,
    the experts left float; built once per dtype and control kind."""
    jc, _ = _configs(control)
    jp = _jax_params(jc, jnp.dtype(dtype_name))
    q = jax.jit(functools.partial(j_quant.quantize_tree, min_dim=16),
                static_argnames=("bits",))
    return {"base": q(jp["base"], bits=4),
            "control": {k: q(v, bits=4 if k in ("double_blocks", "single_blocks") else 8)
                        for k, v in jp["control"].items()}}


def _split(trainable):
    """(JAX trainable, JAX frozen, port trainable, port frozen base arg) of
    the bf16 W4A8 tree with the trainable half cast to ``trainable``."""
    jp = _w4a8_params("bfloat16")
    jtr, jfr = j_quant.split_trainable(jp["control"])
    jtr = jax.tree.map(lambda x: x.astype(jnp.dtype(trainable)), jtr)
    t_frozen = {"base": to_torch_tree(jp["base"]),
                "control_frozen": tree_from_numpy(jax.tree.map(np.asarray, jfr),
                                                  device="cpu")}
    return jp, jtr, jfr, tree_from_numpy(jax.tree.map(np.asarray, jtr), device="cpu"), t_frozen


@pytest.mark.parametrize("trainable", ["bfloat16", "float32"])
def test_w4a8_split_forward_dtype_matches_jax(trainable):
    """The single-card fine-tune tree: W4A8 frozen half (bf16 float leaves),
    float trainable half. With bf16 trainables and activations (the bench's
    run_full) the stream stays bf16. With the Trainer's fp32 upcast the JAX
    forward runs with fp32 activations: fed bf16 ones, its first fp32 bias
    add promotes the scan carry and lax.scan refuses the mismatch, where the
    port's block loop just promotes the stream (torch's products are made
    to promote as jnp's do). Predictions within 5e-2 relative L2 in bf16
    (rounding at other points and the int8 activation codes it flips), 5e-3
    in fp32 (flipped codes only)."""
    from unigen_tpu.models.unigen_flux import unigen_flux_forward as j_fwd
    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward as t_fwd
    jc, tc = _configs()
    jp, jtr, jfr, ttr, t_frozen = _split(trainable)
    jdt, tdt = jnp.dtype(trainable), getattr(torch, trainable)
    jbatch, _ = _batch(np.random.default_rng(2), jdt, tdt)
    ids = np.stack([np.zeros(16), np.arange(16) // 4, np.arange(16) % 4], -1
                   ).astype(np.float32)
    hid = normal(np.random.default_rng(3), B, 16, 16)
    args = dict(encoder=jbatch["prompt_embeds"], pooled=jbatch["pooled"],
                condition_pooled=jbatch["condition_pooled"],
                timestep=jnp.full((B,), 0.5, jnp.float32), img_ids=jnp.asarray(ids),
                txt_ids=jnp.zeros((T, 3)), condition_ids=jnp.asarray(ids))
    j_params = {"base": jp["base"], "control": j_quant.merge_split(jtr, jfr)}
    jpred, _, _ = jax.jit(j_fwd, static_argnums=(1,))(
        j_params, jc, hidden=jnp.asarray(hid, jdt), condition=jnp.asarray(hid, jdt),
        **args)
    t_params = {"base": t_frozen["base"],
                "control": t_quant.merge_split(ttr, t_frozen["control_frozen"])}

    def t_run(dtype):
        targs = {k: torch.from_numpy(np.array(v, np.float32)).to(
            torch.float32 if k.endswith("ids") or k == "timestep" else dtype)
            for k, v in args.items()}
        return t_fwd(t_params, tc, hidden=torch.from_numpy(hid).to(dtype),
                     condition=torch.from_numpy(hid).to(dtype), **targs)[0]
    tpred = t_run(tdt)
    assert tpred.dtype == tdt and str(jpred.dtype) == trainable
    assert rel_l2(tpred, jpred) <= (5e-2 if trainable == "bfloat16" else 5e-3)
    if trainable == "float32":
        assert t_run(torch.bfloat16).dtype == torch.float32
        with pytest.raises(TypeError, match="carry"):
            jax.eval_shape(functools.partial(j_fwd, cfg=jc), j_params,
                           hidden=jnp.asarray(hid, jnp.bfloat16),
                  condition=jnp.asarray(hid, jnp.bfloat16),
                  **{k: (v.astype(jnp.bfloat16) if v.dtype == jnp.float32
                         and not k.endswith("ids") and k != "timestep" else v)
                     for k, v in args.items()})


def test_w4a8_split_bf16_step_matches_jax():
    """The bench's run_full micro-step at tiny width: bf16 trainables, W4A8
    frozen, straight-through gradients through the quantized linears. Loss
    and the concatenated trainable gradients within 5e-2 relative of JAX
    (bf16 rounding at other points; flipped int8 activation codes);
    gradients keep the trainables' dtype, and leaves the loss does not reach
    (the control blocks' discarded context outputs) get zeros, as in JAX."""
    jc, tc = _configs()
    jp, jtr, jfr, ttr, t_frozen = _split("bfloat16")
    kw = dict(remat="full", lr_scheduler="constant")
    jt, tt = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    jbatch, tbatch = _batch(np.random.default_rng(2), jnp.bfloat16, torch.bfloat16)
    key = jax.random.PRNGKey(5)
    loss_fn = j_ts.make_loss_builder(jc, jt)({"base": jp["base"], "control_frozen": jfr},
                                             jbatch, key)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jtr)
    draws = _jax_draws(key, jbatch["latents"], "none")
    t_loss_fn = t_ts.make_loss_builder(tc, tt)(t_frozen, tbatch, draws)
    leaves = tree_map(lambda x: x.detach().requires_grad_(), ttr)
    tloss, _ = t_loss_fn(leaves)
    flat = tree_leaves(leaves)
    tgrads = [torch.zeros_like(x) if g is None else g for x, g in zip(
        flat, torch.autograd.grad(tloss, flat, allow_unused=True))]
    assert abs(float(tloss.detach()) - float(jloss)) <= 5e-2 * abs(float(jloss))
    assert all(g.dtype == torch.bfloat16 for g in tgrads)
    got = torch.cat([g.float().flatten() for g in tgrads])
    want = np.concatenate([np.asarray(w, np.float32).ravel()
                           for w in jax.tree.leaves(jgrads)])
    assert rel_l2(got, want) <= 5e-2


def _stub_encoders(to_array):
    """Deterministic stand-ins for the text and image towers, written once
    for numpy inputs and returning ``to_array`` outputs."""
    bb = j_config.tiny_flux_config()

    def encode_text(prompts):
        seeds = [sum(map(ord, p)) for p in prompts]
        emb = np.stack([np.random.default_rng(s).standard_normal(
            (T, bb.joint_attention_dim)) for s in seeds]).astype(np.float32)
        pooled = np.stack([np.random.default_rng(s + 1).standard_normal(
            bb.pooled_projection_dim) for s in seeds]).astype(np.float32)
        return {"prompt_embeds": to_array(emb), "pooled": to_array(pooled)}

    def encode_images(px):
        b = px.shape[0]
        lat = px.reshape(b, 3, LAT, 2, LAT, 2).mean(axis=(3, 5))
        return to_array(np.concatenate([lat, lat[:, :1]], axis=1).astype(np.float32))
    return encode_text, encode_images


def _raw_batch(rng):
    return {"descriptions": ["a red cube", "two cats"], "task_names": ["canny"] * 2,
            "pixel_values": rng.uniform(-1, 1, (B, 3, 2 * LAT, 2 * LAT)).astype(np.float32),
            "condition_pixels": rng.uniform(-1, 1, (B, 3, 2 * LAT, 2 * LAT)).astype(np.float32)}


def test_trainer_step_on_cpu():
    """Trainer with stub encoders: prepare_batch gives the JAX Trainer's
    batch; trainable leaves are upcast to fp32 and the frozen base keeps
    bf16; a step equals make_train_step with the Trainer's own seeded
    draws; train() runs to max_train_steps with finite losses."""
    jc, tc = _configs()
    jp = _jax_params(jc)
    tcfg_kw = dict(lr_scheduler="constant", gradient_accumulation_steps=2,
                   remat="full", max_train_steps=3, seed=4)
    raw = _raw_batch(np.random.default_rng(6))
    j_text, j_img = _stub_encoders(jnp.asarray)
    t_text, t_img = _stub_encoders(torch.from_numpy)
    jtr = j_loop.Trainer(jc, j_config.TrainConfig(**tcfg_kw), base_params=jp["base"],
                         control_params=jp["control"], encode_text=j_text,
                         encode_images=j_img)
    base = tree_from_numpy(jax.tree.map(np.asarray, jp["base"]), device="cpu")
    ctrl = tree_map(torch.Tensor.bfloat16, to_torch_tree(jp["control"]))
    trainer = t_loop.Trainer(tc, t_config.TrainConfig(**tcfg_kw), base_params=base,
                             control_params=ctrl, encode_text=t_text,
                             encode_images=t_img, device="cpu")
    assert all(x.dtype == torch.float32 for x in tree_leaves(trainer.state.control))
    tb, jb = trainer.prepare_batch(raw), jtr.prepare_batch(raw)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))

    draws = t_ts.draw(tb, torch.Generator().manual_seed(4), "none")
    _, want = t_ts.make_train_step(tc, t_config.TrainConfig(**tcfg_kw))(
        trainer.state, trainer.base_params, tb, draws=draws)
    got = trainer.step(raw)
    assert float(got["step_loss"]) == float(want["step_loss"])
    last = trainer.train([_raw_batch(np.random.default_rng(i)) for i in range(5)],
                         log_every=1)
    assert trainer.global_step == 3 and np.isfinite(last["step_loss"])
    assert trainer.state.opt_state.count == 1
    assert trainer.maybe_resume() is False          # no work_dir: nothing to resume


def test_unported_training_options_raise():
    """A mesh (ROADMAP Queue 1 item 8) and an unknown remat policy raise;
    LoRA mode without the frozen control tree raises when the loss is
    built (LoRA training itself is in tests/test_torch_port_lora.py)."""
    _, tc = _configs()
    build = t_ts.make_loss_builder(tc, t_config.TrainConfig(lora_rank=4))
    _, tbatch = _batch(np.random.default_rng(0))
    draws = t_ts.draw(tbatch, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="control_frozen"):
        build({}, tbatch, draws)
    from unigen_tpu_torch.utils import remat_wrap
    with pytest.raises(ValueError, match="remat"):
        remat_wrap(lambda x: x, "some")
    with pytest.raises(NotImplementedError, match="item 8"):
        t_loop.Trainer(tc, t_config.TrainConfig(), base_params={}, control_params={},
                       encode_text=None, encode_images=None, mesh=object(),
                       device="cpu")


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_remat_step_kernel_calls_match_chip_smoke_count(monkeypatch, control):
    """One W4A8 split micro-step with remat "full" calls each attention
    forward (RoPE and rope-free), each attention backward and the W4A8
    matmul exactly as often as chip_smoke.py's expected_train_launches says
    (the recomputed forwards of every remat body included), the formula
    counts one RoPE rotation pass per RoPE call of either direction, and
    one activation quantization per W4A8 and W8A8 call, so the card's
    launch check is exact."""
    import chip_smoke
    calls = {"fwd": 0, "bwd": 0, "w4a8": 0, "norope_fwd": 0, "norope_bwd": 0,
             "quantize": 0, "w8a8": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(t_fa, "flash_attention_rope_fwd",
                        counted("fwd", t_fa.flash_attention_rope_fwd))
    monkeypatch.setattr(t_fa, "flash_attention_rope_bwd",
                        counted("bwd", t_fa.flash_attention_rope_bwd))
    monkeypatch.setattr(t_fa, "flash_attention_fwd",
                        counted("norope_fwd", t_fa.flash_attention_fwd))
    monkeypatch.setattr(t_fa, "flash_attention_bwd",
                        counted("norope_bwd", t_fa.flash_attention_bwd))
    monkeypatch.setattr(t_qm, "w4a8_matmul", counted("w4a8", t_qm.w4a8_matmul))
    monkeypatch.setattr(t_qm, "quantize_act", counted("quantize", t_qm.quantize_act))
    monkeypatch.setattr(t_quant, "_int_mm", counted("w8a8", t_quant._int_mm))
    jc, tc = _configs(control)
    params = to_torch_tree(_w4a8_params("float32", control))
    trainable, frozen = t_quant.split_trainable(params["control"])
    tt = t_config.TrainConfig(remat="full", gradient_accumulation_steps=2)
    step = t_ts.make_train_step(tc, tt)
    _, tbatch = _batch(np.random.default_rng(7))
    step(t_ts.init_train_state(trainable, tt),
         {"base": params["base"], "control_frozen": frozen}, tbatch,
         torch.Generator().manual_seed(0))
    want = chip_smoke.expected_train_launches(params, tc, B)
    assert calls == {"fwd": want["flash_attention_rope"],
                     "bwd": want["flash_attention_rope_bwd_dq"],
                     "w4a8": want["w4a8_matmul"],
                     "norope_fwd": want["flash_attention"],
                     "norope_bwd": want["flash_attention_bwd_dq"],
                     "quantize": want["quantize_act"],
                     "w8a8": want["quantize_act"] - want["w4a8_matmul"]}
    assert calls["w8a8"] > 0 and want["w4a8_general"] == 0
    assert want["flash_attention_rope_bwd_dq"] == want["flash_attention_rope_bwd_dkv"]
    # one rotation pass per RoPE forward and per RoPE backward call
    assert want["rope_rotate"] == calls["fwd"] + calls["bwd"]
    assert want["flash_attention_bwd_dq"] == want["flash_attention_bwd_dkv"]
    assert (want["flash_attention"] > 0) == (control == "blocks")


def test_discarded_context_leaves_decay_as_optax():
    """The context branch of the control double blocks and of the shared
    expert's weave_text (``ff_context`` and the context's output projection)
    is not run: autograd gives those trainable leaves no gradient, which the
    step treats as zero, so AdamW's weight decay alone moves them, as it
    does under optax, where JAX's gradients are zero. One update of every
    such leaf against JAX's."""
    jc, tc = _configs()
    kw = dict(learning_rate=1e-2, lr_scheduler="constant", gradient_accumulation_steps=1,
              remat="none", adam_weight_decay=0.1, max_grad_norm=1.0)
    jt, tt = j_config.TrainConfig(**kw), t_config.TrainConfig(**kw)
    jp = _jax_params(jc)
    jbatch, tbatch = _batch(np.random.default_rng(2))
    key = jax.random.PRNGKey(300)
    state = j_ts.init_train_state(jp["control"], jt)
    j_state, _ = jax.jit(j_ts.make_train_step(jc, jt))(state, jp["base"], jbatch, key)
    t_state = t_ts.init_train_state(to_torch_tree(jp["control"]), tt)
    t_state, _ = t_ts.make_train_step(tc, tt)(
        t_state, to_torch_tree(jp["base"]), tbatch,
        draws=_jax_draws(key, jbatch["latents"], tt.weighting_scheme))
    before = to_torch_tree(jp["control"])
    want = to_torch_tree(j_state.control)
    checked = 0
    for root in (("double_blocks",), ("shared_expert", "weave_text")):
        t_node, j_node, b_node = t_state.control, want, before
        for k in root:
            t_node, j_node, b_node = t_node[k], j_node[k], b_node[k]
        for branch in ("ff_context", "attn"):
            for name, leaves in t_node[branch].items():
                if branch == "attn" and name != "to_add_out":
                    continue
                for leaf, t in leaves.items():
                    old, ref = b_node[branch][name][leaf], j_node[branch][name][leaf]
                    decayed = old - 1e-2 * 0.1 * old
                    np.testing.assert_allclose(t.numpy(), ref.numpy(), rtol=1e-6, atol=1e-9)
                    np.testing.assert_allclose(t.numpy(), decayed.numpy(), rtol=1e-6,
                                               atol=1e-9)
                    assert not torch.equal(t, old)
                    checked += 1
    assert checked == 12
