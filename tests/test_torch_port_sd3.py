"""The UniGen-SD3 slice of the port against the JAX package on the CPU, at
``tiny_sd3_config`` (4 joint blocks, dual attention on 0-1, 4 heads x 8):
packing and the cropped position table, the patch embed, the dual AdaLN,
joint attention in its SD3 forms, both block kinds, the backbone, the MoE
with block experts under global routing, ``unigen_sd3_forward`` with both
merge methods, a 2-step CFG denoise, and the full-width tree's layout.
JAX trees cross by ``tree_from_numpy``; inputs are numpy draws from a seed.

Tolerances: layers at rtol=atol=1e-4 in fp32 (same algorithm, another
summation order); the whole forward and the denoise within 5e-3 relative
L2 in fp32 and 2e-2 in bf16 (bf16 rounds at other places in the two
frameworks)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, normal, pair, rel_l2, to_jax_tree, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu import presets as j_presets
from unigen_tpu.layers import adaln as j_adaln
from unigen_tpu.layers import attention as j_attn
from unigen_tpu.layers import blocks_sd3 as j_blocks
from unigen_tpu.layers import embeddings as j_emb
from unigen_tpu.models import moe as j_moe
from unigen_tpu.models import sd3 as j_sd3
from unigen_tpu.models import unigen_sd3 as j_usd3
from unigen_tpu.ops import packing as j_pack
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.layers import adaln as t_adaln
from unigen_tpu_torch.layers import attention as t_attn
from unigen_tpu_torch.layers import blocks_sd3 as t_blocks
from unigen_tpu_torch.layers import embeddings as t_emb
from unigen_tpu_torch.models import moe as t_moe
from unigen_tpu_torch.models import sd3 as t_sd3
from unigen_tpu_torch.models import unigen_sd3 as t_usd3
from unigen_tpu_torch.ops import packing as t_pack
from unigen_tpu_torch.utils import tree_leaves_with_path

TOL = 1e-4
SD3 = jcfg.tiny_sd3_config()
D, HEADS, HD = SD3.inner_dim, SD3.num_attention_heads, SD3.attention_head_dim
LAT, T = 8, 6                    # 8x8 latents -> 16 tokens, 6 text tokens
S = (LAT // SD3.patch_size) ** 2


def _configs(cn2base="add"):
    """The same tiny UniGen-SD3 config in the JAX package and in the port."""
    kw = dict(use_rope=False, cn2base_method=cn2base)
    jc = jcfg.UniGenConfig(family="sd3", sd3=SD3, condition_types=("depth",),
                           control=jcfg.ControlConfig(**kw))
    tc = tcfg.UniGenConfig(family="sd3", sd3=tcfg.tiny_sd3_config(),
                           condition_types=("depth",),
                           control=tcfg.ControlConfig(**kw))
    return jc, tc


def test_port_config_and_presets_match_jax():
    jc, tc = _configs("CrossAttn")
    assert dataclasses.asdict(tc.sd3) == dataclasses.asdict(jc.sd3)
    assert dataclasses.asdict(tc.control) == dataclasses.asdict(jc.control)
    j, t = j_presets.sd35_medium(), t_presets.sd35_medium()
    assert dataclasses.asdict(t.sd3) == dataclasses.asdict(j.sd3)
    assert dataclasses.asdict(t.control) == dataclasses.asdict(j.control)
    assert t.backbone is t.sd3 and t.condition_types == j.condition_types
    jb, tb = (m.baseline_configs()["sd3_depth_28step"] for m in (j_presets, t_presets))
    assert {k: v for k, v in tb.items() if k != "cfg"} == \
        {k: v for k, v in jb.items() if k != "cfg"}


@pytest.mark.parametrize("hp", [32, 64])
def test_packing_and_cropped_pos_embed(hp):
    """patchify/unpatchify round trip and the sincos table, center-cropped
    from the 384 table as at 512^2 (32 patches a side) and 1024^2 (64)."""
    rng = np.random.default_rng(0)
    jx, tx = pair(normal(rng, 2, 4, 8, 6))
    assert_close(t_pack.patchify(tx, 2), j_pack.patchify(jx, 2), 0)
    jt, tt = pair(normal(rng, 2, 12, 16))
    assert_close(t_pack.unpatchify(tt, 3, 4, 2, 4), j_pack.unpatchify(jt, 3, 4, 2, 4), 0)
    jtab = j_pack.sincos_2d_pos_embed(32, 384, 64)
    ttab = t_pack.sincos_2d_pos_embed(32, 384, 64)
    assert_close(ttab, jtab, 1e-5)
    assert_close(t_pack.cropped_pos_embed(ttab, 384, hp, hp),
                 j_pack.cropped_pos_embed(jtab, 384, hp, hp), 1e-5)


def test_patch_embed_and_sd35x_adaln():
    rng = np.random.default_rng(1)
    jp = j_emb.init_patch_embed(jax.random.PRNGKey(0), 2, 4, D, 16, 8)
    jx, tx = pair(normal(rng, 2, 4, LAT, LAT))
    assert_close(t_emb.patch_embed(to_torch_tree(jp), tx, 2, 16),
                 j_emb.patch_embed(jp, jx, 2, 16), TOL)
    ja = j_adaln.init_adaln(jax.random.PRNGKey(1), D, 9)
    jh, th = pair(normal(rng, 2, S, D))
    for temb_shape in ((2, D), (2, S, D)):        # per-sample and token-wise
        jt, tt = pair(normal(rng, *temb_shape))
        got = t_adaln.adaln_sd35x(to_torch_tree(ja), th, tt)
        want = j_adaln.adaln_sd35x(ja, jh, jt)
        for a, b in zip(want, got):
            assert_close(b, a, TOL)
        assert_close(t_adaln.gate(got[0], got[1]), j_adaln.gate(want[0], want[1]), TOL)


@pytest.mark.parametrize("mode", ["joint", "context_pre_only", "kv_append"])
def test_sd3_joint_attention(mode):
    """Sample-first concatenation with qk RMSNorm on both streams, the
    context-pre-only module (no ctx output) and the rope-free KV-append."""
    rng = np.random.default_rng(2)
    jp = j_attn.init_joint_attention(
        jax.random.PRNGKey(3), D, HEADS, HD, context=True, qk_norm="rms_norm",
        context_pre_only=(mode == "context_pre_only"),
        condition_kv=(mode == "kv_append"))
    jx, tx = pair(normal(rng, 2, S, D))
    jctx, tctx = pair(normal(rng, 2, T, D))
    jkv = tkv = None
    if mode == "kv_append":
        jkv, tkv = pair(normal(rng, 2, 5, D))
    jo = j_attn.joint_attention(jp, jx, jctx, heads=HEADS, context_first=False,
                                condition_kv_states=jkv)
    to = t_attn.joint_attention(to_torch_tree(jp), tx, tctx, heads=HEADS,
                                context_first=False, condition_kv_states=tkv)
    assert (to[1] is None) == (mode == "context_pre_only") == (jo[1] is None)
    for a, b in zip(jo, to):
        if a is not None:
            assert_close(b, a, TOL)


@pytest.mark.parametrize("kind", ["plain", "dual", "context_pre_only_dual",
                                  "kv_append", "single"])
def test_sd3_blocks(kind):
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(4)
    jx, tx = pair(normal(rng, 2, S, D))
    jctx, tctx = pair(normal(rng, 2, T, D))
    if kind == "single":                          # token-wise temb (experts)
        jp = j_blocks.init_sd3_single_block(key, D, HEADS, HD, qk_norm="rms_norm")
        jt, tt = pair(normal(rng, 2, S, D))
        assert_close(t_blocks.sd3_single_block(to_torch_tree(jp), tx, tt, heads=HEADS),
                     j_blocks.sd3_single_block(jp, jx, jt, heads=HEADS), TOL)
        return
    jp = j_blocks.init_sd3_joint_block(
        key, D, HEADS, HD, qk_norm="rms_norm",
        use_dual_attention=kind in ("dual", "context_pre_only_dual"),
        context_pre_only=(kind == "context_pre_only_dual"),
        condition_kv=(kind == "kv_append"))
    jt, tt = pair(normal(rng, 2, D))
    jkv = tkv = None
    if kind == "kv_append":
        jkv, tkv = pair(normal(rng, 2, S, D))
    jo = j_blocks.sd3_joint_block(jp, jx, jctx, jt, heads=HEADS,
                                  condition_kv_states=jkv)
    to = t_blocks.sd3_joint_block(to_torch_tree(jp), tx, tctx, tt, heads=HEADS,
                                  condition_kv_states=tkv)
    assert (to[0] is None) == (kind == "context_pre_only_dual")
    for a, b in zip(jo, to):
        if a is not None:
            assert_close(b, a, TOL)


def test_sd3_forward():
    """The backbone alone: dual blocks 0-1, plain block 2, the
    context-pre-only last block; timesteps on 0..1000."""
    rng = np.random.default_rng(4)
    jp = j_sd3.init_sd3_params(jax.random.PRNGKey(5), SD3)
    assert set(jp) >= {"dual_blocks", "plain_blocks", "last_block"}
    args = [normal(rng, 2, SD3.in_channels, LAT, LAT),
            normal(rng, 2, T, SD3.joint_attention_dim),
            normal(rng, 2, SD3.pooled_projection_dim),
            np.array([912.5, 37.0], np.float32)]
    want = j_sd3.sd3_forward(jp, SD3, *(jnp.asarray(a) for a in args))
    got = t_sd3.sd3_forward(to_torch_tree(jp), tcfg.tiny_sd3_config(),
                            *(torch.from_numpy(a) for a in args))
    assert got.shape == (2, SD3.out_channels, LAT, LAT)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("b", [2, 4])
def test_moe_block_experts_global_routing(b):
    """Block experts (token-wise temb) under global routing: one capacity
    ceil(B*S/E) over the whole batch, so a sample's output depends on its
    batch mates, as in JAX."""
    rng = np.random.default_rng(5)
    jc, tc = _configs()
    assert jc.control.moe.batch_mode == "global"
    e = jc.control.moe.num_experts(1)
    jp = j_moe.init_moe_params(
        jax.random.PRNGKey(6), D, SD3.pooled_projection_dim, e, modulated=False,
        expert_block_init=lambda k: j_blocks.init_sd3_single_block(
            k, D, HEADS, HD, qk_norm="rms_norm"))
    (jh, th), (jcd, tcd) = pair(normal(rng, b, S, D)), pair(normal(rng, b, S, D))
    names = {"temb": D, "condition_temb": D, "pooled": SD3.pooled_projection_dim,
             "condition_pooled": SD3.pooled_projection_dim}
    streams = {k: normal(rng, b, n) for k, n in names.items()}
    jo = j_moe.moe_apply(jp, jc.control, e, jh, jcd,
                         {k: jnp.asarray(v) for k, v in streams.items()},
                         block_apply=j_blocks.sd3_single_block, heads=HEADS)
    to = t_moe.moe_apply(to_torch_tree(jp), tc.control, e, th, tcd,
                         {k: torch.from_numpy(v) for k, v in streams.items()},
                         block_apply=t_blocks.sd3_single_block, heads=HEADS)
    for a, bb in zip(jo, to):
        assert_close(bb, a, TOL)


@functools.lru_cache(maxsize=None)
def _fp32_params(cn2base):
    """A JAX fp32 tree (built once per merge method) whose zero-init add
    linears carry random values, so the control branch shapes the output."""
    p = j_usd3.init_unigen_sd3_params(jax.random.PRNGKey(0), _configs(cn2base)[0])
    rng = np.random.default_rng(100)
    w = p["control"]["add_blocks"]["w"]
    p["control"]["add_blocks"]["w"] = jnp.asarray(
        rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return p


def _params(cn2base, dtype):
    p = _fp32_params(cn2base)
    if dtype == jnp.bfloat16:      # the bf16 tree keeps the router and tables fp32
        return jax.tree_util.tree_map_with_path(
            lambda path, x: x if any(s in jax.tree_util.keystr(path)
                                     for s in ("gate", "pos_embed']['pos_embed",
                                               "pos_embed_input']['pos_embed"))
            else x.astype(jnp.bfloat16), p)
    return p


def _batch(rng, b=2):
    return dict(hidden=normal(rng, b, SD3.in_channels, LAT, LAT),
                condition=normal(rng, b, SD3.in_channels, LAT, LAT),
                encoder=normal(rng, b, T, SD3.joint_attention_dim),
                pooled=normal(rng, b, SD3.pooled_projection_dim),
                condition_pooled=normal(rng, b, SD3.pooled_projection_dim))


_jit_forward = jax.jit(j_usd3.unigen_sd3_forward, static_argnums=(1,))


@pytest.mark.parametrize("cn2base,dtype", [("add", "fp32"), ("CrossAttn", "fp32"),
                                           ("add", "bf16"), ("CrossAttn", "bf16")])
def test_unigen_sd3_forward(cn2base, dtype):
    rng = np.random.default_rng(6)
    jc, tc = _configs(cn2base)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = _params(cn2base, jdt)
    assert ("cross_kv" in jp["control"]) == (cn2base == "CrossAttn")
    batch = _batch(rng)
    t = np.array([875.0, 312.5], np.float32)
    jpred, jl, jo = _jit_forward(jp, jc, **{k: jnp.asarray(v, jdt) for k, v in batch.items()},
                                 timestep=jnp.asarray(t, jdt), conditioning_scale=0.7)
    tpred, tl, to = t_usd3.unigen_sd3_forward(
        to_torch_tree(jp), tc, **{k: torch.from_numpy(v).to(tdt) for k, v in batch.items()},
        timestep=torch.from_numpy(t).to(tdt),
        conditioning_scale=torch.tensor(0.7, dtype=torch.float32))
    assert tpred.dtype == tdt
    assert rel_l2(tpred, jpred) <= (2e-2 if dtype == "bf16" else 5e-3)
    if dtype == "fp32":
        assert_close(tl["moe_loss"], jl["moe_loss"], 2e-3)
        np.testing.assert_array_equal(to["expert_counts"].numpy(),
                                      np.asarray(jo["expert_counts"]))


@pytest.mark.parametrize("dtype,g", [("fp32", 7.0), ("bf16", 2.0)])
def test_two_step_cfg_denoise_matches_jax(dtype, g):
    """UniGenSD3.denoise against a JAX loop of unigen_sd3_forward,
    inference_sigmas(shift=3.0) and euler_step, as bench_sd3 and the SD3
    pipeline build it: [neg; pos] on the batch axis, pred = neg + g*(pos -
    neg), the timestep sigma*1000 rounded to the activation dtype, and the
    conditioning window (end 0.5: step 1 runs with scale 0). fp32 runs the
    published guidance 7.0. bf16 rounds at other places in the two
    frameworks (XLA keeps fp32 inside fused elementwise chains, torch rounds
    each op), about 0.6% relative L2 per forward here; the combine
    multiplies that by about g*|pred|/|pos - neg|, which is ~90 at g = 7 on
    this random tiny model, so the bf16 case runs at g = 2."""
    rng = np.random.default_rng(7)
    jc, tc = _configs()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = _params("add", jdt)
    b, steps = 2, 2
    batch = _batch(rng, b)
    neg = normal(rng, b, T, SD3.joint_attention_dim)
    neg_pooled = normal(rng, b, SD3.pooled_projection_dim)
    sig, ts = j_sched.inference_sigmas(j_sched.FlowMatchConfig(shift=3.0), steps)
    keep = [1.0 - float((i / steps < 0.0) or ((i + 1) / steps > 0.5))
            for i in range(steps)]
    schedule = jnp.asarray(np.float32(1.0) * np.array(keep, np.float32))
    jb = {k: jnp.asarray(v, jdt) for k, v in batch.items()}
    enc = jnp.concatenate([jnp.asarray(neg, jdt), jb["encoder"]])
    pool = jnp.concatenate([jnp.asarray(neg_pooled, jdt), jb["pooled"]])
    cpool = jnp.concatenate([jb["condition_pooled"]] * 2)
    cond = jnp.concatenate([jb["condition"]] * 2)
    lat = jb["hidden"]
    for i in range(steps):
        pred, _, _ = _jit_forward(jp, jc, hidden=jnp.concatenate([lat, lat]),
                                  condition=cond, encoder=enc, pooled=pool,
                                  condition_pooled=cpool,
                                  timestep=jnp.full((2 * b,), ts[i], jdt),
                                  conditioning_scale=schedule[i])
        n, p = pred[:b], pred[b:]
        lat = j_sched.euler_step(lat, n + g * (p - n), sig[i], sig[i + 1])
    model = t_usd3.UniGenSD3(tc, to_torch_tree(jp), device="cpu", dtype=tdt)
    out = model.denoise(batch["hidden"], batch["condition"], batch["encoder"],
                        batch["pooled"], batch["condition_pooled"], neg, neg_pooled,
                        num_steps=steps, guidance_scale=g, control_guidance_end=0.5)
    assert out.dtype == tdt and out.shape == lat.shape
    assert rel_l2(out, lat) <= (2e-2 if dtype == "bf16" else 5e-3)


def test_full_width_tree_layout_matches_jax_package():
    """The full SD3.5-medium UniGen tree (24 + 24 joint blocks, 6 block
    experts, the shared expert) has the JAX tree's leaf paths, shapes and
    dtypes, both from the port's init and from the card's serving builder
    (run here on the meta device)."""
    from unigen_tpu_torch.io.from_jax import init_sd3_serving_params
    jc, tc = j_presets.sd35_medium(), t_presets.sd35_medium()
    want = jax.eval_shape(lambda k: j_usd3.init_unigen_sd3_params(k, jc, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p, simple=True, separator="."):
            (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(want)}
    for got in (t_usd3.init_unigen_sd3_params(tc, device="meta", dtype=torch.bfloat16),
                init_sd3_serving_params(tc, device="meta")):
        got = {".".join(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in tree_leaves_with_path(got)}
        assert got == want
    assert want["control.moe.experts.hid_block.attn.to_q.w"] == ((6, 1536, 1536), "bfloat16")
    assert want["base.dual_blocks.attn2.to_q.w"][0][0] == 13


def test_serving_params_fill_and_cross_kv_list():
    """The serving builder fills a CrossAttn tree (a list of per-block
    KV projections) on the CPU: computed sincos tables, unit norm scales."""
    _, tc = _configs("CrossAttn")
    from unigen_tpu_torch.io.from_jax import init_sd3_serving_params
    p = init_sd3_serving_params(tc, seed=1, device="cpu", dtype=torch.float32)
    assert len(p["control"]["cross_kv"]) == SD3.num_layers
    assert torch.equal(p["control"]["cross_kv"][0]["condition_k_norm"]["scale"],
                       torch.ones(HD))
    want = t_pack.sincos_2d_pos_embed(D, SD3.pos_embed_max_size,
                                      SD3.sample_size // SD3.patch_size)
    assert torch.equal(p["base"]["pos_embed"]["pos_embed"], want)
    again = init_sd3_serving_params(tc, seed=1, device="cpu", dtype=torch.float32)
    assert torch.equal(again["base"]["last_block"]["ff"]["fc1"]["w"],
                       p["base"]["last_block"]["ff"]["fc1"]["w"])


def _base_variant_params(tc):
    """A UniGenBase tree drawn by the port's init (the preprocess weave
    blocks, the joint_dim context embedder; single control blocks without
    encoder states; the target's own patch embed with use_pos_embed) with
    random add linears, as the JAX tree of the same numpy leaves (JAX's
    eager init of this tree takes ~13 s)."""
    tp = t_usd3.init_unigen_sd3_params(tc, gen=torch.Generator().manual_seed(2),
                                       device="cpu", base_variant=True)
    rng = np.random.default_rng(101)
    w = tp["control"]["add_blocks"]["w"]
    w.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, size=tuple(w.shape)).astype(np.float32)))
    return to_jax_tree(tp)


def _variant_configs(cn2base, enc_states=True, pos_embed=False):
    """Two control blocks over the four base blocks: residual int(i / 2)
    feeds base block i."""
    jc, tc = _configs(cn2base)
    kw = dict(use_encoder_hidden_states=enc_states, use_pos_embed=pos_embed,
              num_layers=2)
    return (dataclasses.replace(jc, control=dataclasses.replace(jc.control, **kw)),
            dataclasses.replace(tc, control=dataclasses.replace(tc.control, **kw)))


_jit_base_forward = jax.jit(j_usd3.unigen_base_forward, static_argnums=(1,),
                            static_argnames=("return_control_residuals",
                                             "control_residuals_bits"))


@pytest.mark.parametrize("cn2base,dtype,enc_states,pos_embed", [
    ("add", "fp32", False, False), ("CrossAttn", "bf16", True, True)])
def test_unigen_base_forward(cn2base, dtype, enc_states, pos_embed):
    """The UniGenBase forward against JAX's (fp32: the single-block control
    stack, against JAX's int8 capture, whose residuals the port's match
    within one code step; bf16: joint control blocks, CrossAttn and the
    target's own patch embed), then the port's capture and replay: at 16
    bits the capture and the replay at the capture's state give the plain
    forward's bits, an int8 replay stays within REPLAY_REL_L2 of it. The
    port's base-variant init has the JAX tree's layout. One JAX compile a
    case keeps the file's time down."""
    from chip_smoke import REPLAY_REL_L2
    rng = np.random.default_rng(8)
    jc, tc = _variant_configs(cn2base, enc_states, pos_embed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    p32 = _base_variant_params(tc)
    jp = (jax.tree_util.tree_map_with_path(
        lambda path, x: x if any(s in jax.tree_util.keystr(path)
                                 for s in ("gate", "pos_embed']['pos_embed",
                                           "pos_embed_input']['pos_embed"))
        else x.astype(jnp.bfloat16), p32) if dtype == "bf16" else p32)
    batch = _batch(rng)
    t = np.array([875.0, 312.5], np.float32)
    jkw = dict({k: jnp.asarray(v, jdt) for k, v in batch.items()},
               timestep=jnp.asarray(t, jdt), conditioning_scale=0.7)
    tkw = dict({k: torch.from_numpy(v).to(tdt) for k, v in batch.items()},
               timestep=torch.from_numpy(t).to(tdt), conditioning_scale=0.7)
    tp = to_torch_tree(jp)
    tpred = t_usd3.unigen_base_forward(tp, tc, **tkw)[0]
    assert tpred.dtype == tdt
    if dtype == "fp32":
        jpred, _, jo = _jit_base_forward(jp, jc, return_control_residuals=True,
                                         control_residuals_bits=8, **jkw)
        tres = t_usd3.unigen_base_forward(tp, tc, return_control_residuals=True,
                                          control_residuals_bits=8,
                                          **tkw)[2]["control_residuals"]
        jres = jo["control_residuals"]
        assert set(tres) == set(jres) == {"q", "s"}
        step = np.asarray(jres["s"])          # one int8 code, per token
        diff = np.abs(tres["q"].numpy().astype(np.float32) * tres["s"].numpy()
                      - np.asarray(jres["q"], np.float32) * step)
        assert np.all(diff <= 1.01 * step + 1e-7)
        assert rel_l2(tpred, jpred) <= 5e-3
        trep = t_usd3.unigen_base_forward(tp, tc, control_residuals=tres, **tkw)[0]
        assert rel_l2(trep, tpred) <= REPLAY_REL_L2[8]
    else:
        jpred = _jit_base_forward(jp, jc, **jkw)[0]
        assert rel_l2(tpred, jpred) <= 2e-2
        cap, _, outs = t_usd3.unigen_base_forward(tp, tc, return_control_residuals=True,
                                                  **tkw)
        res = outs["control_residuals"]
        assert res.shape == (2, 2, S, D)
        rep = t_usd3.unigen_base_forward(tp, tc, control_residuals=res, **tkw)[0]
        assert torch.equal(cap, tpred) and torch.equal(rep, tpred)
    want = jax.eval_shape(lambda k: j_usd3.init_unigen_sd3_params(
        k, jc, base_variant=True), jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p, simple=True, separator="."): tuple(x.shape)
            for p, x in jax.tree_util.tree_leaves_with_path(want)}
    got = {".".join(p): tuple(x.shape) for p, x in tree_leaves_with_path(
        t_usd3.init_unigen_sd3_params(tc, device="meta", base_variant=True))}
    assert got == want
