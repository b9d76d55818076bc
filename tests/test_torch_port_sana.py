"""The SANA modules of the port against the JAX package on the CPU, at
``tiny_sana_config`` (2 blocks, 4 x 8 linear heads, 2 x 16 cross heads),
``tiny_gemma_config`` and ``tiny_dcae_config``: the linear attention, the
masked cross-attention (with a fully padded row), GLUMBConv, the SANA block
with [B, 6D] and token-wise [B, S, 6D] modulation, the backbone,
``sana_unigen_forward`` (fp32 and bf16, the shared expert, control-residual
capture and replay at 16 / 8 / 4 bits), Gemma-2 with a padding mask and a
sequence past the sliding window, the DC-AE encode and decode, and the
DC-AE's native files written by one package and read by the other. JAX
trees cross by ``tree_from_numpy``; inputs are numpy draws from a seed.

Tolerances: fp32 within rtol=atol=2e-3 (the repo's golden); bf16 forwards
within 2e-2 relative L2 (bf16 rounds at other places in the two
frameworks); a bf16 replay at the capture's state gives the plain
forward's bits; native files round-trip bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, normal, rel_l2, to_jax_tree, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.layers import blocks_sana as j_blocks
from unigen_tpu.models import dcae as j_dcae
from unigen_tpu.models import gemma_text as j_gemma
from unigen_tpu.models import sana as j_sana
from unigen_tpu.ops import quant as j_quant
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.layers import blocks_sana as t_blocks
from unigen_tpu_torch.models import dcae as t_dcae
from unigen_tpu_torch.models import gemma_text as t_gemma
from unigen_tpu_torch.models import sana as t_sana
from unigen_tpu_torch.ops.quant import dequantize_residual, residual_at

TOL = 2e-3
SANA = jcfg.tiny_sana_config()
D = SANA.inner_dim
HW, T = 8, 5                     # 8x8 latents (64 tokens), 5 caption tokens


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _configs():
    """The same tiny UniGen-SANA config in the JAX package and in the port
    (the default control branch: shared expert, 6 modulated experts)."""
    jc = jcfg.UniGenConfig(family="sana", sana=SANA, condition_types=("canny",),
                           control=jcfg.ControlConfig())
    tc = tcfg.UniGenConfig(family="sana", sana=tcfg.tiny_sana_config(),
                           condition_types=("canny",), control=tcfg.ControlConfig())
    return jc, tc


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def test_config_matches_jax():
    jc, tc = _configs()
    assert jcfg.asdict(jc.sana) == tcfg.dataclasses.asdict(tc.sana)
    assert tc.backbone is tc.sana
    assert (tcfg.SanaBackboneConfig().inner_dim, tcfg.SanaBackboneConfig().num_layers) == \
        (2240, 20)


@functools.lru_cache(maxsize=None)
def _block_params():
    """A SANA block drawn by the port's init, as JAX arrays (JAX's eager
    inits cost seconds here); its layout is held against JAX's below."""
    return to_jax_tree(t_blocks.init_sana_block(
        D, SANA.num_attention_heads, SANA.attention_head_dim,
        cross_heads=SANA.num_cross_attention_heads,
        cross_head_dim=SANA.cross_attention_head_dim,
        gen=torch.Generator().manual_seed(3), device="cpu"))


def test_linear_attention():
    rng = np.random.default_rng(0)
    jp = _block_params()["attn1"]
    x = normal(rng, 2, 16, D)
    want = j_blocks.linear_attention(jp, jnp.asarray(x), heads=SANA.num_attention_heads)
    got = t_blocks.linear_attention(to_torch_tree(jp), _t(x),
                                    heads=SANA.num_attention_heads)
    assert_close(got, want, TOL)


def test_cross_attention_masked_with_a_padded_row():
    rng = np.random.default_rng(1)
    jp = _block_params()["attn2"]
    x, ctx = normal(rng, 3, 16, D), normal(rng, 3, T, D)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], np.int32)
    want = j_blocks.cross_attention(jp, jnp.asarray(x), jnp.asarray(ctx),
                                    heads=SANA.num_cross_attention_heads,
                                    ctx_mask=jnp.asarray(mask))
    got = t_blocks.cross_attention(to_torch_tree(jp), _t(x), _t(ctx),
                                   heads=SANA.num_cross_attention_heads,
                                   ctx_mask=torch.from_numpy(mask))
    assert_close(got, want, TOL)
    # the padding keys do not reach a masked row
    ctx2 = ctx.copy()
    ctx2[0, 3:] += 5.0
    got2 = t_blocks.cross_attention(to_torch_tree(jp), _t(x), _t(ctx2),
                                    heads=SANA.num_cross_attention_heads,
                                    ctx_mask=torch.from_numpy(mask))
    assert_close(got2[0], got[0], 1e-5)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 2)])
def test_glumb_conv(h, w):
    rng = np.random.default_rng(2)
    jp = jax.tree.map(lambda a: a, _block_params()["ff"])
    # a non-zero depthwise bias, so the bias path is held too
    jp["depth"]["b"] = jnp.asarray(normal(rng, *jp["depth"]["b"].shape, scale=0.3))
    x = normal(rng, 2, h * w, D)
    want = j_blocks.glumb_conv(jp, jnp.asarray(x), h, w)
    got = t_blocks.glumb_conv(to_torch_tree(jp), _t(x), h, w)
    assert_close(got, want, TOL)


@pytest.mark.parametrize("tokenwise", [False, True])
def test_sana_block(tokenwise):
    rng = np.random.default_rng(3)
    jp = _block_params()
    x, ctx = normal(rng, 2, 16, D), normal(rng, 2, T, D)
    temb = normal(rng, *((2, 16, 6 * D) if tokenwise else (2, 6 * D)), scale=0.3)
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0]], np.int32)
    want = j_blocks.sana_block(jp, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(temb),
                               4, 4, heads=SANA.num_attention_heads,
                               cross_heads=SANA.num_cross_attention_heads,
                               ctx_mask=jnp.asarray(mask))
    got = t_blocks.sana_block(to_torch_tree(jp), _t(x), _t(ctx), _t(temb), 4, 4,
                              heads=SANA.num_attention_heads,
                              cross_heads=SANA.num_cross_attention_heads,
                              ctx_mask=torch.from_numpy(mask))
    assert_close(got, want, TOL)


def _batch(rng, b=2):
    return dict(hidden=normal(rng, b, SANA.in_channels, HW, HW),
                condition=normal(rng, b, SANA.in_channels, HW, HW),
                encoder=normal(rng, b, T, SANA.caption_channels),
                pooled=normal(rng, b, SANA.pooled_projection_dim),
                condition_pooled=normal(rng, b, SANA.pooled_projection_dim))


MASK = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], np.int32)
TSTEP = np.array([0.875, 0.3125], np.float32)        # the pipeline's t / 1000


def test_sana_forward():
    rng = np.random.default_rng(4)
    jp = to_jax_tree(t_sana.init_sana_params(tcfg.tiny_sana_config(),
                                         gen=torch.Generator().manual_seed(1), device="cpu"))
    assert jax.tree.map(np.shape, jp) == jax.tree.map(np.shape, jax.eval_shape(
        lambda k: j_sana.init_sana_params(k, SANA), jax.random.PRNGKey(0)))
    bt = _batch(rng)
    want = jax.jit(j_sana.sana_forward, static_argnums=(1,))(
        jp, SANA, jnp.asarray(bt["hidden"]), jnp.asarray(bt["encoder"]),
        jnp.asarray(TSTEP), jnp.asarray(MASK))
    got = t_sana.sana_forward(to_torch_tree(jp), tcfg.tiny_sana_config(),
                              _t(bt["hidden"]), _t(bt["encoder"]), _t(TSTEP),
                              torch.from_numpy(MASK))
    assert got.shape == (2, SANA.out_channels, HW, HW)
    assert_close(got, want, TOL)


@functools.lru_cache(maxsize=None)
def _unigen_params():
    """The port's tree (its layout held against JAX's) as JAX arrays, with
    random add linears, so the control branch and the shared expert shape
    the output."""
    jc, tc = _configs()
    tp = t_sana.init_sana_unigen_params(tc, gen=torch.Generator().manual_seed(0),
                                        device="cpu")
    p = to_jax_tree(tp)
    assert jax.tree.map(np.shape, p) == jax.tree.map(np.shape, jax.eval_shape(
        lambda k: j_sana.init_sana_unigen_params(k, jc), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(100)
    w = p["control"]["add_blocks"]["w"]
    p["control"]["add_blocks"]["w"] = jnp.asarray(
        rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return p


def _as(dtype, tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x if "gate" in jax.tree_util.keystr(path) else x.astype(dtype),
        tree)


_jit_unigen = jax.jit(j_sana.sana_unigen_forward, static_argnums=(1,),
                      static_argnames=("return_control_residuals",
                                       "control_residuals_bits"))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_sana_unigen_forward(dtype):
    rng = np.random.default_rng(5)
    jc, tc = _configs()
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jp = _as(jdt, _unigen_params())
    assert "shared_expert" in jp["control"]
    bt = _batch(rng)
    jpred, jl, jo = _jit_unigen(jp, jc, **{k: jnp.asarray(v, jdt) for k, v in bt.items()},
                                timestep=jnp.asarray(TSTEP, jdt),
                                encoder_mask=jnp.asarray(MASK), conditioning_scale=0.7)
    tpred, tl, to = t_sana.sana_unigen_forward(
        to_torch_tree(jp), tc, **{k: _t(v, tdt) for k, v in bt.items()},
        timestep=_t(TSTEP, tdt), encoder_mask=torch.from_numpy(MASK),
        conditioning_scale=0.7)
    assert tpred.dtype == tdt
    if dtype == "fp32":
        assert_close(tpred, jpred, TOL)
        assert_close(tl["moe_loss"], jl["moe_loss"], TOL)
        np.testing.assert_array_equal(to["expert_counts"].numpy(),
                                      np.asarray(jo["expert_counts"]))
    else:
        assert rel_l2(tpred, jpred) <= 2e-2


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_capture_and_replay(bits):
    """Capture against JAX's captured residuals; a replay at the capture's
    state equals the plain forward (bit for bit at 16 bits in bf16, within
    the fp32 tolerance of JAX's replay at 8 / 4 bits)."""
    rng = np.random.default_rng(6)
    jc, tc = _configs()
    bt = _batch(rng)
    if bits == 16:
        tp = to_torch_tree(_as(jnp.bfloat16, _unigen_params()))
        kw = dict({k: _t(v, torch.bfloat16) for k, v in bt.items()},
                  timestep=_t(TSTEP, torch.bfloat16), encoder_mask=torch.from_numpy(MASK),
                  conditioning_scale=0.7)
        plain = t_sana.sana_unigen_forward(tp, tc, **kw)[0]
        cap, _, outs = t_sana.sana_unigen_forward(tp, tc, return_control_residuals=True,
                                                  **kw)
        res = outs["control_residuals"]
        assert res.shape == (SANA.num_layers, 2, HW * HW, D)
        rep = t_sana.sana_unigen_forward(tp, tc, control_residuals=res, **kw)[0]
        assert torch.equal(cap, plain) and torch.equal(rep, plain)
        return
    jp = _unigen_params()
    jkw = dict({k: jnp.asarray(v) for k, v in bt.items()}, timestep=jnp.asarray(TSTEP),
               encoder_mask=jnp.asarray(MASK), conditioning_scale=0.7)
    _, _, jo = _jit_unigen(jp, jc, return_control_residuals=True,
                           control_residuals_bits=bits, **jkw)
    jrep = _jit_unigen(jp, jc, control_residuals=jo["control_residuals"], **jkw)[0]
    tp = to_torch_tree(jp)
    tkw = dict({k: _t(v) for k, v in bt.items()}, timestep=_t(TSTEP),
               encoder_mask=torch.from_numpy(MASK), conditioning_scale=0.7)
    _, _, to = t_sana.sana_unigen_forward(tp, tc, return_control_residuals=True,
                                          control_residuals_bits=bits, **tkw)
    res = to["control_residuals"]
    assert set(res) == set(jo["control_residuals"])
    for i in range(SANA.num_layers):
        want = j_quant.dequantize_residual(
            jax.tree.map(lambda r: r[i], jo["control_residuals"]), jnp.float32)
        got = dequantize_residual(residual_at(res, i), torch.float32)
        # one code step where the two frameworks' fp32 residuals round apart
        step = float(np.abs(np.asarray(want)).max()) / (127 if bits == 8 else 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=step * 1.01)
    trep = t_sana.sana_unigen_forward(tp, tc, control_residuals=res, **tkw)[0]
    assert_close(trep, jrep, TOL)


# ------------------------------------------------------------ Gemma-2

def _gemma_tree(cfg, seed):
    rng = np.random.default_rng(seed)
    d, hd = cfg.hidden_size, cfg.head_dim

    def lin(i, o):
        return {"w": normal(rng, i, o, scale=i ** -0.5)}

    def norm():
        return {"scale": normal(rng, d, scale=0.1)}

    def layer():
        return {"input_ln": norm(), "post_attn_ln": norm(), "pre_ff_ln": norm(),
                "post_ff_ln": norm(),
                "attn": {"q": lin(d, cfg.num_heads * hd), "k": lin(d, cfg.num_kv_heads * hd),
                         "v": lin(d, cfg.num_kv_heads * hd), "o": lin(cfg.num_heads * hd, d)},
                "gate": lin(d, cfg.intermediate_size), "up": lin(d, cfg.intermediate_size),
                "down": lin(cfg.intermediate_size, d)}
    return {"embed": normal(rng, cfg.vocab_size, d, scale=0.5),
            "layers": [layer() for _ in range(cfg.num_layers)], "final_ln": norm()}


@pytest.mark.parametrize("s", [12, 40])
def test_gemma_encode(s):
    """A padding mask, and (at 40) a sequence past the tiny window of 16, so
    the sliding layers mask."""
    jcf, tcf = j_gemma.tiny_gemma_config(), t_gemma.tiny_gemma_config()
    tree = _gemma_tree(tcf, 7)
    rng = np.random.default_rng(8)
    ids = rng.integers(0, tcf.vocab_size, (2, s))
    mask = np.ones((2, s), np.int32)
    mask[1, s - 3:] = 0
    want = jax.jit(j_gemma.gemma_encode, static_argnums=(1,))(
        jax.tree.map(jnp.asarray, tree), jcf, jnp.asarray(ids), jnp.asarray(mask))
    got = t_gemma.gemma_encode(to_torch_tree(tree), tcf, torch.from_numpy(ids),
                               torch.from_numpy(mask))
    assert_close(got, want, TOL)
    # the port's init has the bridge's layout
    init = t_gemma.init_gemma_params(tcf, gen=torch.Generator().manual_seed(0),
                                     device="cpu")
    assert jax.tree.structure(jax.tree.map(np.shape, tree)) == jax.tree.structure(
        jax.tree.map(lambda t: tuple(t.shape), init))


# ------------------------------------------------------------ DC-AE

@functools.lru_cache(maxsize=None)
def _dcae_tree():
    """A tiny DC-AE drawn by the port's init, as JAX arrays (JAX's eager
    init of it takes ~20 s on this CPU)."""
    cfg = j_dcae.tiny_dcae_config()
    tree = t_dcae.init_dcae_params(t_dcae.tiny_dcae_config(),
                                   gen=torch.Generator().manual_seed(4), device="cpu")
    return to_jax_tree(tree), cfg


def test_dcae_encode_decode():
    """Encode (fp32 pixels; bf16 pixels reach the fp32 codec as fp32) and
    decode (bf16 latents cast to fp32 at the boundary) against JAX's, one
    jitted program for both; the init's structure and shapes are JAX's."""
    jp, jc = _dcae_tree()
    tc = t_dcae.tiny_dcae_config()
    rng = np.random.default_rng(9)
    px = rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32)
    lat = normal(rng, 2, tc.latent_channels, 4, 4)
    z_j, want = jax.jit(lambda p, x, z: (j_dcae.dcae_encode(p, jc, x),
                                         j_dcae.dcae_decode(p, jc, z)))(
        jp, jnp.asarray(px), jnp.asarray(lat, jnp.bfloat16))
    tp = to_torch_tree(jp)
    z_t = t_dcae.dcae_encode(tp, tc, _t(px))
    assert z_t.shape == (2, tc.latent_channels, 16 // tc.downscale, 16 // tc.downscale)
    assert_close(z_t, z_j, TOL)
    assert t_dcae.dcae_encode(tp, tc, _t(px, torch.bfloat16)).dtype == torch.float32
    got = t_dcae.dcae_decode(tp, tc, _t(lat, torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_close(got, want, TOL)
    struct = jax.eval_shape(lambda k: j_dcae.init_dcae_params(k, jc), jax.random.PRNGKey(0))
    init = t_dcae.init_dcae_params(tc, device="meta")
    assert jax.tree.map(lambda a: tuple(a.shape), struct) == \
        jax.tree.map(lambda t: tuple(t.shape), init)


def test_dcae_native_files_both_ways(tmp_path):
    jp, jc = _dcae_tree()
    j_dcae.save_dcae_native(str(tmp_path / "from_jax"), jp, jc)
    tp, tc = t_dcae.load_dcae_native(str(tmp_path / "from_jax"), device="cpu")
    assert tc == t_dcae.tiny_dcae_config()
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(jax.tree.map(
            lambda t: t.numpy(), tp))):
        np.testing.assert_array_equal(np.asarray(a), b)
    port = t_dcae.init_dcae_params(tc, gen=torch.Generator().manual_seed(1),
                                   device="cpu")
    t_dcae.save_dcae_native(str(tmp_path / "from_port"), port, tc)
    assert t_dcae.has_dcae_native(str(tmp_path / "from_port"))
    back, bc = j_dcae.load_dcae_native(str(tmp_path / "from_port"))
    assert bc == jc
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), port)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, np.asarray(b))
