"""Parity of the port's layers with the JAX package on the CPU, at the tiny
preset in fp32: joint attention (both concat orders and the KV-append
identity rows), the FLUX double and single blocks, the plain FLUX forward,
per-sample MoE at b=2, and the copied configs. Same algorithm, another summation order: rtol=atol
=1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, normal, pair, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu import presets as j_presets
from unigen_tpu.layers import attention as j_attn
from unigen_tpu.layers import blocks_flux as j_blocks
from unigen_tpu.models import flux as j_flux
from unigen_tpu.models import moe as j_moe
from unigen_tpu.ops.rope import rope_multi_axis
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.layers import attention as t_attn
from unigen_tpu_torch.layers import blocks_flux as t_blocks
from unigen_tpu_torch.models import flux as t_flux
from unigen_tpu_torch.models import moe as t_moe

TOL = 1e-4
FLUX = jcfg.tiny_flux_config()
D, HEADS, HD = FLUX.inner_dim, FLUX.num_attention_heads, FLUX.attention_head_dim
S = 16


def _configs(conditions=("canny",)):
    """The same tiny UniGen config in the JAX package and in the port."""
    jc = jcfg.UniGenConfig(family="flux", flux=FLUX, condition_types=conditions)
    return jc, t_presets.tiny(conditions)


def _rope(rng, s):
    ids = rng.integers(0, 7, size=(s, 3)).astype(np.float32)
    jc, js = rope_multi_axis(jnp.asarray(ids), FLUX.axes_dims_rope)
    return (jc, js), (torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(js)))


@pytest.mark.parametrize("mode", ["context_first", "sample_first", "kv_append"])
def test_joint_attention(mode):
    rng = np.random.default_rng(0)
    jp = j_attn.init_joint_attention(jax.random.PRNGKey(1), D, HEADS, HD,
                                     context=True, condition_kv=True)
    tp = to_torch_tree(jp)
    jx, tx = pair(normal(rng, 2, 5, D))
    jctx, tctx = pair(normal(rng, 2, 3, D))
    jrope, trope = _rope(rng, 8)
    kw = dict(heads=HEADS, context_first=(mode != "sample_first"))
    jkv = tkv = None
    if mode == "kv_append":
        jkv, tkv = pair(normal(rng, 2, 4, D))
    jo = j_attn.joint_attention(jp, jx, jctx, rope=jrope,
                                condition_kv_states=jkv, **kw)
    to = t_attn.joint_attention(tp, tx, tctx, rope=trope,
                                condition_kv_states=tkv, **kw)
    for a, b in zip(jo, to):
        assert_close(b, a, TOL)


def test_flux_double_and_single_blocks():
    rng = np.random.default_rng(1)
    jd = j_blocks.init_flux_double_block(jax.random.PRNGKey(2), D, HEADS, HD)
    js = j_blocks.init_flux_single_block(jax.random.PRNGKey(3), D, HEADS, HD)
    td, ts = to_torch_tree(jd), to_torch_tree(js)
    jx, tx = pair(normal(rng, 2, 5, D))
    jctx, tctx = pair(normal(rng, 2, 3, D))
    jt, tt = pair(normal(rng, 2, D))
    jrope, trope = _rope(rng, 8)
    for first in (True, False):
        jo = j_blocks.flux_double_block(jd, jx, jctx, jt, jrope, heads=HEADS,
                                        context_first=first)
        to = t_blocks.flux_double_block(td, tx, tctx, tt, trope, heads=HEADS,
                                        context_first=first)
        for a, b in zip(jo, to):
            assert_close(b, a, TOL)
    jtok, ttok = pair(normal(rng, 2, 8, D))          # token-wise temb
    jx8, tx8 = pair(normal(rng, 2, 8, D))
    assert_close(t_blocks.flux_single_block(ts, tx8, ttok, trope, heads=HEADS),
                 j_blocks.flux_single_block(js, jx8, jtok, jrope, heads=HEADS), TOL)


def test_flux_forward():
    """The backbone alone (no control branch): 2 double and 4 single blocks."""
    rng = np.random.default_rng(6)
    jp = j_flux.init_flux_params(jax.random.PRNGKey(5), FLUX)
    ids = rng.integers(0, 4, size=(S, 3)).astype(np.float32)
    txt_ids = np.zeros((6, 3), np.float32)
    args = [normal(rng, 2, S, FLUX.in_channels), normal(rng, 2, 6, FLUX.joint_attention_dim),
            normal(rng, 2, FLUX.pooled_projection_dim),
            np.array([0.3, 0.9], np.float32), ids, txt_ids]
    want = j_flux.flux_forward(jp, FLUX, *(jnp.asarray(a) for a in args))
    got = t_flux.flux_forward(to_torch_tree(jp), t_presets.tiny().flux,
                              *(torch.from_numpy(a) for a in args))
    assert_close(got, want, TOL)


def test_moe_apply_per_sample_b2():
    rng = np.random.default_rng(2)
    jc, tc = _configs()
    jcc = dataclasses.replace(jc.control, moe=dataclasses.replace(
        jc.control.moe, batch_mode="per_sample"))
    tcc = dataclasses.replace(tc.control, moe=dataclasses.replace(
        tc.control.moe, batch_mode="per_sample"))
    e = jcc.moe.num_experts(1)
    jp = j_moe.init_moe_params(jax.random.PRNGKey(4), D,
                               FLUX.pooled_projection_dim, e, modulated=True)
    tp = to_torch_tree(jp)
    (jh, th), (jcd, tcd) = pair(normal(rng, 2, S, D)), pair(normal(rng, 2, S, D))
    names = {"temb": D, "condition_temb": D, "pooled": FLUX.pooled_projection_dim,
             "condition_pooled": FLUX.pooled_projection_dim}
    streams = {k: normal(rng, 2, n) for k, n in names.items()}
    jo = j_moe.moe_apply(jp, jcc, e, jh, jcd,
                         {k: jnp.asarray(v) for k, v in streams.items()})
    to = t_moe.moe_apply(tp, tcc, e, th, tcd,
                         {k: torch.from_numpy(v) for k, v in streams.items()})
    # capacity 4 for 16 tokens over 6 experts: some tokens drop
    assert int(jnp.sum(jo.expert_counts)) == 2 * S
    for a, b in zip(jo, to):
        assert_close(b, a, TOL)


def test_port_config_matches_jax_config():
    jc, tc = _configs()
    assert dataclasses.asdict(tc.flux) == dataclasses.asdict(jc.flux)
    assert dataclasses.asdict(tc.control) == dataclasses.asdict(jc.control)
    for name in ("flux_full", "flux_bench"):
        j, t = getattr(j_presets, name)(), getattr(t_presets, name)()
        assert dataclasses.asdict(t.flux) == dataclasses.asdict(j.flux)
        assert dataclasses.asdict(t.control) == dataclasses.asdict(j.control)
        assert isinstance(t, tcfg.UniGenConfig)
