"""Parity of the port's small modules with the JAX package on the CPU, at
the tiny preset in fp32: rope, packing, core layers, quantization (exact),
AdaLN, embedders, top-1 gating and the Euler step. The same fp32 algorithm
on one CPU differs only in summation order, hence rtol=atol=1e-4; the
integer quantization paths must match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (assert_close, assert_equal, normal, pair,
                                to_torch_tree)
from unigen_tpu import config as jcfg
from unigen_tpu.layers import adaln as j_adaln
from unigen_tpu.layers import core as j_core
from unigen_tpu.layers import embeddings as j_emb
from unigen_tpu.ops import gating as j_gating
from unigen_tpu.ops import packing as j_packing
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.ops import rope as j_rope
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu_torch.layers import adaln as t_adaln
from unigen_tpu_torch.layers import core as t_core
from unigen_tpu_torch.layers import embeddings as t_emb
from unigen_tpu_torch.ops import gating as t_gating
from unigen_tpu_torch.ops import packing as t_packing
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.ops import rope as t_rope
from unigen_tpu_torch.pipelines import scheduling as t_sched

TOL = 1e-4
FLUX = jcfg.tiny_flux_config()
D = FLUX.inner_dim


def _ids(rng, s):
    return rng.integers(0, 9, size=(s, 3)).astype(np.float32)


def test_rope_tables_and_rotation():
    rng = np.random.default_rng(0)
    jids, tids = pair(_ids(rng, 10))
    jc, js = j_rope.rope_multi_axis(jids, FLUX.axes_dims_rope)
    tc, ts = t_rope.rope_multi_axis(tids, FLUX.axes_dims_rope)
    assert_close(tc, jc, TOL)
    assert_close(ts, js, TOL)
    jx, tx = pair(normal(rng, 2, 4, 10, FLUX.attention_head_dim))
    assert_close(t_rope.apply_rotary(tx, tc, ts), j_rope.apply_rotary(jx, jc, js), TOL)


def test_packing_round_trip_and_ids():
    rng = np.random.default_rng(1)
    jx, tx = pair(normal(rng, 2, 4, 8, 6))
    jp, tp = j_packing.pack_latents(jx), t_packing.pack_latents(tx)
    assert_equal(tp, jp)
    assert_equal(t_packing.unpack_latents(tp, 8, 6), j_packing.unpack_latents(jp, 8, 6))
    assert_equal(t_packing.prepare_latent_image_ids(4, 3, offset_w=3.0),
                 j_packing.prepare_latent_image_ids(4, 3, offset_w=3.0))


def test_core_layers():
    rng = np.random.default_rng(2)
    jp = j_core.init_mlp(jax.random.PRNGKey(0), D)
    tp = to_torch_tree(jp)
    jx, tx = pair(normal(rng, 2, 5, D))
    assert_close(t_core.linear(tp["fc1"], tx), j_core.linear(jp["fc1"], jx), TOL)
    assert_close(t_core.mlp(tp, tx), j_core.mlp(jp, jx), TOL)
    assert_close(t_core.gelu_tanh(tx), j_core.gelu_tanh(jx), TOL)
    jw, tw = pair(normal(rng, D) + 1.0)
    jb, tb = pair(normal(rng, D))
    assert_close(t_core.layer_norm(tx, weight=tw, bias=tb),
                 j_core.layer_norm(jx, weight=jw, bias=jb), TOL)
    assert_close(t_core.rms_norm({"scale": tw}, tx),
                 j_core.rms_norm({"scale": jw}, jx), TOL)


def test_int4_pack_unpack_and_weight_quant_exact():
    rng = np.random.default_rng(3)
    codes = rng.integers(-7, 8, size=(3, 10, 6)).astype(np.int8)
    jq, tq = pair(codes, np.int8)
    jpk, tpk = j_quant.pack_int4(jq), t_quant.pack_int4(tq)
    assert_equal(tpk, jpk)
    assert_equal(t_quant.unpack_int4(tpk), j_quant.unpack_int4(jpk))
    assert_equal(t_quant.unpack_int4(tpk), codes)
    jw, tw = pair(normal(rng, 2, 64, 24, scale=0.02))
    for j_fn, t_fn in ((j_quant.quantize_weight, t_quant.quantize_weight),
                       (j_quant.quantize_weight_int4, t_quant.quantize_weight_int4)):
        jo, to = j_fn(jw), t_fn(tw)
        assert jo.keys() == to.keys()
        for k in jo:
            assert_equal(to[k], jo[k])


def test_activation_quant_and_quantized_matmuls_exact():
    rng = np.random.default_rng(4)
    jx, tx = pair(normal(rng, 2, 7, 64))
    jxq, jxs = j_quant._quantize_act(jx)
    txq, txs = t_quant._quantize_act(tx)
    assert_equal(txq, jxq)
    assert_equal(txs, jxs)
    jw, tw = pair(normal(rng, 64, 40, scale=0.02))
    j8, t8 = j_quant.quantize_weight(jw), t_quant.quantize_weight(tw)
    assert_equal(t_quant.int8_matmul(tx, t8["w_q"], t8["w_scale"]),
                 j_quant.int8_matmul(jx, j8["w_q"], j8["w_scale"]))
    j4, t4 = j_quant.quantize_weight_int4(jw), t_quant.quantize_weight_int4(tw)
    assert_equal(t_quant.int4_matmul(tx, t4["w_q4"], t4["w_scale"]),
                 j_quant.int4_matmul(jx, j4["w_q4"], j4["w_scale"]))


def test_quantize_tree_int4_exact():
    jp = {"blocks": j_core.init_mlp(jax.random.PRNGKey(5), D),
          "gate": j_core.init_linear(jax.random.PRNGKey(6), D, 6),
          "small": j_core.init_linear(jax.random.PRNGKey(7), 8, D)}
    jq = j_quant.quantize_tree(jp, bits=4, min_dim=16)
    tq = t_quant.quantize_tree(to_torch_tree(jp), bits=4, min_dim=16)
    jl = jax.tree_util.tree_leaves_with_path(jq)
    tl = jax.tree_util.tree_leaves_with_path(tq)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    assert "w_q4" in tq["blocks"]["fc1"] and "w" in tq["gate"] and "w" in tq["small"]
    for (_, j), (_, t) in zip(jl, tl):
        assert_equal(t, j)


@pytest.mark.parametrize("temb_rank", [2, 3])
def test_adaln_variants(temb_rank):
    rng = np.random.default_rng(8)
    jx, tx = pair(normal(rng, 2, 5, D))
    jt, tt = pair(normal(rng, 2, D) if temb_rank == 2 else normal(rng, 2, 5, D))
    for n, j_fn, t_fn in ((6, j_adaln.adaln_zero, t_adaln.adaln_zero),
                          (3, j_adaln.adaln_zero_single, t_adaln.adaln_zero_single),
                          (2, j_adaln.adaln_continuous, t_adaln.adaln_continuous)):
        jp = j_adaln.init_adaln(jax.random.PRNGKey(n), D, n)
        jo, to = j_fn(jp, jx, jt), t_fn(to_torch_tree(jp), tx, tt)
        jo, to = jax.tree.leaves(jo), (list(to) if isinstance(to, tuple) else [to])
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            assert_close(b, a, TOL)
    assert_close(t_adaln.modulate(tx, tx * 0.5, tx * 0.1),
                 j_adaln.modulate(jx, jx * 0.5, jx * 0.1), TOL)


def test_embedders():
    rng = np.random.default_rng(9)
    jt, tt = pair(rng.uniform(0, 1000, size=3))
    assert_close(t_emb.timestep_sinusoidal(tt), j_emb.timestep_sinusoidal(jt), TOL)
    jp = j_emb.init_combined_time_text(jax.random.PRNGKey(1), D,
                                       FLUX.pooled_projection_dim, guidance=True)
    jpool, tpool = pair(normal(rng, 3, FLUX.pooled_projection_dim))
    jg, tg = pair(rng.uniform(0, 1000, size=3))
    assert_close(t_emb.combined_time_text(to_torch_tree(jp), tt, tpool, tg),
                 j_emb.combined_time_text(jp, jt, jpool, jg), TOL)


def test_top1_gate_drops_and_gather_dispatch():
    rng = np.random.default_rng(10)
    s, e, cap = 24, 3, 5           # 24 tokens, capacity 5/expert: tokens drop
    jl, tl = pair(normal(rng, s, e) + np.array([2.0, 0.0, 0.0], np.float32))
    jg, tg = j_gating.top1_gate(jl, cap), t_gating.top1_gate(tl, cap)
    assert float(jnp.sum(jg.kept)) < s          # some tokens were dropped
    for name in ("combine_weights", "aux_loss", "gate_scalar", "kept"):
        assert_close(getattr(tg, name), getattr(jg, name), TOL)
    for name in ("dispatch_mask", "expert_counts", "expert_idx", "slot"):
        assert_equal(getattr(tg, name), getattr(jg, name))
    assert t_gating.compute_capacity(24, 3, 1.0, 4) == \
        j_gating.compute_capacity(24, 3, 1.0, 4)
    streams = {"hidden": normal(rng, 2, 12, 8), "pooled": normal(rng, 2, 4),
               "text": normal(rng, 2, 5, 8)}
    jr, jd = j_gating.dispatch_streams_gather(
        jg, cap, e, 12, {k: jnp.asarray(v) for k, v in streams.items()})
    tr, td = t_gating.dispatch_streams_gather(
        tg, cap, e, 12, {k: torch.from_numpy(v) for k, v in streams.items()})
    assert_equal(td, jd)
    for k in streams:
        assert_close(tr[k], jr[k], TOL)
    assert_close(t_gating.combine_gather(tg, td, tr["hidden"]),
                 j_gating.combine_gather(jg, jd, jr["hidden"]), TOL)


def test_euler_step_and_sigmas():
    rng = np.random.default_rng(11)
    for cfg in (dict(shift=1.0), dict(shift=3.0),
                dict(use_dynamic_shifting=True)):
        js, jt = j_sched.inference_sigmas(j_sched.FlowMatchConfig(**cfg), 4,
                                          image_seq_len=1024)
        ts, tt = t_sched.inference_sigmas(t_sched.FlowMatchConfig(**cfg), 4,
                                          image_seq_len=1024)
        assert_close(ts, js, 1e-7)
        assert_close(tt, jt, 1e-7)
    jx, tx = pair(normal(rng, 2, 16, 16))
    jv, tv = pair(normal(rng, 2, 16, 16))
    assert_close(t_sched.euler_step(tx, tv, ts[1], ts[2]),
                 j_sched.euler_step(jx, jv, js[1], js[2]), TOL)
