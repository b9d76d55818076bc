"""The whole UniGen-FLUX slice against the JAX package on the CPU, at the
tiny preset: a JAX ``init_unigen_flux_params`` tree is carried across (its
zero-init add linears filled with random values first, so the control
branch shapes the output) and ``unigen_flux_forward`` and a 2-step Euler
denoise run on both sides with the same numpy inputs.

The forward also runs with the reference's shipped control values
(``use_rope = use_modulate = False``: rope-free control blocks and weave,
each MoE expert a pair of FLUX single blocks).

Tolerances: fp32 at the repo's golden 2e-3; bf16 within 2e-2 relative L2
(catches dtype-promotion faults); W4A8 within 5e-3 relative L2 (a 1e-6
input difference can flip one int8 activation code)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, normal, rel_l2, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.models.unigen_flux import (init_unigen_flux_params,
                                           unigen_flux_forward)
from unigen_tpu.ops.packing import prepare_latent_image_ids
from unigen_tpu.ops.quant import quantize_tree
from unigen_tpu.pipelines import scheduling as j_sched
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.models.unigen_flux import UniGenFlux
from unigen_tpu_torch.models.unigen_flux import \
    unigen_flux_forward as t_forward

FLUX = jcfg.tiny_flux_config()
HW, T = 4, 6                     # 4x4 packed image tokens, 6 text tokens
S = HW * HW


def _configs(conditions=("canny",), blocks=False):
    """The same tiny UniGen config in the JAX package and in the port;
    ``blocks``: the reference's control values, rope-free with block
    experts."""
    jc = jcfg.UniGenConfig(family="flux", flux=FLUX, condition_types=conditions)
    tc = t_presets.tiny(conditions)
    if blocks:
        jc, tc = (dataclasses.replace(c, control=dataclasses.replace(
            c.control, use_rope=False, use_modulate=False)) for c in (jc, tc))
    return jc, tc


@functools.lru_cache(maxsize=None)
def _fp32_params(conditions, blocks=False):
    """A JAX fp32 tree (built once per condition set and control kind) whose
    zero-init add linears carry random values."""
    p = init_unigen_flux_params(jax.random.PRNGKey(0), _configs(conditions, blocks)[0])
    rng = np.random.default_rng(100)
    for k in ("add_double", "add_single"):
        w = p["control"][k]["w"]
        p["control"][k]["w"] = jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return p


def _params(variant, conditions):
    p = _fp32_params(conditions, variant.startswith("blocks"))
    if variant.endswith("bf16"):   # the bf16 serving tree keeps the router fp32
        return jax.tree_util.tree_map_with_path(
            lambda path, x: x if "gate" in jax.tree_util.keystr(path)
            else x.astype(jnp.bfloat16), p)
    if variant == "w4a8":
        return jax.jit(functools.partial(quantize_tree, bits=4, min_dim=16))(p)
    return p


def _batch(rng, b=2, k=None):
    lead = (b,) if k is None else (k, b)
    bb = FLUX
    ids = np.array(prepare_latent_image_ids(HW, HW))
    return dict(
        hidden=normal(rng, b, S, bb.in_channels),
        condition=normal(rng, *lead, S, bb.in_channels),
        encoder=normal(rng, b, T, bb.joint_attention_dim),
        pooled=normal(rng, b, bb.pooled_projection_dim),
        condition_pooled=normal(rng, *lead, bb.pooled_projection_dim),
        timestep=np.full((b,), 0.7, np.float32),
        img_ids=ids, txt_ids=np.zeros((T, 3), np.float32),
        condition_ids=ids if k is None else np.stack([ids] * k))


_jit_forward = jax.jit(unigen_flux_forward, static_argnums=(1,))


def _both_forwards(jc, tc, jp, batch, dtype):
    jb = {k: jnp.asarray(v, jnp.float32 if k.endswith("ids") else dtype)
          for k, v in batch.items()}
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tb = {k: torch.from_numpy(v).to(torch.float32 if k.endswith("ids") else tdt)
          for k, v in batch.items()}
    jpred, jl, jo = _jit_forward(jp, jc, **jb)
    tpred, tl, to = t_forward(to_torch_tree(jp), tc, **tb)
    assert tpred.dtype == tdt
    return (jpred, jl, jo), (tpred, tl, to)


@pytest.mark.parametrize("variant", ["fp32", "bf16", "w4a8", "multi_condition",
                                     "blocks_fp32", "blocks_bf16"])
def test_unigen_flux_forward(variant):
    rng = np.random.default_rng(3)
    conditions = ("canny", "depth") if variant == "multi_condition" else ("canny",)
    jc, tc = _configs(conditions, variant.startswith("blocks"))
    dtype = jnp.bfloat16 if variant.endswith("bf16") else jnp.float32
    jp = _params(variant, conditions)
    if variant.startswith("blocks"):
        assert "hid_block" in jp["control"]["moe"]["experts"]
    batch = _batch(rng, k=2 if variant == "multi_condition" else None)
    (jpred, jl, jo), (tpred, tl, to) = _both_forwards(jc, tc, jp, batch, dtype)
    if variant.endswith("bf16"):
        assert rel_l2(tpred, jpred) <= 2e-2
    elif variant == "w4a8":
        assert rel_l2(tpred, jpred) <= 5e-3
    else:
        assert_close(tpred, jpred, 2e-3)
        assert_close(tl["moe_loss"], jl["moe_loss"], 2e-3)
        np.testing.assert_array_equal(to["expert_counts"].numpy(),
                                      np.asarray(jo["expert_counts"]))


@pytest.mark.parametrize("variant", ["fp32", "bf16"])
def test_two_step_denoise_matches_jax(variant):
    """The bench's denoise: the timestep is rounded to the activation dtype
    before the forward, the Euler update runs in fp32."""
    rng = np.random.default_rng(4)
    jc, tc = _configs()
    jp = _params(variant, ("canny",))
    dtype = jnp.bfloat16 if variant == "bf16" else jnp.float32
    b = 2
    batch = _batch(rng, b)
    sig = j_sched.inference_sigmas(j_sched.FlowMatchConfig(shift=1.0), 2)[0]
    lat = jnp.asarray(batch["hidden"], dtype)
    jb = {k: jnp.asarray(v, jnp.float32 if k.endswith("ids") else dtype)
          for k, v in batch.items() if k not in ("hidden", "timestep")}
    for i in range(2):
        pred, _, _ = _jit_forward(jp, jc, hidden=lat,
                                  timestep=jnp.full((b,), sig[i], dtype), **jb)
        lat = j_sched.euler_step(lat, pred, sig[i], sig[i + 1])
    tdt = torch.bfloat16 if variant == "bf16" else torch.float32
    model = UniGenFlux(tc, to_torch_tree(jp), device="cpu", dtype=tdt)
    out = model.denoise(batch["hidden"], batch["condition"], batch["encoder"],
                        batch["pooled"], batch["condition_pooled"], num_steps=2)
    assert out.dtype == tdt
    if variant == "bf16":
        assert rel_l2(out, lat) <= 2e-2
    else:
        assert_close(out, lat, 2e-3)


def test_fp32_conditioning_scale_keeps_bf16_stream():
    """A strongly typed fp32 scale must not promote the bf16 residual stream."""
    rng = np.random.default_rng(5)
    _, tc = _configs()
    tp = to_torch_tree(_params("bf16", ("canny",)))
    batch = {k: torch.from_numpy(v).to(torch.float32 if k.endswith("ids")
                                       else torch.bfloat16)
             for k, v in _batch(rng).items()}
    pred, _, _ = t_forward(tp, tc, **batch,
                           conditioning_scale=torch.tensor(0.5, dtype=torch.float32))
    assert pred.dtype == torch.bfloat16
