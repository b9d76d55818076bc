"""The RoPE attention's rotation pass on the CPU: its plain version against
the JAX package's ``apply_rotary`` cast to bf16 (the operand that
``_ref_attn_rope`` feeds its product, unigen_tpu/ops/pallas/
flash_attention.py:330-333), and the launch counters and formulas of
chip_smoke.py that count it (one pass per RoPE forward and per RoPE
backward call). The kernel itself is tested on the card by
tests/test_torch_port_cuda.py. The same pass rounds the rope-free kernels'
fp32 operands (rounding jobs, head dim 64 or 128; one launch per fp32
rope-free call)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import normal
from unigen_tpu.ops.rope import apply_rotary as j_apply_rotary
from unigen_tpu.ops.rope import rope_multi_axis
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
from unigen_tpu_torch.ops.cuda import flash_attention as t_fa


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_rotation_plain_version_matches_jax_apply_rotary(dtype):
    """bf16 and fp32 inputs over 40 positions, the last 8 with identity
    tables (KV-append keys): rot(x) rounded to bf16 equals the JAX
    package's apply_rotary cast to bf16 bit for bit; a job without tables
    is x rounded to bf16. On CPU tensors rope_rotate takes the plain version
    and launches nothing."""
    rng = np.random.default_rng(11)
    ids = np.stack([np.zeros(40), np.arange(40) // 8, np.arange(40) % 8], -1)
    cos, sin = (np.array(t) for t in rope_multi_axis(jnp.asarray(ids, jnp.float32),
                                                     (16, 56, 56)))
    cos[-8:], sin[-8:] = 1.0, 0.0
    x = np.array(jnp.asarray(normal(rng, 2, 3, 40, 128), dtype).astype(jnp.float32))
    want = np.asarray(j_apply_rotary(jnp.asarray(x, dtype), jnp.asarray(cos),
                                     jnp.asarray(sin)).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tabs = (torch.from_numpy(cos), torch.from_numpy(sin))
    before = t_fa.rotate_launches
    got, plain = t_fa.rope_rotate([(tx, *tabs), (tx, None, None)])
    assert t_fa.rotate_launches == before
    assert got.dtype == plain.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got, t_fa.rope_rotate_ref(tx, *tabs))
    assert torch.equal(plain, tx.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rounding_job_plain_version_at_head_dim_64(dtype):
    """A rounding job (no tables) at SD3's head dim 64 and a ragged length:
    x rounded to bf16, bit for bit, and no launch on CPU tensors."""
    x = torch.from_numpy(normal(np.random.default_rng(12), 2, 3, 37, 64)).to(dtype)
    before = t_fa.rotate_launches
    (got,) = t_fa.rope_rotate([(x, None, None)])
    assert t_fa.rotate_launches == before
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, x.to(torch.bfloat16))
    assert torch.equal(t_fa.rope_rotate_ref(x), x.to(torch.bfloat16))


def test_launch_counts_include_the_rotation_pass(monkeypatch):
    """launch_counts reports the rotation pass's counter and
    reset_launch_counts clears it with the others."""
    for name in ("launches", "rotate_launches", "dq_launches", "dkv_launches"):
        monkeypatch.setattr(t_fa, name, 3)
    counts = chip_smoke.launch_counts()
    assert counts["rope_rotate"] == counts["flash_attention_rope"] == 3
    chip_smoke.reset_launch_counts()
    assert set(chip_smoke.launch_counts().values()) == {0}


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_launch_formulas_count_one_rotation_per_rope_call(control):
    """expected_launches: one rotation pass per RoPE forward call;
    expected_train_launches: one per RoPE forward (recomputed ones
    included) and one per RoPE backward, on flux_full's tree (meta
    tensors), with the default and the shipped control values."""
    cfg = t_presets.flux_full()
    if control == "blocks":
        cfg = chip_smoke.shipped_control(cfg)
    params = init_quantized_serving_params(cfg, device="meta")
    fwd = chip_smoke.expected_launches(params, cfg, 2)
    assert fwd["rope_rotate"] == fwd["flash_attention_rope"] > 0
    train = chip_smoke.expected_train_launches(params, cfg, 2)
    assert train["rope_rotate"] == (train["flash_attention_rope"]
                                    + train["flash_attention_rope_bwd_dq"])
    assert train["flash_attention_rope_bwd_dq"] == fwd["flash_attention_rope"] - 1


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_launch_formulas_count_one_rounding_pass_per_fp32_rope_free_call(control):
    """With fp32 activations each rope-free forward (recomputed ones
    included) and each rope-free backward also launches the rounding pass
    once: both formulas add exactly those calls to the RoPE calls' passes,
    and bf16 activations add none."""
    cfg = t_presets.flux_full()
    if control == "blocks":
        cfg = chip_smoke.shipped_control(cfg)
    params = init_quantized_serving_params(cfg, device="meta")
    fwd, fwd32 = (chip_smoke.expected_launches(params, cfg, 2, fp32=f) for f in (False, True))
    assert fwd32["rope_rotate"] == fwd["rope_rotate"] + fwd["flash_attention"]
    assert {k: n for k, n in fwd32.items() if k != "rope_rotate"} == {
        k: n for k, n in fwd.items() if k != "rope_rotate"}
    train, train32 = (chip_smoke.expected_train_launches(params, cfg, 2, fp32=f)
                      for f in (False, True))
    assert train32["rope_rotate"] == (train["rope_rotate"] + train["flash_attention"]
                                      + train["flash_attention_bwd_dq"])
    assert (train32["rope_rotate"] > train["rope_rotate"]) == (control == "blocks")
