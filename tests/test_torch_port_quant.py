"""The per-token activation quantization and the W4A8 routing on the CPU:
the quantization's plain version against the JAX package's
``_quantize_act`` bit for bit on its edge rows, the wrappers' device rule,
which W4A8 kernel and tile a shape takes, and the launch-formula terms of
chip_smoke.py that count both. The CUDA kernels themselves are tested on
the card by tests/test_torch_port_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import normal
from unigen_tpu.ops import quant as j_quant
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm

# values of exact .5 ties of x / xs: with amax 127 the scale is 1, with
# 15.875 it is 0.125 (both exact); every value is a bf16 value
TIES_SCALE_1 = [127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -126.5]
TIES_SCALE_EIGHTH = [15.875, 0.0625, 0.1875, -0.3125, 15.8125, -15.875, 8.0625]


def edge_rows(k: int, seed: int = 0) -> np.ndarray:
    """[6, k] fp32 rows, all bf16 values: an all-zero row (xs = 1); rows
    that reach +amax and -amax (codes +127 and -127); two rows of .5 ties
    (round half to even); a Gaussian row."""
    rng = np.random.default_rng(seed)
    x = np.zeros((6, k), np.float32)
    x[1] = np.clip(normal(rng, k), -5.9, 5.9)
    x[1, 3], x[1, k - 1] = 6.0, -6.0
    x[2, :8] = TIES_SCALE_1
    x[3, :7] = TIES_SCALE_EIGHTH
    x[4] = -x[1] * 0.75
    x[5] = normal(rng, k) * 3
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [64, 15360])
def test_quantize_act_plain_version_bit_identical_to_jax(dtype, k):
    """Codes and scales of quantize_act_ref (and of _quantize_act, which
    takes it on CPU tensors) equal JAX's _quantize_act bit for bit on the
    edge rows, at a short row and at the single blocks' K=15360."""
    x = edge_rows(k)
    jq, js = j_quant._quantize_act(jnp.asarray(x, getattr(jnp, dtype)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    for tq, ts in (t_qm.quantize_act_ref(tx), t_quant._quantize_act(tx)):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
    q, s = t_qm.quantize_act_ref(tx)
    assert s[0].item() == 1.0 and not q[0].any()
    assert {q[1, 3].item(), q[1, k - 1].item()} == {127, -127}
    assert s[2].item() == 1.0 and q[2, :8].tolist() == [127, 2, -4, 0, 2, 0, 126, -126]
    assert s[3].item() == 0.125 and q[3, :7].tolist() == [127, 0, 2, -2, 126, -127, 64]


def test_quantize_act_wrapper_takes_plain_version_only_on_cpu():
    """CPU tensors take the plain version and launch nothing, any leading
    shape through _quantize_act; other devices raise."""
    x = torch.from_numpy(normal(np.random.default_rng(3), 2, 3, 40))
    before = t_qm.quantize_launches
    got, want = t_quant._quantize_act(x), t_qm.quantize_act_ref(x)
    assert got[0].shape == (2, 3, 40) and got[1].shape == (2, 3, 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(t_qm.quantize_act(x[0]),
                                                 t_qm.quantize_act_ref(x[0])))
    with pytest.raises(ValueError):
        t_qm.quantize_act(x[0].to("meta"))
    assert t_qm.quantize_launches == before


@pytest.mark.parametrize("m,k,n,want", [
    (2, 3072, 18432, (64, 2)), (2, 3072, 9216, (64, 1)), (1024, 3072, 3072, (256, 1)),
    (1024, 12288, 3072, (256, 1)), (2048, 12288, 3072, (256, 1)), (3072, 15360, 3072, (256, 1)),
    (37, 1000, 130, (64, 1)), (300, 3072, 520, (256, 1)), (65, 1032, 144, (256, 1))])
def test_w4a8_route_and_tile(m, k, n, want):
    """Shapes whose K and N are multiples of 16 (every main-path shape) take
    the Hopper kernel, others the general one. Token rows take 256-row
    tiles, short M 64-row tiles; K splits in two only where the measured
    sweep found it faster (short M past one wave of tiles)."""
    assert t_qm.tma_shape(k, n) == (k % 16 == 0 and n % 16 == 0)
    assert t_qm.tile(m, n, k) == want


@pytest.mark.parametrize("control", ["rope", "blocks"])
def test_launch_formulas_count_one_quantization_per_quantized_linear(control):
    """expected_launches: one activation quantization per W4A8 and per W8A8
    linear call (936 W4A8 + 89 W8A8 on flux_full at b=2: the control
    embedders, the shared expert's two weaves and the add linears after
    every base block; the context branches that the control double blocks
    and weave_text skip, 57 W4A8 and 3 W8A8 calls, are not counted), no
    general W4A8 launch; expected_train_launches adds the calls the remat
    bodies run again (the control add linears included)."""
    cfg = t_presets.flux_full()
    if control == "blocks":
        cfg = chip_smoke.shipped_control(cfg)
    params = init_quantized_serving_params(cfg, device="meta")
    fwd = chip_smoke.expected_launches(params, cfg, 2)
    assert fwd["w4a8_matmul"] == 936 and fwd["w4a8_general"] == 0
    assert fwd["quantize_act"] == 936 + chip_smoke.quantized_calls(params, cfg, "w_q") == 1025
    train = chip_smoke.expected_train_launches(params, cfg, 2)
    again_w8 = chip_smoke.quantized_calls(params, cfg, "w_q", again=True)
    assert again_w8 == cfg.flux.num_layers - 1 + cfg.flux.num_single_layers
    assert train["quantize_act"] == (fwd["quantize_act"] + train["w4a8_matmul"]
                                     - fwd["w4a8_matmul"] + again_w8)
    assert train["w4a8_general"] == 0


def test_launch_counts_include_quantization_and_general_w4a8(monkeypatch):
    """launch_counts reports the quantization and the general W4A8 kernel's
    counters and reset_launch_counts clears them with the others."""
    for name in ("launches", "general_launches", "quantize_launches"):
        monkeypatch.setattr(t_qm, name, 5)
    counts = chip_smoke.launch_counts()
    assert counts["quantize_act"] == counts["w4a8_general"] == counts["w4a8_matmul"] == 5
    chip_smoke.reset_launch_counts()
    assert set(chip_smoke.launch_counts().values()) == {0}
