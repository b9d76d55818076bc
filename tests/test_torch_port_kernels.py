"""The port's kernels on the CPU: their plain PyTorch versions against the
Pallas kernels they replace (interpret mode), the full-KV and the streaming
schedules of both attention forwards included, and the wrappers' device
rule. The CUDA kernels themselves are tested on the card by
tests/test_torch_port_cuda.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, assert_equal, normal, pair
from unigen_tpu.ops import quant as j_quant
from unigen_tpu.ops.rope import rope_multi_axis
from unigen_tpu_torch.ops import quant as t_quant
from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm


@pytest.fixture()
def pallas(monkeypatch):
    """The JAX package's Pallas modules reloaded in interpret mode."""
    monkeypatch.setenv("UNIGEN_PALLAS_INTERPRET", "1")
    import unigen_tpu.ops.pallas.flash_attention as fa
    import unigen_tpu.ops.pallas.quant_matmul as qm
    importlib.reload(fa)
    importlib.reload(qm)
    yield fa, qm
    monkeypatch.delenv("UNIGEN_PALLAS_INTERPRET")
    importlib.reload(fa)
    importlib.reload(qm)


def _tables(sq, skv, n_identity):
    """Q tables over sq rows; K tables over skv rows whose last n_identity
    rows are identity (cos=1, sin=0), the KV-append convention."""
    r = np.arange(max(sq, skv))
    ids = np.stack([np.zeros_like(r), r // 8, r % 8], -1).astype(np.float32)
    cos, sin = (np.array(t) for t in rope_multi_axis(jnp.asarray(ids), (16, 56, 56)))
    kcos, ksin = cos[:skv].copy(), sin[:skv].copy()
    kcos[skv - n_identity:], ksin[skv - n_identity:] = 1.0, 0.0
    return cos[:sq].copy(), sin[:sq].copy(), kcos, ksin


@pytest.mark.parametrize("sq,skv", [(160, 160), (130, 257)])
def test_attention_plain_version_matches_pallas(pallas, sq, skv):
    fa, _ = pallas
    rng = np.random.default_rng(0)
    tabs = [pair(t) for t in _tables(sq, skv, n_identity=32)]
    jq, tq = pair(normal(rng, 1, 2, sq, 128))
    jk, tk = pair(normal(rng, 1, 2, skv, 128))
    jv, tv = pair(normal(rng, 1, 2, skv, 128))
    want = fa.flash_attention_rope(jq, jk, jv, *(j for j, _ in tabs))
    got = t_fa.flash_attention_rope(tq, tk, tv, *(t for _, t in tabs))
    assert_close(got, want, 3e-5)     # the JAX kernel test's own tolerance


@pytest.mark.parametrize("d", [64, 128])
def test_rope_free_plain_version_matches_pallas(pallas, d):
    """Ragged lengths (Sq=200, Skv=333: the Pallas kernel pads and masks
    the KV tail to -1e30) at SD3's head dim and at 128."""
    fa, _ = pallas
    rng = np.random.default_rng(3)
    (jq, tq), (jk, tk), (jv, tv) = (pair(normal(rng, 1, 2, s, d))
                                    for s in (200, 333, 333))
    assert_close(t_fa.flash_attention(tq, tk, tv), fa.flash_attention(jq, jk, jv), 3e-5)


def test_rope_free_plain_version_matches_pallas_streaming(pallas):
    """Past the 2560-key gate the TPU takes the online-softmax streaming
    kernel (flash_attention_streaming); the port's one kernel (and so its
    one plain version) serves both."""
    fa, _ = pallas
    rng = np.random.default_rng(4)
    (jq, tq), (jk, tk), (jv, tv) = (pair(normal(rng, 1, 2, s, 64))
                                    for s in (130, 2700, 2700))
    assert not fa.supported(jq, jk, jv)
    assert_close(t_fa.flash_attention(tq, tk, tv),
                 fa.flash_attention_streaming(jq, jk, jv), 3e-5)


def test_rope_plain_version_matches_pallas_streaming(pallas):
    """Kernel 1's plain version against flash_attention_streaming_rope at
    2700 keys, the last 300 of them KV-append rows with identity tables."""
    fa, _ = pallas
    rng = np.random.default_rng(5)
    tabs = [pair(t) for t in _tables(130, 2700, n_identity=300)]
    (jq, tq), (jk, tk), (jv, tv) = (pair(normal(rng, 1, 2, s, 128))
                                    for s in (130, 2700, 2700))
    want = fa.flash_attention_streaming_rope(jq, jk, jv, *(j for j, _ in tabs))
    got = t_fa.flash_attention_rope(tq, tk, tv, *(t for _, t in tabs))
    assert_close(got, want, 3e-5)


@pytest.mark.parametrize("m,k,n", [(40, 1024, 384), (40, 1536, 384), (40, 1152, 384)])
def test_w4a8_plain_version_bit_identical_to_pallas(pallas, m, k, n):
    """K=1152: K/2 = 576 packed rows, not a whole number of the Hopper
    kernel's 128-row stages (its last stage reads past K/2)."""
    _, qm = pallas
    rng = np.random.default_rng(1)
    jw, tw = pair(normal(rng, k, n, scale=0.02))
    jx, tx = pair(normal(rng, m, k))
    jq4, tq4 = j_quant.quantize_weight_int4(jw), t_quant.quantize_weight_int4(tw)
    jxq, jxs = j_quant._quantize_act(jx)
    txq, txs = t_quant._quantize_act(tx)
    want = qm.w4a8_matmul_pallas(jxq, jxs, jq4["w_q4"],
                                 jq4["w_scale"].reshape(1, -1), jnp.float32)
    got = t_qm.w4a8_matmul(txq, txs, tq4["w_q4"], tq4["w_scale"].reshape(1, -1),
                           torch.float32)
    assert_equal(got, want)


def test_wrappers_take_plain_version_only_on_cpu():
    rng = np.random.default_rng(2)
    q = torch.from_numpy(normal(rng, 1, 1, 8, 128))
    tabs = [torch.from_numpy(t) for t in _tables(8, 8, n_identity=0)]
    assert torch.equal(t_fa.flash_attention_rope(q, q, q, *tabs),
                       t_fa.flash_attention_rope_ref(q, q, q, *tabs))
    xq = torch.randint(-127, 128, (3, 64), dtype=torch.int8)
    xs, ws = torch.rand(3, 1), torch.rand(1, 8)
    w = torch.randint(-128, 128, (32, 8), dtype=torch.int8)
    assert torch.equal(t_qm.w4a8_matmul(xq, xs, w, ws),
                       t_qm.w4a8_matmul_ref(xq, xs, w, ws))
    q64 = torch.from_numpy(normal(rng, 1, 2, 9, 64)).requires_grad_()
    assert torch.equal(t_fa.flash_attention(q64, q64, q64),
                       t_fa.flash_attention_ref(q64, q64, q64))
    t_fa.flash_attention(q64, q64, q64).sum().backward()   # CPU: autograd of the plain version
    assert q64.grad is not None
    launches = (t_fa.launches, t_fa.norope_launches, t_qm.launches)
    with pytest.raises(ValueError):
        t_qm.w4a8_matmul(xq.to("meta"), xs.to("meta"), w.to("meta"), ws.to("meta"))
    with pytest.raises(ValueError):
        t_fa.flash_attention_rope(*(t.to("meta") for t in (q, q, q, *tabs)))
    with pytest.raises(ValueError):
        t_fa.flash_attention(*(q64.detach().to("meta"),) * 3)
    assert launches == (t_fa.launches, t_fa.norope_launches, t_qm.launches)
