"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card. Marked ``cuda``; without a card they skip. This file imports
no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from unigen_tpu_torch.ops.cuda import flash_attention as t_fa
from unigen_tpu_torch.ops.cuda import quant_matmul as t_qm
from unigen_tpu_torch.ops.rope import rope_multi_axis


def _tables(sq, skv, n_identity, device):
    """Q tables over sq rows; K tables over skv rows whose last n_identity
    rows are identity (cos=1, sin=0), the KV-append convention."""
    r = torch.arange(max(sq, skv), device=device)
    ids = torch.stack([torch.zeros_like(r), r // 8, r % 8], -1).float()
    cos, sin = rope_multi_axis(ids, (16, 56, 56))
    kcos, ksin = cos[:skv].clone(), sin[:skv].clone()
    kcos[skv - n_identity:], ksin[skv - n_identity:] = 1.0, 0.0
    return cos[:sq].contiguous(), sin[:sq].contiguous(), kcos, ksin


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run through the GPU host")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,n_identity", [(130, 257, 0), (1536, 2048, 512)])
def test_attention_kernel_matches_plain_on_card(card, sq, skv, n_identity):
    g = torch.Generator(device=card).manual_seed(0)
    tabs = _tables(sq, skv, n_identity, card)
    q, k, v = (torch.randn(1, 4, s, 128, device=card, generator=g).bfloat16()
               for s in (sq, skv, skv))
    before = t_fa.launches
    out = t_fa.flash_attention_rope(q, k, v, *tabs)
    torch.cuda.synchronize()
    assert t_fa.launches == before + 1
    ref = t_fa.flash_attention_rope_ref(q, k, v, *tabs)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 3072, 18432), (37, 1000, 130), (300, 3072, 512)])
def test_w4a8_kernel_bit_identical_on_card(card, m, k, n):
    g = torch.Generator(device=card).manual_seed(1)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=card, generator=g)
    w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=card, generator=g)
    xs = torch.rand(m, 1, device=card, generator=g)
    ws = torch.rand(1, n, device=card, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        out = t_qm.w4a8_matmul(xq, xs, w, ws, dtype)
        torch.cuda.synchronize()
        assert torch.equal(out, t_qm.w4a8_matmul_ref(xq, xs, w, ws, dtype))
