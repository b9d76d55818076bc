"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA card (the rotation pass, the RoPE attention forward and its
backward, the rope-free
attention forward and its backward at head dim 64 and 128, the W4A8
matmul on both its kernels, and the activation quantization), and the
pipeline slice on the card (the residual quantization against the CPU's
bits, capture and replay, the launches of a "balanced" generate). Marked
``cuda``; without a card they skip. This file imports no
JAX, so it also runs where JAX is absent:

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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv,n_identity", [(130, 257, 0), (171, 171, 0),
                                               (1536, 2048, 512)])
def test_rotation_pass_bit_identical_on_card(card, sq, skv, n_identity, dtype):
    """One launch rotates q and k and rounds v: each output equals
    apply_rotary rounded to bf16 (v: v rounded to bf16) bit for bit."""
    from unigen_tpu_torch.ops.rope import apply_rotary
    g = torch.Generator(device=card).manual_seed(8)
    cos, sin, kcos, ksin = _tables(sq, skv, n_identity, card)
    q, k, v = (torch.randn(2, 3, s, 128, device=card, generator=g).to(dtype)
               for s in (sq, skv, skv))
    before = t_fa.rotate_launches
    got = t_fa.rope_rotate([(q, cos, sin), (k, kcos, ksin), (v, None, None)])
    torch.cuda.synchronize()
    assert t_fa.rotate_launches == before + 1
    want = (apply_rotary(q, cos, sin).bfloat16(), apply_rotary(k, kcos, ksin).bfloat16(),
            v.bfloat16())
    for x, y in zip(got, want):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sq,skv,n_identity", [(130, 257, 0), (171, 171, 0),
                                               (1536, 2048, 512)])
def test_attention_kernel_matches_plain_on_card(card, sq, skv, n_identity, dtype):
    """bf16, and fp32 inputs (rounded to bf16 for the tensor cores, written
    in fp32), within atol=rtol=1e-2 of the plain version in the same dtype;
    one launch of the rotation pass and one of the kernel; the lse is the
    row log-sum-exp of the bf16-rounded rotated logits."""
    from unigen_tpu_torch.ops.rope import apply_rotary
    g = torch.Generator(device=card).manual_seed(0)
    tabs = _tables(sq, skv, n_identity, card)
    q, k, v = (torch.randn(1, 4, s, 128, device=card, generator=g).to(dtype)
               for s in (sq, skv, skv))
    before = (t_fa.launches, t_fa.rotate_launches)
    out, lse = t_fa.flash_attention_rope_fwd(q, k, v, *tabs, with_lse=True)
    torch.cuda.synchronize()
    assert (t_fa.launches, t_fa.rotate_launches) == (before[0] + 1, before[1] + 1)
    ref = t_fa.flash_attention_rope_ref(q, k, v, *tabs)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    qr, kr = (apply_rotary(x, c, s_).bfloat16().float()
              for x, c, s_ in ((q, tabs[0], tabs[1]), (k, tabs[2], tabs[3])))
    logits = (qr @ kr.transpose(-1, -2)) / 128 ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4, rtol=1e-5)


def _w4a8_inputs(card, m, k, n, seed=1):
    g = torch.Generator(device=card).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=card, generator=g)
    w = torch.randint(-128, 128, (k // 2, n), dtype=torch.int8, device=card, generator=g)
    xs = torch.rand(m, 1, device=card, generator=g)
    ws = torch.rand(1, n, device=card, generator=g)
    return xq, xs, w, ws


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [
    (2, 3072, 18432), (37, 1000, 130), (300, 3072, 512),
    # every shape of a b=2 FLUX forward
    (2, 3072, 9216), (1024, 3072, 3072), (2048, 3072, 3072), (3072, 3072, 3072),
    (1024, 3072, 12288), (2048, 3072, 12288), (3072, 3072, 12288),
    (1024, 12288, 3072), (2048, 12288, 3072), (3072, 15360, 3072),
    # tile edges: M around the 64- and 256-row tiles, N = 144 and 3072 + 16,
    # K/2 = 1552 and 576 (not whole 128-row stages)
    (1, 3104, 3088), (2, 1152, 144), (63, 3104, 144), (65, 1152, 3088),
    (129, 3104, 144), (257, 1152, 3088)])
def test_w4a8_kernel_bit_identical_on_card(card, m, k, n):
    """bf16 and fp32 outputs equal the plain version bit for bit; K and N
    multiples of 16 launch the Hopper kernel, others the general kernel,
    each counted on its own counter."""
    xq, xs, w, ws = _w4a8_inputs(card, m, k, n)
    hopper = k % 16 == 0 and n % 16 == 0
    for dtype in (torch.bfloat16, torch.float32):
        before = (t_qm.launches, t_qm.general_launches)
        out = t_qm.w4a8_matmul(xq, xs, w, ws, dtype)
        torch.cuda.synchronize()
        assert (t_qm.launches, t_qm.general_launches) == (before[0] + hopper,
                                                          before[1] + (not hopper))
        assert torch.equal(out, t_qm.w4a8_matmul_ref(xq, xs, w, ws, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 3072, 18432), (65, 3104, 3088), (1024, 3072, 3072)])
def test_w4a8_every_tile_bit_identical_on_card(card, m, k, n):
    """Every tile the Hopper kernel offers (64 or 256 rows, K split 1, 2, 3
    or one range a stage) gives the plain version's bits; the split-K sums
    repeat bit for bit from run to run."""
    xq, xs, w, ws = _w4a8_inputs(card, m, k, n, seed=2)
    ref = t_qm.w4a8_matmul_ref(xq, xs, w, ws)
    stages = -(-(k // 2) // t_qm.STAGE_ROWS)
    for bm in (64, 256):
        for split in sorted({1, 2, 3, stages}):
            out = t_qm._launch(xq, xs, w, ws, torch.bfloat16, bm, split)
            again = t_qm._launch(xq, xs, w, ws, torch.bfloat16, bm, split)
            torch.cuda.synchronize()
            assert torch.equal(out, ref) and torch.equal(again, out), (bm, split)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["xq", "w_q4"])
def test_w4a8_misaligned_operand_raises_on_card(card, monkeypatch, which):
    """An operand off a 16-byte boundary (a view offset by one byte) raises
    ValueError before any launch and never takes the plain version."""
    def refused(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")
    monkeypatch.setattr(t_qm, "w4a8_matmul_ref", refused)
    x = dict(zip(("xq", "xs", "w_q4", "ws"), _w4a8_inputs(card, 64, 3072, 3072)))
    flat = torch.empty(x[which].numel() + 1, dtype=torch.int8, device=card)
    x[which] = flat[1:].view(x[which].shape).copy_(x[which])
    assert x[which].is_contiguous() and x[which].data_ptr() % 16
    before = (t_qm.launches, t_qm.general_launches)
    with pytest.raises(ValueError, match="16-byte"):
        t_qm.w4a8_matmul(x["xq"], x["xs"], x["w_q4"], x["ws"])
    assert (t_qm.launches, t_qm.general_launches) == before


def _edge_rows(k, device):
    """The CPU tests' edge rows (tests/test_torch_port_quant.py): all zero;
    reaching +amax and -amax; .5 ties at scales 1 and 1/8; Gaussian."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.zeros(6, k, device=device)
    x[1] = torch.randn(k, device=device, generator=g).clamp(-5.9, 5.9)
    x[1, 3], x[1, k - 1] = 6.0, -6.0
    x[2, :8] = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -0.5, 126.5, -126.5])
    x[3, :7] = torch.tensor([15.875, 0.0625, 0.1875, -0.3125, 15.8125, -15.875, 8.0625])
    x[4] = -x[1] * 0.75
    x[5] = torch.randn(k, device=device, generator=g) * 3
    return x.bfloat16().float()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,offset", [(64, 0), (3072, 0), (15360, 0), (1001, 0), (3072, 1),
                                      (40000, 0)])
def test_quantize_act_kernel_bit_identical_on_card(card, k, offset, dtype):
    """Codes and scales equal the plain version bit for bit on the edge
    rows: rows of whole 16-byte vectors in registers (K = 64, 3072, 15360),
    and element by element (K = 1001; x off a 16-byte boundary; K past the
    registers' reach); one launch a call; the bits repeat."""
    x = _edge_rows(k, card).to(dtype)
    if offset:
        flat = torch.empty(x.numel() + offset, dtype=dtype, device=card)
        x = flat[offset:].view(x.shape).copy_(x)
    before = t_qm.quantize_launches
    xq, xs = t_qm.quantize_act(x)
    again = t_qm.quantize_act(x)
    torch.cuda.synchronize()
    assert t_qm.quantize_launches == before + 2
    rq, rs = t_qm.quantize_act_ref(x)
    assert xq.dtype == torch.int8 and xs.shape == (6, 1)
    assert torch.equal(xq, rq) and torch.equal(xs, rs)
    assert torch.equal(again[0], xq) and torch.equal(again[1], xs)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,n_identity,dtype", [
    (1, 130, 257, 0, torch.bfloat16), (1, 200, 96, 40, torch.bfloat16),
    (2, 1536, 2048, 512, torch.bfloat16), (1, 2560, 2560, 0, torch.bfloat16),
    (1, 200, 96, 40, torch.float32), (2, 1536, 2048, 512, torch.float32),
    (1, 171, 171, 0, torch.bfloat16), (1, 171, 171, 0, torch.float32),
    (1, 130, 257, 0, torch.float32)])
def test_attention_backward_kernels_match_plain_on_card(card, b, sq, skv, n_identity,
                                                        dtype):
    """dq, dk, dv within 2e-2 of each one's largest |value| and 1e-2 relative
    L2 of the fp32 plain backward: the kernels round the rotated operands,
    P and dS to bf16 for the tensor cores, the plain version does not (fp32
    inputs too: they are rounded to bf16 where they are staged). The
    forward's lse is the row log-sum-exp of its own bf16-rounded logits."""
    g = torch.Generator(device=card).manual_seed(2)
    tabs = _tables(sq, skv, n_identity, card)
    q, k, v, do = (torch.randn(b, 3, s, 128, device=card, generator=g).to(dtype)
                   for s in (sq, skv, skv, sq))
    out, lse = t_fa.flash_attention_rope_fwd(q, k, v, *tabs, with_lse=True)
    before = (t_fa.dq_launches, t_fa.dkv_launches, t_fa.rotate_launches)
    got = t_fa.flash_attention_rope_bwd(q, k, v, out, lse, do, *tabs)
    torch.cuda.synchronize()
    assert (t_fa.dq_launches, t_fa.dkv_launches, t_fa.rotate_launches) == tuple(
        n + 1 for n in before)
    want = t_fa.flash_attention_rope_bwd_ref(q, k, v, out, do, *tabs)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        assert (x.float() - y.float()).abs().max().item() <= 2e-2 * y.float().abs().max().item()
        assert _rel_l2(x, y) <= 1e-2
    from unigen_tpu_torch.ops.rope import apply_rotary
    qr, kr = (apply_rotary(x, c, s_).bfloat16().float()
              for x, c, s_ in ((q, tabs[0], tabs[1]), (k, tabs[2], tabs[3])))
    logits = (qr @ kr.transpose(-1, -2)) / 128 ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_backward_deterministic_on_card(card, dtype):
    """Two backward runs on the same inputs give the same bits: the dQ and
    dK/dV kernels own their outputs and use no atomics."""
    g = torch.Generator(device=card).manual_seed(9)
    tabs = _tables(1536, 2048, 512, card)
    q, k, v, do = (torch.randn(1, 6, s, 128, device=card, generator=g).to(dtype)
                   for s in (1536, 2048, 2048, 1536))
    out, lse = t_fa.flash_attention_rope_fwd(q, k, v, *tabs, with_lse=True)
    first = t_fa.flash_attention_rope_bwd(q, k, v, out, lse, do, *tabs)
    second = t_fa.flash_attention_rope_bwd(q, k, v, out, lse, do, *tabs)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_attention_autograd_runs_kernels_on_card(card):
    """torch.autograd through flash_attention_rope launches the forward and
    both backward kernels once each, and the rotation pass once per
    direction, and agrees with autograd of the plain forward."""
    g = torch.Generator(device=card).manual_seed(3)
    tabs = _tables(96, 160, 32, card)
    leaves = [torch.randn(1, 2, s, 128, device=card, generator=g).bfloat16()
              .requires_grad_() for s in (96, 160, 160)]
    before = (t_fa.launches, t_fa.dq_launches, t_fa.dkv_launches, t_fa.rotate_launches)
    out = t_fa.flash_attention_rope(*leaves, *tabs)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    assert (t_fa.launches, t_fa.dq_launches, t_fa.dkv_launches,
            t_fa.rotate_launches) == tuple(n + 1 for n in before[:3]) + (before[3] + 2,)
    ref = t_fa.flash_attention_rope_ref(*leaves, *tabs)
    want = torch.autograd.grad(ref.float().square().sum(), leaves)
    for x, y in zip(grads, want):
        assert _rel_l2(x, y) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 3, 200, 333, 64), (2, 2, 1357, 1357, 64), (1, 4, 683, 683, 64),
    (1, 3, 200, 333, 128), (1, 2, 130, 257, 128), (1, 1, 1, 1, 64),
    (1, 2, 40, 129, 64), (1, 2, 63, 257, 64), (1, 2, 40, 129, 128),
    (1, 2, 63, 257, 128)])
def test_rope_free_kernel_matches_plain_on_card(card, b, h, sq, skv, d, dtype):
    """Ragged lengths (the KV tail masked, Q rows past Sq never stored) at
    both head dims, within atol=rtol=1e-2 of the plain version in the same
    dtype: the kernel rounds P to bf16 before normalising, the plain
    version after."""
    from unigen_tpu_torch.ops.attention import sdpa
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn(b, h, s, d, device=card, generator=g).to(dtype)
               for s in (sq, skv, skv))
    before = t_fa.norope_launches
    out = sdpa(q, k, v)
    torch.cuda.synchronize()
    assert t_fa.norope_launches == before + 1
    ref = t_fa.flash_attention_ref(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_long_kv_kernels_match_plain_on_card(card):
    """Both attention kernels past the TPU's 2560-key streaming gate: the
    rope-free one at SD3's ragged 1024^2 length, the RoPE one at FLUX's
    weave_text length with 512 identity K rows."""
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(1, 2, s, 64, device=card, generator=g).bfloat16()
               for s in (4429, 8525, 8525))
    out = t_fa.flash_attention(q, k, v)
    torch.testing.assert_close(out.float(), t_fa.flash_attention_ref(q, k, v).float(),
                               atol=1e-2, rtol=1e-2)
    tabs = _tables(4608, 8704, 512, card)
    q, k, v = (torch.randn(1, 2, s, 128, device=card, generator=g).bfloat16()
               for s in (4608, 8704, 8704))
    out = t_fa.flash_attention_rope(q, k, v, *tabs)
    torch.testing.assert_close(out.float(),
                               t_fa.flash_attention_rope_ref(q, k, v, *tabs).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,sq,skv,d,dtype", [
    (1, 3, 171, 171, 128, torch.bfloat16), (1, 3, 171, 171, 64, torch.float32),
    (1, 3, 200, 300, 64, torch.bfloat16), (1, 3, 200, 300, 128, torch.bfloat16),
    (1, 3, 200, 300, 128, torch.float32), (1, 2, 1, 1, 64, torch.bfloat16),
    (1, 2, 1, 1, 128, torch.float32), (2, 4, 1536, 1536, 128, torch.bfloat16),
    (1, 4, 1357, 1357, 64, torch.bfloat16), (1, 2, 40, 129, 64, torch.bfloat16),
    (1, 2, 63, 257, 64, torch.float32), (1, 2, 40, 257, 128, torch.bfloat16),
    (1, 2, 63, 129, 128, torch.float32)])
def test_rope_free_backward_kernels_match_plain_on_card(card, b, h, sq, skv, d, dtype):
    """Rows 5p/6p: dq, dk, dv within 2e-2 of each one's largest |value| and
    1e-2 relative L2 of the fp32 plain backward at ragged lengths (a FLUX
    block expert's 171, 200/300, 1x1), FLUX's 1536 and SD3's 1357, both
    head dims, bf16 and fp32 inputs; each kernel launches once; the
    forward's lse is the row log-sum-exp of its own bf16-rounded logits.
    With one key P = 1 and dS = 0, so dq and dk are rounding noise on both
    sides (the kernel rounds fp32 dO to bf16 for dP, the D pass does not):
    they must be within 1e-2 of dv's largest |value| instead."""
    g = torch.Generator(device=card).manual_seed(6)
    q, k, v, do = (torch.randn(b, h, s, d, device=card, generator=g).to(dtype)
                   for s in (sq, skv, skv, sq))
    out, lse = t_fa.flash_attention_fwd(q, k, v, with_lse=True)
    before = (t_fa.norope_dq_launches, t_fa.norope_dkv_launches)
    got = t_fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert (t_fa.norope_dq_launches, t_fa.norope_dkv_launches) == (before[0] + 1,
                                                                   before[1] + 1)
    want = t_fa.flash_attention_bwd_ref(q, k, v, out, do)
    for i, (x, y) in enumerate(zip(got, want)):
        assert x.dtype == dtype and x.shape == y.shape
        if skv == 1 and i < 2:
            assert x.float().abs().max().item() <= 1e-2 * want[2].float().abs().max().item()
            continue
        assert (x.float() - y.float()).abs().max().item() <= 2e-2 * y.float().abs().max().item()
        assert _rel_l2(x, y) <= 1e-2
    logits = (q.bfloat16().float() @ k.bfloat16().float().transpose(-1, -2)) / d ** 0.5
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_rope_free_autograd_runs_kernels_on_card(card):
    """torch.autograd through the rope-free sdpa launches the forward and
    both backward kernels once each (no plain math on the card), and agrees
    with autograd of the plain forward; without a gradient to record it is
    the forward alone."""
    from unigen_tpu_torch.ops.attention import sdpa
    g = torch.Generator(device=card).manual_seed(7)
    leaves = [torch.randn(1, 2, s, 64, device=card, generator=g).bfloat16()
              .requires_grad_() for s in (96, 171, 171)]
    before = (t_fa.norope_launches, t_fa.norope_dq_launches, t_fa.norope_dkv_launches)
    out = sdpa(*leaves)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    assert (t_fa.norope_launches, t_fa.norope_dq_launches,
            t_fa.norope_dkv_launches) == tuple(n + 1 for n in before)
    ref = t_fa.flash_attention_ref(*leaves)
    want = torch.autograd.grad(ref.float().square().sum(), leaves)
    for x, y in zip(grads, want):
        assert _rel_l2(x, y) <= 2e-2
    with torch.no_grad():
        assert sdpa(*leaves).shape == leaves[0].shape
    assert t_fa.norope_launches == before[0] + 2
    assert t_fa.norope_dq_launches == before[1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_rope_free_backward_deterministic_on_card(card, d, dtype):
    """Two rope-free backward runs on the same inputs give the same bits:
    the dQ and dK/dV kernels own their outputs and use no atomics."""
    g = torch.Generator(device=card).manual_seed(10)
    q, k, v, do = (torch.randn(1, 4, s, d, device=card, generator=g).to(dtype)
                   for s in (1357, 1500, 1500, 1357))
    out, lse = t_fa.flash_attention_fwd(q, k, v, with_lse=True)
    first = t_fa.flash_attention_bwd(q, k, v, out, lse, do)
    second = t_fa.flash_attention_bwd(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_fp32_rope_free_calls_count_one_rounding_pass_on_card(card, d):
    """fp32 inputs: the rope-free forward rounds k and v, the backward q, k,
    v and dO, each in one launch of the rounding pass (rotate_launches);
    bf16 inputs launch none."""
    g = torch.Generator(device=card).manual_seed(11)
    for dtype, passes in ((torch.float32, 1), (torch.bfloat16, 0)):
        q, k, v, do = (torch.randn(1, 2, s, d, device=card, generator=g).to(dtype)
                       for s in (96, 171, 171, 96))
        before = t_fa.rotate_launches
        out, lse = t_fa.flash_attention_fwd(q, k, v, with_lse=True)
        assert t_fa.rotate_launches == before + passes
        t_fa.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        assert t_fa.rotate_launches == before + 2 * passes


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["q", "k", "v", "do"])
def test_misaligned_operand_raises_on_card(card, monkeypatch, which):
    """A bf16 operand that does not start on a 16-byte boundary (a view
    offset by one element) cannot be read by TMA: the rope-free forward and
    backward and the RoPE forward raise ValueError before any launch, and
    never take a plain version instead."""
    def refused(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")
    for name in ("flash_attention_ref", "flash_attention_bwd_ref",
                 "flash_attention_rope_ref", "flash_attention_rope_bwd_ref"):
        monkeypatch.setattr(t_fa, name, refused)
    g = torch.Generator(device=card).manual_seed(12)
    x = dict(zip("q k v do".split(), (
        torch.randn(1, 2, 64, 128, device=card, generator=g).bfloat16() for _ in range(4))))
    flat = torch.empty(x[which].numel() + 1, dtype=torch.bfloat16, device=card)
    x[which] = flat[1:].view(x[which].shape).copy_(x[which])
    assert x[which].is_contiguous() and x[which].data_ptr() % 16
    before = (t_fa.norope_launches, t_fa.norope_dq_launches, t_fa.launches,
              t_fa.rotate_launches)
    if which != "do":
        with pytest.raises(ValueError, match="16-byte"):
            t_fa.flash_attention_fwd(x["q"], x["k"], x["v"])
        tabs = _tables(64, 64, 0, card)
        with pytest.raises(ValueError, match="16-byte"):
            t_fa.flash_attention_rope_fwd(x["q"], x["k"], x["v"], *tabs)
    out = torch.zeros_like(x["do"])
    lse = torch.zeros(1, 2, 64, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        t_fa.flash_attention_bwd(x["q"], x["k"], x["v"], out, lse, x["do"])
    assert (t_fa.norope_launches, t_fa.norope_dq_launches, t_fa.launches,
            t_fa.rotate_launches) == before


# ---------------------------------------------------------------- the pipeline

def _residual_rows(device):
    """Gaussian rows, a zero row, rows at +-amax, .5 ties at the int8 and
    int4 scales 1 (amax 127 and 7)."""
    g = torch.Generator(device=device).manual_seed(3)
    x = torch.randn(8, 3072, device=device, generator=g)
    x[1] = 0.0
    x[2, 5], x[2, 900] = 40.0, -40.0
    for row, top in ((3, 127.0), (4, 7.0)):
        x[row] = torch.randint(-6, 6, (3072,), device=device, generator=g) + 0.5
        x[row, 0] = top
    return x.reshape(2, 4, 3072)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_residual_on_card_equals_cpu(card, bits, dtype):
    """Codes and scales of the residual cache on the card equal the CPU's
    bit for bit: the scale divides by a device tensor, not by a Python
    number (which the card would multiply by its reciprocal)."""
    from unigen_tpu_torch.ops.quant import dequantize_residual, quantize_residual
    r = _residual_rows(card).to(dtype)
    got, want = quantize_residual(r, bits), quantize_residual(r.cpu(), bits)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key
    assert torch.equal(dequantize_residual(got, dtype).cpu(),
                       dequantize_residual(want, dtype))


def _few_block_flux(card):
    """flux_full's widths (3072, 24 heads x 128, W4A8) at 2 double and 4
    single base blocks (1 + 2 control blocks), random serving weights."""
    import dataclasses

    from unigen_tpu_torch import presets
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    cfg = presets.flux_full()
    cfg = dataclasses.replace(cfg, flux=dataclasses.replace(
        cfg.flux, num_layers=2, num_single_layers=4))
    params = init_quantized_serving_params(
        cfg, device=card, generator=torch.Generator(device=card).manual_seed(0))
    return cfg, params


@pytest.mark.cuda
def test_capture_then_replay_same_bits_on_card(card):
    """A capturing forward and one replaying its bf16 residuals give the
    same bits; the replay launches the base blocks' kernels only."""
    import chip_smoke
    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    cfg, params = _few_block_flux(card)
    bb = cfg.flux
    g = torch.Generator(device=card).manual_seed(1)

    def mk(*shape):
        return torch.randn(*shape, device=card, generator=g).bfloat16()
    ids = prepare_latent_image_ids(16, 16, device=card)
    args = (mk(2, 256, bb.in_channels), mk(2, 256, bb.in_channels),
            mk(2, 64, bb.joint_attention_dim), mk(2, bb.pooled_projection_dim),
            mk(2, bb.pooled_projection_dim), torch.full((2,), 0.75, device=card).bfloat16(),
            ids, torch.zeros(64, 3, device=card), ids)
    with torch.no_grad():
        pred, _, outs = unigen_flux_forward(params, cfg, *args, return_control_residuals=True)
        chip_smoke.reset_launch_counts()
        again, _, _ = unigen_flux_forward(params, cfg, *args,
                                          control_residuals=outs["control_residuals"])
        torch.cuda.synchronize()
    assert torch.equal(again, pred)
    assert chip_smoke.nonzero(chip_smoke.launch_counts()) == chip_smoke.nonzero(
        chip_smoke.expected_replay_launches(params, cfg))


@pytest.mark.cuda
def test_generate_balanced_launches_the_formula_on_card(card):
    """A b=2 "balanced" generate (a full forward at step 0, a base forward
    replaying int8 residuals at step 2, holds at 1 and 3) launches what
    chip_smoke.expected_pipeline_launches counts, and gives uint8 images."""
    import chip_smoke
    from unigen_tpu_torch.models.vae import VAEConfig, init_vae_params
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
    cfg, params = _few_block_flux(card)
    bb = cfg.flux
    vae_cfg = VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8)
    g = torch.Generator(device=card).manual_seed(2)
    pipe = UniGenFluxPipeline(cfg=cfg, params=params, vae_cfg=vae_cfg,
                              vae_params=init_vae_params(vae_cfg, gen=g, device=card),
                              device=card)
    x = dict(prompt_embeds=torch.randn(2, 64, bb.joint_attention_dim, device=card, generator=g),
             pooled=torch.randn(2, bb.pooled_projection_dim, device=card, generator=g),
             cond_pooled=torch.randn(2, bb.pooled_projection_dim, device=card, generator=g),
             control_pixels=torch.rand(2, 3, 64, 64, device=card, generator=g) * 2 - 1)
    chip_smoke.reset_launch_counts()
    img = pipe.generate(**x, height=64, width=64, num_inference_steps=4,
                        quality_profile="balanced")
    assert pipe.last_cache_refreshes == (1, 1)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (2, 64, 64, 3)
    assert chip_smoke.nonzero(chip_smoke.launch_counts()) == \
        chip_smoke.expected_pipeline_launches(params, cfg, [(2, 1, 1)])
