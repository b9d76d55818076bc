"""Quantized paths: W8A8 and W4A8, with a straight-through backward.

Port of ``unigen_tpu/ops/quant.py``. Weights carry per-(block, out-channel)
symmetric scales; activations are quantized per token at run time to int8;
products accumulate in int32 and an fp32 epilogue rescales. ``layers/core.
linear`` dispatches on the leaves: ``w_q``/``w_scale`` (int8) or
``w_q4``/``w_scale`` (int4 codes in [-7, 7], two per int8 byte, HALF-PAIRED
along the in-dim: packed row j holds source row j in its low nibble and row
j + in/2 in its high nibble).

Every W4A8 linear runs the hand-written CUDA kernel on the card
(``ops/cuda/quant_matmul.py``), and every quantized linear quantizes its
activations with the kernel beside it there. The W8A8 product is a library
int8 GEMM (``torch._int_mm``), as it is an XLA dot and not a Pallas kernel
in JAX.

Both products are ``torch.autograd.Function``s with the JAX package's
straight-through VJP (``unigen_tpu/ops/quant.py:197-280``): dx = g W_deq^T,
the activation quantization is ignored, and the integer weight and its scale
get no gradient. ``quant_bwd`` picks how dx is computed ("bf16", the
default; "int8"; "f32"), the JAX package's ``UNIGEN_QUANT_BWD`` made an
argument of ``quant_backward(policy)``, which scopes a forward and its
backward. These backward products are plain matmuls (XLA
dots in JAX, not Pallas kernels), so ``torch.matmul`` and ``torch._int_mm``
compute them.

``quantize_residual`` / ``dequantize_residual`` / ``residual_buffer`` keep
the serving caches' control residuals as int8 or packed int4 codes with
per-token scales (XLA-fused ops in JAX; plain PyTorch here).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Sequence

import torch

from unigen_tpu_torch.ops.cuda import quant_matmul
from unigen_tpu_torch.utils import param_bytes


def _scale(amax: torch.Tensor, qmax: float, reciprocal: bool) -> torch.Tensor:
    """amax / qmax where amax > 0, else 1. ``reciprocal=False`` divides (IEEE,
    by a tensor on amax's device: a CUDA tensor divided by a Python number
    is multiplied by its reciprocal), as the JAX functions run eagerly;
    ``reciprocal=True`` multiplies by the fp32 reciprocal of qmax, as XLA
    compiles the division under ``jax.jit`` (the JAX loader's streaming
    quantization). The two differ in the last bit of some scales."""
    q = amax.new_tensor(qmax)
    s = amax * (1.0 / q) if reciprocal else amax / q
    return torch.where(amax > 0, s, torch.ones_like(amax))


def quantize_weight(w: torch.Tensor, *, reciprocal: bool = False) -> dict:
    """[..., in, out] -> int8 codes with per-(block, out-channel) scales
    (``_scale`` for ``reciprocal``)."""
    wf = w.to(torch.float32)
    scale = _scale(wf.abs().amax(dim=-2, keepdim=True), 127.0, reciprocal)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"w_q": q, "w_scale": scale}


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-7, 7], [..., in, out] -> packed int8 [..., in/2, out]
    (half-paired along the in-dim)."""
    assert q.shape[-2] % 2 == 0, f"in-dim must be even to nibble-pack: {q.shape}"
    half = q.shape[-2] // 2
    lo = q[..., :half, :] & 0x0F
    hi = q[..., half:, :] << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """packed int8 [..., in/2, out] -> int8 [..., in, out], sign-extended."""
    lo = (p << 4) >> 4         # arithmetic shift on int8 sign-extends
    hi = p >> 4
    return torch.cat([lo, hi], dim=-2)


def quantize_weight_int4(w: torch.Tensor, *, reciprocal: bool = False) -> dict:
    """[..., in, out] -> nibble-packed int4 with per-(block, out-chan) scales.
    Symmetric [-7, 7]; the -8 code is unused."""
    wf = w.to(torch.float32)
    scale = _scale(wf.abs().amax(dim=-2, keepdim=True), 7.0, reciprocal)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8)
    return {"w_q4": pack_int4(q), "w_scale": scale}


def _quantize_act(x: torch.Tensor):
    """Dynamic per-token symmetric activation quantization to int8: x
    [..., K] -> (xq int8 [..., K], xs f32 [..., 1]). CUDA tensors run the
    quantization kernel, CPU tensors its plain version
    (``quant_matmul.quantize_act_ref``)."""
    k = x.shape[-1]
    xq, xs = quant_matmul.quantize_act(x.reshape(-1, k).contiguous())
    return xq.reshape(x.shape), xs.reshape(*x.shape[:-1], 1)


def quantize_residual(r: torch.Tensor, bits: int = 8) -> dict:
    """Per-token symmetric quantization of a cached control residual
    (``unigen_tpu/ops/quant.py:84``). bits=8: ``{"q": int8 [..., D], "s":
    f32 [..., 1]}``; bits=4: ``{"q4": int8 [..., D/2], "s"}``, codes in
    [-7, 7] nibble-packed along the FEATURE axis, feature j in the low
    nibble of byte j and feature j + D/2 in its high nibble. The scale's
    divisor is a tensor on r's device: a CUDA tensor divided by a Python
    number is multiplied by its reciprocal, one bit off the IEEE division."""
    rf = r.to(torch.float32)
    amax = rf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    if bits == 4:
        if r.shape[-1] % 2:
            raise ValueError(f"feature dim must be even to nibble-pack: {tuple(r.shape)}")
        s = amax / amax.new_tensor(7.0)
        q = torch.round(rf / s).to(torch.int8)
        half = q.shape[-1] // 2
        return {"q4": (q[..., :half] & 0x0F) | (q[..., half:] << 4), "s": s}
    if bits != 8:
        raise ValueError(f"residual bits must be 4 or 8, got {bits}")
    s = amax / amax.new_tensor(127.0)
    return {"q": torch.round(rf / s).to(torch.int8), "s": s}


def dequantize_residual(d: dict, dtype) -> torch.Tensor:
    """Inverse of ``quantize_residual``: fp32 codes times scales, cast to
    ``dtype``; the leaf key ("q" or "q4") says which."""
    if "q4" in d:
        p = d["q4"]
        q = torch.cat([(p << 4) >> 4, p >> 4], dim=-1)   # sign-extending shifts
        return (q.to(torch.float32) * d["s"]).to(dtype)
    return (d["q"].to(torch.float32) * d["s"]).to(dtype)


def residual_buffer(shape, bits: int, dtype, device=None):
    """A zeroed residual-cache buffer of one capture site: a ``dtype`` tensor
    (bits=16), int8 codes + f32 per-token scales (8), or packed int4 codes +
    scales (4); the scale keeps the token layout with a trailing 1."""
    shape = tuple(shape)
    if bits == 16:
        return torch.zeros(shape, dtype=dtype, device=device)
    scales = torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device)
    if bits == 8:
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device), "s": scales}
    if bits != 4 or shape[-1] % 2:
        raise ValueError(f"residual buffer: bits {bits}, shape {shape}")
    return {"q4": torch.zeros(shape[:-1] + (shape[-1] // 2,), dtype=torch.int8,
                              device=device), "s": scales}


def stack_residuals(ys):
    """Per-block residuals (tensors, or quantized dicts) stacked on a
    leading block axis."""
    if isinstance(ys[0], dict):
        return {k: torch.stack([y[k] for y in ys]) for k in ys[0]}
    return torch.stack(ys)


def residual_at(res, i: int):
    """Block ``i`` of a stacked residual cache, as views."""
    return {k: v[i] for k, v in res.items()} if isinstance(res, dict) else res[i]


def _check_2d(w: torch.Tensor, name: str):
    if w.dim() != 2:
        raise ValueError(
            f"{name} needs a 2-D weight [in, out], got {tuple(w.shape)}; "
            "index one block of a stacked tree before the matmul")


def _int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> exact int32 [M, N]. cuBLASLt refuses
    M <= 16 on the card, so short inputs are padded with zero rows."""
    m = xq.shape[0]
    if xq.is_cuda and m <= 16:
        xq = torch.cat([xq, xq.new_zeros(32 - m, xq.shape[1])])
    return torch._int_mm(xq, w_q)[:m]


QUANT_BWD_POLICIES = ("bf16", "int8", "f32")
_policy = ["bf16"]      # the policy in scope; set only by quant_backward()


@contextlib.contextmanager
def quant_backward(policy: str):
    """Scope the straight-through backward policy of every quantized matmul
    recorded (or recomputed under remat) inside the block. A plain module
    value, not a context variable: the recomputation of a checkpointed block
    runs on autograd's device thread."""
    if policy not in QUANT_BWD_POLICIES:
        raise ValueError(f"quant_bwd={policy!r}: expected one of {QUANT_BWD_POLICIES}")
    saved = _policy[0]
    _policy[0] = policy
    try:
        yield
    finally:
        _policy[0] = saved


def _int8_fwd(x, w_q, w_scale, out_dtype):
    xq, xs = _quantize_act(x)
    lead = x.shape[:-1]
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), w_q).reshape(*lead, -1)
    return (acc.to(torch.float32) * xs * w_scale.reshape(-1)).to(out_dtype)


def _int4_fwd(x, w_q4, w_scale, out_dtype):
    xq, xs = _quantize_act(x)
    lead = x.shape[:-1]
    out = quant_matmul.w4a8_matmul(
        xq.reshape(-1, x.shape[-1]), xs.reshape(-1, 1), w_q4,
        w_scale.reshape(1, -1), out_dtype)
    return out.reshape(*lead, -1)


def bwd_dx(g: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
           x_dtype, policy: str) -> torch.Tensor:
    """dx = g @ (w_q * w_scale)^T for int8 codes w_q [in, out], contracting
    over the out axis (``_bwd_dx``, unigen_tpu/ops/quant.py:197-222):
      "int8": quantize (g * w_scale) per token and run the int8 product with
              the transposed codes (a per-call [out, in] int8 transient);
      "bf16": bf16 g times the bf16-rounded dequantized weight, fp32 sums;
      "f32":  fp32 g times the fp32 dequantized weight."""
    if policy == "int8":
        h = g.to(torch.float32) * w_scale.reshape(-1)
        hq, hs = _quantize_act(h)
        acc = _int_mm(hq.reshape(-1, h.shape[-1]), w_q.t().contiguous())
        return (acc.reshape(*h.shape[:-1], -1).to(torch.float32) * hs).to(x_dtype)
    w_deq = w_q.to(torch.float32) * w_scale.reshape(1, -1)       # [in, out]
    if policy == "bf16":
        gb, wb = g.to(torch.bfloat16), w_deq.to(torch.bfloat16)
        if x_dtype == torch.bfloat16:       # fp32 sums, one rounding at the end
            return gb @ wb.t()
        return (gb.to(torch.float32) @ wb.to(torch.float32).t()).to(x_dtype)
    if policy == "f32":
        return (g.to(torch.float32) @ w_deq.t()).to(x_dtype)
    raise ValueError(f"quant_bwd={policy!r}: expected one of {QUANT_BWD_POLICIES}")


class _StraightThrough(torch.autograd.Function):
    """Quantized forward, straight-through backward; only x gets a gradient."""

    @staticmethod
    def forward(ctx, x, w, w_scale, out_dtype, packed, policy):
        ctx.save_for_backward(w, w_scale)
        ctx.x_dtype, ctx.packed, ctx.policy = x.dtype, packed, policy
        return (_int4_fwd if packed else _int8_fwd)(x, w, w_scale, out_dtype)

    @staticmethod
    def backward(ctx, g):
        w, w_scale = ctx.saved_tensors
        w_q = unpack_int4(w) if ctx.packed else w
        dx = bwd_dx(g, w_q, w_scale, ctx.x_dtype, ctx.policy)
        return dx, None, None, None, None, None


def _quantized(x, w, w_scale, out_dtype, packed):
    out_dtype = out_dtype or x.dtype
    if torch.is_grad_enabled() and x.requires_grad:
        return _StraightThrough.apply(x, w, w_scale, out_dtype, packed, _policy[0])
    return (_int4_fwd if packed else _int8_fwd)(x, w, w_scale, out_dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """W8A8: x [..., N, in] fp; w_q [in, out] int8; w_scale [1, out].
    Differentiable in x (straight-through, the policy of ``quant_backward``
    in scope, "bf16" by default)."""
    _check_2d(w_q, "int8_matmul")
    return _quantized(x, w_q, w_scale, out_dtype, False)


def int4_matmul(x: torch.Tensor, w_q4: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """W4A8: x [..., N, in] fp; w_q4 [in/2, out] packed; w_scale [1, out].
    The product is the W4A8 kernel (its plain version on CPU tensors);
    differentiable in x as ``int8_matmul``."""
    _check_2d(w_q4, "int4_matmul")
    return _quantized(x, w_q4, w_scale, out_dtype, True)


def _eligible(path_names, node, *, min_dim: int, skip: Sequence[str]) -> bool:
    if "w" not in node or node["w"].dim() < 2:
        return False
    joined = ".".join(path_names)
    if any(s in joined for s in skip):
        return False
    in_dim, out_dim = node["w"].shape[-2:]
    return min(in_dim, out_dim) >= min_dim


def _quantize_walk(params: Any, *, min_dim: int, skip: Sequence[str], bits: int,
                   reciprocal: bool, donate: bool) -> Any:
    """The walk of ``quantize_tree`` and ``quantize_tree_streaming``. Without
    ``donate`` every eligible {'w','b'} linear is quantized in one call into
    a new tree. With ``donate`` a stacked weight is quantized one [in, out]
    block at a time (its scales are per block, so the bits are the same and
    the transient is one block's) and each linear's dict is replaced in
    place, freeing its floating-point weight at once."""
    assert bits in (4, 8), bits
    qfn = functools.partial(quantize_weight if bits == 8 else quantize_weight_int4,
                            reciprocal=reciprocal)

    def per_block(w):
        if w.dim() <= 2:
            return qfn(w)
        out = None
        for i in range(w.shape[0]):
            q = per_block(w[i])
            if out is None:
                out = {k: v.new_empty((w.shape[0],) + tuple(v.shape)) for k, v in q.items()}
            for k, v in q.items():
                out[k][i].copy_(v)
        return out

    def walk(node, path):
        if isinstance(node, dict):
            if "w" in node and isinstance(node["w"], torch.Tensor):
                if not _eligible(path, node, min_dim=min_dim, skip=skip) or (
                        bits == 4 and node["w"].shape[-2] % 2 != 0):
                    return node            # small, router / experts, or odd in-dim
                if not donate:
                    q = qfn(node["w"])
                    if "b" in node:
                        q["b"] = node["b"]
                    return q
                q = per_block(node["w"])
                if "b" in node:
                    q["b"] = node["b"]
                node.clear()
                node.update(q)
                return node
            out = {k: walk(v, path + (k,)) for k, v in node.items()}
            if not donate:
                return out
            node.update(out)
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path) for v in node)
        return node
    return walk(params, ())


def quantize_tree(params: Any, *, min_dim: int = 512,
                  skip: Sequence[str] = ("gate", "experts"),
                  bits: int = 8) -> Any:
    """Convert every eligible {'w','b'} linear to int8 (or packed int4,
    ``bits=4``) in a new tree. Small layers (below min_dim), the router gate
    and the MoE expert stacks stay floating point. Works on meta tensors
    too."""
    return _quantize_walk(params, min_dim=min_dim, skip=skip, bits=bits,
                          reciprocal=False, donate=False)


def quantize_unigen_serving(params: dict, *, base_bits: int = 4,
                            adapter_block_bits: int = 4) -> dict:
    """The single-card serving policy: frozen base -> W4; control double/
    single block stacks -> W4; the other control pieces (shared-expert
    weave, zero-init add linears, embedders) -> W8. Expert stacks and the
    router stay floating point."""
    out = dict(params)
    out["base"] = quantize_tree(params["base"], bits=base_bits)
    out["control"] = {
        k: quantize_tree(v, bits=(adapter_block_bits
                                  if k in ("double_blocks", "single_blocks")
                                  else 8))
        for k, v in params["control"].items()}
    return out


#: min(in, out) below which a text-tower linear stays floating point.
TEXT_QUANT_MIN_DIM = 512


def quantize_tree_streaming(params: Any, *, min_dim: int = 512,
                            skip: Sequence[str] = ("gate", "experts"),
                            bits: int = 8, donate: bool = True) -> Any:
    """``quantize_tree``'s leaves with the scales rounded as the JAX
    package's jitted streaming walk rounds them (``_scale`` with
    ``reciprocal``), at bounded device memory. With ``donate`` (the default)
    the tree is CONSUMED, each linear replaced in place, so the peak is the
    source tree plus one block's transient; without it the result is a new
    tree, each linear quantized in one call."""
    return _quantize_walk(params, min_dim=min_dim, skip=skip, bits=bits, reciprocal=True,
                          donate=donate)


def quantize_text_tower(params: Any, *, bits: int = 8, min_dim: int = None,
                        donate: bool = True) -> Any:
    """The serving quantization of a prompt-encoder tower (T5, CLIP):
    every linear at least ``TEXT_QUANT_MIN_DIM`` wide to int8 (or packed
    int4), with no skip list (a text tower has no router); embeddings,
    norms and the relative bias stay floating point."""
    md = TEXT_QUANT_MIN_DIM if min_dim is None else min_dim
    return quantize_tree_streaming(params, bits=bits, skip=(), min_dim=md,
                                   donate=donate)


def quantize_unigen_serving_streaming(params: dict, *, base_bits: int = 4,
                                      adapter_block_bits: int = 4,
                                      donate: bool = True) -> dict:
    """``quantize_unigen_serving`` through the streaming walk (consumes
    ``params`` with ``donate``)."""
    out = dict(params)
    out["base"] = quantize_tree_streaming(params["base"], bits=base_bits, donate=donate)
    out["control"] = {
        k: quantize_tree_streaming(v, bits=(adapter_block_bits
                                            if k in ("double_blocks", "single_blocks")
                                            else 8), donate=donate)
        for k, v in params["control"].items()}
    return out


def quantized_bytes(params: Any) -> int:
    """Bytes of every leaf of a (quantized) tree."""
    return param_bytes(params)


_FROZEN_KEYS = ("w_q", "w_q4", "w_scale")


def split_trainable(tree: Any):
    """Split a (partially) quantized tree into (trainable, frozen) trees of
    the same structure with complementary None leaves: frozen = the quantized
    weight leaves (w_q/w_q4/w_scale), trainable = every float leaf (MoE
    experts and gate, norms, linear biases). Port of
    ``unigen_tpu/ops/quant.split_trainable``."""
    def walk(node):
        if isinstance(node, dict):
            t, f = {}, {}
            for k, v in node.items():
                if k in _FROZEN_KEYS:
                    t[k], f[k] = None, v
                else:
                    t[k], f[k] = walk(v)
            return t, f
        if isinstance(node, (list, tuple)):
            pairs = [walk(v) for v in node]
            return (type(node)(p[0] for p in pairs),
                    type(node)(p[1] for p in pairs))
        return node, None
    return walk(tree)


def merge_split(trainable: Any, frozen: Any):
    """Inverse of ``split_trainable`` (complementary-None merge)."""
    if trainable is None:
        return frozen
    if frozen is None:
        return trainable
    if isinstance(trainable, dict):
        return {k: merge_split(trainable.get(k), frozen.get(k))
                for k in {**trainable, **frozen}}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(merge_split(a, b)
                               for a, b in zip(trainable, frozen))
    return trainable
