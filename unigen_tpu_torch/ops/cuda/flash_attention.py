"""Attention kernels: the fused RoPE attention forward and backward
(``csrc/flash_attention_rope.cu``, ``csrc/flash_attention_rope_bwd.cu``),
the rope-free forward and backward (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``), and their plain PyTorch versions.

Replaces ``unigen_tpu/ops/pallas/flash_attention.py``:

- ``flash_attention_rope`` -> ``_attn_rope_kernel`` (and, past 2560 keys,
  ``flash_attention_streaming_rope`` -> ``_stream_rope_kernel``), and its
  VJP ``_flash_rope_bwd`` -> ``_attn_bwd_rope_kernel`` or the kv-blocked
  ``_lse_rope_kernel``/``_dq_blk_rope_kernel``/``_dkv_blk_rope_kernel``:
  non-causal softmax(rot(q) rot(k)^T / sqrt(D)) v with interleaved-pair
  rotary taken in fp32 and rounded to the input dtype before the product.
  cos/sin [Sq, D] are the Q-side tables, kcos/ksin [Skv, D] the K-side ones
  (identity rows for KV-append keys). The kernels take q, k, v
  [B, H, S, 128] in bf16, or all in fp32 (the ``Trainer``'s fp32
  activations): fp32 operands are rounded to bf16 for the tensor cores, as
  bf16 ones are after the rotation, and the results are written in fp32.
  ``rope_rotate`` is the rotation pass both directions run first (one
  launch per call, counted apart): the TPU kernel rotates K once per head
  in VMEM; on the card the rotated K (and, for the backward, Q), and the
  bf16 rounding of fp32 V and dO, go to bf16 buffers that the attention
  kernels read by TMA. The rope-free kernels run the same pass, as rounding
  jobs only, where their inputs are fp32 (one launch per call, counted in
  ``rotate_launches`` too).
- ``flash_attention`` -> ``_attn_kernel`` (and, past 2560 keys,
  ``flash_attention_streaming`` -> ``_stream_kernel``): the same attention
  without rotary, at head dim 64 (SD3) or 128, any Sq and Skv, and its VJP
  ``_flash_bwd`` / ``_flash_stream_bwd`` -> ``_attn_bwd_kernel`` or the
  kv-blocked ``_lse_kernel``/``_dq_blk_kernel``/``_dkv_blk_kernel``: the
  RoPE kernels' Hopper cores (``csrc/attention_fwd.cuh``,
  ``csrc/attention_bwd.cuh``) without the rotation.

Every attention kernel reads its bf16 operands by TMA, so they must start
on a 16-byte boundary (``_tma_ready`` raises otherwise; fp32 operands, read
with 16-byte loads by the rounding pass or the forward's prologue, too).

On the card one online-softmax kernel walks KV in tiles at any length, so
each TPU pair (full-KV and streaming) has one kernel here.

``flash_attention_rope`` and ``flash_attention`` are
``torch.autograd.Function``s: the forward saves q, k, v (the tables), the
output and the row log-sum-exp; the backward gives dq, dk, dv (and no
gradient for the tables: the JAX VJP returns zeros for them). On CUDA
tensors both directions launch kernels; on CPU tensors both take the plain
versions. The directions go through the module-level
``flash_attention_rope_fwd``/``flash_attention_rope_bwd`` and
``flash_attention_fwd``/``flash_attention_bwd``, so a caller can route all
of them at once.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.rope import apply_rotary

KERNEL = "flash_attention_rope"
KERNEL_BWD = "flash_attention_rope_bwd"
KERNEL_NOROPE = "flash_attention"
KERNEL_NOROPE_BWD = "flash_attention_bwd"
HEAD_DIM = 128                  # the RoPE kernels
HEAD_DIMS_NOROPE = (64, 128)    # the rope-free kernels
# kernel launches, counted by the wrappers; reset by callers
launches = 0              # RoPE forward
rotate_launches = 0       # rotation pass (one per RoPE call; one per fp32 rope-free call)
dq_launches = 0           # RoPE backward, dQ kernel
dkv_launches = 0          # RoPE backward, dK/dV kernel
norope_launches = 0       # rope-free forward
norope_dq_launches = 0    # rope-free backward, dQ kernel
norope_dkv_launches = 0   # rope-free backward, dK/dV kernel


def flash_attention_rope_ref(q, k, v, cos, sin, kcos, ksin) -> torch.Tensor:
    """Plain version: rotate (fp32, rounded to the input dtype), then the
    fp32-softmax attention of ``ops/attention.sdpa_ref``."""
    from unigen_tpu_torch.ops.attention import sdpa_ref
    return sdpa_ref(apply_rotary(q, cos, sin), apply_rotary(k, kcos, ksin), v)


def rope_rotate_ref(x, cos=None, sin=None) -> torch.Tensor:
    """Plain version of one rotation job: ``apply_rotary`` (fp32, rounded to
    x's dtype) rounded to bf16, the operand ``flash_attention_rope_ref``
    feeds its bf16 product; without tables x rounded to bf16."""
    if cos is not None:
        x = apply_rotary(x, cos, sin)
    return x.to(torch.bfloat16)


def rope_rotate(jobs):
    """The rotation pass: for each (x, cos, sin) of ``jobs`` (at most four;
    cos = sin = None for a plain rounding) a bf16 tensor of x's shape. A
    rotating job takes head dim 128, a rounding one 64 or 128. CPU tensors
    take the plain version; CUDA tensors run all jobs in one launch of the
    kernel (counted) or raise."""
    if jobs[0][0].device.type == "cpu":
        return [rope_rotate_ref(*job) for job in jobs]
    if not 1 <= len(jobs) <= 4:
        raise ValueError("rope_rotate: one to four jobs")
    bh = jobs[0][0].shape[0] * jobs[0][0].shape[1]
    for x, cos, sin in jobs:
        dims = HEAD_DIMS_NOROPE if cos is None else (HEAD_DIM,)
        if x.dtype not in _DTYPES or not x.is_cuda or not x.is_contiguous() \
                or x.dim() != 4 or x.shape[-1] not in dims \
                or x.shape[0] * x.shape[1] != bh:
            raise ValueError(f"rope_rotate: x must be a contiguous [B, H, S, D] bf16 "
                             f"or fp32 CUDA tensor of one B*H with D in {dims}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if cos is not None and not all(
                t.shape == (x.shape[2], HEAD_DIM) and t.dtype == torch.float32
                and t.device == x.device and t.is_contiguous() for t in (cos, sin)):
            raise ValueError("rope_rotate: tables must be contiguous f32 [S, D] "
                             "on x's device")
    _tma_ready("rope_rotate", *(x for x, _, _ in jobs))
    return _rotate(jobs)


def _rotate(jobs):
    """Launch the rotation pass on checked CUDA jobs (counted)."""
    outs = [torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
            for x, _, _ in jobs]
    if not any(o.numel() for o in outs):
        return outs
    pad = [None] * (4 - len(jobs))
    ptrs = [(ctypes.c_void_p * 4)(*vals, *pad) for vals in (
        [x.data_ptr() for x, _, _ in jobs], [o.data_ptr() for o in outs],
        [None if c is None else c.data_ptr() for _, c, _ in jobs],
        [None if c is None else c.data_ptr() for _, _, c in jobs])]
    ints = [(ctypes.c_int * 4)(*vals) for vals in (
        [x.shape[2] for x, _, _ in jobs], [x.shape[3] for x, _, _ in jobs],
        [int(x.dtype == torch.float32) for x, _, _ in jobs])]
    x = jobs[0][0]
    build.check(_entry("rope_rotate")(
        *ptrs, *ints, len(jobs), x.shape[0] * x.shape[1], _stream(x)),
        KERNEL + "_rotate")
    build.count(globals(), "rotate_launches")
    return outs


def _softmax_bwd_parts(qf, kf, v, o, do):
    """The shared fp32 part of both plain backwards: P and dS of
    ``_bwd_block_math`` (flash_attention.py:621-643) from fp32 (rotated,
    where rotary applies) q and k, with D = rowsum(dO * O) from the saved
    output as ``_flash_bwd_blocked`` takes it (:1070-1076). -> (P, dS, dO)"""
    f32 = torch.float32
    vf, dof = v.to(f32), do.to(f32)
    scale = 1.0 / math.sqrt(qf.shape[-1])
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, dim=-1)
    drow = (dof * o.to(f32)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - drow) * scale
    return p, ds, dof


def _bwd_ref_parts(q, k, v, o, do, cos, sin, kcos, ksin):
    """The rotated operands (fp32, not rounded), P and dS of the plain RoPE
    backward."""
    f32 = torch.float32
    qr = apply_rotary(q.to(f32), cos, sin)
    kr = apply_rotary(k.to(f32), kcos, ksin)
    return (qr, kr) + _softmax_bwd_parts(qr, kr, v, o, do)


def flash_attention_rope_bwd_ref(q, k, v, o, do, cos, sin, kcos, ksin):
    """Plain backward in fp32 -> (dq, dk, dv) in the inputs' dtypes:
    dq = rot^T(dS kr), dk = rot^T(dS^T qr), dv = P^T dO, where rot^T is
    the counter-rotation rotate(., cos, -sin) (flash_attention.py:687-695)."""
    qr, kr, p, ds, dof = _bwd_ref_parts(q, k, v, o, do, cos, sin, kcos, ksin)
    dq = apply_rotary(ds @ kr, cos, -sin)
    dk = apply_rotary(ds.transpose(-1, -2) @ qr, kcos, -ksin)
    dv = p.transpose(-1, -2) @ dof
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# C entry points: (library, pointer arguments, int arguments, float
# arguments); the ints are BH, Sq, Skv (and D for the rope-free kernels),
# and every entry ends with an fp32 flag and the stream. rope_rotate takes seven arrays
# (sources, destinations, cos, sin, rows, head dims, fp32 flags), then the
# job count and BH as ints, then the stream.
_ENTRIES = {"rope_rotate": (KERNEL, 7, 1, 0),
            "flash_attention_rope": (KERNEL, 11, 3, 1),
            "flash_attention_rope_bwd_dkv": (KERNEL_BWD, 10, 3, 2),
            "flash_attention_rope_bwd_dq": (KERNEL_BWD, 9, 3, 2),
            "flash_attention": (KERNEL_NOROPE, 7, 4, 1),
            "flash_attention_bwd": (KERNEL_NOROPE_BWD, 13, 4, 2)}


def _entry(name: str):
    kernel, n_ptr, n_int, n_float = _ENTRIES[name]
    fn = getattr(build.load(kernel), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


_DTYPES = (torch.bfloat16, torch.float32)


def _check(what, tensors, q, k, cos, sin, kcos, ksin):
    """Raise unless every tensor is a contiguous CUDA tensor of the kernel's
    dtype and shape: q-like and k-like all bf16 or all fp32, tables f32
    [S, 128]."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev} are neither CPU nor CUDA")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: q, k, v must be one of {_DTYPES}, got {q.dtype}")
    for name, t, dtype in tensors:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{what}: q, k, v must be [B, H, S, D]")
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or d != HEAD_DIM:
        raise ValueError(f"{what}: head dim must be {HEAD_DIM} and "
                         f"q {tuple(q.shape)} must match k {tuple(k.shape)}")
    skv = k.shape[2]
    if cos.shape != (sq, d) or sin.shape != (sq, d) \
            or kcos.shape != (skv, d) or ksin.shape != (skv, d):
        raise ValueError(f"{what}: tables must be [Sq, D] and [Skv, D]")
    if skv == 0:
        raise ValueError(f"{what}: empty key sequence")


def _tables(cos, sin, kcos, ksin):
    f32 = torch.float32
    return [("cos", cos, f32), ("sin", sin, f32), ("kcos", kcos, f32),
            ("ksin", ksin, f32)]


def _stream(t) -> int:
    """The raw handle of the current CUDA stream of t's device (the same
    stream as ``torch.cuda.current_stream(t.device)``, without building its
    Python object: a few microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _tma_ready(what, *tensors):
    """Raise unless each tensor's address suits a TMA tensor map and the
    kernels' 16-byte loads (16 bytes)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must start on a 16-byte boundary")


def flash_attention_rope_fwd(q, k, v, cos, sin, kcos, ksin, with_lse=False):
    """Forward -> (out [B,H,Sq,D], lse [B,H,Sq] f32 or None). CPU tensors take
    the plain version (no lse: the plain backward recomputes P); CUDA tensors
    run the rotation pass (kr = rot(k), and v rounded to bf16 for fp32
    inputs) and the kernel, both launched by one C call (each launch
    counted), or raise. ``with_lse`` makes the kernel also write the row
    log-sum-exp for the backward."""
    if q.device.type == "cpu":
        return flash_attention_rope_ref(q, k, v, cos, sin, kcos, ksin), None
    dt = q.dtype
    _check("flash_attention_rope", [("q", q, dt), ("k", k, dt),
                                    ("v", v, dt)] + _tables(cos, sin, kcos, ksin),
           q, k, cos, sin, kcos, ksin)
    if k.shape != v.shape:
        raise ValueError("flash_attention_rope: k and v must have one shape")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * h * sq == 0:
        return out, lse
    fp32 = dt == torch.float32
    _tma_ready("flash_attention_rope", q, k, v)
    kr = torch.empty(k.shape, dtype=torch.bfloat16, device=k.device)
    vb = torch.empty(v.shape, dtype=torch.bfloat16, device=v.device) if fp32 else None
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    err = _entry("flash_attention_rope")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        kcos.data_ptr(), ksin.data_ptr(), kr.data_ptr(),
        None if vb is None else vb.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b * h, sq, k.shape[2],
        scale_log2, int(fp32), _stream(q))
    build.check(err, KERNEL)
    build.count(globals(), "rotate_launches")
    build.count(globals(), "launches")
    return out, lse


def _rotated_bwd_operands(q, k, v, do, cos, sin, kcos, ksin):
    """(qr, kr, v, dO) in bf16 for the backward kernels, from one launch of
    the rotation pass (which also rounds fp32 v and dO)."""
    _tma_ready("flash_attention_rope_bwd", q, k, v, do)
    if q.dtype == torch.float32:
        return tuple(_rotate([(q, cos, sin), (k, kcos, ksin),
                              (v, None, None), (do, None, None)]))
    return (*_rotate([(q, cos, sin), (k, kcos, ksin)]), v, do)


def _bwd_args(rotated, q, k, lse, drow):
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    return ((*(x.data_ptr() for x in rotated), lse.data_ptr(), drow.data_ptr()),
            (q.shape[0] * q.shape[1], q.shape[2], k.shape[2], scale,
             scale * math.log2(math.e), int(q.dtype == torch.float32),
             _stream(q)))


def flash_attention_rope_bwd_dkv(q, k, v, do, lse, drow, cos, sin, kcos, ksin,
                                 rotated=None):
    """The dK/dV kernel alone on checked CUDA tensors -> (dk, dv); counted.
    ``rotated``: the (qr, kr, v, dO) of ``_rotated_bwd_operands``, else the
    rotation pass runs first (and is counted)."""
    rotated = rotated or _rotated_bwd_operands(q, k, v, do, cos, sin, kcos, ksin)
    ptrs, rest = _bwd_args(rotated, q, k, lse, drow)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    build.check(_entry("flash_attention_rope_bwd_dkv")(
        *ptrs, kcos.data_ptr(), ksin.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *rest), KERNEL_BWD + "_dkv")
    build.count(globals(), "dkv_launches")
    return dk, dv


def flash_attention_rope_bwd_dq(q, k, v, do, lse, drow, cos, sin, kcos, ksin,
                                rotated=None):
    """The dQ kernel alone on checked CUDA tensors -> dq; counted.
    ``rotated`` as for flash_attention_rope_bwd_dkv."""
    rotated = rotated or _rotated_bwd_operands(q, k, v, do, cos, sin, kcos, ksin)
    ptrs, rest = _bwd_args(rotated, q, k, lse, drow)
    dq = torch.empty_like(q)
    build.check(_entry("flash_attention_rope_bwd_dq")(
        *ptrs, cos.data_ptr(), sin.data_ptr(), dq.data_ptr(), *rest),
        KERNEL_BWD + "_dq")
    build.count(globals(), "dq_launches")
    return dq


def flash_attention_rope_bwd(q, k, v, o, lse, do, cos, sin, kcos, ksin):
    """Backward -> (dq, dk, dv). CPU tensors take the plain version (``lse``
    unused); CUDA tensors run D = rowsum(dO * O) in fp32 (a torch elementwise
    pass, as XLA computes it in JAX), one rotation pass for both kernels,
    then the dK/dV and the dQ kernels (each launch counted), or raise."""
    if q.device.type == "cpu":
        return flash_attention_rope_bwd_ref(q, k, v, o, do, cos, sin, kcos, ksin)
    if lse is None:
        raise ValueError("flash_attention_rope_bwd: the kernels need the "
                         "forward's lse")
    dt = q.dtype
    _check("flash_attention_rope_bwd",
           [("q", q, dt), ("k", k, dt), ("v", v, dt), ("o", o, dt),
            ("do", do, dt), ("lse", lse, torch.float32)]
           + _tables(cos, sin, kcos, ksin), q, k, cos, sin, kcos, ksin)
    b, h, sq, d = q.shape
    if lse.shape != (b, h, sq) or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_rope_bwd: needs the forward's lse "
                         "[B, H, Sq] and o, do of q's shape, v of k's shape")
    if b * h * sq == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    drow = (do.float() * o.float()).sum(-1)
    tables = (cos, sin, kcos, ksin)
    rotated = _rotated_bwd_operands(q, k, v, do, *tables)
    dk, dv = flash_attention_rope_bwd_dkv(q, k, v, do, lse, drow, *tables,
                                          rotated=rotated)
    dq = flash_attention_rope_bwd_dq(q, k, v, do, lse, drow, *tables,
                                     rotated=rotated)
    return dq, dk, dv


class _FlashAttentionRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, cos, sin, kcos, ksin):
        out, lse = flash_attention_rope_fwd(q, k, v, cos, sin, kcos, ksin,
                                            with_lse=True)
        ctx.save_for_backward(q, k, v, cos, sin, kcos, ksin, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, cos, sin, kcos, ksin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_rope_bwd(q, k, v, out, lse,
                                              do.contiguous(), cos, sin,
                                              kcos, ksin)
        return dq, dk, dv, None, None, None, None


def flash_attention_rope(q, k, v, cos, sin, kcos, ksin) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D]; cos/sin [Sq,D], kcos/ksin [Skv,D] f32.
    Differentiable in q, k and v (a ``torch.autograd.Function``); the tables
    get no gradient. CPU tensors take the plain versions; CUDA tensors launch
    the kernels (and count the launches) or raise. Without a gradient to
    record, it is the forward alone (no lse, nothing saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionRope.apply(q, k, v, cos, sin, kcos, ksin)
    return flash_attention_rope_fwd(q, k, v, cos, sin, kcos, ksin)[0]


# ---------------------------------------------------------------- rope-free

def flash_attention_ref(q, k, v) -> torch.Tensor:
    """Plain version: the fp32-softmax attention of ``ops/attention.sdpa_ref``
    (probabilities cast to the value dtype for the second product)."""
    from unigen_tpu_torch.ops.attention import sdpa_ref
    return sdpa_ref(q, k, v)


def flash_attention_bwd_ref(q, k, v, o, do):
    """Plain backward in fp32 -> (dq, dk, dv) in the inputs' dtypes:
    dq = dS k, dk = dS^T q, dv = P^T dO (``_bwd_ref_parts`` without the
    rotation)."""
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    p, ds, dof = _softmax_bwd_parts(qf, kf, v, o, do)
    return ((ds @ kf).to(q.dtype), (ds.transpose(-1, -2) @ qf).to(k.dtype),
            (p.transpose(-1, -2) @ dof).to(v.dtype))


def _check_norope(what, named, q, k, v):
    """Raise unless q, k, v and the other named tensors are contiguous CUDA
    tensors of q's dtype (bf16 or fp32) and shape rules, head dim 64/128."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {q.device} are neither CPU nor CUDA")
    dt = q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"{what}: q, k, v must be one of {_DTYPES}, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(named):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 4:
            raise ValueError(f"{what}: {name} must be a contiguous [B, H, S, D] "
                             f"{dt} tensor on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS_NOROPE or k.shape[:2] != (b, h) or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"{what}: head dim must be one of {HEAD_DIMS_NOROPE}, "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must agree")
    if k.shape[2] == 0:
        raise ValueError(f"{what}: empty key sequence")


def flash_attention_fwd(q, k, v, with_lse=False):
    """Rope-free forward -> (out, lse [B,H,Sq] f32 or None). CPU tensors take
    the plain version (no lse: the plain backward recomputes P); CUDA tensors
    launch the kernel (and, for fp32 inputs, the rounding pass first, from
    the same C call; each launch counted) or raise. ``with_lse`` makes the
    kernel also write the row log-sum-exp for the backward."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v), None
    _check_norope("flash_attention", (), q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * h * sq == 0:
        return out, lse
    _tma_ready("flash_attention", q, k, v)
    fp32 = q.dtype == torch.float32
    kb, vb = ((torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
               for x in (k, v)) if fp32 else (None, None))
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    err = _entry("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *(None if x is None else x.data_ptr()
                                                    for x in (kb, vb, out, lse)),
        b * h, sq, k.shape[2], d, scale_log2, int(fp32), _stream(q))
    build.check(err, KERNEL_NOROPE)
    build.count(globals(), "rotate_launches", int(fp32))
    build.count(globals(), "norope_launches")
    return out, lse


def _norope_bwd_launch(operands, scratch, q, k, lse, drow, dq=None, dk=None, dv=None):
    """One C call of the rope-free backward on checked CUDA tensors: for fp32
    ``operands`` with bf16 ``scratch`` buffers the rounding pass first, then
    the dK/dV kernel where dk, dv are given and the dQ kernel where dq is
    given, both on one set of tensor maps. Counts the launches."""
    b, h, sq, d = q.shape
    scale = 1.0 / math.sqrt(d)
    fp32 = q.dtype == torch.float32
    build.check(_entry("flash_attention_bwd")(
        *(x.data_ptr() for x in operands),
        *(None if x is None else x.data_ptr() for x in scratch),
        lse.data_ptr(), drow.data_ptr(),
        *(None if x is None else x.data_ptr() for x in (dq, dk, dv)),
        b * h, sq, k.shape[2], d, scale, scale * math.log2(math.e), int(fp32),
        _stream(q)), KERNEL_NOROPE_BWD)
    build.count(globals(), "rotate_launches", int(scratch[0] is not None))
    build.count(globals(), "norope_dkv_launches", int(dk is not None))
    build.count(globals(), "norope_dq_launches", int(dq is not None))


def _norope_bwd_operands(q, k, v, do):
    """(q, k, v, dO) in bf16 for the rope-free backward kernels: as given,
    or for fp32 inputs from one launch of the rounding pass (counted)."""
    _tma_ready("flash_attention_bwd", q, k, v, do)
    if q.dtype == torch.float32:
        return tuple(_rotate([(x, None, None) for x in (q, k, v, do)]))
    return q, k, v, do


def flash_attention_bwd_dkv(q, k, v, do, lse, drow, operands=None):
    """The rope-free dK/dV kernel alone on checked CUDA tensors -> (dk, dv);
    counted. ``operands``: the bf16 (q, k, v, dO) of
    ``_norope_bwd_operands``, else they are made first (fp32: the rounding
    pass, counted)."""
    operands = operands or _norope_bwd_operands(q, k, v, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _norope_bwd_launch(operands, (None,) * 4, q, k, lse, drow, dk=dk, dv=dv)
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, drow, operands=None):
    """The rope-free dQ kernel alone on checked CUDA tensors -> dq; counted.
    ``operands`` as for flash_attention_bwd_dkv."""
    operands = operands or _norope_bwd_operands(q, k, v, do)
    dq = torch.empty_like(q)
    _norope_bwd_launch(operands, (None,) * 4, q, k, lse, drow, dq=dq)
    return dq


def flash_attention_bwd(q, k, v, o, lse, do):
    """Rope-free backward -> (dq, dk, dv). CPU tensors take the plain version
    (``lse`` unused); CUDA tensors run D = rowsum(dO * O) in fp32 (a torch
    elementwise pass, as XLA computes it in JAX), then one C call: for fp32
    inputs the rounding pass for both kernels, and the dK/dV and the dQ
    kernels (each launch counted); or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do)
    if lse is None:
        raise ValueError("flash_attention_bwd: the kernels need the forward's lse")
    _check_norope("flash_attention_bwd", (("o", o), ("do", do)), q, k, v)
    b, h, sq, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous() \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash_attention_bwd: needs the forward's contiguous "
                         "f32 lse [B, H, Sq] and o, do of q's shape")
    if b * h * sq == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    _tma_ready("flash_attention_bwd", q, k, v, do)
    drow = (do.float() * o.float()).sum(-1)
    scratch = ([torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
                for x in (q, k, v, do)] if q.dtype == torch.float32 else (None,) * 4)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _norope_bwd_launch((q, k, v, do), scratch, q, k, lse, drow, dq, dk, dv)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, do.contiguous())


def flash_attention(q, k, v) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,H,Skv,D], D in (64, 128) on CUDA, any lengths.
    Differentiable in q, k and v (a ``torch.autograd.Function``). CPU
    tensors take the plain versions; CUDA tensors launch the kernels (and
    count the launches) or raise. Without a gradient to record, it is the
    forward alone (no lse, nothing saved)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return flash_attention_fwd(q, k, v)[0]
