"""W4A8 dequant-matmul: the CUDA kernel ``csrc/w4a8_matmul.cu`` and its
plain PyTorch version.

Replaces ``unigen_tpu/ops/pallas/quant_matmul.py`` (``w4a8_matmul_pallas``
-> ``_w4a8_kernel``). xq int8 [M, K] and xs f32 [M, 1] are the per-token
quantized activations; w_q4 int8 [K/2, N] holds half-paired int4 codes
(packed row j = source row j in the low nibble, source row j + K/2 in the
high nibble); w_scale f32 [1, N]. The result is
``(float(acc) * xs) * w_scale`` cast to ``out_dtype``, with acc the exact
int32 product; kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from unigen_tpu_torch.ops.cuda import build

KERNEL = "w4a8_matmul"
_OUT_DTYPES = (torch.bfloat16, torch.float32)
launches = 0      # kernel launches, counted by the wrapper; reset by callers


def w4a8_matmul_ref(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                    w_scale: torch.Tensor, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """Plain version: sign-extend both nibble planes and multiply each with
    its half of xq. float64 holds every int32 partial sum exactly, so the
    accumulator equals the integer product on any device."""
    half = w_q4.shape[0]
    lo = ((w_q4 << 4) >> 4).to(torch.float64)
    hi = (w_q4 >> 4).to(torch.float64)
    x = xq.to(torch.float64)
    acc = (x[:, :half] @ lo + x[:, half:] @ hi).to(torch.int32)
    return (acc.to(torch.float32) * xs * w_scale).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load(KERNEL)
    fn = lib.w4a8_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(xq, xs, w_q4, w_scale, out_dtype):
    dev = xq.device
    if dev.type != "cuda":
        raise ValueError(f"w4a8_matmul: tensors on {dev} are neither CPU nor CUDA")
    for name, t, dtype in (("xq", xq, torch.int8), ("xs", xs, torch.float32),
                           ("w_q4", w_q4, torch.int8),
                           ("w_scale", w_scale, torch.float32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"w4a8_matmul: {name} must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if xq.dim() != 2 or w_q4.dim() != 2:
        raise ValueError("w4a8_matmul: xq [M, K] and w_q4 [K/2, N] must be 2-D")
    m, k = xq.shape
    n = w_q4.shape[1]
    if k % 2 or w_q4.shape[0] * 2 != k:
        raise ValueError(f"w4a8_matmul: K={k} must be even and match "
                         f"w_q4 rows {w_q4.shape[0]} * 2")
    if tuple(xs.shape) != (m, 1) or tuple(w_scale.shape) != (1, n):
        raise ValueError(f"w4a8_matmul: xs {tuple(xs.shape)} must be ({m}, 1) "
                         f"and w_scale {tuple(w_scale.shape)} must be (1, {n})")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"w4a8_matmul: out_dtype {out_dtype} not in {_OUT_DTYPES}")


def w4a8_matmul(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq [M, K] int8, xs [M, 1] f32, w_q4 [K/2, N] int8, w_scale [1, N] f32
    -> [M, N] out_dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel (and count the launch) or raise."""
    if xq.device.type == "cpu":
        return w4a8_matmul_ref(xq, xs, w_q4, w_scale, out_dtype)
    _check(xq, xs, w_q4, w_scale, out_dtype)
    m, k = xq.shape
    n = w_q4.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    if m == 0 or n == 0:
        return out
    err = _lib().w4a8_matmul(
        xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, KERNEL)
    global launches
    launches += 1
    return out
