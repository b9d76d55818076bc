"""W4A8 dequant-matmul and per-token activation quantization: the CUDA
kernels ``csrc/w4a8_matmul.cu`` and ``csrc/quantize_act.cu`` and their plain
PyTorch versions.

Replaces ``unigen_tpu/ops/pallas/quant_matmul.py`` (``w4a8_matmul_pallas``
-> ``_w4a8_kernel``). xq int8 [M, K] and xs f32 [M, 1] are the per-token
quantized activations; w_q4 int8 [K/2, N] holds half-paired int4 codes
(packed row j = source row j in the low nibble, source row j + K/2 in the
high nibble); w_scale f32 [1, N]. The result is
``(float(acc) * xs) * w_scale`` cast to ``out_dtype``, with acc the exact
int32 product; kernel and plain version agree bit for bit. Shapes whose K
and N are multiples of 16 (every shape of the main paths) run the Hopper
kernel (``wgmma`` s8 on TMA tiles, counted in ``launches``); the others
run the general kernel (``mma.sync``, counted in ``general_launches``).

``quantize_act`` is ``_quantize_act`` of ``unigen_tpu/ops/quant.py:75``
(there XLA fuses it with its producer): xs = amax/127 per row (1 for an
all-zero row), xq = clamp(round(x / xs), -127, 127); kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from unigen_tpu_torch.ops.cuda import build

KERNEL = "w4a8_matmul"
KERNEL_QUANT = "quantize_act"
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_X_DTYPES = (torch.bfloat16, torch.float32)
STAGE_ROWS = 128      # packed weight rows per stage of the Hopper kernel
# kernel launches, counted by the wrappers; reset by callers
launches = 0          # W4A8, the Hopper kernel
general_launches = 0  # W4A8, the general kernel (K or N not a multiple of 16)
quantize_launches = 0  # activation quantization


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


def quantize_act_ref(x: torch.Tensor):
    """Plain version: dynamic per-token symmetric quantization of x [..., K]
    to int8 codes [..., K] and f32 scales [..., 1]. The divisor 127 is a
    tensor on x's device: divided by a Python number, a CUDA tensor is
    multiplied by the number's reciprocal instead, which changes the last
    bit of some scales against the IEEE division of the JAX function."""
    xf = x.to(torch.float32)
    xmax = xf.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(xmax > 0, xmax / xmax.new_tensor(127.0), torch.ones_like(xmax))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


_fns = {}


def _fn(kernel: str, name: str, n_ptr: int, n_int: int):
    """C entry ``name`` of library ``kernel`` (built at first use), kept
    once typed: the M=2 calls are short enough for the host to set their
    pace."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load(kernel), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _stream(t) -> int:
    """The raw handle of t's device's current CUDA stream."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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
    if xq.data_ptr() % 16 or w_q4.data_ptr() % 16:
        raise ValueError("w4a8_matmul: xq and w_q4 must start on a 16-byte boundary")


def tma_shape(k: int, n: int) -> bool:
    """Whether the Hopper kernel takes (K, N): a 2-D int8 tensor map needs
    row strides (K for xq, N for w_q4) that are multiples of 16 bytes."""
    return k % 16 == 0 and n % 16 == 0


_sm_count = {}


def tile(m: int, n: int, k: int, sms: int = 132):
    """(rows a block, K splits) of the Hopper kernel for an M x K x N call on
    a card of ``sms`` multiprocessors (one block a multiprocessor: each
    takes ~200 KB of shared memory). Token rows (M > 64) take 256-row
    tiles, unsplit; short M (the AdaLN and embedder linears) 64-row tiles,
    with K split in two where the tiles alone leave the last wave mostly
    idle (M=2, N=18432: 25.7 us against 29.7 unsplit; at N=9216 unsplit is
    fastest). Device times of ``chip_smoke.py``'s w4a8_tiles line on an
    H100 80GB HBM3 at 700 W; more splits measured no faster."""
    if m > 64:
        return 256, 1
    tiles = -(-n // 128) * -(-m // 64)
    stages = -(-(k // 2) // STAGE_ROWS)
    return 64, 2 if tiles > sms and stages >= 4 else 1


def _launch(xq, xs, w_q4, w_scale, out_dtype, bm, split):
    """The Hopper kernel at a given tile (checked by the caller)."""
    m, k = xq.shape
    n = w_q4.shape[1]
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    partial = (torch.empty(split, m, n, dtype=torch.int32, device=xq.device)
               if split > 1 else None)
    err = _fn(KERNEL, "w4a8_matmul", 6, 6)(
        xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        m, n, k, bm, split, int(out_dtype == torch.bfloat16), _stream(xq))
    build.check(err, KERNEL)
    build.count(globals(), "launches")
    return out


def w4a8_matmul(xq: torch.Tensor, xs: torch.Tensor, w_q4: torch.Tensor,
                w_scale: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """xq [M, K] int8, xs [M, 1] f32, w_q4 [K/2, N] int8, w_scale [1, N] f32
    -> [M, N] out_dtype. CPU tensors take the plain version; CUDA tensors
    launch a kernel (and count the launch) or raise: the Hopper kernel when
    K and N are multiples of 16, else the general one (chosen by shape,
    before launching)."""
    if xq.device.type == "cpu":
        return w4a8_matmul_ref(xq, xs, w_q4, w_scale, out_dtype)
    _check(xq, xs, w_q4, w_scale, out_dtype)
    m, k = xq.shape
    n = w_q4.shape[1]
    if m == 0 or n == 0:
        return torch.empty(m, n, dtype=out_dtype, device=xq.device)
    if tma_shape(k, n):
        dev = xq.get_device()
        if dev not in _sm_count:
            _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        return _launch(xq, xs, w_q4, w_scale, out_dtype, *tile(m, n, k, _sm_count[dev]))
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    err = _fn(KERNEL, "w4a8_general", 5, 4)(
        xq.data_ptr(), xs.data_ptr(), w_q4.data_ptr(), w_scale.data_ptr(),
        out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16), _stream(xq))
    build.check(err, KERNEL)
    build.count(globals(), "general_launches")
    return out


def quantize_act(x: torch.Tensor):
    """x [M, K] bf16 or fp32 -> (xq int8 [M, K], xs f32 [M, 1]). CPU tensors
    take the plain version; CUDA tensors launch the kernel (and count the
    launch) or raise."""
    if x.device.type == "cpu":
        return quantize_act_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_act: tensors on {x.device} are neither CPU nor CUDA")
    if x.dtype not in _X_DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"quantize_act: x must be a contiguous 2-D tensor of one of "
                         f"{_X_DTYPES}, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x.device)
    xs = torch.empty(m, 1, dtype=torch.float32, device=x.device)
    if m == 0 or k == 0:
        return xq, xs.fill_(1.0)
    err = _fn(KERNEL_QUANT, "quantize_act", 3, 3)(
        x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k, int(x.dtype == torch.float32),
        _stream(x))
    build.check(err, KERNEL_QUANT)
    build.count(globals(), "quantize_launches")
    return xq, xs
