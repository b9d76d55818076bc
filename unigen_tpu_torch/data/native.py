"""ctypes bindings for the native host data pipeline (port of
``unigen_tpu/data/native.py``): resize, normalize, grayscale, Sobel and
Gaussian blur over uint8 [N, H, W, C] batches.

The library is built on first use from the repo's
``native/image_pipeline.cpp`` as it is, with the flags of
``native/build.sh``, into ``build/native/`` (never into ``native/``). On a
host without ``g++`` every function takes the JAX package's numpy path.
This is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "image_pipeline.cpp")
_SO = os.path.join(_ROOT, "build", "native", "libunigen_data.so")
# native/build.sh's command line
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def build() -> str:
    """Compile the library into ``build/native/`` unless it is there and
    newer than its source. A temporary file renamed into place keeps a
    process that builds at the same time from reading a half-written
    library."""
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(build())
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i, f = ctypes.c_int, ctypes.c_float
        lib.resize_bilinear_batch.argtypes = [u8p, i, i, i, i, u8p, i, i, i]
        lib.normalize_chw_batch.argtypes = [u8p, i, i, i, i, f32p, i]
        lib.grayscale_batch.argtypes = [u8p, i, i, i, u8p, i]
        lib.sobel_batch.argtypes = [u8p, i, i, i, u8p, f, i]
        lib.gaussian_blur_batch.argtypes = [u8p, i, i, i, u8p, f, i]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _threads(n):
    return min(max(os.cpu_count() or 1, 1), n)


def normalize_chw(batch_u8: np.ndarray) -> np.ndarray:
    """[N, H, W, C] uint8 -> [N, C, H, W] float32 in [-1, 1]."""
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, c = batch_u8.shape
    lib = _load()
    if lib is None:
        return (batch_u8.astype(np.float32) / 127.5 - 1.0).transpose(0, 3, 1, 2)
    out = np.empty((n, c, h, w), np.float32)
    lib.normalize_chw_batch(_u8p(batch_u8), n, h, w, c, _f32p(out), _threads(n))
    return out


def resize_bilinear(batch_u8: np.ndarray, oh: int, ow: int) -> np.ndarray:
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, c = batch_u8.shape
    lib = _load()
    if lib is None:  # numpy fallback (matching align-corners=False bilinear)
        ys = (np.arange(oh) + 0.5) * h / oh - 0.5
        xs = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = np.clip(ys - y0, 0, 1)[None, :, None, None]
        wx = np.clip(xs - x0, 0, 1)[None, None, :, None]
        b = batch_u8.astype(np.float32)
        v = (b[:, y0][:, :, x0] * (1 - wy) * (1 - wx)
             + b[:, y0][:, :, x1] * (1 - wy) * wx
             + b[:, y1][:, :, x0] * wy * (1 - wx)
             + b[:, y1][:, :, x1] * wy * wx)
        return np.clip(v + 0.5, 0, 255).astype(np.uint8)
    out = np.empty((n, oh, ow, c), np.uint8)
    lib.resize_bilinear_batch(_u8p(batch_u8), n, h, w, c, _u8p(out), oh, ow,
                              _threads(n))
    return out


def grayscale(batch_u8: np.ndarray) -> np.ndarray:
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, _ = batch_u8.shape
    lib = _load()
    if lib is None:
        g = (0.299 * batch_u8[..., 0] + 0.587 * batch_u8[..., 1]
             + 0.114 * batch_u8[..., 2])
        g = np.clip(g, 0, 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    out = np.empty_like(batch_u8)
    lib.grayscale_batch(_u8p(batch_u8), n, h, w, _u8p(out), _threads(n))
    return out


def sobel_edges(batch_u8: np.ndarray, threshold: float = 150.0) -> np.ndarray:
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, _ = batch_u8.shape
    lib = _load()
    if lib is None:
        lum = (0.299 * batch_u8[..., 0] + 0.587 * batch_u8[..., 1]
               + 0.114 * batch_u8[..., 2]).astype(np.float32)
        pad = np.pad(lum, ((0, 0), (1, 1), (1, 1)), mode="edge")
        gx = (pad[:, :-2, 2:] + 2 * pad[:, 1:-1, 2:] + pad[:, 2:, 2:]
              - pad[:, :-2, :-2] - 2 * pad[:, 1:-1, :-2] - pad[:, 2:, :-2])
        gy = (pad[:, 2:, :-2] + 2 * pad[:, 2:, 1:-1] + pad[:, 2:, 2:]
              - pad[:, :-2, :-2] - 2 * pad[:, :-2, 1:-1] - pad[:, :-2, 2:])
        mag = np.sqrt(gx * gx + gy * gy)
        edge = np.where(mag > threshold, 255, 0).astype(np.uint8)
        return np.repeat(edge[..., None], 3, axis=-1)
    out = np.empty_like(batch_u8)
    lib.sobel_batch(_u8p(batch_u8), n, h, w, _u8p(out), threshold, _threads(n))
    return out


def gaussian_blur(batch_u8: np.ndarray, sigma: float = 10.0) -> np.ndarray:
    batch_u8 = np.ascontiguousarray(batch_u8)
    n, h, w, _ = batch_u8.shape
    lib = _load()
    if lib is None:
        try:
            import cv2
            out = np.stack([cv2.GaussianBlur(img, (0, 0), sigma)
                            for img in batch_u8])
            return out
        except Exception:
            return batch_u8.copy()
    out = np.empty_like(batch_u8)
    lib.gaussian_blur_batch(_u8p(batch_u8), n, h, w, _u8p(out), sigma,
                            _threads(n))
    return out
