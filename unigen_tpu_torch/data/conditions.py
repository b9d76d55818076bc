"""Condition-image synthesis + registry (port of
``unigen_tpu/data/conditions.py``).

Equivalent of the reference ``Condition`` helper (src/condition.py:12-135):
derive spatial control images from a source image (canny, grayscale/coloring,
blur/deblurring, fill/outpainting, depth via injected model), the condition
type-id registry, and the subject-type positional id offset trick
(condition.py:118-121).

All transforms are pure numpy/cv2 on uint8 HWC images; outputs are float32
CHW in [-1, 1] ready for the VAE.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

try:
    import cv2
    HAS_CV2 = True
except Exception:  # pragma: no cover
    HAS_CV2 = False

# reference condition.py type_id registry order
CONDITION_TYPE_IDS: Dict[str, int] = {
    "depth": 0, "canny": 1, "subject": 4, "coloring": 6, "deblurring": 7,
    "fill": 9,
}


def to_model_range(img_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 CHW in [-1, 1].

    The hot per-sample conversion in every dataset __getitem__
    (datasets.py): routed through the native C++ pipeline
    (native/image_pipeline.cpp via data/native.normalize_chw — one fused
    pass instead of numpy's cast+scale+transpose copies; equal to the numpy
    path within float32 rounding, pinned by tests) and falling back to
    numpy when the .so is unavailable."""
    from unigen_tpu_torch.data import native
    if native.available():
        return native.normalize_chw(np.ascontiguousarray(img_u8)[None])[0]
    x = img_u8.astype(np.float32) / 127.5 - 1.0
    return x.transpose(2, 0, 1)


def from_model_range(chw: np.ndarray) -> np.ndarray:
    x = np.clip((chw.transpose(1, 2, 0) + 1.0) * 127.5, 0, 255)
    return x.round().astype(np.uint8)


def canny(img_u8: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """cv2.Canny(100, 200) replicated to 3 channels (condition.py / dataloader.py:183)."""
    assert HAS_CV2, "cv2 required for canny"
    gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, low, high)
    return np.repeat(edges[:, :, None], 3, axis=2)


def grayscale(img_u8: np.ndarray) -> np.ndarray:
    """'coloring' condition: luminance replicated to RGB."""
    assert HAS_CV2
    g = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
    return np.repeat(g[:, :, None], 3, axis=2)


def blur(img_u8: np.ndarray, ksize: int = 21, sigma: float = 10.0) -> np.ndarray:
    """'deblurring' condition: Gaussian blur sigma 10 (condition.py:61)."""
    assert HAS_CV2
    return cv2.GaussianBlur(img_u8, (ksize, ksize), sigma)


def fill_mask(img_u8: np.ndarray, box: tuple) -> np.ndarray:
    """'fill' / outpainting: zero the region outside the box."""
    out = np.zeros_like(img_u8)
    y0, y1, x0, x1 = box
    out[y0:y1, x0:x1] = img_u8[y0:y1, x0:x1]
    return out


def inpaint_mask(img_u8: np.ndarray, box: tuple) -> np.ndarray:
    """inpainting: zero the region inside the box."""
    out = img_u8.copy()
    y0, y1, x0, x1 = box
    out[y0:y1, x0:x1] = 0
    return out


_SYNTH: Dict[str, Callable] = {
    "canny": canny, "coloring": grayscale, "grayscale": grayscale,
    "deblurring": blur, "blur": blur,
}


def make_depth_fn(params: dict, cfg=None, *, target_multiple: int = 14):
    """The depth synthesizer from a Depth-Anything tree: it waits for the
    port of ``models/depth.py`` (ROADMAP Queue 1 item 9). Depth conditions
    come pre-rendered from the dataset until then."""
    raise NotImplementedError("make_depth_fn waits for the port of models/depth.py "
                              "(ROADMAP Queue 1 item 9)")


def synthesize(condition_type: str, img_u8: np.ndarray,
               depth_fn: Optional[Callable] = None, **kw) -> np.ndarray:
    """Create a condition image. 'depth' uses an injected depth model
    callable — build one with ``make_depth_fn`` (the reference downloads
    depth-anything-small-hf at call time, condition.py:37)."""
    if condition_type == "depth":
        assert depth_fn is not None, \
            "depth condition needs a depth model callable (or pre-rendered " \
            "depth images from the dataset)"
        return depth_fn(img_u8)
    fn = _SYNTH.get(condition_type)
    if fn is None:
        # dataset-provided condition types (hed, seg, openpose, ...) come
        # pre-rendered from MultiGen-20M; passthrough.
        return img_u8
    return fn(img_u8, **kw)


def condition_id_offset(condition_type: str, latent_width: int) -> float:
    """Subject-driven generation places condition tokens beside (not on top
    of) the image grid: cond_ids[:, 2] += latent_w/2 (condition.py:118-121).

    ``latent_width`` is the LATENT grid width (res // vae_factor, e.g.
    res // 8 for flux) — the returned offset equals the FULL packed-grid
    width (latent_width / 2), matching the serving path
    (pipelines/flux.py ``lw / 2.0``). Passing the packed width here would
    halve the separation (advisor round-4 finding)."""
    return latent_width / 2.0 if condition_type == "subject" else 0.0
