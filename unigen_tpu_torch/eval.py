"""Evaluation metrics (port of ``unigen_tpu/eval.py``): SSIM (the parity
metric of ``BASELINE.md``), PSNR and MAE; the Fréchet distance over any
feature tower; DISTS over the VGG16 tower.

SSIM: an 11x11 Gaussian window (sigma 1.5), K1 = 0.01, K2 = 0.03, per
channel and averaged, a valid depthwise filter (``F.conv2d`` with
``groups=C``); the covariances carry skimage's sample-covariance factor
NP/(NP-1) (``structural_similarity(gaussian_weights=True,
use_sample_covariance=True)``). Images smaller than the window get the
largest odd window that fits.

The Fréchet statistics are accumulated on the host in float64 (numpy), as
in the JAX package. DISTS with learned weights divides ``alpha`` and
``beta`` by their joint sum, as the official DISTS does (``DISTS_pytorch``:
``w_sum = alpha.sum() + beta.sum()``); the JAX package applies them raw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W], valid-mode depthwise filter."""
    c = img.shape[1]
    k = kernel[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(img, k, groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor, *, data_range: float = 255.0,
         win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM between image batches [B, C, H, W] (float)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    # a window larger than the image leaves the valid filter empty: clamp it
    # to the image, odd-sized
    side = min(int(a.shape[-2]), int(a.shape[-1]))
    if side < win_size:
        win_size = side if side % 2 == 1 else side - 1
    k = _gaussian_kernel(win_size, sigma, device=a.device)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d(a, k)
    mu_b = _filter2d(b, k)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # a 1x1 window (1-2 px images): the variances vanish and SSIM is the
    # luminance term; the 1-sample covariance factor would be 0/0
    cov_norm = ((win_size * win_size) / (win_size * win_size - 1.0)
                if win_size > 1 else 1.0)
    s_aa = cov_norm * (_filter2d(a * a, k) - mu_aa)
    s_bb = cov_norm * (_filter2d(b * b, k) - mu_bb)
    s_ab = cov_norm * (_filter2d(a * b, k) - mu_ab)
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return torch.mean(num / den)


def psnr(a: torch.Tensor, b: torch.Tensor, *, data_range: float = 255.0) -> torch.Tensor:
    mse = torch.mean((a.to(torch.float32) - b.to(torch.float32)) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))


def image_metrics(a: np.ndarray, b: np.ndarray, device=None) -> dict:
    """uint8 HWC (or batched BHWC) image comparison report, computed on
    ``device`` (CUDA unless "cpu" is named)."""
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(device)
    if a.ndim == 3:
        a, b = a[None], b[None]
    at = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dev, torch.float32)
    bt = torch.from_numpy(np.ascontiguousarray(b.transpose(0, 3, 1, 2))).to(dev, torch.float32)
    return {"ssim": float(ssim(at, bt)), "psnr": float(psnr(at, bt)),
            "mae": float(torch.mean(torch.abs(at - bt)))}


# --------------------------------------------------------------- FID / DISTS


class FeatureStats:
    """Streaming mean / covariance of [N, D] feature batches, accumulated on
    the host in float64."""

    def __init__(self, dim: int):
        self.n = 0
        self._sum = np.zeros((dim,), np.float64)
        self._outer = np.zeros((dim, dim), np.float64)

    def update(self, feats) -> None:
        f = np.asarray(feats, np.float64)
        if f.ndim != 2 or f.shape[1] != self._sum.shape[0]:
            raise ValueError(f"features of shape {f.shape}; expected [N, "
                             f"{self._sum.shape[0]}]")
        self.n += f.shape[0]
        self._sum += f.sum(axis=0)
        self._outer += f.T @ f

    def finalize(self):
        """-> (mu [D], sigma [D, D]) with the sample covariance's 1/(n-1)
        (np.cov / pytorch-fid)."""
        if self.n < 2:
            raise ValueError("need >= 2 samples for a covariance")
        mu = self._sum / self.n
        sigma = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh((a + a.T) / 2.0)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, sigma1, mu2, sigma2, *, eps: float = 1e-6) -> float:
    """||mu1 - mu2||² + tr(S1 + S2 - 2 sqrtm(S1 S2)), with tr(sqrtm(S1 S2))
    taken symmetrically as the root eigenvalues of sqrtm(S1) S2 sqrtm(S1)
    (each S + eps I, as pytorch-fid's)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1 = np.asarray(sigma1, np.float64) + eps * np.eye(mu1.shape[0])
    s2 = np.asarray(sigma2, np.float64) + eps * np.eye(mu2.shape[0])
    s1h = _sqrtm_psd(s1)
    tr_covmean = np.sum(np.sqrt(np.clip(
        np.linalg.eigvalsh((s1h @ s2 @ s1h + (s1h @ s2 @ s1h).T) / 2.0),
        0.0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean)


def fid(features_a, features_b) -> float:
    """Fréchet distance between two [N, D] feature sets."""
    fa, fb = np.asarray(features_a), np.asarray(features_b)
    sa, sb = FeatureStats(fa.shape[1]), FeatureStats(fb.shape[1])
    sa.update(fa)
    sb.update(fb)
    return frechet_distance(*sa.finalize(), *sb.finalize())


def dists(vgg_params, a: torch.Tensor, b: torch.Tensor,
          weights: Optional[Tuple[Sequence, Sequence]] = None) -> torch.Tensor:
    """DISTS distance (arXiv:2004.07728) between image batches [B, 3, H, W]
    in [0, 1]: -> [B], 0 for identical images.

    Features: the input and the 5 VGG16 relu stages under L2 pooling. Per
    channel a texture term (means) and a structure term (covariance) over
    the spatial map. ``weights=(alpha_list, beta_list)``, one [C_j] tensor
    per feature stage, are the learned weights, divided by their joint sum
    as the official DISTS does; without them every channel weighs
    1 / (2 C_total)."""
    from unigen_tpu_torch.models.vgg import vgg16_stages
    c1 = c2 = 1e-6
    feats_a: List[torch.Tensor] = [a] + vgg16_stages(vgg_params, a, pool="l2")
    feats_b: List[torch.Tensor] = [b] + vgg16_stages(vgg_params, b, pool="l2")
    n_ch = sum(int(f.shape[1]) for f in feats_a)
    if weights is not None:
        alphas = [torch.as_tensor(w, dtype=torch.float32, device=a.device) for w in weights[0]]
        betas = [torch.as_tensor(w, dtype=torch.float32, device=a.device) for w in weights[1]]
        w_sum = sum(w.sum() for w in alphas) + sum(w.sum() for w in betas)
    score = torch.zeros((a.shape[0],), dtype=torch.float32, device=a.device)
    for j, (fa, fb) in enumerate(zip(feats_a, feats_b)):
        mu_a = fa.mean(dim=(2, 3))
        mu_b = fb.mean(dim=(2, 3))
        var_a = fa.var(dim=(2, 3), unbiased=False)
        var_b = fb.var(dim=(2, 3), unbiased=False)
        cov = (fa * fb).mean(dim=(2, 3)) - mu_a * mu_b
        texture = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
        structure = (2 * cov + c2) / (var_a + var_b + c2)
        if weights is None:
            alpha = beta = 1.0 / (2.0 * n_ch)
            score = score + alpha * texture.sum(dim=1) + beta * structure.sum(dim=1)
        else:
            score = score + (alphas[j] / w_sum * texture).sum(dim=1) \
                + (betas[j] / w_sum * structure).sum(dim=1)
    return 1.0 - score
