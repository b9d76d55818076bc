"""The evaluation metrics and the VGG16 tower of the port
(``unigen_tpu_torch/eval.py``, ``models/vgg.py``) against the JAX package
on the CPU, with the same numpy inputs: SSIM / PSNR / MAE (down to 1-2 px
and 7 px images, where the window is clamped), the float64 Fréchet
statistics, the VGG16 stages under both pools, DISTS (uniform weights
alike; learned weights normalised by their sum in the port, applied raw
by JAX), the torchvision state-dict bridge and the VGG tree carried by
``from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_close, to_jax_tree
from unigen_tpu import eval as j_eval
from unigen_tpu.models import vgg as j_vgg
from unigen_tpu_torch import eval as t_eval
from unigen_tpu_torch.io.from_jax import tree_from_numpy
from unigen_tpu_torch.models import vgg as t_vgg


@pytest.fixture(scope="module")
def vgg_tree():
    """The port's random VGG16 tree (CPU generator) and the same leaves for
    JAX."""
    params = t_vgg.init_vgg16_params(torch.Generator().manual_seed(0))
    return params, to_jax_tree(params)


def _uint8_pair(rng, shape):
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-40, 40, shape), 0, 255).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 2, 3), (2, 5, 3), (7, 7, 3), (7, 9, 1),
                                   (2, 33, 40, 3)])
def test_image_metrics_match_jax(shape):
    """SSIM (clamped odd window below 11 px, the 1-px luminance case), PSNR
    and MAE of random uint8 pairs: 1e-5."""
    a, b = _uint8_pair(np.random.default_rng(len(shape) * 100 + shape[-2]), shape)
    got = t_eval.image_metrics(a, b, device="cpu")
    want = j_eval.image_metrics(a, b)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert np.isfinite(got["ssim"])
    x = np.random.default_rng(1).random((2, 3, 16, 16)).astype(np.float32) * 255
    y = np.random.default_rng(2).random((2, 3, 16, 16)).astype(np.float32) * 255
    for kw in ({}, {"data_range": 1.0, "win_size": 7, "sigma": 1.0}):
        assert_close(t_eval.ssim(torch.from_numpy(x), torch.from_numpy(y), **kw),
                     j_eval.ssim(jnp.asarray(x), jnp.asarray(y), **kw), 1e-5)
    assert_close(t_eval.psnr(torch.from_numpy(x), torch.from_numpy(y), data_range=1.0),
                 j_eval.psnr(jnp.asarray(x), jnp.asarray(y), data_range=1.0), 1e-5)


def test_frechet_statistics_match_jax():
    """FeatureStats streamed over uneven batches, frechet_distance and fid:
    1e-9 relative (host float64 on both sides)."""
    rng = np.random.default_rng(3)
    fa = rng.normal(size=(40, 24)) @ rng.normal(size=(24, 24))
    fb = rng.normal(size=(33, 24)) * 1.5 + 0.3
    ts, js = t_eval.FeatureStats(24), j_eval.FeatureStats(24)
    for lo, hi in ((0, 7), (7, 8), (8, 40)):
        ts.update(fa[lo:hi].astype(np.float32))
        js.update(fa[lo:hi].astype(np.float32))
    assert ts.n == js.n == 40
    for got, want in zip(ts.finalize(), js.finalize()):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    mu, sig = js.finalize()
    mu2, sig2 = np.cov(fb, rowvar=False).mean(0), np.cov(fb, rowvar=False)
    np.testing.assert_allclose(t_eval.frechet_distance(mu, sig, mu2, sig2),
                               j_eval.frechet_distance(mu, sig, mu2, sig2), rtol=1e-9)
    np.testing.assert_allclose(t_eval.fid(fa, fb), j_eval.fid(fa, fb), rtol=1e-9)
    # rank-deficient sets (fewer samples than dims), as a 4-image FID gives
    np.testing.assert_allclose(t_eval.fid(fa[:4], fb[:4]), j_eval.fid(fa[:4], fb[:4]),
                               rtol=1e-9)
    with pytest.raises(ValueError, match="2 samples"):
        t_eval.FeatureStats(3).finalize()
    with pytest.raises(ValueError, match="shape"):
        t_eval.FeatureStats(3).update(np.zeros((2, 4)))


def test_vgg16_stages_and_fid_features_match_jax(vgg_tree):
    """The five relu stages under the max and the Hanning L2 pool, and the
    FD-VGG features, at 64x64 (and an odd 40x52 for the L2 pool's padding):
    1e-5 of each stage's scale."""
    t_params, j_params = vgg_tree
    for shape in ((2, 3, 64, 64), (1, 3, 40, 52)):
        px = np.random.default_rng(4).random(shape).astype(np.float32)
        for pool in ("max", "l2"):
            got = t_vgg.vgg16_stages(t_params, torch.from_numpy(px), pool=pool)
            want = j_vgg.vgg16_stages(j_params, jnp.asarray(px), pool=pool)
            assert len(got) == len(want) == 5
            for g, w in zip(got, want):
                w = np.asarray(w)
                assert tuple(g.shape) == w.shape
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                           atol=1e-5 * max(1.0, float(np.abs(w).max())))
        assert_close(t_vgg.vgg16_fid_features(t_params, torch.from_numpy(px)),
                     j_vgg.vgg16_fid_features(j_params, jnp.asarray(px)), 1e-5)
    with pytest.raises(ValueError, match="pool"):
        t_vgg.vgg16_stages(t_params, torch.zeros(1, 3, 32, 32), pool="avg")


def test_dists_uniform_and_learned_weights_against_jax(vgg_tree):
    """Uniform weights: the port equals JAX (1e-5). Learned weights: the port
    divides alpha and beta by their joint sum (the official DISTS), so it
    equals JAX fed the normalised weights and differs from JAX fed the raw
    ones, which is JAX's unnormalised application."""
    t_params, j_params = vgg_tree
    rng = np.random.default_rng(5)
    a = rng.random((2, 3, 48, 48)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    got = t_eval.dists(t_params, ta, tb)
    assert_close(got, j_eval.dists(j_params, ja, jb), 1e-5)
    assert float(t_eval.dists(t_params, ta, ta).abs().max()) < 1e-5
    assert 0 < float(got.min()) and float(got.max()) < 1

    chans = [3, 64, 128, 256, 512, 512]
    alpha = [rng.random(c).astype(np.float32) * 0.1 for c in chans]
    beta = [rng.random(c).astype(np.float32) * 0.1 for c in chans]
    total = sum(float(x.sum(dtype=np.float64)) for x in alpha + beta)
    learned = t_eval.dists(t_params, ta, tb, weights=(alpha, beta))
    normed = j_eval.dists(j_params, ja, jb, weights=([jnp.asarray(x / total) for x in alpha],
                                                     [jnp.asarray(x / total) for x in beta]))
    raw = j_eval.dists(j_params, ja, jb, weights=([jnp.asarray(x) for x in alpha],
                                                  [jnp.asarray(x) for x in beta]))
    assert_close(learned, normed, 1e-5)
    assert np.abs(learned.numpy() - np.asarray(raw)).min() > 1e-2
    assert float(learned.min()) > 0 and float(np.asarray(raw).max()) < 0  # raw sums past 1


def _torchvision_features(rng):
    """A torchvision-layout ``vgg16().features`` state dict (the pools and
    relus take index slots), random."""
    sd, idx, c_in = {}, 0, 3
    for c in t_vgg.VGG16_CFG:
        if c == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.normal(size=(c, c_in, 3, 3)) * np.sqrt(2 / (9 * c_in))).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.normal(size=(c,)) * 0.01).astype(np.float32))
        c_in, idx = c, idx + 2
    return sd


def test_load_vgg16_features_and_from_jax_match_jax():
    """The torchvision bridge gives JAX's list leaf for leaf, refuses a wrong
    shape, and JAX's tree crosses through ``from_jax`` bit for bit."""
    sd = _torchvision_features(np.random.default_rng(6))
    got = t_vgg.load_vgg16_features(sd, device="cpu")
    want = j_vgg.load_vgg16_features({k: v.numpy() for k, v in sd.items()})
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    bad = dict(sd, **{"features.2.weight": torch.zeros(64, 64, 1, 1)})
    with pytest.raises(ValueError, match="features.2"):
        t_vgg.load_vgg16_features(bad, device="cpu")
    carried = tree_from_numpy(jax.tree.map(np.asarray, want), device="cpu")
    assert isinstance(carried, list) and len(carried) == 13
    for g, w in zip(carried, got):
        assert torch.equal(g["w"], w["w"]) and torch.equal(g["b"], w["b"])
