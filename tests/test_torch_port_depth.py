"""Depth-Anything in the port (``unigen_tpu_torch/models/depth.py``,
``io/torch_bridge.load_depth_anything``, ``data/conditions.make_depth_fn``)
against the JAX package on the CPU: the gather-weight bilinear resize in
both corner conventions (up and down), the exact transposed convolution,
``depth_forward`` and ``dinov2_features`` on the native grid and off it
(the position embedding resized bilinearly, as JAX does), the loader leaf
for leaf on a tiny transformers-layout state dict with its strict audit,
the tree carried by ``from_jax``, and the depth condition in uint8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import assert_close
from unigen_tpu.data import conditions as j_cond
from unigen_tpu.io.torch_bridge import load_depth_anything as j_load
from unigen_tpu.models import depth as j_depth
from unigen_tpu_torch.data import conditions as t_cond
from unigen_tpu_torch.io import torch_bridge as t_tb
from unigen_tpu_torch.io.from_jax import tree_from_numpy
from unigen_tpu_torch.models import depth as t_depth
from unigen_tpu_torch.utils import tree_leaves_with_path

CFG_T, CFG_J = t_depth.tiny_depth_config(), j_depth.tiny_depth_config()


def depth_state_dict(cfg, rng, *, native_grid=4, scale=1.0):
    """A transformers DepthAnythingForDepthEstimation state dict of ``cfg``'s
    sizes (the key layout of ``tests/test_depth_model.py``'s tiny model),
    drawn with numpy: weights N(0, 1/fan_in), norms near 1, layer scales
    near 1, so that the depth map is O(1) rather than the 1e-7 of
    transformers' own init."""
    d, f = cfg.hidden_size, cfg.fusion_hidden_size
    sd = {}

    def w(name, *shape, fan=None):
        fan = fan or int(np.prod(shape[1:])) or 1
        sd[name] = (rng.normal(size=shape) * scale / np.sqrt(fan)).astype(np.float32)

    def lin(name, i, o):
        w(f"{name}.weight", o, i)
        sd[f"{name}.bias"] = (rng.normal(size=o) * 0.02).astype(np.float32)

    def ln(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)

    def conv(name, o, i, k, bias=True):
        w(f"{name}.weight", o, i, k, k)
        if bias:
            sd[f"{name}.bias"] = (rng.normal(size=o) * 0.02).astype(np.float32)

    e = "backbone.embeddings"
    sd[f"{e}.cls_token"] = rng.normal(size=(1, 1, d)).astype(np.float32)
    sd[f"{e}.mask_token"] = np.zeros((1, d), np.float32)
    sd[f"{e}.position_embeddings"] = (rng.normal(size=(1, 1 + native_grid ** 2, d))
                                      ).astype(np.float32)
    conv(f"{e}.patch_embeddings.projection", d, 3, cfg.patch_size)
    for i in range(cfg.num_layers):
        p = f"backbone.encoder.layer.{i}"
        ln(f"{p}.norm1", d)
        ln(f"{p}.norm2", d)
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.attention.{n}", d, d)
        lin(f"{p}.attention.output.dense", d, d)
        lin(f"{p}.mlp.fc1", d, cfg.mlp_ratio * d)
        lin(f"{p}.mlp.fc2", cfg.mlp_ratio * d, d)
        sd[f"{p}.layer_scale1.lambda1"] = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
        sd[f"{p}.layer_scale2.lambda1"] = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    ln("backbone.layernorm", d)
    for i, (c, factor) in enumerate(zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)):
        p = f"neck.reassemble_stage.layers.{i}"
        conv(f"{p}.projection", c, d, 1)
        if factor > 1:
            k = int(factor)
            sd[f"{p}.resize.weight"] = (rng.normal(size=(c, c, k, k)) / np.sqrt(c)
                                        ).astype(np.float32)
            sd[f"{p}.resize.bias"] = (rng.normal(size=c) * 0.02).astype(np.float32)
        elif factor < 1:
            conv(f"{p}.resize", c, c, 3)
        conv(f"neck.convs.{i}", f, c, 3, bias=False)
    for i in range(len(cfg.neck_hidden_sizes)):
        p = f"neck.fusion_stage.layers.{i}"
        conv(f"{p}.projection", f, f, 1)
        for r in ("residual_layer1", "residual_layer2"):
            conv(f"{p}.{r}.convolution1", f, f, 3)
            conv(f"{p}.{r}.convolution2", f, f, 3)
    h = cfg.head_hidden_size
    conv("head.conv1", f // 2, f, 3)
    conv("head.conv2", h, f // 2, 3)
    conv("head.conv3", 1, h, 1)
    sd["head.conv3.bias"] = np.full((1,), 0.5, np.float32)
    return sd


@pytest.fixture(scope="module")
def trees():
    sd = depth_state_dict(CFG_T, np.random.default_rng(0))
    t = t_tb.load_depth_anything({k: torch.from_numpy(v) for k, v in sd.items()}, CFG_T,
                                 device="cpu")
    return sd, t, j_load(sd, CFG_J)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(13, 5), (14, 18), (3, 4), (1, 6), (7, 9)])
def test_interpolate_bilinear_matches_jax(align_corners, size):
    """Up, down, to one row, and the identity, in both conventions: the
    port's gather weights give JAX's values (1e-6), which are torch's
    F.interpolate's up to rounding."""
    x = np.random.default_rng(1).normal(size=(2, 3, 7, 9)).astype(np.float32)
    got = t_depth.interpolate_bilinear(torch.from_numpy(x), size, align_corners=align_corners)
    want = j_depth.interpolate_bilinear(jnp.asarray(x), size, align_corners=align_corners)
    assert tuple(got.shape) == np.asarray(want).shape == (2, 3) + size
    assert_close(got, want, 1e-6)
    if size[0] > 1:
        ref = torch.nn.functional.interpolate(torch.from_numpy(x), size=size, mode="bilinear",
                                              align_corners=align_corners)
        assert_close(got, ref, 1e-5)


def test_conv_transpose_exact_and_conv2d_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 5, 7)).astype(np.float32)
    for f in (2, 4):
        p = {"w": rng.normal(size=(6, 3, f, f)).astype(np.float32),
             "b": rng.normal(size=3).astype(np.float32)}
        got = t_depth.conv_transpose_exact({k: torch.from_numpy(v) for k, v in p.items()},
                                           torch.from_numpy(x), f)
        want = j_depth.conv_transpose_exact({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), f)
        assert_close(got, want, 1e-5)
        ref = torch.nn.functional.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(p["w"]),
                                                   torch.from_numpy(p["b"]), stride=f)
        assert_close(got, ref, 1e-5)
    p = {"w": rng.normal(size=(4, 6, 3, 3)).astype(np.float32)}
    assert_close(t_depth.conv2d({"w": torch.from_numpy(p["w"])}, torch.from_numpy(x),
                                stride=2, padding=1),
                 j_depth.conv2d({"w": jnp.asarray(p["w"])}, jnp.asarray(x), stride=2,
                                padding=1), 1e-5)


def test_load_depth_anything_matches_jax_leaf_for_leaf(trees):
    """The port's loader gives JAX's tree (the convs OIHW, the linears
    [in, out], the ConvTranspose [in, out, f, f]) leaf for leaf and bit for
    bit; JAX's tree crosses through ``from_jax`` to the same bits; the
    strict audit refuses a key that maps to nothing."""
    sd, t, j = trees
    want = dict(tree_leaves_with_path(tree_from_numpy(jax.tree.map(np.asarray, j),
                                                      device="cpu")))
    got = dict(tree_leaves_with_path(t))
    assert got.keys() == want.keys() and len(got) > 100
    for path, leaf in got.items():
        assert leaf.dtype == want[path].dtype and torch.equal(leaf, want[path]), path
    extra = {k: torch.from_numpy(v) for k, v in sd.items()}
    extra["neck.convs.0.bias"] = torch.zeros(CFG_T.fusion_hidden_size)
    with pytest.raises(ValueError, match="neck.convs.0.bias"):
        t_tb.load_depth_anything(extra, CFG_T, device="cpu")
    half = t_tb.load_depth_anything(extra, CFG_T, dtype=torch.bfloat16, strict=False,
                                    device="cpu")
    assert half["backbone"]["pos_embed"].dtype == torch.bfloat16


def test_transformers_layout_loads_in_both(trees):
    """transformers' own tiny DepthAnythingForDepthEstimation (the model of
    ``tests/test_depth_model.py``) loads in both packages to the same
    leaves, its mask token being the one key the forward never reads."""
    from tests.test_depth_model import _tiny_hf_model
    sd = dict(_tiny_hf_model().state_dict())
    got = dict(tree_leaves_with_path(t_tb.load_depth_anything(sd, CFG_T, device="cpu")))
    j = j_load({k: v.numpy() for k, v in sd.items()}, CFG_J)
    want = dict(tree_leaves_with_path(tree_from_numpy(jax.tree.map(np.asarray, j),
                                                      device="cpu")))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[p], want[p]) for p in got)


@pytest.mark.parametrize("hw", [(56, 56), (70, 84)])
def test_depth_forward_and_dinov2_features_match_jax(trees, hw):
    """On the native 4x4 grid and on 5x6 (the position embedding resized),
    batch 2: depth within 1e-5 of its scale, the CLS features within 1e-5."""
    _, t, j = trees
    px = np.random.default_rng(3).normal(size=(2, 3) + hw).astype(np.float32)
    got = t_depth.depth_forward(t, CFG_T, torch.from_numpy(px))
    want = np.asarray(jax.jit(lambda p, x: j_depth.depth_forward(p, CFG_J, x))(
        j, jnp.asarray(px)))
    assert tuple(got.shape) == want.shape == (2,) + hw
    assert float(np.abs(want).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    f = t_depth.dinov2_features(t, CFG_T, torch.from_numpy(px))
    assert tuple(f.shape) == (2, CFG_T.hidden_size)
    assert_close(f, jax.jit(lambda p, x: j_depth.dinov2_features(p, CFG_J, x))(
        j, jnp.asarray(px)), 1e-5)
    assert_close(t_depth.depth_to_condition_image(got),
                 j_depth.depth_to_condition_image(jnp.asarray(want)), 1e-3)


def test_make_depth_fn_matches_jax(trees):
    """The depth condition of a 60x80 and a 28x28 uint8 image (resized to
    multiples of 14 with Pillow and back): uint8 within one code of JAX's,
    its own size, not constant."""
    _, t, j = trees
    fn_t, fn_j = t_cond.make_depth_fn(t, CFG_T), j_cond.make_depth_fn(j, CFG_J)
    rng = np.random.default_rng(4)
    for shape in ((60, 80, 3), (28, 28, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        got = t_cond.synthesize("depth", img, depth_fn=fn_t)
        want = fn_j(img)
        assert got.shape == want.shape == shape and got.dtype == np.uint8
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
        assert got.std() > 0
