"""``cli.measure_fidelity``'s cache flags on the CPU: each runs its
denoise and decode, and the quantized path's images are within one code of
the port's own pipeline denoise (``UniGenFluxPipeline.denoise`` /
``UniGenSD3Pipeline.denoise``) in the same cache mode, on the same tree,
batch and VAE (below the quantizers' ``min_dim`` the quantized path is the
bf16 tree under the cache); the SD3 and SANA JSON lines carry the JAX
script's keys in its order; SD3's ``w4a8`` tree is the JAX script's
construction leaf for leaf."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from tests.test_torch_port_loading import sd3_root  # noqa: F401
from tests.torch_port_helpers import to_jax_tree, to_torch_tree
from unigen_tpu_torch.cli import measure_fidelity as mf
from unigen_tpu_torch.models import vae as vae_lib
from unigen_tpu_torch.pipelines import caching


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _tree(cfg, init):
    """A bf16 tree with live gates (the quantizers leave tiny trees as they
    are, so the quantized paths are this tree under the cache flags)."""
    t = init(cfg, gen=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    return mf.liven_gates(t, torch.Generator().manual_seed(77))


@pytest.mark.parametrize("flags,knobs", [
    (["--cache-interval", "2"], dict(control_cache_interval=2)),
    (["--cache-threshold", "0.3"], dict(control_cache_threshold=0.3)),
    (["--cache-interval", "2", "--model-cache", "--model-cache-order", "1"],
     dict(model_cache_interval=2, model_cache_order=1)),
    (["--cache-interval", "4", "--hybrid-model-interval", "2"],
     dict(control_cache_interval=4, model_cache_interval=2))])
def test_flux_cache_flags_match_the_pipeline(fake_ckpt, flags, knobs):  # noqa: F811
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params, unigen_flux_forward
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
    from unigen_tpu_torch.pipelines import scheduling
    args = mf.parse_args(["--ckpt", fake_ckpt, "--res", "32", "--ssim", "--device", "cpu"]
                         + flags)
    cfg = mf.flux_config(args)
    tree = _tree(cfg, init_unigen_flux_params)
    vcfg = vae_lib.tiny_vae_config(latent_channels=cfg.flux.in_channels // 4)
    vae = vae_lib.init_vae_params(vcfg, gen=torch.Generator().manual_seed(2))
    res = mf.main(["--ckpt", fake_ckpt, "--res", "32", "--ssim", "--device", "cpu"] + flags,
                  init_fn=lambda: copy.deepcopy(tree), vae_params=vae)
    batch = mf.setup_for(args, init_fn=lambda: tree, vae_params=vae).batch
    x = {k: torch.from_numpy(v).to(torch.bfloat16 if k in mf.FLUX_KEYS else torch.float32)
         for k, v in batch.items()}
    sig = scheduling.inference_sigmas(scheduling.FlowMatchConfig(shift=1.0), 4)[0]

    def fwd(lat, i, enc, pooled, **kw):
        pred, _, outs = unigen_flux_forward(
            tree, cfg, lat, x["condition"], enc, pooled, x["condition_pooled"],
            torch.full((1,), float(sig[i]), dtype=torch.bfloat16), x["img_ids"],
            x["txt_ids"], x["condition_ids"], **kw)
        return pred, outs
    pipe = UniGenFluxPipeline(cfg=cfg, params=tree, vae_cfg=vcfg, vae_params=vae,
                              device="cpu")
    with torch.no_grad():
        lat = pipe.denoise(caching.resolve_cache_mode(4, **knobs), x["hidden"], fwd,
                           [(x["encoder"], x["pooled"])], sig, 4, 1.0)
        want = pipe.decode(lat, 4, 4).numpy()
    got = res["host"]["w8a8"]["img"]
    assert got.shape == want.shape == (1, 8, 8, 3)      # 4x4 latents, the VAE's 2x
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert not np.array_equal(got, res["host"]["bf16"]["img"])   # the cache replayed


def test_sd3_cfg_cache_matches_the_pipeline(sd3_root):  # noqa: F811
    """--family sd3 --cfg-cache --cache-interval 2: the quantized path's
    images within one code of UniGenSD3Pipeline.denoise in the same mode
    (28 CFG steps at guidance 7), and the JSON carries the JAX script's keys
    in its order."""
    from unigen_tpu_torch.models.unigen_sd3 import init_unigen_sd3_params, unigen_sd3_forward
    from unigen_tpu_torch.pipelines import scheduling
    from unigen_tpu_torch.pipelines.sd3 import UniGenSD3Pipeline
    argv = ["--family", "sd3", "--ckpt", sd3_root, "--res", "32", "--ssim",
            "--cache-interval", "2", "--cfg-cache", "--device", "cpu"]
    args = mf.parse_args(argv)
    setup = mf.setup_for(args, init_fn=lambda: None, vae_params={})
    cfg = setup.cfg
    tree = _tree(cfg, init_unigen_sd3_params)
    vcfg = vae_lib.tiny_vae_config(latent_channels=cfg.sd3.in_channels)
    vae = vae_lib.init_vae_params(vcfg, gen=torch.Generator().manual_seed(2))
    res = mf.main(argv, init_fn=lambda: copy.deepcopy(tree), vae_params=vae)
    assert list(res["json"]) == ["family", "topology", "weights", "control_gates", "res",
                                 "cache_interval", "cfg_cache", "w8a8", "w4a8", "e2e"]
    assert res["json"]["e2e"] == "28-step CFG denoise + VAE decode @ 32px"
    x = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in setup.batch.items()}
    sig = scheduling.inference_sigmas(scheduling.FlowMatchConfig(shift=3.0), 28)[0]

    def t(i, n):
        return torch.full((n,), float(sig[i] * 1000.0), dtype=torch.bfloat16)

    def fwd(lat, i, **kw):
        pred, _, outs = unigen_sd3_forward(tree, cfg, torch.cat([lat, lat]),
                                           torch.cat([x["condition"]] * 2), x["encoder"],
                                           x["pooled"], x["condition_pooled"], t(i, 2), **kw)
        return pred, outs

    def fwd_pos(lat, i, residuals):
        return unigen_sd3_forward(tree, cfg, lat, x["condition"], x["encoder"][1:],
                                  x["pooled"][1:], x["condition_pooled"][1:], t(i, 1),
                                  control_residuals=residuals)[0]
    pipe = UniGenSD3Pipeline(cfg=cfg, params=tree, vae_cfg=vcfg, vae_params=vae,
                             device="cpu")
    mode = caching.resolve_cache_mode(28, control_cache_interval=2, cfg_cache=True,
                                      family="sd3")
    with torch.no_grad():
        want = pipe.decode(pipe.denoise(mode, x["hidden"], fwd, fwd_pos, sig, 28,
                                        7.0)).numpy()
    got = res["host"]["w4a8"]["img"]
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_sana_json_keys(tmp_path):
    """--family sana --ckpt on a tiny directory: the JAX script's keys in its
    order, its 256 -> 512 resolution quirk and its SSIM line."""
    from unigen_tpu import config as j_config
    from tests.test_cli_smoke import _write_transformer_dir
    from tests.test_sd3_bridge_pipeline import _sana_state_dict
    cfg = j_config.tiny_sana_config()
    _write_transformer_dir(str(tmp_path), _sana_state_dict(cfg), {
        "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
        "num_layers": cfg.num_layers, "attention_head_dim": cfg.attention_head_dim,
        "num_attention_heads": cfg.num_attention_heads,
        "num_cross_attention_heads": cfg.num_cross_attention_heads,
        "cross_attention_head_dim": cfg.cross_attention_head_dim,
        "cross_attention_dim": cfg.cross_attention_dim,
        "caption_channels": cfg.caption_channels, "mlp_ratio": cfg.mlp_ratio,
        "patch_size": cfg.patch_size, "sample_size": cfg.sample_size})
    rep = mf.main(["--family", "sana", "--ckpt", str(tmp_path), "--ssim", "--device",
                   "cpu", "--cache-interval", "4", "--model-cache"])["json"]
    assert list(rep) == ["family", "topology", "weights", "res", "control_gates", "w8a8",
                         "cache_interval", "model_cache", "e2e"]
    assert rep["res"] == 512 and rep["weights"] == "real-ckpt"
    assert rep["topology"] == f"sana_{cfg.num_layers}blk_w{cfg.inner_dim}"
    assert rep["e2e"] == "20-step denoise + VAE decode @ 512px"
    assert set(rep["w8a8"]) == {"rel_err", "cosine", "e2e_ssim", "e2e_psnr"}


def test_sd3_w4a8_tree_is_the_jax_scripts(monkeypatch):
    """SD3's ``w4a8`` path: an int4 base and an int8 adapter, leaf for leaf
    the JAX script's construction (its ``quantize_tree_streaming`` of each
    half) on the same tree, with the quantization gate at 16 in both
    packages so that the tiny linears are quantized."""
    import functools

    import unigen_tpu.ops.quant as j_quant
    from unigen_tpu_torch import config as tcfg
    from unigen_tpu_torch import presets as tpresets
    from unigen_tpu_torch.models.unigen_sd3 import init_unigen_sd3_params
    from unigen_tpu_torch.ops import quant as t_quant
    from unigen_tpu_torch.utils import tree_leaves_with_path, tree_map
    for mod in (j_quant, t_quant):
        monkeypatch.setattr(mod, "quantize_tree_streaming", functools.partial(
            mod.quantize_tree_streaming, min_dim=16))
    monkeypatch.setattr(tpresets, "sd35_medium", lambda: tcfg.UniGenConfig(
        family="sd3", sd3=tcfg.tiny_sd3_config(), control=tcfg.ControlConfig(use_rope=False),
        condition_types=("depth",)))
    args = mf.parse_args(["--family", "sd3", "--device", "cpu"])
    setup = mf.setup_for(args, init_fn=None, batch={}, vae_params={})
    tree32 = init_unigen_sd3_params(setup.cfg, gen=torch.Generator().manual_seed(0))
    tree = tree_map(lambda t: t.to(torch.bfloat16), tree32)
    setup = mf.setup_for(args, init_fn=lambda: copy.deepcopy(tree), batch={}, vae_params={})

    def j_tree():          # fresh: the JAX walk deletes what it quantized
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16), to_jax_tree(tree32))
    want = {"base": j_quant.quantize_tree_streaming(j_tree()["base"], bits=4),
            "control": j_quant.quantize_tree_streaming(j_tree()["control"], bits=8)}
    got = dict(tree_leaves_with_path(setup.make_params("w4a8")))
    j_got = dict(tree_leaves_with_path(to_torch_tree(want)))
    assert got.keys() == j_got.keys()
    # int4 codes in the base, int8 in the adapter, and nothing the other way
    assert {p[0] for p in got if p[-1] == "w_q4"} == {"base"}
    assert {p[0] for p in got if p[-1] == "w_q"} == {"control"}
    for p in got:
        assert got[p].dtype == j_got[p].dtype, p
        assert torch.equal(got[p], j_got[p]), p
