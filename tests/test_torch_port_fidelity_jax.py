"""``cli.measure_fidelity --ckpt --ssim`` for SD3 and SANA against
``scripts/measure_fidelity.py``'s ``main`` on the same tiny directory, run
in process (``run_both``/``held``, which the FLUX case in
``tests/test_torch_port_fidelity.py`` shares). The port is handed the JAX
script's own batch and tiny VAE (its ``jax.random`` draws from keys 1 and
2, remade here), so both denoise the same inputs with the same weights.
Below the quantizers' ``min_dim`` of 512 every quantized path is the bf16
tree, so the images differ through the cache flag alone: SD3 under
``--cache-interval 2 --cfg-cache`` (the CFG pair, the timesteps, the
positive stream replaying its half of the residual cache with the cached
guidance delta), SANA under the first-order full-model cache. SD3's
``w4a8`` tree (an int4 base, an int8 adapter) is held leaf for leaf against
the JAX script's construction with the quantization gate lowered."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_fidelity import _jax_script
from tests.test_torch_port_loading import sd3_root  # noqa: F401
from tests.torch_port_helpers import to_jax_tree, to_torch_tree
from unigen_tpu_torch.cli import measure_fidelity as mf


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_inputs(args):
    """The JAX script's batch (its bf16 ``jax.random`` draws from the keys
    split from PRNGKey(1), as float32 numpy, at the port's shapes; the
    position ids are the port's) and its tiny VAE (PRNGKey(2)) as the
    port's tree."""
    from unigen_tpu.models import vae as j_vae
    setup = mf.setup_for(args, init_fn=lambda: None, vae_params={})
    bb = getattr(setup.cfg, args.family)
    ks = jax.random.split(jax.random.PRNGKey(1), 6)
    batch = dict(setup.batch)
    for name, key in zip(mf.FLUX_KEYS, ks):
        batch[name] = np.asarray(jax.random.normal(key, batch[name].shape, jnp.bfloat16)
                                 .astype(jnp.float32))
    channels = bb.in_channels // 4 if args.family == "flux" else bb.in_channels
    vae = j_vae.init_vae_params(jax.random.PRNGKey(2),
                                j_vae.tiny_vae_config(latent_channels=channels))
    return batch, to_torch_tree(jax.tree.map(lambda x: np.asarray(x, np.float32), vae))


def run_both(argv, tmp_path, capsys, monkeypatch):
    """The JAX script's ``main`` and the port's on ``argv`` (--out in
    ``tmp_path``), the port handed the JAX script's batch and VAE; JAX's
    ``image_metrics`` records the images it measures. -> (the port's result,
    the JAX script's JSON line, [(bf16 image, path image)] per quantized
    path as the JAX script measured them)."""
    import unigen_tpu.eval as j_eval
    pairs, metrics = [], j_eval.image_metrics

    def recorded(ref, img, *a, **kw):
        pairs.append((np.asarray(ref), np.asarray(img)))
        return metrics(ref, img, *a, **kw)
    monkeypatch.setattr(j_eval, "image_metrics", recorded)
    batch, vae = _jax_inputs(mf.parse_args(argv + ["--device", "cpu"]))
    _jax_script().main(argv + ["--out", str(tmp_path / "jax.json")])
    jax_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    port = mf.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"],
                   batch=batch, vae_params=vae)
    capsys.readouterr()
    assert json.loads((tmp_path / "port.json").read_text()) == port["json"]
    return port, jax_line, pairs


def held(port, jax_line, pairs, codes):
    """The port's JSON against the JAX script's: the same keys in the same
    order, every string and every forward number (``rel_err``, ``cosine``)
    equal; each path's images (bf16 and quantized) within ``codes`` of the
    JAX script's; the SSIM/PSNR of the JAX script's images, measured and
    rounded as the port reports them, equal to the JAX script's (the port's
    own read its own images, which differ by those codes). A cached path
    must move its images off the exact path's."""
    from unigen_tpu_torch.eval import image_metrics
    got = port["json"]
    assert list(got) == list(jax_line)
    quantized = [p for p in port["host"] if p != "bf16"]
    assert [k for k in jax_line if isinstance(jax_line[k], dict)] == quantized
    for key, want in jax_line.items():
        if key not in quantized:
            assert got[key] == want, key
            continue
        assert list(got[key]) == list(want), key
        for k in ("rel_err", "cosine"):
            assert got[key][k] == want[k], (key, k)
    assert len(pairs) == len(quantized)
    for path, (ref, img) in zip(quantized, pairs):
        for name, want in (("bf16", ref), (path, img)):
            mine = port["host"][name]["img"]
            assert mine.shape == want.shape
            assert np.abs(mine.astype(int) - want.astype(int)).max() <= codes, name
        m = image_metrics(ref, img, device="cpu")
        assert round(m["ssim"], 5) == jax_line[path]["e2e_ssim"]
        assert round(m["psnr"], 2) == jax_line[path]["e2e_psnr"]
        assert jax_line[path]["e2e_ssim"] < 1.0 and got[path]["e2e_ssim"] < 1.0


def test_sd3_ckpt_cfg_cache_json_equals_jax_script(sd3_root, tmp_path, capsys,  # noqa: F811
                                                   monkeypatch):
    """--family sd3 --ckpt --adapter --ssim --cache-interval 2 --cfg-cache on
    the tiny SD3 root against the JAX script (``held``): 28 bf16 CFG steps
    in two frameworks leave up to three codes between the images; a
    timestep left in sigma units or a guidance of 5 moves them further. At
    this size the cache's own effect (about 3% of what the denoise adds to
    the noise) is no larger than that difference, so the replay itself is
    held by the pipeline tests: the CLI runs UniGenSD3Pipeline.denoise."""
    argv = ["--family", "sd3", "--ckpt", sd3_root, "--adapter",
            str(pathlib.Path(sd3_root) / "adapter"), "--res", "32", "--ssim",
            "--cache-interval", "2", "--cfg-cache"]
    held(*run_both(argv, tmp_path, capsys, monkeypatch), codes=3)


def test_sana_ckpt_model_cache_json_equals_jax_script(tmp_path, capsys, monkeypatch):
    """--family sana --ckpt --ssim --cache-interval 2 --model-cache
    --model-cache-order 1 on a tiny SANA directory against the JAX script
    (``held``; 20 bf16 steps: within three codes)."""
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
    argv = ["--family", "sana", "--ckpt", str(tmp_path), "--res", "128", "--ssim",
            "--cache-interval", "2", "--model-cache", "--model-cache-order", "1"]
    held(*run_both(argv, tmp_path, capsys, monkeypatch), codes=3)
