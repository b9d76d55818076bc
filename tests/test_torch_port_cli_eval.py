"""The port's evaluation entry point (``python -m unigen_tpu_torch.cli.eval``)
on the CPU: SSIM / PSNR / MAE per pair, ``--fid`` and ``--dists`` with
``--extractor vgg16:<file>`` against JAX's ``scripts/eval.main`` on the
same directory and the same torchvision-layout file (the aggregate and the
per-image rows); ``--extractor dinov2:<dir>`` on a Depth-Anything
directory in transformers' layout against JAX's ``dinov2_features`` fed
the same tree (JAX's own ``dinov2:`` branch unpacks the loader's one dict
into two names and fails, shown here); the ``test`` extractor's note; and
the refusals."""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from unigen_tpu import eval as j_eval
from unigen_tpu.io.torch_bridge import load_depth_anything as j_load_depth
from unigen_tpu.models import depth as j_depth
from unigen_tpu.models.vgg import IMAGENET_MEAN, IMAGENET_STD
from unigen_tpu_torch.cli import eval as cli
from unigen_tpu_torch.models import depth as t_depth

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_eval_script",
                                                  ROOT / "scripts" / "eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Four {i}/target.png, res.png pairs (40x48; res a noisy target), one
    pair of mismatched sizes (skipped) and a stray file (skipped)."""
    root = tmp_path_factory.mktemp("results")
    rng = np.random.default_rng(4)
    for i in range(4):
        d = root / f"{i:05d}"
        d.mkdir()
        tgt = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        res = np.clip(tgt.astype(int) + rng.integers(-30, 30, tgt.shape), 0, 255)
        Image.fromarray(tgt).save(d / "target.png")
        Image.fromarray(res.astype(np.uint8)).save(d / "res.png")
    (root / "odd").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(root / "odd" / "target.png")
    Image.fromarray(np.zeros((9, 8, 3), np.uint8)).save(root / "odd" / "res.png")
    (root / "info.json").write_text("[]")
    return root


@pytest.fixture(scope="module")
def vgg_file(tmp_path_factory):
    """A random torchvision-layout VGG16 ``features`` file (chip_smoke's
    writer, 14.7 M parameters)."""
    path = tmp_path_factory.mktemp("vgg") / "vgg16.pth"
    n, _ = chip_smoke.write_vgg16_features(torch, path, 0, "cpu")
    assert n == 14_714_688
    return path


def test_vgg16_extractor_matches_scripts_eval(results, vgg_file, tmp_path, capsys):
    """--fid --dists --extractor vgg16:<file> --out: the printed aggregate
    and the per-image rows equal JAX's script on the same inputs (the
    pixel metrics 1e-5, the Fréchet distance and DISTS 1e-4 relative)."""
    argv = ["--results_dir", str(results), "--fid", "--dists",
            "--extractor", f"vgg16:{vgg_file}"]
    got = cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "t.json")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    _jax_script().main(argv + ["--out", str(tmp_path / "j.json")])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["count"] == want["count"] == 4
    assert got["extractor"] == want["extractor"]
    for k, tol in (("ssim", 1e-5), ("psnr", 1e-5), ("mae", 1e-5), ("fid", 1e-4),
                   ("dists", 1e-4)):
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=1e-6, err_msg=k)
    t_rows = json.loads((tmp_path / "t.json").read_text())["per_image"]
    j_rows = json.loads((tmp_path / "j.json").read_text())["per_image"]
    assert [r["index"] for r in t_rows] == [r["index"] for r in j_rows] == \
        [f"{i:05d}" for i in range(4)]
    for t, j in zip(t_rows, j_rows):
        assert t.keys() == j.keys() and "_paths" not in t
        for k in ("ssim", "psnr", "mae", "dists"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, atol=1e-6)


def test_dinov2_extractor_against_jax_features(results, tmp_path, monkeypatch):
    """--fid --extractor dinov2:<dir> reads a Depth-Anything directory in
    transformers' layout (chip_smoke's writer; the tiny config in place of
    the small one the CLI builds) and gives the Fréchet distance of JAX's
    ``dinov2_features`` over the same tree and pixels (1e-4 relative).
    JAX's CLI branch fails on the loader's return value."""
    cfg = t_depth.tiny_depth_config()
    chip_smoke.write_depth_anything(torch, tmp_path / "depth", cfg, 3, "cpu", grid=4)
    monkeypatch.setattr(t_depth, "DepthAnythingConfig", lambda: cfg)
    got = cli.main(["--results_dir", str(results), "--fid", "--device", "cpu",
                    "--extractor", f"dinov2:{tmp_path / 'depth'}"])

    from unigen_tpu.io.torch_bridge import read_checkpoint_dir
    sd = read_checkpoint_dir(str(tmp_path / "depth"))
    jcfg = j_depth.tiny_depth_config()
    params = j_load_depth(sd, jcfg)
    feats = jax.jit(lambda p, x: j_depth.dinov2_features(p, jcfg, x))
    stats = [j_eval.FeatureStats(cfg.hidden_size) for _ in range(2)]
    for i in range(4):
        for s, name in zip(stats, ("res.png", "target.png")):
            px = np.asarray(Image.open(results / f"{i:05d}" / name).convert("RGB"),
                            np.float32).transpose(2, 0, 1)[None] / 255.0
            x = (px - IMAGENET_MEAN[None, :, None, None]) / IMAGENET_STD[None, :, None, None]
            s.update(np.asarray(feats(params, jnp.asarray(x))))
    want = j_eval.frechet_distance(*stats[0].finalize(), *stats[1].finalize())
    assert got["extractor"].startswith("dinov2:") and got["fid"] > 0
    np.testing.assert_allclose(got["fid"], want, rtol=1e-4)

    monkeypatch.setattr(j_depth, "DepthAnythingConfig", lambda: jcfg)
    with pytest.raises(ValueError, match="unpack"):
        _jax_script().main(["--results_dir", str(results), "--fid",
                            "--extractor", f"dinov2:{tmp_path / 'depth'}"])
    with pytest.raises(SystemExit, match="VGG16"):
        cli.main(["--results_dir", str(results), "--dists", "--device", "cpu",
                  "--extractor", f"dinov2:{tmp_path / 'depth'}"])


def test_test_extractor_note_and_refusals(results, tmp_path, capsys):
    """The fixed random tower carries its note and gives the same numbers on
    every run; an unknown extractor and an empty directory are reported; the
    card is refused where there is none."""
    a = cli.main(["--results_dir", str(results), "--fid", "--dists", "--device", "cpu"])
    b = cli.main(["--results_dir", str(results), "--fid", "--dists", "--device", "cpu"])
    assert a == b and "extractor_note" in a and 0 < a["dists"] < 1
    with pytest.raises(SystemExit, match="expected test"):
        cli.main(["--results_dir", str(results), "--fid", "--device", "cpu",
                  "--extractor", "inception"])
    (tmp_path / "empty").mkdir()
    assert cli.main(["--results_dir", str(tmp_path / "empty"), "--device", "cpu"]) == \
        {"error": "no comparable image pairs found"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--results_dir", str(results)])
