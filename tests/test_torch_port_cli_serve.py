"""The port's serving entry point (``python -m unigen_tpu_torch.cli.serve``)
on the CPU. Against JAX's ``scripts/serve.main`` on the tiny FLUX
directory of ``tests/test_from_pretrained.py`` (fp32 in both, the same
numpy noise handed to both pipelines and both step servers): the
request-batched path and ``--step-server`` with a ``cancel`` line, PNGs
within one code and the same cancel. Against the port's own functions: the
PNGs of a batch of 2 equal ``generate`` of that batch bit for bit, both
``--demo`` modes (their shapes and counts are the JAX demos'), the
``--quality-profile`` resolution at ``--steps``, every refusal (the
``--mesh-*`` flags name ROADMAP Queue 1 item 8), and a closed step server
freed by reference counting alone although the CLI's callbacks ran on
it."""

import functools
import importlib.util
import io
import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from unigen_tpu import serving_steps as j_steps
from unigen_tpu.pipelines import flux as j_flux
from unigen_tpu.pipelines import loading as j_loading
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch import serving_steps as t_steps
from unigen_tpu_torch.cli import serve as cli
from unigen_tpu_torch.pipelines import flux as t_flux
from unigen_tpu_torch.pipelines.loading import load_flux_pipeline

ROOT = pathlib.Path(__file__).resolve().parents[1]
RES = 32


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_serve_script",
                                                  ROOT / "scripts" / "serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def seeded(monkeypatch):
    """The same numpy noise for both packages' pipeline generate (keyed by
    the seed and the batch) and step-server submit (keyed by the request's
    seed); JAX's loader and step server in fp32, as the port's."""
    for mod in (j_flux, t_flux):
        real = mod.UniGenFluxPipeline.generate

        def generate(self, *a, _real=real, latents=None, **kw):
            if latents is None:
                b, vs = kw["prompt_embeds"].shape[0], self.vae_cfg.downscale
                lh = 2 * (kw["height"] // (vs * 2))
                lw = 2 * (kw["width"] // (vs * 2))
                latents = np.random.default_rng(1000 + kw.get("seed", 0)).standard_normal(
                    (b, (lh // 2) * (lw // 2), self.cfg.flux.in_channels)).astype(np.float32)
            return _real(self, *a, latents=latents, **kw)
        monkeypatch.setattr(mod.UniGenFluxPipeline, "generate", generate)
    for mod in (j_steps, t_steps):
        real = mod.StepServer.submit

        def submit(self, *, _real=real, latents=None, seed=0, **kw):
            if latents is None:
                latents = np.random.default_rng(2000 + seed).standard_normal(
                    (1,) + tuple(self._lat.shape[1:])).astype(np.float32)
            return _real(self, latents=latents, seed=seed, **kw)
        monkeypatch.setattr(mod.StepServer, "submit", submit)
    monkeypatch.setattr(j_loading, "load_flux_pipeline", functools.partial(
        j_loading.load_flux_pipeline, dtype=jnp.float32))
    monkeypatch.setitem(j_steps.StepServer.__init__.__kwdefaults__, "dtype", jnp.float32)


def _requests(tmp_path, tag, n, out_dir):
    rng = np.random.default_rng(7)
    lines = []
    for i in range(n):
        path = tmp_path / f"control_{i}.png"
        if not path.exists():
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(path)
        lines.append(dict(prompt=["a cat", "a dog wearing a hat", "a hat"][i % 3],
                          condition="canny", control=str(path),
                          out=str(out_dir / f"{tag}_{i}.png"), seed=i))
    return lines


def _text(lines, cancel=None):
    out = "".join(json.dumps(r) + "\n" for r in lines)
    return out + (json.dumps({"cancel": cancel}) + "\n" if cancel else "")


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


def test_serve_matches_scripts_serve(fake_ckpt, seeded, tmp_path, monkeypatch,  # noqa: F811
                                     capsys):
    """Request-batched (batch 1, two requests) and --step-server (2 slots,
    three requests, the last cancelled in flight) on the same directory in
    both packages: the same images within one code, the same paths printed,
    the same cancel."""
    common = ["--ckpt", fake_ckpt, "--resolution", str(RES), "--steps", "2"]
    script = _jax_script()
    outs = {}
    for pkg in ("t", "j"):
        d = tmp_path / pkg
        d.mkdir()
        for name, flags, n, cancel in (("batched", ["--batch-size", "1"], 2, False),
                                       ("stepped", ["--step-server", "--batch-size", "2"], 3,
                                        True)):
            lines = _requests(tmp_path, name, n, d)
            text = _text(lines, lines[-1]["out"] if cancel else None)
            if pkg == "t":
                summary = cli.main(common + flags + ["--device", "cpu", "--dtype", "fp32"],
                                   stdin=io.StringIO(text))
                outs[("t", name)] = sorted(summary["saved"])
                if cancel:
                    assert summary["cancels"] == {lines[-1]["out"]: True}
            else:
                monkeypatch.setattr(sys, "stdin", io.StringIO(text))
                capsys.readouterr()
                script.main(common + flags)
                captured = capsys.readouterr()
                outs[("j", name)] = sorted(x for x in captured.out.split() if x.endswith(".png"))
                if cancel:
                    assert f"cancel {lines[-1]['out']}: ok" in captured.err
    for name, n in (("batched", 2), ("stepped", 2)):
        t_paths, j_paths = outs[("t", name)], outs[("j", name)]
        assert [pathlib.Path(p).name for p in t_paths] == \
            [pathlib.Path(p).name for p in j_paths] and len(t_paths) == n
        for tp, jp in zip(t_paths, j_paths):
            got, want = _png(tp), _png(jp)
            assert got.shape == (RES, RES, 3) and np.abs(got - want).max() <= 1, (tp, jp)


def _pipeline(root):
    pipe = load_flux_pipeline(root, dtype=torch.float32, device="cpu")
    pipe.tokenizer = chip_smoke.SeededTokenizer(pipe.clip_cfg.vocab_size,
                                                pipe.clip_cfg.vocab_size - 1, 0)
    pipe.tokenizer_2 = chip_smoke.SeededTokenizer(pipe.t5_cfg.vocab_size, 1, 1)
    return pipe


def test_batched_pngs_equal_generate_and_the_server_is_freed(fake_ckpt, tmp_path,  # noqa: F811
                                                             monkeypatch):
    """Batch 2 over four requests with a wide batching window: two batches,
    each PNG equal to ``generate`` of its batch bit for bit (the CLI adds
    only I/O). A --step-server run with --stats-every 1, with the collector
    off: every StepServer it made is freed by reference counting alone
    once ``main`` returns (its callbacks hold the server weakly)."""
    import gc
    import weakref
    pipe = _pipeline(fake_ckpt)
    lines = _requests(tmp_path, "b", 4, tmp_path)
    summary = cli.main(["--family", "flux", "--batch-size", "2", "--max-wait-ms", "60000",
                        "--resolution", str(RES), "--steps", "2"], pipeline=pipe,
                       stdin=io.StringIO(_text(lines)))
    assert summary["stats"] == {"batches": 2, "requests": 4, "samples": 4,
                                "padded_samples": 0}
    assert sorted(summary["latency_s"]) == sorted(r["out"] for r in lines)
    for i in (0, 2):
        x = [chip_smoke.served_inputs(torch, pipe, r, RES) for r in lines[i:i + 2]]
        imgs = pipe.generate(**{k: torch.cat([r[k] for r in x]) for k in x[0]}, height=RES,
                             width=RES, num_inference_steps=2)
        for j in range(2):
            assert np.array_equal(_png(lines[i + j]["out"]), imgs[j].numpy().astype(int))

    made = []

    class Recorded(t_steps.StepServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(weakref.ref(self))
    monkeypatch.setattr(t_steps, "StepServer", Recorded)
    was = gc.isenabled()
    gc.disable()
    try:
        summary = cli.main(["--family", "flux", "--step-server", "--batch-size", "2",
                            "--stats-every", "1", "--resolution", str(RES), "--steps", "2"],
                           pipeline=pipe, stdin=io.StringIO(_text(lines[:2])))
        assert len(summary["saved"]) == 2 and summary["stats"]["retired"] == 2
        assert made and all(ref() is None for ref in made)
    finally:
        if was:
            gc.enable()


def test_demos_match_the_jax_demos_shapes():
    """Both --demo modes run the port's tiny random FLUX trees on the CPU:
    the request counts and output shapes of scripts/serve.py's demos (3 x
    batch + 1 forwards of [1, 64, in_channels]; 2 x slots + 1 images of
    [1, 32, 32, 3] at mixed step counts)."""
    flux = tcfg.tiny_flux_config()
    out = cli.main(["--demo", "--batch-size", "2", "--device", "cpu"])
    assert out["requests"] == 7 and out["out_shape"] == [1, 64, flux.in_channels]
    assert out["batches"] >= 4
    out = cli.main(["--demo", "--step-server", "--batch-size", "2", "--device", "cpu",
                    "--model-cache-interval", "2"])
    assert out["requests"] == 5 and out["out_shape"] == [1, 32, 32, 3]
    assert out["stats"]["retired"] == 5 and out["stats"]["ticks_replay"] > 0


def test_quality_profile_resolves_at_the_served_steps(capsys):
    """--step-server --quality-profile resolves before any model is loaded,
    with the schedule's step count: "fast" at the default 4 steps takes
    "balanced"'s point (its min_steps gate is 8), at 8 steps its own."""
    ap = cli.build_parser()
    args = ap.parse_args(["--step-server", "--quality-profile", "fast", "--family", "sd3"])
    with pytest.warns(UserWarning):
        cli.check_args(ap, args)
    assert (args.control_cache_interval, args.model_cache_interval) == (8, 2)
    assert args.quality_profile is None
    args = ap.parse_args(["--step-server", "--quality-profile", "fast", "--steps", "8"])
    cli.check_args(ap, args)
    assert (args.model_cache_interval, args.model_cache_order) == (4, 1)
    assert "quality-profile fast" in capsys.readouterr().err


@pytest.mark.parametrize("flags,match", [
    (["--adaptive-lag", "1"], "adaptive-lag"),
    (["--adaptive-lag", "1", "--step-server"], "adaptive-lag"),
    (["--multi-tick", "2"], "multi-tick"),
    (["--multi-tick", "2", "--step-server", "--model-cache-interval", "2"], "exact"),
    (["--multi-tick", "2", "--step-server", "--quality-profile", "balanced"], "exact"),
    (["--warmup"], "warmup"),
    (["--resolutions", "512:4,1024:1"], "resolutions"),
    (["--step-server", "--quality-profile", "balanced", "--model-cache-interval", "2"],
     "quality_profile"),
    (["--family", "sd3", "--ckpt", "x", "--lora-dir", "l"], "lora-dir"),
    (["--family", "sana", "--ckpt", "x", "--serving-cache", "c"], "serving-cache"),
])
def test_refusals(flags, match, capsys):
    """Every ``ap.error`` of scripts/serve.py: exit code 2 with the reason."""
    with pytest.raises(SystemExit) as e:
        cli.main(flags)
    assert e.value.code == 2 and match in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--mesh-data", "--mesh-expert", "--mesh-model"])
def test_mesh_refuses_and_names_item_8(flag):
    """More than one card waits for the parallel layer, before anything
    loads, as the step servers refuse ``mesh=``."""
    with pytest.raises(SystemExit, match="item 8"):
        cli.main([flag, "2", "--ckpt", "x", "--family", "sd3"])
    with pytest.raises(SystemExit, match="item 8"):
        cli.main([flag, "2", "--demo", "--step-server"])
