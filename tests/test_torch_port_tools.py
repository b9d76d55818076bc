"""The port's checkpoint validation and one-image example on the CPU:

- ``cli.validate_real_ckpt``: its flags against ``scripts/
  validate_real_ckpt.py``'s; on the tiny FLUX directory of
  ``tests/test_from_pretrained.py`` with ``--skip-diffusers --res 64
  --device cpu`` its ``strict_load`` report equals the JAX script's
  ``stage_strict_load`` on the same directory, called in process, and the
  SSIM gate of its ``cli.measure_fidelity`` subprocess passes.
- ``cli.generate``: its flags against ``examples/generate.py``'s; the tiny
  FLUX and SANA demos give the example's image shapes; ``--ckpt`` on the
  tiny directory (fp32 both) within one code of the JAX pipeline's call
  given the same noise (the example's 512² control at 32² here).

The fidelity tool's cache flags are in ``tests/test_torch_port_fidelity_cache.py``.
"""

import argparse
import functools
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from tests.test_torch_port_cli_infer import seeded_noise  # noqa: F401
from unigen_tpu_torch.cli import generate as cli_gen
from unigen_tpu_torch.cli import validate_real_ckpt as cli_val

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- validate

@pytest.mark.parametrize("argv", [
    ["--ckpt", "c"],
    ["--ckpt", "c", "--family", "sana", "--adapter", "a", "--lora-dir", "l",
     "--skip-diffusers", "--ssim-gate", "0.9", "--res", "256", "--out", "v.json"]])
def test_validate_flags_match_the_script(argv):
    got = vars(cli_val.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(_load("jax_validate", "scripts/validate_real_ckpt.py").parse_args(argv))


def test_validate_on_the_tiny_directory(fake_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """Stage 1's report equals JAX's stage_strict_load on the same
    directory; stage 2 is skipped; stage 3's gate passes; the report file
    equals the returned report."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # stage 3's interpreter
    out = tmp_path / "v.json"
    rep = cli_val.main(["--ckpt", fake_ckpt, "--skip-diffusers", "--res", "64", "--out",
                        str(out), "--device", "cpu"])
    script = _load("jax_validate", "scripts/validate_real_ckpt.py")
    jrep = {}
    script.stage_strict_load(script.parse_args(["--ckpt", fake_ckpt]), jrep)
    assert rep["strict_load"] == jrep["strict_load"]
    assert rep["diffusers_goldens"] == "SKIPPED (--skip-diffusers)"
    assert rep["ssim_gate"]["pass"] and rep["ssim_gate"]["worst"] == 1.0
    assert set(rep["quant_fidelity"]) >= {"w8a8", "w4a8_serving"}
    assert json.loads(out.read_text()) == json.loads(json.dumps(rep, default=str))
    with pytest.raises(SystemExit, match="not a directory"):
        cli_val.main(["--ckpt", str(tmp_path / "nope"), "--device", "cpu"])


def test_validate_writes_its_report_when_a_stage_fails(tmp_path, monkeypatch):
    """A refused gate still leaves what the stages found in --out."""
    def strict(args, report):
        report["strict_load"] = {"transformer": "ok (3 params, strict)"}

    def refuse(args, report):
        report["ssim_gate"] = {"gate": 0.99, "worst": 0.5, "pass": False}
        raise SystemExit("SSIM gate FAILED: 0.5 < 0.99")
    monkeypatch.setattr(cli_val, "stage_strict_load", strict)
    monkeypatch.setattr(cli_val, "stage_quant_fidelity", refuse)
    out = tmp_path / "v.json"
    with pytest.raises(SystemExit, match="SSIM gate FAILED"):
        cli_val.main(["--ckpt", str(tmp_path), "--skip-diffusers", "--out", str(out),
                      "--device", "cpu"])
    rep = json.loads(out.read_text())
    assert rep["ssim_gate"]["pass"] is False and rep["strict_load"]["transformer"].startswith("ok")


def test_validate_stage3_command_and_refusal():
    args = cli_val.parse_args(["--ckpt", "c", "--family", "sd3", "--adapter", "a",
                               "--device", "cpu"])
    cmd = cli_val.fidelity_command(args, "f.json")
    assert cmd[1:3] == ["-m", "unigen_tpu_torch.cli.measure_fidelity"]
    assert cmd[3:] == ["--ssim", "--ckpt", "c", "--res", "512", "--out", "f.json",
                       "--device", "cpu", "--family", "sd3", "--adapter", "a"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_val.main(["--ckpt", "c"])


# ---------------------------------------------------------------- generate

class _Parsed(Exception):
    pass


def test_generate_flags_match_the_example(monkeypatch):
    argv = ["--ckpt", "d", "--family", "sana", "--prompt", "p", "--condition", "depth",
            "--image", "i.png", "--steps", "3", "--out", "o.png"]
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))
    script = _load("jax_generate", "examples/generate.py")
    for a in ([], argv):
        monkeypatch.setattr("sys.argv", ["generate.py"] + a)
        with monkeypatch.context() as m:
            m.setattr(argparse.ArgumentParser, "parse_args", capture)
            with pytest.raises(_Parsed) as e:
                script.main()
        got = vars(cli_gen.parse_args(a))
        assert (got.pop("device"), got.pop("seed")) == ("cuda", 0)
        assert got == vars(e.value.args[0])


@pytest.mark.parametrize("family", ["flux", "sana"])
def test_generate_demos(family, tmp_path):
    """The random tiny demos on the CPU give the example's shapes: FLUX
    32x32, SANA 8 latents x the tiny VAE's downscale; the FLUX demo refuses
    the card."""
    from unigen_tpu.models import vae as j_vae
    out = tmp_path / "o.png"
    img = cli_gen.main(["--family", family, "--steps", "2", "--out", str(out),
                        "--device", "cpu"])
    side = 32 if family == "flux" else 8 * j_vae.tiny_vae_config().downscale
    assert img.shape == (side, side, 3) and img.dtype == np.uint8
    from PIL import Image
    assert np.array_equal(np.asarray(Image.open(out)), img)
    if family == "flux":
        with pytest.raises(SystemExit, match="head dim"):
            cli_gen.flux_demo(cli_gen.parse_args([]), torch.device("cuda"))


def test_generate_ckpt_matches_the_jax_pipeline(fake_ckpt, seeded_noise, tmp_path,  # noqa: F811
                                                monkeypatch):
    """--ckpt on the tiny directory (fp32 both, the control at 32²): the PNG
    within one code of the JAX pipeline's call with the example's arguments
    and the same noise."""
    from PIL import Image

    from unigen_tpu.data import conditions as JC
    from unigen_tpu.pipelines import loading as j_loading
    from unigen_tpu_torch.pipelines import loading as t_loading
    monkeypatch.setattr(cli_gen, "RESOLUTION", 32)
    monkeypatch.setattr(t_loading, "load_flux_pipeline", functools.partial(
        t_loading.load_flux_pipeline, dtype=torch.float32))
    png = tmp_path / "c.png"
    Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 48, 3), dtype=np.uint8)
                    ).save(png)
    img = cli_gen.main(["--ckpt", fake_ckpt, "--image", str(png), "--steps", "2", "--out",
                        str(tmp_path / "o.png"), "--device", "cpu"])
    jpipe = j_loading.load_flux_pipeline(fake_ckpt, condition_types=["canny"])
    ctrl = np.asarray(Image.open(png).convert("RGB").resize((32, 32)))
    want = jpipe(prompt="a cat wearing a hat", condition_prompt="canny",
                 control_image=JC.to_model_range(JC.synthesize("canny", ctrl))[None],
                 height=32, width=32, num_inference_steps=2)
    assert img.shape == (32, 32, 3)
    assert np.abs(img.astype(int) - np.asarray(want[0]).astype(int)).max() <= 1
