"""A rehearsal of ``chip_smoke.py``'s phase 11d-11e on the CPU:
``phase_tools_checkpoints`` on the tiny FLUX directory of
``tests/test_from_pretrained.py`` (with a reference-layout adapter) and the
loading tests' tiny SD3 root, in the environment of
``tests/test_torch_port_tools_chip.py``'s ``rehearsal`` fixture (counting
kernel entry points, the example's 512² control at 32²); then
``generate_check`` is shown to see one changed pixel, and ``validate`` a
gate verdict that disagrees with the fidelity measured."""

import json
import pathlib
import types

import pytest

import torch

import chip_smoke
from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from tests.test_torch_port_loading import sd3_root  # noqa: F401
from tests.test_torch_port_tools_chip import rehearsal  # noqa: F401
from unigen_tpu_torch import config as tcfg


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"phase"')]


def _flux_dir(fake_ckpt):  # noqa: F811
    flux = pathlib.Path(fake_ckpt)
    if not (flux / "adapter").exists():
        cfg = tcfg.UniGenConfig(family="flux", flux=tcfg.tiny_flux_config(),
                                condition_types=("canny",))
        chip_smoke.write_reference_adapter_bins(
            torch, flux / "adapter", chip_smoke.flux_adapter_shapes(cfg), torch.float32,
            torch.Generator().manual_seed(5), "cpu")
    return flux


def test_chip_tools_checkpoints(rehearsal, fake_ckpt, sd3_root, tmp_path,  # noqa: F811
                                capsys, monkeypatch):
    """11d-11e on the tiny FLUX directory and the tiny SD3 root (the
    example's 512^2 control at 32^2): the strict counts, both gates,
    generate's launches and generate_check bit for bit."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # stage 3's interpreters
    totals = chip_smoke.phase_tools_checkpoints(torch, torch.device("cpu"), 0,
                                                tmp_path / "tools", _flux_dir(fake_ckpt),
                                                pathlib.Path(sd3_root))
    by = {x["phase"]: x for x in _lines(capsys)}
    assert by["validate_flux"]["strict_counts"] == by["validate_flux"]["expected_counts"]
    assert by["validate_flux"]["ssim_gate"]["pass"]
    assert "skipped" in by["validate_sd3"] or by["validate_sd3"]["ssim_gate"]["pass"]
    assert by["generate_check"]["max_code_diff"] == 0
    assert by["generate"]["launches"] == by["generate"]["expected_launches"]
    assert totals.get("flash_attention_rope", 0) > 0


def test_chip_generate_check_sees_a_changed_pixel(rehearsal, fake_ckpt,  # noqa: F811
                                                  tmp_path):
    """generate_check reads 0 codes on cli.generate's own PNG and 1 after one
    pixel's low bit is flipped."""
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.cli import generate as cli_gen
    png = chip_smoke.write_control_png(tmp_path / "c.png", 32, 0)
    args = cli_gen.parse_args(["--ckpt", str(_flux_dir(fake_ckpt)), "--image", str(png),
                               "--steps", "2", "--out", str(tmp_path / "o.png"),
                               "--device", "cpu"])
    pipe = cli_gen.load_pipeline(args)
    pipe.tokenizer = chip_smoke.SeededTokenizer(pipe.clip_cfg.vocab_size,
                                                pipe.clip_cfg.vocab_size - 1, 0)
    pipe.tokenizer_2 = chip_smoke.SeededTokenizer(pipe.t5_cfg.vocab_size, 1, 1)
    img = cli_gen.main(["--ckpt", args.ckpt, "--image", str(png), "--steps", "2", "--out",
                        args.out, "--device", "cpu"], pipeline=pipe)
    assert chip_smoke.generate_check(torch, pipe, args) == 0
    bad = np.array(img)
    bad[0, 0, 0] ^= 1
    Image.fromarray(bad).save(args.out)
    assert chip_smoke.generate_check(torch, pipe, args) == 1


def test_chip_validate_holds_the_gate_to_its_fidelity(tmp_path):
    """A refused checkpoint's report is read from --out and accepted when
    the verdict matches the worst SSIM; a verdict that disagrees, or a
    failure of another stage, stops the phase."""
    out = tmp_path / "v.json"

    def tool(worst, verdict, message="SSIM gate FAILED: x"):
        def main(argv):
            report = {"quant_fidelity": {"w8a8": {"e2e_ssim": 0.999},
                                         "w4a8": {"e2e_ssim": worst}},
                      "ssim_gate": {"gate": 0.99, "worst": worst, "pass": verdict}}
            out.write_text(json.dumps(report))
            if not verdict:
                raise SystemExit(message)
            return report
        return types.SimpleNamespace(main=main)
    assert chip_smoke.validate(tool(0.995, True), [], out)["ssim_gate"]["pass"]
    rep = chip_smoke.validate(tool(0.93, False), [], out)
    assert not rep["ssim_gate"]["pass"] and rep["ssim_gate"]["exit"].startswith("SSIM gate")
    for bad in (tool(0.995, False), tool(0.93, True)):
        with pytest.raises(SystemExit, match="disagrees"):
            chip_smoke.validate(bad, [], out)
    with pytest.raises(SystemExit, match="strict"):
        chip_smoke.validate(tool(0.93, False, "strict load FAILED"), [], out)


def test_chip_flux_checkpoint_linears_drawn_as_the_port_init(sd3_root, tmp_path):  # noqa: F811
    """write_flux_checkpoint (4e's directory) draws every linear of the
    transformer and of the .bin adapter from U(-k, k), k = 1/sqrt(in), as
    the port's linear init does, and leaves the rest N(0, 0.02) (norms
    about 1); the SD3 writer keeps N(0, 0.02) linears."""
    from unigen_tpu_torch.io import torch_bridge as tb
    cfg = tcfg.UniGenConfig(family="flux", flux=tcfg.tiny_flux_config(),
                            condition_types=("canny",))
    root = tmp_path / "flux"
    chip_smoke.write_flux_checkpoint(torch, "cpu", root, cfg, 0, pathlib.Path(sd3_root))
    sd = tb.read_checkpoint_dir(str(root / "transformer"))
    for f in sorted((root / "adapter").glob("*.bin")):
        sd.update({f"{f.stem}.{k}": v for k, v in torch.load(f).items()})
    linears = {n: t.float() for n, t in sd.items() if t.dim() == 2 and n.endswith(".weight")}
    assert len(linears) > 10
    for name, w in linears.items():
        k = 1 / w.shape[1] ** 0.5
        assert float(w.abs().max()) <= k * (1 + 2 ** -8), name     # k rounded to bf16
        if w.numel() >= 1024:
            assert 0.8 < float(w.std()) / (k / 3 ** 0.5) < 1.2, name
    others = [t.float() for n, t in sd.items() if n not in linears and "norm" not in n]
    assert others and all(float(t.abs().max()) < 0.2 for t in others)
    sd3 = tb.read_checkpoint_dir(str(pathlib.Path(sd3_root) / "adapter"))
    w = next(t.float() for n, t in sd3.items() if t.dim() == 2 and t.numel() >= 1024)
    assert 0.015 < float(w.std()) < 0.025
