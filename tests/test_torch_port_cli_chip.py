"""A rehearsal of ``chip_smoke.py``'s phase 10 (``entry_points``) on the CPU,
at tiny sizes: ``phase_entry_points`` whole, on a tiny SD3 directory (the
loading tests' fixture: transformer, adapter, CLIP-L, CLIP-G, T5, VAE) and
the tiny FLUX directory of ``tests/test_from_pretrained.py`` with a
reference-layout adapter, with the kernel entry points counting their
launches as on the card, ``torch.cuda``'s synchronisation stubbed, the
quantization gate lowered to 16 (so W4A8 runs), 32x32 images and 2 steps,
and a tiny Depth-Anything config in place of the small one. It runs 10a's
launch formula, ``entry_infer_check`` bit for bit and the CFG forward's
path check, 10c's serve runs and ``entry_serve_check``, 10b's FLUX request,
10d's ``entry_eval_check`` (both passes on the CPU) and 10e's
``depth_condition_check``; then each check is shown to see a fault."""

import functools
import json

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from tests.test_torch_port_loading import sd3_root  # noqa: F401
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.models import depth as t_depth
from unigen_tpu_torch.ops import quant as tquant
from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.cuda import flash_attention as fa
from unigen_tpu_torch.ops.cuda import quant_matmul as qm


@pytest.fixture
def rehearsal(monkeypatch, tmp_path, fake_ckpt):  # noqa: F811
    """The phase's environment on the CPU (see the module docstring); -> the
    FLUX directory with its adapter."""
    for mod, name, counters in ((fa, "flash_attention_rope_fwd", ("launches",
                                                                    "rotate_launches")),
                                (fa, "flash_attention_fwd", ("norope_launches",)),
                                (qm, "w4a8_matmul", ("launches",)),
                                (qm, "quantize_act", ("quantize_launches",))):
        def counted(*a, _real=getattr(mod, name), _mod=mod, _names=counters, **kw):
            for c in _names:
                build.count(vars(_mod), c)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(tquant, "quantize_tree_streaming", functools.partial(
        tquant.quantize_tree_streaming, min_dim=16))
    monkeypatch.setattr(tquant, "TEXT_QUANT_MIN_DIM", 16)
    tiny = t_depth.tiny_depth_config()
    monkeypatch.setattr(t_depth, "DepthAnythingConfig", lambda: tiny)
    for name, value in (("PIPE_RES", 32), ("SD3_PIPE_STEPS", 2), ("STEPS", 2),
                        ("LOAD_FLUX_DEPTH", (2, 4))):
        monkeypatch.setattr(chip_smoke, name, value)
    import pathlib
    flux = pathlib.Path(fake_ckpt)
    if not (flux / "adapter").exists():
        cfg = tcfg.UniGenConfig(family="flux", flux=tcfg.tiny_flux_config(),
                                condition_types=("canny",))
        chip_smoke.write_reference_adapter_bins(
            torch, flux / "adapter", chip_smoke.flux_adapter_shapes(cfg), torch.float32,
            torch.Generator().manual_seed(5), "cpu")
    chip_smoke.reset_launch_counts()
    yield flux
    chip_smoke.reset_launch_counts()


def test_chip_entry_points_phase(rehearsal, sd3_root, tmp_path, capsys):  # noqa: F811
    """Phase 10 end to end at tiny sizes: every check passes, each line is
    printed, and the kernels of 10a-10c were launched."""
    import pathlib
    totals = chip_smoke.phase_entry_points(torch, torch.device("cpu"), 0, tmp_path / "entry",
                                           pathlib.Path(sd3_root), rehearsal)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith('{"phase"')]
    phases = [x["phase"] for x in lines]
    for name in ("entry_infer", "entry_infer_check", "entry_infer_path_check",
                 "entry_serve", "entry_serve_check", "entry_infer_flux", "entry_eval",
                 "depth_condition"):
        assert name in phases, phases
    by = {x["phase"]: x for x in lines}
    assert by["entry_infer_check"]["max_code_diff"] == 0
    assert by["entry_serve_check"]["batched"]["max_code_diff"] == 0
    assert by["entry_serve_check"]["step_server"]["images"] == chip_smoke.STEPSERVE_SLOTS - 1
    assert [x["extractor"] for x in lines if x["phase"] == "entry_eval"] == ["vgg16", "dinov2"]
    assert by["depth_condition"]["max_code_diff"] == 0
    for k in ("flash_attention", "w4a8_matmul", "quantize_act", "flash_attention_rope"):
        assert totals.get(k, 0) > 0, totals


def test_chip_entry_points_checks_see_a_fault(tmp_path):
    """entry_eval_check refuses a metric off by more than its limit, a
    missing key or another count; depth_condition_check refuses an output
    of the wrong size."""
    cpu = {"ssim": 0.25, "psnr": 8.0, "mae": 90.0, "count": 4, "extractor": "x",
           "fid": 120.0}
    assert max(chip_smoke.entry_eval_check(dict(cpu), cpu).values()) == 0
    near = dict(cpu, fid=120.0 * (1 + 5e-5))
    assert chip_smoke.entry_eval_check(near, cpu)["fid"] == pytest.approx(5e-5)
    for bad in (dict(cpu, fid=120.0 * (1 + 2e-4)), dict(cpu, count=3),
                {k: v for k, v in cpu.items() if k != "mae"}):
        with pytest.raises(SystemExit):
            chip_smoke.entry_eval_check(bad, cpu)

    cfg = t_depth.tiny_depth_config()
    from unigen_tpu_torch.io.torch_bridge import load_depth_anything, read_checkpoint_dir
    from unigen_tpu_torch.utils import param_count
    n, _ = chip_smoke.write_depth_anything(torch, tmp_path / "d", cfg, 0, "cpu", grid=4)
    params = load_depth_anything(read_checkpoint_dir(str(tmp_path / "d")), cfg, device="cpu")
    assert n == param_count(params) + cfg.hidden_size      # the mask token is not read
    imgs = [np.random.default_rng(i).integers(0, 256, (40, 44, 3), dtype=np.uint8)
            for i in range(2)]
    ms, worst, shape = chip_smoke.depth_condition_check(torch, params, params, cfg, imgs)
    assert worst == 0 and shape == [40, 44, 3] and ms > 0
    from unigen_tpu_torch.data import conditions
    real = conditions.make_depth_fn
    try:
        conditions.make_depth_fn = lambda p, c: (lambda img: img[:-1])
        with pytest.raises(SystemExit, match="depth_condition"):
            chip_smoke.depth_condition_check(torch, params, params, cfg, imgs)
    finally:
        conditions.make_depth_fn = real
