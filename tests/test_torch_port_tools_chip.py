"""A rehearsal of ``chip_smoke.py``'s phase 11 (``tools``) on the CPU at tiny
sizes: ``fidelity_check`` for each family (tiny configs swapped in for the
FLUX proxy, SD3.5-medium and SANA-1.6B, the quantization gate lowered to 16
so W8A8 and W4A8 run) and ``phase_tools_profiles`` on a tiny W4A8 tree (the
tiny preset swapped in for ``flux_full``), with the kernel entry points
counting their launches as on the card and ``torch.cuda``'s synchronisation
stubbed. Then each check is shown to see a planted fault: a wrong path
output, a missing phase, a full phase that is not the forward. The
``phase_tools_checkpoints`` rehearsal (11d-11e) is in
``tests/test_torch_port_tools_chip_ckpt.py``, on this file's fixture."""

import functools
import json

import pytest
import torch

import chip_smoke
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch import presets as tpresets
from unigen_tpu_torch.ops import quant as tquant
from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.cuda import flash_attention as fa
from unigen_tpu_torch.ops.cuda import quant_matmul as qm

COUNTERS = ((fa, "flash_attention_rope_fwd", ("launches", "rotate_launches")),
            (fa, "flash_attention_rope_bwd", ("dq_launches", "dkv_launches",
                                              "rotate_launches")),
            (fa, "flash_attention_fwd", ("norope_launches",)),
            (fa, "flash_attention_bwd", ("norope_dq_launches", "norope_dkv_launches")),
            (qm, "w4a8_matmul", ("launches",)),
            (qm, "quantize_act", ("quantize_launches",)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def rehearsal(monkeypatch):
    """Counting kernel entry points, the card's synchronisation stubbed,
    the quantization gate at 16, tiny configs for the full-size ones."""
    for mod, name, counters in COUNTERS:
        def counted(*a, _real=getattr(mod, name), _mod=mod, _names=counters, **kw):
            for c in _names:
                build.count(vars(_mod), c)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(tquant, "quantize_tree_streaming", functools.partial(
        tquant.quantize_tree_streaming, min_dim=16))
    monkeypatch.setitem(tquant.quantize_tree.__kwdefaults__, "min_dim", 16)
    monkeypatch.setattr(tpresets, "flux_bench", tpresets.tiny)
    monkeypatch.setattr(tpresets, "flux_full", tpresets.tiny)
    monkeypatch.setattr(tpresets, "sd35_medium", lambda: tcfg.UniGenConfig(
        family="sd3", sd3=tcfg.tiny_sd3_config(), control=tcfg.ControlConfig(use_rope=False),
        condition_types=("depth",)))
    real_sana, tiny_sana = tcfg.SanaBackboneConfig, tcfg.tiny_sana_config()
    monkeypatch.setattr(tcfg, "SanaBackboneConfig",
                        lambda **kw: real_sana(**kw) if kw else tiny_sana)
    # int4 codes of 32-wide linears are coarser than the full widths' that
    # the card's 0.99 gate holds: SD3's W4A8 images read 0.9898 here
    for name, value in (("PIPE_RES", 32), ("STEPS", 2), ("VALIDATE_SD3_RES", 32),
                        ("FIDELITY_SSIM", 0.98)):
        monkeypatch.setattr(chip_smoke, name, value)
    from unigen_tpu_torch.cli import generate
    monkeypatch.setattr(generate, "RESOLUTION", 32)
    from unigen_tpu_torch.cli import profile_forward, profile_train
    for mod in (profile_forward, profile_train):      # one timed call a phase
        for name, value in (("T_LEN", 8), ("BURSTS", 1), ("CALLS", 1)):
            monkeypatch.setattr(mod, name, value)
    chip_smoke.reset_launch_counts()
    yield
    chip_smoke.reset_launch_counts()


def _lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith('{"phase"')]


@pytest.mark.parametrize("family,res", [("flux", 32), ("sd3", 32), ("sana", 64)])
def test_chip_fidelity_check(rehearsal, tmp_path, capsys, family, res):
    """11a-11c at tiny sizes: the CLI's bf16 forward equals the model's, every
    quantized path's kernel calls equal their plain versions, the launches
    equal the formulas, rel_err and SSIM within their limits."""
    total = chip_smoke.fidelity_check(torch, torch.device("cpu"), family, res, tmp_path)
    by = {x["phase"]: x for x in _lines(capsys)}
    assert by["fidelity_check"]["ok"] and by["fidelity_check"]["family"] == family
    paths = by[f"fidelity_{family}"]["paths"]
    assert paths["bf16"]["direct_equal"]
    quantized = [p for p in paths if p != "bf16"]
    assert all(paths[p]["launches"] == paths[p]["expected_launches"] for p in paths)
    assert total.get("quantize_act", 0) > 0
    if family != "sana":
        assert total.get("flash_attention_rope" if family == "flux" else "flash_attention")
    assert all(by[f"fidelity_{family}"]["report"][p]["e2e_ssim"] >= 0.98 for p in quantized)


def test_chip_fidelity_check_sees_a_wrong_path_output(rehearsal, tmp_path, monkeypatch):
    """A quantized path whose forward the CLI reports wrong (its output
    scaled) fails fidelity_check's rel_err limit."""
    from unigen_tpu_torch.cli import measure_fidelity as mf
    real = mf.run_paths

    def wrong(args, setup):
        host = real(args, setup)
        host["w8a8"]["fwd"] = host["w8a8"]["fwd"] * 1.5
        return host
    monkeypatch.setattr(mf, "run_paths", wrong)
    with pytest.raises(SystemExit, match="rel_err"):
        chip_smoke.fidelity_check(torch, torch.device("cpu"), "sana", 64, tmp_path)


def test_chip_tools_profiles(rehearsal, capsys):
    """11f-11g on a tiny W4A8 tree: every phase at both batches, the full
    phase bit for bit with its launch formula, attn's RoPE calls, no error
    row, each policy of TOOLS_REMATS with its step loss and launches."""
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    cfg = tpresets.tiny()
    params = init_quantized_serving_params(cfg, device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    totals = chip_smoke.phase_tools_profiles(torch, torch.device("cpu"), params)
    by = {x["phase"]: x for x in _lines(capsys)}
    checks = by["profile_forward"]["checks"]
    assert all(c["full_equal"] for c in checks.values())
    steps = by["profile_train"]["steps"]
    assert set(steps) == set(chip_smoke.TOOLS_REMATS.split(","))
    assert all(s["loss"] == s["cli_loss"] for s in steps.values())
    for k in ("flash_attention_rope", "w4a8_matmul", "quantize_act",
              "flash_attention_rope_bwd_dq", "flash_attention_rope_bwd_dkv"):
        assert totals.get(k, 0) > 0, totals


def test_chip_profile_checks_see_a_missing_phase(rehearsal, monkeypatch):
    """profile_forward's report missing a phase, or a full phase that is not
    the forward, stops the check."""
    from unigen_tpu_torch.cli import profile_forward as pf
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    params = init_quantized_serving_params(tpresets.tiny(), device="cpu",
                                           generator=torch.Generator().manual_seed(0))
    real = pf.run_batch

    def missing(*a, **k):
        report, first, outputs = real(*a, **k)
        report.pop("moe")
        return report, first, outputs
    monkeypatch.setattr(pf, "run_batch", missing)
    with pytest.raises(SystemExit, match="missing"):
        chip_smoke.phase_tools_profiles(torch, torch.device("cpu"), params)
    monkeypatch.setattr(pf, "run_batch", real)
    monkeypatch.setitem(pf.PHASE_FNS, "full", lambda p, c, x: pf.full_phase(p, c, x) * 2)
    with pytest.raises(SystemExit, match="full differs"):
        chip_smoke.phase_tools_profiles(torch, torch.device("cpu"), params)
