"""Checkpoint validation (port of ``scripts/validate_real_ckpt.py``): given a
diffusers-layout directory, in order

  1. a strict load audit: the transformer through
     ``io/torch_bridge.load_flux_transformer(..., strict=True)`` (flux; a
     checkpoint key that maps to nothing fails), then the whole pipeline
     through ``load_{flux,sd3,sana}_pipeline``, each component's parameter
     count reported;
  2. per-block goldens against diffusers: the port's ``flux_double_block``
     against ``FluxTransformer2DModel.transformer_blocks[0]`` on the same
     weights within 2e-3 (flux; reported SKIPPED where ``diffusers`` does
     not import, or with ``--skip-diffusers``);
  3. quantization fidelity on the checkpoint's weights:
     ``python -m unigen_tpu_torch.cli.measure_fidelity --ssim --ckpt ...``
     in a subprocess on the same device, gated on the worst ``e2e_ssim``
     (``--ssim-gate``, 0.99).

    python -m unigen_tpu_torch.cli.validate_real_ckpt --ckpt FLUX_DIR \
        --adapter ADAPTER_DIR --skip-diffusers

A failed stage exits with its reason; the report goes to ``--out`` (what
the stages found so far, also when one failed) and, on success, stdout.
The flags and defaults are ``scripts/validate_real_ckpt.py``'s, plus
``--device`` (the card unless "cpu" is named).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="validate a real checkpoint")
    p.add_argument("--ckpt", required=True, help="diffusers-layout model dir")
    p.add_argument("--family", default="flux", choices=["flux", "sd3", "sana"])
    p.add_argument("--adapter", default=None,
                   help="UniGen adapter checkpoint dir (any supported format)")
    p.add_argument("--lora-dir", default=None,
                   help="per-adapter LoRA dir (reference hook.py layout)")
    p.add_argument("--skip-diffusers", action="store_true")
    p.add_argument("--ssim-gate", type=float, default=0.99)
    p.add_argument("--res", type=int, default=512,
                   help="resolution for the fidelity stage")
    p.add_argument("--out", default="VALIDATE_REAL.json")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    return p.parse_args(argv)


def _count(tree) -> int:
    from unigen_tpu_torch.utils import param_count
    return param_count(tree)


def stage_strict_load(args, report):
    """Stage 1: the strict transformer audit and the whole pipeline's load
    (each subfolder's config.json gives its component's shapes)."""
    import torch

    from unigen_tpu_torch.io import torch_bridge as tb
    from unigen_tpu_torch.pipelines.loading import (_subcfg, load_flux_pipeline,
                                                    load_sana_pipeline, load_sd3_pipeline)
    results = {}
    if args.family == "flux":
        tcfg = _subcfg(args.ckpt, "transformer")
        base = tb.load_flux_transformer(
            tb.read_checkpoint_dir(os.path.join(args.ckpt, "transformer")),
            tcfg.get("num_layers", 19), tcfg.get("num_single_layers", 38),
            dtype=torch.bfloat16, strict=True, device=args.device)
        results["transformer"] = f"ok ({_count(base)} params, strict)"
        del base
        pipe = load_flux_pipeline(args.ckpt, adapter_dir=args.adapter,
                                  lora_dir=args.lora_dir, device=args.device)
        for comp, tree in (("vae", pipe.vae_params), ("text_encoder", pipe.clip_params),
                           ("text_encoder_2", pipe.t5_params)):
            results[comp] = f"ok ({_count(tree)} params)" if tree is not None else "absent"
        if args.adapter:
            results["adapter"] = f"ok ({_count(pipe.params['control'])} params)"
        if args.lora_dir:
            results["lora"] = f"ok ({sorted(pipe._lora.adapters)})"
    elif args.family == "sd3":
        pipe = load_sd3_pipeline(args.ckpt, adapter_dir=args.adapter, device=args.device)
        results["transformer"] = f"ok ({_count(pipe.params)} params)"
        results["vae"] = (f"ok ({_count(pipe.vae_params)} params)"
                          if pipe.vae_params is not None else "absent")
        if pipe.text_encoders is not None:
            results["text_encoders"] = \
                f"ok ({sorted(k for k, v in pipe.text_encoders.items() if v)})"
    else:
        pipe = load_sana_pipeline(args.ckpt, adapter_dir=args.adapter, device=args.device)
        results["transformer"] = f"ok ({_count(pipe.params)} params)"
        results["text_encoder"] = (f"ok ({_count(pipe.gemma_params)} params)"
                                   if pipe.gemma_params is not None else "absent")
    report["strict_load"] = results
    del pipe
    _free(args.device)


def _free(device):
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def stage_diffusers_goldens(args, report):
    """Stage 2: the port's first double block against diffusers' on the
    same weights, fp32 on the CPU."""
    try:
        import torch
        from diffusers import FluxTransformer2DModel
    except Exception as e:
        report["diffusers_goldens"] = f"SKIPPED (no diffusers: {e})"
        return
    import numpy as np

    from unigen_tpu_torch.io import torch_bridge as tb
    from unigen_tpu_torch.layers.blocks_flux import flux_double_block
    from unigen_tpu_torch.utils import index_params

    model = FluxTransformer2DModel.from_pretrained(
        os.path.join(args.ckpt, "transformer"), torch_dtype=torch.float32)
    tree = tb.load_flux_transformer(dict(model.state_dict()), model.config.num_layers,
                                    model.config.num_single_layers, dtype=torch.float32,
                                    device="cpu")
    heads = model.config.num_attention_heads
    d = heads * model.config.attention_head_dim
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.normal(size=(1, 64, d)).astype(np.float32))
    enc = torch.from_numpy(rs.normal(size=(1, 16, d)).astype(np.float32))
    temb = torch.from_numpy(rs.normal(size=(1, d)).astype(np.float32))
    blk = model.transformer_blocks[0]
    with torch.no_grad():
        e_t, h_t = blk(hidden_states=x, encoder_hidden_states=enc, temb=temb,
                       image_rotary_emb=None)
        e_p, h_p = flux_double_block(index_params(tree["double_blocks"], 0), x, enc,
                                     temb, None, heads=heads)
    err_h = float((h_p - h_t).abs().max())
    err_e = float((e_p - e_t).abs().max())
    ok = err_h < 2e-3 and err_e < 2e-3
    report["diffusers_goldens"] = {"double_block0_max_err_hidden": err_h,
                                   "double_block0_max_err_encoder": err_e, "pass": ok}
    if not ok:
        raise SystemExit(f"diffusers golden FAILED: {report['diffusers_goldens']}")


def fidelity_command(args, out_path) -> list:
    """The stage-3 command: the port's measure_fidelity on the checkpoint."""
    cmd = [sys.executable, "-m", "unigen_tpu_torch.cli.measure_fidelity", "--ssim",
           "--ckpt", args.ckpt, "--res", str(args.res), "--out", str(out_path),
           "--device", str(args.device)]
    if args.family != "flux":
        cmd += ["--family", args.family]
    if args.adapter:
        cmd += ["--adapter", args.adapter]
    return cmd


def stage_quant_fidelity(args, report):
    """Stage 3: the SSIM gate re-measured on the checkpoint's weights."""
    with tempfile.TemporaryDirectory() as tmp:
        fid_path = os.path.join(tmp, "fidelity.json")
        r = subprocess.run(fidelity_command(args, fid_path), capture_output=True,
                           text=True, timeout=7200, cwd=PACKAGE_ROOT)
        if r.returncode != 0:
            report["quant_fidelity"] = f"FAILED: {r.stderr[-500:]}"
            raise SystemExit(report["quant_fidelity"])
        with open(fid_path) as f:
            fid = json.load(f)
    report["quant_fidelity"] = fid
    worst = min(v.get("e2e_ssim", 1.0) for v in fid.values() if isinstance(v, dict))
    report["ssim_gate"] = {"gate": args.ssim_gate, "worst": worst,
                           "pass": worst >= args.ssim_gate}
    if worst < args.ssim_gate:
        raise SystemExit(f"SSIM gate FAILED: {worst} < {args.ssim_gate}")


def main(argv=None) -> dict:
    """Run the stages; -> the report (also written to ``--out``)."""
    args = parse_args(argv)
    from unigen_tpu_torch.utils import resolve_device
    resolve_device(args.device)
    report = {"ckpt": args.ckpt, "family": args.family}
    if not os.path.isdir(args.ckpt):
        raise SystemExit(f"--ckpt {args.ckpt}: not a directory")
    try:
        stage_strict_load(args, report)
        if args.skip_diffusers:
            report["diffusers_goldens"] = "SKIPPED (--skip-diffusers)"
        elif args.family != "flux":
            report["diffusers_goldens"] = (
                "SKIPPED (block-level diffusers goldens wired for flux; sd3/sana "
                "math is pinned by tests/test_torch_sd3_golden.py / "
                "test_torch_sana_golden.py on bridged weights)")
        else:
            stage_diffusers_goldens(args, report)
        stage_quant_fidelity(args, report)
    finally:
        # what the stages found, also when one of them failed
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps(report, indent=1, default=str))
    print("validate_real_ckpt: ALL EXECUTED STAGES PASSED")
    return report


if __name__ == "__main__":
    main()
