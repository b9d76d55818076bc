"""Quantization fidelity (port of ``scripts/measure_fidelity.py``): with the
same weights and inputs, each quantized path of a family against its bf16
path, as one forward's relative L2 error and cosine (float64 on the host)
and, with ``--ssim``, as SSIM/PSNR of the images of a whole denoise plus a
tiny-VAE decode.

    python -m unigen_tpu_torch.cli.measure_fidelity --family flux --ssim \
        --out fidelity.json

The paths: FLUX ``bf16``, ``w8a8`` (int8 everywhere eligible) and
``w4a8_serving`` (the single-card serving policy); SD3 ``bf16``, ``w8a8``
and ``w4a8`` (an int4 base, an int8 adapter); SANA ``bf16`` and ``w8a8``.
The trees: the FLUX proxy ``presets.flux_bench()`` (full width, 6/12
blocks), ``--full-topology`` (19/38 blocks at 12 heads), the full
SD3.5-medium, the full SANA-1.6B (per-sample routing), or ``--ckpt``'s own
topology read from a diffusers directory. Random trees come from a
``torch.Generator`` seeded 0, the batch from one seeded 1, the tiny VAE
from 2 and the live gates from 77. One tree is resident at a time: each
path builds its tree, runs, pulls its output to the host and frees the
tree before the next path; each path's seconds and peak bytes go to
stderr.

The JSON line has ``scripts/measure_fidelity.py``'s keys and rounding.
``--out`` writes it to a file too; ``--full-topology`` merges its section
as ``full_depth`` into ``--out`` only. Without ``--out`` no file is
written. The flags and defaults are the JAX script's, plus ``--device``
(the card unless "cpu" is named). ``main`` also takes a tree builder, a
batch and a VAE tree, for callers that hand in their own.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import types
from typing import Callable, NamedTuple, Optional

import numpy as np

TREE_SEED, BATCH_SEED, VAE_SEED, GATE_SEED = 0, 1, 2, 77
GATES = ("add_double", "add_single", "add_blocks")
FLUX_KEYS = ("hidden", "condition", "encoder", "pooled", "condition_pooled")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="quantization fidelity on one CUDA card")
    p.add_argument("--ssim", action="store_true",
                   help="also run the e2e denoise+VAE SSIM comparison")
    p.add_argument("--res", type=int, default=256,
                   help="image resolution for the e2e SSIM pass")
    p.add_argument("--family", default="flux", choices=["flux", "sd3", "sana"])
    p.add_argument("--out", default=None, help="write JSON here too")
    p.add_argument("--ckpt", default=None,
                   help="diffusers-layout checkpoint dir: measure fidelity on its "
                        "weights at the checkpoint's own topology (all 3 "
                        "families; cli/validate_real_ckpt.py stage 3) instead of "
                        "the random-init proxy")
    p.add_argument("--adapter", default=None,
                   help="UniGen adapter dir for --ckpt mode (default: "
                        "warm-started control branch)")
    p.add_argument("--full-topology", action="store_true",
                   help="fidelity at the full 19/38 depth at width 1536 (12 "
                        "heads); with the default full-width 6/12-depth proxy "
                        "the two runs bracket the full config on both axes. "
                        "Its section is merged as full_depth into --out")
    p.add_argument("--cache-interval", type=int, default=1, dest="cache_interval",
                   help="with --ssim (all families): run the quantized paths "
                        "with control-residual step caching at this interval "
                        "(bf16 stays exact)")
    p.add_argument("--cache-threshold", type=float, default=0.0, dest="cache_threshold",
                   help="with --ssim (all families): adaptive cache variant, "
                        "refresh when the latent drifts more than this "
                        "relative L1 since the last refresh (overrides "
                        "--cache-interval)")
    p.add_argument("--cfg-cache", action="store_true", dest="cfg_cache",
                   help="sd3 family: replay steps also skip the uncond stream "
                        "(half-batch pos forward + cached guidance delta); "
                        "requires --cache-interval/-threshold")
    p.add_argument("--model-cache", action="store_true", dest="model_cache",
                   help="all families: reinterpret --cache-interval/-threshold "
                        "as full-model output caching (replay steps reuse the "
                        "cached guided prediction); incompatible with "
                        "--cfg-cache")
    p.add_argument("--model-cache-order", type=int, default=0, dest="model_cache_order",
                   choices=[0, 1],
                   help="with --model-cache: 0 = zero-order hold, 1 = "
                        "first-order extrapolation from the two most recent "
                        "refreshes")
    p.add_argument("--hybrid-model-interval", type=int, default=1,
                   dest="hybrid_model_interval",
                   help="all families: three-level hybrid cache, a full "
                        "refresh every --cache-interval steps, the base "
                        "transformer with control replay every this-many "
                        "steps between, prediction replay otherwise (must "
                        "divide --cache-interval; fixed intervals only)")
    p.add_argument("--subject", action="store_true",
                   help="subject-driven conditioning (flux only): offset the "
                        "condition position ids by w/2 (Subjects-200K)")
    p.add_argument("--routing", default=None, choices=["per_sample", "global"],
                   help="override the MoE batch_mode")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.hybrid_model_interval > 1:
        h, c = args.hybrid_model_interval, args.cache_interval
        if (c <= h or c % h or args.cache_threshold > 0
                or args.model_cache or args.cfg_cache):
            p.error("--hybrid-model-interval requires a larger "
                    "--cache-interval it divides, and no "
                    "--cache-threshold/--model-cache/--cfg-cache")
    if args.subject and args.family != "flux":
        p.error("--subject is a flux-family path (Subjects-200K)")
    return args


# ------------------------------------------------------------ helpers

def fidelity(a, r):
    """(relative L2 error, cosine) of ``a`` against ``r``, float64."""
    a = np.asarray(a, np.float64).ravel()
    r = np.asarray(r, np.float64).ravel()
    rel = float(np.linalg.norm(a - r) / np.linalg.norm(r))
    cos = float(np.dot(a, r) / (np.linalg.norm(a) * np.linalg.norm(r)))
    return rel, cos


def liven_gates(params: dict, generator) -> dict:
    """A fresh init zeroes the control branch's gate linears (add_double,
    add_single, add_blocks), which nulls the whole control branch: give
    them N(0, 0.02) weights, drawn in fp32 from ``generator`` and cast to
    each leaf's dtype, before any path quantizes the tree. The leaves are
    replaced in place (the tree is fresh)."""
    import torch

    from unigen_tpu_torch.utils import tree_map
    ctrl = params["control"]
    for name in GATES:
        if name in ctrl:
            ctrl[name] = tree_map(
                lambda x: (0.02 * torch.randn(x.shape, generator=generator,
                                              dtype=torch.float32, device=x.device)
                           ).to(x.dtype), ctrl[name])
    return params


def to_u8(px) -> np.ndarray:
    """[B, 3, H, W] in [-1, 1] -> uint8 [B, H, W, 3], rounding half to even."""
    return ((np.asarray(px, np.float32).transpose(0, 2, 3, 1) + 1)
            * 127.5).round().astype(np.uint8)


def randn_host(generator, *shape) -> np.ndarray:
    """bf16 normal draws on the host, as float32 numpy."""
    import torch
    return torch.randn(shape, generator=generator, dtype=torch.float32).to(
        torch.bfloat16).float().numpy()


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        import torch
        torch.cuda.empty_cache()


def denoise_with(pipeline_cls, mode, cached: bool, *args):
    """``pipeline_cls.denoise(mode, *args)``: the family pipeline's Euler
    loop under ``mode`` (the control-residual cache with SD3's cfg_cache,
    the full-model cache or the three-level hybrid) where ``cached``, else
    exact, with the CLI's forward callbacks. The loop reads nothing of a
    pipeline's state; it records its refresh counts on the object it is
    given."""
    from unigen_tpu_torch.pipelines.caching import CacheMode
    return pipeline_cls.denoise(types.SimpleNamespace(), mode if cached else CacheMode(),
                                *args)


class Setup(NamedTuple):
    """One family's measurement: its config, the paths in order, a fresh
    tree per path, the host batch, the forward and the denoise-decode."""
    family: str
    cfg: object
    paths: tuple
    init_fn: Callable[[], dict]                   # a fresh unquantized tree
    make_params: Callable[[str], dict]
    batch: dict
    forward: Callable[[dict, dict], object]       # (params, batch) -> fp32 [..]
    denoise: Optional[Callable]                   # (params, batch, cached) -> [B,3,H,W]
    res: int
    num_steps: int


def _vae(args, dev, latent_channels, vae_params):
    import torch

    from unigen_tpu_torch.models import vae as vae_lib
    vae_cfg = vae_lib.tiny_vae_config(latent_channels=latent_channels)
    if vae_params is None:
        vae_params = vae_lib.init_vae_params(
            vae_cfg, gen=torch.Generator(device=dev).manual_seed(VAE_SEED), device=dev)
    return vae_cfg, vae_params


def cache_mode(args, family: str, num_steps: int):
    """The pipelines' CacheMode of the cache flags (the quantized paths'
    denoise): ``--model-cache`` reads the interval and threshold as the
    full-model cache's, ``--hybrid-model-interval`` makes the three-level
    hybrid, else the control-residual cache (with ``--cfg-cache`` for sd3).
    Exact without an interval or a threshold."""
    from unigen_tpu_torch.pipelines.caching import CacheMode, resolve_cache_mode
    if not _cached(args):
        return CacheMode()
    c, t = args.cache_interval, args.cache_threshold
    if args.hybrid_model_interval > 1:
        knobs = dict(control_cache_interval=c, model_cache_interval=args.hybrid_model_interval)
    elif args.model_cache:
        knobs = dict(model_cache_interval=c, model_cache_threshold=t,
                     cfg_cache=family == "sd3" and args.cfg_cache)
    else:
        knobs = dict(control_cache_interval=c, control_cache_threshold=t,
                     cfg_cache=family == "sd3" and args.cfg_cache)
    return resolve_cache_mode(num_steps, model_cache_order=args.model_cache_order,
                              family=family, **knobs)


def _cached(args) -> bool:
    return args.cache_interval > 1 or args.cache_threshold > 0


def _random_init(init, cfg, dev, dtype):
    """The family's random init from the tree seed, gates livened."""
    import torch

    def init_fn():
        params = init(cfg, gen=torch.Generator(device=dev).manual_seed(TREE_SEED),
                      device=dev, dtype=dtype)
        return liven_gates(params, torch.Generator(device=dev).manual_seed(GATE_SEED))
    return init_fn


# ------------------------------------------------------------ FLUX

def flux_config(args):
    """The FLUX config ``args`` name (``--ckpt``, ``--full-topology`` or
    the proxy), with ``--routing``'s batch mode."""
    from unigen_tpu_torch import config as C
    from unigen_tpu_torch import presets
    if args.ckpt:
        from unigen_tpu_torch.pipelines.loading import _subcfg, flux_backbone_from_json
        cfg = C.UniGenConfig(family="flux",
                             flux=flux_backbone_from_json(_subcfg(args.ckpt, "transformer")),
                             condition_types=("canny",))
    elif args.full_topology:
        cfg = C.UniGenConfig(
            family="flux",
            flux=C.FluxBackboneConfig(
                in_channels=64, num_layers=19, num_single_layers=38,
                attention_head_dim=128, num_attention_heads=12,
                joint_attention_dim=4096, pooled_projection_dim=768,
                axes_dims_rope=(16, 56, 56)),
            condition_types=("canny",))
    else:
        cfg = presets.flux_bench()
    if args.routing:
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, moe=dataclasses.replace(cfg.control.moe,
                                                 batch_mode=args.routing)))
    return cfg


def flux_setup(args, dev, init_fn=None, batch=None, vae_params=None) -> Setup:
    import torch

    from unigen_tpu_torch.models.unigen_flux import (init_unigen_flux_control,
                                                     init_unigen_flux_params,
                                                     unigen_flux_forward)
    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids, unpack_latents
    from unigen_tpu_torch.pipelines import scheduling

    dtype = torch.bfloat16
    cfg = flux_config(args)
    bb = cfg.flux
    res = args.res
    hw, t_len, b = res // 16, 512, 1
    s_img = hw * hw

    if init_fn is None and args.ckpt:
        from unigen_tpu_torch.io import torch_bridge as tb

        def init_fn():
            sd = tb.read_checkpoint_dir(os.path.join(args.ckpt, "transformer"))
            base = tb.load_flux_transformer(sd, bb.num_layers, bb.num_single_layers,
                                            dtype=dtype, device=dev)
            n_cn = bb.num_layers // cfg.control.single_control_dev
            n_cn_s = bb.num_single_layers // cfg.control.single_control_dev
            if args.adapter:
                control = tb.load_adapter_checkpoint(
                    args.adapter, n_cn=n_cn, n_cn_single=n_cn_s,
                    num_experts=cfg.control.moe.num_experts(cfg.condition_nums),
                    dtype=dtype, guidance=bb.guidance_embeds, device=dev)
            else:
                control = init_unigen_flux_control(
                    cfg, gen=torch.Generator(device=dev).manual_seed(TREE_SEED),
                    device=dev, dtype=dtype, base_params=base)
            return {"base": base, "control": control}
    elif init_fn is None:
        init_fn = _random_init(init_unigen_flux_params, cfg, dev, dtype)
    quantizers = {"bf16": None, "w8a8": quant.quantize_tree_streaming,
                  "w4a8_serving": quant.quantize_unigen_serving_streaming}

    def make_params(path):
        params = init_fn()
        q = quantizers[path]
        return params if q is None else q(params)

    if batch is None:
        g = torch.Generator().manual_seed(BATCH_SEED)
        ids = prepare_latent_image_ids(hw, hw).numpy()
        batch = dict(hidden=randn_host(g, b, s_img, bb.in_channels),
                     condition=randn_host(g, b, s_img, bb.in_channels),
                     encoder=randn_host(g, b, t_len, bb.joint_attention_dim),
                     pooled=randn_host(g, b, bb.pooled_projection_dim),
                     condition_pooled=randn_host(g, b, bb.pooled_projection_dim),
                     img_ids=ids, txt_ids=np.zeros((t_len, 3), np.float32),
                     condition_ids=ids)
        if args.subject:
            # condition tokens beside the image grid: the offset takes the
            # latent width (2 hw) and returns the packed grid's full width
            from unigen_tpu_torch.data.conditions import condition_id_offset
            batch["condition_ids"] = prepare_latent_image_ids(
                hw, hw, condition_id_offset("subject", 2 * hw)).numpy()

    def cast(batch):
        return {k: torch.as_tensor(v).to(dev, dtype if k in FLUX_KEYS else torch.float32)
                for k, v in batch.items()}

    def run(p, inp, timestep, **kw):
        return unigen_flux_forward(
            p, cfg, inp["hidden"], inp["condition"], inp["encoder"], inp["pooled"],
            inp["condition_pooled"], timestep, inp["img_ids"], inp["txt_ids"],
            inp["condition_ids"], **kw)

    @torch.no_grad()
    def forward(p, batch):
        inp = cast(batch)
        return run(p, inp, torch.full((b,), 0.5, dtype=dtype, device=dev))[0].float()

    num_steps = 4
    denoise = None
    if args.ssim:
        vae_cfg, vae = _vae(args, dev, bb.in_channels // 4, vae_params)
        sig = scheduling.inference_sigmas(scheduling.FlowMatchConfig(shift=1.0),
                                          num_steps)[0]
        lh = lw = hw * 2
        mode = cache_mode(args, "flux", num_steps)
        from unigen_tpu_torch.models import vae as vae_lib
        from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline

        @torch.no_grad()
        def denoise(p, batch, cached):
            inp = cast(batch)

            def fwd(lat, i, encoder, pooled, **cache):
                pred, _, outs = run(p, dict(inp, hidden=lat, encoder=encoder, pooled=pooled),
                                    torch.full((b,), float(sig[i]), dtype=dtype, device=dev),
                                    **cache)
                return pred, outs
            lat = denoise_with(UniGenFluxPipeline, mode, cached, inp["hidden"], fwd,
                               [(inp["encoder"], inp["pooled"])], sig, num_steps, 1.0)
            px = vae_lib.vae_decode(vae, vae_cfg, unpack_latents(lat.float(), lh, lw))
            return px.clamp(-1, 1)
    return Setup("flux", cfg, ("bf16", "w8a8", "w4a8_serving"), init_fn, make_params, batch,
                 forward, denoise, res, num_steps)


def flux_report(args, setup: Setup, host: dict) -> dict:
    bb = setup.cfg.flux
    topo_key = "full_depth_topology" if args.full_topology else "proxy_topology"
    out = {topo_key: f"{bb.num_layers}dbl_{bb.num_single_layers}sgl_w{bb.inner_dim}",
           "res": setup.res,
           "control_gates": "trained" if args.ckpt else "live-N(0,0.02)"}
    _cache_keys(args, out, cfg_cache=False)
    if args.subject:
        out["condition"] = "subject"
    for name in ("w8a8", "w4a8_serving"):
        rel, cos = fidelity(host[name]["fwd"], host["bf16"]["fwd"])
        out[name] = {"rel_err": round(rel, 5), "cosine": round(cos, 6)}
    if args.ssim:
        for name in ("w8a8", "w4a8_serving"):
            _ssim(args, out, name, host)
        out["e2e"] = f"{setup.num_steps}-step denoise + VAE decode @ {setup.res}px"
    return out


# ------------------------------------------------------------ SD3

def sd3_setup(args, dev, init_fn=None, batch=None, vae_params=None) -> Setup:
    import torch

    from unigen_tpu_torch import config as C
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.unigen_sd3 import (init_unigen_sd3_control,
                                                    init_unigen_sd3_params,
                                                    unigen_sd3_forward)
    from unigen_tpu_torch.ops.quant import quantize_tree_streaming
    from unigen_tpu_torch.pipelines import scheduling

    dtype = torch.bfloat16
    if args.ckpt:
        from unigen_tpu_torch.io import torch_bridge as tb
        from unigen_tpu_torch.io import torch_bridge_sd3 as tb3
        from unigen_tpu_torch.pipelines.loading import _subcfg, sd3_backbone_from_json
        cfg = C.UniGenConfig(family="sd3",
                             sd3=sd3_backbone_from_json(_subcfg(args.ckpt, "transformer")),
                             control=C.ControlConfig(use_rope=False),
                             condition_types=("depth",))
        bb = cfg.sd3
        if init_fn is None:
            def init_fn():
                sd = tb.read_checkpoint_dir(os.path.join(args.ckpt, "transformer"))
                base = tb3.load_sd3_transformer(sd, bb, dtype=dtype, device=dev)
                if args.adapter:
                    control = tb3.load_sd3_unigen_adapter(
                        tb.read_checkpoint_dir(args.adapter), bb,
                        cfg.control.num_layers or bb.num_layers,
                        cfg.control.moe.num_experts(cfg.condition_nums), dtype=dtype,
                        modulated=cfg.control.use_modulate or cfg.control.use_rope,
                        device=dev)
                else:
                    control = init_unigen_sd3_control(
                        cfg, gen=torch.Generator(device=dev).manual_seed(TREE_SEED),
                        device=dev, dtype=dtype, base_params=base)
                return {"base": base, "control": control}
    else:
        cfg = presets.sd35_medium()
        bb = cfg.sd3
        if init_fn is None:
            init_fn = _random_init(init_unigen_sd3_params, cfg, dev, dtype)
    res = args.res
    lat, t_len, b = res // 8, 77 + 256, 1

    def make_params(path):
        params = init_fn()
        if path == "bf16":
            return params
        if path == "w4a8":
            # the SD3 serving split: frozen base int4, adapter int8
            return {"base": quantize_tree_streaming(params["base"], bits=4),
                    "control": quantize_tree_streaming(params["control"], bits=8)}
        return quantize_tree_streaming(params)

    if batch is None:
        g = torch.Generator().manual_seed(BATCH_SEED)
        batch = dict(hidden=randn_host(g, b, bb.in_channels, lat, lat),
                     condition=randn_host(g, b, bb.in_channels, lat, lat),
                     encoder=randn_host(g, 2 * b, t_len, bb.joint_attention_dim),
                     pooled=randn_host(g, 2 * b, bb.pooled_projection_dim),
                     condition_pooled=randn_host(g, 2 * b, bb.pooled_projection_dim))

    def cast(batch):
        return {k: torch.as_tensor(v).to(dev, dtype) for k, v in batch.items()}

    @torch.no_grad()
    def forward(p, batch):
        inp = cast(batch)
        out, _, _ = unigen_sd3_forward(
            p, cfg, inp["hidden"], inp["condition"], inp["encoder"][:b],
            inp["pooled"][:b], inp["condition_pooled"][:b],
            torch.full((b,), 500.0, dtype=dtype, device=dev))
        return out.float()

    num_steps = 28
    denoise = None
    if args.ssim:
        sig = scheduling.inference_sigmas(scheduling.FlowMatchConfig(shift=3.0),
                                          num_steps)[0]
        vae_cfg, vae = _vae(args, dev, bb.in_channels, vae_params)
        mode = cache_mode(args, "sd3", num_steps)
        from unigen_tpu_torch.pipelines.sd3 import UniGenSD3Pipeline

        @torch.no_grad()
        def denoise(p, batch, cached):
            inp = cast(batch)
            cond2 = torch.cat([inp["condition"]] * 2)

            def t(i, n):
                return torch.full((n,), float(sig[i] * 1000.0), dtype=dtype, device=dev)

            def fwd(lat_x, i, **cache):
                # the CFG pair: the negative stream is row 0, the prompt row 1
                pred, _, outs = unigen_sd3_forward(
                    p, cfg, torch.cat([lat_x, lat_x]), cond2, inp["encoder"],
                    inp["pooled"], inp["condition_pooled"], t(i, 2 * b), **cache)
                return pred, outs

            def fwd_pos(lat_x, i, residuals):
                return unigen_sd3_forward(
                    p, cfg, lat_x, inp["condition"], inp["encoder"][b:], inp["pooled"][b:],
                    inp["condition_pooled"][b:], t(i, b), control_residuals=residuals)[0]
            lat_x = denoise_with(UniGenSD3Pipeline, mode, cached, inp["hidden"], fwd,
                                 fwd_pos, sig, num_steps, 7.0)
            return vae_lib.vae_decode(vae, vae_cfg, lat_x.float()).clamp(-1, 1)
    return Setup("sd3", cfg, ("bf16", "w8a8", "w4a8"), init_fn, make_params, batch, forward,
                 denoise, res, num_steps)


def sd3_report(args, setup: Setup, host: dict) -> dict:
    bb = setup.cfg.sd3
    out = {"family": "sd3", "topology": f"sd3_{bb.num_layers}blk_w{bb.inner_dim}",
           "weights": "real-ckpt" if args.ckpt else "random-init",
           "control_gates": "trained" if args.ckpt else "live-N(0,0.02)",
           "res": setup.res}
    _cache_keys(args, out, cfg_cache=True)
    for name in ("w8a8", "w4a8"):
        rel, cos = fidelity(host[name]["fwd"], host["bf16"]["fwd"])
        out[name] = {"rel_err": round(rel, 5), "cosine": round(cos, 6)}
        if args.ssim:
            _ssim(args, out, name, host)
    if args.ssim:
        out["e2e"] = f"{setup.num_steps}-step CFG denoise + VAE decode @ {setup.res}px"
    return out


# ------------------------------------------------------------ SANA

def sana_setup(args, dev, init_fn=None, batch=None, vae_params=None) -> Setup:
    import torch

    from unigen_tpu_torch import config as C
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.sana import (init_sana_unigen_control,
                                              init_sana_unigen_params,
                                              sana_unigen_forward)
    from unigen_tpu_torch.ops.quant import quantize_tree_streaming
    from unigen_tpu_torch.pipelines import scheduling

    dtype = torch.bfloat16
    control = C.ControlConfig(moe=C.MoEConfig(batch_mode="per_sample"))
    if args.ckpt:
        from unigen_tpu_torch.io import torch_bridge as tb
        from unigen_tpu_torch.io import torch_bridge_sd3 as tb3
        from unigen_tpu_torch.pipelines.loading import _subcfg, sana_backbone_from_json
        cfg = C.UniGenConfig(family="sana",
                             sana=sana_backbone_from_json(_subcfg(args.ckpt, "transformer")),
                             control=control, condition_types=("canny",))
        bb = cfg.sana
        if init_fn is None:
            def init_fn():
                sd = tb.read_checkpoint_dir(os.path.join(args.ckpt, "transformer"))
                base = tb3.load_sana_transformer(sd, bb, dtype=dtype, device=dev)
                if args.adapter:
                    ctrl = tb3.load_sana_unigen_adapter(
                        tb.read_checkpoint_dir(args.adapter), bb,
                        cfg.control.num_layers or bb.num_layers,
                        cfg.control.moe.num_experts(cfg.condition_nums), dtype=dtype,
                        device=dev)
                else:
                    ctrl = init_sana_unigen_control(
                        cfg, gen=torch.Generator(device=dev).manual_seed(TREE_SEED),
                        device=dev, dtype=dtype, base_params=base)
                return {"base": base, "control": ctrl}
    else:
        cfg = C.UniGenConfig(family="sana", sana=C.SanaBackboneConfig(), control=control,
                             condition_types=("canny",))
        bb = cfg.sana
        if init_fn is None:
            init_fn = _random_init(init_sana_unigen_params, cfg, dev, dtype)
    # the JAX script's quirk: its default 256 becomes 512 for SANA
    res = args.res if args.res != 256 else 512
    lat, t_len, b = res // 32, 300, 1

    def make_params(path):
        params = init_fn()
        return params if path == "bf16" else quantize_tree_streaming(params)

    if batch is None:
        g = torch.Generator().manual_seed(BATCH_SEED)
        batch = dict(hidden=randn_host(g, b, bb.in_channels, lat, lat),
                     condition=randn_host(g, b, bb.in_channels, lat, lat),
                     encoder=randn_host(g, b, t_len, bb.caption_channels),
                     pooled=randn_host(g, b, bb.pooled_projection_dim),
                     condition_pooled=randn_host(g, b, bb.pooled_projection_dim))

    def cast(batch):
        return {k: torch.as_tensor(v).to(dev, dtype) for k, v in batch.items()}

    def run(p, inp, lat_x, ts, **kw):
        return sana_unigen_forward(p, cfg, lat_x, inp["condition"], inp["encoder"],
                                   inp["pooled"], inp["condition_pooled"],
                                   torch.full((b,), ts, dtype=dtype, device=dev), **kw)

    @torch.no_grad()
    def forward(p, batch):
        inp = cast(batch)
        return run(p, inp, inp["hidden"], 500.0)[0].float()

    num_steps = 20
    denoise = None
    if args.ssim:
        sig = scheduling.inference_sigmas(scheduling.FlowMatchConfig(shift=3.0),
                                          num_steps)[0]
        vae_cfg, vae = _vae(args, dev, bb.in_channels, vae_params)
        mode = cache_mode(args, "sana", num_steps)
        from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline

        @torch.no_grad()
        def denoise(p, batch, cached):
            inp = cast(batch)

            def fwd(lat_x, i, **cache):
                pred, _, outs = run(p, inp, lat_x, float(sig[i] * 1000.0), **cache)
                return pred, outs
            lat_x = denoise_with(UniGenSanaPipeline, mode, cached, inp["hidden"], fwd, sig,
                                 num_steps)
            return vae_lib.vae_decode(vae, vae_cfg, lat_x.float()).clamp(-1, 1)
    return Setup("sana", cfg, ("bf16", "w8a8"), init_fn, make_params, batch, forward, denoise,
                 res, num_steps)


def sana_report(args, setup: Setup, host: dict) -> dict:
    bb = setup.cfg.sana
    rel, cos = fidelity(host["w8a8"]["fwd"], host["bf16"]["fwd"])
    out = {"family": "sana", "topology": f"sana_{bb.num_layers}blk_w{bb.inner_dim}",
           "weights": "real-ckpt" if args.ckpt else "random-init",
           "res": setup.res,
           "control_gates": "trained" if args.ckpt else "live-N(0,0.02)",
           "w8a8": {"rel_err": round(rel, 5), "cosine": round(cos, 6)}}
    _cache_keys(args, out, cfg_cache=False)
    if args.ssim:
        _ssim(args, out, "w8a8", host)
        out["e2e"] = f"{setup.num_steps}-step denoise + VAE decode @ {setup.res}px"
    return out


def _cache_keys(args, out, cfg_cache):
    if args.cache_interval > 1:
        out["cache_interval"] = args.cache_interval
    if args.cache_threshold > 0:
        out["cache_threshold"] = args.cache_threshold
    if cfg_cache and args.cfg_cache:
        out["cfg_cache"] = True
    if args.model_cache:
        out["model_cache"] = True
    if args.hybrid_model_interval > 1:
        out["hybrid_model_interval"] = args.hybrid_model_interval


def _ssim(args, out, name, host):
    from unigen_tpu_torch.eval import image_metrics
    m = image_metrics(host["bf16"]["img"], host[name]["img"], device=args.device)
    out[name]["e2e_ssim"] = round(m["ssim"], 5)
    out[name]["e2e_psnr"] = round(m["psnr"], 2)


SETUPS = {"flux": (flux_setup, flux_report), "sd3": (sd3_setup, sd3_report),
          "sana": (sana_setup, sana_report)}


def setup_for(args, *, init_fn=None, batch=None, vae_params=None) -> Setup:
    """The measurement ``args`` describe on ``--device``."""
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    return SETUPS[args.family][0](args, dev, init_fn=init_fn, batch=batch,
                                  vae_params=vae_params)


def run_paths(args, setup: Setup) -> dict:
    """Each path in turn: build its tree, run the forward (and with
    ``--ssim`` the denoise, exact for bf16 and under the cache flags for the
    quantized paths), pull the outputs to the host, free the tree. ->
    {path: {"fwd", "img"?, "seconds", "peak_bytes"}}."""
    import torch

    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    host = {}
    for path in setup.paths:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        params = setup.make_params(path)
        rec = {"fwd": setup.forward(params, setup.batch).cpu().numpy()}
        if setup.denoise is not None:
            rec["img"] = to_u8(setup.denoise(params, setup.batch,
                                             path != "bf16" and _cached(args)).cpu())
        del params
        sync(dev)
        free(dev)
        rec["seconds"] = time.time() - t0
        rec["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                             else None)
        host[path] = rec
        print(f"# {setup.family} {path} path done in {rec['seconds']:.1f}s, peak "
              f"{rec['peak_bytes']} bytes", file=sys.stderr, flush=True)
    return host


def main(argv=None, *, init_fn=None, batch=None, vae_params=None) -> dict:
    """Measure what the arguments describe; print the JSON line (and write
    it where ``--out`` says). ``init_fn() -> tree``: a fresh unquantized
    bf16 {base, control} tree on the device for each path, in place of the
    random init or ``--ckpt``'s load; ``batch``: the host inputs (numpy, the
    JAX script's keys); ``vae_params``: the tiny VAE's tree. -> {"json":
    the report, "host": each path's outputs, seconds and peak bytes}."""
    args = parse_args(argv)
    setup = setup_for(args, init_fn=init_fn, batch=batch, vae_params=vae_params)
    host = run_paths(args, setup)
    out = SETUPS[args.family][1](args, setup, host)
    line = json.dumps(out)
    print(line, flush=True)
    if args.full_topology and args.family == "flux":
        if args.out:
            try:
                with open(args.out) as f:
                    merged = json.load(f)
            except (FileNotFoundError, json.JSONDecodeError):
                merged = {}
            merged["full_depth"] = out
            with open(args.out, "w") as f:
                json.dump(merged, f)
                f.write("\n")
    elif args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return {"json": out, "host": host}


if __name__ == "__main__":
    main()
