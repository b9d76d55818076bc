"""The serving entry point (port of ``scripts/serve.py``): a family pipeline
(``--family flux|sd3|sana``) behind ``serving.MicroBatchServer``, or with
``--step-server`` behind the step-level ``StepServer`` (one bucket per
resolution with ``--resolutions``). Requests arrive as JSON lines, on
stdin by default, and images leave as PNGs whose paths are printed:

  {"prompt": "a cat", "condition": "canny", "control": "path/in.png",
   "out": "path/out.png"}

Under ``--step-server`` a request may also carry ``steps``, ``guidance``,
``control_start``, ``control_end``, ``conditioning_scale``, ``priority``,
``timeout``, ``seed``, ``resolution`` and (sd3) ``negative``, and
``{"cancel": "path/out.png"}`` abandons that request while it is in
flight.

    python -m unigen_tpu_torch.cli.serve --family sd3 --ckpt SD35_DIR \
        --adapter ADAPTER_DIR --quant w4a8 --quant-text w4a8 --step-server \
        --batch-size 4 < requests.jsonl

The step server runs at the loaded pipeline's dtype. The flags and
defaults are ``scripts/serve.py``'s, plus ``--device`` (the
card unless "cpu" is named), ``--dtype`` (the load dtype; by default the
family loader's) and ``--max-wait-ms`` (the request-batched server's
batching window). ``--demo`` (or no ``--ckpt``) serves a tiny random FLUX
model with synthetic load instead. ``--mesh-*`` above 1 waits for the port
of the parallel layer (ROADMAP Queue 1 item 8). ``main`` also takes an
already-loaded pipeline and a stream of request lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
import time
import weakref

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="UniGen serving on one CUDA card")
    ap.add_argument("--ckpt", help="diffusers checkpoint dir (family layout)")
    ap.add_argument("--family", default="flux", choices=["flux", "sd3", "sana"],
                    help="model family served from --ckpt (flux: FLUX.1 "
                         "layout; sd3: SD3.5 triple-encoder layout; sana: "
                         "SANA layout with Gemma-2 text encoder + native "
                         "DC-AE)")
    ap.add_argument("--clip-dir", default=None,
                    help="sana only: CLIP-L dir for the pooled prompt/"
                         "condition stream")
    ap.add_argument("--guidance-scale", type=float, default=None,
                    help="override the family's default guidance scale "
                         "(flux embedded guidance / sd3 CFG; sana has none)")
    ap.add_argument("--adapter", help="UniGen adapter dir")
    ap.add_argument("--condition-types", nargs="+", default=["canny"])
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--batch-sizes", type=int, nargs="+", default=None,
                    help="program-size ladder (e.g. 1 2 8): each dispatch "
                         "runs the smallest batch that fits")
    ap.add_argument("--lora-dir", default=None,
                    help="per-condition LoRA experts (reference per-adapter "
                         "layout); switched by condition type")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--control-cache-interval", type=int, default=1,
                    help="recompute the control branch every k-th denoise "
                         "step, replay cached residual adds in between")
    ap.add_argument("--control-cache-threshold", type=float, default=0.0,
                    help="adaptive variant: refresh the control cache when "
                         "the latent drifts more than this relative L1 "
                         "since the last refresh")
    ap.add_argument("--model-cache-interval", type=int, default=1,
                    help="full-model output caching: replay steps reuse the "
                         "cached prediction; with a larger "
                         "--control-cache-interval that it divides, the "
                         "three-level hybrid cache")
    ap.add_argument("--model-cache-threshold", type=float, default=0.0,
                    help="adaptive variant of --model-cache-interval")
    ap.add_argument("--adaptive-lag", type=int, default=0, choices=[0, 1],
                    help="step-server adaptive modes only: 1 = drift "
                         "decisions one tick stale")
    ap.add_argument("--model-cache-order", type=int, default=0, choices=[0, 1],
                    help="0 = zero-order hold, 1 = first-order Taylor "
                         "extrapolation from the two most recent refreshes")
    ap.add_argument("--residual-cache-bits", type=int, default=16, choices=[4, 8, 16],
                    help="8 stores the control-residual cache int8 with "
                         "per-token scales, 4 packs int4; requires a "
                         "control-cache or hybrid mode")
    ap.add_argument("--quality-profile", default=None,
                    choices=["exact", "balanced", "fast"],
                    help="named serving operating point: exact = no caching; "
                         "balanced = the hybrid cache; fast = the full-model "
                         "cache. Mutually exclusive with the raw cache knobs")
    ap.add_argument("--prompt-cache", type=int, default=32,
                    help="LRU size for prompt/condition embeddings (0 "
                         "disables)")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel mesh axis (waits for ROADMAP Queue 1 "
                         "item 8)")
    ap.add_argument("--mesh-expert", type=int, default=1,
                    help="expert-parallel mesh axis (waits for item 8)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel mesh axis (waits for item 8)")
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--quant", default="w4a8", choices=["w4a8", "w8a8", "bf16"])
    ap.add_argument("--quant-text", default=None, choices=["w8a8", "w4a8"],
                    help="serving quantization for the prompt-encoder towers "
                         "(T5/CLIP/Gemma). Default keeps the load dtype")
    ap.add_argument("--serving-cache", default=None,
                    help="directory for the persisted quantized transformer "
                         "tree (io/serving_cache): restarts read it instead "
                         "of the checkpoint and the quantization; written on "
                         "first start when missing")
    ap.add_argument("--step-server", action="store_true",
                    help="step-level continuous batching (serving_steps."
                         "StepServer): requests join mid-denoise at their own "
                         "step index; sd3 slots carry the CFG pair (JSON key "
                         "'negative' sets the negative prompt)")
    ap.add_argument("--resolutions", default=None,
                    help="step-server only: comma-separated 'res[:slots]' "
                         "list (e.g. '512:4,1024:2'): one StepServer bucket "
                         "per resolution over one weight tree; requests "
                         "route by the JSON 'resolution' key")
    ap.add_argument("--stats-every", type=int, default=0,
                    help="step-server: print a stats() snapshot to stderr "
                         "every N completed requests (0 = only at drain)")
    ap.add_argument("--max-waiters", type=int, default=None,
                    help="step-server backpressure: reject wait=True "
                         "admissions beyond this many queued waiters")
    ap.add_argument("--multi-tick", type=int, default=1,
                    help="step-server, exact schedule only: run up to K "
                         "consecutive ticks in one window when every slot "
                         "is busy")
    ap.add_argument("--warmup", action="store_true",
                    help="step-server only: run the serving ladder with "
                         "synthetic requests before reading requests")
    ap.add_argument("--demo", action="store_true",
                    help="tiny random model + synthetic load (no checkpoint)")
    ap.add_argument("--device", default="cuda",
                    help="the card to serve on; 'cpu' runs the plain versions "
                         "of the kernels on the CPU")
    ap.add_argument("--dtype", default=None, choices=["bf16", "fp32"],
                    help="load dtype of the transformer and T5/Gemma trees "
                         "(default: the family loader's)")
    ap.add_argument("--max-wait-ms", type=float, default=50.0,
                    help="request-batched server: the longest an incomplete "
                         "batch waits for more requests")
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The refusals that need no model (``ap.error`` exits with code 2),
    and ``--quality-profile`` under ``--step-server`` resolved to the
    family's fixed per-slot intervals at ``--steps`` (so "fast" on a short
    schedule takes the point its ``min_steps`` gate allows)."""
    if args.adaptive_lag and not (args.step_server and (
            args.model_cache_threshold > 0 or args.control_cache_threshold > 0)):
        ap.error("--adaptive-lag 1 needs --step-server with an adaptive "
                 "--*-cache-threshold (it pipelines the per-tick drift "
                 "decision; one-shot pipelines have no tick to hide)")
    if args.step_server and args.quality_profile:
        from unigen_tpu_torch.pipelines import caching
        try:
            knobs = caching.quality_profile_knobs(
                args.quality_profile, caching.PROFILE_TABLES[args.family],
                dict(control_cache_interval=args.control_cache_interval,
                     model_cache_interval=args.model_cache_interval,
                     model_cache_order=args.model_cache_order,
                     control_cache_threshold=args.control_cache_threshold,
                     model_cache_threshold=args.model_cache_threshold,
                     residual_cache_bits=(args.residual_cache_bits
                                          if args.residual_cache_bits != 16 else 0)),
                num_steps=args.steps)
        except ValueError as e:
            ap.error(str(e))
        for k in ("control_cache_interval", "model_cache_interval",
                  "model_cache_order", "residual_cache_bits"):
            setattr(args, k, knobs.get(k, getattr(args, k)))
        print(f"# quality-profile {args.quality_profile} -> per-slot "
              f"control_cache_interval={args.control_cache_interval} "
              f"model_cache_interval={args.model_cache_interval} "
              f"model_cache_order={args.model_cache_order} "
              f"residual_cache_bits={args.residual_cache_bits}", file=sys.stderr)
        args.quality_profile = None      # consumed: the StepServer takes knobs
    if args.multi_tick > 1:
        if not args.step_server:
            ap.error("--multi-tick is wired for --step-server")
        if (args.model_cache_interval > 1 or args.control_cache_interval > 1
                or args.model_cache_threshold > 0 or args.control_cache_threshold > 0):
            ap.error("--multi-tick runs exact ticks only; drop the cache/adaptive "
                     "knobs (or a --quality-profile that maps to them)")
    if args.warmup and not args.step_server:
        ap.error("--warmup is wired for --step-server (the request-batched "
                 "server warms each batch size on first use)")
    if args.resolutions and not args.step_server:
        ap.error("--resolutions (mixed-resolution buckets) is wired for "
                 "--step-server; the request-batched server is single-"
                 "resolution (--resolution)")
    mesh = {"--mesh-data": args.mesh_data, "--mesh-expert": args.mesh_expert,
            "--mesh-model": args.mesh_model}
    wide = [f"{k} {v}" for k, v in mesh.items() if v > 1]
    if wide:
        raise SystemExit(f"{', '.join(wide)}: serving on more than one card waits for "
                         "the port of unigen_tpu/parallel (ROADMAP Queue 1 item 8)")


# ------------------------------------------------------------ demos

def _tiny_flux(args, per_sample: bool):
    import torch

    from unigen_tpu_torch import config as cfg_lib
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    control = (cfg_lib.ControlConfig(moe=cfg_lib.MoEConfig(batch_mode="per_sample"))
               if per_sample else cfg_lib.ControlConfig())
    cfg = cfg_lib.UniGenConfig(family="flux", flux=cfg_lib.tiny_flux_config(),
                               condition_types=("canny",), control=control)
    params = init_unigen_flux_params(cfg, gen=torch.Generator(device=dev).manual_seed(0),
                                     device=dev)
    return cfg, params, dev


def _demo_steps(args) -> dict:
    """The tiny random StepServer demo: the whole request lifecycle (VAE
    encode on admission, per-slot denoise ticks, VAE decode on retirement)
    for 2 x slots + 1 requests of mixed step counts (3-5) and keep-windows,
    at the cache knobs given. -> its summary."""
    import torch

    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.serving_steps import StepServer
    cfg, params, dev = _tiny_flux(args, per_sample=True)
    vae_cfg = vae_lib.tiny_vae_config(latent_channels=cfg.flux.in_channels // 4)
    vae_params = vae_lib.init_vae_params(
        vae_cfg, gen=torch.Generator(device=dev).manual_seed(1), device=dev)
    b = args.batch_size
    srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=b,
                     num_inference_steps=4, height=32, width=32,
                     model_cache_interval=args.model_cache_interval,
                     model_cache_order=args.model_cache_order,
                     control_cache_interval=args.control_cache_interval,
                     model_cache_threshold=args.model_cache_threshold,
                     control_cache_threshold=args.control_cache_threshold,
                     adaptive_lag=args.adaptive_lag,
                     residual_cache_bits=args.residual_cache_bits,
                     dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    bb = cfg.flux
    n_req = 2 * b + 1
    t0 = time.time()
    per_req = [dict(num_inference_steps=3 + (i % 3), control_guidance_end=1.0 - 0.2 * (i % 2))
               for i in range(n_req)]
    try:
        futs = [srv.submit(prompt_embeds=mk(1, 16, bb.joint_attention_dim),
                           pooled=mk(1, bb.pooled_projection_dim),
                           cond_pooled=mk(1, bb.pooled_projection_dim),
                           control_pixels=mk(1, 3, 32, 32), wait=True, **k)
                for k in per_req]
        outs = [f.result(timeout=600) for f in futs]
        dt = time.time() - t0
        st = srv.stats()
    finally:
        srv.close()
    print(f"step-server demo: {n_req} requests in {dt:.2f}s ({n_req / dt:.1f} req/s, "
          f"{b} slots, model_cache_interval={args.model_cache_interval}, mixed "
          f"per-request steps 3-5); out shape {tuple(outs[0].shape)}; "
          f"stats {json.dumps(st)}")
    return dict(requests=n_req, out_shape=list(outs[0].shape), stats=st)


def _demo(args) -> dict:
    """The tiny random request-batched demo: 3 x batch + 1 forward requests
    through MicroBatchServer. -> its summary."""
    import torch

    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    from unigen_tpu_torch.serving import MicroBatchServer
    cfg, params, dev = _tiny_flux(args, per_sample=False)
    bb = cfg.flux
    hw, t = 8, 16
    s = hw * hw
    ids = prepare_latent_image_ids(hw, hw, device=dev)
    tids = torch.zeros(t, 3, device=dev)

    @torch.no_grad()
    def program(inputs):
        x = {k: torch.as_tensor(v).to(dev) for k, v in inputs.items()}
        pred, _, _ = unigen_flux_forward(
            params, cfg, x["hidden"], x["condition"], x["encoder"], x["pooled"],
            x["cond_pooled"], torch.full((x["hidden"].shape[0],), 0.5, device=dev),
            ids, tids, ids)
        return pred

    srv = MicroBatchServer(program, batch_size=args.batch_size, max_wait_ms=25)
    rng = np.random.default_rng(0)
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    n_req = 3 * args.batch_size + 1
    t0 = time.time()
    try:
        futs = [srv.submit(hidden=mk(1, s, bb.in_channels), condition=mk(1, s, bb.in_channels),
                           encoder=mk(1, t, bb.joint_attention_dim),
                           pooled=mk(1, bb.pooled_projection_dim),
                           cond_pooled=mk(1, bb.pooled_projection_dim))
                for _ in range(n_req)]
        outs = [f.result(timeout=600) for f in futs]
        dt = time.time() - t0
    finally:
        srv.close()
    print(f"demo: {n_req} requests in {dt:.2f}s ({n_req / dt:.1f} req/s), "
          f"{srv.stats.batches} batches, {srv.stats.padded_samples} padded samples; "
          f"out shape {tuple(outs[0].shape)}")
    return dict(requests=n_req, out_shape=list(outs[0].shape), batches=srv.stats.batches,
                padded_samples=srv.stats.padded_samples)


# ------------------------------------------------------------ checkpoints

def load_pipeline(args):
    """The pipeline ``--family`` and ``--ckpt`` describe, on ``--device``,
    with the prompt LRU and the LoRA expert of the first condition type."""
    import torch

    from unigen_tpu_torch.pipelines.loading import (load_flux_pipeline,
                                                    load_sana_pipeline,
                                                    load_sd3_pipeline)
    kw = dict(condition_types=args.condition_types, adapter_dir=args.adapter,
              quantize=None if args.quant == "bf16" else args.quant,
              quantize_text=args.quant_text, device=args.device)
    if args.dtype is not None:
        kw["dtype"] = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if args.family == "flux":
        return load_flux_pipeline(args.ckpt, lora_dir=args.lora_dir,
                                  serving_cache=args.serving_cache, **kw)
    if args.family == "sd3":
        return load_sd3_pipeline(args.ckpt, **kw)
    return load_sana_pipeline(args.ckpt, clip_dir=args.clip_dir, **kw)


def _control(path: str, res: int) -> np.ndarray:
    """A control image file -> [1, 3, res, res] float32 in [-1, 1] (Lanczos
    resize, as the JAX server)."""
    from PIL import Image
    pil = Image.open(path).convert("RGB").resize((res, res), Image.LANCZOS)
    return (np.asarray(pil, np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None]


def _encode(pipe, family: str, req: dict, cond_name: str) -> dict:
    """A request's prompt streams as the server takes them."""
    out = {}
    if family == "sana":
        embeds, mask = pipe.encode_prompt(req["prompt"])
        out["pooled"] = pipe.encode_pooled(req["prompt"])
        out["cond_pooled"] = pipe.encode_pooled(cond_name)
        out["prompt_mask"] = mask
    else:
        embeds, out["pooled"] = pipe.encode_prompt(req["prompt"])
        out["cond_pooled"] = pipe.encode_condition_prompt(cond_name)
    out["prompt_embeds"] = embeds
    return out


class _Saver:
    """Done-callbacks that save each image to its path, print the path and
    record the request's latency; every ``stats_every`` images a stats
    snapshot goes to stderr. The server is held weakly, so a closed server
    is freed by reference counting alone."""

    def __init__(self, srv=None, stats_every: int = 0):
        self.srv = weakref.ref(srv) if srv is not None else None
        self.stats_every = stats_every
        self.done = itertools.count(1)
        self.latency_s = {}
        self.saved = []

    def __call__(self, out_path: str, t_submit: float):
        def cb(fut):
            from PIL import Image
            if fut.cancelled() or fut.exception() is not None:
                print(f"# {out_path}: "
                      f"{'cancelled' if fut.cancelled() else fut.exception()}",
                      file=sys.stderr)
                return
            Image.fromarray(np.asarray(fut.result()[0])).save(out_path)
            self.latency_s[out_path] = time.perf_counter() - t_submit
            self.saved.append(out_path)
            print(out_path, flush=True)
            srv = self.srv() if self.srv is not None else None
            if self.stats_every and next(self.done) % self.stats_every == 0 and srv:
                print(f"# stats: {json.dumps(srv.stats())}", file=sys.stderr)
        return cb


def _serve_steps(pipe, args, stdin) -> dict:
    """The StepServer loop: each request is admitted into a free slot as
    soon as one exists (a blocking submit keeps the slots full under load)."""
    from unigen_tpu_torch.serving_steps import (AdmissionRejected,
                                                MultiResolutionStepServer, StepServer)
    cfg = pipe.cfg
    # the StepServer needs row-independent routing
    cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, moe=dataclasses.replace(cfg.control.moe, batch_mode="per_sample")))
    if cfg.family == "sana":
        kw = dict(ae_encode=pipe.ae_encode, ae_decode=pipe.ae_decode,
                  ae_downscale=pipe.ae_downscale)
    else:
        kw = dict(vae_cfg=pipe.vae_cfg, vae_params=pipe.vae_params)
    if cfg.family == "sd3":
        kw["guidance_scale"] = 7.0 if args.guidance_scale is None else args.guidance_scale
    common = dict(batch_size=args.batch_size, num_inference_steps=args.steps,
                  scheduler=pipe.scheduler,
                  model_cache_interval=args.model_cache_interval,
                  model_cache_order=args.model_cache_order,
                  control_cache_interval=args.control_cache_interval,
                  model_cache_threshold=args.model_cache_threshold,
                  control_cache_threshold=args.control_cache_threshold,
                  adaptive_lag=args.adaptive_lag,
                  residual_cache_bits=args.residual_cache_bits,
                  max_waiters=args.max_waiters, multi_tick=args.multi_tick,
                  dtype=pipe.dtype, device=pipe.device, **kw)
    if args.resolutions:
        buckets = {}
        for part in args.resolutions.split(","):
            r, _, s = part.partition(":")
            buckets[int(r)] = dict(batch_size=int(s)) if s else {}
        buckets.setdefault(args.resolution, {})
        srv = MultiResolutionStepServer(cfg, pipe.params, buckets=buckets, **common)
    else:
        srv = StepServer(cfg, pipe.params, height=args.resolution, width=args.resolution,
                         **common)
    saver = _Saver(srv, args.stats_every)
    t0 = time.perf_counter()
    try:
        if args.warmup:
            tw = time.time()
            we = pipe.encode_prompt("warmup")[0]
            t_len = we.shape[2] if cfg.family == "sd3" and we.ndim == 4 else we.shape[1]
            n = srv.warmup(int(t_len))
            print(f"# warmup: {n} synthetic requests (t_len={t_len}) in "
                  f"{time.time() - tw:.1f}s", file=sys.stderr)
        print(f"# step-server ready: slots={args.batch_size} steps={args.steps} "
              f"res={args.resolution} quant={args.quant} "
              f"model_cache_interval={args.model_cache_interval} "
              f"control_cache_interval={args.control_cache_interval}; "
              f"JSON lines on stdin", file=sys.stderr)
        t0 = time.perf_counter()
        pending = {}                  # out path -> in-flight Future
        cancels = {}
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            req = json.loads(line)
            if "cancel" in req:
                # best effort: a request whose image already landed refuses
                f = pending.get(req["cancel"])
                ok = bool(f is not None and f.cancel())
                cancels[req["cancel"]] = ok
                print(f"# cancel {req['cancel']}: {'ok' if ok else 'not pending'}",
                      file=sys.stderr)
                continue
            r = int(req.get("resolution", args.resolution))
            cond_name = req.get("condition", args.condition_types[0])
            x = _encode(pipe, cfg.family, req, cond_name)
            if cfg.family == "sd3" and req.get("negative"):
                x["neg_embeds"], x["neg_pooled"] = pipe.encode_prompt(req["negative"])
            for json_key, kw_key in (("steps", "num_inference_steps"),
                                     ("guidance", "guidance_scale"),
                                     ("control_start", "control_guidance_start"),
                                     ("control_end", "control_guidance_end"),
                                     ("conditioning_scale", "conditioning_scale"),
                                     ("priority", "priority"), ("timeout", "timeout"),
                                     ("seed", "seed")):
                if json_key in req:
                    x[kw_key] = req[json_key]
            t_submit = time.perf_counter()
            try:
                fut = srv.submit(control_pixels=_control(req["control"], r), wait=True, **x)
            except (TimeoutError, AdmissionRejected) as e:
                # shed this request and keep serving; other errors surface
                print(f"# {req['out']}: rejected ({e})", file=sys.stderr)
                continue
            pending[req["out"]] = fut
            fut.add_done_callback(saver(req["out"], t_submit))
            fut.add_done_callback(lambda _f, k=req["out"]: pending.pop(k, None))
        srv.drain()
        wall = time.perf_counter() - t0
        st = srv.stats()
    finally:
        srv.close()
    print(f"# step-server stats: {json.dumps(st)}", file=sys.stderr)
    return dict(saved=saver.saved, latency_s=saver.latency_s, cancels=cancels,
                wall_s=wall, stats=st)


def _serve_batched(pipe, args, stdin) -> dict:
    """The request-batched loop: MicroBatchServer collects up to
    ``--batch-size`` requests and runs ``pipe.generate`` on them at the
    server's fixed resolution."""
    from unigen_tpu_torch.serving import MicroBatchServer
    fam = pipe.cfg.family

    def run_batch(inputs):
        kw = dict(height=args.resolution, width=args.resolution,
                  num_inference_steps=args.steps,
                  control_cache_interval=args.control_cache_interval,
                  control_cache_threshold=args.control_cache_threshold,
                  model_cache_interval=args.model_cache_interval,
                  model_cache_threshold=args.model_cache_threshold,
                  model_cache_order=args.model_cache_order,
                  residual_cache_bits=args.residual_cache_bits,
                  quality_profile=args.quality_profile)
        if fam != "sana" and args.guidance_scale is not None:
            kw["guidance_scale"] = args.guidance_scale
        return pipe.generate(**inputs, **kw)

    srv = MicroBatchServer(run_batch, batch_size=args.batch_size,
                           batch_sizes=args.batch_sizes, max_wait_ms=args.max_wait_ms)
    print(f"# serving ready: family={fam} batch={args.batch_size} steps={args.steps} "
          f"res={args.resolution} quant={args.quant}; JSON lines on stdin",
          file=sys.stderr)
    saver = _Saver()
    t0 = time.perf_counter()
    try:
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            req = json.loads(line)
            # every control image takes the server's resolution: a batch is
            # one shape
            x = _encode(pipe, fam, req, req.get("condition", args.condition_types[0]))
            t_submit = time.perf_counter()
            fut = srv.submit(control_pixels=_control(req["control"], args.resolution), **x)
            fut.add_done_callback(saver(req["out"], t_submit))
    finally:
        srv.close()          # drains; the callbacks have all run at join()
    stats = dataclasses.asdict(srv.stats)
    return dict(saved=saver.saved, latency_s=saver.latency_s,
                wall_s=time.perf_counter() - t0, stats=stats)


def main(argv=None, *, pipeline=None, stdin=None):
    """Serve what the arguments describe. ``pipeline``: an already loaded
    pipeline of ``--family`` instead of loading ``--ckpt``; ``stdin``: the
    stream of request lines (default ``sys.stdin``). -> a summary: the
    saved paths, each one's latency in seconds, the wall time and the
    server's stats (a demo's own summary under ``--demo``)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    if pipeline is None and (args.demo or not args.ckpt):
        return _demo_steps(args) if args.step_server else _demo(args)
    if args.family != "flux":
        for flag, name in ((args.lora_dir, "--lora-dir"),
                           (args.serving_cache, "--serving-cache")):
            if flag:
                ap.error(f"{name} is wired for the flux family")

    pipe = pipeline if pipeline is not None else load_pipeline(args)
    if pipe.cfg.family != args.family:
        raise SystemExit(f"--family {args.family} needs a {args.family} pipeline; "
                         f"got {pipe.cfg.family}")
    if args.prompt_cache > 0:
        from unigen_tpu_torch.pipelines.caching import PromptLRU
        pipe.prompt_cache_size = args.prompt_cache
        pipe._prompt_cache = PromptLRU(args.prompt_cache)
    if args.lora_dir and args.condition_types:
        pipe._auto_switch(args.condition_types[0])
    stream = sys.stdin if stdin is None else stdin
    if args.step_server:
        return _serve_steps(pipe, args, stream)
    return _serve_batched(pipe, args, stream)


if __name__ == "__main__":
    main()
