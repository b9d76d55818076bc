"""The inference entry point (port of ``scripts/infer.py``, the reference's
infer.py:36-247): one image from a prompt and a control image, or the
held-out split of a Subjects-200K directory generated batch by batch with
its target, result and condition images and an ``info.json`` manifest.

    python -m unigen_tpu_torch.cli.infer --basemodel UniGenSD3 \
        --pretrained_model_name_or_path SD35_DIR --ckpt_path ADAPTER_DIR \
        --condition_types depth --quantize w4a8 --quantize_text w4a8 \
        --prompt "a red cube" --control_image depth.png --save_path out

Without ``--prompt`` it reads ``--data_path``'s test split and writes
``{save_path}/{i:05d}/{target,res,condition}.png``. The flags and defaults
are ``scripts/infer.py``'s (the [sic] ``MultiCondtionUniGenFlux`` spelling
is the reference's), plus ``--device`` (the card unless "cpu" is named)
and ``--dtype`` (the load dtype; by default the family loader's: bf16 for
FLUX, fp32 for SD3 and SANA). ``load_pipeline`` builds the pipeline the
flags describe; ``main`` also takes an already-loaded pipeline, for
callers that build their own (a host without tokenizers sets stub ones on
it).
"""

from __future__ import annotations

import argparse
import json
import os

FAMILIES = {"UniGenFlux": "flux", "MultiCondtionUniGenFlux": "flux",
            "UniGenSD3": "sd3", "SANAUniGen": "sana"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="UniGen inference")
    p.add_argument("--basemodel", default="UniGenFlux",
                   choices=["UniGenFlux", "MultiCondtionUniGenFlux",
                            "UniGenSD3", "SANAUniGen"],
                   help="model family (reference infer.py:115-121 "
                        "eval(basemodel).from_pretrained; the [sic] "
                        "multi-condition spelling is the reference's)")
    p.add_argument("--clip_dir", default=None,
                   help="SANAUniGen only: CLIP-L directory for the pooled "
                        "prompt/condition stream")
    p.add_argument("--pretrained_model_name_or_path", required=True)
    p.add_argument("--ckpt_path", default=None, help="UniGen adapter dir")
    p.add_argument("--data_path", default=None)
    p.add_argument("--save_path", default="output/infer")
    p.add_argument("--condition_types", nargs="+", default=["canny"])
    p.add_argument("--prompt", default=None, help="single-prompt mode")
    p.add_argument("--control_image", default=None, nargs="+",
                   help="control image path(s); MultiCondtionUniGenFlux "
                        "pairs one per --condition_types entry")
    p.add_argument("--quantize", default=None, choices=["w8a8", "w4a8", "bf16"],
                   help="serving quantization of the loaded transformer tree "
                        "(the streaming walk; the knob serve uses). Default "
                        "keeps the load dtype")
    p.add_argument("--quantize_text", default=None, choices=["w8a8", "w4a8"],
                   help="serving quantization of the prompt-encoder towers "
                        "(T5/CLIP/Gemma). Default keeps the load dtype")
    p.add_argument("--num_inference_steps", type=int, default=28)
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--true_cfg_scale", type=float, default=1.0)
    p.add_argument("--conditioning_scale", type=float, default=1.0)
    p.add_argument("--control_cache_interval", type=int, default=1,
                   help="recompute the control branch every k-th step")
    p.add_argument("--control_cache_threshold", type=float, default=0.0,
                   help="adaptive variant: refresh when the latent drifts "
                        "more than this relative L1 since the last refresh")
    p.add_argument("--cfg_cache", action="store_true",
                   help="with a caching mode + true_cfg_scale>1: replay "
                        "steps skip the negative stream and reuse the "
                        "cached guidance delta")
    p.add_argument("--model_cache_interval", type=int, default=1,
                   help="full-model output caching: replay steps reuse the "
                        "cached prediction; with a larger "
                        "--control_cache_interval that it divides, the "
                        "three-level hybrid cache")
    p.add_argument("--model_cache_threshold", type=float, default=0.0,
                   help="adaptive variant of --model_cache_interval")
    p.add_argument("--model_cache_order", type=int, default=0, choices=[0, 1],
                   help="0 = zero-order hold, 1 = first-order Taylor "
                        "extrapolation from the two most recent refreshes")
    p.add_argument("--residual_cache_bits", type=int, default=16, choices=[4, 8, 16],
                   help="8 stores the control-residual cache int8 with "
                        "per-token scales, 4 packs int4; requires a "
                        "control-cache or hybrid mode")
    p.add_argument("--quality_profile", default=None,
                   choices=["exact", "balanced", "fast"],
                   help="named serving operating point; mutually exclusive "
                        "with the raw cache knobs")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--max_sequence_length", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--max_samples", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lora_dir", default=None,
                   help="per-condition LoRA experts (reference hook.py "
                        "per-adapter layout); auto-switched by condition type")
    p.add_argument("--cn_config", type=str, default=None,
                   help="reference-format control config YAML "
                        "(config/unigen.yaml layout); the --single_* flags "
                        "override it")
    p.add_argument("--single_control_dev", type=int, default=2)
    p.add_argument("--single_block_control_method", default="overall_add")
    p.add_argument("--disable_single_trans_blocks", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    p.add_argument("--dtype", default=None, choices=["bf16", "fp32"],
                   help="load dtype of the transformer and T5/Gemma trees "
                        "(default: the family loader's, bf16 for FLUX, fp32 "
                        "for SD3 and SANA)")
    return p.parse_args(argv)


def load_pipeline(args):
    """The pipeline ``args`` describe, loaded from
    ``--pretrained_model_name_or_path`` onto ``--device``."""
    import torch

    from unigen_tpu_torch.config import control_overrides_from_yaml
    from unigen_tpu_torch.pipelines.loading import (load_flux_pipeline,
                                                    load_sana_pipeline,
                                                    load_sd3_pipeline)
    family = FAMILIES[args.basemodel]
    if args.lora_dir and family != "flux":
        raise SystemExit("--lora_dir: per-condition LoRA experts are wired for the "
                         "flux family")
    try:
        control_overrides = control_overrides_from_yaml(args.cn_config)
    except ValueError as e:
        raise SystemExit(f"--cn_config: {e}")
    control_overrides.update(
        single_control_dev=args.single_control_dev,
        single_block_control_method=args.single_block_control_method,
        use_single_trans_blocks=not args.disable_single_trans_blocks)
    quantize = None if args.quantize == "bf16" else args.quantize
    kw = dict(condition_types=args.condition_types, adapter_dir=args.ckpt_path,
              quantize=quantize, quantize_text=args.quantize_text,
              control_overrides=control_overrides, device=args.device)
    if args.dtype is not None:
        kw["dtype"] = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    root = args.pretrained_model_name_or_path
    if family == "flux":
        return load_flux_pipeline(root, lora_dir=args.lora_dir, **kw)
    if family == "sd3":
        return load_sd3_pipeline(root, **kw)
    return load_sana_pipeline(root, clip_dir=args.clip_dir, **kw)


def main(argv=None, *, pipeline=None):
    """Run the inference the arguments describe. ``pipeline``: an already
    loaded pipeline of ``--basemodel``'s family to use instead of loading
    ``--pretrained_model_name_or_path``."""
    args = parse_args(argv)
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.data import conditions as C
    from unigen_tpu_torch.data.datasets import Subjects200K
    from unigen_tpu_torch.observability import param_report, setup_logging

    os.makedirs(args.save_path, exist_ok=True)
    logger = setup_logging(args.save_path)
    family = FAMILIES[args.basemodel]
    pipe = pipeline if pipeline is not None else load_pipeline(args)
    if pipe.cfg.family != family:
        raise SystemExit(f"--basemodel {args.basemodel} needs a {family} pipeline; "
                         f"got {pipe.cfg.family}")
    param_report(pipe.params["base"], "base")
    param_report(pipe.params["control"], "adapter")

    cache_kw = dict(control_cache_interval=args.control_cache_interval,
                    control_cache_threshold=args.control_cache_threshold,
                    model_cache_interval=args.model_cache_interval,
                    model_cache_threshold=args.model_cache_threshold,
                    model_cache_order=args.model_cache_order,
                    residual_cache_bits=args.residual_cache_bits,
                    quality_profile=args.quality_profile)

    def run_pipe(prompts, control, seed):
        # a batch takes one condition name per sample (SD3's classifier-free
        # guidance doubles the rows, and one pooled condition row does not
        # broadcast over them)
        cond = (args.condition_types[0] if isinstance(prompts, str)
                else [args.condition_types[0]] * len(prompts))
        kw = dict(condition_prompt=cond, control_image=control,
                  height=args.resolution, width=args.resolution,
                  num_inference_steps=args.num_inference_steps,
                  conditioning_scale=args.conditioning_scale, seed=seed, **cache_kw)
        if family == "flux":
            kw.update(guidance_scale=args.guidance_scale,
                      true_cfg_scale=args.true_cfg_scale, cfg_cache=args.cfg_cache)
        elif family == "sd3":
            kw.update(guidance_scale=args.guidance_scale, cfg_cache=args.cfg_cache)
        return pipe(prompt=prompts, **kw).numpy()

    if args.prompt is not None:
        def load_control(path):
            img = np.asarray(Image.open(path).convert("RGB")
                             .resize((args.resolution, args.resolution)))
            return C.to_model_range(img)[None]

        if not args.control_image:
            raise SystemExit("--prompt needs --control_image")
        if args.basemodel == "MultiCondtionUniGenFlux" and len(args.condition_types) > 1:
            # joint control (reference UniGenPipeline.py:809-1134): one
            # control image per condition type
            if len(args.control_image) != len(args.condition_types):
                raise SystemExit("--control_image count must match --condition_types")
            imgs = pipe.multi_condition_call(
                args.prompt, condition_prompts=list(args.condition_types),
                control_images=[load_control(p) for p in args.control_image],
                height=args.resolution, width=args.resolution,
                num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                conditioning_scale=args.conditioning_scale,
                seed=args.seed, **cache_kw).numpy()
        else:
            imgs = run_pipe(args.prompt, load_control(args.control_image[0]), args.seed)
        out = os.path.join(args.save_path, "res.png")
        Image.fromarray(imgs[0]).save(out)
        logger.info("saved %s", out)
        return

    # batched test-set generation (reference infer.py:160-232)
    ds = Subjects200K(args.data_path, args.condition_types[0],
                      resolution=args.resolution, split="test")
    n = min(len(ds), args.max_samples)
    manifest = []
    for start in range(0, n, args.batch_size):
        idxs = range(start, min(start + args.batch_size, n))
        samples = [ds[i] for i in idxs]
        control = np.stack([C.to_model_range(s["condition_image"]) for s in samples])
        prompts = [s["descriptions"] for s in samples]
        imgs = run_pipe(prompts, control, args.seed + start)
        for j, (i, s) in enumerate(zip(idxs, samples)):
            d = os.path.join(args.save_path, f"{i:05d}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(s["target_image"]).save(os.path.join(d, "target.png"))
            Image.fromarray(imgs[j]).save(os.path.join(d, "res.png"))
            Image.fromarray(s["condition_image"]).save(os.path.join(d, "condition.png"))
            manifest.append({"index": i, "prompt": s["descriptions"],
                             "condition": args.condition_types[0]})
        logger.info("generated %d/%d", min(start + args.batch_size, n), n)
    with open(os.path.join(args.save_path, "info.json"), "w") as f:
        json.dump(manifest, f, indent=2)


if __name__ == "__main__":
    main()
