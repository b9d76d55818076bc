"""One-image controllable generation (port of ``examples/generate.py``).

With ``--ckpt`` (a diffusers FLUX.1 directory) the pipeline is loaded with
``load_flux_pipeline``, ``--image`` is resized to 512² (``RESOLUTION``) and
turned into the ``--condition`` control image (``data/conditions.synthesize``),
and the pipeline's call at that size writes ``--out``:

    python -m unigen_tpu_torch.cli.generate --ckpt FLUX_DIR --image in.png \
        --condition canny --steps 4 --out out.png

Without ``--ckpt`` a randomly initialised tiny model runs the whole
pipeline (control image -> VAE encode -> condition-weaving denoise -> VAE
decode): the FLUX demo (32x32) or, with ``--family sana``, the SANA demo.
The tiny FLUX model's head dim (16) has no attention kernel on the card
(its kernels take 64 and 128), so the FLUX demo runs with ``--device
cpu`` and refuses the card, as ``cli.serve --demo`` does; the SANA demo
runs on either. The flags are the example's, plus ``--device`` (the card
unless "cpu" is named) and ``--seed`` (the random trees and inputs).
``main`` also takes an already-loaded pipeline.
"""

from __future__ import annotations

import argparse

RESOLUTION = 512          # the control image's side with --ckpt (the example's)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="UniGen one-image generation")
    p.add_argument("--ckpt", default=None, help="diffusers-layout FLUX dir")
    p.add_argument("--family", default="flux", choices=["flux", "sana"],
                   help="model family for the random tiny demo")
    p.add_argument("--prompt", default="a cat wearing a hat")
    p.add_argument("--condition", default="canny")
    p.add_argument("--image", default=None, help="control image path")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--out", default="out.png")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random trees, inputs and noise")
    return p.parse_args(argv)


def load_pipeline(args):
    """The FLUX pipeline of ``--ckpt`` on ``--device``."""
    from unigen_tpu_torch.pipelines.loading import load_flux_pipeline
    return load_flux_pipeline(args.ckpt, condition_types=[args.condition],
                              device=args.device)


def control_image(args):
    """``--image`` at RESOLUTION², turned into the condition in [-1, 1],
    [1, 3, H, W]."""
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.data import conditions as C
    if not args.image:
        raise SystemExit("--ckpt needs --image (the control image)")
    img = np.asarray(Image.open(args.image).convert("RGB").resize((RESOLUTION, RESOLUTION)))
    return C.to_model_range(C.synthesize(args.condition, img))[None]


def sana_demo(args, dev):
    """The random tiny SANA pipeline's image: uint8 [1, H, W, 3]."""
    import numpy as np
    import torch

    from unigen_tpu_torch import config as cfg_lib
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.sana import init_sana_unigen_params
    from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline

    sana = cfg_lib.tiny_sana_config()
    ucfg = cfg_lib.UniGenConfig(family="sana", sana=sana, condition_types=(args.condition,))
    params = init_sana_unigen_params(
        ucfg, gen=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    vae_cfg = vae_lib.tiny_vae_config(latent_channels=sana.in_channels)
    vae_params = vae_lib.init_vae_params(
        vae_cfg, gen=torch.Generator(device=dev).manual_seed(args.seed + 1), device=dev)
    pipe = UniGenSanaPipeline(
        cfg=ucfg, params=params,
        ae_encode=lambda px: vae_lib.vae_encode(vae_params, vae_cfg, px),
        ae_decode=lambda lat: vae_lib.vae_decode(vae_params, vae_cfg, lat),
        ae_downscale=vae_cfg.downscale, device=dev)
    res = 8 * vae_cfg.downscale
    g = torch.Generator().manual_seed(args.seed + 2)
    return pipe.generate(
        prompt_embeds=torch.randn(1, 8, sana.caption_channels, generator=g),
        prompt_mask=torch.ones(1, 8, dtype=torch.int32),
        pooled=torch.randn(1, sana.pooled_projection_dim, generator=g),
        cond_pooled=torch.zeros(1, sana.pooled_projection_dim),
        control_pixels=np.zeros((1, 3, res, res), np.float32),
        height=res, width=res, num_inference_steps=args.steps, seed=args.seed)


def flux_demo(args, dev):
    """The random tiny FLUX pipeline's image: uint8 [1, 32, 32, 3]."""
    import numpy as np
    import torch

    from unigen_tpu_torch import presets
    from unigen_tpu_torch.data import conditions as C
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline

    if dev.type == "cuda":
        raise SystemExit("the tiny FLUX demo's head dim (16) has no attention kernel on "
                         "the card (64 and 128 only): run it with --device cpu, or give "
                         "--ckpt")
    cfg = presets.tiny((args.condition,))
    params = init_unigen_flux_params(
        cfg, gen=torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    vae_cfg = vae_lib.tiny_vae_config(latent_channels=cfg.flux.in_channels // 4)
    vae_params = vae_lib.init_vae_params(
        vae_cfg, gen=torch.Generator(device=dev).manual_seed(args.seed + 1), device=dev)
    pipe = UniGenFluxPipeline(cfg=cfg, params=params, vae_cfg=vae_cfg,
                              vae_params=vae_params, dtype=torch.float32, device=dev)
    h = w = 32
    rng = np.random.default_rng(args.seed)
    control_u8 = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    control = C.to_model_range(C.synthesize("canny", control_u8))[None]
    g = torch.Generator().manual_seed(args.seed + 2)
    return pipe.generate(
        prompt_embeds=torch.randn(1, 8, cfg.flux.joint_attention_dim, generator=g),
        pooled=torch.randn(1, cfg.flux.pooled_projection_dim, generator=g),
        cond_pooled=torch.randn(1, cfg.flux.pooled_projection_dim, generator=g),
        control_pixels=torch.as_tensor(control, dtype=torch.float32),
        height=h, width=w, num_inference_steps=args.steps, seed=args.seed)


def main(argv=None, *, pipeline=None):
    """Generate the image the arguments describe and write ``--out``.
    ``pipeline``: an already-loaded FLUX pipeline used in place of loading
    ``--ckpt``. -> the image, uint8 [H, W, 3]."""
    args = parse_args(argv)
    from PIL import Image

    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    if args.ckpt or pipeline is not None:
        pipe = pipeline if pipeline is not None else load_pipeline(args)
        imgs = pipe(prompt=args.prompt, condition_prompt=args.condition,
                    control_image=control_image(args), height=RESOLUTION,
                    width=RESOLUTION, num_inference_steps=args.steps, seed=args.seed)
    elif args.family == "sana":
        print("no --ckpt given: running the random tiny SANA demo")
        imgs = sana_demo(args, dev)
    else:
        print("no --ckpt given: running the random tiny demo model")
        imgs = flux_demo(args, dev)
    img = imgs[0].cpu().numpy() if hasattr(imgs[0], "cpu") else imgs[0]
    Image.fromarray(img).save(args.out)
    print(f"wrote {args.out} ({img.shape})")
    return img


if __name__ == "__main__":
    main()
