"""The evaluation entry point (port of ``scripts/eval.py``): SSIM, PSNR and
MAE between the ``res.png`` and ``target.png`` of every
``{index}/`` directory that ``cli.infer`` writes, and on request the
Fréchet distance between the two sets and DISTS per pair.

    python -m unigen_tpu_torch.cli.eval --results_dir output/infer \
        --fid --dists --extractor vgg16:vgg16.pth

``--extractor``: ``test`` (a fixed random VGG16: the plumbing, not a
comparable score), ``vgg16:<file>`` (a torchvision ``vgg16`` state dict
saved by ``torch.save``) or ``dinov2:<dir>`` (a
Depth-Anything-small directory in transformers' layout: FD-DINOv2 through
its backbone; it serves ``--fid`` only). The metrics run on the card, in
fp32 with TF32 off, or on the CPU with ``--device cpu``. The aggregate is
printed as one JSON line and, with ``--out``, written with the per-image
rows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="UniGen artifact evaluation")
    p.add_argument("--results_dir", required=True,
                   help="dir of {index}/target.png,res.png from cli.infer")
    p.add_argument("--against", default="target.png",
                   help="filename to compare res.png against")
    p.add_argument("--out", default=None, help="write metrics json here")
    p.add_argument("--fid", action="store_true",
                   help="Fréchet distance between the res.png and target "
                        "sets (distribution-level, needs >=2 pairs)")
    p.add_argument("--dists", action="store_true",
                   help="DISTS perceptual distance per pair (arXiv:2004.07728)")
    p.add_argument("--extractor", default="test",
                   help="feature tower for --fid/--dists: 'test' (fixed "
                        "random VGG16: the plumbing, not a comparable "
                        "metric), 'vgg16:<torch .pth/.bin>' "
                        "(torchvision vgg16 state dict), or 'dinov2:<checkpoint "
                        "dir>' (FD-DINOv2 through the Depth-Anything backbone)")
    p.add_argument("--device", default="cuda",
                   help="the card to compute on; 'cpu' computes on the CPU")
    return p.parse_args(argv)


@contextlib.contextmanager
def _fp32_exact():
    """TF32 off for the metrics' fp32 convolutions and products, restored
    after."""
    import torch
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def main(argv=None):
    """Evaluate ``--results_dir``; -> the aggregate dict that is printed."""
    args = parse_args(argv)
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.eval import image_metrics
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)

    rows = []
    with _fp32_exact():
        for name in sorted(os.listdir(args.results_dir)):
            d = os.path.join(args.results_dir, name)
            res_p = os.path.join(d, "res.png")
            tgt_p = os.path.join(d, args.against)
            if not (os.path.isdir(d) and os.path.exists(res_p) and os.path.exists(tgt_p)):
                continue
            res = np.asarray(Image.open(res_p).convert("RGB"))
            tgt = np.asarray(Image.open(tgt_p).convert("RGB"))
            if res.shape != tgt.shape:
                continue
            m = image_metrics(tgt, res, device=dev)
            m["index"] = name
            m["_paths"] = (res_p, tgt_p)
            rows.append(m)

        if not rows:
            out = {"error": "no comparable image pairs found"}
            print(json.dumps(out))
            return out
        agg = {k: float(np.mean([r[k] for r in rows])) for k in ("ssim", "psnr", "mae")}
        agg["count"] = len(rows)

        if args.fid or args.dists:
            agg.update(_feature_metrics(args, rows, dev))

    for r in rows:
        r.pop("_paths", None)
    print(json.dumps(agg))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"aggregate": agg, "per_image": rows}, f, indent=2)
    return agg


def _load_pixels(path, dev):
    """PNG -> [1, 3, H, W] float32 in [0, 1] on ``dev``."""
    import numpy as np
    import torch
    from PIL import Image
    a = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(a.transpose(2, 0, 1)[None])).to(dev)


def make_extractor(spec: str, dev):
    """-> (feature_fn(pixels [B, 3, H, W] in [0, 1]) -> [B, D] numpy, the
    VGG16 params for --dists or None). See --extractor for the registry."""
    import numpy as np
    import torch

    from unigen_tpu_torch.models import vgg as vgg_lib

    def vgg_features(params):
        def feats(px):
            with torch.no_grad():
                return vgg_lib.vgg16_fid_features(params, px).to("cpu").numpy()
        return feats

    if spec == "test":
        params = [{k: v.to(dev) for k, v in p.items()}
                  for p in vgg_lib.init_vgg16_params(torch.Generator().manual_seed(0))]
        return vgg_features(params), params
    if spec.startswith("vgg16:"):
        from unigen_tpu_torch.io.torch_bridge import read_torch_bin
        params = vgg_lib.load_vgg16_features(read_torch_bin(spec[6:]), device=dev)
        return vgg_features(params), params
    if spec.startswith("dinov2:"):
        from unigen_tpu_torch.io.torch_bridge import load_depth_anything, read_checkpoint_dir
        from unigen_tpu_torch.models import depth as depth_lib
        dcfg = depth_lib.DepthAnythingConfig()
        dparams = load_depth_anything(read_checkpoint_dir(spec[7:]), dcfg, device=dev)
        mean = torch.as_tensor(vgg_lib.IMAGENET_MEAN, device=dev)[None, :, None, None]
        std = torch.as_tensor(vgg_lib.IMAGENET_STD, device=dev)[None, :, None, None]

        def feats(px):
            with torch.no_grad():
                out = depth_lib.dinov2_features(dparams, dcfg, (px - mean) / std)
            return out.to("cpu").numpy()
        return feats, None
    raise SystemExit(f"--extractor {spec!r}: expected test | vgg16:<path> | dinov2:<dir>")


def _feature_metrics(args, rows, dev) -> dict:
    """--fid / --dists over the collected pairs (host float64 statistics)."""
    import numpy as np
    import torch

    from unigen_tpu_torch import eval as E

    feature_fn, vgg_params = make_extractor(args.extractor, dev)
    if args.dists and vgg_params is None:
        raise SystemExit("--dists needs a VGG16 extractor (test or vgg16:<path>)")
    out = {"extractor": args.extractor}
    if args.extractor == "test":
        out["extractor_note"] = ("random-init tower: validates the metric "
                                 "plumbing, not a comparable score")
    stats_res = stats_tgt = None
    dists_vals = []
    for r in rows:
        res_p, tgt_p = r["_paths"]
        res_px, tgt_px = _load_pixels(res_p, dev), _load_pixels(tgt_p, dev)
        if args.fid:
            fr = feature_fn(res_px)
            ft = feature_fn(tgt_px)
            if stats_res is None:
                stats_res = E.FeatureStats(fr.shape[1])
                stats_tgt = E.FeatureStats(ft.shape[1])
            stats_res.update(fr)
            stats_tgt.update(ft)
        if args.dists:
            with torch.no_grad():
                val = float(E.dists(vgg_params, res_px, tgt_px)[0])
            r["dists"] = val
            dists_vals.append(val)
    if args.fid:
        if stats_res is None or stats_res.n < 2:
            out["fid"] = None
            out["fid_note"] = "needs >= 2 image pairs"
        else:
            out["fid"] = E.frechet_distance(*stats_res.finalize(), *stats_tgt.finalize())
    if args.dists:
        out["dists"] = float(np.mean(dists_vals)) if dists_vals else None
    return out


if __name__ == "__main__":
    main()
