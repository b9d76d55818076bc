"""Train-step phase attribution per remat policy (port of
``scripts/profile_train.py``), on the production loss
(``train_step.make_loss_builder``, the closure ``make_train_step``
differentiates):

  fwd      the loss alone
  fwd+bwd  the loss and its gradients (``torch.autograd.grad``)
  step     ``make_train_step`` (forward, backward, clip, AdamW)

for each policy of ``--remats``: "full" (every block body checkpointed),
"dots" (the weight products' outputs saved, the rest recomputed) or "none".
``bwd_ms`` = fwd+bwd - fwd and ``opt_ms`` = step - fwd+bwd. Each time is
the minimum over 3 bursts of 2 calls after a first call, ended by a device
synchronisation; the step's state flows from one call into the next, and
every call reads the same draws (noise and timesteps from a generator
seeded 2).

    python -m unigen_tpu_torch.cli.profile_train --preset full \
        --remats full,dots --out train_profile.json

The trees: ``full`` is the full-topology W4A8 serving tree (``io/from_jax``
fills it leaf by leaf from seed 0) split by ``ops/quant.split_trainable``;
``trainbench`` the reduced-depth preset with an int4 base and a floating
control; ``tiny`` all fp32 at 64² (8 text tokens). ``mfu`` is the
step's model FLOPs (3 x ``model_flops_per_forward`` x batch) over the
step's time and the card's dense int8 peak (``peak_ops`` in the JSON,
looked up by the card's name); on the CPU both are null. Only an
out-of-memory error becomes a policy's ``error`` row; any other error ends
the run. The flags replace the JAX script's environment variables:
``--preset`` (UNIGEN_BENCH_PRESET), ``--remats`` (UNIGEN_TRAIN_REMATS),
``--batch`` (UNIGEN_BENCH_TRAIN_BATCH), ``--res`` (UNIGEN_BENCH_RES),
``--accum`` (UNIGEN_BENCH_TRAIN_ACCUM), ``--out`` (the JSON's file; none
is written without it) and ``--device``. ``main`` also takes a tree.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

BURSTS, CALLS = 3, 2
T_LEN = 512               # text tokens of the full and trainbench presets
#: dense int8 peak operations per second by ``torch.cuda.get_device_name()``
INT8_PEAK_OPS = {"NVIDIA H100 80GB HBM3": 1979e12}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train-step phases per remat policy")
    p.add_argument("--preset", default="full", choices=["full", "trainbench", "tiny"])
    p.add_argument("--remats", default="full,dots",
                   help="comma-separated remat policies (full, dots, none)")
    p.add_argument("--batch", type=int, default=1, help="micro-batch")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--accum", type=int, default=1, help="gradient accumulation steps")
    p.add_argument("--out", default=None, help="write the JSON line here too")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    args.remats = [x.strip() for x in args.remats.split(",")]
    bad = [x for x in args.remats if x not in ("full", "dots", "none")]
    if bad:
        p.error(f"--remats: unknown policies {bad}")
    return args


def model_flops_per_forward(cfg, s_img: int, s_txt: int, s_cond: int) -> float:
    """Dense matmul FLOPs of one UniGenFlux forward (2*m*n*k terms + attention),
    the benchmark's count (``bench.py``'s function of the same name)."""
    bb = cfg.flux
    d = bb.inner_dim
    s_all = s_img + s_txt

    def attn_flops(s_q, s_kv):
        return 2 * s_q * s_kv * d * 2  # qk^T + pv

    # per token: double block = qkv+o (4 d^2 MACs) + 2-linear 4x MLP (8 d^2 MACs)
    double = 2 * (4 * d * d) * s_all + 2 * (8 * d * d) * s_all + attn_flops(s_all, s_all)
    single = 2 * (3 * d * d + 4 * d * d + 5 * d * d) * s_all + attn_flops(s_all, s_all)
    total = (bb.num_layers * double + bb.num_single_layers * single
             + bb.num_layers * double  # control double applied per base block
             + bb.num_single_layers * single  # control single per base block
             )
    # MoE (capacity ~= tokens) + shared expert (2 double blocks over img+cond)
    total += 2 * (4 * d * d) * (s_img + s_cond) * 2  # modulated experts
    total += 2 * (2 * (4 * d * d) * (s_img + s_cond) * 3)  # shared-expert weave approx
    return float(total)


def peak_ops(device_name: str) -> float:
    """The card's dense int8 peak; raises for a card the table lacks."""
    try:
        return INT8_PEAK_OPS[device_name]
    except KeyError:
        raise KeyError(f"no int8 peak recorded for {device_name!r}; known: "
                       f"{sorted(INT8_PEAK_OPS)}") from None


def preset_config(name: str):
    from unigen_tpu_torch import presets
    return {"tiny": presets.tiny, "trainbench": presets.flux_train_bench}.get(
        name, presets.flux_full)()


def init_trees(cfg, preset: str, dev):
    """The random tree of ``preset`` from seed 0."""
    import torch

    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
    from unigen_tpu_torch.ops.quant import quantize_tree
    gen = torch.Generator(device=dev).manual_seed(0)
    if preset == "full":
        return init_quantized_serving_params(cfg, device=dev, generator=gen)
    if preset == "trainbench":
        p = init_unigen_flux_params(cfg, gen=gen, device=dev, dtype=torch.bfloat16)
        return {"base": quantize_tree(p["base"], bits=4), "control": p["control"]}
    return init_unigen_flux_params(cfg, gen=gen, device=dev)


def split(params, preset: str):
    """(trainable, frozen argument) of a tree: the W4A8 tree's float leaves
    train (``split_trainable``), otherwise the whole control tree."""
    from unigen_tpu_torch.ops.quant import split_trainable
    if preset == "full":
        trainable, frozen = split_trainable(params["control"])
        return trainable, {"base": params["base"], "control_frozen": frozen}
    return params["control"], params["base"]


def make_batch(cfg, preset: str, b: int, res: int, dev) -> tuple:
    """(batch, the step's draws, latent side, text length) from the batch
    seed 1 and the draw seed 2."""
    import torch

    from unigen_tpu_torch.train import train_step as ts
    bb = cfg.flux
    dtype = torch.float32 if preset == "tiny" else torch.bfloat16
    lat_hw, t_len = res // 8, T_LEN
    if preset == "tiny":
        res, lat_hw, t_len = 64, 8, 8
    c_lat = bb.in_channels // 4
    g = torch.Generator(device=dev).manual_seed(1)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
    batch = {"latents": mk(b, c_lat, lat_hw, lat_hw),
             "condition_latents": mk(b, c_lat, lat_hw, lat_hw),
             "prompt_embeds": mk(b, t_len, bb.joint_attention_dim),
             "pooled": mk(b, bb.pooled_projection_dim),
             "condition_pooled": mk(b, bb.pooled_projection_dim)}
    draws = ts.draw(batch, torch.Generator(device=dev).manual_seed(2), "none",
                    ts.rts_draw_shape(cfg, batch["latents"].shape))
    return batch, draws, res, t_len


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, arg0, dev, thread=False):
    """-> (ms, first call s, first call's output). ``thread``: ``fn``
    returns (state, ...) and each call's state feeds the next."""
    t0 = time.perf_counter()
    out = first = fn(arg0)
    _sync(dev)
    first_s = time.perf_counter() - t0
    if thread:
        arg0 = out[0]
    times = []
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            out = fn(arg0)
            if thread:
                arg0 = out[0]
        _sync(dev)
        times.append((time.perf_counter() - t0) / CALLS)
    return min(times) * 1e3, first_s, first


def loss_and_grads(loss_fn, control):
    """The loss of ``control`` and its gradients with respect to the
    floating leaves, as ``make_train_step`` takes them."""
    import torch

    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.utils import tree_leaves, tree_map
    control = tree_map(lambda x: x.detach().requires_grad_(x.is_floating_point()), control)
    leaves = [t for t in tree_leaves(control) if t.requires_grad]
    with quant.quant_backward("bf16"):
        loss, _ = loss_fn(control)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


def profile_policy(cfg, policy: str, args, trainable, frozen_arg, batch, draws, dev):
    """One policy's row: fwd, fwd+bwd and step times, and the first step's
    loss and metrics."""
    import torch

    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.train import train_step as ts
    tcfg = TrainConfig(train_batch_size=args.batch, remat=policy,
                       gradient_accumulation_steps=args.accum)
    builder = ts.make_loss_builder(cfg, tcfg)
    loss_fn = builder(frozen_arg, batch, draws)
    row = {}

    def fwd(control):
        with torch.no_grad():
            return loss_fn(control)[0]
    ms, cs, _ = timeit(fwd, trainable, dev)
    row["fwd_ms"] = round(ms, 1)
    print(f"# {policy:5s} fwd      {ms:8.1f} ms (first call {cs:.1f}s)",
          file=sys.stderr, flush=True)
    ms, cs, _ = timeit(lambda c: loss_and_grads(loss_fn, c), trainable, dev)
    row["fwd_bwd_ms"] = round(ms, 1)
    print(f"# {policy:5s} fwd+bwd  {ms:8.1f} ms (first call {cs:.1f}s)",
          file=sys.stderr, flush=True)
    step = ts.make_train_step(cfg, tcfg)
    state = ts.init_train_state(trainable, tcfg)
    ms, cs, first = timeit(lambda s: step(s, frozen_arg, batch, draws=draws), state, dev,
                           thread=True)
    row["step_ms"] = round(ms, 1)
    row["bwd_ms"] = round(row["fwd_bwd_ms"] - row["fwd_ms"], 1)
    row["opt_ms"] = round(row["step_ms"] - row["fwd_bwd_ms"], 1)
    row["first_step_loss"] = float(first[1]["step_loss"])
    print(f"# {policy:5s} step     {ms:8.1f} ms (first call {cs:.1f}s)",
          file=sys.stderr, flush=True)
    return row


def main(argv=None, *, params=None) -> dict:
    """Profile what the arguments describe; print the JSON line (and write
    it to ``--out``). ``params``: a tree of ``--preset``'s layout on the
    device in place of the random one. -> the report."""
    args = parse_args(argv)
    import torch

    from unigen_tpu_torch.ops.quant import quantized_bytes
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    peak = peak_ops(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    t0 = time.time()
    if params is None:
        params = init_trees(cfg, args.preset, dev)
    trainable, frozen_arg = split(params, args.preset)
    print(f"# profile_train init {time.time() - t0:.1f}s preset={args.preset} "
          f"resident={quantized_bytes(params) / 2**30:.2f}GiB", file=sys.stderr, flush=True)
    batch, draws, res, t_len = make_batch(cfg, args.preset, args.batch, args.res, dev)
    s_img = (res // 16) ** 2
    flops_step = 3 * model_flops_per_forward(cfg, s_img, t_len, s_img) * args.batch
    rows = {}
    for policy in args.remats:
        try:
            row = profile_policy(cfg, policy, args, trainable, frozen_arg, batch, draws,
                                 dev)
            if peak is not None:
                row["mfu"] = round(flops_step / (row["step_ms"] / 1e3) / peak, 3)
            row["samples_per_sec"] = round(args.batch / (row["step_ms"] / 1e3), 3)
        except torch.cuda.OutOfMemoryError as e:
            row = {"error": f"OutOfMemoryError: {str(e)[:300]}"}
            print(f"# {policy} failed: {row['error']}", file=sys.stderr, flush=True)
        rows[policy] = row
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out = {"preset": args.preset, "res": res, "batch": args.batch, "accum": args.accum,
           "weights": "random", "flops_step_model": flops_step, "peak_ops": peak,
           "policies": rows}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
