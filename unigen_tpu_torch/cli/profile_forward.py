"""Per-phase forward time (port of ``scripts/profile_forward.py``): at the
benchmark's shapes, each phase of a UniGen-FLUX forward timed on its own:

  embed      the input, context and time embedders and the rope table
  attn       the RoPE attention kernel alone at the stream length, run
             n_base + n_single times with a carry dependence
  double     the base double-block stack alone
  double_cn  the double stack with its control blocks and gated adds
  moe        the MoE preprocess (route, experts, shared-expert weave)
  single     the base single-block stack alone
  single_cn  the single stack with its control blocks
  full       unigen_flux_forward

The phases need not sum to ``full``; their differences
(``control_double_ms``, ``control_single_ms``) attribute the control branch.
Each phase's first call is reported apart (``first_call_s``: the kernels
build on first use; nothing compiles), then the time is the minimum over 3
bursts of 4 calls, each burst ended by a device synchronisation.

    python -m unigen_tpu_torch.cli.profile_forward --preset full --quant w4a8 \
        --batches 1,2 --res 512 --out profile.json

The flags replace the JAX script's environment variables:
``--preset proxy|full|tiny`` (UNIGEN_BENCH_PRESET), ``--quant
bf16|w8a8|w4a8`` (UNIGEN_BENCH_QUANT), ``--batches`` (UNIGEN_PROFILE_BATCHES
/ UNIGEN_PROFILE_BATCH), ``--res`` (UNIGEN_BENCH_RES), ``--phases``
(UNIGEN_PROFILE_PHASES) and ``--out`` (UNIGEN_PROFILE_OUT); ``--device``
names the card (or "cpu"). Random trees come from a ``torch.Generator``
seeded 0 (W4A8 filled leaf by leaf as ``io/from_jax`` fills the serving
tree; W8A8 through ``ops/quant.quantize_tree``), inputs from one seeded 1.
A phase that fails ends the run. ``main`` also takes a tree.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

PHASES = ("embed", "attn", "double", "double_cn", "moe", "single", "single_cn", "full")
BURSTS, CALLS = 3, 4
T_LEN = 512


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="per-phase UniGen-FLUX forward time")
    p.add_argument("--preset", default="proxy", choices=["proxy", "full", "tiny"],
                   help="presets.flux_bench (proxy), flux_full or tiny")
    p.add_argument("--quant", default="bf16", choices=["bf16", "w8a8", "w4a8"])
    p.add_argument("--batches", default="2",
                   help="comma-separated batch sizes; more than one gives the sweep "
                        "form with the per-image scaling of each phase")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--phases", default=None,
                   help=f"comma-separated subset of {','.join(PHASES)} (default all)")
    p.add_argument("--out", default=None, help="write the JSON line here too")
    p.add_argument("--device", default="cuda",
                   help="the card to run on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    try:
        args.batches = [int(x) for x in args.batches.split(",")]
    except ValueError:
        p.error(f"--batches: comma-separated integers, got {args.batches!r}")
    args.phases = (list(PHASES) if args.phases is None
                   else [x.strip() for x in args.phases.split(",")])
    unknown = [x for x in args.phases if x not in PHASES]
    if unknown:
        p.error(f"--phases: unknown {unknown}; choose from {list(PHASES)}")
    return args


def preset_config(name: str):
    from unigen_tpu_torch import presets
    return {"full": presets.flux_full, "tiny": presets.tiny}.get(name, presets.flux_bench)()


def init_params(cfg, quant: str, dev, dtype=None):
    """The random tree of ``quant`` from the tree seed."""
    import torch

    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
    from unigen_tpu_torch.ops.quant import quantize_tree
    dtype = torch.bfloat16 if dtype is None else dtype
    gen = torch.Generator(device=dev).manual_seed(0)
    if quant == "w4a8":
        return init_quantized_serving_params(cfg, device=dev, generator=gen, dtype=dtype)
    params = init_unigen_flux_params(cfg, gen=gen, device=dev, dtype=dtype)
    return quantize_tree(params) if quant == "w8a8" else params


def make_inputs(cfg, b: int, res: int, dev, dtype=None) -> dict:
    """One batch of phase inputs from the input seed: hidden, condition,
    encoder, pooled, cond_pooled, timestep 0.5, the position ids and the
    attention phase's q, k, v [b, heads, T_LEN + S_img, head_dim]."""
    import torch

    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    dtype = torch.bfloat16 if dtype is None else dtype
    bb = cfg.flux
    hw = res // 16
    s_img = hw * hw
    g = torch.Generator(device=dev).manual_seed(1)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)
    heads, hd = bb.num_attention_heads, bb.attention_head_dim
    x = dict(hidden=mk(b, s_img, bb.in_channels), condition=mk(b, s_img, bb.in_channels),
             encoder=mk(b, T_LEN, bb.joint_attention_dim),
             pooled=mk(b, bb.pooled_projection_dim),
             cond_pooled=mk(b, bb.pooled_projection_dim))
    x.update(q=mk(b, heads, T_LEN + s_img, hd), k=mk(b, heads, T_LEN + s_img, hd),
             v=mk(b, heads, T_LEN + s_img, hd),
             timestep=torch.full((b,), 0.5, dtype=dtype, device=dev),
             img_ids=prepare_latent_image_ids(hw, hw, device=dev),
             txt_ids=torch.zeros(T_LEN, 3, device=dev))
    return x


# ------------------------------------------------------------ the phases
# Each phase is (params, cfg, inputs) -> its output, as the JAX script
# composes it.

def _embed(params, cfg, x):
    import torch

    from unigen_tpu_torch.models.flux import flux_embed_inputs, flux_rope
    bb = cfg.flux
    h, enc, temb = flux_embed_inputs(params["base"], bb, x["hidden"], x["encoder"],
                                     x["pooled"], x["timestep"], None)
    return h, enc, temb, flux_rope(bb, torch.cat([x["txt_ids"], x["img_ids"]]))


def embed_phase(params, cfg, x):
    h, enc, temb, rope = _embed(params, cfg, x)
    return h, enc, temb, rope[0]


def attn_phase(params, cfg, x):
    """The attention kernel alone at the stream length, n_base + n_single
    times; each call's q depends on the last call's output (a constant
    input would let a caller hoist the call)."""
    import torch

    from unigen_tpu_torch.models.flux import flux_rope
    from unigen_tpu_torch.ops.attention import sdpa
    bb = cfg.flux
    rope = flux_rope(bb, torch.cat([x["txt_ids"], x["img_ids"]]))
    q, k, v = x["q"], x["k"], x["v"]
    carry = torch.zeros(q.shape[0], q.shape[2], q.shape[3], dtype=q.dtype, device=q.device)
    eps = torch.tensor(1e-6, dtype=q.dtype, device=q.device)
    for _ in range(bb.num_layers + bb.num_single_layers):
        out = sdpa(q + eps * carry[:, None], k, v, rope=rope)
        carry = out.mean(dim=1)
    return carry


def double_phase(params, cfg, x):
    from unigen_tpu_torch.layers.blocks_flux import flux_double_block
    from unigen_tpu_torch.utils import index_params
    bb = cfg.flux
    h, enc, temb, rope = _embed(params, cfg, x)
    for i in range(bb.num_layers):
        enc, h = flux_double_block(index_params(params["base"]["double_blocks"], i), h,
                                   enc, temb, rope, heads=bb.num_attention_heads)
    return h


def double_cn_phase(params, cfg, x):
    """The double stack with a control block and its gated add after each
    base block; the preprocess outputs are fixed stand-ins of their shapes
    (the context embedder's output, the base temb)."""
    import torch

    from unigen_tpu_torch.layers.blocks_flux import flux_double_block
    from unigen_tpu_torch.layers.core import linear
    from unigen_tpu_torch.models.flux import flux_rope
    from unigen_tpu_torch.models.unigen_flux import control_block_index_table
    from unigen_tpu_torch.utils import index_params
    bb, cc = cfg.flux, cfg.control
    base, ctrl = params["base"], params["control"]
    h, enc, temb, rope = _embed(params, cfg, x)
    rope_cn = flux_rope(bb, torch.cat([x["img_ids"], x["txt_ids"]]))
    table = control_block_index_table(bb.num_layers, bb.num_layers // cc.single_control_dev)
    control_enc = linear(ctrl["context_embedder"], enc)
    heads = bb.num_attention_heads
    for i in range(bb.num_layers):
        enc, h = flux_double_block(index_params(base["double_blocks"], i), h, enc, temb,
                                   rope, heads=heads)
        _, cn_out = flux_double_block(index_params(ctrl["double_blocks"], table[i]), h,
                                      control_enc, temb, rope_cn, heads=heads,
                                      context_first=False)
        h = h + linear(index_params(ctrl["add_double"], table[i]), cn_out)
    return h


def moe_phase(params, cfg, x):
    from unigen_tpu_torch.models.unigen_flux import preprocess_moe
    h, enc, _, _ = _embed(params, cfg, x)
    pre = preprocess_moe(params["control"], cfg, h, enc, x["condition"], x["pooled"],
                         x["cond_pooled"], x["timestep"], None, x["img_ids"],
                         x["txt_ids"], x["img_ids"])
    return pre.moe_hidden


def single_phase(params, cfg, x):
    import torch

    from unigen_tpu_torch.layers.blocks_flux import flux_single_block
    from unigen_tpu_torch.utils import index_params
    bb = cfg.flux
    h, enc, temb, rope = _embed(params, cfg, x)
    stream = torch.cat([enc, h], dim=1)
    for i in range(bb.num_single_layers):
        stream = flux_single_block(index_params(params["base"]["single_blocks"], i),
                                   stream, temb, rope, heads=bb.num_attention_heads)
    return stream


def single_cn_phase(params, cfg, x):
    import torch

    from unigen_tpu_torch.layers.blocks_flux import flux_single_block
    from unigen_tpu_torch.layers.core import linear
    from unigen_tpu_torch.models.unigen_flux import control_block_index_table
    from unigen_tpu_torch.utils import index_params
    bb, cc = cfg.flux, cfg.control
    base, ctrl = params["base"], params["control"]
    h, enc, temb, rope = _embed(params, cfg, x)
    stream = torch.cat([enc, h], dim=1)
    n = bb.num_single_layers
    table = control_block_index_table(n, n // cc.single_control_dev)
    heads = bb.num_attention_heads
    for i in range(n):
        stream = flux_single_block(index_params(base["single_blocks"], i), stream, temb,
                                   rope, heads=heads)
        cn_out = flux_single_block(index_params(ctrl["single_blocks"], table[i]), stream,
                                   temb, rope, heads=heads)
        stream = stream + linear(index_params(ctrl["add_single"], table[i]), cn_out)
    return stream


def full_phase(params, cfg, x):
    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
    pred, _, _ = unigen_flux_forward(params, cfg, x["hidden"], x["condition"], x["encoder"],
                                     x["pooled"], x["cond_pooled"], x["timestep"],
                                     x["img_ids"], x["txt_ids"], x["img_ids"])
    return pred


PHASE_FNS = {"embed": embed_phase, "attn": attn_phase, "double": double_phase,
             "double_cn": double_cn_phase, "moe": moe_phase, "single": single_phase,
             "single_cn": single_cn_phase, "full": full_phase}


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_phase(fn, dev):
    """-> (ms: the minimum over BURSTS bursts of CALLS calls, first call s,
    the last output)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(BURSTS):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            out = fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) / CALLS)
    return min(times) * 1e3, first_s, out


def run_batch(params, cfg, b: int, args, dev):
    """Every phase of ``args.phases`` at batch ``b`` -> (report, first-call
    seconds, outputs)."""
    import torch
    x = make_inputs(cfg, b, args.res, dev)
    report, first, outputs = {}, {}, {}
    with torch.no_grad():
        for name in args.phases:
            fn = PHASE_FNS[name]
            ms, first_s, out = time_phase(lambda: fn(params, cfg, x), dev)
            report[name] = round(ms, 2)
            first[name] = round(first_s, 3)
            outputs[name] = out
            print(f"# b={b} {name:10s} {ms:8.2f} ms  {ms / b:8.2f} ms/img  "
                  f"(first call {first_s:.1f}s)", file=sys.stderr, flush=True)
    if "double_cn" in report and "double" in report:
        report["control_double_ms"] = round(report["double_cn"] - report["double"], 2)
    if "single_cn" in report and "single" in report:
        report["control_single_ms"] = round(report["single_cn"] - report["single"], 2)
    return report, first, outputs


def main(argv=None, *, params=None) -> dict:
    """Profile what the arguments describe; print the JSON line (and write
    it to ``--out``). ``params``: a tree of ``--preset``'s config and
    ``--quant``'s layout on the device, in place of the random one. ->
    {"json": the report, "outputs": {batch: {phase: its last output}}}."""
    args = parse_args(argv)
    from unigen_tpu_torch.utils import resolve_device
    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    if params is None:
        params = init_params(cfg, args.quant, dev)
    sweep, outputs = [], {}
    for b in args.batches:
        report, first, outputs[b] = run_batch(params, cfg, b, args, dev)
        sweep.append({"batch": b, "phase_ms": report, "first_call_s": first,
                      "phase_ms_per_img": {k: round(v / b, 2) for k, v in report.items()}})
    out = {"preset": args.preset, "quant": args.quant, "res": args.res,
           "batches": args.batches, "weights": "random"}
    if len(sweep) == 1:
        out.update({"batch": args.batches[0], "phase_ms": sweep[0]["phase_ms"],
                    "first_call_s": sweep[0]["first_call_s"]})
    else:
        out["sweep"] = sweep
        lo, hi = sweep[0], sweep[-1]
        out["per_img_scaling"] = {
            k: round(hi["phase_ms_per_img"][k] / lo["phase_ms_per_img"][k], 3)
            for k in hi["phase_ms_per_img"]
            if k in lo["phase_ms_per_img"] and lo["phase_ms_per_img"][k] > 0}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return {"json": out, "outputs": outputs}


if __name__ == "__main__":
    main()
