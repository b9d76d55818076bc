"""The training entry point (port of ``scripts/train.py``): the reference
train.py's command line on one CUDA card.

    python -m unigen_tpu_torch.cli.train \
        --pretrained_model_name_or_path FLUX_DIR --data_path DATA \
        --dataset_name Subjects200K --condition_types depth \
        --rank 16 --max_train_steps 1000 --checkpointing_steps 250 \
        --work_dir output/lora_depth

It loads the FLUX directory (``load_flux_pipeline``), reads the datasets
through the mixed-task sampler and the prefetcher, trains the control
branch (or, with ``--rank``, rank-r LoRA factors over the frozen control
branch), checkpoints every ``--checkpointing_steps`` into ``--work_dir``,
resumes from its ``latest`` checkpoint, and in LoRA mode exports the
adapter at every checkpoint as
``{work_dir}/lora_adapters/{name}/pytorch_lora_weights.safetensors``. A
resumed run skips the batches its checkpoint has seen, so it trains on what
an uninterrupted run would. The mesh and multi-process flags are taken for
parity and refuse anything above one card (ROADMAP Queue 1 item 8).
``main`` also takes an already-loaded pipeline, for callers that build
their own (a host without tokenizers sets stub ones on it).
"""

from __future__ import annotations

import argparse
import math
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="UniGen training on one CUDA card")
    p.add_argument("--basemodel", default="UniGenFlux",
                   choices=["UniGenFlux", "MultiCondtionUniGenFlux", "UniGenSD3",
                            "SANAUniGen"])
    p.add_argument("--pretrained_model_name_or_path", required=True)
    p.add_argument("--data_path", default="")
    p.add_argument("--dataset_name", default="Subjects200K",
                   choices=["Subjects200K", "MultiGen", "MultiConditionSubjects200K"])
    p.add_argument("--condition_types", nargs="+", default=["depth", "canny"])
    p.add_argument("--work_dir", default="output/train_result")
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--max_train_steps", type=int, default=30000)
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true", default=False,
                   help="scale LR by grad_accum * batch * num_processes "
                        "(reference train.py:341-342)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="alternative to --max_train_steps: epochs over the "
                        "dataset (reference train.py:438-440)")
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.999)
    p.add_argument("--adam_weight_decay", type=float, default=1e-2)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--lr_scheduler", type=str, default="cosine",
                   choices=["linear", "cosine", "cosine_with_restarts",
                            "polynomial", "constant", "constant_with_warmup"],
                   help="LR schedule shape (reference train.py:160-161)")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--weighting_scheme", default="none",
                   choices=["sigma_sqrt", "logit_normal", "mode", "cosmap", "none"])
    p.add_argument("--guidance_scale", type=float, default=3.5)
    p.add_argument("--max_sequence_length", type=int, default=512)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--checkpointing_steps", type=int, default=1000)
    p.add_argument("--seed", type=int, default=12443)
    p.add_argument("--mixed_precision", default="bf16", choices=["bf16", "fp32", "no"],
                   help="dtype the FROZEN base weights are loaded in (reference "
                        "accelerate --mixed_precision, train.py:251); trainable "
                        "parameters stay fp32 either way")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--rank", type=int, default=0,
                   help="LoRA rank (reference train.py:137 --rank): > 0 trains "
                        "rank-r LoRA factors over the FROZEN control branch and "
                        "exports them in the reference per-adapter layout "
                        "({work_dir}/lora_adapters/{name}/"
                        "pytorch_lora_weights.safetensors) at every checkpoint")
    p.add_argument("--lora_targets", nargs="+", default=None,
                   help="substring patterns over dotted param paths picking the "
                        "LoRA-adapted linears (default: "
                        "models/lora.DEFAULT_LORA_TARGETS)")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--lora_adapter_name", default=None,
                   help="adapter directory name of the export (default: the "
                        "joined condition types)")
    p.add_argument("--cn_config", type=str, default=None,
                   help="reference-format control config YAML/JSON (unigen.yaml: "
                        "params.control_params.*); the explicit --single_* flags "
                        "override it (reference train.py:297-301)")
    p.add_argument("--single_control_dev", type=int, default=2)
    p.add_argument("--single_block_control_method", default="overall_add")
    p.add_argument("--disable_single_trans_blocks", action="store_true")
    p.add_argument("--mesh-data", type=int, default=0, help="0 = all devices")
    p.add_argument("--mesh-expert", type=int, default=1)
    p.add_argument("--mesh-sequence", type=int, default=1)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the card to train on; 'cpu' runs the plain versions of "
                        "the kernels on the CPU")
    return p.parse_args(argv)


def _refuse_parallel(args) -> None:
    axes = {"--mesh-data": args.mesh_data, "--mesh-expert": args.mesh_expert,
            "--mesh-sequence": args.mesh_sequence, "--mesh-model": args.mesh_model,
            "--num-processes": args.num_processes}
    wide = [f"{k} {v}" for k, v in axes.items() if v > 1]
    if wide or args.coordinator:
        raise SystemExit(f"{', '.join(wide) or '--coordinator'}: training on more "
                         "than one card waits for the port of unigen_tpu/parallel "
                         "(ROADMAP Queue 1 item 8)")


def load_cn_config(path):
    """The reference's --cn_config file -> ControlConfig override kwargs
    (SystemExit on an unknown key, so the command fails loudly)."""
    from unigen_tpu_torch import config as C
    try:
        return C.control_overrides_from_yaml(path)
    except ValueError as e:
        raise SystemExit(f"--cn_config: {e}")


def main(argv=None, *, pipeline=None):
    """Run the training the arguments describe. ``pipeline``: an already
    loaded ``UniGenFluxPipeline`` to train instead of loading
    ``--pretrained_model_name_or_path`` (its control config is then the
    pipeline's). -> the Trainer, with the run's Prefetcher as its
    ``prefetcher`` (for its ``stats``), or None when the run had already
    completed."""
    args = parse_args(argv)
    _refuse_parallel(args)
    import torch

    from unigen_tpu_torch import config as C, observability
    from unigen_tpu_torch.data.datasets import (ConcatDataset,
                                                MultiConditionSubjects200K,
                                                MultiGen, Subjects200K, collate)
    from unigen_tpu_torch.data.prefetch import Prefetcher
    from unigen_tpu_torch.data.sampler import MultiTaskMixedBatchSampler
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.train import checkpoint as ckpt_lib
    from unigen_tpu_torch.train.loop import Trainer

    os.makedirs(args.work_dir, exist_ok=True)
    log = observability.setup_logging(args.work_dir)

    # exit if this run already completed (reference train.py:717-722); the
    # epochs mode re-derives max_steps from the dataset and checks again
    done = ckpt_lib.latest_step(args.work_dir)
    if done is not None and args.num_train_epochs is None and done >= args.max_train_steps:
        log.info("training already completed at step %d", done)
        return None

    if pipeline is None:
        from unigen_tpu_torch.pipelines.loading import load_flux_pipeline
        control_overrides = load_cn_config(args.cn_config)
        # the flags override the config file (reference train.py:298-301)
        control_overrides.update(
            single_control_dev=args.single_control_dev,
            single_block_control_method=args.single_block_control_method,
            use_single_trans_blocks=not args.disable_single_trans_blocks)
        pipeline = load_flux_pipeline(
            args.pretrained_model_name_or_path, condition_types=args.condition_types,
            control_overrides=control_overrides,
            dtype=torch.bfloat16 if args.mixed_precision == "bf16" else torch.float32,
            device=args.device)
    pipe = pipeline
    observability.param_report(pipe.params["base"], "base")
    observability.param_report(pipe.params["control"], "adapter")

    if args.dataset_name == "MultiGen":
        datasets = [MultiGen(args.data_path, t, args.resolution)
                    for t in args.condition_types]
    elif args.dataset_name == "MultiConditionSubjects200K":
        datasets = [MultiConditionSubjects200K(args.data_path, args.condition_types,
                                               resolution=args.resolution)]
    else:
        datasets = [Subjects200K(args.data_path, t, args.resolution)
                    for t in args.condition_types]
    concat = ConcatDataset(datasets)
    sampler = MultiTaskMixedBatchSampler([len(d) for d in datasets], args.train_batch_size,
                                         num_replicas=1, rank=0, shuffle=True,
                                         seed=args.seed)

    lr = args.learning_rate
    if args.scale_lr:
        # reference train.py:341-342: the LR scales with the effective batch
        lr = lr * args.gradient_accumulation_steps * args.train_batch_size
    max_steps = args.max_train_steps
    if args.num_train_epochs is not None:
        # reference train.py:438-440: epochs -> optimizer updates over the
        # sampler's epoch length (ceil over accumulation)
        epoch_len = math.ceil(len(concat) / args.train_batch_size)
        max_steps = args.num_train_epochs * math.ceil(
            epoch_len / args.gradient_accumulation_steps)
        log.info("num_train_epochs=%d -> max_train_steps=%d",
                 args.num_train_epochs, max_steps)
        if done is not None and done >= max_steps:
            log.info("training already completed at step %d", done)
            return None

    tcfg = C.TrainConfig(
        learning_rate=lr, lr_warmup_steps=args.lr_warmup_steps,
        lr_scheduler=args.lr_scheduler, max_train_steps=max_steps,
        train_batch_size=args.train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        weighting_scheme=args.weighting_scheme, guidance_scale=args.guidance_scale,
        max_sequence_length=args.max_sequence_length, resolution=args.resolution,
        seed=args.seed, checkpointing_steps=args.checkpointing_steps,
        max_grad_norm=args.max_grad_norm, mixed_precision=args.mixed_precision,
        adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_weight_decay=args.adam_weight_decay, adam_epsilon=args.adam_epsilon,
        lora_rank=args.rank, lora_targets=tuple(args.lora_targets or ()),
        lora_scale=args.lora_scale,
        lora_adapter_name=args.lora_adapter_name or "_".join(args.condition_types))

    def encode_text(prompts):
        embeds, pooled = pipe.encode_prompt(list(prompts), args.max_sequence_length)
        return {"prompt_embeds": embeds, "pooled": pooled}

    def encode_images(px):
        x = torch.as_tensor(px).to(pipe.device, torch.float32)
        return vae_lib.vae_encode(pipe.vae_params, pipe.vae_cfg, x)

    common = dict(encode_text=encode_text, encode_images=encode_images,
                  work_dir=args.work_dir, device=pipe.device)
    if args.rank > 0:
        # LoRA fine-tuning: rank-r factors over the frozen control branch,
        # rooted at the whole {"base", "control"} tree so that the paths
        # match the reference-format export and load maps
        from unigen_tpu_torch.models.lora import DEFAULT_LORA_TARGETS, init_lora_adapters
        targets = list(tcfg.lora_targets or DEFAULT_LORA_TARGETS)
        gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
        lora = init_lora_adapters(pipe.params, targets, args.rank,
                                  [tcfg.lora_adapter_name], gen=gen)[tcfg.lora_adapter_name]
        if not lora:
            raise SystemExit(f"--rank {args.rank}: no linear weights match "
                             f"--lora_targets {targets}")
        log.info("LoRA mode: rank %d, %d target stacks, adapter '%s'",
                 args.rank, len(lora), tcfg.lora_adapter_name)
        trainer = Trainer(pipe.cfg, tcfg,
                          base_params={"base": pipe.params["base"],
                                       "control_frozen": pipe.params["control"]},
                          control_params=lora, **common)
    else:
        trainer = Trainer(pipe.cfg, tcfg, base_params=pipe.params["base"],
                          control_params=pipe.params["control"], **common)
    trainer.maybe_resume()

    multi = args.dataset_name == "MultiConditionSubjects200K"

    def batch_stream(skip: int):
        while True:
            for idxs in sampler:
                if skip:                    # seen before the checkpoint
                    skip -= 1
                    continue
                yield collate([concat[i] for i in idxs],
                              condition_types=args.condition_types if multi else None)

    # one worker: the batches keep the sampler's order (the stream does its
    # work inside the prefetcher's lock, so a second worker would only race
    # the first to the queue)
    trainer.prefetcher = Prefetcher(batch_stream(trainer.global_step), depth=4, workers=1)
    try:
        trainer.train(trainer.prefetcher)
    finally:
        trainer.prefetcher.close()
    log.info("training complete at step %d", trainer.global_step)
    return trainer


if __name__ == "__main__":
    main()
