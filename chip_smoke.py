#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unigen_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--parent DIR]
    python3 chip_smoke.py --schedules     # the rope-free forward's variants only

Phases, in order; any failure exits non-zero:
  1. device: CUDA is required; prints the card's name and power limit.
  2. build: compiles the CUDA kernels from unigen_tpu_torch/csrc (one nvcc
     per source, started together) into build/kernels.
  3. kernels: each kernel at the main paths' shapes against its plain
     PyTorch version on the card (attention bf16 within atol=rtol=1e-2, W4A8
     at every shape of a b=2 FLUX forward, the activation quantization and
     the RoPE rotation pass bit-identical, the attention backward's dq,
     dk, dv each within 2e-2 of its largest |value| and 1e-2 relative L2),
     with CUDA-event medians of the kernel, the plain version and a library
     yardstick that the port never calls, beside the bound; the RoPE forward
     and the whole backwards also by profiler device time (device_ms); a
     "ptxas" line with the registers, spills and static shared memory of
     every kernel from their build logs; "w4a8_tiles" lines time each W4A8
     path shape at every tile of the Hopper kernel (the measurement behind
     quant_matmul.tile).
  4. slice: the full-width W4A8 UniGen-FLUX (flux_full, 512^2, 4 Euler steps)
     serves four b=1 requests through MicroBatchServer(batch_size=2); the
     launch counters must show every attention, every W4A8 linear and every
     activation quantization of those forwards went through the kernels
     (and none through the general W4A8 kernel); in one more forward every
     kernel call is also held against its plain version on the path's own
     inputs, and that forward and one with the plain versions on the same
     inputs agree within 3e-2 relative L2; a profiled forward gives the
     device time by kernel.
  4b. pipeline: UniGenFluxPipeline on the same tree with a full-width
     random VAE (fp32), CLIP-L and T5-XXL (bf16) and seeded stub
     tokenizers: in each mode of PIPELINE_MODES (exact; "balanced", the
     hybrid cache with int8 residuals; the control cache at interval 2;
     the order-1 model cache at interval 2; the adaptive hybrid at two
     thresholds) four b=1 requests at 512^2, 4 steps, prompts through
     encode_prompt (the repeated condition prompt must hit the prompt
     LRU), served by MicroBatchServer(batch_size=2): a "pipeline" line
     with img/s, the ms of prompt encoding, VAE encode, denoise and VAE
     decode (CUDA events), the full / base / skip steps, the residual
     cache's bytes and the peak memory, and launch counts equal to
     expected_pipeline_launches; one request through __call__ equal to
     generate; pipeline_replay_check (a replay of bf16 residuals gives the
     capture's bits, int8 / int4 within REPLAY_REL_L2), pipeline_composition
     ("balanced" against its forward calls written out),
     pipeline_path_check (every kernel call of a "balanced" generate
     against its plain version), pipeline_vae_check (against the VAE in
     fp64 on the card, with the TF32 flags in force) and pipeline_profile
     (device time by group of an exact generate and of the text towers).
  4c. stepserve: serving_steps.StepServer on the same tree and 4b's VAE,
     4 slots, 512^2, 4 steps, in each mode of STEPSERVE_MODES (exact;
     multi_tick 4; model cache k=2 order 1; hybrid c=4 k=2 int8; adaptive
     hybrid at lag 1): a "stepserve" line with cold and warm single-request
     latency, sustained img/s over 16 requests fed by blocking submits from
     threads, latency p50/p95, mean occupancy, rows full/base/refresh/pad,
     replay ticks, the device's idle share over the sustained window (a
     CUDA-only profiler), peak and residual-cache bytes, and launches
     equal to the formula of the forwards the server dispatched (its
     family forward wrapped), none of the general W4A8 kernel; then
     stepserve_check: every kernel call of one exact 4-slot tick against
     its plain version; then, at the deepest of REDUCED_DEPTHS whose
     stream stays unsaturated (at full depth the random tree's stream
     overflows and outputs stop depending on inputs), each request's final
     latents (its decode wrapped) against UniGenFluxPipeline.generate of
     the same request and knobs (lag 1: the lagged rule written out) at
     the same shapes, within STEPSERVE_REL_L2: requests served in pairs
     one tick apart (two live slots at different steps), multi_tick with
     all 4 slots admitted at one tick.
  4d. stepserve_multires: MultiResolutionStepServer on the same tree, a
     512^2 bucket of 4 slots and a 1024^2 bucket of 1; per-bucket stats
     and launches.
  5. train: the flow-matching fine-tune step of the same tree (the fp
     trainable subset in bf16, W4A8 frozen), 512^2, micro-batch 2,
     accumulation 2, remat "full", 1 warm-up + 4 timed micro-steps through
     make_train_step on synthetic data from --seed; finite losses, the
     trainable count, launch counts equal to the config's (remat recompute
     included), a profiled micro-step, and the trainable gradients of one
     micro-step against the same step with the plain versions (relative L2
     within 3e-2), in which every attention backward call is also held
     against its plain version on its own q, k, v, O, lse with dO at unit
     scale (backward_path_check).
  6. trainer: Trainer.step on the same tree with stub encoders, 1 warm-up +
     2 timed steps: the Trainer upcasts the trainable subset to fp32 and
     the encoders give fp32 latents and embeddings (as the JAX Trainer
     runs), so every kernel runs on fp32 activations; finite losses and the
     config's launch counts.
  6b. train_lora: LoRA fine-tuning (rank LORA_RANK on DEFAULT_LORA_TARGETS,
     factors drawn at the fp shapes) over the same frozen W4A8 tree at full
     width and depth with the reference's gate (random token selection):
     TRAIN_LORA_STEPS micro-steps through Trainer with a work_dir under
     build/ and a save at TRAIN_LORA_SAVE; a second Trainer resumes from
     that save (state, optimizer and generator equal bit for bit) and takes
     the remaining steps, its losses beside the first run's; launches equal
     the LoRA formula (the targeted linears leave W4A8; the frozen MoE
     preprocess gets no attention backward); train_lora_grad_check against
     the plain versions (at full depth the gradients vanish in the
     saturated random stream; held at LOAD_FLUX_DEPTH);
     the exported adapter read back bit for bit; then the adapter loaded
     from its files into a UniGenFluxPipeline on the W4A8 tree, every
     re-quantized leaf equal to fold_linear_node's, two requests, and
     train_lora_path_check (every kernel call of a forward).
  6c. train_routing: ROUTING_STEPS timed micro-steps (after a warm-up) each
     of top-2 with the dense dispatch, the consis module (its second call attends
     over 3072 keys) and remat "dots", beside the top-1 remat "full" step,
     at full width and the deepest depth that fits; peak bytes, launches
     equal to the formula, and every kernel call of one micro-step of each
     at the shallowest depth against its plain version.
  7. flux_1024: one b=1 request through the same W4A8 tree at 1024^2, 4
     steps (attention over 4608, 8192 and 8704 keys, past the TPU's
     2560-key streaming gate): launch counts and a per-call path check.
  7b. train_blocks: phase 5's step on the W4A8 tree of flux_full with the
     reference's shipped control values (use_rope = use_modulate = False:
     rope-free control blocks and weave, 6 block experts of two FLUX single
     blocks each, left in bf16 and trained): finite losses, the trainable
     count, launch counts of all six attention kernels and W4A8 equal to
     the config's, the peak memory, train_blocks_profile, and
     train_blocks_grad_check against the plain versions (relative L2
     within 3e-2).
  8. sd3: the full-width bf16 UniGen-SD3.5-medium (sd3_depth_28step: 24
     joint blocks, dual attention on 0..12, width 1536 = 24 heads x 64, 24
     control blocks, 6 block experts + the shared expert, global routing)
     serves four b=1 requests through MicroBatchServer(batch_size=2): 28
     Euler steps with classifier-free guidance 7.0 at 512^2, so each
     forward runs batch 4; every attention call goes through the rope-free
     kernel (launches equal expected_sd3_launches), the sd3_path_check
     line holds each call of one more forward against its plain version and
     that forward against one with the plain versions, and sd3_profile
     gives the device time by kernel group. sd3_base_forward_check runs the
     UniGenBase forward (unigen_base_forward) of a full-width base-variant
     tree at b=2, then a capture and its replay: every rope-free call
     against its plain version, the calls against
     expected_sd3_base_launches, the capture and the replay bit for bit
     equal to the plain forward.
  9. sd3_1024: one b=1 request of the same model at 1024^2, 4 steps
     (4429, 4096, 8192 and 8525 keys): launch counts and the path check.
  8b. stepserve_sd3 (after 9, on the same tree): the StepServer with
     per-sample routing, 4 slots, 28 steps, CFG 7.0 inside the tick, exact
     and the hybrid (8, 2), the fields of 4c; stepserve_sd3_check holds the
     exact server against UniGenSD3.denoise of the same 4 requests, and
     every kernel call of one exact 4-slot tick and of a one-slot gathered
     full and base-with-replay forward against its plain version.
  8c. sd3_pipeline (after 8b): a random SD3.5-medium checkpoint directory
     at full size in the diffusers layout (transformer and T5-XXL bf16,
     CLIP-L and CLIP-G fp16, the VAE fp32, a UniGen adapter; drawn on the
     card from --seed, streamed into safetensors files under
     build/checkpoints after a free-space check) is loaded by
     load_sd3_pipeline as an int4 base, an int8 adapter and W4A8 text
     towers: an "sd3_load" line (bytes written, seconds and GB/s read per
     component, seconds to convert, each quantization's seconds, bytes
     before and after and peak device bytes); sd3_load_check (the loaded,
     donated quantization against the same walk without donation of the
     same checkpoint loaded unquantized, bit for bit); then, SD3_PIPE_RUNS
     times in turn, in each mode of SD3_PIPE_MODES four b=1 requests at
     512^2, 28 steps, CFG 7 with a negative prompt through
     MicroBatchServer(batch_size=2): an "sd3_pipeline" line per mode and
     run with the fields of 4b (residual-cache bytes read from the captured
     tensors, peak bytes also above the phase's start) and launches equal
     to expected_sd3_pipeline_launches plus the text towers' encodes;
     sd3_pipeline_path_check (every kernel call of one CFG forward, one T5
     and one CLIP-G encode against its plain version, with the W4A8 shapes
     they ran), sd3_pipeline_profile (device time by group of a CFG
     forward at the served batch and of a cfg_cache replay step) and
     sd3_pipeline_composition ("balanced" against its forward
     calls written out, bit for bit).
  4e. load_flux (after 8c): load_flux_pipeline on a full-width FLUX
     directory at LOAD_FLUX_DEPTH (random transformer, the reference's .bin
     adapter layout, 8c's VAE, CLIP-L and T5 files linked), W4A8 with W4A8
     text towers through a serving-tree cache, twice: the cold start and the
     restart from the cache (the same tree bit for bit); two requests
     through its __call__ with launches equal to the formula, and
     load_flux_path_check (one forward and one T5 encode at M = 512).
  4f. train_cli (after 4e): the training entry point's main on 4e's
     directory (bf16, the .bin adapter, stub tokenizers) and a
     Subjects-200K-layout dataset under build/ with pre-rendered depth
     conditions: LoRA rank LORA_RANK, CLI_STEPS steps with a checkpoint
     every CLI_SAVE, a second main resumed to CLI_RESUME_TO, a third that
     finds the run complete (s per step, the prefetcher's stats,
     checkpoint bytes and save and resume seconds); then
     load_flux_pipeline(..., lora_dir=...) serves one request with the
     adapter. The checkpoint directories are removed at the end.
  9 sana (after 4f): the full-width SANA family (Sana_1600M_1024px's
     transformer with the default control branch, W4A8 by the loader's
     policy: int4 base, int8 adapter; Gemma-2-2B and CLIP-L W4A8; the fp32
     DC-AE f32c32; random from the seed) through UniGenSanaPipeline at
     1024^2, 20 steps: four b=1 requests with 300-token padded Gemma
     prompts in two b=2 batches per mode of SANA_PIPE_MODES (exact,
     "balanced", "fast"), a "sana_pipeline" line each (img/s, stage_ms,
     step kinds, residual bytes, peak, the TF32 switches), launches equal
     to expected_sana_pipeline_launches plus each Gemma and CLIP encode's;
     sana_path_check (every W4A8 and quantization call of a b=2 forward
     and of a Gemma encode against its plain version) and sana_profile
     (device time by group: linear attention, cross-attention, depthwise
     conv and the DC-AE by profiler range, then W4A8, the quantization,
     library GEMMs such as W8A8's _int_mm, elementwise).
  9b stepserve_sana: StepServer(family sana) on the same trees with
     per-sample routing, 4 slots at 1024^2, exact and the hybrid (4, 2),
     the fields of 4c; stepserve_sana_check holds the served final latents
     against generate at the same shapes, at the deepest of SANA_DEPTHS
     whose random stream stays finite, within STEPSERVE_REL_L2.
  9c sana_load: a random full-size SANA directory under build/checkpoints
     (transformer, Gemma-2 in two shards, CLIP-L, the native DC-AE; about
     10 GB after a free-space check) loaded by load_sana_pipeline(bf16,
     w4a8, w4a8 text); sana_load_check (the loaded trees bit for bit
     against the undonated quantization of a quantize=None load) and two
     requests through the pipeline's __call__; the directory is removed
     whatever happens.
 10 entry_points (after 4f, before the directories go): the user entry
     points on 8c's SD3.5-medium directory and 4e's FLUX directory, each
     pipeline loaded once and given seeded stub tokenizers. 10a
     entry_infer: cli.infer --basemodel UniGenSD3 (W4A8, W4A8 text, bf16,
     512^2, 28 steps, CFG 7) loaded through cli.infer.load_pipeline, a
     single-prompt request with a control PNG, then the held-out split of
     a Subjects-200K-layout dataset in batches of 2 (load s, img/s,
     launches equal to expected_sd3_pipeline_launches plus the prompt
     encodes); entry_infer_check (every image bit for bit equal to the
     pipeline's own call with the same arguments and seed) and
     entry_infer_path_check (one CFG forward's kernel calls against their
     plain versions). 10c entry_serve, on the same pipeline at the serve
     CLI's 4 steps: cli.serve request-batched (batch 2, four JSON-line
     requests) and --step-server (4 slots, four requests, the last
     cancelled in flight): img/s, latency p50/p95, the server's stats, the
     launches; entry_serve_check (the batched PNGs bit for bit against
     generate of their batches; the step server's against generate at b =
     slots with the server's noise, per-request VAE ends, within
     ENTRY_SERVE_CODES). 10b entry_infer_flux: one cli.infer request on
     the FLUX directory at LOAD_FLUX_DEPTH (kernel 1 on the entry path),
     launches against the formula. 10d entry_eval: cli.eval over 10a's
     batch output, --fid --dists on a random torchvision-layout VGG16 file
     (14.7 M parameters) and --fid on a random Depth-Anything-small
     directory in transformers' layout, each on the card (TF32 off) and
     with --device cpu: every metric within ENTRY_EVAL_REL (entry_eval_check).
     10e depth_condition: make_depth_fn of that tree on DEPTH_IMAGES 512^2
     images (504^2 inside): ms per image on the card, uint8 within one
     code of the CPU's.
 11 tools: the JAX package's remaining tools through the port's CLIs.
     11f profile_forward (after phase 7, on phase 4's W4A8 flux_full tree):
     cli.profile_forward --preset full --quant w4a8 --batches 1,2 --res 512,
     every phase reported, the full phase bit for bit against
     unigen_flux_forward, one full call's launches against the formula, one
     attn call 19 + 38 RoPE launches. 11g profile_train (same tree):
     cli.profile_train --preset full --remats full (TOOLS_REMATS; 6c times
     "dots" beside "full"), no error row, the first step's loss equal to one
     make_train_step on the same state and inputs with launches equal to
     expected_train_launches; mfu beside the card's int8 peak. 11d
     validate_flux (inside 8c/4e's try, after 10): cli.validate_real_ckpt on
     4e's directory and .bin adapter (--skip-diffusers, 512^2): the
     strict-load counts against the same files loaded here, its SSIM gate
     on its cli.measure_fidelity --ckpt subprocess passed (4e's linears are
     drawn as the port's linear init draws them) and consistent with the
     fidelity that stage measured; 8c's SD3 directory (N(0, 0.02) weights,
     which int4 codes serve below the gate) is validated where its
     full-depth bf16 forward is finite, its verdict, a pass or a refusal,
     held to its fidelity the same way, else the line says why not. 11e generate:
     cli.generate --ckpt on 4e's directory with a control PNG, 4 steps,
     launches against the formula, generate_check bit for bit against the
     pipeline's own call. 11a-11c fidelity_flux / _sd3 / _sana (after 9c):
     cli.measure_fidelity --ssim on the FLUX proxy (full width, 6/12
     blocks, 256^2, 4 steps), the full SD3.5-medium (256^2, 28 CFG steps)
     and the full SANA-1.6B (512^2, 20 steps), live gates, one tree at a
     time; fidelity_check: the CLI's bf16 forward bit for bit against the
     model's, every kernel call of one forward of each quantized path
     against its plain version, each path's launches against the formulas,
     the bf16 output finite, rel_err below FIDELITY_REL, e2e_ssim at least
     FIDELITY_SSIM.
 12. one JSON line listing the kernels (tools_launches: phase 11's); the
     last line is the JSON result.
Phase 3 also holds the rope-free kernel against its plain version at every
shape of the SD3 paths (D=64, ragged lengths), both attention kernels at
the 1024^2 lengths, kernel 1 and its backward at the consis module's 3072
keys, and the rope-free backward at train_blocks' shapes and
SD3's; plain versions past ~2 GB of fp32 logits run in head chunks. It
imports neither JAX nor the JAX package.

--schedules runs phases 1-2 and then only the timing of the rope-free
forward's D=64 variants (ring depths, FlashAttention-3's overlap; a
timing-only library, csrc/timing/flash_attention_schedules.cu, that the
port never builds) against the production kernel at SD3's shapes.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12        # H100 SXM dense int8 tensor-core peak
HBM_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
ATTN_CASES = [            # (B*H split as B, H, Sq, Skv, identity K rows)
    (1, 24, 1536, 1536, 0), (1, 24, 2048, 2048, 0), (1, 24, 2560, 2560, 0),
    (1, 24, 1536, 2048, 512)]
# W4A8 (M, K, N): the first four as in earlier PRs, then every shape of a
# b=2 FLUX forward (tokens: 1024 text, 2048 image, 3072 single-block
# stream; 2 for the AdaLN linears)
W4A8_CASES = [(2, 3072, 18432), (1536, 3072, 3072), (1536, 12288, 3072),
              (1536, 15360, 3072),
              (1024, 3072, 3072), (2048, 3072, 3072), (3072, 3072, 3072),
              (1024, 3072, 12288), (2048, 3072, 12288), (3072, 3072, 12288),
              (1024, 12288, 3072), (2048, 12288, 3072), (3072, 15360, 3072),
              (2, 3072, 9216)]
# the StepServer's forwards (phase 4c): the AdaLN linears at M = 1 and 4,
# image rows 4 x 1024, single-block stream rows 4 x 1536 (rows of phase 3,
# at the tile quant_matmul.tile picks)
W4A8_STEPSERVE_CASES = [(1, 3072, 18432), (4, 3072, 18432), (4, 3072, 9216),
                        (4096, 3072, 3072), (6144, 3072, 12288), (6144, 15360, 3072)]
# the loaded pipelines' new shapes (phases 8c, 4e): the SD3.5-medium W4A8
# base at the CFG batch of 2 requests (4 x 1024 image rows, 4 x 333 context
# rows, 4 AdaLN / embedder rows), T5-XXL at 256 (SD3) and 512 (FLUX) tokens,
# CLIP-L and CLIP-G at 77 tokens and their pooled projections
W4A8_LOAD_CASES = [(4096, 1536, 1536), (4096, 1536, 6144), (4096, 6144, 1536),
                   (1332, 1536, 1536), (1332, 1536, 6144), (1332, 6144, 1536),
                   (1332, 4096, 1536), (4, 1536, 9216), (4, 1536, 13824),
                   (4, 1536, 3072), (4, 1536, 1536), (4, 2048, 1536),
                   (256, 4096, 4096), (256, 4096, 10240), (256, 10240, 4096),
                   (512, 4096, 4096), (512, 4096, 10240), (512, 10240, 4096),
                   (77, 768, 768), (77, 768, 3072), (77, 3072, 768), (1, 768, 768),
                   (77, 1280, 1280), (77, 1280, 5120), (77, 5120, 1280), (1, 1280, 1280)]
# the SANA paths' shapes (phase 9): the W4A8 base at b=2, 1024^2 (2048
# image rows at 2240 wide, the GLUMBConv's 2240 -> 11200 and 5600 -> 2240,
# 600 caption rows, 2 time-embedding rows), Gemma-2-2B at one and two
# 300-token prompts
W4A8_SANA_CASES = [(2048, 2240, 2240), (2048, 2240, 11200), (2048, 5600, 2240),
                   (600, 2240, 2240), (600, 2304, 2240), (2, 2240, 2240),
                   (2, 2240, 13440),
                   (300, 2304, 2048), (300, 2304, 1024), (300, 2048, 2304),
                   (300, 2304, 9216), (300, 9216, 2304),
                   (600, 2304, 2048), (600, 2304, 1024), (600, 2048, 2304),
                   (600, 2304, 9216), (600, 9216, 2304)]
W4A8_REP = (2048, 3072, 3072)         # the kernels line's shape
# the activation quantization at the path's (M, K) in bf16, and one fp32 row
# (the Trainer's activations)
QUANT_CASES = [(2, 3072, "bfloat16"), (1024, 3072, "bfloat16"), (2048, 3072, "bfloat16"),
               (3072, 3072, "bfloat16"), (1024, 12288, "bfloat16"),
               (2048, 12288, "bfloat16"), (3072, 15360, "bfloat16"),
               (2048, 3072, "float32"),
               (4, 3072, "bfloat16"), (4096, 3072, "bfloat16"), (6144, 15360, "bfloat16")]
QUANT_SANA_CASES = [(2048, 2240, "bfloat16"), (2048, 5600, "bfloat16"),
                    (600, 2240, "bfloat16"), (600, 2304, "bfloat16"),
                    (300, 2304, "bfloat16"), (300, 9216, "bfloat16")]
QUANT_REP = (2048, 3072, "bfloat16")
# the rope-free kernel at the SD3 paths' shapes (B, H, Sq, Skv, D): 512^2 at
# serving batch 4 (2 requests x CFG), then the 1024^2 lengths at batch 2
SD3_TXT = 77 + 256        # CLIP + T5 joint context
NOROPE_CASES = [
    (4, 24, 1357, 1357, 64),   # base and control joint blocks: 1024 img + 333 txt
    (4, 24, 1024, 1024, 64),   # dual attn2 of base blocks 0..12
    (4, 24, 2048, 2048, 64),   # weave_cond [img | cond], weave_text's attn2
    (4, 24, 2381, 2381, 64),   # weave_text [img | cond | txt]
    (1, 24, 683, 683, 64),     # one block expert at capacity ceil(4*1024/6)
    (2, 24, 4429, 4429, 64),   # 1024^2: joint blocks, 4096 img + 333 txt
    (2, 24, 4096, 4096, 64),   # 1024^2: dual attn2
    (2, 24, 8192, 8192, 64),   # 1024^2: weave_cond
    (2, 24, 8525, 8525, 64)]   # 1024^2: weave_text
# kernel 1 at the consis module's second call at 512^2: [expert hidden |
# consis condition] attending with the image stream, 3 x 1024 keys
CONSIS_CASES = [(1, 24, 3072, 3072, 0)]
ROPE_LONG_CASES = [       # kernel 1 at FLUX's 1024^2 lengths (b=1)
    (1, 24, 4608, 4608, 0), (1, 24, 8192, 8192, 0), (1, 24, 8704, 8704, 0)]
# --schedules: the timing-only library of the rope-free forward's D=64
# variants (10 x ring stages + overlap), timed at these SD3 shapes
SCHEDULES_KERNEL = "timing/flash_attention_schedules"
FWD_SCHEDULES = (20, 30, 40, 21, 31, 41)
SCHEDULE_CASES = [NOROPE_CASES[0], NOROPE_CASES[2], NOROPE_CASES[3], NOROPE_CASES[-1]]
HIRES, HIRES_STEPS = 1024, 4
LOGITS_BUDGET = 2 ** 31   # bytes of fp32 logits a plain call may hold at once
SEQ_TXT, HW = 512, 32     # 512^2 image -> 64^2 latents -> 32^2 = 1024 tokens
STEPS, N_REQUESTS, BATCH = 4, 4, 2
TRAIN_MICRO_STEPS, TRAIN_ACCUM, TRAINER_STEPS = 4, 2, 2
# the rope-free backward at the training sites of train_blocks (B, H, Sq,
# Skv, D, dtype), and at SD3's joint length and head dim
NOROPE_BWD_CASES = [
    (1, 24, 1536, 1536, 128, "bfloat16"),   # control double and single blocks
    (1, 24, 2048, 2048, 128, "bfloat16"),   # weave_cond [img | cond]
    (1, 24, 2560, 2560, 128, "bfloat16"),   # weave_text [img | cond | txt]
    (1, 24, 171, 171, 128, "bfloat16"),     # a block expert at capacity ceil(1024/6)
    (1, 24, 1536, 1536, 128, "float32"),    # the Trainer's fp32 activations
    (4, 24, 1357, 1357, 64, "bfloat16")]    # SD3.5-medium's joint blocks
# split_trainable of the flux_full W4A8 control tree, counted by the JAX
# package on eval_shape (tests/test_torch_port_train.py holds both to it):
# with the modulated experts, and with the shipped control values' block
# experts (145,202,432 - 141,631,488 of modulated experts + 12 FLUX single
# blocks of 141,591,808)
FLUX_FULL_TRAINABLE = 145_202_432
FLUX_FULL_BLOCKS_TRAINABLE = 1_702_672_640
# a forward replaying int8 / int4 control residuals at the state they were
# captured at stays within this relative L2 of the exact prediction
# (tests/test_torch_port_cache.py holds JAX and the port to it on the CPU)
REPLAY_REL_L2 = {8: 2e-2, 4: 2.5e-1}
# the pipeline phase: four b=1 requests at 512^2, 4 steps, in each mode
PIPE_RES = 512
PIPELINE_MODES = [
    ("exact", {}),
    ("balanced", dict(quality_profile="balanced")),    # hybrid c=4, m=2, int8
    ("control_interval_2", dict(control_cache_interval=2)),
    ("model_interval_2_order_1", dict(model_cache_interval=2, model_cache_order=1)),
    # under the random init the latent drifts about 0.0084 a step (the
    # pipeline lines' adaptive_drifts), so: (a) full, base, base, full;
    # (b) full, skip, base, skip
    ("adaptive_hybrid_a", dict(control_cache_threshold=0.02, model_cache_threshold=0.007)),
    ("adaptive_hybrid_b", dict(control_cache_threshold=0.03, model_cache_threshold=0.012))]
# the fp32 VAE's encode and decode against the same modules in fp64
VAE_REL_L2 = 1e-4
# the StepServer phases: 4 slots; at 512^2 FLUX, 4 steps, in each mode
STEPSERVE_SLOTS = 4
STEPSERVE_MODES = [
    ("exact", {}),
    ("exact_multi_tick_4", dict(multi_tick=4)),
    ("model_cache_2_order_1", dict(model_cache_interval=2, model_cache_order=1)),
    ("hybrid_4_2_int8", dict(control_cache_interval=4, model_cache_interval=2,
                             residual_cache_bits=8)),
    # at ~0.0084 of drift a step: full, hold, hold, base
    ("adaptive_hybrid_lag1", dict(control_cache_threshold=0.03,
                                  model_cache_threshold=0.012, adaptive_lag=1))]
# a served request against the one-shot pipeline (or denoise) of the same
# request and knobs, at the same shapes: the relative L2 of their final
# latents' displacement from the initial noise (what the forwards
# contributed). At equal shapes every mode read 0 on the H100 (the same
# kernels on the same rows give the same bits); the bound leaves room for
# a last-bit difference only, well under what a wrong replay coefficient
# or a row written to another slot moves
STEPSERVE_REL_L2 = 1e-3
# the reduced depths (double, single base blocks) tried, deepest first, for
# the comparison where the random tree's stream stays unsaturated
REDUCED_DEPTHS = ((8, 16), (4, 8), (2, 4))
SD3_STEPSERVE_MODES = [
    ("exact", {}),
    ("hybrid_8_2", dict(control_cache_interval=8, model_cache_interval=2))]  # sd3 "balanced"
SD3_STEPSERVE_REQUESTS = 2 * STEPSERVE_SLOTS
SD3_CHECK_STEPS = 4       # the server-vs-denoise check's steps a request
MULTIRES_REQUESTS = {512: 4, 1024: 2}     # requests per bucket (resolution)
# 8c: the loaded SD3.5-medium pipeline, four b=1 requests at 512^2 in each
# mode; 4e: the loaded FLUX directory's depth (double, single blocks)
SD3_PIPE_STEPS, SD3_PIPE_GUIDANCE = 28, 7.0
SD3_NEGATIVE = "blurry, low quality"
SD3_PIPE_RUNS = 2         # readings of each mode, each printed
SD3_PIPE_MODES = [
    ("exact", {}),
    ("balanced", dict(quality_profile="balanced")),    # hybrid c=8, m=2
    ("fast", dict(quality_profile="fast")),            # model cache k=4, order 1
    ("control_interval_2_cfg_cache", dict(control_cache_interval=2, cfg_cache=True))]
LOAD_FLUX_DEPTH = REDUCED_DEPTHS[1]
# 9: the SANA family at 1024^2, 20 steps, a 300-token Gemma prompt: four
# b=1 requests in two b=2 batches through the pipeline in each mode; 9b the
# StepServer (4 slots) in each of its modes, 8 requests from threads, and
# the server-vs-pipeline check at SANA_CHECK_STEPS steps at the deepest of
# SANA_DEPTHS whose stream stays finite; 9c the loaded directory's requests
SANA_RES, SANA_STEPS, SANA_TXT = 1024, 20, 300
SANA_PIPE_MODES = [
    ("exact", {}),
    ("balanced", dict(quality_profile="balanced")),    # hybrid c=4, m=2
    ("fast", dict(quality_profile="fast"))]            # model cache k=4, order 1
SANA_STEPSERVE_MODES = [
    ("exact", {}),
    ("hybrid_4_2", dict(control_cache_interval=4, model_cache_interval=2))]
SANA_STEPSERVE_REQUESTS = 2 * STEPSERVE_SLOTS
SANA_CHECK_STEPS = 4
SANA_DEPTHS = (20, 10, 4)
SANA_LOAD_STEPS = 4
# 6b: LoRA fine-tuning over phase 4's tree; 4f: the training entry point on
# 4e's directory (micro-steps, the save step, the resumed run's end)
LORA_RANK = 16
TRAIN_LORA_STEPS, TRAIN_LORA_SAVE = 4, 2
CLI_STEPS, CLI_SAVE, CLI_RESUME_TO = 4, 2, 6
CLI_ITEMS = 8             # Subjects-200K items written for 4f
ENTRY_SAMPLES = 4         # 10a: the held-out split served in batches of BATCH
SERVE_REQUESTS = 4        # 10c: request-batched requests
ENTRY_SERVE_CODES = 1     # 10c: the step server's images against generate
ENTRY_EVAL_REL = 1e-4     # 10d: the card's metrics against the CPU's
DEPTH_IMAGES = 4          # 10e
FIDELITY_REL = 0.1        # 11a-11c: the largest rel_err of a quantized path's forward
FIDELITY_SSIM = 0.99      # 11a-11c: the smallest e2e_ssim (validate_real_ckpt's gate)
FIDELITY_RES = {"flux": 256, "sd3": 256, "sana": 512}   # 11a-11c (the CLI's own defaults)
VALIDATE_SD3_RES = 256   # 11d: the SD3 directory's fidelity stage (11b's resolution)
TOOLS_REMATS = "full"     # 11g: the remat policies timed (6c times "dots" beside "full")
ROUTING_STEPS = 3         # 6c: timed micro-steps of each variant (the median read)
CHECKPOINTS = Path(__file__).resolve().parent / "build" / "checkpoints"
BWD_NAMES = ("flash_attention_rope_bwd_dq", "flash_attention_rope_bwd_dkv")
# 65536 registers / 384 threads, rounded down to the allocation unit of 8:
# the register count at entry of the setmaxnreg kernels (24 x 128 + 240 x 256
# = 168 x 384)
SETMAXNREG_REGISTERS = 168
# kernels that move registers with setmaxnreg, by ptxas-line key prefix: the
# attention kernels and the W4A8 kernel's 256-row instantiations
SETMAXNREG_PREFIXES = ("flash", "w4a8_wgmma_kernel<bf16,256>",
                       "w4a8_wgmma_kernel<float,256>")
NOROPE_BWD_NAMES = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def emit(obj):
    print(json.dumps(obj), flush=True)


def shipped_control(cfg):
    """``cfg`` (a UniGen config of the port or of the JAX package) with the
    control values of the reference's shipped config/unigen.yaml:
    use_rope = use_modulate = False, so the control blocks and the weave
    attend without rotary and each MoE expert is a pair of FLUX single
    blocks."""
    import dataclasses
    return dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, use_rope=False, use_modulate=False))


def bound(ops: float, peak: float, nbytes: float):
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def chunked(fn, q, k, v, *tables):
    """``fn`` over head chunks of q, k, v [B, H, S, D] whose fp32 logits stay
    under LOGITS_BUDGET (a plain version at 8704 keys and 24 heads would
    hold 7.3 GB of them), concatenated on the head axis."""
    import torch
    b, h, sq, _ = q.shape
    step = max(1, LOGITS_BUDGET // (4 * b * sq * k.shape[2]))
    if step >= h:
        return fn(q, k, v, *tables)
    return torch.cat([fn(q[:, i:i + step], k[:, i:i + step], v[:, i:i + step],
                         *tables) for i in range(0, h, step)], dim=1)


def median_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(torch, fn, runs: int = 10) -> float:
    """Mean device time of one call of ``fn``: the summed CUDA time of its
    kernels under torch.profiler over ``runs`` calls after a warm-up. Unlike
    an event pair it leaves out the gaps in which the card waits for the
    host, which dominate a call that launches many short kernels (the
    autograd backward of the library yardstick)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / runs / 1e3


@contextlib.contextmanager
def routed(**fns):
    """Route the port's kernel entry points (``flash_attention_rope_fwd``,
    ``flash_attention_rope_bwd``, ``flash_attention_fwd``,
    ``flash_attention_bwd`` of the attention module, ``w4a8_matmul`` and
    ``quantize_act`` of the quantized one) through the given functions;
    both directions of both attention autograd Functions and every
    quantized linear look them up at each call."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    mods = {name: qm if name in ("w4a8_matmul", "quantize_act") else fa for name in fns}
    saved = {name: getattr(mods[name], name) for name in fns}
    for name, fn in fns.items():
        setattr(mods[name], name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(mods[name], name, fn)


def plain_kernels():
    """Route the port through the kernels' plain versions on the card."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm

    def fwd(*args, with_lse=False):
        return chunked(fa.flash_attention_rope_ref, *args), None

    def bwd(q, k, v, o, lse, do, *tables):
        return fa.flash_attention_rope_bwd_ref(q, k, v, o, do, *tables)

    def norope_fwd(q, k, v, with_lse=False):
        return chunked(fa.flash_attention_ref, q, k, v), None

    def norope_bwd(q, k, v, o, lse, do):
        return fa.flash_attention_bwd_ref(q, k, v, o, do)
    return routed(flash_attention_rope_fwd=fwd, flash_attention_rope_bwd=bwd,
                  flash_attention_fwd=norope_fwd, flash_attention_bwd=norope_bwd,
                  w4a8_matmul=qm.w4a8_matmul_ref, quantize_act=qm.quantize_act_ref)


def attention_fp64(torch, q, k, v, *tables):
    """Attention of the same bf16-rounded (rotated, where tables are given)
    operands in float64 with an unrounded softmax: the value both bf16
    versions approximate. Run in head chunks."""
    from unigen_tpu_torch.ops.rope import apply_rotary

    def one(q, k, v, *tables):
        if tables:
            cos, sin, kcos, ksin = tables
            q, k = apply_rotary(q, cos, sin), apply_rotary(k, kcos, ksin)
        p = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                          / q.shape[-1] ** 0.5, dim=-1)
        return p @ v.double()
    return chunked(one, q, k, v, *tables)


def attention_bwd_fp64(torch, q, k, v, do, cos, sin, kcos, ksin):
    """The backward in float64 from the same bf16-rounded rotated operands the
    kernels use: the value the kernels and the fp32 plain backward
    approximate."""
    from unigen_tpu_torch.ops.rope import apply_rotary
    qr, kr = (apply_rotary(x, c, s).double().requires_grad_() for x, c, s in
              ((q, cos, sin), (k, kcos, ksin)))
    vd = v.double().requires_grad_()
    p = torch.softmax(qr @ kr.transpose(-1, -2) / q.shape[-1] ** 0.5, dim=-1)
    dqr, dkr, dv = torch.autograd.grad(p @ vd, (qr, kr, vd), do.double())
    return (apply_rotary(dqr, cos.double(), -sin.double()),
            apply_rotary(dkr, kcos.double(), -ksin.double()), dv)


def attention_record(torch, out, ref, args):
    """One path-check record of an attention call: within 1e-2 of the
    call's largest output; where the elementwise atol=rtol=1e-2 of phase 3
    fails, which of the two is nearer the float64 value."""
    o, r = out.float(), ref.float()
    err, scale = (o - r).abs().max().item(), r.abs().max().item()
    rec = dict(shape=list(args[0].shape) + [args[1].shape[2]], max_abs_err=err,
               max_abs_out=scale, ok=err <= 1e-2 * scale)
    if not torch.allclose(o, r, atol=1e-2, rtol=1e-2):
        truth = attention_fp64(torch, *args)
        rec.update(elementwise_fail=True,
                   kernel_vs_fp64=(out.double() - truth).abs().max().item(),
                   plain_vs_fp64=(ref.double() - truth).abs().max().item())
    return rec


def shadowed_backwards(torch, checks, seed=0):
    """Run every attention backward of the path as it is, and also hold the
    kernels against the plain version on the call's own q, k, v, O and lse
    with its dO brought to unit scale: under the random serving init the
    gradient reaching the attention is tiny (it can flush to zero at full
    depth), and a check at that scale would see nothing. Where dO is all
    zero, a seeded normal draw stands in. One record per call in
    ``checks[name]``: the path's largest |dO|, the worst of dq, dk, dv by
    largest error over largest |value| and by relative L2, ok under
    gradient_errors' limits."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    kernel_rope, kernel_norope = fa.flash_attention_rope_bwd, fa.flash_attention_bwd
    gen = {}

    def unit(do):
        top = do.float().abs().max()
        if top > 0:
            return (do.float() / top).to(do.dtype), top.item()
        g = gen.setdefault(do.device, torch.Generator(device=do.device).manual_seed(seed))
        return torch.randn(do.shape, generator=g, device=do.device).to(do.dtype), 0.0

    def record(name, kernel, plain, q, k, do_unit, do_max):
        errs, ok = gradient_errors(kernel(do_unit), plain(do_unit))
        checks.setdefault(name, []).append(dict(
            shape=list(q.shape) + [k.shape[2]], ok=ok, do_max=do_max,
            max_err_over_max=max(e["max_abs_err"] / max(e["max_abs"], 1e-30)
                                 for e in errs.values()),
            rel_l2=max(e["rel_l2"] for e in errs.values())))

    def rope(q, k, v, o, lse, do, *tables):
        record("flash_attention_rope_bwd",
               lambda d: kernel_rope(q, k, v, o, lse, d, *tables),
               lambda d: fa.flash_attention_rope_bwd_ref(q, k, v, o, d, *tables),
               q, k, *unit(do))
        return kernel_rope(q, k, v, o, lse, do, *tables)

    def norope(q, k, v, o, lse, do):
        record("flash_attention_bwd", lambda d: kernel_norope(q, k, v, o, lse, d),
               lambda d: fa.flash_attention_bwd_ref(q, k, v, o, d), q, k, *unit(do))
        return kernel_norope(q, k, v, o, lse, do)
    return routed(flash_attention_rope_bwd=rope, flash_attention_bwd=norope)


def shadowed_kernels(torch, checks):
    """Run every kernel call of the path as it is and also through its plain
    version on the same inputs; append one record per call to
    ``checks[name]``. W4A8 and the activation quantization must be
    bit-identical. Attention must agree within
    1e-2 of the call's largest output: the two bf16 versions round P at
    different points (the kernel before normalising, the plain version
    after), so their difference scales with the call's outputs, not with
    each element."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    kernel_fa, kernel_norope, kernel_qm, kernel_quant = (
        fa.flash_attention_rope_fwd, fa.flash_attention_fwd, qm.w4a8_matmul,
        qm.quantize_act)

    def attention(*args, with_lse=False):
        out, lse = kernel_fa(*args, with_lse=with_lse)
        ref = chunked(fa.flash_attention_rope_ref, *args)
        checks.setdefault("flash_attention_rope", []).append(
            attention_record(torch, out, ref, args))
        return out, lse

    def norope(*args, with_lse=False):
        out, lse = kernel_norope(*args, with_lse=with_lse)
        ref = chunked(fa.flash_attention_ref, *args)
        checks.setdefault("flash_attention", []).append(
            attention_record(torch, out, ref, args))
        return out, lse

    def w4a8(*args):
        out, ref = kernel_qm(*args), qm.w4a8_matmul_ref(*args)
        checks.setdefault("w4a8_matmul", []).append(dict(
            max_abs_err=(out.float() - ref.float()).abs().max().item(),
            ok=torch.equal(out, ref),
            shape=[args[0].shape[0], args[0].shape[1], args[2].shape[1]]))
        return out

    def quantize(x):
        (xq, xs), (rq, rs) = kernel_quant(x), qm.quantize_act_ref(x)
        checks.setdefault("quantize_act", []).append(dict(
            max_abs_err=max((xq.int() - rq.int()).abs().max().item(),
                            (xs - rs).abs().max().item()),
            ok=torch.equal(xq, rq) and torch.equal(xs, rs)))
        return xq, xs

    return routed(flash_attention_rope_fwd=attention, flash_attention_fwd=norope,
                  w4a8_matmul=w4a8, quantize_act=quantize)


def path_check_summary(checks):
    """Per kernel: calls, the largest error, the calls that disagree, and
    for attention the largest error over the call's largest output."""
    out = {name: dict(calls=len(c), max_abs_err=max(r["max_abs_err"] for r in c),
                      disagree=sum(not r["ok"] for r in c))
           for name, c in checks.items()}
    for name in ("flash_attention_rope", "flash_attention"):
        if name in checks:
            out[name].update(
                max_err_over_max_out=max(r["max_abs_err"] / max(r["max_abs_out"], 1e-30)
                                         for r in checks[name]),
                elementwise_fails=[r for r in checks[name] if r.get("elementwise_fail")])
    return out


def attention_tables(torch, dev, ids, sq, skv, ident):
    """FLUX's multi-axis rope tables for sq query and skv key rows, the last
    ``ident`` key rows identity (cos=1, sin=0), the KV-append convention."""
    from unigen_tpu_torch.ops.rope import rope_multi_axis
    d = 128
    cos, sin = rope_multi_axis(ids(sq), (16, 56, 56))
    kcos, ksin = rope_multi_axis(ids(skv - ident), (16, 56, 56))
    return (cos, sin, torch.cat([kcos, torch.ones(ident, d, device=dev)]),
            torch.cat([ksin, torch.zeros(ident, d, device=dev)]))


def rotation_row(torch, xs, tabs, direction):
    """The rotation pass as a direction runs it: the forward rotates k (and
    rounds v where the inputs are fp32), the backward rotates q and k (and
    rounds v and dO where fp32). Bit-identical to the plain version (ok);
    bound: the inputs and the tables read once, the bf16 outputs written
    once, at 3.35 TB/s. No PyTorch call computes it: library_ms is null."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    cos, sin, kcos, ksin = tabs
    fp32 = xs[0].dtype == torch.float32
    if direction == "forward":
        jobs = [(xs[1], kcos, ksin)] + ([(xs[2], None, None)] if fp32 else [])
    else:
        jobs = [(xs[0], cos, sin), (xs[1], kcos, ksin)] + (
            [(xs[2], None, None), (xs[3], None, None)] if fp32 else [])
    got = fa.rope_rotate(jobs)
    torch.cuda.synchronize()
    ok = all(torch.equal(x, fa.rope_rotate_ref(*job)) for x, job in zip(got, jobs))
    nbytes = sum(x.numel() * (x.element_size() + 2) + (0 if c is None else 8 * c.numel())
                 for x, c, _ in jobs)
    row = dict(kernel="rope_rotate", direction=direction, dtype=str(xs[0].dtype),
               shapes=[list(x.shape) for x, _, _ in jobs], jobs=len(jobs), ok=ok,
               max_abs_err=max((x.float() - fa.rope_rotate_ref(*job).float()).abs().max().item()
                               for x, job in zip(got, jobs)),
               ms=median_ms(lambda: fa.rope_rotate(jobs)),
               plain_ms=median_ms(lambda: [fa.rope_rotate_ref(*job) for job in jobs]),
               device_ms=device_ms(torch, lambda: fa.rope_rotate(jobs)),
               library_ms=None, bound_ms=nbytes / HBM_BYTES * 1e3, bound_by="bytes")
    emit(row)
    return row


def kernel_name(mangled):
    """The unqualified name of a mangled kernel ``..._kernel``: the
    identifier that ends there and is preceded by its length."""
    end = mangled.find("_kernel") + len("_kernel")
    for n in range(len("_kernel"), end + 1):
        if mangled[:end - n].endswith(str(n)):
            return mangled[end - n:end]
    return mangled


def ptxas_line(build, names):
    """Registers, spills, stack and static shared memory of every kernel in
    the build logs of ``names`` (nvcc -Xptxas -v), and ptxas's warnings;
    returns the kernels' entries by name (with the dtype and the integer
    template arguments: head dim, ring stages)."""
    out, warnings = {}, []
    for name in names:
        log = build._target(name).with_suffix(".log").read_text()
        for m in re.finditer(r"Compiling entry function '(\w+)'(.*?)Used (\d+) registers"
                             r"([^\n]*)", log, re.S):
            mangled, body, regs, tail = m.groups()
            args = ["float" if "IfE" in mangled or "IfL" in mangled else
                    "bf16" if "bfloat16" in mangled else None]
            args += re.findall(r"L[ib](\d+)E", mangled)
            args = [a for a in args if a]
            key = kernel_name(mangled) + (f"<{','.join(args)}>" if args else "")
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", body)
            smem = re.search(r"(\d+) bytes smem", tail)
            out[key] = dict(registers=int(regs),
                            stack=int(spill.group(1)) if spill else None,
                            spill_stores=int(spill.group(2)) if spill else None,
                            spill_loads=int(spill.group(3)) if spill else None,
                            static_smem=int(smem.group(1)) if smem else 0)
        warnings += [line.strip() for line in log.splitlines() if "warning" in line]
    emit(dict(phase="ptxas", kernels=out, warnings=warnings))
    return out


def check_setmaxnreg(kernels):
    """Every kernel that moves registers with setmaxnreg
    (SETMAXNREG_PREFIXES: 384 threads, 24 for the producer, 240 for the
    consumers) must enter with exactly SETMAXNREG_REGISTERS registers a
    thread, or setmaxnreg.inc waits forever and the launch hangs the card;
    the W4A8 Hopper kernels must not spill. Stop before launching anything
    otherwise."""
    moving = {k: v for k, v in kernels.items() if k.startswith(SETMAXNREG_PREFIXES)}
    bad = {k: v["registers"] for k, v in moving.items()
           if v["registers"] != SETMAXNREG_REGISTERS}
    if bad or not moving:
        raise SystemExit(f"setmaxnreg kernels built with other than "
                         f"{SETMAXNREG_REGISTERS} registers (they would hang): {bad}")
    spilling = {k: v for k, v in kernels.items()
                if k.startswith("w4a8_wgmma") and (v["spill_stores"] or v["spill_loads"])}
    if spilling:
        raise SystemExit(f"W4A8 kernels spill: {spilling}")


def changed_bits(torch, dev, pfa, fa, seed=0):
    """The RoPE forward (out, lse) and backward (dq, dk, dv) through the
    parent's wrappers and kernels (``pfa``) and through this tree's (``fa``)
    on the same inputs, drawn from ``seed``, at phase 3's shapes (bf16, b = 1
    and 2 for the backward, and fp32 at the first shape): the outputs whose
    bits differ, and how many were compared. None differ when kernel 1 and
    5r/6r keep their bits on the shared cores."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ids(n):
        r = torch.arange(n, device=dev)
        return torch.stack([torch.zeros_like(r), r // HW, r % HW], -1).float()
    changed, compared = [], 0
    cases = [(c, "bfloat16", 1) for c in ATTN_CASES + ROPE_LONG_CASES] + [
        (c, "bfloat16", 2) for c in ATTN_CASES] + [(ATTN_CASES[0], "float32", 1)]
    for (b, h, sq, skv, ident), dtype, mult in cases:
        tabs = attention_tables(torch, dev, ids, sq, skv, ident)
        q, k, v, do = (torch.randn(b * mult, h, s, fa.HEAD_DIM, device=dev, generator=g)
                       .to(getattr(torch, dtype)) for s in (sq, skv, skv, sq))
        outs = []
        for mod in (pfa, fa):
            o, lse = mod.flash_attention_rope_fwd(q, k, v, *tabs, with_lse=True)
            grads = (mod.flash_attention_rope_bwd(q, k, v, o, lse, do, *tabs)
                     if skv <= 2560 else ())
            outs.append((o, lse) + tuple(grads))
        names = ("out", "lse", "dq", "dk", "dv")
        for name, x, y in zip(names, *outs):
            compared += 1
            if not torch.equal(x, y):
                changed.append(f"{b * mult}x{h}x{sq}x{skv}x{ident} {dtype} {name}")
    return changed, compared


def parent_phase(parent, seed):
    """Phase 3 of the parent commit's chip_smoke.py, from a checkout at
    ``parent`` (its kernels built there), run on the same card before this
    tree's, in a process of its own. -> the parent's rows"""
    code = "\n".join([
        "import torch",
        "import chip_smoke as parent",
        "from unigen_tpu_torch.ops.cuda import build, flash_attention as fa, quant_matmul as qm",
        "build.build_all([fa.KERNEL, fa.KERNEL_BWD, fa.KERNEL_NOROPE,",
        "                 fa.KERNEL_NOROPE_BWD, qm.KERNEL])",
        "torch.backends.cuda.matmul.allow_tf32 = False",
        "torch.backends.cudnn.allow_tf32 = False",
        f"parent.phase_kernels(torch, torch.device('cuda', 0), {seed})"])
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise SystemExit(f"parent phase 3 failed ({proc.returncode}): "
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith('{"kernel"')]
    print(f"# parent: phase 3 of {parent} in {time.time() - t0:.1f}s, {len(rows)} rows",
          flush=True)
    return rows


def load_parent(parent):
    """The parent commit's kernel wrappers (``ops/cuda/flash_attention.py``
    and ``quant_matmul.py`` of the checkout at ``parent``) and its
    ``ops/quant.py`` (its activation quantization), loaded beside this
    tree's under other module names, with its own build module: its
    kernels are built from its csrc into its build directory."""
    import importlib.util
    root = Path(parent).resolve() / "unigen_tpu_torch" / "ops"
    mods = {}
    for name, path in (("build", "cuda/build.py"), ("flash_attention", "cuda/flash_attention.py"),
                       ("quant_matmul", "cuda/quant_matmul.py"), ("quant", "quant.py")):
        spec = importlib.util.spec_from_file_location(f"parent_{name}", root / path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    mods["flash_attention"].build = mods["quant_matmul"].build = mods["build"]
    mods["quant"].quant_matmul = mods["quant_matmul"]
    return mods


def changed_w4a8_bits(torch, dev, pqm, seed=0):
    """W4A8 outputs (bf16 and fp32) through the parent's wrapper (``pqm``)
    and this tree's at phase 3's shapes, on the same inputs: the outputs
    whose bits differ, and how many were compared."""
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    changed, compared = [], 0
    for m, kdim, n in W4A8_CASES:
        args = w4a8_inputs(torch, dev, g, m, kdim, n)
        for dtype in (torch.bfloat16, torch.float32):
            compared += 1
            if not torch.equal(pqm.w4a8_matmul(*args, dtype), qm.w4a8_matmul(*args, dtype)):
                changed.append(f"w4a8 {m}x{kdim}x{n} {dtype}")
    return changed, compared


def quant_vs_parent(torch, dev, pquant, seed=0):
    """The activation quantization through the parent's ``_quantize_act``
    (an eager chain) and this tree's (the kernel) at QUANT_CASES, on the
    same inputs. They differ where the parent's scale is not amax / 127:
    on the card torch divides a tensor by a Python number by multiplying
    with the number's fp32 reciprocal. Each case: the rows whose scale
    differs, the codes that differ, and whether every parent scale equals
    amax * fl(1/127) exactly (the explanation) while this tree's equals the
    IEEE amax / 127 of the JAX function."""
    from unigen_tpu_torch.ops import quant
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    out = []
    for m, kdim, dtype in QUANT_CASES:
        x = (torch.randn(m, kdim, device=dev, generator=g) * 3).to(getattr(torch, dtype))
        (pq, ps), (tq, ts) = pquant._quantize_act(x), quant._quantize_act(x)
        amax = x.float().abs().amax(-1, keepdim=True)
        one = torch.ones((), device=dev)
        recip = one / torch.full((), 127.0, device=dev)
        ieee = torch.where(amax > 0, amax / torch.full((), 127.0, device=dev), one)
        out.append(dict(m=m, k=kdim, dtype=dtype,
                        scales_differ=int((ps != ts).sum()),
                        codes_differ=int((pq != tq).sum()), codes=pq.numel(),
                        explained=torch.equal(ps, torch.where(amax > 0, amax * recip, one))
                        and torch.equal(ts, ieee)))
    emit(dict(phase="quant_vs_parent", cases=out))
    if not all(c["explained"] for c in out):
        raise SystemExit(f"the quantization differs from the parent's other than by "
                         f"the reciprocal: {out}")
    return out


def host_bound_ab(torch, dev, pfa, rounds=4):
    """The attention calls that host work bounds (a FLUX block expert's
    backward at 171 keys, an SD3 block expert's forward at 683), with the
    parent's wrappers and kernels and with this tree's in one process, in
    turns (parent, this, this, parent) x ``rounds``, CUDA-event medians of 25
    calls each: on one input set (this tree's tensor maps then come from its
    host cache) and on 48 input sets cycled (every call encodes its maps)."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, (b, h, s, d) in (("flash_attention_bwd", (1, 24, 171, 128)),
                               ("flash_attention", (1, 24, 683, 64))):
        pool = []
        for _ in range(48):
            q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g).bfloat16()
                           for _ in range(4))
            pool.append((q, k, v, do, *fa.flash_attention_fwd(q, k, v, with_lse=True)))

        def call(mod, q, k, v, do, o, lse):
            if name == "flash_attention":
                return mod.flash_attention_fwd(q, k, v)
            return mod.flash_attention_bwd(q, k, v, o, lse, do)
        for inputs in (pool[:1], pool):
            ring = itertools.cycle(inputs)
            t = {"parent": [], "this": []}
            for _ in range(rounds):
                for side in ("parent", "this", "this", "parent"):
                    mod = pfa if side == "parent" else fa
                    t[side].append(median_ms(lambda: call(mod, *next(ring))))
            rec = dict(phase="host_bound_ab", kernel=name, b=b, h=h, sq=s, skv=s, d=d,
                       input_sets=len(inputs),
                       parent_ms=statistics.median(t["parent"]),
                       ms=statistics.median(t["this"]), runs=t)
            rec["ratio"] = rec["ms"] / rec["parent_ms"]
            emit(rec)
            out.append(rec)
    return out


ROW_KEYS = ("kernel", "b", "h", "sq", "skv", "d", "dtype", "identity_rows", "m", "k",
            "n", "direction", "shapes")


def same_run(rows, parent_rows):
    """Each row of this run's phase 3 beside the parent's row of the same
    kernel and shape: event ms (and device ms where both have it) and the
    parent-over-this ratio, emitted as one line."""
    def key(r):
        return tuple(str(r.get(k)) for k in ROW_KEYS)
    parent = {key(r): r for r in parent_rows}
    out = []
    for r in (r for rs in rows.values() for r in rs):
        p = parent.get(key(r))
        if p is None or not isinstance(r.get("ms"), float):
            continue
        rec = {k: r[k] for k in ROW_KEYS if k in r}
        rec.update(ms=r["ms"], parent_ms=p["ms"], speedup=p["ms"] / r["ms"])
        if r.get("device_ms") and p.get("device_ms"):
            rec.update(device_ms=r["device_ms"], parent_device_ms=p["device_ms"],
                       device_speedup=p["device_ms"] / r["device_ms"])
        out.append(rec)
    emit(dict(phase="same_run", rows=out))
    return out


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    card idle at the start, synchronised after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def w4a8_inputs(torch, dev, g, m, kdim, n):
    xq = torch.randint(-127, 128, (m, kdim), dtype=torch.int8, device=dev, generator=g)
    xs = torch.rand(m, 1, device=dev, generator=g) * 1e-2 + 1e-4
    w = torch.randint(-128, 128, (kdim // 2, n), dtype=torch.int8, device=dev, generator=g)
    ws = torch.rand(1, n, device=dev, generator=g) * 1e-3 + 1e-4
    return xq, xs, w, ws


def w4a8_row(torch, dev, g, m, kdim, n, pqm=None):
    """The W4A8 kernel at one shape against its plain version (bit
    equality), CUDA-event and profiler times, host us per call, the bound,
    the library's int8 GEMM with the eager epilogue (library_ms) and alone
    (library_gemm_ms), and with ``pqm`` (the parent's wrapper module) the
    parent's kernel and this one timed in turns in this process
    (parent_ms, same_run_ms)."""
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    from unigen_tpu_torch.ops.quant import _int_mm, unpack_int4
    xq, xs, w, ws = w4a8_inputs(torch, dev, g, m, kdim, n)
    out = qm.w4a8_matmul(xq, xs, w, ws)
    torch.cuda.synchronize()
    ref = qm.w4a8_matmul_ref(xq, xs, w, ws)
    ok = torch.equal(out, ref) and torch.equal(
        qm.w4a8_matmul(xq, xs, w, ws, torch.float32),
        qm.w4a8_matmul_ref(xq, xs, w, ws, torch.float32))
    w8 = unpack_int4(w)
    xq_gemm = torch.cat([xq, xq.new_zeros(32 - m, kdim)]) if m <= 16 else xq
    bms, by = bound(2.0 * m * n * kdim, INT8_OPS,
                    m * kdim + 4.0 * m + kdim / 2 * n + 4.0 * n + 2.0 * m * n)
    call = lambda: qm.w4a8_matmul(xq, xs, w, ws)      # noqa: E731
    row = dict(kernel="w4a8_matmul", m=m, k=kdim, n=n,
               route="wgmma" if qm.tma_shape(kdim, n) else "general",
               tile=list(qm.tile(m, n, kdim)),
               max_abs_err=(out.float() - ref.float()).abs().max().item(), ok=ok,
               ms=median_ms(call), device_ms=device_ms(torch, call),
               host_us=host_us(torch, call),
               plain_ms=median_ms(lambda: qm.w4a8_matmul_ref(xq, xs, w, ws)),
               library_ms=median_ms(lambda: (
                   _int_mm(xq, w8).float() * xs * ws).to(torch.bfloat16)),
               library_gemm_ms=median_ms(lambda: torch._int_mm(xq_gemm, w8)),
               bound_ms=bms, bound_by=by)
    if pqm is not None:
        pcall = lambda: pqm.w4a8_matmul(xq, xs, w, ws)    # noqa: E731
        t = {"parent": [], "this": []}
        for side in ("parent", "this", "this", "parent"):
            t[side].append(median_ms(pcall if side == "parent" else call))
        row.update(same_run_ms=statistics.median(t["this"]),
                   parent_ms=statistics.median(t["parent"]),
                   parent_device_ms=device_ms(torch, pcall))
    emit(row)
    return row


def quantize_row(torch, dev, g, m, kdim, dtype):
    """The activation quantization at one (M, K, dtype) against its plain
    version (codes and scales bit-identical), with event and profiler
    times and the byte bound (x read once, codes and scales written once).
    No single PyTorch call computes it: library_ms is null."""
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    x = (torch.randn(m, kdim, device=dev, generator=g) * 3).to(getattr(torch, dtype))
    x[1] = 0                         # an all-zero row: scale 1, codes 0
    (xq, xs), (rq, rs) = qm.quantize_act(x), qm.quantize_act_ref(x)
    torch.cuda.synchronize()
    call = lambda: qm.quantize_act(x)                  # noqa: E731
    row = dict(kernel="quantize_act", m=m, k=kdim, dtype=dtype,
               ok=torch.equal(xq, rq) and torch.equal(xs, rs),
               max_abs_err=max((xq.int() - rq.int()).abs().max().item(),
                               (xs - rs).abs().max().item()),
               ms=median_ms(call), device_ms=device_ms(torch, call),
               host_us=host_us(torch, call),
               plain_ms=median_ms(lambda: qm.quantize_act_ref(x)), library_ms=None,
               bound_ms=(x.numel() * (x.element_size() + 1) + 4.0 * m) / HBM_BYTES * 1e3,
               bound_by="bytes")
    emit(row)
    return row


def w4a8_tiles(torch, dev, seed):
    """Each W4A8 path shape at every tile the Hopper kernel offers (rows a
    block; K splits for short M), bit-checked and timed: the measurement
    behind quant_matmul.tile. One line per shape."""
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    for m, kdim, n in W4A8_CASES[:1] + W4A8_CASES[4:]:
        xq, xs, w, ws = w4a8_inputs(torch, dev, g, m, kdim, n)
        ref = qm.w4a8_matmul_ref(xq, xs, w, ws)
        stages = -(-(kdim // 2) // qm.STAGE_ROWS)
        tiles = ([(64, s) for s in (1, 2, 3, 4, 6, 8, 12, 16, 24) if s <= stages]
                 if m <= 64 else [(256, 1), (256, 2), (64, 1)])
        times = {}
        for bm, split in tiles:
            fn = lambda: qm._launch(xq, xs, w, ws, torch.bfloat16, bm, split)  # noqa: E731
            if not torch.equal(fn(), ref):
                raise SystemExit(f"W4A8 tile {bm}/{split} disagrees at {m}x{kdim}x{n}")
            times[f"{bm}/{split}"] = [median_ms(fn), device_ms(torch, fn)]
        emit(dict(phase="w4a8_tiles", m=m, k=kdim, n=n, picked=list(qm.tile(m, n, kdim)),
                  ms_and_device_ms=times))


def phase_kernels(torch, dev, seed, pqm=None):
    import torch.nn.functional as F
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.rope import apply_rotary

    g = torch.Generator(device=dev).manual_seed(seed)
    rows = {"flash_attention_rope": [], "rope_rotate": [], "w4a8_matmul": []}

    def ids(n):
        r = torch.arange(n, device=dev)
        return torch.stack([torch.zeros_like(r), r // HW, r % HW], -1).float()

    for b, h, sq, skv, ident in ATTN_CASES + CONSIS_CASES + ROPE_LONG_CASES:
        d = fa.HEAD_DIM
        tabs = attention_tables(torch, dev, ids, sq, skv, ident)
        cos, sin, kcos, ksin = tabs
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).bfloat16()
                   for s in (sq, skv, skv))
        args = (q, k, v, cos, sin, kcos, ksin)
        out = fa.flash_attention_rope(*args)
        torch.cuda.synchronize()
        ref = chunked(fa.flash_attention_rope_ref, *args)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        del out, ref
        qr, kr = apply_rotary(q, cos, sin), apply_rotary(k, kcos, ksin)
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d) + 4.0 * 2 * (sq + skv) * d
        bms, by = bound(flops, BF16_FLOPS, nbytes)
        long = skv > 2560                     # the TPU's streaming kernel
        row = dict(kernel="flash_attention_rope", b=b, h=h, sq=sq, skv=skv,
                   identity_rows=ident,
                   tpu_schedule="streaming" if long else "full_kv",
                   max_abs_err=err, ok=ok,
                   ms=median_ms(lambda: fa.flash_attention_rope(*args)),
                   plain_ms=median_ms(lambda: chunked(fa.flash_attention_rope_ref, *args),
                                      *((5, 1) if long else ())),
                   library_ms=median_ms(
                       lambda: F.scaled_dot_product_attention(qr, kr, v)),
                   device_ms=device_ms(torch, lambda: fa.flash_attention_rope(*args)),
                   library_device_ms=device_ms(
                       torch, lambda: F.scaled_dot_product_attention(qr, kr, v)),
                   bound_ms=bms, bound_by=by)
        emit(row)
        rows["flash_attention_rope"].append(row)
        if (b, h, sq, skv, ident) in ATTN_CASES[:1] + ROPE_LONG_CASES[:1]:
            rows["rope_rotate"].append(rotation_row(torch, (q, k, v), tabs, "forward"))
    for b, h, sq, skv, ident in ATTN_CASES[:1]:
        tabs = attention_tables(torch, dev, ids, sq, skv, ident)
        q, k, v, do = (torch.randn(b, h, s, fa.HEAD_DIM, device=dev, generator=g).bfloat16()
                       for s in (sq, skv, skv, sq))
        rows["rope_rotate"].append(rotation_row(torch, (q, k, v, do), tabs, "backward"))
        rows["rope_rotate"].append(rotation_row(
            torch, tuple(x.float() for x in (q, k, v, do)), tabs, "backward"))

    rows["flash_attention"] = []
    for b, h, sq, skv, d in NOROPE_CASES:
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).bfloat16()
                   for s in (sq, skv, skv))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = chunked(fa.flash_attention_ref, q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
        del out, ref
        bms, by = bound(4.0 * b * h * sq * skv * d, BF16_FLOPS,
                        2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d))
        long = skv > 2560
        row = dict(kernel="flash_attention", b=b, h=h, sq=sq, skv=skv, d=d,
                   tpu_schedule="streaming" if long else "full_kv",
                   max_abs_err=err, ok=ok,
                   ms=median_ms(lambda: fa.flash_attention(q, k, v)),
                   plain_ms=median_ms(lambda: chunked(fa.flash_attention_ref, q, k, v),
                                      *((5, 1) if long else ())),
                   library_ms=median_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                   device_ms=device_ms(torch, lambda: fa.flash_attention(q, k, v)),
                   library_device_ms=device_ms(
                       torch, lambda: F.scaled_dot_product_attention(q, k, v)),
                   bound_ms=bms, bound_by=by)
        emit(row)
        rows["flash_attention"].append(row)

    rows["w4a8_matmul"] = [w4a8_row(torch, dev, g, *case, pqm=pqm)
                           for case in W4A8_CASES + W4A8_STEPSERVE_CASES]
    rows["w4a8_matmul"] += [w4a8_row(torch, dev, g, *case) for case in W4A8_LOAD_CASES]
    rows["w4a8_matmul"] += [w4a8_row(torch, dev, g, *case) for case in W4A8_SANA_CASES]
    rows["quantize_act"] = [quantize_row(torch, dev, g, *case)
                            for case in QUANT_CASES + QUANT_SANA_CASES]
    rows.update(backward_rows(torch, dev, g, ids))
    rows.update(norope_backward_rows(torch, dev, g))
    bad = [r for rs in rows.values() for r in rs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    return rows


def phase_schedules(torch, dev, build, fa, seed):
    """--schedules: the rope-free forward's D=64 variants of the timing-only
    library (``csrc/timing/flash_attention_schedules.cu``: 10 x ring stages
    + 1 where tile t's S product is issued with tile t-1's P V and the
    softmax runs under it) at SCHEDULE_CASES, each held against the plain
    version (atol=rtol=1e-2) and timed by CUDA events in turns with the
    production kernel ("0", through its C entry) on the same inputs, from
    one preallocated output. -> rows"""
    import ctypes
    fn = build.load(SCHEDULES_KERNEL).flash_attention_schedule
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    prod = fa._entry("flash_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for b, h, sq, skv, d in SCHEDULE_CASES:
        q, k, v = (torch.randn(b, h, s, d, device=dev, generator=g).bfloat16()
                   for s in (sq, skv, skv))
        ref = chunked(fa.flash_attention_ref, q, k, v).float()
        out = torch.empty_like(q)
        scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())

        def launch(sched):
            if sched == 0:
                err = prod(*ptrs, None, None, out.data_ptr(), None, b * h, sq, skv, d,
                           scale_log2, 0, stream)
            else:
                err = fn(*ptrs, out.data_ptr(), b * h, sq, skv, sched, scale_log2, stream)
            build.check(err, SCHEDULES_KERNEL)
        ms, errs, ok = {}, {}, True
        for sched in (0,) + FWD_SCHEDULES + (0,):
            launch(sched)
            torch.cuda.synchronize()
            errs[sched] = (out.float() - ref).abs().max().item()
            ok &= torch.allclose(out.float(), ref, atol=1e-2, rtol=1e-2)
            ms.setdefault(sched, []).append(median_ms(lambda: launch(sched)))
        bms, by = bound(4.0 * b * h * sq * skv * d, BF16_FLOPS,
                        2.0 * (2 * b * h * sq * d + 2 * b * h * skv * d))
        row = dict(kernel="flash_attention_schedules", b=b, h=h, sq=sq, skv=skv, d=d,
                   ok=ok, max_abs_err=max(errs.values()), errors=errs,
                   ms={str(n): min(t) for n, t in ms.items()}, bound_ms=bms,
                   bound_by=by)
        emit(row)
        rows.append(row)
    return rows


def gradient_errors(got, want):
    """Per gradient (dq, dk, dv): the largest error, the largest |value| of
    the fp32 plain version and the relative L2; ok when each is within 2e-2
    of its largest |value| and 1e-2 relative L2."""
    errs = {}
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        x, y = x.float(), y.float()
        den, num = y.norm().item(), (x - y).norm().item()
        errs[name] = dict(max_abs_err=(x - y).abs().max().item(),
                          max_abs=y.abs().max().item(),
                          rel_l2=num / den if den > 0 else (0.0 if num == 0 else math.inf))
    return errs, all(e["max_abs_err"] <= 2e-2 * e["max_abs"] and e["rel_l2"] <= 1e-2
                     for e in errs.values())


def time_backward(torch, names, shape, dims, el, row, fns):
    """Time one checked backward shape: the whole backward (the D pass plus
    both kernels) into ``row``, then one emitted row per kernel alone
    (returned by name), each beside the plain version of the same outputs
    and the backward of scaled_dot_product_attention as the library
    yardstick; the whole one also by device time (device_ms). ``names``:
    the dQ and dK/dV kernels; ``dims``: (B*H, Sq, Skv, D); ``fns``: whole,
    plain, dq, plain_dq, dkv, plain_dkv, and lib(*wrt), the library
    backward for some of the leaves ``fns["leaves"]`` (q, k, v). Bound:
    10*B*H*Sq*Skv*D operations for the whole (the count the JAX kernel
    states), 6 and 8 for the dQ and the dK/dV kernel (the products each
    needs: S, dP and dQ; S, dP, dV and dK), against q, k, v, O, dO, lse
    (and the D rows for one kernel) read once at ``el`` bytes an element
    and the outputs written once."""
    bh, sq, skv, d = dims
    ql, kl, vl = fns["leaves"]
    lib = fns["lib"]
    io = el * (3 * bh * sq * d + 2 * bh * skv * d) + 4.0 * bh * sq
    bms, by = bound(10.0 * bh * sq * skv * d, BF16_FLOPS,
                    io + el * (bh * sq * d + 2 * bh * skv * d))
    row.update(ms=median_ms(fns["whole"]), plain_ms=median_ms(fns["plain"]),
               library_ms=median_ms(lib(ql, kl, vl)),
               device_ms=device_ms(torch, fns["whole"]),
               library_device_ms=device_ms(torch, lib(ql, kl, vl)),
               bound_ms=bms, bound_by=by)
    errs, out = row["errors"], {}
    for name, n_ops, out_bytes, err, kern, plain, wrt in (
            (names[0], 6, el * bh * sq * d, errs["dq"]["max_abs_err"],
             fns["dq"], fns["plain_dq"], (ql,)),
            (names[1], 8, 2 * el * bh * skv * d,
             max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"]),
             fns["dkv"], fns["plain_dkv"], (kl, vl))):
        kb, kby = bound(n_ops * bh * sq * skv * d, BF16_FLOPS,
                        io + 4.0 * bh * sq + out_bytes)
        out[name] = dict(kernel=name, **shape, ok=row["ok"], max_abs_err=err,
                         ms=median_ms(kern), plain_ms=median_ms(plain),
                         library_ms=median_ms(lib(*wrt)), bound_ms=kb, bound_by=kby)
        emit(out[name])
    return out


def library_backward(torch, leaves, do):
    """lib(*wrt): the backward of scaled_dot_product_attention on
    ``leaves`` (q, k, v with requires_grad) for the leaves ``wrt``."""
    import torch.nn.functional as F
    lib_out = F.scaled_dot_product_attention(*leaves)

    def lib(*wrt):
        return lambda: torch.autograd.grad(lib_out, wrt, do, retain_graph=True)
    return lib


def backward_rows(torch, dev, g, ids):
    """The RoPE backward (rows 5r/6r) at the training path's shapes: checked
    against the fp32 plain backward at b=1 and b=2 (B*H = 24 and 48),
    timed at b=1 by time_backward (the whole backward with its rotation
    pass; each kernel alone on operands the pass rotated before), the
    library yardstick on pre-rotated q, k."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.rope import apply_rotary
    rows = {"flash_attention_rope_bwd": [], BWD_NAMES[0]: [], BWD_NAMES[1]: []}
    for b_mult in (1, 2):
        for b, h, sq, skv, ident in ATTN_CASES + CONSIS_CASES:
            b *= b_mult
            d = fa.HEAD_DIM
            tabs = attention_tables(torch, dev, ids, sq, skv, ident)
            cos, sin, kcos, ksin = tabs
            q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g).bfloat16()
                           for s in (sq, skv, skv, sq))
            out, lse = fa.flash_attention_rope_fwd(q, k, v, *tabs, with_lse=True)
            got = fa.flash_attention_rope_bwd(q, k, v, out, lse, do, *tabs)
            torch.cuda.synchronize()
            want = fa.flash_attention_rope_bwd_ref(q, k, v, out, do, *tabs)
            errs, ok = gradient_errors(got, want)
            shape = dict(b=b, h=h, sq=sq, skv=skv, identity_rows=ident)
            row = dict(kernel="flash_attention_rope_bwd", **shape, errors=errs,
                       max_abs_err=max(e["max_abs_err"] for e in errs.values()), ok=ok)
            if not ok:
                truth = attention_bwd_fp64(torch, q, k, v, do, *tabs)
                row["kernel_vs_fp64"] = [(x.double() - t).abs().max().item()
                                         for x, t in zip(got, truth)]
                row["plain_vs_fp64"] = [(x.double() - t).abs().max().item()
                                        for x, t in zip(want, truth)]
            del got, want
            if b_mult == 1:
                drow = (do.float() * out.float()).sum(-1)
                kargs = (q, k, v, do, lse, drow, *tabs)
                rotated = fa._rotated_bwd_operands(q, k, v, do, *tabs)
                leaves = (apply_rotary(q, cos, sin).requires_grad_(),
                          apply_rotary(k, kcos, ksin).requires_grad_(),
                          v.clone().requires_grad_())

                def plain_dq():
                    _, kr32, _, ds, _ = fa._bwd_ref_parts(q, k, v, out, do, *tabs)
                    return apply_rotary(ds @ kr32, cos, -sin).to(q.dtype)

                def plain_dkv():
                    qr32, _, p, ds, dof = fa._bwd_ref_parts(q, k, v, out, do, *tabs)
                    return (apply_rotary(ds.transpose(-1, -2) @ qr32, kcos, -ksin),
                            p.transpose(-1, -2) @ dof)
                per_kernel = time_backward(torch, BWD_NAMES, shape, (b * h, sq, skv, d), 2,
                                           row, dict(
                    whole=lambda: fa.flash_attention_rope_bwd(q, k, v, out, lse, do, *tabs),
                    plain=lambda: fa.flash_attention_rope_bwd_ref(q, k, v, out, do, *tabs),
                    dq=lambda: fa.flash_attention_rope_bwd_dq(*kargs, rotated=rotated),
                    plain_dq=plain_dq,
                    dkv=lambda: fa.flash_attention_rope_bwd_dkv(*kargs, rotated=rotated),
                    plain_dkv=plain_dkv,
                    leaves=leaves, lib=library_backward(torch, leaves, do)))
                for name, krow in per_kernel.items():
                    rows[name].append(krow)
            emit(row)
            rows["flash_attention_rope_bwd"].append(row)
            del out, lse
    return rows


def norope_backward_rows(torch, dev, g):
    """Rows 5p/6p: the rope-free backward at NOROPE_BWD_CASES, checked as
    backward_rows checks the RoPE one and timed by time_backward (the whole
    backward with its rounding pass for fp32 inputs; each kernel alone on
    operands the pass rounded before; fp32 inputs and outputs counted at 4
    bytes)."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    rows = {"flash_attention_bwd": [], NOROPE_BWD_NAMES[0]: [], NOROPE_BWD_NAMES[1]: []}
    for b, h, sq, skv, d, dtype in NOROPE_BWD_CASES:
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.randn(b, h, s, d, device=dev, generator=g).to(dt)
                       for s in (sq, skv, skv, sq))
        out, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        errs, ok = gradient_errors(got, fa.flash_attention_bwd_ref(q, k, v, out, do))
        del got
        shape = dict(b=b, h=h, sq=sq, skv=skv, d=d, dtype=dtype)
        row = dict(kernel="flash_attention_bwd", **shape, errors=errs,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()), ok=ok)
        drow = (do.float() * out.float()).sum(-1)
        kargs = (q, k, v, do, lse, drow, fa._norope_bwd_operands(q, k, v, do))
        leaves = tuple(x.clone().requires_grad_() for x in (q, k, v))

        def parts():
            return fa._softmax_bwd_parts(q.float(), k.float(), v, out, do)

        def plain_dq():
            _, ds, _ = parts()
            return (ds @ k.float()).to(dt)

        def plain_dkv():
            p, ds, dof = parts()
            return ((ds.transpose(-1, -2) @ q.float()).to(dt),
                    (p.transpose(-1, -2) @ dof).to(dt))
        per_kernel = time_backward(torch, NOROPE_BWD_NAMES, shape, (b * h, sq, skv, d),
                                   q.element_size(), row, dict(
            whole=lambda: fa.flash_attention_bwd(q, k, v, out, lse, do),
            plain=lambda: fa.flash_attention_bwd_ref(q, k, v, out, do),
            dq=lambda: fa.flash_attention_bwd_dq(*kargs), plain_dq=plain_dq,
            dkv=lambda: fa.flash_attention_bwd_dkv(*kargs), plain_dkv=plain_dkv,
            leaves=leaves, lib=library_backward(torch, leaves, do)))
        for name, krow in per_kernel.items():
            rows[name].append(krow)
        emit(row)
        rows["flash_attention_bwd"].append(row)
        del out, lse
    return rows


def device_breakdown(torch, fn, phase="profile", **extra):
    """Device time of one call of ``fn`` by kernel (torch.profiler), beside
    its wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    groups = {"w4a8_matmul": 0.0, "quantize_act": 0.0, "flash_attention_rope": 0.0,
              "rope_rotate": 0.0, "flash_attention_rope_bwd": 0.0, "flash_attention": 0.0,
              "flash_attention_bwd": 0.0, "library gemm": 0.0, "other": 0.0}
    for name, us in by_name.items():
        key = ("w4a8_matmul" if "w4a8" in name else
               "quantize_act" if "quantize_act" in name else
               "rope_rotate" if "rope_rotate" in name else
               "flash_attention_rope_bwd" if "flash_rope_bwd" in name else
               "flash_attention_bwd" if "flash_bwd" in name else
               "flash_attention_rope" if "flash_rope" in name else
               "flash_attention" if "flash_kernel" in name else
               "library gemm" if any(t in name.lower() for t in
                                     ("gemm", "cutlass", "xmma", "nvjet"))
               else "other")
        groups[key] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit(dict(phase=phase, **extra, wall_ms=wall_us / 1e3,
              device_busy_ms=busy / 1e3,
              device_idle_share=(1 - busy / wall_us) if busy else None,
              groups_ms={k: v / 1e3 for k, v in groups.items()},
              top_kernels_ms=[[n[:80], us / 1e3] for n, us in top]))


def launch_counts():
    """Every kernel wrapper's launch count, by kernel name."""
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    return {"flash_attention_rope": fa.launches, "rope_rotate": fa.rotate_launches,
            BWD_NAMES[0]: fa.dq_launches,
            BWD_NAMES[1]: fa.dkv_launches, "w4a8_matmul": qm.launches,
            "w4a8_general": qm.general_launches, "quantize_act": qm.quantize_launches,
            "flash_attention": fa.norope_launches,
            NOROPE_BWD_NAMES[0]: fa.norope_dq_launches,
            NOROPE_BWD_NAMES[1]: fa.norope_dkv_launches}


def reset_launch_counts():
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    fa.launches = fa.rotate_launches = fa.dq_launches = fa.dkv_launches = 0
    fa.norope_launches = 0
    fa.norope_dq_launches = fa.norope_dkv_launches = 0
    qm.launches = qm.general_launches = qm.quantize_launches = 0


def expected_sd3_launches(cfg, batch: int = 1) -> int:
    """Rope-free attention calls of one UniGen-SD3 forward at ``batch``:
    every base joint block (and attn2 of the dual ones), the control joint
    block run after each base block, two block-expert calls per expert (the
    hidden and the condition stream; per sample under per-sample routing),
    and the shared expert's weave_cond, weave_text and weave_text's attn2."""
    bb, cc = cfg.sd3, cfg.control
    dual = sum(i in set(bb.dual_attention_layers) for i in range(bb.num_layers))
    experts = (0 if cc.use_modulate or cc.use_rope
               else 2 * cc.moe.num_experts(cfg.condition_nums))
    if cc.moe.batch_mode == "per_sample" and batch > 1:
        experts *= batch
    return 2 * bb.num_layers + dual + experts + (3 if cc.use_shared_expert else 0)


def quantized_calls(params, cfg, leaf: str, again: bool = False) -> int:
    """Calls of the quantized linears whose codes are ``leaf`` ("w_q4":
    W4A8, "w_q": W8A8) in one UniGen-FLUX forward: a stacked leaf once per
    application of its stack (the control double and single stacks and
    their add linears once per base block), the shared expert's and the
    condition embedder's once per condition, any other once. ``again``:
    the calls that the remat bodies (base + control double block i >= 1
    with its add linear, base + control single block with its add linear)
    run once more in the backward. The context branch of the control double
    blocks, of the shared expert's weave_text and of the consis module (the
    context's output projection and ``ff_context``) is never run: their
    callers discard it. The consis module's block0 runs twice per
    condition, its block1 never (the reference's quirk)."""
    from unigen_tpu_torch.utils import tree_leaves_with_path
    bb = cfg.flux
    if again:
        uses = {"double_blocks": bb.num_layers - 1, "single_blocks": bb.num_single_layers,
                "add_double": bb.num_layers - 1, "add_single": bb.num_single_layers}
        default = 0
    else:
        uses = {"double_blocks": bb.num_layers, "single_blocks": bb.num_single_layers,
                "add_double": bb.num_layers, "add_single": bb.num_single_layers,
                "shared_expert": cfg.condition_nums, "condition_embed": cfg.condition_nums}
        default = 1
    def use(path):
        if path[1] == "consis":
            return 0 if again or path[2] == "block1" else 2 * cfg.condition_nums
        return uses.get(path[1], default)
    return sum(use(path) for path, _ in tree_leaves_with_path(params)
               if path[-1] == leaf and not discarded_context(path))


def discarded_context(path) -> bool:
    """A leaf of a control block's context branch that no forward runs: the
    control double blocks (FLUX), the control joint blocks (SD3) and the
    shared expert's weave_text return only their sample stream."""
    control_double = path[:2] in (("control", "double_blocks"), ("control", "joint_blocks"),
                                  ("control", "consis")) \
        or path[:3] == ("control", "shared_expert", "weave_text")
    return control_double and ("ff_context" in path or "to_add_out" in path)


def expected_launches(params, cfg, batch: int = 1, fp32: bool = False):
    """Kernel launches of one UniGen-FLUX forward at ``batch``, by kernel:
    the attention sites (the base blocks with rope; the control blocks and
    the shared-expert weave with rope under ``use_rope``, rope-free
    otherwise; with block experts, two rope-free calls per expert and
    condition, per sample under per-sample routing), and the W4A8 linear
    calls counted from the tree (a stacked leaf is used once per
    application of its stack); one rotation pass per RoPE attention call,
    and with ``fp32`` activations one (rounding k and v) per rope-free
    call; one activation quantization per quantized linear call (W4A8 and
    W8A8); no launch of the general W4A8 kernel (no path shape needs
    it)."""
    bb, cc = cfg.flux, cfg.control
    w4 = quantized_calls(params, cfg, "w_q4")
    single_ctrl = cc.use_single_trans_blocks and "single_blocks" in params["control"]
    control = (bb.num_layers + (bb.num_single_layers if single_ctrl else 0)
               + (2 if cc.use_shared_expert else 0) * cfg.condition_nums
               + (2 if "consis" in params["control"] else 0) * cfg.condition_nums)
    experts = 0
    if not (cc.use_modulate or cc.use_rope):
        experts = 2 * cc.moe.num_experts(cfg.condition_nums) * cfg.condition_nums
        if cc.moe.batch_mode == "per_sample":
            experts *= batch
    rope = bb.num_layers + bb.num_single_layers + (control if cc.use_rope else 0)
    norope = (0 if cc.use_rope else control) + experts
    return {"flash_attention_rope": rope, "rope_rotate": rope + (norope if fp32 else 0),
            "flash_attention": norope, "w4a8_matmul": w4, "w4a8_general": 0,
            "quantize_act": w4 + quantized_calls(params, cfg, "w_q")}


def expected_train_launches(params, cfg, batch: int = 1, fp32: bool = False,
                            remat="full", lora: bool = False):
    """Kernel launches of one training micro-step at ``batch`` with a frozen
    base: every forward call of expected_launches, plus, under remat "full"
    or "dots" (which saves only the weight products: a kernel is a ctypes
    call the dispatcher does not see, so it runs again as under "full"),
    the forward that each remat body (base + control double block i >= 1,
    base + control single block) runs again in the backward; one backward
    per attention call except base double block 0, which sees no trainable
    input; one rotation pass per RoPE forward and per RoPE backward, and
    with ``fp32`` activations also one per rope-free forward and per
    rope-free backward (the rounding of their operands); one activation
    quantization per quantized linear call of the forward and of the
    recomputation (the straight-through backward of the default
    ``quant_bwd="bf16"`` quantizes nothing). In LoRA mode (``lora``)
    ``params`` is the tree after ``fold_for_training``: its targeted
    linears are floating products and leave the W4A8 count; and the MoE
    preprocess (the block experts, the consis module, the shared expert's
    weave) holds no factor and sees no trainable input, so its attention
    calls get no backward."""
    bb, cc = cfg.flux, cfg.control
    per = expected_launches(params, cfg, batch)
    single_ctrl = cc.use_single_trans_blocks and "single_blocks" in params["control"]
    again = remat not in (False, None, "none")
    base_again = (bb.num_layers - 1 + bb.num_single_layers) if again else 0
    ctrl_again = (bb.num_layers - 1 + (bb.num_single_layers if single_ctrl else 0)
                  if again else 0)
    w4_again = quantized_calls(params, cfg, "w_q4", again=True) if again else 0
    w8_again = quantized_calls(params, cfg, "w_q", again=True) if again else 0
    rope, norope = per["flash_attention_rope"], per["flash_attention"]
    rope_fwd = rope + base_again + (ctrl_again if cc.use_rope else 0)
    norope_fwd = norope + (0 if cc.use_rope else ctrl_again)
    rope_bwd, norope_bwd = rope - 1, norope
    if lora:
        weave = ((2 if cc.use_shared_expert else 0)
                 + (2 if "consis" in params["control"] else 0)) * cfg.condition_nums
        experts = 0
        if not (cc.use_modulate or cc.use_rope):
            experts = 2 * cc.moe.num_experts(cfg.condition_nums) * cfg.condition_nums
            if cc.moe.batch_mode == "per_sample":
                experts *= batch
        rope_bwd -= weave if cc.use_rope else 0
        norope_bwd -= experts + (0 if cc.use_rope else weave)
    return {"flash_attention_rope": rope_fwd,
            "rope_rotate": rope_fwd + rope_bwd + (norope_fwd + norope_bwd if fp32 else 0),
            BWD_NAMES[0]: rope_bwd, BWD_NAMES[1]: rope_bwd,
            "flash_attention": norope_fwd,
            NOROPE_BWD_NAMES[0]: norope_bwd, NOROPE_BWD_NAMES[1]: norope_bwd,
            "w4a8_matmul": per["w4a8_matmul"] + w4_again, "w4a8_general": 0,
            "quantize_act": per["quantize_act"] + w4_again + w8_again}


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def phase_slice(torch, dev):
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    from unigen_tpu_torch.models.unigen_flux import UniGenFlux
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    from unigen_tpu_torch.serving import MicroBatchServer
    from unigen_tpu_torch.utils import param_bytes

    cfg = presets.flux_full()
    bb = cfg.flux
    t0 = time.time()
    params = init_quantized_serving_params(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    resident = param_bytes(params)
    model = UniGenFlux(cfg, params, device=dev)
    print(f"# slice: flux_full W4A8 tree built in {time.time() - t0:.1f}s, "
          f"resident {resident / 2**30:.3f} GiB", flush=True)

    host = torch.Generator().manual_seed(1)

    def request():
        def mk(*shape):
            return torch.randn(*shape, generator=host).numpy()
        return dict(latents=mk(1, HW * HW, bb.in_channels),
                    condition=mk(1, HW * HW, bb.in_channels),
                    encoder=mk(1, SEQ_TXT, bb.joint_attention_dim),
                    pooled=mk(1, bb.pooled_projection_dim),
                    cond_pooled=mk(1, bb.pooled_projection_dim))

    reqs = [request() for _ in range(N_REQUESTS)]
    warm = {k: torch.cat([torch.as_tensor(r[k]) for r in reqs[:BATCH]])
            for k in reqs[0]}
    t0 = time.time()
    model.denoise(**warm, num_steps=1)
    torch.cuda.synchronize()
    print(f"# slice: warm-up forward {time.time() - t0:.2f}s", flush=True)

    srv = MicroBatchServer(lambda x: model.denoise(**x, num_steps=STEPS),
                           batch_size=BATCH, max_wait_ms=50)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        t0 = time.time()
        futs = [srv.submit(**r) for r in reqs]
        outs = [f.result(timeout=900) for f in futs]
        dt = time.time() - t0
    finally:
        srv.close()
    launches = nonzero(launch_counts())
    peak = torch.cuda.max_memory_allocated()

    forwards = srv.stats.batches * STEPS
    per_fwd = nonzero(expected_launches(params, cfg, BATCH))
    want = {k: n * forwards for k, n in per_fwd.items()}
    for o in outs:
        if tuple(o.shape) != (1, HW * HW, bb.in_channels) or not torch.isfinite(o).all():
            raise SystemExit(f"bad denoise output: {tuple(o.shape)}")
    if srv.stats.batches != N_REQUESTS // BATCH or launches != want:
        raise SystemExit(f"launches {launches} != expected {want} "
                         f"({srv.stats.batches} batches)")

    # one forward with the kernels, one with the plain versions, same inputs
    def forward_fn(batch):
        x = {k: v.to(dev, model.dtype) for k, v in batch.items()}
        b = x["latents"].shape[0]
        img_ids = prepare_latent_image_ids(HW, HW, device=dev)
        args = (x["latents"], x["condition"], x["encoder"], x["pooled"],
                x["cond_pooled"], torch.ones(b, dtype=model.dtype, device=dev),
                img_ids, torch.zeros(SEQ_TXT, 3, device=dev), img_ids)
        return lambda: model(*args)[0]

    # One forward with the kernels, each call also held against its plain
    # version on the path's own inputs (under this random init the
    # differences inside the forward need not reach its output, so the output
    # alone may not see a kernel fault); then one forward with the plain
    # versions on the same inputs.
    fwd1 = forward_fn({k: torch.as_tensor(v) for k, v in reqs[0].items()})
    checks = {}
    with torch.no_grad():
        before = launch_counts()
        with shadowed_kernels(torch, checks):
            pred_k = fwd1().float()
        mid = launch_counts()
        with plain_kernels():
            pred_p = fwd1().float()
        after = launch_counts()
    if mid != {k: n + per_fwd.get(k, 0) for k, n in before.items()} or after != mid:
        raise SystemExit(f"kernel/plain forwards launched {before} -> {mid} -> {after}")
    path_check = path_check_summary(checks)
    emit(dict(phase="path_check", **path_check))
    if any(c["disagree"] or not c["calls"] for c in path_check.values()) \
            or set(path_check) != {"flash_attention_rope", "w4a8_matmul", "quantize_act"}:
        raise SystemExit(f"a kernel disagrees with its plain version on the path: "
                         f"{path_check}")
    rel = ((pred_k - pred_p).norm() / pred_p.norm()).item()
    print(f"# slice: kernel vs plain forward: |pred| mean {pred_p.abs().mean().item():.4g}, "
          f"max abs diff {(pred_k - pred_p).abs().max().item():.4g}, "
          f"{int((pred_k != pred_p).sum())} of {pred_p.numel()} values differ", flush=True)

    with torch.no_grad():
        device_breakdown(torch, forward_fn(warm), forward_batch=BATCH)
    result = dict(phase="slice", requests=N_REQUESTS, batches=srv.stats.batches,
                  steps=STEPS, seconds=dt, images_per_s=N_REQUESTS / dt,
                  ms_per_denoise_step=dt / forwards * 1e3,
                  attention_launches_per_forward=per_fwd["flash_attention_rope"],
                  w4a8_launches_per_forward=per_fwd["w4a8_matmul"],
                  quantize_launches_per_forward=per_fwd["quantize_act"], launches=launches,
                  kernel_vs_plain_rel_l2=rel, peak_bytes=peak,
                  resident_bytes=resident, out_shape=list(outs[0].shape))
    emit(result)
    if not (rel <= 3e-2):
        raise SystemExit(f"kernel forward differs from plain: rel L2 {rel}")
    return params, launches


class SeededTokenizer:
    """A tokenizer's call signature (the card host has no transformers):
    each prompt's ids are drawn from a generator seeded with ``seed`` and
    the prompt's CRC, a few per word, then ``eos``, then 0 padding; the
    attention mask is 1 up to the eos."""

    def __init__(self, vocab: int, eos: int, seed: int):
        self.vocab, self.eos, self.seed = vocab, eos, seed

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        import zlib

        import numpy as np
        ids = np.zeros((len(prompts), max_length), np.int64)
        for i, p in enumerate(prompts):
            rng = np.random.default_rng([self.seed, zlib.crc32(p.encode())])
            n = min(2 * len(p.split()) + 2, max_length - 1)
            ids[i, :n] = rng.integers(2, self.vocab - 1, n)
            ids[i, n] = self.eos

        class Out:
            input_ids = ids
            attention_mask = (np.arange(max_length)[None, :]
                              <= np.argmax(ids == self.eos, axis=1)[:, None]).astype(np.int32)
        return Out()


def expected_replay_launches(params, cfg):
    """Kernel launches of one UniGen-FLUX forward that replays cached control
    residuals: the base blocks only (no MoE preprocess, no control block,
    no add linear), at any batch."""
    bb = cfg.flux
    base = {"base": params["base"]}
    rope = bb.num_layers + bb.num_single_layers
    w4 = quantized_calls(base, cfg, "w_q4")
    return {"flash_attention_rope": rope, "rope_rotate": rope, "flash_attention": 0,
            "w4a8_matmul": w4, "w4a8_general": 0,
            "quantize_act": w4 + quantized_calls(base, cfg, "w_q")}


def expected_pipeline_launches(params, cfg, steps):
    """Launches of a run of pipeline denoise loops: ``steps`` lists (batch,
    n_full, n_base) per loop; a full step runs expected_launches, a base
    step expected_replay_launches (one stream, no true CFG), a skip step
    none."""
    out = {}
    replay = expected_replay_launches(params, cfg)
    for batch, n_full, n_base in steps:
        full = expected_launches(params, cfg, batch)
        for k in set(full) | set(replay):
            out[k] = out.get(k, 0) + n_full * full.get(k, 0) + n_base * replay.get(k, 0)
    return nonzero(out)


def step_kinds(mode, refreshes, steps):
    """(n_full, n_base, n_skip) of one denoise loop from the pipeline's cache
    mode (``pipelines.caching.resolve_cache_mode``) and its
    ``last_cache_refreshes``: the control cache replays residuals between
    refreshes, the model cache skips the transformer."""
    if mode.exact:
        return steps, 0, 0
    if mode.hybrid:
        return refreshes[0], refreshes[1], steps - sum(refreshes)
    if mode.model_cache:
        return refreshes, 0, steps - refreshes
    return refreshes, steps - refreshes, 0


@contextlib.contextmanager
def drift_log(values):
    """Append every drift the adaptive cache rules read to ``values``."""
    from unigen_tpu_torch.pipelines import caching
    real = caching.rel_change

    def logged(lat, ref):
        out = real(lat, ref)
        values.append(round(out.item(), 6))
        return out
    caching.rel_change = logged
    try:
        yield
    finally:
        caching.rel_change = real


def residual_cache_bytes(cfg, batch, s_img, s_txt, bits):
    """Bytes of one stream's control-residual cache: the double blocks'
    adds over the image tokens and the single blocks' over text and image,
    bf16 (bits 16), or int8 / packed int4 codes with an fp32 scale a token."""
    bb = cfg.flux
    tokens = batch * (bb.num_layers * s_img + bb.num_single_layers * (s_img + s_txt))
    per_token = {16: 2 * bb.inner_dim, 8: bb.inner_dim + 4, 4: bb.inner_dim // 2 + 4}
    return tokens * per_token[bits]


@contextlib.contextmanager
def stage_timer(torch, pipe, stages):
    """Record CUDA events around the pipeline's control encode, denoise and
    decode (the instance's methods are wrapped); ``stages[name]`` collects
    (start, end) pairs."""
    names = {"encode_control": "vae_encode", "denoise": "denoise", "decode": "vae_decode"}

    def wrap(method, name):
        def timed(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = method(*a, **kw)
            end.record()
            stages.setdefault(name, []).append((start, end))
            return out
        return timed
    for attr, name in names.items():
        setattr(pipe, attr, wrap(getattr(pipe, attr), name))
    try:
        yield
    finally:
        for attr in names:
            delattr(pipe, attr)


def stage_ms(torch, stages):
    torch.cuda.synchronize()
    return {name: sum(s.elapsed_time(e) for s, e in pairs) for name, pairs in stages.items()}


def conv_group(name):
    """The pipeline profile's group of a CUDA kernel name."""
    low = name.lower()
    if any(t in low for t in ("conv", "fprop", "dgrad", "wgrad", "winograd", "implicit",
                              "cudnn", "nchw", "nhwc")):
        return "convolutions"
    if "w4a8" in low:
        return "w4a8_matmul"
    if "quantize_act" in low:
        return "quantize_act"
    if "rope_rotate" in low:
        return "rope_rotate"
    if "flash_rope" in low:
        return "flash_attention_rope"
    if "flash" in low:
        return "flash_attention"
    if any(t in low for t in ("gemm", "cutlass", "xmma", "nvjet")):
        return "library gemm"
    return "elementwise and other"


def profile_groups(torch, fn):
    """Device time by conv_group of one call of ``fn`` (torch.profiler), the
    wall time of an unprofiled call beside it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            g = conv_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    return wall_ms, groups


def phase_pipeline(torch, dev, params, seed):
    """The FLUX pipeline end to end on phase 4's W4A8 flux_full tree, with a
    full-width random VAE (fp32), CLIP-L and T5-XXL (bf16) from ``seed`` and
    seeded stub tokenizers: in each mode of PIPELINE_MODES four b=1
    requests at 512^2, 4 steps, their prompts through encode_prompt (the
    repeated condition prompt hits the prompt LRU), served by
    MicroBatchServer(batch_size=2); the launch counters must equal the
    formula of the steps taken. Then the replay, composition, path, VAE
    and profile checks. Every check stops the run. -> the VAE's config and
    tree (the text towers are freed on return)."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.clip_text import CLIPTextConfig, init_clip_params
    from unigen_tpu_torch.models.t5_text import T5Config, init_t5_params
    from unigen_tpu_torch.pipelines import scheduling
    from unigen_tpu_torch.pipelines.caching import resolve_cache_mode
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
    from unigen_tpu_torch.serving import MicroBatchServer
    from unigen_tpu_torch.utils import param_bytes, tree_map

    cfg = presets.flux_full()
    bb = cfg.flux
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.time()
    vae_cfg, clip_cfg, t5_cfg = vae_lib.VAEConfig(), CLIPTextConfig(), T5Config()
    pipe = UniGenFluxPipeline(
        cfg=cfg, params=params, vae_cfg=vae_cfg,
        vae_params=vae_lib.init_vae_params(vae_cfg, gen=gen, device=dev),
        clip_cfg=clip_cfg, clip_params=init_clip_params(clip_cfg, gen=gen, device=dev,
                                                        dtype=torch.bfloat16),
        t5_cfg=t5_cfg, t5_params=init_t5_params(t5_cfg, gen=gen, device=dev,
                                                dtype=torch.bfloat16),
        tokenizer=SeededTokenizer(clip_cfg.vocab_size, clip_cfg.eos_token_id, seed),
        tokenizer_2=SeededTokenizer(t5_cfg.vocab_size, 1, seed + 1),
        prompt_cache_size=64, device=dev)
    torch.cuda.synchronize()
    sizes = {k: param_bytes(getattr(pipe, k)) for k in ("vae_params", "clip_params",
                                                         "t5_params")}
    print(f"# pipeline: VAE, CLIP-L, T5-XXL built in {time.time() - t0:.1f}s: "
          f"{sizes}", flush=True)
    host = torch.Generator().manual_seed(seed + 5)
    pixels = [torch.rand(1, 3, PIPE_RES, PIPE_RES, generator=host) * 2 - 1
              for _ in range(N_REQUESTS)]
    s_img = (PIPE_RES // (2 * vae_cfg.downscale)) ** 2

    # warm-up: a b=2 "balanced" generate runs both forward kinds and the VAE
    # (cuDNN picks its algorithms)
    e, p = pipe.encode_prompt(["warm-up a", "warm-up b"])
    c = pipe.encode_condition_prompt(["canny", "canny"])
    pipe.generate(prompt_embeds=e, pooled=p, cond_pooled=c,
                  control_pixels=torch.cat(pixels[:BATCH]), height=PIPE_RES,
                  width=PIPE_RES, num_inference_steps=STEPS, quality_profile="balanced")
    torch.cuda.synchronize()

    for name, knobs in PIPELINE_MODES:
        mode = resolve_cache_mode(STEPS, **knobs)
        refreshes, stages, drifts = [], {}, []

        def run(x, knobs=knobs):
            out = pipe.generate(**x, height=PIPE_RES, width=PIPE_RES,
                                num_inference_steps=STEPS, **knobs)
            refreshes.append((x["pooled"].shape[0], pipe.last_cache_refreshes))
            return out

        srv = MicroBatchServer(run, batch_size=BATCH, max_wait_ms=50)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        hits = pipe._prompt_cache.hits
        try:
            with stage_timer(torch, pipe, stages), drift_log(drifts):
                t0 = time.perf_counter()
                enc_start = torch.cuda.Event(enable_timing=True)
                enc_end = torch.cuda.Event(enable_timing=True)
                enc_start.record()
                reqs = []
                for r in range(N_REQUESTS):
                    e, p = pipe.encode_prompt(f"{name} request {r}: a photo of a red cube")
                    reqs.append(dict(prompt_embeds=e, pooled=p,
                                     cond_pooled=pipe.encode_condition_prompt("canny"),
                                     control_pixels=pixels[r]))
                enc_end.record()
                outs = [f.result(timeout=900) for f in [srv.submit(**r) for r in reqs]]
                wall = time.perf_counter() - t0
        finally:
            srv.close()
        launches = nonzero(launch_counts())
        peak = torch.cuda.max_memory_allocated()
        ms = stage_ms(torch, stages)
        ms["prompt_encoding"] = enc_start.elapsed_time(enc_end)
        kinds = [(b, *step_kinds(mode, ref, STEPS)) for b, ref in refreshes]
        want = expected_pipeline_launches(params, cfg, [k[:3] for k in kinds])
        cached = mode.hybrid or not (mode.exact or mode.model_cache)
        res_bytes = residual_cache_bytes(cfg, BATCH, s_img, SEQ_TXT, mode.bits) if cached else 0
        emit(dict(phase="pipeline", mode=name, knobs=knobs, requests=N_REQUESTS,
                  batches=srv.stats.batches, steps=STEPS, resolution=PIPE_RES,
                  wall_ms=wall * 1e3, images_per_s=N_REQUESTS / wall, stage_ms=ms,
                  steps_per_batch=[dict(batch=b, n_full=f, n_base=n, n_skip=s)
                                   for b, f, n, s in kinds],
                  residual_cache_bytes=res_bytes, residual_bits=mode.bits if cached else None,
                  adaptive_drifts=drifts,
                  peak_bytes=peak, prompt_cache_hits=pipe._prompt_cache.hits - hits,
                  launches=launches, expected_launches=want,
                  out_shape=list(outs[0].shape)))
        for o in outs:
            if o.dtype != torch.uint8 or tuple(o.shape) != (1, PIPE_RES, PIPE_RES, 3):
                raise SystemExit(f"pipeline {name}: bad output {o.dtype} {tuple(o.shape)}")
        if launches != want or srv.stats.batches != N_REQUESTS // BATCH:
            raise SystemExit(f"pipeline {name}: launches {launches} != expected {want} "
                             f"({srv.stats.batches} batches, steps {kinds})")
        if pipe._prompt_cache.hits - hits < N_REQUESTS - 1:
            raise SystemExit(f"pipeline {name}: the condition prompt missed the LRU")

    # one request through __call__: the same bits as generate on its encodings
    # and the latents drawn from the same seed
    img = pipe("a photo of a red cube", "canny", pixels[0], height=PIPE_RES,
               width=PIPE_RES, num_inference_steps=STEPS, seed=seed)
    e, p = pipe.encode_prompt("a photo of a red cube")
    want_img = pipe.generate(prompt_embeds=e, pooled=p,
                             cond_pooled=pipe.encode_condition_prompt("canny"),
                             control_pixels=pixels[0].to(dev, pipe.dtype),
                             height=PIPE_RES, width=PIPE_RES, num_inference_steps=STEPS,
                             seed=seed)
    emit(dict(phase="pipeline_call", same_bits_as_generate=torch.equal(img, want_img),
              out_shape=list(img.shape)))
    if not torch.equal(img, want_img):
        raise SystemExit("pipeline: __call__ differs from generate")

    one = dict(prompt_embeds=e, pooled=p, cond_pooled=pipe.encode_condition_prompt("canny"),
               control_pixels=pixels[0], height=PIPE_RES, width=PIPE_RES,
               num_inference_steps=STEPS, seed=seed)
    real_denoise = pipe.denoise

    # replay: at the first step's state, a capturing forward and forwards
    # replaying its residuals (bf16: the same bits; int8/int4: within the
    # bound the CPU tests hold JAX and the port to); beside them, how far the
    # quantized residuals are from the bf16 ones
    from unigen_tpu_torch.ops.quant import dequantize_residual
    replay, exact_res = {}, None

    def replay_check(mode, latents, fwd, streams, sigmas, num_steps, cfg_scale):
        for bits in (16, 8, 4):
            pred, outs = fwd(latents, 0, *streams[0], return_control_residuals=True,
                             control_residuals_bits=bits)
            res = outs["control_residuals"]
            again = fwd(latents, 0, *streams[0], control_residuals=res)[0]
            nbytes = sum(t.numel() * t.element_size() for r in res
                         for t in (r.values() if isinstance(r, dict) else [r]))
            rel = ((again.float() - pred.float()).norm() / pred.float().norm()).item()
            if bits == 16:
                exact_res = res
            # in fp64: under the random init the residuals reach ~1e20, past
            # what an fp32 sum of squares holds
            deq = [dequantize_residual(r, torch.float64) if isinstance(r, dict) else r.double()
                   for r in res]
            res_rel = math.sqrt(sum((a - b.double()).square().sum().item()
                                    for a, b in zip(deq, exact_res))
                                / sum(b.double().square().sum().item() for b in exact_res))
            replay[bits] = dict(rel_l2=rel, same_bits=torch.equal(again, pred),
                                residual_rel_l2=res_rel,
                                residual_max_abs=max(r.abs().max().item() for r in deq),
                                bytes=nbytes, bytes_expected=residual_cache_bytes(
                                    cfg, 1, s_img, SEQ_TXT, bits),
                                bound=0.0 if bits == 16 else REPLAY_REL_L2[bits])
        return real_denoise(mode, latents, fwd, streams, sigmas, num_steps, cfg_scale)
    pipe.denoise = replay_check
    pipe.generate(**one)
    del pipe.denoise
    emit(dict(phase="pipeline_replay_check", state="step 0 of a b=1 request", **{
        f"bits_{b}": r for b, r in replay.items()}))
    if not replay[16]["same_bits"] or any(
            r["rel_l2"] > r["bound"] or r["bytes"] != r["bytes_expected"]
            or not r["residual_rel_l2"] > 0 for b, r in replay.items() if b != 16):
        raise SystemExit(f"pipeline: replay check failed: {replay}")

    # composition: "balanced" (c=4, m=2, int8) written out as forward calls:
    # full at step 0, base replaying its residuals at 2, the held
    # prediction at 1 and 3
    def composed(mode, lat, fwd, streams, sigmas, num_steps, cfg_scale):
        pred, outs = fwd(lat, 0, *streams[0], return_control_residuals=True,
                         control_residuals_bits=8)
        lat = scheduling.euler_step(lat, pred, sigmas[0], sigmas[1])
        lat = scheduling.euler_step(lat, pred, sigmas[1], sigmas[2])
        pred = fwd(lat, 2, *streams[0], control_residuals=outs["control_residuals"])[0]
        lat = scheduling.euler_step(lat, pred, sigmas[2], sigmas[3])
        return scheduling.euler_step(lat, pred, sigmas[3], sigmas[4])
    reset_launch_counts()
    balanced = pipe.generate(**one, quality_profile="balanced")
    gen_launches = nonzero(launch_counts())
    pipe.denoise = composed
    reset_launch_counts()
    by_hand = pipe.generate(**one)
    hand_launches = nonzero(launch_counts())
    del pipe.denoise
    want = expected_pipeline_launches(params, cfg, [(1, 1, 1)])
    emit(dict(phase="pipeline_composition", mode="balanced", same_bits=torch.equal(
        balanced, by_hand), launches=gen_launches, composition_launches=hand_launches,
        expected_launches=want,
        full_forward_launches=nonzero(expected_launches(params, cfg, 1)),
        replay_forward_launches=nonzero(expected_replay_launches(params, cfg))))
    if not torch.equal(balanced, by_hand) or not gen_launches == hand_launches == want:
        raise SystemExit("pipeline: balanced generate differs from its composition")

    # path check: every kernel call of a balanced generate (a full and a
    # base-with-replay forward) against its plain version
    checks = {}
    with shadowed_kernels(torch, checks):
        pipe.generate(**one, quality_profile="balanced")
    path_check = path_check_summary(checks)
    emit(dict(phase="pipeline_path_check", mode="balanced", **path_check))
    if any(c["disagree"] or not c["calls"] for c in path_check.values()) \
            or {n: c["calls"] for n, c in path_check.items()} != {
                n: want[n] for n in ("flash_attention_rope", "w4a8_matmul", "quantize_act")}:
        raise SystemExit(f"pipeline: a kernel disagrees with its plain version: "
                         f"{path_check}")

    # VAE: the fp32 modules against the same weights in fp64 on the card
    vae64 = tree_map(lambda t: t.double(), pipe.vae_params)
    px = pixels[0].to(dev)
    with torch.no_grad():
        z32 = vae_lib.vae_encode(pipe.vae_params, vae_cfg, px)
        z64 = vae_lib.vae_encode(vae64, vae_cfg, px.double())
        x32 = vae_lib.vae_decode(pipe.vae_params, vae_cfg, z32)
        x64 = vae_lib.vae_decode(vae64, vae_cfg, z32.double())
    vae = {n: dict(rel_l2=((a.double() - b).norm() / b.norm()).item(),
                   max_abs_err=(a.double() - b).abs().max().item(),
                   max_abs=b.abs().max().item())
           for n, a, b in (("encode", z32, z64), ("decode", x32, x64))}
    emit(dict(phase="pipeline_vae_check", reference="the same modules in fp64 on the card",
              tolerance_rel_l2=VAE_REL_L2, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, **vae))
    if any(not (v["rel_l2"] <= VAE_REL_L2) for v in vae.values()):
        raise SystemExit(f"pipeline: the VAE is off its fp64 version: {vae}")
    del vae64

    # profile: device time by group of one exact b=1 generate, and of the
    # text towers encoding one new prompt
    text_wall, text = profile_groups(torch, lambda: pipe.encode_prompt(
        f"profiled prompt {time.time()}"))
    wall, groups = profile_groups(torch, lambda: pipe.generate(**one))
    busy = sum(groups.values())
    emit(dict(phase="pipeline_profile", mode="exact", batch=1, wall_ms=wall,
              device_busy_ms=busy, device_idle_share=1 - busy / wall,
              groups_ms=groups, text_towers=dict(wall_ms=text_wall,
                                                 device_busy_ms=sum(text.values()),
                                                 groups_ms=text)))
    return vae_cfg, pipe.vae_params


def phase_train(torch, dev, cfg, params, seed, n_trainable, phase="train"):
    """The full-width fine-tune step (bench.py run_full's configuration) of
    ``cfg`` on its W4A8 serving tree: trainable = its float leaves (bf16),
    frozen = the W4A8/W8A8 codes and scales. Reports lines ``phase``,
    ``phase``_profile and ``phase``_grad_check; returns the launch counts of
    the timed micro-steps."""
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.ops.quant import split_trainable
    from unigen_tpu_torch.train import train_step as ts
    from unigen_tpu_torch.utils import tree_leaves

    bb = cfg.flux
    tcfg = TrainConfig(train_batch_size=BATCH, remat="full",
                       gradient_accumulation_steps=TRAIN_ACCUM)
    trainable, frozen = split_trainable(params["control"])
    n_train = sum(t.numel() for t in tree_leaves(trainable))
    if n_train != n_trainable:
        raise SystemExit(f"{phase}: trainable count {n_train} != {n_trainable}")
    base_arg = {"base": params["base"], "control_frozen": frozen}
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = 2 * HW                      # 64^2 latents for 512^2 images

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()
    c = bb.in_channels // 4           # 16 VAE channels, packed 2x2 -> 64
    batch = dict(latents=mk(BATCH, c, lat, lat), condition_latents=mk(BATCH, c, lat, lat),
                 prompt_embeds=mk(BATCH, SEQ_TXT, bb.joint_attention_dim),
                 pooled=mk(BATCH, bb.pooled_projection_dim),
                 condition_pooled=mk(BATCH, bb.pooled_projection_dim))
    step = ts.make_train_step(cfg, tcfg)
    state = ts.init_train_state(trainable, tcfg)
    t0 = time.time()
    state, m = step(state, base_arg, batch, g)            # warm-up micro-step
    torch.cuda.synchronize()
    print(f"# {phase}: warm-up micro-step {time.time() - t0:.2f}s, "
          f"loss {float(m['step_loss']):.5g}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_MICRO_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, base_arg, batch, g)
        losses.append(float(m["step_loss"]))              # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nonzero(launch_counts())
    peak = torch.cuda.max_memory_allocated()
    per_step = nonzero(expected_train_launches(params, cfg, BATCH))
    want = {k: n * TRAIN_MICRO_STEPS for k, n in per_step.items()}
    result = dict(phase=phase, micro_steps=TRAIN_MICRO_STEPS, micro_batch=BATCH,
                  accumulation=TRAIN_ACCUM, remat=tcfg.remat,
                  optimizer_updates=state.opt_state.count,
                  losses=losses, step_ms=step_ms,
                  ms_per_micro_step=statistics.median(step_ms),
                  samples_per_s=BATCH / (statistics.median(step_ms) / 1e3),
                  peak_bytes=peak, trainable_elements=n_train,
                  launches=launches, expected_launches=want,
                  grad_norm=float(m["grad_norm"]), lr=m["lr"])
    emit(result)
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{phase}: non-finite training loss: {losses}")
    if launches != want:
        raise SystemExit(f"{phase} launches {launches} != expected {want}")

    # a profiled micro-step: device time by kernel group, idle share
    device_breakdown(torch, lambda: step(state, base_arg, batch, g),
                     phase=phase + "_profile", micro_batch=BATCH)

    # gradients of one micro-step with the kernels and with the plain versions
    if not grad_check(torch, phase, ts.make_loss_builder(cfg, tcfg), base_arg, batch,
                      ts.draw(batch, g), trainable, per_step,
                      f"{bb.num_layers} double / {bb.num_single_layers} single (full)"):
        raise SystemExit(f"{phase}_grad_check: every gradient vanishes")
    return launches


def grad_check(torch, phase, builder, base_arg, batch, draws, trainable, per_step, depth):
    """``phase``_grad_check: the gradients of one micro-step's loss
    (``builder(base_arg, batch, draws)``) with respect to ``trainable``,
    with the kernels (every attention backward also held against its plain
    version, shadowed_backwards) and with the plain versions; stops unless
    they agree within 3e-2 relative L2 and the backward calls number
    ``per_step``'s. -> the number of leaves with a nonzero plain gradient
    (none where the random stream saturates and the gradient vanishes)."""
    from unigen_tpu_torch.utils import tree_leaves, tree_map

    def grads():
        leaves = tree_map(lambda x: x.detach().requires_grad_(), trainable)
        flat = tree_leaves(leaves)
        loss, _ = builder(base_arg, batch, draws)(leaves)
        out = torch.autograd.grad(loss, flat, allow_unused=True)
        return float(loss.detach()), [torch.zeros_like(t) if x is None else x
                                      for t, x in zip(flat, out)]
    t0 = time.time()
    checks = {}
    with shadowed_backwards(torch, checks):
        loss_k, grad_k = grads()
    with plain_kernels():
        loss_p, grad_p = grads()
    path_check = {name: dict(calls=len(c), disagree=sum(not r["ok"] for r in c),
                             max_err_over_max=max(r["max_err_over_max"] for r in c),
                             max_rel_l2=max(r["rel_l2"] for r in c),
                             path_do_max=[min(r["do_max"] for r in c),
                                          max(r["do_max"] for r in c)],
                             zero_do_calls=sum(r["do_max"] == 0 for r in c))
                  for name, c in checks.items()}
    want_calls = {"flash_attention_rope_bwd": per_step.get(BWD_NAMES[0], 0),
                  "flash_attention_bwd": per_step.get(NOROPE_BWD_NAMES[0], 0)}
    num = sum((a.float() - b.float()).square().sum() for a, b in zip(grad_k, grad_p))
    den = sum(b.float().square().sum() for b in grad_p)
    rel = (num / den).sqrt().item() if den > 0 else None
    cos = [torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                                 dim=0).item()
           for a, b in zip(grad_k, grad_p) if b.float().norm() > 0]
    emit(dict(phase=phase + "_grad_check", depth=depth,
              loss_kernels=loss_k, loss_plain=loss_p, rel_l2=rel, leaves=len(grad_p),
              nonzero_leaves=len(cos), worst_leaf_cosine=min(cos) if cos else None,
              seconds=time.time() - t0,
              backward_path_check=path_check,
              note="the MoE gather's backward is a scatter-add with atomics: "
                   "its bits change from run to run"))
    if cos and not (rel is not None and rel <= 3e-2):
        raise SystemExit(f"{phase}: kernel gradients differ from plain: rel L2 {rel}")
    if any(c["disagree"] for c in path_check.values()) or \
            {n: c["calls"] for n, c in path_check.items()} != nonzero(want_calls):
        raise SystemExit(f"{phase}: a backward kernel disagrees with its plain version "
                         f"on the path, or calls != {want_calls}: {path_check}")
    return len(cos)


def phase_train_blocks(torch, dev, seed):
    """Phase 5's step with the reference's shipped control values
    (shipped_control(flux_full)): the W4A8 serving tree built from ``seed``
    (the block experts stay bf16 and train, 12 FLUX single blocks), every
    trainable control attention rope-free."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.io.from_jax import init_quantized_serving_params
    from unigen_tpu_torch.utils import param_bytes
    cfg = shipped_control(presets.flux_full())
    t0 = time.time()
    params = init_quantized_serving_params(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    print(f"# train_blocks: W4A8 tree with block experts built in "
          f"{time.time() - t0:.1f}s, resident {param_bytes(params) / 2**30:.3f} GiB",
          flush=True)
    return phase_train(torch, dev, cfg, params, seed, FLUX_FULL_BLOCKS_TRAINABLE,
                       phase="train_blocks")


def phase_trainer(torch, dev, params, seed):
    """Trainer.step at full width with stub encoders that give fp32 latents
    (a seeded 8x8 average pool and 3 -> 16 channel projection of the pixels)
    and fp32 text embeddings (seeded Gaussians)."""
    import numpy as np
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.ops.quant import split_trainable
    from unigen_tpu_torch.train.loop import Trainer
    from unigen_tpu_torch.utils import tree_leaves

    cfg = presets.flux_full()
    bb = cfg.flux
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    proj = torch.randn(3, bb.in_channels // 4, generator=g, device=dev)

    def encode_text(prompts):
        n = len(prompts)
        return {"prompt_embeds": torch.randn(n, SEQ_TXT, bb.joint_attention_dim,
                                             generator=g, device=dev),
                "pooled": torch.randn(n, bb.pooled_projection_dim, generator=g,
                                      device=dev)}

    def encode_images(pixels):
        x = torch.nn.functional.avg_pool2d(torch.as_tensor(pixels, device=dev), 8)
        return torch.einsum("bchw,cd->bdhw", x, proj)

    trainable, frozen = split_trainable(params["control"])
    trainer = Trainer(cfg, TrainConfig(train_batch_size=BATCH, remat="full",
                                       gradient_accumulation_steps=TRAIN_ACCUM,
                                       seed=seed),
                      base_params={"base": params["base"], "control_frozen": frozen},
                      control_params=trainable, encode_text=encode_text,
                      encode_images=encode_images, device=dev)
    host = np.random.default_rng(seed)
    px = 16 * HW                      # 512^2 pixels

    def batch():
        return {"descriptions": ["a photo"] * BATCH, "task_names": ["canny"] * BATCH,
                "pixel_values": host.uniform(-1, 1, (BATCH, 3, px, px)).astype(np.float32),
                "condition_pixels": host.uniform(-1, 1, (BATCH, 3, px, px)).astype(np.float32)}
    t0 = time.time()
    m = trainer.step(batch())                              # warm-up step
    print(f"# trainer: warm-up step {time.time() - t0:.2f}s, "
          f"loss {float(m['step_loss']):.5g}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(TRAINER_STEPS):
        t0 = time.perf_counter()
        m = trainer.step(batch())
        losses.append(float(m["step_loss"]))              # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = nonzero(launch_counts())
    want = {k: n * TRAINER_STEPS
            for k, n in nonzero(expected_train_launches(params, cfg, BATCH,
                                                        fp32=True)).items()}
    dtypes = sorted({str(t.dtype) for t in tree_leaves(trainer.state.control)})
    emit(dict(phase="trainer", steps=TRAINER_STEPS, micro_batch=BATCH,
              accumulation=TRAIN_ACCUM, trainable_dtypes=dtypes,
              input_dtype=str(trainer.prepare_batch(batch())["latents"].dtype),
              losses=losses,
              step_ms=step_ms, peak_bytes=torch.cuda.max_memory_allocated(),
              global_step=trainer.global_step,
              optimizer_updates=trainer.state.opt_state.count,
              launches=launches, expected_launches=want))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite Trainer loss: {losses}")
    if launches != want or dtypes != ["torch.float32"]:
        raise SystemExit(f"Trainer launches {launches} != expected {want}, "
                         f"trainable dtypes {dtypes}")


# ---------------------------------------------------------------- training run

def with_rts(cfg):
    """``cfg`` with the reference's training gate: random token selection
    (UniGenUtils.py:17-66, ``use_rts=True``)."""
    import dataclasses
    return dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, moe=dataclasses.replace(cfg.control.moe, use_rts=True)))


def lora_adapter(torch, params, rank, name, gen, dev, targets=None):
    """A rank-``rank`` adapter drawn at the fp shapes of the targeted
    linears of a (quantized) tree: ``init_lora_adapters`` on a meta tree of
    their unpacked [in, out] shapes, as the JAX tests draw factors on the fp
    tree and train them over its quantized copy."""
    from unigen_tpu_torch.models.lora import DEFAULT_LORA_TARGETS, init_lora_adapters

    def shapes(node):
        if not isinstance(node, dict):
            return node
        if "w_q4" in node or "w_q" in node:
            q = node.get("w_q", node.get("w_q4"))
            lead, (i, o) = tuple(q.shape[:-2]), tuple(q.shape[-2:])
            return {"w": torch.empty(lead + ((i * 2 if "w_q4" in node else i), o),
                                     device="meta")}
        return {k: shapes(v) for k, v in node.items()}
    return init_lora_adapters(shapes(params), targets or DEFAULT_LORA_TARGETS, rank, [name],
                              gen=gen, device=dev)[name]


def cut_lora(lora, cfg):
    """``lora``'s factors cut to the control stacks of ``cfg``'s depth (the
    first blocks, as flux_reduced cuts the tree)."""
    per = cfg.control.single_control_dev
    n = {"double_blocks": cfg.flux.num_layers // per, "add_double": cfg.flux.num_layers // per,
         "single_blocks": cfg.flux.num_single_layers // per,
         "add_single": cfg.flux.num_single_layers // per}
    return {path: {k: v[:n[path.split(".")[1]]] if path.split(".")[1] in n else v
                   for k, v in ab.items()} for path, ab in lora.items()}


def lora_folded_layout(params, lora):
    """The layout of ``fold_for_training(params, lora)`` without its values:
    each targeted linear a floating ``w`` (for the launch formulas, which
    read only leaf names)."""
    from unigen_tpu_torch.models.lora import tree_get, tree_set
    out = params
    for path in lora:
        node = tree_get(out, path)
        out = tree_set(out, path, {"w": None, **({"b": node["b"]} if "b" in node else {})})
    return out


def fill_like(torch, shapes, dev, gen):
    """A random serving subtree in the layout of the meta tree ``shapes``,
    filled as ``init_quantized_serving_params`` fills its leaves."""
    def fill(name, meta):
        out = torch.empty(meta.shape, dtype=meta.dtype, device=dev)
        if not meta.dtype.is_floating_point:
            return out.random_(-127, 128, generator=gen)
        if name == "w_scale":
            return out.uniform_(1e-4, 1e-3, generator=gen)
        return out.normal_(0.0, 0.02, generator=gen)
    return {k: fill_like(torch, v, dev, gen) if isinstance(v, dict) else fill(k, v)
            for k, v in shapes.items()}


def stub_trainer_encoders(torch, dev, bb, seed, dtype):
    """Text and image stand-ins for a Trainer at full width, functions of
    their inputs alone (two Trainers fed the same batches get the same
    encodings): Gaussian text embeddings drawn from ``seed`` and each
    prompt's CRC, and latents from an 8x8 average pool and a seeded 3 -> C
    channel projection of the pixels, in ``dtype``."""
    import zlib
    proj = torch.randn(3, bb.in_channels // 4, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))

    def encode_text(prompts):
        embeds, pooled = [], []
        for p in prompts:
            g = torch.Generator(device=dev).manual_seed(seed * 2**32 + zlib.crc32(p.encode()))
            embeds.append(torch.randn(SEQ_TXT, bb.joint_attention_dim, generator=g, device=dev))
            pooled.append(torch.randn(bb.pooled_projection_dim, generator=g, device=dev))
        return {"prompt_embeds": torch.stack(embeds).to(dtype),
                "pooled": torch.stack(pooled).to(dtype)}

    def encode_images(pixels):
        x = torch.nn.functional.avg_pool2d(torch.as_tensor(pixels, device=dev), 8)
        return torch.einsum("bchw,cd->bdhw", x, proj).to(dtype)
    return encode_text, encode_images


def trainer_batches(seed, n):
    """``n`` Trainer batches of BATCH 512^2 images drawn from ``seed``."""
    import numpy as np
    host = np.random.default_rng(seed)
    px = 16 * HW
    return [{"descriptions": ["a photo"] * BATCH, "task_names": ["canny"] * BATCH,
             "pixel_values": host.uniform(-1, 1, (BATCH, 3, px, px)).astype(np.float32),
             "condition_pixels": host.uniform(-1, 1, (BATCH, 3, px, px)).astype(np.float32)}
            for _ in range(n)]


def train_path_check(torch, phase, run, want):
    """``phase``_path_check: every kernel call of ``run()`` (a training
    micro-step: forward, recompute and backward) also through its plain
    version (shadowed_kernels, shadowed_backwards); stops if one disagrees
    or the calls differ from the formula ``want``."""
    checks = {}
    with shadowed_kernels(torch, checks), shadowed_backwards(torch, checks):
        run()
    fwd = path_check_summary({k: v for k, v in checks.items() if not k.endswith("_bwd")})
    bwd = {k: dict(calls=len(v), disagree=sum(not r["ok"] for r in v),
                   max_rel_l2=max(r["rel_l2"] for r in v))
           for k, v in checks.items() if k.endswith("_bwd")}
    calls = {n: c["calls"] for n, c in {**fwd, **bwd}.items()}
    expected = nonzero({
        "flash_attention_rope": want.get("flash_attention_rope", 0),
        "flash_attention": want.get("flash_attention", 0),
        "w4a8_matmul": want.get("w4a8_matmul", 0), "quantize_act": want.get("quantize_act", 0),
        "flash_attention_rope_bwd": want.get(BWD_NAMES[0], 0),
        "flash_attention_bwd": want.get(NOROPE_BWD_NAMES[0], 0)})
    emit(dict(phase=phase + "_path_check", **fwd, **bwd, expected_calls=expected))
    if any(c["disagree"] for c in {**fwd, **bwd}.values()) or calls != expected:
        raise SystemExit(f"{phase}_path_check: {calls} (expected {expected}) or a kernel "
                         f"disagrees with its plain version")


def timed_steps(torch, step, n):
    """``n`` calls of ``step()`` (each returns metrics) from launch counts 0
    and a reset peak: (losses, ms per call, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step()["step_loss"]))            # synchronises
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, nonzero(launch_counts()), torch.cuda.max_memory_allocated()


def phase_train_lora(torch, dev, params, vae_cfg, vae_params, seed):
    """6b. LoRA fine-tuning over phase 4's frozen W4A8 tree at full width
    and depth with the reference's gate (random token selection): rank
    LORA_RANK on DEFAULT_LORA_TARGETS, TRAIN_LORA_STEPS micro-steps through
    Trainer with a work_dir and a save at step TRAIN_LORA_SAVE; a second
    Trainer resumes from it (its state equal to the saved one bit for bit)
    and takes the same steps; launches equal the formula of the folded tree
    (the targeted linears leave W4A8 for plain products); the gradient
    check against the plain kernels; the exported adapter read back bit
    for bit; then the adapter served: loaded from its files into a
    pipeline on the W4A8 tree, every re-quantized leaf equal to
    fold_linear_node's, two requests, and every kernel call of a forward
    against its plain version. -> launches of the timed micro-steps."""
    import shutil

    from unigen_tpu_torch import presets
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.io.torch_bridge import load_lora_adapters
    from unigen_tpu_torch.models.lora import fold_linear_node, tree_get
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
    from unigen_tpu_torch.train import train_step as ts
    from unigen_tpu_torch.train.loop import Trainer
    from unigen_tpu_torch.utils import tree_leaves_with_path

    cfg = with_rts(presets.flux_full())
    bb = cfg.flux
    name = "canny"
    work = CHECKPOINTS.parent / "train_lora"
    shutil.rmtree(work, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    lora = lora_adapter(torch, params, LORA_RANK, name, gen, dev)
    tcfg = TrainConfig(train_batch_size=BATCH, remat="full", lora_rank=LORA_RANK,
                       lora_adapter_name=name, max_train_steps=TRAIN_LORA_STEPS,
                       checkpointing_steps=TRAIN_LORA_SAVE, lr_scheduler="constant",
                       learning_rate=1e-4, seed=seed)
    text, images = stub_trainer_encoders(torch, dev, bb, seed + 2, torch.bfloat16)
    base_arg = {"base": params["base"], "control_frozen": params["control"]}

    def trainer():
        return Trainer(cfg, tcfg, base_params=base_arg, control_params=lora,
                       encode_text=text, encode_images=images, work_dir=str(work),
                       device=dev)
    batches = trainer_batches(seed + 3, TRAIN_LORA_STEPS)
    first = trainer()
    t0 = time.time()
    first.step(batches[0])                                  # warm-up, not saved
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    first = trainer()
    head = batches[:TRAIN_LORA_SAVE]
    losses1, ms1, launches1, peak1 = timed_steps(
        torch, lambda: first.step(head.pop(0)), TRAIN_LORA_SAVE)
    t0 = time.time()
    first.save()
    torch.cuda.synchronize()
    save_s = time.time() - t0
    step_dir = work / f"step_{TRAIN_LORA_SAVE:08d}"
    ckpt_bytes = sum(f.stat().st_size for f in step_dir.iterdir())
    saved = (first.state, first._generator.get_state())
    snapshot = work.parent / "train_lora_resume"
    shutil.rmtree(snapshot, ignore_errors=True)
    shutil.copytree(work, snapshot)
    tail = batches[TRAIN_LORA_SAVE:]
    losses2, ms2, launches2, peak2 = timed_steps(
        torch, lambda: first.step(tail.pop(0)), TRAIN_LORA_STEPS - TRAIN_LORA_SAVE)
    first.save()
    launches = add_counts((1, launches1), (1, launches2))

    second = Trainer(cfg, tcfg, base_params=base_arg, control_params=lora,
                     encode_text=text, encode_images=images, work_dir=str(snapshot),
                     device=dev)
    t0 = time.time()
    resumed = second.maybe_resume()
    torch.cuda.synchronize()
    resume_s = time.time() - t0
    state, gstate = saved
    same = (resumed and second.global_step == TRAIN_LORA_SAVE
            and not trees_equal(torch, second.state.control, state.control)[1]
            and not trees_equal(torch, second.state.opt_state.mu, state.opt_state.mu)[1]
            and not trees_equal(torch, second.state.opt_state.nu, state.opt_state.nu)[1]
            and second.state.opt_state.count == state.opt_state.count
            and torch.equal(second._generator.get_state(), gstate))
    resumed_losses = [float(second.step(b)["step_loss"])
                      for b in batches[TRAIN_LORA_SAVE:]]
    folded = lora_folded_layout(params, lora)
    per_step = nonzero(expected_train_launches(folded, cfg, BATCH, lora=True))
    want = {k: n * TRAIN_LORA_STEPS for k, n in per_step.items()}
    whole_w4 = expected_train_launches(params, cfg, BATCH)["w4a8_matmul"]
    emit(dict(phase="train_lora", depth=f"{bb.num_layers} double / "
              f"{bb.num_single_layers} single (full)", rank=LORA_RANK, adapter=name,
              targets=len(lora), factor_elements=sum(t.numel() for ab in lora.values()
                                                     for t in ab.values()),
              gate="top-1, random token selection", micro_batch=BATCH,
              warm_up_s=warm_s, step_ms=ms1 + ms2,
              ms_per_micro_step=statistics.median(ms1 + ms2),
              losses=losses1 + losses2, resumed_losses=resumed_losses,
              peak_bytes=max(peak1, peak2), checkpoint_bytes=ckpt_bytes, save_s=save_s,
              resume_s=resume_s, resumed_state_equal=bool(same),
              launches=launches, expected_launches=want,
              w4a8_per_step_whole_tree=whole_w4))
    if not all(math.isfinite(x) for x in losses1 + losses2 + resumed_losses):
        raise SystemExit("train_lora: non-finite loss")
    if launches != want or not same:
        raise SystemExit(f"train_lora: launches {launches} != expected {want}, or the "
                         f"resumed state differs from the saved one ({same})")

    # one step's gradients with respect to a/b against the plain kernels:
    # at full depth the random W4A8 stream saturates and no gradient reaches
    # the control branch (recorded). The factors' gradients x^T dy see the
    # attention forward's bf16 rounding in x (the two versions round P at
    # different points) beside the backward kernels' own: read on an H100,
    # 2.4e-2 to 2.8e-2 relative L2 at 8/16, 4/8 and 2/4 blocks alike; the
    # check holds at LOAD_FLUX_DEPTH
    batch = first.prepare_batch(batches[0])
    draws = ts.draw(batch, torch.Generator(device=dev).manual_seed(seed + 5),
                    rts_shape=ts.rts_draw_shape(cfg, batch["latents"].shape))
    for depth in ((bb.num_layers, bb.num_single_layers), LOAD_FLUX_DEPTH):
        c, t = flux_reduced(torch, cfg, params, depth)
        factors = cut_lora(first.state.control, c)
        if grad_check(torch, "train_lora", ts.make_loss_builder(c, tcfg),
                      {"base": t["base"], "control_frozen": t["control"]}, batch, draws,
                      factors, nonzero(expected_train_launches(
                          lora_folded_layout(t, factors), c, BATCH, lora=True)),
                      f"{depth[0]} double / {depth[1]} single"):
            break
    else:
        raise SystemExit("train_lora_grad_check: the gradients vanish at every depth")

    # the exported adapter, read back
    export = work / "lora_adapters"
    back = load_lora_adapters(str(export), params, device=dev)[name]
    differ = sorted(set(back) ^ set(first.state.control)) + [
        p for p in back if p in first.state.control and not all(
            torch.equal(back[p][k], first.state.control[p][k]) for k in ("a", "b"))]
    emit(dict(phase="train_lora_export", path=str(export / name), stacks=len(back),
              bytes=(export / name / "pytorch_lora_weights.safetensors").stat().st_size,
              same_bits=not differ))
    if differ:
        raise SystemExit(f"train_lora: the exported adapter reads back different at {differ}")
    trained = dict(first.state.control)
    del first, second, saved, state
    torch.cuda.empty_cache()

    # served: the adapter from its files, folded into the W4A8 tree
    pipe = UniGenFluxPipeline(cfg=presets.flux_full(), params=params, vae_cfg=vae_cfg,
                              vae_params=vae_params, dtype=torch.bfloat16, device=dev)
    t0 = time.time()
    pipe.load_lora(str(export))
    pipe.set_condition_adapter(name)
    torch.cuda.synchronize()
    switch_s = time.time() - t0
    bad, leaves = [], 0
    for path, ab in trained.items():
        want_node = fold_linear_node(tree_get(params, path), ab, jit=True)
        got = tree_get(pipe.params, path)
        for k, v in want_node.items():
            leaves += 1
            if not torch.equal(got[k], v):
                bad.append(f"{path}.{k}")
    codes = sorted({p[-1] for path in trained
                    for p, _ in tree_leaves_with_path(tree_get(pipe.params, path))})
    host = torch.Generator().manual_seed(seed + 7)
    reqs = [dict(prompt_embeds=torch.randn(1, SEQ_TXT, bb.joint_attention_dim, generator=host),
                 pooled=torch.randn(1, bb.pooled_projection_dim, generator=host),
                 cond_pooled=torch.randn(1, bb.pooled_projection_dim, generator=host),
                 control_pixels=torch.rand(1, 3, PIPE_RES, PIPE_RES, generator=host) * 2 - 1)
            for _ in range(2)]
    kw = dict(height=PIPE_RES, width=PIPE_RES, num_inference_steps=STEPS)
    pipe.generate(**reqs[0], **kw)                           # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [pipe.generate(**r, **kw) for r in reqs]
    wall = time.perf_counter() - t0
    served = nonzero(launch_counts())
    want_served = expected_pipeline_launches(pipe.params, pipe.cfg, [(1, STEPS, 0)] * 2)
    emit(dict(phase="train_lora_serve", switch_s=switch_s, folded_leaves=leaves,
              leaves_differ=bad[:8], folded_leaf_names=codes, requests=2, steps=STEPS,
              images_per_s=2 / wall, launches=served, expected_launches=want_served,
              out_shape=list(outs[0].shape)))
    if bad or served != want_served or any(
            o.dtype != torch.uint8 or tuple(o.shape) != (1, PIPE_RES, PIPE_RES, 3)
            for o in outs):
        raise SystemExit(f"train_lora_serve: folded leaves differ at {bad[:8]}, or launches "
                         f"{served} != {want_served}, or bad outputs")
    checks = {}
    with torch.no_grad(), shadowed_kernels(torch, checks):
        pipe.generate(**reqs[0], **dict(kw, num_inference_steps=1))
    summary = path_check_summary(checks)
    expected = {n: v for n, v in nonzero(expected_launches(pipe.params, pipe.cfg, 1)).items()
                if n in ("flash_attention_rope", "flash_attention", "w4a8_matmul",
                         "quantize_act")}
    emit(dict(phase="train_lora_path_check", **summary, expected_calls=expected))
    if any(c["disagree"] for c in summary.values()) or \
            {n: c["calls"] for n, c in summary.items()} != expected:
        raise SystemExit(f"train_lora_path_check: {summary} (expected {expected})")
    del pipe
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(snapshot, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def consis_tree(torch, params, cfg, dev, gen):
    """Phase 4's serving tree with a random consis module (block0, block1:
    FLUX double blocks under the serving policy, int8) added to its
    control branch."""
    from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
    from unigen_tpu_torch.ops.quant import quantize_unigen_serving
    shapes = quantize_unigen_serving(init_unigen_flux_params(cfg, device="meta",
                                                             dtype=torch.bfloat16))
    consis = fill_like(torch, shapes["control"]["consis"], dev, gen)
    return {"base": params["base"], "control": dict(params["control"], consis=consis)}


def phase_train_routing(torch, dev, params, seed):
    """6c. ROUTING_STEPS timed micro-steps (after a warm-up; the median
    read) of each routing variant the port took over in this slice, at
    full width, on phase 4's W4A8 tree: top-2 with the dense einsum
    dispatch, the consis module (its second call attends over 3072 keys),
    and remat "dots"; each beside the plain top-1 remat "full" step at the
    same depth (the deepest of full depth and REDUCED_DEPTHS that fits),
    with peak bytes, launches equal to the formula, and a path check of
    every kernel call of one micro-step at the shallowest depth."""
    import dataclasses

    from unigen_tpu_torch import presets
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.ops.quant import split_trainable
    from unigen_tpu_torch.train import train_step as ts

    full = presets.flux_full()
    moe = full.control.moe
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    variants = {
        "full": (full, "full", params),
        "top2_dense": (dataclasses.replace(full, control=dataclasses.replace(
            full.control, moe=dataclasses.replace(moe, top_k=2, fast_dispatch=False))),
            "full", params),
        "consis": None,
        "dots": (full, "dots", params)}
    consis_cfg = dataclasses.replace(full, control=dataclasses.replace(
        full.control, use_consis_module=True))
    variants["consis"] = (consis_cfg, "full", consis_tree(torch, params, consis_cfg, dev, gen))
    g = torch.Generator(device=dev).manual_seed(seed + 32)
    lat = 2 * HW

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()
    bb = full.flux
    batch = dict(latents=mk(BATCH, bb.in_channels // 4, lat, lat),
                 condition_latents=mk(BATCH, bb.in_channels // 4, lat, lat),
                 prompt_embeds=mk(BATCH, SEQ_TXT, bb.joint_attention_dim),
                 pooled=mk(BATCH, bb.pooled_projection_dim),
                 condition_pooled=mk(BATCH, bb.pooled_projection_dim))
    depths = [(bb.num_layers, bb.num_single_layers)] + list(REDUCED_DEPTHS)
    out = {}
    for name, (cfg, remat, tree) in variants.items():
        tcfg = TrainConfig(train_batch_size=BATCH, remat=remat, lr_scheduler="constant")
        for depth in depths:
            c, t = flux_reduced(torch, cfg, tree, depth)
            trainable, frozen = split_trainable(t["control"])
            base_arg = {"base": t["base"], "control_frozen": frozen}
            step = ts.make_train_step(c, tcfg)
            state = [ts.init_train_state(trainable, tcfg)]

            def one():
                state[0], m = step(state[0], base_arg, batch, g)
                return m
            try:
                one()                                         # warm-up
                losses, ms, launches, peak = timed_steps(torch, one, ROUTING_STEPS)
            except torch.cuda.OutOfMemoryError as e:
                del state
                torch.cuda.empty_cache()
                print(f"# train_routing {name}: {depth} does not fit ({e}); shallower",
                      flush=True)
                continue
            want = {k: n * ROUTING_STEPS for k, n in
                    nonzero(expected_train_launches(t, c, BATCH, remat=remat)).items()}
            out[name] = dict(depth=list(depth), remat=remat, top_k=c.control.moe.top_k,
                             fast_dispatch=c.control.moe.fast_dispatch,
                             consis="consis" in t["control"], step_ms=ms,
                             ms=statistics.median(ms), losses=losses,
                             peak_bytes=peak, launches=launches, expected_launches=want)
            del state
            torch.cuda.empty_cache()
            if launches != want or not all(math.isfinite(x) for x in losses):
                raise SystemExit(f"train_routing {name}: launches {launches} != {want} "
                                 f"or losses {losses}")
            break
        else:
            raise SystemExit(f"train_routing {name}: no depth fits")
        # every kernel call of one micro-step against its plain version
        c, t = flux_reduced(torch, cfg, tree, REDUCED_DEPTHS[-1])
        trainable, frozen = split_trainable(t["control"])
        base_arg = {"base": t["base"], "control_frozen": frozen}
        step = ts.make_train_step(c, tcfg)
        state = ts.init_train_state(trainable, tcfg)
        train_path_check(torch, f"train_routing_{name}",
                         lambda: step(state, base_arg, batch, g),
                         nonzero(expected_train_launches(t, c, BATCH, remat=remat)))
        del state
        torch.cuda.empty_cache()
    for name, rec in out.items():
        ref = out["full"]
        if rec["depth"] == ref["depth"]:
            rec.update(ms_over_full=rec["ms"] / ref["ms"],
                       peak_over_full=rec["peak_bytes"] / ref["peak_bytes"])
    emit(dict(phase="train_routing", micro_batch=BATCH, variants=out))
    return out


def hires_phase(torch, phase, run, forward, per_forward, steps, **extra):
    """One request at 1024^2: ``run()`` denoises it (timed, launch counts
    from 0), which must launch ``per_forward`` kernels of each name per
    step; then one ``forward()`` with every kernel call also held against
    its plain version (head-chunked), which must agree."""
    reset_launch_counts()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: n for k, n in launch_counts().items() if n}
    want = {k: n * steps for k, n in per_forward.items() if n}
    if not torch.isfinite(out.float()).all() or launches != want:
        raise SystemExit(f"{phase}: launches {launches} != expected {want} "
                         f"or non-finite output")
    checks = {}
    with torch.no_grad(), shadowed_kernels(torch, checks):
        forward()
    path_check = path_check_summary(checks)
    emit(dict(phase=phase, steps=steps, seconds=dt, ms_per_denoise_step=dt / steps * 1e3,
              launches=launches, expected_launches=want, out_shape=list(out.shape),
              path_check=path_check, **extra))
    # the rotation pass runs inside each flash_attention_rope call, which is
    # held against its plain version as a whole
    if any(c["disagree"] or not c["calls"] for c in path_check.values()) \
            or set(path_check) != set(want) - {"rope_rotate"}:
        raise SystemExit(f"{phase}: a kernel disagrees with its plain version on "
                         f"the path: {path_check}")
    return launches


def phase_flux_1024(torch, dev, params):
    """One b=1 request through the phase-4 W4A8 FLUX tree at 1024^2: 4096
    image + 512 text tokens (4608), the weave over 8192 and 8704."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models.unigen_flux import UniGenFlux
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    cfg = presets.flux_full()
    bb = cfg.flux
    model = UniGenFlux(cfg, params, device=dev)
    hw = HIRES // 16                             # 64^2 packed tokens
    g = torch.Generator(device=dev).manual_seed(3)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()
    x = dict(latents=mk(1, hw * hw, bb.in_channels), condition=mk(1, hw * hw, bb.in_channels),
             encoder=mk(1, SEQ_TXT, bb.joint_attention_dim),
             pooled=mk(1, bb.pooled_projection_dim),
             cond_pooled=mk(1, bb.pooled_projection_dim))
    img_ids = prepare_latent_image_ids(hw, hw, device=dev)
    return hires_phase(
        torch, "flux_1024", lambda: model.denoise(**x, num_steps=HIRES_STEPS),
        lambda: model(x["latents"], x["condition"], x["encoder"], x["pooled"],
                      x["cond_pooled"], torch.ones(1, dtype=model.dtype, device=dev),
                      img_ids, torch.zeros(SEQ_TXT, 3, device=dev), img_ids),
        expected_launches(params, cfg), HIRES_STEPS,
        resolution=HIRES, attention_lengths=[hw * hw + SEQ_TXT, 2 * hw * hw,
                                            2 * hw * hw + SEQ_TXT])


def sd3_requests(bb, n, res, seed):
    """``n`` b=1 requests (latents, condition latents, text embeddings)
    drawn on the host from ``seed``; the negative prompt is the pipeline's
    default, zeros."""
    import torch
    host = torch.Generator().manual_seed(seed)
    lat = res // 8

    def mk(*shape):
        return torch.randn(*shape, generator=host).numpy()
    return [dict(latents=mk(1, bb.in_channels, lat, lat),
                 condition=mk(1, bb.in_channels, lat, lat),
                 encoder=mk(1, SD3_TXT, bb.joint_attention_dim),
                 pooled=mk(1, bb.pooled_projection_dim),
                 cond_pooled=mk(1, bb.pooled_projection_dim)) for _ in range(n)]


def sd3_cfg_forward(torch, model, batch, steps):
    """One UniGen-SD3 forward of the denoise's first step on the
    CFG-doubled batch ([neg; pos] on the batch axis, zero negatives)."""
    from unigen_tpu_torch.models.unigen_sd3 import SD3_SCHEDULER
    from unigen_tpu_torch.pipelines import scheduling
    dev, dt = model.device, model.dtype
    x = {k: torch.as_tensor(v).to(dev, dt) for k, v in batch.items()}

    def two(t):
        return torch.cat([t, t])
    _, ts = scheduling.inference_sigmas(SD3_SCHEDULER, steps)
    args = (two(x["latents"]), two(x["condition"]),
            torch.cat([torch.zeros_like(x["encoder"]), x["encoder"]]),
            torch.cat([torch.zeros_like(x["pooled"]), x["pooled"]]),
            two(x["cond_pooled"]),
            torch.full((2 * x["latents"].shape[0],), float(ts[0]), dtype=dt, device=dev))
    return lambda: model(*args)[0]


def phase_sd3(torch, dev, seed):
    """BASELINE config #2 (presets.baseline_configs()["sd3_depth_28step"]):
    the full-width bf16 UniGen-SD3.5-medium tree from ``seed``, four b=1
    requests through MicroBatchServer(batch_size=2), 28 Euler steps with
    guidance 7.0 at 512^2."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.io.from_jax import init_sd3_serving_params
    from unigen_tpu_torch.models.unigen_sd3 import UniGenSD3
    from unigen_tpu_torch.serving import MicroBatchServer
    from unigen_tpu_torch.utils import param_bytes
    run = presets.baseline_configs()["sd3_depth_28step"]
    cfg, steps, guidance, res = run["cfg"], run["steps"], run["guidance"], run["resolution"]
    bb = cfg.sd3
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_sd3_serving_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    resident, init_peak = param_bytes(params), torch.cuda.max_memory_allocated()
    model = UniGenSD3(cfg, params, device=dev)
    print(f"# sd3: sd35_medium bf16 tree built in {time.time() - t0:.1f}s, "
          f"resident {resident / 2**30:.3f} GiB", flush=True)

    reqs = sd3_requests(bb, N_REQUESTS, res, seed + 2)
    warm = {k: torch.cat([torch.as_tensor(r[k]) for r in reqs[:BATCH]]) for k in reqs[0]}
    t0 = time.time()
    model.denoise(**warm, num_steps=1, guidance_scale=guidance)
    torch.cuda.synchronize()
    print(f"# sd3: warm-up step {time.time() - t0:.2f}s", flush=True)

    srv = MicroBatchServer(lambda x: model.denoise(**x, num_steps=steps,
                                                   guidance_scale=guidance),
                           batch_size=BATCH, max_wait_ms=50)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        t0 = time.time()
        futs = [srv.submit(**r) for r in reqs]
        outs = [f.result(timeout=900) for f in futs]
        dt = time.time() - t0
    finally:
        srv.close()
    launches = {k: n for k, n in launch_counts().items() if n}
    peak = torch.cuda.max_memory_allocated()
    per_fwd = expected_sd3_launches(cfg, 2 * BATCH)
    forwards = srv.stats.batches * steps
    want = {"flash_attention": per_fwd * forwards}
    lat = res // 8
    for o in outs:
        if tuple(o.shape) != (1, bb.out_channels, lat, lat) or not torch.isfinite(o).all():
            raise SystemExit(f"bad sd3 denoise output: {tuple(o.shape)}")
    if srv.stats.batches != N_REQUESTS // BATCH or launches != want:
        raise SystemExit(f"sd3 launches {launches} != expected {want} "
                         f"({srv.stats.batches} batches)")

    # one forward with each kernel call held against its plain version,
    # then one with the plain versions, on the same CFG-doubled inputs
    fwd = sd3_cfg_forward(torch, model, warm, steps)
    checks = {}
    with torch.no_grad():
        before = launch_counts()
        with shadowed_kernels(torch, checks):
            pred_k = fwd().float()
        mid = launch_counts()
        with plain_kernels():
            pred_p = fwd().float()
        after = launch_counts()
    if mid != dict(before, flash_attention=before["flash_attention"] + per_fwd) \
            or after != mid:
        raise SystemExit(f"sd3 kernel/plain forwards launched {before} -> {mid} -> {after}")
    rel = ((pred_k - pred_p).norm() / pred_p.norm()).item()
    path_check = path_check_summary(checks)
    emit(dict(phase="sd3_path_check", **path_check, kernel_vs_plain_rel_l2=rel,
              values_differ=int((pred_k != pred_p).sum()), values=pred_p.numel()))
    if any(c["disagree"] or not c["calls"] for c in path_check.values()) \
            or set(path_check) != {"flash_attention"} or not rel <= 3e-2:
        raise SystemExit(f"sd3: a kernel disagrees with its plain version: "
                         f"{path_check}, forward rel L2 {rel}")

    with torch.no_grad():
        device_breakdown(torch, fwd, phase="sd3_profile", forward_batch=2 * BATCH)
    st = srv.stats
    emit(dict(phase="sd3", config="sd3_depth_28step", requests=N_REQUESTS,
              steps=steps, guidance=guidance, resolution=res, seconds=dt,
              images_per_s=N_REQUESTS / dt, ms_per_denoise_step=dt / forwards * 1e3,
              server=dict(batches=st.batches, requests=st.requests, samples=st.samples,
                          padded_samples=st.padded_samples,
                          wasted_pad_fraction=st.wasted_pad_fraction),
              attention_launches_per_forward=per_fwd, launches=launches,
              expected_launches=want, peak_bytes=peak, init_peak_bytes=init_peak,
              resident_bytes=resident, out_shape=list(outs[0].shape)))
    return model, launches


def phase_sd3_1024(torch, model, seed):
    """One b=1 request of the same SD3 model at 1024^2 (4096 image tokens:
    attention over 4429, 4096, 8192 and 8525 keys), 4 steps."""
    from unigen_tpu_torch import presets
    cfg = model.cfg
    guidance = presets.baseline_configs()["sd3_depth_28step"]["guidance"]
    req = sd3_requests(cfg.sd3, 1, HIRES, seed + 3)[0]
    return hires_phase(
        torch, "sd3_1024", lambda: model.denoise(**req, num_steps=HIRES_STEPS,
                                                 guidance_scale=guidance),
        sd3_cfg_forward(torch, model, req, HIRES_STEPS),
        {"flash_attention": expected_sd3_launches(cfg, 2)}, HIRES_STEPS,
        resolution=HIRES, guidance=guidance)


# ------------------------------------------------------------ the StepServer

def forward_log(srv):
    """Wrap the server's family forward: each call appends (rows, "full" or
    "replay") to the returned list. The wrapper reaches the server through a
    weak reference: a bound method stored on the server would make a
    reference cycle that holds a closed server until the collector runs."""
    import weakref
    calls, real, server = [], type(srv)._fwd, weakref.ref(srv)

    def logged(lat, *a, **kw):
        calls.append((lat.shape[0], "replay" if "control_residuals" in kw else "full"))
        return real(server(), lat, *a, **kw)
    srv._fwd = logged
    return calls


def decode_log(srv):
    """Wrap the server's VAE decode: the final latents it is handed, in
    retirement order (the order in which the requests' futures resolve)."""
    rows, real = [], srv._decode

    def logged(lat):
        rows.append(lat)
        return real(lat)
    srv._decode = logged
    return rows


def flux_forward_launches(params, cfg, calls):
    """Launches of the FLUX forwards a server dispatched: a full forward
    expected_launches (any rows: per-sample routing, rope control), a
    replaying one expected_replay_launches."""
    out = {}
    for rows, kind in calls:
        per = (expected_replay_launches(params, cfg) if kind == "replay"
               else expected_launches(params, cfg, rows))
        for k, n in per.items():
            out[k] = out.get(k, 0) + n
    return nonzero(out)


def expected_sd3_replay_launches(cfg) -> int:
    """Rope-free attention calls of a UniGen-SD3 forward that replays cached
    control outputs: the base joint blocks and attn2 of the dual ones (no
    MoE preprocess, no control block)."""
    bb = cfg.sd3
    return bb.num_layers + sum(i in set(bb.dual_attention_layers)
                               for i in range(bb.num_layers))


def sd3_forward_launches(cfg, calls):
    """Launches of the SD3 forwards a server dispatched (each runs 2m rows:
    the CFG pair of m slots)."""
    n = sum(expected_sd3_replay_launches(cfg) if kind == "replay"
            else expected_sd3_launches(cfg, 2 * rows) for rows, kind in calls)
    return {"flash_attention": n} if n else {}


def stepserve_requests(torch, dev, bb, vae_cfg, n, res, seed, t_len, latent_shape):
    """``n`` b=1 requests made on the device from ``seed``: text rows, pooled
    rows, control pixels in [-1, 1] and initial noise of ``latent_shape``."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    return [dict(prompt_embeds=mk(1, t_len, bb.joint_attention_dim),
                 pooled=mk(1, bb.pooled_projection_dim),
                 cond_pooled=mk(1, bb.pooled_projection_dim),
                 control_pixels=torch.rand(1, 3, res, res, generator=g, device=dev) * 2 - 1,
                 latents=mk(1, *latent_shape)) for _ in range(n)]


def busy_ms(torch, prof):
    """Summed device time of the CUDA events of a profiler window, read from
    the raw trace (building the profiler's Python event objects for a
    window of ~10^5 kernels takes longer than the window itself)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6


def serve_requests(torch, srv, reqs, keys, order, latency):
    """Feed ``reqs`` by one blocking submit (wait=True) from a thread each;
    ``order`` gets each request's key as its future resolves, ``latency``
    its submit-to-image ms. -> the futures, by key."""
    futs = {}

    def feed(key, req):
        t0 = time.perf_counter()
        fut = srv.submit(**req, wait=True)

        def done(_, key=key, t0=t0):
            latency[key] = (time.perf_counter() - t0) * 1e3
            order.append(key)
        fut.add_done_callback(done)
        futs[key] = fut
    threads = [threading.Thread(target=feed, args=(k, r)) for k, r in zip(keys, reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
        if t.is_alive():
            raise SystemExit("stepserve: a blocking submit never admitted")
    return futs


def drive_server(torch, dev, srv, reqs, n_sustained, phase, launch_formula, **extra):
    """One mode of a StepServer: a cold and a warm single request, then
    ``n_sustained`` requests fed by blocking submits from threads, the
    sustained window traced by the profiler (CUDA activity only) for the
    device's idle share. Checks the launch counts against ``launch_formula``
    of the forwards the window dispatched. -> the line."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from unigen_tpu_torch.utils import tree_leaves
    calls, order, latency = forward_log(srv), [], {}
    out = {}
    try:
        single = []
        for k in (0, 1):
            t0 = time.perf_counter()
            out[k] = srv.submit(**reqs[k]).result(timeout=900)
            single.append((time.perf_counter() - t0) * 1e3)
        before = srv.stats()
        calls.clear()
        reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        keys = list(range(2, 2 + n_sustained))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            futs = serve_requests(torch, srv, [reqs[k] for k in keys], keys, order,
                                  latency)
            for k in keys:
                out[k] = futs[k].result(timeout=900)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
        launches = nonzero(launch_counts())
        peak = torch.cuda.max_memory_allocated()
        after = srv.stats()
        res_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(srv._res))
    finally:
        srv.close()
    busy = busy_ms(torch, prof)
    delta = {k: after[k] - before[k] for k in ("ticks", "ticks_replay", "ticks_fused",
                                               "rows_full", "rows_base", "rows_refresh",
                                               "rows_pad", "active_row_steps", "failed",
                                               "retired")}
    lat = np.asarray([latency[k] for k in keys])
    want = launch_formula(calls)
    forwards = {}
    for r, kind in calls:
        forwards[f"{kind}_{r}"] = forwards.get(f"{kind}_{r}", 0) + 1
    line = dict(phase=phase, **extra, slots=srv.B, requests_sustained=n_sustained,
                cold_ms=single[0], warm_ms=single[1], wall_ms=wall * 1e3,
                images_per_s=n_sustained / wall,
                latency_ms=dict(p50=float(np.percentile(lat, 50)),
                                p95=float(np.percentile(lat, 95)), max=float(lat.max())),
                mean_occupancy=delta["active_row_steps"] / (delta["ticks"] * srv.B),
                **delta, device_busy_ms=busy, device_idle_share=1 - busy / (wall * 1e3),
                peak_bytes=peak, residual_cache_bytes=res_bytes,
                forwards=forwards, launches=launches, expected_launches=want)
    emit(line)
    if launches != want or launches.get("w4a8_general") or delta["failed"] \
            or delta["retired"] != n_sustained:
        raise SystemExit(f"{phase} {extra}: launches {launches} != expected {want}, "
                         f"or a request failed ({delta})")
    shape = (1, srv.height, srv.width, 3)
    if sorted(order) != keys or any(img.dtype != torch.uint8 or tuple(img.shape) != shape
                                    for img in out.values()):
        raise SystemExit(f"{phase}: {len(order)} of {n_sustained} requests resolved, "
                         f"or an image is not uint8 {shape}")
    return line


def serve_staggered(srv, pair):
    """Two requests one tick apart: the second is submitted from inside the
    first tick's forward (on the worker's thread, outside its lock), so it
    is admitted at the next tick boundary and the two slots run at
    different steps. -> the two futures (the second is set before the
    first resolves)."""
    futs, real = [None, None], srv._fwd

    def first(*a, **kw):
        unwrap(srv, "_fwd")
        futs[1] = srv.submit(**pair[1])
        return real(*a, **kw)
    wrap(srv, "_fwd", first)
    futs[0] = srv.submit(**pair[0])
    return futs


def wrap(obj, name, fn):
    """Set ``obj.name`` to ``fn``, keeping what it shadows for ``unwrap``."""
    obj.__dict__.setdefault("_wrapped", []).append((name, obj.__dict__.get(name)))
    setattr(obj, name, fn)


def unwrap(obj, name):
    """Undo the last ``wrap`` of ``name``: the instance attribute it replaced,
    or none, so that the class's method shows again (storing a bound method
    on its own instance would be a reference cycle)."""
    stack = obj.__dict__["_wrapped"]
    i = max(k for k, (n, _) in enumerate(stack) if n == name)
    _, saved = stack.pop(i)
    if saved is None:
        delattr(obj, name)
    else:
        setattr(obj, name, saved)


def admit_together(srv, reqs):
    """Submit ``reqs`` so that all of them are admitted at one tick
    boundary: the worker's first admission waits on its condition (which
    lets the submits take the lock) until every request holds a slot.
    -> their futures."""
    def gathered():
        unwrap(srv, "_apply_admissions")
        srv._work.wait_for(lambda: sum(s.payload is not None for s in srv._slots)
                           == len(reqs), timeout=900)
        srv._apply_admissions()
    wrap(srv, "_apply_admissions", gathered)
    return [srv.submit(**r) for r in reqs]


def serve_at_reference_shapes(srv, reqs, knobs):
    """Serve ``reqs`` (an even number, at most the slots) so that each
    forward runs at the shapes of the one-shot reference: under multi_tick
    all admitted at one tick (full occupancy, one fused window), else in
    pairs one tick apart (two live slots at different steps; the gathered
    forwards then run one row each). -> {index: (final latents, image)},
    the forwards (rows, kind), the stats, how they were admitted."""
    calls, rows = forward_log(srv), decode_log(srv)
    if knobs.get("multi_tick", 1) > 1:
        admission = f"all {len(reqs)} at one tick"
        imgs = [f.result(timeout=900) for f in admit_together(srv, reqs)]
    else:
        admission = "pairs one tick apart"
        imgs = []
        for i in range(0, len(reqs), 2):
            futs = serve_staggered(srv, reqs[i:i + 2])
            imgs.append(futs[0].result(timeout=900))
            imgs.append(futs[1].result(timeout=900))
    return dict(enumerate(zip(rows, imgs))), calls, srv.stats(), admission


def at_reference_shapes(srv, knobs, calls, stats):
    """Whether serve_at_reference_shapes ran at its reference's shapes: the
    exact modes every forward over all slots (against the pipeline at b =
    slots; multi_tick in a fused window), the cache modes every gathered
    forward over one row (against the pipeline at b=1)."""
    exact = not pipeline_knobs(knobs)
    sizes = {m for m, _ in calls}
    return (sizes == ({srv.B} if exact else {1})
            and (knobs.get("multi_tick", 1) == 1 or stats["ticks_fused"] > 0))


def flux_reduced(torch, cfg, params, depth):
    """The flux_full config and a view of its tree cut to ``depth`` = (double,
    single) base blocks and half as many control blocks (the first blocks of
    each stack, no copy)."""
    import dataclasses

    from unigen_tpu_torch.utils import tree_map
    dbl, sgl = depth
    per = cfg.control.single_control_dev
    cut = {"double_blocks": (dbl, dbl // per), "single_blocks": (sgl, sgl // per),
           "add_double": (None, dbl // per), "add_single": (None, sgl // per)}

    def take(tree, n):
        return tree_map(lambda t: t[:n], tree)
    base = {k: take(v, cut[k][0]) if k in cut and cut[k][0] else v
            for k, v in params["base"].items()}
    ctrl = {k: take(v, cut[k][1]) if k in cut else v for k, v in params["control"].items()}
    return (dataclasses.replace(cfg, flux=dataclasses.replace(
        cfg.flux, num_layers=dbl, num_single_layers=sgl)), {"base": base, "control": ctrl})


def stream_probe(torch, cfg, params, req, dev):
    """One b=1 forward of ``params`` (the request's noise as latents and as
    condition): whether the stream entering the final
    AdaLN keeps a finite mean square in float32 on every token (past it the
    norm divides by inf and the prediction no longer depends on the input),
    and the stream's largest |value|."""
    from unigen_tpu_torch.models import unigen_flux as uf
    from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
    seen, real = [], uf.adaln_continuous

    def probe(p, x, temb):
        xf = x.float()
        seen.append((bool(torch.isfinite(xf.square().mean(-1)).all()),
                     xf.abs().max().item()))
        return real(p, x, temb)
    lat = req["latents"]
    hw = math.isqrt(lat.shape[1])
    ids = prepare_latent_image_ids(hw, hw, device=dev)
    uf.adaln_continuous = probe
    try:
        with torch.no_grad():
            pred = uf.unigen_flux_forward(
                params, cfg, lat, lat, req["prompt_embeds"], req["pooled"],
                req["cond_pooled"], torch.full((1,), 0.5, dtype=lat.dtype, device=dev),
                ids, torch.zeros(req["prompt_embeds"].shape[1], 3, device=dev), ids)[0]
    finally:
        uf.adaln_continuous = real
    finite, max_abs = seen[-1]
    return finite and bool(torch.isfinite(pred.float()).all()), max_abs


def lagged_denoise(thr_c, thr_m, kinds):
    """The server's adaptive_lag=1 hybrid rule for one request, written out
    as forward calls (a stand-in for UniGenFluxPipeline.denoise at b=1):
    step 0 full, step 1 holds; at step i >= 2 the drifts of step i-1's input
    against the references as they stood after step i-2, read as 0 where
    step i-1 moved that reference; full past ``thr_c``, else base past
    ``thr_m``, else the held prediction. Appends each step's kind to
    ``kinds``."""
    import numpy as np
    from unigen_tpu_torch.pipelines import caching, scheduling

    def denoise(mode, lat, fwd, streams, sigmas, num_steps, cfg_scale):
        ref_full = ref_pred = lat
        drifts, moved, res, p1 = [], [], None, None
        for i in range(num_steps):
            kind = "full" if i == 0 else "hold"
            if i >= 2:
                d_full, d_pred = drifts[i - 2]
                full_moved, pred_moved = moved[i - 1]
                kind = ("full" if not full_moved and d_full > np.float32(thr_c) else
                        "base" if not pred_moved and d_pred > np.float32(thr_m) else "hold")
            if kind == "full":
                p1, outs = fwd(lat, i, *streams[0], return_control_residuals=True)
                res, ref_full, ref_pred = outs["control_residuals"], lat, lat
            elif kind == "base":
                p1 = fwd(lat, i, *streams[0], control_residuals=res)[0]
                ref_pred = lat
            kinds.append(kind)
            moved.append((kind == "full", kind != "hold"))
            lat = scheduling.euler_step(lat, p1, sigmas[i], sigmas[i + 1])
            drifts.append((np.float32(caching.rel_change(lat, ref_full).item()),
                           np.float32(caching.rel_change(lat, ref_pred).item())))
        return lat
    return denoise


def pipeline_knobs(knobs):
    """A server mode's knobs as the one-shot pipeline takes them (multi_tick
    and adaptive_lag are the server's alone)."""
    return {k: v for k, v in knobs.items() if k not in ("multi_tick", "adaptive_lag")}


def pipeline_finals(torch, pipe, reqs, knobs, res, batch=STEPSERVE_SLOTS):
    """The one-shot pipeline's (final latents, uint8 images) of ``reqs`` with
    the server's ``knobs``: one generate over up to ``batch`` requests at a
    time (rows are independent under per-sample routing and the fixed
    schedules are per step), or, under adaptive_lag=1, lagged_denoise per
    request. Each control image is VAE-encoded alone, as the server's
    admission does: the convolutions' last bits depend on the batch size,
    and a last-bit change of the condition can flip a token's top-1 expert.
    Also -> the step kinds of the lagged references."""
    knobs = pipeline_knobs(knobs)
    lagged = "control_cache_threshold" in knobs
    got, kinds, real, encode = [], [], pipe.decode, pipe.encode_control

    def keep(lat, lh, lw):
        got.append(lat)
        return real(lat, lh, lw)

    def one_by_one(px, offsets, lh, lw):
        rows = [encode(px[i:i + 1], offsets, lh, lw) for i in range(px.shape[0])]
        return torch.cat([lat for lat, _ in rows]), rows[0][1]
    pipe.decode, pipe.encode_control = keep, one_by_one
    imgs = []
    try:
        step = 1 if lagged else batch
        for i in range(0, len(reqs), step):
            part = reqs[i:i + step]
            x = {k: torch.cat([r[k] for r in part]) for k in part[0]}
            if lagged:
                pipe.denoise = lagged_denoise(knobs["control_cache_threshold"],
                                              knobs["model_cache_threshold"], kinds)
                imgs.append(pipe.generate(**x, height=res, width=res,
                                          num_inference_steps=STEPS))
                del pipe.denoise
            else:
                imgs.append(pipe.generate(**x, height=res, width=res,
                                          num_inference_steps=STEPS, **knobs))
    finally:
        del pipe.decode, pipe.encode_control
    return torch.cat(got), torch.cat(imgs), kinds


def compare_finals(torch, reqs, finals, ref_lat, ref_img):
    """Per request: the relative L2 of the server's displacement (final
    latents - initial noise) from the pipeline's, and the largest uint8
    difference of their images."""
    rels, codes = [], []
    for k, r in enumerate(reqs):
        lat, img = finals[k]
        init = r["latents"].double()
        want = ref_lat[k:k + 1].double() - init
        rels.append(((lat.double() - init - want).norm() / want.norm()).item())
        codes.append(int((img.int() - ref_img[k:k + 1].int()).abs().max()))
    return rels, codes


def phase_stepserve(torch, dev, params, vae_cfg, vae_params, seed):
    """4c. The StepServer on phase 4's W4A8 flux_full tree and phase 4b's
    full-width VAE, 512^2, STEPSERVE_SLOTS slots, 4 steps, 512-token
    embeddings from ``seed``: one ``stepserve`` line per mode of
    STEPSERVE_MODES. Then ``stepserve_check``: every kernel call of one
    exact tick at full occupancy against its plain version, and, at the
    largest reduced depth whose stream stays unsaturated, every request's
    final latents against the one-shot pipeline's at the same shapes."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
    from unigen_tpu_torch.serving_steps import StepServer

    cfg = presets.flux_full()
    bb, slots = cfg.flux, STEPSERVE_SLOTS
    s_img = (PIPE_RES // (2 * vae_cfg.downscale)) ** 2
    n_sus = 4 * slots
    reqs = stepserve_requests(torch, dev, bb, vae_cfg, 2 + n_sus, PIPE_RES, seed + 11,
                              SEQ_TXT, (s_img, bb.in_channels))
    lines = {}
    for name, knobs in STEPSERVE_MODES:
        srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=slots,
                         num_inference_steps=STEPS, height=PIPE_RES, width=PIPE_RES,
                         device=dev, **knobs)
        lines[name] = drive_server(
            torch, dev, srv, reqs, n_sus, "stepserve",
            lambda calls: flux_forward_launches(params, cfg, calls), mode=name,
            knobs=knobs, steps=STEPS, resolution=PIPE_RES)

    # every kernel call of one exact tick at full occupancy
    srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=slots,
                     num_inference_steps=STEPS, height=PIPE_RES, width=PIPE_RES,
                     device=dev)
    try:
        four = reqs[2:2 + slots]
        st = dict(lat=torch.cat([r["latents"] for r in four]),
                  cond=torch.cat([srv._encode(r["control_pixels"]) for r in four]),
                  embeds=torch.cat([r["prompt_embeds"] for r in four]),
                  pooled=torch.cat([r["pooled"] for r in four]),
                  cpool=torch.cat([r["cond_pooled"] for r in four]))
        vec = [torch.full((slots,), float(v), device=dev) for v in
               (srv._timesteps[0], srv._sigmas[0], srv._sigmas[1], 1.0, 0.0)]
        checks = {}
        with torch.no_grad(), shadowed_kernels(torch, checks):
            tick = srv._exact_step(st, st["lat"], *vec)
    finally:
        srv.close()
    path_check = path_check_summary(checks)
    per_tick = expected_launches(params, cfg, slots)

    # each request against the one-shot pipeline of the same request and
    # knobs, at the deepest reduced depth whose stream stays unsaturated
    # (at full depth the random tree's stream overflows and the outputs no
    # longer depend on the inputs). On the card the random quantized tree
    # turns a last-bit difference of a product at another batch size into
    # a flipped int8 code or top-1 expert (the line's pipeline_b4_vs_b1:
    # the pipeline against itself at b=4 and b=1), so the server is held to
    # the pipeline at equal shapes: two requests one tick apart (two live
    # slots at different steps), whose gathered forwards then run one row
    # each, against the pipeline at b=1; the exact tick runs all 4 rows,
    # against the pipeline at b=4; multi_tick with all 4 slots admitted at
    # once (one fused window), against the pipeline at b=4
    probes = {}
    for depth in ((bb.num_layers, bb.num_single_layers),) + REDUCED_DEPTHS:
        rcfg, rparams = flux_reduced(torch, cfg, params, depth)
        probes[depth] = stream_probe(torch, rcfg, rparams, reqs[0], dev)
        if probes[depth][0]:
            break
    else:
        raise SystemExit(f"stepserve_check: no depth keeps the stream unsaturated: "
                         f"{probes}")
    rpipe = UniGenFluxPipeline(cfg=rcfg, params=rparams, vae_cfg=vae_cfg,
                               vae_params=vae_params, device=dev)
    part, reduced, rrefs = reqs[2:2 + slots], {}, {}
    # recorded, not bounded: the pipeline against itself, the same four
    # requests in one b=4 generate and one at a time
    rrefs["{}"] = pipeline_finals(torch, rpipe, part, {}, PIPE_RES)
    alone = {k: pipeline_finals(torch, rpipe, [r], {}, PIPE_RES)[:2]
             for k, r in enumerate(part)}
    rels, codes = compare_finals(torch, part, alone, *rrefs["{}"][:2])
    sensitivity = dict(max_rel_l2=max(rels), max_uint8_diff=max(codes))
    unequal = []
    for name, knobs in STEPSERVE_MODES:
        srv = StepServer(rcfg, rparams, vae_cfg, vae_params, batch_size=slots,
                         num_inference_steps=STEPS, height=PIPE_RES, width=PIPE_RES,
                         device=dev, **knobs)
        try:
            got, calls, st, admission = serve_at_reference_shapes(srv, part, knobs)
        finally:
            srv.close()
        key = json.dumps(pipeline_knobs(knobs), sort_keys=True)
        if key not in rrefs:
            rrefs[key] = pipeline_finals(torch, rpipe, part, knobs, PIPE_RES,
                                         batch=slots if key == "{}" else 1)
        ref_lat, ref_img, kinds = rrefs[key]
        rels, codes = compare_finals(torch, part, got, ref_lat, ref_img)
        if not at_reference_shapes(srv, knobs, calls, st):
            unequal.append(name)
        reduced[name] = dict(requests=len(rels), admission=admission,
                             max_rel_l2=max(rels), max_uint8_diff=max(codes),
                             rows_full=st["rows_full"], rows_base=st["rows_base"],
                             rows_refresh=st["rows_refresh"],
                             ticks_replay=st["ticks_replay"], ticks_fused=st["ticks_fused"],
                             forwards=sorted({f"{k}_{m}" for m, k in calls}),
                             **({"reference_kinds": kinds[:STEPS]} if kinds else {}))
    emit(dict(phase="stepserve_check",
              reference="UniGenFluxPipeline.generate of the same request and knobs "
                        "(adaptive_lag=1: the lagged rule written out as forward calls)",
              metric="relative L2 of the final latents' displacement from the noise",
              bound_rel_l2=STEPSERVE_REL_L2,
              tick_path_check=dict(path_check, rows=slots,
                                   expected={k: per_tick[k] for k in path_check}),
              reduced_depth=dict(depth=list(depth), pipeline_b4_vs_b1=sensitivity,
                                 probes={f"{d[0]}/{d[1]}": dict(unsaturated=ok,
                                                                stream_max_abs=m)
                                         for d, (ok, m) in probes.items()},
                                 modes=reduced)))
    bad = [n for n, r in reduced.items() if not r["max_rel_l2"] <= STEPSERVE_REL_L2]
    if bad or unequal or any(c["disagree"] or c["calls"] != per_tick[n]
                             for n, c in path_check.items()) \
            or set(path_check) != {"flash_attention_rope", "w4a8_matmul", "quantize_act"} \
            or not torch.isfinite(tick.float()).all():
        raise SystemExit(f"stepserve_check failed: modes {bad}, not at the "
                         f"reference's shapes {unequal}, tick {path_check}")
    return lines


def phase_stepserve_multires(torch, dev, params, vae_cfg, vae_params, seed):
    """4d. MultiResolutionStepServer on the one shared tree: a 512^2 bucket
    of STEPSERVE_SLOTS slots and a 1024^2 bucket of one slot, a few
    requests each fed from threads at once; per-bucket stats and launches
    (the counters are shared: their total must equal the sum of both
    buckets' formulas)."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.serving_steps import MultiResolutionStepServer
    cfg = presets.flux_full()
    bb = cfg.flux
    srv = MultiResolutionStepServer(
        cfg, params, vae_cfg, vae_params, num_inference_steps=STEPS, device=dev,
        buckets={PIPE_RES: dict(batch_size=STEPSERVE_SLOTS), HIRES: dict(batch_size=1)})
    calls = {key: forward_log(s) for key, s in srv.servers.items()}
    reqs, keys = [], []
    for res, n in MULTIRES_REQUESTS.items():
        s_img = (res // (2 * vae_cfg.downscale)) ** 2
        reqs += stepserve_requests(torch, dev, bb, vae_cfg, n, res, seed + res, SEQ_TXT,
                                   (s_img, bb.in_channels))
        keys += [(res, i) for i in range(n)]
    reset_launch_counts()
    order, latency = [], {}
    try:
        t0 = time.perf_counter()
        futs = serve_requests(torch, srv, reqs, keys, order, latency)
        imgs = {k: f.result(timeout=900) for k, f in futs.items()}
        wall = time.perf_counter() - t0
        stats = srv.stats()
    finally:
        srv.close()
    launches = nonzero(launch_counts())
    per_bucket = {f"{h}x{w}": flux_forward_launches(params, cfg, c)
                  for (h, w), c in calls.items()}
    want = {}
    for b in per_bucket.values():
        for k, n in b.items():
            want[k] = want.get(k, 0) + n
    emit(dict(phase="stepserve_multires", requests={str(r): n for r, n in
                                                    MULTIRES_REQUESTS.items()},
              steps=STEPS, wall_ms=wall * 1e3,
              latency_ms={f"{r}_{i}": v for (r, i), v in sorted(latency.items())},
              buckets={k: {f: v[f] for f in ("retired", "ticks", "rows_refresh",
                                              "rows_pad", "mean_occupancy", "latency_ms",
                                              "failed") if f in v}
                       for k, v in stats.items() if k != "total"},
              bucket_launches=per_bucket, launches=launches, expected_launches=want))
    for (res, i), img in imgs.items():
        if img.dtype != torch.uint8 or tuple(img.shape) != (1, res, res, 3):
            raise SystemExit(f"stepserve_multires: bad image {tuple(img.shape)} at {res}")
    if launches != nonzero(want) or launches.get("w4a8_general") \
            or stats["total"]["failed"] or stats["total"]["retired"] != len(reqs):
        raise SystemExit(f"stepserve_multires: launches {launches} != expected {want} "
                         f"or a request failed: {stats['total']}")


def sd3_server_path_check(torch, srv, x, cond, guidance):
    """Every kernel call of an sd3 StepServer's own forwards against its
    plain version, on the requests ``x`` (batched, one per slot) and their
    encoded control latents ``cond``: one exact tick of all slots (a
    forward of twice as many rows, each sample's block experts at their own
    capacities), and the hybrid's gathered full forward and
    base-with-replay forward of one slot (two rows), the replay fed what
    the full one captured at the same state. -> per forward the
    path_check_summary, the expected call counts, the replay's relative L2
    from the full forward's prediction with its bound (REPLAY_REL_L2 at
    int8 / int4 residuals, else STEPSERVE_REL_L2), and the three outputs."""
    n = srv.B
    e, p = x["prompt_embeds"], x["pooled"]
    st = dict(lat=x["latents"], cond=cond, cpool=x["cond_pooled"],
              embeds=torch.stack([torch.zeros_like(e), e], 1),
              pooled=torch.stack([torch.zeros_like(p), p], 1))
    vec = [torch.full((n,), float(v), device=srv.device) for v in
           (srv._timesteps[0], srv._sigmas[0], srv._sigmas[1], 1.0, guidance)]
    one = [v[:1] for v in vec]
    idx = torch.zeros(1, dtype=torch.long, device=srv.device)
    checks = {k: {} for k in ("tick", "full_1", "replay_1")}
    with torch.no_grad():
        with shadowed_kernels(torch, checks["tick"]):
            tick = srv._exact_step(st, st["lat"], *vec)
        with shadowed_kernels(torch, checks["full_1"]):
            full, _, outs = srv._gathered(st, idx, one[0], one[3], one[4],
                                          return_control_residuals=True,
                                          control_residuals_bits=srv.res_bits)
        with shadowed_kernels(torch, checks["replay_1"]):
            base = srv._gathered(st, idx, one[0], one[3], one[4],
                                 control_residuals=outs["control_residuals"])[0]
    expected = {"tick": expected_sd3_launches(srv.cfg, 2 * n),
                "full_1": expected_sd3_launches(srv.cfg, 2),
                "replay_1": expected_sd3_replay_launches(srv.cfg)}
    rel = ((base.double() - full.double()).norm() / full.double().norm()).item()
    replay = dict(bits=srv.res_bits, rel_l2=rel,
                  bound=REPLAY_REL_L2.get(srv.res_bits, STEPSERVE_REL_L2))
    return ({k: path_check_summary(c) for k, c in checks.items()}, expected, replay,
            (tick, full, base))


def phase_stepserve_sd3(torch, dev, params, seed):
    """8b. The StepServer on phase 8's SD3.5-medium tree with per-sample
    routing, a full-width random SD3 VAE (fp32, its 1.5305 / 0.0609
    factors), STEPSERVE_SLOTS slots, 28 steps, CFG 7.0 inside the tick, in
    each mode of SD3_STEPSERVE_MODES; then the exact server's final latents
    against UniGenSD3.denoise of the same requests, and
    sd3_server_path_check on a hybrid server."""
    import dataclasses
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models import vae as vae_lib
    from unigen_tpu_torch.models.unigen_sd3 import UniGenSD3
    from unigen_tpu_torch.serving_steps import StepServer
    run = presets.baseline_configs()["sd3_depth_28step"]
    cfg, steps, guidance, res = run["cfg"], run["steps"], run["guidance"], run["resolution"]
    cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, moe=dataclasses.replace(cfg.control.moe, batch_mode="per_sample")))
    bb = cfg.sd3
    vae_cfg = vae_lib.VAEConfig(scaling_factor=1.5305, shift_factor=0.0609)
    vae_params = vae_lib.init_vae_params(
        vae_cfg, gen=torch.Generator(device=dev).manual_seed(seed + 21), device=dev)
    lat = res // vae_cfg.downscale
    n_sus = SD3_STEPSERVE_REQUESTS
    reqs = stepserve_requests(torch, dev, bb, vae_cfg, 2 + n_sus, res, seed + 22, SD3_TXT,
                              (bb.in_channels, lat, lat))
    lines = {}
    for name, knobs in SD3_STEPSERVE_MODES:
        srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=STEPSERVE_SLOTS,
                         num_inference_steps=steps, guidance_scale=guidance,
                         height=res, width=res, device=dev, **knobs)
        lines[name] = drive_server(
            torch, dev, srv, reqs, n_sus, "stepserve_sd3",
            lambda calls: sd3_forward_launches(cfg, calls), mode=name, knobs=knobs,
            steps=steps, guidance=guidance, resolution=res)
    # the exact server against the model's CFG denoise of the same four
    # requests at SD3_CHECK_STEPS steps (a server knob): an exact tick runs
    # all 4 slots, so its forwards have the denoise's shapes at b=4
    part = reqs[2:2 + STEPSERVE_SLOTS]
    srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=STEPSERVE_SLOTS,
                     num_inference_steps=SD3_CHECK_STEPS, guidance_scale=guidance,
                     height=res, width=res, device=dev)
    rows, order = decode_log(srv), []
    try:
        futs = serve_requests(torch, srv, part, list(range(len(part))), order, {})
        for f in futs.values():
            f.result(timeout=900)
    finally:
        srv.close()
    got = dict(zip(order, rows))
    cond = torch.cat([srv._encode(r["control_pixels"]) for r in part])
    x = {k: torch.cat([r[k] for r in part])
         for k in ("latents", "prompt_embeds", "pooled", "cond_pooled")}
    want = UniGenSD3(cfg, params, device=dev).denoise(
        x["latents"], cond, x["prompt_embeds"], x["pooled"], x["cond_pooled"],
        num_steps=SD3_CHECK_STEPS, guidance_scale=guidance)
    rels = []
    for j, r in enumerate(part):
        init = r["latents"].double()
        d_want = want[j:j + 1].double() - init
        rels.append(((got[j].double() - init - d_want).norm() / d_want.norm()).item())

    srv = StepServer(cfg, params, vae_cfg, vae_params, batch_size=STEPSERVE_SLOTS,
                     num_inference_steps=steps, guidance_scale=guidance, height=res,
                     width=res, device=dev, **dict(SD3_STEPSERVE_MODES)["hybrid_8_2"])
    try:
        path_check, expected, replay, outs = sd3_server_path_check(
            torch, srv, x, cond, guidance)
    finally:
        srv.close()
    emit(dict(phase="stepserve_sd3_check", reference="UniGenSD3.denoise (CFG on the "
              "batch axis) of the same requests", mode="exact", requests=len(rels),
              steps=SD3_CHECK_STEPS,
              metric="relative L2 of the final latents' displacement from the noise",
              max_rel_l2=max(rels), bound_rel_l2=STEPSERVE_REL_L2,
              path_check=path_check, expected_calls=expected, replay_vs_full=replay))
    if not max(rels) <= STEPSERVE_REL_L2:
        raise SystemExit(f"stepserve_sd3: exact server differs from the denoise: {rels}")
    bad = {k: c for k, c in path_check.items()
           if set(c) != {"flash_attention"} or c["flash_attention"]["disagree"]
           or c["flash_attention"]["calls"] != expected[k]}
    if bad or not replay["rel_l2"] <= replay["bound"] \
            or not all(torch.isfinite(t.float()).all() for t in outs):
        raise SystemExit(f"stepserve_sd3: a kernel call of the server's forwards "
                         f"disagrees with its plain version or ran another number of "
                         f"times ({bad}), or the replay differs from the full forward "
                         f"({replay})")
    return lines


# ------------------------------------------------------------ checkpoint directories

def _lin_shapes(sd, name, i, o, bias=True):
    sd[f"{name}.weight"] = (o, i)
    if bias:
        sd[f"{name}.bias"] = (o,)


def _time_text_shapes(sd, root, d, pooled_dim):
    for e, ind in (("timestep_embedder", 256), ("text_embedder", pooled_dim)):
        _lin_shapes(sd, f"{root}.{e}.linear_1", ind, d)
        _lin_shapes(sd, f"{root}.{e}.linear_2", d, d)


def _flux_attn_shapes(sd, p, d, hd, context):
    for n in ("to_q", "to_k", "to_v"):
        _lin_shapes(sd, f"{p}.{n}", d, d)
    sd[f"{p}.norm_q.weight"] = sd[f"{p}.norm_k.weight"] = (hd,)
    if context:
        for n in ("to_out.0", "add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
            _lin_shapes(sd, f"{p}.{n}", d, d)
        sd[f"{p}.norm_added_q.weight"] = sd[f"{p}.norm_added_k.weight"] = (hd,)


def _flux_double_shapes(sd, p, d, hd):
    _lin_shapes(sd, f"{p}.norm1.linear", d, 6 * d)
    _lin_shapes(sd, f"{p}.norm1_context.linear", d, 6 * d)
    _flux_attn_shapes(sd, f"{p}.attn", d, hd, True)
    for ff in ("ff", "ff_context"):
        _lin_shapes(sd, f"{p}.{ff}.net.0.proj", d, 4 * d)
        _lin_shapes(sd, f"{p}.{ff}.net.2", 4 * d, d)


def _flux_single_shapes(sd, p, d, hd):
    _lin_shapes(sd, f"{p}.norm.linear", d, 3 * d)
    _flux_attn_shapes(sd, f"{p}.attn", d, hd, False)
    _lin_shapes(sd, f"{p}.proj_mlp", d, 4 * d)
    _lin_shapes(sd, f"{p}.proj_out", 5 * d, d)


def flux_transformer_shapes(bb):
    """diffusers FluxTransformer2DModel's tensor names and shapes."""
    sd, d, hd = {}, bb.inner_dim, bb.attention_head_dim
    _lin_shapes(sd, "x_embedder", bb.in_channels, d)
    _lin_shapes(sd, "context_embedder", bb.joint_attention_dim, d)
    _time_text_shapes(sd, "time_text_embed", d, bb.pooled_projection_dim)
    if bb.guidance_embeds:
        _lin_shapes(sd, "time_text_embed.guidance_embedder.linear_1", 256, d)
        _lin_shapes(sd, "time_text_embed.guidance_embedder.linear_2", d, d)
    for i in range(bb.num_layers):
        _flux_double_shapes(sd, f"transformer_blocks.{i}", d, hd)
    for i in range(bb.num_single_layers):
        _flux_single_shapes(sd, f"single_transformer_blocks.{i}", d, hd)
    _lin_shapes(sd, "norm_out.linear", d, 2 * d)
    _lin_shapes(sd, "proj_out", d, bb.in_channels)
    return sd


def flux_adapter_shapes(cfg):
    """The reference UniGen FLUX adapter's names (trainable_control_modules:
    control_* blocks, their add linears, the DeepSpeed MoE of modulated
    experts, the shared expert) and shapes."""
    bb, cc = cfg.flux, cfg.control
    sd, d, hd, pd = {}, bb.inner_dim, bb.attention_head_dim, bb.pooled_projection_dim
    n_cn, n_cn_s = bb.num_layers // cc.single_control_dev, \
        bb.num_single_layers // cc.single_control_dev
    e_num = cc.moe.num_experts(cfg.condition_nums)
    _lin_shapes(sd, "control_x_embedder", bb.in_channels, d)
    _lin_shapes(sd, "control_context_embedder", d, d)
    for root in ("control_time_text_embed", "control_condition_embed"):
        _time_text_shapes(sd, root, d, pd)
    for i in range(n_cn):
        _flux_double_shapes(sd, f"control_joint_trans_blocks.{i}", d, hd)
        _lin_shapes(sd, f"controlnet_add_joint_blocks.{i}", d, d)
    for i in range(n_cn_s):
        _flux_single_shapes(sd, f"control_single_trans_blocks.{i}", d, hd)
        _lin_shapes(sd, f"controlnet_add_single_blocks.{i}", d, d)
    sd["moe.moe_layer.gate.wg.weight"] = (e_num, d)
    for e in range(e_num):
        for pair in (0, 1):
            _lin_shapes(sd, f"moe.moe_layer.experts.deepspeed_experts.{e}.{pair}.0", d, d)
            _lin_shapes(sd, f"moe.moe_layer.experts.deepspeed_experts.{e}.{pair}.1", pd, d)
    _flux_double_shapes(sd, "shared_expert.0", d, hd)
    _flux_double_shapes(sd, "shared_expert.1", d, hd)
    return sd


def _sd3_attn_shapes(sd, p, d, hd, qk, context, pre_only=False):
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        _lin_shapes(sd, f"{p}.{n}", d, d)
    if qk:
        sd[f"{p}.norm_q.weight"] = sd[f"{p}.norm_k.weight"] = (hd,)
    if context:
        for n in ("add_q_proj", "add_k_proj", "add_v_proj"):
            _lin_shapes(sd, f"{p}.{n}", d, d)
        if qk:
            sd[f"{p}.norm_added_q.weight"] = sd[f"{p}.norm_added_k.weight"] = (hd,)
        if not pre_only:
            _lin_shapes(sd, f"{p}.to_add_out", d, d)


def _sd3_block_shapes(sd, p, d, hd, qk, *, dual, last):
    _lin_shapes(sd, f"{p}.norm1.linear", d, (9 if dual else 6) * d)
    _lin_shapes(sd, f"{p}.norm1_context.linear", d, (2 if last else 6) * d)
    _sd3_attn_shapes(sd, f"{p}.attn", d, hd, qk, True, pre_only=last)
    if dual:
        _sd3_attn_shapes(sd, f"{p}.attn2", d, hd, qk, False)
    ffs = ("ff",) if last else ("ff", "ff_context")
    for ff in ffs:
        _lin_shapes(sd, f"{p}.{ff}.net.0.proj", d, 4 * d)
        _lin_shapes(sd, f"{p}.{ff}.net.2", 4 * d, d)


def _patch_embed_shapes(sd, p, d, ch, patch, max_size):
    sd[f"{p}.proj.weight"] = (d, ch, patch, patch)
    sd[f"{p}.proj.bias"] = (d,)
    sd[f"{p}.pos_embed"] = (1, max_size ** 2, d)


def sd3_transformer_shapes(bb):
    """diffusers SD3Transformer2DModel's tensor names and shapes."""
    sd, d, hd, qk = {}, bb.inner_dim, bb.attention_head_dim, bool(bb.qk_norm)
    _patch_embed_shapes(sd, "pos_embed", d, bb.in_channels, bb.patch_size,
                        bb.pos_embed_max_size)
    _time_text_shapes(sd, "time_text_embed", d, bb.pooled_projection_dim)
    _lin_shapes(sd, "context_embedder", bb.joint_attention_dim, d)
    dual = set(bb.dual_attention_layers)
    for i in range(bb.num_layers):
        _sd3_block_shapes(sd, f"transformer_blocks.{i}", d, hd, qk, dual=i in dual,
                          last=i == bb.num_layers - 1)
    _lin_shapes(sd, "norm_out.linear", d, 2 * d)
    _lin_shapes(sd, "proj_out", d, bb.patch_size ** 2 * bb.out_channels)
    return sd


def sd3_adapter_shapes(cfg):
    """The reference UniGenSD3 adapter's names and shapes (the interleaved
    control stack, its add linears, the condition patch embed with its
    position table, block experts of two SD3 single blocks, the shared
    expert whose weave_text is context-pre-only with dual attention)."""
    bb, cc = cfg.sd3, cfg.control
    sd, d, hd, qk = {}, bb.inner_dim, bb.attention_head_dim, bool(bb.qk_norm)
    n_cn = cc.num_layers or bb.num_layers
    _patch_embed_shapes(sd, "control_pos_embed_input", d,
                        bb.in_channels + cc.extra_conditioning_channels, bb.patch_size,
                        bb.pos_embed_max_size)
    for root in ("control_time_text_embed", "control_condition_embed"):
        _time_text_shapes(sd, root, d, bb.pooled_projection_dim)
    _lin_shapes(sd, "control_context_embedder", d, d)
    for i in range(n_cn):
        _sd3_block_shapes(sd, f"control_transformer_blocks.{i}", d, hd, qk, dual=False,
                          last=False)
        _lin_shapes(sd, f"controlnet_add_blocks.{i}", d, d)
    e_num = cc.moe.num_experts(cfg.condition_nums)
    sd["moe.moe_layer.gate.wg.weight"] = (e_num, d)
    for e in range(e_num):
        for pair in (0, 1):
            p = f"moe.moe_layer.experts.deepspeed_experts.{e}.{pair}"
            _lin_shapes(sd, f"{p}.norm1.linear", d, 6 * d)
            _sd3_attn_shapes(sd, f"{p}.attn", d, hd, qk, False)
            _lin_shapes(sd, f"{p}.ff.net.0.proj", d, 4 * d)
            _lin_shapes(sd, f"{p}.ff.net.2", 4 * d, d)
    _sd3_block_shapes(sd, "shared_expert.0", d, hd, qk, dual=False, last=False)
    _sd3_block_shapes(sd, "shared_expert.1", d, hd, qk, dual=True, last=True)
    return sd


def clip_shapes(ccfg):
    """transformers CLIPTextModel(WithProjection)'s names and shapes."""
    d, it = ccfg.hidden_size, ccfg.intermediate_size
    sd = {"text_model.embeddings.token_embedding.weight": (ccfg.vocab_size, d),
          "text_model.embeddings.position_embedding.weight":
              (ccfg.max_position_embeddings, d)}
    for i in range(ccfg.num_layers):
        p = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin_shapes(sd, f"{p}.self_attn.{n}", d, d)
        _lin_shapes(sd, f"{p}.mlp.fc1", d, it)
        _lin_shapes(sd, f"{p}.mlp.fc2", it, d)
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{p}.{n}.weight"] = sd[f"{p}.{n}.bias"] = (d,)
    sd["text_model.final_layer_norm.weight"] = sd["text_model.final_layer_norm.bias"] = (d,)
    if ccfg.projection_dim:
        sd["text_projection.weight"] = (ccfg.projection_dim, d)
    return sd


def t5_shapes(tcfg):
    """transformers T5EncoderModel's names and shapes (the embedding once, as
    ``shared``)."""
    dm, inner = tcfg.d_model, tcfg.num_heads * tcfg.d_kv
    sd = {"shared.weight": (tcfg.vocab_size, dm),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              (tcfg.relative_attention_num_buckets, tcfg.num_heads)}
    for i in range(tcfg.num_layers):
        p = f"encoder.block.{i}.layer"
        for n in ("q", "k", "v"):
            sd[f"{p}.0.SelfAttention.{n}.weight"] = (inner, dm)
        sd[f"{p}.0.SelfAttention.o.weight"] = (dm, inner)
        sd[f"{p}.1.DenseReluDense.wi_0.weight"] = (tcfg.d_ff, dm)
        sd[f"{p}.1.DenseReluDense.wi_1.weight"] = (tcfg.d_ff, dm)
        sd[f"{p}.1.DenseReluDense.wo.weight"] = (dm, tcfg.d_ff)
        sd[f"{p}.0.layer_norm.weight"] = sd[f"{p}.1.layer_norm.weight"] = (dm,)
    sd["encoder.final_layer_norm.weight"] = (dm,)
    return sd


def vae_shapes(vcfg):
    """diffusers AutoencoderKL's names and shapes."""
    sd = {}

    def conv(name, ci, co, k=3):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = (co, ci, k, k), (co,)

    def norm(name, c):
        sd[f"{name}.weight"] = sd[f"{name}.bias"] = (c,)

    def res(p, ci, co):
        norm(f"{p}.norm1", ci)
        conv(f"{p}.conv1", ci, co)
        norm(f"{p}.norm2", co)
        conv(f"{p}.conv2", co, co)
        if ci != co:
            conv(f"{p}.conv_shortcut", ci, co, 1)

    def mid(p, c):
        res(f"{p}.mid_block.resnets.0", c, c)
        norm(f"{p}.mid_block.attentions.0.group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _lin_shapes(sd, f"{p}.mid_block.attentions.0.{n}", c, c)
        res(f"{p}.mid_block.resnets.1", c, c)

    chs, lpb = vcfg.block_out_channels, vcfg.layers_per_block
    conv("encoder.conv_in", vcfg.in_channels, chs[0])
    ci = chs[0]
    for i, co in enumerate(chs):
        for j in range(lpb):
            res(f"encoder.down_blocks.{i}.resnets.{j}", ci if j == 0 else co, co)
        if i < len(chs) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", co, co)
        ci = co
    mid("encoder", chs[-1])
    norm("encoder.conv_norm_out", chs[-1])
    conv("encoder.conv_out", chs[-1], 2 * vcfg.latent_channels)
    rev = list(reversed(chs))
    conv("decoder.conv_in", vcfg.latent_channels, rev[0])
    mid("decoder", rev[0])
    ci = rev[0]
    for i, co in enumerate(rev):
        for j in range(lpb + 1):
            res(f"decoder.up_blocks.{i}.resnets.{j}", ci if j == 0 else co, co)
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", co, co)
        ci = co
    norm("decoder.conv_norm_out", rev[-1])
    conv("decoder.conv_out", rev[-1], vcfg.in_channels)
    return sd


SAFETENSORS_NAMES = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}


def checkpoint_value(torch, name, shape, dtype, gen, device, fixed=None, uniform=False):
    """A checkpoint tensor on ``device``: ``fixed[name]`` where given (a
    position table), else drawn from ``gen``: a norm's 1-D weight
    1 + N(0, 0.02), any other N(0, 0.02); with ``uniform`` a linear's 2-D
    weight [out, in] is drawn as the port's linear init draws it,
    U(-k, k) with k = 1/sqrt(in)."""
    if fixed and name in fixed:
        return fixed[name].to(device, dtype)
    if uniform and len(shape) == 2 and name.endswith(".weight"):
        k = 1.0 / math.sqrt(shape[1])
        return torch.empty(shape, dtype=dtype, device=device).uniform_(-k, k, generator=gen)
    out = torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02, generator=gen)
    if len(shape) == 1 and "norm" in name and name.endswith(".weight"):
        out += 1.0
    return out


def sd3_tables(torch, cfg, device):
    """The SD3 PatchEmbed sincos tables [1, max_size^2, D] of the base and
    of the control's condition embed, as the checkpoints hold them."""
    from unigen_tpu_torch.ops.packing import sincos_2d_pos_embed
    bb = cfg.sd3
    table = sincos_2d_pos_embed(bb.inner_dim, bb.pos_embed_max_size,
                                bb.sample_size // bb.patch_size, device=device)[None]
    return {"pos_embed.pos_embed": table, "control_pos_embed_input.pos_embed": table}


def write_safetensors(torch, path, shapes, dtype, gen, device, fixed=None, uniform=False):
    """Stream the tensors of ``shapes`` ({name: shape}, in order) into one
    safetensors file, each drawn on ``device`` (checkpoint_value) and written
    as it comes (``fixed`` as in checkpoint_value): the 8-byte header
    length, the JSON header, the raw bytes (``uniform`` as in
    checkpoint_value). -> bytes written."""
    import struct
    itemsize = torch.empty((), dtype=dtype).element_size()
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for name, shape in shapes.items():
        n = math.prod(shape) * itemsize
        header[name] = {"dtype": SAFETENSORS_NAMES[str(dtype).split(".")[-1]],
                        "shape": list(shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name, shape in shapes.items():
            t = checkpoint_value(torch, name, shape, dtype, gen, device, fixed, uniform)
            f.write(t.reshape(-1).view(torch.uint8).cpu().numpy().data)
    return 8 + len(head) + off


def write_component(torch, dirpath, shapes, dtype, gen, device, config=None,
                    shards=1, stem="model", fixed=None, uniform=False):
    """A diffusers / transformers component directory: its config.json and
    its tensors in ``shards`` safetensors files (named as the libraries name
    sharded files, with their index). -> bytes written."""
    dirpath.mkdir(parents=True, exist_ok=True)
    if config is not None:
        (dirpath / "config.json").write_text(json.dumps(config))
    names = list(shapes)
    per = -(-len(names) // shards)
    total, index = 0, {}
    for s in range(shards):
        part = {n: shapes[n] for n in names[s * per:(s + 1) * per]}
        fname = (f"{stem}.safetensors" if shards == 1
                 else f"{stem}-{s + 1:05d}-of-{shards:05d}.safetensors")
        total += write_safetensors(torch, dirpath / fname, part, dtype, gen, device, fixed,
                                   uniform)
        index.update({n: fname for n in part})
    if shards > 1:
        (dirpath / f"{stem}.safetensors.index.json").write_text(
            json.dumps({"metadata": {"total_size": total}, "weight_map": index}))
    return total


def write_reference_adapter_bins(torch, dirpath, shapes, dtype, gen, device, uniform=False):
    """The reference trainer's adapter layout: one ``torch.save``d state dict
    per top-level module, ``{module}_weights_{idx}.bin``, keys without the
    module prefix (``uniform`` as in checkpoint_value). -> bytes written."""
    dirpath.mkdir(parents=True, exist_ok=True)
    by_module = {}
    for name, shape in shapes.items():
        module, rest = name.split(".", 1)
        by_module.setdefault(module, {})[rest] = shape
    total = 0
    for idx, (module, part) in enumerate(sorted(by_module.items())):
        sd = {k: checkpoint_value(torch, f"{module}.{k}", s, dtype, gen, device,
                                  uniform=uniform).cpu()
              for k, s in part.items()}
        path = dirpath / f"{module}_weights_{idx}.bin"
        torch.save(sd, path)
        total += path.stat().st_size
    return total


def checkpoint_bytes(shapes_by_dtype):
    """Bytes of the tensors of (shapes, itemsize) pairs."""
    return sum(math.prod(s) * size for shapes, size in shapes_by_dtype
               for s in shapes.values())


def require_disk(path, need):
    """Stop the run unless the file system of ``path`` has ``need`` bytes free
    and 2 GiB to spare."""
    import shutil
    path.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(path).free
    if free < need + 2 ** 31:
        raise SystemExit(f"{path}: {free / 2**30:.1f} GiB free, the checkpoint needs "
                         f"{need / 2**30:.1f} GiB and 2 GiB to spare")
    return free


# ------------------------------------------------------------ loading and the SD3 pipeline

def sd3_quantized_calls(params, cfg, leaf: str, replay: bool = False) -> int:
    """Calls of the quantized linears whose codes are ``leaf`` in one
    UniGen-SD3 forward: the dual and plain base stacks once per block, the
    control joint stack and its add linears once per base block (without
    the context branch the forward discards), any other once; a forward
    replaying cached control outputs (``replay``) runs the base and the add
    linears only."""
    from unigen_tpu_torch.utils import tree_leaves_with_path
    bb = cfg.sd3
    n_dual = len(set(bb.dual_attention_layers) & set(range(bb.num_layers)))
    uses = {("base", "dual_blocks"): n_dual,
            ("base", "plain_blocks"): bb.num_layers - n_dual - 1,
            ("control", "joint_blocks"): bb.num_layers,
            ("control", "add_blocks"): bb.num_layers}
    return sum(uses.get(path[:2], 1) for path, _ in tree_leaves_with_path(params)
               if path[-1] == leaf and not discarded_context(path)
               and not (replay and path[0] == "control" and path[1] != "add_blocks"))


def text_quantized_calls(tree, leaf: str) -> int:
    """Calls of the quantized linears of one CLIP, T5 or Gemma encode (a
    stacked layer leaf once per layer; Gemma's layers are a list)."""
    from unigen_tpu_torch.utils import tree_leaves_with_path
    return sum(t.shape[0] if path[0] == "layers" and t.dim() == 3 else 1
               for path, t in tree_leaves_with_path(tree) if path[-1] == leaf)


def text_launches(*trees):
    """W4A8 and activation-quantization launches of one encode by each tree."""
    w4 = sum(text_quantized_calls(t, "w_q4") for t in trees)
    return {"w4a8_matmul": w4, "w4a8_general": 0,
            "quantize_act": w4 + sum(text_quantized_calls(t, "w_q") for t in trees)}


def sd3_forward_launches_quantized(params, cfg, batch, replay=False):
    """Kernel launches of one UniGen-SD3 forward of a (W4A8 / W8A8) tree:
    rope-free attention (expected_sd3_launches, or the replay's), W4A8 and
    the activation quantization of every quantized linear."""
    w4 = sd3_quantized_calls(params, cfg, "w_q4", replay)
    return {"flash_attention": (expected_sd3_replay_launches(cfg) if replay
                                else expected_sd3_launches(cfg, batch)),
            "w4a8_matmul": w4, "w4a8_general": 0,
            "quantize_act": w4 + sd3_quantized_calls(params, cfg, "w_q", replay)}


def add_counts(*parts):
    out = {}
    for n, counts in parts:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + n * v
    return nonzero(out)


def expected_sd3_pipeline_launches(params, cfg, kinds):
    """Launches of SD3 pipeline denoise loops: ``kinds`` lists (batch,
    n_full, n_base) per loop; a full step runs one forward on the CFG pair,
    a replaying step (the control cache's, the hybrid's base step, a
    cfg_cache step on the positive half) a replay forward, a skip step
    none."""
    parts = []
    for batch, n_full, n_base in kinds:
        parts += [(n_full, sd3_forward_launches_quantized(params, cfg, 2 * batch)),
                  (n_base, sd3_forward_launches_quantized(params, cfg, 2 * batch, True))]
    return add_counts(*parts)


def sd3_residual_cache_bytes(cfg, batch, s_img, bits, itemsize=2):
    """Bytes of the SD3 control-output cache over the CFG pair: one
    [n_base, 2B, S_img, D] stack, in the pipeline's dtype (``itemsize``
    bytes, bf16 by default) or int8 / packed int4 codes with an fp32 scale
    a token."""
    bb = cfg.sd3
    per_token = {16: itemsize * bb.inner_dim, 8: bb.inner_dim + 4, 4: bb.inner_dim // 2 + 4}
    return bb.num_layers * 2 * batch * s_img * per_token[bits]


@contextlib.contextmanager
def residual_probe(pipe, held):
    """Append to ``held`` the bytes of every control-residual cache that
    ``pipe.generate``'s forwards capture, read from the tensors themselves,
    by wrapping the forward that the SD3 pipeline's ``denoise`` is handed."""
    from unigen_tpu_torch.utils import param_bytes
    real, saved = pipe.denoise, vars(pipe).get("denoise")

    def denoise(mode, latents, fwd, *a, **kw):
        def probed(lat, i, **cache):
            raw, outs = fwd(lat, i, **cache)
            if cache.get("return_control_residuals"):
                held.append(param_bytes(outs["control_residuals"]))
            return raw, outs
        return real(mode, latents, probed, *a, **kw)
    pipe.denoise = denoise
    try:
        yield held
    finally:
        if saved is None:
            del pipe.denoise
        else:
            pipe.denoise = saved           # an outer wrapper, as stage_timer's


@contextlib.contextmanager
def load_timer(torch, stats):
    """Time the loader's parts by wrapping the bridge's entry points in their
    modules: each checkpoint directory's read (its files read through once
    first, so ``read_s`` is the host read and the lazy mapping after it
    finds the pages in memory), each converter (read pages to the card,
    transpose, cast), and each quantization (seconds, the tree's bytes
    before and after, the peak device bytes while it ran)."""
    from unigen_tpu_torch.io import torch_bridge as tb
    from unigen_tpu_torch.io import torch_bridge_sd3 as tb3
    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.pipelines import loading
    from unigen_tpu_torch.utils import param_bytes
    buf = bytearray(64 << 20)

    def read_through(path):
        files = [p for p in sorted(Path(path).iterdir())
                 if p.suffix in (".safetensors", ".bin") and p.is_file()]
        t0, n = time.perf_counter(), 0
        for p in files:
            with open(p, "rb") as f:
                while (got := f.readinto(buf)):
                    n += got
        dt = time.perf_counter() - t0
        stats.setdefault("read", {})[Path(path).name] = dict(
            bytes=n, s=dt, gb_per_s=n / dt / 1e9 if dt else None)

    def reader(real):
        def read(path, *a, **kw):
            if Path(path).is_dir():
                read_through(path)
            return real(path, *a, **kw)
        return read

    def converter(name, real):
        def convert(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            stats.setdefault("convert_s", {})
            stats["convert_s"][name] = stats["convert_s"].get(name, 0.0) + \
                time.perf_counter() - t0
            return out
        return convert

    def quantizer(name, real):
        def quantize(*a, **kw):
            before = param_bytes([x for x in a if isinstance(x, dict)])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            stats.setdefault("quantize", []).append(dict(
                what=name, s=time.perf_counter() - t0, source_bytes=before,
                quantized_bytes=quant.quantized_bytes(out),
                resident_bytes_before=resident,
                peak_bytes=torch.cuda.max_memory_allocated()))
            return out
        return quantize

    patches = [(tb, "read_checkpoint_dir", reader(tb.read_checkpoint_dir)),
               (tb, "read_adapter_checkpoint", reader(tb.read_adapter_checkpoint))]
    patches += [(mod, n, converter(n, getattr(mod, n))) for mod, n in (
        (tb, "load_flux_transformer"), (tb, "load_unigen_adapter"), (tb, "load_clip_text"),
        (tb, "load_t5_encoder"), (tb, "load_vae"), (tb3, "load_sd3_transformer"),
        (tb3, "load_sd3_unigen_adapter"), (tb, "load_gemma_text"),
        (tb3, "load_sana_transformer"), (tb3, "load_sana_unigen_adapter"))]
    patches += [(mod, n, quantizer(n, getattr(mod, n))) for mod, n in (
        (loading, "_quantize_unigen_tree"), (loading, "_quantize_text"),
        (quant, "quantize_unigen_serving_streaming"))]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    for mod, n, fn in patches:
        setattr(mod, n, fn)
    try:
        yield stats
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


def sd3_text_configs():
    """The configs of SD3.5-medium's text encoders as its checkpoint holds
    them: CLIP-L (quick-GELU) and CLIP-G (exact GELU), both with projection,
    and T5-XXL; -> {subfolder: (port config, config.json)}."""
    from unigen_tpu_torch.models.clip_text import CLIPTextConfig
    from unigen_tpu_torch.models.t5_text import T5Config
    out = {}
    for sub, d, it, layers, heads, act in (("text_encoder", 768, 3072, 12, 12, "quick_gelu"),
                                           ("text_encoder_2", 1280, 5120, 32, 20, "gelu")):
        ccfg = CLIPTextConfig(hidden_size=d, intermediate_size=it, num_layers=layers,
                              num_heads=heads, projection_dim=d, eos_token_id=2,
                              hidden_act=act)
        out[sub] = (ccfg, {"architectures": ["CLIPTextModelWithProjection"],
                           "vocab_size": ccfg.vocab_size, "hidden_size": d,
                           "intermediate_size": it, "num_hidden_layers": layers,
                           "num_attention_heads": heads, "max_position_embeddings": 77,
                           "projection_dim": d, "hidden_act": act, "eos_token_id": 2})
    t5 = T5Config()
    out["text_encoder_3"] = (t5, {"architectures": ["T5EncoderModel"],
                                  "vocab_size": t5.vocab_size, "d_model": t5.d_model,
                                  "d_kv": t5.d_kv, "d_ff": t5.d_ff,
                                  "num_layers": t5.num_layers, "num_heads": t5.num_heads,
                                  "relative_attention_num_buckets": 32,
                                  "feed_forward_proj": "gated-gelu"})
    return out


def sd3_vae_config():
    """SD3.5's AutoencoderKL config: FLUX's architecture, SD3's scaling."""
    from unigen_tpu_torch.models.vae import VAEConfig
    return VAEConfig(scaling_factor=1.5305, shift_factor=0.0609)


def vae_config_json(vcfg):
    return {"_class_name": "AutoencoderKL", "in_channels": vcfg.in_channels,
            "out_channels": vcfg.in_channels, "latent_channels": vcfg.latent_channels,
            "block_out_channels": list(vcfg.block_out_channels),
            "layers_per_block": vcfg.layers_per_block,
            "norm_num_groups": vcfg.norm_num_groups,
            "scaling_factor": vcfg.scaling_factor, "shift_factor": vcfg.shift_factor}


def write_sd3_checkpoint(torch, dev, root, cfg, seed):
    """A random SD3.5 checkpoint directory of ``cfg``'s sizes in the diffusers
    layout (transformer and T5 bf16, T5 in two shards; CLIP-L and CLIP-G
    fp16; the VAE fp32; the text towers and the VAE of sd3_text_configs
    and sd3_vae_config), each tensor drawn on ``dev`` from ``seed``, and
    the UniGen adapter in ``root/adapter`` (bf16 safetensors). -> bytes per
    component."""
    bb = cfg.sd3
    text, vae_cfg = sd3_text_configs(), sd3_vae_config()
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    parts = [("transformer", sd3_transformer_shapes(bb), bf16, 1,
              dict(_class_name="SD3Transformer2DModel", sample_size=bb.sample_size,
                   patch_size=bb.patch_size, in_channels=bb.in_channels,
                   num_layers=bb.num_layers, attention_head_dim=bb.attention_head_dim,
                   num_attention_heads=bb.num_attention_heads,
                   joint_attention_dim=bb.joint_attention_dim,
                   caption_projection_dim=bb.caption_projection_dim,
                   pooled_projection_dim=bb.pooled_projection_dim,
                   out_channels=bb.out_channels, pos_embed_max_size=bb.pos_embed_max_size,
                   dual_attention_layers=list(bb.dual_attention_layers),
                   qk_norm=bb.qk_norm), "diffusion_pytorch_model"),
             ("adapter", sd3_adapter_shapes(cfg), bf16, 1, None, "diffusion_pytorch_model"),
             ("text_encoder", clip_shapes(text["text_encoder"][0]), f16, 1,
              text["text_encoder"][1], "model"),
             ("text_encoder_2", clip_shapes(text["text_encoder_2"][0]), f16, 1,
              text["text_encoder_2"][1], "model"),
             ("text_encoder_3", t5_shapes(text["text_encoder_3"][0]), bf16, 2,
              text["text_encoder_3"][1], "model"),
             ("vae", vae_shapes(vae_cfg), f32, 1, vae_config_json(vae_cfg),
              "diffusion_pytorch_model")]
    require_disk(root, checkpoint_bytes([
        (shapes, torch.empty((), dtype=dt).element_size()) for _, shapes, dt, *_ in parts]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    fixed = sd3_tables(torch, cfg, dev)
    written = {sub: write_component(torch, root / sub, shapes, dt, gen, dev, config,
                                    shards=shards, stem=stem, fixed=fixed)
               for sub, shapes, dt, shards, config, stem in parts}
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "num_train_timesteps": 1000,
         "shift": 3.0}))
    return written


def set_stub_tokenizers(pipe, seed):
    """SeededTokenizer stubs in place of the tokenizers the card host cannot
    load (no transformers there), with the checkpoint's vocabularies."""
    te = pipe.text_encoders
    for i, key in enumerate(("clip_l", "clip_g")):
        params, ccfg, _ = te[key]
        te[key] = (params, ccfg, SeededTokenizer(ccfg.vocab_size, ccfg.vocab_size - 1,
                                                 seed + i))
    if te.get("t5"):
        params, tcfg, _ = te["t5"]
        te["t5"] = (params, tcfg, SeededTokenizer(tcfg.vocab_size, 1, seed + 2))


def sd3_pipeline_forward(torch, pipe, embeds, pooled, cond_pooled, control_lat, seed,
                         replay=False):
    """One forward of the pipeline's tree at its shapes, at the first step of
    a 28-step schedule: the CFG forward on the [zero negatives; prompt]
    pair, or with ``replay`` the cfg_cache replay step (the positive half
    alone, replaying that CFG forward's control outputs)."""
    from unigen_tpu_torch.models.unigen_sd3 import unigen_sd3_forward
    from unigen_tpu_torch.pipelines import scheduling
    dev, dt = pipe.device, pipe.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    b = embeds.shape[0]
    lat = torch.randn((b,) + tuple(control_lat.shape[1:]), generator=g, device=dev, dtype=dt)
    _, ts = scheduling.inference_sigmas(pipe.scheduler, SD3_PIPE_STEPS)
    t = torch.full((2 * b,), float(ts[0]), dtype=dt, device=dev)
    args = (torch.cat([lat, lat]), torch.cat([control_lat, control_lat]),
            torch.cat([torch.zeros_like(embeds), embeds]),
            torch.cat([torch.zeros_like(pooled), pooled]),
            torch.cat([cond_pooled, cond_pooled]), t)
    if not replay:
        return lambda: unigen_sd3_forward(pipe.params, pipe.cfg, *args)[0]
    res = unigen_sd3_forward(pipe.params, pipe.cfg, *args, return_control_residuals=True)[2]
    res = res["control_residuals"][:, b:]
    return lambda: unigen_sd3_forward(pipe.params, pipe.cfg, lat, control_lat, embeds, pooled,
                                      cond_pooled, t[:b], control_residuals=res)[0]


def composed_balanced_sd3(mode, lat, fwd, fwd_pos, sigmas, num_steps, guidance):
    """SD3's "balanced" profile (hybrid c=8, m=2, bf16 residuals, order 0)
    written out as forward calls: a full forward capturing the control
    outputs every 8th step, a base forward replaying them on the other
    even steps, the last prediction held on the odd ones."""
    from unigen_tpu_torch.pipelines import scheduling
    b = lat.shape[0]

    def guided(raw):
        return raw[:b] + guidance * (raw[b:] - raw[:b])
    res = pred = None
    for i in range(num_steps):
        if i % 8 == 0:
            raw, outs = fwd(lat, i, return_control_residuals=True,
                            control_residuals_bits=16)
            pred, res = guided(raw), outs["control_residuals"]
        elif i % 2 == 0:
            pred = guided(fwd(lat, i, control_residuals=res)[0])
        lat = scheduling.euler_step(lat, pred, sigmas[i], sigmas[i + 1])
    return lat


def sd3_load_check(torch, root, pipe, dev, min_dim=512):
    """The streaming-quantized trees of ``pipe`` (W4A8 transformer, W4A8 text
    towers; donated, one block of a stack at a time) against the same walk
    without donation (each linear in one call, into a new tree, at
    ``min_dim``, the loader's gate) of the same checkpoint loaded with
    quantize=None: -> (leaves compared, leaves that differ). It sees the
    loader's per-subtree choice of bits, gate and skip list, and any bit
    that the in-place, per-block path changes; the rounding of the scales
    is held against the JAX loader by the CPU tests."""
    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.pipelines.loading import load_sd3_pipeline
    raw = load_sd3_pipeline(str(root), adapter_dir=str(root / "adapter"),
                            dtype=torch.bfloat16, device=dev)
    whole = functools.partial(quant.quantize_tree_streaming, donate=False)
    pairs = [(pipe.params["base"], whole(raw.params["base"], bits=4, min_dim=min_dim)),
             (pipe.params["control"], whole(raw.params["control"], bits=8,
                                            min_dim=min_dim))]
    for key in ("clip_l", "clip_g", "t5"):
        pairs.append((pipe.text_encoders[key][0], quant.quantize_text_tower(
            raw.text_encoders[key][0], bits=4, donate=False)))
    compared, differ = 0, []
    for got, want in pairs:
        n, d = trees_equal(torch, got, want)
        compared, differ = compared + n, differ + d
    del raw
    torch.cuda.empty_cache()
    return compared, differ


def kernel_path_check(torch, phase, calls):
    """Every kernel call of each ``(what, call, expected launches)`` against
    its plain version on the call's own inputs, with the W4A8 shapes run:
    one line, and a stop if a call disagrees or the calls differ from the
    expected launches."""
    path = {}
    with torch.no_grad():
        for what, call, want in calls:
            checks = {}
            with shadowed_kernels(torch, checks):
                call()
            summary = path_check_summary(checks)
            path[what] = dict(summary, expected_calls=nonzero(want),
                              w4a8_shapes=shape_counts(checks.get("w4a8_matmul", [])))
            got = {n: c["calls"] for n, c in summary.items()}
            if any(c["disagree"] for c in summary.values()) or got != {
                    n: v for n, v in nonzero(want).items() if n != "w4a8_general"}:
                raise SystemExit(f"{phase} {what}: {summary} (expected {want})")
    emit(dict(phase=phase, **path))
    return path


def phase_sd3_pipeline(torch, dev, seed, root):
    """8c. A full-size random SD3.5-medium checkpoint directory written to
    ``root`` (the diffusers layout, with a UniGen adapter), loaded by
    load_sd3_pipeline as a W4A8 tree (int4 base, int8 adapter) with W4A8
    text towers and seeded stub tokenizers; then 4 b=1 requests at 512^2,
    28 steps, CFG 7 in each mode of SD3_PIPE_MODES through
    MicroBatchServer(batch_size=2), and the load, path and composition
    checks. Every check stops the run. -> launches of the exact mode."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models.clip_text import clip_encode
    from unigen_tpu_torch.models.t5_text import t5_encode
    from unigen_tpu_torch.models.text_encoder import tokenize
    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.pipelines import caching
    from unigen_tpu_torch.pipelines.caching import resolve_cache_mode
    from unigen_tpu_torch.pipelines.loading import load_sd3_pipeline
    from unigen_tpu_torch.serving import MicroBatchServer
    from unigen_tpu_torch.utils import param_bytes

    cfg = presets.sd35_medium()
    torch.cuda.synchronize()
    before_collect = torch.cuda.memory_allocated()
    print(f"# sd3_pipeline: {before_collect} bytes resident at the phase's start, "
          "before gc.collect()", flush=True)
    gc.collect()             # earlier phases' tensors that only reference cycles hold
    torch.cuda.synchronize()
    phase_start = torch.cuda.memory_allocated()
    t0 = time.time()
    written = write_sd3_checkpoint(torch, dev, root, cfg, seed)
    write_s = time.time() - t0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    with load_timer(torch, stats):
        pipe = load_sd3_pipeline(str(root), adapter_dir=str(root / "adapter"),
                                 dtype=torch.bfloat16, quantize="w4a8", quantize_text="w4a8",
                                 device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    set_stub_tokenizers(pipe, seed)
    pipe._prompt_cache = caching.PromptLRU(64)
    te = pipe.text_encoders
    emit(dict(phase="sd3_load", root=str(root), written_bytes=written, write_s=write_s,
              load_s=load_s, phase_start_bytes=phase_start,
              before_collect_bytes=before_collect, **stats,
              transformer_bytes=param_bytes(pipe.params),
              text_bytes={k: param_bytes(v[0]) for k, v in te.items()},
              vae_bytes=param_bytes(pipe.vae_params)))
    t0 = time.time()
    compared, differ = sd3_load_check(torch, root, pipe, dev)
    emit(dict(phase="sd3_load_check",
              reference="quantize_tree_streaming(donate=False) of the quantize=None load",
              leaves=compared, differ=differ, s=time.time() - t0))
    if differ or not compared:
        raise SystemExit(f"sd3_load_check: the loaded and the undonated quantization differ "
                         f"at {differ[:8]}")

    res, steps, guidance = PIPE_RES, SD3_PIPE_STEPS, SD3_PIPE_GUIDANCE
    host = torch.Generator().manual_seed(seed + 11)
    pixels = [torch.rand(1, 3, res, res, generator=host) * 2 - 1 for _ in range(N_REQUESTS)]
    s_img = (res // pipe.vae_cfg.downscale // cfg.sd3.patch_size) ** 2
    neg = pipe.encode_prompt(SD3_NEGATIVE)
    cond = pipe.encode_condition_prompt("depth")
    per_prompt = text_launches(*(te[k][0] for k in ("clip_l", "clip_g", "t5")))
    # warm-up: a b=2 generate on the control cache with cfg_cache runs the
    # full and the half-batch replay forwards and the VAE
    e, p = pipe.encode_prompt(["warm-up a", "warm-up b"])
    pipe.generate(prompt_embeds=e, pooled=p, cond_pooled=torch.cat([cond, cond]),
                  neg_embeds=torch.cat([neg[0], neg[0]]), neg_pooled=torch.cat([neg[1], neg[1]]),
                  control_pixels=torch.cat(pixels[:BATCH]), height=res, width=res,
                  num_inference_steps=2, guidance_scale=guidance,
                  control_cache_interval=2, cfg_cache=True)
    torch.cuda.synchronize()

    lines = {}
    for run_no, (name, knobs) in itertools.product(range(1, SD3_PIPE_RUNS + 1), SD3_PIPE_MODES):
        mode = resolve_cache_mode(steps, family="sd3", **knobs)
        refreshes, stages, held = [], {}, []

        def run(x, knobs=knobs):
            out = pipe.generate(**x, height=res, width=res, num_inference_steps=steps,
                                guidance_scale=guidance, **knobs)
            refreshes.append((x["pooled"].shape[0], pipe.last_cache_refreshes))
            return out

        srv = MicroBatchServer(run, batch_size=BATCH, max_wait_ms=50)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launch_counts()
        misses = pipe._prompt_cache.misses
        try:
            with stage_timer(torch, pipe, stages), residual_probe(pipe, held):
                t0 = time.perf_counter()
                enc_start = torch.cuda.Event(enable_timing=True)
                enc_end = torch.cuda.Event(enable_timing=True)
                enc_start.record()
                reqs = []
                for r in range(N_REQUESTS):
                    e, p = pipe.encode_prompt(f"{name} run {run_no} request {r}: "
                                              "a photo of a red cube")
                    ne, npool = pipe.encode_prompt(SD3_NEGATIVE)
                    reqs.append(dict(prompt_embeds=e, pooled=p, neg_embeds=ne,
                                     neg_pooled=npool,
                                     cond_pooled=pipe.encode_condition_prompt("depth"),
                                     control_pixels=pixels[r]))
                enc_end.record()
                outs = [f.result(timeout=900) for f in [srv.submit(**r) for r in reqs]]
                wall = time.perf_counter() - t0
        finally:
            srv.close()
        launches = nonzero(launch_counts())
        peak = torch.cuda.max_memory_allocated()
        ms = stage_ms(torch, stages)
        ms["prompt_encoding"] = enc_start.elapsed_time(enc_end)
        kinds = [(b, *step_kinds(mode, ref, steps)) for b, ref in refreshes]
        encodes = pipe._prompt_cache.misses - misses
        want = add_counts((1, expected_sd3_pipeline_launches(pipe.params, cfg,
                                                             [k[:3] for k in kinds])),
                          (encodes, per_prompt))
        cached = mode.hybrid or not (mode.exact or mode.model_cache)
        line = dict(phase="sd3_pipeline", mode=name, run=run_no, knobs=knobs,
                    requests=N_REQUESTS, batches=srv.stats.batches, steps=steps,
                    guidance=guidance, resolution=res, wall_ms=wall * 1e3,
                    images_per_s=N_REQUESTS / wall, stage_ms=ms,
                    steps_per_batch=[dict(batch=b, n_full=f, n_base=n, n_skip=s)
                                     for b, f, n, s in kinds],
                    residual_cache_bytes=max(held, default=0),
                    residual_cache_bytes_formula=(
                        sd3_residual_cache_bytes(cfg, BATCH, s_img, mode.bits)
                        if cached else 0),
                    residual_bits=mode.bits if cached else None, prompt_encodes=encodes,
                    phase_start_bytes=phase_start, resident_bytes=resident,
                    peak_bytes=peak, peak_above_phase_start_bytes=peak - phase_start,
                    peak_above_resident_bytes=peak - resident,
                    launches=launches, expected_launches=want,
                    out_shape=list(outs[0].shape))
        emit(line)
        lines.setdefault(name, []).append(line)
        for o in outs:
            if o.dtype != torch.uint8 or tuple(o.shape) != (1, res, res, 3):
                raise SystemExit(f"sd3_pipeline {name}: bad output {o.dtype} {tuple(o.shape)}")
        if launches != want or srv.stats.batches != N_REQUESTS // BATCH \
                or encodes != N_REQUESTS:
            raise SystemExit(f"sd3_pipeline {name}: launches {launches} != expected {want} "
                             f"({srv.stats.batches} batches, {encodes} encodes, "
                             f"steps {kinds})")
        if bool(held) != cached:
            raise SystemExit(f"sd3_pipeline {name}: {len(held)} residual captures in a "
                             f"{'cached' if cached else 'cache-free'} mode")

    # path check: every kernel call of one CFG forward, one T5 and one CLIP-G
    # encode against its plain version, with the W4A8 shapes they ran
    e, p = pipe.encode_prompt("a photo of a red cube")
    control_lat = pipe.encode_control(pixels[0].to(dev))
    fwd = sd3_pipeline_forward(torch, pipe, e, p, cond, control_lat, seed)
    ids_t5 = tokenize(te["t5"][2], ["a photo of a red cube"], 256)
    ids_g = tokenize(te["clip_g"][2], ["a photo of a red cube"], 77)
    kernel_path_check(torch, "sd3_pipeline_path_check", (
        ("cfg_forward", fwd, sd3_forward_launches_quantized(pipe.params, cfg, 2)),
        ("t5_encode", lambda: t5_encode(te["t5"][0], te["t5"][1], ids_t5),
         text_launches(te["t5"][0])),
        ("clip_g_encode", lambda: clip_encode(te["clip_g"][0], te["clip_g"][1], ids_g)[2],
         text_launches(te["clip_g"][0]))))

    # profile: device time by group of a CFG forward at the served batch (two
    # requests) and of the cfg_cache replay step on its positive half
    e2, p2 = pipe.encode_prompt(["profiled prompt a", "profiled prompt b"])
    with torch.no_grad():
        for replay in (False, True):
            device_breakdown(torch, sd3_pipeline_forward(
                torch, pipe, e2, p2, torch.cat([cond, cond]),
                torch.cat([control_lat, control_lat]), seed, replay=replay),
                phase="sd3_pipeline_profile", forward="cfg_cache replay" if replay else "cfg",
                forward_batch=2 if replay else 4)

    # composition: a "balanced" generate against its forward calls written out
    one = dict(prompt_embeds=e, pooled=p, cond_pooled=cond, neg_embeds=neg[0],
               neg_pooled=neg[1], control_pixels=pixels[0], height=res, width=res,
               num_inference_steps=steps, guidance_scale=guidance, seed=seed)
    reset_launch_counts()
    balanced = pipe.generate(**one, quality_profile="balanced")
    gen_launches = nonzero(launch_counts())
    refreshes = pipe.last_cache_refreshes
    pipe.denoise = composed_balanced_sd3
    reset_launch_counts()
    try:
        by_hand = pipe.generate(**one)
    finally:
        del pipe.denoise
    hand_launches = nonzero(launch_counts())
    want = expected_sd3_pipeline_launches(pipe.params, cfg, [(1, *refreshes)])
    emit(dict(phase="sd3_pipeline_composition", mode="balanced",
              same_bits=torch.equal(balanced, by_hand), refreshes=list(refreshes),
              launches=gen_launches, composition_launches=hand_launches,
              expected_launches=want))
    if not torch.equal(balanced, by_hand) or not gen_launches == hand_launches == want:
        raise SystemExit("sd3_pipeline: balanced generate differs from its composition")
    del pipe
    torch.cuda.empty_cache()
    return lines["exact"][0]["launches"]


def link_component(src, dst, config):
    """A component directory whose weight files are symlinks to ``src``'s,
    with its own config.json."""
    dst.mkdir(parents=True, exist_ok=True)
    for f in src.iterdir():
        if f.suffix == ".safetensors":
            (dst / f.name).symlink_to(f.resolve())
    (dst / "config.json").write_text(json.dumps(config))


def write_flux_checkpoint(torch, dev, root, cfg, seed, sd3_root):
    """A random FLUX.1 directory of ``cfg``'s sizes: the transformer (bf16,
    two shards) and the reference's adapter in its ``{module}_weights_{idx}
    .bin`` layout drawn on ``dev`` from ``seed``, their linears as the port's
    linear init draws them (N(0, 0.02) weights of this width lose to int4
    codes what a trained or torch-initialized linear does not, so the
    validation's W4A8 fidelity gate would measure the draw; PERF §7); the
    VAE, CLIP-L and T5
    weights linked from the SD3 directory ``sd3_root`` with FLUX's configs
    (the VAE's FLUX scaling; CLIP-L keeps its projection, which the loader
    reads where the file holds it). -> bytes per written component."""
    bb = cfg.flux
    shapes = flux_transformer_shapes(bb)
    adapter = flux_adapter_shapes(cfg)
    # the files and the serving-tree cache, well under half their size
    require_disk(root, checkpoint_bytes([(shapes, 2), (adapter, 2)]) * 3 // 2)
    gen = torch.Generator(device=dev).manual_seed(seed)
    written = {"transformer": write_component(
        torch, root / "transformer", shapes, torch.bfloat16, gen, dev,
        dict(_class_name="FluxTransformer2DModel", in_channels=bb.in_channels,
             num_layers=bb.num_layers, num_single_layers=bb.num_single_layers,
             attention_head_dim=bb.attention_head_dim,
             num_attention_heads=bb.num_attention_heads,
             joint_attention_dim=bb.joint_attention_dim,
             pooled_projection_dim=bb.pooled_projection_dim,
             guidance_embeds=bb.guidance_embeds, axes_dims_rope=list(bb.axes_dims_rope)),
        shards=2, stem="diffusion_pytorch_model", uniform=True)}
    written["adapter"] = write_reference_adapter_bins(torch, root / "adapter", adapter,
                                                      torch.bfloat16, gen, dev, uniform=True)
    text = sd3_text_configs()
    import dataclasses
    flux_vae = dataclasses.replace(sd3_vae_config(), scaling_factor=0.3611, shift_factor=0.1159)
    link_component(sd3_root / "vae", root / "vae", vae_config_json(flux_vae))
    link_component(sd3_root / "text_encoder", root / "text_encoder", text["text_encoder"][1])
    link_component(sd3_root / "text_encoder_3", root / "text_encoder_2",
                   text["text_encoder_3"][1])
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 1.0,
         "use_dynamic_shifting": False}))
    return written


def trees_equal(torch, a, b):
    """-> (leaves compared, paths whose leaves differ in dtype, shape or
    bits)."""
    from unigen_tpu_torch.utils import tree_leaves_with_path
    want = dict(tree_leaves_with_path(b))
    got = dict(tree_leaves_with_path(a))
    differ = sorted(".".join(p) for p in set(want) ^ set(got))
    differ += [".".join(p) for p, t in got.items() if p in want and (
        t.dtype != want[p].dtype or not torch.equal(t, want[p]))]
    return len(got), differ


def phase_load_flux(torch, dev, seed, root, sd3_root):
    """4e. load_flux_pipeline at full FLUX width and a reduced depth
    (LOAD_FLUX_DEPTH): a random transformer directory and the reference's
    .bin adapter, 8c's VAE, CLIP-L and T5 files; loaded twice as W4A8 with
    W4A8 text towers through a serving-tree cache (the cold start, then the
    restart from the cache, which must give the same tree bit for bit);
    two requests through the loaded pipeline's __call__ with stub
    tokenizers; every kernel call of one forward and one T5 encode at
    M = 512 against its plain version."""
    import dataclasses

    from unigen_tpu_torch import presets
    from unigen_tpu_torch.models.t5_text import t5_encode
    from unigen_tpu_torch.models.text_encoder import tokenize
    from unigen_tpu_torch.pipelines import caching
    from unigen_tpu_torch.pipelines.loading import load_flux_pipeline
    from unigen_tpu_torch.utils import param_bytes

    full = presets.flux_full()
    n_double, n_single = LOAD_FLUX_DEPTH
    cfg = dataclasses.replace(full, flux=dataclasses.replace(
        full.flux, num_layers=n_double, num_single_layers=n_single))
    t0 = time.time()
    written = write_flux_checkpoint(torch, dev, root, cfg, seed, sd3_root)
    write_s = time.time() - t0
    cache = root / "serving_cache"
    loads = []
    for start in ("cold", "restart_from_cache"):
        stats = {}
        torch.cuda.synchronize()
        t0 = time.time()
        with load_timer(torch, stats):
            pipe = load_flux_pipeline(str(root), adapter_dir=str(root / "adapter"),
                                      quantize="w4a8", quantize_text="w4a8",
                                      serving_cache=str(cache), device=dev)
        torch.cuda.synchronize()
        loads.append((pipe, dict(start=start, s=time.time() - t0, **stats)))
    (first, cold), (pipe, warm) = loads
    compared, differ = trees_equal(torch, pipe.params, first.params)
    cache_bytes = sum(f.stat().st_size for f in cache.iterdir())
    del first, loads
    torch.cuda.empty_cache()
    emit(dict(phase="load_flux", depth=list(LOAD_FLUX_DEPTH), written_bytes=written,
              write_s=write_s, cold=cold, restart=warm, serving_cache_bytes=cache_bytes,
              transformer_bytes=param_bytes(pipe.params),
              text_bytes={"clip": param_bytes(pipe.clip_params),
                          "t5": param_bytes(pipe.t5_params)},
              restart_same_tree=not differ, leaves=compared))
    if differ or not compared:
        raise SystemExit(f"load_flux: the serving-cache restart differs from the cold "
                         f"load at {differ[:8]}")

    pipe.tokenizer = SeededTokenizer(pipe.clip_cfg.vocab_size, pipe.clip_cfg.vocab_size - 1,
                                     seed)
    pipe.tokenizer_2 = SeededTokenizer(pipe.t5_cfg.vocab_size, 1, seed + 1)
    pipe._prompt_cache = caching.PromptLRU(64)
    host = torch.Generator().manual_seed(seed + 13)
    pixels = [torch.rand(1, 3, PIPE_RES, PIPE_RES, generator=host) * 2 - 1
              for _ in range(3)]
    kw = dict(height=PIPE_RES, width=PIPE_RES, num_inference_steps=STEPS)
    pipe("warm-up", "canny", pixels[2], **kw)
    torch.cuda.synchronize()
    per_prompt = text_launches(pipe.clip_params, pipe.t5_params)
    stages = {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    misses = pipe._prompt_cache.misses
    with stage_timer(torch, pipe, stages):
        t0 = time.perf_counter()
        outs = [pipe(f"loaded request {r}: a photo of a red cube", "canny", pixels[r], **kw)
                for r in range(2)]
        wall = time.perf_counter() - t0
    launches = nonzero(launch_counts())
    encodes = pipe._prompt_cache.misses - misses
    want = add_counts((1, expected_pipeline_launches(pipe.params, cfg, [(1, STEPS, 0)] * 2)),
                      (encodes, per_prompt))
    line = dict(phase="load_flux_requests", requests=2, steps=STEPS, resolution=PIPE_RES,
                wall_ms=wall * 1e3, images_per_s=2 / wall, stage_ms=stage_ms(torch, stages),
                prompt_encodes=encodes, peak_bytes=torch.cuda.max_memory_allocated(),
                launches=launches, expected_launches=want, out_shape=list(outs[0].shape))
    emit(line)
    if launches != want or encodes != 2 or any(
            o.dtype != torch.uint8 or tuple(o.shape) != (1, PIPE_RES, PIPE_RES, 3)
            for o in outs):
        raise SystemExit(f"load_flux: launches {launches} != expected {want} or bad "
                         f"outputs ({encodes} encodes)")

    path = {}
    ids = tokenize(pipe.tokenizer_2, ["a photo of a red cube"], 512)
    e, p = pipe.encode_prompt("a photo of a red cube")
    c = pipe.encode_condition_prompt("canny")
    for what, call, want in (
            ("forward", lambda: pipe.generate(prompt_embeds=e, pooled=p, cond_pooled=c,
                                              control_pixels=pixels[0], height=PIPE_RES,
                                              width=PIPE_RES, num_inference_steps=1),
             expected_launches(pipe.params, cfg, 1)),
            ("t5_encode", lambda: t5_encode(pipe.t5_params, pipe.t5_cfg, ids),
             text_launches(pipe.t5_params))):
        checks = {}
        with torch.no_grad(), shadowed_kernels(torch, checks):
            call()
        summary = path_check_summary(checks)
        path[what] = dict(summary, w4a8_shapes=shape_counts(checks.get("w4a8_matmul", [])))
        calls = {n: c["calls"] for n, c in summary.items()}
        expected = {n: v for n, v in nonzero(want).items()
                    if n in ("flash_attention_rope", "flash_attention", "w4a8_matmul",
                             "quantize_act")}
        if any(c["disagree"] for c in summary.values()) or calls != expected:
            raise SystemExit(f"load_flux_path_check {what}: {summary} (expected {expected})")
    emit(dict(phase="load_flux_path_check", **path))
    del pipe
    torch.cuda.empty_cache()
    return line


def write_subjects200k(root, n, res, seed, test=0):
    """A Subjects-200K-layout dataset of ``n`` items (score_5/itemNNN_target_0
    .jpg, its pre-rendered depth_large condition and description sidecar)
    of seeded random res x res images, the first ``test`` of them listed in
    the held-out split (test_infos/depth_subject_pose.txt). -> bytes
    written."""
    import numpy as np
    from PIL import Image
    rng = np.random.default_rng(seed)
    (root / "score_5").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        stem = root / "score_5" / f"item{i:03d}"
        for kind in ("target", "depth_large"):
            Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)).save(
                f"{stem}_{kind}_0.jpg")
        Path(f"{stem}_target_0.json").write_text(
            json.dumps({"description": f"item {i}: a photo of a red cube"}))
    if test:
        (root / "test_infos").mkdir(exist_ok=True)
        (root / "test_infos" / "depth_subject_pose.txt").write_text(
            "".join(f"item{i:03d}_target_0.jpg\n" for i in range(test)))
    return sum(f.stat().st_size for f in (root / "score_5").iterdir())


@contextlib.contextmanager
def timed_methods(cls, names, log):
    """Time every call of ``cls``'s methods ``names`` (seconds appended to
    ``log[name]``), restored on exit."""
    saved = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(self, *a, **kw):
            import torch
            t0 = time.time()
            out = fn(self, *a, **kw)
            torch.cuda.synchronize()
            log.setdefault(name, []).append(time.time() - t0)
            return out
        return timed
    for n in names:
        setattr(cls, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def phase_train_cli(torch, dev, seed, root):
    """4f. The training entry point (``unigen_tpu_torch.cli.train.main``) on
    4e's FLUX directory (full width, LOAD_FLUX_DEPTH blocks, the
    reference's .bin adapter, loaded in bf16 with seeded stub tokenizers
    and handed to main) and a Subjects-200K-layout dataset under build/
    with pre-rendered depth conditions: LoRA rank LORA_RANK, CLI_STEPS
    steps with a checkpoint every CLI_SAVE; a second main resumes to
    CLI_RESUME_TO; a third finds the run complete; then
    load_flux_pipeline(..., lora_dir=...) serves one request with the
    exported adapter on the W4A8 tree."""
    import shutil

    from unigen_tpu_torch.cli import train as cli
    from unigen_tpu_torch.pipelines import caching
    from unigen_tpu_torch.pipelines.loading import load_flux_pipeline
    from unigen_tpu_torch.train import checkpoint as ckpt_lib
    from unigen_tpu_torch.train.loop import Trainer

    data, work = CHECKPOINTS / "subjects200k", CHECKPOINTS / "train_cli"
    shutil.rmtree(data, ignore_errors=True)
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    data_bytes = write_subjects200k(data, CLI_ITEMS, PIPE_RES, seed)
    data_s = time.time() - t0

    def stubbed(pipe):
        pipe.tokenizer = SeededTokenizer(pipe.clip_cfg.vocab_size,
                                         pipe.clip_cfg.vocab_size - 1, seed)
        pipe.tokenizer_2 = SeededTokenizer(pipe.t5_cfg.vocab_size, 1, seed + 1)
        pipe._prompt_cache = caching.PromptLRU(64)
        return pipe
    t0 = time.time()
    pipe = stubbed(load_flux_pipeline(str(root), adapter_dir=str(root / "adapter"),
                                      condition_types=("depth",), dtype=torch.bfloat16,
                                      device=dev))
    torch.cuda.synchronize()
    load_s = time.time() - t0

    def argv(steps):
        return ["--pretrained_model_name_or_path", str(root), "--data_path", str(data),
                "--dataset_name", "Subjects200K", "--condition_types", "depth",
                "--rank", str(LORA_RANK), "--train_batch_size", str(BATCH),
                "--resolution", str(PIPE_RES), "--max_train_steps", str(steps),
                "--checkpointing_steps", str(CLI_SAVE), "--lr_scheduler", "constant",
                "--work_dir", str(work), "--seed", str(seed)]
    runs, log = [], {}
    with timed_methods(Trainer, ("save", "maybe_resume", "step"), log):
        for steps in (CLI_STEPS, CLI_RESUME_TO, CLI_RESUME_TO):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            trainer = cli.main(argv(steps), pipeline=pipe)
            torch.cuda.synchronize()
            runs.append(dict(max_train_steps=steps, s=time.time() - t0,
                             peak_bytes=torch.cuda.max_memory_allocated(),
                             global_step=None if trainer is None else trainer.global_step,
                             prefetcher=None if trainer is None else trainer.prefetcher.stats(),
                             latest=ckpt_lib.latest_step(str(work))))
            del trainer
    ckpts = sorted(d.name for d in work.iterdir() if d.name.startswith("step_"))
    ckpt_bytes = sum(f.stat().st_size for f in (work / ckpts[0]).iterdir())
    adapter = work / "lora_adapters" / "depth" / "pytorch_lora_weights.safetensors"
    step_s = log.get("step", [])
    line = dict(phase="train_cli", depth=list(LOAD_FLUX_DEPTH), rank=LORA_RANK,
                micro_batch=BATCH, resolution=PIPE_RES, dataset_items=CLI_ITEMS,
                dataset_bytes=data_bytes, dataset_write_s=data_s, pipeline_load_s=load_s,
                runs=runs, step_s=step_s, s_per_step=statistics.median(step_s[1:] or step_s),
                checkpoints=ckpts, checkpoint_bytes=ckpt_bytes, save_s=log.get("save"),
                resume_s=log.get("maybe_resume"), adapter_bytes=adapter.stat().st_size)
    emit(line)
    want = [CLI_STEPS, CLI_RESUME_TO, None]
    if [r["global_step"] for r in runs] != want or runs[-1]["latest"] != CLI_RESUME_TO \
            or runs[1]["prefetcher"]["batches"] != CLI_RESUME_TO - CLI_STEPS:
        raise SystemExit(f"train_cli: runs {runs} (expected global steps {want})")
    del pipe
    torch.cuda.empty_cache()

    served = stubbed(load_flux_pipeline(str(root), adapter_dir=str(root / "adapter"),
                                        condition_types=("depth",), quantize="w4a8",
                                        quantize_text="w4a8", device=dev,
                                        lora_dir=str(work / "lora_adapters")))
    px = torch.rand(1, 3, PIPE_RES, PIPE_RES, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    t0 = time.time()
    img = served("a photo of a red cube", "depth", px, height=PIPE_RES, width=PIPE_RES,
                 num_inference_steps=STEPS)
    torch.cuda.synchronize()
    active = served._lora.active
    emit(dict(phase="train_cli_serve", adapters=sorted(served._lora.adapters), active=active,
              request_s=time.time() - t0, out_shape=list(img.shape), dtype=str(img.dtype)))
    if active != (("depth", 1.0),) or img.dtype != torch.uint8 or \
            tuple(img.shape) != (1, PIPE_RES, PIPE_RES, 3):
        raise SystemExit(f"train_cli_serve: adapter {active}, output {img.dtype} "
                         f"{tuple(img.shape)}")
    del served
    torch.cuda.empty_cache()
    return line


# ------------------------------------------------------------ the entry points

def vgg16_features_shapes():
    """torchvision ``vgg16().features``' state-dict shapes (the pools and
    relus take index slots)."""
    from unigen_tpu_torch.models.vgg import VGG16_CFG
    shapes, idx, c_in = {}, 0, 3
    for c in VGG16_CFG:
        if c == "M":
            idx += 1
            continue
        shapes[f"features.{idx}.weight"] = (c, c_in, 3, 3)
        shapes[f"features.{idx}.bias"] = (c,)
        c_in, idx = c, idx + 2
    return shapes


def write_vgg16_features(torch, path, seed, device):
    """A random torchvision-layout VGG16 ``features`` state dict (He-normal
    weights, small biases) drawn on ``device``, ``torch.save``d to ``path``.
    -> (parameters, bytes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sd = {}
    for name, shape in vgg16_features_shapes().items():
        t = torch.randn(shape, generator=gen, device=device)
        scale = math.sqrt(2.0 / math.prod(shape[1:])) if len(shape) > 1 else 0.01
        sd[name] = (t * scale).cpu()
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)
    return sum(t.numel() for t in sd.values()), path.stat().st_size


def depth_anything_shapes(cfg, grid):
    """transformers DepthAnythingForDepthEstimation's state-dict shapes for
    ``cfg`` (a models/depth.DepthAnythingConfig) with a ``grid`` x ``grid``
    native position table."""
    d, f = cfg.hidden_size, cfg.fusion_hidden_size
    e = "backbone.embeddings"
    shapes = {f"{e}.cls_token": (1, 1, d), f"{e}.mask_token": (1, d),
              f"{e}.position_embeddings": (1, 1 + grid * grid, d),
              f"{e}.patch_embeddings.projection.weight": (d, 3, cfg.patch_size,
                                                          cfg.patch_size),
              f"{e}.patch_embeddings.projection.bias": (d,)}
    for i in range(cfg.num_layers):
        p = f"backbone.encoder.layer.{i}"
        for n in ("norm1", "norm2"):
            shapes.update({f"{p}.{n}.weight": (d,), f"{p}.{n}.bias": (d,)})
        for n in ("attention.attention.query", "attention.attention.key",
                  "attention.attention.value", "attention.output.dense"):
            shapes.update({f"{p}.{n}.weight": (d, d), f"{p}.{n}.bias": (d,)})
        shapes.update({f"{p}.layer_scale1.lambda1": (d,),
                       f"{p}.mlp.fc1.weight": (cfg.mlp_ratio * d, d),
                       f"{p}.mlp.fc1.bias": (cfg.mlp_ratio * d,),
                       f"{p}.mlp.fc2.weight": (d, cfg.mlp_ratio * d), f"{p}.mlp.fc2.bias": (d,),
                       f"{p}.layer_scale2.lambda1": (d,)})
    shapes.update({"backbone.layernorm.weight": (d,), "backbone.layernorm.bias": (d,)})
    for i, (c, factor) in enumerate(zip(cfg.neck_hidden_sizes, cfg.reassemble_factors)):
        p = f"neck.reassemble_stage.layers.{i}"
        shapes.update({f"{p}.projection.weight": (c, d, 1, 1), f"{p}.projection.bias": (c,)})
        if factor > 1:
            shapes.update({f"{p}.resize.weight": (c, c, int(factor), int(factor)),
                           f"{p}.resize.bias": (c,)})
        elif factor < 1:
            shapes.update({f"{p}.resize.weight": (c, c, 3, 3), f"{p}.resize.bias": (c,)})
    for i, c in enumerate(cfg.neck_hidden_sizes):
        shapes[f"neck.convs.{i}.weight"] = (f, c, 3, 3)
    for i in range(len(cfg.neck_hidden_sizes)):
        p = f"neck.fusion_stage.layers.{i}"
        shapes.update({f"{p}.projection.weight": (f, f, 1, 1), f"{p}.projection.bias": (f,)})
        for r in ("residual_layer1", "residual_layer2"):
            for cv in ("convolution1", "convolution2"):
                shapes.update({f"{p}.{r}.{cv}.weight": (f, f, 3, 3),
                               f"{p}.{r}.{cv}.bias": (f,)})
    h = cfg.head_hidden_size
    shapes.update({"head.conv1.weight": (f // 2, f, 3, 3), "head.conv1.bias": (f // 2,),
                   "head.conv2.weight": (h, f // 2, 3, 3), "head.conv2.bias": (h,),
                   "head.conv3.weight": (1, h, 1, 1), "head.conv3.bias": (1,)})
    return shapes


def depth_anything_value(torch, name, shape, gen, device):
    """A Depth-Anything tensor drawn so that the depth map is O(1): weights
    N(0, 1 / fan-in), norm weights and layer scales 1 + N(0, 0.1), biases
    N(0, 0.02), the class token and position table N(0, 1), the mask token
    0, the head's last bias 0.5."""
    if name.endswith("mask_token"):
        return torch.zeros(shape, device=device)
    t = torch.randn(shape, generator=gen, device=device)
    if name.endswith(("cls_token", "position_embeddings")):
        return t
    if name == "head.conv3.bias":
        return torch.full(shape, 0.5, device=device)
    if len(shape) > 1:
        return t / math.sqrt(math.prod(shape[1:]))
    if name.endswith("lambda1") or (name.endswith(".weight") and "norm" in name):
        return 1.0 + 0.1 * t
    return 0.02 * t


def depth_anything_config_json(cfg, grid):
    """transformers' config.json of a Depth-Anything directory of ``cfg``."""
    return {"architectures": ["DepthAnythingForDepthEstimation"],
            "model_type": "depth_anything",
            "backbone_config": {"model_type": "dinov2", "hidden_size": cfg.hidden_size,
                                "num_hidden_layers": cfg.num_layers,
                                "num_attention_heads": cfg.num_heads,
                                "mlp_ratio": cfg.mlp_ratio, "patch_size": cfg.patch_size,
                                "image_size": grid * cfg.patch_size,
                                "layerscale_value": 1.0,
                                "out_indices": list(cfg.out_indices),
                                "apply_layernorm": True, "reshape_hidden_states": False},
            "reassemble_factors": list(cfg.reassemble_factors),
            "neck_hidden_sizes": list(cfg.neck_hidden_sizes),
            "fusion_hidden_size": cfg.fusion_hidden_size,
            "head_hidden_size": cfg.head_hidden_size, "patch_size": cfg.patch_size,
            "depth_estimation_type": "relative", "max_depth": cfg.max_depth}


def write_depth_anything(torch, root, cfg, seed, device, grid=37):
    """A random Depth-Anything directory in transformers' layout
    (config.json + model.safetensors, fp32) of ``cfg``'s sizes, drawn on
    ``device`` (depth_anything_value). -> (parameters, bytes)."""
    shapes = depth_anything_shapes(cfg, grid)
    gen = torch.Generator(device=device).manual_seed(seed)
    fixed = {n: depth_anything_value(torch, n, s, gen, device) for n, s in shapes.items()}
    written = write_component(torch, root, shapes, torch.float32, gen, device,
                              depth_anything_config_json(cfg, grid), fixed=fixed)
    return sum(math.prod(s) for s in shapes.values()), written


def write_control_png(path, res, seed):
    """A seeded random res x res RGB control image."""
    import numpy as np
    from PIL import Image
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (res, res, 3), dtype=np.uint8)).save(path)
    return path


def read_png(torch, path):
    import numpy as np
    from PIL import Image
    return torch.from_numpy(np.asarray(Image.open(path).convert("RGB")).copy())


def code_diff(torch, a, b):
    """The largest uint8 difference of two images."""
    return int((a.int() - b.int()).abs().max())


def entry_infer_check(torch, pipe, single_argv, batch_argv):
    """``cli.infer``'s images against the SD3 pipeline's own call on the same
    loaded pipeline with the same arguments and seed: the single-prompt
    res.png (its control read and resized as the reference's infer does)
    and the first batch of the test split (the dataset's samples, seed
    --seed + 0). The CLI adds only I/O, so each must equal bit for bit.
    -> (images compared, their largest uint8 difference)."""
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.cli import infer as cli
    from unigen_tpu_torch.data import conditions as C
    from unigen_tpu_torch.data.datasets import Subjects200K
    a = cli.parse_args(single_argv)
    if pipe.cfg.family != "sd3":
        raise SystemExit("entry_infer_check holds the SD3 pipeline")
    kw = dict(condition_prompt=a.condition_types[0], height=a.resolution, width=a.resolution,
              num_inference_steps=a.num_inference_steps, guidance_scale=a.guidance_scale,
              conditioning_scale=a.conditioning_scale)
    img = np.asarray(Image.open(a.control_image[0]).convert("RGB")
                     .resize((a.resolution, a.resolution)))
    pairs = [(pipe(prompt=a.prompt, control_image=C.to_model_range(img)[None], seed=a.seed,
                   **kw)[0], Path(a.save_path) / "res.png")]
    b = cli.parse_args(batch_argv)
    ds = Subjects200K(b.data_path, b.condition_types[0], resolution=b.resolution,
                      split="test")
    samples = [ds[i] for i in range(min(b.batch_size, len(ds)))]
    ref = pipe(prompt=[s["descriptions"] for s in samples],
               control_image=np.stack([C.to_model_range(s["condition_image"])
                                       for s in samples]), seed=b.seed,
               **dict(kw, condition_prompt=[a.condition_types[0]] * len(samples)))
    pairs += [(ref[i], Path(b.save_path) / f"{i:05d}" / "res.png")
              for i in range(len(samples))]
    diffs = [code_diff(torch, want, read_png(torch, path)) for want, path in pairs]
    return len(pairs), max(diffs)


def served_inputs(torch, pipe, req, res):
    """A request line's inputs as the server's protocol defines them: the
    control image resized with Lanczos to [-1, 1], the prompt's embeddings
    and the condition name's pooled embedding."""
    import numpy as np
    from PIL import Image
    pil = Image.open(req["control"]).convert("RGB").resize((res, res), Image.LANCZOS)
    px = torch.from_numpy((np.asarray(pil, np.float32) / 127.5 - 1.0).transpose(2, 0, 1)[None]
                          .copy())
    e, p = pipe.encode_prompt(req["prompt"])
    return dict(prompt_embeds=e, pooled=p,
                cond_pooled=pipe.encode_condition_prompt(req["condition"]),
                control_pixels=px)


def stacked(torch, rows):
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def entry_serve_check(torch, pipe, batched, stepped, steps, res):
    """``cli.serve``'s PNGs against ``pipe.generate`` at the shapes they were
    served at. ``batched``: (request lines, batch size) of the
    request-batched run, whose batches are the lines in order; each PNG
    against generate of its batch, bit for bit. ``stepped``: (request lines,
    slots, the paths saved) of the --step-server run, where every exact tick
    runs all slots: each saved PNG against generate of all the lines at
    b = slots, with the server's per-request noise (its seed), each control
    VAE-encoded alone (as admission does) and each row decoded alone (as
    retirement does), each row routed by itself as the server routes it;
    the image of a cancelled request is not there.
    -> {run: (images compared, largest uint8 difference)}."""
    import dataclasses
    out = {}
    lines, b = batched
    diffs = []
    for i in range(0, len(lines), b):
        part = lines[i:i + b]
        imgs = pipe.generate(**stacked(torch, [served_inputs(torch, pipe, r, res)
                                               for r in part]),
                             height=res, width=res, num_inference_steps=steps)
        diffs += [code_diff(torch, imgs[j], read_png(torch, r["out"]))
                  for j, r in enumerate(part)]
    out["batched"] = (len(diffs), max(diffs))

    lines, slots, saved = stepped
    if len(lines) != slots or pipe.cfg.family != "sd3":
        raise SystemExit("entry_serve_check: an SD3 step-server run fills every slot once")
    dev, dt = pipe.device, pipe.dtype
    vs = pipe.vae_cfg.downscale
    shape = (1, pipe.cfg.sd3.in_channels, res // vs, res // vs)
    x = stacked(torch, [served_inputs(torch, pipe, r, res) for r in lines])
    x["latents"] = torch.cat([
        torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(r.get("seed", 0)),
                    device=dev, dtype=dt) for r in lines])
    encode, decode, cfg = pipe.encode_control, pipe.decode, pipe.cfg
    pipe.encode_control = lambda px: torch.cat([encode(px[i:i + 1].float())
                                                for i in range(px.shape[0])])
    pipe.decode = lambda lat: torch.cat([decode(lat[i:i + 1]) for i in range(lat.shape[0])])
    pipe.cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, moe=dataclasses.replace(cfg.control.moe, batch_mode="per_sample")))
    try:
        imgs = pipe.generate(**x, height=res, width=res, num_inference_steps=steps)
    finally:
        del pipe.encode_control, pipe.decode
        pipe.cfg = cfg
    diffs = [code_diff(torch, imgs[i], read_png(torch, r["out"]))
             for i, r in enumerate(lines) if r["out"] in saved]
    out["step_server"] = (len(diffs), max(diffs))
    return out


def entry_eval_check(card, cpu, rel=1e-4):
    """The evaluation CLI's aggregate on the card against the same run with
    --device cpu: the same keys and count, every number within ``rel`` of
    the CPU's (and 1e-6 absolute, for values at 0). -> {key: relative
    difference}; raises on a miss."""
    if card.keys() != cpu.keys() or card.get("count") != cpu.get("count"):
        raise SystemExit(f"entry_eval_check: {card} against {cpu}")
    diffs = {}
    for k, want in cpu.items():
        got = card[k]
        if isinstance(want, float):
            diffs[k] = abs(got - want) / max(abs(want), 1e-12)
            if not abs(got - want) <= rel * abs(want) + 1e-6:
                raise SystemExit(f"entry_eval_check: {k} {got} on the card, {want} on the "
                                 f"CPU (relative limit {rel})")
        elif got != want:
            raise SystemExit(f"entry_eval_check: {k} {got!r} != {want!r}")
    return diffs


def depth_condition_check(torch, params, params_cpu, cfg, imgs):
    """make_depth_fn on ``params``' device and on the CPU over ``imgs``
    (uint8 HWC): -> (ms per image on the device, the median after a
    warm-up; the largest uint8 difference from the CPU's; the output
    shape)."""
    from unigen_tpu_torch.data.conditions import make_depth_fn
    fn, fn_cpu = make_depth_fn(params, cfg), make_depth_fn(params_cpu, cfg)
    fn(imgs[0])
    times, diffs, shape = [], [], None
    for img in imgs:
        t0 = time.perf_counter()
        got = fn(img)                 # a host array: the device work is done
        times.append(time.perf_counter() - t0)
        want = fn_cpu(img)
        shape = got.shape
        diffs.append(int(abs(got.astype(int) - want.astype(int)).max()))
        if got.dtype.name != "uint8" or got.shape != img.shape or want.std() == 0:
            raise SystemExit(f"depth_condition: output {got.dtype} {got.shape}, CPU std "
                             f"{want.std()}")
    return statistics.median(times) * 1e3, max(diffs), list(shape)


def serve_lines(root, n, res, seed, name, cond):
    """``n`` request lines of random control images under ``root``, each
    with its own seed."""
    return [dict(prompt=f"{name} request {i}: a photo of a red cube", condition=cond,
                 control=str(write_control_png(root / f"{name}_control_{i}.png", res,
                                               seed + 100 + i)),
                 out=str(root / f"{name}_{i}.png"), seed=i) for i in range(n)]


def percentiles(values):
    import numpy as np
    a = np.asarray(sorted(values), np.float64)
    return dict(p50=float(np.percentile(a, 50)), p95=float(np.percentile(a, 95)))


def phase_entry_points(torch, dev, seed, root, sd3_root, flux_root):
    """10. The user entry points on 8c's SD3.5-medium directory and 4e's FLUX
    directory (stub tokenizers put into each loaded pipeline):
    10a entry_infer: cli.infer (W4A8 SD3, 512^2, 28 steps, CFG 7) loaded
    once through cli.infer.load_pipeline, one single-prompt request, then
    the test split of a Subjects-200K-layout dataset in batches of 2;
    launches against the formula, entry_infer_check bit for bit, and the
    kernel calls of one CFG forward against their plain versions.
    10b entry_infer_flux: one cli.infer request on the FLUX directory.
    10c entry_serve: cli.serve on 10a's pipeline at its default 4 steps,
    request-batched (batch 2, four requests) and --step-server (4 slots,
    four requests, the last cancelled), entry_serve_check.
    10d entry_eval: cli.eval over 10a's batch output with --fid --dists on a
    random full-size VGG16 file, then --fid on a random Depth-Anything-small
    directory, each on the card and with --device cpu (entry_eval_check).
    10e depth_condition: make_depth_fn of that Depth-Anything tree on four
    512^2 images, on the card and on the CPU.
    -> {kernel: launches over 10a-10c}."""
    import io

    import numpy as np

    from unigen_tpu_torch.cli import eval as cli_eval
    from unigen_tpu_torch.cli import infer as cli_infer
    from unigen_tpu_torch.cli import serve as cli_serve
    from unigen_tpu_torch.io.torch_bridge import load_depth_anything, read_checkpoint_dir
    from unigen_tpu_torch.models.depth import DepthAnythingConfig
    from unigen_tpu_torch.pipelines import caching

    res, steps = PIPE_RES, SD3_PIPE_STEPS
    data = root / "subjects200k"
    write_subjects200k(data, ENTRY_SAMPLES, res, seed, test=ENTRY_SAMPLES)
    control = write_control_png(root / "control.png", res, seed)
    common = ["--basemodel", "UniGenSD3", "--pretrained_model_name_or_path", str(sd3_root),
              "--ckpt_path", str(sd3_root / "adapter"), "--condition_types", "depth",
              "--quantize", "w4a8", "--quantize_text", "w4a8", "--dtype", "bf16",
              "--resolution", str(res), "--num_inference_steps", str(steps),
              "--guidance_scale", str(SD3_PIPE_GUIDANCE), "--seed", str(seed),
              "--device", str(dev)]
    single = common + ["--prompt", "a photo of a red cube", "--control_image", str(control),
                       "--save_path", str(root / "infer_single")]
    batch = common + ["--data_path", str(data), "--batch_size", str(BATCH),
                      "--max_samples", str(ENTRY_SAMPLES), "--save_path",
                      str(root / "infer_batch")]
    totals = {}

    # 10a
    torch.cuda.synchronize()
    t0 = time.time()
    pipe = cli_infer.load_pipeline(cli_infer.parse_args(single))
    torch.cuda.synchronize()
    load_s = time.time() - t0
    set_stub_tokenizers(pipe, seed)
    pipe._prompt_cache = caching.PromptLRU(64)
    # the condition names, one and one a sample of a batch, cached first: the
    # misses then count the prompt encodes
    pipe.encode_condition_prompt("depth")
    pipe.encode_condition_prompt(["depth"] * BATCH)
    te = pipe.text_encoders
    per_prompt = text_launches(*(te[k][0] for k in ("clip_l", "clip_g", "t5")))
    runs = {}
    reset_launch_counts()
    misses = pipe._prompt_cache.misses
    for name, argv, images in (("single", single, 1), ("batch", batch, ENTRY_SAMPLES)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli_infer.main(argv, pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[name] = dict(images=images, wall_s=wall, images_per_s=images / wall)
    launches = nonzero(launch_counts())
    encodes = pipe._prompt_cache.misses - misses
    calls = [(1, steps, 0)] + [(BATCH, steps, 0)] * (ENTRY_SAMPLES // BATCH)
    want = add_counts((1, expected_sd3_pipeline_launches(pipe.params, pipe.cfg, calls)),
                      (encodes, per_prompt))
    emit(dict(phase="entry_infer", family="sd3", load_s=load_s, steps=steps, resolution=res,
              runs=runs, prompt_encodes=encodes, launches=launches, expected_launches=want))
    if launches != want or encodes != 1 + ENTRY_SAMPLES // BATCH:
        raise SystemExit(f"entry_infer: launches {launches} != expected {want} "
                         f"({encodes} encodes)")
    totals = add_counts((1, launches))
    t0 = time.time()
    compared, worst = entry_infer_check(torch, pipe, single, batch)
    emit(dict(phase="entry_infer_check", images=compared, max_code_diff=worst,
              s=time.time() - t0))
    if worst or compared != 1 + BATCH:
        raise SystemExit(f"entry_infer_check: {compared} images, largest difference {worst}")
    e, p = pipe.encode_prompt("a photo of a red cube")
    cond = pipe.encode_condition_prompt("depth")
    px = torch.rand(1, 3, res, res, generator=torch.Generator().manual_seed(seed)) * 2 - 1
    kernel_path_check(torch, "entry_infer_path_check", (
        ("cfg_forward", sd3_pipeline_forward(torch, pipe, e, p, cond,
                                             pipe.encode_control(px.to(dev)), seed),
         sd3_forward_launches_quantized(pipe.params, pipe.cfg, 2)),))

    # 10c (on 10a's pipeline, before it is freed for 10b)
    serve_root = root / "serve"
    batched = serve_lines(serve_root, SERVE_REQUESTS, res, seed, "batched", "depth")
    stepped = serve_lines(serve_root, STEPSERVE_SLOTS, res, seed, "stepped", "depth")
    serve_common = ["--family", "sd3", "--resolution", str(res), "--condition-types", "depth"]
    serve_runs = {}
    for name, argv, lines in (
            ("batched", serve_common + ["--batch-size", str(BATCH), "--max-wait-ms", "60000"],
             batched),
            ("step_server", serve_common + ["--step-server", "--batch-size",
                                            str(STEPSERVE_SLOTS)], stepped)):
        text = "".join(json.dumps(r) + "\n" for r in lines)
        if name == "step_server":
            text += json.dumps({"cancel": lines[-1]["out"]}) + "\n"
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summary = cli_serve.main(argv, pipeline=pipe, stdin=io.StringIO(text))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = nonzero(launch_counts())
        totals = add_counts((1, totals), (1, launches))
        lat = percentiles(summary["latency_s"].values())
        serve_runs[name] = summary
        emit(dict(phase="entry_serve", mode=name, requests=len(lines),
                  images=len(summary["saved"]), wall_s=wall,
                  images_per_s=len(summary["saved"]) / wall, latency_s=lat,
                  cancels=summary.get("cancels"), stats=summary["stats"], launches=launches))
        if any(not launches.get(k) for k in ("flash_attention", "w4a8_matmul", "quantize_act")):
            raise SystemExit(f"entry_serve {name}: a kernel of the path was not launched: "
                             f"{launches}")
    if serve_runs["batched"]["stats"]["batches"] != SERVE_REQUESTS // BATCH \
            or len(serve_runs["batched"]["saved"]) != SERVE_REQUESTS:
        raise SystemExit(f"entry_serve batched: {serve_runs['batched']['stats']}")
    if not serve_runs["step_server"]["cancels"].get(stepped[-1]["out"]) \
            or len(serve_runs["step_server"]["saved"]) != STEPSERVE_SLOTS - 1:
        raise SystemExit(f"entry_serve step_server: cancels "
                         f"{serve_runs['step_server']['cancels']}, saved "
                         f"{serve_runs['step_server']['saved']}")
    t0 = time.time()
    check = entry_serve_check(torch, pipe, (batched, BATCH),
                              (stepped, STEPSERVE_SLOTS, serve_runs["step_server"]["saved"]),
                              4, res)
    emit(dict(phase="entry_serve_check", s=time.time() - t0,
              **{k: dict(images=n, max_code_diff=d) for k, (n, d) in check.items()}))
    if check["batched"][1] or check["step_server"][1] > ENTRY_SERVE_CODES:
        raise SystemExit(f"entry_serve_check: {check}")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # 10b
    flux_argv = ["--basemodel", "UniGenFlux", "--pretrained_model_name_or_path", str(flux_root),
                 "--ckpt_path", str(flux_root / "adapter"), "--condition_types", "canny",
                 "--quantize", "w4a8", "--quantize_text", "w4a8", "--resolution", str(res),
                 "--num_inference_steps", str(STEPS), "--prompt", "a photo of a red cube",
                 "--control_image", str(control), "--save_path", str(root / "infer_flux"),
                 "--seed", str(seed), "--device", str(dev)]
    t0 = time.time()
    fpipe = cli_infer.load_pipeline(cli_infer.parse_args(flux_argv))
    torch.cuda.synchronize()
    load_s = time.time() - t0
    fpipe.tokenizer = SeededTokenizer(fpipe.clip_cfg.vocab_size, fpipe.clip_cfg.vocab_size - 1,
                                      seed)
    fpipe.tokenizer_2 = SeededTokenizer(fpipe.t5_cfg.vocab_size, 1, seed + 1)
    fpipe._prompt_cache = caching.PromptLRU(64)
    fpipe.encode_condition_prompt("canny")
    reset_launch_counts()
    misses = fpipe._prompt_cache.misses
    t0 = time.perf_counter()
    cli_infer.main(flux_argv, pipeline=fpipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nonzero(launch_counts())
    encodes = fpipe._prompt_cache.misses - misses
    want = add_counts((1, expected_pipeline_launches(fpipe.params, fpipe.cfg, [(1, STEPS, 0)])),
                      (encodes, text_launches(fpipe.clip_params, fpipe.t5_params)))
    img = read_png(torch, root / "infer_flux" / "res.png")
    emit(dict(phase="entry_infer_flux", depth=list(LOAD_FLUX_DEPTH), load_s=load_s,
              steps=STEPS, wall_s=wall, images_per_s=1 / wall, prompt_encodes=encodes,
              launches=launches, expected_launches=want, out_shape=list(img.shape)))
    if launches != want or tuple(img.shape) != (res, res, 3):
        raise SystemExit(f"entry_infer_flux: launches {launches} != expected {want}")
    totals = add_counts((1, totals), (1, launches))
    del fpipe
    gc.collect()
    torch.cuda.empty_cache()

    # 10d
    vgg_path = root / "vgg16_features.pth"
    depth_dir = root / "depth_anything_small"
    dcfg = DepthAnythingConfig()
    vgg_n, vgg_bytes = write_vgg16_features(torch, vgg_path, seed, dev)
    depth_n, depth_bytes = write_depth_anything(torch, depth_dir, dcfg, seed, dev)
    for name, flags in (("vgg16", ["--fid", "--dists", "--extractor", f"vgg16:{vgg_path}"]),
                        ("dinov2", ["--fid", "--extractor", f"dinov2:{depth_dir}"])):
        argv = ["--results_dir", str(root / "infer_batch")] + flags
        t0 = time.perf_counter()
        card = cli_eval.main(argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = cli_eval.main(argv + ["--device", "cpu"])
        cpu_s = time.perf_counter() - t0
        diffs = entry_eval_check(card, cpu, ENTRY_EVAL_REL)
        emit(dict(phase="entry_eval", extractor=name,
                  parameters=vgg_n if name == "vgg16" else depth_n,
                  file_bytes=vgg_bytes if name == "vgg16" else depth_bytes,
                  card_s=card_s, cpu_s=cpu_s, card=card, cpu=cpu, relative_diff=diffs,
                  limit=ENTRY_EVAL_REL))

    # 10e
    params = load_depth_anything(read_checkpoint_dir(str(depth_dir)), dcfg, device=dev)
    params_cpu = load_depth_anything(read_checkpoint_dir(str(depth_dir)), dcfg, device="cpu")
    rng = np.random.default_rng(seed + 7)
    imgs = [rng.integers(0, 256, (res, res, 3), dtype=np.uint8) for _ in range(DEPTH_IMAGES)]
    ms, worst, shape = depth_condition_check(torch, params, params_cpu, dcfg, imgs)
    emit(dict(phase="depth_condition", images=DEPTH_IMAGES, resolution=res,
              model_resolution=res // dcfg.patch_size * dcfg.patch_size,
              ms_per_image=ms, max_code_diff=worst, out_shape=shape))
    if worst > 1:
        raise SystemExit(f"depth_condition: {worst} codes from the CPU's")
    del params, params_cpu
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------ the SANA family

def sana_backbone():
    """Sana_1600M_1024px's transformer: 20 blocks, 2240 wide (70 x 32
    linear heads, 20 x 112 cross heads), caption 2304."""
    from unigen_tpu_torch import config as cfg_lib
    return cfg_lib.SanaBackboneConfig()


def sana_text_configs():
    """Gemma-2-2B (gemma_config_from_json's defaults) and CLIP-L, whose
    pooled 768 is SANA's pooled_projection_dim."""
    from unigen_tpu_torch.models.clip_text import CLIPTextConfig
    from unigen_tpu_torch.pipelines.loading import gemma_config_from_json
    return gemma_config_from_json({}), CLIPTextConfig()


def sana_dcae_config():
    """The DC-AE f32c32 (6 stages, 32x down, 32 latent channels)."""
    from unigen_tpu_torch.models import dcae
    return dcae.DCAEConfig()


def sana_config(per_sample=False):
    """The UniGen-SANA config: the default control branch (20 control
    blocks, one condition, 6 modulated experts, the shared expert); global
    routing as load_sana_pipeline builds it, or per-sample routing (the
    StepServer's)."""
    from unigen_tpu_torch import config as cfg_lib
    moe = cfg_lib.MoEConfig(batch_mode="per_sample" if per_sample else "global")
    return cfg_lib.UniGenConfig(family="sana", sana=sana_backbone(),
                                control=cfg_lib.ControlConfig(moe=moe),
                                condition_types=("canny",))


def sana_quantized_calls(params, cfg, leaf: str, replay: bool = False) -> int:
    """Calls of the quantized linears whose codes are ``leaf`` in one
    UniGen-SANA forward: the base blocks, the control blocks (one after
    each base block) and the add linears once per base block, the unused
    second shared-expert block never, any other once; a forward replaying
    cached control outputs (``replay``) runs the base and the add linears
    only."""
    from unigen_tpu_torch.utils import tree_leaves_with_path
    n = cfg.sana.num_layers
    uses = {("base", "blocks"): n, ("control", "blocks"): n, ("control", "add_blocks"): n}
    return sum(uses.get(path[:2], 1) for path, _ in tree_leaves_with_path(params)
               if path[-1] == leaf and path[:3] != ("control", "shared_expert", "block1")
               and not (replay and path[0] == "control" and path[1] != "add_blocks"))


def expected_sana_launches(params, cfg, replay: bool = False):
    """Kernel launches of one UniGen-SANA forward of a W4A8 / W8A8 tree (any
    batch): W4A8 and the activation quantization of every quantized linear.
    SANA's attention reaches no kernel (the linear attention is fp32
    products, the cross-attention the plain masked attention), as in JAX."""
    w4 = sana_quantized_calls(params, cfg, "w_q4", replay)
    return {"w4a8_matmul": w4, "w4a8_general": 0,
            "quantize_act": w4 + sana_quantized_calls(params, cfg, "w_q", replay)}


def expected_sana_pipeline_launches(params, cfg, kinds):
    """Launches of SANA denoise loops: ``kinds`` lists (batch, n_full,
    n_base) per loop; a full step one forward, a replaying step a replay
    forward, a skip step none."""
    parts = []
    for _, n_full, n_base in kinds:
        parts += [(n_full, expected_sana_launches(params, cfg)),
                  (n_base, expected_sana_launches(params, cfg, replay=True))]
    return add_counts(*parts)


def sana_forward_launches(params, cfg, calls):
    """Launches of the SANA forwards a server dispatched (rows, kind)."""
    return add_counts(*[(1, expected_sana_launches(params, cfg, kind == "replay"))
                        for _, kind in calls])


def sana_residual_cache_bytes(cfg, batch, s_img, bits, itemsize=2):
    """Bytes of the SANA control-output cache: one [n_base, B, S, D] stack
    in the pipeline's dtype, or int8 / packed int4 codes with an fp32 scale
    a token."""
    bb = cfg.sana
    per_token = {16: itemsize * bb.inner_dim, 8: bb.inner_dim + 4, 4: bb.inner_dim // 2 + 4}
    return bb.num_layers * batch * s_img * per_token[bits]


def tf32_flags(torch):
    """The TF32 switches the fp32 products and convolutions ran under."""
    return dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                cudnn=torch.backends.cudnn.allow_tf32)


def sana_world(torch, dev, seed, cfg):
    """The full-width SANA serving stack on the card from ``seed``: the
    UniGen-SANA tree (bf16, every leaf drawn, the add linears too) quantized
    by the loader's w4a8 policy (int4 base, int8 adapter), Gemma-2-2B (bf16)
    and CLIP-L (fp32) quantized by quantize_text="w4a8", the fp32 DC-AE.
    -> (params, gemma, gemma_cfg, clip, clip_cfg, dcae params, dcae cfg)."""
    from unigen_tpu_torch.io.from_jax import init_sana_serving_params
    from unigen_tpu_torch.models import clip_text, dcae, gemma_text
    from unigen_tpu_torch.pipelines.loading import _quantize_text, _quantize_unigen_tree
    tree = init_sana_serving_params(cfg, seed=seed, device=dev)
    base, control = _quantize_unigen_tree(tree["base"], tree["control"], "w4a8")
    gcfg, ccfg = sana_text_configs()
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    gemma = _quantize_text(gemma_text.init_gemma_params(gcfg, gen=g, device=dev,
                                                        dtype=torch.bfloat16), "w4a8")
    clip = _quantize_text(clip_text.init_clip_params(ccfg, gen=g, device=dev), "w4a8")
    ae_cfg = sana_dcae_config()
    ae = dcae.init_dcae_params(ae_cfg, gen=g, device=dev)
    return {"base": base, "control": control}, gemma, gcfg, clip, ccfg, ae, ae_cfg


def sana_pipeline(torch, dev, cfg, params, gemma, gcfg, clip, ccfg, ae, ae_cfg, seed):
    """UniGenSanaPipeline over these trees, bf16, seeded stub tokenizers,
    the prompt LRU on."""
    from unigen_tpu_torch.models import dcae
    from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline
    return UniGenSanaPipeline(
        cfg=cfg, params=params,
        ae_encode=functools.partial(dcae.dcae_encode, ae, ae_cfg),
        ae_decode=functools.partial(dcae.dcae_decode, ae, ae_cfg),
        ae_downscale=ae_cfg.downscale, gemma_cfg=gcfg, gemma_params=gemma,
        clip_cfg=ccfg, clip_params=clip,
        tokenizer=SeededTokenizer(gcfg.vocab_size, 1, seed + 32),
        tokenizer_clip=SeededTokenizer(ccfg.vocab_size, ccfg.vocab_size - 1, seed + 33),
        dtype=torch.bfloat16, prompt_cache_size=64, device=dev)


def sana_forward(torch, pipe, embeds, mask, pooled, cond_pooled, control_lat, seed,
                 replay=False):
    """One forward of the pipeline's tree at its shapes, at the first step of
    a SANA_STEPS schedule (noise from ``seed``); with ``replay`` the replay
    of that forward's captured control outputs."""
    from unigen_tpu_torch.models.sana import sana_unigen_forward
    from unigen_tpu_torch.pipelines import scheduling
    dev, dt = pipe.device, pipe.dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    lat = torch.randn(tuple(control_lat.shape), generator=g, device=dev, dtype=dt)
    lh, lw = control_lat.shape[2:]
    _, ts = scheduling.inference_sigmas(pipe.scheduler, SANA_STEPS, image_seq_len=lh * lw)
    t = torch.full((lat.shape[0],), float(ts[0] / 1000.0), dtype=dt, device=dev)
    args = (pipe.params, pipe.cfg, lat, control_lat, embeds, pooled, cond_pooled, t, mask)
    if not replay:
        return lambda: sana_unigen_forward(*args)[0]
    res = sana_unigen_forward(*args, return_control_residuals=True)[2]["control_residuals"]
    return lambda: sana_unigen_forward(*args, control_residuals=res)[0]


SANA_LABELS = ("sana linear attention", "sana cross-attention", "sana depthwise conv",
               "dc-ae")


@contextlib.contextmanager
def sana_ranges(torch, pipe):
    """Profiler ranges around the SANA blocks' linear attention, masked
    cross-attention and depthwise convolution (their module functions
    wrapped) and around the pipeline's DC-AE calls."""
    from unigen_tpu_torch.layers import blocks_sana
    targets = [(blocks_sana, "relu_linear_attention", SANA_LABELS[0]),
               (blocks_sana, "sdpa_xla", SANA_LABELS[1]),
               (blocks_sana, "depthwise_conv", SANA_LABELS[2])]
    saved = [(m, n, getattr(m, n)) for m, n, _ in targets]
    codec = pipe.ae_encode, pipe.ae_decode

    def labeled(fn, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run
    for m, n, label in targets:
        setattr(m, n, labeled(getattr(m, n), label))
    pipe.ae_encode, pipe.ae_decode = (labeled(pipe.ae_encode, SANA_LABELS[3]),
                                      labeled(pipe.ae_decode, SANA_LABELS[3]))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
        pipe.ae_encode, pipe.ae_decode = codec


def labeled_breakdown(torch, fn, labels):
    """Device time of one call of ``fn`` by group: the kernels that the
    torch ops inside each ``labels`` profiler range launched (the outermost
    range wins), then the rest by kernel name (W4A8, the activation
    quantization, library GEMMs such as W8A8's ``_int_mm``, convolutions,
    elementwise and other). -> (wall ms of an unprofiled call, {group: ms},
    device busy ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    inside, flat = {}, {}

    def visit(e, label):
        label = label or (e.name if e.name in labels else None)
        if label:
            for k in e.kernels:
                by = inside.setdefault(label, {})
                by[k.name] = by.get(k.name, 0.0) + k.duration
        for c in e.cpu_children:
            visit(c, label)
    for e in events:
        if e.device_type == cpu and e.cpu_parent is None:
            visit(e, None)
        elif e.device_type == cuda and e.name not in labels:
            # (a range's own span on the device timeline is not a kernel)
            flat[e.name] = flat.get(e.name, 0.0) + e.time_range.elapsed_us()
    groups = {label: sum(by.values()) / 1e3 for label, by in inside.items()}
    for name, us in flat.items():
        rest = us - sum(by.get(name, 0.0) for by in inside.values())
        g = conv_group(name)
        g = "library gemm (_int_mm)" if g == "library gemm" else g
        groups[g] = groups.get(g, 0.0) + max(rest, 0.0) / 1e3
    return wall_ms, groups, sum(flat.values()) / 1e3


def sana_requests(torch, dev, bb, n, res, seed, latent_shape, t_len=SANA_TXT):
    """``n`` b=1 requests drawn on the device from ``seed``: caption rows
    with a padding mask (a different count of tokens each), pooled rows,
    control pixels in [-1, 1] that bf16 represents exactly (the pipeline
    casts them to bf16 before its codec, the server does not), noise."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def mk(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    out = []
    for i in range(n):
        mask = torch.zeros((1, t_len), dtype=torch.int32, device=dev)
        mask[:, :1 + (17 + 37 * i) % (t_len - 1)] = 1
        px = (torch.rand(1, 3, res, res, generator=g, device=dev) * 2 - 1)
        out.append(dict(prompt_embeds=mk(1, t_len, bb.caption_channels), prompt_mask=mask,
                        pooled=mk(1, bb.pooled_projection_dim),
                        cond_pooled=mk(1, bb.pooled_projection_dim),
                        control_pixels=px.to(torch.bfloat16).float(),
                        latents=mk(1, *latent_shape)))
    return out


def phase_sana(torch, dev, seed):
    """9. The full-width SANA stack (sana_world) through UniGenSanaPipeline
    at SANA_RES^2, SANA_STEPS steps: in each mode of SANA_PIPE_MODES four
    b=1 requests with prompts through Gemma (300 tokens, padded) and CLIP,
    served by MicroBatchServer(batch_size=2); launches against
    expected_sana_pipeline_launches plus each encode's; sana_path_check (a
    full forward and a Gemma encode, every kernel call against its plain
    version); sana_profile. -> (the exact mode's launches, the trees)."""
    from unigen_tpu_torch.models.gemma_text import gemma_encode
    from unigen_tpu_torch.pipelines.caching import resolve_cache_mode
    from unigen_tpu_torch.serving import MicroBatchServer
    from unigen_tpu_torch.utils import param_bytes
    cfg = sana_config()
    bb = cfg.sana
    t0 = time.time()
    world = sana_world(torch, dev, seed, cfg)
    params, gemma, gcfg, clip, ccfg, ae, ae_cfg = world
    torch.cuda.synchronize()
    build_s = time.time() - t0
    pipe = sana_pipeline(torch, dev, cfg, *world, seed)
    res, steps = SANA_RES, SANA_STEPS
    s_img = (res // ae_cfg.downscale // bb.patch_size) ** 2
    host = torch.Generator().manual_seed(seed + 34)
    pixels = [torch.rand(1, 3, res, res, generator=host) * 2 - 1 for _ in range(N_REQUESTS)]
    per_gemma, per_clip = text_launches(gemma), text_launches(clip)
    # warm-up: a b=2 generate on the control cache (capture and replay
    # forwards, both codec directions, both encoders)
    e, m = pipe.encode_prompt(["warm-up a", "warm-up b"])
    p = pipe.encode_pooled(["warm-up a", "warm-up b"])
    pipe.generate(prompt_embeds=e, prompt_mask=m, pooled=p, cond_pooled=p,
                  control_pixels=torch.cat(pixels[:BATCH]), height=res, width=res,
                  num_inference_steps=2, control_cache_interval=2)
    torch.cuda.synchronize()
    print(f"# sana: stack built in {build_s:.1f}s, warm-up done", flush=True)

    lines = {}
    for name, knobs in SANA_PIPE_MODES:
        mode = resolve_cache_mode(steps, family="sana", **knobs)
        refreshes, stages, held = [], {}, []

        def run(x, knobs=knobs):
            out = pipe.generate(**x, height=res, width=res, num_inference_steps=steps,
                                **knobs)
            refreshes.append((x["pooled"].shape[0], pipe.last_cache_refreshes))
            return out

        srv = MicroBatchServer(run, batch_size=BATCH, max_wait_ms=50)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launch_counts()
        encodes = {"gemma": 0, "clip": 0}
        try:
            with stage_timer(torch, pipe, stages), residual_probe(pipe, held):
                t0 = time.perf_counter()
                enc_start = torch.cuda.Event(enable_timing=True)
                enc_end = torch.cuda.Event(enable_timing=True)
                enc_start.record()
                reqs = []
                for r in range(N_REQUESTS):
                    prompt = f"{name} request {r}: a photo of a red cube on a table"
                    before = pipe._prompt_cache.misses
                    emb, mask = pipe.encode_prompt(prompt, SANA_TXT)
                    mid = pipe._prompt_cache.misses
                    pooled, cpool = pipe.encode_pooled(prompt), pipe.encode_pooled("canny")
                    encodes["gemma"] += mid - before
                    encodes["clip"] += pipe._prompt_cache.misses - mid
                    reqs.append(dict(prompt_embeds=emb, prompt_mask=mask, pooled=pooled,
                                     cond_pooled=cpool, control_pixels=pixels[r]))
                enc_end.record()
                outs = [f.result(timeout=900) for f in [srv.submit(**x) for x in reqs]]
                wall = time.perf_counter() - t0
        finally:
            srv.close()
        launches = nonzero(launch_counts())
        peak = torch.cuda.max_memory_allocated()
        ms = stage_ms(torch, stages)
        ms["prompt_encoding"] = enc_start.elapsed_time(enc_end)
        kinds = [(b, *step_kinds(mode, ref, steps)) for b, ref in refreshes]
        want = add_counts((1, expected_sana_pipeline_launches(params, cfg,
                                                              [k[:3] for k in kinds])),
                          (encodes["gemma"], per_gemma), (encodes["clip"], per_clip))
        cached = mode.hybrid or not (mode.exact or mode.model_cache)
        pad = int((reqs[0]["prompt_mask"] == 0).sum())
        line = dict(phase="sana_pipeline", mode=name, knobs=knobs, requests=N_REQUESTS,
                    batches=srv.stats.batches, steps=steps, resolution=res,
                    text_tokens=SANA_TXT, first_prompt_padding_tokens=pad,
                    wall_ms=wall * 1e3, images_per_s=N_REQUESTS / wall, stage_ms=ms,
                    steps_per_batch=[dict(batch=b, n_full=f, n_base=n, n_skip=s)
                                     for b, f, n, s in kinds],
                    residual_cache_bytes=max(held, default=0),
                    residual_cache_bytes_formula=(
                        sana_residual_cache_bytes(cfg, BATCH, s_img, mode.bits)
                        if cached else 0),
                    residual_bits=mode.bits if cached else None, prompt_encodes=encodes,
                    resident_bytes=resident, peak_bytes=peak,
                    peak_above_resident_bytes=peak - resident, tf32=tf32_flags(torch),
                    launches=launches, expected_launches=want,
                    out_shape=list(outs[0].shape))
        emit(line)
        lines[name] = line
        for o in outs:
            if o.dtype != torch.uint8 or tuple(o.shape) != (1, res, res, 3):
                raise SystemExit(f"sana_pipeline {name}: bad output {o.dtype} {tuple(o.shape)}")
        if launches != want or srv.stats.batches != N_REQUESTS // BATCH \
                or encodes["gemma"] != N_REQUESTS or not pad:
            raise SystemExit(f"sana_pipeline {name}: launches {launches} != expected {want} "
                             f"({srv.stats.batches} batches, {encodes} encodes, "
                             f"{pad} padding tokens, steps {kinds})")
        if bool(held) != cached:
            raise SystemExit(f"sana_pipeline {name}: {len(held)} residual captures in a "
                             f"{'cached' if cached else 'cache-free'} mode")

    # path check: every kernel call of one b=2 forward and one Gemma encode
    # against its plain version, with the W4A8 shapes they ran
    e2, m2 = pipe.encode_prompt(["path check a", "path check b"], SANA_TXT)
    p2 = pipe.encode_pooled(["path check a", "path check b"])
    control_lat = pipe.encode_control(torch.cat(pixels[:BATCH]).to(dev))
    fwd = sana_forward(torch, pipe, e2, m2, p2, p2, control_lat, seed)
    ids = SeededTokenizer(gcfg.vocab_size, 1, seed)(["a photo of a red cube"],
                                                      max_length=SANA_TXT)
    path = {}
    with torch.no_grad():
        for what, call, want in (
                ("forward", fwd, expected_sana_launches(params, cfg)),
                ("gemma_encode", lambda: gemma_encode(gemma, gcfg, ids.input_ids,
                                                      torch.as_tensor(ids.attention_mask)),
                 per_gemma)):
            checks = {}
            with shadowed_kernels(torch, checks):
                out = call()
            summary = path_check_summary(checks)
            path[what] = dict(summary, expected_calls=nonzero(want),
                              w4a8_shapes=shape_counts(checks.get("w4a8_matmul", [])),
                              finite=bool(torch.isfinite(out.float()).all()))
            calls = {n: c["calls"] for n, c in summary.items()}
            if any(c["disagree"] for c in summary.values()) or not path[what]["finite"] \
                    or calls != {n: v for n, v in nonzero(want).items()
                                 if n != "w4a8_general"}:
                raise SystemExit(f"sana_path_check {what}: {summary} (expected {want})")
    emit(dict(phase="sana_path_check", **path))

    # profile: control encode, one b=2 forward and the decode, by group
    lat2 = torch.randn(tuple(control_lat.shape), generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev, dtype=pipe.dtype)
    px2 = torch.cat(pixels[:BATCH]).to(dev)
    with torch.no_grad(), sana_ranges(torch, pipe):
        wall_ms, groups, busy = labeled_breakdown(
            torch, lambda: (pipe.encode_control(px2), fwd(), pipe.decode(lat2)),
            SANA_LABELS)
        fwd_wall, fwd_groups, fwd_busy = labeled_breakdown(torch, fwd, SANA_LABELS)
    emit(dict(phase="sana_profile", what="DC-AE encode + one b=2 forward + DC-AE decode",
              wall_ms=wall_ms, device_busy_ms=busy, groups_ms=groups,
              forward=dict(wall_ms=fwd_wall, device_busy_ms=fwd_busy, groups_ms=fwd_groups),
              tf32=tf32_flags(torch), resident_bytes=param_bytes(params),
              gemma_bytes=param_bytes(gemma), clip_bytes=param_bytes(clip),
              dcae_bytes=param_bytes(ae)))
    return lines["exact"]["launches"], pipe


def sana_cut(cfg, params, depth):
    """The SANA config and a view of its tree cut to ``depth`` base and
    control blocks (the first of each stack, no copy)."""
    import dataclasses

    from unigen_tpu_torch.utils import tree_map

    def take(tree):
        return tree_map(lambda t: t[:depth], tree)
    base = dict(params["base"], blocks=take(params["base"]["blocks"]))
    ctrl = dict(params["control"], blocks=take(params["control"]["blocks"]),
                add_blocks=take(params["control"]["add_blocks"]))
    return (dataclasses.replace(cfg, sana=dataclasses.replace(cfg.sana, num_layers=depth),
                                control=dataclasses.replace(cfg.control, num_layers=depth)),
            {"base": base, "control": ctrl})


def sana_stream_finite(torch, cfg, params, req, dev):
    """One b=1 forward (the request's noise as latents and condition):
    whether the stream entering the output norm keeps a finite mean square
    in fp32 on every token, and the prediction is finite."""
    from unigen_tpu_torch.models import sana as sana_mod
    seen, real = [], sana_mod._output

    def probe(base, bb, h, *a):
        seen.append(bool(torch.isfinite(h.float().square().mean(-1)).all()))
        return real(base, bb, h, *a)
    lat = req["latents"]
    sana_mod._output = probe
    try:
        with torch.no_grad():
            pred = sana_mod.sana_unigen_forward(
                params, cfg, lat, lat, req["prompt_embeds"], req["pooled"],
                req["cond_pooled"], torch.full((1,), 0.5, dtype=lat.dtype, device=dev),
                req["prompt_mask"])[0]
    finally:
        sana_mod._output = real
    return seen[-1] and bool(torch.isfinite(pred.float()).all())


def sana_pipeline_finals(torch, pipe, reqs, knobs, res, steps, batch):
    """The pipeline's (final latents, images) of ``reqs`` with the server's
    ``knobs``, ``batch`` requests a generate; each control image encoded
    alone, as the server's admission encodes it."""
    got, real_decode, real_encode = [], pipe.decode, pipe.encode_control

    def keep(lat):
        got.append(lat)
        return real_decode(lat)

    def one_by_one(px):
        return torch.cat([real_encode(px[i:i + 1]) for i in range(px.shape[0])])
    pipe.decode, pipe.encode_control = keep, one_by_one
    imgs = []
    try:
        for i in range(0, len(reqs), batch):
            part = reqs[i:i + batch]
            x = {k: torch.cat([r[k] for r in part]) for k in part[0]}
            imgs.append(pipe.generate(**x, height=res, width=res,
                                      num_inference_steps=steps, **knobs))
    finally:
        del pipe.decode, pipe.encode_control
    return torch.cat(got), torch.cat(imgs)


def phase_stepserve_sana(torch, dev, pipe, seed):
    """9b. StepServer(family sana) on phase 9's trees with per-sample
    routing: STEPSERVE_SLOTS slots at SANA_RES^2, SANA_STEPS steps, in each
    mode of SANA_STEPSERVE_MODES (cold and warm requests, then
    SANA_STEPSERVE_REQUESTS from threads); then stepserve_sana_check: at the
    deepest of SANA_DEPTHS whose random stream stays finite, each request's
    final latents against the pipeline's generate at the same shapes
    (exact: all slots against b=4; the hybrid: one-row gathered forwards
    against b=1) within STEPSERVE_REL_L2."""
    import dataclasses

    from unigen_tpu_torch.serving_steps import StepServer
    cfg = sana_config(per_sample=True)
    bb = cfg.sana
    res, steps = SANA_RES, SANA_STEPS
    lat = res // pipe.ae_downscale
    codec = dict(ae_encode=pipe.ae_encode, ae_decode=pipe.ae_decode,
                 ae_downscale=pipe.ae_downscale)
    n_sus = SANA_STEPSERVE_REQUESTS
    reqs = sana_requests(torch, dev, bb, 2 + n_sus, res, seed + 35, (bb.in_channels, lat, lat))
    lines = {}
    for name, knobs in SANA_STEPSERVE_MODES:
        srv = StepServer(cfg, pipe.params, batch_size=STEPSERVE_SLOTS,
                         num_inference_steps=steps, height=res, width=res, device=dev,
                         **codec, **knobs)
        lines[name] = drive_server(
            torch, dev, srv, reqs, n_sus, "stepserve_sana",
            lambda calls: sana_forward_launches(pipe.params, cfg, calls), mode=name,
            knobs=knobs, steps=steps, resolution=res)

    depth = next((d for d in SANA_DEPTHS
                  if sana_stream_finite(torch, *sana_cut(cfg, pipe.params, d), reqs[0], dev)),
                 None)
    if depth is None:
        raise SystemExit(f"stepserve_sana: the random stream saturates at every depth "
                         f"of {SANA_DEPTHS}")
    cut_cfg, cut = sana_cut(cfg, pipe.params, depth)
    ref = dataclasses.replace(pipe, cfg=cut_cfg, params=cut)
    check = {}
    part = reqs[2:2 + STEPSERVE_SLOTS]
    for name, knobs in SANA_STEPSERVE_MODES:
        srv = StepServer(cut_cfg, cut, batch_size=STEPSERVE_SLOTS,
                         num_inference_steps=SANA_CHECK_STEPS, height=res, width=res,
                         device=dev, **codec, **knobs)
        try:
            finals, calls, stats, admission = serve_at_reference_shapes(srv, part, knobs)
            same_shapes = at_reference_shapes(srv, knobs, calls, stats)
        finally:
            srv.close()
        ref_lat, ref_img = sana_pipeline_finals(torch, ref, part, knobs, res,
                                                SANA_CHECK_STEPS,
                                                STEPSERVE_SLOTS if not knobs else 1)
        rels, codes = compare_finals(torch, part, finals, ref_lat, ref_img)
        check[name] = dict(admission=admission, same_shapes=same_shapes,
                           max_rel_l2=max(rels), max_uint8_diff=max(codes))
    emit(dict(phase="stepserve_sana_check", depth=depth, steps=SANA_CHECK_STEPS,
              reference="UniGenSanaPipeline.generate of the same requests at the same "
                        "shapes", metric="relative L2 of the final latents' displacement "
                        "from the noise", bound_rel_l2=STEPSERVE_REL_L2, modes=check))
    bad = {k: c for k, c in check.items()
           if not c["same_shapes"] or not c["max_rel_l2"] <= STEPSERVE_REL_L2}
    if bad:
        raise SystemExit(f"stepserve_sana: the server differs from the pipeline: {bad}")
    return lines


def _sana_block_shapes(sd, p, bb):
    """A diffusers SanaTransformerBlock's names and shapes (the linear
    attention's q, k, v without bias, the GLUMBConv's 1x1 and depthwise
    convolutions)."""
    d = bb.inner_dim
    inner_x = bb.num_cross_attention_heads * bb.cross_attention_head_dim
    hidden = int(d * bb.mlp_ratio)
    sd[f"{p}.scale_shift_table"] = (6, d)
    for n in ("to_q", "to_k", "to_v"):
        _lin_shapes(sd, f"{p}.attn1.{n}", d, d, bias=False)
    _lin_shapes(sd, f"{p}.attn1.to_out.0", d, d)
    for n in ("to_q", "to_k", "to_v"):
        _lin_shapes(sd, f"{p}.attn2.{n}", d, inner_x)
    _lin_shapes(sd, f"{p}.attn2.to_out.0", inner_x, d)
    sd[f"{p}.ff.conv_inverted.weight"] = (2 * hidden, d, 1, 1)
    sd[f"{p}.ff.conv_inverted.bias"] = (2 * hidden,)
    sd[f"{p}.ff.conv_depth.weight"] = (2 * hidden, 1, 3, 3)
    sd[f"{p}.ff.conv_depth.bias"] = (2 * hidden,)
    sd[f"{p}.ff.conv_point.weight"] = (d, hidden, 1, 1)


def _adaln_single_shapes(sd, p, d):
    _lin_shapes(sd, f"{p}.emb.timestep_embedder.linear_1", 256, d)
    _lin_shapes(sd, f"{p}.emb.timestep_embedder.linear_2", d, d)
    _lin_shapes(sd, f"{p}.linear", d, 6 * d)


def sana_transformer_shapes(bb):
    """diffusers SanaTransformer2DModel's names and shapes."""
    sd, d = {}, bb.inner_dim
    sd["patch_embed.proj.weight"] = (d, bb.in_channels, bb.patch_size, bb.patch_size)
    sd["patch_embed.proj.bias"] = (d,)
    _adaln_single_shapes(sd, "time_embed", d)
    _lin_shapes(sd, "caption_projection.linear_1", bb.caption_channels, d)
    _lin_shapes(sd, "caption_projection.linear_2", d, d)
    sd["caption_norm.weight"] = (d,)
    for i in range(bb.num_layers):
        _sana_block_shapes(sd, f"transformer_blocks.{i}", bb)
    sd["scale_shift_table"] = (2, d)
    _lin_shapes(sd, "proj_out", d, bb.patch_size ** 2 * bb.out_channels)
    return sd


def sana_adapter_shapes(cfg):
    """The reference SANAUniGen adapter's names and shapes (the control
    blocks and their add linears, the condition patch embed and time
    embed, the modulated experts, the two shared-expert blocks)."""
    bb, cc = cfg.sana, cfg.control
    sd, d = {}, bb.inner_dim
    n_cn = cc.num_layers or bb.num_layers
    sd["control_pos_embed_input.proj.weight"] = (d, bb.in_channels, bb.patch_size,
                                                 bb.patch_size)
    sd["control_pos_embed_input.proj.bias"] = (d,)
    _adaln_single_shapes(sd, "control_condition_embed", d)
    _lin_shapes(sd, "control_context_embedder", d, d)
    for i in range(n_cn):
        _sana_block_shapes(sd, f"control_transformer_blocks.{i}", bb)
        _lin_shapes(sd, f"controlnet_add_blocks.{i}", d, d)
    e_num = cc.moe.num_experts(cfg.condition_nums)
    sd["moe.moe_layer.gate.wg.weight"] = (e_num, d)
    for e in range(e_num):
        for pair in (0, 1):
            p = f"moe.moe_layer.experts.deepspeed_experts.{e}.{pair}"
            _lin_shapes(sd, f"{p}.0", d, d)
            _lin_shapes(sd, f"{p}.1", bb.pooled_projection_dim, d)
    for k in (0, 1):
        _sana_block_shapes(sd, f"shared_expert.{k}", bb)
    return sd


def gemma_shapes(gcfg):
    """transformers Gemma2Model's names and shapes."""
    sd, d, hd = {"embed_tokens.weight": (gcfg.vocab_size, gcfg.hidden_size)}, \
        gcfg.hidden_size, gcfg.head_dim
    for i in range(gcfg.num_layers):
        p = f"layers.{i}"
        for n in ("input_layernorm", "post_attention_layernorm",
                  "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            sd[f"{p}.{n}.weight"] = (d,)
        _lin_shapes(sd, f"{p}.self_attn.q_proj", d, gcfg.num_heads * hd, bias=False)
        _lin_shapes(sd, f"{p}.self_attn.k_proj", d, gcfg.num_kv_heads * hd, bias=False)
        _lin_shapes(sd, f"{p}.self_attn.v_proj", d, gcfg.num_kv_heads * hd, bias=False)
        _lin_shapes(sd, f"{p}.self_attn.o_proj", gcfg.num_heads * hd, d, bias=False)
        _lin_shapes(sd, f"{p}.mlp.gate_proj", d, gcfg.intermediate_size, bias=False)
        _lin_shapes(sd, f"{p}.mlp.up_proj", d, gcfg.intermediate_size, bias=False)
        _lin_shapes(sd, f"{p}.mlp.down_proj", gcfg.intermediate_size, d, bias=False)
    sd["norm.weight"] = (d,)
    return sd


def gemma_config_json(gcfg):
    return {"architectures": ["Gemma2Model"], "vocab_size": gcfg.vocab_size,
            "hidden_size": gcfg.hidden_size, "intermediate_size": gcfg.intermediate_size,
            "num_hidden_layers": gcfg.num_layers, "num_attention_heads": gcfg.num_heads,
            "num_key_value_heads": gcfg.num_kv_heads, "head_dim": gcfg.head_dim,
            "rms_norm_eps": gcfg.rms_norm_eps, "rope_theta": gcfg.rope_theta,
            "attn_logit_softcapping": gcfg.attn_logit_softcapping,
            "query_pre_attn_scalar": gcfg.query_pre_attn_scalar,
            "sliding_window": gcfg.sliding_window}


def write_sana_checkpoint(torch, dev, root, cfg, seed):
    """A random SANA directory of ``cfg``'s sizes: the diffusers transformer
    (bf16), Gemma-2 as text_encoder (bf16, two shards), the DC-AE in the
    native format under vae/ (fp32, drawn by the port's init), CLIP-L in
    clip/ (fp16), the scheduler; each tensor drawn on ``dev`` from
    ``seed``. -> bytes per component."""
    from unigen_tpu_torch.models import dcae
    from unigen_tpu_torch.utils import param_bytes
    bb = cfg.sana
    gcfg, ccfg = sana_text_configs()
    ae_cfg = sana_dcae_config()
    bf16, f16 = torch.bfloat16, torch.float16
    tcfg = dict(_class_name="SanaTransformer2DModel", in_channels=bb.in_channels,
                out_channels=bb.out_channels, num_layers=bb.num_layers,
                attention_head_dim=bb.attention_head_dim,
                num_attention_heads=bb.num_attention_heads,
                num_cross_attention_heads=bb.num_cross_attention_heads,
                cross_attention_head_dim=bb.cross_attention_head_dim,
                cross_attention_dim=bb.cross_attention_dim,
                caption_channels=bb.caption_channels, mlp_ratio=bb.mlp_ratio,
                patch_size=bb.patch_size, sample_size=bb.sample_size,
                pooled_projection_dim=bb.pooled_projection_dim)
    ccfg_json = {"architectures": ["CLIPTextModel"], "vocab_size": ccfg.vocab_size,
                 "hidden_size": ccfg.hidden_size,
                 "intermediate_size": ccfg.intermediate_size,
                 "num_hidden_layers": ccfg.num_layers,
                 "num_attention_heads": ccfg.num_heads,
                 "max_position_embeddings": ccfg.max_position_embeddings,
                 "eos_token_id": ccfg.eos_token_id, "hidden_act": ccfg.hidden_act}
    parts = [("transformer", sana_transformer_shapes(bb), bf16, 1, tcfg,
              "diffusion_pytorch_model"),
             ("text_encoder", gemma_shapes(gcfg), bf16, 2, gemma_config_json(gcfg), "model"),
             ("clip", clip_shapes(ccfg), f16, 1, ccfg_json, "model")]
    ae_bytes = param_bytes(dcae.init_dcae_params(ae_cfg, device="meta"))   # fp32
    require_disk(root, checkpoint_bytes([
        (shapes, torch.empty((), dtype=dt).element_size()) for _, shapes, dt, *_ in parts])
        + ae_bytes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    written = {sub: write_component(torch, root / sub, shapes, dt, gen, dev, config,
                                    shards=shards, stem=stem)
               for sub, shapes, dt, shards, config, stem in parts}
    ae = dcae.init_dcae_params(ae_cfg, gen=gen, device=dev)
    dcae.save_dcae_native(str(root / "vae"), ae, ae_cfg)
    written["vae"] = (root / "vae" / "dcae_native.npz").stat().st_size
    del ae
    (root / "scheduler").mkdir(parents=True, exist_ok=True)
    (root / "scheduler" / "config.json").write_text(json.dumps(
        {"_class_name": "FlowMatchEulerDiscreteScheduler", "shift": 3.0}))
    return written


def sana_load_check(torch, root, pipe, dev, min_dim=512):
    """The loaded W4A8 trees of ``pipe`` (transformer: int4 base, int8
    adapter; Gemma and CLIP W4A8 text towers) against
    quantize_tree_streaming(donate=False) of the same directory loaded with
    quantize=None: -> (leaves compared, leaves that differ)."""
    from unigen_tpu_torch.ops import quant
    from unigen_tpu_torch.pipelines.loading import load_sana_pipeline
    raw = load_sana_pipeline(str(root), dtype=torch.bfloat16, clip_dir=str(root / "clip"),
                             device=dev)
    whole = functools.partial(quant.quantize_tree_streaming, donate=False)
    pairs = [(pipe.params["base"], whole(raw.params["base"], bits=4, min_dim=min_dim)),
             (pipe.params["control"], whole(raw.params["control"], bits=8,
                                            min_dim=min_dim)),
             (pipe.gemma_params, quant.quantize_text_tower(raw.gemma_params, bits=4,
                                                           donate=False)),
             (pipe.clip_params, quant.quantize_text_tower(raw.clip_params, bits=4,
                                                          donate=False))]
    compared, differ = 0, []
    for got, want in pairs:
        n, d = trees_equal(torch, got, want)
        compared, differ = compared + n, differ + d
    del raw
    torch.cuda.empty_cache()
    return compared, differ


def phase_sana_load(torch, dev, seed, root):
    """9c. A full-size random SANA directory (sana_config's transformer,
    Gemma-2-2B, CLIP-L, the native DC-AE f32c32) written to ``root``, loaded
    by load_sana_pipeline(dtype=bf16, quantize="w4a8", quantize_text="w4a8")
    with its load times; sana_load_check; two requests served (one b=2
    generate at SANA_RES^2, SANA_LOAD_STEPS steps) with stub tokenizers."""
    from unigen_tpu_torch.pipelines.loading import load_sana_pipeline
    from unigen_tpu_torch.utils import param_bytes
    cfg = sana_config()
    t0 = time.time()
    written = write_sana_checkpoint(torch, dev, root, cfg, seed)
    write_s = time.time() - t0
    stats = {}
    torch.cuda.synchronize()
    t0 = time.time()
    with load_timer(torch, stats):
        pipe = load_sana_pipeline(str(root), dtype=torch.bfloat16, quantize="w4a8",
                                  quantize_text="w4a8", clip_dir=str(root / "clip"),
                                  device=dev)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    pipe.tokenizer = SeededTokenizer(pipe.gemma_cfg.vocab_size, 1, seed + 36)
    pipe.tokenizer_clip = SeededTokenizer(pipe.clip_cfg.vocab_size,
                                          pipe.clip_cfg.vocab_size - 1, seed + 37)
    emit(dict(phase="sana_load", root=str(root), written_bytes=written, write_s=write_s,
              load_s=load_s, **stats, transformer_bytes=param_bytes(pipe.params),
              gemma_bytes=param_bytes(pipe.gemma_params),
              clip_bytes=param_bytes(pipe.clip_params), ae_downscale=pipe.ae_downscale))
    t0 = time.time()
    compared, differ = sana_load_check(torch, root, pipe, dev)
    emit(dict(phase="sana_load_check",
              reference="quantize_tree_streaming(donate=False) of the quantize=None load",
              leaves=compared, differ=differ, s=time.time() - t0))
    if differ or not compared:
        raise SystemExit(f"sana_load_check: the loaded and the undonated quantization "
                         f"differ at {differ[:8]}")
    host = torch.Generator().manual_seed(seed + 38)
    px = torch.rand(BATCH, 3, SANA_RES, SANA_RES, generator=host) * 2 - 1
    prompts = ["a red cube", "a blue sphere on the grass"]
    t0 = time.time()
    imgs = pipe(prompts, "canny", px, height=SANA_RES, width=SANA_RES,
                num_inference_steps=SANA_LOAD_STEPS)
    torch.cuda.synchronize()
    emit(dict(phase="sana_load_requests", requests=len(prompts), steps=SANA_LOAD_STEPS,
              resolution=SANA_RES, s=time.time() - t0, out_shape=list(imgs.shape)))
    if imgs.dtype != torch.uint8 or tuple(imgs.shape) != (BATCH, SANA_RES, SANA_RES, 3):
        raise SystemExit(f"sana_load: bad output {imgs.dtype} {tuple(imgs.shape)}")
    del pipe
    torch.cuda.empty_cache()


def sd3_base_forward_check(torch, dev, seed):
    """8: the UniGenBase forward (unigen_base_forward) of a full-width
    SD3.5-medium base-variant tree at b=2, 512^2: a plain forward, a
    capture and its replay, every rope-free attention call against its
    plain version and the calls against expected_sd3_base_launches; the
    capture and the replay must give the plain forward's bits."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.io.from_jax import init_sd3_serving_params
    from unigen_tpu_torch.models.unigen_sd3 import unigen_base_forward
    run = presets.baseline_configs()["sd3_depth_28step"]
    cfg, steps, res = run["cfg"], run["steps"], run["resolution"]
    bb = cfg.sd3
    params = init_sd3_serving_params(cfg, seed=seed + 41, device=dev, base_variant=True)
    x = sd3_requests(bb, BATCH, res, seed + 42)
    from unigen_tpu_torch.models.unigen_sd3 import SD3_SCHEDULER
    from unigen_tpu_torch.pipelines import scheduling
    _, ts = scheduling.inference_sigmas(SD3_SCHEDULER, steps)
    args = [torch.cat([torch.as_tensor(r[k]) for r in x]).to(dev, torch.bfloat16)
            for k in ("latents", "condition", "encoder", "pooled", "cond_pooled")]
    t = torch.full((BATCH,), float(ts[0]), dtype=torch.bfloat16, device=dev)
    checks, outs = {}, {}
    with torch.no_grad():
        for what, kw in (("forward", {}), ("capture", dict(return_control_residuals=True))):
            checks[what] = {}
            with shadowed_kernels(torch, checks[what]):
                outs[what] = unigen_base_forward(params, cfg, *args, t,
                                                 conditioning_scale=0.8, **kw)
        res_stack = outs["capture"][2]["control_residuals"]
        checks["replay"] = {}
        with shadowed_kernels(torch, checks["replay"]):
            outs["replay"] = unigen_base_forward(params, cfg, *args, t,
                                                 conditioning_scale=0.8,
                                                 control_residuals=res_stack)
    want = {"forward": expected_sd3_base_launches(cfg, BATCH),
            "capture": expected_sd3_base_launches(cfg, BATCH),
            "replay": expected_sd3_replay_launches(cfg)}
    summary = {k: path_check_summary(c) for k, c in checks.items()}
    pred = outs["forward"][0]
    same = {k: torch.equal(outs[k][0], pred) for k in ("capture", "replay")}
    emit(dict(phase="sd3_base_forward_check", batch=BATCH, resolution=res,
              residuals_shape=list(res_stack.shape), path_check=summary,
              expected_calls=want, same_bits_as_forward=same,
              finite=bool(torch.isfinite(pred.float()).all())))
    bad = {k: s for k, s in summary.items()
           if set(s) != {"flash_attention"} or s["flash_attention"]["disagree"]
           or s["flash_attention"]["calls"] != want[k]}
    if bad or not all(same.values()) or not torch.isfinite(pred.float()).all():
        raise SystemExit(f"sd3_base_forward_check: {bad}, same bits {same}")
    del params
    torch.cuda.empty_cache()
    return sum(s["flash_attention"]["calls"] for s in summary.values())


def expected_sd3_base_launches(cfg, batch: int = 1) -> int:
    """Rope-free attention calls of one UniGenBase forward at ``batch``:
    the base pass (every joint block and the dual blocks' attn2), the two
    preprocess weave blocks, the block experts (two calls per expert, per
    sample under per-sample routing), the shared expert's three, and the
    n_cn control blocks (joint or single, one call each)."""
    bb, cc = cfg.sd3, cfg.control
    dual = sum(i in set(bb.dual_attention_layers) for i in range(bb.num_layers))
    experts = (0 if cc.use_modulate or cc.use_rope
               else 2 * cc.moe.num_experts(cfg.condition_nums))
    if cc.moe.batch_mode == "per_sample" and batch > 1:
        experts *= batch
    n_cn = cc.num_layers or bb.num_layers
    return (bb.num_layers + dual + 2 + experts + (3 if cc.use_shared_expert else 0)
            + n_cn)


# ------------------------------------------------------------ 11. the tools

def tool_forward_launches(family, params, cfg, batch):
    """Kernel launches of one forward of ``family`` at ``batch``."""
    if family == "flux":
        return expected_launches(params, cfg, batch)
    if family == "sd3":
        return sd3_forward_launches_quantized(params, cfg, batch)
    return expected_sana_launches(params, cfg)


def fidelity_path_launches(family, params, cfg, steps):
    """Launches of one measure_fidelity path with --ssim and no cache flag:
    the b=1 forward, then the exact denoise (SD3's CFG pair at b=2)."""
    return add_counts((1, tool_forward_launches(family, params, cfg, 1)),
                      (steps, tool_forward_launches(family, params, cfg,
                                                    2 if family == "sd3" else 1)))


def direct_forward(torch, setup, params, dev):
    """The family's model forward called directly on the setup's host batch
    at the CLI's timestep (bf16): what the CLI's bf16 forward must equal bit
    for bit."""
    from unigen_tpu_torch.models.sana import sana_unigen_forward
    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
    from unigen_tpu_torch.models.unigen_sd3 import unigen_sd3_forward
    bf = torch.bfloat16
    x = {k: torch.as_tensor(v).to(dev) for k, v in setup.batch.items()}
    fp = {k: v.to(bf) for k, v in x.items() if not k.endswith("_ids")}
    with torch.no_grad():
        if setup.family == "flux":
            t = torch.full((1,), 0.5, dtype=bf, device=dev)
            out = unigen_flux_forward(params, setup.cfg, fp["hidden"], fp["condition"],
                                      fp["encoder"], fp["pooled"], fp["condition_pooled"], t,
                                      x["img_ids"], x["txt_ids"], x["condition_ids"])[0]
        elif setup.family == "sd3":
            t = torch.full((1,), 500.0, dtype=bf, device=dev)
            out = unigen_sd3_forward(params, setup.cfg, fp["hidden"], fp["condition"],
                                     fp["encoder"][:1], fp["pooled"][:1],
                                     fp["condition_pooled"][:1], t)[0]
        else:
            t = torch.full((1,), 500.0, dtype=bf, device=dev)
            out = sana_unigen_forward(params, setup.cfg, fp["hidden"], fp["condition"],
                                      fp["encoder"], fp["pooled"], fp["condition_pooled"],
                                      t)[0]
    return out.float().cpu()


def fidelity_check(torch, dev, family, res, out_dir):
    """11a-11c. cli.measure_fidelity --family ``family`` --ssim at ``res`` on
    the CLI's own random tree (live gates), its launches read per path
    around the CLI's tree builder; then each path's tree again: the bf16
    forward called directly equals the CLI's bit for bit, every kernel call
    of one forward of each quantized path against its plain version, each
    path's launches equal the forward formulas; the bf16 output's largest
    |value| finite, rel_err finite and below FIDELITY_REL, e2e_ssim at least
    FIDELITY_SSIM. -> the launches of the CLI's run."""
    from unigen_tpu_torch.cli import measure_fidelity as mf
    out_dir.mkdir(parents=True, exist_ok=True)
    argv = ["--family", family, "--ssim", "--res", str(res), "--device", str(dev),
            "--out", str(out_dir / f"fidelity_{family}.json")]
    args = mf.parse_args(argv)
    setup = mf.setup_for(args)
    marks = []

    def counted_init():
        marks.append(launch_counts())
        return setup.init_fn()
    reset_launch_counts()
    t0 = time.time()
    result = mf.main(argv, init_fn=counted_init)
    torch.cuda.synchronize()
    wall = time.time() - t0
    marks.append(launch_counts())
    total = nonzero(marks[-1])
    got = [nonzero({k: b[k] - a[k] for k in a}) for a, b in zip(marks, marks[1:])]
    report, host = result["json"], result["host"]
    with open(out_dir / f"fidelity_{family}.json") as f:
        written = json.load(f)
    paths, checks = {}, {}
    for i, path in enumerate(setup.paths):
        params = setup.make_params(path)
        want = fidelity_path_launches(family, params, setup.cfg, setup.num_steps)
        rec = dict(seconds=host[path]["seconds"], peak_bytes=host[path]["peak_bytes"],
                   launches=got[i], expected_launches=want)
        if path == "bf16":
            direct = direct_forward(torch, setup, params, dev)
            cli = torch.from_numpy(host["bf16"]["fwd"])
            rec.update(max_abs_out=direct.abs().max().item(),
                       direct_equal=bool(torch.equal(direct, cli)))
        else:
            per = tool_forward_launches(family, params, setup.cfg, 1)
            checks[path] = kernel_path_check(
                torch, f"fidelity_{family}_path_check",
                ((path, lambda: setup.forward(params, setup.batch),
                  {k: n for k, n in per.items() if k != "rope_rotate"}),))[path]
        paths[path] = rec
        del params
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase=f"fidelity_{family}", res=setup.res, steps=setup.num_steps,
              wall_s=wall, report=report, paths=paths, launches=total))
    bf16 = paths["bf16"]
    quantized = [p for p in setup.paths if p != "bf16"]
    bad = []
    if not math.isfinite(bf16["max_abs_out"]):
        bad.append(f"bf16 output not finite ({bf16['max_abs_out']})")
    if not bf16["direct_equal"]:
        bad.append("the CLI's bf16 forward differs from the model's")
    if written != report:
        bad.append("--out differs from the printed line")
    for path in setup.paths:
        if paths[path]["launches"] != paths[path]["expected_launches"]:
            bad.append(f"{path} launches {paths[path]['launches']} != "
                       f"{paths[path]['expected_launches']}")
    for path in quantized:
        rel, ssim = report[path]["rel_err"], report[path]["e2e_ssim"]
        if not (math.isfinite(rel) and rel < FIDELITY_REL):
            bad.append(f"{path} rel_err {rel} (limit {FIDELITY_REL})")
        if not ssim >= FIDELITY_SSIM:
            bad.append(f"{path} e2e_ssim {ssim} (gate {FIDELITY_SSIM})")
    emit(dict(phase="fidelity_check", family=family, ok=not bad, problems=bad,
              max_abs_out=bf16["max_abs_out"],
              rel_err={p: report[p]["rel_err"] for p in quantized},
              e2e_ssim={p: report[p]["e2e_ssim"] for p in quantized}))
    if bad:
        raise SystemExit(f"fidelity_check {family}: {bad}")
    return total


def strict_counts(report):
    """{component: the parameter count} of a strict_load report's "ok (N
    params...)" entries."""
    out = {}
    for comp, text in report["strict_load"].items():
        m = re.match(r"ok \((\d+) params", text)
        if m:
            out[comp] = int(m.group(1))
    return out


def validate(cli_val, argv, out):
    """cli.validate_real_ckpt.main(argv) -> its report, read from ``out``
    where its SSIM gate refused the checkpoint. The gate's verdict must
    agree with the fidelity it measured: the worst e2e_ssim of stage 3's
    JSON, passed exactly when it reaches the gate; any other failure
    stops the phase."""
    try:
        report = cli_val.main(argv)
    except SystemExit as e:
        if not str(e).startswith("SSIM gate FAILED"):
            raise
        with open(out) as f:
            report = json.load(f)
        report["ssim_gate"]["exit"] = str(e)
    gate = report["ssim_gate"]
    worst = min(v["e2e_ssim"] for v in report["quant_fidelity"].values()
                if isinstance(v, dict))
    if gate["worst"] != worst or gate["pass"] != (worst >= gate["gate"]) \
            or ("exit" in gate) == gate["pass"]:
        raise SystemExit(f"validate: the gate's verdict {gate} disagrees with stage 3's "
                         f"worst e2e_ssim {worst}")
    return report


def generate_check(torch, pipe, args):
    """cli.generate's PNG against the pipeline's own call with the same
    arguments: its control image read, resized to the example's 512^2 and
    turned into the condition, as the reference example does. -> the
    largest uint8 difference."""
    import numpy as np
    from PIL import Image

    from unigen_tpu_torch.cli.generate import RESOLUTION
    from unigen_tpu_torch.data import conditions as C
    img = np.asarray(Image.open(args.image).convert("RGB").resize((RESOLUTION, RESOLUTION)))
    ref = pipe(prompt=args.prompt, condition_prompt=args.condition,
               control_image=C.to_model_range(C.synthesize(args.condition, img))[None],
               height=RESOLUTION, width=RESOLUTION, num_inference_steps=args.steps,
               seed=args.seed)[0]
    return code_diff(torch, ref.cpu(), read_png(torch, Path(args.out)))


def phase_tools_checkpoints(torch, dev, seed, root, flux_root, sd3_root):
    """11d validate_flux: cli.validate_real_ckpt on 4e's FLUX directory with
    its .bin adapter (--skip-diffusers, 512^2): the strict-load counts equal
    the leaf counts of the same files loaded here (11e's pipeline and the
    adapter), stage 3
    (cli.measure_fidelity --ckpt in a subprocess on the same card) runs to
    its end, the gate's verdict agrees with it (``validate``) and passes;
    then 8c's SD3 directory's bf16 forward at full depth, and its
    validation only where that output is finite (its verdict held to its
    fidelity, a pass not required: its linears are N(0, 0.02)). 11e generate: cli.generate --ckpt on
    4e's directory (pipeline through cli.generate.load_pipeline, stub
    tokenizers), launches against the formula, generate_check bit for bit.
    -> the launches of 11d's in-process part and 11e."""
    from unigen_tpu_torch.cli import generate as cli_gen
    from unigen_tpu_torch.cli import measure_fidelity as mf
    from unigen_tpu_torch.cli import validate_real_ckpt as cli_val
    from unigen_tpu_torch.io import torch_bridge as tb
    from unigen_tpu_torch.utils import param_count

    root.mkdir(parents=True, exist_ok=True)
    png = write_control_png(root / "generate_control.png", PIPE_RES, seed)
    gen_argv = ["--ckpt", str(flux_root), "--image", str(png), "--condition", "canny",
                "--steps", str(STEPS), "--out", str(root / "generate.png"),
                "--device", str(dev), "--seed", str(seed)]
    gargs = cli_gen.parse_args(gen_argv)
    t0 = time.time()
    pipe = cli_gen.load_pipeline(gargs)
    torch.cuda.synchronize()
    gen_load_s = time.time() - t0
    pipe.tokenizer = SeededTokenizer(pipe.clip_cfg.vocab_size, pipe.clip_cfg.vocab_size - 1,
                                     seed)
    pipe.tokenizer_2 = SeededTokenizer(pipe.t5_cfg.vocab_size, 1, seed + 1)

    # 11d
    bb = pipe.cfg.flux
    adapter = flux_root / "adapter"
    want = {"transformer": param_count(pipe.params["base"])}
    n_cn = bb.num_layers // pipe.cfg.control.single_control_dev
    n_cn_s = bb.num_single_layers // pipe.cfg.control.single_control_dev
    want["adapter"] = param_count(tb.load_adapter_checkpoint(
        str(adapter), n_cn=n_cn, n_cn_single=n_cn_s,
        num_experts=pipe.cfg.control.moe.num_experts(pipe.cfg.condition_nums),
        guidance=bb.guidance_embeds, device=dev))
    want.update(vae=param_count(pipe.vae_params), text_encoder=param_count(pipe.clip_params),
                text_encoder_2=param_count(pipe.t5_params))
    gc.collect()
    torch.cuda.empty_cache()
    val_argv = ["--ckpt", str(flux_root), "--adapter", str(adapter), "--skip-diffusers",
                "--res", str(PIPE_RES), "--out", str(root / "validate_flux.json"),
                "--device", str(dev)]
    reset_launch_counts()
    t0 = time.time()
    report = validate(cli_val, val_argv, root / "validate_flux.json")
    wall = time.time() - t0
    launches = nonzero(launch_counts())
    counts = strict_counts(report)
    emit(dict(phase="validate_flux", depth=[bb.num_layers, bb.num_single_layers],
              wall_s=wall, strict_counts=counts, expected_counts=want,
              quant_fidelity=report["quant_fidelity"], ssim_gate=report["ssim_gate"],
              diffusers_goldens=report["diffusers_goldens"]))
    if counts != want or not report["ssim_gate"]["pass"]:
        raise SystemExit(f"validate_flux: counts {counts} != {want}, or the gate refused "
                         f"the directory ({report['ssim_gate']})")
    totals = add_counts((1, launches))

    # 8c's SD3 directory: validated only where its random stream stays finite
    sargs = mf.parse_args(["--family", "sd3", "--ckpt", str(sd3_root), "--adapter",
                           str(sd3_root / "adapter"), "--res", str(VALIDATE_SD3_RES),
                           "--device", str(dev)])
    s = mf.setup_for(sargs)
    p = s.make_params("bf16")
    out = s.forward(p, s.batch)
    top = out.abs().max().item()
    del p, out
    gc.collect()
    torch.cuda.empty_cache()
    if math.isfinite(top):
        t0 = time.time()
        sd3_report = validate(cli_val, [
            "--ckpt", str(sd3_root), "--family", "sd3", "--adapter", str(sd3_root / "adapter"),
            "--skip-diffusers", "--res", str(VALIDATE_SD3_RES), "--out",
            str(root / "validate_sd3.json"), "--device", str(dev)], root / "validate_sd3.json")
        emit(dict(phase="validate_sd3", bf16_max_abs_out=top, wall_s=time.time() - t0,
                  strict_load=sd3_report["strict_load"],
                  quant_fidelity=sd3_report["quant_fidelity"],
                  ssim_gate=sd3_report["ssim_gate"]))
    else:
        emit(dict(phase="validate_sd3", skipped=True, bf16_max_abs_out=top,
                  reason="the random full-depth SD3.5-medium stream saturates: its bf16 "
                         "forward is not finite, so a fidelity gate on it measures nothing "
                         "(its strict load is held by sd3_load_check)"))

    # 11e
    reset_launch_counts()
    t0 = time.perf_counter()
    img = cli_gen.main(gen_argv, pipeline=pipe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nonzero(launch_counts())
    want = expected_pipeline_launches(pipe.params, pipe.cfg, [(1, STEPS, 0)])
    diff = generate_check(torch, pipe, gargs)
    emit(dict(phase="generate", load_s=gen_load_s, steps=STEPS, wall_s=wall,
              out_shape=list(img.shape), launches=launches, expected_launches=want))
    emit(dict(phase="generate_check", images=1, max_code_diff=diff))
    if launches != want or diff or tuple(img.shape) != (cli_gen.RESOLUTION,) * 2 + (3,):
        raise SystemExit(f"generate: launches {launches} != {want} or {diff} codes")
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return add_counts((1, totals), (1, launches))


def phase_tools_profiles(torch, dev, params):
    """11f profile_forward: cli.profile_forward --preset full --quant w4a8
    --batches 1,2 --res 512 on phase 4's W4A8 flux_full tree: every phase
    reported at each batch, the full phase's output equal to
    unigen_flux_forward bit for bit, one full call's launches equal to the
    formula, one attn call 57 RoPE launches. 11g profile_train: cli.
    profile_train --preset full --remats TOOLS_REMATS on the same tree: no
    error row, each policy's first step loss equal to one make_train_step on
    a fresh state and the same inputs, whose launches equal
    expected_train_launches. -> the launches of the two CLI runs."""
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.cli import profile_forward as cli_pf
    from unigen_tpu_torch.cli import profile_train as cli_pt
    from unigen_tpu_torch.config import TrainConfig
    from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
    from unigen_tpu_torch.train import train_step as ts

    cfg = presets.flux_full()
    bb = cfg.flux
    batches = (1, 2)
    reset_launch_counts()
    t0 = time.time()
    res = cli_pf.main(["--preset", "full", "--quant", "w4a8", "--batches",
                       ",".join(map(str, batches)), "--res", str(PIPE_RES), "--device",
                       str(dev)], params=params)
    wall = time.time() - t0
    totals = nonzero(launch_counts())
    checks, bad = {}, []
    for entry in res["json"]["sweep"]:
        missing = [p for p in cli_pf.PHASES if p not in entry["phase_ms"]]
        if missing:
            bad.append(f"b={entry['batch']} missing {missing}")
    for b in batches:
        x = cli_pf.make_inputs(cfg, b, PIPE_RES, dev)
        with torch.no_grad():
            direct = unigen_flux_forward(params, cfg, x["hidden"], x["condition"],
                                         x["encoder"], x["pooled"], x["cond_pooled"],
                                         x["timestep"], x["img_ids"], x["txt_ids"],
                                         x["img_ids"])[0]
            equal = bool(torch.equal(direct, res["outputs"][b]["full"]))
            reset_launch_counts()
            cli_pf.full_phase(params, cfg, x)
            full = nonzero(launch_counts())
            reset_launch_counts()
            cli_pf.attn_phase(params, cfg, x)
            attn = nonzero(launch_counts())
        want_full = nonzero(expected_launches(params, cfg, b))
        n = bb.num_layers + bb.num_single_layers
        checks[b] = dict(full_equal=equal, full_launches=full,
                         expected_full_launches=want_full, attn_launches=attn)
        if not equal:
            bad.append(f"b={b} full differs from unigen_flux_forward")
        if full != want_full:
            bad.append(f"b={b} full launches {full} != {want_full}")
        if attn != {"flash_attention_rope": n, "rope_rotate": n}:
            bad.append(f"b={b} attn launches {attn} (want {n} RoPE calls)")
    emit(dict(phase="profile_forward", wall_s=wall, report=res["json"], checks=checks,
              launches=totals))
    if bad:
        raise SystemExit(f"profile_forward: {bad}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    # 11g
    reset_launch_counts()
    t0 = time.time()
    prof = cli_pt.main(["--preset", "full", "--remats", TOOLS_REMATS, "--res", str(PIPE_RES),
                        "--device", str(dev)], params=params)
    wall = time.time() - t0
    launches = nonzero(launch_counts())
    trainable, frozen_arg = cli_pt.split(params, "full")
    batch, draws, _, _ = cli_pt.make_batch(cfg, "full", 1, PIPE_RES, dev)
    steps = {}
    for policy, row in prof["policies"].items():
        if "error" in row:
            bad.append(f"{policy}: {row['error']}")
            continue
        tcfg = TrainConfig(train_batch_size=1, remat=policy)
        step = ts.make_train_step(cfg, tcfg)
        reset_launch_counts()
        _, m = step(ts.init_train_state(trainable, tcfg), frozen_arg, batch, draws=draws)
        loss = float(m["step_loss"])
        got = nonzero(launch_counts())
        want = nonzero(expected_train_launches(params, cfg, 1, remat=policy))
        steps[policy] = dict(loss=loss, cli_loss=row["first_step_loss"], launches=got,
                             expected_launches=want, mfu=row.get("mfu"))
        if loss != row["first_step_loss"]:
            bad.append(f"{policy}: step loss {loss} != the CLI's {row['first_step_loss']}")
        if got != want:
            bad.append(f"{policy}: launches {got} != {want}")
        gc.collect()
        torch.cuda.empty_cache()
    emit(dict(phase="profile_train", wall_s=wall, report=prof, peak_ops=prof["peak_ops"],
              mfu={p: r.get("mfu") for p, r in prof["policies"].items()}, steps=steps,
              launches=launches))
    if bad:
        raise SystemExit(f"profile_train: {bad}")
    return add_counts((1, totals), (1, launches))


def shape_counts(records):
    """{"MxKxN": calls} of the W4A8 path-check records."""
    out = {}
    for r in records:
        key = "x".join(map(str, r["shape"]))
        out[key] = out.get(key, 0) + 1
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA "
                                     "port on one NVIDIA card")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the kernel inputs and the training data")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of the parent commit: its phase 3 runs first "
                             "on the same card, each phase-3 row is shown beside the "
                             "parent's (the same_run line; W4A8 rows also time the "
                             "parent's kernel in turns in this process), the RoPE "
                             "kernels' and W4A8's outputs must keep their bits "
                             "(same_bits), the quantization's may differ from the parent's "
                             "only by its scale's reciprocal (quant_vs_parent), and the "
                             "host-bound "
                             "attention calls are timed against the parent's in one "
                             "process (host_bound_ab lines)")
    parser.add_argument("--schedules", action="store_true",
                        help="only time the rope-free forward's D=64 variants "
                             "(csrc/timing/flash_attention_schedules.cu) against "
                             "the production kernel, then stop")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 2
    from unigen_tpu_torch import presets
    from unigen_tpu_torch.ops.cuda import build
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm

    # 1. device
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.time()
    if args.schedules:
        build.build_all([fa.KERNEL_NOROPE, SCHEDULES_KERNEL])
        check_setmaxnreg(ptxas_line(build, [fa.KERNEL_NOROPE, SCHEDULES_KERNEL]))
        bad = [r for r in phase_schedules(torch, dev, build, fa, args.seed) if not r["ok"]]
        if bad:
            raise SystemExit(f"a schedule disagrees with the plain version: {bad}")
        return 0
    logs = build.build_all([fa.KERNEL, fa.KERNEL_BWD, fa.KERNEL_NOROPE,
                            fa.KERNEL_NOROPE_BWD, qm.KERNEL, qm.KERNEL_QUANT])
    print(f"# build: {time.time() - t0:.1f}s from {build.CSRC}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# {name}: {line.strip()}", flush=True)
    check_setmaxnreg(ptxas_line(build, [fa.KERNEL, fa.KERNEL_BWD, fa.KERNEL_NOROPE,
                                        fa.KERNEL_NOROPE_BWD, qm.KERNEL, qm.KERNEL_QUANT]))

    t_phase = [time.time()]

    def done(name):
        print(f"# phase {name}: {time.time() - t_phase[0]:.1f}s", flush=True)
        t_phase[0] = time.time()

    # 3. kernels at the main paths' shapes (the parent's first, with --parent)
    parent = parent_phase(args.parent, args.seed) if args.parent else None
    pmods = load_parent(args.parent) if args.parent else None
    rows = phase_kernels(torch, dev, args.seed,
                         pqm=pmods["quant_matmul"] if pmods else None)
    w4a8_tiles(torch, dev, args.seed)
    if parent:
        same_run(rows, parent)
        pfa = pmods["flash_attention"]
        changed, compared = changed_bits(torch, dev, pfa, fa)
        w_changed, w_compared = changed_w4a8_bits(torch, dev, pmods["quant_matmul"])
        emit(dict(phase="same_bits", outputs=compared + w_compared,
                  changed=changed + w_changed))
        if changed or w_changed:
            raise SystemExit(f"kernel outputs changed bits: {changed + w_changed}")
        quant_vs_parent(torch, dev, pmods["quant"])
        host_bound_ab(torch, dev, pfa)
    done("3 kernels")

    # 4. the serving slice
    params, serving = phase_slice(torch, dev)
    done("4 slice")

    # 4b. the FLUX pipeline on the same tree (the text towers are freed
    # here, the VAE after phase 4d)
    vae_cfg, vae_params = phase_pipeline(torch, dev, params, args.seed)
    torch.cuda.empty_cache()
    done("4b pipeline")

    # 4c. the StepServer in each mode, and its check; 4d. two resolutions
    stepserve = phase_stepserve(torch, dev, params, vae_cfg, vae_params, args.seed)
    done("4c stepserve")
    phase_stepserve_multires(torch, dev, params, vae_cfg, vae_params, args.seed)
    done("4d stepserve_multires")

    # 5. the training slice
    launches = phase_train(torch, dev, presets.flux_full(), params, args.seed,
                           FLUX_FULL_TRAINABLE)
    done("5 train")

    # 6. the Trainer on the same tree, fp32 activations
    phase_trainer(torch, dev, params, args.seed)
    done("6 trainer")

    # 6b. LoRA fine-tuning over the same frozen tree with the reference's
    # gate, checkpoint and resume, then the adapter served
    lora_launches = phase_train_lora(torch, dev, params, vae_cfg, vae_params, args.seed)
    del vae_params
    torch.cuda.empty_cache()
    done("6b train_lora")

    # 6c. top-2 with the dense dispatch, the consis module, remat "dots"
    phase_train_routing(torch, dev, params, args.seed)
    done("6c train_routing")

    # 7. the W4A8 FLUX tree at 1024^2
    phase_flux_1024(torch, dev, params)
    done("7 flux_1024")

    # 11f-11g. the profiling tools on the same tree
    tools = phase_tools_profiles(torch, dev, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    done("11f-11g tools_profiles")

    # 7b. training with the shipped control values: rope-free control
    # attention and block experts, on a tree of its own
    blocks = phase_train_blocks(torch, dev, args.seed)
    torch.cuda.empty_cache()
    done("7b train_blocks")

    # 8. the SD3 serving path, 9. the same at 1024^2
    model, sd3_launches = phase_sd3(torch, dev, args.seed)
    sd3_base = sd3_base_forward_check(torch, dev, args.seed)
    done("8 sd3")
    phase_sd3_1024(torch, model, args.seed)
    done("9 sd3_1024")
    # 8b. the StepServer on the same SD3 tree, per-sample routing
    sd3_serve = phase_stepserve_sd3(torch, dev, model.params, args.seed)
    del model
    torch.cuda.empty_cache()
    done("8b stepserve_sd3")

    # 8c. the SD3 pipeline loaded from a full-size checkpoint directory;
    # 4e. the FLUX loader on a directory sharing its VAE and text files.
    # The directories are removed whatever happens.
    import shutil
    shutil.rmtree(CHECKPOINTS, ignore_errors=True)
    try:
        sd3_pipeline = phase_sd3_pipeline(torch, dev, args.seed, CHECKPOINTS / "sd35_medium")
        done("8c sd3_pipeline")
        load_flux = phase_load_flux(torch, dev, args.seed, CHECKPOINTS / "flux",
                                    CHECKPOINTS / "sd35_medium")
        done("4e load_flux")
        # 4f. the training entry point on 4e's directory
        phase_train_cli(torch, dev, args.seed, CHECKPOINTS / "flux")
        done("4f train_cli")
        # 10. the inference, serving and evaluation entry points on the same
        # directories, the evaluation towers and the depth condition
        entry_launches = phase_entry_points(torch, dev, args.seed, CHECKPOINTS / "entry",
                                            CHECKPOINTS / "sd35_medium", CHECKPOINTS / "flux")
        done("10 entry_points")
        # 11d-11e. the checkpoint validation and the one-image example on the
        # same directories
        tools = add_counts((1, tools), (1, phase_tools_checkpoints(
            torch, dev, args.seed, CHECKPOINTS / "tools", CHECKPOINTS / "flux",
            CHECKPOINTS / "sd35_medium")))
        done("11d-11e tools_checkpoints")
    finally:
        shutil.rmtree(CHECKPOINTS, ignore_errors=True)

    # 9. the SANA family end to end; 9b. its StepServer on the same trees;
    # 9c. SANA loaded from a full-size directory (removed whatever happens)
    sana_launches, sana_pipe = phase_sana(torch, dev, args.seed)
    done("9 sana")
    phase_stepserve_sana(torch, dev, sana_pipe, args.seed)
    del sana_pipe
    gc.collect()
    torch.cuda.empty_cache()
    done("9b stepserve_sana")
    try:
        phase_sana_load(torch, dev, args.seed, CHECKPOINTS / "sana")
        done("9c sana_load")
    finally:
        shutil.rmtree(CHECKPOINTS, ignore_errors=True)

    # 11a-11c. cli.measure_fidelity per family on its own random trees
    try:
        for family in ("flux", "sd3", "sana"):
            tools = add_counts((1, tools), (1, fidelity_check(
                torch, dev, family, FIDELITY_RES[family], CHECKPOINTS / "fidelity")))
            done(f"11 fidelity_{family}")
    finally:
        shutil.rmtree(CHECKPOINTS, ignore_errors=True)

    # 12. kernels line: the dominant main-path shape of each kernel; launches
    # from the main path that runs it (training for the FLUX kernels, with
    # the serving run's beside the forward kernels; SD3 serving for the
    # rope-free forward, with train_blocks' beside it; train_blocks for the
    # rope-free backward). The RoPE kernels' times include their rotation
    # pass (rope_rotate in flash_attention_rope.cu, counted apart: one launch
    # per RoPE forward and per RoPE backward call).
    pallas = "unigen_tpu/ops/pallas/"
    sources = {
        "flash_attention_rope": ("flash_attention_rope.cu", "flash_attention.py:128",
                                 pallas + "flash_attention.py:416"),
        "w4a8_matmul": ("w4a8_matmul.cu", "quant_matmul.py:57", None),
        "quantize_act": ("quantize_act.cu", None, None),
        BWD_NAMES[0]: ("flash_attention_rope_bwd.cu", "flash_attention.py:904",
                       pallas + "flash_attention.py:670"),
        BWD_NAMES[1]: ("flash_attention_rope_bwd.cu", "flash_attention.py:958",
                       pallas + "flash_attention.py:670"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:109",
                            pallas + "flash_attention.py:399"),
        NOROPE_BWD_NAMES[0]: ("flash_attention_bwd.cu", "flash_attention.py:882",
                              [pallas + "flash_attention.py:646",
                               pallas + "flash_attention.py:815"]),
        NOROPE_BWD_NAMES[1]: ("flash_attention_bwd.cu", "flash_attention.py:930",
                              [pallas + "flash_attention.py:646",
                               pallas + "flash_attention.py:815"])}
    main_path = dict(launches, flash_attention=sd3_launches["flash_attention"],
                     **{n: blocks[n] for n in NOROPE_BWD_NAMES})
    kernels = []
    reps = {"w4a8_matmul": lambda r: (r["m"], r["k"], r["n"]) == W4A8_REP,
            "quantize_act": lambda r: (r["m"], r["k"], r["dtype"]) == QUANT_REP}
    for name, (src, replaces, also) in sources.items():
        rep = next(r for r in rows[name] if reps.get(name, lambda r: True)(r))
        entry = dict(
            name=name, route="cuda", source="unigen_tpu_torch/csrc/" + src,
            replaces=pallas + replaces if replaces else "unigen_tpu/ops/quant.py:75",
            launches=main_path[name],
            max_abs_err=max(r["max_abs_err"] for r in rows[name]),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"])
        if also:
            entry["also_replaces"] = also
        if not replaces:
            entry["note"] = ("_quantize_act is not a Pallas kernel: XLA fuses it with "
                             "its producer")
        if name in serving:
            entry["serving_launches"] = serving[name]
        if name in stepserve["exact"]["launches"]:
            entry["stepserve_launches"] = stepserve["exact"]["launches"][name]
        if name in sd3_serve["exact"]["launches"]:
            entry["stepserve_sd3_launches"] = sd3_serve["exact"]["launches"][name]
        if name == "flash_attention":
            entry["train_blocks_launches"] = blocks[name]
        if name in sd3_pipeline:
            entry["sd3_pipeline_launches"] = sd3_pipeline[name]
        if name in load_flux["launches"]:
            entry["load_flux_launches"] = load_flux["launches"][name]
        if name in lora_launches:
            entry["train_lora_launches"] = lora_launches[name]
        if name in sana_launches:
            entry["sana_launches"] = sana_launches[name]
        if name in entry_launches:
            entry["entry_points_launches"] = entry_launches[name]
        if name in tools:
            entry["tools_launches"] = tools[name]
        if name == "flash_attention":
            entry["sd3_base_forward_launches"] = sd3_base
        if name in ("flash_attention_rope",) + BWD_NAMES:
            entry.update(rotation_source="unigen_tpu_torch/csrc/flash_attention_rope.cu",
                         rotation_launches=main_path["rope_rotate"])
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
