"""The training loop (port of ``unigen_tpu/train/loop.py``): the reference
train.py:206-712 as a library class, on one device.

Per step: encode the prompts and condition task names and the target and
condition images with the caller's encoders (no gradient), then one train
step (``train_step.make_train_step``). Trainable floating leaves are upcast
to fp32, as the reference does (train.py:346); the frozen base keeps its
dtype. The JAX forward then needs fp32 activations (with bf16 ones its
first fp32 bias add changes a ``lax.scan`` carry's dtype, which it refuses);
the port takes either and promotes as jnp does, and its attention kernels
take fp32 activations on the card.

With a ``work_dir`` the Trainer checkpoints every ``checkpointing_steps``
and at the end of ``train`` (``train/checkpoint.py``), and ``maybe_resume``
continues from ``latest``, the random generator's state included, so a
resumed run draws what an uninterrupted one would. In LoRA mode every save
also exports the adapter in the reference's per-adapter layout
(``{work_dir}/lora_adapters/{name}/pytorch_lora_weights.safetensors``).
There is no mesh yet: ``mesh`` waits for the port of ``parallel/``
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from unigen_tpu_torch.config import TrainConfig, UniGenConfig
from unigen_tpu_torch.train import checkpoint as ckpt_lib
from unigen_tpu_torch.train.train_step import (TrainState, init_train_state,
                                               make_train_step)
from unigen_tpu_torch.utils import resolve_device, tree_map

logger = logging.getLogger("unigen_tpu_torch.train")


class Trainer:
    def __init__(self, ucfg: UniGenConfig, tcfg: TrainConfig, *,
                 base_params, control_params,
                 encode_text: Callable[[Sequence[str]], Dict[str, torch.Tensor]],
                 encode_images: Callable[[np.ndarray], torch.Tensor],
                 work_dir: Optional[str] = None, mesh=None, device=None,
                 quant_bwd: str = "bf16"):
        """encode_text(prompts) -> {'prompt_embeds', 'pooled'};
        encode_text(task_names)['pooled'] doubles as the condition embed.
        encode_images(pixels [B,3,H,W]) -> latents [B,C,h,w]. The trees move
        to ``device`` (CUDA unless "cpu" is named)."""
        if mesh is not None:
            raise NotImplementedError("sharded training waits for the port of "
                                      "unigen_tpu/parallel (ROADMAP Queue 1 item 8)")
        self.ucfg, self.tcfg = ucfg, tcfg
        self.work_dir = work_dir
        self.encode_text = encode_text
        self.encode_images = encode_images
        self.device = resolve_device(device)
        dev = self.device
        # reference train.py:346: "only upcast trainable parameters into
        # fp32"; the frozen base rides in its loaded dtype
        control_params = tree_map(
            lambda x: x.to(dev, torch.float32) if x.is_floating_point()
            else x.to(dev), control_params)
        self.base_params = tree_map(lambda x: x.to(dev), base_params)
        self.state: TrainState = init_train_state(control_params, tcfg)
        self.global_step = 0
        self._step_fn = make_train_step(ucfg, tcfg, quant_bwd=quant_bwd)
        self._generator = torch.Generator(device=dev).manual_seed(tcfg.seed)

    def maybe_resume(self) -> bool:
        """Continue from ``{work_dir}/latest``. A checkpoint that fails to
        load, or does not match the live state, logs a warning and the run
        starts fresh (the reference catches load errors the same way,
        train.py:473-475). -> whether a checkpoint was restored."""
        if not self.work_dir:
            return False
        try:
            restored = ckpt_lib.restore_train_state(
                self.work_dir, self.state.control, self.state.opt_state,
                map_location=self.device)
        except Exception as e:
            logger.warning("checkpoint restore failed (%s); starting fresh", e)
            return False
        if restored is None:
            return False
        control, opt_state, meta = restored
        self.state = TrainState(control=control, opt_state=opt_state,
                                step=int(meta["step"]))
        self.global_step = int(meta["step"])
        if "generator_state" in meta:
            self._generator.set_state(meta["generator_state"])
        logger.info("resumed from step %d", self.global_step)
        return True

    def save(self) -> None:
        """Checkpoint the trainable tree, the optimizer and the generator at
        ``global_step``; in LoRA mode also export the adapter in the
        reference's per-adapter layout (hook.py:29-45), loadable at any
        point by ``io/torch_bridge.load_lora_adapters``."""
        ckpt_lib.save_train_state(self.work_dir, self.global_step,
                                  self.state.control, self.state.opt_state,
                                  generator_state=self._generator.get_state())
        if self.tcfg.lora_rank > 0:
            from unigen_tpu_torch.io.torch_bridge import export_lora_adapters_reference
            out = os.path.join(self.work_dir, "lora_adapters")
            export_lora_adapters_reference(
                {self.tcfg.lora_adapter_name: self.state.control}, out)
            logger.info("exported LoRA adapter '%s' to %s",
                        self.tcfg.lora_adapter_name, out)
        logger.info("saved checkpoint at step %d", self.global_step)

    def prepare_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            text = self.encode_text(batch["descriptions"])
            latents = self.encode_images(np.asarray(batch["pixel_values"]))
            cond_px = np.asarray(batch["condition_pixels"])
            if cond_px.ndim == 5:
                cond_lat = torch.stack([self.encode_images(cond_px[k])
                                        for k in range(cond_px.shape[0])])
                cond_pooled = torch.stack(
                    [self.encode_text([t] * latents.shape[0])["pooled"]
                     for t in batch["condition_types"]])
            else:
                cond_lat = self.encode_images(cond_px)
                cond_pooled = self.encode_text(batch["task_names"])["pooled"]
        out = dict(latents=latents, condition_latents=cond_lat,
                   prompt_embeds=text["prompt_embeds"], pooled=text["pooled"],
                   condition_pooled=cond_pooled)
        return {k: torch.as_tensor(v).to(self.device) for k, v in out.items()}

    def step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        device_batch = self.prepare_batch(batch)
        self.state, metrics = self._step_fn(self.state, self.base_params,
                                            device_batch, self._generator)
        self.global_step += 1
        return metrics

    def train(self, batches: Iterable[Dict[str, Any]],
              log_every: int = 10) -> Dict[str, float]:
        from unigen_tpu_torch.observability import log_step_metrics
        last = {}
        t0 = time.time()
        for batch in batches:
            metrics = self.step(batch)
            if self.global_step % log_every == 0:
                last = {k: float(v) for k, v in metrics.items()
                        if not isinstance(v, torch.Tensor) or v.dim() == 0}
                last["s_per_it"] = (time.time() - t0) / log_every
                log_step_metrics(logger, self.global_step, metrics)
                t0 = time.time()
            if (self.work_dir and self.tcfg.checkpointing_steps
                    and self.global_step % self.tcfg.checkpointing_steps == 0):
                self.save()
            if self.global_step >= self.tcfg.max_train_steps:
                break
        if self.work_dir:
            self.save()
        return last
