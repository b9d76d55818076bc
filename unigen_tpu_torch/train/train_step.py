"""Flow-matching training step (port of ``unigen_tpu/train/train_step.py``).

One step reproduces the reference step (train.py:517-697): draw the
timestep density and the noise, noise and pack the latents, run the UniGen
forward (remat per block, the MoE's training capacity), weighted MSE plus
the MoE aux loss, then AdamW on the trainable tree only, behind a global-
norm clip, with the HF learning-rate schedules and micro-batch gradient
accumulation. The optimizer is written out by hand to mirror
``optax.MultiSteps(optax.chain(clip_by_global_norm, adamw), k)`` step for
step, with its state in the same places (``io/from_jax`` carries an optax
state across).

The random draws come from a ``torch.Generator``; ``Draws`` passes them in
as tensors instead, so the tests can feed the JAX package's own draws. The
MoE draws only for random token selection (``use_rts`` with top-1 routing,
the reference's gate): one uniform [tokens, E] per step.

LoRA mode (``lora_rank > 0``) trains rank-r factors over the frozen control
branch: the step folds them into the frozen weights inside the loss
(``models/lora.fold_for_training``), so the optimizer state and the
checkpoints hold only the factors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from unigen_tpu_torch.config import TrainConfig, UniGenConfig
from unigen_tpu_torch.models import lora as lora_lib
from unigen_tpu_torch.models.moe import rts_tokens
from unigen_tpu_torch.models.unigen_flux import unigen_flux_forward
from unigen_tpu_torch.ops import quant
from unigen_tpu_torch.ops.packing import (pack_latents, prepare_latent_image_ids,
                                          unpack_latents)
from unigen_tpu_torch.pipelines import scheduling
from unigen_tpu_torch.utils import tree_leaves, tree_map


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (optax.global_norm)."""
    return torch.stack([x.float().square().sum() for x in tree_leaves(tree)]).sum().sqrt()


# ---------------------------------------------------------------- schedules

def _polynomial(init, end, power, steps):
    """optax.polynomial_schedule (transition_begin 0)."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        count = min(max(count, 0), steps)
        return (init - end) * (1 - count / steps) ** power + end
    return schedule


def _cosine(init, decay_steps, alpha=0.0):
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps))
                       + alpha)
    return schedule


def _join(schedules, boundaries):
    """optax.join_schedules."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out
    return schedule


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The reference's six HF ``get_scheduler`` choices (train.py:160-161)
    with the JAX package's optax semantics (train_step.py:35-68): linear
    warmup 0 -> peak over ``lr_warmup_steps``, then per-type decay over the
    remaining steps (polynomial power 1.0 to 1e-7; cosine_with_restarts with
    one cycle equals cosine)."""
    total = max(cfg.max_train_steps, 1)
    warmup = min(cfg.lr_warmup_steps, max(total - 1, 1))
    decay = max(total - warmup, 1)
    peak = cfg.learning_rate
    kind = cfg.lr_scheduler

    if kind == "constant":
        return lambda step: peak
    ramp = _polynomial(0.0, peak, 1, warmup)
    if kind == "constant_with_warmup":
        tail = lambda step: peak
    elif kind == "linear":
        tail = _polynomial(peak, 0.0, 1, decay)
    elif kind == "polynomial":
        tail = _polynomial(peak, 1e-7, 1.0, decay)
    elif kind in ("cosine", "cosine_with_restarts"):
        return _join([ramp, _cosine(peak, total - warmup)], [warmup])
    else:
        raise ValueError(f"unknown lr_scheduler {kind!r}; expected one of "
                         "linear/cosine/cosine_with_restarts/polynomial/"
                         "constant/constant_with_warmup (reference "
                         "train.py:161)")
    return _join([ramp, tail], [warmup])


# ---------------------------------------------------------------- optimizer

class OptState(NamedTuple):
    """optax's state, flattened: ``count`` is both ScaleByAdamState.count and
    ScaleByScheduleState.count (the chain increments them together on every
    inner update); ``mini_step``, ``gradient_step`` and ``acc_grads`` are
    MultiStepsState's (``acc_grads`` None without accumulation)."""
    count: int
    mu: Any
    nu: Any
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Any = None


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay))``, wrapped in ``optax.MultiSteps(every_k)`` when
    ``every_k > 1`` (``make_optimizer``, train_step.py:71-81). Every leaf's
    arithmetic runs in the leaf's dtype, as optax's does."""

    def __init__(self, cfg: TrainConfig):
        self.lr = lr_schedule(cfg)
        self.b1, self.b2 = cfg.adam_beta1, cfg.adam_beta2
        self.eps, self.wd = cfg.adam_epsilon, cfg.adam_weight_decay
        self.max_norm = cfg.max_grad_norm
        self.every_k = max(cfg.gradient_accumulation_steps, 1)

    def init(self, params: Any) -> OptState:
        zeros = lambda: tree_map(torch.zeros_like, params)
        return OptState(count=0, mu=zeros(), nu=zeros(),
                        acc_grads=zeros() if self.every_k > 1 else None)

    def _inner(self, grads, state: OptState, params):
        g_norm = global_norm(grads)
        keep = g_norm < self.max_norm

        def clip(g):
            return torch.where(keep, g, g / g_norm.to(g.dtype) * self.max_norm)
        grads = tree_map(clip, grads)
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads, state.nu)
        count = state.count + 1
        # 1 - decay**count in fp32 as optax, then divide in the leaf's dtype
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        step_size = -self.lr(state.count)

        def update(m, v, p):
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            u = u + self.wd * p
            return torch.tensor(step_size, dtype=u.dtype, device=u.device) * u
        updates = tree_map(update, mu, nu, params)
        return updates, state._replace(count=count, mu=mu, nu=nu)

    def update(self, grads: Any, state: OptState, params: Any
               ) -> Tuple[Optional[Any], OptState]:
        """-> (updates, new state); updates is None on an accumulation step
        that does not emit (optax gives zeros there)."""
        if self.every_k == 1:
            return self._inner(grads, state, params)
        n = state.mini_step
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state.acc_grads)
        if n < self.every_k - 1:
            return None, state._replace(mini_step=n + 1, acc_grads=acc)
        updates, inner = self._inner(acc, state, params)
        return updates, inner._replace(
            mini_step=0, gradient_step=state.gradient_step + 1,
            acc_grads=tree_map(torch.zeros_like, acc))


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """The optimizer of ``cfg``: clip + AdamW, behind MultiSteps when it
    accumulates (``unigen_tpu/train/train_step.make_optimizer``)."""
    return AdamW(cfg)


def apply_updates(params: Any, updates: Optional[Any]) -> Any:
    """optax.apply_updates: p + u in the parameter's dtype."""
    if updates is None:
        return params
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------- the step

class TrainState(NamedTuple):
    control: Any          # trainable tree (None leaves where frozen)
    opt_state: OptState
    step: int


class Draws(NamedTuple):
    """The step's random draws: noise like the latents, u [B] fp32 in (0, 1),
    and under random token selection the MoE's uniform [tokens, E]."""
    noise: torch.Tensor
    u: torch.Tensor
    moe_u: Optional[torch.Tensor] = None


def init_train_state(control_params: Any, cfg: TrainConfig) -> TrainState:
    return TrainState(control=control_params,
                      opt_state=make_optimizer(cfg).init(control_params), step=0)


def rts_draw_shape(ucfg: UniGenConfig, latents_shape) -> Optional[Tuple[int, int]]:
    """The MoE's uniform draw of a training step on latents [B, C, H, W],
    or None when its routing draws nothing (no ``use_rts``, or top-2)."""
    moe = ucfg.control.moe
    if not moe.use_rts or moe.top_k != 1:
        return None
    b, _, h, w = latents_shape
    return (rts_tokens(ucfg.control, b, (h // 2) * (w // 2)),
            moe.num_experts(ucfg.condition_nums))


def draw(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
         weighting_scheme: str = "none", rts_shape=None) -> Draws:
    """The timestep density u, noise in the latents' dtype and, for a
    ``rts_shape``, the MoE's uniform, in that order from ``generator`` (on
    the latents' device)."""
    lat = batch["latents"]
    u = scheduling.sample_timestep_density(generator, lat.shape[0],
                                           weighting_scheme, device=lat.device)
    noise = torch.randn(lat.shape, generator=generator, dtype=lat.dtype,
                        device=lat.device)
    moe_u = (None if rts_shape is None else
             torch.rand(rts_shape, generator=generator, device=lat.device))
    return Draws(noise, u, moe_u)


def flow_matching_loss(pred_packed: torch.Tensor, latents: torch.Tensor,
                       noise: torch.Tensor, sigmas: torch.Tensor,
                       weighting_scheme: str) -> torch.Tensor:
    """Weighted MSE against the flow target (noise - x); pred is packed
    [B, S, C*4], latents/noise are [B, C, H, W] (train.py:636-652)."""
    h, w = latents.shape[-2:]
    pred = unpack_latents(pred_packed, h, w)
    weighting = scheduling.loss_weighting(sigmas, weighting_scheme)
    weighting = weighting.reshape((-1,) + (1,) * (latents.dim() - 1))
    target = noise - latents
    per_sample = (weighting * (pred.to(torch.float32) - target.to(torch.float32)) ** 2
                  ).reshape(latents.shape[0], -1).mean(dim=1)
    return per_sample.mean()


def make_loss_builder(ucfg: UniGenConfig, tcfg: TrainConfig, *,
                      guidance_embeds: Optional[bool] = None):
    """Returns ``build(base_params, batch, draws) -> loss_fn(control)``, the
    closure ``make_train_step`` differentiates (noising, packing, forward,
    weighted flow loss plus the MoE aux loss).

    base_params is the frozen base tree, or {"base", "control_frozen"} for
    the single-card fine-tune split (``ops/quant.split_trainable``): the
    control tree is then merged from the trainable and frozen halves inside
    the loss. In LoRA mode it must be {"base", "control_frozen"} with the
    whole frozen control tree (fp or quantized), and the trainable tree is
    an adapter {dotted path: {"a", "b"}} rooted at {"base", "control"}."""
    lora_mode = tcfg.lora_rank > 0
    sigma_table = torch.from_numpy(scheduling.training_sigmas(
        scheduling.FlowMatchConfig(shift=1.0)))
    n_train = sigma_table.shape[0]
    use_guidance = (ucfg.flux.guidance_embeds if guidance_embeds is None
                    else guidance_embeds)

    def build(base_params, batch: Dict[str, torch.Tensor], draws: Draws):
        latents = batch["latents"]
        dev = latents.device
        b, _, h, w = latents.shape
        idx = torch.clamp((draws.u * n_train).to(torch.int32), 0, n_train - 1)
        sigmas = sigma_table.to(dev)[idx.long()]
        noisy = scheduling.scale_noise(latents, draws.noise, sigmas)

        packed_noisy = pack_latents(noisy)
        cond = batch["condition_latents"]
        multi = cond.dim() == 5
        packed_cond = (torch.stack([pack_latents(c) for c in cond]) if multi
                       else pack_latents(cond))
        img_ids = prepare_latent_image_ids(h // 2, w // 2, device=dev)
        cond_ids = prepare_latent_image_ids(cond.shape[-2] // 2,
                                            cond.shape[-1] // 2, device=dev)
        if multi:
            cond_ids = cond_ids[None].expand(cond.shape[0], *cond_ids.shape)
        txt_ids = torch.zeros(batch["prompt_embeds"].shape[1], 3, device=dev)
        guidance = (torch.full((b,), tcfg.guidance_scale, dtype=latents.dtype,
                               device=dev) if use_guidance else None)
        has_frozen = isinstance(base_params, dict) and "control_frozen" in base_params
        if lora_mode and not has_frozen:
            raise ValueError("LoRA mode (lora_rank > 0) needs base_params="
                             "{'base', 'control_frozen'}")
        split = has_frozen and not lora_mode
        base = base_params["base"] if has_frozen else base_params

        def loss_fn(control):
            base_t = base
            if split:
                control = quant.merge_split(control, base_params["control_frozen"])
            if lora_mode:
                folded = lora_lib.fold_for_training(
                    {"base": base, "control": base_params["control_frozen"]},
                    control, scale=tcfg.lora_scale)
                base_t, control = folded["base"], folded["control"]
            pred, add_losses, add_outputs = unigen_flux_forward(
                {"base": base_t, "control": control}, ucfg,
                hidden=packed_noisy, condition=packed_cond,
                encoder=batch["prompt_embeds"], pooled=batch["pooled"],
                condition_pooled=batch["condition_pooled"],
                timestep=sigmas, img_ids=img_ids, txt_ids=txt_ids,
                condition_ids=cond_ids, guidance=guidance,
                remat=tcfg.remat, training=True, rts_uniform=draws.moe_u)
            flow = flow_matching_loss(pred, latents, draws.noise, sigmas,
                                      tcfg.weighting_scheme)
            total = flow + sum(add_losses.values())
            return total, {"flow_loss": flow, **add_losses,
                           "expert_counts": add_outputs["expert_counts"]}

        return loss_fn

    return build


def make_train_step(ucfg: UniGenConfig, tcfg: TrainConfig, *,
                    guidance_embeds: Optional[bool] = None,
                    quant_bwd: str = "bf16"):
    """Returns ``train_step(state, base_params, batch, generator=None, *,
    draws=None) -> (state, metrics)``.

    batch (tensors on one device):
      latents            [B, C, H, W]   VAE-encoded targets
      condition_latents  [B, C, H, W] or [K, B, C, H, W]
      prompt_embeds      [B, T, joint_dim]
      pooled             [B, pooled_dim]
      condition_pooled   [B, pooled_dim] or [K, B, pooled_dim]

    The draws come from ``generator`` unless ``draws`` is given. Gradients
    reach the trainable leaves of ``state.control`` only; through quantized
    linears they flow straight through (``quant_bwd`` picks the backward
    product, ``ops/quant.bwd_dx``). Metrics stay on the device: step_loss,
    flow_loss, moe_loss, grad_norm (of this micro-step's gradients), lr (at
    the outer step, as the JAX step reads it) and expert_counts."""
    tx = make_optimizer(tcfg)
    schedule = lr_schedule(tcfg)
    builder = make_loss_builder(ucfg, tcfg, guidance_embeds=guidance_embeds)

    def train_step(state: TrainState, base_params, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   draws: Optional[Draws] = None):
        if draws is None:
            draws = draw(batch, generator, tcfg.weighting_scheme,
                         rts_draw_shape(ucfg, batch["latents"].shape))
        loss_fn = builder(base_params, batch, draws)
        control = tree_map(lambda x: x.detach().requires_grad_(
            x.is_floating_point()), state.control)
        leaves = [t for t in tree_leaves(control) if t.requires_grad]
        with quant.quant_backward(quant_bwd):
            loss, aux = loss_fn(control)
            found = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(t): (g if g is not None else torch.zeros_like(t))
                 for t, g in zip(leaves, found)}
        grads = tree_map(lambda t: by_id.get(id(t), torch.zeros_like(t)),
                                control)
        updates, opt_state = tx.update(grads, state.opt_state, state.control)
        new_control = apply_updates(state.control, updates)
        metrics = {"step_loss": loss.detach(), "flow_loss": aux["flow_loss"].detach(),
                   "moe_loss": aux.get("moe_loss", torch.zeros(())).detach(),
                   "grad_norm": global_norm(grads),
                   "lr": schedule(state.step),
                   "expert_counts": aux["expert_counts"]}
        return TrainState(new_control, opt_state, state.step + 1), metrics

    return train_step
