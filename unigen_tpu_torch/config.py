"""Config dataclasses of the FLUX, SD3 and SANA families (a copy of
``unigen_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package.
Only the pieces the port reads are here: the FLUX, SD3 and SANA backbones, the
control branch with its MoE, the model config that joins them, and the
training hyperparameters.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


@dataclass(frozen=True)
class FluxBackboneConfig:
    """FLUX.1 MMDiT backbone hyperparameters (frozen pretrained base)."""
    in_channels: int = 64                  # packed latent channels (16 * 2 * 2)
    num_layers: int = 19                   # double-stream blocks
    num_single_layers: int = 38            # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096        # T5 embedding dim
    pooled_projection_dim: int = 768       # CLIP pooled dim
    guidance_embeds: bool = False          # schnell: False, dev: True
    axes_dims_rope: Tuple[int, ...] = (16, 56, 56)
    rope_theta: int = 10000

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def out_channels(self) -> int:
        return self.in_channels


@dataclass(frozen=True)
class SD3BackboneConfig:
    """SD3 / SD3.5 MMDiT backbone hyperparameters."""
    sample_size: int = 128
    patch_size: int = 2
    in_channels: int = 16
    num_layers: int = 24                   # SD3.5-medium: 24 (w/ dual attn 0..12)
    attention_head_dim: int = 64
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    caption_projection_dim: int = 1536
    pooled_projection_dim: int = 2048
    out_channels: int = 16
    pos_embed_max_size: int = 384
    dual_attention_layers: Tuple[int, ...] = tuple(range(13))
    qk_norm: Optional[str] = "rms_norm"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclass(frozen=True)
class SanaBackboneConfig:
    """SANA linear-attention DiT backbone hyperparameters (the defaults are
    Sana_1600M_1024px's transformer config)."""
    in_channels: int = 32
    out_channels: int = 32
    num_layers: int = 20
    attention_head_dim: int = 32
    num_attention_heads: int = 70
    num_cross_attention_heads: int = 20
    cross_attention_head_dim: int = 112
    cross_attention_dim: int = 2240
    caption_channels: int = 2304
    mlp_ratio: float = 2.5
    patch_size: int = 1
    sample_size: int = 32
    pooled_projection_dim: int = 768       # pooled embed dim of the MoE streams

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


@dataclass(frozen=True)
class MoEConfig:
    """Condition-expert MoE: GShard top-1 routing with a static capacity.

    ``batch_mode="per_sample"`` routes each sample with its own capacity
    (the serving mode); ``"global"`` routes all B*S tokens together.
    """
    expert_num: Optional[int] = None
    expert_num_each_condition: int = 3
    top_k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    drop_tokens: bool = True
    use_rts: bool = False
    aux_loss_weight: float = 0.1
    ep_size: int = 1
    batch_mode: str = "global"
    fast_dispatch: bool = True

    def num_experts(self, condition_nums: int) -> int:
        if self.expert_num is not None:
            return self.expert_num
        return (condition_nums + 1) * self.expert_num_each_condition


@dataclass(frozen=True)
class ControlConfig:
    """Condition-weaving control branch. ``use_rope=True`` is the only
    shape-consistent FLUX configuration (see the JAX package's note); SD3
    presets set False. ``extra_conditioning_channels`` and ``num_layers``
    (the control depth) are read by SD3 only."""
    use_transformer_params: bool = True
    use_pooled_prompt_embeds: bool = True
    use_encoder_hidden_states: bool = True
    use_single_trans_blocks: bool = True
    single_block_control_method: str = "overall_add"  # or "single_add"
    single_control_dev: int = 2            # base blocks per control block
    use_shared_expert: bool = True
    use_consis_module: bool = False
    use_modulate: bool = False
    use_rope: bool = True
    use_pos_embed: bool = False
    cn2base_method: str = "add"
    extra_conditioning_channels: int = 0
    num_layers: Optional[int] = None
    moe: MoEConfig = field(default_factory=MoEConfig)


@dataclass(frozen=True)
class UniGenConfig:
    """Backbone family (flux | sd3 | sana) + control branch + condition types."""
    family: str = "flux"
    flux: FluxBackboneConfig = field(default_factory=FluxBackboneConfig)
    sd3: SD3BackboneConfig = field(default_factory=SD3BackboneConfig)
    sana: SanaBackboneConfig = field(default_factory=SanaBackboneConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    condition_types: Tuple[str, ...] = ("canny",)

    @property
    def condition_nums(self) -> int:
        return len(self.condition_types)

    @property
    def backbone(self):
        return {"flux": self.flux, "sd3": self.sd3, "sana": self.sana}[self.family]


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference train.py defaults)."""
    learning_rate: float = 1e-4
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 500
    max_train_steps: int = 30000
    train_batch_size: int = 1              # per-process micro batch
    gradient_accumulation_steps: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    weighting_scheme: str = "none"         # sigma_sqrt|logit_normal|mode|cosmap|none
    guidance_scale: float = 3.5
    max_sequence_length: int = 512
    resolution: int = 512
    seed: int = 12443
    mixed_precision: str = "bf16"
    checkpointing_steps: int = 1000
    # activation rematerialisation (utils.remat_wrap): True/"full",
    # "dots" (save the weight products), False/"none"
    remat: Union[bool, str] = True
    # LoRA fine-tuning (rank > 0): rank-r factors over the frozen control
    # branch (models/lora.fold_for_training); () targets ->
    # models/lora.DEFAULT_LORA_TARGETS; the adapter's export name
    lora_rank: int = 0
    lora_targets: tuple = ()
    lora_scale: float = 1.0
    lora_adapter_name: str = "default"


def control_overrides_from_yaml(path: Optional[str]) -> dict:
    """The reference's control-config file (``config/unigen.yaml``:
    ``params.control_params.*``, plain YAML or JSON) -> ControlConfig
    override kwargs; the MoE keys (``expert_num_each_condition`` and the
    others) fold into a ``moe=MoEConfig(...)`` override, and an unknown key
    raises. {} for a falsy path. PyYAML is imported here, on use."""
    if not path:
        return {}
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f)
    params = (doc or {}).get("params", doc) or {}
    cp = dict(params.get("control_params", params) or {})
    moe_keys = {k: cp.pop(k) for k in list(cp)
                if k in ("expert_num_each_condition", "expert_num", "top_k",
                         "capacity_factor", "aux_loss_weight")}
    valid = {f.name for f in dataclasses.fields(ControlConfig)}
    unknown = set(cp) - valid
    if unknown:
        raise ValueError(f"control config {path}: unknown control_params keys "
                         f"{sorted(unknown)}; valid: {sorted(valid)}")
    if moe_keys:
        cp["moe"] = MoEConfig(**moe_keys)
    return cp


def tiny_flux_config(**overrides) -> FluxBackboneConfig:
    """A miniature Flux config for tests (same topology, tiny dims)."""
    base = dict(
        in_channels=16, num_layers=2, num_single_layers=4,
        attention_head_dim=16, num_attention_heads=4,
        joint_attention_dim=32, pooled_projection_dim=24,
        guidance_embeds=False, axes_dims_rope=(4, 6, 6),
    )
    base.update(overrides)
    return FluxBackboneConfig(**base)


def tiny_sd3_config(**overrides) -> SD3BackboneConfig:
    """A miniature SD3 config for tests (same topology, tiny dims)."""
    base = dict(
        sample_size=16, patch_size=2, in_channels=4, num_layers=4,
        attention_head_dim=8, num_attention_heads=4, joint_attention_dim=32,
        caption_projection_dim=32, pooled_projection_dim=24, out_channels=4,
        pos_embed_max_size=32, dual_attention_layers=(0, 1), qk_norm="rms_norm",
    )
    base.update(overrides)
    return SD3BackboneConfig(**base)


def tiny_sana_config(**overrides) -> SanaBackboneConfig:
    """A miniature SANA config for tests (same topology, tiny dims)."""
    base = dict(
        in_channels=4, out_channels=4, num_layers=2, attention_head_dim=8,
        num_attention_heads=4, num_cross_attention_heads=2,
        cross_attention_head_dim=16, cross_attention_dim=32,
        caption_channels=24, mlp_ratio=2.5, patch_size=1, sample_size=8,
        pooled_projection_dim=16,
    )
    base.update(overrides)
    return SanaBackboneConfig(**base)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
