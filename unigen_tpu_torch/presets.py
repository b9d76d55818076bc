"""Named FLUX and SD3 presets (a copy of the ones in
``unigen_tpu/presets.py``)."""

from __future__ import annotations

from unigen_tpu_torch import config as C


def flux_schnell(condition_types=("canny",), **ctrl_overrides) -> C.UniGenConfig:
    """FLUX.1-schnell's hyperparameters (no guidance embedding)."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(guidance_embeds=False),
        control=C.ControlConfig(**ctrl_overrides),
        condition_types=tuple(condition_types),
    )


def flux_dev(condition_types=("canny",), **ctrl_overrides) -> C.UniGenConfig:
    """FLUX.1-dev's hyperparameters (the guidance embedding)."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(guidance_embeds=True),
        control=C.ControlConfig(**ctrl_overrides),
        condition_types=tuple(condition_types),
    )


def flux_mini(condition_types=("canny",)) -> C.UniGenConfig:
    """The full FLUX topology (19 double / 38 single, 9 + 19 control blocks,
    MoE, shared expert) at width 512."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(
            in_channels=64, num_layers=19, num_single_layers=38,
            attention_head_dim=64, num_attention_heads=8,
            joint_attention_dim=1024, pooled_projection_dim=256,
            guidance_embeds=False, axes_dims_rope=(8, 28, 28)),
        control=C.ControlConfig(),
        condition_types=tuple(condition_types),
    )


def flux_bench(condition_types=("canny",)) -> C.UniGenConfig:
    """Real FLUX width (3072, 24 heads x 128) at reduced depth: 6 double /
    12 single base blocks, 3 + 6 control blocks, per-sample routing."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(
            in_channels=64, num_layers=6, num_single_layers=12,
            attention_head_dim=128, num_attention_heads=24,
            joint_attention_dim=4096, pooled_projection_dim=768,
            guidance_embeds=False, axes_dims_rope=(16, 56, 56)),
        control=C.ControlConfig(moe=C.MoEConfig(batch_mode="per_sample")),
        condition_types=tuple(condition_types),
    )


def flux_full(condition_types=("canny",)) -> C.UniGenConfig:
    """The real FLUX.1 topology: 19 double / 38 single base blocks at width
    3072 (24 heads x 128), 9 + 19 control blocks, MoE + shared expert, with
    per-sample routing (the serving mode)."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(guidance_embeds=False),
        control=C.ControlConfig(moe=C.MoEConfig(batch_mode="per_sample")),
        condition_types=tuple(condition_types),
    )


def flux_train_bench(condition_types=("canny",), *,
                     shared_expert: bool = True) -> C.UniGenConfig:
    """Real FLUX width (3072) at 2 double / 4 single base blocks (1 + 2
    control blocks), for one training step on one card;
    ``shared_expert=False`` drops the shared expert."""
    return C.UniGenConfig(
        family="flux",
        flux=C.FluxBackboneConfig(
            in_channels=64, num_layers=2, num_single_layers=4,
            attention_head_dim=128, num_attention_heads=24,
            joint_attention_dim=4096, pooled_projection_dim=768,
            guidance_embeds=False, axes_dims_rope=(16, 56, 56)),
        control=C.ControlConfig(use_shared_expert=shared_expert),
        condition_types=tuple(condition_types),
    )


def sd35_medium(condition_types=("depth",), **ctrl_overrides) -> C.UniGenConfig:
    """SD3.5-medium: 24 joint blocks (dual attention on 0..12) at width 1536
    (24 heads x 64), a 24-block control stack, block experts, global
    routing; rope-free."""
    ctrl_overrides.setdefault("use_rope", False)
    return C.UniGenConfig(
        family="sd3",
        sd3=C.SD3BackboneConfig(),
        control=C.ControlConfig(**ctrl_overrides),
        condition_types=tuple(condition_types),
    )


def baseline_configs() -> dict:
    """The ``BASELINE.md`` configurations the port serves so far (model
    config and run settings, as ``unigen_tpu/presets.baseline_configs``)."""
    return {
        # 2. UniGenSD3 depth single-condition (SD3.5-medium, 28-step)
        "sd3_depth_28step": dict(cfg=sd35_medium(("depth",)),
                                 steps=28, resolution=512, guidance=7.0),
    }


def tiny(condition_types=("canny",)) -> C.UniGenConfig:
    return C.UniGenConfig(family="flux", flux=C.tiny_flux_config(),
                          condition_types=tuple(condition_types))
