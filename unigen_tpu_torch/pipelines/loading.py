"""from_pretrained for the port (port of ``unigen_tpu/pipelines/loading.py``):
a diffusers-layout checkpoint directory -> a pipeline on the card.

FLUX: ``transformer/ vae/ text_encoder/ (CLIP-L) text_encoder_2/ (T5-XXL)
tokenizer/ tokenizer_2/ scheduler/``. SD3.5: ``transformer/ vae/
text_encoder/ (CLIP-L) text_encoder_2/ (CLIP-G) text_encoder_3/ (T5-XXL,
optional) tokenizer*/ scheduler/``. SANA: ``transformer/ text_encoder/
(Gemma-2) tokenizer/ scheduler/``, the DC-AE in the native format
(``models/dcae.save_dcae_native``) under ``vae/`` or ``dcae_dir``, and
CLIP-L from ``clip_dir``. Each subfolder's ``config.json`` gives
its configuration; the weights are read by ``io/torch_bridge`` (the
port's own safetensors reader). An optional UniGen adapter checkpoint
gives the control branch; without one, it is the port's control init
from a ``torch.Generator`` seeded 0, warm-started from the base (the JAX
loader draws it from ``PRNGKey(0)``, so the two differ).

Tokenizers load through ``transformers`` where it is installed and the
subfolder holds one; a missing package or directory leaves them None, and
the pipeline then serves embeddings passed by the caller. Every loader
takes ``device`` (CUDA unless "cpu" is named) and ``dtype``.
"""

from __future__ import annotations

import functools
import json
import os
import sys
from typing import Optional, Sequence

import torch

from unigen_tpu_torch import config as cfg_lib
from unigen_tpu_torch.io import serving_cache as serving_cache_lib
from unigen_tpu_torch.io import torch_bridge as tb
from unigen_tpu_torch.io import torch_bridge_sd3 as tb3
from unigen_tpu_torch.models import dcae
from unigen_tpu_torch.models import vae as vae_lib
from unigen_tpu_torch.models.clip_text import CLIPTextConfig
from unigen_tpu_torch.models.gemma_text import GemmaConfig
from unigen_tpu_torch.models.sana import init_sana_unigen_control
from unigen_tpu_torch.models.t5_text import T5Config
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_control
from unigen_tpu_torch.models.unigen_sd3 import init_unigen_sd3_control
from unigen_tpu_torch.ops import quant
from unigen_tpu_torch.pipelines import scheduling
from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline
from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline
from unigen_tpu_torch.pipelines.sd3 import UniGenSD3Pipeline
from unigen_tpu_torch.utils import resolve_device


def _subcfg(root: str, sub: str) -> dict:
    path = os.path.join(root, sub, "config.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def _tokenizer(cls_name: str, path: str):
    """A transformers tokenizer from the local directory ``path``, or None
    where there is no such directory, it holds no tokenizer file (a CLIP
    weights directory without one, as SANA's ``clip_dir`` may be), or
    transformers is missing (a broken tokenizer raises)."""
    names = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "tokenizer.model",
             "spiece.model")
    if not os.path.isdir(path) or not any(os.path.exists(os.path.join(path, n))
                                          for n in names):
        return None
    try:
        import transformers
        return getattr(transformers, cls_name).from_pretrained(path)
    except (ImportError, OSError):
        return None


def _vae_cfg_from_json(raw: dict, scaling: float, shift: float) -> vae_lib.VAEConfig:
    return vae_lib.VAEConfig(
        latent_channels=raw.get("latent_channels", 16),
        block_out_channels=tuple(raw.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=raw.get("layers_per_block", 2),
        norm_num_groups=raw.get("norm_num_groups", 32),
        scaling_factor=raw.get("scaling_factor", scaling),
        shift_factor=raw.get("shift_factor", shift))


def _load_vae(root: str, vae_cfg: vae_lib.VAEConfig, device) -> dict:
    return tb.load_vae(tb.read_checkpoint_dir(os.path.join(root, "vae")),
                       vae_cfg.block_out_channels, vae_cfg.layers_per_block,
                       dtype=torch.float32, device=device)


def _t5_cfg_from_json(raw: dict) -> T5Config:
    return T5Config(vocab_size=raw.get("vocab_size", 32128),
                    d_model=raw.get("d_model", 4096), d_kv=raw.get("d_kv", 64),
                    d_ff=raw.get("d_ff", 10240), num_layers=raw.get("num_layers", 24),
                    num_heads=raw.get("num_heads", 64))


def _clip_cfg_from_json(raw: dict) -> CLIPTextConfig:
    """transformers CLIPTextConfig json -> the port's CLIPTextConfig. Unlike
    the JAX loader it reads ``hidden_act``: CLIP-G (SD3's text_encoder_2)
    uses the exact GELU, CLIP-L quick-GELU."""
    return CLIPTextConfig(
        vocab_size=raw.get("vocab_size", 49408),
        hidden_size=raw.get("hidden_size", 768),
        intermediate_size=raw.get("intermediate_size", 3072),
        num_layers=raw.get("num_hidden_layers", 12),
        num_heads=raw.get("num_attention_heads", 12),
        max_position_embeddings=raw.get("max_position_embeddings", 77),
        eos_token_id=raw.get("eos_token_id", 49407),
        projection_dim=raw.get("projection_dim")
        if raw.get("architectures", [""])[0].endswith("WithProjection") else None,
        hidden_act=raw.get("hidden_act", "quick_gelu"))


def _load_clip_bundle(root: str, sub: str, tok_sub: str, device):
    """(params, cfg, tokenizer) of a CLIP text-encoder subfolder, or None
    where the subfolder is absent. CLIP loads in fp32."""
    enc_dir = os.path.join(root, sub)
    if not os.path.isdir(enc_dir):
        return None
    ccfg = _clip_cfg_from_json(_subcfg(root, sub))
    params = tb.load_clip_text(tb.read_checkpoint_dir(enc_dir), ccfg.num_layers,
                               dtype=torch.float32, device=device)
    return params, ccfg, _tokenizer("CLIPTokenizer", os.path.join(root, tok_sub))


def _quantize_text(params, quantize_text: Optional[str]):
    """The text-tower serving policy (``quant.quantize_text_tower``):
    "w8a8" int8, "w4a8" nibble-packed int4, None as loaded."""
    if params is None or quantize_text is None:
        return params
    if quantize_text not in ("w8a8", "w4a8"):
        raise ValueError(f"quantize_text must be 'w8a8'/'w4a8', got {quantize_text!r}")
    return quant.quantize_text_tower(params, bits=4 if quantize_text == "w4a8" else 8)


def _quantize_unigen_tree(base, control, quantize: Optional[str]):
    """The sd3 / sana serving policy for a loaded {base, control} pair: "w8a8" int8
    everywhere eligible, "w4a8" an int4 base and an int8 adapter; other
    values keep the load dtype."""
    if quantize == "w8a8":
        tree = quant.quantize_tree_streaming({"base": base, "control": control})
        return tree["base"], tree["control"]
    if quantize == "w4a8":
        return (quant.quantize_tree_streaming(base, bits=4),
                quant.quantize_tree_streaming(control, bits=8))
    return base, control


def flux_backbone_from_json(tcfg: dict) -> cfg_lib.FluxBackboneConfig:
    """diffusers FluxTransformer2DModel config.json -> FluxBackboneConfig."""
    return cfg_lib.FluxBackboneConfig(
        in_channels=tcfg.get("in_channels", 64),
        num_layers=tcfg.get("num_layers", 19),
        num_single_layers=tcfg.get("num_single_layers", 38),
        attention_head_dim=tcfg.get("attention_head_dim", 128),
        num_attention_heads=tcfg.get("num_attention_heads", 24),
        joint_attention_dim=tcfg.get("joint_attention_dim", 4096),
        pooled_projection_dim=tcfg.get("pooled_projection_dim", 768),
        guidance_embeds=tcfg.get("guidance_embeds", False),
        axes_dims_rope=tuple(tcfg.get("axes_dims_rope", (16, 56, 56))))


def load_flux_pipeline(root: str, *, condition_types: Sequence[str] = ("canny",),
                       adapter_dir: Optional[str] = None, dtype=torch.bfloat16,
                       control_overrides: Optional[dict] = None,
                       quantize: Optional[str] = None,
                       quantize_text: Optional[str] = None,
                       lora_dir: Optional[str] = None,
                       lora_adapter_names: Optional[Sequence[str]] = None,
                       serving_cache: Optional[str] = None,
                       device=None) -> UniGenFluxPipeline:
    """A UniGenFluxPipeline from a FLUX.1 directory. The control branch is
    the adapter at ``adapter_dir`` (any layout of
    ``torch_bridge.read_adapter_checkpoint``) or the warm-started init.

    ``quantize``: None / "bf16" keeps the load dtype; "w4a8" the serving
    policy (``quant.quantize_unigen_serving``: int4 base and control
    blocks, int8 small pieces); "w8a8" int8 everywhere eligible; both
    through the streaming walk. ``quantize_text`` does the same to CLIP and
    T5. ``serving_cache`` (with ``quantize``): a directory for the quantized
    transformer tree (``io/serving_cache``); a valid cache is read instead
    of the checkpoint and the quantization, a missing one is written after
    the first quantization, and a cache of another topology or policy
    refuses to load. ``lora_dir``: per-condition LoRA experts in the
    reference's per-adapter layout ({lora_dir}/{adapter}/
    pytorch_lora_weights.safetensors, hook.py:48-76), all of them or
    ``lora_adapter_names``, attached to the (possibly quantized) tree
    (``UniGenFluxPipeline.load_lora``)."""
    dev = resolve_device(device)
    flux = flux_backbone_from_json(_subcfg(root, "transformer"))
    cfg = cfg_lib.UniGenConfig(
        family="flux", flux=flux,
        control=cfg_lib.ControlConfig(**(control_overrides or {})),
        condition_types=tuple(condition_types))

    fingerprint = {"family": "flux", "num_layers": flux.num_layers,
                   "num_single_layers": flux.num_single_layers,
                   "inner_dim": flux.inner_dim,
                   "single_control_dev": cfg.control.single_control_dev,
                   "condition_types": list(condition_types),
                   "adapter_dir": bool(adapter_dir)}
    use_cache = quantize in ("w4a8", "w8a8") and serving_cache
    if use_cache and serving_cache_lib.has_serving_tree(serving_cache):
        tree, _ = serving_cache_lib.load_serving_tree(
            serving_cache, quantize=quantize, config_fingerprint=fingerprint, device=dev)
        base, control = tree["base"], tree["control"]
    else:
        base = tb.load_flux_transformer(
            tb.read_checkpoint_dir(os.path.join(root, "transformer")), flux.num_layers,
            flux.num_single_layers, dtype=dtype, device=dev)
        n_cn = flux.num_layers // cfg.control.single_control_dev
        n_cn_s = flux.num_single_layers // cfg.control.single_control_dev
        if adapter_dir:
            control = tb.load_adapter_checkpoint(
                adapter_dir, n_cn=n_cn, n_cn_single=n_cn_s,
                num_experts=cfg.control.moe.num_experts(cfg.condition_nums),
                dtype=dtype, guidance=flux.guidance_embeds, device=dev)
        else:
            control = init_unigen_flux_control(
                cfg, gen=torch.Generator(device=dev).manual_seed(0), device=dev,
                dtype=dtype, base_params=base)
        if quantize in ("w4a8", "w8a8"):
            tree = {"base": base, "control": control}
            tree = (quant.quantize_unigen_serving_streaming(tree) if quantize == "w4a8"
                    else quant.quantize_tree_streaming(tree))
            base, control = tree["base"], tree["control"]
            if use_cache:
                serving_cache_lib.save_serving_tree(
                    tree, serving_cache, quantize=quantize, config_fingerprint=fingerprint)

    vae_cfg = _vae_cfg_from_json(_subcfg(root, "vae"), 0.3611, 0.1159)
    vae_params = _load_vae(root, vae_cfg, dev)
    clip_cfg = _clip_cfg_from_json(_subcfg(root, "text_encoder"))
    clip_params = tb.load_clip_text(
        tb.read_checkpoint_dir(os.path.join(root, "text_encoder")), clip_cfg.num_layers,
        dtype=torch.float32, device=dev)
    t5_cfg = _t5_cfg_from_json(_subcfg(root, "text_encoder_2"))
    t5_params = tb.load_t5_encoder(
        tb.read_checkpoint_dir(os.path.join(root, "text_encoder_2")), t5_cfg.num_layers,
        dtype=dtype, device=dev)
    clip_params = _quantize_text(clip_params, quantize_text)
    t5_params = _quantize_text(t5_params, quantize_text)

    sch = _subcfg(root, "scheduler")
    scheduler = scheduling.FlowMatchConfig(
        shift=sch.get("shift", 1.0),
        use_dynamic_shifting=sch.get("use_dynamic_shifting", False),
        base_shift=sch.get("base_shift", 0.5), max_shift=sch.get("max_shift", 1.15))

    tokenizer = _tokenizer("CLIPTokenizer", os.path.join(root, "tokenizer"))
    tokenizer_2 = _tokenizer("T5TokenizerFast", os.path.join(root, "tokenizer_2"))
    pipe = UniGenFluxPipeline(
        cfg=cfg, params={"base": base, "control": control},
        vae_cfg=vae_cfg, vae_params=vae_params, clip_cfg=clip_cfg,
        clip_params=clip_params, t5_cfg=t5_cfg, t5_params=t5_params,
        scheduler=scheduler, tokenizer=tokenizer, tokenizer_2=tokenizer_2,
        dtype=dtype, device=dev)
    if lora_dir:
        pipe.load_lora(lora_dir, list(lora_adapter_names) if lora_adapter_names else None)
    return pipe


def sd3_backbone_from_json(tcfg: dict) -> cfg_lib.SD3BackboneConfig:
    """diffusers SD3Transformer2DModel config.json -> SD3BackboneConfig."""
    return cfg_lib.SD3BackboneConfig(
        sample_size=tcfg.get("sample_size", 128),
        patch_size=tcfg.get("patch_size", 2),
        in_channels=tcfg.get("in_channels", 16),
        num_layers=tcfg.get("num_layers", 24),
        attention_head_dim=tcfg.get("attention_head_dim", 64),
        num_attention_heads=tcfg.get("num_attention_heads", 24),
        joint_attention_dim=tcfg.get("joint_attention_dim", 4096),
        caption_projection_dim=tcfg.get("caption_projection_dim", 1536),
        pooled_projection_dim=tcfg.get("pooled_projection_dim", 2048),
        out_channels=tcfg.get("out_channels", 16),
        pos_embed_max_size=tcfg.get("pos_embed_max_size", 384),
        dual_attention_layers=tuple(tcfg.get("dual_attention_layers", ())),
        qk_norm=tcfg.get("qk_norm"))


def load_sd3_pipeline(root: str, *, condition_types: Sequence[str] = ("depth",),
                      adapter_dir: Optional[str] = None, dtype=torch.float32,
                      control_overrides: Optional[dict] = None,
                      quantize: Optional[str] = None,
                      quantize_text: Optional[str] = None,
                      device=None) -> UniGenSD3Pipeline:
    """A UniGenSD3Pipeline from an SD3.5 directory. The control branch is the
    safetensors / bin adapter directory ``adapter_dir`` or the warm-started
    init (rope-free unless ``control_overrides`` says otherwise). The text
    encoders load where both CLIP subfolders exist (T5 where
    ``text_encoder_3`` does, else the zero-T5 block); otherwise the pipeline
    serves embeddings passed by the caller. ``quantize`` "w8a8" / "w4a8"
    quantizes the transformer tree (``_quantize_unigen_tree``) and
    ``quantize_text`` the text towers, both streaming."""
    dev = resolve_device(device)
    sd3 = sd3_backbone_from_json(_subcfg(root, "transformer"))
    overrides = dict(control_overrides or {})
    overrides.setdefault("use_rope", False)
    cfg = cfg_lib.UniGenConfig(family="sd3", sd3=sd3,
                               control=cfg_lib.ControlConfig(**overrides),
                               condition_types=tuple(condition_types))

    base = tb3.load_sd3_transformer(
        tb.read_checkpoint_dir(os.path.join(root, "transformer")), sd3, dtype=dtype,
        device=dev)
    n_cn = cfg.control.num_layers or sd3.num_layers
    if adapter_dir:
        control = tb3.load_sd3_unigen_adapter(
            tb.read_checkpoint_dir(adapter_dir), sd3, n_cn,
            cfg.control.moe.num_experts(cfg.condition_nums), dtype=dtype,
            modulated=cfg.control.use_modulate or cfg.control.use_rope, device=dev)
    else:
        control = init_unigen_sd3_control(
            cfg, gen=torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=dtype, base_params=base)
    base, control = _quantize_unigen_tree(base, control, quantize)

    text_encoders = None
    clip_l = _load_clip_bundle(root, "text_encoder", "tokenizer", dev)
    clip_g = _load_clip_bundle(root, "text_encoder_2", "tokenizer_2", dev)
    if clip_l and clip_g:
        t5 = None
        t5_dir = os.path.join(root, "text_encoder_3")
        if os.path.isdir(t5_dir):
            t5_cfg = _t5_cfg_from_json(_subcfg(root, "text_encoder_3"))
            t5_params = tb.load_t5_encoder(tb.read_checkpoint_dir(t5_dir),
                                           t5_cfg.num_layers, dtype=dtype, device=dev)
            t5 = (_quantize_text(t5_params, quantize_text), t5_cfg,
                  _tokenizer("T5TokenizerFast", os.path.join(root, "tokenizer_3")))
        clip_l = (_quantize_text(clip_l[0], quantize_text),) + clip_l[1:]
        clip_g = (_quantize_text(clip_g[0], quantize_text),) + clip_g[1:]
        text_encoders = {"clip_l": clip_l, "clip_g": clip_g, "t5": t5}

    vae_cfg = _vae_cfg_from_json(_subcfg(root, "vae"), 1.5305, 0.0609)
    vae_params = _load_vae(root, vae_cfg, dev)
    scheduler = scheduling.FlowMatchConfig(shift=_subcfg(root, "scheduler").get("shift", 3.0))
    return UniGenSD3Pipeline(cfg=cfg, params={"base": base, "control": control},
                             vae_cfg=vae_cfg, vae_params=vae_params, scheduler=scheduler,
                             text_encoders=text_encoders, dtype=dtype, device=dev)


def sana_backbone_from_json(tcfg: dict) -> cfg_lib.SanaBackboneConfig:
    """diffusers SanaTransformer2DModel config.json -> SanaBackboneConfig
    (``pooled_projection_dim``, the MoE streams' pooled width, is UniGen's
    own field)."""
    return cfg_lib.SanaBackboneConfig(
        in_channels=tcfg.get("in_channels", 32),
        out_channels=tcfg.get("out_channels", 32),
        num_layers=tcfg.get("num_layers", 20),
        attention_head_dim=tcfg.get("attention_head_dim", 32),
        num_attention_heads=tcfg.get("num_attention_heads", 70),
        num_cross_attention_heads=tcfg.get("num_cross_attention_heads", 20),
        cross_attention_head_dim=tcfg.get("cross_attention_head_dim", 112),
        cross_attention_dim=tcfg.get("cross_attention_dim", 2240),
        caption_channels=tcfg.get("caption_channels", 2304),
        mlp_ratio=tcfg.get("mlp_ratio", 2.5),
        patch_size=tcfg.get("patch_size", 1),
        sample_size=tcfg.get("sample_size", 32),
        pooled_projection_dim=tcfg.get("pooled_projection_dim", 768))


def gemma_config_from_json(raw: dict) -> GemmaConfig:
    """transformers Gemma2 config.json -> GemmaConfig (Gemma-2-2B's values
    by default)."""
    return GemmaConfig(
        vocab_size=raw.get("vocab_size", 256000),
        hidden_size=raw.get("hidden_size", 2304),
        intermediate_size=raw.get("intermediate_size", 9216),
        num_layers=raw.get("num_hidden_layers", 26),
        num_heads=raw.get("num_attention_heads", 8),
        num_kv_heads=raw.get("num_key_value_heads", 4),
        head_dim=raw.get("head_dim", 256),
        rms_norm_eps=raw.get("rms_norm_eps", 1e-6),
        rope_theta=raw.get("rope_theta", 10000.0),
        attn_logit_softcapping=raw.get("attn_logit_softcapping", 50.0),
        query_pre_attn_scalar=raw.get("query_pre_attn_scalar", 256.0),
        sliding_window=raw.get("sliding_window", 4096))


def load_sana_pipeline(root: str, *, condition_types: Sequence[str] = ("canny",),
                       adapter_dir: Optional[str] = None, dtype=torch.float32,
                       control_overrides: Optional[dict] = None,
                       quantize: Optional[str] = None,
                       quantize_text: Optional[str] = None,
                       dcae_dir: Optional[str] = None,
                       clip_dir: Optional[str] = None,
                       device=None) -> UniGenSanaPipeline:
    """A UniGenSanaPipeline from a SANA directory. The control branch is the
    reference SANAUniGen adapter at ``adapter_dir`` or the warm-started init;
    ``quantize`` "w8a8" / "w4a8" quantizes the transformer tree
    (``_quantize_unigen_tree``: w4a8 is an int4 base and an int8 adapter)
    and ``quantize_text`` Gemma and CLIP. The latent codec is the native
    DC-AE at ``dcae_dir`` or ``{root}/vae`` (fp32); where neither holds a
    native save, a random DC-AE (``DCAEConfig(latent_channels=in_channels)``
    drawn from a generator seeded 2) is used and a warning printed to
    stderr: its pixels mean nothing. Gemma loads where ``text_encoder/``
    exists, CLIP-L from ``clip_dir`` (its config.json beside the weights);
    without them the pipeline serves embeddings passed by the caller."""
    dev = resolve_device(device)
    sana = sana_backbone_from_json(_subcfg(root, "transformer"))
    cfg = cfg_lib.UniGenConfig(
        family="sana", sana=sana,
        control=cfg_lib.ControlConfig(**(control_overrides or {})),
        condition_types=tuple(condition_types))

    base = tb3.load_sana_transformer(
        tb.read_checkpoint_dir(os.path.join(root, "transformer")), sana, dtype=dtype,
        device=dev)
    n_cn = cfg.control.num_layers or sana.num_layers
    if adapter_dir:
        control = tb3.load_sana_unigen_adapter(
            tb.read_checkpoint_dir(adapter_dir), sana, n_cn,
            cfg.control.moe.num_experts(cfg.condition_nums), dtype=dtype, device=dev)
    else:
        control = init_sana_unigen_control(
            cfg, gen=torch.Generator(device=dev).manual_seed(0), device=dev,
            dtype=dtype, base_params=base)
    base, control = _quantize_unigen_tree(base, control, quantize)

    ae_root = dcae_dir or os.path.join(root, "vae")
    if dcae.has_dcae_native(ae_root):
        ae_params, ae_cfg = dcae.load_dcae_native(ae_root, device=dev)
    else:
        ae_cfg = dcae.DCAEConfig(latent_channels=sana.in_channels)
        ae_params = dcae.init_dcae_params(
            ae_cfg, gen=torch.Generator(device=dev).manual_seed(2), device=dev)
        print(f"# load_sana_pipeline: no native DC-AE at {ae_root}; using a "
              "RANDOM-INIT codec (decoded pixels are meaningless; write released "
              "dc-ae weights with models/dcae.save_dcae_native)", file=sys.stderr)

    gemma_cfg = gemma_params = tokenizer = None
    enc_dir = os.path.join(root, "text_encoder")
    if os.path.isdir(enc_dir):
        gemma_cfg = gemma_config_from_json(_subcfg(root, "text_encoder"))
        gemma_params = _quantize_text(
            tb.load_gemma_text(tb.read_checkpoint_dir(enc_dir), gemma_cfg.num_layers,
                               dtype=dtype, device=dev), quantize_text)
        tokenizer = _tokenizer("AutoTokenizer", os.path.join(root, "tokenizer"))

    clip_cfg = clip_params = tokenizer_clip = None
    if clip_dir:
        raw = {}
        if os.path.exists(os.path.join(clip_dir, "config.json")):
            with open(os.path.join(clip_dir, "config.json")) as f:
                raw = json.load(f)
        clip_cfg = _clip_cfg_from_json(raw)
        clip_params = _quantize_text(
            tb.load_clip_text(tb.read_checkpoint_dir(clip_dir), clip_cfg.num_layers,
                              dtype=torch.float32, device=dev), quantize_text)
        tokenizer_clip = _tokenizer("CLIPTokenizer", clip_dir)

    scheduler = scheduling.FlowMatchConfig(shift=_subcfg(root, "scheduler").get("shift", 3.0))
    return UniGenSanaPipeline(
        cfg=cfg, params={"base": base, "control": control},
        ae_encode=functools.partial(dcae.dcae_encode, ae_params, ae_cfg),
        ae_decode=functools.partial(dcae.dcae_decode, ae_params, ae_cfg),
        ae_downscale=ae_cfg.downscale, gemma_cfg=gemma_cfg, gemma_params=gemma_params,
        clip_cfg=clip_cfg, clip_params=clip_params, tokenizer=tokenizer,
        tokenizer_clip=tokenizer_clip, scheduler=scheduler, dtype=dtype, device=dev)
