"""The SD3 pipeline of the port against the JAX package on the CPU, at the
tiny presets: ``sd3_encode_prompt`` (with T5 and with the zero-T5 block),
the pipeline's prompt encodings, and ``UniGenSD3Pipeline.generate`` on
explicit latents with a negative prompt and a keep-window (start 0.2, end
0.8) in the exact mode, the control cache at interval 2 with int8
residuals, ``cfg_cache``, the order-1 model cache, "balanced" and "fast";
every cache-knob combination JAX refuses. Also the repair that skips the
control blocks' discarded context branch: the kept outputs keep the
parent path's bits in fp32 and bf16.

Tolerances: float pixels and encodings within rtol=atol=2e-3 in fp32 (the
repo's golden), uint8 images within one code, the rest bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_pipeline import StubTokenizer
from torch_port_helpers import assert_close, normal
from unigen_tpu import config as jcfg
from unigen_tpu.models import clip_text as j_clip
from unigen_tpu.models import t5_text as j_t5
from unigen_tpu.models import text_encoder as j_text
from unigen_tpu.models import vae as j_vae
from unigen_tpu.pipelines.sd3 import UniGenSD3Pipeline as JPipe
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.layers import blocks_flux, blocks_sd3
from unigen_tpu_torch.models import clip_text as t_clip
from unigen_tpu_torch.models import t5_text as t_t5
from unigen_tpu_torch.models import text_encoder as t_text
from unigen_tpu_torch.models import unigen_flux as t_unigen_flux
from unigen_tpu_torch.models import unigen_sd3 as t_unigen_sd3
from unigen_tpu_torch.models import vae as t_vae
from unigen_tpu_torch.ops.packing import prepare_latent_image_ids
from unigen_tpu_torch.pipelines.caching import resolve_cache_mode
from unigen_tpu_torch.pipelines.sd3 import UniGenSD3Pipeline as TPipe
from unigen_tpu_torch.utils import tree_map

TOL = 2e-3
SD3 = jcfg.tiny_sd3_config()
RES, STEPS, GUIDANCE, T = 32, 8, 3.0, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _vae_cfg(lib):
    return lib.tiny_vae_config(latent_channels=SD3.in_channels, scaling_factor=1.5305,
                               shift_factor=0.0609)


def _clip_cfgs(lib):
    half = SD3.pooled_projection_dim // 2
    return [lib.tiny_clip_config(hidden_size=half, intermediate_size=2 * half,
                                 max_position_embeddings=77, num_layers=n) for n in (2, 3)]


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tree))


@functools.lru_cache(maxsize=None)
def _trees():
    """fp32 trees drawn by the port's inits from a seed (the JAX inits take
    tens of seconds at these sizes), and the same values as JAX arrays:
    UniGen-SD3 (rope-free control, random add linears), the VAE, CLIP-L,
    CLIP-G and T5."""
    g = torch.Generator().manual_seed(0)
    p = t_unigen_sd3.init_unigen_sd3_params(_tcfg(), gen=g)
    p["control"]["add_blocks"]["w"].uniform_(-0.2, 0.2, generator=g)
    cl, cg = _clip_cfgs(t_clip)
    t = dict(params=p, vae=t_vae.init_vae_params(_vae_cfg(t_vae), gen=g),
             clip_l=t_clip.init_clip_params(cl, gen=g), clip_g=t_clip.init_clip_params(cg, gen=g),
             t5=t_t5.init_t5_params(t_t5.tiny_t5_config(d_model=SD3.joint_attention_dim),
                                    gen=g))
    return {"t": t, "j": {k: _to_jax(v) for k, v in t.items()}}


def _tcfg():
    return tcfg.UniGenConfig(family="sd3", sd3=tcfg.tiny_sd3_config(),
                             condition_types=("depth",),
                             control=tcfg.ControlConfig(use_rope=False))


def _text(lib, t5_lib, tr, t5=True):
    cl, cg = _clip_cfgs(lib)
    out = {"clip_l": (tr["clip_l"], cl, StubTokenizer(128, 90)),
           "clip_g": (tr["clip_g"], cg, StubTokenizer(128, 90)), "t5": None}
    if t5:
        out["t5"] = (tr["t5"], t5_lib.tiny_t5_config(d_model=SD3.joint_attention_dim),
                     StubTokenizer(128, 90))
    return out


def _jax_pipe(t5=True):
    tr = _trees()["j"]
    jc = jcfg.UniGenConfig(family="sd3", sd3=SD3, condition_types=("depth",),
                           control=jcfg.ControlConfig(use_rope=False))
    return JPipe(cfg=jc, params=tr["params"], vae_cfg=_vae_cfg(j_vae), vae_params=tr["vae"],
                 text_encoders=_text(j_clip, j_t5, tr, t5), dtype=jnp.float32)


def _torch_pipe(t5=True, **kw):
    tr = _trees()["t"]
    return TPipe(cfg=_tcfg(), params=tr["params"], vae_cfg=_vae_cfg(t_vae),
                 vae_params=tr["vae"], text_encoders=_text(t_clip, t_t5, tr, t5),
                 dtype=torch.float32, device="cpu", **kw)


def _inputs(b=2, seed=33):
    rng = np.random.default_rng(seed)
    lat = RES // 2
    d, pd = SD3.joint_attention_dim, SD3.pooled_projection_dim
    return dict(prompt_embeds=normal(rng, b, T, d), pooled=normal(rng, b, pd),
                cond_pooled=normal(rng, b, pd), neg_embeds=normal(rng, b, T, d),
                neg_pooled=normal(rng, b, pd),
                control_pixels=rng.uniform(-1, 1, (b, 3, RES, RES)).astype(np.float32),
                latents=normal(rng, b, SD3.in_channels, lat, lat))


def _uint8(pixels):
    imgs = np.clip(np.asarray(pixels, np.float32), -1, 1)
    return ((imgs.transpose(0, 2, 3, 1) + 1) * 127.5).round().astype(np.uint8)


# ---------------------------------------------------------------- prompts

@pytest.mark.parametrize("t5", [True, False])
def test_sd3_encode_prompt_matches_jax(t5):
    """CLIP-L and CLIP-G penultimate states side by side, channel-padded,
    with T5's sequence or the zero block of max_sequence_length after them;
    the pooled embeddings joined."""
    tr = _trees()
    jt, tt = _text(j_clip, j_t5, tr["j"]), _text(t_clip, t_t5, tr["t"])

    def args(te):
        t5p, t5c, tok3 = te["t5"] if t5 else (None, None, None)
        return (te["clip_l"][0], te["clip_l"][1], te["clip_g"][0], te["clip_g"][1], t5p,
                t5c, te["clip_l"][2], te["clip_g"][2], tok3)
    prompts = ["a red cube", "two dogs wearing hats"]
    want = j_text.sd3_encode_prompt(*args(jt), prompts, 12, pad_to_dim=SD3.joint_attention_dim)
    got = t_text.sd3_encode_prompt(*args(tt), prompts, 12, pad_to_dim=SD3.joint_attention_dim)
    assert tuple(got[0].shape) == (2, 77 + 12, SD3.joint_attention_dim)
    for g, w in zip(got, want):
        assert_close(g, w, TOL)
    if not t5:
        assert not got[0][:, 77:].any()


def test_pipeline_prompts_and_call_match_jax_and_generate():
    """The pipeline's encode_prompt and encode_condition_prompt equal JAX's
    (the LRU returns the same tensors again); __call__ with a negative
    prompt equals generate on its encodings bit for bit."""
    jp, tp = _jax_pipe(), _torch_pipe(prompt_cache_size=8)
    for fn in ("encode_prompt", "encode_condition_prompt"):
        arg = "a red cube" if fn == "encode_prompt" else "depth"
        for g, w in zip(*(getattr(p, fn)(arg) if fn == "encode_prompt"
                          else (getattr(p, fn)(arg),) for p in (tp, jp))):
            assert_close(g, w, TOL)
    e, p = tp.encode_prompt("a red cube")
    assert tp.encode_prompt("a red cube")[0] is e and tp._prompt_cache.hits == 2
    x = _inputs(b=1)
    kw = dict(height=RES, width=RES, num_inference_steps=2, guidance_scale=GUIDANCE,
              latents=x["latents"])
    img = tp("a red cube", "depth", x["control_pixels"], negative_prompt="blurry", **kw)
    ne, npool = tp.encode_prompt("blurry")
    want = tp.generate(prompt_embeds=e, pooled=p, cond_pooled=tp.encode_condition_prompt(
        "depth"), neg_embeds=ne, neg_pooled=npool, control_pixels=x["control_pixels"], **kw)
    assert torch.equal(img, want)


# ---------------------------------------------------------------- generate

MODES = [
    ("exact", {}, None),
    ("control_2_int8", dict(control_cache_interval=2, residual_cache_bits=8), 4),
    ("cfg_cache", dict(control_cache_interval=2, cfg_cache=True), 4),
    ("model_2_order_1", dict(model_cache_interval=2, model_cache_order=1), 4),
    ("balanced", dict(quality_profile="balanced"), (1, 3)),
    ("fast", dict(quality_profile="fast"), 2)]


@pytest.mark.parametrize("name,knobs,counts", MODES, ids=[m[0] for m in MODES])
def test_generate_matches_jax(monkeypatch, name, knobs, counts):
    """uint8 images from both pipelines (b=2, negative embeddings, the
    keep-window 0.2-0.8 at conditioning scale 0.9), the float pixels
    before them (JAX's compiled program called again, the port's decoder
    output), and the step counts."""
    x = _inputs()
    kw = dict(height=RES, width=RES, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
              conditioning_scale=0.9, control_guidance_start=0.2, control_guidance_end=0.8)
    jpipe = _jax_pipe(t5=False)
    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    jimg = jpipe.generate(**jargs, **kw, **knobs)
    (program, _), = jpipe._program_cache.values()
    jpix = program(jpipe.params, jpipe.vae_params, jargs["latents"], jargs["control_pixels"],
                   jargs["prompt_embeds"], jargs["pooled"], jargs["cond_pooled"],
                   jargs["neg_embeds"], jargs["neg_pooled"])
    np.testing.assert_array_equal(_uint8(jpix), jimg)

    decoded = []
    real_decode = t_vae.vae_decode

    def keep(*a):
        decoded.append(real_decode(*a))
        return decoded[-1]
    monkeypatch.setattr(t_vae, "vae_decode", keep)
    tpipe = _torch_pipe(t5=False)
    timg = tpipe.generate(**x, **kw, **knobs)
    assert timg.dtype == torch.uint8 and tuple(timg.shape) == jimg.shape == (2, RES, RES, 3)
    assert_close(decoded[0], jpix, TOL)
    assert np.abs(timg.numpy().astype(int) - jimg.astype(int)).max() <= 1
    assert tpipe.last_cache_refreshes == counts


REFUSED = [
    dict(control_cache_threshold=0.1, model_cache_threshold=0.05, control_cache_interval=2),
    dict(control_cache_threshold=0.1, model_cache_threshold=0.05, cfg_cache=True),
    dict(control_cache_threshold=0.05, model_cache_threshold=0.1),
    dict(control_cache_interval=4, model_cache_interval=2, control_cache_threshold=0.1),
    dict(control_cache_interval=4, model_cache_interval=2, cfg_cache=True),
    dict(control_cache_interval=4, model_cache_interval=3),
    dict(control_cache_interval=2, model_cache_interval=4),
    dict(model_cache_interval=2, control_cache_threshold=0.1),
    dict(model_cache_interval=2, cfg_cache=True),
    dict(cfg_cache=True),
    dict(residual_cache_bits=6),
    dict(model_cache_interval=2, residual_cache_bits=8),
    dict(quality_profile="balanced", control_cache_interval=2),
    dict(quality_profile="turbo")]


def test_cache_knob_refusals_match_jax():
    """Every combination JAX's SD3 pipeline refuses, the port refuses (before
    any forward); an sd3 profile with residual bits, which the FLUX
    pipeline refuses, is accepted by both sd3 pipelines' rules."""
    x = _inputs(b=1)
    jpipe, tpipe = _jax_pipe(t5=False), _torch_pipe(t5=False)
    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    for knobs in REFUSED:
        with pytest.raises(ValueError):
            jpipe.generate(**jargs, height=RES, width=RES, num_inference_steps=STEPS, **knobs)
        with pytest.raises(ValueError):
            tpipe.generate(**x, height=RES, width=RES, num_inference_steps=STEPS, **knobs)
    mode = resolve_cache_mode(STEPS, quality_profile="balanced", residual_cache_bits=8,
                              family="sd3")
    assert (mode.interval, mode.hybrid_interval, mode.bits) == (8, 2, 8)
    with pytest.raises(ValueError):
        resolve_cache_mode(STEPS, quality_profile="balanced", residual_cache_bits=8)
    with pytest.raises(NotImplementedError):
        tpipe.shard(None)


# ---------------------------------------------------------------- the discarded context

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipped_context_branch_keeps_the_parent_bits(dtype):
    """flux_double_block and sd3_joint_block with context_out=False return
    the parent path's sample stream bit for bit and no context; the UniGen
    FLUX and SD3 forwards, whose control blocks now skip the branch, give
    the bits of the same forwards with every block on the parent path."""
    g = torch.Generator().manual_seed(0)
    d, heads = 32, 4
    x, ctx, temb = (torch.randn(2, n, d, generator=g).to(dtype) for n in (10, 6, 1))
    temb = temb[:, 0]
    fp = blocks_flux.init_flux_double_block(d, heads, d // heads, gen=g, dtype=dtype)
    sp = blocks_sd3.init_sd3_joint_block(d, heads, d // heads, qk_norm="rms_norm",
                                         gen=g, dtype=dtype)
    for block, p in ((blocks_flux.flux_double_block, fp), (blocks_sd3.sd3_joint_block, sp)):
        c_full, x_full = block(p, x, ctx, temb, heads=heads)
        c_skip, x_skip = block(p, x, ctx, temb, heads=heads, context_out=False)
        assert c_full is not None and c_skip is None and torch.equal(x_skip, x_full)

    def parent(block):
        def call(*a, context_out=True, **kw):
            return block(*a, **kw)
        return call

    flux_cfg = tcfg.UniGenConfig(family="flux", flux=tcfg.tiny_flux_config(),
                                 condition_types=("canny",))
    tp = t_unigen_flux.init_unigen_flux_params(flux_cfg, gen=g, dtype=dtype)
    bb = flux_cfg.flux
    ids = prepare_latent_image_ids(4, 4)
    args = (torch.randn(1, 16, bb.in_channels, generator=g).to(dtype),
            torch.randn(1, 16, bb.in_channels, generator=g).to(dtype),
            torch.randn(1, 5, bb.joint_attention_dim, generator=g).to(dtype),
            torch.randn(1, bb.pooled_projection_dim, generator=g).to(dtype),
            torch.randn(1, bb.pooled_projection_dim, generator=g).to(dtype),
            torch.full((1,), 0.5, dtype=dtype), ids, torch.zeros(5, 3), ids)
    sd3_cfg = tcfg.UniGenConfig(family="sd3", sd3=tcfg.tiny_sd3_config(),
                                condition_types=("depth",),
                                control=tcfg.ControlConfig(use_rope=False))
    sp = t_unigen_sd3.init_unigen_sd3_params(sd3_cfg, gen=g, dtype=dtype)
    sp["control"]["add_blocks"]["w"].uniform_(-0.2, 0.2, generator=g)
    sb = sd3_cfg.sd3
    sargs = (torch.randn(1, sb.in_channels, 8, 8, generator=g).to(dtype),
             torch.randn(1, sb.in_channels, 8, 8, generator=g).to(dtype),
             torch.randn(1, 5, sb.joint_attention_dim, generator=g).to(dtype),
             torch.randn(1, sb.pooled_projection_dim, generator=g).to(dtype),
             torch.randn(1, sb.pooled_projection_dim, generator=g).to(dtype),
             torch.full((1,), 500.0, dtype=dtype))
    for mod, name, fwd, params, cfg, a in (
            (t_unigen_flux, "flux_double_block", t_unigen_flux.unigen_flux_forward, tp,
             flux_cfg, args),
            (t_unigen_sd3, "sd3_joint_block", t_unigen_sd3.unigen_sd3_forward, sp, sd3_cfg,
             sargs)):
        with torch.no_grad():
            now = fwd(params, cfg, *a)[0]
            real = getattr(mod, name)
            setattr(mod, name, parent(real))
            try:
                before = fwd(params, cfg, *a)[0]
            finally:
                setattr(mod, name, real)
        assert now.dtype == dtype and torch.equal(now, before), name


# ---------------------------------------------------------------- chip_smoke's helpers

@pytest.fixture
def counting(monkeypatch):
    """The kernel entry points count their launches on the CPU as they do on
    the card (where the plain versions run uncounted)."""
    import chip_smoke
    from unigen_tpu_torch.ops.cuda import build
    from unigen_tpu_torch.ops.cuda import flash_attention as fa
    from unigen_tpu_torch.ops.cuda import quant_matmul as qm
    for mod, name, counters in ((fa, "flash_attention_fwd", ("norope_launches",)),
                                (qm, "w4a8_matmul", ("launches",)),
                                (qm, "quantize_act", ("quantize_launches",))):
        def counted(*a, _real=getattr(mod, name), _mod=mod, _names=counters, **kw):
            for c in _names:
                build.count(vars(_mod), c)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    chip_smoke.reset_launch_counts()
    yield chip_smoke
    chip_smoke.reset_launch_counts()


def test_chip_sd3_pipeline_launch_formula_and_composition(counting):
    """chip_smoke's SD3 pipeline formulas (phase 8c) equal the launches of
    generate on a W4A8 tree (int4 base, int8 control) with W4A8 text towers
    in the exact, "balanced" and cfg_cache modes, the text towers' per
    encode included; the residual-cache bytes that its probe reads from the
    captured tensors equal its formula; its "balanced" composition gives
    generate's bits and launches."""
    from unigen_tpu_torch.ops import quant
    chip = counting
    pipe = _torch_pipe(prompt_cache_size=8)
    cfg = pipe.cfg
    pipe.params = {"base": quant.quantize_tree(pipe.params["base"], bits=4, min_dim=16),
                   "control": quant.quantize_tree(pipe.params["control"], bits=8,
                                                  min_dim=16)}
    te = pipe.text_encoders
    pipe.text_encoders = {k: (quant.quantize_text_tower(v[0], bits=4, min_dim=16,
                                                        donate=False),) + v[1:]
                          for k, v in te.items()}
    per_prompt = chip.text_launches(*(v[0] for v in pipe.text_encoders.values()))
    assert per_prompt["w4a8_matmul"] > 0
    x = _inputs(b=2)
    steps = 12
    s_img = (RES // pipe.vae_cfg.downscale // cfg.sd3.patch_size) ** 2
    for knobs in ({}, dict(quality_profile="balanced"),
                  dict(control_cache_interval=2, cfg_cache=True, residual_cache_bits=8)):
        chip.reset_launch_counts()
        misses = pipe._prompt_cache.misses
        pipe.encode_prompt(f"prompt {len(knobs)}")
        held = []
        with chip.residual_probe(pipe, held):
            pipe.generate(**x, height=RES, width=RES, num_inference_steps=steps,
                          guidance_scale=GUIDANCE, **knobs)
        mode = resolve_cache_mode(steps, family="sd3", **knobs)
        assert set(held) == ({chip.sd3_residual_cache_bytes(cfg, 2, s_img, mode.bits,
                                                             itemsize=4)}
                             if knobs else set()), (knobs, held)
        kinds = [(2, *chip.step_kinds(mode, pipe.last_cache_refreshes, steps)[:2])]
        want = chip.add_counts((1, chip.expected_sd3_pipeline_launches(pipe.params, cfg,
                                                                      kinds)),
                               (pipe._prompt_cache.misses - misses, per_prompt))
        got = chip.nonzero(chip.launch_counts())
        assert got == want and got["w4a8_matmul"] > 0, (knobs, got, want)

    one = {k: v[:1] for k, v in x.items()}
    kw = dict(height=RES, width=RES, num_inference_steps=steps, guidance_scale=GUIDANCE)
    chip.reset_launch_counts()
    balanced = pipe.generate(**one, **kw, quality_profile="balanced")
    gen_launches = chip.nonzero(chip.launch_counts())
    assert pipe.last_cache_refreshes == (2, 4)
    pipe.denoise = chip.composed_balanced_sd3
    chip.reset_launch_counts()
    by_hand = pipe.generate(**one, **kw)
    assert torch.equal(balanced, by_hand)
    assert chip.nonzero(chip.launch_counts()) == gen_launches == \
        chip.expected_sd3_pipeline_launches(pipe.params, cfg, [(1, 2, 4)])
