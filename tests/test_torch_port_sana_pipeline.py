"""The SANA pipeline of the port against the JAX package on the CPU, at the
tiny presets (``tiny_sana_config`` with a 32-wide caption, ``tiny_gemma_config``,
``tiny_dcae_config``: 32x32 pixels -> 8x8 latents): prompt encoding
(Gemma-2 with its padding mask, CLIP-L pooled), ``generate`` against JAX's
pipeline in the exact mode, "balanced" (the hybrid c=4, m=2) and "fast"
(the order-1 model cache at interval 4, 8 steps), the other cache modes
(int4 control cache, adaptive control / model / hybrid, the keep window)
against a composition of forward calls written out in this file, every
refused knob combination, and chip_smoke's SANA launch formula and path
check on a W4A8 tree with counting kernels. The trees are drawn by the
port's init and handed to JAX as numpy; inputs are numpy draws from a seed.

Tolerances: float pixels within rtol=atol=2e-3 (the repo's golden), uint8
images within one code, the compositions bit for bit."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import assert_close, normal, to_jax_tree
from unigen_tpu import config as jcfg
from unigen_tpu.models import clip_text as j_clip
from unigen_tpu.models import dcae as j_dcae
from unigen_tpu.models import gemma_text as j_gemma
from unigen_tpu.pipelines.sana import UniGenSanaPipeline as JPipe
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.models import clip_text as t_clip
from unigen_tpu_torch.models import dcae as t_dcae
from unigen_tpu_torch.models import gemma_text as t_gemma
from unigen_tpu_torch.models.sana import init_sana_unigen_params, sana_unigen_forward
from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.cuda import quant_matmul as qm
from unigen_tpu_torch.pipelines import caching as t_caching
from unigen_tpu_torch.pipelines import scheduling as t_sched
from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline as TPipe

TOL = 2e-3
RES, T = 32, 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


class StubTokenizer:
    """A tokenizer's call signature: ids from the characters, the eos id
    after the text, 0 padding and the padding mask."""

    def __init__(self, vocab, eos):
        self.vocab, self.eos = vocab, eos

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            codes = [ord(ch) % (self.vocab - 3) + 2 for ch in p][:max_length - 1]
            ids[i, :len(codes) + 1] = codes + [self.eos]

        class Out:
            input_ids = ids
            attention_mask = (ids != 0).astype(np.int32)
        return Out()


def _cfgs():
    sana = dict(caption_channels=32)
    return (jcfg.UniGenConfig(family="sana", sana=jcfg.tiny_sana_config(**sana),
                              condition_types=("canny",)),
            tcfg.UniGenConfig(family="sana", sana=tcfg.tiny_sana_config(**sana),
                              condition_types=("canny",)))


@functools.lru_cache(maxsize=None)
def _trees():
    """The port's fp32 trees (UniGen-SANA with random add linears, Gemma,
    CLIP-L at the pooled width, the DC-AE) and the same leaves for JAX."""
    _, tc = _cfgs()
    g = torch.Generator().manual_seed(0)
    p = init_sana_unigen_params(tc, gen=g, device="cpu")
    p["control"]["add_blocks"]["w"].uniform_(-0.2, 0.2, generator=g)
    gemma = t_gemma.init_gemma_params(t_gemma.tiny_gemma_config(), gen=g, device="cpu")
    clip = t_clip.init_clip_params(_clip_cfg(t_clip), gen=g, device="cpu")
    ae = t_dcae.init_dcae_params(t_dcae.tiny_dcae_config(), gen=g, device="cpu")
    port = dict(params=p, gemma=gemma, clip=clip, ae=ae)
    return port, {k: to_jax_tree(v) for k, v in port.items()}


def _clip_cfg(lib):
    d = tcfg.tiny_sana_config().pooled_projection_dim
    return lib.tiny_clip_config(hidden_size=d, intermediate_size=2 * d,
                                max_position_embeddings=77)


def _jax_pipe():
    jc, _ = _cfgs()
    tr = _trees()[1]
    ae, acfg = tr["ae"], j_dcae.tiny_dcae_config()
    return JPipe(cfg=jc, params=tr["params"],
                 ae_encode=lambda px: j_dcae.dcae_encode(ae, acfg, px),
                 ae_decode=lambda z: j_dcae.dcae_decode(ae, acfg, z),
                 ae_downscale=acfg.downscale, gemma_cfg=j_gemma.tiny_gemma_config(),
                 gemma_params=tr["gemma"], clip_cfg=_clip_cfg(j_clip), clip_params=tr["clip"],
                 tokenizer=StubTokenizer(128, 1), tokenizer_clip=StubTokenizer(128, 90))


def _torch_pipe(params=None, **kw):
    _, tc = _cfgs()
    tr = _trees()[0]
    acfg = t_dcae.tiny_dcae_config()
    return TPipe(cfg=tc, params=params or tr["params"],
                 ae_encode=functools.partial(t_dcae.dcae_encode, tr["ae"], acfg),
                 ae_decode=functools.partial(t_dcae.dcae_decode, tr["ae"], acfg),
                 ae_downscale=acfg.downscale, gemma_cfg=t_gemma.tiny_gemma_config(),
                 gemma_params=tr["gemma"], clip_cfg=_clip_cfg(t_clip),
                 clip_params=tr["clip"], tokenizer=StubTokenizer(128, 1),
                 tokenizer_clip=StubTokenizer(128, 90), device="cpu", **kw)


def _inputs(b=2, seed=40):
    rng = np.random.default_rng(seed)
    bb = tcfg.tiny_sana_config(caption_channels=32)
    mask = np.ones((b, T), np.int32)
    mask[0, 9:], mask[-1, 5:] = 0, 0
    lat = RES // t_dcae.tiny_dcae_config().downscale
    return dict(prompt_embeds=normal(rng, b, T, bb.caption_channels), prompt_mask=mask,
                pooled=normal(rng, b, bb.pooled_projection_dim),
                cond_pooled=normal(rng, b, bb.pooled_projection_dim),
                control_pixels=rng.uniform(-1, 1, (b, 3, RES, RES)).astype(np.float32),
                latents=normal(rng, b, bb.in_channels, lat, lat))


def _uint8(pixels):
    imgs = np.clip(np.asarray(pixels, np.float32), -1, 1)
    return ((imgs.transpose(0, 2, 3, 1) + 1) * 127.5).round().astype(np.uint8)


def test_prompt_encoding_matches_jax():
    """encode_prompt (Gemma and its mask) and encode_pooled (CLIP-L) against
    JAX's pipeline; a repeat hits the LRU."""
    jp, tp = _jax_pipe(), _torch_pipe(prompt_cache_size=4)
    prompts = ["a red cube", "a dog on the grass"]
    je, jm = jp.encode_prompt(prompts, max_sequence_length=T)
    te, tm = tp.encode_prompt(prompts, max_sequence_length=T)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert int((tm == 0).sum()) > 0
    assert_close(te, je, TOL)
    assert_close(tp.encode_pooled("canny"), jp.encode_pooled("canny"), TOL)
    tp.encode_prompt(prompts, max_sequence_length=T)
    assert tp._prompt_cache.hits == 1


@pytest.mark.parametrize("steps,knobs,counts", [
    (2, {}, None),
    (4, dict(quality_profile="balanced"), (1, 1)),
    (8, dict(quality_profile="fast"), 2)])
def test_generate_matches_jax(monkeypatch, steps, knobs, counts):
    """uint8 images of both pipelines, the float pixels before them (JAX's
    compiled program called again, the port's decoder output), and the
    step counts."""
    x = _inputs()
    jpipe = _jax_pipe()
    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    jimg = jpipe.generate(**jargs, height=RES, width=RES, num_inference_steps=steps, **knobs)
    (program, _), = jpipe._program_cache.values()
    jpix = program(jpipe.params, jargs["latents"], jargs["control_pixels"],
                   jargs["prompt_embeds"], jargs["prompt_mask"], jargs["pooled"],
                   jargs["cond_pooled"])
    np.testing.assert_array_equal(_uint8(jpix), jimg)
    tpipe = _torch_pipe()
    decoded = []
    real = tpipe.ae_decode
    tpipe.ae_decode = lambda z: decoded.append(real(z)) or decoded[-1]
    timg = tpipe.generate(**x, height=RES, width=RES, num_inference_steps=steps, **knobs)
    assert timg.dtype == torch.uint8 and tuple(timg.shape) == jimg.shape == (2, RES, RES, 3)
    assert_close(decoded[0], jpix, TOL)
    assert np.abs(timg.numpy().astype(int) - jimg.astype(int)).max() <= 1
    assert tpipe.last_cache_refreshes == counts


def _reference(pipe, x, steps, decide, *, order=0, bits=16, scale=1.0, window=(0.0, 1.0)):
    """The denoise written out as forward calls: ``decide(i, lat, refs)``
    names each step "full" (capture), "base" (replay the residuals) or
    "hold" (replay the prediction; order 1 extrapolates as the hybrid's
    scan does). -> (uint8 images, kinds)."""
    lh = RES // pipe.ae_downscale
    sig, ts = t_sched.inference_sigmas(pipe.scheduler, steps, image_seq_len=lh * lh)
    cond = pipe.ae_encode(torch.from_numpy(x["control_pixels"])).float()
    emb, mask, pool, cpool = (torch.from_numpy(x[k]) for k in
                              ("prompt_embeds", "prompt_mask", "pooled", "cond_pooled"))

    def fwd(lat, i, **kw):
        keep = not (i / steps < window[0] or (i + 1) / steps > window[1])
        t = torch.full((lat.shape[0],), float(ts[i] / 1000.0))
        return sana_unigen_forward(pipe.params, pipe.cfg, lat, cond, emb, pool, cpool, t,
                                   mask, conditioning_scale=float(np.float32(scale * keep)),
                                   **kw)

    lat = torch.from_numpy(x["latents"])
    refs = dict(full=lat, pred=lat)
    res, p1, p0, i1, i0, kinds = None, None, None, -1, -1, []
    for i in range(steps):
        kind = decide(i, lat, refs)
        kinds.append(kind)
        if kind == "full":
            pred, _, outs = fwd(lat, i, return_control_residuals=True,
                                control_residuals_bits=bits)
            res = outs["control_residuals"]
            refs.update(full=lat, pred=lat)
        elif kind == "base":
            pred = fwd(lat, i, control_residuals=res)[0]
            refs["pred"] = lat
        elif order and i0 >= 0:
            pred = p1 + torch.tensor(float(i - i1)) * (p1 - p0) / torch.tensor(
                float(max(i1 - i0, 1)))
        else:
            pred = p1
        if kind in ("full", "base"):
            p1, p0, i1, i0 = pred, p1, i, i1
        lat = t_sched.euler_step(lat, pred, sig[i], sig[i + 1])
    return _uint8(pipe.ae_decode(lat).numpy()), kinds


def _drift(a, b):
    return float(t_caching.rel_change(a, b))


MODES = {
    "control_interval_int4": (dict(control_cache_interval=3, residual_cache_bits=4),
                              dict(decide=lambda i, lat, r: "full" if i % 3 == 0 else "base",
                                   bits=4), 2),
    "control_adaptive": (dict(control_cache_threshold=0.1),
                         dict(decide=lambda i, lat, r: "full" if i == 0 or
                              _drift(lat, r["full"]) > 0.1 else "base"), "count"),
    "model_adaptive": (dict(model_cache_threshold=0.1),
                       dict(decide=lambda i, lat, r: "full" if i == 0 or
                            _drift(lat, r["pred"]) > 0.1 else "hold"), "count"),
    "hybrid_adaptive": (dict(control_cache_threshold=0.25, model_cache_threshold=0.08,
                             model_cache_order=1, residual_cache_bits=8),
                        dict(decide=lambda i, lat, r: "full" if i == 0 or
                             _drift(lat, r["full"]) > 0.25 else "base"
                             if _drift(lat, r["pred"]) > 0.08 else "hold",
                             order=1, bits=8), "pair"),
    "window_scale": (dict(conditioning_scale=0.7, control_guidance_start=0.25,
                          control_guidance_end=0.75),
                     dict(decide=lambda i, lat, r: "full", scale=0.7, window=(0.25, 0.75)),
                     None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_manual_composition(mode):
    knobs, ref, counts = MODES[mode]
    steps = 6
    x = _inputs(seed=41)
    pipe = _torch_pipe()
    img = pipe.generate(**x, height=RES, width=RES, num_inference_steps=steps, **knobs)
    want, kinds = _reference(pipe, x, steps, **ref)
    np.testing.assert_array_equal(img.numpy(), want)
    if counts == "count":
        counts = kinds.count("full")
        assert 1 < counts < steps, kinds
    elif counts == "pair":
        counts = (kinds.count("full"), kinds.count("base"))
        assert len(set(kinds)) == 3, kinds
    assert pipe.last_cache_refreshes == counts


@pytest.mark.parametrize("knobs", [
    dict(control_cache_threshold=0.5, model_cache_threshold=0.1, model_cache_interval=2),
    dict(control_cache_threshold=0.1, model_cache_threshold=0.5),
    dict(control_cache_interval=4, model_cache_interval=2, control_cache_threshold=0.1),
    dict(control_cache_interval=2, model_cache_interval=4),
    dict(model_cache_threshold=0.1, control_cache_interval=2),
    dict(residual_cache_bits=6),
    dict(model_cache_interval=2, residual_cache_bits=8),
    dict(quality_profile="balanced", control_cache_interval=2),
    dict(quality_profile="turbo")])
def test_cache_knob_errors_match_jax(knobs):
    x = _inputs()
    with pytest.raises(ValueError):
        _jax_pipe().generate(**{k: jnp.asarray(v) for k, v in x.items()}, height=RES,
                             width=RES, **knobs)
    with pytest.raises(ValueError):
        _torch_pipe().generate(**x, height=RES, width=RES, **knobs)


def test_call_equals_generate_on_its_encodings():
    """__call__ from prompt strings equals generate on the pipeline's own
    encodings and the noise drawn from its seed; the control pixels reach
    the codec in the pipeline's dtype."""
    pipe = _torch_pipe(prompt_cache_size=8, dtype=torch.bfloat16)
    x = _inputs(b=1, seed=42)
    img = pipe("a red cube", "canny", x["control_pixels"], height=RES, width=RES,
               num_inference_steps=2, max_sequence_length=T, seed=3)
    emb, mask = pipe.encode_prompt("a red cube", T)
    want = pipe.generate(prompt_embeds=emb, prompt_mask=mask,
                         pooled=pipe.encode_pooled("a red cube"),
                         cond_pooled=pipe.encode_pooled("canny"),
                         control_pixels=x["control_pixels"], height=RES, width=RES,
                         num_inference_steps=2, seed=3)
    assert torch.equal(img, want)


@pytest.fixture
def counting(monkeypatch):
    """W4A8 and the activation quantization count their launches on the CPU
    as on the card."""
    for name, counter in (("w4a8_matmul", "launches"), ("quantize_act", "quantize_launches")):
        def counted(*a, _real=getattr(qm, name), _c=counter, **kw):
            build.count(vars(qm), _c)
            return _real(*a, **kw)
        monkeypatch.setattr(qm, name, counted)
    chip_smoke.reset_launch_counts()
    yield
    chip_smoke.reset_launch_counts()


def test_chip_sana_launches_and_path_check(counting):
    """chip_smoke's SANA formulas on a tree quantized by the loader's w4a8
    policy at the tiny widths (int4 base, int8 adapter, gate 16): a full
    forward, a replay and a pipeline of each kind of step; a Gemma encode
    (its layers a list) by text_launches; then the path check helpers hold
    every call against its plain version."""
    from unigen_tpu_torch.ops import quant
    _, tc = _cfgs()
    tr = _trees()[0]
    q = functools.partial(quant.quantize_tree_streaming, min_dim=16, donate=False)
    params = {"base": q(tr["params"]["base"], bits=4),
              "control": q(tr["params"]["control"], bits=8)}
    pipe = _torch_pipe(params=params)
    x = _inputs(seed=43)
    full = chip_smoke.expected_sana_launches(params, tc)
    assert full["w4a8_matmul"] > 0 and full["quantize_act"] > full["w4a8_matmul"]
    chip_smoke.reset_launch_counts()
    img = pipe.generate(**x, height=RES, width=RES, num_inference_steps=4,
                        quality_profile="balanced")
    kinds = [(2, *pipe.last_cache_refreshes)]
    assert chip_smoke.nonzero(chip_smoke.launch_counts()) == \
        chip_smoke.expected_sana_pipeline_launches(params, tc, kinds)
    assert img.shape == (2, RES, RES, 3)
    gemma = quant.quantize_text_tower(tr["gemma"], bits=4, min_dim=16, donate=False)
    ids = StubTokenizer(128, 1)(["a red cube"], max_length=T)
    chip_smoke.reset_launch_counts()
    t_gemma.gemma_encode(gemma, t_gemma.tiny_gemma_config(), ids.input_ids,
                         torch.from_numpy(ids.attention_mask))
    assert chip_smoke.nonzero(chip_smoke.launch_counts()) == chip_smoke.nonzero(
        chip_smoke.text_launches(gemma))
    # the path check of phase 9: every call of a forward recorded and equal
    cond = pipe.encode_control(torch.from_numpy(x["control_pixels"]))
    fwd = chip_smoke.sana_forward(torch, pipe, *(torch.from_numpy(x[k]) for k in (
        "prompt_embeds", "prompt_mask", "pooled", "cond_pooled")), cond, seed=0)
    checks = {}
    with torch.no_grad(), chip_smoke.shadowed_kernels(torch, checks):
        fwd()
    summary = chip_smoke.path_check_summary(checks)
    assert {n: c["calls"] for n, c in summary.items()} == {
        n: v for n, v in full.items() if v}
    assert not any(c["disagree"] for c in summary.values())
    replay = chip_smoke.sana_forward(torch, pipe, *(torch.from_numpy(x[k]) for k in (
        "prompt_embeds", "prompt_mask", "pooled", "cond_pooled")), cond, seed=0,
        replay=True)
    assert torch.equal(replay(), fwd())
