"""The FLUX pipeline of the port against the JAX package on the CPU, at the
tiny presets: the VAE, the CLIP and T5 towers, prompt encoding with a stub
tokenizer, and ``UniGenFluxPipeline.generate`` on explicit latents in the
exact, "balanced" (hybrid, int8 residuals) and order-1 model-cache modes,
at 32x32 and 32x48 pixels. The other cache modes are held against a
composition of forward calls written out in this file; every cache-knob
combination that JAX refuses is refused. JAX trees cross by
``tree_from_numpy``; inputs are numpy draws from a seed.

Tolerances: modules and float pixels within rtol=atol=2e-3 in fp32 (the
repo's golden), uint8 images within one code, the composition bit for
bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import assert_close, normal, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.models import clip_text as j_clip
from unigen_tpu.models import t5_text as j_t5
from unigen_tpu.models import text_encoder as j_text
from unigen_tpu.models import vae as j_vae
from unigen_tpu.models.unigen_flux import init_unigen_flux_params
from unigen_tpu.pipelines.flux import UniGenFluxPipeline as JPipe
from unigen_tpu_torch import presets as t_presets
from unigen_tpu_torch.models import clip_text as t_clip
from unigen_tpu_torch.models import t5_text as t_t5
from unigen_tpu_torch.models import text_encoder as t_text
from unigen_tpu_torch.models import vae as t_vae
from unigen_tpu_torch.models.unigen_flux import UniGenFlux, unigen_flux_forward
from unigen_tpu_torch.ops.packing import (pack_latents, prepare_latent_image_ids,
                                          unpack_latents)
from unigen_tpu_torch.pipelines import caching as t_caching
from unigen_tpu_torch.pipelines import scheduling as t_sched
from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline as TPipe
from unigen_tpu_torch.serving import MicroBatchServer

TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
FLUX = jcfg.tiny_flux_config()
T = 6


class StubTokenizer:
    """A tokenizer's call signature: deterministic ids from the characters,
    padded with 0, the eos id after the text."""

    def __init__(self, vocab, eos):
        self.vocab, self.eos, self.calls = vocab, eos, 0

    def __call__(self, prompts, padding=None, max_length=None, truncation=None,
                 return_tensors=None):
        self.calls += 1
        ids = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            codes = [ord(ch) % (self.eos - 1) + 1 for ch in p][:max_length - 1]
            ids[i, :len(codes) + 1] = codes + [self.eos]

        class Out:
            input_ids = ids
            attention_mask = (ids != 0).astype(np.int32)
        return Out()


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("pixels", ["fp32", "bf16"])
def test_vae_encode_decode_match_jax(pixels):
    """The fp32 VAE casts bf16 control pixels to its own dtype, as JAX's."""
    cfg = j_vae.tiny_vae_config()
    jp = j_vae.init_vae_params(jax.random.PRNGKey(3), cfg)
    tp = to_torch_tree(jp)
    rng = np.random.default_rng(30)
    px = rng.uniform(-1, 1, (2, 3, 32, 48)).astype(np.float32)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if pixels == "bf16"
                else (jnp.float32, torch.float32))
    jl = j_vae.vae_encode(jp, cfg, jnp.asarray(px, jdt))
    tl = t_vae.vae_encode(tp, t_vae.tiny_vae_config(), torch.from_numpy(px).to(tdt))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape == (2, 4, 16, 24)
    assert_close(tl, jl, TOL)
    z = normal(rng, 2, 4, 16, 24)
    assert_close(t_vae.vae_decode(tp, t_vae.tiny_vae_config(), torch.from_numpy(z)),
                 j_vae.vae_decode(jp, cfg, jnp.asarray(z)), TOL)


@pytest.mark.parametrize("eos,projection", [(90, None), (2, 12)])
def test_clip_encode_matches_jax(eos, projection):
    """Last and penultimate hidden states and the EOS-pooled output (the
    legacy eos id 2 pools at the largest id), projected when configured."""
    jcfg_ = j_clip.tiny_clip_config(eos_token_id=eos, projection_dim=projection)
    tcfg_ = t_clip.tiny_clip_config(eos_token_id=eos, projection_dim=projection)
    jp = j_clip.init_clip_params(jax.random.PRNGKey(4), jcfg_)
    rng = np.random.default_rng(31)
    ids = rng.integers(3, 80, size=(2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 4], ids[1, 12] = 90, 90, 90
    jout = j_clip.clip_encode(jp, jcfg_, jnp.asarray(ids))
    tout = t_clip.clip_encode(to_torch_tree(jp), tcfg_, ids)
    for t, j in zip(tout, jout):
        assert tuple(t.shape) == j.shape
        assert_close(t, j, TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_t5_encode_matches_jax(masked):
    cfg = j_t5.tiny_t5_config()
    jp = j_t5.init_t5_params(jax.random.PRNGKey(5), cfg)
    rng = np.random.default_rng(32)
    ids = rng.integers(1, 128, size=(2, 40)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 25:], mask[1, 7:] = 0, 0
    kw = dict(attention_mask=mask) if masked else {}
    want = j_t5.t5_encode(jp, cfg, jnp.asarray(ids), **{k: jnp.asarray(v) for k, v in kw.items()})
    got = t_t5.t5_encode(to_torch_tree(jp), t_t5.tiny_t5_config(), ids, **kw)
    assert_close(got, want, TOL)
    np.testing.assert_array_equal(
        t_t5.relative_position_buckets(40, 40, 32, 128),
        j_t5.relative_position_buckets(40, 40, 32, 128))


# ---------------------------------------------------------------- pipelines

def _clip_cfg(lib):
    return lib.tiny_clip_config(hidden_size=FLUX.pooled_projection_dim,
                                intermediate_size=2 * FLUX.pooled_projection_dim,
                                max_position_embeddings=77)


@functools.lru_cache(maxsize=None)
def _trees():
    """JAX fp32 trees (UniGen-FLUX with random add linears, VAE, CLIP, T5)."""
    jc = jcfg.UniGenConfig(family="flux", flux=FLUX, condition_types=("canny",))
    p = init_unigen_flux_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(100)
    for k in ("add_double", "add_single"):
        w = p["control"][k]["w"]
        p["control"][k]["w"] = jnp.asarray(
            rng.uniform(-0.2, 0.2, size=w.shape).astype(np.float32))
    return dict(cfg=jc, params=p,
                vae=j_vae.init_vae_params(jax.random.PRNGKey(3), j_vae.tiny_vae_config()),
                clip=j_clip.init_clip_params(jax.random.PRNGKey(1), _clip_cfg(j_clip)),
                t5=j_t5.init_t5_params(jax.random.PRNGKey(2), j_t5.tiny_t5_config(
                    d_model=FLUX.joint_attention_dim)))


def _tokenizers():
    return StubTokenizer(128, 90), StubTokenizer(128, 90)


def _jax_pipe():
    tr = _trees()
    return JPipe(cfg=tr["cfg"], params=tr["params"], vae_cfg=j_vae.tiny_vae_config(),
                 vae_params=tr["vae"], clip_cfg=_clip_cfg(j_clip), clip_params=tr["clip"],
                 t5_cfg=j_t5.tiny_t5_config(d_model=FLUX.joint_attention_dim),
                 t5_params=tr["t5"], dtype=jnp.float32)


def _torch_pipe(**kw):
    tr = _trees()
    tok, tok2 = _tokenizers()
    return TPipe(cfg=t_presets.tiny(("canny",)), params=to_torch_tree(tr["params"]),
                 vae_cfg=t_vae.tiny_vae_config(), vae_params=to_torch_tree(tr["vae"]),
                 clip_cfg=_clip_cfg(t_clip), clip_params=to_torch_tree(tr["clip"]),
                 t5_cfg=t_t5.tiny_t5_config(d_model=FLUX.joint_attention_dim),
                 t5_params=to_torch_tree(tr["t5"]), tokenizer=tok, tokenizer_2=tok2,
                 dtype=torch.float32, device="cpu", **kw)


def _inputs(h, w, b=2, k=None, seed=33):
    rng = np.random.default_rng(seed)
    s = (h // 4) * (w // 4)
    lead = (b,) if k is None else (k, b)
    return dict(prompt_embeds=normal(rng, b, T, FLUX.joint_attention_dim),
                pooled=normal(rng, b, FLUX.pooled_projection_dim),
                cond_pooled=normal(rng, *lead, FLUX.pooled_projection_dim),
                control_pixels=rng.uniform(-1, 1, (*lead, 3, h, w)).astype(np.float32),
                latents=normal(rng, b, s, FLUX.in_channels))


def _uint8(pixels):
    """The JAX pipeline's last step: clip, to HWC, scale, round."""
    imgs = np.clip(np.asarray(pixels, np.float32), -1, 1)
    return ((imgs.transpose(0, 2, 3, 1) + 1) * 127.5).round().astype(np.uint8)


@pytest.mark.parametrize("h,w,steps,knobs,counts", [
    (32, 48, 2, {}, None),
    (32, 32, 4, dict(quality_profile="balanced"), (1, 1)),
    (32, 48, 4, dict(model_cache_interval=2, model_cache_order=1), 2)])
def test_generate_matches_jax(monkeypatch, h, w, steps, knobs, counts):
    """uint8 images from both pipelines, the float pixels before them (JAX's
    compiled program called again, the port's decoder output), and the step
    counts."""
    x = _inputs(h, w)
    jpipe = _jax_pipe()
    jargs = {k: jnp.asarray(v) for k, v in x.items()}
    jimg = jpipe.generate(**jargs, height=h, width=w, num_inference_steps=steps, **knobs)
    (program, _), = jpipe._program_cache.values()
    jpix = program(jpipe.params, jpipe.vae_params, jargs["latents"],
                   jargs["control_pixels"], jargs["prompt_embeds"], jargs["pooled"],
                   jargs["cond_pooled"], jnp.zeros_like(jargs["prompt_embeds"]),
                   jnp.zeros_like(jargs["pooled"]), jnp.asarray(0.0))
    np.testing.assert_array_equal(_uint8(jpix), jimg)

    decoded = []
    real_decode = t_vae.vae_decode

    def keep(*a):
        decoded.append(real_decode(*a))
        return decoded[-1]
    monkeypatch.setattr(t_vae, "vae_decode", keep)
    tpipe = _torch_pipe()
    timg = tpipe.generate(**x, height=h, width=w, num_inference_steps=steps, **knobs)
    assert timg.dtype == torch.uint8 and tuple(timg.shape) == jimg.shape == (2, h, w, 3)
    assert_close(decoded[0], jpix, TOL)
    assert np.abs(timg.numpy().astype(int) - jimg.astype(int)).max() <= 1
    assert tpipe.last_cache_refreshes == counts


def _reference(pipe, x, h, w, steps, decide, *, order=0, slope_first=True, bits=16,
               true_cfg=1.0, cfg_cache=False, scale=1.0, window=(0.0, 1.0),
               offsets=0.0):
    """The denoise written out as forward calls: ``decide(i, lat, refs)``
    names each step "full" (capture), "base" (replay the residuals),
    "delta" (replay the positive stream and reuse the guidance delta) or
    "hold" (replay the prediction). Returns (uint8 images, kinds)."""
    cfg, dev = pipe.cfg, "cpu"
    lh, lw = h // 2, w // 2
    sig, ts = t_sched.inference_sigmas(pipe.scheduler, steps,
                                       image_seq_len=(lh // 2) * (lw // 2))
    px = torch.from_numpy(x["control_pixels"])
    multi = px.dim() == 5

    def enc(p, off):
        lat = pack_latents(t_vae.vae_encode(pipe.vae_params, pipe.vae_cfg, p))
        return lat, prepare_latent_image_ids(lh // 2, lw // 2, off)
    if multi:
        lats, idss = zip(*(enc(p, o) for p, o in zip(px, offsets)))
        cond, cond_ids = torch.stack(lats), torch.stack(idss)
    else:
        cond, cond_ids = enc(px, offsets)
    emb, pool, cpool = (torch.from_numpy(x[k]) for k in
                        ("prompt_embeds", "pooled", "cond_pooled"))
    streams = [(emb, pool)] + ([(torch.zeros_like(emb), torch.zeros_like(pool))]
                               if true_cfg > 1 else [])
    b = emb.shape[0]
    img_ids = prepare_latent_image_ids(lh // 2, lw // 2)

    def fwd(lat, i, e, p, **kw):
        keep = not (i / steps < window[0] or (i + 1) / steps > window[1])
        t = torch.full((b,), float(ts[i] / 1000.0))
        return unigen_flux_forward(pipe.params, cfg, lat, cond, e, p, cpool, t, img_ids,
                                   torch.zeros(T, 3), cond_ids,
                                   conditioning_scale=float(np.float32(scale * keep)),
                                   **kw)

    def combine(preds):
        return preds[1] + true_cfg * (preds[0] - preds[1]) if len(preds) == 2 else preds[0]

    lat = torch.from_numpy(x["latents"])
    refs = dict(full=lat, pred=lat)
    res, p1, p0, i1, i0, delta, kinds = None, None, None, -1, -1, None, []
    for i in range(steps):
        kind = decide(i, lat, refs)
        kinds.append(kind)
        if kind == "full":
            outs = [fwd(lat, i, *s, return_control_residuals=True,
                        control_residuals_bits=bits) for s in streams]
            preds = [o[0] for o in outs]
            res = [o[2]["control_residuals"] for o in outs]
            pred = combine(preds)
            if true_cfg > 1:
                delta = preds[0] - preds[1]
            refs.update(full=lat, pred=lat)
        elif kind == "base":
            pred = combine([fwd(lat, i, *s, control_residuals=r)[0]
                            for s, r in zip(streams, res)])
            refs["pred"] = lat
        elif kind == "delta":
            pred = fwd(lat, i, *streams[0], control_residuals=res[0])[0] + (
                true_cfg - 1.0) * delta
        elif order and i0 >= 0:
            dt, gap = torch.tensor(float(max(i1 - i0, 1))), torch.tensor(float(i - i1))
            pred = p1 + gap * ((p1 - p0) / dt) if slope_first else p1 + gap * (p1 - p0) / dt
        else:
            pred = p1
        if kind in ("full", "base"):
            p1, p0, i1, i0 = pred, p1, i, i1
        lat = t_sched.euler_step(lat, pred, sig[i], sig[i + 1])
    pixels = t_vae.vae_decode(pipe.vae_params, pipe.vae_cfg, unpack_latents(lat, lh, lw))
    return _uint8(pixels.numpy()), kinds


def _drift(a, b):
    return float(t_caching.rel_change(a, b))


def _every(k, other):
    return lambda i, lat, refs: "full" if i % k == 0 else other


MODES = {
    # knobs of generate, reference arguments, the expected last_cache_refreshes
    "control_interval_fp32": (dict(control_cache_interval=2), dict(decide=_every(2, "base")), 3),
    "control_interval_int4": (dict(control_cache_interval=3, residual_cache_bits=4),
                              dict(decide=_every(3, "base"), bits=4), 2),
    "control_adaptive": (dict(control_cache_threshold=0.15),
                         dict(decide=lambda i, lat, r: "full" if i == 0 or _drift(lat, r["full"]) > 0.15
                              else "base"), "count"),
    "cfg_cache": (dict(control_cache_interval=2, cfg_cache=True, true_cfg_scale=2.0),
                  dict(decide=_every(2, "delta"), true_cfg=2.0), 3),
    "cfg_no_cache": (dict(control_cache_interval=2, true_cfg_scale=2.0),
                     dict(decide=_every(2, "base"), true_cfg=2.0), 3),
    "model_adaptive": (dict(model_cache_threshold=0.15),
                       dict(decide=lambda i, lat, r: "full" if i == 0 or _drift(lat, r["pred"]) > 0.15
                            else "hold"), "count"),
    "hybrid_adaptive": (dict(control_cache_threshold=0.3, model_cache_threshold=0.12,
                             model_cache_order=1, residual_cache_bits=8),
                        dict(decide=lambda i, lat, r: "full" if i == 0 or _drift(lat, r["full"]) > 0.3
                             else "base" if _drift(lat, r["pred"]) > 0.12 else "hold",
                             order=1, slope_first=False, bits=8), "pair"),
    "window_scale": (dict(conditioning_scale=0.7, control_guidance_start=0.25,
                          control_guidance_end=0.75),
                     dict(decide=lambda i, lat, r: "full", scale=0.7, window=(0.25, 0.75)), None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_generate_matches_manual_composition(mode):
    knobs, ref, counts = MODES[mode]
    h, w, steps = 32, 48, 5
    x = _inputs(h, w, seed=34)
    pipe = _torch_pipe()
    img = pipe.generate(**x, height=h, width=w, num_inference_steps=steps, **knobs)
    want, kinds = _reference(pipe, x, h, w, steps, **ref)
    np.testing.assert_array_equal(img.numpy(), want)
    n_full, n_base = kinds.count("full"), kinds.count("base") + kinds.count("delta")
    if counts == "count":
        counts = n_full
        assert 1 < n_full < steps, kinds          # the threshold decides something
    elif counts == "pair":
        counts = (n_full, n_base)
        assert len(set(kinds)) == 3, kinds
    assert pipe.last_cache_refreshes == counts


def test_multi_condition_subject_offsets_match_composition():
    """K=2 joint conditions, the second a subject condition: its ids shift
    by the latent width / 2."""
    h, w, steps = 32, 48, 2
    x = _inputs(h, w, k=2, seed=35)
    pipe = _torch_pipe()
    img = pipe.generate(**x, height=h, width=w, num_inference_steps=steps,
                        subject_offset=[False, True])
    want, _ = _reference(pipe, x, h, w, steps, lambda i, lat, r: "full",
                         offsets=[0.0, (w // 2) / 2.0])
    np.testing.assert_array_equal(img.numpy(), want)


@pytest.mark.parametrize("knobs", [
    dict(control_cache_threshold=0.5, model_cache_threshold=0.1, model_cache_interval=2),
    dict(control_cache_threshold=0.5, model_cache_threshold=0.1, cfg_cache=True),
    dict(control_cache_threshold=0.1, model_cache_threshold=0.5),
    dict(control_cache_interval=4, model_cache_interval=2, control_cache_threshold=0.1),
    dict(control_cache_interval=4, model_cache_interval=2, cfg_cache=True),
    dict(control_cache_interval=2, model_cache_interval=4),
    dict(control_cache_interval=6, model_cache_interval=4),
    dict(model_cache_threshold=0.1, control_cache_interval=2),
    dict(model_cache_interval=2, cfg_cache=True),
    dict(cfg_cache=True),
    dict(residual_cache_bits=6),
    dict(model_cache_interval=2, residual_cache_bits=8),
    dict(quality_profile="balanced", control_cache_interval=2),
    dict(quality_profile="turbo")])
def test_cache_knob_errors_match_jax(knobs):
    x = _inputs(32, 32)
    with pytest.raises(ValueError):
        _jax_pipe().generate(**{k: jnp.asarray(v) for k, v in x.items()}, height=32,
                             width=32, **knobs)
    with pytest.raises(ValueError):
        _torch_pipe().generate(**x, height=32, width=32, **knobs)


def test_fast_profile_degrades_to_balanced_under_min_steps():
    x = _inputs(32, 32)
    pipe = _torch_pipe()
    with pytest.warns(UserWarning, match="degrading to 'balanced'"):
        img = pipe.generate(**x, height=32, width=32, num_inference_steps=4,
                            quality_profile="fast")
    assert pipe.last_cache_refreshes == (1, 1)
    np.testing.assert_array_equal(
        img.numpy(), pipe.generate(**x, height=32, width=32, num_inference_steps=4,
                                   quality_profile="balanced").numpy())


def test_prompt_encoding_and_call_match_jax_and_generate():
    """encode_prompt / encode_condition_prompt against JAX's and against
    text_encoder.flux_encode_prompt; repeats hit the LRU; __call__ equals
    generate on the same encodings and the latents drawn from its seed."""
    tr = _trees()
    jpipe = _jax_pipe()
    jpipe.tokenizer, jpipe.tokenizer_2 = _tokenizers()
    pipe = _torch_pipe(prompt_cache_size=4)
    je, jpool = jpipe.encode_prompt(["a red cube", "a dog"], max_sequence_length=24)
    te, tpool = pipe.encode_prompt(["a red cube", "a dog"], max_sequence_length=24)
    assert_close(te, je, TOL)
    assert_close(tpool, jpool, TOL)
    calls = pipe.tokenizer.calls
    assert pipe.encode_prompt(["a red cube", "a dog"], max_sequence_length=24)[0] is te
    assert pipe.tokenizer.calls == calls and pipe._prompt_cache.hits == 1
    c1 = pipe.encode_condition_prompt("canny")
    assert pipe.encode_condition_prompt("canny") is c1
    assert_close(c1, jpipe.encode_condition_prompt("canny"), TOL)
    assert (pipe._prompt_cache.hits, pipe._prompt_cache.misses) == (2, 2)

    tok, tok2 = _tokenizers()
    ccfg, t5cfg = _clip_cfg(j_clip), j_t5.tiny_t5_config(d_model=FLUX.joint_attention_dim)
    jf = j_text.flux_encode_prompt(tr["clip"], ccfg, tr["t5"], t5cfg, tok, tok2,
                                   ["a red cube"], max_sequence_length=24)
    tf = t_text.flux_encode_prompt(pipe.clip_params, _clip_cfg(t_clip), pipe.t5_params,
                                   pipe.t5_cfg, tok, tok2, ["a red cube"],
                                   max_sequence_length=24)
    for t, j in zip(tf, jf):
        assert_close(t, j, TOL)
    assert_close(t_text.encode_pooled_only(pipe.clip_params, _clip_cfg(t_clip), tok, ["x"]),
                 j_text.encode_pooled_only(tr["clip"], ccfg, tok, ["x"]), TOL)

    rng = np.random.default_rng(36)
    image = rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    img = pipe("a red cube", "canny", image, height=32, width=32, num_inference_steps=2,
               max_sequence_length=24, seed=5)
    e, p = pipe.encode_prompt("a red cube", max_sequence_length=24)
    want = pipe.generate(prompt_embeds=e, pooled=p, cond_pooled=c1,
                         control_pixels=image, height=32, width=32,
                         num_inference_steps=2, seed=5)
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_multi_condition_call_equals_generate_on_its_encodings():
    """One pooled embedding and control image per condition, stacked; a
    "subject" condition gets its id offset."""
    pipe = _torch_pipe(prompt_cache_size=8)
    rng = np.random.default_rng(38)
    images = [rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32) for _ in range(2)]
    img = pipe.multi_condition_call("a red cube", ["canny", "subject"], images,
                                    height=32, width=32, num_inference_steps=2,
                                    max_sequence_length=24, seed=6)
    e, p = pipe.encode_prompt("a red cube", max_sequence_length=24)
    want = pipe.generate(
        prompt_embeds=e, pooled=p,
        cond_pooled=torch.stack([pipe.encode_condition_prompt(c) for c in ("canny", "subject")]),
        control_pixels=torch.stack([torch.from_numpy(i) for i in images]),
        subject_offset=[False, True], height=32, width=32, num_inference_steps=2, seed=6)
    np.testing.assert_array_equal(img.numpy(), want.numpy())


def test_served_through_micro_batch_server():
    pipe = _torch_pipe()
    srv = MicroBatchServer(lambda x: pipe.generate(**x, height=32, width=32,
                                                   num_inference_steps=2,
                                                   quality_profile="balanced"),
                           batch_size=2, max_wait_ms=200)
    try:
        reqs = [{k: v[:1] for k, v in _inputs(32, 32, seed=40 + r).items()} for r in range(4)]
        outs = [f.result(timeout=120) for f in [srv.submit(**r) for r in reqs]]
    finally:
        srv.close()
    assert all(o.dtype == torch.uint8 and tuple(o.shape) == (1, 32, 32, 3) for o in outs)
    assert srv.stats.requests == 4 and srv.stats.batches <= 4


def test_unported_parts_raise_and_device_defaults_to_cuda():
    """Multi-card serving still raises; an adapter switch before
    ``load_lora`` and one to an adapter never loaded raise; with no LoRA
    loaded the per-call switch is a no-op."""
    pipe = _torch_pipe()
    with pytest.raises(NotImplementedError, match="parallel"):
        pipe.shard(None)
    assert pipe._auto_switch("canny") is None
    with pytest.raises(ValueError, match="load_lora"):
        pipe.set_condition_adapter("canny")
    pipe.load_lora({})
    with pytest.raises(KeyError, match="canny"):
        pipe.set_condition_adapter("canny")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TPipe(cfg=pipe.cfg, params=pipe.params)


def test_denoise_takes_a_non_square_grid():
    """UniGenFlux.denoise on a 8x12 latent grid (4x6 packed tokens) against
    the forward loop with ids from prepare_latent_image_ids(4, 6)."""
    tr = _trees()
    cfg = t_presets.tiny(("canny",))
    params = to_torch_tree(tr["params"])
    rng = np.random.default_rng(37)
    lat, cond = normal(rng, 2, 24, FLUX.in_channels), normal(rng, 2, 24, FLUX.in_channels)
    enc, pool, cpool = (normal(rng, 2, T, FLUX.joint_attention_dim),
                        normal(rng, 2, FLUX.pooled_projection_dim),
                        normal(rng, 2, FLUX.pooled_projection_dim))
    model = UniGenFlux(cfg, params, device="cpu", dtype=torch.float32)
    out = model.denoise(lat, cond, enc, pool, cpool, num_steps=2, latent_hw=(8, 12))
    ids = prepare_latent_image_ids(4, 6)
    sig, _ = t_sched.inference_sigmas(t_sched.FlowMatchConfig(shift=1.0), 2)
    x = torch.from_numpy(lat)
    for i in range(2):
        pred, _, _ = unigen_flux_forward(
            params, cfg, x, torch.from_numpy(cond), torch.from_numpy(enc),
            torch.from_numpy(pool), torch.from_numpy(cpool), torch.full((2,), float(sig[i])),
            ids, torch.zeros(T, 3), ids)
        x = t_sched.euler_step(x, pred, sig[i], sig[i + 1])
    assert torch.equal(out, x)
    with pytest.raises(ValueError, match="latent_hw"):
        model.denoise(lat, cond, enc, pool, cpool, num_steps=1)
