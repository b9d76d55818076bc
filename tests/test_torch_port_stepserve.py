"""The port's StepServer (step-level continuous batching) on the CPU, at the
tiny presets of the JAX package's own StepServer tests.

Held against JAX's ``StepServer`` fed the same requests in the same
admission pattern: flux exact, the hybrid (c=4, k=2) with int8 residuals,
the adaptive hybrid under ``adaptive_lag=1``; sd3 exact (with per-request
guidance, steps and default negatives) and the hybrid with int8 residuals.
Held against the port's own ``UniGenFluxPipeline.generate`` (which
``tests/test_torch_port_pipeline.py`` holds against JAX): ``multi_tick``,
the model cache (order 0 and 1), the hybrid (2, 1), int4 residuals, the
adaptive model / control / hybrid rules, lag 1 at a tight threshold (the
fixed interval 2), mixed per-request guidance, steps and keep-windows, and
``MultiResolutionStepServer``. Then the serving semantics of the JAX
tests: slot reuse, cancellation, priority, admission timeout and
backpressure, the hybrid error path, warm-up, the refusals.

JAX trees cross by ``to_torch_tree``; inputs are numpy draws from a seed.
Tolerance: uint8 images within one code (the JAX tests' own, fp32)."""

import functools
import sys
import threading
import time
import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from torch_port_helpers import to_jax_tree, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.models import vae as j_vae
from unigen_tpu.models.unigen_flux import init_unigen_flux_params
from unigen_tpu.models.unigen_sd3 import init_unigen_sd3_params
from unigen_tpu.serving_steps import StepServer as JServer
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.models import vae as t_vae
from unigen_tpu_torch.ops.cuda import build
from unigen_tpu_torch.ops.cuda import flash_attention as fa
from unigen_tpu_torch.ops.cuda import quant_matmul as qm
from unigen_tpu_torch.pipelines.flux import UniGenFluxPipeline as TPipe
from unigen_tpu_torch.serving_steps import (AdmissionRejected,
                                            MultiResolutionStepServer, StepServer)

FLUX_VAE = dict(latent_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                norm_num_groups=4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny forwards are many small ops: one intra-op thread keeps them
    from fighting the other test workers for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# ---------------------------------------------------------------- worlds

@functools.lru_cache(maxsize=None)
def _flux_world(guidance=False):
    """(JAX cfg, JAX params, JAX VAE cfg, JAX VAE, port cfg, port params,
    port VAE cfg, port VAE): the JAX tests' tiny_world (live add gates)."""
    jc = jcfg.UniGenConfig(
        family="flux", flux=jcfg.tiny_flux_config(guidance_embeds=guidance),
        condition_types=("canny",),
        control=jcfg.ControlConfig(moe=jcfg.MoEConfig(batch_mode="per_sample")))
    p = init_unigen_flux_params(jax.random.PRNGKey(0), jc)
    p["control"]["add_double"]["w"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(9), p["control"]["add_double"]["w"].shape)
    jv = j_vae.VAEConfig(**FLUX_VAE)
    vp = j_vae.init_vae_params(jax.random.PRNGKey(1), jv)
    tc = tcfg.UniGenConfig(
        family="flux", flux=tcfg.tiny_flux_config(guidance_embeds=guidance),
        condition_types=("canny",),
        control=tcfg.ControlConfig(moe=tcfg.MoEConfig(batch_mode="per_sample")))
    return (jc, p, jv, vp, tc, to_torch_tree(p), t_vae.VAEConfig(**FLUX_VAE),
            to_torch_tree(vp))


@functools.lru_cache(maxsize=None)
def _sd3_world():
    jc = jcfg.UniGenConfig(
        family="sd3", sd3=jcfg.tiny_sd3_config(), condition_types=("depth",),
        control=jcfg.ControlConfig(use_rope=False,
                                   moe=jcfg.MoEConfig(batch_mode="per_sample")))
    p = init_unigen_sd3_params(jax.random.PRNGKey(0), jc)
    p["control"]["add_blocks"]["w"] = p["control"]["add_blocks"]["w"] + 0.05 * \
        jax.random.normal(jax.random.PRNGKey(9), p["control"]["add_blocks"]["w"].shape)
    jv = j_vae.tiny_vae_config(latent_channels=jc.sd3.in_channels)
    vp = j_vae.init_vae_params(jax.random.PRNGKey(1), jv)
    tc = tcfg.UniGenConfig(
        family="sd3", sd3=tcfg.tiny_sd3_config(), condition_types=("depth",),
        control=tcfg.ControlConfig(use_rope=False,
                                   moe=tcfg.MoEConfig(batch_mode="per_sample")))
    return (jc, p, jv, vp, tc, to_torch_tree(p),
            t_vae.tiny_vae_config(latent_channels=tc.sd3.in_channels), to_torch_tree(vp))


def _request(i, res=32, flux_cfg=None):
    """One flux request (leading dim 1) drawn with numpy from seed ``i``."""
    bb = flux_cfg or tcfg.tiny_flux_config()
    r = np.random.default_rng(1000 + i)
    s = (res // 4) ** 2
    return dict(prompt_embeds=r.standard_normal((1, 8, bb.joint_attention_dim), np.float32),
                pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
                cond_pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
                control_pixels=r.standard_normal((1, 3, res, res), np.float32),
                latents=r.standard_normal((1, s, bb.in_channels), np.float32))


SD3_RES = 16     # tiny VAE downscale 2: 8x8 latents, 16 patches


def _sd3_request(i, negatives=True):
    bb = tcfg.tiny_sd3_config()
    r = np.random.default_rng(2000 + i)
    x = dict(prompt_embeds=r.standard_normal((1, 6, bb.joint_attention_dim), np.float32),
             neg_embeds=r.standard_normal((1, 6, bb.joint_attention_dim), np.float32),
             pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
             neg_pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
             cond_pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
             control_pixels=r.standard_normal((1, 3, SD3_RES, SD3_RES), np.float32),
             latents=r.standard_normal((1, bb.in_channels, SD3_RES // 2, SD3_RES // 2),
                                       np.float32))
    if not negatives:
        del x["neg_embeds"], x["neg_pooled"]
    return x


def _as_np(img):
    return img.numpy() if isinstance(img, torch.Tensor) else np.asarray(img)


def _assert_codes(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        out, ref = _as_np(out), _as_np(ref)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        diff = np.abs(out.astype(np.int32) - ref.astype(np.int32)).max()
        assert diff <= 1, f"max diff {diff}"


def _serve(server, reqs, per_req=None):
    """Submit every request at once (the JAX tests' staggered admission:
    the first tick may start with only the first request), then reuse a
    slot for the first request again; returns the images and the stats."""
    per_req = per_req or [{}] * len(reqs)
    futs = [server.submit(**r, **k) for r, k in zip(reqs, per_req)]
    outs = [f.result(timeout=300) for f in futs]
    outs.append(server.submit(**reqs[0], **per_req[0]).result(timeout=300))
    st = server.stats()
    server.close()
    assert st["failed"] == 0, st
    return outs, st


def _port(world, **kw):
    *_, tc, tp, tv, tvp = world
    kw.setdefault("batch_size", 4)
    kw.setdefault("height", 32)
    kw.setdefault("width", 32)
    return StepServer(tc, tp, tv, tvp, dtype=torch.float32, device="cpu", **kw)


def _jax(world, **kw):
    jc, jp, jv, jvp, *_ = world
    kw.setdefault("batch_size", 4)
    kw.setdefault("height", 32)
    kw.setdefault("width", 32)
    return JServer(jc, jp, jv, jvp, dtype=jnp.float32, **kw)


def _jax_req(r):
    return {k: jnp.asarray(v) for k, v in r.items()}


def _pipe(world):
    *_, tc, tp, tv, tvp = world
    return TPipe(cfg=tc, params=tp, vae_cfg=tv, vae_params=tvp, dtype=torch.float32,
                 device="cpu")


def _pipeline_refs(world, reqs, steps, per_req=None, res=32, **knobs):
    pipe = _pipe(world)
    per_req = per_req or [{}] * len(reqs)
    return [pipe.generate(**r, height=res, width=res,
                          **{"num_inference_steps": steps, **k}, **knobs)
            for r, k in zip(reqs, per_req)]


# ---------------------------------------------------------------- against JAX

FLUX_JAX_MODES = {
    "exact": (3, {}),
    "hybrid_4_2_int8": (5, dict(control_cache_interval=4, model_cache_interval=2,
                                residual_cache_bits=8)),
    # the tiny model drifts ~0.09 a step: under lag 1 a request runs full,
    # skip, skip, base, skip, full
    "adaptive_lag1": (6, dict(control_cache_threshold=0.25, model_cache_threshold=0.12,
                              adaptive_lag=1)),
}


@pytest.mark.parametrize("mode", list(FLUX_JAX_MODES))
def test_flux_matches_jax_step_server(mode):
    steps, knobs = FLUX_JAX_MODES[mode]
    world = _flux_world()
    reqs = [_request(i) for i in range(3)]
    jsrv = _jax(world, num_inference_steps=steps, **knobs)
    want, jst = _serve(jsrv, [_jax_req(r) for r in reqs])
    got, st = _serve(_port(world, num_inference_steps=steps, **knobs), reqs)
    _assert_codes(got, want)
    for key in ("retired", "rows_full", "rows_base", "rows_refresh"):
        assert st[key] == jst[key], (key, st, jst)


SD3_JAX_MODES = {
    # per-request guidance and steps; the third request takes the default
    # (zero) negatives
    "exact": (3, {}, [dict(guidance_scale=2.0), dict(num_inference_steps=4,
                                                     guidance_scale=6.5), {}]),
    "hybrid_4_2_int8": (5, dict(control_cache_interval=4, model_cache_interval=2,
                                residual_cache_bits=8), None),
}


@pytest.mark.parametrize("mode", list(SD3_JAX_MODES))
def test_sd3_matches_jax_step_server(mode):
    steps, knobs, per_req = SD3_JAX_MODES[mode]
    world = _sd3_world()
    reqs = [_sd3_request(i, negatives=i != 2) for i in range(3)]
    kw = dict(num_inference_steps=steps, guidance_scale=3.0, height=SD3_RES,
              width=SD3_RES, **knobs)
    want, jst = _serve(_jax(world, **kw), [_jax_req(r) for r in reqs], per_req)
    got, st = _serve(_port(world, **kw), reqs, per_req)
    _assert_codes(got, want)
    assert got[0].shape == (1, SD3_RES, SD3_RES, 3)
    for key in ("retired", "rows_full", "rows_base", "rows_refresh"):
        assert st[key] == jst[key], (key, st, jst)


# ------------------------------------------------------ against the pipeline

PIPELINE_MODES = {
    "model_cache_o0": (5, dict(model_cache_interval=2)),
    "model_cache_o1": (5, dict(model_cache_interval=2, model_cache_order=1)),
    "control_only_2": (5, dict(control_cache_interval=2, model_cache_interval=1)),
    "hybrid_4_2_int4": (5, dict(control_cache_interval=4, model_cache_interval=2,
                                residual_cache_bits=4)),
    "model_thr": (6, dict(model_cache_threshold=0.15)),
    "control_thr": (6, dict(control_cache_threshold=0.15)),
    "hybrid_thr": (6, dict(control_cache_threshold=0.25, model_cache_threshold=0.12)),
}


@pytest.mark.parametrize("mode", list(PIPELINE_MODES))
def test_cache_modes_match_pipeline(mode):
    """Each slot on its own schedule; staggered admissions mix the slots'
    levels in one tick, and the slot reuse starts a fresh step-0 refresh."""
    steps, knobs = PIPELINE_MODES[mode]
    world = _flux_world()
    reqs = [_request(10 + i) for i in range(3)]
    refs = _pipeline_refs(world, reqs, steps, **knobs)
    outs, st = _serve(_port(world, num_inference_steps=steps, **knobs), reqs)
    _assert_codes(outs, refs + refs[:1])
    assert st["ticks_replay"] + st["rows_base"] > 0 or "thr" in mode, st


def test_multi_tick_matches_pipeline():
    """multi_tick=3 at full occupancy (2 slots, 5 blocking submits from
    threads): windows run, retirements land at window boundaries, each
    output equals its one-shot pipeline."""
    world = _flux_world()
    steps = 4
    reqs = [_request(20 + i) for i in range(5)]
    refs = _pipeline_refs(world, reqs, steps)
    srv = _port(world, batch_size=2, num_inference_steps=steps, multi_tick=3)
    futs = [None] * len(reqs)

    def feed(i):
        futs[i] = srv.submit(**reqs[i], wait=True)
    threads = [threading.Thread(target=feed, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    outs = [f.result(timeout=300) for f in futs]
    st = srv.stats()
    assert srv.prewarm_multi_tick() == 2
    srv.close()
    assert st["ticks_fused"] >= 1 and st["retired"] == len(reqs), st
    _assert_codes(outs, refs)
    with pytest.raises(AssertionError, match="multi_tick fuses EXACT ticks only"):
        _port(world, batch_size=2, model_cache_interval=2, multi_tick=2)


def test_adaptive_lag_tight_equals_interval_2():
    """A tight threshold under adaptive_lag=1 is the fixed per-slot interval
    2 (every measured decision refreshes, every refresh suppresses the next
    decision): the one-shot pipeline at model_cache_interval=2, resp. the
    control cache at interval 2, including a second request on the slot."""
    world = _flux_world()
    steps = 5
    for knobs, ref_knobs in ((dict(model_cache_threshold=1e-6),
                              dict(model_cache_interval=2)),
                             (dict(control_cache_threshold=1e-6),
                              dict(control_cache_interval=2))):
        reqs = [_request(30 + i) for i in range(2)]
        refs = _pipeline_refs(world, reqs, steps, **ref_knobs)
        srv = _port(world, batch_size=1, num_inference_steps=steps, adaptive_lag=1,
                    **knobs)
        outs = [srv.submit(**r).result(timeout=300) for r in reqs]
        st = srv.stats()
        srv.close()
        assert st["failed"] == 0
        _assert_codes(outs, refs)


def test_adaptive_lag_refresh_accounting():
    """Lag 1 pays no extra refreshes: at a loose threshold each request
    refreshes once (its step 0) and every other tick replays, for a fresh
    occupant of the slot too; the loose control threshold runs full once
    and base on every later step."""
    world = _flux_world()
    steps = 6
    srv = _port(world, batch_size=1, num_inference_steps=steps,
                model_cache_threshold=10.0, adaptive_lag=1)
    srv.submit(**_request(40)).result(timeout=300)
    srv.submit(**_request(41)).result(timeout=300)
    st = srv.stats()
    srv.close()
    assert st["rows_refresh"] == 2 and st["ticks_replay"] == 2 * (steps - 1), st
    srv = _port(world, batch_size=2, num_inference_steps=5,
                control_cache_threshold=10.0, adaptive_lag=1)
    srv.submit(**_request(42)).result(timeout=300)
    st = srv.stats()
    srv.close()
    assert st["rows_full"] == 1 and st["rows_base"] == 4, st


@pytest.mark.parametrize("knobs", [{}, dict(control_cache_interval=4,
                                            model_cache_interval=2)],
                         ids=["exact", "hybrid_4_2"])
def test_per_request_knobs_match_pipeline(knobs):
    """Three concurrent requests with different step counts, guidance
    scales (guidance embeddings on) and keep-windows: each equals the
    one-shot pipeline with its own knobs."""
    world = _flux_world(guidance=True)
    reqs = [_request(50 + i) for i in range(3)]
    per_req = [dict(num_inference_steps=3, guidance_scale=1.0),
               dict(num_inference_steps=5, guidance_scale=7.0,
                    control_guidance_start=0.4),
               dict(num_inference_steps=4, guidance_scale=3.5,
                    control_guidance_end=0.6)]
    refs = _pipeline_refs(world, reqs, None, per_req, **knobs)
    srv = _port(world, num_inference_steps=4, guidance_scale=2.0, **knobs)
    futs = [srv.submit(**r, **k) for r, k in zip(reqs, per_req)]
    outs = [f.result(timeout=300) for f in futs]
    st = srv.stats()
    srv.close()
    assert st["submitted"] == 3 and st["failed"] == 0
    assert st["ticks"] >= 5 and 0.0 < st["mean_occupancy"] <= 1.0
    _assert_codes(outs, refs)


def test_multires_routes_and_matches_pipeline():
    """One shared tree, one bucket per resolution: routed by resolution= or
    by the control image's shape, each equal to the pipeline at its size;
    an unserved resolution is refused; stats per bucket and in total."""
    world = _flux_world()
    *_, tc, tp, tv, tvp = world
    steps = 2
    r_small, r_big = _request(60, 32), _request(61, 64)
    refs = (_pipeline_refs(world, [r_small], steps, res=32)
            + _pipeline_refs(world, [r_big], steps, res=64))
    srv = MultiResolutionStepServer(
        tc, tp, tv, tvp, buckets={32: dict(batch_size=2), (64, 64): dict(batch_size=1)},
        num_inference_steps=steps, dtype=torch.float32, device="cpu")
    assert (srv.servers[(32, 32)].params["base"]["proj_out"]["w"]
            is srv.servers[(64, 64)].params["base"]["proj_out"]["w"])
    f_small = srv.submit(**r_small)
    f_big = srv.submit(resolution=64, **r_big)
    outs = [f_small.result(timeout=300), f_big.result(timeout=300)]
    with pytest.raises(KeyError, match="no bucket for resolution"):
        srv.submit(resolution=128, **r_small)
    st = srv.stats()
    srv.close()
    assert outs[0].shape == (1, 32, 32, 3) and outs[1].shape == (1, 64, 64, 3)
    _assert_codes(outs, refs)
    assert st["32x32"]["retired"] == 1 and st["64x64"]["retired"] == 1
    assert st["total"]["retired"] == 2 and st["total"]["failed"] == 0


# ---------------------------------------------------------------- semantics

def test_slot_reuse_and_errors():
    world = _flux_world()
    srv = _port(world, batch_size=2, num_inference_steps=2)
    for f in [srv.submit(**_request(70 + i)) for i in range(2)]:
        f.result(timeout=300)
    img = srv.submit(**_request(72)).result(timeout=300)
    assert img.dtype == torch.uint8 and tuple(img.shape) == (1, 32, 32, 3)
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(**_request(73))


def test_cancel_frees_slot():
    """Future.cancel() reclaims the slot at the next tick boundary: a
    blocked submit on the full server admits, and its output is exact."""
    world = _flux_world()
    req_a, req_b = _request(80), _request(81)
    ref_b = _pipeline_refs(world, [req_b], 3)[0]
    srv = _port(world, batch_size=1, num_inference_steps=40)
    fa_ = srv.submit(**req_a)
    assert fa_.cancel()
    out_b = srv.submit(**req_b, num_inference_steps=3, wait=True).result(timeout=300)
    st = srv.stats()
    srv.close()
    with pytest.raises(cf.CancelledError):
        fa_.result(timeout=0)
    assert st["cancelled"] == 1 and st["failed"] == 0 and st["retired"] == 1
    _assert_codes([out_b], [ref_b])


def test_cancel_row_independence():
    """Cancelling one in-flight request leaves its tick-mates exact (model
    cache on, so the swept slot's cache indices must not leak into the next
    occupant)."""
    world = _flux_world()
    steps = 5
    reqs = [_request(90 + i) for i in range(3)]
    refs = _pipeline_refs(world, reqs, steps, model_cache_interval=2)
    srv = _port(world, num_inference_steps=steps, model_cache_interval=2)
    futs = [srv.submit(**r) for r in reqs]
    assert futs[1].cancel()
    outs = [futs[0].result(timeout=300), futs[2].result(timeout=300)]
    outs.append(srv.submit(**reqs[1], wait=True).result(timeout=300))
    st = srv.stats()
    srv.close()
    assert st["cancelled"] == 1 and st["failed"] == 0
    assert not futs[0].cancel()
    _assert_codes(outs, [refs[0], refs[2], refs[1]])


def _wait_for_heap(srv, n):
    for _ in range(3000):
        with srv._work:
            if len(srv._wait_heap) == n:
                return
        time.sleep(0.01)
    raise AssertionError(f"waiter {n} never queued")


def test_priority_admission():
    """A freed slot goes to the highest-priority waiter, not the first."""
    world = _flux_world()
    reqs = [_request(100 + i) for i in range(3)]
    srv = _port(world, batch_size=1, num_inference_steps=3)
    f0 = srv.submit(**reqs[0], num_inference_steps=500)
    retired, futs = [], {}

    def blocked_submit(name, req, prio):
        f = srv.submit(**req, wait=True, priority=prio)
        futs[name] = f
        f.add_done_callback(lambda _: retired.append(name))

    t_low = threading.Thread(target=blocked_submit, args=("low", reqs[1], 0), daemon=True)
    t_low.start()
    _wait_for_heap(srv, 1)
    t_high = threading.Thread(target=blocked_submit, args=("high", reqs[2], 5),
                              daemon=True)
    t_high.start()
    _wait_for_heap(srv, 2)
    assert f0.cancel()
    for t in (t_low, t_high):
        t.join(timeout=300)
        assert not t.is_alive()
    for f in futs.values():
        f.result(timeout=300)
    srv.close()
    assert retired == ["high", "low"], retired
    _assert_codes([futs["high"].result()], _pipeline_refs(world, reqs[2:], 3))


def test_admission_timeout_and_backpressure():
    world = _flux_world()
    reqs = [_request(110 + i) for i in range(4)]
    srv = _port(world, batch_size=1, num_inference_steps=3, max_waiters=1)
    f0 = srv.submit(**reqs[0], num_inference_steps=500)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="admission window"):
        srv.submit(**reqs[1], wait=True, timeout=0.3)
    assert time.monotonic() - t0 >= 0.3
    with srv._work:
        assert not srv._wait_heap
    holder = {}
    t = threading.Thread(target=lambda: holder.setdefault(
        "f", srv.submit(**reqs[2], wait=True)), daemon=True)
    t.start()
    _wait_for_heap(srv, 1)
    t1 = time.monotonic()
    with pytest.raises(AdmissionRejected, match="admission queue full"):
        srv.submit(**reqs[3], wait=True)
    assert time.monotonic() - t1 < 0.3
    # a strictly higher priority passes the cap (and then times out)
    with pytest.raises(TimeoutError, match="admission window"):
        srv.submit(**reqs[3], wait=True, priority=5, timeout=0.2)
    with pytest.raises(ValueError, match="wait=True"):
        srv.submit(**reqs[3], wait=False, timeout=1.0)
    with pytest.raises(AdmissionRejected, match="no free slot"):
        srv.submit(**reqs[3])
    assert f0.cancel()
    t.join(timeout=300)
    assert not t.is_alive()
    assert tuple(holder["f"].result(timeout=300).shape) == (1, 32, 32, 3)
    st = srv.stats()
    srv.close()
    assert st["timed_out"] == 2 and st["rejected"] == 1
    assert st["retired"] == 1 and st["cancelled"] == 1


def test_hybrid_error_path_rebuilds_residuals():
    """A failed full forward fails the tick's futures, rebuilds the residual
    buffers and forces full refreshes: the next request is exact."""
    world = _flux_world()
    req = _request(120)
    ref = _pipeline_refs(world, [req], 3, control_cache_interval=2)[0]
    srv = _port(world, batch_size=2, num_inference_steps=3, control_cache_interval=2)
    real, armed = srv._fwd, {"on": True}

    def poisoned(*a, **kw):
        if kw.get("return_control_residuals") and armed["on"]:
            armed["on"] = False
            armed["res"] = srv._res
            raise RuntimeError("injected tick failure")
        return real(*a, **kw)
    srv._fwd = poisoned
    with pytest.raises(RuntimeError, match="injected tick failure"):
        srv.submit(**req).result(timeout=300)
    # the server frees the slots and rebuilds the buffers before it fails
    # the futures
    assert all(s.free for s in srv._slots)
    assert srv._res[0] is not armed["res"][0]
    out = srv.submit(**req).result(timeout=300)
    st = srv.stats()
    srv.close()
    assert st["failed"] == 1
    _assert_codes([out], [ref])


def test_warmup_then_serve():
    world = _flux_world()
    steps = 5
    req = _request(130)
    knobs = dict(control_cache_interval=4, model_cache_interval=2)
    ref = _pipeline_refs(world, [req], steps, **knobs)[0]
    srv = _port(world, batch_size=2, num_inference_steps=steps, **knobs)
    n = srv.warmup(req["prompt_embeds"].shape[1])
    assert n == 2 * srv.B
    st = srv.stats()
    assert st["retired"] == n and st["failed"] == 0
    out = srv.submit(**req).result(timeout=300)
    srv.close()
    _assert_codes([out], [ref])


def test_refusals():
    """The JAX server's knob assertions (a sana server needs its latent
    codec, a sana request takes no guidance), and the part that waits for
    a later slice: mesh= (item 8)."""
    world = _flux_world()
    *_, tc, tp, tv, tvp = world
    for kw, match in ((dict(model_cache_interval=2, model_cache_threshold=0.02),
                       "replace the fixed intervals"),
                      (dict(control_cache_threshold=0.02, model_cache_threshold=0.05),
                       "control_cache_threshold >"),
                      (dict(adaptive_lag=1), "adaptive_lag needs"),
                      (dict(control_cache_interval=4, model_cache_interval=3),
                       "hybrid needs"),
                      (dict(residual_cache_bits=6), "residual_cache_bits")):
        with pytest.raises(AssertionError, match=match):
            _port(world, **kw)
    with pytest.raises(AssertionError, match="per-sample MoE routing"):
        StepServer(tcfg.UniGenConfig(family="flux", flux=tc.flux), tp, tv, tvp,
                   device="cpu")
    with pytest.raises(AssertionError, match="DC-AE codec"):
        StepServer(tcfg.UniGenConfig(family="sana", control=tc.control), tp, tv, tvp,
                   device="cpu")
    srv = _sana_port(batch_size=1, num_inference_steps=1)
    with pytest.raises(ValueError, match="without guidance"):
        srv.submit(**_sana_request(0), guidance_scale=3.0)
    srv.close()
    with pytest.raises(NotImplementedError, match="item 8"):
        _port(world, mesh=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        MultiResolutionStepServer(tc, tp, tv, tvp, buckets={32: {}}, mesh=object(),
                                  device="cpu")


def test_launch_counters_exact_under_threads():
    """The kernel wrappers' launch counters are shared by the bucket
    workers of a MultiResolutionStepServer: concurrent counting loses no
    update."""
    saved = sys.getswitchinterval()
    before_fa, before_qm = fa.norope_launches, qm.quantize_launches
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(2000):
                build.count(vars(fa), "norope_launches")
                build.count(vars(qm), "quantize_launches")
        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert fa.norope_launches - before_fa == 16000
    assert qm.quantize_launches - before_qm == 16000
    fa.norope_launches, qm.quantize_launches = before_fa, before_qm


@pytest.fixture
def counting(monkeypatch):
    """The four kernel entry points count their launches on the CPU as they
    do on the card (where the plain versions run uncounted)."""
    for mod, name, counters in ((fa, "flash_attention_rope_fwd", ("launches",
                                                                    "rotate_launches")),
                                (fa, "flash_attention_fwd", ("norope_launches",)),
                                (qm, "w4a8_matmul", ("launches",)),
                                (qm, "quantize_act", ("quantize_launches",))):
        def counted(*a, _real=getattr(mod, name), _mod=mod, _names=counters, **kw):
            for c in _names:
                build.count(vars(_mod), c)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    chip_smoke.reset_launch_counts()
    yield
    chip_smoke.reset_launch_counts()


def test_chip_launch_formulas_match_served_forwards(counting):
    """chip_smoke's launch formulas for the forwards a server dispatched
    (logged by wrapping its family forward, as phases 4c and 8b do) equal
    the counts, with full and replaying forwards at several gathered
    sizes: flux on a tree quantized W4A8/W8A8 at the tiny widths, sd3 with
    its CFG pair and per-sample block experts."""
    from unigen_tpu_torch.ops.quant import quantize_tree
    *_, tc, tp, tv, tvp = _flux_world()
    q = {"base": quantize_tree(tp["base"], min_dim=16, bits=4),
         "control": {k: quantize_tree(v, min_dim=16, bits=4 if k in (
             "double_blocks", "single_blocks") else 8) for k, v in tp["control"].items()}}
    srv = StepServer(tc, q, tv, tvp, batch_size=4, height=32, width=32,
                     num_inference_steps=5, control_cache_interval=4,
                     model_cache_interval=2, residual_cache_bits=8,
                     dtype=torch.float32, device="cpu")
    calls = chip_smoke.forward_log(srv)
    _serve(srv, [_request(140 + i) for i in range(3)])
    assert {kind for _, kind in calls} == {"full", "replay"}
    got = chip_smoke.nonzero(chip_smoke.launch_counts())
    assert got == chip_smoke.flux_forward_launches(q, tc, calls)
    assert got["w4a8_matmul"] > 0 and "w4a8_general" not in got

    chip_smoke.reset_launch_counts()
    *_, sc, sp, sv, svp = _sd3_world()
    srv = StepServer(sc, sp, sv, svp, batch_size=4, height=SD3_RES, width=SD3_RES,
                     num_inference_steps=5, guidance_scale=3.0,
                     control_cache_interval=4, model_cache_interval=2,
                     dtype=torch.float32, device="cpu")
    calls = chip_smoke.forward_log(srv)
    _serve(srv, [_sd3_request(150 + i) for i in range(3)])
    assert {kind for _, kind in calls} == {"full", "replay"}
    assert chip_smoke.nonzero(chip_smoke.launch_counts()) == \
        chip_smoke.sd3_forward_launches(sc, calls)


def test_exact_server_equals_pipeline_bit_for_bit():
    """In fp32 the exact server's final latents equal the one-shot
    pipeline's bit for bit, with requests admitted together at mixed
    steps. The server divides the timesteps by 1000 as the pipeline does;
    the JAX server multiplies by 1e-3, one float32 ulp off at 750 (step 1
    of a 4-step schedule), which moved the port's fp32 latents by up to
    1e-2 through the top-1 routing before it divided."""
    assert np.float32(750.0) * 1e-3 != np.float32(750.0) / np.float32(1000.0)
    world = _flux_world()
    reqs = [{k: torch.from_numpy(v) for k, v in _request(160 + i).items()}
            for i in range(3)]
    ref_lat = chip_smoke.pipeline_finals(torch, _pipe(world), reqs, {}, 32)[0]
    srv = _port(world, num_inference_steps=chip_smoke.STEPS)
    np.testing.assert_array_equal(srv._timesteps,
                                  np.float32([1000.0, 750.0, 500.0, 250.0]) / 1000)
    rows, order = chip_smoke.decode_log(srv), []
    futs = chip_smoke.serve_requests(torch, srv, reqs, [0, 1, 2], order, {})
    for f in futs.values():
        f.result(timeout=300)
    srv.close()
    got = dict(zip(order, rows))
    for k in range(3):
        assert torch.equal(got[k], ref_lat[k:k + 1]), k


@pytest.mark.parametrize("mode", ["exact", "exact_multi_tick_4", "model_cache_2_order_1",
                                  "hybrid_4_2_int8"])
def test_chip_reference_shapes_check(mode):
    """chip_smoke's equal-shape comparison (stepserve_check at reduced
    depth): requests served in pairs one tick apart, or all at one tick
    under multi_tick, run every forward at the reference's shapes, and
    their final latents equal the one-shot pipeline's within
    STEPSERVE_REL_L2."""
    knobs = dict(chip_smoke.STEPSERVE_MODES)[mode]
    world = _flux_world()
    reqs = [{k: torch.from_numpy(v) for k, v in _request(170 + i).items()}
            for i in range(4)]
    srv = _port(world, num_inference_steps=chip_smoke.STEPS, **knobs)
    try:
        got, calls, st, _ = chip_smoke.serve_at_reference_shapes(srv, reqs, knobs)
    finally:
        srv.close()
    assert chip_smoke.at_reference_shapes(srv, knobs, calls, st), calls
    exact = not chip_smoke.pipeline_knobs(knobs)
    ref_lat, ref_img, _ = chip_smoke.pipeline_finals(torch, _pipe(world), reqs, knobs, 32,
                                                     batch=4 if exact else 1)
    rels, codes = chip_smoke.compare_finals(torch, reqs, got, ref_lat, ref_img)
    assert max(rels) <= chip_smoke.STEPSERVE_REL_L2 and max(codes) <= 1, (rels, codes)


def test_chip_sd3_server_path_check():
    """chip_smoke's sd3_server_path_check (stepserve_sd3_check) on the tiny
    sd3 server: every attention call of an exact tick, a gathered full and
    a base-with-replay forward is recorded, as many as the formulas say,
    and the replay of bf16-exact residuals gives the full forward's
    prediction."""
    *_, sc, sp, sv, svp = _sd3_world()
    srv = StepServer(sc, sp, sv, svp, batch_size=4, height=SD3_RES, width=SD3_RES,
                     num_inference_steps=5, guidance_scale=3.0,
                     control_cache_interval=4, model_cache_interval=2,
                     dtype=torch.float32, device="cpu")
    reqs = [_sd3_request(180 + i, negatives=False) for i in range(4)]
    try:
        x = {k: torch.cat([torch.from_numpy(r[k]) for r in reqs])
             for k in ("latents", "prompt_embeds", "pooled", "cond_pooled")}
        cond = torch.cat([srv._encode(torch.from_numpy(r["control_pixels"]))
                          for r in reqs])
        path_check, expected, replay, outs = chip_smoke.sd3_server_path_check(
            torch, srv, x, cond, 3.0)
    finally:
        srv.close()
    for k, c in path_check.items():
        assert set(c) == {"flash_attention"}, c
        assert c["flash_attention"]["calls"] == expected[k] > 0, (k, c, expected)
        assert c["flash_attention"]["disagree"] == 0
    assert replay["bits"] == 16 and replay["rel_l2"] <= replay["bound"], replay
    assert all(torch.isfinite(t).all() for t in outs)


@pytest.mark.parametrize("family", ["flux", "sd3"])
def test_closed_server_is_freed_without_the_collector(family):
    """A closed server whose last reference is dropped is freed by reference
    counting alone: nothing it holds (the VAE ends, the worker threads)
    refers back to it, so its trees, residual buffers and caches go at once,
    without waiting for ``gc.collect()``. The same holds after chip_smoke's
    wrappers (``forward_log``, ``decode_log``, ``serve_staggered``) have
    been on it, as on the card."""
    import gc
    import weakref
    if family == "flux":
        srv = _port(_flux_world(), batch_size=2, num_inference_steps=2)
        reqs = [_request(80), _request(81)]
    else:
        srv = _port(_sd3_world(), batch_size=2, num_inference_steps=2,
                    height=SD3_RES, width=SD3_RES)
        reqs = [_sd3_request(80), _sd3_request(81)]
    chip_smoke.forward_log(srv)
    chip_smoke.decode_log(srv)
    for f in chip_smoke.serve_staggered(srv, reqs):
        f.result(timeout=300)
    srv.close()
    ref = weakref.ref(srv)
    was = gc.isenabled()
    gc.disable()
    try:
        del srv
        assert ref() is None, gc.get_referrers(ref())
    finally:
        if was:
            gc.enable()


# ------------------------------------------------------------ sana

SANA_RES = 32    # tiny DC-AE downscale 4: 8x8 latents


@functools.lru_cache(maxsize=None)
def _sana_world():
    """(JAX cfg, JAX params, JAX DC-AE, port cfg, port params, port DC-AE):
    the port's tiny SANA tree (per-sample routing, random add linears) and
    DC-AE, the same leaves for JAX."""
    from unigen_tpu_torch.models import dcae as t_dcae
    from unigen_tpu_torch.models.sana import init_sana_unigen_params
    kw = dict(condition_types=("canny",))
    jc = jcfg.UniGenConfig(family="sana", sana=jcfg.tiny_sana_config(),
                           control=jcfg.ControlConfig(moe=jcfg.MoEConfig(
                               batch_mode="per_sample")), **kw)
    tc = tcfg.UniGenConfig(family="sana", sana=tcfg.tiny_sana_config(),
                           control=tcfg.ControlConfig(moe=tcfg.MoEConfig(
                               batch_mode="per_sample")), **kw)
    g = torch.Generator().manual_seed(0)
    tp = init_sana_unigen_params(tc, gen=g, device="cpu")
    tp["control"]["add_blocks"]["w"].uniform_(-0.2, 0.2, generator=g)
    ae = t_dcae.init_dcae_params(t_dcae.tiny_dcae_config(), gen=g, device="cpu")
    return jc, to_jax_tree(tp), to_jax_tree(ae), tc, tp, ae


def _sana_request(i):
    bb = tcfg.tiny_sana_config()
    r = np.random.default_rng(2000 + i)
    mask = np.zeros((1, 6), np.int32)
    mask[0, :2 + i % 4] = 1
    return dict(prompt_embeds=r.standard_normal((1, 6, bb.caption_channels), np.float32),
                prompt_mask=mask,
                pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
                cond_pooled=r.standard_normal((1, bb.pooled_projection_dim), np.float32),
                control_pixels=r.uniform(-1, 1, (1, 3, SANA_RES, SANA_RES)).astype(np.float32),
                latents=r.standard_normal((1, bb.in_channels, 8, 8), np.float32))


def _sana_codec(jax_side=False):
    jc, _, jae, _, _, ae = _sana_world()
    if jax_side:
        from unigen_tpu.models import dcae as j_dcae
        cfg = j_dcae.tiny_dcae_config()
        return dict(ae_encode=lambda px: j_dcae.dcae_encode(jae, cfg, px),
                    ae_decode=lambda z: j_dcae.dcae_decode(jae, cfg, z),
                    ae_downscale=cfg.downscale)
    from unigen_tpu_torch.models import dcae as t_dcae
    cfg = t_dcae.tiny_dcae_config()
    return dict(ae_encode=functools.partial(t_dcae.dcae_encode, ae, cfg),
                ae_decode=functools.partial(t_dcae.dcae_decode, ae, cfg),
                ae_downscale=cfg.downscale)


def _sana_port(**kw):
    *_, tc, tp, _ = _sana_world()
    kw.setdefault("batch_size", 4)
    return StepServer(tc, tp, height=SANA_RES, width=SANA_RES, dtype=torch.float32,
                      device="cpu", **_sana_codec(), **kw)


@pytest.mark.parametrize("knobs", [{}, dict(control_cache_interval=4, model_cache_interval=2,
                                            residual_cache_bits=8)])
def test_sana_matches_jax_step_server(knobs):
    """The sana family against JAX's StepServer fed the same requests, with
    per-request padding masks: uint8 within one code, the same row counts."""
    jc, jp, *_ = _sana_world()
    reqs = [_sana_request(i) for i in range(3)]
    jsrv = JServer(jc, jp, batch_size=4, height=SANA_RES, width=SANA_RES,
                   num_inference_steps=5, dtype=jnp.float32, **_sana_codec(True), **knobs)
    want, jst = _serve(jsrv, [_jax_req(r) for r in reqs])
    got, st = _serve(_sana_port(num_inference_steps=5, **knobs), reqs)
    _assert_codes(got, want)
    assert got[0].shape == (1, SANA_RES, SANA_RES, 3)
    for key in ("retired", "rows_full", "rows_base", "rows_refresh"):
        assert st[key] == jst[key], (key, st, jst)


@pytest.mark.parametrize("knobs", [{}, dict(control_cache_interval=4, model_cache_interval=2)])
def test_sana_server_equals_own_pipeline(knobs):
    """chip_smoke's stepserve_sana_check on the CPU: the server's final
    latents against UniGenSanaPipeline.generate of the same requests at the
    same shapes (exact: every tick over all slots against b=4; the hybrid:
    one-row gathered forwards against b=1), bit for bit; the server's
    timesteps are divided by 1000 as the pipeline divides them. The
    control pixels are bf16 values (the pipeline casts them to its dtype,
    the server does not)."""
    import dataclasses as dc
    from unigen_tpu_torch.pipelines.sana import UniGenSanaPipeline
    from unigen_tpu_torch.utils import tree_map
    *_, tc, tp, _ = _sana_world()
    # a bf16 tree with the router fp32, as the serving trees are
    tp = dict(tree_map(lambda t: t.bfloat16(), tp))
    tp["control"] = dict(tp["control"], moe=dict(
        tp["control"]["moe"], gate=_sana_world()[4]["control"]["moe"]["gate"]))
    reqs = []
    for i in range(4):
        r = {k: torch.from_numpy(v) for k, v in _sana_request(10 + i).items()}
        r["control_pixels"] = r["control_pixels"].bfloat16().float()
        reqs.append({k: (v.bfloat16() if v.is_floating_point() and k != "control_pixels"
                         else v) for k, v in r.items()})
    srv = StepServer(tc, tp, height=SANA_RES, width=SANA_RES, batch_size=4,
                     num_inference_steps=4, device="cpu", **_sana_codec(), **knobs)
    try:
        finals, calls, stats, _ = chip_smoke.serve_at_reference_shapes(srv, reqs, knobs)
        assert chip_smoke.at_reference_shapes(srv, knobs, calls, stats)
    finally:
        srv.close()
    pipe = UniGenSanaPipeline(cfg=tc, params=tp, dtype=torch.bfloat16, device="cpu",
                              **_sana_codec())
    assert dc.is_dataclass(pipe)
    ref_lat, ref_img = chip_smoke.sana_pipeline_finals(torch, pipe, reqs, knobs, SANA_RES, 4,
                                                       4 if not knobs else 1)
    rels, codes = chip_smoke.compare_finals(torch, reqs, finals, ref_lat, ref_img)
    assert max(rels) == 0 and max(codes) == 0, (rels, codes)


def test_sana_warmup_and_multires():
    """warmup at the sana text length (a padding mask of ones), and a
    MultiResolutionStepServer of sana buckets routed by the control image."""
    srv = _sana_port(batch_size=2, num_inference_steps=1)
    assert srv.warmup(6, rounds=1) == 2
    srv.close()
    *_, tc, tp, _ = _sana_world()
    multi = MultiResolutionStepServer(tc, tp, buckets={32: {}, 64: dict(batch_size=1)},
                                      num_inference_steps=1, dtype=torch.float32,
                                      device="cpu", **_sana_codec())
    try:
        r = _sana_request(3)
        r64 = dict(r, control_pixels=np.zeros((1, 3, 64, 64), np.float32),
                   latents=np.zeros((1, 4, 16, 16), np.float32))
        assert multi.submit(**r).result(timeout=300).shape == (1, 32, 32, 3)
        assert multi.submit(**r64).result(timeout=300).shape == (1, 64, 64, 3)
    finally:
        multi.close()
