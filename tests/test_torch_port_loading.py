"""The port's loading layer against the JAX package's on the CPU, on the
same checkpoint files at tiny sizes: the safetensors reader (every dtype,
several shards) and chip_smoke's checkpoint writer, read back by the
``safetensors`` package; ``load_flux_pipeline`` and ``load_sd3_pipeline``
with an adapter, leaf for leaf against JAX's trees carried by
``io/from_jax`` (fp32 / bf16; quantize None, "w4a8", "w8a8"; the text
towers "w8a8" / "w4a8"); the three adapter layouts; the strict audit; the
serving-tree cache; ``control_overrides_from_yaml``; the default control's
warm start; CLIP's ``hidden_act``; chip_smoke's load check.

Both packages quantize nothing below 512 wide, so the tree tests lower
that gate to 16 in both (the text towers' ``TEXT_QUANT_MIN_DIM`` too).
Trees must be equal bit for bit; the CLIP encodes within the repo's 2e-3."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_from_pretrained import _write, fake_ckpt, make_fake_sd3_root  # noqa: F401
from tests.test_torch_bridge import _build_adapter_sd, _flux_tiny_sd
from torch_port_helpers import assert_close, to_torch_tree
from unigen_tpu import config as jcfg
from unigen_tpu.io import torch_bridge as jtb
from unigen_tpu.models import clip_text as j_clip
from unigen_tpu.ops import quant as jquant
from unigen_tpu.pipelines import loading as jload
from unigen_tpu_torch import config as tcfg
from unigen_tpu_torch.io import torch_bridge as ttb
from unigen_tpu_torch.models import clip_text as t_clip
from unigen_tpu_torch.models.t5_text import tiny_t5_config
from unigen_tpu_torch.ops import quant as tquant
from unigen_tpu_torch.pipelines import loading as tload
from unigen_tpu_torch.utils import tree_leaves_with_path, tree_map

FLUX = jcfg.tiny_flux_config()
SD3 = jcfg.tiny_sd3_config()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def low_gate(monkeypatch):
    """Quantize every linear at least 16 wide, in both packages."""
    for mod in (jquant, tquant):
        monkeypatch.setattr(mod, "quantize_tree_streaming", functools.partial(
            mod.quantize_tree_streaming, min_dim=16))
        monkeypatch.setattr(mod, "TEXT_QUANT_MIN_DIM", 16)


def assert_trees_equal(port, jax_tree):
    """The port's tree equals the JAX tree carried by from_jax: the same
    paths, dtypes and bits, in contiguous tensors (the card's wrappers
    take no other)."""
    want = dict(tree_leaves_with_path(to_torch_tree(jax_tree)))
    got = dict(tree_leaves_with_path(port))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    for path, t in got.items():
        assert t.dtype == want[path].dtype, (path, t.dtype, want[path].dtype)
        assert t.is_contiguous(), path
        assert torch.equal(t, want[path]), path


def _cfg_dict(cfg):
    """A UniGenConfig as a dict, without JAX's SANA field."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "sana"}


def _flux_ucfg():
    return jcfg.UniGenConfig(family="flux", flux=FLUX, condition_types=("canny",))


def _flux_adapter_sd():
    ucfg = _flux_ucfg()
    dev = ucfg.control.single_control_dev
    return _build_adapter_sd(FLUX, ucfg, FLUX.num_layers // dev,
                             FLUX.num_single_layers // dev, ucfg.control.moe.num_experts(1))


@pytest.fixture(scope="module")
def flux_adapters(tmp_path_factory):
    """The same reference adapter in its three layouts: a safetensors
    directory, ``{module}_weights_{idx}.bin`` shards, an ``.npz``."""
    root = tmp_path_factory.mktemp("flux_adapter")
    sd = _flux_adapter_sd()
    _write(str(root / "safetensors"), sd, {})
    (root / "bins").mkdir()
    by_module = {}
    for k, v in sd.items():
        by_module.setdefault(k.split(".")[0], {})[k.split(".", 1)[1]] = torch.tensor(v)
    for i, (mod, part) in enumerate(sorted(by_module.items())):
        torch.save(part, root / "bins" / f"{mod}_weights_{i}.bin")
    np.savez(root / "adapter.npz", **sd)
    return {"safetensors": str(root / "safetensors"), "bins": str(root / "bins"),
            "npz": str(root / "adapter.npz")}


def _sd3_cfgs():
    j = jcfg.UniGenConfig(family="sd3", sd3=SD3, condition_types=("depth",),
                          control=jcfg.ControlConfig(use_rope=False))
    t = tcfg.UniGenConfig(family="sd3", sd3=tcfg.tiny_sd3_config(),
                          condition_types=("depth",),
                          control=tcfg.ControlConfig(use_rope=False))
    return j, t


@pytest.fixture(scope="module")
def sd3_root(tmp_path_factory):
    """The tests' fake SD3 root (transformer, VAE, CLIP-L and CLIP-G with
    tokenizers) with a T5 and a UniGen adapter written by chip_smoke's
    writer (fp32, from a seed)."""
    root = tmp_path_factory.mktemp("sd3_root")
    make_fake_sd3_root(str(root))
    _, cfg = _sd3_cfgs()
    gen = torch.Generator().manual_seed(3)
    t5 = tiny_t5_config(d_model=SD3.joint_attention_dim)
    chip_smoke.write_component(
        torch, root / "text_encoder_3", chip_smoke.t5_shapes(t5), torch.float32, gen, "cpu",
        {"vocab_size": t5.vocab_size, "d_model": t5.d_model, "d_kv": t5.d_kv,
         "d_ff": t5.d_ff, "num_layers": t5.num_layers, "num_heads": t5.num_heads}, shards=2)
    chip_smoke.write_component(torch, root / "adapter", chip_smoke.sd3_adapter_shapes(cfg),
                               torch.float32, gen, "cpu",
                               fixed=chip_smoke.sd3_tables(torch, cfg, "cpu"))
    return str(root)


# ---------------------------------------------------------------- readers

def test_reader_every_dtype_and_shards_against_safetensors_and_jax(tmp_path):
    """The port's reader on files written by the safetensors package (numpy
    for the numpy dtypes, torch for bf16) in three shards: every tensor
    equals what was written, in its stored dtype, and what JAX's
    read_checkpoint_dir reads (which upcasts bf16)."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch
    rng = np.random.default_rng(0)
    arrays = {"f64": rng.standard_normal((3, 2)), "f32": rng.standard_normal((5,)).astype(
        np.float32), "f16": rng.standard_normal((2, 3)).astype(np.float16),
        "i64": rng.integers(-9, 9, (4,)), "i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "i16": rng.integers(-9, 9, (3,)).astype(np.int16),
        "i8": rng.integers(-9, 9, (6,)).astype(np.int8),
        "u8": rng.integers(0, 255, (2, 2)).astype(np.uint8),
        "bool": rng.integers(0, 2, (3,)).astype(bool), "scalar": np.float32(2.5),
        "empty": np.zeros((0, 3), np.float32)}
    names = sorted(arrays)
    save_file({k: np.asarray(arrays[k]) for k in names[:5]}, str(tmp_path / "a-1.safetensors"),
              metadata={"format": "np"})
    save_file({k: np.asarray(arrays[k]) for k in names[5:]}, str(tmp_path / "a-2.safetensors"))
    bf16 = torch.randn(4, 3, generator=torch.Generator().manual_seed(1)).bfloat16()
    save_torch({"bf16": bf16}, str(tmp_path / "b.safetensors"))

    got = ttb.read_checkpoint_dir(str(tmp_path))
    assert set(got) == set(arrays) | {"bf16"}
    for k, a in arrays.items():
        assert got[k].numpy().dtype == np.asarray(a).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a))
    assert got["bf16"].dtype == torch.bfloat16 and torch.equal(got["bf16"], bf16)
    ref = jtb.read_checkpoint_dir(str(tmp_path))
    for k in got:
        np.testing.assert_array_equal(got[k].float().numpy() if k == "bf16"
                                      else got[k].numpy(), ref[k])


def test_bin_reader_and_state_dict_unwrap(tmp_path):
    """Without safetensors files, every .bin is read (a ``state_dict``
    wrapper unwrapped), in its dtype, as JAX reads it."""
    a = {"x.weight": torch.randn(3, 2, dtype=torch.float64).float()}
    b = {"y.weight": torch.randn(2, dtype=torch.float32).bfloat16()}
    torch.save(a, tmp_path / "pytorch_model-1.bin")
    torch.save({"state_dict": b}, tmp_path / "pytorch_model-2.bin")
    got = ttb.read_checkpoint_dir(str(tmp_path))
    ref = jtb.read_checkpoint_dir(str(tmp_path))
    assert got["y.weight"].dtype == torch.bfloat16
    for k in ("x.weight", "y.weight"):
        np.testing.assert_array_equal(got[k].float().numpy(), ref[k])


def test_chip_writer_read_back_by_safetensors(tmp_path):
    """chip_smoke's streaming writer: each component's shards hold the
    header the safetensors package reads, and its tensors equal the port
    reader's (bf16, fp16, fp32; the position tables as given)."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    _, cfg = _sd3_cfgs()
    gen = torch.Generator().manual_seed(0)
    tables = chip_smoke.sd3_tables(torch, cfg, "cpu")
    shapes = chip_smoke.sd3_transformer_shapes(cfg.sd3)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        d = tmp_path / str(dtype)
        n = chip_smoke.write_component(torch, d, shapes, dtype, gen, "cpu", {"x": 1},
                                       shards=3, fixed=tables)
        files = sorted(d.glob("*.safetensors"))
        assert len(files) == 3 and n == sum(f.stat().st_size for f in files)
        assert json.loads((d / "model.safetensors.index.json").read_text())["weight_map"]
        ref = {}
        for f in files:
            ref.update(safetensors_torch.load_file(str(f)))
        got = ttb.read_checkpoint_dir(str(d))
        assert set(got) == set(ref) == set(shapes)
        for k, t in got.items():
            assert t.dtype == dtype and tuple(t.shape) == tuple(shapes[k])
            assert torch.equal(t, ref[k]), k
        assert torch.equal(got["pos_embed.pos_embed"], tables["pos_embed.pos_embed"].to(dtype))
        assert abs(float(got["transformer_blocks.0.attn.norm_q.weight"].float().mean()) - 1) < .1


# ---------------------------------------------------------------- trees

LOAD_CASES = [("float32", None, None), ("bfloat16", None, "w8a8"),
              ("float32", "w4a8", "w4a8"), ("bfloat16", "w8a8", "w4a8"),
              ("bfloat16", "w4a8", "w8a8")]


@pytest.mark.parametrize("dtype,quantize,quantize_text", LOAD_CASES)
def test_load_flux_pipeline_trees_match_jax(fake_ckpt, flux_adapters, low_gate,  # noqa: F811
                                            dtype, quantize, quantize_text):
    """load_flux_pipeline of the same directory and adapter in both packages:
    the transformer, VAE, CLIP and T5 trees leaf for leaf, the configs and
    the scheduler."""
    kw = dict(adapter_dir=flux_adapters["safetensors"], quantize=quantize,
              quantize_text=quantize_text)
    jp = jload.load_flux_pipeline(fake_ckpt, dtype=getattr(jnp, dtype), **kw)
    tp = tload.load_flux_pipeline(fake_ckpt, dtype=getattr(torch, dtype), device="cpu", **kw)
    for name in ("params", "vae_params", "clip_params", "t5_params"):
        assert_trees_equal(getattr(tp, name), getattr(jp, name))
    if quantize:
        assert any(p[-1] == ("w_q4" if quantize == "w4a8" else "w_q")
                   for p, _ in tree_leaves_with_path(tp.params["base"]))
    if quantize_text:
        assert any(p[-1] in ("w_q", "w_q4") for p, _ in tree_leaves_with_path(tp.t5_params))
    assert _cfg_dict(tp.cfg) == _cfg_dict(jp.cfg)
    assert dataclasses.asdict(tp.vae_cfg) == dataclasses.asdict(jp.vae_cfg)
    assert dataclasses.asdict(tp.t5_cfg) == dataclasses.asdict(jp.t5_cfg)
    assert {k: v for k, v in dataclasses.asdict(tp.clip_cfg).items() if k != "hidden_act"} \
        == dataclasses.asdict(jp.clip_cfg)
    assert dataclasses.asdict(tp.scheduler) == dataclasses.asdict(jp.scheduler)
    assert (tp.tokenizer is None) == (jp.tokenizer is None)


@pytest.mark.parametrize("dtype,quantize,quantize_text", LOAD_CASES)
def test_load_sd3_pipeline_trees_match_jax(sd3_root, low_gate, dtype, quantize,
                                           quantize_text):
    """load_sd3_pipeline of the same directory and adapter in both packages:
    the {base, control} trees, the VAE and the CLIP-L, CLIP-G and T5 towers
    leaf for leaf."""
    kw = dict(adapter_dir=str(Path(sd3_root) / "adapter"), quantize=quantize,
              quantize_text=quantize_text)
    jp = jload.load_sd3_pipeline(sd3_root, dtype=getattr(jnp, dtype), **kw)
    tp = tload.load_sd3_pipeline(sd3_root, dtype=getattr(torch, dtype), device="cpu", **kw)
    assert_trees_equal(tp.params, jp.params)
    assert_trees_equal(tp.vae_params, jp.vae_params)
    for key in ("clip_l", "clip_g", "t5"):
        assert_trees_equal(tp.text_encoders[key][0], jp.text_encoders[key][0])
        assert (tp.text_encoders[key][2] is None) == (jp.text_encoders[key][2] is None)
    if quantize:
        assert any(p[-1] == ("w_q4" if quantize == "w4a8" else "w_q")
                   for p, _ in tree_leaves_with_path(tp.params["base"]))
    assert _cfg_dict(tp.cfg) == _cfg_dict(jp.cfg)
    assert dataclasses.asdict(tp.scheduler) == dataclasses.asdict(jp.scheduler)


@pytest.mark.parametrize("layout", ["safetensors", "bins", "npz"])
def test_adapter_layouts_match_jax(flux_adapters, layout):
    """load_adapter_checkpoint in each of the reference's layouts gives JAX's
    control tree, and the three layouts give one tree."""
    ucfg = _flux_ucfg()
    dev = ucfg.control.single_control_dev
    kw = dict(n_cn=FLUX.num_layers // dev, n_cn_single=FLUX.num_single_layers // dev,
              num_experts=ucfg.control.moe.num_experts(1))
    got = ttb.load_adapter_checkpoint(flux_adapters[layout], dtype=torch.float32,
                                      device="cpu", **kw)
    assert_trees_equal(got, jtb.load_adapter_checkpoint(flux_adapters[layout],
                                                        dtype=jnp.float32, **kw))
    assert_trees_equal(got, jtb.load_adapter_checkpoint(flux_adapters["safetensors"],
                                                        dtype=jnp.float32, **kw))


def test_strict_audit_raises_in_both_packages():
    """strict=True consumes every key of a clean transformer and adapter, and
    raises in both packages on an injected key, naming it."""
    ucfg = _flux_ucfg()
    dev = ucfg.control.single_control_dev
    kw = dict(n_cn=FLUX.num_layers // dev, n_cn_single=FLUX.num_single_layers // dev,
              num_experts=ucfg.control.moe.num_experts(1))
    base = _flux_tiny_sd(FLUX)
    adapter = _flux_adapter_sd()
    t_base = {k: torch.from_numpy(v) for k, v in base.items()}
    t_adapter = {k: torch.from_numpy(v) for k, v in adapter.items()}
    ttb.load_flux_transformer(t_base, FLUX.num_layers, FLUX.num_single_layers,
                              dtype=torch.float32, strict=True, device="cpu")
    ttb.load_unigen_adapter(t_adapter, dtype=torch.float32, strict=True, device="cpu", **kw)
    for sd, tsd, key in ((base, t_base, "transformer_blocks.0.attn.to_q.lora_A"),
                         (adapter, t_adapter,
                          "moe.moe_layer.experts.deepspeed_experts.99.0.0.weight")):
        sd[key] = np.zeros((2, 2), np.float32)
        tsd[key] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="lora_A"):
        jtb.load_flux_transformer(base, FLUX.num_layers, FLUX.num_single_layers,
                                  dtype=jnp.float32, strict=True)
    with pytest.raises(ValueError, match="lora_A"):
        ttb.load_flux_transformer(t_base, FLUX.num_layers, FLUX.num_single_layers,
                                  dtype=torch.float32, strict=True, device="cpu")
    with pytest.raises(ValueError, match="deepspeed_experts.99"):
        jtb.load_unigen_adapter(adapter, dtype=jnp.float32, strict=True, **kw)
    with pytest.raises(ValueError, match="deepspeed_experts.99"):
        ttb.load_unigen_adapter(t_adapter, dtype=torch.float32, strict=True, device="cpu",
                                **kw)


def test_serving_cache_roundtrip_and_refusals(fake_ckpt, flux_adapters, low_gate,  # noqa: F811
                                              tmp_path):
    """A quantized load writes the serving-tree cache, the next load reads it
    (the same tree bit for bit, and JAX's); another policy or topology
    refuses to load it."""
    cache = str(tmp_path / "cache")
    kw = dict(adapter_dir=flux_adapters["bins"], dtype=torch.float32, device="cpu",
              quantize="w8a8", serving_cache=cache)
    first = tload.load_flux_pipeline(fake_ckpt, **kw)
    assert (tmp_path / "cache" / "meta.json").exists()
    calls = []
    real = ttb.read_checkpoint_dir
    ttb.read_checkpoint_dir = lambda p, *a: calls.append(p) or real(p, *a)
    try:
        second = tload.load_flux_pipeline(fake_ckpt, **kw)
    finally:
        ttb.read_checkpoint_dir = real
    assert not any(p.endswith("transformer") for p in calls), calls
    assert_trees_equal(second.params, jax.tree.map(
        np.asarray, jload.load_flux_pipeline(
            fake_ckpt, adapter_dir=flux_adapters["bins"], dtype=jnp.float32,
            quantize="w8a8").params))
    for a, b in zip(tree_leaves_with_path(first.params), tree_leaves_with_path(second.params)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="quantized as"):
        tload.load_flux_pipeline(fake_ckpt, **dict(kw, quantize="w4a8"))
    with pytest.raises(ValueError, match="topology mismatch"):
        tload.load_flux_pipeline(fake_ckpt, condition_types=("canny", "depth"), **kw)


def test_control_overrides_from_yaml_matches_jax(tmp_path):
    path = tmp_path / "unigen.yaml"
    path.write_text("params:\n  control_params:\n    use_rope: false\n"
                    "    use_modulate: false\n    single_control_dev: 1\n"
                    "    expert_num_each_condition: 2\n    aux_loss_weight: 0.05\n")
    got = tcfg.control_overrides_from_yaml(str(path))
    want = jcfg.control_overrides_from_yaml(str(path))
    assert {k: v for k, v in got.items() if k != "moe"} == \
        {k: v for k, v in want.items() if k != "moe"}
    assert dataclasses.asdict(got["moe"]) == dataclasses.asdict(want["moe"])
    assert tcfg.control_overrides_from_yaml(None) == {}
    path.write_text("params:\n  control_params:\n    not_a_knob: 1\n")
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError, match="not_a_knob"):
            mod.control_overrides_from_yaml(str(path))


def test_default_control_is_warm_started_from_the_base(fake_ckpt, sd3_root):  # noqa: F811
    """Without an adapter the control branch is the port's own init (a
    torch.Generator seeded 0, not JAX's PRNGKey(0)); the leaves it
    warm-starts equal the loaded base's."""
    fp = tload.load_flux_pipeline(fake_ckpt, dtype=torch.float32, device="cpu")
    base, ctrl = fp.params["base"], fp.params["control"]
    n_cn = FLUX.num_layers // fp.cfg.control.single_control_dev
    n_cn_s = FLUX.num_single_layers // fp.cfg.control.single_control_dev
    for got, want in ((ctrl["x_embedder"], base["x_embedder"]),
                      (ctrl["time_text_embed"], base["time_text_embed"]),
                      (ctrl["condition_embed"], base["time_text_embed"]),
                      (ctrl["double_blocks"], _slice(base["double_blocks"], n_cn)),
                      (ctrl["single_blocks"], _slice(base["single_blocks"], n_cn_s))):
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(got), tree_leaves_with_path(want)):
            assert pa == pb and torch.equal(a, b), pa
    sp = tload.load_sd3_pipeline(sd3_root, dtype=torch.float32, device="cpu")
    base, ctrl = sp.params["base"], sp.params["control"]
    for key in ("time_text_embed", "condition_embed"):
        for (pa, a), (pb, b) in zip(tree_leaves_with_path(ctrl[key]),
                                    tree_leaves_with_path(base["time_text_embed"])):
            assert pa == pb and torch.equal(a, b), (key, pa)
    assert torch.equal(ctrl["context_embedder"]["w"], base["context_embedder"]["w"])


def _slice(tree, n):
    return {k: _slice(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


def test_lora_dir_and_unknown_text_policy_raise(fake_ckpt, tmp_path):  # noqa: F811
    """A LoRA directory without adapter files, and an unknown text policy,
    raise (the LoRA loading itself is in tests/test_torch_port_lora.py)."""
    with pytest.raises(FileNotFoundError, match="pytorch_lora_weights"):
        tload.load_flux_pipeline(fake_ckpt, dtype=torch.float32, lora_dir=str(tmp_path),
                                 device="cpu")
    with pytest.raises(ValueError, match="quantize_text"):
        tload.load_flux_pipeline(fake_ckpt, dtype=torch.float32, quantize_text="w2",
                                 device="cpu")


# ---------------------------------------------------------------- CLIP activation

def test_clip_hidden_act_quick_gelu_matches_jax_and_gelu_matches_torch_layer():
    """The default (quick-GELU) CLIP equals JAX's; "gelu" equals a plain
    torch CLIP layer with the exact erf GELU (CLIP-G's hidden_act), which
    the JAX package does not read."""
    cfg = j_clip.tiny_clip_config()
    jparams = j_clip.init_clip_params(jax.random.PRNGKey(0), cfg)
    tparams = to_torch_tree(jparams)
    ids = np.random.default_rng(0).integers(1, 89, (2, cfg.max_position_embeddings))
    ids[:, -3] = cfg.eos_token_id
    want = j_clip.clip_encode(jparams, cfg, jnp.asarray(ids))
    tc = t_clip.CLIPTextConfig(**dataclasses.asdict(cfg))
    for g, w in zip(t_clip.clip_encode(tparams, tc, ids), want):
        assert_close(g, w, 2e-3)

    gcfg = dataclasses.replace(tc, hidden_act="gelu", num_layers=1)
    one = {**tparams, "layers": tree_map(lambda t: t[:1], tparams["layers"])}
    last, _, _ = t_clip.clip_encode(one, gcfg, ids)
    lp = tree_map(lambda t: t[0], tparams["layers"])
    x = tparams["token_embedding"][torch.as_tensor(ids)] + \
        tparams["position_embedding"][None, :ids.shape[1]]

    def ln(p, h):
        return torch.nn.functional.layer_norm(h, h.shape[-1:], p["scale"], p["bias"], 1e-5)

    def lin(p, h):
        return h @ p["w"] + p["b"]
    h = ln(lp["ln1"], x)
    b, t, d = h.shape
    q, k, v = (lin(lp[n], h).view(b, t, cfg.num_heads, -1).transpose(1, 2) for n in "qkv")
    attn = torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True)
    x = x + lin(lp["o"], attn.transpose(1, 2).reshape(b, t, d))
    x = x + lin(lp["fc2"], torch.nn.functional.gelu(lin(lp["fc1"], ln(lp["ln2"], x))))
    assert_close(last, ln(tparams["final_ln"], x), 1e-4)
    assert not torch.allclose(last, t_clip.clip_encode(
        one, dataclasses.replace(gcfg, hidden_act="quick_gelu"), ids)[0], atol=1e-4)
    with pytest.raises(ValueError, match="hidden_act"):
        t_clip.clip_encode(one, dataclasses.replace(gcfg, hidden_act="relu"), ids)


def test_clip_hidden_act_read_from_config_json(sd3_root):
    """The loader reads hidden_act: CLIP-G's "gelu" reaches the config (the
    JAX loader drops it)."""
    raw = json.loads((Path(sd3_root) / "text_encoder_2" / "config.json").read_text())
    assert tload._clip_cfg_from_json(dict(raw, hidden_act="gelu")).hidden_act == "gelu"
    assert tload._clip_cfg_from_json(raw).hidden_act == "quick_gelu"


# ---------------------------------------------------------------- quantization

def test_streaming_quantization_equals_quantize_tree_and_chip_load_check(sd3_root,
                                                                          low_gate):
    """quantize_tree_streaming donated (one block of a stack at a time, the
    source consumed) gives the bits of the same walk into a new tree, and
    quantize_tree's leaves; chip_smoke's sd3_load_check finds no difference
    between a W4A8 load and the unquantized load quantized without
    donation, and finds a changed leaf."""
    _, cfg = _sd3_cfgs()
    raw = tload.load_sd3_pipeline(sd3_root, adapter_dir=str(Path(sd3_root) / "adapter"),
                                  dtype=torch.bfloat16, device="cpu")
    src = raw.params["base"]
    want = tquant.quantize_tree_streaming(src, bits=4, min_dim=16, donate=False)
    eager = tquant.quantize_tree(src, bits=4, min_dim=16)
    before = tquant.quantized_bytes(src)
    w = src["dual_blocks"]["attn"]["to_q"]
    got = tquant.quantize_tree_streaming(src, bits=4)
    assert got is src and "w" not in w and w["w_q4"].dim() == 3
    for (pa, a), (pb, b), (pc, c) in zip(tree_leaves_with_path(got),
                                         tree_leaves_with_path(want),
                                         tree_leaves_with_path(eager)):
        assert pa == pb == pc and a.dtype == b.dtype == c.dtype, pa
        assert a.shape == c.shape and torch.equal(a, b), pa
    assert tquant.quantized_bytes(got) < before

    pipe = tload.load_sd3_pipeline(sd3_root, adapter_dir=str(Path(sd3_root) / "adapter"),
                                   dtype=torch.bfloat16, quantize="w4a8", quantize_text="w4a8",
                                   device="cpu")
    compared, differ = chip_smoke.sd3_load_check(torch, Path(sd3_root), pipe, "cpu",
                                                 min_dim=16)
    assert compared > 100 and not differ, differ
    pipe.params["base"]["context_embedder"]["w_q4"][0, 0] += 1
    assert chip_smoke.sd3_load_check(torch, Path(sd3_root), pipe, "cpu", min_dim=16)[1] == [
        "context_embedder.w_q4"]


def test_chip_checkpoint_shapes_match_the_state_dict_fixtures(fake_ckpt, sd3_root):  # noqa: F811
    """chip_smoke's checkpoint specs name and shape every tensor as the
    tests' state-dict fixtures do (whose files JAX's loaders read): the FLUX
    transformer and adapter, the SD3 transformer, the VAE, CLIP and T5;
    and the SD3 adapter it writes loads into the tree of JAX's control
    init."""
    from tests.test_from_pretrained import make_fake_vae_sd
    from tests.test_sd3_bridge_pipeline import _sd3_state_dict
    from unigen_tpu.io import torch_bridge_sd3 as jtb3
    from unigen_tpu.models import vae as j_vae
    from unigen_tpu.models.unigen_sd3 import init_unigen_sd3_control
    from unigen_tpu_torch.models.clip_text import CLIPTextConfig
    from unigen_tpu_torch.models.vae import tiny_vae_config

    def shapes(sd):
        return {k: tuple(np.shape(v)) for k, v in sd.items()}

    tflux = tcfg.tiny_flux_config()
    tucfg = tcfg.UniGenConfig(family="flux", flux=tflux, condition_types=("canny",))
    assert chip_smoke.flux_transformer_shapes(tflux) == shapes(_flux_tiny_sd(FLUX))
    assert chip_smoke.flux_adapter_shapes(tucfg) == shapes(_flux_adapter_sd())
    jsd3, tsd3 = _sd3_cfgs()
    assert chip_smoke.sd3_transformer_shapes(tsd3.sd3) == shapes(_sd3_state_dict(SD3))
    rng = np.random.default_rng(0)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    assert chip_smoke.vae_shapes(tiny_vae_config(latent_channels=4)) == shapes(
        make_fake_vae_sd(j_vae.tiny_vae_config(latent_channels=4), g))
    for sub, raw_cfg in (("text_encoder", Path(sd3_root)), ("text_encoder_2", Path(fake_ckpt))):
        raw = json.loads((raw_cfg / sub / "config.json").read_text())
        got = shapes(ttb.read_checkpoint_dir(str(raw_cfg / sub)))
        if sub == "text_encoder":
            want = chip_smoke.clip_shapes(CLIPTextConfig(
                vocab_size=raw["vocab_size"], hidden_size=raw["hidden_size"],
                intermediate_size=raw["intermediate_size"],
                num_layers=raw["num_hidden_layers"], num_heads=raw["num_attention_heads"],
                max_position_embeddings=raw["max_position_embeddings"]))
        else:
            want = chip_smoke.t5_shapes(tiny_t5_config(
                vocab_size=raw["vocab_size"], d_model=raw["d_model"], d_kv=raw["d_kv"],
                d_ff=raw["d_ff"], num_layers=raw["num_layers"], num_heads=raw["num_heads"]))
        assert want == got, sub
    adapter = jtb3.load_sd3_unigen_adapter(
        jtb.read_checkpoint_dir(str(Path(sd3_root) / "adapter")), SD3, SD3.num_layers,
        jsd3.control.moe.num_experts(1), dtype=jnp.float32)
    want = jax.eval_shape(lambda: init_unigen_sd3_control(jax.random.PRNGKey(0), jsd3))
    assert jax.tree.map(lambda x: x.shape, adapter) == jax.tree.map(lambda x: x.shape, want)


# ---------------------------------------------------------------- SANA

def _sana_cfgs():
    kw = dict(caption_channels=32)
    return (jcfg.UniGenConfig(family="sana", sana=jcfg.tiny_sana_config(**kw),
                              condition_types=("canny",)),
            tcfg.UniGenConfig(family="sana", sana=tcfg.tiny_sana_config(**kw),
                              condition_types=("canny",)))


@pytest.fixture(scope="module")
def sana_root(tmp_path_factory):
    """A tiny SANA directory written by chip_smoke's writer (transformer,
    Gemma-2 in two shards, CLIP-L in clip/, the native DC-AE in vae/, the
    scheduler) with the tiny configs swapped in, and a reference SANAUniGen
    adapter (fp32, from a seed)."""
    from unigen_tpu_torch.models import dcae, gemma_text
    root = tmp_path_factory.mktemp("sana_root")
    _, cfg = _sana_cfgs()
    pooled = cfg.sana.pooled_projection_dim
    texts = (gemma_text.tiny_gemma_config(),
             t_clip.tiny_clip_config(hidden_size=pooled, intermediate_size=2 * pooled,
                                     max_position_embeddings=77))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "sana_text_configs", lambda: texts)
        mp.setattr(chip_smoke, "sana_dcae_config",
                   lambda: dcae.tiny_dcae_config(latent_channels=cfg.sana.in_channels))
        chip_smoke.write_sana_checkpoint(torch, "cpu", root, cfg, seed=5)
    gen = torch.Generator().manual_seed(6)
    chip_smoke.write_component(torch, root / "adapter", chip_smoke.sana_adapter_shapes(cfg),
                               torch.float32, gen, "cpu")
    return str(root)


SANA_LOAD_CASES = [("float32", None, None), ("bfloat16", "w4a8", "w4a8"),
                   ("bfloat16", "w8a8", "w8a8")]


@pytest.mark.parametrize("dtype,quantize,quantize_text", SANA_LOAD_CASES)
def test_load_sana_pipeline_trees_match_jax(sana_root, low_gate, dtype, quantize,
                                            quantize_text):
    """load_sana_pipeline of the same directory and adapter in both packages:
    the {base, control} trees, Gemma and CLIP leaf for leaf, the configs, the
    codec's downscale and the scheduler; the DC-AE read by the port equals
    JAX's read of the same native files."""
    from unigen_tpu.models import dcae as j_dcae
    kw = dict(adapter_dir=str(Path(sana_root) / "adapter"), quantize=quantize,
              quantize_text=quantize_text, clip_dir=str(Path(sana_root) / "clip"))
    jp = jload.load_sana_pipeline(sana_root, dtype=getattr(jnp, dtype), **kw)
    tp = tload.load_sana_pipeline(sana_root, dtype=getattr(torch, dtype), device="cpu", **kw)
    assert_trees_equal(tp.params, jp.params)
    assert_trees_equal(tp.gemma_params, jp.gemma_params)
    assert_trees_equal(tp.clip_params, jp.clip_params)
    if quantize:
        assert any(p[-1] == ("w_q4" if quantize == "w4a8" else "w_q")
                   for p, _ in tree_leaves_with_path(tp.params["base"]))
        assert any(p[-1] == ("w_q4" if quantize_text == "w4a8" else "w_q")
                   for p, _ in tree_leaves_with_path(tp.gemma_params))
    assert dataclasses.asdict(tp.cfg) == dataclasses.asdict(jp.cfg)
    assert dataclasses.asdict(tp.gemma_cfg) == dataclasses.asdict(jp.gemma_cfg)
    assert dataclasses.asdict(tp.scheduler) == dataclasses.asdict(jp.scheduler)
    assert tp.ae_downscale == jp.ae_downscale
    ae_t = tp.ae_encode.args[0]
    ae_j, _ = j_dcae.load_dcae_native(str(Path(sana_root) / "vae"))
    assert_trees_equal(ae_t, ae_j)


def test_sana_default_control_random_codec_and_load_check(sana_root, low_gate, capsys):
    """Without an adapter the control branch is the port's init warm-started
    from the base (its blocks, patch and time embeds copied); without a
    native DC-AE a random one is built and stderr says so; chip_smoke's
    sana_load_check finds no difference between a W4A8 load and the
    unquantized load quantized without donation, and finds a changed
    leaf."""
    import shutil
    from unigen_tpu_torch.models import dcae
    pipe = tload.load_sana_pipeline(sana_root, device="cpu")
    base, ctrl = pipe.params["base"], pipe.params["control"]
    assert torch.equal(ctrl["blocks"]["attn1"]["to_q"]["w"], base["blocks"]["attn1"]["to_q"]["w"])
    assert torch.equal(ctrl["pos_embed_input"]["w"], base["patch_embed"]["w"])
    assert not ctrl["add_blocks"]["w"].any()
    no_vae = Path(sana_root).parent / "sana_no_vae"
    shutil.copytree(sana_root, no_vae, ignore=shutil.ignore_patterns("vae"))
    tiny = dcae.tiny_dcae_config(latent_channels=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dcae, "DCAEConfig", lambda latent_channels: tiny)
        rnd = tload.load_sana_pipeline(str(no_vae), device="cpu")
    assert "RANDOM-INIT codec" in capsys.readouterr().err
    assert rnd.ae_downscale == tiny.downscale

    q = tload.load_sana_pipeline(sana_root, dtype=torch.bfloat16, quantize="w4a8",
                                 quantize_text="w4a8", clip_dir=str(Path(sana_root) / "clip"),
                                 device="cpu")
    compared, differ = chip_smoke.sana_load_check(torch, Path(sana_root), q, "cpu",
                                                  min_dim=16)
    assert compared > 50 and not differ, differ
    q.params["base"]["caption_projection"]["fc2"]["w_q4"][0, 0] += 1
    assert chip_smoke.sana_load_check(torch, Path(sana_root), q, "cpu", min_dim=16)[1] == [
        "caption_projection.fc2.w_q4"]
