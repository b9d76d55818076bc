"""The port's inference entry point (``python -m unigen_tpu_torch.cli.infer``)
on the CPU: its flags against ``scripts/infer.py``'s; ``main`` in process on
the tiny FLUX directory of ``tests/test_from_pretrained.py`` (fp32) in
single-prompt and test-split modes against JAX's ``scripts/infer.main`` on
the same directory and dataset (PNGs within one code, ``info.json``
equal); both pipelines are handed the same numpy noise, since the two
frameworks cannot draw the same PRNG stream. The other cases hold the CLI
against the port's own pipeline calls: the joint multi-condition call, the
SANA family loaded through ``load_pipeline`` from the loading tests' tiny
directory, and the refusals. SD3 is rehearsed in
``tests/test_torch_port_cli_chip.py`` (``chip_smoke.entry_infer_check``)."""

import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from unigen_tpu.pipelines import flux as j_flux
from unigen_tpu.pipelines import loading as j_loading
from unigen_tpu_torch.cli import infer as cli
from unigen_tpu_torch.data import conditions as C
from unigen_tpu_torch.pipelines import flux as t_flux

ROOT = pathlib.Path(__file__).resolve().parents[1]
RES, STEPS = 32, 2


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_infer_script",
                                                  ROOT / "scripts" / "infer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [
    ["--pretrained_model_name_or_path", "x"],
    ["--pretrained_model_name_or_path", "x", "--basemodel", "MultiCondtionUniGenFlux",
     "--condition_types", "depth", "canny", "--control_image", "a.png", "b.png",
     "--prompt", "p", "--quantize", "w4a8", "--quantize_text", "w8a8", "--cfg_cache",
     "--quality_profile", "fast", "--residual_cache_bits", "8", "--lora_dir", "l",
     "--cn_config", "c.yaml", "--disable_single_trans_blocks", "--batch_size", "4"]])
def test_parse_args_matches_scripts_infer(argv):
    """Every flag and default of scripts/infer.py, plus ``--device`` (cuda
    unless named) and ``--dtype`` (the family loader's by default)."""
    got = vars(cli.parse_args(argv))
    assert got.pop("device") == "cuda" and got.pop("dtype") is None
    assert got == vars(_jax_script().parse_args(argv))


def _noise(pipe, prompt_embeds, height, width, seed):
    """The packed FLUX latents both pipelines are given: numpy normal draws
    keyed by the seed the CLI passes."""
    b = prompt_embeds.shape[0]
    vs = pipe.vae_cfg.downscale
    lh, lw = 2 * (height // (vs * 2)), 2 * (width // (vs * 2))
    return np.random.default_rng(1000 + seed).standard_normal(
        (b, (lh // 2) * (lw // 2), pipe.cfg.flux.in_channels)).astype(np.float32)


@pytest.fixture
def seeded_noise(monkeypatch):
    """Both FLUX pipelines' generate takes ``_noise`` when no latents are
    given, and JAX's loader loads fp32 (its CLI has no dtype flag)."""
    for mod in (j_flux, t_flux):
        real = mod.UniGenFluxPipeline.generate

        def generate(self, *a, _real=real, latents=None, **kw):
            if latents is None:
                latents = _noise(self, kw["prompt_embeds"], kw.get("height", 512),
                                 kw.get("width", 512), kw.get("seed", 0))
            return _real(self, *a, latents=latents, **kw)
        monkeypatch.setattr(mod.UniGenFluxPipeline, "generate", generate)
    monkeypatch.setattr(j_loading, "load_flux_pipeline", functools.partial(
        j_loading.load_flux_pipeline, dtype=jnp.float32))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A Subjects-200K-layout directory of 3 held-out items (random JPEGs,
    pre-rendered depth conditions)."""
    root = tmp_path_factory.mktemp("subjects")
    chip_smoke.write_subjects200k(root, 3, 40, 7, test=3)
    return root


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(int)


def test_main_matches_scripts_infer(fake_ckpt, dataset, seeded_noise, tmp_path):  # noqa: F811
    """Single-prompt mode (a control PNG, ``res.png``) and test-split mode
    (batch 2 over 3 items: ``{i:05d}/{target,res,condition}.png`` and
    ``info.json``), the port's CLI against JAX's script on the same
    directory and files: images within one code, the manifest and the
    target / condition files equal."""
    Image.fromarray(np.random.default_rng(3).integers(0, 256, (48, 40, 3), dtype=np.uint8)
                    ).save(tmp_path / "control.png")
    common = ["--pretrained_model_name_or_path", fake_ckpt, "--condition_types", "depth",
              "--resolution", str(RES), "--num_inference_steps", str(STEPS), "--seed", "4"]
    prompt = ["--prompt", "a cat wearing a hat", "--control_image",
              str(tmp_path / "control.png")]
    batch = ["--data_path", str(dataset), "--batch_size", "2", "--max_samples", "5"]
    port = ["--device", "cpu", "--dtype", "fp32"]
    script = _jax_script()
    for mode, extra in (("prompt", prompt), ("batch", batch)):
        cli.main(common + extra + port + ["--save_path", str(tmp_path / "t" / mode)])
        script.main(common + extra + ["--save_path", str(tmp_path / "j" / mode)])
    got, want = _png(tmp_path / "t/prompt/res.png"), _png(tmp_path / "j/prompt/res.png")
    assert got.shape == (RES, RES, 3) and np.abs(got - want).max() <= 1
    manifest = json.loads((tmp_path / "t/batch/info.json").read_text())
    assert manifest == json.loads((tmp_path / "j/batch/info.json").read_text())
    assert [m["index"] for m in manifest] == [0, 1, 2]
    for i in range(3):
        d = f"{i:05d}"
        for name in ("target.png", "condition.png"):
            assert np.array_equal(_png(tmp_path / "t/batch" / d / name),
                                  _png(tmp_path / "j/batch" / d / name))
        assert np.abs(_png(tmp_path / "t/batch" / d / "res.png")
                      - _png(tmp_path / "j/batch" / d / "res.png")).max() <= 1


def _stub(pipe, seed=0):
    pipe.tokenizer = chip_smoke.SeededTokenizer(pipe.clip_cfg.vocab_size,
                                                pipe.clip_cfg.vocab_size - 1, seed)
    pipe.tokenizer_2 = chip_smoke.SeededTokenizer(pipe.t5_cfg.vocab_size, 1, seed + 1)
    return pipe


def test_multi_condition_equals_the_pipeline_call(fake_ckpt, tmp_path):  # noqa: F811
    """MultiCondtionUniGenFlux with two condition types and two control
    images: res.png equals ``multi_condition_call`` on the same pipeline
    with the controls read and resized as the CLI reads them, bit for bit;
    a count mismatch refuses."""
    args = cli.parse_args(["--pretrained_model_name_or_path", fake_ckpt, "--basemodel",
                           "MultiCondtionUniGenFlux", "--condition_types", "depth", "canny",
                           "--device", "cpu", "--dtype", "fp32"])
    pipe = _stub(cli.load_pipeline(args))
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"c{i}.png"))
        Image.fromarray(np.random.default_rng(i).integers(0, 256, (RES, RES, 3),
                                                          dtype=np.uint8)).save(paths[-1])
    argv = ["--pretrained_model_name_or_path", fake_ckpt, "--basemodel",
            "MultiCondtionUniGenFlux", "--condition_types", "depth", "canny",
            "--prompt", "a dog", "--control_image", *paths, "--resolution", str(RES),
            "--num_inference_steps", str(STEPS), "--guidance_scale", "2.0", "--seed", "9",
            "--save_path", str(tmp_path / "out"), "--device", "cpu"]
    cli.main(argv, pipeline=pipe)
    controls = [C.to_model_range(np.asarray(Image.open(p).convert("RGB").resize((RES, RES))))[None]
                for p in paths]
    want = pipe.multi_condition_call("a dog", condition_prompts=["depth", "canny"],
                                     control_images=controls, height=RES, width=RES,
                                     num_inference_steps=STEPS, guidance_scale=2.0, seed=9)
    assert np.array_equal(_png(tmp_path / "out/res.png"), want[0].numpy().astype(int))
    with pytest.raises(SystemExit, match="count"):
        cli.main(argv[:-6] + ["--control_image", paths[0], "--save_path", str(tmp_path / "x"),
                              "--device", "cpu"], pipeline=pipe)


def test_sana_family_loads_and_equals_the_pipeline_call(tmp_path):
    """SANAUniGen through ``load_pipeline`` (the loading tests' tiny SANA
    directory, its adapter and CLIP-L): the tree equals
    ``load_sana_pipeline``'s, and res.png equals the pipeline's own call."""
    from tests.test_torch_port_loading import _sana_cfgs
    from unigen_tpu_torch.models import dcae, gemma_text
    from unigen_tpu_torch.models import clip_text as t_clip
    from unigen_tpu_torch.pipelines.loading import load_sana_pipeline
    from unigen_tpu_torch.utils import tree_leaves_with_path
    _, cfg = _sana_cfgs()
    pooled = cfg.sana.pooled_projection_dim
    texts = (gemma_text.tiny_gemma_config(),
             t_clip.tiny_clip_config(hidden_size=pooled, intermediate_size=2 * pooled,
                                     max_position_embeddings=77))
    root = tmp_path / "sana"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "sana_text_configs", lambda: texts)
        mp.setattr(chip_smoke, "sana_dcae_config",
                   lambda: dcae.tiny_dcae_config(latent_channels=cfg.sana.in_channels))
        chip_smoke.write_sana_checkpoint(torch, "cpu", root, cfg, seed=5)
    argv = ["--pretrained_model_name_or_path", str(root), "--basemodel", "SANAUniGen",
            "--condition_types", "canny", "--clip_dir", str(root / "clip"),
            "--prompt", "a cube", "--control_image", str(tmp_path / "c.png"),
            "--resolution", str(RES), "--num_inference_steps", str(STEPS), "--seed", "2",
            "--save_path", str(tmp_path / "out"), "--device", "cpu"]
    Image.fromarray(np.random.default_rng(5).integers(0, 256, (RES, RES, 3), dtype=np.uint8)
                    ).save(tmp_path / "c.png")
    pipe = cli.load_pipeline(cli.parse_args(argv))
    ref = load_sana_pipeline(str(root), condition_types=("canny",),
                             clip_dir=str(root / "clip"), device="cpu")
    want = dict(tree_leaves_with_path(ref.params))
    assert all(torch.equal(t, want[p]) for p, t in tree_leaves_with_path(pipe.params))
    pipe.tokenizer = chip_smoke.SeededTokenizer(pipe.gemma_cfg.vocab_size, 1, 0)
    pipe.tokenizer_clip = chip_smoke.SeededTokenizer(pipe.clip_cfg.vocab_size,
                                                     pipe.clip_cfg.vocab_size - 1, 1)
    cli.main(argv, pipeline=pipe)
    control = C.to_model_range(np.asarray(Image.open(tmp_path / "c.png").convert("RGB")
                                          .resize((RES, RES))))[None]
    img = pipe(prompt="a cube", condition_prompt="canny", control_image=control, height=RES,
               width=RES, num_inference_steps=STEPS, seed=2)
    assert np.array_equal(_png(tmp_path / "out/res.png"), img[0].numpy().astype(int))


def test_refusals(fake_ckpt, tmp_path):  # noqa: F811
    """``--lora_dir`` outside FLUX, a pipeline of another family, an unknown
    ``--cn_config`` key, and the card where there is none."""
    with pytest.raises(SystemExit, match="lora_dir"):
        cli.load_pipeline(cli.parse_args(["--pretrained_model_name_or_path", "x",
                                          "--basemodel", "UniGenSD3", "--lora_dir", "l"]))
    (tmp_path / "c.yaml").write_text("params:\n  control_params:\n    no_such_knob: 1\n")
    with pytest.raises(SystemExit, match="cn_config"):
        cli.load_pipeline(cli.parse_args(["--pretrained_model_name_or_path", fake_ckpt,
                                          "--cn_config", str(tmp_path / "c.yaml"),
                                          "--device", "cpu"]))
    pipe = cli.load_pipeline(cli.parse_args(["--pretrained_model_name_or_path", fake_ckpt,
                                             "--device", "cpu"]))
    with pytest.raises(SystemExit, match="sd3 pipeline"):
        cli.main(["--pretrained_model_name_or_path", fake_ckpt, "--basemodel", "UniGenSD3",
                  "--save_path", str(tmp_path / "o")], pipeline=pipe)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.load_pipeline(cli.parse_args(["--pretrained_model_name_or_path", fake_ckpt]))
