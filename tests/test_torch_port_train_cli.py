"""The port's training entry point (``python -m unigen_tpu_torch.cli.train``)
on the CPU: its flags against ``scripts/train.py``'s, the refusal of
anything wider than one card, and ``main`` in process at the tiny preset on
a random FLUX directory and a Subjects-200K fixture on disk (depth
conditions from files): 2 LoRA steps with a checkpoint at each, a second
``main`` that resumes and stops at ``--max_train_steps`` (its adapter equal,
bit for bit, to an uninterrupted run's), and the completed-run pre-check.
The exported adapter is read by ``safetensors.numpy`` and by the JAX
package's ``load_lora_adapters``. The directory holds no tokenizers, so the
pipeline is loaded first and handed to ``main`` with seeded stub ones (as
``chip_smoke.py`` does on the card host, which has no ``transformers``)."""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_datasets_disk import subjects_root  # noqa: F401
from tests.test_from_pretrained import fake_ckpt  # noqa: F401
from unigen_tpu.io import torch_bridge as j_tb
from unigen_tpu_torch.cli import train as cli
from unigen_tpu_torch.pipelines import caching
from unigen_tpu_torch.pipelines.loading import load_flux_pipeline
from unigen_tpu_torch.train import checkpoint as t_ckpt
from unigen_tpu_torch.utils import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _jax_parse_args():
    spec = importlib.util.spec_from_file_location("jax_train_script",
                                                  ROOT / "scripts" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_args


@pytest.mark.parametrize("argv", [
    ["--pretrained_model_name_or_path", "x"],
    ["--pretrained_model_name_or_path", "x", "--rank", "16", "--lora_targets", "a", "b",
     "--condition_types", "depth", "--dataset_name", "MultiGen", "--scale_lr",
     "--num_train_epochs", "3", "--mixed_precision", "fp32", "--lr_scheduler", "linear",
     "--disable_single_trans_blocks", "--cn_config", "c.yaml", "--mesh-data", "1"]])
def test_parse_args_matches_scripts_train(argv):
    """Every flag and default of scripts/train.py, plus ``--device``
    (cuda unless named)."""
    got = vars(cli.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(_jax_parse_args()(argv))
    assert cli.parse_args(argv + ["--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("flags", [["--mesh-expert", "2"], ["--mesh-data", "4"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--num-processes", "2"]])
def test_wider_than_one_card_refuses(flags):
    with pytest.raises(SystemExit, match="item 8"):
        cli.main(["--pretrained_model_name_or_path", "x"] + flags)


def _pipeline(root):
    pipe = load_flux_pipeline(root, condition_types=("depth",), dtype=torch.float32,
                              device="cpu")
    pipe.tokenizer = chip_smoke.SeededTokenizer(pipe.clip_cfg.vocab_size,
                                                pipe.clip_cfg.vocab_size - 1, 0)
    pipe.tokenizer_2 = chip_smoke.SeededTokenizer(pipe.t5_cfg.vocab_size, 1, 1)
    pipe._prompt_cache = caching.PromptLRU(16)
    return pipe


def test_main_lora_checkpoint_resume_and_completed_run(fake_ckpt, subjects_root,  # noqa: F811
                                                        tmp_path):
    """2 LoRA steps (rank 2, batch 2 at 16x16) with a checkpoint every step,
    then ``--max_train_steps 4``: the second run resumes at 2, skips the two
    batches its checkpoint saw, and ends at 4 with the adapter of 4
    uninterrupted steps, bit for bit; a third call finds the run complete
    and trains nothing. The adapter file holds the reference's PEFT keys,
    which safetensors.numpy and JAX's loader read back to the Trainer's
    factors."""
    from safetensors.numpy import load_file
    pipe = _pipeline(fake_ckpt)

    def argv(work_dir, steps):
        return ["--pretrained_model_name_or_path", fake_ckpt, "--data_path", subjects_root,
                "--dataset_name", "Subjects200K", "--condition_types", "depth",
                "--rank", "2", "--train_batch_size", "2", "--resolution", "16",
                "--max_sequence_length", "8", "--max_train_steps", str(steps),
                "--checkpointing_steps", "1", "--lr_scheduler", "constant",
                "--learning_rate", "1e-3", "--work_dir", str(work_dir), "--device", "cpu",
                "--seed", "3"]
    first = cli.main(argv(tmp_path / "run", 2), pipeline=pipe)
    assert first.global_step == 2 and t_ckpt.latest_step(str(tmp_path / "run")) == 2
    assert sorted(os.listdir(tmp_path / "run")) == [
        "latest", "lora_adapters", "step_00000001", "step_00000002", "train.log"]
    assert first.prefetcher.stats()["batches"] == 2
    resumed = cli.main(argv(tmp_path / "run", 4), pipeline=pipe)
    assert resumed.global_step == 4 and resumed.prefetcher.stats()["batches"] == 2
    straight = cli.main(argv(tmp_path / "straight", 4), pipeline=pipe)
    assert straight.global_step == 4
    for path, ab in straight.state.control.items():
        for k in ("a", "b"):
            assert torch.equal(resumed.state.control[path][k], ab[k]), (path, k)
    assert float(resumed.state.control["control.add_single"]["b"].abs().max()) > 0
    assert cli.main(argv(tmp_path / "run", 4), pipeline=pipe) is None

    f = tmp_path / "run" / "lora_adapters" / "depth" / "pytorch_lora_weights.safetensors"
    sd = load_file(str(f))
    assert all(k.startswith("transformer.") and k.endswith(("lora_A.weight", "lora_B.weight"))
               for k in sd)
    assert "transformer.controlnet_add_single_blocks.0.lora_B.weight" in sd
    shapes = tree_map(lambda t: t.numpy(), pipe.params)
    back = j_tb.load_lora_adapters(str(tmp_path / "run" / "lora_adapters"), shapes)["depth"]
    assert sorted(back) == sorted(resumed.state.control)
    for path, ab in resumed.state.control.items():
        for k in ("a", "b"):
            np.testing.assert_array_equal(np.asarray(back[path][k]), ab[k].numpy())
