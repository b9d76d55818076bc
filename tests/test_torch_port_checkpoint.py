"""Checkpoints and resume in the port (``train/checkpoint.py``, ``Trainer
(work_dir=...)``) on the CPU, at the tiny preset: the save/restore round
trip bit for bit (the MultiSteps accumulator and the generator state
included), ``latest_step`` and a corrupt checkpoint (a warning and a fresh
start, as the JAX Trainer does), both adapter exports against the JAX
package's files for the same tree (the same names and arrays; the ``.bin``
shards read back by JAX's ``load_adapter_checkpoint``), and a Trainer that
saves at ``checkpointing_steps`` and a second one that resumes: 3 micro-
steps, a save in the middle of a gradient accumulation, a resume and one
more step equal 4 uninterrupted steps bit for bit (the JAX Trainer re-seeds
its key on construction, so its resumed run would repeat the first draws;
the port saves the generator's state)."""

import logging
import os

import jax
import numpy as np
import pytest
import torch

from unigen_tpu import config as j_config
from unigen_tpu.io import torch_bridge as j_tb
from unigen_tpu.models.unigen_flux import init_unigen_flux_control as j_init_control
from unigen_tpu.train import checkpoint as j_ckpt
from unigen_tpu_torch import config as t_config
from unigen_tpu_torch.models.unigen_flux import init_unigen_flux_params
from unigen_tpu_torch.train import checkpoint as t_ckpt
from unigen_tpu_torch.train import loop as t_loop
from unigen_tpu_torch.train.train_step import AdamW, OptState
from unigen_tpu_torch.utils import tree_leaves_with_path, tree_map

B, LAT, T = 2, 8, 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**moe):
    return t_config.UniGenConfig(
        family="flux", flux=t_config.tiny_flux_config(),
        control=t_config.ControlConfig(moe=t_config.MoEConfig(
            batch_mode="per_sample", min_capacity=1, **moe)))


def _params(seed=0, cfg=None):
    return init_unigen_flux_params(cfg or _cfg(), gen=torch.Generator().manual_seed(seed),
                                   device="cpu")


def assert_trees_equal(got, want):
    g, w = dict(tree_leaves_with_path(got)), dict(tree_leaves_with_path(want))
    assert g.keys() == w.keys()
    for k in w:
        if w[k] is None:
            assert g[k] is None, k
            continue
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_save_restore_round_trip_bit_for_bit(tmp_path):
    """A control tree, an optimizer state halfway through a MultiSteps
    accumulation (``acc_grads`` nonzero, mini_step 1) and a generator state
    come back with every bit, dtype and count; the layout is JAX's."""
    control = _params()["control"]
    tx = AdamW(t_config.TrainConfig(gradient_accumulation_steps=2))
    grads = tree_map(lambda x: torch.randn(x.shape, generator=torch.Generator().manual_seed(1)),
                     control)
    _, state = tx.update(grads, tx.init(control), control)
    assert state.mini_step == 1 and state.acc_grads is not None
    gen = torch.Generator().manual_seed(5)
    torch.rand(7, generator=gen)
    path = t_ckpt.save_train_state(str(tmp_path), 12, control, state, extra={"note": "x"},
                                   generator_state=gen.get_state())
    assert sorted(os.listdir(path)) == ["adapter", "generator", "meta.json", "opt_state"]
    assert os.path.basename(path) == "step_00000012"
    assert (tmp_path / "latest").read_text() == "step_00000012"
    got_control, got_state, meta = t_ckpt.restore_train_state(
        str(tmp_path), control, state, map_location="cpu")
    assert_trees_equal(got_control, control)
    assert isinstance(got_state, OptState)
    assert (got_state.count, got_state.mini_step, got_state.gradient_step) == (
        state.count, state.mini_step, state.gradient_step)
    for name in ("mu", "nu", "acc_grads"):
        assert_trees_equal(getattr(got_state, name), getattr(state, name))
    assert meta["step"] == 12 and meta["note"] == "x"
    again = torch.Generator().manual_seed(0)
    again.set_state(meta["generator_state"])
    assert torch.equal(torch.rand(3, generator=again), torch.rand(3, generator=gen))


def test_latest_step_and_corrupt_checkpoint(tmp_path, caplog):
    """No tag or an unreadable one: nothing to resume. A checkpoint whose
    file is corrupt, or whose tree does not match the live state, raises in
    ``restore_train_state``, and the Trainer warns and starts fresh."""
    assert t_ckpt.latest_step(str(tmp_path)) is None
    assert t_ckpt.restore_train_state(str(tmp_path)) is None
    (tmp_path / "latest").write_text("step_garbage")
    assert t_ckpt.latest_step(str(tmp_path)) is None
    params = _params()
    tcfg = t_config.TrainConfig(lr_scheduler="constant")
    trainer = t_loop.Trainer(_cfg(), tcfg, base_params=params["base"],
                             control_params=params["control"], encode_text=None,
                             encode_images=None, work_dir=str(tmp_path), device="cpu")
    assert trainer.maybe_resume() is False
    trainer.save()
    assert t_ckpt.latest_step(str(tmp_path)) == 0
    small = {"x_embedder": params["control"]["x_embedder"]}
    with pytest.raises(ValueError, match="does not match"):
        t_ckpt.restore_train_state(str(tmp_path), small)
    (tmp_path / "step_00000000" / "adapter").write_bytes(b"not a checkpoint")
    with pytest.raises(Exception):
        t_ckpt.restore_train_state(str(tmp_path))
    with caplog.at_level(logging.WARNING, logger="unigen_tpu_torch.train"):
        assert trainer.maybe_resume() is False
    assert "starting fresh" in caplog.text


def test_adapter_exports_match_jax(tmp_path):
    """The flat ``.npz`` and the ``{module}_weights_{idx}.bin`` shards of a
    control tree with single blocks, modulated experts and the shared
    expert hold the names and arrays of JAX's exports of the same tree, bit
    for bit; JAX's ``load_adapter_checkpoint`` reads the port's shards into
    the tree it reads from its own."""
    jc = j_config.UniGenConfig(
        family="flux", flux=j_config.tiny_flux_config(),
        control=j_config.ControlConfig(use_modulate=True))
    tc = t_config.UniGenConfig(
        family="flux", flux=t_config.tiny_flux_config(),
        control=t_config.ControlConfig(use_modulate=True))
    ttree = _params(3, tc)["control"]
    jtree = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), ttree,
                         is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert jax.tree.structure(jtree) == jax.tree.structure(
        jax.eval_shape(lambda k: j_init_control(k, jc), jax.random.PRNGKey(0)))
    j_ckpt.export_adapter_torch_compatible(jtree, str(tmp_path / "jax.npz"))
    t_ckpt.export_adapter_torch_compatible(ttree, str(tmp_path / "port.npz"))
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert any(".deepspeed_experts." in k for k in j.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and np.array_equal(j[k], t[k]), k
    jpaths = j_ckpt.export_adapter_reference_shards(jtree, str(tmp_path / "jax_bins"))
    tpaths = t_ckpt.export_adapter_reference_shards(ttree, str(tmp_path / "port_bins"))
    assert [os.path.basename(p) for p in jpaths] == [os.path.basename(p) for p in tpaths]
    for jp, tp in zip(jpaths, tpaths):
        js, ts = torch.load(jp, weights_only=True), torch.load(tp, weights_only=True)
        assert js.keys() == ts.keys()
        for k in js:
            assert torch.equal(js[k], ts[k]), k
    bb = jc.flux
    kw = dict(n_cn=bb.num_layers // 2, n_cn_single=bb.num_single_layers // 2,
              num_experts=jc.control.moe.num_experts(jc.condition_nums))
    back = j_tb.load_adapter_checkpoint(str(tmp_path / "port_bins"), **kw)
    want = j_tb.load_adapter_checkpoint(str(tmp_path / "jax_bins"), **kw)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def _encoders():
    """Deterministic stand-ins for the text and image towers."""
    bb = t_config.tiny_flux_config()

    def encode_text(prompts):
        seeds = [sum(map(ord, p)) for p in prompts]
        emb = np.stack([np.random.default_rng(s).standard_normal(
            (T, bb.joint_attention_dim)) for s in seeds]).astype(np.float32)
        pooled = np.stack([np.random.default_rng(s + 1).standard_normal(
            bb.pooled_projection_dim) for s in seeds]).astype(np.float32)
        return {"prompt_embeds": torch.from_numpy(emb), "pooled": torch.from_numpy(pooled)}

    def encode_images(px):
        lat = px.reshape(px.shape[0], 3, LAT, 2, LAT, 2).mean(axis=(3, 5))
        return torch.from_numpy(np.concatenate([lat, lat[:, :1]], axis=1).astype(np.float32))
    return encode_text, encode_images


def _batches(n):
    out = []
    for i in range(n):
        rng = np.random.default_rng(40 + i)
        out.append({"descriptions": ["a red cube", f"cats {i}"], "task_names": ["canny"] * 2,
                    "pixel_values": rng.uniform(-1, 1, (B, 3, 2 * LAT, 2 * LAT)).astype(np.float32),
                    "condition_pixels": rng.uniform(-1, 1, (B, 3, 2 * LAT, 2 * LAT)).astype(np.float32)})
    return out


def test_trainer_checkpoints_and_resumes_bit_for_bit(tmp_path):
    """Random token selection in the gate (so the generator draws the MoE's
    uniform as well), accumulation over 2 micro-steps. The first Trainer
    saves at step 3 (``checkpointing_steps``, halfway through an
    accumulation) and again at the end of its batches; a second Trainer
    resumes from ``latest`` with the saved state bit for bit and takes step
    4; its state, counts and generator equal those of 4 uninterrupted
    steps, bit for bit."""
    cfg = _cfg(use_rts=True)
    params = _params(1, cfg)
    kw = dict(lr_scheduler="constant", learning_rate=1e-3, gradient_accumulation_steps=2,
              max_train_steps=4, checkpointing_steps=3, seed=8, remat="full")
    text, images = _encoders()
    batches = _batches(4)

    def trainer(work_dir):
        return t_loop.Trainer(cfg, t_config.TrainConfig(**kw), base_params=params["base"],
                              control_params=params["control"], encode_text=text,
                              encode_images=images, work_dir=work_dir, device="cpu")
    straight = trainer(None)
    straight.train(batches)
    assert straight.global_step == 4 and straight.state.opt_state.count == 2

    first = trainer(str(tmp_path))
    assert first.maybe_resume() is False
    first.train(batches[:3])
    assert t_ckpt.latest_step(str(tmp_path)) == 3
    assert sorted(os.listdir(tmp_path)) == ["latest", "step_00000003"]
    second = trainer(str(tmp_path))
    assert second.maybe_resume() is True and second.global_step == 3
    assert_trees_equal(second.state.control, first.state.control)
    assert_trees_equal(second.state.opt_state.acc_grads, first.state.opt_state.acc_grads)
    assert second.state.opt_state.mini_step == 1
    second.train(batches[3:])
    assert second.global_step == 4 and t_ckpt.latest_step(str(tmp_path)) == 4
    assert_trees_equal(second.state.control, straight.state.control)
    for name in ("mu", "nu", "acc_grads"):
        assert_trees_equal(getattr(second.state.opt_state, name),
                           getattr(straight.state.opt_state, name))
    assert second.state.step == straight.state.step == 4
    assert torch.equal(second._generator.get_state(), straight._generator.get_state())
