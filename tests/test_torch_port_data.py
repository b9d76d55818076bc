"""The port's data pipeline (``unigen_tpu_torch/data``) against the JAX
package's on the CPU: the mixed-task sampler's index stream for the same
seed, rank and replicas; the prefetcher's order with one worker, its error
passing and ``stats``; the condition synthesizers; the native host library
(built by the port from ``native/image_pipeline.cpp`` into
``build/native/``) and the numpy path beside it; the Subjects-200K,
multi-condition and MultiGen items read from the same files on disk, the
reference resize rules, ``ConcatDataset``, ``collate`` and
``partition_subjects200k``. Everything bit for bit."""

import json
import os
import random

import numpy as np
import pytest

from tests.test_datasets_disk import _img, subjects_root  # noqa: F401
from unigen_tpu.data import conditions as j_cond
from unigen_tpu.data import datasets as j_data
from unigen_tpu.data import native as j_native
from unigen_tpu.data import prefetch as j_prefetch
from unigen_tpu.data import sampler as j_sampler
from unigen_tpu_torch.data import conditions as t_cond
from unigen_tpu_torch.data import datasets as t_data
from unigen_tpu_torch.data import native as t_native
from unigen_tpu_torch.data import prefetch as t_prefetch
from unigen_tpu_torch.data import sampler as t_sampler


def _equal(got, want):
    """Items, batches and nested containers equal, arrays bit for bit."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("lengths,batch,replicas,rank,shuffle,drop_last", [
    ([7, 3, 12], 6, 1, 0, True, False),
    ([5, 9], 8, 2, 1, True, True),
    ([4, 4, 4, 4], 3, 1, 0, False, False),
    ([10, 1], 4, 2, 0, True, False)])
def test_sampler_index_stream_matches_jax(lengths, batch, replicas, rank, shuffle, drop_last):
    """Two passes over the sampler (each starts anew from the seed and
    rank; short tasks are tiled and reshuffled when exhausted) give JAX's
    batches, and its length."""
    kw = dict(num_replicas=replicas, rank=rank, shuffle=shuffle, seed=3,
              drop_last=drop_last)
    j = j_sampler.MultiTaskMixedBatchSampler(lengths, batch, **kw)
    t = t_sampler.MultiTaskMixedBatchSampler(lengths, batch, **kw)
    assert len(t) == len(j)
    for _ in range(2):
        assert list(t) == list(j)


def test_prefetcher_order_errors_and_stats_match_jax():
    """One worker keeps the source's order; ``map_fn`` runs in the worker;
    an error in the source reaches the consumer after the items before it;
    ``stats`` counts the deliveries."""
    for lib in (j_prefetch, t_prefetch):
        pf = lib.Prefetcher(range(20), depth=3, workers=1, map_fn=lambda x: x * x)
        assert list(pf) == [i * i for i in range(20)]
        assert pf.stats()["batches"] == 20 and pf.stats()["wait_s"] >= 0

    def bad():
        yield 1
        yield 2
        raise RuntimeError("boom")
    for lib in (j_prefetch, t_prefetch):
        got = []
        with pytest.raises(RuntimeError, match="boom"):
            for x in lib.Prefetcher(bad(), workers=1):
                got.append(x)
        assert got == [1, 2]
    many = t_prefetch.Prefetcher(range(50), depth=2, workers=3)
    assert sorted(many) == list(range(50))
    many.close()


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)


def test_native_library_and_numpy_path_match_jax(images, monkeypatch):
    """The port builds its own copy of the library into build/native/ and
    every function equals JAX's bindings; with the library away, both
    packages' numpy paths agree too."""
    assert t_native.available()
    assert os.path.dirname(t_native._SO).endswith(os.path.join("build", "native"))
    calls = [("normalize_chw", (images,)), ("resize_bilinear", (images, 17, 29)),
             ("grayscale", (images,)), ("sobel_edges", (images, 120.0)),
             ("gaussian_blur", (images, 3.0))]
    for name, args in calls:
        _equal(getattr(t_native, name)(*args), getattr(j_native, name)(*args))
    for lib in (t_native, j_native):
        monkeypatch.setattr(lib, "_load", lambda: None)
    for name, args in calls:
        _equal(getattr(t_native, name)(*args), getattr(j_native, name)(*args))


def test_conditions_match_jax(images):
    """Every synthesizer and helper gives JAX's bits (``make_depth_fn``, on
    a Depth-Anything tree, is held against JAX's in
    ``tests/test_torch_port_depth.py``)."""
    img = images[0]
    assert t_cond.CONDITION_TYPE_IDS == j_cond.CONDITION_TYPE_IDS
    _equal(t_cond.to_model_range(img), j_cond.to_model_range(img))
    x = t_cond.to_model_range(img)
    _equal(t_cond.from_model_range(x), j_cond.from_model_range(x))
    for kind in ("canny", "coloring", "grayscale", "deblurring", "blur", "seg"):
        _equal(t_cond.synthesize(kind, img), j_cond.synthesize(kind, img))
    _equal(t_cond.canny(img, 50, 120), j_cond.canny(img, 50, 120))
    _equal(t_cond.fill_mask(img, (2, 20, 5, 30)), j_cond.fill_mask(img, (2, 20, 5, 30)))
    _equal(t_cond.inpaint_mask(img, (2, 20, 5, 30)), j_cond.inpaint_mask(img, (2, 20, 5, 30)))
    depth = lambda u8: 255 - u8
    _equal(t_cond.synthesize("depth", img, depth_fn=depth),
           j_cond.synthesize("depth", img, depth_fn=depth))
    for kind in ("subject", "canny"):
        assert t_cond.condition_id_offset(kind, 64) == j_cond.condition_id_offset(kind, 64)


def test_reference_resize_rules_match_jax():
    """The reference's crop-rate propagation control -> target and its
    interpolation rule (LANCZOS4 up, AREA down, k from the uncropped
    dims), from the same random.Random."""
    r = np.random.default_rng(1)
    for shape, tshape, res in (((40, 64, 3), (80, 128, 3), 48),
                               ((90, 30, 3), (45, 15, 3), 16)):
        control = r.integers(0, 255, shape, dtype=np.uint8)
        target = r.integers(0, 255, tshape, dtype=np.uint8)
        jc, jrates = j_data.resize_image_control(control, res, random.Random(7))
        tc, trates = t_data.resize_image_control(control, res, random.Random(7))
        _equal(tc, jc)
        assert trates == jrates
        _equal(t_data.resize_image_target(target, res, trates),
               j_data.resize_image_target(target, res, jrates))
        _equal(t_data._ref_resize(control, res, 0.5), j_data._ref_resize(control, res, 0.5))


@pytest.fixture(scope="module")
def multigen_root(tmp_path_factory):
    """Both MultiGen record layouts: the simplified one (``image``/
    ``source``) for canny, the reference's (``source`` under images/,
    ``control_{task}`` under conditions/) for depth."""
    root = str(tmp_path_factory.mktemp("multigen"))
    os.makedirs(os.path.join(root, "json_files"))
    simple, ref = [], []
    for i in range(5):
        _img(os.path.join(root, f"img/{i}_t.jpg"), (20 * i, 40, 90), size=(40, 24))
        _img(os.path.join(root, f"img/{i}_s.jpg"), (90, 20 * i, 40), size=(40, 24))
        simple.append({"image": f"img/{i}_t.jpg", "source": f"img/{i}_s.jpg",
                       "prompt": f"p{i}"})
        _img(os.path.join(root, "images", f"pics/{i}.jpg"), (20 * i, 40, 90), size=(48, 32))
        _img(os.path.join(root, "conditions", f"group_0_{i}.jpg"), (90, 20 * i, 40),
             size=(48, 32))
        ref.append({"source": f"./pics/{i}.jpg", "control_depth": f"x_group_0_{i}.jpg",
                    "prompt": f"q{i}"})
    for task, recs in (("canny", simple), ("depth", ref)):
        with open(os.path.join(root, "json_files",
                               f"aesthetics_plus_all_group_{task}_all.json"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs))
    return root


def test_datasets_match_jax(subjects_root, multigen_root):  # noqa: F811
    """Every item of Subjects200K (depth from files, canny on the fly,
    subject, both splits), MultiConditionSubjects200K, MultiGen (both
    record layouts, with prompt dropout) and their ConcatDataset, and the
    collated batches (single and multi-condition), equal JAX's."""
    cases = [dict(condition_type=c, resolution=16, split=s, seed=2)
             for c in ("depth", "canny", "subject") for s in ("train", "test")]
    for kw in cases:
        j = j_data.Subjects200K(subjects_root, **kw)
        t = t_data.Subjects200K(subjects_root, **kw)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            _equal(t[i], j[i])
    kw = dict(condition_types=("depth", "canny"), resolution=16)
    jm = j_data.MultiConditionSubjects200K(subjects_root, **kw)
    tm = t_data.MultiConditionSubjects200K(subjects_root, **kw)
    for i in range(len(jm)):
        _equal(tm[i], jm[i])
    _equal(t_data.collate([tm[0], tm[1]], condition_types=("depth", "canny")),
           j_data.collate([jm[0], jm[1]], condition_types=("depth", "canny")))
    for task in ("canny", "depth"):
        for split in ("train", "test"):
            kw = dict(resolution=16, split=split, seed=1, prompt_dropout=0.5)
            j = j_data.MultiGen(multigen_root, task, **kw)
            t = t_data.MultiGen(multigen_root, task, **kw)
            assert len(t) == len(j) > 0
            for i in range(len(j)):
                _equal(t[i], j[i])
    parts = [("canny", "train"), ("depth", "train")]
    jc = j_data.ConcatDataset([j_data.MultiGen(multigen_root, k, resolution=16, split=s)
                               for k, s in parts])
    tc = t_data.ConcatDataset([t_data.MultiGen(multigen_root, k, resolution=16, split=s)
                               for k, s in parts])
    assert len(tc) == len(jc) == 8
    for i in range(len(jc)):
        _equal(tc[i], jc[i])
    _equal(t_data.collate([tc[i] for i in (0, 5, 7)]),
           j_data.collate([jc[i] for i in (0, 5, 7)]))
    test = t_data.Subjects200K(subjects_root, "depth", resolution=16, split="test")
    jtest = j_data.Subjects200K(subjects_root, "depth", resolution=16, split="test")
    _equal(t_data.collate([test[0]]), j_data.collate([jtest[0]]))


def test_partition_subjects200k_matches_jax():
    rng = np.random.default_rng(4)
    recs = [{"quality_assessment": {"compositeStructure": int(a), "objectConsistency": int(b),
                                    "imageQuality": int(c)}}
            for a, b, c in rng.integers(1, 6, (60, 3))] + [{}, {"quality_assessment": None}]
    for kw in ({}, dict(train_scores=(4, 5, 5), min_composite=2, quality=4)):
        assert t_data.partition_subjects200k(recs, **kw) == \
            j_data.partition_subjects200k(recs, **kw)
