"""Datasets: MultiGen-20M, Subjects-200K, multi-condition variant, collate
(port of ``unigen_tpu/data/datasets.py``).

Re-design of reference src/dataloader.py (MultiGen :15-126, Subjects200K
:128-235, collate :237-281, MultiConditionSubjects200K :284-407) and
src/partition_dataset.py as framework-agnostic map-style datasets returning
numpy dicts (the Trainer moves them to the card). Image files are read
with Pillow; a host without it cannot build these datasets.

Layout/semantics preserved:
  * MultiGen: per-task jsonl ``json_files/aesthetics_plus_all_group_{task}_all.json``
    with source/target paths + prompt; 80/20 split by index; random-crop with
    the SAME crop propagated control->target; LANCZOS/AREA resize.
  * Subjects200K: glob ``score_*/*_{kind}_*.jpg`` with kinds
    (depth_large, target, subject, openpose); canny computed on the fly;
    test split from test_infos/*.txt; description JSON sidecars; 30% prompt
    dropout on train.
  * collate: stacks pixel_values/condition tensors for train, keeps lists of
    uint8 images + prompts for test.
"""

from __future__ import annotations

import glob as globlib
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from unigen_tpu_torch.data import conditions as C

try:
    from PIL import Image
    HAS_PIL = True
except Exception:  # pragma: no cover
    HAS_PIL = False


PROMPT_DROPOUT = 0.3  # reference dataloader.py:222,235


def _load_image(path: str) -> np.ndarray:
    img = Image.open(path).convert("RGB")
    return np.asarray(img)


def _resize(img: np.ndarray, size: int, *, down_ok: bool = True) -> np.ndarray:
    """LANCZOS upscale / AREA downscale (reference resize_image_* :37-67)."""
    pil = Image.fromarray(img)
    method = Image.LANCZOS if (pil.size[0] < size or not down_ok) else Image.BOX
    return np.asarray(pil.resize((size, size), method))


def _ref_resize(img: np.ndarray, size: int, k: float) -> np.ndarray:
    """cv2.resize to (size, size); LANCZOS4 when the pre-crop shorter side
    upscales (k > 1) else AREA — the reference's exact interpolation rule,
    including the quirk that k is computed from the ORIGINAL dims, not the
    cropped square (dataloader.py:52-55,65-66)."""
    try:
        import cv2
        interp = cv2.INTER_LANCZOS4 if k > 1 else cv2.INTER_AREA
        return cv2.resize(img, (size, size), interpolation=interp)
    except ImportError:  # pragma: no cover
        return _resize(img, size, down_ok=(k <= 1))


def resize_image_control(img: np.ndarray, resolution: int, rng: random.Random):
    """Reference ``resize_image_control`` (dataloader.py:37-55): random
    SQUARE crop of the shorter side, resize, and return the crop RATES
    [t/H, b/H, l/W, r/W] so the target applies the same relative crop."""
    h, w = img.shape[:2]
    if w >= h:
        crop = h
        left = rng.randint(0, w - crop)      # randint is inclusive, like the ref
        t, b, l, r = 0, h, left, left + crop
    else:
        crop = w
        top = rng.randint(0, h - crop)
        t, b, l, r = top, top + crop, 0, w
    out = _ref_resize(img[t:b, l:r], resolution, resolution / min(h, w))
    return out, (t / h, b / h, l / w, r / w)


def resize_image_target(img: np.ndarray, resolution: int, rates) -> np.ndarray:
    """Reference ``resize_image_target`` (dataloader.py:57-67): the control's
    crop rates re-scaled to THIS image's dims, then the same resize rule."""
    h, w = img.shape[:2]
    tr, br, lr, rr = rates
    t, b, l, r = int(tr * h), int(br * h), int(lr * w), int(rr * w)
    return _ref_resize(img[t:b, l:r], resolution, resolution / min(h, w))


class MultiGen:
    """MultiGen-20M single-task dataset (one instance per condition type)."""

    def __init__(self, data_path: str, task: str, resolution: int = 512,
                 split: str = "train", seed: int = 0,
                 json_dir: str = "json_files", prompt_dropout: float = 0.0):
        # prompt_dropout defaults OFF: the reference ships MultiGen's 30%
        # dropout commented out (dataloader.py:115) — only Subjects200K
        # drops prompts
        self.data_path = data_path
        self.task = task
        self.resolution = resolution
        self.split = split
        self.seed = seed
        self.prompt_dropout = prompt_dropout
        json_path = os.path.join(
            data_path, json_dir, f"aesthetics_plus_all_group_{task}_all.json")
        self.records: List[dict] = []
        if os.path.exists(json_path):
            with open(json_path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self.records.append(json.loads(line))
        n_train = int(len(self.records) * 0.8)
        self.records = (self.records[:n_train] if split == "train"
                        else self.records[n_train:])

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.records[i]
        rng = random.Random(self.seed * 1_000_003 + i)
        # Reference record layout (dataloader.py:84-100): the single key
        # containing 'control' names the condition under conditions/
        # (``group_`` + the part after '_group_'); 'source' is the TARGET
        # under images/ ('./' prefix stripped).
        ckeys = [k for k in rec if "control" in k]
        if len(ckeys) == 1 and "source" in rec:
            ckey = ckeys[0]
            control_path = os.path.join(
                self.data_path, "conditions",
                "group_" + rec[ckey].split("_group_")[-1])
            tname = rec["source"]
            tname = tname[2:] if tname.startswith("./") else tname
            target_path = os.path.join(self.data_path, "images", tname)
            task = ckey.replace("control_", "")
        else:  # simplified synthetic layout (tests / custom data)
            target_path = os.path.join(self.data_path,
                                       rec.get("image", rec.get("target", "")))
            control_path = os.path.join(self.data_path,
                                        rec.get("source", rec.get("control", "")))
            task = self.task
        target = _load_image(target_path)
        control = _load_image(control_path)
        # crop-rate propagation control -> target, BOTH splits (ref :106-107)
        control, rates = resize_image_control(control, self.resolution, rng)
        target = resize_image_target(target, self.resolution, rates)
        prompt = rec.get("prompt", "")
        if self.split == "train" and rng.random() < self.prompt_dropout:
            prompt = ""
        return {
            "pixel_values": C.to_model_range(target),
            "condition_pixels": C.to_model_range(control),
            "descriptions": prompt,
            "task_names": task,
        }


_SUBJECT_KINDS = {"depth": "depth_large", "subject": "subject",
                  "openpose": "openpose", "target": "target"}


class Subjects200K:
    """Subjects-200K subject-driven dataset (reference :128-235)."""

    def __init__(self, data_path: str, condition_type: str = "depth",
                 resolution: int = 512, split: str = "train",
                 test_split: str = "depth_subject_pose.txt", seed: int = 0):
        assert split in ("train", "test")
        self.data_path = data_path
        self.condition_type = condition_type
        self.resolution = resolution
        self.split = split
        self.seed = seed

        targets = sorted(globlib.glob(os.path.join(data_path, "score_*",
                                                   "*_target_*.jpg")))
        test_names = set()
        test_file = os.path.join(data_path, "test_infos", test_split)
        if os.path.exists(test_file):
            with open(test_file) as f:
                test_names = {l.strip() for l in f if l.strip()}
        def is_test(p):
            return os.path.basename(p) in test_names
        self.targets = [p for p in targets if is_test(p) == (split == "test")]

    def __len__(self) -> int:
        return len(self.targets)

    def _condition_path(self, target_path: str) -> Optional[str]:
        kind = _SUBJECT_KINDS.get(self.condition_type)
        if kind is None or self.condition_type == "canny":
            return None
        p = target_path.replace("_target_", f"_{kind}_")
        return p if os.path.exists(p) else None

    def __getitem__(self, i: int) -> Dict[str, Any]:
        path = self.targets[i]
        rng = random.Random(self.seed * 1_000_003 + i)
        target = _resize(_load_image(path), self.resolution)
        cpath = self._condition_path(path)
        if self.condition_type == "canny" or cpath is None:
            control = C.synthesize("canny", target)
        else:
            control = _resize(_load_image(cpath), self.resolution)

        prompt = ""
        desc_path = os.path.splitext(path)[0] + ".json"
        if os.path.exists(desc_path):
            with open(desc_path) as f:
                meta = json.load(f)
            prompt = meta.get("description", meta.get("prompt", ""))
        if self.split == "train" and rng.random() < PROMPT_DROPOUT:
            prompt = ""

        if self.split == "train":
            return {"pixel_values": C.to_model_range(target),
                    "condition_pixels": C.to_model_range(control),
                    "descriptions": prompt,
                    "task_names": self.condition_type}
        return {"target_image": target, "condition_image": control,
                "descriptions": prompt, "task_names": self.condition_type}


class MultiConditionSubjects200K(Subjects200K):
    """One sample carries ALL requested condition images keyed by type
    (reference :284-407)."""

    def __init__(self, data_path: str, condition_types: Sequence[str] = ("depth", "canny"),
                 **kw):
        super().__init__(data_path, condition_type=condition_types[0], **kw)
        self.condition_types = list(condition_types)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        path = self.targets[i]
        rng = random.Random(self.seed * 1_000_003 + i)
        target = _resize(_load_image(path), self.resolution)
        out: Dict[str, Any] = {"pixel_values": C.to_model_range(target)}
        for ct in self.condition_types:
            self.condition_type = ct
            cpath = self._condition_path(path)
            if ct == "canny" or cpath is None:
                control = C.synthesize("canny", target)
            else:
                control = _resize(_load_image(cpath), self.resolution)
            out[ct] = C.to_model_range(control)
        prompt = ""
        desc_path = os.path.splitext(path)[0] + ".json"
        if os.path.exists(desc_path):
            with open(desc_path) as f:
                prompt = json.load(f).get("description", "")
        if self.split == "train" and rng.random() < PROMPT_DROPOUT:
            prompt = ""
        out["descriptions"] = prompt
        return out


class ConcatDataset:
    """Concatenation for the multi-task sampler (global index space)."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._lengths = [len(d) for d in self.datasets]
        self._offsets = np.cumsum([0] + self._lengths[:-1])

    def __len__(self):
        return sum(self._lengths)

    def __getitem__(self, i: int):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]


def collate(samples: List[Dict[str, Any]],
            condition_types: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """dict-of-lists batching; numeric arrays stacked (reference collate_fn
    :237-281 and collect_multi_condition_fun :370-407)."""
    out: Dict[str, Any] = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray) and vals[0].dtype != np.uint8:
            out[k] = np.stack(vals)
        else:
            out[k] = vals
    if condition_types:
        # stack per-condition tensors into a leading condition axis [K, B, ...]
        out["condition_pixels"] = np.stack([out.pop(ct) for ct in condition_types])
    return out


def partition_subjects200k(dataset, *, train_scores=(5, 5, 5),
                           min_composite: int = 3, quality: int = 5):
    """HF-datasets filtering equivalent of reference partition_dataset.py:8-51:
    items whose quality_assessment equals ``train_scores`` go to train; items
    with composite >= min_composite and quality == ``quality`` go to test."""
    train_idx, test_idx = [], []
    for i, rec in enumerate(dataset):
        qa = rec.get("quality_assessment") or {}
        scores = (qa.get("compositeStructure", 0), qa.get("objectConsistency", 0),
                  qa.get("imageQuality", 0))
        if tuple(scores) == tuple(train_scores):
            train_idx.append(i)
        elif scores[0] >= min_composite and scores[2] == quality:
            test_idx.append(i)
    return train_idx, test_idx
