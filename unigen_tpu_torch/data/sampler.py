"""Deterministic multi-task mixed-batch sampler (port of
``unigen_tpu/data/sampler.py``, the same index stream for the same seed,
rank and replica count).

Re-design of the reference ``MultiTaskMixedBatchSampler``
(src/UniGenUtils.py:232-338) with the same contract:
  * each task's index list is oversampled (tiled) to the longest task's
    length, shuffled once with the global seed;
  * each rank takes a strided slice (indices[rank::num_replicas]);
  * every local batch draws local_batch_size // num_tasks samples per task
    (+1 for the first `remainder` tasks in a per-batch shuffled task order);
  * an exhausted task reshuffles its per-rank list with the rank-offset seed.

Determinism: fully reproducible from (seed, rank) via numpy Generator. (The
reference uses torch randperm — deterministic per seed but not bit-identical
to numpy; the CONTRACT, not the torch bitstream, is what is preserved.)
"""

from __future__ import annotations

import math
from typing import Iterator, List, Sequence

import numpy as np


class MultiTaskMixedBatchSampler:
    def __init__(self, dataset_lengths: Sequence[int], batch_size: int,
                 num_replicas: int = 1, rank: int = 0, shuffle: bool = True,
                 seed: int = 42, drop_last: bool = False):
        self.dataset_lengths = list(dataset_lengths)
        self.num_datasets = len(self.dataset_lengths)
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

        self.max_length = max(self.dataset_lengths)
        self.total_samples = self.max_length * self.num_datasets
        self.samples_per_replica = math.ceil(self.total_samples / num_replicas)
        self.local_batch_size = batch_size // num_replicas
        assert self.local_batch_size > 0, "batch_size must cover all replicas"

        # global concatenated-index ranges per task
        starts = np.cumsum([0] + self.dataset_lengths[:-1])
        g = np.random.default_rng(seed)
        self._task_indices: List[np.ndarray] = []
        for start, length in zip(starts, self.dataset_lengths):
            idx = np.arange(start, start + length)
            reps = math.ceil(self.max_length / length)
            idx = np.tile(idx, reps)[: self.max_length]
            if shuffle:
                idx = idx[g.permutation(len(idx))]
            self._task_indices.append(idx)

    def __len__(self) -> int:
        if self.drop_last:
            return self.samples_per_replica // self.local_batch_size
        return math.ceil(self.samples_per_replica / self.local_batch_size)

    def __iter__(self) -> Iterator[List[int]]:
        g = np.random.default_rng(self.seed + self.rank)
        per_rank = [idx[self.rank::self.num_replicas].copy()
                    for idx in self._task_indices]
        cursors = [0] * self.num_datasets
        collected = 0
        per_task = self.local_batch_size // self.num_datasets
        extra = self.local_batch_size % self.num_datasets

        while collected < self.samples_per_replica:
            task_order = list(range(self.num_datasets))
            if self.shuffle:
                task_order = [task_order[i] for i in g.permutation(self.num_datasets)]
            batch: List[int] = []
            for pos, task in enumerate(task_order):
                n = per_task + (1 if pos < extra else 0)
                for _ in range(n):
                    if cursors[task] >= len(per_rank[task]):
                        lst = per_rank[task]
                        if self.shuffle:
                            lst = lst[g.permutation(len(lst))]
                        per_rank[task] = lst
                        cursors[task] = 0
                    batch.append(int(per_rank[task][cursors[task]]))
                    cursors[task] += 1
            if not batch:
                break
            if len(batch) < self.local_batch_size and self.drop_last:
                break
            if self.shuffle:
                batch = [batch[i] for i in g.permutation(len(batch))]
            yield batch
            collected += len(batch)
