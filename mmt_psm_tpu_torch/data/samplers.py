"""Index samplers (the port's copy of ``mmt_psm_tpu/data/samplers.py``; numpy only).

Ports of the reference's sampler zoo (reference:
maskrcnn_benchmark/data/samplers/): GroupedBatchSampler
(grouped_batch_sampler.py:9-115), IterationBasedBatchSampler
(iteration_based_batch_sampler.py:5-31), a shard sampler replacing
DistributedSampler (distributed.py:10-66: each rank's share of an
index space, the sharded evaluation's split), and WeightedRandomSubsetSampler
(weighted_random_sampler.py:6-36).

All samplers are plain iterables of indices / index batches over numpy,
matching the reference's iteration contracts (verified against its own
unit tests, tests/test_data_samplers.py).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


class SequentialSampler:
    def __init__(self, n: int):
        self.n = n

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    def __init__(self, n: int, seed: int = 0):
        self.n = n
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class BatchSampler:
    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


class GroupedBatchSampler:
    """Batches contain only elements from one group (aspect-ratio
    grouping), preserving sampler order as closely as possible —
    algorithm identical to the reference (:40-100)."""

    def __init__(self, sampler, group_ids: Sequence[int], batch_size: int, drop_uneven: bool = False):
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        if self.group_ids.ndim != 1:
            raise ValueError(f"group_ids must be 1-D, not of shape {self.group_ids.shape}")
        self.batch_size = batch_size
        self.drop_uneven = drop_uneven
        self.groups = np.sort(np.unique(self.group_ids))
        self._batches = None
        self._can_reuse_batches = False

    def _prepare_batches(self) -> List[List[int]]:
        dataset_size = len(self.group_ids)
        sampled_ids = np.asarray(list(self.sampler))
        order = np.full(dataset_size, -1, np.int64)
        order[sampled_ids] = np.arange(len(sampled_ids))
        mask = order >= 0

        merged = []
        for g in self.groups:
            cluster = (self.group_ids == g) & mask
            relative_order = order[cluster]
            # dataset ids of this cluster in sampler order
            cluster_ids = np.nonzero(cluster)[0]
            permuted = cluster_ids[np.argsort(relative_order)]
            for start in range(0, len(permuted), self.batch_size):
                merged.append(permuted[start : start + self.batch_size])

        inv = {int(v): k for k, v in enumerate(sampled_ids)}
        first_index = [inv[int(t[0])] for t in merged]
        batches = [merged[i].tolist() for i in np.argsort(first_index, kind="stable")]
        if self.drop_uneven:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __iter__(self):
        if self._can_reuse_batches:
            batches = self._batches
            self._can_reuse_batches = False
        else:
            batches = self._prepare_batches()
        self._batches = batches
        return iter(batches)

    def __len__(self):
        if self._batches is None:
            self._batches = self._prepare_batches()
            self._can_reuse_batches = True
        return len(self._batches)


class IterationBasedBatchSampler:
    """Resample from a batch sampler until num_iterations
    (iteration_based_batch_sampler.py:5-31, inclusive upper bound)."""

    def __init__(self, batch_sampler, num_iterations: int, start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        iteration = self.start_iter
        while iteration <= self.num_iterations:
            sampler = getattr(self.batch_sampler, "sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(iteration)
            for batch in self.batch_sampler:
                iteration += 1
                if iteration > self.num_iterations:
                    break
                yield batch

    def __len__(self):
        return self.num_iterations


class ShardSampler:
    """One rank's shard of a (possibly shuffled) index space, as torch's
    DistributedSampler (distributed.py:10-66): padded with the first indices
    to a multiple of the world size, so every rank sees equal counts."""

    def __init__(self, n: int, num_shards: int, shard_id: int, shuffle: bool = True, seed: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        self.n = n
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = math.ceil(n / num_shards)
        self.total_size = self.num_samples * num_shards

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.n).tolist()
        else:
            indices = list(range(self.n))
        indices += indices[: self.total_size - len(indices)]
        return iter(indices[self.shard_id : self.total_size : self.num_shards])

    def __len__(self):
        return self.num_samples

    @property
    def num_real(self) -> int:
        """This shard's indices that are not padding repeats (those come last)."""
        return len(range(self.shard_id, self.n, self.num_shards))


class WeightedRandomSubsetSampler:
    """Sample num_samples indices with given per-index weights
    (weighted_random_sampler.py:6-36)."""

    def __init__(self, weights: Sequence[float], num_samples: int, replacement: bool = True, seed: int = 0):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = self.rng.choice(len(p), size=self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples
