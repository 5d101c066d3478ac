"""Iteration-budget samplers with resume (port of
`rnnpose_tpu/data/samplers.py`; numpy only).

* `GivenIterationSampler`: a fixed budget of `total_iter` batches, the
  seed-7 permutation repeated to cover it, each shard a contiguous slice;
  resume fast-forwards `(last_iter + 1) * batch_size` indices (the
  reference's `DistributedGivenIterationSampler`).
* `GivenIterationSamplerEpoch`: the same stream as (index, epoch seed).
* `SequentialShardSampler`: round-robin eval sharding, no shuffle.

A shard is (shard_id, num_shards): (0, 1) in one process.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

__all__ = ["GivenIterationSampler", "GivenIterationSamplerEpoch", "SequentialShardSampler"]


class GivenIterationSampler:
    def __init__(self, dataset_size: int, total_iter: int, batch_size: int, shard_id: int = 0,
                 num_shards: int = 1, last_iter: int = -1, seed: int = 7):
        self.dataset_size = dataset_size
        self.total_iter = total_iter
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.last_iter = last_iter
        self.seed = seed
        self.total_size = total_iter * batch_size
        self.indices = self._gen_indices()

    def _gen_indices(self) -> np.ndarray:
        rs = np.random.RandomState(self.seed)
        need = self.total_size * self.num_shards
        reps = int(np.ceil(need / self.dataset_size))
        idx = np.concatenate([rs.permutation(self.dataset_size) for _ in range(reps)])[:need]
        beg = self.total_size * self.shard_id
        return idx[beg:beg + self.total_size]

    def __iter__(self) -> Iterator[int]:
        start = (self.last_iter + 1) * self.batch_size
        return iter(self.indices[start:].tolist())

    def __len__(self) -> int:
        return self.total_size - (self.last_iter + 1) * self.batch_size


class GivenIterationSamplerEpoch(GivenIterationSampler):
    """Yields (index, seed + epoch) so that per-sample augmentation can be
    re-seeded per epoch."""

    def __iter__(self):
        start = (self.last_iter + 1) * self.batch_size
        for pos in range(start, self.total_size):
            epoch = (pos + self.total_size * self.shard_id) // max(self.dataset_size, 1)
            yield int(self.indices[pos]), self.seed + epoch


class SequentialShardSampler:
    """Round-robin eval sharding: shard k takes k, k + n, k + 2n, ..."""

    def __init__(self, dataset_size: int, shard_id: int = 0, num_shards: int = 1):
        self.dataset_size = dataset_size
        self.shard_id = shard_id
        self.num_shards = num_shards

    def __iter__(self) -> Iterator[int]:
        return iter(range(self.shard_id, self.dataset_size, self.num_shards))

    def __len__(self) -> int:
        n, k, w = self.dataset_size, self.shard_id, self.num_shards
        return (n - k + w - 1) // w
