"""Deterministic per-replica index sharding: a copy of the reference's
``DistributedSampler`` (``distributeddataparallel_tpu/parallel/sampler.py``).

It shuffles with numpy ``default_rng(seed + epoch).permutation`` — not
``torch.randperm`` — so both packages give every rank the same rows:

1. Optionally shuffle ``range(N)`` with a generator seeded ``seed + epoch``.
2. If not ``drop_last``: pad by repeating indices until
   ``total_size = ceil(N / num_replicas) * num_replicas``; if ``drop_last``:
   truncate to the floor multiple.
3. Each replica takes the strided slice ``indices[rank::num_replicas]``.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np


class DistributedSampler:
    """Epoch-seeded, padded, strided index shard for one replica.

    ``dataset`` may be anything with ``__len__``, or an int length."""

    def __init__(
        self,
        dataset,
        num_replicas: int,
        rank: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
    ):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} not in [0, {num_replicas})")
        self.dataset_len = dataset if isinstance(dataset, int) else len(dataset)
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if self.drop_last and self.dataset_len % num_replicas != 0:
            self.num_samples = self.dataset_len // num_replicas
        else:
            self.num_samples = math.ceil(self.dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle for a new epoch."""
        self.epoch = epoch

    def _global_indices(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        if self.drop_last:
            indices = indices[: self.total_size]
        else:
            pad = self.total_size - len(indices)
            if pad > 0:
                # Repeat from the head, wrapping if the dataset is smaller
                # than one full round — same rule torch uses.
                reps = math.ceil(pad / len(indices))
                indices = np.concatenate([indices, np.tile(indices, reps)[:pad]])
        return indices

    def local_indices(self) -> np.ndarray:
        """This replica's indices for the current epoch (rank::num_replicas)."""
        return self._global_indices()[self.rank :: self.num_replicas]

    def __iter__(self) -> Iterator[int]:
        return iter(self.local_indices().tolist())

    def __len__(self) -> int:
        return self.num_samples
