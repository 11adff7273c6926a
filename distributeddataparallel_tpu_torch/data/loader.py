"""Per-rank batches from the sampler: the batching subset of the reference's
``data/loader.py`` for one process per device.

Each rank iterates its own ``DistributedSampler`` shard, ``per_replica_batch``
rows per step, gathered from the dataset's columns and moved to ``device``.
Rank r therefore receives exactly the rows the reference's replica r does.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from distributeddataparallel_tpu_torch.parallel.sampler import DistributedSampler


class DataLoader:
    """Iterates dict batches (``{"tokens": int64 (B, S+1)}``) for one rank.

    ``drop_last`` (default, training) keeps every step the same shape;
    ``drop_last=False`` covers the tail with a shorter final batch.

    ``with_mask=True`` adds ``"valid"``: a (rows,) float32 mask that is 0 on
    sampler-padded duplicate rows.  Local position p of replica r maps to
    global padded position ``r + p * num_replicas``; slots at or past the
    dataset length are padding.  Evaluation uses it to average over unique
    samples only (``make_eval_step``).
    """

    def __init__(
        self,
        dataset,
        *,
        per_replica_batch: int,
        rank: int = 0,
        num_replicas: int = 1,
        device: torch.device | str = "cpu",
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        with_mask: bool = False,
    ):
        self.dataset = dataset
        self.per_replica_batch = per_replica_batch
        self.device = torch.device(device)
        self.with_mask = with_mask
        self.sampler = DistributedSampler(
            len(dataset), num_replicas=num_replicas, rank=rank,
            shuffle=shuffle, seed=seed, drop_last=False,
        )
        n = self.sampler.num_samples
        self.steps_per_epoch = n // per_replica_batch if drop_last else -(-n // per_replica_batch)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch."""
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype in (torch.int32, torch.int16, torch.uint8):
            t = t.long()  # embedding/label index dtype
        return t.to(self.device, non_blocking=True)

    def __iter__(self) -> Iterator[dict]:
        smp, B = self.sampler, self.per_replica_batch
        shard = smp.local_indices()
        columns = self.dataset.arrays()
        for step in range(self.steps_per_epoch):
            idx = shard[step * B : (step + 1) * B]
            batch = {k: self._to_device(v[idx]) for k, v in columns.items()}
            if self.with_mask:
                p = np.arange(step * B, step * B + len(idx))
                valid = (smp.rank + p * smp.num_replicas < smp.dataset_len).astype(np.float32)
                batch["valid"] = self._to_device(valid)
            yield batch
