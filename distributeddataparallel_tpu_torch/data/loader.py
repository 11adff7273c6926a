"""Per-rank batches from the sampler: the batching subset of the reference's
``data/loader.py`` for one process per device.

Each rank iterates its own ``DistributedSampler`` shard, ``per_replica_batch``
rows per step, gathered from the dataset and moved to ``device``.  Rank r
therefore receives exactly the rows the reference's replica r does.

Datasets give rows through ``gather(idx) -> dict`` (``data.sharded``,
``data.tokens``) or ``arrays() -> dict`` of columns (``data.datasets``); a
dataset marked ``normalize_u8`` has its uint8 image column normalized on the
host, by the native gather (``native.gather_normalize_u8``), as the
reference's loader does.  An augment hook with a ``gather_u8`` method
(``transforms.CifarAugment``) on such a dataset takes the fused path: one
native pass gathers, crops, flips and normalizes the uint8 rows.  uint8 columns that reach the device stay uint8 (the train step
normalizes them); smaller integer columns (token ids, labels) become int64.

Batches bound for a GPU are copied from pinned host memory without
blocking, so the host gathers the next batch while the device works (a
copy from pageable memory would first wait for the device to finish).
``workers=True`` moves the gather (and augmentation) to a background thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from distributeddataparallel_tpu_torch import native
from distributeddataparallel_tpu_torch.parallel.sampler import DistributedSampler


class DataLoader:
    """Iterates dict batches (``{"tokens"}`` or ``{"image", "label"}``) for
    one rank.

    ``drop_last`` (default, training) keeps every step the same shape;
    ``drop_last=False`` covers the tail with a shorter final batch.

    ``with_mask=True`` adds ``"valid"``: a (rows,) float32 mask that is 0 on
    sampler-padded duplicate rows.  Local position p of replica r maps to
    global padded position ``r + p * num_replicas``; slots at or past the
    dataset length are padding.  Evaluation uses it to average over unique
    samples only (``make_eval_step``).

    ``augment(batch, rng, rows) -> batch`` transforms each host batch
    (``data.transforms``).  As in the reference, one generator,
    ``default_rng((seed, 0xA06, epoch, step, 0))``, is drawn over the rows
    of all replicas concatenated replica by replica.  Rank r's rows are the
    r-th slice of that ``num_replicas x B`` batch, so the hook gets
    ``rows=(r * B, num_replicas * B)``: it draws for every row and applies
    the draws to this rank's rows only, which then equal the reference's
    replica r's.

    ``workers=True`` gathers host batches on a background thread, one batch
    ahead (one ordered producer, as in the reference).
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
        augment=None,
        workers: bool = False,
    ):
        self.dataset = dataset
        self.per_replica_batch = per_replica_batch
        self.device = torch.device(device)
        self.with_mask = with_mask
        self.augment = augment
        self.workers = workers
        self.seed = seed
        self.sampler = DistributedSampler(
            len(dataset), num_replicas=num_replicas, rank=rank,
            shuffle=shuffle, seed=seed, drop_last=False,
        )
        n = self.sampler.num_samples
        arrays = getattr(dataset, "arrays", None)
        self._fused_augment = bool(
            augment is not None and hasattr(augment, "gather_u8")
            and getattr(dataset, "normalize_u8", False) and callable(arrays)
            and getattr(arrays().get("image"), "dtype", None) == np.uint8
        )
        self.steps_per_epoch = n // per_replica_batch if drop_last else -(-n // per_replica_batch)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch."""
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return self.steps_per_epoch

    def _gather(self, idx: np.ndarray, image_gather=None) -> dict:
        """Rows ``idx`` as a dict of columns; ``image_gather(column, idx)``
        replaces the uint8 image column's gather (the fused augment)."""
        gather = getattr(self.dataset, "gather", None)
        if callable(gather):
            return gather(idx)
        norm = getattr(self.dataset, "normalize_u8", False)
        out = {}
        for k, v in self.dataset.arrays().items():
            if image_gather is not None and k == "image":
                out[k] = image_gather(v, idx)
            elif norm and v.dtype == np.uint8 and v.ndim >= 2:
                out[k] = native.gather_normalize_u8(v, idx)
            else:
                out[k] = v[idx]
        return out

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.dtype in (torch.int32, torch.int16):
            t = t.long()  # embedding/label index dtype
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def __iter__(self) -> Iterator[dict]:
        host = self._host_batches()
        if self.workers:
            host = _background(host)
        for batch in host:
            yield {k: self._to_device(v) for k, v in batch.items()}

    def _host_batches(self) -> Iterator[dict]:
        smp, B = self.sampler, self.per_replica_batch
        own = smp.local_indices()
        for step in range(self.steps_per_epoch):
            idx = own[step * B : (step + 1) * B]
            if self.augment is None:
                host = self._gather(idx)
            else:
                # Every replica's slice at this step has len(idx) rows.
                rng = np.random.default_rng((self.seed, 0xA06, smp.epoch, step, 0))
                rows = (smp.rank * len(idx), smp.num_replicas * len(idx))
                if self._fused_augment:
                    host = self._gather(idx, lambda v, i: self.augment.gather_u8(v, i, rng, rows))
                else:
                    host = self.augment(self._gather(idx), rng, rows)
            if self.with_mask:
                p = np.arange(step * B, step * B + len(idx))
                host["valid"] = (smp.rank + p * smp.num_replicas < smp.dataset_len).astype(np.float32)
            yield host


def _background(items: Iterator) -> Iterator:
    """``items`` produced on a daemon thread, one ahead.  An exception in
    the producer is raised at the consumer; a consumer that stops early
    stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=1)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        end = done
        try:
            for item in items:
                if not put(item):
                    return
        except Exception as e:  # raised again by the consumer
            end = e
        finally:
            put(end)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while (item := q.get()) is not done:
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=10.0)
