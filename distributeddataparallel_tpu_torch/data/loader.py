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
``workers=True`` moves the gather (and augmentation) to a background thread;
``prefetch_depth`` is then the number of batches its queue holds ahead of
the train loop (the ``loader_prefetch_depth`` gauge), and when the loop finds
that queue empty ``starvation_window`` times in a row the loader warns once
and emits one ``loader_starved`` event (``window``, ``epoch``) into
``events``, as the reference's loader does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from distributeddataparallel_tpu_torch import native
from distributeddataparallel_tpu_torch.utils.logging import warn_all
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

    ``index_shards`` (every replica's row indices, ``(num_replicas, n)``:
    ``data.sharded.resize_index_plan``) replaces the sampler with row
    ``rank`` of it: the rest of an epoch after an elastic resize.
    ``set_epoch`` then changes nothing (the rows are one epoch's tail), and
    the augment draws are keyed on epoch 0, as the reference's tail loader
    draws them.

    Over a mesh, ``rank`` and ``num_replicas`` are the ``data`` axis's index
    and size: ranks that share a data index (the ``seq`` and ``model`` ranks
    of one replica) get the same rows.  ``seq_shard=(index, n)`` (context
    parallelism, the reference's ``shard_lm_batch``) splits each LM batch's
    ``(B, S + 1)`` tokens into ``inputs`` and ``targets`` on the host, where
    the next-token shift may cross a chunk's end, and keeps this rank's
    contiguous ``S / n`` chunk of each.
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
        seq_shard: tuple[int, int] | None = None,
        starvation_window: int = 50,
        index_shards=None,
    ):
        self.dataset = dataset
        self.starvation_window = starvation_window
        self.events = None  # an EventLog for ``loader_starved`` (the trainer binds it)
        self._starved_warned = False
        self._depth_fn = None
        self.seq_shard = seq_shard
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
        self._index_shards = None
        if index_shards is not None:
            if with_mask:
                raise ValueError("index_shards + with_mask is unsupported (pad-slot masks are a function of "
                                 "sampler geometry)")
            rows = np.asarray(index_shards, np.int64)
            if rows.ndim != 2 or len(rows) != num_replicas:
                raise ValueError(f"index_shards has {len(rows)} rows for {num_replicas} replicas")
            self._index_shards, n = rows[rank], rows.shape[1]
        arrays = getattr(dataset, "arrays", None)
        self._fused_augment = bool(
            augment is not None and hasattr(augment, "gather_u8")
            and getattr(dataset, "normalize_u8", False) and callable(arrays)
            and getattr(arrays().get("image"), "dtype", None) == np.uint8
        )
        self.steps_per_epoch = n // per_replica_batch if drop_last else -(-n // per_replica_batch)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch."""
        if self._index_shards is None:
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return self.steps_per_epoch

    @property
    def prefetch_depth(self) -> int:
        """Batches the background worker holds ahead of the consumer; 0
        without a worker or between iterations."""
        fn = self._depth_fn
        return int(fn()) if fn is not None else 0

    def _starving(self, streak: int) -> None:
        """The consumer found the queue empty ``streak`` times in a row:
        the input pipeline is starving the train loop.  Once a loader."""
        if streak < self.starvation_window or self._starved_warned:
            return
        self._starved_warned = True
        warn_all("loader prefetch queue empty for %d consecutive steps — input pipeline is starving "
                 "the train loop (consider more workers or faster storage)", streak)
        if self.events is not None:
            self.events.emit("loader_starved", window=streak, epoch=self.sampler.epoch)

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
            host = _background(host, self)
        for batch in host:
            yield {k: self._to_device(v) for k, v in batch.items()}

    def _host_batches(self) -> Iterator[dict]:
        smp, B = self.sampler, self.per_replica_batch
        own = smp.local_indices() if self._index_shards is None else self._index_shards
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
            if self.seq_shard is not None:
                host = _seq_chunk(host, *self.seq_shard)
            yield host


def _seq_chunk(host: dict, index: int, n: int) -> dict:
    """An LM host batch's next-token pairs, chunk ``index`` of ``n`` along
    the sequence."""
    tokens = host.pop("tokens")
    S = tokens.shape[1] - 1
    if S % n:
        raise ValueError(f"sequence length {S} is not divisible by the {n} sequence shards")
    lo, hi = index * (S // n), (index + 1) * (S // n)
    host["inputs"], host["targets"] = tokens[:, :-1][:, lo:hi], tokens[:, 1:][:, lo:hi]
    return host


def _background(items: Iterator, loader: DataLoader | None = None) -> Iterator:
    """``items`` produced on a daemon thread, one ahead.  An exception in
    the producer is raised at the consumer; a consumer that stops early
    stops the producer.  ``loader`` reads the queue's depth while it runs
    and hears of every consecutive empty arrival (``DataLoader._starving``)."""
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
        # ddplint: allow[broad-except] — the producer thread hands any failure to the consumer, which raises it
        except Exception as e:  # raised again by the consumer
            end = e
        finally:
            put(end)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    if loader is not None:
        loader._depth_fn = q.qsize
    streak = 0
    try:
        while True:
            if loader is not None:
                # One empty arrival is normal pipelining; a window of them
                # in a row is an input-bound loop.
                streak = streak + 1 if q.empty() else 0
                if streak:
                    loader._starving(streak)
            if (item := q.get()) is done:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        if loader is not None:
            loader._depth_fn = None
        stop.set()
        thread.join(timeout=10.0)
