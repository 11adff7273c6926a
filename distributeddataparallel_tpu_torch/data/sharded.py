"""File-sharded streaming image dataset: the ImageNet-shape input path.

Counterpart of the reference's ``distributeddataparallel_tpu/data/sharded.py``,
with the same on-disk format, so each package reads the other's directories:
``shard_NNNNN_images.npy`` (uint8, N x H x W x C) and
``shard_NNNNN_labels.npy`` (int32) pairs with an ``index.json`` manifest
(``num_examples``, ``shape``, ``shard_counts``, ``num_classes``).

Image shards are memory-mapped: a batch reads only its rows, and the corpus
is never held in host memory.  The writers generate shard by shard, so their
peak memory is one shard.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np

from distributeddataparallel_tpu_torch.data.datasets import normalize_images

_MANIFEST = "index.json"


def write_image_shards(root: str, images: np.ndarray, labels: np.ndarray, *,
                       shard_rows: int = 1024, num_classes: int | None = None) -> str:
    """Write an in-memory (images, labels) pair as a shard directory."""
    if len(images) != len(labels):
        raise ValueError("images/labels length mismatch")
    if images.dtype != np.uint8:
        raise ValueError(f"shards store uint8 images (got {images.dtype}); quantize first")
    if num_classes is None and len(labels):
        # Consumers size the classifier head from the manifest.
        num_classes = int(np.max(labels)) + 1
    return _write_shards(root, len(images), images.shape[1:],
                         lambda lo, hi: (images[lo:hi], labels[lo:hi]),
                         shard_rows=shard_rows, num_classes=num_classes)


def write_synthetic_image_shards(
    root: str,
    num_examples: int,
    shape: tuple[int, ...] = (224, 224, 3),
    num_classes: int = 1000,
    *,
    shard_rows: int = 1024,
    seed: int = 0,
    proto_seed: int = 0,
) -> str:
    """Synthetic class-conditional shards: a per-class colour (from
    ``proto_seed``) plus uniform pixel noise in [-40, 40], generated shard by
    shard."""
    colors = np.random.default_rng(proto_seed).integers(32, 224, size=(num_classes, shape[-1]),
                                                        dtype=np.int16)
    rng = np.random.default_rng(seed)

    def gen(lo, hi):
        n = hi - lo
        labels = rng.integers(0, num_classes, size=(n,), dtype=np.int32)
        noise = rng.integers(-40, 41, size=(n,) + shape, dtype=np.int16)
        base = colors[labels].reshape((n,) + (1,) * (len(shape) - 1) + (shape[-1],))
        return np.clip(base + noise, 0, 255).astype(np.uint8), labels

    return _write_shards(root, num_examples, shape, gen, shard_rows=shard_rows,
                         num_classes=num_classes)


def _write_shards(root: str, num_examples: int, shape: tuple[int, ...], gen: Callable, *,
                  shard_rows: int, num_classes: int | None) -> str:
    os.makedirs(root, exist_ok=True)
    counts = []
    for s, lo in enumerate(range(0, num_examples, shard_rows)):
        hi = min(lo + shard_rows, num_examples)
        imgs, labels = gen(lo, hi)
        np.save(os.path.join(root, f"shard_{s:05d}_images.npy"), np.ascontiguousarray(imgs))
        np.save(os.path.join(root, f"shard_{s:05d}_labels.npy"),
                np.ascontiguousarray(labels.astype(np.int32)))
        counts.append(hi - lo)
    manifest = {"num_examples": num_examples, "shape": list(shape),
                "shard_counts": counts, "num_classes": num_classes}
    with open(os.path.join(root, _MANIFEST), "w") as fh:
        json.dump(manifest, fh)
    return root


class ShardedImageDataset:
    """Streaming (memory-mapped) image classification dataset.

    ``gather(idx)`` gives a batch of global rows in the order asked for;
    labels (4 bytes a row) are loaded at construction, image pages are read
    per gather.  Images come out normalized float32, or with
    ``device_normalize`` as raw uint8 for the train step to normalize on
    the device (``ops.preprocess.normalize_u8_images``)."""

    def __init__(self, root: str, *, device_normalize: bool = False):
        mpath = os.path.join(root, _MANIFEST)
        if not os.path.exists(mpath):
            raise FileNotFoundError(
                f"no shard manifest at {mpath}; build one with "
                "write_image_shards / write_synthetic_image_shards"
            )
        with open(mpath) as fh:
            m = json.load(fh)
        self.root = root
        self.image_shape = tuple(m["shape"])
        self.num_classes = m.get("num_classes")
        counts = np.asarray(m["shard_counts"], dtype=np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        self._n = int(m["num_examples"])
        if self._offsets[-1] != self._n:
            raise ValueError(
                f"manifest inconsistent: shard counts sum {self._offsets[-1]} "
                f"!= num_examples {self._n}"
            )
        self.device_normalize = device_normalize
        self._mmaps: dict[int, np.ndarray] = {}
        self.labels = np.concatenate([
            np.load(os.path.join(root, f"shard_{s:05d}_labels.npy")) for s in range(len(counts))
        ]) if len(counts) else np.zeros((0,), np.int32)

    def _shard(self, s: int) -> np.ndarray:
        if s not in self._mmaps:
            self._mmaps[s] = np.load(os.path.join(self.root, f"shard_{s:05d}_images.npy"),
                                     mmap_mode="r")
        return self._mmaps[s]

    def __len__(self) -> int:
        return self._n

    def gather(self, idx) -> dict:
        """Rows ``idx`` (global indices) as {"image", "label"}; only
        batch-sized buffers are allocated."""
        idx = np.asarray(idx, dtype=np.int64)
        # global index -> (shard, row in shard) under the manifest's offsets
        shard_ids = np.searchsorted(self._offsets, idx, side="right") - 1
        local = idx - self._offsets[shard_ids]
        out = np.empty((len(idx),) + self.image_shape,
                       np.uint8 if self.device_normalize else np.float32)
        for s in np.unique(shard_ids):
            sel = shard_ids == s
            rows = self._shard(int(s))[local[sel]]
            out[sel] = rows if self.device_normalize else normalize_images(rows)
        return {"image": out, "label": self.labels[idx]}

    def __getitem__(self, idx):
        b = self.gather(np.asarray([idx]))
        return b["image"][0], b["label"][0]
