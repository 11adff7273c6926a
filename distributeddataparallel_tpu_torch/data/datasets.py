"""Datasets: numpy copies of the reference's (``distributeddataparallel_tpu/
data/datasets.py``), so both packages train on identical rows from the same
seed.

- ``ArrayDataset``: in-memory (images, labels); ``normalize_u8`` marks uint8
  images that the loader normalizes per batch.
- ``normalize_images``: ToTensor + Normalize((0.5,), (0.5,)) on the host.
- ``SyntheticClassification``: class-conditional images, f32 or u8.
- ``load_cifar10``: the python-pickle CIFAR-10 batches from a local
  directory or the tar.gz (no download), with a loudly logged synthetic
  stand-in when the payload is missing.
- ``SyntheticLM``: Markov-chain token sequences.
"""

from __future__ import annotations

import logging
import os
import pickle
import shutil
import tarfile
import tempfile

import numpy as np

log = logging.getLogger(__name__)


class ArrayDataset:
    """In-memory dataset of (images, labels) numpy arrays.

    With ``normalize_u8`` the images are stored uint8 and both access paths
    normalize them: ``__getitem__`` inline, and the loader per batch
    (``data.loader``), so consumers never see raw uint8 values."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, *, normalize_u8: bool = False):
        if len(images) != len(labels):
            raise ValueError("images/labels length mismatch")
        self.images = images
        self.labels = labels
        self.normalize_u8 = normalize_u8

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.normalize_u8:
            img = normalize_images(img)
        return img, self.labels[idx]

    def arrays(self) -> dict:
        """Columnar view for batched fancy indexing (``data.loader``)."""
        return {"image": self.images, "label": self.labels}


def normalize_images(images_u8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 in [-1, 1]: ToTensor + Normalize((0.5,), (0.5,))."""
    return (images_u8.astype(np.float32) / 255.0 - 0.5) / 0.5


class SyntheticClassification(ArrayDataset):
    """Deterministic class-conditional images, so loss can decrease.

    Class prototypes come from ``proto_seed`` and the examples from
    ``seed``, so train and eval splits with different seeds share one task.
    ``keep_u8`` stores the images as uint8 (``(x / 8 + 0.5) * 255``
    clipped), which the normalize maps back to ``x / 4``: a different but
    self-consistent dataset with the same labels."""

    def __init__(
        self,
        num_examples: int = 2048,
        shape: tuple[int, ...] = (32, 32, 3),
        num_classes: int = 10,
        seed: int = 0,
        proto_seed: int = 0,
        keep_u8: bool = False,
    ):
        rng = np.random.default_rng(seed)
        labels = rng.integers(0, num_classes, size=(num_examples,), dtype=np.int32)
        protos = np.random.default_rng(proto_seed).normal(size=(num_classes,) + shape).astype(np.float32)
        images = protos[labels] + 0.5 * rng.normal(size=(num_examples,) + shape).astype(np.float32)
        if keep_u8:
            u8 = np.clip((images * 0.125 + 0.5) * 255.0, 0.0, 255.0)
            super().__init__(np.ascontiguousarray(u8.astype(np.uint8)), labels, normalize_u8=True)
        else:
            super().__init__(images.astype(np.float32), labels)
        self.num_classes = num_classes


class SyntheticLM:
    """Deterministic synthetic token sequences with learnable structure.

    Each sequence follows a fixed random Markov chain over the vocab (one
    transition table per ``proto_seed``), with ``noise`` probability of a
    uniform-random token — so an LM can drive loss toward the chain's
    entropy, and train/eval splits built with different ``seed``s share the
    same underlying process.
    """

    def __init__(
        self,
        num_examples: int = 2048,
        seq_len: int = 128,
        vocab_size: int = 256,
        seed: int = 0,
        proto_seed: int = 0,
        noise: float = 0.1,
        branching: int = 4,
    ):
        proto_rng = np.random.default_rng(proto_seed)
        # Sparse transition table: each token can be followed by `branching`
        # successors, uniformly.
        nxt = proto_rng.integers(
            0, vocab_size, size=(vocab_size, branching), dtype=np.int32
        )
        rng = np.random.default_rng(seed)
        # +1 token so loaders can split into (inputs, targets) shifted pairs.
        toks = np.empty((num_examples, seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, vocab_size, size=num_examples)
        for t in range(1, seq_len + 1):
            choice = rng.integers(0, branching, size=num_examples)
            step = nxt[toks[:, t - 1], choice]
            noisy = rng.random(num_examples) < noise
            rand = rng.integers(0, vocab_size, size=num_examples)
            toks[:, t] = np.where(noisy, rand, step)
        self.tokens = toks
        self.vocab_size = vocab_size
        self.seq_len = seq_len

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx):
        return {"tokens": self.tokens[idx]}

    def arrays(self) -> dict:
        return {"tokens": self.tokens}


_CIFAR_BATCHES = [f"data_batch_{i}" for i in range(1, 6)]


def _complete(d: str) -> bool:
    return all(os.path.exists(os.path.join(d, n)) for n in _CIFAR_BATCHES)


def _cifar_batch_files(root: str) -> list[str] | None:
    """The cifar-10-batches-py payload under ``root``, directly or from the
    usual tar.gz.  Each process extracts into its own temporary directory
    and renames the payload into place, so a partial extraction is never
    visible under the final name; a stale partial directory is moved aside
    and replaced."""
    d = os.path.join(root, "cifar-10-batches-py")
    if not _complete(d):
        tgz = os.path.join(root, "cifar-10-python.tar.gz")
        if not os.path.exists(tgz):
            return None
        tmp = tempfile.mkdtemp(dir=root, prefix=".cifar-extract-")
        try:
            with tarfile.open(tgz) as tf:
                tf.extractall(tmp, filter="data")
            src = os.path.join(tmp, "cifar-10-batches-py")
            try:
                os.rename(src, d)
            except OSError:
                # d exists: a concurrent process's complete copy, or a
                # stale partial one to replace.
                if not _complete(d):
                    broken = tempfile.mkdtemp(dir=root, prefix=".cifar-broken-")
                    try:
                        os.rename(d, os.path.join(broken, "partial"))
                        os.rename(src, d)
                    except OSError:
                        pass  # lost a repair race; checked below
                    finally:
                        shutil.rmtree(broken, ignore_errors=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if not _complete(d):
            return None
    return [os.path.join(d, n) for n in _CIFAR_BATCHES]


def load_cifar10(
    root: str = "data",
    train: bool = True,
    *,
    normalize: bool = True,
    synthetic_fallback: bool = True,
    keep_u8: bool = False,
) -> ArrayDataset:
    """CIFAR-10 as NHWC from the local python-pickle batches (no network).

    A missing payload raises, or with ``synthetic_fallback`` (the default)
    yields a logged synthetic 32x32x3 / 10-class stand-in of the split's
    size.  ``keep_u8`` stores uint8 images that the loader normalizes per
    batch (a quarter of the host memory, the same values)."""
    files = _cifar_batch_files(root)
    if files is None:
        if not synthetic_fallback:
            raise FileNotFoundError(
                f"CIFAR-10 not found under {root!r}; pre-stage "
                "cifar-10-batches-py or cifar-10-python.tar.gz"
            )
        n = 50000 if train else 10000
        log.warning(
            "CIFAR-10 payload not found under %r: using a synthetic stand-in "
            "(%d fake 32x32x3 examples). Pre-stage the real batches for "
            "meaningful accuracy.", root, n,
        )
        return SyntheticClassification(n, (32, 32, 3), 10, seed=0 if train else 1)
    if not train:
        files = [os.path.join(os.path.dirname(files[0]), "test_batch")]
    imgs, labels = [], []
    for f in files:
        with open(f, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        # (N, 3072) uint8 in CHW planes -> NHWC
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.append(np.asarray(d[b"labels"], dtype=np.int32))
    images, labels = np.concatenate(imgs), np.concatenate(labels)
    if keep_u8:
        return ArrayDataset(np.ascontiguousarray(images), labels, normalize_u8=normalize)
    return ArrayDataset(normalize_images(images) if normalize else images, labels)
