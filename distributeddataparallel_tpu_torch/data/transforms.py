"""CIFAR training augmentation on host batches: a numpy copy of the
reference's ``distributeddataparallel_tpu/data/transforms.py``.

``RandomCrop(32, padding=4)`` + ``RandomHorizontalFlip`` as one vectorized
op over a (B, H, W, C) batch, driven by an explicit ``np.random.Generator``
that the loader derives from (seed, epoch, step): augmentation is a pure
function of those, across reruns and ``--resume``.  The generator is drawn
in the reference's order (crop ``oy``, then ``ox``, then the flips), so
both packages augment a batch identically.
"""

from __future__ import annotations

import numpy as np


def _flip(images: np.ndarray, flip: np.ndarray) -> np.ndarray:
    out = images.copy()
    out[flip] = out[flip, :, ::-1]
    return out


def random_horizontal_flip(images: np.ndarray, rng: np.random.Generator, p: float = 0.5) -> np.ndarray:
    """Flip each sample's width axis with probability ``p``; (B, H, W, C)."""
    return _flip(images, rng.random(images.shape[0]) < p)


def _crop_at(images: np.ndarray, oy: np.ndarray, ox: np.ndarray, padding: int, fill: float) -> np.ndarray:
    """Pad each side by ``padding`` with ``fill`` and crop back to the
    original size at per-sample offsets (oy, ox).

    ``fill`` is in normalized units: -1.0 is black after Normalize((0.5,),
    (0.5,)).  A uint8 batch (normalized later, on the device) gets the fill
    mapped back to u8 space, -1.0 -> 0, so both orders pad with black."""
    if images.dtype == np.uint8:
        fill = float(np.clip(round((fill * 0.5 + 0.5) * 255.0), 0, 255))
    B, H, W, _ = images.shape
    padded = np.pad(images, ((0, 0), (padding, padding), (padding, padding), (0, 0)),
                    constant_values=fill)
    rows = oy[:, None] + np.arange(H)
    cols = ox[:, None] + np.arange(W)
    return padded[np.arange(B)[:, None, None], rows[:, :, None], cols[:, None, :]]


def random_crop(images: np.ndarray, rng: np.random.Generator, padding: int = 4,
                fill: float = -1.0) -> np.ndarray:
    """Pad by ``padding`` with ``fill`` and crop at a random per-sample offset."""
    if padding == 0:
        return images
    B = images.shape[0]
    oy = rng.integers(0, 2 * padding + 1, B)
    ox = rng.integers(0, 2 * padding + 1, B)
    return _crop_at(images, oy, ox, padding, fill)


def cifar_augment(batch: dict, rng: np.random.Generator, rows: tuple[int, int] | None = None) -> dict:
    """Random crop (pad 4, black fill) + horizontal flip on the ``image``
    column.

    ``rows=(first, total)`` says that ``batch`` holds rows ``first ..`` of a
    host batch of ``total`` rows: the draws are made for all ``total`` rows,
    in the reference's order, and ``batch`` takes its slice of them.  So one
    rank augments only its own rows, and exactly as the whole batch would."""
    img = batch["image"]
    n = img.shape[0]
    first, total = rows if rows is not None else (0, n)
    own = slice(first, first + n)
    oy = rng.integers(0, 9, total)[own]
    ox = rng.integers(0, 9, total)[own]
    flip = (rng.random(total) < 0.5)[own]
    return {**batch, "image": _flip(_crop_at(img, oy, ox, 4, -1.0), flip)}


class CifarAugment:
    """The loader's ``augment(batch, rng, rows)`` hook for the CIFAR recipe."""

    def __call__(self, batch: dict, rng: np.random.Generator, rows: tuple[int, int] | None = None) -> dict:
        return cifar_augment(batch, rng, rows)
