"""Device-side input preprocessing.

Counterpart of ``distributeddataparallel_tpu/ops/preprocess.py``: image
datasets that ship raw uint8 batches to the device (``ShardedImageDataset(
device_normalize=True)``) are normalized inside the train step, so the host
copies a quarter of the bytes and does no float conversion.
"""

from __future__ import annotations

import torch


def normalize_u8_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 in [-1, 1]: ToTensor + Normalize((0.5,), (0.5,)),
    the same arithmetic as the host-side ``data.datasets.normalize_images``."""
    return (x.to(torch.float32) / 255.0 - 0.5) / 0.5
