"""ResNet family: counterpart of ``distributeddataparallel_tpu/models/resnet.py``,
written by hand (there is no torchvision here).

- ``BasicBlock`` (ResNet-18/34) and ``BottleneckBlock`` (ResNet-50/101, v1.5:
  the stride on the 3x3); the last BatchNorm of each block starts at scale 0.
- Stems: ``"imagenet"`` = 7x7/2 conv, BN, ReLU, 3x3/2 max pool;
  ``"cifar"`` = 3x3/1 conv, BN, ReLU.
- Convolutions pad as XLA's SAME does (``layers.Conv2dSame``), BatchNorm
  follows flax (``layers.BatchNorm``), kernels start from flax's
  ``lecun_normal`` (``layers.lecun_normal_``).
- Inputs are NHWC batches, permuted once to NCHW in ``channels_last``
  memory; the pool is a global mean over H and W before the f32 head.

Submodules carry torchvision's ``state_dict`` names (``conv1``, ``bn1``,
``layerS.j.convC`` / ``bnC``, ``downsample.{0,1}``, ``fc``), which
``models.io`` maps to the reference's flax names.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch.nn.functional as F
from torch import nn

from distributeddataparallel_tpu_torch.models.layers import (
    BatchNorm,
    Conv2dSame,
    init_image_model,
    max_pool_same,
    nhwc_to_nchw,
)


class BasicBlock(nn.Module):
    """Two 3x3 convs."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm, device=None):
        super().__init__()
        self.conv1 = Conv2dSame(cin, filters, 3, stride, device=device)
        self.bn1 = norm(filters)
        self.conv2 = Conv2dSame(filters, filters, 3, device=device)
        self.bn2 = norm(filters, zero_scale=True)
        self.downsample = _projection(cin, filters, stride, norm, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 with 4x expansion."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm, device=None):
        super().__init__()
        self.conv1 = Conv2dSame(cin, filters, 1, device=device)
        self.bn1 = norm(filters)
        self.conv2 = Conv2dSame(filters, filters, 3, stride, device=device)
        self.bn2 = norm(filters)
        self.conv3 = Conv2dSame(filters, filters * 4, 1, device=device)
        self.bn3 = norm(filters * 4, zero_scale=True)
        self.downsample = _projection(cin, filters * 4, stride, norm, device)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


def _projection(cin: int, cout: int, stride: int, norm, device):
    """The 1x1 projection shortcut where the block changes the shape, as
    the reference adds one (``residual.shape != y.shape``)."""
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(Conv2dSame(cin, cout, 1, stride, device=device), norm(cout))


class ResNet(nn.Module):
    """NHWC images (B, H, W, C) -> f32 logits (B, num_classes)."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls,
        num_classes: int = 1000,
        num_filters: int = 64,
        stem: str = "imagenet",
        bn_momentum: float = 0.9,
        bn_epsilon: float = 1e-5,
        in_channels: int = 3,
        *,
        device=None,
        generator=None,
    ):
        super().__init__()
        if stem not in ("imagenet", "cifar"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stage_sizes, self.block_cls, self.stem = tuple(stage_sizes), block_cls, stem
        norm = partial(BatchNorm, momentum=bn_momentum, eps=bn_epsilon, device=device)
        self.conv1 = Conv2dSame(in_channels, num_filters, 7 if stem == "imagenet" else 3,
                                2 if stem == "imagenet" else 1, device=device)
        self.bn1 = norm(num_filters)
        cin = num_filters
        for i, n in enumerate(stage_sizes):
            blocks = []
            for j in range(n):
                filters = num_filters * 2**i
                blocks.append(block_cls(cin, filters, 2 if i > 0 and j == 0 else 1, norm, device))
                cin = filters * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(cin, num_classes, device=device)
        init_image_model(self, generator)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(nhwc_to_nchw(x))))
        if self.stem == "imagenet":
            x = max_pool_same(x, 3, 2)
        for i in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3), block_cls=BottleneckBlock)
