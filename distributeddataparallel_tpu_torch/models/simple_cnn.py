"""The toy image models: ``TinyMLP`` and ``SimpleCNN``, counterparts of
``distributeddataparallel_tpu/models/simple_cnn.py``.

Both take NHWC float32 batches, as the reference's do.  ``TinyMLP``
flattens the NHWC rows as they are, so its first weight is the reference's
``Dense_0`` kernel transposed; ``SimpleCNN`` permutes once to NCHW in
``channels_last`` memory.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributeddataparallel_tpu_torch.models.layers import Conv2dSame, init_image_model, nhwc_to_nchw


class TinyMLP(nn.Module):
    """Dense + ReLU per ``features`` entry on flattened inputs, then the
    f32 head."""

    def __init__(self, image_shape=(32, 32, 3), features=(128, 128), num_classes: int = 10, *,
                 device=None, generator=None):
        super().__init__()
        widths = [math.prod(image_shape), *features]
        self.hidden = nn.ModuleList(nn.Linear(a, b, device=device) for a, b in zip(widths, widths[1:]))
        self.fc = nn.Linear(widths[-1], num_classes, device=device)
        init_image_model(self, generator)

    def forward(self, x):
        x = x.to(torch.float32).reshape(x.shape[0], -1)
        for layer in self.hidden:
            x = F.relu(layer(x))
        return self.fc(x)


class SimpleCNN(nn.Module):
    """Per ``widths`` entry: 3x3 SAME conv (with bias), ReLU, 2x2/2 max pool
    (VALID); then the global mean over H and W and the f32 head."""

    def __init__(self, num_classes: int = 10, widths=(32, 64), in_channels: int = 3, *,
                 device=None, generator=None):
        super().__init__()
        chans = [in_channels, *widths]
        self.convs = nn.ModuleList(Conv2dSame(a, b, 3, bias=True, device=device)
                                   for a, b in zip(chans, chans[1:]))
        self.fc = nn.Linear(chans[-1], num_classes, device=device)
        init_image_model(self, generator)

    def forward(self, x):
        x = nhwc_to_nchw(x)
        for conv in self.convs:
            x = F.max_pool2d(F.relu(conv(x)), 2, 2)
        return self.fc(x.mean(dim=(2, 3)))
