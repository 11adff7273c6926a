"""Layers the image models share, with flax's semantics where PyTorch's
defaults differ.

- ``lecun_normal_``: flax's default kernel init, a truncated normal
  (within 2 std) scaled by fan-in, drawn from an explicit generator.
- ``Conv2dSame``: a convolution with XLA's ``SAME`` padding, which for a
  strided conv on an even input pads one pixel more after than before.
- ``BatchNorm``: flax's BatchNorm: biased batch variance both to normalize
  and in the running average, ``running = momentum * running + (1 -
  momentum) * batch``.

Activations are NCHW tensors in ``channels_last`` memory: the models take
the reference's NHWC batches and permute them once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# Standard deviation of a unit normal truncated to [-2, 2]; flax divides
# the target std by it so the truncated draw keeps the target variance.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int, generator=None) -> torch.Tensor:
    """In place: truncated normal with variance 1 / fan_in (flax
    ``lecun_normal``)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """XLA SAME padding of one spatial axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0):
    """``x`` padded for a SAME window, or ``(x, symmetric pad)`` when a
    symmetric pad the op can take itself suffices."""
    ph, pw = same_pads(x.shape[2], kernel, stride), same_pads(x.shape[3], kernel, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return x, (ph[0], pw[0])
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value), (0, 0)


class Conv2dSame(nn.Module):
    """k x k convolution with SAME padding; weight (out, in, k, k)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, *, bias: bool = False,
                 device=None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x, pad = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight, self.bias, self.stride, pad)


def max_pool_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Max pool with SAME padding (pad value -inf, as flax's)."""
    x, pad = _pad_same(x, kernel, stride, value=-math.inf)
    return F.max_pool2d(x, kernel, stride, pad)


class BatchNorm(nn.Module):
    """flax ``BatchNorm`` over the channels of an NCHW tensor.

    Training normalizes with the batch mean and biased variance and moves
    the buffers to ``momentum * running + (1 - momentum) * batch`` (torch's
    own BatchNorm puts the unbiased variance into ``running_var``); eval
    normalizes with the buffers."""

    def __init__(self, channels: int, *, momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False, device=None):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        self.register_buffer("running_mean", torch.zeros(channels, device=device))
        self.register_buffer("running_var", torch.ones(channels, device=device))

    def reset_parameters(self, generator=None) -> None:
        nn.init.constant_(self.weight, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        # The op behind F.batch_norm (cuDNN's kernels on the GPU), given no
        # running stats: it normalizes with the batch mean and biased
        # variance and returns the mean and 1 / sqrt(var + eps) it used, so
        # the buffers need no second pass over x.
        out, mean, invstd, _, _ = torch.ops.aten._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(invstd.pow(-2) - self.eps, alpha=1.0 - m)
        return out


def init_image_model(model: nn.Module, generator=None) -> nn.Module:
    """Initialize every layer in module order and move 4-D weights to
    ``channels_last``."""
    for m in model.modules():
        if isinstance(m, (Conv2dSame, BatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)
    return model.to(memory_format=torch.channels_last)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC batch -> float32 NCHW view in channels_last memory."""
    return x.to(torch.float32).permute(0, 3, 1, 2)
