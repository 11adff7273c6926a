"""Losses/metrics: mean softmax cross entropy over integer labels.

Counterpart of ``distributeddataparallel_tpu/ops/losses.py``.  Everything is
computed in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 1 else x.mean(dim=tuple(range(1, x.dim())))


def _token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE with labels' shape: logits (..., C), labels (...)."""
    ce = F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]),
        labels.reshape(-1).long(),
        reduction="none",
    )
    return ce.view(labels.shape)


def per_example_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row CE: (B, C)/(B,) -> (B,); LM (B, S, V)/(B, S) -> (B,) mean
    over positions (so evaluation can mask sampler-padded rows)."""
    return _row_mean(_token_ce(logits, labels))


def per_example_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row accuracy; trailing (sequence) axes are averaged per row."""
    return _row_mean((logits.argmax(dim=-1) == labels).float())


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE with integer labels; logits (B, C), labels (B,)."""
    return per_example_cross_entropy(logits, labels).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return per_example_accuracy(logits, labels).mean()


def lm_cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Next-token CE for LMs: logits (B, S, V), targets (B, S) int.

    ``mask`` (B, S) in {0,1} excludes padding positions; the mean is over
    unmasked tokens."""
    ce = _token_ce(logits, targets)
    if mask is None:
        return ce.mean()
    mask = mask.float()
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)
