"""Train state: what one replica carries from step to step.

Counterpart of ``distributeddataparallel_tpu/training/state.py``.  The
reference threads an immutable pytree through a compiled step; here the
model and optimizer own their tensors and update them in place, and the
state object groups them with the LR scheduler and the step count.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer step on the synced ``.grad`` buffers, then the
        schedule advances (optax's count convention: step k uses the
        schedule's value at k)."""
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
