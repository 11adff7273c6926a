"""Train state: what one replica carries from step to step.

Counterpart of ``distributeddataparallel_tpu/training/state.py``.  The
reference threads an immutable pytree through a compiled step; here the
model and optimizer own their tensors and update them in place, and the
state object groups them with the LR scheduler and the step count.

Under ZeRO (``parallel.zero.zero_state``) ``zero`` holds the flat layout and
the optimizer steps this rank's shard of it (``moments`` keeps its moments
low-bit between steps); under level 3 the model holds no parameters between
steps, and ``full_params()`` gathers them for a block (evaluation, saving).
``comm_state`` is PowerSGD's per-leaf hook state (``parallel.powersgd``).
Under FSDP (``parallel.fsdp.fsdp_state``) ``model`` is the ``FsdpLM`` over
this rank's shards and ``fsdp`` the same object: the optimizer steps the
shards, evaluation streams the per-layer gathers, and the whole model is
assembled only by ``parallel.fsdp.fsdp_gather_params``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0
    zero: Any = None        # parallel.zero.ZeroLayout
    moments: Any = None     # parallel.zero.LowBitMoments
    comm_state: Any = None  # parallel.powersgd state: a list over the reference's leaves
    fsdp: Any = None        # parallel.fsdp.FsdpLM

    def apply_gradients(self, ok: torch.Tensor | None = None) -> None:
        """One optimizer step on the synced ``.grad`` buffers, then the
        schedule advances (optax's count convention: step k uses the
        schedule's value at k).

        ``ok`` (the nonfinite guard's verdict: a 0-d f32 tensor, 1.0 to
        apply, 0.0 to skip) is decided on the device and never read here:
        the fused optimizer gets ``found_inf = 1 - ok`` and skips inside its
        kernel, ``LowBitMoments`` puts its moments back by a select, and the
        ``DeviceSchedule``'s count advances by ``ok``.  ``step`` advances
        either way, as the reference's skip advances it."""
        if ok is not None:
            self.optimizer.found_inf = (1.0 - ok).reshape(())
        try:
            if self.moments is not None:
                self.moments.step(ok)
            else:
                self.optimizer.step()
        finally:
            if ok is not None:
                del self.optimizer.found_inf
        if self.scheduler is not None:
            if ok is None:
                self.scheduler.step()
            else:
                self.scheduler.step(ok.to(torch.int64).reshape(()))
        self.step += 1

    def full_params(self):
        """The model's whole parameters for a block (a collective under
        ZeRO-3; nothing to do otherwise)."""
        return self.zero.full_params() if self.zero is not None else contextlib.nullcontext()

    def num_params(self) -> int:
        if self.fsdp is not None:
            return self.fsdp.meta.total
        if self.zero is not None:
            return sum(self.zero.sizes)
        return sum(p.numel() for p in self.model.parameters())
