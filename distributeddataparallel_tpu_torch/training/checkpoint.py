"""Epoch checkpoints of the replicated data-parallel train state.

Counterpart of the reference's ``Checkpointer``
(``distributeddataparallel_tpu/training/checkpoint.py``) for plain DP, where
every rank holds the same state: rank 0 writes the model (parameters and
buffers), the optimizer, the LR schedule, the step and the epoch to a
temporary file and renames it into place, so a partial file is never
visible under a checkpoint's name; a barrier follows.  Every rank restores
from the same file, mapped onto its own device, so a resume may use another
number of processes.  The directory must be one filesystem that every rank
sees.
"""

from __future__ import annotations

import os
import re

import torch

from distributeddataparallel_tpu_torch.runtime.distributed import barrier, get_rank
from distributeddataparallel_tpu_torch.training.state import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


class Checkpointer:
    """Keeps the ``max_to_keep`` newest epoch checkpoints in ``directory``."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if get_rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        barrier()

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def all_steps(self) -> list[int]:
        """Saved epochs, oldest first."""
        return sorted(int(m.group(1)) for f in os.listdir(self.directory) if (m := _NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, epoch: int) -> None:
        """Write ``state`` as the checkpoint of ``epoch`` (rank 0), prune to
        ``max_to_keep``, then wait for every rank."""
        if get_rank() == 0:
            payload = {
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
                "step": state.step,
                "epoch": epoch,
            }
            tmp = os.path.join(self.directory, f".epoch_{epoch}.pt.tmp")
            try:
                torch.save(payload, tmp)
                os.replace(tmp, self._path(epoch))
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            for old in self.all_steps()[: -self.max_to_keep]:
                os.remove(self._path(old))
        barrier()

    def restore_latest(self, state: TrainState) -> tuple[TrainState, int]:
        """Load the newest checkpoint into ``state`` in place; returns
        ``(state, next_epoch)``, or ``(state, 0)`` when there is none."""
        epoch = self.latest_step()
        if epoch is None:
            return state, 0
        device = next(state.model.parameters()).device
        ckpt = torch.load(self._path(epoch), map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        if state.scheduler is not None:
            state.scheduler.load_state_dict(ckpt["scheduler"])
        state.step = ckpt["step"]
        return state, ckpt["epoch"] + 1
