"""Epoch checkpoint files of the replicated data-parallel train state.

Counterpart of the file half of the reference's ``Checkpointer``
(``distributeddataparallel_tpu/training/checkpoint.py``) for plain DP, where
every rank holds the same state.  ``CheckpointFiles.write`` copies the model
(parameters and buffers), the optimizer, the LR schedule, the step and the
epoch to the host once, hashes that copy (``state_content_hash``) into the
sidecar ``hash_N.json``, then writes the copy to a temporary file and
renames it into place as ``epoch_N.pt``, so a partial file is never visible
under a checkpoint's name.  ``read`` verifies the content hash before the
state is trusted: a corrupted-but-readable checkpoint raises ``ValueError``
(a checkpoint without a sidecar, written before the hash existed, is read
unverified).  No method here is a collective: which rank writes, how every
rank learns a save's fate, retries and the fall-back past a corrupt file
are ``training.fault_tolerance.ResilientCheckpointer``'s, the one
checkpointer the trainer uses.  A resume may use another number of
processes.  The directory must be one filesystem that every rank sees.
Nothing of the dropout stream is saved: each step's masks are a function
of the run's seed, the epoch and the step (``dpp.step_seed``), so a resumed
run draws the masks the uninterrupted run would have.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import torch

from distributeddataparallel_tpu_torch.training.state import TrainState

_NAME = re.compile(r"^epoch_(\d+)\.pt$")


def _leaves(tree, prefix: str = ""):
    """(path, leaf) of every non-container value in a nested dict/list."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def state_content_hash(payload: dict) -> str:
    """sha256 over every leaf of a checkpoint payload, in sorted path order:
    ``path|dtype|shape|`` and the raw bytes of each tensor (the model's
    state dict, the optimizer's state), ``path|type|repr`` of every other
    value (the schedule's state, the step, the epoch, the hyperparameters).
    Two payloads hash equal iff they are structurally and bitwise identical.
    The tensors must be on the host (``host_payload``)."""
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(payload), key=lambda kv: kv[0]):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().contiguous()
            h.update(f"{path}|{t.dtype}|{tuple(t.shape)}|".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())
        else:
            h.update(f"{path}|{type(leaf).__name__}|{leaf!r}|".encode())
    return h.hexdigest()


def host_payload(state: TrainState, epoch: int) -> dict:
    """What a checkpoint holds, with every tensor copied to the host once."""
    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cpu(v) for v in tree]
        return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree

    return cpu({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
        "step": state.step,
        "epoch": epoch,
    })


def _atomic_write(path: str, write) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp")
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class CheckpointFiles:
    """The ``max_to_keep`` newest epoch checkpoints in ``directory``."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch}.pt")

    def _hash_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"hash_{epoch}.json")

    def all_steps(self) -> list[int]:
        """Saved epochs, oldest first."""
        return sorted(int(m.group(1)) for f in os.listdir(self.directory) if (m := _NAME.match(f)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def write(self, state: TrainState, epoch: int) -> None:
        """Write ``state`` as the checkpoint of ``epoch``: the host copy, its
        hash sidecar, the checkpoint file, and the pruning to
        ``max_to_keep`` (a checkpoint's sidecar goes with it)."""
        payload = host_payload(state, epoch)
        digest = state_content_hash(payload)
        # Sidecar first: a crash between the two renames leaves a sidecar
        # without its checkpoint (replaced by the next save of the epoch),
        # never a checkpoint that would be read unverified.
        _atomic_write(self._hash_path(epoch), lambda p: _dump_json(p, {"sha256": digest}))
        try:
            _atomic_write(self._path(epoch), lambda p: torch.save(payload, p))
        except BaseException:
            os.remove(self._hash_path(epoch))
            raise
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))
            if os.path.exists(self._hash_path(old)):
                os.remove(self._hash_path(old))

    def read(self, epoch: int) -> dict:
        """The checkpoint of ``epoch`` on the host, its content hash
        verified; ``ValueError`` on a mismatch."""
        payload = torch.load(self._path(epoch), map_location="cpu", weights_only=True)
        if os.path.exists(self._hash_path(epoch)):
            with open(self._hash_path(epoch)) as fh:
                saved = json.load(fh)["sha256"]
            actual = state_content_hash(payload)
            if actual != saved:
                raise ValueError(
                    f"checkpoint epoch {epoch} failed content-hash verification (saved sha256 "
                    f"{saved[:12]}…, restored {actual[:12]}…): corrupted-but-readable state"
                )
        return payload

    @staticmethod
    def load_into(state: TrainState, payload: dict) -> int:
        """Copy a checkpoint payload into ``state`` in place; returns the
        next epoch."""
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        if state.scheduler is not None:
            state.scheduler.load_state_dict(payload["scheduler"])
        state.step = payload["step"]
        return payload["epoch"] + 1


def _dump_json(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)
