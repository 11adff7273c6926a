"""Epoch checkpoint files of the replicated data-parallel train state.

Counterpart of the file half of the reference's ``Checkpointer``
(``distributeddataparallel_tpu/training/checkpoint.py``) for plain DP, where
every rank holds the same state.  ``CheckpointFiles.write`` copies the model
(parameters and buffers), the optimizer, the LR schedule, the step, the
epoch and the topology record to the host once, hashes that copy (``state_content_hash``) into the
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

Under ZeRO (``parallel.zero``) or PowerSGD each rank holds state of its own:
its shard of the optimizer state (the low-bit moments with their noise
generator), PowerSGD's error residual.  ``host_payload`` is then a
collective: every rank calls it, rank 0 gathers each rank's part into the
payload's ``ranks`` list (and, under ZeRO-3, the model's gathered
parameters) and gets the payload, the others None.  Under tensor, expert or
pipeline parallelism each model shard (a rank's heads and hidden units, its
experts, its stage's layers with the replicated leaves; without ZeRO, its
optimizer state too, with its parameters' names) is gathered once, from the
ranks at data and seq index 0; the payload's ``model`` is the shards
merged, the whole model (so a plain model loads an ``--ep`` or ``--pp``
checkpoint's).  Under FSDP (``parallel.fsdp``) the payload's ``model`` is
the whole model from the host gather (a collective), its ``layout`` is
``"fsdp"`` and ``ranks`` holds each rank's optimizer shard.

Every payload records its mesh and its topology (``training.elastic``'s
``topology_meta``: the layout, the data, TP, EP and PP degrees, a
pipeline's virtual chunks a stage).  ``load_into`` goes through
``training.elastic.elastic_restore``: at the same mesh each rank takes its
own part back; at another, the state is resharded as the reference's
``elastic_restore`` reshards it (replicated, ``zero1`` and ``fsdp``
layouts, across the data, TP, EP and PP degrees), and refused where the
reference refuses (another layout, another interleaved pipeline geometry,
ZeRO-2/3 at another degree).  A payload written before the topology record
resumes only at its own mesh.  An FSDP payload without TP also loads into a
plain run, and a plain one into an FSDP run, the optimizer state moved
between the flats and the parameters (``parallel.fsdp``'s
``plain_optimizer_state`` / ``shard_optimizer_state``).
Nothing of the dropout stream is saved: each step's masks are a function
of the run's seed, the epoch and the step (``dpp.step_seed``), so a resumed
run draws the masks the uninterrupted run would have.
Under ``--nan-guard`` the schedule's count lives on the device
(``training.optim.DeviceSchedule``) and the optimizer is fused; a save
reads the count (the train loop drains its in-flight steps before every
save) and writes it, and the optimizer's LR, in ``LambdaLR``'s format, and
a load keeps the loading run's kind of update
(``training.optim.load_optimizer_state``): a guarded checkpoint resumes
into an unguarded run, and the reverse.
"""

from __future__ import annotations

import hashlib
import json
import os
import re

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.runtime.distributed import (
    PIPE_AXIS,
    axis_size,
    current_mesh,
    get_rank,
    get_world_size,
)
from distributeddataparallel_tpu_torch.training.elastic import merge_positions, state_topology
from distributeddataparallel_tpu_torch.training.optim import optimizer_state_dict
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


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def _model_axes(state: TrainState) -> dict:
    """The mesh axes the model is sharded over, ``{"tp": axis, "ep": axis,
    "pp": axis}`` for those of size > 1 (empty: unsharded; ``pp``: a
    pipeline stage's model)."""
    cfg = getattr(state.model, "cfg", None)
    axes = {"tp": getattr(cfg, "tp_axis", None), "ep": getattr(cfg, "ep_axis", None),
            "pp": PIPE_AXIS if getattr(state.model, "n_stages", 1) > 1 else None}
    return {k: a for k, a in axes.items() if axis_size(a) > 1}


def _shard_owner(axes) -> int:
    """The rank that writes this rank's model shard: the one at index 0 on
    every mesh axis but ``axes`` and at this rank's index on those."""
    mesh = current_mesh()
    return mesh.rank_at({a: mesh.index(a) for a in axes})


def _merge_model(parts: list, axes: dict, virtual: int = 1) -> dict:
    """The whole model from the owners' shards (``parts``: every rank's
    part, those of the owners holding ``model``)."""
    mesh = current_mesh()
    index = lambda r, k: mesh.coords_of(r)[axes[k]] if k in axes else 0
    owned = {(index(r, "tp"), index(r, "ep"), index(r, "pp")): p.pop("model")
             for r, p in enumerate(parts) if "model" in p}
    return merge_positions(owned, *(axis_size(axes.get(k)) for k in ("tp", "ep", "pp")), virtual)


def _virtual(state: TrainState) -> int:
    """A pipeline stage's virtual chunks (1 for any other model)."""
    return getattr(state.model, "virtual", 1)


def per_rank(state: TrainState) -> bool:
    """Does each rank hold state of its own (ZeRO or FSDP shards, PowerSGD,
    a TP or EP shard of the model)?"""
    return (state.zero is not None or state.fsdp is not None or state.comm_state is not None
            or bool(_model_axes(state)))


def _mesh_record():
    mesh = current_mesh()
    return None if mesh is None else {"axes": list(mesh.axes), "shape": list(mesh.shape)}


def _param_names(state: TrainState) -> list[str]:
    """The model's parameter names in the optimizer's order."""
    return [n for n, _ in state.model.named_parameters()]


def _rank_part(state: TrainState) -> dict:
    out: dict = {}
    axes = _model_axes(state)
    if axes and get_rank() == _shard_owner(axes.values()):
        out["model"] = state.model.state_dict()
        if state.zero is None:
            out["optimizer"] = optimizer_state_dict(state.optimizer)
            out["param_names"] = _param_names(state)
    if state.zero is not None:
        out["optimizer"] = optimizer_state_dict(state.optimizer)
        out["zero_level"] = state.zero.level
        if state.moments is not None:
            out["moments"] = state.moments.state_dict()
    if state.comm_state is not None:
        out["comm_state"] = [None if s is None else {"q": s.q, "err": s.err} for s in state.comm_state]
    return _cpu(out)


def _gather_parts(part: dict) -> list | None:
    """Every rank's ``part`` on rank 0 (None elsewhere): a collective."""
    if get_world_size() == 1:
        return [part]
    parts = [None] * get_world_size() if get_rank() == 0 else None
    dist.gather_object(part, parts, dst=0)
    return parts


def _fsdp_payload(state: TrainState, epoch: int) -> dict | None:
    from distributeddataparallel_tpu_torch.parallel.fsdp import fsdp_gather_params

    model = fsdp_gather_params(state.fsdp, host=True)
    parts = _gather_parts(_cpu({"optimizer": optimizer_state_dict(state.optimizer)}))
    if get_rank() != 0:
        return None
    payload = {"model": model, "layout": "fsdp",
               "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
               "step": state.step, "epoch": epoch, "ranks": parts, "topology": state_topology(state)}
    if _mesh_record() is not None:
        payload["mesh"] = _mesh_record()
    return payload


def host_payload(state: TrainState, epoch: int) -> dict | None:
    """What a checkpoint holds, with every tensor copied to the host once.
    A collective when each rank holds state of its own (``per_rank``):
    rank 0 gets the payload, the others None."""
    if state.fsdp is not None:
        return _fsdp_payload(state, epoch)
    with state.full_params():
        model = _cpu(state.model.state_dict())
    payload = {
        "model": model,
        "scheduler": state.scheduler.state_dict() if state.scheduler is not None else None,
        "step": state.step,
        "epoch": epoch,
        "topology": state_topology(state),
    }
    if _mesh_record() is not None:
        payload["mesh"] = _mesh_record()
    axes = _model_axes(state)
    if "pp" in axes:
        payload["pp_virtual"] = _virtual(state)
    if state.zero is None and not axes:  # the optimizer state is the same on every rank
        payload["optimizer"] = _cpu(optimizer_state_dict(state.optimizer))
        payload["param_names"] = _param_names(state)
    if not per_rank(state):
        return payload
    parts = _gather_parts(_rank_part(state))
    if get_rank() != 0:
        return None
    if axes:
        payload["model"] = _merge_model(parts, axes, _virtual(state))
    payload["ranks"] = parts
    return payload


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

    def write(self, state: TrainState, epoch: int, payload: dict | None = None) -> None:
        """Write ``state`` as the checkpoint of ``epoch``: the host copy
        (``payload`` when given), its hash sidecar, the checkpoint file, and
        the pruning to ``max_to_keep`` (a checkpoint's sidecar goes with
        it)."""
        if payload is None:
            payload = host_payload(state, epoch)
        digest = state_content_hash(payload)
        # Sidecar first: a crash between the two renames leaves a sidecar
        # without its checkpoint (replaced by the next save of the epoch),
        # never a checkpoint that would be read unverified.
        _atomic_write(self._hash_path(epoch), lambda p: _dump_json(p, {"sha256": digest}))
        try:
            _atomic_write(self._path(epoch), lambda p: torch.save(payload, p))
        # ddplint: allow[broad-except] — removes the partial hash sidecar, then re-raises
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
        """Copy a checkpoint payload into ``state`` in place, resharded to
        this run's geometry (``training.elastic.elastic_restore``); returns
        the next epoch."""
        from distributeddataparallel_tpu_torch.training.elastic import elastic_restore

        return elastic_restore(payload, state)


def _dump_json(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)
