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

Under ZeRO (``parallel.zero``) or PowerSGD each rank holds state of its own:
its shard of the optimizer state (the low-bit moments with their noise
generator), PowerSGD's error residual.  ``host_payload`` is then a
collective: every rank calls it, rank 0 gathers each rank's part into the
payload's ``ranks`` list (and, under ZeRO-3, the model's gathered
parameters) and gets the payload, the others None.  ``load_into`` gives each
rank its own part back, at the same world size only (resharding to another
is ROADMAP item 13).  Under tensor, expert or pipeline parallelism each
model shard (a rank's heads and hidden units, its experts, its stage's
layers with the replicated leaves; without ZeRO, its optimizer state too)
is gathered once, from the ranks at data and seq index 0; the payload's
``model`` is the shards merged, the whole model (so a plain model loads an
``--ep`` or ``--pp`` checkpoint's), and each rank cuts its shard out of it
on resume.  The payload records the mesh: a resume needs the same mesh.  A
pipeline's payload also records its virtual chunks a stage
(``pp_virtual``): the stages' layers and optimizer state are in that
geometry's storage order, so a resume at another ``(pp, virtual)`` is
refused, as the reference's restore guard refuses it.
Under FSDP (``parallel.fsdp``) the payload's ``model`` is the whole model
from the host gather (a collective), its ``layout`` is ``"fsdp"`` (the
reference's ``topology_meta`` name) and ``ranks`` holds each rank's
optimizer shard.  It resumes at the same mesh; its model loads into a plain
run, and a plain checkpoint into an FSDP run, the optimizer state moved
between the flats and the parameters (``parallel.fsdp``'s
``plain_optimizer_state`` / ``shard_optimizer_state``; without TP).
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

import dataclasses
import hashlib
import json
import os
import re

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.parallel.expert_parallel import merge_ep_shards, shard_model_axes
from distributeddataparallel_tpu_torch.parallel.pipeline_parallel import merge_pp_shards, shard_state_dict_pp
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards
from distributeddataparallel_tpu_torch.runtime.distributed import (
    PIPE_AXIS,
    axis_index,
    axis_size,
    current_mesh,
    get_rank,
    get_world_size,
)
from distributeddataparallel_tpu_torch.training.optim import load_optimizer_state, optimizer_state_dict
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
    part, those of the owners holding ``model``): TP shards merged per
    expert index, then the experts, then the pipeline stages."""
    mesh = current_mesh()
    owned = {r: p.pop("model") for r, p in enumerate(parts) if "model" in p}
    index = lambda r, k: mesh.coords_of(r)[axes[k]] if k in axes else 0
    stages = []
    for s in range(axis_size(axes.get("pp"))):
        rows = []
        for e in range(axis_size(axes.get("ep"))):
            row = [sd for r, sd in sorted(owned.items(), key=lambda kv: index(kv[0], "tp"))
                   if index(r, "ep") == e and index(r, "pp") == s]
            rows.append(merge_tp_shards(row))
        stages.append(merge_ep_shards(rows))
    return merge_pp_shards(stages, virtual) if len(stages) > 1 else stages[0]


def _virtual(state: TrainState) -> int:
    """A pipeline stage's virtual chunks (1 for any other model)."""
    return getattr(state.model, "virtual", 1)


def _check_pp_geometry(state: TrainState, payload: dict) -> None:
    """The reference's restore guard (``training/elastic.py:293-308``): a
    pipeline's layers are stored in its ``(pp, virtual)`` order, so an
    interleaved checkpoint resumes only at that geometry, and an
    interleaved run only from a checkpoint of its own geometry."""
    old_v, new_v = int(payload.get("pp_virtual", 1)), _virtual(state)
    mesh = payload.get("mesh") or {"axes": [], "shape": []}
    old_pp, new_pp = dict(zip(mesh["axes"], mesh["shape"])).get(PIPE_AXIS, 1), axis_size(PIPE_AXIS)
    if old_v != new_v or (new_v > 1 and old_pp != new_pp):
        raise ValueError(f"checkpoint layer storage is interleaved for (pp={old_pp}, virtual={old_v}) but this run "
                         f"is (pp={new_pp}, virtual={new_v}) — interleaved layouts resume only at their exact "
                         f"pipeline geometry")


def per_rank(state: TrainState) -> bool:
    """Does each rank hold state of its own (ZeRO or FSDP shards, PowerSGD,
    a TP or EP shard of the model)?"""
    return (state.zero is not None or state.fsdp is not None or state.comm_state is not None
            or bool(_model_axes(state)))


def _mesh_record():
    mesh = current_mesh()
    return None if mesh is None else {"axes": list(mesh.axes), "shape": list(mesh.shape)}


def _rank_part(state: TrainState) -> dict:
    out: dict = {}
    axes = _model_axes(state)
    if axes and get_rank() == _shard_owner(axes.values()):
        out["model"] = state.model.state_dict()
        if state.zero is None:
            out["optimizer"] = optimizer_state_dict(state.optimizer)
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
               "step": state.step, "epoch": epoch, "ranks": parts}
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
    }
    if _mesh_record() is not None:
        payload["mesh"] = _mesh_record()
    axes = _model_axes(state)
    if "pp" in axes:
        payload["pp_virtual"] = _virtual(state)
    if state.zero is None and not axes:  # the optimizer state is the same on every rank
        payload["optimizer"] = _cpu(optimizer_state_dict(state.optimizer))
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
        if state.fsdp is not None or payload.get("layout") == "fsdp":
            _load_fsdp(state, payload)
            if state.scheduler is not None:
                state.scheduler.load_state_dict(payload["scheduler"])
            state.step = payload["step"]
            return payload["epoch"] + 1
        _check_pp_geometry(state, payload)
        if per_rank(state) != ("ranks" in payload):
            raise ValueError("the checkpoint's layout (per-rank ZeRO/PowerSGD/TP/EP state or not) is not "
                             "this run's: resume with the flags it was saved with")
        if payload.get("mesh") != _mesh_record():
            raise ValueError(f"the checkpoint was saved on the mesh {payload.get('mesh')}, this run's is "
                             f"{_mesh_record()}: resume on the same mesh (resharding is ROADMAP item 13)")
        axes = _model_axes(state)
        model_sd = shard_model_axes(payload["model"], axes.get("tp"), axes.get("ep"))
        if "pp" in axes:
            model_sd = shard_state_dict_pp(model_sd, axis_index(PIPE_AXIS), axis_size(PIPE_AXIS), _virtual(state))
        with state.full_params():
            state.model.load_state_dict(model_sd)
            if state.zero is not None:
                state.zero.load_shard_from_flat()
        if "optimizer" in payload:
            load_optimizer_state(state.optimizer, payload["optimizer"])
        if "ranks" in payload:
            _load_rank_part(state, payload["ranks"])
        if state.scheduler is not None:
            state.scheduler.load_state_dict(payload["scheduler"])
        state.step = payload["step"]
        return payload["epoch"] + 1


def _load_fsdp(state: TrainState, payload: dict) -> None:
    """An FSDP payload into an FSDP state at the same mesh, or into a plain
    state; a plain payload into an FSDP state."""
    from distributeddataparallel_tpu_torch.parallel import fsdp

    groups = optimizer_state_dict(state.optimizer)["param_groups"]
    if state.fsdp is not None and payload.get("layout") == "fsdp":
        if payload.get("mesh") != _mesh_record() or len(payload["ranks"]) != get_world_size():
            raise ValueError(f"the FSDP checkpoint was saved on {len(payload['ranks'])} ranks (mesh "
                             f"{payload.get('mesh')}), this run has {get_world_size()} (mesh {_mesh_record()}): "
                             f"resume on the same mesh (resharding is ROADMAP item 13)")
        state.fsdp.load_full(payload["model"])
        load_optimizer_state(state.optimizer, payload["ranks"][get_rank()]["optimizer"])
    elif state.fsdp is not None:
        if "ranks" in payload:
            raise ValueError("an FSDP run loads an FSDP or a plain checkpoint (not ZeRO/TP/PowerSGD state)")
        state.fsdp.load_full(payload["model"])
        load_optimizer_state(state.optimizer, fsdp.shard_optimizer_state(state.fsdp, payload["optimizer"], groups))
    else:
        mesh = payload.get("mesh") or {"axes": [], "shape": []}
        if per_rank(state) or dict(zip(mesh["axes"], mesh["shape"])).get("model", 1) > 1:
            raise ValueError("an FSDP checkpoint without TP loads into an FSDP run or a plain one (not "
                             "ZeRO/TP/PowerSGD state)")
        cfg = dataclasses.replace(state.model.cfg, scan_layers=True, dropout_rate=0.0, cp_axis=None)
        meta = fsdp.FsdpMeta(cfg, len(payload["ranks"]))
        state.model.load_state_dict(payload["model"])
        load_optimizer_state(state.optimizer, 
            fsdp.plain_optimizer_state(meta, [p["optimizer"] for p in payload["ranks"]], groups))


def _load_rank_part(state: TrainState, parts: list) -> None:
    if len(parts) != get_world_size():
        raise ValueError(f"the checkpoint holds {len(parts)} ranks' shards, this run has "
                         f"{get_world_size()}: resharding to another world size is ROADMAP item 13")
    part = parts[get_rank()]
    if state.zero is not None:
        if part.get("zero_level") != state.zero.level:
            raise ValueError(f"checkpoint of ZeRO level {part.get('zero_level')}, this run is at "
                             f"{state.zero.level}")
        if state.moments is not None:
            state.moments.load_state_dict(part["moments"])
    axes = _model_axes(state)
    if state.zero is not None:
        load_optimizer_state(state.optimizer, part["optimizer"])
    elif axes:
        load_optimizer_state(state.optimizer, parts[_shard_owner(axes.values())]["optimizer"])
    if state.comm_state is not None:
        from distributeddataparallel_tpu_torch.parallel.powersgd import PowerSGDLeaf

        device = next(state.model.parameters()).device
        state.comm_state = [None if s is None else PowerSGDLeaf(q=s["q"].to(device), err=s["err"].to(device))
                            for s in part["comm_state"]]


def _dump_json(path: str, obj) -> None:
    with open(path, "w") as fh:
        json.dump(obj, fh)
