"""Graph lint of the port: the collectives one eager step issues, recorded.

The JAX package's ``analysis/graph_lint.py`` walks the jaxpr of a traced
step.  An eager torch step has no program to walk before it runs, so the
port runs the step and records what it does: ``CollectiveRecorder`` wraps
``torch.distributed``'s collectives (every module of the port calls them
as ``dist.<name>`` on the one module object, so the wrappers see every
call, the world group of one rank and ``batch_isend_irecv`` included;
``isend``/``irecv`` stay unwrapped, since ``P2POp`` checks its function
by identity) and notes, for each, the function, the mesh axes of its
process group
(``runtime.distributed.make_mesh``'s groups; the world is every axis of
the mesh, or ``data`` without one), the shapes, dtypes and element
count, and whether it is gradient-sized.  A collective over a mesh axis
of one rank is skipped by the port (``data_parallel.group_active``), so
it is not recorded: the reference's jaxpr still holds it.

Gradient-sized means more than one element and not a metric pack: the
port stacks a step's scalar metrics into one vector for one reduction
(``data_parallel.metric_pack`` marks it), where the reference reduces
each scalar alone and counts none of them.

What is checked (rule ids in ``analysis.rules``):

- GL001: the gradient-sized reductions per mesh axis match the factory's
  manifest (``step.collective_manifest``, or a builder of it from the
  state): a dropped or doubled ``all_reduce`` is a count mismatch;
- GL002: the collective sequence fingerprint of two consecutive steps is
  the same (``check_order``: the second and third steps, since the first
  may issue one-time set-up collectives);
- GL004: no bf16 -> f32 promotion on the wire (an f32 gradient reduction
  under uniformly bf16 parameters) or in the updated state;
- GL005: no device-to-host sync inside the step: on CUDA the step runs
  under ``torch.cuda.set_sync_debug_mode("error")``, so the first sync
  raises (on the CPU nothing syncs, and there is nothing to find);
- SF201: a gradient-sized ``all_reduce`` over an axis whose manifest
  declares ``reduce_scatter_tensor`` (the replicated reduction a ZeRO or
  FSDP layout exists to avoid);
- SF203: an all-gather whose gathered output exceeds the device's memory
  (``observability.memory.hbm_budget_bytes``).

GL003 (donation) has no port meaning: the port's update runs in place.
Linting runs the step for real: the state is updated as by any step, so
``dpp.py --lint-step`` lints the run's first step itself.  Without a
process group nothing can be recorded, and ``lint_train_step`` raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.analysis.rules import Finding, collective_manifest

#: ``torch.distributed`` functions the recorder wraps
COLLECTIVE_FNS = (
    "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor", "all_gather", "all_to_all_single",
    "broadcast", "batch_isend_irecv", "send", "recv",
)

#: reduction collectives that move gradient-sized payloads — an unexpected
#: one on an unexpected axis is a double-sync bug
REDUCE_PRIMS = frozenset({"all_reduce", "reduce_scatter_tensor"})

#: all-gathers, whose gathered output SF203 weighs against the budget
GATHER_PRIMS = frozenset({"all_gather_into_tensor", "all_gather"})



@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective the step issued, in issue order.  ``prim`` is the
    ``torch.distributed`` function (``all_reduce`` sums and means;
    ``all_reduce_min`` / ``_max`` / ``_product`` the other reductions);
    ``sends`` counts a ``batch_isend_irecv``'s sends; ``out_bytes`` is an
    all-gather's gathered output."""

    prim: str
    axes: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[str, ...]
    grad_sized: bool
    sends: int = 0
    out_bytes: int = 0

    def key(self) -> tuple:
        return (self.prim, self.axes, self.shapes, self.dtypes)


def _axes_by_group() -> dict:
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    mesh = rt.current_mesh()
    if mesh is None:
        return {None: (rt.DATA_AXIS,)}
    out = {None: tuple(mesh.axes)}
    for key, group in mesh._groups.items():
        if group is not None:
            out[id(group)] = tuple(key) if isinstance(key, tuple) else (key,)
    return out


def _tensors(arg) -> list:
    if isinstance(arg, torch.Tensor):
        return [arg]
    if isinstance(arg, (list, tuple)):
        return [t for a in arg for t in _tensors(a)]
    return []


def _grad_sized(tensors) -> bool:
    return any(t.numel() > 1 and not getattr(t, "ddp_metric_pack", False) for t in tensors)


class CollectiveRecorder:
    """Within ``with CollectiveRecorder() as rec:`` every collective the
    process issues is appended to ``rec.collectives`` (and still runs),
    from any thread: on CUDA, autograd runs backward nodes and gradient
    hooks on its device thread, so FSDP's reduce-scatter and the
    bucketed sync's all-reduces come from there, not from the thread
    that called the step."""

    def __init__(self):
        self.collectives: list[Collective] = []
        self._saved: dict = {}
        self._lock = threading.Lock()

    def _record(self, name: str, args, kwargs) -> None:
        with self._lock:
            self._append(name, args, kwargs)

    def _append(self, name: str, args, kwargs) -> None:
        ops = (args[0] if args else kwargs["p2p_op_list"]) if name == "batch_isend_irecv" else None
        group = ops[0].group if ops else kwargs.get("group")
        axes = self._axes.get(None if group in (None, dist.group.WORLD) else id(group), ("?",))
        if ops is not None:
            tensors = [op.tensor for op in ops]
            kinds = tuple("send" if op.op is dist.isend else "recv" for op in ops)
            self.collectives.append(Collective(
                name, axes, tuple(tuple(t.shape) for t in tensors) + (kinds,),
                tuple(str(t.dtype).replace("torch.", "") for t in tensors), _grad_sized(tensors),
                sends=kinds.count("send")))
            return
        tensors = _tensors(list(args) + [v for k, v in kwargs.items() if k != "group"])
        prim = name
        if name == "all_reduce":
            op = kwargs.get("op", args[1] if len(args) > 1 else dist.ReduceOp.SUM)
            if op not in (dist.ReduceOp.SUM, dist.ReduceOp.AVG):
                prim = f"all_reduce_{str(op).rsplit('.', 1)[-1].lower()}"
        out_bytes = sum(t.numel() * t.element_size() for t in _tensors(args[0])) \
            if name in GATHER_PRIMS and args else 0
        self.collectives.append(Collective(
            prim, axes, tuple(tuple(t.shape) for t in tensors),
            tuple(str(t.dtype).replace("torch.", "") for t in tensors), _grad_sized(tensors),
            out_bytes=out_bytes))

    def __enter__(self) -> CollectiveRecorder:
        self._axes = _axes_by_group()
        for name in COLLECTIVE_FNS:
            orig = getattr(dist, name)
            self._saved[name] = orig

            def wrapped(*args, _name=name, _orig=orig, **kwargs):
                self._record(_name, args, kwargs)
                return _orig(*args, **kwargs)

            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        for name, orig in self._saved.items():
            setattr(dist, name, orig)
        self._saved.clear()


def collective_fingerprint(collectives) -> str:
    """Stable digest of the collective sequence (function, axes, shapes,
    dtypes, in issue order): two ranks, or two steps, compare a 16-hex
    string instead of the lists."""
    h = hashlib.sha256()
    for c in collectives:
        h.update(repr(c.key()).encode())
    return h.hexdigest()[:16]


def collective_counts(collectives) -> dict[str, int]:
    """``"axis:function" -> count`` over the gradient-sized collectives
    (``GraphReport.collective_counts``)."""
    counts: dict[str, int] = {}
    for c in collectives:
        if c.grad_sized:
            for ax in c.axes:
                k = f"{ax}:{c.prim}"
                counts[k] = counts.get(k, 0) + 1
    return counts


def default_manifest(axis_name: str = "data") -> dict:
    """Fallback contract for steps whose factory attaches no manifest:
    at least one gradient-sized all_reduce over the data axis."""
    return collective_manifest("generic-dp", grad_reduce={axis_name: {"all_reduce": (1, None)}})


def step_manifest(step, state) -> dict:
    """The manifest ``step`` declares for ``state``: a dict, or a builder
    of one from the state (the plain step's depends on whether the model
    has buffers to sync)."""
    man = getattr(step, "collective_manifest", None)
    if callable(man):
        man = man(state)
    return man or default_manifest()


@dataclasses.dataclass
class GraphReport:
    """Lint outcome + the artifacts worth logging even when clean."""

    mode: str
    findings: list
    fingerprint: str
    collective_counts: dict
    #: recorded Collective records (for downstream passes — the schedule
    #: lint counts hop sends without running the step again)
    collectives: list | None = None
    #: the linted step's own result (its metrics): the step really ran
    metrics: dict | None = None

    @property
    def ok(self) -> bool:
        return not self.findings


def _one_rank_axes() -> set:
    """The current mesh's axes of one rank: the port issues no collective
    over them (``data_parallel.group_active``), so their floors are 0."""
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    mesh = rt.current_mesh()
    return set() if mesh is None else {a for a in mesh.axes if mesh.size(a) == 1}


def _check_counts(colls, manifest, n_param_leaves, where) -> list[Finding]:
    findings = []
    idle = _one_rank_axes()
    counts: dict[tuple[str, str], int] = {}
    for c in colls:
        if c.grad_sized:
            for ax in c.axes:
                counts[(ax, c.prim)] = counts.get((ax, c.prim), 0) + 1
    grad_reduce = manifest["grad_reduce"]
    for axis, prims in grad_reduce.items():
        for prim, (mn, mx) in prims.items():
            n = counts.get((axis, prim), 0)
            if n < mn and axis not in idle:
                findings.append(Finding(
                    "GL001", where,
                    f"expected >= {mn} gradient-sized {prim} over axis {axis!r}, found {n} — gradient "
                    "reduction dropped?"))
            elif mx is not None and n > mx:
                findings.append(Finding(
                    "GL001", where,
                    f"expected <= {mx} gradient-sized {prim} over axis {axis!r}, found {n} — duplicated sync?"))
    for axis in manifest["per_leaf_axes"]:
        n = counts.get((axis, "all_reduce"), 0)
        if n != n_param_leaves and axis not in idle:
            findings.append(Finding(
                "GL001", where,
                f"leaf-wise sync over axis {axis!r}: expected exactly {n_param_leaves} all_reduces (one per "
                f"param leaf), found {n}"))
    for (axis, prim), n in sorted(counts.items()):
        if prim in REDUCE_PRIMS and axis not in grad_reduce:
            findings.append(Finding(
                "GL001", where,
                f"{n} gradient-sized {prim} over UNEXPECTED axis {axis!r} (manifest for mode "
                f"{manifest['mode']!r} declares {sorted(grad_reduce)})"))
    return findings


def _check_dtypes(colls, manifest, in_dtypes, out_dtypes, where) -> list[Finding]:
    findings = []
    all_bf16 = bool(in_dtypes) and all(d == torch.bfloat16 for _, d in in_dtypes)
    if all_bf16 and not manifest["allow_f32_reduce"]:
        for c in colls:
            if (c.prim in REDUCE_PRIMS and c.grad_sized and "float32" in c.dtypes
                    and any(ax in manifest["grad_reduce"] for ax in c.axes)):
                findings.append(Finding(
                    "GL004", where,
                    f"{c.prim} over {c.axes} carries float32 operands {c.shapes} while params are uniformly "
                    "bf16 — gradients promoted before the wire (2x bytes)"))
                break  # one finding per step is enough signal
    for (name, a), (_, b) in zip(in_dtypes, out_dtypes):
        if a != b:
            findings.append(Finding(
                "GL004", where,
                f"param {name!r} enters {str(a).replace('torch.', '')} but the updated state holds "
                f"{str(b).replace('torch.', '')} — state dtype promoted"))
    return findings


def _check_flow(colls, manifest, budget, where) -> list[Finding]:
    findings = []
    for axis, prims in manifest["grad_reduce"].items():
        if prims.get("reduce_scatter_tensor", (0, None))[0] < 1:
            continue
        dense = [c for c in colls if c.prim == "all_reduce" and c.grad_sized and axis in c.axes]
        if dense:
            findings.append(Finding(
                "SF201", where,
                f"{len(dense)} gradient-sized all_reduce over axis {axis!r} (largest {max(c.shapes for c in dense)})"
                " under a manifest that declares reduce_scatter_tensor — the gradient is reduced fully "
                "replicated"))
    if budget:
        for c in colls:
            if c.prim in GATHER_PRIMS and c.out_bytes > budget:
                findings.append(Finding(
                    "SF203", where,
                    f"{c.prim} over {c.axes} gathers {c.out_bytes} bytes, more than the device's "
                    f"{budget} — it cannot fit at this scale"))
    return findings


def _param_dtypes(state) -> list:
    return [(n, p.dtype) for n, p in state.model.named_parameters()]


def _param_leaves(state) -> int:
    return sum(1 for p in state.model.parameters() if p.requires_grad)


@contextlib.contextmanager
def _sync_debug(device: torch.device):
    if device.type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _device_of(state) -> torch.device:
    for p in state.model.parameters():
        return p.device
    return torch.device("cpu")


def _sync_site(exc: BaseException) -> str:
    """``dir/file.py:line`` of the innermost frame outside torch in
    ``exc``'s traceback: the code that synchronised."""
    torch_dir = os.path.dirname(torch.__file__)
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if not f.filename.startswith(torch_dir)]
    return "/".join(Path(frames[-1].filename).parts[-2:]) + f":{frames[-1].lineno}" if frames else "?"


def record_step(step, state, batch, rng=None):
    """Run ``step(state, batch, rng)`` once under the recorder (and, on
    CUDA, the sync debug mode "error").  Returns ``(metrics, collectives,
    syncs)``: ``syncs`` holds the message of the device-to-host sync that
    stopped the step, and where it happened, if one did."""
    if not dist.is_initialized():
        raise RuntimeError("graph lint records the collectives of a process group: form one first "
                           "(runtime.distributed.init_process_group, world 1 included)")
    device = _device_of(state)
    syncs: list[str] = []
    metrics = None
    with CollectiveRecorder() as rec:
        try:
            with _sync_debug(device):
                metrics = step(state, batch, rng)
        except RuntimeError as e:
            if "synchroniz" not in str(e):
                raise
            syncs.append(f"{str(e).strip().splitlines()[0]}, at {_sync_site(e)}")
    return metrics, rec.collectives, syncs


def lint_train_step(step, state, batch, rng=None, *, manifest: dict | None = None, check_order: bool = True,
                    mode: str | None = None,
                    hbm_budget_bytes: int | None = None) -> GraphReport:
    """Run ``step(state, batch, rng)`` under the recorder and verify the
    manifest (``step``'s own unless one is given).  The state is updated:
    the step really ran.  ``check_order`` runs two more steps (on the same
    batch) and compares their fingerprints (GL002).
    ``hbm_budget_bytes``: SF203's budget (None: no SF203)."""
    in_dtypes = _param_dtypes(state)
    manifest = manifest or step_manifest(step, state)
    where = f"graph:{mode or manifest['mode']}"
    metrics, colls, syncs = record_step(step, state, batch, rng)
    fingerprint = collective_fingerprint(colls)
    findings = _check_counts(colls, manifest, _param_leaves(state), where)
    findings += _check_dtypes(colls, manifest, in_dtypes, _param_dtypes(state), where)
    for s in syncs:
        findings.append(Finding(
            "GL005", where,
            f"device-to-host sync inside the step ({s}) — every step waits for the device"))
    findings += _check_flow(colls, manifest, hbm_budget_bytes, where)
    if check_order and not syncs:
        # Two steps after the first, which may issue one-time set-up
        # collectives (the pipe's warm-up all_reduce before its first
        # batch_isend_irecv).
        fp2, fp3 = (collective_fingerprint(record_step(step, state, batch, rng)[1]) for _ in range(2))
        if fp2 != fp3:
            findings.append(Finding(
                "GL002", where,
                f"collective sequence fingerprint changed between two steps ({fp2} != {fp3}) — "
                "a nondeterministic collective order will wedge the gang"))
    return GraphReport(mode=mode or manifest["mode"], findings=findings, fingerprint=fingerprint,
                       collective_counts=collective_counts(colls), collectives=colls, metrics=metrics)


def lint_step_schedule(step, state, rep: GraphReport) -> tuple:
    """``(ir, findings)``: SL301-SL304 over the schedule IR ``step``
    carries (a pipeline's ``schedule_ir``, or the bucketed sync's
    ``comm_schedule`` built from the trainable parameters), against the
    collectives ``rep`` recorded; ``(None, [])`` for a step without one.
    A pipeline stage's sends are held to its row of the table."""
    from distributeddataparallel_tpu_torch.analysis.schedule_lint import lint_schedule
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    ir = getattr(step, "schedule_ir", None)
    if ir is None and getattr(step, "comm_schedule", None) is not None:
        ir = step.comm_schedule([p for p in state.model.parameters() if p.requires_grad])
    if ir is None:
        return None, []
    mine = [c for c in rep.collectives or () if c.prim == ir.hop_prim and ir.hop_axis in c.axes]
    stage = None
    if ir.kind == "grad-sync":
        hops = sum(1 for c in mine if c.grad_sized)
    else:
        mesh = rt.current_mesh()
        stage = mesh.index(ir.hop_axis) if mesh is not None and ir.hop_axis in mesh.axes else 0
        hops = sum(c.sends for c in mine)
    return ir, lint_schedule(ir, manifest=step_manifest(step, state), traced_hops=hops,
                             bubble=getattr(step, "bubble_accounting", None),
                             where=f"sched:{rep.mode}:{ir.kind}", stage=stage)
