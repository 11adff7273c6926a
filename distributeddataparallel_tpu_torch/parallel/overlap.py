"""Gradient reduction overlapped with backward, and the trace evidence.

Counterpart of ``distributeddataparallel_tpu/parallel/overlap.py``.  The
reference gets overlap from XLA's schedule (separate reverse-order buckets
and the TPU compiler's async-collective options) and proves it from the
scheduled HLO.  Here it is DDP's own mechanism, a reducer on autograd hooks:

- ``BucketHooks`` registers one ``register_post_accumulate_grad_hook`` per
  parameter.  When the last parameter of a bucket has its gradient, the
  hook launches that bucket's collective asynchronously, while backward
  goes on computing the earlier layers; the step waits on every work
  handle before the update.  Only an armed backward launches (the
  boundary microbatch under accumulation: DDP's ``no_sync``; each
  bucket's gradient is first scaled by ``arm``'s ``1 / accum_steps``, as
  the reference averages the microbatches before it syncs), and a
  bucket that no hook completed (a parameter without a gradient) is
  launched after backward.  Buckets launch in the order their gradients
  become ready, which is the autograd engine's order for the one graph
  every rank runs, so every rank issues the same collectives in the same
  order.  ``COUNTS`` counts the launches made inside backward and after it.
- ``DPOverlap`` is ``--overlap``'s all-reduce (over ``group``: the data
  axis of a mesh, the world by default): the model's parameters in
  ~``OVERLAP_BUCKET_BYTES`` buckets planned in reverse registration order,
  the port's gradient-ready order (the output layers' gradients first),
  each bucket reduced as ``parallel.data_parallel.bucket_gradients``
  reduces it (f32, or bf16 under the bf16 hook), so the result equals the
  unoverlapped bucketed mean bit for bit.
- ``overlap_report`` reads device kernel intervals (``trace_kernels`` takes
  them from a ``torch.profiler`` Chrome trace): the communication kernels'
  time, the part of it under compute kernels on another stream, and their
  ratio; ``kernel_time_by_name`` buckets kernel time by name.

The reference's XLA-side helpers (``compiler_stamp``,
``overlap_compiler_options``, ``tpu_topology_mesh``, the scheduled-HLO
parsers) read a compiler's schedule that has no counterpart here.
"""

from __future__ import annotations

import json
import re
import weakref
from typing import Callable, Sequence

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    OVERLAP_BUCKET_BYTES,
    _check_compress,
    bucket_flat,
    bucket_unflat,
    group_active,
    plan_buckets,
)

#: Bucket launches, summed over steps: from a hook inside backward, and
#: after backward returned (``reset_counts`` zeroes them).
COUNTS = {"in_backward": 0, "after_backward": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class BucketHooks:
    """Launch ``launch(b, scale)`` for bucket ``b`` from the
    post-accumulate-grad hook of the bucket's last parameter to get its
    gradient, while armed.  ``buckets`` lists each bucket's parameters (a
    parameter in one bucket only).  ``launch`` scales the bucket's gradient
    by ``scale`` unless it is None, starts its collective, and returns what
    ``finish`` hands back for the bucket (a work handle and whatever its
    completion needs)."""

    def __init__(self, buckets: Sequence[Sequence[nn.Parameter]],
                 launch: Callable[[int, float | None], object]):
        self.buckets = [list(b) for b in buckets]
        self.launch = launch
        self._bucket_of = {id(p): b for b, ps in enumerate(self.buckets) for p in ps}
        # The hooks reach this object through a weak reference: the
        # parameters then hold no cycle that would keep the model alive
        # after its trainer is gone.
        me = weakref.ref(self)

        def ready(p):
            hooks = me()
            if hooks is not None:
                hooks._ready(p)

        self._handles = [p.register_post_accumulate_grad_hook(ready) for ps in self.buckets for p in ps]
        self.armed = False
        self.scale: float | None = None
        self.order: list[int] = []
        self._pending: list[int] = []
        self._launched: list = []

    def arm(self, scale: float | None = None) -> None:
        """The next backward launches the buckets as they complete, each
        gradient scaled by ``scale`` first."""
        self.armed, self.scale = True, scale
        self.order = []
        self._pending = [len(ps) for ps in self.buckets]
        self._launched = [None] * len(self.buckets)

    def _ready(self, p: nn.Parameter) -> None:
        if not self.armed:
            return
        b = self._bucket_of[id(p)]
        self._pending[b] -= 1
        if self._pending[b] == 0:
            self._launched[b] = self.launch(b, self.scale)
            self.order.append(b)
            COUNTS["in_backward"] += 1

    def finish(self) -> list:
        """Disarm; launch every bucket no hook launched (all of them when
        not armed), in bucket order; returns each bucket's launch result in
        bucket order."""
        if not self.armed:
            self.order, self._launched, self.scale = [], [None] * len(self.buckets), None
        self.armed = False
        for b, r in enumerate(self._launched):
            if r is None:
                self._launched[b] = self.launch(b, self.scale)
                self.order.append(b)
                COUNTS["after_backward"] += 1
        out, self._launched = self._launched, []
        return out

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


class DPOverlap:
    """``--overlap``'s reducer: the mean all-reduce of ``params``' gradients
    in ~``bucket_bytes`` buckets, launched from backward's hooks."""

    def __init__(self, params: Sequence[nn.Parameter], *, bucket_bytes: int | None = None,
                 compress: str | None = None, group=None):
        _check_compress(compress)
        self.params = list(params)
        self.compress = compress
        self.group = group  # the data axis's process group (None: the world)
        groups = plan_buckets([p.numel() * p.element_size() for p in self.params],
                              bucket_bytes or OVERLAP_BUCKET_BYTES)
        self.hooks = BucketHooks([[self.params[i] for i in g] for g in groups], self._launch)

    def _launch(self, b: int, scale: float | None):
        leaves = []
        for p in self.hooks.buckets[b]:
            if p.grad is None:  # unused by the loss: a zero gradient
                p.grad = torch.zeros_like(p)
            elif scale is not None:
                p.grad.mul_(scale)
            leaves.append(p.grad)
        flat = bucket_flat(leaves, self.compress)
        work = dist.all_reduce(flat, group=self.group, async_op=True) if group_active(self.group) else None
        return work, flat, leaves

    def arm(self, scale: float | None = None) -> None:
        self.hooks.arm(scale)

    def finish(self) -> None:
        """Every bucket reduced (waited on) and its mean in the ``.grad``s."""
        for work, flat, leaves in self.hooks.finish():
            if work is not None:
                work.wait()
            bucket_unflat(flat, leaves, self.group)


# ------------------------------------------------------------ evidence ---

#: Device kernels of the collectives (NCCL's, and gloo's none: it has no
#: device kernels).
COMM_KERNEL = re.compile(r"nccl", re.IGNORECASE)


def trace_kernels(trace) -> list[dict]:
    """Device kernel intervals of a ``torch.profiler`` Chrome trace (a path
    or its loaded JSON): ``{"name", "stream", "start", "end"}`` in us."""
    if not isinstance(trace, dict):
        with open(trace) as fh:
            trace = json.load(fh)
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") == "kernel":
            args = ev.get("args", {})
            stream = args.get("stream", ev.get("tid"))
            out.append({"name": ev.get("name", ""), "stream": stream,
                        # ddplint: allow[host-sync] — parses a trace's JSON numbers, no tensor
                        "start": float(ev["ts"]), "end": float(ev["ts"]) + float(ev.get("dur", 0.0))})
    return out


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _covered(a: float, b: float, union: list[tuple[float, float]]) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in union)


def overlap_report(kernels: list[dict], comm: re.Pattern = COMM_KERNEL) -> dict:
    """Communication against compute from device kernel intervals
    (``trace_kernels``): ``comm_ms`` (the union of the communication
    kernels' intervals), ``overlapped_ms`` (the part of each communication
    kernel's interval that compute kernels on other streams cover),
    ``overlap_frac`` (their ratio; None without communication) and
    ``compute_ms``.  The counterpart of the reference's ``schedule_report``,
    on measured intervals instead of a compiler's cost model."""
    comm_k = [k for k in kernels if comm.search(k["name"])]
    compute_k = [k for k in kernels if not comm.search(k["name"])]
    overlapped = 0.0
    for c in comm_k:
        others = _union([(k["start"], k["end"]) for k in compute_k if k["stream"] != c["stream"]])
        overlapped += _covered(c["start"], c["end"], others)
    comm_us = sum(b - a for a, b in _union([(k["start"], k["end"]) for k in comm_k]))
    compute_us = sum(b - a for a, b in _union([(k["start"], k["end"]) for k in compute_k]))
    return {
        "n_comm_kernels": len(comm_k),
        "comm_ms": comm_us / 1e3,
        "overlapped_ms": overlapped / 1e3,
        "overlap_frac": overlapped / comm_us if comm_us else None,
        "compute_ms": compute_us / 1e3,
    }


def kernel_time_by_name(kernels: list[dict], buckets: dict[str, str]) -> dict:
    """Device kernel time (ms) bucketed by the first regex in ``buckets``
    that matches a kernel's name, the rest under ``other`` (the
    counterpart of the reference's ``cycles_by_scope``)."""
    compiled = {k: re.compile(v, re.IGNORECASE) for k, v in buckets.items()}
    out = {k: 0.0 for k in buckets}
    out["other"] = 0.0
    for k in kernels:
        ms = (k["end"] - k["start"]) / 1e3
        for name, rx in compiled.items():
            if rx.search(k["name"]):
                out[name] += ms
                break
        else:
            out["other"] += ms
    total = sum(out.values())
    return {"total_ms": total, "by_name": out,
            "frac": {k: (v / total if total else 0.0) for k, v in out.items()}}


def comm_schedule_ir(params, *, bucket_bytes: int | None = None, axis: str = "data",
                     prim: str = "all_reduce"):
    """The bucketed gradient sync's order as schedule IR (the reference's
    ``comm_schedule_ir``, ``parallel/overlap.py:553``): one tick a bucket,
    planned from ``params`` (the trainable parameters, in the model's
    order) by the planner the step uses (``plan_buckets``), so the SL302
    recorded-count check catches the step and the plan diverging.
    ``bucket_bytes=None``: one bucket a leaf."""
    from distributeddataparallel_tpu_torch.analysis.schedule_lint import grad_sync_schedule_ir

    sizes = [p.numel() * p.element_size() for p in params]
    n = len(sizes) if bucket_bytes is None else len(plan_buckets(sizes, bucket_bytes))
    return grad_sync_schedule_ir(n, axis=axis, prim=prim)


def zero_bucket_params(layout) -> list[list[nn.Parameter]]:
    """A ``parallel.zero.ZeroLayout``'s buckets as parameter lists, for
    ``BucketHooks`` (the reduce-scatters of ZeRO-2/3 under ``--overlap``)."""
    return [[pc.param for pc in pieces] for pieces in layout.bucket_pieces]
