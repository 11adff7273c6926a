"""Step metrics: the windowed throughput meter and the run's fault counters.

Copies of ``StepTimer`` and ``FaultCounters`` from the JAX package's
``utils/metrics.py``.  ``StepTimer`` takes the device drain as a callable
(``torch.cuda.synchronize`` on the card) instead of an array to block on,
and the chip count from its caller.

The gradient all-reduce probes (the reference's ``allreduce_bandwidth``
and ``overlap_probe``, BASELINE.md's "grad all-reduce BW util"), over the
data axis's process group (NCCL on the cards, gloo on the CPU): the bus
bandwidth of a ``size_mb`` f32 all-reduce in the NCCL convention against
the card's link peak (``LINK_PEAK_BYTES_PER_S``: the H100's NVLink; None
elsewhere, so no utilization against a wrong denominator), and how much of
a train step's gradient all-reduce hides under its compute.  Timed with
CUDA events on the card, the host clock around a drained loop on the CPU.

Design rule carried over from the reference: keep measurement off the hot
path.  ``StepTimer`` only drains the device at window boundaries; per step
it just stamps the host clock.
"""

from __future__ import annotations

import time

import torch

from distributeddataparallel_tpu_torch.observability.schema import json_safe


# Readings no longer have a warmup state (the first step is accounted
# separately), but the key survives for JSONL schema compatibility.
_WARMUP_COMPAT = False


class StepTimer:
    """Windowed throughput meter: items/s and items/s/chip.

    ``tick(items, sync)`` per step; every ``window`` steps it calls
    ``sync`` (a zero-arg callable that drains the device, or None) and
    emits a reading.

    The FIRST tick is special: it carries the one-time costs (kernel build
    and load, allocator warm-up), so it is timed separately — the timer
    calls ``sync``, records the wall time as ``compile_s``, and excludes
    that step from every throughput window instead of letting it poison
    the first reading.  ``compile_s`` is emitted once, in the first
    reading after it is known.

    Historical note: readings used to flag their first window as
    ``warmup`` and every consumer had to branch on it; splitting the
    compile step out made the flag constant-False and the branches dead,
    so they are gone.  The key itself stays (see ``_WARMUP_COMPAT``) so
    existing JSONL consumers keyed on it don't break.
    """

    def __init__(self, window: int = 50, n_chips: int = 1):
        self.window = window
        self.n_chips = n_chips
        self.compile_s: float | None = None
        self._first_pending = True
        self._compile_emitted = False
        self._t0 = time.perf_counter()
        self._items = 0
        self._steps = 0
        self._windows = 0

    def reset(self) -> None:
        """Restart the current window — call after off-path work (eval,
        checkpoint save) so its wall time doesn't pollute the reading.
        The compile-step accounting is not reset: compilation happens
        once per process, not once per window."""
        self._t0 = time.perf_counter()
        self._items = 0
        self._steps = 0

    def tick(self, items: int, sync: object = None) -> dict | None:
        """Record one step of `items` processed; returns a reading dict at
        window boundaries, else None."""
        if self._first_pending:
            # The compile step: sync NOW so its wall time is attributed
            # here and nowhere else, then start the first window clean.
            if sync is not None:
                sync()  # attributes the first step's wall time
            t1 = time.perf_counter()
            self.compile_s = t1 - self._t0
            self._first_pending = False
            self._t0 = t1
            return None
        self._items += items
        self._steps += 1
        if self._steps < self.window:
            return None
        if sync is not None:
            sync()  # window boundary only, by design
        t1 = time.perf_counter()
        dt = t1 - self._t0
        reading = {
            "items_per_s": self._items / dt,
            "items_per_s_per_chip": self._items / dt / self.n_chips,
            "steps_per_s": self._steps / dt,
            "window_s": dt,
            "warmup": _WARMUP_COMPAT,
        }
        if self.compile_s is not None and not self._compile_emitted:
            reading["compile_s"] = round(self.compile_s, 3)
            self._compile_emitted = True
        self._t0 = t1
        self._items = 0
        self._steps = 0
        self._windows += 1
        return reading


class FaultCounters:
    """Run-level fault accounting — the observability face of the
    fault-tolerance subsystem (``training.fault_tolerance``).

    Mutated by the resilient checkpointer (IO retries, corrupt-step
    fallbacks), the train loop (skipped non-finite steps), the watchdog,
    and the supervisor; ``summary()`` goes into the end-of-run log so a
    run that survived faults SAYS so — silent recovery hides operational
    signal (a climbing retry count is a failing filesystem).
    """

    def __init__(self):
        self.nonfinite_steps = 0
        self.io_retries = 0
        self.ckpt_fallbacks = 0
        self.watchdog_fires = 0
        self.restarts = 0
        # Silent-data-corruption defense (training.integrity): checks
        # are routine probes (not faults — excluded from ``total`` like
        # warm-start accounting); detections and evictions are faults.
        self.sdc_checks = 0
        self.sdc_detects = 0
        self.sdc_evictions = 0
        # Warm-start accounting (training.warm_start): how this
        # incarnation got its kernels — "cache-hit" (all found in the
        # --compile-cache), "cold" (built here), "eager" (no cache) — the
        # wall seconds to the first step, and the attempt it was.
        # Not faults, so excluded from ``total``; surfaced in summary()
        # so a respawn that silently recompiles is visible per attempt.
        self.warm_start_mode: str | None = None
        self.compile_s: float | None = None
        self.warm_start_attempt: int | None = None

    @property
    def total(self) -> int:
        return (
            self.nonfinite_steps + self.io_retries + self.ckpt_fallbacks
            + self.watchdog_fires + self.restarts
            + self.sdc_detects + self.sdc_evictions
        )

    def summary(self) -> dict:
        out = {
            "nonfinite_steps": self.nonfinite_steps,
            "ckpt_io_retries": self.io_retries,
            "ckpt_fallbacks": self.ckpt_fallbacks,
            "watchdog_fires": self.watchdog_fires,
            "restarts": self.restarts,
        }
        if self.sdc_checks or self.sdc_detects or self.sdc_evictions:
            out["sdc_checks"] = self.sdc_checks
            out["sdc_detects"] = self.sdc_detects
            out["sdc_evictions"] = self.sdc_evictions
        if self.warm_start_mode is not None:
            out["warm_start"] = self.warm_start_mode
        if self.warm_start_attempt is not None:
            out["warm_start_attempt"] = self.warm_start_attempt
        if self.compile_s is not None:
            # compile_s may arrive as a numpy scalar or nan (warm-start
            # timing of a failed acquisition); round() keeps those alive,
            # so coerce — this dict goes into the JSONL event log.
            out["first_step_s"] = round(float(self.compile_s), 3)
        return json_safe(out)


# Peak one-way link bandwidth of one card to its peers, bytes/s: the
# all-reduce probe's utilization denominator.  H100 SXM: NVLink 4, 18 links
# of 25 GB/s each way = 450 GB/s (NVIDIA data sheet).  A denominator for a
# *relative* utilization number, as the reference's ICI table; no entry
# (None) off these cards.
LINK_PEAK_BYTES_PER_S = {
    "h100": 450e9,
}


def link_peak_for(device) -> float | None:
    """The card's link peak (bytes/s) from its name, or None (the CPU, an
    unknown card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((bw for key, bw in LINK_PEAK_BYTES_PER_S.items() if key in name), None)


def _probe_group(mesh, axis_name: str):
    """(the axis's process group — None: the world —, its size, the
    collectives' device)."""
    import torch.distributed as dist

    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    if not dist.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
        return None, 1, torch.device(device)
    if mesh is not None:
        return mesh.group(axis_name), mesh.size(axis_name), rt._collective_device()
    return None, dist.get_world_size(), rt._collective_device()


def _timed_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of ``fn`` over ``iters`` calls after one warm-up call:
    CUDA events around the loop on the card (one synchronisation at its
    end), the host clock around a drained loop elsewhere."""
    fn()  # warm-up (NCCL's communicator, the allocator)
    if device.type == "cuda":
        # ddplint: allow[host-sync] — a probe's timing fence, off the training loop
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def allreduce_bandwidth(
    mesh=None,
    *,
    size_mb: float = 64.0,
    iters: int = 10,
    axis_name: str = "data",
) -> dict:
    """Measure gradient all-reduce bandwidth over the mesh's data axis
    (``mesh`` None: the world group).

    Times ``iters`` all-reduces of a ``size_mb`` float32 buffer (the shape
    of DDP's bucket all-reduce) after one warm-up (the first NCCL
    collective builds the communicator) and reports **bus bandwidth** in
    the NCCL convention — ``busbw = 2*(N-1)/N * bytes / t`` — which is the
    number comparable against link peaks, plus utilization against the
    card's link peak (None/0 on unknown hardware).  With one rank the world
    group of one still runs its collective, but the bus formula's
    ``2(N-1)/N`` is 0: the probe reads 0 GB/s and utilization 0.0, as the
    reference's does — it is only meaningful over several ranks.
    """
    import torch.distributed as dist

    from distributeddataparallel_tpu_torch.parallel.data_parallel import group_active

    group, n, device = _probe_group(mesh, axis_name)
    nbytes = int(size_mb * 1e6)
    x = torch.ones(nbytes // 4, dtype=torch.float32, device=device)

    def once():
        if group_active(group):
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)

    dt = _timed_ms(once, iters, device) / 1e3
    bus_bytes = 2 * (n - 1) / max(n, 1) * nbytes
    bw = bus_bytes / dt if dt > 0 else 0.0
    peak = link_peak_for(device)
    return {
        "devices": n,
        "payload_mb": size_mb,
        "time_s": dt,
        "bus_bw_gb_s": bw / 1e9,
        "peak_gb_s": peak / 1e9 if peak else None,
        "utilization": bw / peak if (peak and n > 1) else 0.0,
    }


def overlap_probe(
    loss_fn,
    state,
    batch,
    *,
    mesh=None,
    iters: int = 8,
    axis_name: str = "data",
    overlap: bool = False,
) -> dict:
    """Measure how much of the gradient all-reduce hides under backward.

    Three timings, as the reference's:

    - ``step_ms``:    the full DP train step (compute + its all-reduce;
                      ``overlap=True``: the buckets launched from
                      backward's hooks, ``parallel.overlap``)
    - ``compute_ms``: the same step with ``grad_sync=False`` (no_sync
                      analog — identical compute, zero grad comm)
    - ``comm_ms``:    a bare all-reduce of the exact gradient leaves

    ``overlap_frac = (compute + comm - step) / comm`` — 1.0 when the
    collective is fully hidden under compute, 0.0 when the step serializes
    them.  With one rank the collective has nothing to hide and the probe
    reports ``overlap_frac = None``.  The steps update ``state`` in place
    (the reference's are functional): probe a throwaway state.
    """
    from distributeddataparallel_tpu_torch.parallel.data_parallel import all_reduce_gradients
    from distributeddataparallel_tpu_torch.training.train_step import make_train_step

    group, n, _ = _probe_group(mesh, axis_name)
    device = next(state.model.parameters()).device
    full = make_train_step(loss_fn, overlap=overlap)
    nosync = make_train_step(loss_fn, grad_sync=False)
    step_ms = _timed_ms(lambda: full(state, batch), iters, device)
    compute_ms = _timed_ms(lambda: nosync(state, batch), iters, device)

    params = [p for p in state.model.parameters() if p.requires_grad]
    grads_like = [torch.zeros_like(p) for p in params]
    comm_ms = _timed_ms(lambda: all_reduce_gradients(grads_like, group=group), iters, device)

    grad_bytes = sum(p.numel() * p.element_size() for p in params)
    frac = None
    if n > 1 and comm_ms > 0:
        frac = max(0.0, min(1.0, (compute_ms + comm_ms - step_ms) / comm_ms))
    return {
        "devices": n,
        "grad_mb": round(grad_bytes / 1e6, 2),
        "step_ms": round(step_ms, 3),
        "compute_ms": round(compute_ms, 3),
        "comm_ms": round(comm_ms, 3),
        "overlap_frac": None if frac is None else round(frac, 4),
    }
