"""Step metrics: the windowed throughput meter and the run's fault counters.

Copies of ``StepTimer`` and ``FaultCounters`` from the JAX package's
``utils/metrics.py``.  ``StepTimer`` takes the device drain as a callable
(``torch.cuda.synchronize`` on the card) instead of an array to block on,
and the chip count from its caller.  The all-reduce bandwidth probe and
the overlap probe wait for a multi-card port.

Design rule carried over from the reference: keep measurement off the hot
path.  ``StepTimer`` only drains the device at window boundaries; per step
it just stamps the host clock.
"""

from __future__ import annotations

import time

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
