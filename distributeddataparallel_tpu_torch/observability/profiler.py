"""Profiler orchestration over ``torch.profiler``: windowed capture +
capture-on-anomaly.

Counterpart of the JAX package's ``observability/profiler.py``, which drives
``jax.profiler``; here each capture is a ``torch.profiler.profile`` of the
host (CPU activity) and, on a GPU, the card (CUDA activity, through CUPTI),
written as a Chrome trace (``trace_<reason>_<first>-<last>_p<rank>.json``,
one file per rank, readable by Perfetto or ``chrome://tracing``) into the
directory the reference writes its traces to.

``profile_trace`` is the one-shot context manager.  On top of it,
``ProfilerOrchestrator`` drives the profiler across the train loop:

- ``--profile-steps A:B`` opens a trace when the global step enters
  [A, B) and closes it when it leaves;
- capture-on-anomaly: the FIRST anomaly (``trigger_anomaly``) starts a
  short trace (``anomaly_steps`` steps).  The trigger is wired but idle:
  the nan guard and the watchdog that call it are not ported yet.

Only one trace is active at a time; the orchestrator guards every
transition and degrades to a warning rather than letting telemetry kill
the run.

Module-import rule: stdlib only at module scope — ``torch`` is imported
inside functions.
"""

from __future__ import annotations

import contextlib
import os


def _start_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, path: str, sync=None) -> None:
    if sync is not None:
        sync()  # the trace covers the device work its steps launched
    prof.stop()
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def profile_trace(log_dir: str | None, *, sync=None, name: str = "trace"):
    """A ``torch.profiler`` trace of the scope, written to
    ``log_dir/<name>.json`` (give each rank its own ``name``).  No-op if the
    dir is None.  ``sync`` (a
    zero-arg callable, e.g. ``torch.cuda.synchronize``) runs before the
    trace stops, so it covers the device work launched inside the scope."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    prof = _start_profile()
    try:
        yield
    finally:
        _stop_profile(prof, os.path.join(log_dir, f"{name}.json"), sync)


def parse_profile_steps(spec: str | None) -> tuple[int, int] | None:
    """Parse ``"A:B"`` into a half-open global-step window [A, B)."""
    if not spec:
        return None
    try:
        a_s, b_s = spec.split(":")
        a, b = int(a_s), int(b_s)
    except ValueError:
        raise ValueError(
            f"--profile-steps wants A:B (two ints, e.g. 10:20), got {spec!r}"
        ) from None
    if a < 0 or b <= a:
        raise ValueError(
            f"--profile-steps window must satisfy 0 <= A < B, got {spec!r}"
        )
    return a, b


class ProfilerOrchestrator:
    """Drives ``torch.profiler`` from the train loop.

    Call ``on_step_start(gstep)`` before dispatching a step and
    ``on_step_end(gstep, sync=...)`` after; ``trigger_anomaly(reason,
    step)`` from fault paths.  ``sync`` (a zero-arg callable) on the
    closing step lets the trace cover the device work it launched.
    """

    def __init__(
        self,
        log_dir: str | None,
        *,
        window: tuple[int, int] | None = None,
        anomaly_steps: int = 3,
        events=None,
        rank: int = 0,
    ):
        self.log_dir = log_dir
        self.rank = rank
        self.window = window
        self.anomaly_steps = anomaly_steps
        self.events = events
        self.active = False
        self._prof = None
        self._name = None
        self._anomaly_used = False
        self._stop_after: int | None = None

    @property
    def enabled(self) -> bool:
        return bool(self.log_dir)

    def _start(self, reason: str, step: int) -> None:
        if self.active or not self.enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        try:
            self._prof = _start_profile()
        # ddplint: allow[broad-except] — profiling is advisory, never fatal
        except Exception as exc:  # another profiler active, CUPTI refusal
            self._warn("profiler start failed (%s): %s", reason, exc)
            return
        self.active = True
        self._name = (reason.replace(":", "_"), step)
        if self.events is not None:
            self.events.emit(
                "profile_start", reason=reason, step=step, dir=self.log_dir
            )

    def _stop(self, step: int, sync=None) -> None:
        if not self.active:
            return
        reason, first = self._name
        path = os.path.join(self.log_dir, f"trace_{reason}_{first}-{step}_p{self.rank}.json")
        try:
            _stop_profile(self._prof, path, sync)
        # ddplint: allow[broad-except] — profiling is advisory, never fatal
        except Exception as exc:
            self._warn("profiler stop failed: %s", exc)
        self.active = False
        self._prof = None
        self._stop_after = None
        if self.events is not None:
            self.events.emit("profile_stop", step=step)

    def _warn(self, fmt, *args) -> None:
        from distributeddataparallel_tpu_torch.utils.logging import get_logger

        get_logger().warning("[profiler] " + fmt, *args)

    def on_step_start(self, gstep: int) -> None:
        if self.window and not self.active and gstep == self.window[0]:
            self._start("window", gstep)

    def on_step_end(self, gstep: int, sync=None) -> None:
        if not self.active:
            return
        if self.window and self._stop_after is None and gstep >= self.window[1] - 1:
            self._stop(gstep, sync=sync)
        elif self._stop_after is not None and gstep >= self._stop_after:
            self._stop(gstep, sync=sync)

    def trigger_anomaly(self, reason: str, step: int, *, immediate: bool = False):
        """First anomaly starts a short capture.  ``immediate=True``
        (the loop may never reach another step) stops the trace right
        away instead of letting it run ``anomaly_steps``."""
        if self._anomaly_used or not self.enabled or self.active:
            return
        self._anomaly_used = True
        self._start(f"anomaly:{reason}", step)
        if immediate:
            self._stop(step)
        else:
            self._stop_after = step + self.anomaly_steps

    def close(self, sync=None) -> None:
        self._stop(-1, sync=sync)
