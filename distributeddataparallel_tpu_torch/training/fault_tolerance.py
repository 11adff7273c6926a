"""Fault tolerance: retrying, verified checkpoint IO, the step watchdog and
the non-finite-gradient circuit breaker.

Counterpart of the JAX package's ``training/fault_tolerance.py``
(``utils.chaos`` is the injection half that proves these work):

- ``ResilientCheckpointer``: the trainer's checkpointer, on
  ``training.checkpoint.CheckpointFiles``: every save wrapped in bounded
  retry (exponential backoff with jitter) and a check that the file
  landed, and a restore that quarantines a corrupt or unreadable
  checkpoint and falls back to the newest intact one, down to a fresh
  start;
- ``StepWatchdog``: a wall-clock deadline on the train loop's heartbeats.
  A wedged step stops them; the watchdog logs a diagnostic with the loop's
  last-known state, runs a best-effort checkpoint hook and exits with 75
  (EX_TEMPFAIL) instead of hanging, so supervision restarts the worker;
- ``NonFiniteBreaker``: the host half of the train step's
  ``nonfinite_guard``: it counts consecutive skipped steps and stops the
  run once it is diverging rather than glitching.

With ``runtime.launcher.spawn(max_restarts=...)`` these close the loop:
crash, supervised restart, resume from the newest intact checkpoint.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable

from distributeddataparallel_tpu_torch.runtime.distributed import agree, broadcast_object, get_rank
from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles
from distributeddataparallel_tpu_torch.training.state import TrainState
from distributeddataparallel_tpu_torch.utils.logging import warn_all

#: EX_TEMPFAIL: the watchdog's exit code, "transient failure, retry me";
#: distinct from ordinary crashes, restarted by supervision like them.
WATCHDOG_EXIT_CODE = 75
#: Seconds the watchdog's checkpoint hook may take before the exit is forced.
WATCHDOG_GRACE_S = 30.0
#: RetryPolicy's backoff: the first delay, its cap, and the jitter's share.
RETRY_BACKOFF_S, RETRY_MAX_BACKOFF_S, RETRY_JITTER = 0.5, 8.0, 0.25


class TrainingDiverged(RuntimeError):
    """Raised by NonFiniteBreaker: too many consecutive non-finite-gradient
    steps; the run is not glitching, it is diverging."""


class CheckpointUnrecoverable(IOError):
    """A checkpoint save exhausted its retry budget."""


class RetryPolicy:
    """Bounded exponential backoff with jitter for checkpoint IO.

    ``retries`` is the number of RE-tries after the first attempt (so
    ``retries=3`` means at most 4 attempts).  The backoff for attempt k is
    ``min(RETRY_BACKOFF_S * 2**k, RETRY_MAX_BACKOFF_S) * (1 + RETRY_JITTER * u)``
    with ``u ~ U[0, 1)`` drawn from ``seed``: the jitter decorrelates retry
    storms when many hosts hit the same flaky filesystem at once.
    """

    def __init__(self, retries: int = 3, *, seed: int | None = None):
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        self.retries = retries
        self._rng = random.Random(seed)

    def sleep(self, attempt: int) -> float:
        t = min(RETRY_BACKOFF_S * (2 ** attempt), RETRY_MAX_BACKOFF_S)
        t *= 1.0 + RETRY_JITTER * self._rng.random()
        time.sleep(t)
        return t


class ResilientCheckpointer(CheckpointFiles):
    """The trainer's checkpointer, whose IO survives transient failure and
    corruption.

    Rank 0 writes each save inside the retry scope and checks that the
    checkpoint and its hash sidecar landed; then every rank agrees on the
    outcome in one all-reduce (epoch cadence, off the step path), so a save
    that exhausted its budget raises ``CheckpointUnrecoverable`` on every
    rank instead of leaving the others waiting.  ``injector`` (a
    ``utils.chaos.FaultInjector``) is consulted inside the retry scope, so
    chaos runs take the real retry path; ``counters``
    (``utils.metrics.FaultCounters``) and ``events`` (an ``EventLog``) make
    retries and fallbacks visible.
    """

    def __init__(self, directory: str, *, max_to_keep: int = 3, injector=None, counters=None,
                 events=None):
        super().__init__(directory, max_to_keep=max_to_keep)
        self._policy = RetryPolicy()
        self._injector = injector
        self._counters = counters
        self._events = events
        self._saves = 0

    # -- save: bounded retry + verification ----------------------------
    def save(self, state: TrainState, epoch: int) -> None:
        """Write ``state`` as the checkpoint of ``epoch`` (rank 0, retried);
        raises ``CheckpointUnrecoverable`` on every rank once the budget is
        spent."""
        ordinal = self._saves
        self._saves += 1
        err = self._write_with_retry(state, epoch, ordinal) if get_rank() == 0 else None
        if not agree(err is None):
            raise CheckpointUnrecoverable(
                f"checkpoint save for epoch {epoch} failed after {self._policy.retries + 1} attempts"
            ) from err

    def _write_with_retry(self, state: TrainState, epoch: int, ordinal: int) -> Exception | None:
        """Rank 0's save attempts; returns the last error, or None once one
        attempt landed."""
        err = None
        for attempt in range(self._policy.retries + 1):
            try:
                if self._injector is not None:
                    self._injector.fail_io(ordinal, attempt)
                self.write(state, epoch)
                self._verify_saved(epoch)
                if self._events is not None:
                    self._events.emit("ckpt_save", epoch=epoch, attempts=attempt + 1)
                return None
            except Exception as e:  # noqa: BLE001 — the retrying IO boundary
                err = e
                if attempt >= self._policy.retries:
                    break
                if self._counters is not None:
                    self._counters.io_retries += 1
                if self._events is not None:
                    self._events.emit("ckpt_retry", epoch=epoch, attempt=attempt, error=str(e))
                slept = self._policy.sleep(attempt)
                warn_all("checkpoint save (epoch %d) attempt %d failed: %s — retrying after "
                         "%.2fs backoff", epoch, attempt, e, slept)
        return err

    def _verify_saved(self, epoch: int) -> None:
        """The write landed: the checkpoint is listed under its name, not
        empty, and its hash sidecar is beside it."""
        path = self._path(epoch)
        if epoch not in self.all_steps() or os.path.getsize(path) == 0 \
                or not os.path.exists(self._hash_path(epoch)):
            raise CheckpointUnrecoverable(
                f"epoch {epoch}'s checkpoint or its hash sidecar is missing after the save")

    # -- restore: corrupt-checkpoint fallback --------------------------
    def restore_latest(self, state: TrainState) -> tuple[TrainState, int]:
        """Load the newest intact checkpoint into ``state`` in place;
        returns ``(state, next_epoch)``, or ``(state, 0)`` when there is
        none.  A checkpoint that fails to load or to verify is quarantined
        (renamed ``*.corrupt``, kept for post-mortem) and the next newest
        one is tried, down to a fresh start when nothing intact remains.  Rank 0 decides and tells the
        others which epoch to load, so no two ranks quarantine the same
        file or resume at different epochs."""
        payload = None
        if get_rank() == 0:
            while (epoch := self.latest_step()) is not None:
                try:
                    payload = self.read(epoch)
                    break
                except Exception as e:  # noqa: BLE001 — the corrupt-checkpoint boundary
                    if self._counters is not None:
                        self._counters.ckpt_fallbacks += 1
                    if self._events is not None:
                        self._events.emit("ckpt_fallback", step=epoch, error=str(e))
                    warn_all("checkpoint epoch %d is corrupt or unreadable (%s: %s) — "
                             "quarantining it and falling back to the previous epoch",
                             epoch, type(e).__name__, e)
                    self._quarantine(epoch)
        else:
            epoch = None
        epoch = broadcast_object(epoch)
        if epoch is None:
            return state, 0
        if payload is None:
            payload = self.read(epoch)
        return state, self.load_into(state, payload)

    def _quarantine(self, epoch: int) -> None:
        """Move the bad checkpoint and its sidecar aside (``*.corrupt``):
        deleting them would destroy the evidence."""
        for path in (self._path(epoch), self._hash_path(epoch)):
            if os.path.exists(path):
                dst = path + ".corrupt"
                if os.path.exists(dst):  # quarantined twice: make it unique
                    dst = f"{dst}.{int(time.time() * 1e3)}"
                os.replace(path, dst)


class StepWatchdog:
    """Wall-clock deadline on train-loop heartbeats.

    It guards against the worst failure a multi-device run has: a wedged
    collective (a peer gone mid all-reduce) that hangs the step forever
    with no exception to catch.  The loop calls ``beat()`` once a step;
    when the heartbeats stop for ``timeout_s``, the monitor thread

    1. logs a diagnostic with the last-known loop state (the kwargs of the
       final ``beat``), the seconds since that beat, and the devices
       captured at ``start()`` (querying a wedged runtime from the watchdog
       thread could itself hang);
    2. runs ``on_timeout(diagnostic)``: the trainer wires a best-effort
       checkpoint of the last COMPLETED state here;
    3. exits the process with ``WATCHDOG_EXIT_CODE`` (75), so supervision
       restarts the worker; a ``WATCHDOG_GRACE_S`` timer guarantees the exit
       even if the checkpoint attempt itself wedges.

    ``exit_process=False`` (tests, library embedding) skips step 3 and
    records the diagnostic in ``self.fired``.

    Arm it AFTER the first completed step: the first step builds and loads
    the kernels and would need a meaninglessly long deadline.
    """

    def __init__(self, timeout_s: float, *, on_timeout: Callable[[dict], None] | None = None,
                 exit_process: bool = True):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self.exit_process = exit_process
        self._poll_s = min(timeout_s / 4.0, 1.0)
        self.fired: dict | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_beat: float | None = None
        self._context: dict = {}
        self._devices: list[str] = []

    def start(self, **context) -> "StepWatchdog":
        if self._thread is not None:
            return self
        self._devices = _device_roster()
        with self._lock:
            self._last_beat = time.monotonic()
            self._context = dict(context)
        self._thread = threading.Thread(target=self._run, name="step-watchdog", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None

    def beat(self, **context) -> None:
        """Heartbeat: the loop is alive.  ``context`` kwargs (epoch, batch,
        ...) become the diagnostic's last-known state."""
        with self._lock:
            self._last_beat = time.monotonic()
            if context:
                self._context = dict(context)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                last = self._last_beat
                ctx = dict(self._context)
            if last is None:
                continue
            stalled = time.monotonic() - last
            if stalled > self.timeout_s:
                self._fire(stalled, ctx)
                return

    def _fire(self, stalled_s: float, ctx: dict) -> None:
        diag = {
            "seconds_since_heartbeat": round(stalled_s, 3),
            "timeout_s": self.timeout_s,
            "last_known_state": ctx,
            "devices": self._devices,
        }
        self.fired = diag
        warn_all("step watchdog: no heartbeat for %.1fs (deadline %.1fs) — last-known state %s on "
                 "devices %s; forcing checkpoint-then-exit rather than hanging",
                 stalled_s, self.timeout_s, ctx, self._devices)
        if self.exit_process:
            # The exit must not depend on the checkpoint attempt
            # cooperating: a wedged runtime can hang a save forever.
            killer = threading.Timer(WATCHDOG_GRACE_S, os._exit, args=(WATCHDOG_EXIT_CODE,))
            killer.daemon = True
            killer.start()
        try:
            if self.on_timeout is not None:
                self.on_timeout(diag)
        finally:
            if self.exit_process:
                os._exit(WATCHDOG_EXIT_CODE)


def _device_roster() -> list[str]:
    """This process's devices, for the watchdog's diagnostic."""
    import torch

    if not torch.cuda.is_available():
        return ["cpu"]
    return [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]


class NonFiniteBreaker:
    """Consecutive-bad-step circuit breaker for the non-finite-gradient guard.

    The step (``make_train_step(nonfinite_guard=True)``) skips a bad step's
    update and reports ``metrics['nonfinite_grad']``; this host-side
    breaker turns a RUN of them into a hard stop: an isolated overflow is
    weather, N in a row is divergence, and skipping forever would burn GPU
    time on a run that is already dead.
    """

    def __init__(self, max_consecutive: int = 5):
        if max_consecutive < 1:
            raise ValueError(f"max_consecutive must be >= 1, got {max_consecutive}")
        self.max_consecutive = max_consecutive
        self.consecutive = 0
        self.total = 0

    def observe(self, nonfinite) -> int:
        """Feed one step's ``metrics['nonfinite_grad']`` (0/1; anything
        float-able).  Returns the current consecutive count; raises
        TrainingDiverged at the threshold."""
        if float(nonfinite) > 0:
            self.consecutive += 1
            self.total += 1
            if self.consecutive >= self.max_consecutive:
                raise TrainingDiverged(
                    f"{self.consecutive} consecutive non-finite-gradient steps (threshold "
                    f"{self.max_consecutive}): the run is diverging — lower the LR / raise "
                    "warmup / check the data pipeline, then resume from the last checkpoint"
                )
        else:
            self.consecutive = 0
        return self.consecutive
