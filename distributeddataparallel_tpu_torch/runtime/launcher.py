"""Launcher: one process per local device, optionally supervised.

Counterpart of the spawn-and-supervise part of the JAX package's
``runtime/launcher.py`` (without the elastic resize, ROADMAP items 13 and
20).  ``spawn(fn, args, nprocs)`` starts ``nprocs`` child processes through
the ``spawn`` start method (a fresh interpreter each: a forked CUDA context
is unusable, and this process never initialises CUDA) and calls
``fn(i, nprocs, store_address, *args)`` in child ``i``.  A gang of
several forms its process group on a ``TCPStore`` that this process binds
to a port the kernel picks (``127.0.0.1:<port>``, ``store_address``) and
holds while the gang runs, a fresh one per gang; a gang of one needs no
rendezvous (``store_address`` None).  No port is probed free and bound
later, so none can be taken in between.

With ``max_restarts > 0`` it SUPERVISES, with torchrun's
``--max-restarts`` semantics: when any member exits non-zero (a crash, a
chaos preemption, the step watchdog's exit 75), the rest of the gang is
killed (under NCCL a survivor of a dead rank hangs in its next collective,
so waiting on it would never return) and the whole gang is started again
with a fresh store and ``DDP_RESTART_ATTEMPT`` set to the attempt, after a
linear backoff (``RESTART_BACKOFF_S`` times the attempt), up to the
budget; then it raises.  The worker owns resume
correctness: it restores from its newest checkpoint on start-up
(``--resume``).

``events_dir`` writes the supervisor's records (``restart_attempt``,
``restart_exhausted``, ``gang_verdict``) to ``events-supervisor.jsonl``,
passes the directory to the workers as ``DDP_EVENTS_DIR``, and merges every
per-writer file into ``timeline.jsonl`` on exit; ``runs_dir`` appends the
run summary rebuilt from that timeline, which spans every incarnation and
the restart gaps, to the runs store (workers get ``DDP_RUNS_DIR``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from multiprocessing.connection import wait
from typing import Any, Callable, Sequence

import torch.distributed as dist

from distributeddataparallel_tpu_torch.utils.logging import get_logger

#: Seconds before restart k (k = 1, 2, ...) are ``RESTART_BACKOFF_S * k``.
RESTART_BACKOFF_S = 1.0


def _child(fn, i, nprocs, store_address, env, args):
    os.environ.update(env)
    fn(i, nprocs, store_address, *args)


def _run_gang(fn, args, nprocs, env) -> list[tuple[int, int]]:
    """Run one gang to its end; returns [(rank, exitcode)] of the members
    that failed.  Once one fails, the others are killed and not listed.
    The gang's store (a fresh one per gang: a restarted gang must not read
    the dead one's keys) lives until the gang has ended."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False) if nprocs > 1 else None
    store_address = f"127.0.0.1:{store.port}" if store is not None else None
    ctx = mp.get_context("spawn")
    procs = []
    for i in range(nprocs):
        p = ctx.Process(target=_child, args=(fn, i, nprocs, store_address, dict(env or {}), tuple(args)))
        p.start()
        procs.append(p)
    live = {p.sentinel: (i, p) for i, p in enumerate(procs)}
    failed = []
    while live and not failed:
        for s in wait(list(live)):
            i, p = live.pop(s)
            p.join()
            if p.exitcode != 0:
                failed.append((i, p.exitcode))
    for _, p in live.values():
        # SIGKILL, not SIGTERM: SIGTERM is the trainer's preemption signal,
        # which would have a survivor save mid-epoch state as a finished
        # epoch; and a survivor stuck in a collective acts on no signal.
        p.kill()
    for _, p in live.values():
        p.join()
    return failed


def spawn(
    fn: Callable[..., Any],
    args: Sequence[Any] = (),
    nprocs: int = 1,
    *,
    env: dict[str, str] | None = None,
    max_restarts: int = 0,
    events_dir: str | None = None,
    runs_dir: str | None = None,
) -> None:
    """Run ``fn(i, nprocs, store_address, *args)`` for i in range(nprocs), each
    in a child process, and wait for all; raise ``RuntimeError`` naming the
    failed members when one fails (after ``max_restarts`` restarts of the
    whole gang)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    if max_restarts == 0:
        failed = _run_gang(fn, args, nprocs, env)
        if failed:
            raise RuntimeError(f"spawned processes failed (rank, exitcode): {failed}")
        return

    sup_events = None
    if events_dir:
        from distributeddataparallel_tpu_torch.observability.events import EventLog

        sup_events = EventLog(os.path.join(events_dir, "events-supervisor.jsonl"), "supervisor")
    try:
        attempt = 0
        while True:
            gang_env = dict(env or {})
            # The worker reads its incarnation (FaultCounters.restarts, its
            # run_start record) from here.
            gang_env["DDP_RESTART_ATTEMPT"] = str(attempt)
            if events_dir:
                gang_env.setdefault("DDP_EVENTS_DIR", events_dir)
            if runs_dir:
                gang_env.setdefault("DDP_RUNS_DIR", runs_dir)
            failed = _run_gang(fn, args, nprocs, gang_env)
            if not failed:
                if attempt > 0 and sup_events is not None:
                    # The run's terminal record: which rung it ended on.
                    sup_events.emit("gang_verdict", rung="restart", fault=None, fault_kind=None,
                                    attempts=attempt)
                return
            if attempt >= max_restarts:
                if sup_events is not None:
                    sup_events.emit("restart_exhausted", attempt=attempt, failed=failed,
                                    max_restarts=max_restarts)
                    sup_events.emit("gang_verdict", rung="fail", fault=None, fault_kind=None,
                                    attempts=attempt, failed=failed, max_restarts=max_restarts)
                raise RuntimeError(
                    f"spawned processes failed (rank, exitcode): {failed} "
                    f"— restart budget of {max_restarts} exhausted"
                )
            if sup_events is not None:
                sup_events.emit("restart_attempt", attempt=attempt + 1, failed=failed,
                                max_restarts=max_restarts)
            get_logger().warning("[supervisor] gang failed (rank, exitcode): %s — restart %d/%d "
                                 "after %.1fs", failed, attempt + 1, max_restarts,
                                 RESTART_BACKOFF_S * (attempt + 1))
            time.sleep(RESTART_BACKOFF_S * (attempt + 1))
            attempt += 1
    finally:
        if sup_events is not None:
            sup_events.close()
        if events_dir:
            _merge(events_dir, runs_dir)


def _merge(events_dir: str, runs_dir: str | None) -> None:
    """The gang timeline and, with ``runs_dir``, the supervisor's run
    record.  Best-effort: this runs while a restart-exhausted error may be
    propagating, and a merge failure must not mask it."""
    from distributeddataparallel_tpu_torch.observability import baseline
    from distributeddataparallel_tpu_torch.observability.events import load_timeline, merge_timeline

    try:
        if merge_timeline(events_dir) is None:
            get_logger().warning("[supervisor] no event files to merge in %s (gang died before "
                                 "writing any?)", events_dir)
        elif runs_dir:
            baseline.append_run(runs_dir, baseline.run_summary_from_timeline(load_timeline(events_dir)),
                                source="supervisor")
    except OSError as exc:
        get_logger().warning("[supervisor] timeline merge failed in %s: %s", events_dir, exc)
