"""Launcher: one process per local device, optionally supervised.

Counterpart of the spawn-and-supervise part of the JAX package's
``runtime/launcher.py``, with its resize rung and a join rung (not the
multi-host in-place absorption, ``_absorbed_resize``, which needs
hostgang's rank bindings: ROADMAP item 20b).  ``spawn(fn, args, nprocs)`` starts ``nprocs`` child processes through
the ``spawn`` start method (a fresh interpreter each: a forked CUDA context
is unusable, and this process never initialises CUDA) and calls
``fn(i, nprocs, store_address, *args)`` in child ``i``, after enabling an
inherited kernel build cache (``DDP_COMPILE_CACHE``,
``training.warm_start.enable_compile_cache``).  A gang of
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

``elastic_store`` (a ``runtime.rendezvous`` root) adds the resize rung
below the restart: when the dead gang's store shows tombstoned members (a
chaos ``worker-kill``, a peer's failure detector), the supervisor respawns
the gang at the surviving size (``DDP_ELASTIC_WORLD``) without spending the
restart budget, and records ``gang_resize`` and ``resize_downtime``; a
death with the roster intact takes the restart rung.  ``min_procs`` floors
the resize.

The join rung (``elastic_store``, supervised or not): while a gang runs,
the launcher watches the store's join requests (a chaos ``worker-join``,
``runtime.elastic_gang.ElasticGangCoordinator.rejoin``) and starts a
process for each requested member ``proc<R>`` as child ``R`` (the device
its member had) with ``DDP_ELASTIC_JOIN=proc<R>``, running the same
function with the same arguments and the inherited build cache; the
running gang takes it in place.  It spends no restart budget, and records
``gang_resize`` with ``joined`` (the ``gang_verdict`` then names the
``worker-join`` entry).  A failure while a join is open (the joiner's
own, or a survivor's that timed out waiting for it or broke off the state
transfer) is an error that ends the gang, never a silent restart of it.

``events_dir`` writes the supervisor's records (``restart_attempt``,
``restart_exhausted``, ``gang_resize``, ``resize_downtime``,
``gang_verdict`` naming the chaos fault behind it) to
``events-supervisor.jsonl``,
passes the directory to the workers as ``DDP_EVENTS_DIR``, and merges every
per-writer file into ``timeline.jsonl`` on exit; ``runs_dir`` appends the
run summary rebuilt from that timeline, which spans every incarnation and
the restart gaps, to the runs store (workers get ``DDP_RUNS_DIR``).
"""

from __future__ import annotations

import json
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
    if os.environ.get("DDP_COMPILE_CACHE"):
        # Inherit the parent's kernel build cache before the child's first
        # build: a supervised respawn then loads the kernels instead of
        # compiling them, whatever the worker function is.
        from distributeddataparallel_tpu_torch.training.warm_start import enable_compile_cache

        enable_compile_cache(os.environ["DDP_COMPILE_CACHE"])
    fn(i, nprocs, store_address, *args)


#: Seconds between the join rung's looks at the elastic store.
JOIN_POLL_S = 0.1


def _start(fn, args, nprocs, env, store_address, ranks=None) -> list:
    ctx = mp.get_context("spawn")
    procs = []
    for i in range(nprocs) if ranks is None else ranks:
        p = ctx.Process(target=_child, args=(fn, i, nprocs, store_address, dict(env or {}), tuple(args)))
        p.start()
        procs.append(p)
    return procs


def _run_gang(fn, args, nprocs, env, elastic_store: str | None = None, on_join=None) -> list[tuple[int, int]]:
    """Run one gang to its end; returns [(rank, exitcode)] of the members
    that failed.  Once one fails, the others are killed and not listed.
    The gang's store (a fresh one per gang: a restarted gang must not read
    the dead one's keys) lives until the gang has ended.  With
    ``elastic_store`` the join rung starts a process for every join request
    there (module docstring) and calls ``on_join(member)``.  A join is open
    from its request until its joiner has written its ``join-<member>``
    blob (after the state transfer); any failure while a join is open (the
    joiner's, or a survivor's that timed out waiting for it or broke off
    the transfer) raises ``RuntimeError`` once the gang is down."""
    store = (dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
             if nprocs > 1 or elastic_store else None)
    store_address = f"127.0.0.1:{store.port}" if store is not None else None
    procs = _start(fn, args, nprocs, env, store_address)
    live = {p.sentinel: (i, p) for i, p in enumerate(procs)}
    joins = None
    if elastic_store is not None:
        from distributeddataparallel_tpu_torch.runtime.elastic_gang import member_index
        from distributeddataparallel_tpu_torch.runtime.rendezvous import RendezvousStore

        joins = RendezvousStore(elastic_store)
    opened, failed = {}, []  # open joins: member -> the membership epoch when its process started

    def joined(member: str) -> bool:
        blob = joins.get_blob(f"join-{member}")
        return blob is not None and json.loads(blob)["epoch"] > opened[member]

    while live and not failed:
        for s in wait(list(live), timeout=JOIN_POLL_S if joins is not None else None):
            i, p = live.pop(s)
            p.join()
            if p.exitcode != 0:
                failed.append((i, p.exitcode))
        if joins is None:
            continue
        opened = {m: e for m, e in opened.items() if not joined(m)}
        for member, asked in ({} if failed else joins.join_requests()).items():
            joins.clear_join(member)
            opened[member] = joins.epoch()["epoch"]
            i = member_index(member)
            (p,) = _start(fn, args, nprocs, {**dict(env or {}), "DDP_ELASTIC_JOIN": member,
                                             "DDP_ELASTIC_JOIN_REQUESTED": repr(asked)}, store_address, [i])
            live[p.sentinel] = (i, p)
            get_logger().warning("[launcher] join request for %s: started a process for it (child %d)", member, i)
            if on_join is not None:
                on_join(member)
    for _, p in live.values():
        # SIGKILL, not SIGTERM: SIGTERM is the trainer's preemption signal,
        # which would have a survivor save mid-epoch state as a finished
        # epoch; and a survivor stuck in a collective acts on no signal.
        p.kill()
    for _, p in live.values():
        p.join()
    if failed and joins is not None:
        pending = sorted({m for m in opened if not joined(m)} | set(joins.join_requests()))
        if pending:
            raise RuntimeError(f"elastic join failed (rank, exitcode): {failed} while the join of {pending} was "
                               f"open — the gang is not restarted for a failed join")
    return failed


def _last_fault(elastic_store: str | None) -> dict | None:
    """The newest chaos breadcrumb in the store's ``faults.jsonl`` (the
    injectors' ``fault_log``), or None: the fault a ``gang_verdict``
    names."""
    if not elastic_store:
        return None
    last = None
    try:
        with open(os.path.join(elastic_store, "faults.jsonl")) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    last = rec
    except OSError:
        return None
    return last


def _elastic_survivors(elastic_store: str):
    """``(store, epoch, roster, survivors)`` of an elastic rendezvous store,
    or None before its first epoch.  Survivorship is decided by tombstones
    only: when a gang has just died every heartbeat still looks fresh, and
    the tombstone is what tells a member removed from the gang from one
    whose process merely went down with the rest."""
    from distributeddataparallel_tpu_torch.runtime.rendezvous import RendezvousStore

    store = RendezvousStore(elastic_store)
    cur = store.epoch()
    if cur["epoch"] < 0:
        return None
    dead = set(store.dead())
    roster = list(cur["roster"])
    return store, cur["epoch"], roster, [m for m in roster if m not in dead]


def spawn(
    fn: Callable[..., Any],
    args: Sequence[Any] = (),
    nprocs: int = 1,
    join: bool = True,
    *,
    env: dict[str, str] | None = None,
    max_restarts: int = 0,
    events_dir: str | None = None,
    runs_dir: str | None = None,
    elastic_store: str | None = None,
    min_procs: int = 1,
):
    """Run ``fn(i, nprocs, store_address, *args)`` for i in range(nprocs), each
    in a child process, and wait for all; raise ``RuntimeError`` naming the
    failed members when one fails (after ``max_restarts`` restarts of the
    whole gang).  ``join=False`` starts the gang and returns its processes
    at once, with no rendezvous store (``store_address`` None: members that
    form no process group, as the serving fleet's engine workers); the
    caller joins them.  ``elastic_store`` / ``min_procs``: the resize rung
    (module docstring)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    if not join:
        if max_restarts:
            raise ValueError("max_restarts needs join=True: supervision is a blocking "
                             "join-and-respawn loop, there is no handle to return")
        return _start(fn, args, nprocs, env, None)
    if max_restarts == 0:
        failed = _run_gang(fn, args, nprocs, env, elastic_store)
        if failed:
            raise RuntimeError(f"spawned processes failed (rank, exitcode): {failed}")
        return

    sup_events = None
    if events_dir:
        from distributeddataparallel_tpu_torch.observability.events import EventLog

        sup_events = EventLog(os.path.join(events_dir, "events-supervisor.jsonl"), "supervisor")
    def verdict(rung: str, **detail) -> None:
        """The run's terminal record: the rung it ended on, and the chaos
        fault that led there (None for an organic failure)."""
        if sup_events is not None:
            fault = _last_fault(elastic_store) or {}
            sup_events.emit("gang_verdict", rung=rung, fault=fault.get("entry"), fault_kind=fault.get("kind"),
                            **detail)

    joins = 0

    def joined(member: str) -> None:
        nonlocal joins
        joins += 1
        if sup_events is not None:
            from distributeddataparallel_tpu_torch.runtime.rendezvous import RendezvousStore

            rdzv = RendezvousStore(elastic_store)
            sup_events.emit("gang_resize", epoch=rdzv.epoch()["epoch"] + 1, old_size=len(rdzv.roster()),
                            new_size=len(rdzv.roster()) + 1, left=[], joined=[member])

    try:
        attempt = resizes = 0
        world = nprocs
        while True:
            gang_env = dict(env or {})
            # The worker reads its incarnation (FaultCounters.restarts, its
            # run_start record) from here.
            gang_env["DDP_RESTART_ATTEMPT"] = str(attempt)
            # This incarnation's start: a chaos entry one of its ranks fired
            # before it (``utils.chaos``) has fired for every rank.
            gang_env["DDP_GANG_START"] = repr(time.time())
            if world != nprocs:
                gang_env["DDP_ELASTIC_WORLD"] = str(world)
            if events_dir:
                gang_env.setdefault("DDP_EVENTS_DIR", events_dir)
            if runs_dir:
                gang_env.setdefault("DDP_RUNS_DIR", runs_dir)
            failed = _run_gang(fn, args, world, gang_env, elastic_store, joined)
            if not failed:
                if attempt > 0:
                    verdict("restart", attempts=attempt)
                elif resizes > 0 or joins > 0 or _last_fault(elastic_store) is not None:
                    verdict("resize", respawns=resizes, joins=joins)
                return
            t_died = time.perf_counter()
            info = _elastic_survivors(elastic_store) if elastic_store is not None else None
            if info is not None:
                store, epoch, roster, survivors = info
                if set(survivors) != set(roster) and len(survivors) >= max(min_procs, 1):
                    # The resize rung: the gang lost members before it
                    # died, so it comes back at the surviving size.  The
                    # whole old roster is tombstoned first (every heartbeat
                    # is a ghost now); the respawned members join again and
                    # propose the next epoch over those that came back.
                    world, resizes = len(survivors), resizes + 1
                    for m in roster:
                        store.leave(m)
                    if sup_events is not None:
                        sup_events.emit("gang_resize", epoch=epoch + 1, old_size=len(roster),
                                        new_size=len(survivors), left=sorted(set(roster) - set(survivors)))
                        sup_events.emit("resize_downtime", epoch=epoch + 1,
                                        seconds=round(time.perf_counter() - t_died, 3))
                    get_logger().warning("[supervisor] gang died with a shrunk roster (%d -> %d members) — "
                                         "elastic resize-respawn, restart budget untouched (%d/%d used)",
                                         len(roster), len(survivors), attempt, max_restarts)
                    continue
            if attempt >= max_restarts:
                if sup_events is not None:
                    sup_events.emit("restart_exhausted", attempt=attempt, failed=failed,
                                    max_restarts=max_restarts)
                verdict("fail", attempts=attempt, failed=failed, max_restarts=max_restarts)
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
