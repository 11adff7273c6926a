"""Deterministic fault injection: the chaos harness behind ``--chaos``.

The port's copy of the JAX package's ``utils/chaos.py``.  It injects the
faults a real run produces (checkpoint-IO errors, slow or hung steps,
non-finite gradients, worker preemption) at chosen, reproducible points, so
that every recovery path in ``training.fault_tolerance`` and the
supervisor is exercised:

    DDP_CHAOS="ckpt-io@0,nan-grad@3,slow-step@5:2.5,preempt@12" \\
        python -m distributeddataparallel_tpu_torch.dpp ...
    python -m distributeddataparallel_tpu_torch.dpp --chaos "preempt@12" --max-restarts 2 ...

Spec grammar (comma-separated entries, all steps 0-based)::

    ckpt-io@N[:K]      fail the N-th checkpoint *save call*'s first K
                       attempts (default 1) with an injected IOError: the
                       bounded-retry path
    nan-grad@S         poison the step-S batch with a NaN so the gradients
                       go non-finite: the skip-step guard (float batches
                       only)
    slow-step@S[:SEC]  sleep SEC seconds (default 30) before step S: the
                       step watchdog
    preempt@S          raise SimulatedPreemption before step S: under
                       supervision (``--max-restarts``) the worker dies and
                       resumes from the last checkpoint
    worker-kill@S[:R]  mark gang member R (default 1) dead in the elastic
                       rendezvous store at step S: with ``--elastic`` the
                       gang resizes in place around it after step S (or,
                       killed together with a ``preempt``, the supervisor
                       respawns it at the surviving size); without a gang
                       coordinator the entry warns and does nothing.  The
                       tombstone is written after step S (``after_step``),
                       behind the injector's ``sync`` (``dpp``: a drain and
                       a barrier of the gang, on every rank, since each
                       fires the same entry), so every rank, one process
                       each, sees it at the same step boundary: a rank
                       whose host runs ahead (``--dispatch-depth``) cannot
                       show it to one still polling after S - 1
    worker-join@S[:R]  take gang member R (default 1), killed or evicted
                       earlier, back before step S: the gang's ``rejoin``
                       writes a join request into the elastic store after
                       the injector's ``sync``, the launcher starts a new
                       process for R, and the survivors wait at that
                       boundary for it and grow in place (``dpp``);
                       without a gang coordinator the entry warns and
                       does nothing
    bitflip@S[:R][:leaf]
                       XOR one low mantissa bit of one parameter leaf on
                       data rank R (default 1) before step S
                       (``corrupt_state``, ``training.integrity.
                       apply_bitflip``): a silent device-memory bit flip
                       whose values stay finite, so only the replica
                       digest (``--integrity-every``) can catch it.
                       ``leaf`` selects the first leaf whose reference
                       name contains it (default: the first leaf)

The parser also accepts the reference's multi-host gang kinds
(``host-kill``, ``proposer-kill``, ``rdzv-kill``, ``slow-heartbeat``,
``partition``, ``torn-epoch``), with the reference's argument rules.  Their
runtime (``runtime/hostgang.py``) is not ported (``NOT_PORTED`` names its
ROADMAP item), and an injector refuses them rather than skipping them.

With ``fault_log`` (or ``DDP_FAULT_LOG``) every entry that fires is
appended to a JSONL breadcrumb file, from which the supervisor names the
fault behind its ``gang_verdict``.

Determinism across restarts: with a ``state_dir``, each entry fires AT MOST
ONCE across process restarts: a marker file records the firing, so a
restarted worker does not hit the same preemption again and crash-loop.
Without a state dir, entries fire once per process.  With one state dir a
rank (``<dir>/rank{r}``) each rank fires each entry once, and under a
supervisor (``DDP_GANG_START``, the wall-clock start of this incarnation of
the gang) an entry another rank fired in an earlier incarnation counts as
fired too: a rank killed before it reached the entry, or renumbered by a
resize-respawn, does not fire it again.

Import-light (no torch at module import): the supervisor parses specs.
"""

from __future__ import annotations

import os
import time

__all__ = [
    "FaultInjector",
    "InjectedIOError",
    "KINDS",
    "NOT_PORTED",
    "SimulatedPreemption",
    "check_ported",
    "parse_chaos_spec",
]

KINDS = (
    "ckpt-io", "nan-grad", "slow-step", "preempt", "worker-kill", "bitflip",
    "worker-join", "host-kill", "proposer-kill", "rdzv-kill",
    "slow-heartbeat", "partition", "torn-epoch",
)

_GANG = ("ROADMAP.md Queue 1 item 20b: runtime/hostgang.py and the multi-host "
         "gang chaos kinds")
#: Kinds the parser accepts but this port cannot inject yet, each with the
#: ROADMAP item that ports its runtime.
NOT_PORTED = {k: _GANG for k in ("host-kill", "proposer-kill", "rdzv-kill", "slow-heartbeat", "partition",
                                 "torn-epoch")}


class SimulatedPreemption(RuntimeError):
    """An injected worker death: the chaos analog of a preemption that
    delivers no graceful SIGTERM (the host just goes away)."""


class InjectedIOError(IOError):
    """An injected transient checkpoint-IO failure."""


class _Entry:
    __slots__ = ("kind", "step", "arg", "key")

    def __init__(self, kind: str, step: int, arg: str | None):
        self.kind = kind
        self.step = step
        self.arg = arg
        # Stable identity for once-markers: the spec text itself.
        self.key = f"{kind}@{step}" + (f":{arg}" if arg is not None else "")

    def __repr__(self) -> str:
        return self.key


def parse_chaos_spec(spec: str) -> list[_Entry]:
    """Parse ``kind@step[:arg]`` entries; raises ValueError with the grammar
    on any malformed entry (a SystemExit at CLI parse time, not a crash
    mid-run)."""
    entries: list[_Entry] = []
    for raw in (spec or "").split(","):
        raw = raw.strip()
        if not raw:
            continue
        kind, sep, rest = raw.partition("@")
        step_s, _, arg = rest.partition(":")
        try:
            if kind not in KINDS or not sep:
                raise ValueError
            step = int(step_s)
            if step < 0:
                raise ValueError
            if arg:
                # Validate eagerly: a typo'd argument must fail at parse,
                # not at fire time deep into a run.
                if kind == "slow-step":
                    float(arg)
                elif kind == "bitflip":
                    # R or R:leaf: the rank a non-negative int, the leaf
                    # selector free-form.
                    rank_s, _, _leaf = arg.partition(":")
                    if int(rank_s) < 0:
                        raise ValueError
                elif kind == "slow-heartbeat":
                    # SEC or SEC:R
                    sec_s, _, rank_s = arg.partition(":")
                    float(sec_s)
                    if rank_s and int(rank_s) < 0:
                        raise ValueError
                else:
                    int(arg)
            elif kind in ("slow-step", "ckpt-io"):
                arg = ""
            if kind in ("nan-grad", "preempt", "proposer-kill", "rdzv-kill", "torn-epoch") and arg:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad chaos entry {raw!r}: expected one of "
                "ckpt-io@N[:K] | nan-grad@S | slow-step@S[:SECONDS] | "
                "preempt@S | worker-kill@S[:RANK] | worker-join@S[:RANK] | "
                "bitflip@S[:R][:leaf] | host-kill@S[:RANK] | "
                "proposer-kill@S | rdzv-kill@S | "
                "slow-heartbeat@S[:SEC[:RANK]] | partition@S[:RANK] | "
                "torn-epoch@S (comma-separated)"
            ) from None
        entries.append(_Entry(kind, step, arg or None))
    return entries


def check_ported(entries: list[_Entry]) -> None:
    """Raise NotImplementedError naming the ROADMAP item of the first entry
    whose kind this port cannot inject."""
    for e in entries:
        if e.kind in NOT_PORTED:
            raise NotImplementedError(
                f"chaos entry {e.key!r}: {e.kind} is not ported yet ({NOT_PORTED[e.kind]})")


class FaultInjector:
    """Env/CLI-configurable deterministic fault injector.

    ``spec`` is the chaos grammar above; ``state_dir`` (optional) makes each
    entry fire at most once ACROSS restarts via marker files.  An empty spec
    gives a disabled injector whose hooks are all no-ops.  ``events`` (an
    ``observability.EventLog``) receives a ``chaos_inject`` record for every
    injection that fires.
    """

    def __init__(self, spec: str = "", state_dir: str | None = None, events=None):
        self._entries = parse_chaos_spec(spec)
        check_ported(self._entries)
        self._state_dir = state_dir
        self.events = events
        # The elastic gang coordinator (``runtime.elastic_gang``) a
        # worker-kill tombstones a member through, and the chaos rank ->
        # member name map; ``dpp`` wires both under ``--elastic``.
        self.gang = None
        self.hosts: dict[str, str] = {}
        self.fault_log = os.environ.get("DDP_FAULT_LOG") or None
        self._kills: list[str] = []  # members to tombstone after the step
        #: members a worker-join of this step takes back (``dpp`` grows the
        #: gang before the step and empties it)
        self.joins: list[str] = []
        # Called on every rank before a worker-kill's tombstones or a
        # worker-join's request are written: ``dpp`` sets it to a drain and
        # a barrier of the gang.
        self.sync = None
        self._fired_local: set[str] = set()
        # Entries this PROCESS started firing (a multi-attempt ckpt-io entry
        # keeps failing attempts here after its cross-restart marker is
        # written).
        self._owned: set[str] = set()
        if self._entries and state_dir:
            os.makedirs(state_dir, exist_ok=True)

    @classmethod
    def from_env(cls) -> "FaultInjector":
        return cls(os.environ.get("DDP_CHAOS", ""), os.environ.get("DDP_CHAOS_STATE") or None)

    @property
    def enabled(self) -> bool:
        return bool(self._entries)

    # -- once-semantics ------------------------------------------------
    def _marker(self, key: str) -> str | None:
        if self._state_dir is None:
            return None
        return os.path.join(self._state_dir, key.replace("@", "_at_").replace(":", "_"))

    def _already_fired(self, key: str) -> bool:
        if key in self._fired_local:
            return True
        m = self._marker(key)
        if m is None:
            return False
        if os.path.exists(m):
            return True
        start = os.environ.get("DDP_GANG_START")
        parent, me = os.path.split(self._state_dir)
        if not start or not me.startswith("rank"):
            return False
        for sib in os.listdir(parent):
            other = os.path.join(parent, sib, os.path.basename(m))
            try:
                if sib.startswith("rank") and os.path.getmtime(other) < float(start):
                    return True
            except OSError:
                continue
        return False

    def _mark(self, key: str) -> None:
        self._fired_local.add(key)
        m = self._marker(key)
        if m is not None:
            with open(m, "w") as fh:
                fh.write(str(time.time()))

    def _take(self, kind: str, step: int) -> _Entry | None:
        """The unfired entry of ``kind`` scheduled for ``step``, marked
        fired BEFORE the fault takes effect (a preemption must not recur
        after the supervisor restarts the worker)."""
        for e in self._entries:
            if e.kind == kind and e.step == step and not self._already_fired(e.key):
                self._mark(e.key)
                self._breadcrumb(e, step)
                if self.events is not None:
                    self.events.emit("chaos_inject", entry=e.key, step=step)
                return e
        return None

    def fast_forward(self, step: int) -> None:
        """Count as fired, without a record, every entry before ``step``
        and a ``worker-join`` at it: a process that joins the gang at the
        boundary of ``step`` continues the survivors' schedule there."""
        for e in self._entries:
            if e.kind != "ckpt-io" and (e.step < step or (e.step == step and e.kind == "worker-join")):
                self._fired_local.add(e.key)

    def _breadcrumb(self, e: _Entry, step: int) -> None:
        if not self.fault_log:
            return
        try:
            with open(self.fault_log, "a") as fh:
                fh.write('{"entry": "%s", "kind": "%s", "step": %d, "ts": %f}\n'
                         % (e.key, e.kind, step, time.time()))
        except OSError:
            pass  # attribution is best-effort, never a new failure

    # -- injection hooks ----------------------------------------------
    def before_step(self, step: int) -> None:
        """Call at the top of each train-loop iteration with the global step
        index.  May sleep (slow-step), tombstone a gang member
        (worker-kill), ask for one back (worker-join, into ``joins``) or
        raise SimulatedPreemption."""
        e = self._take("slow-step", step)
        if e is not None:
            time.sleep(float(e.arg or 30.0))
        e = self._take("worker-kill", step)
        if e is not None:
            if self.gang is not None:
                self._kills.append(self.hosts.get(e.arg or "1", e.arg or "1"))
            else:
                from distributeddataparallel_tpu_torch.utils.logging import warn0

                warn0("chaos %s: no elastic gang coordinator wired (--elastic not set?) — kill not injected",
                      e.key)
        e = self._take("worker-join", step)
        if e is not None:
            if self.gang is not None:
                self.joins.append(self.hosts.get(e.arg or "1", e.arg or "1"))
            else:
                from distributeddataparallel_tpu_torch.utils.logging import warn0

                warn0("chaos %s: no elastic gang coordinator wired (--elastic not set?) — rejoin not injected",
                      e.key)
        e = self._take("preempt", step)
        if e is not None:
            self.after_step(step)  # a member killed at this step is dead in the store when the gang dies
            raise SimulatedPreemption(f"chaos: simulated worker preemption at step {step}")

    def after_step(self, step: int) -> None:
        """Call after each train step, before the gang's poll: tombstones
        the members a ``worker-kill`` of this step named, once ``sync``
        has ordered every rank's earlier polls before them."""
        if self._kills and self.sync is not None:
            self.sync()
        while self._kills:
            self.gang.kill(self._kills.pop(0))

    def corrupt_batch(self, batch: dict, step: int) -> dict:
        """``batch`` with one NaN planted at index 0 of its first floating
        tensor when a ``nan-grad`` entry fires at ``step`` (identity
        otherwise).  One NaN input propagates through the forward and
        backward to every gradient, the shape of a real numerical
        blow-up."""
        if self._take("nan-grad", step) is None:
            return batch
        for k, v in batch.items():
            if v.is_floating_point():
                v = v.clone()
                v[(0,) * v.ndim] = float("nan")
                return {**batch, k: v}
        raise ValueError(
            "chaos nan-grad needs a float leaf in the batch to poison "
            "(integer-token LM batches cannot carry a NaN input)"
        )

    def corrupt_state(self, state, step: int, *, group=None):
        """``state`` with one bit XOR'd in one parameter leaf on one data
        rank when a ``bitflip`` entry fires at ``step`` (identity
        otherwise): the silent corruption behind the ``--integrity-every``
        closed loop.  ``group``: the data group (None: the world)."""
        e = self._take("bitflip", step)
        if e is None:
            return state
        rank_s, _, leaf = (e.arg or "1").partition(":")
        from distributeddataparallel_tpu_torch.training.integrity import apply_bitflip

        return apply_bitflip(state, rank=int(rank_s), leaf=leaf or None, group=group)

    def fail_io(self, ordinal: int, attempt: int) -> None:
        """Call from inside the checkpoint retry loop with the save-call
        ordinal (0-based count of save() calls in this process) and the
        attempt index.  Raises InjectedIOError for the first K attempts of
        a matching ``ckpt-io@N[:K]`` entry."""
        for e in self._entries:
            if e.kind != "ckpt-io" or e.step != ordinal:
                continue
            if e.key not in self._owned and self._already_fired(e.key):
                continue  # injected by a previous incarnation
            if attempt < int(e.arg or 1):
                self._owned.add(e.key)
                self._mark(e.key)
                if self.events is not None:
                    self.events.emit("chaos_inject", entry=e.key, step=ordinal, attempt=attempt)
                raise InjectedIOError(
                    f"chaos: injected checkpoint-IO failure ({e.key}, attempt {attempt})"
                )
