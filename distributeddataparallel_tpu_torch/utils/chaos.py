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

The parser also accepts the reference's elastic-gang and replica-digest
kinds (``worker-kill``, ``worker-join``, ``host-kill``, ``proposer-kill``,
``rdzv-kill``, ``slow-heartbeat``, ``partition``, ``torn-epoch``,
``bitflip``), with the reference's argument rules.  Their runtimes are not
ported (``NOT_PORTED`` names the ROADMAP item of each), and an injector
refuses them rather than skipping them.

Determinism across restarts: with a ``state_dir``, each entry fires AT MOST
ONCE across process restarts: a marker file records the firing, so a
restarted worker does not hit the same preemption again and crash-loop.
Without a state dir, entries fire once per process.

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

_GANG = ("ROADMAP.md Queue 1 items 13 and 20: training/elastic.py and "
         "runtime/{rendezvous,elastic_gang,hostgang}.py")
#: Kinds the parser accepts but this port cannot inject yet, each with the
#: ROADMAP item that ports its runtime.
NOT_PORTED = {
    **{k: _GANG for k in ("worker-kill", "worker-join", "host-kill", "proposer-kill",
                          "rdzv-kill", "slow-heartbeat", "partition", "torn-epoch")},
    "bitflip": "ROADMAP.md Queue 1 item 20: training/integrity.py (the replica digest)",
}


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
        return m is not None and os.path.exists(m)

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
                if self.events is not None:
                    self.events.emit("chaos_inject", entry=e.key, step=step)
                return e
        return None

    # -- injection hooks ----------------------------------------------
    def before_step(self, step: int) -> None:
        """Call at the top of each train-loop iteration with the global step
        index.  May sleep (slow-step) or raise SimulatedPreemption."""
        e = self._take("slow-step", step)
        if e is not None:
            time.sleep(float(e.arg or 30.0))
        e = self._take("preempt", step)
        if e is not None:
            raise SimulatedPreemption(f"chaos: simulated worker preemption at step {step}")

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
