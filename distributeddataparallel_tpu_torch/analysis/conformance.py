"""Timeline conformance: replay recorded events against the protocol specs.

The port's copy of the JAX package's ``analysis/conformance.py``, over
the v2 timelines the port writes (its own ``observability`` schema).

Every chaos/fleet/smoke run already records a merged ``timeline.jsonl``
whose 46 event kinds carry the protocol-relevant ids (epoch numbers,
rosters, request fids, handoff attempt counts, verdict rungs).  This
module replays such a timeline against the invariants declared in
``analysis.protocol``, so every existing smoke run doubles as a
protocol-conformance test: the first time the live ``runtime/`` /
``serving/`` code emits an event sequence the spec forbids, the drift
is a PL405 finding — not a silent divergence between the checked plan
and the executed one.

Checks (each violation is one ``Finding("PL405", ...)``):

rendezvous spec (``membership_epoch`` / ``rdzv_rehost`` / ``gang_verdict``):
- no two committed epochs share a number with different rosters (a
  forked membership history); per-writer epoch announcements never go
  backwards;
- a ``rdzv_rehost`` owner is a member of the most recent roster, and
  re-host generations are strictly increasing;
- ``gang_verdict`` rungs come from the declared degradation ladder.

router + handoff specs (``route_admit`` / ``kv_handoff`` /
``engine_verdict``):
- an affinity-hit admission never enters the prefill tier
  (``affinity`` true forces ``prefill`` null);
- a request fid is re-admitted only after an ``engine_verdict`` (the
  drain-and-requeue path) — a duplicate admit with no death in between
  is a routing double-own;
- ``kv_handoff.attempts`` stays within the NAK redelivery budget
  (``protocol.HANDOFF_MAX_ATTEMPTS``) and only fids that were admitted
  through the prefill tier hand off;
- ``engine_verdict`` rungs come from ``protocol.VERDICT_RUNGS``, an
  engine dies at most once per run, and nothing routes to an engine
  after its verdict.

Conservative by design: kinds a timeline does not contain are simply
not checked, so the same replay runs on a training chaos timeline (no
serving events) and a fleet timeline (no rendezvous events).

Module-import rule: stdlib only (plus the stdlib-only ``analysis`` and
``observability.events`` modules).
"""

from __future__ import annotations

import json
import os

from distributeddataparallel_tpu_torch.analysis.protocol import (
    HANDOFF_MAX_ATTEMPTS,
    VERDICT_RUNGS,
)
from distributeddataparallel_tpu_torch.analysis.rules import Finding

#: the supervisor degradation ladder's terminal rungs (launcher.py)
GANG_RUNGS = ("resize", "restart", "fail")


def check_timeline(records, *, where: str = "timeline") -> list[Finding]:
    """Replay one merged, (ts, seq)-ordered record list against the
    protocol specs; returns PL405 findings (empty = conformant)."""
    out: list[Finding] = []

    def flag(i: int, msg: str) -> None:
        out.append(Finding("PL405", f"{where}:{i + 1}", msg))

    epoch_roster: dict[int, list] = {}   # epoch -> first roster seen
    per_writer_epoch: dict[str, int] = {}
    last_roster: list | None = None
    last_generation: int | None = None

    admitted: dict[str, int] = {}        # fid -> admit count
    had_prefill: set = set()             # fids admitted via prefill tier
    verdicts_between: int = 0            # engine_verdict count so far
    admit_verdict_mark: dict[str, int] = {}  # fid -> verdict count at admit
    dead_engines: set = set()

    for i, rec in enumerate(records):
        kind = rec.get("kind")
        if kind == "membership_epoch":
            epoch = rec.get("epoch")
            roster = sorted(rec.get("roster") or [])
            if not isinstance(epoch, int):
                flag(i, f"membership_epoch with non-int epoch {epoch!r}")
                continue
            prior = epoch_roster.setdefault(epoch, roster)
            if prior != roster:
                flag(
                    i,
                    f"epoch {epoch} committed twice with different "
                    f"rosters {prior} vs {roster} — forked membership "
                    "history (rendezvous epoch-unique)",
                )
            proc = str(rec.get("proc"))
            prev = per_writer_epoch.get(proc)
            if prev is not None and epoch < prev:
                flag(
                    i,
                    f"writer {proc} announced epoch {epoch} after "
                    f"epoch {prev} — membership went backwards",
                )
            per_writer_epoch[proc] = epoch
            last_roster = roster
        elif kind == "rdzv_rehost":
            owner = rec.get("owner")
            gen = rec.get("generation")
            if last_roster is not None and owner not in last_roster:
                flag(
                    i,
                    f"rdzv_rehost onto {owner!r} which is not in the "
                    f"last committed roster {last_roster} (rendezvous "
                    "rehost-owner)",
                )
            if isinstance(gen, int):
                if last_generation is not None and gen <= last_generation:
                    flag(
                        i,
                        f"rdzv_rehost generation {gen} does not fence "
                        f"generation {last_generation} — a stale store "
                        "could outlive its successor",
                    )
                last_generation = gen
        elif kind == "gang_verdict":
            rung = rec.get("rung")
            if rung not in GANG_RUNGS:
                flag(
                    i,
                    f"gang_verdict rung {rung!r} not on the declared "
                    f"degradation ladder {GANG_RUNGS}",
                )
        elif kind == "route_admit":
            fid = str(rec.get("req"))
            engine = rec.get("engine")
            prefill = rec.get("prefill")
            if rec.get("affinity") and prefill is not None:
                flag(
                    i,
                    f"affinity-hit admission of {fid} still assigned "
                    f"prefill engine {prefill!r} (router affinity-tier)",
                )
            if engine in dead_engines:
                flag(
                    i,
                    f"request {fid} routed to engine {engine!r} after "
                    "its engine_verdict (routing to a tombstone)",
                )
            if prefill in dead_engines and prefill is not None:
                flag(
                    i,
                    f"request {fid} assigned dead prefill engine "
                    f"{prefill!r}",
                )
            n = admitted.get(fid, 0)
            if n > 0 and admit_verdict_mark.get(fid) == verdicts_between:
                flag(
                    i,
                    f"request {fid} admitted {n + 1} times with no "
                    "engine_verdict in between — double-own without a "
                    "drain (router drop-vs-complete)",
                )
            admitted[fid] = n + 1
            admit_verdict_mark[fid] = verdicts_between
            if prefill is not None:
                had_prefill.add(fid)
        elif kind == "kv_handoff":
            fid = str(rec.get("req"))
            attempts = rec.get("attempts", 1)
            if isinstance(attempts, int) and not (
                1 <= attempts <= HANDOFF_MAX_ATTEMPTS
            ):
                flag(
                    i,
                    f"kv_handoff for {fid} took {attempts} attempts — "
                    f"outside the NAK budget [1, {HANDOFF_MAX_ATTEMPTS}] "
                    "(handoff attempt-budget)",
                )
            if fid not in had_prefill:
                flag(
                    i,
                    f"kv_handoff for {fid} which was never admitted "
                    "through the prefill tier — blocks arriving from "
                    "nowhere (handoff at-most-once)",
                )
        elif kind == "engine_verdict":
            engine = rec.get("engine")
            rung = rec.get("rung")
            if rung not in VERDICT_RUNGS:
                flag(
                    i,
                    f"engine_verdict rung {rung!r} not in the declared "
                    f"rungs {VERDICT_RUNGS}",
                )
            if engine in dead_engines:
                flag(
                    i,
                    f"second engine_verdict for {engine!r} — an engine "
                    "dies at most once per run",
                )
            dead_engines.add(engine)
            verdicts_between += 1
    return out


def load_records(path: str) -> list[dict]:
    """Records from a merged-timeline JSONL file or an events directory
    (merged on the fly via ``observability.events.load_timeline``)."""
    if os.path.isdir(path):
        from distributeddataparallel_tpu_torch.observability.events import (
            load_timeline,
        )

        return load_timeline(path)
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line; schema validation owns this
    return records


def check_path(path: str) -> list[Finding]:
    return check_timeline(load_records(path), where=path)
