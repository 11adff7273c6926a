"""Goodput accounting: classify run wall time into productive /
compile / checkpoint / eval / restart / stall buckets.

"Goodput" is the fraction of wall-clock time spent stepping the model —
the number a capacity planner multiplies MFU by.  Two faces:

- ``GoodputLedger`` — the live, in-process ledger the trainer feeds as
  it goes (compile time from StepTimer, checkpoint/eval span durations,
  injected stalls); ``summary()`` is emitted as a ``goodput`` event at
  run_end.  Pure host arithmetic, no device reads.
- ``goodput_from_timeline`` — the offline reconstruction over a merged
  gang ``timeline.jsonl``, which sees what no single incarnation can:
  the dead time BETWEEN incarnations (a preempted worker never gets to
  emit its own restart cost).  Per-incarnation numbers come from each
  incarnation's own ``goodput`` event when it lived long enough to
  write one, else are rebuilt from its spans and warm_start events.

Module-import rule: stdlib only (see schema.py) — the report generator
runs this in jax-free interpreters.
"""

from __future__ import annotations

import time

#: every non-productive bucket the ledger recognises; "productive" is
#: always the remainder, so it can never double-count.  ``resize`` is
#: deliberately distinct from ``restart``: a restart pays gang respawn +
#: checkpoint restore + warm start, a resize pays only the in-memory
#: reshard + mesh rebuild — the difference between the two buckets IS
#: the elasticity win ddp_report's "Elasticity" section reports.
BUCKETS = ("compile", "checkpoint", "eval", "restart", "resize", "stall")


class GoodputLedger:
    """Wall-clock ledger for one incarnation.  ``add`` seconds into a
    bucket as they happen; ``summary()`` computes productive time as
    the remainder of total wall time and the goodput fraction."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self.buckets = dict.fromkeys(BUCKETS, 0.0)

    def add(self, bucket: str, seconds: float | None) -> None:
        if seconds is None:
            return
        if bucket not in self.buckets:
            raise KeyError(
                f"unknown goodput bucket {bucket!r}; one of {BUCKETS}"
            )
        self.buckets[bucket] += float(seconds)

    def summary(self, total_s: float | None = None) -> dict:
        total = (
            float(total_s) if total_s is not None
            else time.perf_counter() - self._t0
        )
        spent = sum(self.buckets.values())
        productive = max(total - spent, 0.0)
        return {
            "total_s": round(total, 3),
            "productive_s": round(productive, 3),
            "buckets": {k: round(v, 3) for k, v in self.buckets.items()},
            "goodput": round(productive / total, 4) if total > 0 else 0.0,
        }


def _incarnations(records: list[dict], proc=0) -> list[list[dict]]:
    """Split one worker's records into incarnations at run_start
    boundaries.  Records before the first run_start (possible only in
    torn logs) attach to the first incarnation."""
    recs = [r for r in records if r.get("proc") == proc]
    out: list[list[dict]] = []
    for r in recs:
        if r.get("kind") == "run_start" or not out:
            out.append([])
        out[-1].append(r)
    return out


def _incarnation_summary(recs: list[dict]) -> dict:
    """Goodput buckets for one incarnation's record slice.  Prefers the
    incarnation's own ``goodput`` event; a killed incarnation (no
    run_end) is rebuilt from spans + warm_start."""
    start_ts = recs[0].get("ts", 0.0)
    end_rec = next((r for r in recs if r.get("kind") == "run_end"), None)
    end_ts = end_rec["ts"] if end_rec else recs[-1].get("ts", start_ts)
    out = {
        "start_ts": start_ts,
        "end_ts": end_ts,
        "ended_clean": end_rec is not None,
        "status": end_rec.get("status") if end_rec else "killed",
    }
    own = next(
        (r for r in reversed(recs) if r.get("kind") == "goodput"), None
    )
    if own is not None:
        out["total_s"] = own["total_s"]
        out["buckets"] = dict(own.get("buckets", {}))
        return out
    # Rebuild: spans carry their durations; warm_start carries the
    # compile (first-step) time.  A killed incarnation's numbers are a
    # floor — time between the last record and the kill is unknowable.
    buckets = dict.fromkeys(BUCKETS, 0.0)
    for r in recs:
        if r.get("kind") == "span" and r.get("name") == "ckpt_save":
            buckets["checkpoint"] += r.get("dur_s", 0.0)
        elif r.get("kind") == "span" and r.get("name") == "eval":
            buckets["eval"] += r.get("dur_s", 0.0)
        elif r.get("kind") == "warm_start":
            buckets["compile"] += r.get("first_step_s") or 0.0
        elif r.get("kind") == "resize_downtime":
            # Killed incarnations never emit their own goodput event, so
            # in-place resizes they performed are rebuilt here too.
            buckets["resize"] += r.get("seconds") or 0.0
    out["total_s"] = round(max(end_ts - start_ts, 0.0), 3)
    out["buckets"] = {k: round(v, 3) for k, v in buckets.items()}
    return out


def goodput_from_timeline(records: list[dict], proc=0) -> dict | None:
    """Run-level goodput from a merged gang timeline (rank ``proc``
    clocks the gang — the step loop is SPMD, so any one rank's wall
    clock is the run's).

    Sums bucket time across incarnations, attributes the dead gaps
    BETWEEN incarnations to the ``restart`` bucket, and computes the
    goodput fraction over first-start..last-end wall time.  Returns
    None when the timeline has no run_start for that rank (a gang that
    died before ever starting — the caller reports that instead of a
    fabricated number).
    """
    incs = [
        _incarnation_summary(i)
        for i in _incarnations(records, proc=proc)
        if any(r.get("kind") == "run_start" for r in i)
    ]
    if not incs:
        return None
    total = max(incs[-1]["end_ts"] - incs[0]["start_ts"], 0.0)
    buckets = dict.fromkeys(BUCKETS, 0.0)
    for inc in incs:
        for k, v in inc.get("buckets", {}).items():
            if k in buckets:
                buckets[k] += v
    for prev, nxt in zip(incs, incs[1:]):
        buckets["restart"] += max(nxt["start_ts"] - prev["end_ts"], 0.0)
    spent = sum(buckets.values())
    productive = max(total - spent, 0.0)
    return {
        "total_s": round(total, 3),
        "productive_s": round(productive, 3),
        "buckets": {k: round(v, 3) for k, v in buckets.items()},
        "goodput": round(productive / total, 4) if total > 0 else 0.0,
        "incarnations": incs,
        "restarts": len(incs) - 1,
    }
