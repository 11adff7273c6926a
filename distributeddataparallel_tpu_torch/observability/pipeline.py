"""Measured pipeline-bubble reconstruction from the gang timeline.

Counterpart of ``distributeddataparallel_tpu/observability/pipeline.py``,
copied so that ``scripts/ddp_report.py`` reads the port's ``pp_phase``
events unchanged.  The 1F1B and zero-bubble train steps, interleaved or
not (``parallel.pipeline_parallel``), count each stage's executed units
(``pp_phase_counts`` in the step metrics: an ``(n_stages, 3)`` [F, B, W]
table, W zb's deferred weight-gradient units); the trainer emits that table
once per run as a ``pp_phase`` event with the schedule, its virtual chunks
and its slot accounting (``pp_bubble_fraction``).  ``measured_bubble_fraction``
rebuilds the per-stage useful fraction and the gang bubble from the
merged timeline: the measured and analytic numbers agreeing is the
verification; them disagreeing is a schedule bug the counters caught.

Module-import rule: stdlib only (same contract as schema.py).
"""

from __future__ import annotations

#: counter-column order in a pp_phase record's ``counts`` table
PHASE_COLUMNS = ("F", "B", "W")


def phase_counts_payload(
    counts,
    *,
    schedule: str,
    n_stages: int,
    virtual: int = 1,
    microbatches: int | None = None,
    accounting: dict | None = None,
    step: int | None = None,
) -> dict:
    """Build the ``pp_phase`` event payload from the step metrics'
    counter table.  ``counts`` may be a device array, numpy array, or
    nested list — anything with ``.tolist()`` or row iteration; the
    payload is plain ints so ``json_safe`` round-trips it losslessly.
    ``accounting`` is the factory's ``pp_bubble_fraction(...)`` dict
    (slot capacity, windows, analytic bubble) — the denominator side of
    the reconstruction."""
    rows = counts.tolist() if hasattr(counts, "tolist") else list(counts)
    payload = {
        "schedule": schedule,
        "n_stages": int(n_stages),
        "virtual": int(virtual),
        "counts": [[int(x) for x in row] for row in rows],
    }
    if microbatches is not None:
        payload["microbatches"] = int(microbatches)
    if accounting:
        payload["accounting"] = dict(accounting)
    if step is not None:
        payload["step"] = int(step)
    return payload


def measured_bubble_fraction(records) -> dict | None:
    """Reconstruct the measured bubble from ``pp_phase`` records in a
    merged timeline (or any iterable of event dicts).

    Returns None when the run recorded no pipeline phase counters (the
    report's degrade path).  Otherwise a plain-data dict: the schedule
    identity, a per-stage table (F/B/W useful slots, per-stage bubble
    against the declared slot capacity), the gang
    ``measured_bubble_fraction``, and the factory's
    ``analytic_bubble_fraction`` for the drift comparison.  Uses the
    LAST pp_phase record — later incarnations supersede earlier ones,
    matching the goodput ledger's convention.
    """
    recs = [r for r in records if r.get("kind") == "pp_phase"]
    if not recs:
        return None
    rec = recs[-1]
    counts = rec.get("counts") or []
    acct = rec.get("accounting") or {}
    capacity = acct.get("slot_capacity")
    per_stage = []
    total_useful = 0
    for stage, row in enumerate(counts):
        row = [int(x) for x in row]
        row += [0] * (len(PHASE_COLUMNS) - len(row))
        useful = sum(row)
        total_useful += useful
        entry = dict(zip(PHASE_COLUMNS, row))
        entry["stage"] = stage
        entry["useful_slots"] = useful
        if capacity:
            entry["bubble_fraction"] = round(1.0 - useful / capacity, 4)
        per_stage.append(entry)
    out = {
        "schedule": rec.get("schedule"),
        "n_stages": rec.get("n_stages") or len(counts),
        "virtual": rec.get("virtual", 1),
        "microbatches": rec.get("microbatches"),
        "ticks": acct.get("ticks"),
        "slot_capacity": capacity,
        "per_stage": per_stage,
        "analytic_bubble_fraction": acct.get("bubble_fraction"),
    }
    if capacity and per_stage:
        out["measured_bubble_fraction"] = round(
            1.0 - total_useful / (capacity * len(per_stage)), 4
        )
    return out
