"""Post-hoc gang straggler analysis over a merged ``timeline.jsonl``.

Data parallelism is a gang: every step ends with an all-reduce, so the
gang moves at the pace of its slowest rank and a persistent straggler
taxes every step (the MPMD pipeline paper in PAPERS.md motivates the
same per-rank skew attribution for its gangs).  This module answers
"which rank is dragging" from evidence every run already writes — the
per-step ``span`` events in the merged timeline — with no extra runtime
instrumentation:

- per-rank step-duration stats (count / mean / max);
- per-step cross-rank skew: for each global step seen on 2+ ranks, the
  spread between the first and last rank to finish it, and WHO was last
  (``slowest_counts`` — a healthy gang spreads blame uniformly, a
  straggler concentrates it);
- a skew histogram over fixed log-spaced edges, comparable across runs.

Single-process runs degrade gracefully: per-rank stats still populate,
skew fields are None (there is nothing to be skewed against).

A copy of the reference's ``observability/straggler.py``: the port's
trainers write the same ``span`` records (``kind`` span, ``name`` step,
``proc``, ``step``, ``dur_s``), so the same report reads a merged port
timeline.

Module-import rule: stdlib only.
"""

from __future__ import annotations

#: histogram bucket upper edges, seconds (last bucket is open-ended)
SKEW_EDGES = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0)


def _step_spans(records: list[dict]) -> dict[int, list[dict]]:
    """kind=span/name=step records grouped per rank, each reduced to
    (step, end_ts, dur_s).  Span events are emitted at span exit, so
    the record ``ts`` IS the step boundary."""
    per_rank: dict[int, list[dict]] = {}
    for r in records:
        if r.get("kind") != "span" or r.get("name") != "step":
            continue
        proc = r.get("proc")
        if not isinstance(proc, int):
            continue  # supervisor or torn record
        per_rank.setdefault(proc, []).append({
            "step": r.get("step"),
            "end_ts": r.get("ts", 0.0),
            "dur_s": r.get("dur_s", 0.0),
        })
    return per_rank


def _skew_histogram(skews: list[float]) -> dict[str, int]:
    labels = []
    lo = 0.0
    for hi in SKEW_EDGES:
        labels.append((f"{lo:g}-{hi:g}s", lo, hi))
        lo = hi
    labels.append((f">{lo:g}s", lo, float("inf")))
    hist = {label: 0 for label, _, _ in labels}
    for s in skews:
        for label, lo, hi in labels:
            if lo <= s < hi:
                hist[label] += 1
                break
    return hist


def straggler_report(records: list[dict]) -> dict | None:
    """Gang skew analysis over merged timeline records; None when the
    timeline carries no step spans at all (nothing ran)."""
    per_rank = _step_spans(records)
    if not per_rank:
        return None

    ranks = {}
    for proc, spans in sorted(per_rank.items()):
        durs = [s["dur_s"] for s in spans]
        ranks[proc] = {
            "steps": len(spans),
            "mean_step_s": round(sum(durs) / len(durs), 6),
            "max_step_s": round(max(durs), 6),
        }

    out = {
        "n_ranks": len(per_rank),
        "ranks": ranks,
        "steps_compared": 0,
        "skew_mean_s": None,
        "skew_max_s": None,
        "slowest_rank": None,
        "slowest_counts": {},
        "skew_histogram": None,
    }
    if len(per_rank) < 2:
        return out

    # Last finish per (rank, step) — a restarted rank replays steps, and
    # the replay is the boundary that gated the gang's second pass.
    by_step: dict[int, dict[int, float]] = {}
    for proc, spans in per_rank.items():
        for s in spans:
            step = s["step"]
            if step is None:
                continue
            row = by_step.setdefault(step, {})
            row[proc] = max(row.get(proc, float("-inf")), s["end_ts"])

    skews, slowest_counts = [], dict.fromkeys(per_rank, 0)
    for step, row in by_step.items():
        if len(row) < 2:
            continue  # step not seen on enough ranks (torn tail)
        slowest = max(row, key=row.get)
        skews.append(row[slowest] - min(row.values()))
        slowest_counts[slowest] += 1

    if skews:
        out["steps_compared"] = len(skews)
        out["skew_mean_s"] = round(sum(skews) / len(skews), 6)
        out["skew_max_s"] = round(max(skews), 6)
        out["slowest_counts"] = {
            p: c for p, c in sorted(slowest_counts.items()) if c
        }
        out["slowest_rank"] = max(slowest_counts, key=slowest_counts.get)
        out["skew_histogram"] = _skew_histogram(skews)
    return out
