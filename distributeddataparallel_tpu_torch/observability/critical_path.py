"""Span trees, their lineage check, and the critical-path TTFT decomposition.

Copy of the JAX package's ``observability/critical_path.py``.  Input: a
merged timeline (``events.load_timeline``).  Every ``span`` record carrying
schema-v2 trace fields joins its request's span tree: one root (the fleet's
``req:<fid>`` span, no parent) with engine-local children named by role:
``prefill:*`` (admission to first token), ``handoff:*`` (KV blocks on the
wire), ``decode:*`` (first token or injection to completion), ``request:*``
(an engine's whole ownership window).  Span records carry explicit
``start_s``/``end_s`` in the run's injected clock domain (the envelope
``ts`` is always wall clock), so the arithmetic below is
VirtualClock-consistent.

:func:`request_decompositions` answers "where did this request's TTFT go":
the root span carries the measured TTFT, and each category's spans are
clipped to the TTFT window ``[arrival, arrival + ttft]`` and
interval-merged; whatever no span covers is **queue wait**.  By
construction the four segments sum to the window, so ``err_frac`` is the
tree's self-consistency check.  The fleet smoke gates
``ttft_decomp_err_frac <= 0.05`` on every completed request.

:func:`check_lineage` is the structural half (``check_events --lineage``):
every span's parent exists, exactly one root per trace, no cross-trace
parent edges.  The serving CLI's ``--smoke`` reads both.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import math

#: span-name prefix -> decomposition segment
_SEGMENTS = ("prefill", "handoff", "decode")


def nearest_rank_quantile(values, q: float) -> float:
    """Nearest-rank quantile (the value AT rank ceil(q*n) — a sample
    that occurred, not an interpolation; 0.0 on empty input)."""
    vals = sorted(values)
    if not vals:
        return 0.0
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    rank = max(1, math.ceil(q * len(vals)))
    return float(vals[rank - 1])


def _is_traced_span(rec) -> bool:
    return (
        isinstance(rec, dict)
        and rec.get("kind") == "span"
        and isinstance(rec.get("trace"), str)
        and isinstance(rec.get("span"), str)
    )


def trace_spans(records) -> dict[str, list[dict]]:
    """trace_id -> that trace's span records, in timeline order."""
    out: dict[str, list[dict]] = {}
    for rec in records:
        if _is_traced_span(rec):
            out.setdefault(rec["trace"], []).append(rec)
    return out


def span_window(rec) -> tuple[float, float] | None:
    """(start, end) of a span in the run clock domain: explicit
    ``start_s``/``end_s`` when present, else reconstructed from the
    wall-clock envelope (``ts`` is the emit time = span end)."""
    start, end = rec.get("start_s"), rec.get("end_s")
    if isinstance(start, (int, float)) and isinstance(end, (int, float)):
        return float(start), float(end)
    ts, dur = rec.get("ts"), rec.get("dur_s")
    if isinstance(ts, (int, float)) and isinstance(dur, (int, float)):
        return float(ts) - float(dur), float(ts)
    return None


def check_lineage(records) -> list[str]:
    """Trace-context integrity over a merged timeline; empty = clean.

    Checks only spans (they form the tree; membership annotations on
    non-span records are free-form pointers): every ``parent`` id must
    exist as a span of the SAME trace, every trace must have exactly
    one root (a span without ``parent``), and a parent id found only
    in a different trace is called out as a cross-trace edge.
    """
    by_trace = trace_spans(records)
    traces_of_span: dict[str, set[str]] = {}
    for tid, spans in by_trace.items():
        for rec in spans:
            traces_of_span.setdefault(rec["span"], set()).add(tid)
    problems = []
    for tid in sorted(by_trace):
        spans = by_trace[tid]
        ids = {rec["span"] for rec in spans}
        roots = [rec for rec in spans if rec.get("parent") is None]
        if len(roots) != 1:
            names = sorted(str(r.get("name")) for r in roots)
            problems.append(
                f"trace {tid}: {len(roots)} root spans "
                f"({names if roots else 'none'}), want exactly 1"
            )
        for rec in spans:
            parent = rec.get("parent")
            if parent is None or parent in ids:
                continue
            elsewhere = sorted(traces_of_span.get(parent, ()))
            if elsewhere:
                problems.append(
                    f"trace {tid}: span {rec['span']} "
                    f"({rec.get('name')}) parent {parent} belongs to "
                    f"other trace(s) {elsewhere} — cross-trace edge"
                )
            else:
                problems.append(
                    f"trace {tid}: span {rec['span']} "
                    f"({rec.get('name')}) parent {parent} not emitted "
                    "— orphan"
                )
    return problems


def _merged_len(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total = 0.0
    last_end = None
    for start, end in sorted(intervals):
        if last_end is None or start > last_end:
            total += end - start
            last_end = end
        elif end > last_end:
            total += end - last_end
            last_end = end
    return total


def request_decompositions(records) -> list[dict]:
    """Per-request TTFT decomposition, one dict per trace whose root
    span carries a measured ``ttft_s``:

    ``{"trace", "req", "ttft_s", "queue_s", "prefill_s", "handoff_s",
    "decode_s", "err_frac", "spans"}``

    Segments are clipped to the TTFT window and interval-merged per
    category; queue wait is the uncovered remainder.
    """
    out = []
    for tid, spans in sorted(trace_spans(records).items()):
        root = next(
            (
                rec for rec in spans
                if rec.get("parent") is None
                and isinstance(rec.get("ttft_s"), (int, float))
            ),
            None,
        )
        if root is None:
            continue
        win = span_window(root)
        if win is None:
            continue
        ttft = float(root["ttft_s"])
        w0, w1 = win[0], win[0] + ttft
        segs = {}
        for seg in _SEGMENTS:
            clipped = []
            for rec in spans:
                if not str(rec.get("name", "")).startswith(f"{seg}:"):
                    continue
                sw = span_window(rec)
                if sw is None:
                    continue
                lo, hi = max(sw[0], w0), min(sw[1], w1)
                if hi > lo:
                    clipped.append((lo, hi))
            segs[f"{seg}_s"] = _merged_len(clipped)
        # Unclipped handoff count: the tier classifier.  Handoff rides
        # AFTER the first token here (the prefill tier samples it from
        # the final chunk), so its seconds inside the TTFT window are
        # ~0 by architecture — existence, not coverage, marks the
        # disaggregated path.
        handoffs = sum(
            1 for rec in spans
            if str(rec.get("name", "")).startswith("handoff:")
        )
        covered = sum(segs.values())
        segs["queue_s"] = max(0.0, ttft - covered)
        total = segs["queue_s"] + covered
        out.append({
            "trace": tid,
            "req": root.get("req"),
            "ttft_s": ttft,
            "handoffs": handoffs,
            **segs,
            "err_frac": (
                abs(total - ttft) / ttft if ttft > 0
                else (0.0 if total == 0 else float("inf"))
            ),
            "spans": len(spans),
        })
    return out


def ttft_rollup(decomps) -> dict:
    """Fleet-level headline rollup over per-request decompositions.

    Share fractions are ratios of SUMS (total seconds spent in a
    segment over total TTFT seconds — the fleet's aggregate time
    budget, robust to a few tiny-TTFT requests), and
    ``ttft_decomp_err_frac`` is the WORST per-request error, because
    one disconnected span tree is a bug even when the average hides it.
    """
    out = {"requests": len(decomps)}
    if not decomps:
        return out
    ttft_total = sum(d["ttft_s"] for d in decomps)
    for seg in ("queue", "prefill", "handoff", "decode"):
        seg_vals = [d[f"{seg}_s"] for d in decomps]
        out[f"ttft_{seg}_share_frac"] = (
            sum(seg_vals) / ttft_total if ttft_total > 0 else 0.0
        )
        out[f"{seg}_p50_s"] = nearest_rank_quantile(seg_vals, 0.50)
        out[f"{seg}_p99_s"] = nearest_rank_quantile(seg_vals, 0.99)
    out["ttft_decomp_err_frac"] = max(d["err_frac"] for d in decomps)
    return out


def tier_rollups(decomps) -> dict[str, dict]:
    """Per-tier rollups, keyed by which path produced the first token:
    ``prefill`` (a handoff span exists — the disaggregated path) vs
    ``decode`` (served end-to-end by a decode engine)."""
    # Disaggregated requests ship KV blocks across tiers by definition;
    # affinity hits prefill locally on their decode engine.  The split
    # the fleet actually uses is handoff-vs-not.
    by_tier: dict[str, list[dict]] = {"prefill": [], "decode": []}
    for d in decomps:
        disagg = d.get("handoffs", 0) > 0 or d["handoff_s"] > 0
        by_tier["prefill" if disagg else "decode"].append(d)
    return {tier: ttft_rollup(ds) for tier, ds in by_tier.items()}


def critical_path_of(records, trace_id: str) -> list[dict]:
    """One request's critical path: its spans in start order as
    ``{"name", "engine", "start_s", "end_s", "dur_s"}`` — the chain a
    human reads to see where the time went."""
    steps = []
    for rec in trace_spans(records).get(trace_id, []):
        win = span_window(rec)
        if win is None:
            continue
        steps.append({
            "name": rec.get("name"),
            "engine": rec.get("engine"),
            "start_s": win[0],
            "end_s": win[1],
            "dur_s": win[1] - win[0],
        })
    steps.sort(key=lambda s: (s["start_s"], s["end_s"]))
    return steps


def worst_request(decomps) -> dict | None:
    """The fleet's critical request: the decomposition with the largest
    measured TTFT (None when empty) — pair with
    :func:`critical_path_of` on its trace id for the drill-down."""
    return max(decomps, key=lambda d: d["ttft_s"], default=None)
