"""Span-lineage check over a merged timeline.

Copy of the ``check_lineage`` half of the JAX package's
``observability/critical_path.py`` (``check_events --lineage``): every
span's parent exists, exactly one root per trace, no cross-trace parent
edges.  The serving CLI's ``--smoke`` reads it.  The TTFT decomposition
half serves only the fleet and comes with it (ROADMAP item 19b).

Module-import rule: stdlib only.
"""

from __future__ import annotations


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
