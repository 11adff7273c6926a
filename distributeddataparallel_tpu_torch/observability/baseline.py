"""Run summaries, the longitudinal run store, and baseline comparison.

One training run ends as ~10 numbers: MFU, step-time percentiles,
memory high-water mark, goodput fraction, restart count, alert count.
This module extracts that record (``run_summary``), keeps every run's
record in an append-only ``runs/index.jsonl`` history store with named
baselines beside it, and answers the only longitudinal question that
matters: *did this run regress against the baseline?* —
``scripts/perf_gate.py`` wires the answer into CI as an exit code.

Two extraction paths mirror goodput's design: ``RunSummaryBuilder`` is
fed live at the same window boundaries that feed the AlertEngine (zero
extra host syncs — every input is a host float the boundary already
computed) and emitted as a ``run_summary`` event before ``run_end``;
``run_summary_from_timeline`` rebuilds the same record offline from a
merged gang timeline, which is how the supervisor summarises a
multi-incarnation run (restart gaps included) and how old runs enter
the store retroactively.

Store layout (``runs_dir``)::

    index.jsonl            # one run_summary per line, append-only
    baselines/<name>.json  # named baseline = a pinned run_summary

Comparison is per-metric with relative thresholds and a declared
direction (higher-better MFU vs lower-better step time); a metric
missing on either side *degrades* (reported, not failed) so a gate
never blocks on a run that didn't enable some telemetry.

Module-import rule: stdlib only (see schema.py).
"""

from __future__ import annotations

import json
import os

from .goodput import goodput_from_timeline

INDEX_NAME = "index.jsonl"
BASELINES_DIR = "baselines"

#: metric -> (direction, default relative tolerance).  Directions:
#: "higher" = regression when value drops below baseline*(1-tol),
#: "lower"  = regression when value rises above baseline*(1+tol),
#: "count"  = regression when value exceeds baseline + tol (absolute).
GATE_METRICS: dict[str, tuple[str, float]] = {
    "mfu_mean": ("higher", 0.05),
    "step_s_p50": ("lower", 0.05),
    "step_s_p99": ("lower", 0.10),
    "live_hwm_bytes": ("lower", 0.05),
    "goodput": ("higher", 0.05),
    "restarts": ("count", 0.0),
}


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        raise ValueError("percentile of empty list")
    idx = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class RunSummaryBuilder:
    """Accumulates window-boundary samples into a run_summary record.

    ``sample()`` is called once per throughput window with whatever the
    boundary already computed; ``build()`` closes the run.  Percentiles
    are over *window-mean* step times — the same granularity every
    other consumer (alerts, reports) sees, and bounded memory: one
    float per window, not per step.
    """

    def __init__(self):
        self._step_s: list[float] = []
        self._mfu: list[float] = []
        self._hwm_bytes: float | None = None
        self._steps_total = 0
        self._collective_fp: str | None = None

    def sample(self, *, step_s=None, mfu=None, live_hwm_bytes=None,
               steps_total=None, collective_fp=None) -> None:
        if step_s is not None:
            self._step_s.append(float(step_s))
        if mfu is not None:
            self._mfu.append(float(mfu))
        if live_hwm_bytes is not None:
            self._hwm_bytes = float(live_hwm_bytes)
        if steps_total is not None:
            self._steps_total = int(steps_total)
        if collective_fp is not None:
            self._collective_fp = str(collective_fp)

    def build(self, *, goodput: dict | None = None, restarts: int = 0,
              alerts_total: int = 0, status: str = "ok") -> dict:
        step_sorted = sorted(self._step_s)
        summary = {
            "windows": len(self._step_s),
            "steps_total": self._steps_total,
            "status": status,
            "restarts": int(restarts),
            "alerts_total": int(alerts_total),
            "step_s_p50": (
                round(_percentile(step_sorted, 0.50), 6) if step_sorted else None
            ),
            "step_s_p99": (
                round(_percentile(step_sorted, 0.99), 6) if step_sorted else None
            ),
            "mfu_mean": (
                round(sum(self._mfu) / len(self._mfu), 6) if self._mfu else None
            ),
            "live_hwm_bytes": (
                int(self._hwm_bytes) if self._hwm_bytes is not None else None
            ),
            "goodput": goodput.get("goodput") if goodput else None,
            "goodput_buckets": goodput.get("buckets") if goodput else None,
            # GL002 collective-sequence fingerprint of the traced step:
            # lets the perf gate attribute a regression to a graph
            # change (fp differs from baseline) vs environment drift
            # (fp identical, only the numbers moved).
            "collective_fp": self._collective_fp,
        }
        return summary


def run_summary_from_timeline(records: list[dict], proc=0) -> dict:
    """Rebuild a run_summary from a merged gang timeline — the offline
    twin of RunSummaryBuilder, and the only path that sees a whole
    supervised run (every incarnation + the restart gaps between them).
    Rank ``proc`` clocks the gang, same convention as goodput."""
    builder = RunSummaryBuilder()
    steps = set()
    status = "killed"
    for rec in records:
        if rec.get("proc") != proc:
            continue
        kind = rec.get("kind")
        if kind == "span" and rec.get("name") == "step":
            dur = rec.get("dur_s")
            if isinstance(dur, (int, float)):
                builder.sample(step_s=float(dur))
            if isinstance(rec.get("step"), int):
                steps.add(rec["step"])
        elif kind == "mfu" and isinstance(rec.get("mfu"), (int, float)):
            builder.sample(mfu=float(rec["mfu"]))
        elif kind == "memory":
            hwm = rec.get("live_hwm_bytes", rec.get("live_bytes"))
            if isinstance(hwm, (int, float)):
                builder.sample(live_hwm_bytes=float(hwm))
        elif kind == "run_summary":
            if rec.get("collective_fp"):
                builder.sample(collective_fp=rec["collective_fp"])
        elif kind == "run_end":
            status = rec.get("status", status)
    goodput = goodput_from_timeline(records, proc=proc)
    alerts = sum(1 for r in records if r.get("kind") == "alert")
    summary = builder.build(
        goodput=goodput,
        restarts=goodput.get("restarts", 0) if goodput else 0,
        alerts_total=alerts,
        status=status,
    )
    summary["steps_total"] = len(steps) or summary["steps_total"]
    # Offline percentiles are per-STEP spans, not window means — note it
    # so cross-source comparisons know the granularity differs.
    summary["source_granularity"] = "step"
    return summary


# ---------------------------------------------------------------------------
# History store


def append_run(runs_dir: str, summary: dict, *, name: str | None = None,
               source: str = "trainer") -> str:
    """Append one run_summary to ``runs_dir/index.jsonl`` (created on
    first use).  ``name`` tags the run for later baseline promotion;
    ``source`` records which path produced it (trainer / supervisor /
    cli)."""
    os.makedirs(runs_dir, exist_ok=True)
    rec = dict(summary)
    rec["source"] = source
    if name:
        rec["name"] = name
    path = os.path.join(runs_dir, INDEX_NAME)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return path


def read_runs(runs_dir: str) -> list[dict]:
    path = os.path.join(runs_dir, INDEX_NAME)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail: the store is append-only JSONL
    return out


def baseline_path(runs_dir: str, name: str) -> str:
    return os.path.join(runs_dir, BASELINES_DIR, f"{name}.json")


def save_baseline(runs_dir: str, name: str, summary: dict) -> str:
    path = baseline_path(runs_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(summary, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def load_baseline(runs_dir: str, name: str) -> dict | None:
    path = baseline_path(runs_dir, name)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


# ---------------------------------------------------------------------------
# Comparison


def compare_metric(name: str, value, base, *, direction: str,
                   tolerance: float) -> dict:
    """One metric verdict: status pass / regress / missing, with the
    bound that was applied.  None / absent on either side is 'missing'
    — a degrade, never a failure (a run that didn't enable --mfu must
    not fail the MFU gate; it must say so)."""
    if not isinstance(value, (int, float)) or not isinstance(base, (int, float)):
        return {"metric": name, "status": "missing", "value": value,
                "baseline": base}
    value, base = float(value), float(base)
    if direction == "higher":
        bound = base * (1.0 - tolerance)
        regressed = value < bound
    elif direction == "lower":
        bound = base * (1.0 + tolerance)
        regressed = value > bound
    elif direction == "count":
        bound = base + tolerance
        regressed = value > bound
    else:
        raise ValueError(f"unknown gate direction {direction!r}")
    delta = (value - base) / base if base else None
    return {
        "metric": name,
        "status": "regress" if regressed else "pass",
        "value": value,
        "baseline": base,
        "bound": round(bound, 9),
        "direction": direction,
        "tolerance": tolerance,
        "rel_delta": round(delta, 6) if delta is not None else None,
    }


def compare_to_baseline(summary: dict, baseline: dict,
                        thresholds: dict[str, float] | None = None,
                        metrics: dict[str, tuple[str, float]] | None = None,
                        ) -> dict:
    """Gate one run_summary against a baseline over ``metrics``
    (default GATE_METRICS), with per-metric tolerance overrides in
    ``thresholds``.  Returns per-metric verdicts plus the aggregate
    ``ok`` (False iff any metric regressed)."""
    metrics = metrics if metrics is not None else GATE_METRICS
    thresholds = thresholds or {}
    checks = []
    for name, (direction, default_tol) in metrics.items():
        checks.append(compare_metric(
            name, summary.get(name), baseline.get(name),
            direction=direction,
            tolerance=thresholds.get(name, default_tol),
        ))
    regressed = [c["metric"] for c in checks if c["status"] == "regress"]
    missing = [c["metric"] for c in checks if c["status"] == "missing"]
    return {
        "ok": not regressed,
        "regressed": regressed,
        "missing": missing,
        "checks": checks,
    }
