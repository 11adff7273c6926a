"""Event-record schema for the observability subsystem.

Every record written to a per-worker events JSONL file is a flat JSON
object carrying a fixed envelope plus kind-specific fields.  The schema
is versioned (``SCHEMA_VERSION``) so downstream consumers — the gang
timeline merger, ``scripts/check_events.py``, external log shippers —
can reject records they don't understand instead of misparsing them.

Module-import rule: stdlib only.  This file is imported by the chaos
injector and the launcher supervisor, both of which must stay cheap to
import in a fresh interpreter (no jax at module scope).
"""

from __future__ import annotations

import json
import math

#: v2 added the OPTIONAL trace-context envelope fields (trace / span /
#: parent).  v1 records — written by pre-tracing builds — still
#: validate: the version check accepts anything in SUPPORTED_VERSIONS,
#: and the trace fields are optional in both directions.
SCHEMA_VERSION = 2
SUPPORTED_VERSIONS = frozenset({1, 2})

# Fields every record carries, in canonical order:
#   v    — schema version (int)
#   ts   — host UNIX timestamp, seconds (float); comparable across the
#          gang to clock-sync precision, which is exact for the
#          single-host CPU-simulation gangs this repo runs
#   seq  — per-writer monotonic sequence number; total-orders records
#          from one process even when ts ties at clock resolution
#   proc — writer identity: process index (int) or "supervisor"
#   kind — record type, one of EVENT_KINDS
ENVELOPE = ("v", "ts", "seq", "proc", "kind")

# Optional trace-context envelope fields (schema v2): any record MAY
# carry them; a record opts into the trace-context contract by carrying
# ``trace``, and from then on all three must be lowercase-hex ids of
# the W3C shapes below (128-bit trace, 64-bit span), with ``parent``
# additionally requiring ``span`` — a parent edge with no span of its
# own is meaningless.  Without ``trace``, ``span``/``parent`` stay
# free-form: the trainer's Tracer has emitted nesting-scope NAMES
# (``parent: "epoch"``) in those fields since v1, and v1 records must
# keep validating.  Propagation rules live in observability/tracecontext.
#   trace  — 32-hex trace id: one request's end-to-end journey
#   span   — 16-hex span id: this record's unit of work
#   parent — 16-hex id of the parent span within the same trace
TRACE_FIELDS = ("trace", "span", "parent")
_TRACE_HEX_LEN = {"trace": 32, "span": 16, "parent": 16}


def _is_hex_id(value, n: int) -> bool:
    return (
        isinstance(value, str) and len(value) == n
        and all(c in "0123456789abcdef" for c in value)
    )

# kind -> required kind-specific fields.  Extra fields are allowed (the
# schema is open for forward-compat); missing required fields are not.
EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "run_start": ("argv",),
    "run_end": ("status",),
    "span": ("name", "dur_s"),
    "metrics": ("snapshot",),
    "warm_start": ("mode",),
    "nan_skip": ("step",),
    "watchdog_fire": ("seconds_since_heartbeat",),
    "ckpt_retry": ("attempt",),
    "ckpt_fallback": (),
    "ckpt_save": ("epoch",),
    "chaos_inject": ("entry", "step"),
    "restart_attempt": ("attempt",),
    "restart_exhausted": ("attempt",),
    # Silent-data-corruption defense (training.integrity): the periodic
    # replica-digest check, a detection (rank = corrupt rank by majority
    # vote / replay tiebreak, or -1 for an unattributed shadow-mode
    # transient), and the checkpoint-free eviction of the corrupt rank
    # through the elastic gang.
    "sdc_check": ("step", "ok"),
    "sdc_detect": ("step", "rank"),
    "sdc_evict": ("step", "rank"),
    # Elastic gang runtime (runtime.elastic_gang / rendezvous):
    "membership_epoch": ("epoch", "roster", "size"),
    "gang_resize": ("epoch", "old_size", "new_size"),
    "resize_downtime": ("epoch", "seconds"),
    # Multi-host hardening layer (runtime.hostgang / launcher ladder):
    # a member in the heartbeat-hysteresis window (slow-but-alive, not
    # yet tombstoned), a rendezvous-store re-host onto the elected
    # survivor, and the supervisor's terminal degradation-ladder record
    # (rung = resize | restart | fail, fault = the chaos entry that
    # triggered it, or null for organic failures).
    "gang_suspect": ("member", "age_s"),
    "rdzv_rehost": ("generation", "owner"),
    "gang_verdict": ("rung", "fault"),
    "profile_start": ("reason",),
    "profile_stop": (),
    "loader_starved": ("window",),
    # Performance-attribution layer (cost_model / memory / goodput):
    "mfu": ("step", "model_flops_per_s"),
    "memory": ("step", "live_bytes"),
    "exec_memory": ("label",),
    "goodput": ("total_s", "goodput", "buckets"),
    # Alerting + longitudinal layer (alerts / baseline):
    "alert": ("rule", "step", "value", "threshold"),
    "run_summary": ("windows", "restarts"),
    # Static-analysis layer (ddplint):
    "lint_report": ("layer", "n_findings", "rules"),
    # Pipeline-parallel layer (measured schedule-bubble counters):
    "pp_phase": ("schedule", "n_stages", "counts"),
    # Serving layer (serving/engine request lifecycle):
    "request_admit": ("req",),
    "prefill_chunk": ("req", "start", "len"),
    "decode_step": ("step", "n_active"),
    "request_done": ("req", "ttft_s", "tokens"),
    "kv_evict": ("blocks",),
    # Serving fast path: an admission that mapped `tokens` cached
    # context tokens from the radix prefix cache (skipping their
    # prefill), and one speculative-verify dispatch (`drafted` tokens
    # proposed across the slot batch, `accepted` emitted).
    "prefix_hit": ("req", "tokens"),
    "spec_verify": ("step", "drafted", "accepted"),
    # Serving fleet (serving/fleet + serving/router): one routing
    # decision per request (`engine` = decode owner, `prefill` = None on
    # a session-affinity hit), one record per completed KV-block handoff
    # prefill→decode (`bytes` on the wire, `attempts` > 1 means digest
    # NAK + resend), the drain/fail rung when an engine dies (the
    # serving `gang_verdict`), and one per-tier latency rollup per run.
    "route_admit": ("req", "engine"),
    "kv_handoff": ("req", "blocks", "bytes"),
    "engine_verdict": ("engine", "rung"),
    "tier_summary": ("tier", "completed"),
    # Autotuner (tuning/): one record per candidate config (status =
    # pruned-memory / pruned-cost / baseline / measured / error: ...)
    # and one per search or apply outcome (winner = trial label or None).
    "tune_trial": ("trial", "status"),
    "tune_result": ("mode", "winner"),
}


def json_safe(value):
    """Coerce ``value`` to something ``json.dumps`` accepts losslessly
    enough for telemetry: numpy scalars/0-d arrays -> Python scalars,
    non-finite floats -> their repr string ("nan"/"inf"/"-inf") since
    JSON has no spelling for them, containers recursively, and anything
    else -> ``str``.  Bool is checked before int (bool is an int
    subclass) so True doesn't silently become 1... it stays True."""
    if value is None or isinstance(value, (bool, str)):
        return value
    if isinstance(value, int):
        return int(value)  # np.int* subclasses included
    if isinstance(value, float):
        # Normalize through float(): np.float64 SUBCLASSES float, and
        # its repr ("np.float64(nan)") must not leak into records.
        value = float(value)
        return value if math.isfinite(value) else repr(value)
    # numpy scalar / 0-d array without importing numpy: duck-type on
    # ndim==0 + .item().  (A 0-d ndarray is not Sized — len() raises —
    # so this check must come before any container handling.)
    if getattr(value, "ndim", None) == 0 and callable(getattr(value, "item", None)):
        return json_safe(value.item())
    if isinstance(value, dict):
        return {str(k): json_safe(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [json_safe(v) for v in value]
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return str(value)


def validate_record(rec, *, lineno: int | None = None) -> list[str]:
    """Return a list of problems with one decoded record (empty = valid)."""
    where = f"line {lineno}: " if lineno is not None else ""
    problems = []
    if not isinstance(rec, dict):
        return [f"{where}record is not a JSON object: {type(rec).__name__}"]
    for field in ENVELOPE:
        if field not in rec:
            problems.append(f"{where}missing envelope field {field!r}")
    v = rec.get("v")
    if v is not None and v not in SUPPORTED_VERSIONS:
        problems.append(
            f"{where}schema version {v!r} not in supported "
            f"{sorted(SUPPORTED_VERSIONS)}"
        )
    # ``trace`` opts the record into the trace-context contract; bare
    # ``span``/``parent`` are the Tracer's legacy nesting-scope names.
    if rec.get("trace") is not None:
        for field in TRACE_FIELDS:
            value = rec.get(field)
            if value is not None and not _is_hex_id(
                value, _TRACE_HEX_LEN[field]
            ):
                problems.append(
                    f"{where}{field} is not {_TRACE_HEX_LEN[field]}-hex: "
                    f"{value!r}"
                )
        if rec.get("parent") is not None and rec.get("span") is None:
            problems.append(f"{where}parent without span")
    kind = rec.get("kind")
    if kind is not None:
        if kind not in EVENT_KINDS:
            problems.append(f"{where}unknown kind {kind!r}")
        else:
            for field in EVENT_KINDS[kind]:
                if field not in rec:
                    problems.append(
                        f"{where}kind {kind!r} missing required field {field!r}"
                    )
    ts = rec.get("ts")
    if ts is not None and not isinstance(ts, (int, float)):
        problems.append(f"{where}ts is not a number: {ts!r}")
    seq = rec.get("seq")
    if seq is not None and not isinstance(seq, int):
        problems.append(f"{where}seq is not an int: {seq!r}")
    return problems


def validate_file(path) -> list[str]:
    """Validate one JSONL events file; returns all problems found."""
    problems = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                problems.append(f"line {lineno}: invalid JSON: {exc}")
                continue
            problems.extend(validate_record(rec, lineno=lineno))
    return problems
