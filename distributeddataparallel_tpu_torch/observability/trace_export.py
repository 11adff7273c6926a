"""Gang timeline -> Chrome/Perfetto ``trace_event`` JSON.

The merged ``timeline.jsonl`` already totally orders every span and
telemetry event across the gang; this module re-expresses it in the
trace_event format so a whole run — every incarnation, every rank, the
supervisor's restart decisions — is inspectable in ``ui.perfetto.dev``
(or ``chrome://tracing``) next to XLA profiler captures.

Mapping:

* one *process* track per writer — supervisor is pid 0, rank ``r`` is
  pid ``r + 1`` — with ``process_name``/``thread_name`` metadata events;
* ``span`` events become ``"X"`` complete events.  The event log stamps
  a span at *exit* with its duration, so the trace start is
  ``ts - dur_s``; nesting is recovered by Perfetto from containment,
  which holds because spans on one writer are properly nested;
* counter tracks (``"C"``): ``step_s`` sampled from step spans, ``mfu``
  from mfu events, ``memory_bytes`` from memory events;
* discrete incidents — nan_skip, chaos_inject, watchdog_fire,
  restart_attempt / restart_exhausted, loader_starved, alert — become
  ``"i"`` instant events, so a restart is a visible mark on the
  supervisor track at the moment it happened;
* spans carrying schema-v2 trace context get a *per-trace thread
  track* (``req:<trace8>``) inside their process — concurrent requests
  stop rendering as one falsely-nested pile on tid 0 — and each
  multi-span trace is stitched across processes with legacy flow
  events (``"s"``/``"t"``/``"f"`` sharing the trace id), so clicking a
  request's root span in Perfetto draws arrows through its prefill →
  handoff → decode spans on whichever engines served it.

Timestamps are microseconds relative to the earliest instant in the
run (trace viewers want small numbers, not epoch µs).

Copy of the JAX package's ``observability/trace_export.py`` without
``write_trace`` (the port's serving CLI validates the trace and writes
none).  Module-import rule: stdlib only.
"""

from __future__ import annotations

#: kind -> counter-track name, value field
_COUNTER_KINDS = {
    "mfu": ("mfu", "mfu"),
    "memory": ("memory_bytes", "live_bytes"),
    # Serving: active decode slots over time — occupancy at a glance.
    "decode_step": ("active_slots", "n_active"),
    # Speculative decoding: accepted tokens per verify dispatch — the
    # accept-length track dropping toward n_active means drafts stopped
    # landing.
    "spec_verify": ("spec_accepted", "accepted"),
    # Serving fleet: bytes shipped per prefill->decode KV-block handoff
    # — spikes line up with prefill-tier completions on the span tracks.
    "kv_handoff": ("handoff_bytes", "bytes"),
}

#: kinds rendered as instant events (fields worth carrying into args)
_INSTANT_KINDS = {
    "nan_skip": ("step",),
    "chaos_inject": ("entry", "step"),
    "watchdog_fire": ("seconds_since_heartbeat",),
    "restart_attempt": ("attempt", "exit_code"),
    "restart_exhausted": ("attempt",),
    "loader_starved": ("window", "step"),
    "alert": ("rule", "step", "value", "threshold"),
    # Serving lifecycle marks (request spans come through "span"
    # records named "request:<rid>" and need no mapping here).
    "request_admit": ("req", "prompt_tokens", "slot", "queued_s"),
    "prefill_chunk": ("req", "start", "len"),
    "request_done": ("req", "ttft_s", "tokens", "latency_s"),
    "kv_evict": ("blocks", "req", "reason"),
    "prefix_hit": ("req", "tokens", "ctx"),
    # Serving fleet: routing decisions and engine-death verdicts.
    "route_admit": ("req", "engine", "prefill", "affinity", "session"),
    "engine_verdict": ("engine", "rung", "tier", "requeued", "reason"),
}

SUPERVISOR_PID = 0


def _pid(proc) -> int:
    """supervisor -> 0, rank r -> r + 1, unknown writers -> hash-free
    stable fallback pid 999 (keeps the trace loadable rather than
    raising on a foreign record)."""
    if proc == "supervisor":
        return SUPERVISOR_PID
    try:
        return int(proc) + 1
    except (TypeError, ValueError):
        return 999


def _track_name(proc) -> str:
    if proc == "supervisor":
        return "supervisor"
    try:
        return f"rank {int(proc)}"
    except (TypeError, ValueError):
        return str(proc)


def _span_start_s(rec: dict) -> float:
    return float(rec.get("ts", 0.0)) - float(rec.get("dur_s", 0.0) or 0.0)


def _args(rec: dict, fields) -> dict:
    out = {}
    for f in fields:
        if f in rec and rec[f] is not None:
            out[f] = rec[f]
    return out


def to_trace_events(records: list[dict]) -> dict:
    """Convert merged timeline records to a trace_event JSON object:
    ``{"traceEvents": [...], "displayTimeUnit": "ms"}``.  Pure host
    work over already-decoded records; ignores kinds it has no mapping
    for rather than failing on future schema additions."""
    # Epoch of the trace: the earliest instant anywhere, including span
    # starts (a span's exit ts may not be the first thing that happened).
    t0 = None
    for rec in records:
        ts = rec.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        start = _span_start_s(rec) if rec.get("kind") == "span" else float(ts)
        t0 = start if t0 is None else min(t0, start)
    if t0 is None:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def us(ts_s: float) -> float:
        return max(0.0, (ts_s - t0) * 1e6)

    events: list[dict] = []
    seen_pids: dict[int, str] = {}
    # Per-trace track + flow bookkeeping: trace id -> tid (tid 0 stays
    # the writer's "main" track), and trace id -> its span events in
    # append order (flow-stitched after the scan).
    trace_tids: dict[str, int] = {}
    flow_groups: dict[str, list[dict]] = {}
    for rec in records:
        proc = rec.get("proc")
        kind = rec.get("kind")
        ts = rec.get("ts")
        if kind is None or not isinstance(ts, (int, float)):
            continue
        pid = _pid(proc)
        seen_pids.setdefault(pid, _track_name(proc))

        if kind == "span":
            dur_s = rec.get("dur_s")
            if not isinstance(dur_s, (int, float)):
                continue
            trace_id = rec.get("trace")
            tid = 0
            if isinstance(trace_id, str) and trace_id:
                tid = trace_tids.setdefault(trace_id, len(trace_tids) + 1)
            ev = {
                "ph": "X",
                "name": str(rec.get("name", "span")),
                "cat": "span",
                "pid": pid,
                "tid": tid,
                "ts": us(_span_start_s(rec)),
                "dur": float(dur_s) * 1e6,
                "args": _args(
                    rec,
                    ("step", "epoch", "depth", "parent", "trace",
                     "span", "req", "engine"),
                ),
            }
            events.append(ev)
            if tid:
                flow_groups.setdefault(trace_id, []).append(ev)
            # step spans double as the step_s counter samples
            if rec.get("name") == "step":
                events.append({
                    "ph": "C",
                    "name": "step_s",
                    "pid": pid,
                    "tid": 0,
                    "ts": us(float(ts)),
                    "args": {"step_s": float(dur_s)},
                })
        elif kind in _COUNTER_KINDS:
            track, field = _COUNTER_KINDS[kind]
            value = rec.get(field)
            if isinstance(value, (int, float)):
                events.append({
                    "ph": "C",
                    "name": track,
                    "pid": pid,
                    "tid": 0,
                    "ts": us(float(ts)),
                    "args": {track: float(value)},
                })
        elif kind in _INSTANT_KINDS:
            events.append({
                "ph": "i",
                "name": kind,
                "cat": "incident",
                "pid": pid,
                "tid": 0,
                "ts": us(float(ts)),
                # supervisor incidents concern the whole gang
                "s": "g" if pid == SUPERVISOR_PID else "p",
                "args": _args(rec, _INSTANT_KINDS[kind]),
            })
            # route_admit carries the router's queue depth: double it
            # into a counter track (like step spans double as step_s).
            if kind == "route_admit" and isinstance(
                rec.get("queue_depth"), (int, float)
            ):
                events.append({
                    "ph": "C",
                    "name": "router_queue",
                    "pid": pid,
                    "tid": 0,
                    "ts": us(float(ts)),
                    "args": {
                        "router_queue": float(rec["queue_depth"])
                    },
                })

    # Flow stitching: each multi-span trace becomes one flow (legacy
    # "s"/"t"/"f" phases sharing the trace id), anchored at each span's
    # start on its own pid/tid — the cross-process arrow through a
    # request's prefill/handoff/decode hops.
    flows: list[dict] = []
    for trace_id, group in flow_groups.items():
        if len(group) < 2:
            continue
        group = sorted(group, key=lambda e: (e["ts"], e["ts"] + e["dur"]))
        for i, anchor in enumerate(group):
            ph = "s" if i == 0 else ("f" if i == len(group) - 1 else "t")
            fev = {
                "ph": ph,
                "name": f"req:{trace_id[:8]}",
                "cat": "trace",
                "id": trace_id[:16],
                "pid": anchor["pid"],
                "tid": anchor["tid"],
                "ts": anchor["ts"],
            }
            if ph == "f":
                fev["bp"] = "e"  # bind to the enclosing slice
            flows.append(fev)
    events.extend(flows)

    # Per-track monotonic order (viewers require ts-sorted streams per
    # track; a global ts sort gives that and keeps the file diffable).
    events.sort(key=lambda e: (e["ts"], e["pid"]))

    trace8_of_tid = {
        tid: f"req:{trace_id[:8]}" for trace_id, tid in trace_tids.items()
    }
    trace_threads = sorted({
        (e["pid"], e["tid"]) for e in events
        if e.get("ph") == "X" and e.get("tid")
    })
    meta: list[dict] = []
    for pid in sorted(seen_pids):
        meta.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": seen_pids[pid]},
        })
        meta.append({
            "ph": "M", "name": "process_sort_index", "pid": pid, "tid": 0,
            "args": {"sort_index": pid},
        })
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "main"},
        })
    for pid, tid in trace_threads:
        meta.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": trace8_of_tid.get(tid, f"trace {tid}")},
        })
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_trace(trace: dict) -> list[str]:
    """Structural check of a trace_event object (empty list = valid):
    required top-level shape, required per-event fields by phase,
    per-(pid, tid) monotonic timestamps, and flow integrity — every
    flow id must open with exactly one ``"s"``, close with a ``"f"``,
    and never continue (``"t"``/``"f"``) before it opened.  Used by
    tests and by ``ddp_trace.py --check`` before handing the file to a
    viewer."""
    problems = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["trace is not an object with a traceEvents array"]
    events = trace["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not an array"]
    last_ts: dict[tuple, float] = {}
    flows: dict[str, list[tuple[str, float]]] = {}  # id -> [(ph, ts)]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "C", "i", "M", "s", "t", "f"):
            problems.append(f"event {i}: unsupported phase {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i}: missing {field!r}")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"event {i}: complete event without dur")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            problems.append(f"event {i}: instant event bad scope {ev.get('s')!r}")
        if ph in ("s", "t", "f"):
            fid = ev.get("id")
            if not isinstance(fid, (str, int)):
                problems.append(f"event {i}: flow event without id")
                continue
            flows.setdefault(str(fid), []).append((ph, float(ts)))
        key = (ev.get("pid"), ev.get("tid"))
        if ts < last_ts.get(key, float("-inf")):
            problems.append(
                f"event {i}: ts {ts} regresses on track {key}"
            )
        last_ts[key] = float(ts)
    # Flow integrity, order-insensitive (same-ts events from different
    # pids interleave arbitrarily in the global sort): each id opens
    # exactly once, closes exactly once, and the open/close bracket
    # every step in time.
    for fid, phases in sorted(flows.items()):
        n_s = sum(1 for ph, _ in phases if ph == "s")
        n_f = sum(1 for ph, _ in phases if ph == "f")
        if n_s != 1 or n_f != 1:
            problems.append(
                f"flow {fid}: {n_s} start(s) / {n_f} finish(es), want "
                "exactly 1 of each — dangling flow id"
            )
            continue
        t_s = next(t for ph, t in phases if ph == "s")
        t_f = next(t for ph, t in phases if ph == "f")
        if any(not t_s <= t <= t_f for ph, t in phases if ph == "t"):
            problems.append(
                f"flow {fid}: step outside its start/finish window"
            )
    return problems
