"""Per-worker JSONL event log + launcher-side gang-timeline merge.

Each gang member appends schema-versioned records (``schema.EVENT_KINDS``)
to its own ``events-p{proc}.jsonl`` — one writer per file, so no
cross-process locking and no torn lines.  The supervisor writes
``events-supervisor.jsonl``.  On exit the launcher merges every per-writer
file into a single ``timeline.jsonl`` ordered by ``(ts, seq)`` — the gang
timeline that lets a watchdog fire on rank 3 be read in context of what
every other rank was doing at that instant.

Emission is hot-path-safe by construction: ``emit`` stamps the host
clock, coerces with ``json_safe`` (pure host work), and appends to a
line-buffered file.  It never touches a device value, so it can never
force a sync.

Module-import rule: stdlib only (see schema.py).
"""

from __future__ import annotations

import glob
import heapq
import json
import os
import time

from .schema import SCHEMA_VERSION, json_safe

EVENTS_GLOB = "events-*.jsonl"
TIMELINE_NAME = "timeline.jsonl"


def events_path(events_dir: str, proc) -> str:
    return os.path.join(events_dir, f"events-p{proc}.jsonl")


class EventLog:
    """Append-only JSONL writer for one process.

    Records carry a per-writer monotonic ``seq`` so the merged timeline
    has a total order within each writer even when two events land in
    the same clock tick.  Opened in append mode: a supervised respawn
    reuses the same path and its records continue the same file rather
    than erasing the previous incarnation's history.
    """

    def __init__(self, path: str, proc):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self.proc = proc
        self._seq = 0
        self._fh = open(path, "a", buffering=1)  # line-buffered

    def emit(self, kind: str, **fields) -> dict:
        rec = {
            "v": SCHEMA_VERSION,
            "ts": time.time(),
            "seq": self._seq,
            "proc": self.proc,
            "kind": kind,
        }
        self._seq += 1
        for k, v in fields.items():
            rec[k] = json_safe(v)
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def flush(self) -> None:
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        try:
            self._fh.close()
        except (OSError, ValueError):
            pass

    # Context-manager convenience for tests and short-lived tools.
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def read_events(path: str) -> list[dict]:
    """Decode one JSONL events file, skipping blank lines.  Malformed
    lines raise — a half-written trailing line only happens if a writer
    was SIGKILLed mid-record, and the validator reports it properly."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def _merge_key(rec: dict) -> tuple:
    return (rec.get("ts", 0.0), rec.get("seq", 0), str(rec.get("proc", "")))


def _iter_records(path: str):
    """Yield decoded records from one per-writer file, dropping torn
    lines (the tail of a SIGKILLed writer).  One writer per file means
    records are already in ``(ts, seq)`` order within the file, which is
    what lets the merge stream instead of sort."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail of a killed writer


def merge_timeline(events_dir: str, out_name: str = TIMELINE_NAME) -> str | None:
    """Merge every per-writer events file in ``events_dir`` into one
    timeline ordered by ``(ts, seq, proc)``; returns the timeline path,
    or None when there are no event files to merge.

    Streaming k-way heap merge: each input file is one writer's
    append-only log and therefore already (ts, seq)-ordered, so the
    merge holds one record per file instead of the whole gang history —
    supervisor exit-merge stays O(files) resident however long the run
    ran.  ``heapq.merge`` tolerates a locally out-of-order input (a
    clock step mid-run) by emitting it late rather than raising, which
    matches the old sort-everything behaviour closely enough for a
    telemetry timeline.  Tolerates a torn final line in a worker file (a
    killed worker is exactly when the timeline matters most) by
    dropping it.
    """
    paths = sorted(glob.glob(os.path.join(events_dir, EVENTS_GLOB)))
    if not paths:
        return None
    out_path = os.path.join(events_dir, out_name)
    tmp = out_path + ".tmp"
    streams = [_iter_records(p) for p in paths]
    with open(tmp, "w") as fh:
        for rec in heapq.merge(*streams, key=_merge_key):
            fh.write(json.dumps(rec) + "\n")
    os.replace(tmp, out_path)
    return out_path


def load_timeline(events_dir: str) -> list[dict]:
    """Load the merged gang timeline for ``events_dir``, producing it
    first if the run died before its exit-merge ran.  Returns [] when
    there are no events at all.  Shared by the offline consumers
    (ddp_report / ddp_trace / baseline extraction)."""
    timeline = os.path.join(events_dir, TIMELINE_NAME)
    if not os.path.exists(timeline):
        if merge_timeline(events_dir) is None:
            return []
    return list(_iter_records(timeline))
