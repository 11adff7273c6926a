"""W3C-style trace context as plain data — deterministic, stdlib-only.

A trace context is two hex strings: a 128-bit ``trace_id`` naming one
request's end-to-end journey (router -> prefill -> KV handoff ->
decode) and a 64-bit ``span_id`` naming one unit of work inside it.
Spans form a tree via ``parent_id``; exactly one span per trace has no
parent (the root).

Everything here is **derived, never drawn**: ids come from sha256 over
``(seed, request id, role, ...)`` name parts, so a VirtualClock replay
of the same (seed, config) run produces byte-identical trace ids — the
property the deterministic-replay test pins.  No ``os.urandom``, no
clock, no global counter.

The context rides as *plain data* (three envelope fields ``trace`` /
``span`` / ``parent``, schema v2) on event records, ``Request``
objects, KV-handoff frame headers (inside ``meta``), router admission
records, fleet control-socket messages, and rendezvous RPC payloads.
Processes that receive a context re-emit it verbatim or derive child
spans from it; no process ever invents an unrelated id for work it did
on someone else's behalf.

Interop shape follows W3C Trace Context (``traceparent:
00-<trace>-<span>-01``) so external tooling can join these traces, but
propagation here is explicit-field, not header parsing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re

TRACE_ID_HEX = 32   # 128-bit
SPAN_ID_HEX = 16    # 64-bit

_TRACE_RE = re.compile(r"^[0-9a-f]{32}$")
_SPAN_RE = re.compile(r"^[0-9a-f]{16}$")

_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\x1f")  # unit separator: ("ab","c") != ("a","bc")
    return h.hexdigest()


def derive_trace_id(*parts) -> str:
    """128-bit hex trace id from name parts (typically (seed, rid))."""
    if not parts:
        raise ValueError("derive_trace_id needs at least one name part")
    return _digest("trace", *parts)[:TRACE_ID_HEX]


def derive_span_id(trace_id: str, *parts) -> str:
    """64-bit hex span id, scoped to ``trace_id`` by construction so
    equal role names in different traces never collide."""
    if not parts:
        raise ValueError("derive_span_id needs at least one name part")
    return _digest("span", trace_id, *parts)[:SPAN_ID_HEX]


def is_trace_id(value) -> bool:
    return isinstance(value, str) and bool(_TRACE_RE.match(value))


def is_span_id(value) -> bool:
    return isinstance(value, str) and bool(_SPAN_RE.match(value))


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """One span's identity inside a trace.  Immutable; derive children
    with :meth:`child`, serialize with :meth:`to_fields`."""

    trace_id: str
    span_id: str
    parent_id: str | None = None

    def __post_init__(self):
        if not is_trace_id(self.trace_id):
            raise ValueError(f"bad trace_id {self.trace_id!r}")
        if not is_span_id(self.span_id):
            raise ValueError(f"bad span_id {self.span_id!r}")
        if self.parent_id is not None and not is_span_id(self.parent_id):
            raise ValueError(f"bad parent_id {self.parent_id!r}")

    def child(self, *parts) -> "SpanContext":
        """A child span named by ``parts`` (deterministic: same parent
        + same parts -> same child id)."""
        return SpanContext(
            trace_id=self.trace_id,
            span_id=derive_span_id(self.trace_id, self.span_id, *parts),
            parent_id=self.span_id,
        )

    def to_fields(self) -> dict:
        """The schema-v2 envelope fields this context contributes to an
        event record (or any JSON payload)."""
        out = {"trace": self.trace_id, "span": self.span_id}
        if self.parent_id is not None:
            out["parent"] = self.parent_id
        return out

    def traceparent(self) -> str:
        """W3C ``traceparent`` header form (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def root_context(*parts) -> SpanContext:
    """The root span of a new trace named by ``parts`` — trace id and
    root span id both derived from the same name, ``parent_id=None``."""
    trace_id = derive_trace_id(*parts)
    return SpanContext(
        trace_id=trace_id,
        span_id=derive_span_id(trace_id, "root"),
        parent_id=None,
    )


def from_fields(record) -> SpanContext | None:
    """Rebuild a context from a record/payload carrying ``trace`` /
    ``span`` (and optionally ``parent``) fields; None if absent or
    malformed — propagation is best-effort, never a crash."""
    if not isinstance(record, dict):
        return None
    trace, span = record.get("trace"), record.get("span")
    if not (is_trace_id(trace) and is_span_id(span)):
        return None
    parent = record.get("parent")
    if parent is not None and not is_span_id(parent):
        return None
    return SpanContext(trace_id=trace, span_id=span, parent_id=parent)


def from_traceparent(header: str) -> SpanContext | None:
    """Parse a W3C ``traceparent`` string; None on mismatch."""
    m = _TRACEPARENT_RE.match(header.strip()) \
        if isinstance(header, str) else None
    if not m:
        return None
    return SpanContext(trace_id=m.group(1), span_id=m.group(2))
