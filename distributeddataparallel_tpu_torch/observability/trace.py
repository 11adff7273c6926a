"""Tracer: nested, low-overhead host-side spans.

``with tracer.span("step", step=gstep):`` stamps ``time.perf_counter``
at entry/exit and emits a ``span`` event with the duration, its nesting
``depth``, and its ``parent`` span name.  That is the ENTIRE cost: two
host clock reads and a dict append.  A span never reads a device value,
so wrapping the dispatch of an async jax computation measures dispatch
time — which is the honest number for an async step.  Wall-clock truth
for device work still comes from the window boundaries where
BoundedDispatch drains; spans covering those drains (log/eval/epoch
edges) include the settled time naturally.

Module-import rule: stdlib only (see schema.py).
"""

from __future__ import annotations

import contextlib
import time


class Tracer:
    """Emits nested span records into an EventLog and (optionally) a
    MetricsRegistry histogram per span name.

    ``events`` and ``registry`` are both optional: with neither, spans
    cost two clock reads and nothing else, so call sites never need to
    guard on whether observability is enabled.
    """

    def __init__(self, events=None, registry=None):
        self.events = events
        self.registry = registry
        self._stack: list[str] = []

    @property
    def depth(self) -> int:
        return len(self._stack)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a scope.  ``attrs`` must be host values (ints, floats,
        strings) — passing a jax.Array here would defeat the no-sync
        guarantee at serialization time."""
        parent = self._stack[-1] if self._stack else None
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            self._stack.pop()
            if self.events is not None:
                self.events.emit(
                    "span",
                    name=name,
                    dur_s=round(dur, 6),
                    depth=len(self._stack),
                    parent=parent,
                    **attrs,
                )
            if self.registry is not None:
                self.registry.histogram(f"span_{name}_s").observe(dur)
