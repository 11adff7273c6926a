"""MetricsRegistry: named counters / gauges / histograms + exporters.

One registry per process.  Instruments are get-or-create by name so any
layer (loader, fault tolerance, warm start, the train loop) can grab
``registry.counter("nan_skips")`` without plumbing object handles
through every constructor.  ``bind(name, fn)`` registers a provider
whose value is read only at export time — the loader's prefetch-queue
depth costs nothing per step this way.

Exporters are pluggable; two ship here:

- ``JsonlExporter``    — each export emits a ``metrics`` event (full
                         snapshot) into the per-worker event log;
- ``TextExporter``     — rank-0 writes a plaintext ``/metrics``-style
                         snapshot file (atomic tmp+rename), the thing a
                         node-local scraper or a human `cat`s.

Export is host-only work: snapshot() reads Python numbers, never device
arrays, so exporting at an arbitrary step cannot force a sync.

Module-import rule: stdlib only (see schema.py).
"""

from __future__ import annotations

import math
import os

from .schema import json_safe


class Counter:
    """Monotonic count (events since process start)."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def read(self):
        return self.value


class Gauge:
    """Point-in-time value; ``set`` a number or ``set_fn`` a provider
    that is called lazily at snapshot time."""

    def __init__(self):
        self.value = None
        self._fn = None

    def set(self, value) -> None:
        self.value = value
        self._fn = None

    def set_fn(self, fn) -> None:
        self._fn = fn

    def read(self):
        if self._fn is not None:
            try:
                return self._fn()
            # ddplint: allow[broad-except] — user gauge callback; a broken
            # gauge must read None, not kill the metrics scrape
            except Exception:
                return None
        return self.value


class Histogram:
    """Streaming summary (count/sum/min/max/last) — enough to answer
    "how long do ckpt saves take" without storing every observation."""

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = None

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        self.last = value

    def read(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(self.sum / self.count, 6),
            "min": round(self.min, 6),
            "max": round(self.max, 6),
            "last": round(self.last, 6),
        }


class MetricsRegistry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._exporters: list[object] = []

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def bind(self, name: str, fn) -> None:
        """Gauge whose value is pulled from ``fn()`` at snapshot time."""
        self.gauge(name).set_fn(fn)

    def add_exporter(self, exporter) -> None:
        self._exporters.append(exporter)

    def snapshot(self) -> dict:
        """Read every instrument; pure host work, JSON-safe values."""
        return {
            name: json_safe(m.read())
            for name, m in sorted(self._metrics.items())
        }

    def export(self, **context) -> dict:
        snap = self.snapshot()
        for exporter in self._exporters:
            exporter.export(snap, **context)
        return snap


class JsonlExporter:
    """Routes each snapshot into the per-worker event log."""

    def __init__(self, events):
        self.events = events

    def export(self, snapshot: dict, **context) -> None:
        self.events.emit("metrics", snapshot=snapshot, **context)


class TextExporter:
    """Plaintext ``/metrics``-style snapshot file (one writer: rank 0).

    Flat metrics print as ``name value``; dict-valued metrics (histogram
    summaries) as ``name_key value`` — close enough to the Prometheus
    exposition format for a human or a file-based scraper, without
    pretending to be a real endpoint."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path

    def export(self, snapshot: dict, **context) -> None:
        lines = []
        for name, value in snapshot.items():
            if isinstance(value, dict):
                for k, v in value.items():
                    lines.append(f"{name}_{k} {v}")
            else:
                lines.append(f"{name} {value}")
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        os.replace(tmp, self.path)
