"""Pull-based /metrics plane: a Prometheus-text HTTP endpoint per process.

Copy of the JAX package's ``observability/httpmetrics.py``.  Every fleet
process (the router and each engine worker, ``serving.fleet``) serves its
:class:`~.registry.MetricsRegistry` on a loopback ``http.server`` endpoint
in the Prometheus text exposition format (version 0.0.4), and the fleet
smoke scrapes each one mid-run to assert the required series exist.

Exposition subset on purpose: ``name value`` lines with ``# TYPE``
comments, no labels, no timestamps: exactly what the registry's flat
snapshot (counters/gauges as scalars, histograms flattened to
``name_count`` / ``name_sum`` / ... like ``TextExporter``) needs, and
what any Prometheus scraper parses.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import socketserver
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_NAME_OK = set(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"
)


def _sanitize(name: str) -> str:
    out = "".join(c if c in _NAME_OK else "_" for c in str(name))
    return out if out and not out[0].isdigit() else f"_{out}"


def prometheus_text(registry_or_snapshot) -> str:
    """Render a registry (anything with ``.snapshot()``) or a snapshot
    dict as Prometheus text.  Histogram dicts flatten to
    ``name_<stat>`` series; non-numeric values are skipped (the text
    format has no spelling for them)."""
    snap = (
        registry_or_snapshot.snapshot()
        if hasattr(registry_or_snapshot, "snapshot")
        else dict(registry_or_snapshot)
    )
    lines = []
    for name in sorted(snap):
        value = snap[name]
        flat = (
            {f"{name}_{k}": v for k, v in sorted(value.items())}
            if isinstance(value, dict) else {name: value}
        )
        for key, v in flat.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            key = _sanitize(key)
            lines.append(f"# TYPE {key} gauge")
            lines.append(f"{key} {float(v):g}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict[str, float]:
    """Inverse of :func:`prometheus_text`: ``{series name: value}``.
    Raises ``ValueError`` on a malformed sample line — the fleet smoke
    asserts scraped payloads PARSE, not just arrive."""
    out: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 2 or not all(c in _NAME_OK for c in parts[0]):
            raise ValueError(
                f"line {lineno}: not a 'name value' sample: {line!r}"
            )
        out[parts[0]] = float(parts[1])
    return out


class _LoopbackHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that names itself by its address: the stock
    ``server_bind`` resolves the host's name (``socket.getfqdn``), a
    lookup a loopback endpoint has no use for."""

    def server_bind(self):
        socketserver.TCPServer.server_bind(self)
        self.server_name, self.server_port = self.server_address[:2]


class MetricsHTTPServer:
    """A daemon-thread ``/metrics`` endpoint over one registry.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` and
    advertise it: the fleet workers put theirs in the hello message).
    ``snapshot_fn`` overrides the payload source for processes that
    compose several registries.
    """

    def __init__(
        self,
        registry=None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        snapshot_fn=None,
    ):
        if registry is None and snapshot_fn is None:
            raise ValueError("need a registry or a snapshot_fn")
        source = snapshot_fn if snapshot_fn is not None else registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                try:
                    body = prometheus_text(
                        source() if callable(source) else source
                    ).encode()
                # HTTP boundary: any render failure becomes a 500, never a
                # dead socket
                # ddplint: allow[broad-except] — HTTP boundary: a render failure becomes a 500
                except Exception as exc:  # noqa: BLE001
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        # Loopback listener (serving side; scrapers own the retry policy).
        self._httpd = _LoopbackHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"metrics-http:{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def scrape(address: str, *, timeout: float = 2.0) -> dict[str, float]:
    """GET ``http://address/metrics`` and parse it.  Raises ``OSError``
    on connection trouble and ``ValueError`` on unparseable payload:
    callers decide whether a dead endpoint is fatal (the smoke) or not."""
    url = f"http://{address}/metrics"
    # No proxy: the endpoints are loopback ones, whatever the environment's
    # http_proxy says.
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(url, timeout=timeout) as resp:  # noqa: S310
        return parse_prometheus_text(resp.read().decode())
