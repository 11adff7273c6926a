"""Observability of the port's trainer: spans, metrics, per-worker event
logs, MFU, memory gauges, alerts, run summaries and profiler windows.

Copies of the JAX package's ``observability`` modules that its trainer uses
on the main path, writing the same schema-versioned records, so the repo's
readers (``scripts/check_events.py``, ``scripts/ddp_report.py``,
``scripts/perf_gate.py``) read the port's files as they read the
reference's.  ``schema``, ``events``, ``registry``, ``trace``,
``tracecontext``, ``goodput``, ``baseline``, ``alerts`` and ``straggler``
(the gang's per-rank step skew over a merged timeline) are verbatim
(stdlib only), as are ``trace_export``,
``critical_path`` (the lineage check and the TTFT decomposition, which the
serving CLI's ``--smoke`` reads) and ``httpmetrics`` (the fleet's loopback
``/metrics`` endpoints); ``cost_model`` takes the card's peaks,
``memory`` reads the CUDA caching allocator and ``profiler`` drives
``torch.profiler``.

Everything here is import-light (no torch at module scope).  The package
exports what the trainer and ``chip_smoke.py`` use; the rest of each
module is reached through the module.
"""

from .alerts import AlertEngine, parse_alert_spec
from .baseline import RunSummaryBuilder, append_run
from .cost_model import (
    MFUMeter,
    mlp_fwd_flops,
    peak_flops_for,
    simple_cnn_fwd_flops,
    train_step_flops,
    transformer_fwd_flops,
)
from .events import EventLog, events_path, merge_timeline, read_events
from .goodput import GoodputLedger
from .memory import MemoryTelemetry
from .profiler import ProfilerOrchestrator, parse_profile_steps, profile_trace
from .registry import JsonlExporter, MetricsRegistry, TextExporter
from .schema import validate_file
from .trace import Tracer

__all__ = [
    "AlertEngine",
    "EventLog",
    "GoodputLedger",
    "JsonlExporter",
    "MFUMeter",
    "MemoryTelemetry",
    "MetricsRegistry",
    "ProfilerOrchestrator",
    "RunSummaryBuilder",
    "TextExporter",
    "Tracer",
    "append_run",
    "events_path",
    "merge_timeline",
    "mlp_fwd_flops",
    "parse_alert_spec",
    "parse_profile_steps",
    "peak_flops_for",
    "profile_trace",
    "read_events",
    "simple_cnn_fwd_flops",
    "train_step_flops",
    "transformer_fwd_flops",
    "validate_file",
]
