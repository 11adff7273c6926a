"""Device-memory telemetry: the caching allocator's counters, sampled at
window boundaries only.

Counterpart of the JAX package's ``observability/memory.py``.  The
reference reads ``jax.live_arrays()`` and ``device.memory_stats()``; on the
card the allocator keeps the same numbers itself:

- ``live_array_bytes`` -> ``torch.cuda.memory_allocated``: the bytes of the
  tensors alive now;
- ``device_memory_stats`` -> ``torch.cuda.memory_stats`` (bytes reserved
  from CUDA, its peak and the allocator's limit) and
  ``torch.cuda.max_memory_allocated``.

``hbm_budget_bytes`` is the autotuner's memory budget: the card's total
memory, the reference's 32 GiB default off the card.

Each is a host read of the allocator's counters, never a device value, and
``MemoryTelemetry.sample`` runs only where the StepTimer's window closes.
On the CPU there is no allocator to ask: the byte fields are ``None``.

Left out: the reference's one-time ``exec_memory`` event (the compiler's
static budget of the step program, ``compiled.memory_analysis()``) — an
eager PyTorch step has no compiled program to ask.

Module-import rule: stdlib only at module scope; torch is imported inside
the sampling functions.
"""

from __future__ import annotations


def _cuda(device) -> bool:
    import torch

    return device is not None and torch.device(device).type == "cuda"


def live_array_bytes(device=None) -> int | None:
    """Bytes of the tensors alive on ``device`` (the allocator's count);
    None off the card."""
    import torch

    return int(torch.cuda.memory_allocated(device)) if _cuda(device) else None


def device_memory_stats(device=None) -> dict | None:
    """The allocator's reserved bytes, their peak, the peak of the live
    bytes (``max_memory_allocated``) and the card's size; None off the
    card."""
    if not _cuda(device):
        return None
    import torch

    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("reserved_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("reserved_bytes.all.peak", 0)),
        "peak_allocated_bytes": int(torch.cuda.max_memory_allocated(device)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


#: Fallback per-device budget when no CUDA device is visible (the CPU): the
#: reference's default (one TPU v4 chip's 32 GiB), so the autotuner's
#: analytic memory pruning prices against the same number on the CPU.
DEFAULT_HBM_BUDGET_BYTES = 32 * 1024**3


def hbm_budget_bytes(devices=None) -> int:
    """Per-device memory budget: the smallest total memory over ``devices``
    (default: every visible CUDA device) — the tightest card is the one
    that runs out, as the reference takes the minimum of its allocators'
    ``bytes_limit`` — else ``DEFAULT_HBM_BUDGET_BYTES``.  The total is the
    device's property (the total ``torch.cuda.mem_get_info`` reports),
    read without making a CUDA context on every visible card."""
    import torch

    if devices is None:
        devices = range(torch.cuda.device_count()) if torch.cuda.is_available() else ()
    devices = [torch.device("cuda", d) if isinstance(d, int) else torch.device(d) for d in devices]
    limits = [int(torch.cuda.get_device_properties(d).total_memory) for d in devices if d.type == "cuda"]
    return min(limits) if limits else DEFAULT_HBM_BUDGET_BYTES


class MemoryTelemetry:
    """Window-boundary memory sampler feeding gauges + ``memory`` events.

    ``sample(step)`` is the only recurring entry point and the caller
    contract is the StepTimer rule: call it where the loop already
    drained (throughput-window boundaries), never per step.  Tracks the
    live-bytes high-water mark across samples, and the allocator's own
    peak (``max_memory_allocated``), which also sees the bytes alive
    between samples."""

    def __init__(self, registry=None, events=None, device=None):
        self.registry = registry
        self.events = events
        self.device = device
        self.live_hwm_bytes = 0
        self.device_peak_bytes = 0

    def sample(self, step: int) -> dict:
        live = live_array_bytes(self.device)
        out = {"step": step, "live_bytes": live, "live_hwm_bytes": None}
        if live is not None:
            self.live_hwm_bytes = max(self.live_hwm_bytes, live)
            out["live_hwm_bytes"] = self.live_hwm_bytes
        stats = device_memory_stats(self.device)
        if stats:
            self.device_peak_bytes = max(self.device_peak_bytes, stats["peak_allocated_bytes"])
            out["device_bytes_in_use"] = stats["bytes_in_use"]
            out["device_peak_bytes"] = self.device_peak_bytes
            out["device_reserved_peak_bytes"] = stats["peak_bytes_in_use"]
            out["device_bytes_limit"] = stats["bytes_limit"]
        if self.registry is not None and live is not None:
            g = self.registry.gauge
            g("mem_live_bytes").set(live)
            g("mem_live_hwm_bytes").set(self.live_hwm_bytes)
            if stats:
                g("mem_device_bytes_in_use").set(out["device_bytes_in_use"])
                g("mem_device_peak_bytes").set(self.device_peak_bytes)
        if self.events is not None:
            self.events.emit("memory", **out)
        return out
