"""The trainer's telemetry: event log, spans, metrics, MFU, memory, alerts,
goodput, run summary and profiler windows, wired as the reference's
``dpp.py`` wires them (``dpp.py:1294-1346``, ``:2111-2226``, ``:2607-2780``,
``:2980-3052``).

``Telemetry(args, ...)`` builds what the flags ask for; the train loop calls

- ``span(name, **attrs)`` around an epoch, a step, an eval, a save;
- ``step_start(gstep)`` before a step and ``step_end(gstep)`` after it: the
  profiler window, the ``steps_total`` counter, the StepTimer and, where
  its window closes, the MFU meter, the memory sampler, the run summary's
  sample and the alert rules, then the periodic metrics snapshot;
- ``nan_skip(...)`` after a step the non-finite guard skipped, and
  ``watchdog_fire(diagnostic)`` from the step watchdog's thread: the fault
  counters and their events, as the reference emits them;
- ``add_goodput(bucket, seconds)`` and ``reset_window()`` around eval and
  checkpoints; ``close(status)`` at the end, which writes the final
  snapshot, the ``goodput``, ``run_summary`` and ``run_end`` events,
  merges the per-writer files into ``timeline.jsonl`` (rank 0) and appends
  the run to ``--runs-dir``.  Under supervision (``_DDP_SUPERVISED``) the
  launcher does those two after the last incarnation instead, so the merge
  sees every attempt's events.

The checkpointer (``ckpt_save``, ``ckpt_retry``, ``ckpt_fallback``), the
fault injector (``chaos_inject``) and the supervisor (``restart_attempt``,
``restart_exhausted``) write their records into the same event logs.

Nothing here reads a device value per step: the loop already drains the
device after every step, and the meters run only where the StepTimer's
window closes.  With no telemetry flag every call is a no-op but the
StepTimer's clock reads.
"""

from __future__ import annotations

import contextlib
import os
import sys

from distributeddataparallel_tpu_torch.observability import (
    AlertEngine,
    EventLog,
    GoodputLedger,
    JsonlExporter,
    MemoryTelemetry,
    MetricsRegistry,
    MFUMeter,
    ProfilerOrchestrator,
    RunSummaryBuilder,
    TextExporter,
    Tracer,
    append_run,
    events_path,
    merge_timeline,
    parse_alert_spec,
    parse_profile_steps,
    peak_flops_for,
    profile_trace,
)
from distributeddataparallel_tpu_torch.utils.logging import log0, warn0
from distributeddataparallel_tpu_torch.utils.metrics import FaultCounters, StepTimer


class Telemetry:
    def __init__(self, args, *, rank: int, world_size: int, items_per_step: int,
                 unit: str, sync=None):
        self.args, self.rank, self.world_size, self.sync = args, rank, world_size, sync
        self.items_per_step, self.unit = items_per_step, unit
        self.counters = FaultCounters()
        self.counters.restarts = int(os.environ.get("DDP_RESTART_ATTEMPT", "0") or 0)
        self.events = self.registry = self.tracer = self.prof = None
        if args.events_dir:
            self.events = EventLog(events_path(args.events_dir, rank), rank)
            self.events.emit("run_start", argv=sys.argv[1:], attempt=self.counters.restarts,
                             devices=world_size)
            self.registry = MetricsRegistry()
            self.registry.add_exporter(JsonlExporter(self.events))
            if rank == 0:
                # Rank-0 plaintext /metrics-style snapshot, refreshed at
                # every export.
                self.registry.add_exporter(TextExporter(os.path.join(args.events_dir, "metrics.txt")))
            self.tracer = Tracer(self.events, self.registry)
            self.registry.bind("faults", self.counters.summary)
        # Traces go to --profile-dir when given, else EVENTS_DIR/xprof.
        prof_dir = args.profile_dir or (
            os.path.join(args.events_dir, "xprof") if args.events_dir else None)
        if (args.events_dir or args.profile_steps) and prof_dir:
            self.prof = ProfilerOrchestrator(prof_dir, window=parse_profile_steps(args.profile_steps),
                                             events=self.events, rank=rank)
        self.timer = StepTimer(window=max(20, args.log_every), n_chips=world_size)
        self.goodput = GoodputLedger() if self.events is not None else None
        self.mfu_meter = self.mem_tel = None
        self.steps_total = self.registry.counter("steps_total") if self.registry is not None else None
        self.alert_engine = None
        if args.alerts is not None:
            self.alert_engine = AlertEngine(
                parse_alert_spec(args.alerts), events=self.events, registry=self.registry,
                on_fire=lambda a: warn0("alert [%s] at step %s: value %s vs threshold %s",
                                        a["rule"], a["step"], a.get("value"), a.get("threshold")))
        self.summary_builder = (RunSummaryBuilder()
                                if self.events is not None or args.runs_dir else None)
        self.readings: list[dict] = []
        self.run_summary = None
        self._first_logged = False

    def arm_mfu(self, step_flops: dict, *, device, dtype, n_chips: int) -> None:
        """Report MFU/HFU at every window from ``step_flops``
        (``cost_model.train_step_flops``) over the card's peak for the
        step's matmul dtype."""
        peak = peak_flops_for(device, dtype)
        self.mfu_meter = MFUMeter(step_flops, n_chips=n_chips, peak_flops_per_chip=peak,
                                  registry=self.registry, events=self.events)
        log0("mfu: %.3e model FLOPs/step (%.3e hw) over %d chip(s), peak %s FLOP/s/chip",
             step_flops["model_flops"], step_flops["hardware_flops"], n_chips,
             f"{peak:.2e}" if peak else "unknown")

    def arm_memory(self, device) -> None:
        self.mem_tel = MemoryTelemetry(registry=self.registry, events=self.events, device=device)

    def span(self, name: str, **attrs):
        return self.tracer.span(name, **attrs) if self.tracer is not None else contextlib.nullcontext()

    def epoch_trace(self, first_epoch: bool):
        """The legacy whole-epoch capture of ``--profile-dir`` (its first
        epoch), unless ``--profile-steps`` drives the profiler."""
        args = self.args
        on = first_epoch and not args.profile_steps and args.profile_dir
        return profile_trace(args.profile_dir if on else None, sync=self.sync,
                             name=f"epoch_p{self.rank}")

    def step_start(self, gstep: int) -> None:
        if self.prof is not None:
            self.prof.on_step_start(gstep)

    def step_end(self, gstep: int) -> None:
        """After a step: the counters, the profiler window, the StepTimer
        and, where its window closes, the meters."""
        if self.steps_total is not None:
            self.steps_total.inc()
        if self.prof is not None:
            self.prof.on_step_end(gstep, sync=self.sync)
        reading = self.timer.tick(self.items_per_step, sync=self.sync)
        if self.timer.compile_s is not None and not self._first_logged:
            # First step done: how this incarnation got its step (eager
            # PyTorch builds its kernels on first use) and its time.
            self._first_logged = True
            self.counters.warm_start_mode = "eager"
            self.counters.compile_s = self.timer.compile_s
            if self.events is not None:
                self.events.emit("warm_start", mode="eager", first_step_s=self.timer.compile_s,
                                 attempt=self.counters.restarts)
            if self.goodput is not None:
                self.goodput.add("compile", self.timer.compile_s)
        if reading:
            self._window(gstep, reading)
        args = self.args
        if self.registry is not None and args.metrics_every and gstep % args.metrics_every == 0:
            # Periodic snapshot into the event log: host reads only.
            self.registry.export(step=gstep)

    def _window(self, gstep: int, reading: dict) -> None:
        self.readings.append(reading)
        if self.registry is not None:
            g = self.registry.gauge
            g("items_per_s").set(reading["items_per_s"])
            g("items_per_s_per_chip").set(reading["items_per_s_per_chip"])
            g("steps_per_s").set(reading["steps_per_s"])
        att = None
        if self.mfu_meter is not None:
            att = self.mfu_meter.on_reading(reading, step=gstep)
            reading["mfu"], reading["hfu"] = att["mfu"], att["hfu"]
            if att["mfu"] is not None:
                log0("mfu: %.2f%% (hfu %.2f%%, %.3e model FLOP/s)", 100 * att["mfu"],
                     100 * att["hfu"], att["model_flops_per_s"])
        mem_sample = self.mem_tel.sample(gstep) if self.mem_tel is not None else None
        window_step_s = 1.0 / reading["steps_per_s"] if reading["steps_per_s"] else None
        window_mfu = att["mfu"] if att is not None else None
        window_hwm = mem_sample.get("live_hwm_bytes") if mem_sample else None
        if self.summary_builder is not None:
            self.summary_builder.sample(step_s=window_step_s, mfu=window_mfu,
                                        live_hwm_bytes=window_hwm, steps_total=gstep + 1)
        if self.alert_engine is not None:
            gsum = self.goodput.summary() if self.goodput is not None else {}
            # The loader keeps no queue-depth gauge yet, so loader_starved
            # has nothing to read.
            self.alert_engine.observe(
                step=gstep, step_s=window_step_s, mfu=window_mfu, live_hwm_bytes=window_hwm,
                goodput=gsum.get("goodput"), elapsed_s=gsum.get("total_s"),
                prefetch_depth=None, restarts=self.counters.restarts,
                sdc_detects=self.counters.sdc_detects, gang_suspects=0)
        log0("throughput: %.0f %s/s (%.1f %s/s/chip)", reading["items_per_s"], self.unit,
             reading["items_per_s_per_chip"], self.unit)

    def nan_skip(self, gstep: int, epoch: int, batch: int) -> None:
        """A step whose gradients were not finite: its update was skipped."""
        self.counters.nonfinite_steps += 1
        if self.events is not None:
            self.events.emit("nan_skip", step=gstep, epoch=epoch, batch=batch)
        if self.prof is not None:
            # The first anomaly grabs a short trace of the steps right after
            # the blow-up, while it is still happening.
            self.prof.trigger_anomaly("nan_grad", gstep)
        warn0("non-finite gradients at epoch %d batch %d: update skipped", epoch, batch)

    def watchdog_fire(self, diag: dict) -> None:
        """The step watchdog fired (its thread; the process exits next)."""
        self.counters.watchdog_fires += 1
        last = diag.get("last_known_state") or {}
        if self.events is not None:
            self.events.emit("watchdog_fire", seconds_since_heartbeat=diag.get("seconds_since_heartbeat"),
                             last_known_state=last)
            self.events.flush()
        if self.prof is not None:
            # immediate: the loop is wedged, there may never be another
            # step to close a windowed capture on.
            self.prof.trigger_anomaly("watchdog", int(last.get("gstep", 0)), immediate=True)

    def add_goodput(self, bucket: str, seconds: float) -> None:
        if self.goodput is not None:
            self.goodput.add(bucket, seconds)

    def reset_window(self) -> None:
        """Restart the StepTimer's window after off-path work (eval, save)."""
        self.timer.reset()

    def close(self, status: str = "ok") -> None:
        """End of run, whatever the exit path: final snapshot, goodput, run
        summary, ``run_end``, the merged timeline and the runs store."""
        args = self.args
        supervised = bool(os.environ.get("_DDP_SUPERVISED"))
        if self.prof is not None:
            self.prof.close(sync=self.sync)
        if self.registry is not None:
            self.registry.export(final=True)
        if self.summary_builder is not None:
            self.run_summary = self.summary_builder.build(
                goodput=self.goodput.summary() if self.goodput is not None else None,
                restarts=self.counters.restarts,
                alerts_total=len(self.alert_engine.fired) if self.alert_engine is not None else 0,
                status=status)
        if self.events is not None:
            if self.goodput is not None:
                self.events.emit("goodput", **self.goodput.summary())
            if self.run_summary is not None:
                self.events.emit("run_summary", **self.run_summary)
            self.events.emit("run_end", status=status, faults=self.counters.summary())
            self.events.close()
            if self.world_size > 1 and status == "ok":
                import torch.distributed as dist

                # Every rank's file is closed before the merge.  Not after a
                # failure: the other ranks may never reach the barrier.
                dist.barrier()
            if self.rank == 0 and not supervised:
                merge_timeline(args.events_dir)
        if self.run_summary is not None and args.runs_dir and self.rank == 0 and not supervised:
            append_run(args.runs_dir, self.run_summary, source="trainer")
        if self.counters.total:
            log0("fault summary: %s", self.counters.summary())
