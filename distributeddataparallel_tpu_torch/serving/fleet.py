"""Disaggregated serving fleet: prefill tier + decode tier + router.

Counterpart of ``distributeddataparallel_tpu/serving/fleet.py``.  A single
engine serves a traffic mix by interleaving prefill chunks into every
decode step, so a long prompt ahead of you in the queue taxes every
in-flight token stream.  The fleet splits the two workloads:

- **prefill-tier** engines run chunked prefill to completion (several
  chunks per step: they have no decode batch to protect) and at most one
  sampled token, then ship the sequence's KV blocks to a decode engine
  through a ``serving.handoff`` channel;
- **decode-tier** engines run pure decode/verify steps over their slot
  batch, adopting handed-off sequences directly into decode slots
  (``inject_handoff`` -> ``Scheduler.adopt``) without running their
  prefill;
- the **router** (``serving.router``) spreads fresh requests by
  least-outstanding-tokens per tier, pins multi-turn sessions to the
  decode engine holding their prefix-cache blocks, and drains dead
  engines' requests back into the pool (``engine_verdict`` rungs).

Two execution modes share all of that logic:

- :class:`ServingFleet`: every engine in ONE process, stepped round-robin
  with in-memory ``PipeChannel`` handoffs.  Deterministic under the
  loadgen ``VirtualClock``.
- :class:`FleetService` + :func:`fleet_worker`: one OS process per engine
  under ``runtime.launcher.spawn(join=False)``, KV handoff over TCP socket
  frames, the router in the parent driving loadgen arrivals over a
  JSON-lines control socket.  ``serve --fleet P:D`` runs this; an engine
  kill mid-run exercises the drain-and-requeue ladder for real (worker EOF
  -> tombstone -> requeue -> zero dropped).  Every worker builds its engine
  on the parent's ``device`` (the card, or the CPU under ``--device cpu``)
  from the same seed, so every engine holds the same weights.

Degradation ladder on engine death (recorded as ``engine_verdict``):
``drain``: requeue the dead engine's requests onto tier survivors; prefill
tier empty: decode engines serve end-to-end (no verdict: routing just stops
using the tier); ``fail``: a tier's LAST engine died with requests
outstanding; those requests are requeued if any other serving path
remains, else dropped (counted, never silent).
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import socket
import time
from typing import Any

import numpy as np

from distributeddataparallel_tpu_torch.observability.httpmetrics import scrape as scrape_metrics
from distributeddataparallel_tpu_torch.observability.tracecontext import SpanContext, root_context
from distributeddataparallel_tpu_torch.serving.engine import EngineConfig, InferenceEngine
from distributeddataparallel_tpu_torch.serving.handoff import (
    MAX_ATTEMPTS,
    HandoffReceiver,
    HandoffSender,
    PipeChannel,
    SocketChannel,
)
from distributeddataparallel_tpu_torch.serving.router import Router, RouterError


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet shape: tier sizes and the knobs that differ between them."""

    prefill: int = 1
    decode: int = 2
    #: Prefill-tier engines run this many chunks per step: they hold no
    #: decode batch, so saturating the chunk budget is pure TTFT win.
    prefill_chunks_per_step: int = 4
    heartbeat_timeout_s: float = 2.0

    def __post_init__(self):
        if self.prefill < 0 or self.decode < 1:
            raise ValueError(
                f"fleet needs decode >= 1 and prefill >= 0, got "
                f"{self.prefill}:{self.decode}"
            )


def _prefill_tier_config(engine: EngineConfig, fleet: FleetConfig) -> EngineConfig:
    """Prefill engines: no speculative verify program (they decode at
    most one token) and an opened-up chunk budget."""
    return dataclasses.replace(
        engine,
        spec_k=0,
        max_prefill_chunks_per_step=fleet.prefill_chunks_per_step,
    )


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def _req_root(fid) -> SpanContext:
    """The root span context of fleet request ``fid``.  Derived (never
    drawn), so any fleet component (either execution mode, any incarnation
    after a requeue) recovers the same trace id from the fid alone, and a
    VirtualClock replay reproduces ids byte for byte."""
    return root_context("req", fid)


# ---------------------------------------------------------------------------
# In-process fleet (deterministic)
# ---------------------------------------------------------------------------


class ServingFleet:
    """P prefill + D decode engines in one process behind a router.

    ``model`` is the port's ``TransformerLM`` (each engine builds its decode
    twin of it, as ``InferenceEngine`` does; ``qparams`` is shared by the
    engines under ``quantize_weights``).  ``step()`` is deterministic under
    an injected virtual clock: prefill engines step first, completed
    prefills hand off synchronously through in-memory pipe channels
    (digest verify + NAK/resend included), then decode engines step.
    Drives exactly like an engine for ``loadgen.run_load``
    (``submit``/``has_work``/``step`` plus its own ``summary``).

    ``check_invariants=True`` asserts ``BlockAllocator.check()`` after
    every engine step on every tier (the fleet tests run with it on).
    """

    def __init__(
        self,
        model,
        engine_config: EngineConfig = EngineConfig(),
        fleet_config: FleetConfig = FleetConfig(),
        *,
        qparams=None,
        events=None,
        registry=None,
        time_fn=time.monotonic,
        check_invariants: bool = False,
    ):
        self.config = fleet_config
        self.engine_config = engine_config
        self.events = events
        self.registry = registry
        self._time = time_fn
        self._check = check_invariants
        self.router = Router(
            block_size=engine_config.block_size,
            heartbeat_timeout_s=fleet_config.heartbeat_timeout_s,
            events=events,
            time_fn=time_fn,
        )
        self.engines: dict[str, InferenceEngine] = {}
        pcfg = _prefill_tier_config(engine_config, fleet_config)
        for tier, n, cfg in (("prefill", fleet_config.prefill, pcfg),
                             ("decode", fleet_config.decode, engine_config)):
            for i in range(n):
                name = f"{tier}-{i}"
                self.engines[name] = InferenceEngine(model, cfg, qparams=qparams, events=events,
                                                     time_fn=time_fn, name=name)
                self.router.register_engine(name, tier)
        self._senders: dict[tuple[str, str], HandoffSender] = {}
        self._receivers: dict[tuple[str, str], HandoffReceiver] = {}
        for p in self.router.alive_engines("prefill"):
            for d in self.router.alive_engines("decode"):
                a, b = PipeChannel.pair()
                self._senders[(p, d)] = HandoffSender(a, time_fn=time_fn)
                self._receivers[(p, d)] = HandoffReceiver(b)
        self._next_fid = 0
        self._rid2fid: dict[tuple[str, int], int] = {}
        self._routes: dict[int, dict] = {}
        self._arrival: dict[int, float] = {}
        self.completed: dict[int, Any] = {}  # fid -> Request
        self.dropped: list[int] = []
        self.handoffs = 0
        self.handoff_bytes = 0
        self.handoff_s_sum = 0.0
        self.requeued = 0
        self.kills = 0
        self._step_idx = 0

    # -- intake -------------------------------------------------------
    def emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        arrival_s: float | None = None,
        session=None,
    ) -> int:
        fid = self._next_fid
        self._next_fid += 1
        self._arrival[fid] = (
            self._time() if arrival_s is None else float(arrival_s)
        )
        try:
            record = self.router.route(
                fid, prompt, max_new_tokens, session=session,
                trace=_req_root(fid).to_fields(),
            )
        except RouterError:
            self.dropped.append(fid)
            return fid
        self._routes[fid] = record
        self._dispatch(fid, record)
        return fid

    def _dispatch(self, fid: int, record: dict) -> None:
        arrival = self._arrival[fid]
        if record["prefill"] is None:
            # Affinity hit (or no prefill tier left): the home decode
            # engine serves end-to-end, its prefix cache covering the
            # shared context.
            eng_name = record["decode"]
            rid = self.engines[eng_name].submit(
                record["prompt"], record["max_new_tokens"],
                arrival_s=arrival, session=record["session"],
                trace=record["trace"],
            )
        else:
            eng_name = record["prefill"]
            rid = self.engines[eng_name].submit(
                record["prompt"], 1,
                arrival_s=arrival, session=record["session"],
                trace=record["trace"],
            )
        self._rid2fid[(eng_name, rid)] = fid

    def _redispatch(self, record: dict) -> None:
        fid = record["fid"]
        if fid in self.completed:
            return
        self.requeued += 1
        try:
            record = self.router.route(
                fid, record["prompt"], record["max_new_tokens"],
                session=record["session"],
                trace=record.get("trace") or _req_root(fid).to_fields(),
            )
        except RouterError:
            self.dropped.append(fid)
            return
        self._routes[fid] = record
        self._dispatch(fid, record)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines.values()) or any(
            s.in_flight for s in self._senders.values()
        )

    # -- the fleet step -----------------------------------------------
    def _step_engine(self, name: str) -> None:
        eng = self.engines[name]
        if eng.has_work():
            eng.step()
            if self._check:
                eng.allocator.check()

    def step(self) -> None:
        """One fleet iteration: prefill tier → handoffs → decode tier.
        A prefill completed this step lands on its decode engine before
        the decode tier steps — the handoff never costs a fleet step of
        latency on top of the wire work."""
        self._step_idx += 1
        for name in self.router.alive_engines("prefill"):
            self._step_engine(name)
            eng = self.engines[name]
            for rid in list(eng.completed):
                fid = self._rid2fid.pop((name, rid))
                record = self._routes[fid]
                target = record["decode"]
                if (
                    target not in self.engines
                    or not self.router.engines[target].alive
                ):
                    # Decode target died while we prefilled: retarget
                    # the handoff to a surviving decode engine.
                    target = self.router._least_loaded("decode")
                    if target is None:
                        eng.completed.pop(rid)
                        self.router.complete(fid)
                        self.dropped.append(fid)
                        continue
                    record["decode"] = target
                payload = eng.extract_handoff(
                    rid, max_new_tokens=record["max_new_tokens"]
                )
                payload.meta["fid"] = fid
                self._senders[(name, target)].offer(payload)
        self._pump_handoffs()
        for name in self.router.alive_engines("decode"):
            self._step_engine(name)
            eng = self.engines[name]
            for rid in list(eng.completed):
                fid = self._rid2fid.pop((name, rid), None)
                if fid is None:
                    continue
                req = eng.completed.pop(rid)
                self.completed[fid] = req
                self.router.complete(fid)
                self._emit_root_span(fid, req)
        for name, eng_state in self.router.engines.items():
            if eng_state.alive:
                self.router.heartbeat(name)
        for record in self.router.check():
            self._redispatch(record)

    def _emit_root_span(self, fid, req) -> None:
        """Close the request's trace: the root span, arrival to
        completion in the fleet clock domain, carrying the measured
        TTFT — the number critical_path's decomposition must re-derive
        from the child spans to within tolerance."""
        arrival = self._arrival.get(fid, req.arrival_s)
        self.emit(
            "span",
            name=f"req:{fid}",
            dur_s=req.done_s - arrival,
            start_s=arrival,
            end_s=req.done_s,
            ttft_s=(req.first_token_s or req.done_s) - arrival,
            req=fid,
            **_req_root(fid).to_fields(),
        )

    def _pump_handoffs(self) -> None:
        """Run the sender/receiver state machines to quiescence: frames
        → verify → ACK (or NAK → resend → reverify), then injection
        into the decode pool.  Bounded by the redelivery budget."""
        for _ in range(MAX_ATTEMPTS + 2):
            progress = False
            for (p, d), recv in self._receivers.items():
                for payload in recv.poll():
                    fid = payload.meta["fid"]
                    rid = self.engines[d].inject_handoff(payload)
                    self._rid2fid[(d, rid)] = fid
                    self.router.handoff_done(fid)
                    progress = True
            for (p, d), snd in self._senders.items():
                for done in snd.poll():
                    self.handoffs += 1
                    self.handoff_bytes += done["bytes"]
                    self.handoff_s_sum += done["handoff_s"]
                    fid = done["meta"]["fid"]
                    # Handoff counter in the span name parts: a fid
                    # re-handed-off after a kill gets a distinct span id
                    # per attempt, deterministically.
                    hctx = _req_root(fid).child(
                        "handoff", p, d, self.handoffs
                    )
                    end = self._time()
                    self.emit(
                        "kv_handoff",
                        req=fid,
                        blocks=done["blocks"],
                        bytes=done["bytes"],
                        attempts=done["attempts"],
                        handoff_s=done["handoff_s"],
                        src=p,
                        dst=d,
                        trace=hctx.trace_id,
                        span=hctx.span_id,
                    )
                    self.emit(
                        "span",
                        name=f"handoff:{fid}",
                        dur_s=done["handoff_s"],
                        start_s=end - done["handoff_s"],
                        end_s=end,
                        req=fid,
                        src=p,
                        dst=d,
                        **hctx.to_fields(),
                    )
                    progress = True
            if not progress:
                return

    # -- faults -------------------------------------------------------
    def kill_engine(self, name: str) -> int:
        """Drop an engine mid-flight (the in-process stand-in for a
        worker crash): tombstone it, abort its in-flight handoffs, and
        requeue everything it owned.  Returns the requeue count."""
        if name not in self.engines:
            raise KeyError(f"unknown engine {name!r}")
        self.kills += 1
        del self.engines[name]
        drained = self.router.mark_dead(name, reason="killed")
        for key in [k for k in self._rid2fid if k[0] == name]:
            del self._rid2fid[key]
        for pair in [
            k for k in self._senders if k[0] == name or k[1] == name
        ]:
            snd = self._senders.pop(pair)
            self._receivers.pop(pair)
            if pair[1] == name:
                # Handoffs racing toward the dead decode engine: their
                # requests re-serve from scratch on survivors.
                for meta in snd.abort_all():
                    record = self.router.complete(meta["fid"])
                    if record is not None:
                        drained.append(record)
        before = len(self.dropped)
        for record in drained:
            self._redispatch(record)
        return len(drained) - (len(self.dropped) - before)

    # -- reporting ----------------------------------------------------
    @property
    def re_handoff_blocks(self) -> int:
        return sum(s.redelivered_blocks for s in self._senders.values())

    def summary(self, *, wall_elapsed_s: float | None = None) -> dict:
        reqs = list(self.completed.values())
        out = {
            "completed": len(reqs),
            "dropped_req_total": len(self.dropped),
            "routed": self.router.routed,
            "affinity_hits": self.router.affinity_hits,
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "handoff_s": (
                self.handoff_s_sum / self.handoffs if self.handoffs else 0.0
            ),
            "re_handoff_blocks": self.re_handoff_blocks,
            "requeued": self.requeued,
            "kills": self.kills,
            "steps": self._step_idx,
            "evictions": sum(
                e.allocator.evictions for e in self.engines.values()
            ),
        }
        if not reqs:
            return out
        ttft = [(r.first_token_s or r.done_s) - r.arrival_s for r in reqs]
        tpot = [
            (r.done_s - r.first_token_s) / (len(r.generated) - 1)
            for r in reqs
            if r.first_token_s is not None and len(r.generated) > 1
        ]
        tokens = sum(len(r.generated) for r in reqs)
        elapsed = (
            wall_elapsed_s
            if wall_elapsed_s is not None
            else max(
                max(r.done_s for r in reqs)
                - min(r.arrival_s for r in reqs),
                1e-9,
            )
        )
        out.update({
            "tokens_out": tokens,
            "elapsed_s": elapsed,
            "serve_tok_s": tokens / max(elapsed, 1e-9),
            "serve_p50_ttft_s": _pct(ttft, 50),
            "serve_p99_ttft_s": _pct(ttft, 99),
            "tpot_p50_s": _pct(tpot, 50) if tpot else 0.0,
            "tpot_p99_s": _pct(tpot, 99) if tpot else 0.0,
        })
        out["tiers"] = self._tier_summaries(reqs, elapsed)
        if self.registry is not None:
            for k in ("serve_tok_s", "serve_p50_ttft_s", "serve_p99_ttft_s"):
                self.registry.gauge(k).set(out[k])
        return out

    def _tier_summaries(self, reqs, elapsed: float) -> dict:
        """Per-tier p50/p99 TTFT/TPOT.  TTFT belongs to the tier that
        produced the first token: the prefill tier for handed-off
        requests, the decode tier for affinity/fallback requests it
        served end-to-end.  TPOT is always the decode tier's."""
        by_path = {
            "prefill": [r for r in reqs if r.handoff],
            "decode": [r for r in reqs if not r.handoff],
        }
        tiers = {}
        for tier in ("prefill", "decode"):
            rs = by_path[tier]
            ttft = [
                (r.first_token_s or r.done_s) - r.arrival_s for r in rs
            ]
            tpot_rs = reqs if tier == "decode" else []
            tpot = [
                (r.done_s - r.first_token_s) / (len(r.generated) - 1)
                for r in tpot_rs
                if r.first_token_s is not None and len(r.generated) > 1
            ]
            tiers[tier] = {
                "completed": len(rs),
                "p50_ttft_s": _pct(ttft, 50) if ttft else 0.0,
                "p99_ttft_s": _pct(ttft, 99) if ttft else 0.0,
                "p50_tpot_s": _pct(tpot, 50) if tpot else 0.0,
                "p99_tpot_s": _pct(tpot, 99) if tpot else 0.0,
            }
            self.emit(
                "tier_summary",
                tier=tier,
                completed=len(rs),
                elapsed_s=elapsed,
                **{k: v for k, v in tiers[tier].items() if k != "completed"},
            )
        return tiers


# ---------------------------------------------------------------------------
# Multi-process fleet (ddp_serve --fleet P:D)
# ---------------------------------------------------------------------------

def _send_line(sock: socket.socket, msg: dict) -> None:
    sock.sendall(json.dumps(msg, separators=(",", ":")).encode() + b"\n")


class _LineReader:
    """Non-blocking JSON-lines reassembly over one socket."""

    def __init__(self, sock: socket.socket):
        sock.setblocking(False)
        self.sock = sock
        self._buf = bytearray()
        self.eof = False

    def poll(self) -> list[dict]:
        out = []
        while not self.eof:
            try:
                chunk = self.sock.recv(1 << 16)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self.eof = True
                break
            if not chunk:
                self.eof = True
                break
            self._buf += chunk
        while b"\n" in self._buf:
            line, _, rest = bytes(self._buf).partition(b"\n")
            self._buf = bytearray(rest)
            if line.strip():
                out.append(json.loads(line))
        return out


def _worker_name(process_id: int, prefill: int) -> tuple[str, str]:
    """(tier, name) of launcher child ``process_id``: prefill-i is i,
    decode-i is prefill + i."""
    if process_id < prefill:
        return "prefill", f"prefill-{process_id}"
    return "decode", f"decode-{process_id - prefill}"


def fleet_worker(process_id: int, nprocs: int, store_address, cfg_json: str) -> None:
    """One engine process of a ``--fleet P:D`` run (started by
    ``runtime.launcher.spawn(join=False)``, which passes ``nprocs`` and no
    store): build the tier's engine on ``cfg["device"]``, connect back to
    the parent's control socket, serve submits, and move KV handoffs over
    TCP ``SocketChannel`` frames (the prefill tier dials the decode tier's
    per-worker handoff listener).  An engine that fails to build raises,
    and the process exits non-zero before its hello."""
    from types import SimpleNamespace

    from distributeddataparallel_tpu_torch.observability.events import EventLog, events_path
    from distributeddataparallel_tpu_torch.observability.httpmetrics import MetricsHTTPServer
    from distributeddataparallel_tpu_torch.observability.registry import MetricsRegistry
    from distributeddataparallel_tpu_torch.runtime.retry import retry_call
    from distributeddataparallel_tpu_torch.serve import build_model

    cfg = json.loads(cfg_json)
    P = cfg["prefill"]
    tier, name = _worker_name(process_id, P)
    # Same seed on every worker: the fleet's engines must hold the SAME
    # weights or a handed-off sequence would diverge at its first decode
    # step (build_model draws them from an explicit torch.Generator).
    model = build_model(SimpleNamespace(model=cfg["model"], seq_len=cfg["seq_len"],
                                        device=cfg["device"], seed=cfg["seed"]))
    ecfg = EngineConfig(**cfg["engine"])
    fcfg = FleetConfig(prefill=P, decode=cfg["decode"],
                       prefill_chunks_per_step=cfg["prefill_chunks_per_step"])
    if tier == "prefill":
        ecfg = _prefill_tier_config(ecfg, fcfg)
    events = None
    if cfg.get("events_dir"):
        events = EventLog(events_path(cfg["events_dir"], process_id), process_id)
        events.emit("run_start", argv=[name], role="serve")
    # Live pull-based metrics: every worker serves its registry on a
    # loopback /metrics endpoint; the port rides the hello message so the
    # parent can poll it mid-run.
    registry = MetricsRegistry()
    registry.gauge("serve_tok_s").set(0.0)
    metrics_srv = MetricsHTTPServer(registry)
    engine = InferenceEngine(model, ecfg, events=events, registry=registry,
                             time_fn=time.time, name=name)

    listener = None
    handoff_addr = None
    if tier == "decode":
        # ddplint: allow[blocking-socket] — loopback listener bind, not a dial
        listener = socket.socket()
        listener.bind(("127.0.0.1", 0))
        listener.listen(8)
        listener.setblocking(False)
        handoff_addr = list(listener.getsockname())

    psock = retry_call(lambda: socket.create_connection(tuple(cfg["parent_addr"]), timeout=10.0))
    _send_line(psock, {
        "op": "hello", "name": name, "tier": tier,
        "handoff_addr": handoff_addr,
        "metrics_addr": metrics_srv.address,
    })
    parent = _LineReader(psock)

    rid2fid: dict[int, int] = {}
    pending_handoff: dict[int, dict] = {}  # rid -> submit msg
    senders: dict[str, HandoffSender] = {}
    # Decode engines known dead (the parent's engine_dead note, or a failed
    # dial): a handoff to one fails at once for the parent to requeue,
    # instead of each paying the dial's retry budget (~2.5 s) again.
    dead: set[str] = set()
    receivers: list[HandoffReceiver] = []
    hb_s = cfg.get("heartbeat_s", 0.25)
    last_beat = 0.0
    running = True
    handoffs_out = 0
    tokens_done = 0
    # ddplint: allow[wallclock] — a worker process: host clock by design (ServingFleet replays in-process)
    t_start = time.time()

    def _fail_handoff(fid) -> None:
        try:
            _send_line(psock, {"op": "handoff_fail", "fid": fid})
        except OSError:
            pass

    while running:
        for msg in parent.poll():
            if msg["op"] == "submit":
                handoff = tier == "prefill" and msg.get("handoff_to")
                rid = engine.submit(msg["prompt"], 1 if handoff else msg["max_new_tokens"],
                                    arrival_s=msg["arrival_s"], session=msg.get("session"),
                                    trace=msg.get("trace"))
                if handoff:
                    pending_handoff[rid] = msg
                else:
                    rid2fid[rid] = msg["fid"]
            elif msg["op"] == "engine_dead":
                dead.add(msg["name"])
            elif msg["op"] == "shutdown":
                running = False
        if parent.eof:
            break

        if listener is not None:
            while True:
                try:
                    conn, _ = listener.accept()
                except (BlockingIOError, OSError):
                    break
                receivers.append(HandoffReceiver(SocketChannel(conn)))
            for recv in list(receivers):
                try:
                    payloads = recv.poll()
                except (ConnectionError, OSError):
                    receivers.remove(recv)
                    continue
                for payload in payloads:
                    rid = engine.inject_handoff(payload)
                    rid2fid[rid] = payload.meta["fid"]

        for target, snd in list(senders.items()):
            try:
                for done in snd.poll():
                    fid = done["meta"]["fid"]
                    handoffs_out += 1
                    hctx = _req_root(fid).child("handoff", name, target, handoffs_out)
                    # ddplint: allow[wallclock] — a worker process: host clock by design
                    end = time.time()
                    engine.emit("kv_handoff", req=fid, blocks=done["blocks"], bytes=done["bytes"],
                                attempts=done["attempts"], handoff_s=done["handoff_s"], dst=target,
                                trace=hctx.trace_id, span=hctx.span_id)
                    engine.emit("span", name=f"handoff:{fid}", dur_s=done["handoff_s"],
                                start_s=end - done["handoff_s"], end_s=end, req=fid, src=name,
                                dst=target, **hctx.to_fields())
                    _send_line(psock, {"op": "handoff_done", "fid": fid, "bytes": done["bytes"]})
            except (ConnectionError, OSError):
                for meta in snd.abort_all():
                    _fail_handoff(meta["fid"])
                del senders[target]
                dead.add(target)

        if engine.has_work():
            engine.step()
        else:
            time.sleep(0.002)

        for rid in list(engine.completed):
            if rid in pending_handoff:
                msg = pending_handoff.pop(rid)
                payload = engine.extract_handoff(rid, max_new_tokens=msg["max_new_tokens"])
                payload.meta["fid"] = msg["fid"]
                target = msg["handoff_to"]
                try:
                    if target in dead:
                        raise ConnectionError(f"{target} is dead")
                    if target not in senders:
                        senders[target] = HandoffSender(SocketChannel.connect(msg["handoff_addr"]),
                                                        time_fn=time.time)
                    senders[target].offer(payload)
                except (ConnectionError, OSError):
                    dead.add(target)
                    failed = {msg["fid"]}
                    snd = senders.pop(target, None)
                    if snd is not None:  # its in-flight handoffs die with the link
                        failed.update(meta["fid"] for meta in snd.abort_all())
                    for fid in failed:
                        _fail_handoff(fid)
            else:
                req = engine.completed.pop(rid)
                fid = rid2fid.pop(rid, None)
                if fid is None:
                    continue
                tokens_done += len(req.generated)
                # ddplint: allow[wallclock] — live throughput gauge of a worker process
                registry.gauge("serve_tok_s").set(tokens_done / max(time.time() - t_start, 1e-9))
                _send_line(psock, {
                    "op": "done",
                    "fid": fid,
                    "tokens": len(req.generated),
                    "ttft_s": (req.first_token_s or req.done_s) - req.arrival_s,
                    "latency_s": req.done_s - req.arrival_s,
                    "tpot_s": ((req.done_s - req.first_token_s) / (len(req.generated) - 1)
                               if req.first_token_s is not None and len(req.generated) > 1 else None),
                    "handoff": req.handoff,
                })

        # Heartbeats pace a real socket on the host clock (the engine runs
        # on time.time too); only the in-process fleet replays under a
        # VirtualClock.
        # ddplint: allow[wallclock] — heartbeats pace a real socket
        now = time.time()
        if now - last_beat >= hb_s:
            try:
                _send_line(psock, {"op": "heartbeat"})
            except OSError:
                break
            last_beat = now

    if events is not None:
        # Per-request detail already flows through the engine's own
        # request_admit/request_done events; the per-tier rollup
        # (tier_summary) is the parent's to emit.
        events.emit("run_end", status="ok")
        events.close()
    metrics_srv.close()
    psock.close()


class FleetService:
    """Parent side of a multi-process ``--fleet P:D`` run: spawns the engine
    workers under the launcher, routes loadgen arrivals over the control
    socket, tombstones dead workers (EOF first, heartbeat-age hysteresis as
    backup) and requeues their requests.

    ``device`` is where every worker builds its engine: ``"cuda"`` raises
    here, before any worker starts, when there is no GPU.
    ``kill_after_s`` terminates one decode worker that long into the drive:
    the engine-kill drain the fleet smoke asserts ends with zero dropped
    requests.
    """

    def __init__(
        self,
        *,
        model: str,
        seq_len: int | None,
        seed: int,
        engine_config: EngineConfig,
        fleet_config: FleetConfig,
        device: str = "cuda",
        events_dir: str | None = None,
        # Generous on purpose: a worker's first engine.step() includes its
        # device's warm-up, which must not read as death: socket EOF is
        # the primary (and instant) kill signal, the heartbeat age only
        # backstops a hung-but-connected worker.
        heartbeat_timeout_s: float = 60.0,
        kill_after_s: float | None = None,
        kill_engine: str | None = None,
        deadline_s: float = 180.0,
    ):
        self.model = model
        self.seq_len = seq_len
        self.seed = seed
        self.engine_config = engine_config
        self.fleet_config = fleet_config
        self.device = device
        self.events_dir = events_dir
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.kill_after_s = kill_after_s
        self.kill_engine = kill_engine
        self.deadline_s = deadline_s
        self.handoffs = 0
        self.kills = 0
        self.requeued = 0
        #: Mid-run /metrics pulls, one per live endpoint (workers + this
        #: router process): name -> parsed series dict.
        self.metrics_scrape: dict[str, dict] = {}

    def run(self, trace: list[dict]) -> dict:
        import torch

        from distributeddataparallel_tpu_torch.observability.events import (
            EventLog,
            events_path,
            merge_timeline,
        )
        from distributeddataparallel_tpu_torch.observability.httpmetrics import MetricsHTTPServer
        from distributeddataparallel_tpu_torch.observability.registry import MetricsRegistry
        from distributeddataparallel_tpu_torch.runtime.launcher import spawn

        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("fleet --device cuda: torch.cuda.is_available() is false; pass "
                               "--device cpu to run the fleet on the CPU")
        fc = self.fleet_config
        nprocs = fc.prefill + fc.decode
        # ddplint: allow[blocking-socket] — loopback listener bind, not a dial
        server = socket.socket()
        server.bind(("127.0.0.1", 0))
        server.listen(nprocs)
        server.setblocking(False)

        events = None
        if self.events_dir:
            os.makedirs(self.events_dir, exist_ok=True)
            events = EventLog(events_path(self.events_dir, "supervisor"), "supervisor")
            events.emit("run_start", argv=[f"--fleet {fc.prefill}:{fc.decode}"], role="serve")
        router = Router(
            block_size=self.engine_config.block_size,
            heartbeat_timeout_s=self.heartbeat_timeout_s,
            events=events,
        )
        # The router process's own /metrics endpoint: live queue depth plus
        # running per-tier TTFT quantile gauges (initialized to 0 so the
        # series EXIST before the first completion).
        registry = MetricsRegistry()
        registry.bind("router_queue_depth", lambda: router.queue_depth)
        for tier in ("prefill", "decode"):
            for q in ("p50", "p99"):
                registry.gauge(f"fleet_{tier}_{q}_ttft_s").set(0.0)
        self.metrics_server = MetricsHTTPServer(registry)
        cfg_json = json.dumps({
            "parent_addr": list(server.getsockname()),
            "prefill": fc.prefill,
            "decode": fc.decode,
            "prefill_chunks_per_step": fc.prefill_chunks_per_step,
            "model": self.model,
            "seq_len": self.seq_len,
            "seed": self.seed,
            "device": self.device,
            "engine": dataclasses.asdict(self.engine_config),
            "events_dir": self.events_dir,
        })
        procs = spawn(fleet_worker, args=(cfg_json,), nprocs=nprocs, join=False)
        try:
            return self._drive(trace, router, server, procs, events, registry)
        finally:
            self.metrics_server.close()
            server.close()
            # Graceful first (workers flush run_end to their event files on
            # shutdown), then force the rest.
            for p in procs:
                p.join(timeout=15)
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
            if events is not None:
                events.emit("run_end", status="ok")
                events.close()
                merge_timeline(self.events_dir)

    # -- internals ----------------------------------------------------
    def _handshake(self, router, server, procs) -> tuple[dict, dict, dict, dict]:
        """Every worker dials in and names itself; a worker that exits
        before its hello (its engine did not build) fails the run."""
        fc = self.fleet_config
        conns: dict[str, _LineReader] = {}
        proc_of: dict[str, int] = {}
        handoff_addrs: dict[str, list] = {}
        metrics_addrs: dict[str, str] = {}
        # ddplint: allow[wallclock] — the subprocess fleet's start-up deadline on the host clock
        deadline = time.monotonic() + 300.0
        unnamed: list[_LineReader] = []
        while len(conns) < len(procs):
            # ddplint: allow[wallclock] — the subprocess fleet's start-up deadline on the host clock
            if time.monotonic() > deadline:
                raise RuntimeError(f"fleet handshake: {len(conns)}/{len(procs)} workers reported")
            try:
                sock, _ = server.accept()
                unnamed.append(_LineReader(sock))
            except (BlockingIOError, OSError):
                pass
            for reader in list(unnamed):
                for msg in reader.poll():
                    if msg.get("op") == "hello":
                        name = msg["name"]
                        conns[name] = reader
                        router.register_engine(name, msg["tier"])
                        if msg.get("handoff_addr"):
                            handoff_addrs[name] = msg["handoff_addr"]
                        if msg.get("metrics_addr"):
                            metrics_addrs[name] = msg["metrics_addr"]
                        idx = int(name.split("-")[1])
                        proc_of[name] = idx if msg["tier"] == "prefill" else fc.prefill + idx
                        unnamed.remove(reader)
                        break
            reported = set(proc_of.values())
            dead = [(i, p.exitcode) for i, p in enumerate(procs)
                    if i not in reported and p.exitcode is not None]
            if dead:
                names = [_worker_name(i, fc.prefill)[1] for i, _ in dead]
                raise RuntimeError(f"fleet worker(s) {names} exited before reporting (exit codes "
                                   f"{[c for _, c in dead]}): the engine did not build")
            time.sleep(0.01)
        return conns, proc_of, handoff_addrs, metrics_addrs

    def _drive(self, trace, router, server, procs, events, registry) -> dict:
        conns, proc_of, handoff_addrs, metrics_addrs = self._handshake(router, server, procs)
        pending: dict[int, dict] = {}
        arrival_abs: dict[int, float] = {}
        completed: dict[int, dict] = {}
        dropped: set[int] = set()
        tier_ttft: dict[str, list[float]] = {"prefill": [], "decode": []}

        def requeue(record) -> None:
            fid = record["fid"]
            if fid in completed or fid in dropped:
                return
            self.requeued += 1
            send_request(fid, record["prompt"], record["max_new_tokens"], record["session"])

        def mark_dead(name: str, reason: str) -> None:
            drained = router.mark_dead(name, reason=reason)
            for other, reader in conns.items():  # prefill workers stop dialing it
                if other != name and router.engines[other].alive and not reader.eof:
                    try:
                        _send_line(reader.sock, {"op": "engine_dead", "name": name})
                    except OSError:
                        pass
            for record in drained:
                requeue(record)

        def send_request(fid, prompt, max_new, session) -> None:
            try:
                record = router.route(fid, prompt, max_new, session=session,
                                      trace=_req_root(fid).to_fields())
            except RouterError:
                dropped.add(fid)
                pending.pop(fid, None)
                return
            pending[fid] = record
            target = record["prefill"] or record["decode"]
            msg = {
                "op": "submit", "fid": fid, "prompt": record["prompt"],
                "max_new_tokens": max_new, "session": session,
                "arrival_s": arrival_abs[fid],
                "trace": record["trace"],
            }
            if record["prefill"]:
                msg["handoff_to"] = record["decode"]
                msg["handoff_addr"] = handoff_addrs[record["decode"]]
            try:
                _send_line(conns[target].sock, msg)
            except OSError:
                mark_dead(target, "send-failed")

        # A real multi-process run: arrivals, the stall watchdog and the
        # summary's elapsed time live on the host clock by design (the
        # in-process VirtualClock path is ServingFleet).
        # ddplint: allow[wallclock] — a real multi-process run lives on the host clock by design
        t0 = time.time()
        i = 0
        kill_pending = self.kill_after_s is not None
        last_progress = time.monotonic()  # ddplint: allow[wallclock]
        while i < len(trace) or pending:
            # ddplint: allow[wallclock] — the stall watchdog of a real multi-process run
            if time.monotonic() - last_progress > self.deadline_s:
                break
            # ddplint: allow[wallclock] — a real multi-process run lives on the host clock by design
            now_rel = time.time() - t0
            while i < len(trace) and trace[i]["arrival_s"] <= now_rel:
                r = trace[i]
                fid = i
                i += 1
                arrival_abs[fid] = t0 + r["arrival_s"]
                send_request(fid, [int(t) for t in r["prompt"]], r["max_new_tokens"], r.get("session"))
            if kill_pending and now_rel >= self.kill_after_s:
                kill_pending = False
                victim = self.kill_engine or (router.alive_engines("decode") or [None])[-1]
                if victim is not None and victim in proc_of:
                    procs[proc_of[victim]].terminate()
                    self.kills += 1
                    mark_dead(victim, "killed")
            socks = [c.sock for c in conns.values() if not c.eof]
            if socks:
                select.select(socks, [], [], 0.005)
            for name, reader in list(conns.items()):
                if not router.engines[name].alive:
                    continue
                for msg in reader.poll():
                    op = msg.get("op")
                    if op == "heartbeat":
                        router.heartbeat(name)
                    elif op == "done":
                        fid = msg["fid"]
                        if fid in completed or fid in dropped:
                            continue
                        completed[fid] = msg
                        router.complete(fid)
                        pending.pop(fid, None)
                        # ddplint: allow[wallclock] — the stall watchdog of a real multi-process run
                        last_progress = time.monotonic()
                        tier = "prefill" if msg.get("handoff") else "decode"
                        tier_ttft[tier].append(msg["ttft_s"])
                        for q in (50, 99):
                            registry.gauge(f"fleet_{tier}_p{q}_ttft_s").set(_pct(tier_ttft[tier], q))
                        if events is not None:
                            # Root span: the workers' serve/prefill spans all
                            # parent on this (same fid-derived context on
                            # every process).
                            start = arrival_abs[fid]
                            events.emit("span", name=f"req:{fid}", dur_s=msg["latency_s"],
                                        start_s=start, end_s=start + msg["latency_s"],
                                        ttft_s=msg["ttft_s"], req=fid, **_req_root(fid).to_fields())
                        if not self.metrics_scrape:
                            # First completion: the fleet is warm; pull every
                            # live /metrics endpoint exactly once, mid-run by
                            # construction (requests are still outstanding).
                            self._scrape_fleet(router, metrics_addrs)
                    elif op == "handoff_done":
                        self.handoffs += 1
                        # ddplint: allow[wallclock] — the stall watchdog of a real multi-process run
                        last_progress = time.monotonic()
                        try:
                            record = router.handoff_done(msg["fid"])
                        except KeyError:
                            continue  # requeued while the blocks flew
                        if not router.engines[record["decode"]].alive:
                            # The decode engine took the blocks and died before
                            # this note arrived: its drain did not hold the
                            # request yet, so serve it again (the reference
                            # leaves it on the tombstone and drops it).
                            router.complete(msg["fid"])
                            requeue(record)
                    elif op == "handoff_fail":
                        record = router.complete(msg["fid"])
                        if record is not None:
                            requeue(record)
                if reader.eof and router.engines[name].alive:
                    mark_dead(name, "eof")
            for record in router.check():
                requeue(record)

        for fid in list(pending):
            dropped.add(fid)
            pending.pop(fid)
        for name, reader in conns.items():
            if not reader.eof:
                try:
                    _send_line(reader.sock, {"op": "shutdown"})
                except OSError:
                    pass
        # ddplint: allow[wallclock] — a real multi-process run lives on the host clock by design
        elapsed = time.time() - t0
        return self._summary(completed, dropped, elapsed, events, trace)

    def _scrape_fleet(self, router, metrics_addrs: dict) -> None:
        """Pull every live endpoint's /metrics once (workers + this router
        process).  Parse failures are recorded, not raised: the smoke turns
        them into assertions with the run's context."""
        targets = {"router": self.metrics_server.address}
        for name, addr in metrics_addrs.items():
            if router.engines[name].alive:
                targets[name] = addr
        for name, addr in targets.items():
            try:
                self.metrics_scrape[name] = scrape_metrics(addr, timeout=2.0)
            except (OSError, ValueError) as exc:
                self.metrics_scrape[name] = {"_error": str(exc)}

    def _summary(self, completed, dropped, elapsed, events, trace) -> dict:
        recs = list(completed.values())
        out = {
            "requests": len(trace),
            "completed": len(recs),
            "dropped_req_total": len(dropped),
            "handoffs": self.handoffs,
            "requeued": self.requeued,
            "kills": self.kills,
            "elapsed_s": elapsed,
            "metrics_scrape": self.metrics_scrape,
        }
        if recs:
            tokens = sum(r["tokens"] for r in recs)
            ttft = [r["ttft_s"] for r in recs]
            tpot = [r["tpot_s"] for r in recs if r.get("tpot_s")]
            out.update({
                "tokens_out": tokens,
                "serve_tok_s": tokens / max(elapsed, 1e-9),
                "serve_p50_ttft_s": _pct(ttft, 50),
                "serve_p99_ttft_s": _pct(ttft, 99),
                "tpot_p50_s": _pct(tpot, 50) if tpot else 0.0,
                "tpot_p99_s": _pct(tpot, 99) if tpot else 0.0,
            })
            if events is not None:
                for tier, rs in (("prefill", [r for r in recs if r.get("handoff")]),
                                 ("decode", [r for r in recs if not r.get("handoff")])):
                    tt = [r["ttft_s"] for r in rs]
                    events.emit("tier_summary", tier=tier, completed=len(rs),
                                p50_ttft_s=_pct(tt, 50) if tt else 0.0,
                                p99_ttft_s=_pct(tt, 99) if tt else 0.0)
        return out
