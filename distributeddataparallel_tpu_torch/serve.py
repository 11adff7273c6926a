"""Serving CLI: the continuous-batching engine under Poisson open-loop load.

    python -m distributeddataparallel_tpu_torch.serve --model gpt2_124m \\
        --seq-len 1024 --slots 16 --blocks 640 --chunk 128 --rate 16 \\
        --duration 8 --prompt-len 64,768 --output-len 32,192 --events-dir DIR
    python -m distributeddataparallel_tpu_torch.serve --device cpu --smoke

The port's twin of ``scripts/ddp_serve.py``, with its flags.  It builds the
model with random weights made from ``--seed`` (the traffic is synthetic
token ids: serving-path performance and correctness do not depend on
trained weights), wires the engine to an events dir and a metrics
registry, replays a seeded loadgen trace, and prints the serving summary
as JSON.  ``gpt2_124m`` computes in bf16 on its f32 init, cast once, as
the reference's CLI runs it.  It runs on the GPU unless ``--device cpu``
is given; ``--device cuda`` (the default) raises without one.

``--smoke`` is the reference's gate: tiny model, a ~2 s virtual burst, at
least one completed request and a valid timeline and trace export, then
the fast path (prefix cache + speculative decoding on a shared-prefix
Zipf trace) must hit the cache and accept drafts.  ``--virtual-dt`` makes
any run deterministic (the clock advances per engine step).

``--store DIR`` roots the process's kernel builds at ``DIR`` (the
``--compile-cache`` switch, ``training.warm_start``).  The reference stored
its compiled decode, prefill and verify programs there; the port's eager
engine has no such program.

``--fleet P:D`` runs the disaggregated fleet instead (``serving.fleet``):
P prefill + D decode engine processes behind the session-affinity router,
the KV handoff over TCP, each worker on ``--device`` (the GPU, or the CPU
under ``--device cpu``).  ``--kill-engine NAME|auto`` terminates one
worker ``--kill-after`` seconds into the drive (default: 60% through the
arrival trace).  Its ``--smoke`` holds the reference's fleet contract:
every request completes with zero dropped through the kill, at least one
KV handoff and one affinity-routed follow-up turn, a valid, lineage-clean
timeline whose TTFT decomposition covers every request within 5%, and a
mid-run ``/metrics`` scrape of the router and every live engine.  It keeps
``--model`` and ``--seq-len`` (the reference's fleet smoke forces ``tiny``),
so the same checks run at GPT-2 124M width on the card:

    python -m distributeddataparallel_tpu_torch.serve --fleet 1:2 --model gpt2_124m \
        --seq-len 1024 --prefix-cache --turns 3 --kill-engine auto --smoke --events-dir DIR
    python -m distributeddataparallel_tpu_torch.serve --fleet 1:2 --device cpu --smoke \
        --kill-engine auto --turns 3
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--model", default="tiny", choices=("tiny", "gpt2_124m"))
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override max_seq_len (default: model's)")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32, help="prefill chunk tokens")
    ap.add_argument("--max-prefill-chunks", type=int, default=1)
    ap.add_argument("--rate", type=float, default=8.0, help="Poisson arrival rate, requests/s")
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--prompt-len", default="4,24", help="uniform prompt length range 'lo,hi'")
    ap.add_argument("--output-len", default="4,16", help="uniform output length range 'lo,hi'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quantize-kv", action="store_true")
    ap.add_argument("--quantize-weights", action="store_true")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache: share KV blocks across requests with a "
                         "common prompt prefix")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding: n-gram-draft k tokens per step through "
                         "the verify program (0 = off)")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest n-gram the self-draft proposer matches")
    ap.add_argument("--prefix-pool", type=int, default=0,
                    help="shared-prefix trace mode: pool of N fixed prefixes sampled "
                         "with Zipf rank weights")
    ap.add_argument("--prefix-len", type=int, default=0, help="tokens per pooled shared prefix")
    ap.add_argument("--zipf-alpha", type=float, default=1.1,
                    help="Zipf exponent over the prefix pool ranks")
    ap.add_argument("--turns", type=int, default=1,
                    help="multi-turn sessions: each base request seeds a session with N "
                         "turns (follow-up prompts extend the prior turn's)")
    ap.add_argument("--turn-gap", type=float, default=0.25,
                    help="mean seconds between a session's turns")
    ap.add_argument("--fleet", default=None, metavar="P:D",
                    help="disaggregated fleet: P prefill + D decode engine processes behind the "
                         "session-affinity router, KV handoff over TCP, each on --device")
    ap.add_argument("--kill-engine", default=None, metavar="NAME|auto",
                    help="fleet fault injection: terminate this engine worker mid-run ('auto' "
                         "picks a decode engine)")
    ap.add_argument("--kill-after", type=float, default=None,
                    help="seconds into the drive to kill (default: 60%% through the arrival trace)")
    ap.add_argument("--events-dir", default=None)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="kernel build cache root (the --compile-cache switch); the reference stored "
                         "its compiled decode/prefill/verify programs here, which the port's eager "
                         "engine does not have")
    ap.add_argument("--virtual-dt", type=float, default=None,
                    help="deterministic mode: seconds per engine step")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: tiny burst + trace validity asserts")
    return ap


def _range(spec: str) -> tuple[int, int]:
    lo, hi = (int(x) for x in spec.split(","))
    return lo, hi


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is false; pass "
                           "--device cpu to run on the CPU")
    if args.smoke and not args.fleet:
        args.model = "tiny"
        args.virtual_dt = args.virtual_dt or 0.005
        args.duration = min(args.duration, 2.0)
    return args


def build_model(args):
    """The seeded random-weight model the reference's CLI serves."""
    from distributeddataparallel_tpu_torch.models import transformer as tfm

    if args.model == "gpt2_124m":
        cfg = tfm.gpt2_124m(max_seq_len=args.seq_len or 256, dtype=torch.bfloat16)
    else:
        cfg = tfm.tiny_lm(max_seq_len=args.seq_len or 128)
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return tfm.TransformerLM(cfg, device=device, generator=gen)


def engine_config(args, **over):
    from distributeddataparallel_tpu_torch.serving import EngineConfig

    kw = dict(
        num_slots=args.slots, num_blocks=args.blocks, block_size=args.block_size,
        prefill_chunk=args.chunk, max_prefill_chunks_per_step=args.max_prefill_chunks,
        quantized_kv=args.quantize_kv, quantize_weights=args.quantize_weights,
        prefix_cache=args.prefix_cache, spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        store_dir=args.store,
    )
    kw.update(over)
    return EngineConfig(**kw)


def load_config(args, vocab_size: int, **over):
    from distributeddataparallel_tpu_torch.serving import LoadConfig

    kw = dict(
        rate_rps=args.rate, duration_s=args.duration, prompt_len=_range(args.prompt_len),
        output_len=_range(args.output_len), vocab_size=vocab_size, seed=args.seed,
        prefix_pool=args.prefix_pool, prefix_len=args.prefix_len, zipf_alpha=args.zipf_alpha,
        turns=args.turns, turn_gap_s=args.turn_gap,
    )
    kw.update(over)
    return LoadConfig(**kw)


def serve(args, model=None):
    """Build the engine for ``args`` (over ``model`` if given), replay the
    seeded trace and return ``(summary, engine, trace)``."""
    from distributeddataparallel_tpu_torch.observability import EventLog, MetricsRegistry, events_path
    from distributeddataparallel_tpu_torch.observability.events import merge_timeline
    from distributeddataparallel_tpu_torch.serving import (
        InferenceEngine,
        VirtualClock,
        kv_pool_bytes,
        make_trace,
        run_load,
    )

    model = model if model is not None else build_model(args)
    cfg = model.cfg
    events = None
    if args.events_dir:
        os.makedirs(args.events_dir, exist_ok=True)
        events = EventLog(events_path(args.events_dir, 0), 0)
        events.emit("run_start", argv=sys.argv[1:], role="serve")
    registry = MetricsRegistry()
    clock = VirtualClock(args.virtual_dt) if args.virtual_dt else None
    engine = InferenceEngine(model, engine_config(args), events=events, registry=registry,
                             **({"time_fn": clock} if clock else {}))
    trace = make_trace(load_config(args, cfg.vocab_size))
    out = run_load(engine, trace, clock=clock)
    out["requests"] = len(trace)
    out["kv_pool_bytes"] = kv_pool_bytes(cfg, args.blocks, args.block_size,
                                         quantized_kv=args.quantize_kv)
    out["peak_live_blocks"] = engine.peak_live_blocks
    out["decode_step_ms"] = engine.decode_step_ms()
    if events is not None:
        events.emit("metrics", snapshot=registry.snapshot())
        events.emit("run_end", status="ok")
        events.close()
        merge_timeline(args.events_dir)
    return out, engine, trace


def timeline_problems(events_dir: str, needed, what: str) -> list[str]:
    """Schema, trace-export and span-lineage problems of a serving run's
    merged timeline, and the event kinds it lacks."""
    from distributeddataparallel_tpu_torch.observability.critical_path import check_lineage
    from distributeddataparallel_tpu_torch.observability.events import load_timeline
    from distributeddataparallel_tpu_torch.observability.schema import validate_file
    from distributeddataparallel_tpu_torch.observability.trace_export import (
        to_trace_events,
        validate_trace,
    )

    failures = list(validate_file(os.path.join(events_dir, "timeline.jsonl"))[:5])
    records = load_timeline(events_dir)
    failures.extend(validate_trace(to_trace_events(records))[:5])
    kinds = {r.get("kind") for r in records}
    failures.extend(f"{what}: no {k} event" for k in needed if k not in kinds)
    failures.extend(f"{what}: {p}" for p in check_lineage(records)[:5])
    return failures


def _smoke_fastpath(args, model) -> tuple[dict, list[str]]:
    """The serving fast path (prefix cache + speculative decoding) on a
    shared-prefix Zipf trace: the cache must hit and drafts must land."""
    from distributeddataparallel_tpu_torch.observability import EventLog, events_path
    from distributeddataparallel_tpu_torch.observability.events import merge_timeline
    from distributeddataparallel_tpu_torch.serving import (
        InferenceEngine,
        VirtualClock,
        make_trace,
        run_load,
    )

    fp_dir = fp_events = None
    if args.events_dir:
        fp_dir = os.path.join(args.events_dir, "fastpath")
        os.makedirs(fp_dir, exist_ok=True)
        fp_events = EventLog(events_path(fp_dir, 0), 0)
        fp_events.emit("run_start", argv=["--smoke", "fastpath"], role="serve")
    clock = VirtualClock(args.virtual_dt)
    engine = InferenceEngine(model, engine_config(args, prefix_cache=True, spec_k=max(args.spec_k, 3)),
                             events=fp_events, time_fn=clock)
    trace = make_trace(load_config(args, model.cfg.vocab_size, rate_rps=24.0, prompt_len=(56, 72),
                                   output_len=(8, 16), prefix_pool=4, prefix_len=48, turns=1))
    out = run_load(engine, trace, clock=clock)
    failures = []
    if fp_events is not None:
        fp_events.emit("run_end", status="ok")
        fp_events.close()
        merge_timeline(fp_dir)
        failures.extend(timeline_problems(fp_dir, ("prefix_hit", "spec_verify"), "smoke fastpath"))
    if out["completed"] < len(trace):
        failures.append(f"smoke fastpath: only {out['completed']}/{len(trace)} completed")
    if engine.prefix_hits < 1:
        failures.append("smoke fastpath: no prefix-cache hit")
    if out.get("spec_accept_mean", 0.0) <= 1.0:
        failures.append(f"smoke fastpath: spec_accept_mean {out.get('spec_accept_mean', 0.0):.2f} "
                        "<= 1 (speculation not landing)")
    return out, failures


def fleet_smoke_failures(args, out: dict, n_requests: int) -> list[str]:
    """The reference's fleet smoke checks over a ``FleetService`` run's
    summary and (with ``--events-dir``) its merged timeline; fills
    ``out["ttft_decomp"]``."""
    failures = []
    if out["completed"] < n_requests:
        failures.append(f"fleet smoke: only {out['completed']}/{n_requests} requests completed")
    if out["dropped_req_total"] != 0:
        failures.append(f"fleet smoke: {out['dropped_req_total']} dropped requests "
                        "(engine-kill drain must requeue, not lose)")
    if out["handoffs"] < 1:
        failures.append("fleet smoke: no prefill->decode KV handoff")
    if args.kill_engine and out["kills"] < 1:
        failures.append("fleet smoke: engine kill did not fire")
    if args.events_dir:
        from distributeddataparallel_tpu_torch.observability.critical_path import (
            request_decompositions,
            ttft_rollup,
        )
        from distributeddataparallel_tpu_torch.observability.events import load_timeline

        needed = ["route_admit", "kv_handoff", "tier_summary"]
        if args.kill_engine:
            needed.append("engine_verdict")
        failures.extend(timeline_problems(args.events_dir, needed, "fleet smoke"))
        records = load_timeline(args.events_dir)
        if not any(r.get("kind") == "route_admit" and r.get("affinity") for r in records):
            failures.append("fleet smoke: no affinity-routed follow-up turn")
        # Each request's critical-path decomposition must account for its
        # measured TTFT across the three process boundaries.
        decomps = request_decompositions(records)
        if len(decomps) < out["completed"]:
            failures.append(f"fleet smoke: TTFT decomposition covers only "
                            f"{len(decomps)}/{out['completed']} completed requests")
        bad = [d for d in decomps if d["err_frac"] > 0.05]
        if bad:
            worst = max(bad, key=lambda d: d["err_frac"])
            failures.append(f"fleet smoke: {len(bad)} request(s) decompose to more than 5% off "
                            f"their measured TTFT (worst {worst['err_frac']:.1%}, req {worst['req']})")
        out["ttft_decomp"] = ttft_rollup(decomps)
    # The service scraped every live endpoint mid-run (at the first
    # completion, while requests were still outstanding).
    scraped = out.get("metrics_scrape") or {}
    router_series = scraped.get("router")
    if not isinstance(router_series, dict) or "_error" in router_series:
        failures.append("fleet smoke: router /metrics scrape failed "
                        f"({(router_series or {}).get('_error', 'never scraped')})")
    else:
        for name in ("router_queue_depth", "fleet_prefill_p50_ttft_s", "fleet_prefill_p99_ttft_s",
                     "fleet_decode_p50_ttft_s", "fleet_decode_p99_ttft_s"):
            if name not in router_series:
                failures.append(f"fleet smoke: router /metrics missing {name}")
    workers = {k: v for k, v in scraped.items() if k != "router"}
    if not workers:
        failures.append("fleet smoke: no engine /metrics endpoint scraped")
    for wname, series in sorted(workers.items()):
        if not isinstance(series, dict) or "_error" in series:
            failures.append(f"fleet smoke: engine {wname} /metrics scrape failed "
                            f"({(series or {}).get('_error', 'bad payload')})")
        elif "serve_tok_s" not in series:
            failures.append(f"fleet smoke: engine {wname} /metrics missing serve_tok_s")
    return failures


def run_fleet(args) -> int:
    """``--fleet P:D``: spawn the disaggregated tiers as worker processes,
    drive a (multi-turn) loadgen trace through the router, and under
    ``--smoke`` assert the fleet contract (``fleet_smoke_failures``)."""
    from distributeddataparallel_tpu_torch.models import transformer as tfm
    from distributeddataparallel_tpu_torch.serving import make_trace
    from distributeddataparallel_tpu_torch.serving.fleet import FleetConfig, FleetService

    try:
        n_prefill, n_decode = (int(x) for x in args.fleet.split(":"))
    except ValueError:
        print(f"serve: bad --fleet {args.fleet!r} (want P:D)", file=sys.stderr)
        return 1
    if args.smoke:
        args.duration = min(args.duration, 1.5)
        args.rate = min(args.rate, 6.0)
        args.turns = max(args.turns, 2)
        # Affinity keys hash the first KV block: keep prompts at least one
        # block long so a follow-up's key matches its base turn's.
        args.prompt_len = "20,40"
        args.output_len = "6,12"
        if args.kill_engine is None:
            args.kill_engine = "auto"
    vocab = (tfm.gpt2_124m() if args.model == "gpt2_124m" else tfm.tiny_lm()).vocab_size
    trace = make_trace(load_config(args, vocab))
    kill_after = kill_name = None
    if args.kill_engine:
        last_arrival = trace[-1]["arrival_s"] if trace else 0.0
        kill_after = args.kill_after if args.kill_after is not None else 0.6 * last_arrival
        kill_name = None if args.kill_engine == "auto" else args.kill_engine
    svc = FleetService(
        model=args.model, seq_len=args.seq_len, seed=args.seed,
        # Affinity hits only pay off if the home decode engine's prefix
        # cache actually holds the session's blocks.
        engine_config=engine_config(args, prefix_cache=True),
        fleet_config=FleetConfig(prefill=n_prefill, decode=n_decode),
        device=args.device, events_dir=args.events_dir,
        kill_after_s=kill_after, kill_engine=kill_name,
    )
    out = svc.run(trace)
    out["fleet"] = f"{n_prefill}:{n_decode}"
    if not args.smoke:
        print(json.dumps(out, indent=1, sort_keys=True, default=str), flush=True)
        return 0
    failures = fleet_smoke_failures(args, out, len(trace))
    print(json.dumps(out, indent=1, sort_keys=True, default=str), flush=True)
    if failures:
        print("SMOKE FAIL:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    roll = out.get("ttft_decomp") or {}
    decomp_note = (f", ttft queue_share={roll['ttft_queue_share_frac']:.2f} "
                   f"decomp_err={roll['ttft_decomp_err_frac']:.3f} over {roll['requests']} traced "
                   "request(s)" if roll.get("requests") else "")
    print("fleet smoke OK: "
          f"{out['completed']}/{len(trace)} requests, {out['handoffs']} handoffs, "
          f"{out['requeued']} requeued through {out['kills']} kill(s), "
          f"p99_ttft={out.get('serve_p99_ttft_s', 0):.3f}s{decomp_note}", flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.fleet:
        return run_fleet(args)
    out, engine, _ = serve(args)
    print(json.dumps(out, indent=1, sort_keys=True, default=str), flush=True)
    if not args.smoke:
        return 0
    failures = []
    if out["completed"] < 1:
        failures.append("smoke: no request completed")
    if args.events_dir:
        failures.extend(timeline_problems(
            args.events_dir, ("request_admit", "decode_step", "request_done"), "smoke"))
    fp_out, fp_failures = _smoke_fastpath(args, engine.model)
    failures.extend(fp_failures)
    if failures:
        print("SMOKE FAIL:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    print("serving smoke OK: "
          f"{out['completed']}/{out['requests']} requests, "
          f"{out.get('serve_tok_s', 0):.1f} tok/s; fastpath "
          f"hit_frac={fp_out.get('prefix_hit_frac', 0):.2f} "
          f"accept_mean={fp_out.get('spec_accept_mean', 0.0):.2f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
