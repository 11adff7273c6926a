"""Synthetic open-loop load generator (Poisson arrivals) + run driver.

Open-loop means arrivals do NOT wait for the server: the trace is a
Poisson process sampled up front (exponential inter-arrival gaps at
``rate_rps``), and a slow engine simply accumulates queue — which is
what makes the measured TTFT tail honest (closed-loop generators hide
overload by self-throttling; the serving literature's standard
methodology is open-loop for exactly this reason).

Two clocks:

- **wall** (default): arrivals are released by ``time.monotonic``; the
  bench's sustained tokens/s headline is real wall-clock throughput.
- **virtual** (:class:`VirtualClock`): the clock advances a fixed
  ``dt`` per engine step and the engine gets the same injectable
  ``time_fn`` — every admission decision, preemption, and generated
  token becomes a pure function of (seed, config), which is what the
  deterministic-replay test pins down.

``summary`` folds the completed requests into the serving headline
dict (p50/p99 TTFT, mean per-token latency, sustained tokens/s) and
publishes the same numbers as registry gauges (``serve_tok_s``,
``serve_p50_ttft_s``, ``serve_p99_ttft_s``) so the metrics exporters
and the perf gate see serving runs like any training run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Shape of the synthetic traffic.

    ``prefix_pool > 0`` turns on the shared-prefix trace mode that
    models production traffic (repeated system prompts / few-shot
    headers): a seeded pool of ``prefix_pool`` fixed prefixes of
    ``prefix_len`` tokens is sampled once, and every request draws its
    prefix from the pool with Zipf rank weights (rank r picked with
    probability proportional to ``r ** -zipf_alpha`` — a handful of hot
    prefixes dominate, the tail stays warm) followed by an independent
    random suffix.  Everything stays a pure function of ``seed``.
    """

    rate_rps: float = 8.0
    duration_s: float = 2.0
    prompt_len: tuple[int, int] = (4, 24)    # uniform [lo, hi]
    output_len: tuple[int, int] = (4, 16)    # uniform [lo, hi]
    vocab_size: int = 256
    seed: int = 0
    prefix_pool: int = 0     # 0 = plain random prompts
    prefix_len: int = 0      # shared-prefix tokens per pooled prefix
    zipf_alpha: float = 1.1  # rank-weight exponent over the pool
    # Multi-turn sessions (turns > 1): each base request seeds a
    # session; follow-up turns arrive ~turn_gap_s later (exponential)
    # with a prompt that EXTENDS the prior turn's prompt by a uniform
    # [lo, hi] draw of fresh tokens — the trace shape that exercises
    # router session affinity and cross-request prefix reuse.  The
    # follow-up stream draws from its own seeded rng AFTER the base
    # trace is built, so turns == 1 traces stay bitwise identical to
    # pre-multi-turn ones (replay pinning).
    turns: int = 1
    turn_gap_s: float = 0.25
    turn_tokens: tuple[int, int] = (4, 12)


def make_trace(cfg: LoadConfig) -> list[dict]:
    """Sample the full arrival trace up front (seeded, replayable):
    ``[{"arrival_s", "prompt", "max_new_tokens"}, ...]`` sorted by
    arrival time."""
    if cfg.rate_rps <= 0 or cfg.duration_s <= 0:
        raise ValueError("rate_rps and duration_s must be positive")
    if cfg.prefix_pool > 0 and cfg.prefix_len < 1:
        raise ValueError("prefix_pool needs prefix_len >= 1")
    rng = np.random.default_rng(cfg.seed)
    pool = None
    if cfg.prefix_pool > 0:
        pool = [
            rng.integers(0, cfg.vocab_size, cfg.prefix_len, dtype=np.int32)
            for _ in range(cfg.prefix_pool)
        ]
        ranks = np.arange(1, cfg.prefix_pool + 1, dtype=np.float64)
        probs = ranks ** -float(cfg.zipf_alpha)
        probs /= probs.sum()
    trace = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / cfg.rate_rps))
        if t >= cfg.duration_s:
            break
        p_lo, p_hi = cfg.prompt_len
        o_lo, o_hi = cfg.output_len
        plen = int(rng.integers(p_lo, p_hi + 1))
        if pool is not None:
            prefix = pool[int(rng.choice(cfg.prefix_pool, p=probs))]
            suffix_len = max(plen - cfg.prefix_len, 1)
            prompt = np.concatenate([
                prefix,
                rng.integers(
                    0, cfg.vocab_size, suffix_len, dtype=np.int32
                ),
            ])
        else:
            prompt = rng.integers(
                0, cfg.vocab_size, plen, dtype=np.int32
            )
        trace.append({
            "arrival_s": t,
            "prompt": prompt,
            "max_new_tokens": int(rng.integers(o_lo, o_hi + 1)),
        })
    if cfg.turns > 1:
        trace = _add_turns(cfg, trace)
    return trace


def _add_turns(cfg: LoadConfig, base: list[dict]) -> list[dict]:
    """Expand each base request into a ``cfg.turns``-turn session.

    Follow-up prompts are strict extensions of the prior turn's prompt
    (turn t's prompt is a prefix of turn t+1's), which is exactly what
    makes a session's first KV block content-stable — the router's
    affinity key — and its full context a radix-trie hit on the engine
    that served the previous turn.  Uses an independent rng seeded off
    ``(seed, salt)`` so the base trace's draws are untouched.
    """
    if cfg.turn_gap_s <= 0:
        raise ValueError("turn_gap_s must be positive")
    lo, hi = cfg.turn_tokens
    if not 1 <= lo <= hi:
        raise ValueError(f"turn_tokens must be 1 <= lo <= hi, got {lo, hi}")
    rng = np.random.default_rng([cfg.seed, 0x7A95])
    out: list[dict] = []
    for i, r in enumerate(base):
        sid = f"s{i}"
        out.append({**r, "session": sid, "turn": 0})
        t = r["arrival_s"]
        prompt = r["prompt"]
        for turn in range(1, cfg.turns):
            t += float(rng.exponential(cfg.turn_gap_s))
            prompt = np.concatenate([
                prompt,
                rng.integers(
                    0, cfg.vocab_size,
                    int(rng.integers(lo, hi + 1)), dtype=np.int32,
                ),
            ])
            out.append({
                "arrival_s": t,
                "prompt": prompt,
                "max_new_tokens": int(
                    rng.integers(cfg.output_len[0], cfg.output_len[1] + 1)
                ),
                "session": sid,
                "turn": turn,
            })
    out.sort(key=lambda r: r["arrival_s"])
    return out


class VirtualClock:
    """A callable clock that advances ``dt`` per :meth:`tick` — shared
    by the loadgen loop and the engine (``time_fn=clock``) to make a
    run deterministic."""

    def __init__(self, dt: float = 0.01):
        self.t = 0.0
        self.dt = float(dt)

    def __call__(self) -> float:
        return self.t

    def tick(self) -> None:
        self.t += self.dt


def run_load(
    engine,
    trace: list[dict],
    *,
    clock: VirtualClock | None = None,
    max_steps: int = 200_000,
) -> dict:
    """Replay ``trace`` against ``engine`` until every request drains.

    With ``clock=None`` arrivals are released on the wall clock (build
    the engine with the default ``time_fn``).  With a
    :class:`VirtualClock`, pass the SAME instance as the engine's
    ``time_fn`` — the loop ticks it once per engine step.

    Returns the :func:`summary` dict.
    """
    wall = clock is None
    # ddplint: allow[wallclock] — this IS the documented wall branch;
    # with a VirtualClock the lambda below is never built
    t0 = time.monotonic() if wall else 0.0
    now = (lambda: time.monotonic() - t0) if wall else clock  # ddplint: allow[wallclock]
    i = 0
    steps = 0
    while i < len(trace) or engine.has_work():
        while i < len(trace) and trace[i]["arrival_s"] <= now():
            r = trace[i]
            # The engine stamps TTFT/latency with ITS clock: translate
            # the trace-relative arrival into that domain (monotonic
            # absolute on the wall clock, as-is on the virtual one).
            kw = (
                {"session": r["session"]} if r.get("session") is not None
                else {}
            )
            engine.submit(
                r["prompt"], r["max_new_tokens"],
                arrival_s=(
                    t0 + r["arrival_s"] if wall else r["arrival_s"]
                ),
                **kw,
            )
            i += 1
        if engine.has_work():
            engine.step()
        elif wall:
            time.sleep(0.0002)  # idle until the next arrival releases
        if not wall:
            clock.tick()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(
                f"load did not drain within {max_steps} iterations"
            )
    elapsed = now() if wall else clock()
    # Fleets fold per-tier stats into their own summary; single engines
    # use the module-level one.
    if hasattr(engine, "summary"):
        return engine.summary(wall_elapsed_s=elapsed)
    return summary(engine, wall_elapsed_s=elapsed)


def _pct(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def summary(engine, *, wall_elapsed_s: float | None = None) -> dict:
    """Serving headline numbers over the engine's completed requests."""
    reqs = list(engine.completed.values())
    out = {
        "completed": len(reqs),
        "preemptions": sum(r.preemptions for r in reqs),
        "evictions": engine.allocator.evictions,
        "steps": engine._step_idx,
    }
    if not reqs:
        return out
    ttft = [
        (r.first_token_s or r.done_s) - r.arrival_s for r in reqs
    ]
    tok_lat = [
        (r.done_s - r.first_token_s) / (len(r.generated) - 1)
        for r in reqs
        if r.first_token_s is not None and len(r.generated) > 1
    ]
    total_tokens = sum(len(r.generated) for r in reqs)
    t_start = min(r.arrival_s for r in reqs)
    t_end = max(r.done_s for r in reqs)
    elapsed = (
        wall_elapsed_s
        if wall_elapsed_s is not None
        else max(t_end - t_start, 1e-9)
    )
    out.update({
        "tokens_out": total_tokens,
        "elapsed_s": elapsed,
        "serve_tok_s": total_tokens / max(elapsed, 1e-9),
        "serve_p50_ttft_s": _pct(ttft, 50),
        "serve_p99_ttft_s": _pct(ttft, 99),
        "mean_tok_latency_s": (
            float(np.mean(tok_lat)) if tok_lat else 0.0
        ),
    })
    # Serving fast path (prefix cache + speculative decoding) stats.
    if getattr(engine, "prefix_admits", 0) > 0:
        out.update({
            "prefix_hit_frac": engine.prefix_hits / engine.prefix_admits,
            "prefill_flops_avoided_frac": (
                engine.prefix_hit_tokens
                / max(engine.prefix_ctx_tokens, 1)
            ),
            "prefix_hit_tokens": engine.prefix_hit_tokens,
            "cow_copies": engine.cow_copies,
        })
    if getattr(engine, "spec_rows", 0) > 0:
        out.update({
            "spec_drafted": engine.spec_drafted,
            "spec_accepted": engine.spec_accepted,
            "spec_accept_mean": engine.spec_accepted / engine.spec_rows,
        })
    if engine.registry is not None:
        for k in ("serve_tok_s", "serve_p50_ttft_s", "serve_p99_ttft_s"):
            engine.registry.gauge(k).set(out[k])
    return out
