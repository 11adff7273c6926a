"""The port's serving engine (``serving/engine.py``) against the port's own
``generate()`` and against the JAX package's engine, on the CPU.

- Continuous batching is invisible: every request's greedy continuation
  equals ``generate()``'s for that prompt, bitwise, in both layer layouts,
  with prompts that end exactly on a block boundary.
- A seeded loadgen trace under a ``VirtualClock`` replayed through the
  port's engine and the JAX engine (same params, ``from_jax_params``):
  the same output ids and the same admit / first-token / done times and
  preemption counts, plain and with the prefix cache and speculative
  decoding (``spec_k=3``) under pool pressure (preemptions > 0).  f32
  logits of the two packages differ by ~1e-7, so an id may differ only at
  a true tie of the reference's logits (top-2 gap under 1e-5); none
  occurs on these traces.
- int8 KV with int8 weights completes every request, with the JAX
  engine's ids (the int8 rows and the int8 tree are bit-equal,
  ``test_torch_kv_cache.py`` / ``test_torch_quant.py``).
- The serving events validate against the port's schema, export to a
  valid Perfetto trace, and their span trees are lineage-clean.
- The fleet's handoff refuses what the reference refuses, and the
  warm-start store roots the kernel builds (``test_torch_handoff.py`` and
  ``test_torch_fleet.py`` hold the handoff and the fleet).
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.serving import engine as jeng
from distributeddataparallel_tpu_torch.models import generate as tgen
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.io import from_jax_params
from distributeddataparallel_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    LoadConfig,
    VirtualClock,
    make_trace,
    run_load,
)

jq = importlib.import_module("distributeddataparallel_tpu.ops.quant")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TIE = 1e-5
UNROLLED = dict(vocab_size=97, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=32,
                positional="learned", norm="layernorm", activation="gelu", tie_embeddings=True)
STACKED = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, d_ff=64,
               max_seq_len=32, scan_layers=True, tie_embeddings=False)
# int8 weights: the embedding (512 x 64) and the MLP (64 x 256) quantize.
QUANT = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=64, d_ff=256, max_seq_len=32)


@functools.lru_cache(maxsize=None)
def _pair(kind):
    kw = {"unrolled": UNROLLED, "stacked": STACKED, "quant": QUANT}[kind]
    jmodel = jtfm.TransformerLM(jtfm.tiny_lm(attn_impl="xla", **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    tcfg = ttfm.tiny_lm(attn_impl="plain", **kw)
    tmodel = ttfm.TransformerLM(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel


@pytest.mark.parametrize("kind", ["unrolled", "stacked"])
def test_engine_matches_generate(kind):
    _, _, model = _pair(kind)
    engine = InferenceEngine(model, EngineConfig(num_slots=4, num_blocks=16, block_size=8, prefill_chunk=8))
    rng = np.random.default_rng(3)
    cases = [(3, 6), (8, 7), (16, 9), (8, 7), (5, 12)]  # 8 and 16: block-exact prompts
    rids = {}
    for plen, n in cases:
        p = rng.integers(0, 97, plen, dtype=np.int32)
        rids[engine.submit(p, n)] = (p, n)
    engine.run()
    assert len(engine.completed) == len(cases)
    for rid, (p, n) in rids.items():
        want = tgen.generate(model, torch.from_numpy(p)[None], n)[0].numpy()
        np.testing.assert_array_equal(engine.output_tokens(rid), want)


def _replay(make_engine, trace):
    clock = VirtualClock(0.01)
    engine = make_engine(clock)
    out = run_load(engine, trace, clock=clock)
    runs = {rid: (list(map(int, r.generated)), r.admit_s, r.first_token_s, r.done_s, r.preemptions)
            for rid, r in engine.completed.items()}
    return out, runs, engine


def _assert_runs_match(jmodel, jparams, jruns, truns, trace):
    """Same ids (or a true tie of the reference's logits at the first
    difference) and, while the ids agree, the same schedule."""
    assert set(truns) == set(jruns) == set(range(len(trace)))
    for rid, r in enumerate(trace):
        jr, tr = jruns[rid], truns[rid]
        if jr[0] != tr[0]:
            t = next(i for i, (a, b) in enumerate(zip(jr[0], tr[0])) if a != b)
            ctx = np.concatenate([r["prompt"], np.asarray(jr[0][:t], np.int32)])
            logits = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ctx[None])))[0, -1]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TIE, (rid, t, top2)
            continue
        assert jr[1:5] == tr[1:5], rid


@pytest.mark.parametrize("fast", [False, True], ids=["plain", "prefix-spec-pressure"])
def test_virtual_clock_replay_matches_jax_engine(fast):
    jmodel, params, tmodel = _pair("unrolled")
    if fast:
        trace = make_trace(LoadConfig(rate_rps=60.0, duration_s=0.4, prompt_len=(10, 14), output_len=(4, 10),
                                      vocab_size=97, seed=5, prefix_pool=2, prefix_len=8))
        kw = dict(num_slots=3, num_blocks=12, block_size=4, prefill_chunk=8, prefix_cache=True, spec_k=3)
    else:
        trace = make_trace(LoadConfig(rate_rps=40.0, duration_s=0.5, prompt_len=(4, 20), output_len=(4, 12),
                                      vocab_size=97, seed=7))
        kw = dict(num_slots=2, num_blocks=12, block_size=8, prefill_chunk=8)
    assert len(trace) >= 5
    _, jruns, _ = _replay(lambda c: jeng.InferenceEngine(jmodel, params, jeng.EngineConfig(**kw), time_fn=c), trace)
    out, truns, engine = _replay(lambda c: InferenceEngine(tmodel, EngineConfig(**kw), time_fn=c), trace)
    _assert_runs_match(jmodel, params, jruns, truns, trace)
    assert out["completed"] == len(trace)
    if fast:
        assert out["preemptions"] > 0 and engine.prefix_hits > 0 and engine.spec_rows > 0
        engine.allocator.check()


def test_int8_kv_and_weights_complete_with_jax_ids():
    jmodel, params, tmodel = _pair("quant")
    trace = make_trace(LoadConfig(rate_rps=30.0, duration_s=0.4, prompt_len=(4, 16), output_len=(3, 10),
                                  vocab_size=512, seed=9))
    kw = dict(num_slots=2, num_blocks=16, block_size=8, prefill_chunk=8, quantized_kv=True, quantize_weights=True)
    _, jruns, _ = _replay(lambda c: jeng.InferenceEngine(jmodel, params, jeng.EngineConfig(**kw), time_fn=c), trace)
    out, truns, engine = _replay(lambda c: InferenceEngine(tmodel, EngineConfig(**kw), time_fn=c), trace)
    assert out["completed"] == len(trace) >= 3
    assert engine.pool[0][0]["q"].dtype == torch.int8
    deq = jq.dequantize(jq.quantize_for_decode(params, False), jnp.float32)
    _assert_runs_match(jmodel, deq, jruns, truns, trace)


def test_serving_events_validate(tmp_path):
    from distributeddataparallel_tpu_torch.observability import EventLog, events_path, merge_timeline
    from distributeddataparallel_tpu_torch.observability.critical_path import check_lineage
    from distributeddataparallel_tpu_torch.observability.events import load_timeline
    from distributeddataparallel_tpu_torch.observability.registry import MetricsRegistry
    from distributeddataparallel_tpu_torch.observability.schema import validate_file
    from distributeddataparallel_tpu_torch.observability.trace_export import to_trace_events, validate_trace

    _, _, model = _pair("unrolled")
    events = EventLog(events_path(str(tmp_path), 0), 0)
    events.emit("run_start", argv=[], role="serve")
    registry = MetricsRegistry()
    clock = VirtualClock(0.005)
    engine = InferenceEngine(model, EngineConfig(num_slots=2, num_blocks=6, block_size=4, prefill_chunk=8),
                             events=events, registry=registry, time_fn=clock)
    trace = make_trace(LoadConfig(rate_rps=40.0, duration_s=0.4, prompt_len=(4, 12), output_len=(3, 8),
                                  vocab_size=97, seed=1))
    out = run_load(engine, trace, clock=clock)
    events.emit("metrics", snapshot=registry.snapshot())
    events.emit("run_end", status="ok")
    events.close()
    merge_timeline(str(tmp_path))
    assert out["completed"] == len(trace)
    assert validate_file(os.path.join(tmp_path, "timeline.jsonl")) == []
    records = load_timeline(str(tmp_path))
    kinds = {r["kind"] for r in records}
    assert {"request_admit", "prefill_chunk", "decode_step", "request_done", "kv_evict", "span"} <= kinds
    spans = {r["name"] for r in records if r["kind"] == "span"}
    assert {f"request:{rid}" for rid in range(len(trace))} <= spans
    assert validate_trace(to_trace_events(records)) == []
    assert check_lineage(records) == []
    assert registry.snapshot()["serve_requests_done"] == len(trace)


def test_handoff_and_store_raise_with_their_items(tmp_path, monkeypatch):
    """The KV handoff (item 19b) is ported: a request that is not a
    completed one has nothing to extract, and a payload without a pending
    token is refused with the reference's HandoffError."""
    from distributeddataparallel_tpu_torch.serving.handoff import HandoffError, HandoffPayload

    _, _, model = _pair("unrolled")
    engine = InferenceEngine(model, EngineConfig(num_slots=2, num_blocks=8, block_size=8, prefill_chunk=8))
    with pytest.raises(KeyError):
        engine.extract_handoff(0)
    with pytest.raises(HandoffError, match="carries no pending token"):
        engine.inject_handoff(HandoffPayload({"rid": 0, "prompt": [1, 2], "max_new_tokens": 2}, []))
    # store_dir (item 11b) is ported: it roots the process's kernel builds
    # at the store, through the compile-cache switch.
    from distributeddataparallel_tpu_torch.training import warm_start

    monkeypatch.setattr(warm_start, "_cache_dir", None)
    monkeypatch.setenv(warm_start.ENV, "")
    InferenceEngine(model, EngineConfig(num_slots=2, num_blocks=8, block_size=8, prefill_chunk=8,
                                        store_dir=str(tmp_path / "store")))
    assert warm_start.build_root() == tmp_path / "store" / "build"
