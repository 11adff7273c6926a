"""The port's disaggregated serving fleet (``serving/{router,fleet}.py``,
``serve.py --fleet``) against its own single engine and the JAX package's
fleet, on the CPU.

- A 1:2 ``ServingFleet`` (1 prefill + 2 decode engines) generates the
  port's single engine's tokens bit for bit, for block-exact, mid-block and
  multi-block prompts, unrolled and scanned layers, int8 KV and the fast
  path (prefix cache + speculative decoding), with ``BlockAllocator.check()``
  holding on every step of every engine.
- On one shared case (the reference's tiny unrolled model and 3 prompts,
  carried over by ``from_jax_params``) the port's fleet gives the
  reference's ``ServingFleet`` tokens (f32 logits of the two packages
  differ by ~1e-7, so an id may differ only at a true tie of the
  reference's logits, top-2 gap under 1e-5; none occurs), and its summary
  has the reference's keys.
- The router makes the reference ``Router``'s decisions and emits its
  events over the same call sequence on an injected clock: least
  outstanding tokens, session affinity, the heartbeat's suspect and
  tombstone, ``drain`` and ``fail``.
- Killing a decode engine mid-run drains with zero dropped; a
  ``VirtualClock`` replay is identical.
- ``serve --fleet 1:2 --device cpu --smoke --kill-engine auto --turns 3``
  exits 0 in a fresh process (no JAX in it or its workers); on its
  timeline the port's five critical-path functions equal the reference's
  and the reference's ``check_events --conformance`` passes.
- ``--fleet`` without a GPU and without ``--device cpu`` raises before a
  worker starts; a worker whose engine does not build fails the run.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.observability import critical_path as jcp
from distributeddataparallel_tpu.serving import fleet as jfleet
from distributeddataparallel_tpu.serving import engine as jeng
from distributeddataparallel_tpu.serving import router as jrouter
from distributeddataparallel_tpu.serving.loadgen import VirtualClock as JClock
from distributeddataparallel_tpu_torch import serve
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.io import from_jax_params
from distributeddataparallel_tpu_torch.observability import critical_path as tcp
from distributeddataparallel_tpu_torch.observability.events import load_timeline
from distributeddataparallel_tpu_torch.serving import (
    EngineConfig,
    FleetConfig,
    FleetService,
    InferenceEngine,
    LoadConfig,
    Router,
    RouterError,
    ServingFleet,
    VirtualClock,
    make_trace,
    run_load,
)

ROOT = Path(__file__).resolve().parents[1]
TIE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UNROLLED = dict(vocab_size=97, num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=64,
                positional="learned", norm="layernorm", activation="gelu", tie_embeddings=True)
SCANNED = dict(vocab_size=97, num_layers=2, num_heads=4, num_kv_heads=2, d_model=32, d_ff=64,
               max_seq_len=64, scan_layers=True, tie_embeddings=False)
ENGINE = dict(num_slots=4, num_blocks=48, block_size=8, prefill_chunk=8)
#: at block_size 8: block-exact (16), mid-block (13), multi-block (21)
PROMPT_LENS = (16, 13, 21)


def _prompts(vocab=97, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).tolist() for n in lens]


def _model(kw, seed=0):
    return ttfm.TransformerLM(ttfm.tiny_lm(attn_impl="plain", **kw), generator=torch.Generator().manual_seed(seed))


def _single(model, ecfg, prompts, n_new):
    eng = InferenceEngine(model, ecfg, time_fn=VirtualClock())
    rids = [eng.submit(p, n_new) for p in prompts]
    eng.run()
    return [list(eng.completed[r].generated) for r in rids]


def _drive(fleet, clock, max_steps=800):
    steps = 0
    while fleet.has_work():
        fleet.step()
        clock.tick()
        steps += 1
        assert steps < max_steps, "fleet failed to drain"


def _fleet_run(model, ecfg, prompts, n_new, **kw):
    clock = VirtualClock()
    fleet = ServingFleet(model, ecfg, FleetConfig(prefill=1, decode=2), time_fn=clock,
                         check_invariants=True, **kw)
    fids = [fleet.submit(p, n_new) for p in prompts]
    _drive(fleet, clock)
    return fleet, [list(fleet.completed[f].generated) for f in fids]


@pytest.mark.parametrize("case", ["unrolled", "scanned", "int8_kv", "fastpath"])
def test_fleet_equals_the_single_engine(case):
    model = _model(SCANNED if case == "scanned" else UNROLLED)
    over = {"int8_kv": {"quantized_kv": True}, "fastpath": {"prefix_cache": True, "spec_k": 2}}.get(case, {})
    ecfg = EngineConfig(**ENGINE, **over)
    prompts = _prompts()
    fleet, outs = _fleet_run(model, ecfg, prompts, 10)
    assert outs == _single(model, ecfg, prompts, 10)
    s = fleet.summary()
    assert s["handoffs"] == len(PROMPT_LENS) and s["dropped_req_total"] == 0
    assert s["re_handoff_blocks"] == 0 and s["completed"] == len(PROMPT_LENS)


@pytest.fixture(scope="module")
def shared():
    """The reference's tiny unrolled model and its fleet's run of the 3
    prompts: computed once for the file (the JAX side's compiles dominate)."""
    jmodel = jtfm.TransformerLM(jtfm.tiny_lm(attn_impl="xla", **UNROLLED))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    clock = JClock()
    jf = jfleet.ServingFleet(jmodel, params, jeng.EngineConfig(**ENGINE), jfleet.FleetConfig(prefill=1, decode=2),
                             time_fn=clock, check_invariants=True)
    fids = [jf.submit(p, 10) for p in _prompts()]
    while jf.has_work():
        jf.step()
        clock.tick()
    tcfg = ttfm.tiny_lm(attn_impl="plain", **UNROLLED)
    tmodel = ttfm.TransformerLM(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel, [list(jf.completed[f].generated) for f in fids], jf.summary()


def test_fleet_tokens_equal_the_reference_fleet(shared):
    jmodel, params, tmodel, want, jsummary = shared
    fleet, got = _fleet_run(tmodel, EngineConfig(**ENGINE), _prompts(), 10)
    for prompt, j, t in zip(_prompts(), want, got):
        if j != t:  # only at a tie of the reference's logits
            i = next(i for i, (a, b) in enumerate(zip(j, t)) if a != b)
            ctx = np.asarray(prompt + j[:i], np.int32)
            logits = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ctx[None])))[0, -1]
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TIE, (i, top2)
    s = fleet.summary()
    assert set(s) == set(jsummary) and set(s["tiers"]["prefill"]) == set(jsummary["tiers"]["prefill"])
    assert {k: s[k] for k in ("completed", "handoffs", "handoff_bytes", "routed")} == \
        {k: jsummary[k] for k in ("completed", "handoffs", "handoff_bytes", "routed")}


class _Events:
    def __init__(self):
        self.records = []

    def emit(self, kind, **fields):
        self.records.append({"kind": kind, **fields})


class _Clock:
    t = 0.0

    def __call__(self):
        return self.t


def _router_script(cls, error):
    """The same call sequence on a router class; everything it returned and
    emitted, in order."""
    clock, ev, out = _Clock(), _Events(), []
    r = cls(block_size=8, heartbeat_timeout_s=2.0, events=ev, time_fn=clock)
    for name, tier in (("prefill-0", "prefill"), ("decode-0", "decode"), ("decode-1", "decode"),
                       ("decode-2", "decode")):
        r.register_engine(name, tier)
    base = list(range(20))
    out.append(r.route(0, list(range(100, 110)), 20, session="a"))
    out.append(r.route(1, list(range(10, 20)), 5))
    out.append(r.route(2, list(range(20, 30)), 5))
    out.append(r.route(3, list(range(30, 40)), 5))          # least outstanding tokens, not round-robin
    out.append(r.route(4, base, 8, session="s0"))
    out.append(r.route(5, base + [55, 56], 8, session="s0"))  # affinity: same first block, no prefill
    out.append(r.route(6, [1, 2, 3], 4, session="tiny"))
    out.append(r.route(7, [1, 2, 3, 4], 4, session="tiny"))  # short prompts key on the raw tuple
    out += [r.handoff_done(4), r.complete(1), r.complete(99)]
    clock.t = 1.2                                            # suspect, not dead
    out += [r.check(), r.check()]
    r.heartbeat("decode-1")
    clock.t = 2.5                                            # the silent ones tombstone and drain
    out.append(r.check())
    out.append(r.route(8, base + [9], 8, session="s0"))      # affinity purged with its engine
    out.append(r.mark_dead("decode-1", reason="killed"))     # the tier's last: fail
    with pytest.raises(error):
        r.route(9, list(range(20)), 4)
    out += [r.alive_engines("decode"), r.routed, r.affinity_hits, r.queue_depth]
    return out, ev.records


def test_router_matches_the_reference_router():
    got, got_events = _router_script(Router, RouterError)
    want, want_events = _router_script(jrouter.Router, jrouter.RouterError)
    assert got == want and got_events == want_events
    kinds = [e["kind"] for e in got_events]
    assert kinds.count("gang_suspect") == 5 and "engine_verdict" in kinds  # decode-1 re-suspected after its beat
    assert {e["rung"] for e in got_events if e["kind"] == "engine_verdict"} == {"drain", "fail"}
    assert got[5]["prefill"] is None and got[-2] == 1  # one affinity hit


def test_kill_drains_with_zero_dropped():
    model = _model(UNROLLED)
    clock = VirtualClock()
    fleet = ServingFleet(model, EngineConfig(**ENGINE), FleetConfig(prefill=1, decode=2), time_fn=clock,
                         check_invariants=True)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 97, 16 + i).tolist() for i in range(6)]
    fids = [fleet.submit(p, 8) for p in prompts]
    for _ in range(3):  # requests in flight on both tiers
        fleet.step()
        clock.tick()
    assert fleet.kill_engine("decode-0") >= 1
    _drive(fleet, clock)
    assert sorted(fleet.completed) == sorted(fids)
    s = fleet.summary()
    assert s["dropped_req_total"] == 0 and s["kills"] == 1 and s["requeued"] >= 1
    fleet.engines["decode-1"].allocator.check()
    assert [list(fleet.completed[f].generated) for f in fids] == _single(model, EngineConfig(**ENGINE), prompts, 8)


def test_virtual_clock_replay_is_identical():
    model = _model(UNROLLED)
    trace = make_trace(LoadConfig(rate_rps=40.0, duration_s=0.4, prompt_len=(10, 20), output_len=(4, 8),
                                  vocab_size=97, seed=3, turns=2, turn_gap_s=0.05))

    def one_run():
        clock = VirtualClock()
        fleet = ServingFleet(model, EngineConfig(**ENGINE, prefix_cache=True), FleetConfig(prefill=1, decode=2),
                             time_fn=clock)
        out = run_load(fleet, trace, clock=clock)
        toks = [list(fleet.completed[f].generated) for f in sorted(fleet.completed)]
        return toks, {k: out[k] for k in ("completed", "handoffs", "routed", "affinity_hits", "requeued",
                                          "dropped_req_total", "tokens_out", "serve_p99_ttft_s")}

    toks_a, sum_a = one_run()
    assert one_run() == (toks_a, sum_a)
    assert sum_a["completed"] == len(trace) and sum_a["handoffs"] >= 1 and sum_a["affinity_hits"] >= 1


@pytest.fixture(scope="module", autouse=True)
def cli(tmp_path_factory):
    """Two ``serve --fleet --device cpu`` runs in fresh processes, started
    before the file's first test so that they run while the in-process
    cases compute: the smoke, and a fleet whose worker cannot build its
    engine (``--seq-len 100`` is no multiple of the block size)."""
    ev = tmp_path_factory.mktemp("fleet") / "ev"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}

    def start(*flags):
        return subprocess.Popen([sys.executable, "-m", "distributeddataparallel_tpu_torch.serve", "--device", "cpu",
                                 *flags], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    procs = {"smoke": start("--fleet", "1:2", "--model", "tiny", "--smoke", "--kill-engine", "auto", "--turns", "3",
                            "--events-dir", str(ev)),
             "bad_worker": start("--fleet", "0:1", "--seq-len", "100")}
    results = {}

    def result(name):
        if name not in results:
            out, err = procs[name].communicate(timeout=300)
            results[name] = (procs[name].returncode, out, err)
        return results[name]

    yield result, ev
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def test_serve_fleet_smoke_exits_0(cli):
    rc, text, err = cli[0]("smoke")
    assert rc == 0, err[-3000:]
    assert "fleet smoke OK" in text
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["completed"] == summary["requests"] and summary["dropped_req_total"] == 0
    assert summary["kills"] == 1 and summary["handoffs"] >= 1 and summary["fleet"] == "1:2"


def test_critical_path_and_conformance_on_the_fleet_timeline(cli):
    result, ev = cli
    rc, _, err = result("smoke")
    assert rc == 0, err[-3000:]
    records = load_timeline(str(ev))
    decomps = tcp.request_decompositions(records)
    assert decomps == jcp.request_decompositions(records) and len(decomps) >= 3
    assert tcp.ttft_rollup(decomps) == jcp.ttft_rollup(decomps)
    assert tcp.tier_rollups(decomps) == jcp.tier_rollups(decomps)
    worst = tcp.worst_request(decomps)
    assert worst == jcp.worst_request(decomps)
    assert tcp.critical_path_of(records, worst["trace"]) == jcp.critical_path_of(records, worst["trace"])
    assert tcp.check_lineage(records) == jcp.check_lineage(records) == []
    spec = importlib.util.spec_from_file_location("check_events", ROOT / "scripts" / "check_events.py")
    check_events = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(check_events)
    assert check_events.main(["--conformance", str(ev / "timeline.jsonl")]) == 0


def test_no_gpu_raises_and_a_worker_that_fails_to_build_fails_the_run(cli):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(["--fleet", "1:2", "--smoke"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            FleetService(model="tiny", seq_len=None, seed=0, engine_config=EngineConfig(),
                         fleet_config=FleetConfig(prefill=0, decode=1)).run([])
    assert serve.main(["--fleet", "1-2", "--device", "cpu"]) == 1  # the reference's P:D check
    rc, _, err = cli[0]("bad_worker")
    assert rc != 0 and "block_size (16) must divide max_seq_len (100)" in err
    assert "fleet worker(s) ['decode-0'] exited before reporting (exit codes [1])" in err
