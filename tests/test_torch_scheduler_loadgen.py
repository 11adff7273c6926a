"""The port's scheduler and load generator (``serving/scheduler.py``,
``serving/loadgen.py``, copies of the JAX package's) against the
reference, on the CPU.

- ``make_trace`` is bit-equal to the reference's for Poisson, Zipf
  shared-prefix and multi-turn traces (arrival times as floats, prompts,
  budgets, sessions): both draw from numpy's seeded generator in the same
  order.
- One trace driven through both schedulers (a host-only engine loop that
  appends deterministic tokens) gives the same ``StepPlan`` every step,
  plain and with the prefix cache and a speculative lookahead, under a
  pool small enough to preempt and evict.
- The reference's scheduler invariants hold in the port: a chunked
  prefill does not starve running decodes, a preempted request is
  requeued at the front, impossible requests are refused at submit.
- ``summary`` folds the same completed requests into the same numbers.
"""

import types

import numpy as np
import pytest

from distributeddataparallel_tpu.serving import kv_cache as jkv
from distributeddataparallel_tpu.serving import loadgen as jlg
from distributeddataparallel_tpu.serving import scheduler as jsch
from distributeddataparallel_tpu_torch.serving import kv_cache as tkv
from distributeddataparallel_tpu_torch.serving import loadgen as tlg
from distributeddataparallel_tpu_torch.serving import scheduler as tsch
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

TRACES = {
    "poisson": dict(rate_rps=40.0, duration_s=1.0, prompt_len=(4, 40), output_len=(2, 30), seed=3),
    "zipf": dict(rate_rps=30.0, duration_s=1.0, prompt_len=(20, 40), output_len=(4, 12), seed=4,
                 prefix_pool=4, prefix_len=14, zipf_alpha=1.3),
    "multiturn": dict(rate_rps=10.0, duration_s=1.0, prompt_len=(8, 16), output_len=(4, 8), seed=5,
                      turns=3, turn_gap_s=0.1, turn_tokens=(2, 6)),
}


@pytest.mark.parametrize("kind", list(TRACES))
def test_make_trace_is_bit_equal(kind):
    jt = jlg.make_trace(jlg.LoadConfig(vocab_size=1000, **TRACES[kind]))
    tt = tlg.make_trace(tlg.LoadConfig(vocab_size=1000, **TRACES[kind]))
    assert len(tt) == len(jt) > 5
    for a, b in zip(jt, tt):
        assert set(a) == set(b)
        for k in a:
            if k == "prompt":
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k] and type(a[k]) is type(b[k]), k


def _drive(sch_mod, kv_mod, trace, *, prefix_cache, lookahead):
    """Plans of a host-only run: every plan's decisions as plain data."""
    alloc = kv_mod.BlockAllocator(num_blocks=16, block_size=4)
    s = sch_mod.Scheduler(alloc, num_slots=3, prefill_chunk=8, max_seq_len=64,
                          prefix_cache=prefix_cache, lookahead=lookahead)
    for rid, r in enumerate(trace):
        s.submit(sch_mod.Request(rid=rid, prompt=r["prompt"], max_new_tokens=r["max_new_tokens"]))
    plans = []
    while s.has_work():
        p = s.plan_step()
        plans.append(([r.rid for r in p.admitted], [(r.rid, a, n) for r, a, n in p.prefill_chunks],
                      [r.rid for r in p.decode], [(r.rid, n) for r, n in p.preempted], list(p.evicted),
                      [(r.rid, a, b) for r, a, b in p.cow]))
        for req, start, n in p.prefill_chunks:
            if prefix_cache:
                alloc.register_progress(req.rid, req.ctx_tokens(), upto=start + n)
            if s.advance_prefill(req, n) and not req.generated:
                req.generated.append((req.rid * 7 + 1) % 50)
                if req.done:
                    s.finish(req)
        for req in [r for r in p.decode if r.slot >= 0 and s.running.get(r.slot) is r]:
            req.generated.append((req.rid * 7 + len(req.generated)) % 50)
            if prefix_cache:
                alloc.register_progress(req.rid, req.ctx_tokens(), upto=req.ctx_len)
            if req.done:
                s.finish(req)
        alloc.check()
        assert len(plans) < 5000
    return plans


@pytest.mark.parametrize("prefix_cache,lookahead", [(False, 0), (True, 3)], ids=["plain", "prefix-spec"])
def test_plan_sequences_match(prefix_cache, lookahead):
    trace = tlg.make_trace(tlg.LoadConfig(vocab_size=50, **TRACES["zipf"]))[:14]
    jp = _drive(jsch, jkv, trace, prefix_cache=prefix_cache, lookahead=lookahead)
    tp = _drive(tsch, tkv, trace, prefix_cache=prefix_cache, lookahead=lookahead)
    assert tp == jp
    assert any(p[3] for p in tp) and any(p[4] for p in tp)  # preemptions and evictions happened
    if prefix_cache:
        assert any(p[5] for p in tp)  # and copy-on-write


def test_chunked_prefill_does_not_starve_decodes():
    """With one chunk per plan, a long prompt prefills one chunk per plan
    while the running slot decodes every plan."""
    alloc = tkv.BlockAllocator(num_blocks=16, block_size=4)
    s = tsch.Scheduler(alloc, num_slots=2, prefill_chunk=8, max_seq_len=64, max_prefill_chunks_per_step=1)
    short = tsch.Request(rid=0, prompt=np.zeros(4, np.int32), max_new_tokens=32)
    s.submit(short)
    plan = s.plan_step()
    assert plan.admitted == [short] and plan.prefill_chunks == [(short, 0, 4)] and plan.decode == []
    assert s.advance_prefill(short, 4)
    short.generated.append(1)
    long = tsch.Request(rid=1, prompt=np.zeros(32, np.int32), max_new_tokens=8)
    s.submit(long)
    for step in range(4):
        plan = s.plan_step()
        assert plan.decode == [short], f"decode starved at step {step}"
        assert plan.prefill_chunks == [(long, 8 * step, 8)]
        assert not s.advance_prefill(long, 8) or step == 3
        short.generated.append(1)
    assert s.running[long.slot] is long


def test_preemption_requeues_at_front():
    alloc = tkv.BlockAllocator(num_blocks=4, block_size=4)  # 3 allocatable
    s = tsch.Scheduler(alloc, num_slots=2, prefill_chunk=8, max_seq_len=16)
    a = tsch.Request(rid=0, prompt=np.zeros(3, np.int32), max_new_tokens=8)
    b = tsch.Request(rid=1, prompt=np.zeros(3, np.int32), max_new_tokens=8)
    later = tsch.Request(rid=2, prompt=np.zeros(3, np.int32), max_new_tokens=2)
    for r in (a, b):
        s.submit(r)
    assert s.plan_step().admitted == [a, b]
    s.advance_prefill(a, 3)
    s.advance_prefill(b, 3)
    s.submit(later)
    for _ in range(2):
        for r in (a, b):
            r.generated.append(1)
    plan = s.plan_step()
    assert [r.rid for r, _ in plan.preempted] == [1]
    assert s.waiting[0] is b and s.waiting[1] is later  # at the FRONT, ahead of later arrivals
    assert b.slot == -1 and b.prefilled == 0 and b.preemptions == 1
    assert plan.decode == [a]
    assert b.ctx_len == 3 + len(b.generated) - 1
    alloc.check()


def test_submit_refuses_impossible_requests():
    s = tsch.Scheduler(tkv.BlockAllocator(8, 4), num_slots=2, prefill_chunk=8, max_seq_len=32)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        s.submit(tsch.Request(rid=0, prompt=np.zeros(30, np.int32), max_new_tokens=8))
    s2 = tsch.Scheduler(tkv.BlockAllocator(4, 4), num_slots=2, prefill_chunk=8, max_seq_len=64)
    with pytest.raises(ValueError, match="never be admitted"):
        s2.submit(tsch.Request(rid=1, prompt=np.zeros(20, np.int32), max_new_tokens=8))


def test_summary_matches():
    rng = np.random.default_rng(6)
    done = {}
    for rid in range(9):
        r = tsch.Request(rid=rid, prompt=np.zeros(3, np.int32), max_new_tokens=5,
                         arrival_s=float(rng.random()))
        r.first_token_s = r.arrival_s + float(rng.random())
        r.done_s = r.first_token_s + float(rng.random())
        r.generated = list(range(int(rng.integers(1, 6))))
        r.preemptions = int(rng.integers(0, 2))
        done[rid] = r
    engine = types.SimpleNamespace(completed=done, allocator=types.SimpleNamespace(evictions=4),
                                   _step_idx=31, registry=None, prefix_admits=6, prefix_hits=2,
                                   prefix_hit_tokens=40, prefix_ctx_tokens=90, cow_copies=3,
                                   spec_rows=12, spec_drafted=36, spec_accepted=20)
    assert tlg.summary(engine) == jlg.summary(engine)
    assert tlg.summary(engine, wall_elapsed_s=2.5) == jlg.summary(engine, wall_elapsed_s=2.5)
