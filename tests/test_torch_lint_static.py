"""The port's stdlib lint layers against the JAX package's, on the CPU.

- The rule registry: the same ids, layers, names and waivers.
- The protocol model checker: ``explore_all`` over the default specs
  gives the same states, moves, completeness and findings, and a mutated
  spec (a rehost election that picks the largest survivor; a handoff
  without its redelivery dedup) the same counterexample trace; the live
  constants are the checker's own objects (the handoff budget and rungs,
  the rehost election).
- Timeline conformance: the same PL405 findings on the same records (a
  forked epoch, a rehost outside the roster, routing to a dead engine, an
  out-of-budget handoff, an affinity hit through the prefill tier).
- The schedule IR: the same units for GPipe, 1F1B and zb at (n, M) = (2,
  4) and (4, 8), and the same SL findings on the clean and a malformed
  table (the hop collective differs by design: ``batch_isend_irecv``
  against ``ppermute``).
- The AST layer: AL103, AL105, AL106 and AL108 find the same lines of the
  same framework-neutral snippets; the torch host-sync patterns (AL101,
  AL107) fire on torch snippets and their pragmas waive them; the port's
  own source lints clean, and the lint CLI's exit codes are the
  reference's.
"""

import dataclasses
import json
import sys
import textwrap
from pathlib import Path

import pytest

from distributeddataparallel_tpu.analysis import ast_rules as jast
from distributeddataparallel_tpu.analysis import conformance as jconf
from distributeddataparallel_tpu.analysis import protocol as jproto
from distributeddataparallel_tpu.analysis import rules as jrules
from distributeddataparallel_tpu.analysis import schedule_lint as jsched
from distributeddataparallel_tpu.analysis import sync_lint as jsync
from distributeddataparallel_tpu_torch.analysis import ast_rules, conformance, ddplint, protocol, rules
from distributeddataparallel_tpu_torch.analysis import schedule_lint as sched
from distributeddataparallel_tpu_torch.analysis import sync_lint

ROOT = Path(__file__).resolve().parents[1]


def _same(mine, theirs):
    assert [str(f) for f in mine] == [str(f) for f in theirs]


def test_rule_registry_equals_the_references():
    assert set(rules.RULES) == set(jrules.RULES)
    for rid, (layer, name, _what, waiver) in jrules.RULES.items():
        assert (rules.RULES[rid][0], rules.RULES[rid][1], rules.RULES[rid][3]) == (layer, name, waiver), rid
    # the kept-out rules say why
    for rid in ("GL003", "SF202", "SF204"):
        assert "no port meaning" in rules.RULES[rid][2], rid
    # the manifest is the reference's, by torch's names, without the keys
    # that serve only GL003 and SF204
    theirs = jrules.collective_manifest("dp", grad_reduce={"data": {"psum": (1, None)}})
    del theirs["donate"], theirs["custom_vjp_collectives_ok"]
    assert rules.collective_manifest("dp", grad_reduce={"data": {"all_reduce": (1, None)}}) == {
        **theirs, "grad_reduce": {"data": {"all_reduce": (1, None)}}}


def _reports(explore_all, specs=None):
    return [(r.spec, r.n_states, r.n_moves, r.complete, [str(f) for f in r.findings])
            for r in explore_all(specs)]


def test_explore_all_and_mutated_specs_equal_the_references():
    assert _reports(protocol.explore_all) == _reports(jproto.explore_all)
    for name, kw in (("rendezvous_spec", {"elect": max}), ("handoff_spec", {"dedup": False}),
                     ("router_spec", {"affinity_uses_prefill": True}), ("allocator_spec", {"cow": False})):
        mine = _reports(protocol.explore_all, (getattr(protocol, name)(**kw),))
        theirs = _reports(jproto.explore_all, (getattr(jproto, name)(**kw),))
        assert mine == theirs and mine[0][4], name  # each mutation has a counterexample
    # The checked plan is the executed plan.
    from distributeddataparallel_tpu_torch.runtime import rendezvous
    from distributeddataparallel_tpu_torch.serving import handoff

    assert handoff.HANDOFF_MAX_ATTEMPTS is protocol.HANDOFF_MAX_ATTEMPTS == jproto.HANDOFF_MAX_ATTEMPTS
    assert handoff.verdict_rung is protocol.verdict_rung and handoff.VERDICT_RUNGS == jproto.VERDICT_RUNGS
    assert rendezvous.elect_rehost(["c", "a", "b"]) == protocol.elect_rehost_owner(["c", "b", "a"]) == "a"


TIMELINE = [
    {"kind": "membership_epoch", "proc": 0, "epoch": 1, "roster": ["a", "b", "c"]},
    {"kind": "membership_epoch", "proc": 1, "epoch": 2, "roster": ["a", "b"]},
    {"kind": "membership_epoch", "proc": 0, "epoch": 2, "roster": ["a", "c"]},  # forked
    {"kind": "membership_epoch", "proc": 1, "epoch": 1, "roster": ["a", "b", "c"]},  # backwards
    {"kind": "rdzv_rehost", "owner": "z", "generation": 1},
    {"kind": "rdzv_rehost", "owner": "a", "generation": 1},
    {"kind": "gang_verdict", "rung": "retry"},
    {"kind": "route_admit", "req": 7, "engine": "d0", "prefill": "p0", "affinity": True},
    {"kind": "route_admit", "req": 8, "engine": "d0", "prefill": "p0"},
    {"kind": "route_admit", "req": 8, "engine": "d1", "prefill": "p0"},
    {"kind": "kv_handoff", "req": 8, "attempts": 9},
    {"kind": "kv_handoff", "req": 9, "attempts": 1},
    {"kind": "engine_verdict", "engine": "d0", "rung": "drain"},
    {"kind": "engine_verdict", "engine": "d0", "rung": "melt"},
    {"kind": "route_admit", "req": 10, "engine": "d0", "prefill": None},
]


def test_timeline_conformance_equals_the_references(tmp_path):
    mine, theirs = conformance.check_timeline(TIMELINE), jconf.check_timeline(TIMELINE)
    _same(mine, theirs)
    assert len(mine) >= 8
    assert conformance.check_timeline(TIMELINE[:2]) == []
    path = tmp_path / "timeline.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in TIMELINE) + "\n{torn")
    _same(conformance.check_path(str(path)), jconf.check_path(str(path)))


@pytest.mark.parametrize("n,M", [(2, 4), (4, 8)])
def test_schedule_ir_and_its_lint_equal_the_references(n, M):
    for build in ("gpipe_schedule_ir", "one_f_one_b_schedule_ir", "zb_schedule_ir"):
        mine, theirs = getattr(sched, build)(n, M), getattr(jsched, build)(n, M)
        assert [dataclasses.astuple(u) for u in mine.units] == [dataclasses.astuple(u) for u in theirs.units]
        a, b = mine.to_dict(), theirs.to_dict()
        assert (a.pop("hop_prim"), b.pop("hop_prim")) == ("batch_isend_irecv", "ppermute")
        assert a == b, build
        _same(sched.lint_schedule(mine), jsched.lint_schedule(theirs))
        # a malformed table: one unit duplicated, one dropped
        units = list(mine.units)
        broken = dataclasses.replace(mine, units=tuple(units[:-1] + units[:1]))
        jbroken = dataclasses.replace(theirs, units=tuple(list(theirs.units)[:-1] + list(theirs.units)[:1]))
        found = sched.lint_schedule(broken)
        assert {f.rule for f in found} == {"SL301"}
        _same(found, jsched.lint_schedule(jbroken))
    # every stage's sends of the 1F1B table: forwards down, backwards up
    table = sched.one_f_one_b_schedule_ir(n, M)
    assert [sched.stage_sends(table, s) for s in range(n)] == [M] + [2 * M] * (n - 2) + [M]
    assert sched.grad_sync_schedule_ir(3).hop_prim == "all_reduce"


NEUTRAL = textwrap.dedent('''\
    import socket
    import threading
    import time


    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []

        def put(self, x):
            with self._lock:
                self.items.append(x)

        def drop(self):
            self.items.clear()


    def dial(addr):
        try:
            return socket.create_connection(addr)
        except Exception:
            pass


    def now():
        return time.monotonic()
    ''')


def _rules_at(findings):
    return sorted((f.rule, int(f.where.rsplit(":", 1)[1])) for f in findings)


def test_neutral_snippets_find_the_same_lines():
    rel, jrel = "distributeddataparallel_tpu_torch/serving/router.py", "distributeddataparallel_tpu/serving/router.py"
    mine = ast_rules.lint_source(NEUTRAL, rel) + sync_lint.lint_source(NEUTRAL, rel)
    theirs = jast.lint_source(NEUTRAL, jrel) + jsync.lint_source(NEUTRAL, jrel)
    assert _rules_at(mine) == _rules_at(theirs)
    assert {r for r, _ in _rules_at(mine)} == {"AL103", "AL105", "AL106", "AL108"}


def test_torch_host_syncs_fire_on_the_step_and_serve_paths():
    src = textwrap.dedent('''\
        import numpy as np
        import torch


        def step(loss, grads):
            a = loss.item()
            b = grads.tolist()
            c = grads.cpu()
            d = float(loss.sum())
            e = np.asarray(grads)
            torch.cuda.synchronize()
            f = loss.item()  # ddplint: allow[host-sync] — a planted, waived read
            return a, b, c, d, e, f
        ''')
    found = ast_rules.lint_source(src, "distributeddataparallel_tpu_torch/training/train_step.py")
    assert _rules_at(found) == [("AL101", line) for line in range(6, 12)]
    assert ast_rules.lint_source(src, "distributeddataparallel_tpu_torch/data/loader.py") == []
    serve = sync_lint.lint_source(src, "distributeddataparallel_tpu_torch/serving/engine.py")
    assert _rules_at(serve) == [("AL107", line) for line in (6, 7, 8, 10, 12)]


def test_the_ports_source_lints_clean_and_the_cli_exits_as_the_reference():
    targets = ast_rules.default_targets(ROOT)
    assert targets and all("distributeddataparallel_tpu_torch" in str(t) for t in targets)
    found = ddplint.run_ast(False)  # the AST and sync layers over those targets
    assert found == [], rules.format_findings(found)
    from distributeddataparallel_tpu_torch.observability.schema import EVENT_KINDS

    assert set(ast_rules.collect_emitted_kinds(ROOT)) <= set(EVENT_KINDS) and "lint_report" in EVENT_KINDS
    assert ddplint.main(["--list-rules"]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ddplint, "run_ast", lambda changed_only: found)  # linted once, above
        assert ddplint.main(["--ast", "--protocol"]) == 0
        mp.setattr(ddplint, "run_ast", lambda changed_only: [rules.Finding("AL103", "x:1", "planted")])
        assert ddplint.main(["--ast"]) == 1
        mp.setattr(ddplint, "run_ast", lambda changed_only: [rules.Finding("ZZ999", "x:1", "invented")])
        assert ddplint.main(["--ast"]) == 2
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import ddplint as jddplint
    finally:
        sys.path.pop(0)
    assert jddplint.main(["--list-rules"]) == 0
