"""The port's command line against the reference's, and a scheduler stall
the port inherits from the reference, on the CPU.

- Both parsers (the reference's ``dpp.py``, read through its own
  ``parse_args`` with ``argparse.ArgumentParser.parse_args`` patched to hand
  back the parser, and ``distributeddataparallel_tpu_torch.dpp``) have the
  same flags with the same defaults, types, choices and ``nargs`` but for
  ``--device`` (the port's defaults to ``cuda``).
- Every flag whose feature is not ported raises ``NotImplementedError``
  naming its ROADMAP.md Queue 1 item at a value the reference accepts; the
  reference's own value checks come first, with its messages.
- The scheduler replay of ROADMAP.md Queue 3's fault 2: 14 requests of the
  Zipf trace with 3 slots, 14 blocks of 4, the prefix cache and a lookahead
  of 3.  Both schedulers make the same plans; request 3 (prompt 40, budget
  12) is preempted at context 49, where its decode window needs 53 tokens
  (14 blocks) of the 13 the pool can allocate, and its re-admission needs
  the same 14, so FIFO admission stops at it and every later plan is
  empty.  The check at submit counts prompt + budget (52 tokens, 13
  blocks) and not the lookahead.  This is the reference's behaviour; the
  port keeps it.
"""

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402


class _Captured(Exception):
    pass


def parser_of(parse_args) -> argparse.ArgumentParser:
    """The parser a module's ``parse_args`` builds, taken at its
    ``ArgumentParser.parse_args`` call."""
    seen = {}

    def grab(self, *a, **k):
        seen["parser"] = self
        raise _Captured

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab), pytest.raises(_Captured):
        parse_args([])
    return seen["parser"]


def flags(parser) -> dict:
    return {a.option_strings[-1]: a for a in parser._actions if a.option_strings and a.dest != "help"}


def reference_parser():
    import dpp as jdpp  # the reference entry point

    return jdpp, parser_of(jdpp.parse_args)


def test_both_parsers_have_the_same_flags_defaults_and_choices():
    _, ref = reference_parser()
    mine, theirs = flags(parser_of(tdpp.parse_args)), flags(ref)
    assert set(mine) == set(theirs) and len(mine) == 85
    for name in sorted(set(mine) - {"--device"}):
        a, b = mine[name], theirs[name]
        for attr in ("dest", "default", "choices", "nargs", "const", "type"):
            va, vb = getattr(a, attr), getattr(b, attr)
            if attr == "type" and callable(va) and callable(vb):
                va, vb = getattr(va, "__name__", va), getattr(vb, "__name__", vb)
            assert va == vb, f"{name}.{attr}: {va!r} != {vb!r}"
        assert type(a) is type(b), name
    assert mine["--device"].default == "cuda" and theirs["--device"].default == "auto"


# Each unported flag at a value the reference accepts, and its item: none
# since item 21's --lint-step.
UNPORTED = []


# Item 17's, 16a's, 16b's and 11b's cases, ported since: each parses and
# validates as the reference's does, with its values, and builds the MoE or
# pipeline config.
PORTED = [
    # item 21's --lint-step
    ["--lint-step"],
    ["--model", "gpt2", "--lint-step", "--pp", "2"],
    # item 22's --autotune and --tune-*, item 10's --bw-probe
    ["--autotune", "search", "--tune-dir", "t", "--tune-trials", "5", "--tune-steps", "2"],
    ["--tune-steps", "2"],
    ["--model", "gpt2", "--autotune", "apply", "--zero", "1"],
    ["--bw-probe"],
    # item 20a's --integrity-every and --integrity-shadow
    ["--integrity-every", "2", "--integrity-shadow"],
    ["--integrity-every", "3", "--zero", "1", "--elastic", "--elastic-dir", "gang"],
    # item 13's --elastic, --elastic-dir and --min-procs
    ["--elastic", "--checkpoint-dir", "ck"],
    ["--elastic-dir", "gang"],
    ["--min-procs", "2"],
    ["--elastic", "--elastic-dir", "gang", "--zero", "1", "--min-procs", "2"],
    ["--compile-cache", "cache"],
    ["--dispatch-depth", "0"],
    ["--dispatch-depth", "4", "--nan-guard"],
    ["--model", "gpt2", "--pp", "2", "--pp-schedule", "zb"],
    ["--model", "gpt2", "--pp", "2", "--cp", "2", "--seq-len", "16"],
    ["--pp-schedule", "zb"],
    ["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"],
    ["--model", "gpt2", "--moe-experts", "2", "--ep", "2"],
    ["--model", "gpt2", "--moe-experts", "4"],
    ["--moe-aux-weight", "0"],
    ["--model", "gpt2", "--moe-experts", "4", "--moe-top-k", "2", "--moe-capacity-factor", "1.25"],
    ["--model", "gpt2", "--pp", "2"],
    ["--pp-microbatches", "4"],
    ["--pp-schedule", "1f1b"],
    ["--model", "llama", "--layers", "4", "--pp", "2", "--pp-schedule", "1f1b", "--pp-microbatches", "4"],
]


def test_unported_flags_raise_naming_their_item(tmp_path):
    jdpp, _ = reference_parser()
    for argv, item in UNPORTED:
        argv = ["--device", "cpu", *argv]
        jdpp.validate_args(jdpp.parse_args(argv))  # the reference accepts the value
        with pytest.raises(NotImplementedError, match=rf"ROADMAP.md Queue 1, item {item}$"):
            tdpp.parse_args(argv)
    for argv in PORTED:
        argv = ["--device", "cpu", *argv]
        jargs = jdpp.parse_args(argv)
        jdpp.validate_args(jargs)
        args = tdpp.parse_args(argv)
        for dest in ("ep", "moe_experts", "moe_top_k", "moe_aux_weight", "moe_capacity_factor", "pp",
                     "pp_microbatches", "pp_schedule", "pp_virtual", "cp", "compile_cache", "dispatch_depth",
                     "elastic", "elastic_dir", "min_procs", "integrity_every", "integrity_shadow",
                     "autotune", "tune_dir", "tune_trials", "tune_steps", "bw_probe", "lint_step"):
            assert getattr(args, dest) == getattr(jargs, dest), dest
        if args.pp > 1:
            cfg = tdpp.build_config(args)
            assert cfg.scan_layers  # the stages' slices of the stacked layout
            assert cfg.cp_axis == ("seq" if args.cp > 1 else None)
        if args.moe_experts:
            cfg = tdpp.build_config(args)
            assert (cfg.moe_experts, cfg.moe_top_k, cfg.moe_capacity_factor) == (
                args.moe_experts, args.moe_top_k, args.moe_capacity_factor)
            assert cfg.ep_axis == ("expert" if args.ep > 1 else None)
    seen = {d for dests in tdpp.UNPORTED_FLAGS.values() for d in dests}
    # the 21 flags the parser lacked, less --fsdp-gather, item 17's four,
    # item 16a's --pp, --pp-microbatches, --pp-schedule, 16b's --pp-virtual,
    # 11b's --compile-cache and --dispatch-depth, item 13's --elastic,
    # --elastic-dir and --min-procs and item 20a's --integrity-every and
    # --integrity-shadow, item 22's --autotune and --tune-*, item 10's
    # --bw-probe and item 21's --lint-step: every flag runs
    assert len(seen) == 0 and tdpp.UNPORTED_FLAGS == {}
    assert not {"17", "16", "16b", "11b", "13", "20", "20a", "21", "22", "10's remainder"} & set(tdpp.UNPORTED_FLAGS)
    # Item 13's flags run: a gang of one joins its store, trains, and leaves it.
    summary = tdpp.main(["--device", "cpu", "--model", "mlp", "--epochs", "1", "--steps-per-epoch", "2",
                         "--num-examples", "32", "--batch-size", "4", "--elastic", "--elastic-dir",
                         str(tmp_path / "gang"), "--min-procs", "1"])
    assert summary["train_steps"] == 2 and summary["world_size"] == 1
    assert json.loads((tmp_path / "gang" / "epoch.json").read_text())["roster"] == ["proc0"]
    # Item 20a's flags run: two cadence checks, each step run again by the shadow.
    summary = tdpp.main(["--device", "cpu", "--model", "mlp", "--epochs", "1", "--steps-per-epoch", "4",
                         "--num-examples", "32", "--batch-size", "4", "--integrity-every", "2",
                         "--integrity-shadow"])
    assert summary["faults"]["sdc_checks"] == 2 and summary["faults"]["sdc_detects"] == 0
    # --elastic across hosts stays hostgang's (item 20b).
    with pytest.raises(NotImplementedError, match=r"--coordinator\) is hostgang's: ROADMAP.md Queue 1, item 20b$"):
        tdpp.parse_args(["--device", "cpu", "--elastic", "--elastic-dir", "g", "--coordinator", "127.0.0.1:1",
                         "--num-processes", "2", "--process-id", "0"])


REFERENCE_CHECKS = [
    (["--min-procs", "0"], "--min-procs must be >= 1"),
    (["--pp-virtual", "2"], "--pp-virtual requires --pp > 1"),
    (["--moe-top-k", "2"], "--moe-top-k requires --moe-experts"),
    (["--model", "gpt2", "--moe-experts", "2", "--moe-capacity-factor", "-1"], "--moe-capacity-factor must be >= 0"),
    (["--model", "gpt2", "--ep", "2"], "--ep requires --moe-experts"),
    (["--integrity-shadow"], "--integrity-shadow needs a cadence"),
    (["--integrity-every", "-1"], "--integrity-every must be >= 0"),
    (["--model", "gpt2", "--integrity-every", "2", "--tp", "2", "--cp", "2", "--seq-len", "16"],
     r"--integrity-every compares replicated data-axis state; drop --tp, --cp$"),
    (["--integrity-every", "2", "--zero", "2"],
     "--integrity-every supports plain DP and --zero 1; ZeRO-2/3 shard the comparable state away"),
    (["--elastic"], "--elastic needs a rendezvous root"),
    (["--model", "gpt2", "--autotune", "search", "--tp", "2"], "--autotune searches the DP/ZeRO space only; drop --tp"),
    (["--model", "gpt2", "--pp", "2", "--accum-steps", "2"], "IS the accumulation"),
]


def test_reference_value_checks_come_first():
    jdpp, _ = reference_parser()
    for argv, match in REFERENCE_CHECKS:
        argv = ["--device", "cpu", *argv]
        with pytest.raises(SystemExit, match=match):
            jdpp.validate_args(jdpp.parse_args(argv))
        with pytest.raises(SystemExit, match=match):
            tdpp.parse_args(argv)
    with pytest.raises(SystemExit, match="--dispatch-depth must be >= 0"):
        tdpp.parse_args(["--device", "cpu", "--dispatch-depth", "-1"])


def _replay(sch_mod, kv_mod, trace, limit):
    """The host-only engine loop of ``test_torch_scheduler_loadgen.py`` at 14
    blocks, prefix cache and lookahead 3: the plans, and the scheduler."""
    alloc = kv_mod.BlockAllocator(num_blocks=14, block_size=4)
    s = sch_mod.Scheduler(alloc, num_slots=3, prefill_chunk=8, max_seq_len=64, prefix_cache=True, lookahead=3)
    for rid, r in enumerate(trace):
        s.submit(sch_mod.Request(rid=rid, prompt=r["prompt"], max_new_tokens=r["max_new_tokens"]))
    plans = []
    while s.has_work() and len(plans) < limit:
        p = s.plan_step()
        plans.append(([r.rid for r in p.admitted], [(r.rid, a, n) for r, a, n in p.prefill_chunks],
                      [r.rid for r in p.decode], [(r.rid, n) for r, n in p.preempted], list(p.evicted),
                      [(r.rid, a, b) for r, a, b in p.cow]))
        for req, start, n in p.prefill_chunks:
            alloc.register_progress(req.rid, req.ctx_tokens(), upto=start + n)
            if s.advance_prefill(req, n) and not req.generated:
                req.generated.append((req.rid * 7 + 1) % 50)
                if req.done:
                    s.finish(req)
        for req in [r for r in p.decode if r.slot >= 0 and s.running.get(r.slot) is r]:
            req.generated.append((req.rid * 7 + len(req.generated)) % 50)
            alloc.register_progress(req.rid, req.ctx_tokens(), upto=req.ctx_len)
            if req.done:
                s.finish(req)
        alloc.check()
    return plans, s, alloc


def test_tight_pool_stalls_in_both_schedulers():
    """ROADMAP.md Queue 3, fault 2: the stall, plan for plan the
    reference's (module docstring)."""
    from distributeddataparallel_tpu.serving import kv_cache as jkv
    from distributeddataparallel_tpu.serving import scheduler as jsch
    from distributeddataparallel_tpu_torch.serving import kv_cache as tkv
    from distributeddataparallel_tpu_torch.serving import loadgen as tlg
    from distributeddataparallel_tpu_torch.serving import scheduler as tsch

    trace = tlg.make_trace(tlg.LoadConfig(vocab_size=50, rate_rps=30.0, duration_s=1.0, prompt_len=(20, 40),
                                          output_len=(4, 12), seed=4, prefix_pool=4, prefix_len=14,
                                          zipf_alpha=1.3))[:14]
    jp, _, _ = _replay(jsch, jkv, trace, 120)
    tp, ts, ta = _replay(tsch, tkv, trace, 120)
    assert tp == jp and len(tp) == 120 and ts.has_work()
    assert tp[38][3] == [(3, 13)]  # request 3 preempted, its 13 blocks freed
    assert all(p == ([], [], [], [], [], []) for p in tp[39:])  # then nothing, forever
    head = ts.waiting[0]
    assert head.rid == 3 and not ts.running and not ts.prefilling
    need = ta.blocks_for(head.ctx_len + 1 + ts.lookahead)
    assert (head.ctx_len, need, ta.num_blocks - 1) == (49, 14, 13)
    assert ta.blocks_for(head.prompt_len + head.max_new_tokens) == 13  # what submit checked
