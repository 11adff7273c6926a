"""ddplint for the port — the twin of the JAX package's ``scripts/ddplint.py``.

Layers (rule table: ``--list-rules``; registry in ``analysis/rules.py``):

  --ast      AST rules over the port's source (AL1xx: the step-path pass
             in ``ast_rules`` plus the concurrency/clock pass in
             ``sync_lint``).  Stdlib only.
  --graph    Graph rules over the port's own step factories at tiny
             sizes, each built by the entry point's ``build_trainer`` in a
             process group of one rank on ``--device`` and run for three
             steps under the collective recorder (GL001, GL002, GL004,
             GL005, SF201, SF203), with the schedule-as-data lint (SL3xx)
             for a step that carries a schedule IR (the bucketed sync).
  --protocol Protocol rules (PL4xx): the small-scope model checker
             explores the declared rendezvous / router / handoff /
             allocator state machines exhaustively.  Stdlib only.

With no layer flag, all three layers run.  ``--changed-only`` narrows
the AST layer to files in ``git diff --name-only HEAD``, skips the graph
layer unless step-defining code changed, and skips the protocol layer
unless analysis/runtime/serving code changed.  ``--events-dir DIR``
additionally writes one schema-valid ``lint_report`` event per layer to
``DIR/events-lint.jsonl``.

Exit status: 0 clean, 1 findings, 2 operational error (including a
checker emitting a rule id the registry doesn't know).

Examples:
    python -m distributeddataparallel_tpu_torch.analysis.ddplint --ast --protocol
    python -m distributeddataparallel_tpu_torch.analysis.ddplint --graph --device cpu --modes all
    python -m distributeddataparallel_tpu_torch.analysis.ddplint --graph --device cuda
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PKG = "distributeddataparallel_tpu_torch/"

#: a graph-layer run is warranted when any of these changed
_GRAPH_TRIGGERS = tuple(PKG + d for d in ("analysis/", "parallel/", "training/", "ops/", "dpp.py"))

#: a protocol-layer run is warranted when the specs or the live modules
#: they model changed
_PROTOCOL_TRIGGERS = tuple(PKG + d for d in ("analysis/", "runtime/", "serving/"))

#: graph-lint modes; "all" expands to every one
DEFAULT_MODES = ("dp", "zero", "bucket", "bf16")
ALL_MODES = ("dp", "zero", "bucket", "bf16", "fsdp")

_MLP = ["--model", "mlp", "--num-examples", "64", "--batch-size", "8"]
_LM = ["--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16", "--vocab-size", "64",
       "--num-examples", "32", "--batch-size", "4"]
#: each mode's flags of the port's entry point
MODE_FLAGS = {
    "dp": _MLP,
    "zero": _MLP + ["--zero", "1", "--optimizer", "adamw"],
    "bucket": _MLP + ["--bucket-mb", "1"],
    "bf16": _LM,
    "fsdp": _LM + ["--fsdp"],
}


def _changed_files(root: Path | None = None) -> list[str]:
    out = subprocess.run(["git", "diff", "--name-only", "HEAD"], cwd=root or ROOT, capture_output=True,
                         text=True, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def run_ast(changed_only: bool, *, root: Path | None = None) -> list:
    from distributeddataparallel_tpu_torch.analysis import ast_rules, sync_lint

    root = root or ROOT
    targets = ast_rules.default_targets(root)
    if changed_only:
        changed = set(_changed_files(root))
        targets = [t for t in targets if t.relative_to(root).as_posix() in changed]
        if not targets:
            return []
    return ast_rules.lint_paths(targets, root) + sync_lint.lint_paths(targets, root)


def run_protocol(*, verbose: bool = True) -> list:
    """Exhaustively explore every shipped protocol spec (PL4xx)."""
    from distributeddataparallel_tpu_torch.analysis import protocol

    findings: list = []
    for rep in protocol.explore_all():
        findings += rep.findings
        if verbose:
            status = "ok" if rep.ok else f"{len(rep.findings)} finding(s)"
            print(f"ddplint proto [{rep.spec}] {status} states={rep.n_states} moves={rep.n_moves} "
                  f"complete={rep.complete}")
    return findings


def graph_cases(modes, device: str):
    """Yield ``(mode, step, state, batch, seed)``: the port's factories
    through the entry point's ``build_trainer`` at tiny sizes, in the
    current process group.  ``bf16`` is plain DP of the tiny LM with its
    parameters cast to bf16 (GL004's wire check)."""
    import torch

    from distributeddataparallel_tpu_torch import dpp

    dev = torch.device(device)
    for mode in modes:
        args = dpp.parse_args(["--device", device, *MODE_FLAGS[mode]])
        trainer = dpp.build_trainer(args, dev, 0, 1)
        if mode == "bf16":
            trainer.state.model.to(torch.bfloat16)
        batch = next(iter(trainer.loader))
        yield mode, trainer.step_fn, trainer.state, batch, dpp.step_seed(args, 0, 0)


def run_graph(modes, *, device: str = "cpu", verbose: bool = True) -> dict:
    """Run every requested factory's step three times under the recorder and the
    graph (GL0xx), flow (SF201, SF203) and schedule (SL3xx) checks in a
    process group of one rank on ``device``.  Returns the findings per
    layer: ``{"graph": [...], "schedule": [...]}``."""
    from distributeddataparallel_tpu_torch.analysis import graph_lint
    from distributeddataparallel_tpu_torch.observability.memory import hbm_budget_bytes
    from distributeddataparallel_tpu_torch.runtime import distributed as rt

    by_layer: dict[str, list] = {"graph": [], "schedule": []}
    rt.init_process_group(world_size=1, rank=0, device=device)
    try:
        for mode, step, state, batch, seed in graph_cases(modes, device):
            rep = graph_lint.lint_train_step(step, state, batch, seed, mode=mode,
                                             hbm_budget_bytes=hbm_budget_bytes())
            ir, sched = graph_lint.lint_step_schedule(step, state, rep)
            by_layer["graph"] += rep.findings
            by_layer["schedule"] += sched
            if verbose:
                counts = " ".join(f"{k}={v}" for k, v in sorted(rep.collective_counts.items()))
                status = "ok" if rep.ok and not sched else f"{len(rep.findings) + len(sched)} finding(s)"
                note = f" schedule={ir.kind}" if ir is not None else ""
                print(f"ddplint graph [{mode}] {status} fp={rep.fingerprint} {counts}{note}")
    finally:
        rt.destroy_process_group()
    return by_layer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ddplint", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ast", action="store_true", help="run the AST layer (AL1xx rules)")
    ap.add_argument("--graph", action="store_true", help="run the graph layer (GL0xx, SF2xx, SL3xx rules)")
    ap.add_argument("--protocol", action="store_true",
                    help="run the protocol layer (PL4xx rules): model-check the declared rendezvous/router/"
                         "handoff/allocator state machines")
    ap.add_argument("--changed-only", action="store_true",
                    help="lint only files changed vs HEAD; skip the graph layer unless step code changed")
    ap.add_argument("--modes", default=",".join(DEFAULT_MODES),
                    help=f"graph-lint configurations, comma-separated (default: %(default)s; 'all' = "
                         f"{','.join(ALL_MODES)})")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="where the graph layer's steps run (default cuda; it raises without a GPU)")
    ap.add_argument("--list-rules", action="store_true", help="print the rule table and exit")
    ap.add_argument("--events-dir", metavar="DIR",
                    help="append one lint_report event per layer to DIR/events-lint.jsonl")
    args = ap.parse_args(argv)

    from distributeddataparallel_tpu_torch.analysis.rules import (
        format_findings,
        rule_table,
        unregistered_rule_ids,
    )

    if args.list_rules:
        print(rule_table())
        return 0

    any_layer = args.ast or args.graph or args.protocol
    modes = ALL_MODES if args.modes == "all" else tuple(m.strip() for m in args.modes.split(",") if m.strip())
    unknown = set(modes) - set(ALL_MODES)
    if unknown:
        ap.error(f"unknown --modes {sorted(unknown)}; pick from {','.join(ALL_MODES)} or 'all'")

    by_layer: dict[str, list] = {}
    if args.ast or not any_layer:
        by_layer["ast"] = run_ast(args.changed_only)
    if args.protocol or not any_layer:
        if args.changed_only and not any(c.startswith(_PROTOCOL_TRIGGERS) for c in _changed_files()):
            print("ddplint proto: skipped (no protocol-adjacent changes)")
        else:
            by_layer["protocol"] = run_protocol()
    if args.graph or not any_layer:
        if args.changed_only and not any(c.startswith(_GRAPH_TRIGGERS) for c in _changed_files()):
            print("ddplint graph: skipped (no step-defining changes)")
        else:
            by_layer.update(run_graph(modes, device=args.device))

    findings = [f for fs in by_layer.values() for f in fs]

    if args.events_dir:
        from distributeddataparallel_tpu_torch.observability.events import EventLog

        ev = EventLog(os.path.join(args.events_dir, "events-lint.jsonl"), proc="lint")
        try:
            for layer, fs in sorted(by_layer.items()):
                ev.emit("lint_report", layer=layer, n_findings=len(fs), rules=sorted({f.rule for f in fs}),
                        findings=[str(f) for f in fs[:50]])
        finally:
            ev.close()

    # A checker inventing a rule id is an operational error, not a finding.
    bad_ids = unregistered_rule_ids(findings)
    if bad_ids:
        print(f"ddplint: unregistered rule id(s) {bad_ids} — register them in analysis/rules.py RULES",
              file=sys.stderr)
        return 2
    if findings:
        print(format_findings(findings), file=sys.stderr)
        print(f"ddplint: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    print("ddplint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
