"""ddplint for the port: static and recorded checks of its SPMD invariants.

The JAX package's ``analysis`` package, ported.  Three layers:

- graph/flow/schedule rules over one eager step, whose collectives a
  recorder sees as it issues them (``graph_lint``), and over the schedule
  IR a step factory attaches as data (``schedule_lint``);
- AST rules over the port's source (``ast_rules``, ``sync_lint``);
- protocol rules over the declared distributed-protocol state machines
  (``protocol``, explored by a small-scope model checker) and recorded
  event timelines (``conformance``);

with a shared rule registry (``rules``) and the analytic memory fit
(``mesh_sim.analytic_memory_fit``, the autotuner's).  CLI:
``python -m distributeddataparallel_tpu_torch.analysis.ddplint``.

Import note: this package root re-exports only the stdlib-only pieces;
``graph_lint`` (which imports torch) is imported by the callers that need
it, so ``ast_rules``, ``protocol`` and ``conformance`` stay usable without
torch.  Kept out, with no eager meaning: shard_flow's StableHLO passes
(SF202, SF204), the donation check (GL003) and ``mesh_sim.simulate``'s
lowering.
"""

from distributeddataparallel_tpu_torch.analysis.rules import (  # noqa: F401
    RULES,
    Finding,
    collective_manifest,
    format_findings,
    rule_table,
)
