"""Analysis helpers of the port.

Only ``mesh_sim.analytic_memory_fit`` is here: the autotuner's analytic
memory pruning (``tuning.harness``).  The rest of the reference's
``analysis`` package (the graph, AST and protocol lints, ``--lint-step``,
and ``mesh_sim``'s lowering and ``simulate``) is ROADMAP.md Queue 1's item
21.
"""
