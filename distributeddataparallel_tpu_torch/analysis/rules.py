"""ddplint rule registry of the port: ids, descriptions, waivers, manifests.

The port's copy of the JAX package's ``analysis/rules.py``: the same rule
ids, layers, names and waiver pragmas, with the texts naming torch's
collectives where the reference named JAX primitives (``all_reduce`` for
``psum``, ``reduce_scatter_tensor``, ``all_gather_into_tensor``,
``all_to_all_single``, and the P2P ``batch_isend_irecv`` for
``ppermute``).  The layers:

- **graph rules (GL*)** run over the collectives one eager step issues
  (``analysis.graph_lint``'s recorder): a dropped or doubled gradient
  reduction, a collective order that changes between steps, a promoted
  dtype, a device-to-host sync inside the step;
- **sharding-flow rules (SF*)** SF201 and SF203 read the same recorded
  collectives (a gradient-sized ``all_reduce`` where the manifest declares
  a reduce-scatter; an all-gather larger than the device's memory);
- **schedule rules (SL*)** run over the schedule IR a factory attaches
  as data (``analysis.schedule_lint``);
- **AST rules (AL*)** run over the port's source (``analysis.ast_rules``
  for the step path, ``analysis.sync_lint`` for the runtime/serving
  protocol code);
- **protocol rules (PL*)** run over the declared protocol state machines
  (``analysis.protocol``) and recorded event timelines
  (``analysis.conformance``).

Three rules stay in the table with no port meaning, so ids and tables
match the reference's: GL003 (donation: the port's update runs in place
and donates no buffer), SF202 and SF204 (shard_flow's loop and
``custom_vjp`` passes over a lowered StableHLO module: an eager step has
no lowered module).  No checker of the port emits them.

Waivers: AST findings can be waived per line with a pragma comment
``# ddplint: allow[<tag>]`` on the offending line (or the line directly
above, for wrapped statements).  Graph/flow/schedule rules have no
pragma: the step factory's collective manifest and attached schedule IR
declare what the step is supposed to issue.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import dataclasses

#: rule id -> (layer, name, what it catches, waiver)
RULES: dict[str, tuple[str, str, str, str]] = {
    "GL001": (
        "graph", "grad-reduce-count",
        "missing/extra gradient-sized reduction collectives per mesh "
        "axis (a dropped all_reduce trains on per-replica grads; a "
        "doubled one pays the wire twice)",
        "factory manifest (grad_reduce bounds)",
    ),
    "GL002": (
        "graph", "collective-order",
        "collective sequence fingerprint differs between two recorded "
        "runs of the same step (nondeterministic collective order deadlocks a "
        "gang: ranks would issue collectives in different orders)",
        "none",
    ),
    "GL003": (
        "graph", "donation-coverage",
        "factory requested donate=True but the lowered module does not "
        "alias params+optimizer-state inputs to outputs (silent 2x "
        "state memory); no port meaning: the update runs in place",
        "factory manifest (donate=False)",
    ),
    "GL004": (
        "graph", "dtype-promotion",
        "bf16 params/grads promoted to f32 — on the wire (f32 "
        "gradient reduction under uniformly-bf16 params) or in the "
        "updated state (output param dtype != input param dtype)",
        "factory manifest (allow_f32_reduce)",
    ),
    "GL005": (
        "graph", "host-callback",
        "a device-to-host sync inside the step (.item(), .tolist(), "
        ".cpu(), a non-pinned copy to the host; read under "
        "torch.cuda.set_sync_debug_mode('error')): every step waits "
        "for the device",
        "none",
    ),
    "SF201": (
        "flow", "replicated-grad",
        "gradient-sized all_reduce under a manifest that declares "
        "sharded reduction (reduce_scatter_tensor) — the gradient is reduced "
        "fully replicated, silently defeating the ZeRO/FSDP memory win",
        "factory manifest (no reduce_scatter declared)",
    ),
    "SF202": (
        "flow", "reshard-in-loop",
        "reshard collective (all_gather/all_to_all) inside a loop body "
        "re-gathering a loop-invariant value — the same bytes cross the "
        "interconnect every iteration for an identical result; no port "
        "meaning: an eager step has no lowered loop",
        "factory manifest (prim declared in grad_reduce)",
    ),
    "SF203": (
        "flow", "gather-exceeds-hbm",
        "all_gather_into_tensor whose gathered output is larger than the "
        "per-device memory budget (observability.memory convention) — the program "
        "cannot fit at this scale regardless of schedule",
        "budget override (hbm_budget_bytes)",
    ),
    "SF204": (
        "flow", "custom-vjp-opaque",
        "collective or sharding-constraint hidden behind a custom_vjp "
        "boundary whose backward rule is opaque to the flow pass — the "
        "hand-written transpose can silently drop the sharding; no port "
        "meaning: an eager step has no lowered module",
        "factory manifest (custom_vjp_collectives_ok)",
    ),
    "SL301": (
        "sched", "schedule-malformed",
        "pipeline schedule table is not a valid pipeline: a (stage, "
        "chunk, microbatch, phase) unit missing/duplicated, or a "
        "microbatch reaching stage s+1 no later than stage s",
        "none",
    ),
    "SL302": (
        "sched", "schedule-collectives",
        "per-stage collectives disagree with the schedule: the recorded "
        "boundary sends != the sends the IR's table gives the stage, or "
        "the manifest does not declare the hop collective",
        "none",
    ),
    "SL303": (
        "sched", "cross-stage-donation",
        "schedule donates/overwrites a buffer another in-flight unit "
        "still reads (saved-activation ring slot collision, or a "
        "donated carry with live cross-stage consumers)",
        "none",
    ),
    "SL304": (
        "sched", "bubble-mismatch",
        "analytic bubble fraction derived from the schedule table "
        "disagrees with the compiled-schedule accounting "
        "(pp_bubble_fraction) — the schedule-as-data drifted from the "
        "code that runs",
        "none",
    ),
    "AL101": (
        "ast", "host-sync",
        ".item() / .tolist() / .cpu() / float(<call>) / np.asarray / "
        "torch.cuda.synchronize in step-path modules (each is a "
        "device->host sync on a CUDA tensor)",
        "# ddplint: allow[host-sync]",
    ),
    "AL102": (
        "ast", "time-in-jit",
        "time.*/np.random/random/datetime.now inside make_*_step inner "
        "functions (the reference's trace-time constant; in an eager "
        "step a host clock or RNG read that makes steps differ by rank)",
        "# ddplint: allow[time-in-jit]",
    ),
    "AL103": (
        "ast", "broad-except",
        "bare except / except (Base)Exception without justification "
        "(swallows KeyboardInterrupt or masks real faults)",
        "# ddplint: allow[broad-except]",
    ),
    "AL104": (
        "ast", "event-kind",
        "EventLog.emit(kind) string literal not registered in the "
        "port's observability.schema.EVENT_KINDS (schema drift: consumers "
        "reject or misparse the record)",
        "# ddplint: allow[event-kind]",
    ),
    "AL105": (
        "ast", "blocking-socket",
        "socket.create_connection / socket.socket call outside a "
        "retry_call wrapper (a transient connect race crashes instead "
        "of taking the RetryPolicy backoff)",
        "# ddplint: allow[blocking-socket]",
    ),
    "AL106": (
        "ast", "wallclock-in-virtual-path",
        "time.time()/time.monotonic() called in a VirtualClock-"
        "replayable module (forks virtual and real time; replays stop "
        "being deterministic) — pass the injected time_fn instead",
        "# ddplint: allow[wallclock]",
    ),
    "AL107": (
        "ast", "host-sync-in-serve-loop",
        ".item() / .tolist() / .cpu() / np.asarray inside a per-step "
        "serving-loop function (one device->host sync per decode step "
        "serializes the fleet)",
        "# ddplint: allow[serve-host-sync]",
    ),
    "AL108": (
        "ast", "lock-discipline",
        "attribute mutated under `with self.<lock>:` in one method but "
        "bare in another (outside __init__) — the lock either protects "
        "the attribute everywhere or protects nothing",
        "# ddplint: allow[lock-discipline]",
    ),
    "PL401": (
        "proto", "protocol-invariant",
        "a reachable state of a declared protocol spec violates one of "
        "its safety invariants (forked epoch history, dropped+completed "
        "request, double block injection, refcount leak); reported "
        "with the minimal counterexample trace",
        "none",
    ),
    "PL402": (
        "proto", "protocol-deadlock",
        "a reachable protocol state has no enabled transition while "
        "some entity is outside the declared quiescent states (a "
        "request/block/member stuck forever)",
        "none",
    ),
    "PL403": (
        "proto", "spec-unreachable-state",
        "a declared protocol state no interleaving reaches at the "
        "explored scope — the spec promises behavior the model cannot "
        "exhibit (spec drift or dead spec)",
        "none",
    ),
    "PL404": (
        "proto", "spec-dead-transition",
        "a declared protocol transition never enabled in any reachable "
        "state — dead spec entry or a guard that contradicts the rest "
        "of the machine",
        "none",
    ),
    "PL405": (
        "proto", "timeline-conformance",
        "a recorded event timeline disagrees with the protocol specs "
        "(duplicate epoch, affinity hit with a prefill engine, handoff "
        "attempts outside the NAK budget, routing to a dead engine) — "
        "the executed run drifted from the checked plan",
        "none",
    ),
    "PL406": (
        "proto", "spec-malformed",
        "the protocol spec itself is structurally broken: unknown "
        "initial/guard states, duplicate transition names, or a fired "
        "move whose entity did not make the declared source->target "
        "hop",
        "none",
    ),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation.  ``rule`` is the table id (GL001...); ``where``
    is a file:line for AST findings or a mode/step label for graph
    findings."""

    rule: str
    where: str
    message: str

    @property
    def name(self) -> str:
        entry = RULES.get(self.rule)
        return entry[1] if entry else "UNREGISTERED"

    def __str__(self) -> str:  # the CLI's one-line format
        return f"{self.where}: {self.rule} [{self.name}] {self.message}"


def format_findings(findings) -> str:
    return "\n".join(str(f) for f in findings)


def unregistered_rule_ids(findings) -> list[str]:
    """Rule ids carried by ``findings`` that are not in ``RULES`` — a
    checker emitting an id the registry doesn't know is an operational
    error (the CI ddplint stage hard-fails on it), not a lint finding."""
    return sorted({f.rule for f in findings} - set(RULES))


def rule_table() -> str:
    """The rule table as aligned text (CLI --list-rules; README source)."""
    rows = [("id", "layer", "name", "catches", "waiver")]
    for rid, (layer, name, what, waiver) in sorted(RULES.items()):
        rows.append((rid, layer, name, what, waiver))
    return "\n".join(
        f"{r[0]:<7} {r[1]:<6} {r[2]:<18} {r[3]}  [waiver: {r[4]}]"
        for r in rows[1:]
    )


#: every gradient-sized collective, unbounded: the manifest's entry for an
#: axis whose layout issues its own (TP, EP and CP inside a step)
ANY_COLLECTIVE = {p: (0, None) for p in ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
                                        "batch_isend_irecv", "all_to_all_single")}


def collective_manifest(
    mode: str,
    *,
    grad_reduce: dict,
    allow_f32_reduce: bool = False,
    per_leaf_axes: tuple = (),
) -> dict:
    """The expected-collective manifest a step factory attaches to its
    returned step (``step.collective_manifest``) — the contract the
    graph linter verifies the recorded step against.

    ``grad_reduce`` maps mesh axis name -> {collective: (min, max|None)}
    bounds on the number of *gradient-sized* collectives over that axis
    (``graph_lint.Collective.grad_sized``), by torch's names:
    ``all_reduce`` (a sum or mean), ``reduce_scatter_tensor``,
    ``all_gather_into_tensor``, ``all_to_all_single``,
    ``batch_isend_irecv``.  Scalar reductions (the metric pack, the
    nonfinite guard's MIN) are never counted.  Axes not listed at
    all must carry NO gradient-sized reduction — an unexpected axis is
    a double-sync bug, not forward-compat.

    ``per_leaf_axes``: axes where the count must EQUAL the number of
    parameter leaves (the unbucketed leaf-wise all_reduce layout) — this is
    what turns "synced twice" into a countable violation.

    ``allow_f32_reduce``: waives the GL004 wire check for modes whose
    reduction legitimately runs f32 (legacy coalesced buckets, ZeRO/
    FSDP f32 master flats).

    The reference's ``donate`` and ``custom_vjp_collectives_ok`` serve
    GL003 and SF204, which have no port meaning, so the port has neither.
    """
    return {
        "mode": mode,
        "grad_reduce": {
            str(ax): {str(p): tuple(b) for p, b in prims.items()}
            for ax, prims in grad_reduce.items()
        },
        "allow_f32_reduce": bool(allow_f32_reduce),
        "per_leaf_axes": tuple(str(a) for a in per_leaf_axes),
    }
