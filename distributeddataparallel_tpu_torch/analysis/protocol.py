"""Protocol-as-data: declared state machines + a small-scope model checker.

The port's copy of the JAX package's ``analysis/protocol.py``.  The
graph/schedule layers check what a step issues; this layer checks the
hand-written distributed protocols around it — the code paths made of
sockets, epochs, and refcounts.  Following the schedule-as-data direction
(``schedule_lint.ScheduleIR``: the plan is data, the lint checks the
data, the runtime executes the same data), each protocol is promoted to
a :class:`ProtocolSpec`:

- a **declared entity state machine** — states, transitions with
  (source, target), quiescent rest states — which is pure data and is
  what ``--list-rules``/README document;
- an **executable small-scope model** — ``init``/``moves``/
  ``violations`` closures over a canonical hashable system state — which
  :func:`explore` drives through every reachable interleaving of 2–4
  actors with state-hash dedup and a bounded frontier.

Four specs ship (factories below), mirroring the live modules:

========== ======================= ===================================
spec        live module             invariants checked
========== ======================= ===================================
rendezvous  runtime/rendezvous.py   epoch-unique, tombstone-barrier,
                                    rehost-owner (smallest survivor)
router      serving/router.py       drop-vs-complete, affinity-tier,
                                    owner-alive (drain completeness)
handoff     serving/handoff.py      at-most-once inject, NAK attempt
                                    budget
allocator   serving/kv_cache.py     refcount conservation, CoW before
                                    shared write
========== ======================= ===================================

The checked plan IS the executed plan: the port's live modules import
their load-bearing constants/rules from here (``serving/handoff.py``:
``HANDOFF_MAX_ATTEMPTS``, ``VERDICT_RUNGS``/:func:`verdict_rung`;
``runtime/rendezvous.py``: :func:`elect_rehost_owner`), so
a spec edit that the checker explores is the same object the runtime
consults.

Explorer findings (ids registered in ``analysis.rules``):

- **PL401** protocol-invariant — a reachable state violates a declared
  safety invariant; reported with the minimal counterexample trace
  (breadth-first order makes the first hit minimal).
- **PL402** protocol-deadlock — a reachable state has no enabled move
  while some entity is outside the declared quiescent states.
- **PL403** spec-unreachable-state — a declared state no interleaving
  reaches: the spec promises behavior the model cannot exhibit.
- **PL404** spec-dead-transition — a declared transition no reachable
  state enables.
- **PL406** spec-malformed — structural breakage: unknown initial
  state, a transition naming an undeclared state, duplicate names, or
  a fired move whose entity did not make the declared source→target
  hop.

PL405 (timeline-conformance) is this spec set replayed against recorded
event timelines — see ``analysis.conformance``.

Module-import rule: stdlib only.  ``runtime/rendezvous.py`` (itself
stdlib-only) and ``serving/handoff.py`` import from here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from distributeddataparallel_tpu_torch.analysis.rules import Finding

# ---------------------------------------------------------------------------
# Shared protocol constants — the live modules import THESE, so the
# values the checker explores are the values the runtime executes.

#: Digest-mismatch redelivery budget per handoff before the sender gives
#: up (``serving.handoff.MAX_ATTEMPTS`` re-exports this).
HANDOFF_MAX_ATTEMPTS = 4

#: Degradation rungs an ``engine_verdict`` may record: ``drain`` while
#: the tier has live survivors (requests requeue), ``fail`` when it does
#: not (``serving.router.Router.mark_dead`` consults these).
VERDICT_RUNGS = ("drain", "fail")

#: The router's request lifecycle states, as declared data (the router
#: spec below and the conformance replay both key on these).
REQUEST_STATES = (
    "new", "prefill", "handoff", "decode", "done", "requeued", "failed",
)


def elect_rehost_owner(survivors) -> str:
    """The deterministic re-host/proposer election rule: the
    lexicographically smallest survivor.  ``rendezvous.elect_rehost``
    delegates here so the rule the model checker explores is the rule
    the gang executes."""
    names = sorted(str(s) for s in survivors)
    if not names:
        raise ValueError("no survivors to elect an owner from")
    return names[0]


def verdict_rung(tier_has_survivors: bool) -> str:
    """drain while the tier has live engines, fail when it does not."""
    return VERDICT_RUNGS[0] if tier_has_survivors else VERDICT_RUNGS[1]


# ---------------------------------------------------------------------------
# Spec model


@dataclasses.dataclass(frozen=True)
class Transition:
    """One declared transition of the entity state machine.  ``source``/
    ``target`` of ``None`` mark an environment/fault action (or a
    multi-entity effect) whose per-entity hop is not pinned — the
    explorer skips the source→target consistency check for those."""

    name: str
    source: str | None
    target: str | None


@dataclasses.dataclass(frozen=True)
class ProtocolSpec:
    """A protocol as data + executable small-scope semantics.

    The declarative half (``states``/``initial``/``quiescent``/
    ``transitions``/``invariants``) is what docs and ``--list-rules``
    show; the executable half is three pure functions over a canonical
    *hashable* system state:

    - ``init() -> sys``
    - ``moves(sys) -> tuple[(transition_name, entity|None, sys2), ...]``
    - ``violations(sys) -> tuple[(invariant_name, message), ...]``
    - ``entity_states(sys) -> dict[entity, state]`` projects the system
      state onto the declared per-entity machine.
    """

    name: str
    entity: str
    states: tuple[str, ...]
    initial: str
    quiescent: tuple[str, ...]
    transitions: tuple[Transition, ...]
    invariants: tuple[str, ...]
    init: Callable[[], Any]
    moves: Callable[[Any], tuple]
    violations: Callable[[Any], tuple]
    entity_states: Callable[[Any], dict]


def validate_spec(spec: ProtocolSpec) -> list[Finding]:
    """Structural PL406 checks — run before any exploration."""
    where = f"protocol:{spec.name}"
    out: list[Finding] = []
    states = set(spec.states)
    if len(states) != len(spec.states):
        out.append(Finding("PL406", where, "duplicate declared states"))
    if spec.initial not in states:
        out.append(Finding(
            "PL406", where,
            f"initial state {spec.initial!r} not in declared states",
        ))
    for q in spec.quiescent:
        if q not in states:
            out.append(Finding(
                "PL406", where,
                f"quiescent state {q!r} not in declared states",
            ))
    names = [t.name for t in spec.transitions]
    for dup in sorted({n for n in names if names.count(n) > 1}):
        out.append(Finding(
            "PL406", where, f"duplicate transition name {dup!r}",
        ))
    for t in spec.transitions:
        for end, label in ((t.source, "source"), (t.target, "target")):
            if end is not None and end not in states:
                out.append(Finding(
                    "PL406", where,
                    f"transition {t.name!r} {label} {end!r} not in "
                    "declared states",
                ))
    return out


@dataclasses.dataclass
class ExploreReport:
    """Result of one exhaustive small-scope exploration."""

    spec: str
    n_states: int
    n_moves: int
    complete: bool
    findings: list[Finding]

    @property
    def ok(self) -> bool:
        return not self.findings


def _trace(parent: dict, sys) -> str:
    """Minimal counterexample: the move sequence from init to ``sys``."""
    steps = []
    while parent[sys] is not None:
        sys, tname, ent = parent[sys]
        steps.append(f"{tname}({ent})" if ent is not None else tname)
    steps.reverse()
    if len(steps) > 24:
        steps = steps[:24] + [f"... (+{len(steps) - 24} more)"]
    return " -> ".join(["init", *steps])


def explore(
    spec: ProtocolSpec, *, max_states: int = 200_000
) -> ExploreReport:
    """Exhaustively explore every interleaving at the spec's scope.

    Breadth-first with state-hash dedup, so the state count is the
    number of distinct reachable system states (not paths) and the
    first counterexample found for each invariant is minimal.  The
    frontier is bounded by ``max_states``: past it the exploration
    reports ``complete=False`` and skips the reachability verdicts
    (PL403/PL404), which are only meaningful on a full exploration.
    """
    where = f"protocol:{spec.name}"
    findings = validate_spec(spec)
    if findings:
        return ExploreReport(spec.name, 0, 0, False, findings)

    by_name = {t.name: t for t in spec.transitions}
    init = spec.init()
    # sys -> None (init) or (parent_sys, transition, entity)
    parent: dict[Any, Any] = {init: None}
    frontier = [init]
    fired: set[str] = set()
    seen_states = set(spec.entity_states(init).values())
    reported: set[tuple[str, str]] = set()
    complete = True
    n_moves = 0

    def report(rule: str, key: str, msg: str) -> None:
        if (rule, key) not in reported:
            reported.add((rule, key))
            findings.append(Finding(rule, where, msg))

    while frontier:
        nxt = []
        for sys in frontier:
            bad = spec.violations(sys)
            if bad:
                for inv, msg in bad:
                    report(
                        "PL401", inv,
                        f"invariant {inv!r} violated: {msg} "
                        f"[trace: {_trace(parent, sys)}]",
                    )
                continue  # don't explore past a broken state
            moves = spec.moves(sys)
            if not moves:
                stuck = sorted(
                    str(e) for e, s in spec.entity_states(sys).items()
                    if s not in spec.quiescent
                )
                if stuck:
                    report(
                        "PL402", "deadlock",
                        f"deadlock: no enabled move but {spec.entity} "
                        f"{', '.join(stuck)} not quiescent "
                        f"[trace: {_trace(parent, sys)}]",
                    )
                continue
            before = spec.entity_states(sys)
            for tname, ent, sys2 in moves:
                n_moves += 1
                t = by_name.get(tname)
                if t is None:
                    report(
                        "PL406", f"move:{tname}",
                        f"model emitted undeclared transition {tname!r}",
                    )
                    continue
                if ent is not None and t.source is not None:
                    after = spec.entity_states(sys2)
                    if (before.get(ent) != t.source
                            or after.get(ent) != t.target):
                        report(
                            "PL406", f"hop:{tname}",
                            f"transition {tname!r} declared "
                            f"{t.source}->{t.target} but {ent!r} moved "
                            f"{before.get(ent)}->{after.get(ent)}",
                        )
                fired.add(tname)
                seen_states.update(spec.entity_states(sys2).values())
                if sys2 not in parent:
                    parent[sys2] = (sys, tname, ent)
                    nxt.append(sys2)
            if len(parent) > max_states:
                complete = False
                break
        if not complete:
            break
        frontier = nxt

    hit_safety = any(f.rule in ("PL401", "PL402") for f in findings)
    if complete and not hit_safety:
        for s in spec.states:
            if s not in seen_states:
                report(
                    "PL403", f"state:{s}",
                    f"declared state {s!r} unreachable at scope "
                    f"{len(spec.entity_states(init))} "
                    f"{spec.entity}(s) — dead spec or missing transition",
                )
        for t in spec.transitions:
            if t.name not in fired:
                report(
                    "PL404", f"dead:{t.name}",
                    f"declared transition {t.name!r} never enabled in "
                    f"{len(parent)} reachable states — dead transition",
                )
    return ExploreReport(spec.name, len(parent), n_moves, complete, findings)


# ---------------------------------------------------------------------------
# Spec 1: rendezvous membership epochs (runtime/rendezvous.py)


def rendezvous_spec(
    *,
    members: tuple[str, ...] = ("a", "b", "c"),
    max_faults: int = 1,
    fence: bool = True,
    elect: Callable[[list], str] | None = None,
    barrier_guard: bool = True,
) -> ProtocolSpec:
    """Membership epochs + barrier + store re-hosting.

    Entities are gang members on the suspect→tombstone hysteresis
    ladder.  Mutation knobs (for seeded-mutant tests): ``fence=False``
    lets a resurrected proposer replay an old epoch number
    (epoch-unique violation), ``elect`` overrides the smallest-survivor
    election (rehost-owner violation), ``barrier_guard=False`` lets a
    tombstoned member re-enter the barrier.
    """
    members = tuple(sorted(members))
    elect = elect or elect_rehost_owner

    # sys = (statuses, epoch, roster, barrier, owner, history)
    #   statuses: tuple[(name, "live"|"suspect"|"tombstoned"), ...]
    #   history:  committed epoch numbers, append-only
    def init():
        return (
            tuple((m, "live") for m in members),
            1, members, (), members[0], (1,),
        )

    def _status(statuses, m):
        return dict(statuses)[m]

    def _set(statuses, m, st):
        return tuple((n, st if n == m else s) for n, s in statuses)

    def _alive(statuses):
        return [n for n, s in statuses if s != "tombstoned"]

    def moves(sys):
        statuses, epoch, roster, barrier, owner, history = sys
        out = []
        dead = [n for n, s in statuses if s == "tombstoned"]
        for m, st in statuses:
            if st == "live":
                out.append((
                    "suspect", m,
                    (_set(statuses, m, "suspect"), epoch, roster,
                     barrier, owner, history),
                ))
            elif st == "suspect":
                out.append((
                    "beat", m,
                    (_set(statuses, m, "live"), epoch, roster,
                     barrier, owner, history),
                ))
                if len(dead) < max_faults:
                    out.append((
                        "tombstone", m,
                        (_set(statuses, m, "tombstoned"), epoch, roster,
                         tuple(b for b in barrier if b != m),
                         owner, history),
                    ))
        # barrier arrival for the current epoch
        for m in roster:
            st = _status(statuses, m)
            ok = st != "tombstoned" if barrier_guard else True
            if ok and m not in barrier:
                out.append((
                    "enter_barrier", m,
                    (statuses, epoch, roster,
                     tuple(sorted((*barrier, m))), owner, history),
                ))
        if barrier and set(barrier) == set(roster):
            out.append((
                "barrier_release", None,
                (statuses, epoch, roster, (), owner, history),
            ))
        # the smallest live survivor proposes the shrunk roster
        survivors = _alive(statuses)
        if survivors:
            proposer = elect(survivors)
            nxt_roster = tuple(sorted(survivors))
            if (nxt_roster != roster
                    and _status(statuses, proposer) == "live"):
                out.append((
                    "propose", None,
                    (statuses, epoch + 1, nxt_roster, (), owner,
                     (*history, epoch + 1)),
                ))
        # a resurrected proposer replays an already-committed epoch:
        # the version fence turns it into a no-op; without the fence it
        # forks membership history (duplicate committed epoch number)
        if len(history) >= 2:
            stale = (
                sys if fence else
                (statuses, epoch, roster, barrier, owner,
                 (*history, history[0]))
            )
            out.append(("stale_propose", None, stale))
        # store re-host when the owner is tombstoned
        if _status(statuses, owner) == "tombstoned" and survivors:
            out.append((
                "rehost", None,
                (statuses, epoch, roster, barrier,
                 elect(survivors), history),
            ))
        return tuple(out)

    def violations(sys):
        statuses, _epoch, _roster, barrier, owner, history = sys
        out = []
        if len(set(history)) != len(history):
            out.append((
                "epoch-unique",
                f"two committed epochs share a number: {history}",
            ))
        dead_in_barrier = [
            m for m in barrier if _status(statuses, m) == "tombstoned"
        ]
        if dead_in_barrier:
            out.append((
                "tombstone-barrier",
                f"tombstoned member(s) {dead_in_barrier} inside the "
                "barrier",
            ))
        survivors = _alive(statuses)
        if (survivors and _status(statuses, owner) != "tombstoned"
                and owner != elect_rehost_owner(survivors)):
            out.append((
                "rehost-owner",
                f"store owner {owner!r} is not the smallest survivor "
                f"{elect_rehost_owner(survivors)!r}",
            ))
        return tuple(out)

    def entity_states(sys):
        return dict(sys[0])

    return ProtocolSpec(
        name="rendezvous",
        entity="member",
        states=("live", "suspect", "tombstoned"),
        initial="live",
        quiescent=("live", "tombstoned"),
        transitions=(
            Transition("suspect", "live", "suspect"),
            Transition("beat", "suspect", "live"),
            Transition("tombstone", "suspect", "tombstoned"),
            Transition("enter_barrier", None, None),
            Transition("barrier_release", None, None),
            Transition("propose", None, None),
            Transition("stale_propose", None, None),
            Transition("rehost", None, None),
        ),
        invariants=("epoch-unique", "tombstone-barrier", "rehost-owner"),
        init=init,
        moves=moves,
        violations=violations,
        entity_states=entity_states,
    )


# ---------------------------------------------------------------------------
# Spec 2: router request lifecycle (serving/router.py)


def router_spec(
    *,
    n_requests: int = 2,
    prefill: tuple[str, ...] = ("p0",),
    decode: tuple[str, ...] = ("d0", "d1"),
    max_engine_deaths: int = 2,
    affinity_uses_prefill: bool = False,
    complete_purges: bool = True,
) -> ProtocolSpec:
    """admit→prefill→handoff→decode→complete | drain | fail, with
    session affinity and engine-death drain-and-requeue.

    All requests share one session key, so a completed request pins the
    session and a later request may take the affinity fast path.
    Mutation knobs: ``affinity_uses_prefill=True`` routes affinity hits
    through the prefill tier (affinity-tier violation);
    ``complete_purges=False`` leaves completed requests in the engine's
    outstanding table, so a later death drains an already-completed
    request (drop-vs-complete violation).
    """
    reqs = tuple(f"r{i}" for i in range(n_requests))
    tiers = {e: "prefill" for e in prefill}
    tiers.update({e: "decode" for e in decode})

    # per-request record: (state, owner|None, home|None, affinity, done)
    # sys = (records, engines_alive, affinity_home|None, deaths)
    def init():
        return (
            tuple(("new", None, None, False, False) for _ in reqs),
            tuple((e, True) for e in sorted(tiers)),
            None, 0,
        )

    def _alive_tier(engines, tier):
        return [e for e, up in engines if up and tiers[e] == tier]

    def _upd(records, i, rec):
        return tuple(rec if j == i else r for j, r in enumerate(records))

    def moves(sys):
        records, engines, home, deaths = sys
        alive = dict(engines)
        live_p = _alive_tier(engines, "prefill")
        live_d = _alive_tier(engines, "decode")
        out = []
        for i, (st, owner, dhome, aff, done) in enumerate(records):
            r = reqs[i]
            if st in ("new", "requeued"):
                tname = "admit" if st == "new" else "readmit"
                if home is not None and alive.get(home):
                    # affinity hit: the pinned decode engine serves the
                    # whole request from its prefix cache — no prefill
                    owner2 = (
                        min(live_p) if affinity_uses_prefill and live_p
                        else home
                    )
                    out.append((
                        tname + "_affinity", r,
                        (_upd(records, i,
                              ("decode", owner2, home, True, done)),
                         engines, home, deaths),
                    ))
                elif live_p and live_d:
                    out.append((
                        tname, r,
                        (_upd(records, i,
                              ("prefill", min(live_p), min(live_d),
                               False, done)),
                         engines, home, deaths),
                    ))
                elif live_d:
                    # prefill tier empty: route() returns prefill=None
                    # and the decode engine serves the whole request
                    out.append((
                        tname + "_direct", r,
                        (_upd(records, i,
                              ("decode", min(live_d), min(live_d),
                               False, done)),
                         engines, home, deaths),
                    ))
                elif st == "requeued" and not live_d:
                    out.append((
                        "req_fail", r,
                        (_upd(records, i,
                              ("failed", None, None, aff, done)),
                         engines, home, deaths),
                    ))
            elif st == "prefill" and alive.get(dhome):
                out.append((
                    "prefill_done", r,
                    (_upd(records, i,
                          ("handoff", owner, dhome, aff, done)),
                     engines, home, deaths),
                ))
            elif st == "handoff" and alive.get(dhome):
                out.append((
                    "handoff_done", r,
                    (_upd(records, i,
                          ("decode", dhome, dhome, aff, done)),
                     engines, home, deaths),
                ))
            elif st == "decode":
                owner2 = None if complete_purges else owner
                out.append((
                    "complete", r,
                    (_upd(records, i,
                          ("done", owner2, dhome, aff, True)),
                     engines, dhome, deaths),
                ))
        if deaths < max_engine_deaths:
            for e, up in engines:
                if not up:
                    continue
                engines2 = tuple(
                    (n, up2 and n != e) for n, up2 in engines
                )
                records2 = list(records)
                for i, (st, owner, dhome, aff, done) in enumerate(records):
                    hit = owner == e or (
                        st in ("prefill", "handoff", "decode")
                        and dhome == e
                    )
                    if hit and st in ("prefill", "handoff", "decode",
                                      "done"):
                        if st == "done":
                            # only reachable with complete_purges=False:
                            # a completed request drained again
                            records2[i] = ("requeued", None, None, aff,
                                           done)
                        else:
                            records2[i] = ("requeued", None, None, aff,
                                           done)
                home2 = None if home == e else home
                out.append((
                    "engine_die", None,
                    (tuple(records2), engines2, home2, deaths + 1),
                ))
        return tuple(out)

    def violations(sys):
        records, engines, _home, _deaths = sys
        alive = dict(engines)
        out = []
        for i, (st, owner, _dhome, aff, done) in enumerate(records):
            r = reqs[i]
            if done and st in ("requeued", "failed"):
                out.append((
                    "drop-vs-complete",
                    f"request {r} completed AND {st} — a finished "
                    "request re-entered the drain path",
                ))
            if aff and owner is not None and tiers.get(owner) == "prefill":
                out.append((
                    "affinity-tier",
                    f"affinity-hit request {r} owned by prefill-tier "
                    f"engine {owner!r}",
                ))
            if (owner is not None and st in ("prefill", "handoff",
                                             "decode")
                    and not alive.get(owner)):
                out.append((
                    "owner-alive",
                    f"request {r} still owned by dead engine {owner!r} "
                    "(drain missed it)",
                ))
        return tuple(out)

    def entity_states(sys):
        return {reqs[i]: rec[0] for i, rec in enumerate(sys[0])}

    return ProtocolSpec(
        name="router",
        entity="request",
        states=REQUEST_STATES,
        initial="new",
        quiescent=("new", "done", "failed"),
        transitions=(
            Transition("admit", "new", "prefill"),
            Transition("admit_affinity", "new", "decode"),
            Transition("admit_direct", "new", "decode"),
            Transition("prefill_done", "prefill", "handoff"),
            Transition("handoff_done", "handoff", "decode"),
            Transition("complete", "decode", "done"),
            Transition("readmit", "requeued", "prefill"),
            Transition("readmit_affinity", "requeued", "decode"),
            Transition("readmit_direct", "requeued", "decode"),
            Transition("req_fail", "requeued", "failed"),
            Transition("engine_die", None, None),
        ),
        invariants=("drop-vs-complete", "affinity-tier", "owner-alive"),
        init=init,
        moves=moves,
        violations=violations,
        entity_states=entity_states,
    )


# ---------------------------------------------------------------------------
# Spec 3: handoff NAK protocol (serving/handoff.py)


def handoff_spec(
    *,
    n_blocks: int = 2,
    max_attempts: int = HANDOFF_MAX_ATTEMPTS,
    dedup: bool = True,
    escalate: bool = True,
) -> ProtocolSpec:
    """NAK-based KV-block shipping: every corrupt frame is either
    re-shipped (attempts budget permitting) or escalated to
    ``HandoffError``; a delivered block is injected at most once.

    Mutation knobs: ``dedup=False`` lets a redelivered frame inject a
    second time (at-most-once violation); ``escalate=False`` removes
    the budget-exhausted escape hatch (deadlock: a corrupt block with
    no attempts left has no enabled move).
    """
    blocks = tuple(f"b{i}" for i in range(n_blocks))

    # per-block: (state, attempts, inject_count)
    def init():
        return tuple(("unsent", 0, 0) for _ in blocks)

    def _upd(sys, i, rec):
        return tuple(rec if j == i else r for j, r in enumerate(sys))

    def moves(sys):
        out = []
        for i, (st, att, inj) in enumerate(sys):
            b = blocks[i]
            if st == "unsent":
                out.append(("send", b, _upd(sys, i, ("inflight", 1, inj))))
            elif st == "inflight":
                out.append((
                    "deliver", b, _upd(sys, i, ("delivered", att, inj)),
                ))
                out.append((
                    "corrupt", b, _upd(sys, i, ("corrupt", att, inj)),
                ))
            elif st == "corrupt":
                if att < max_attempts:
                    out.append((
                        "resend", b,
                        _upd(sys, i, ("inflight", att + 1, inj)),
                    ))
                elif escalate:
                    out.append((
                        "escalate", b,
                        _upd(sys, i, ("failed", att, inj)),
                    ))
            elif st == "delivered":
                out.append((
                    "inject", b, _upd(sys, i, ("injected", att, inj + 1)),
                ))
            elif st == "injected" and not dedup and inj < 2:
                # a spurious retransmit re-injecting the same block —
                # only enabled when the receiver-side dedup is mutated
                # away (entity stays "injected"; inject is declared as
                # an environment hop exactly so this mutant trips the
                # invariant, not the hop check)
                out.append((
                    "inject", b, _upd(sys, i, ("injected", att, inj + 1)),
                ))
        return tuple(out)

    def violations(sys):
        out = []
        for i, (_st, att, inj) in enumerate(sys):
            if inj > 1:
                out.append((
                    "at-most-once",
                    f"block {blocks[i]} injected {inj} times",
                ))
            if att > max_attempts:
                out.append((
                    "attempt-budget",
                    f"block {blocks[i]} shipped {att} times "
                    f"(budget {max_attempts})",
                ))
        return tuple(out)

    def entity_states(sys):
        return {blocks[i]: rec[0] for i, rec in enumerate(sys)}

    return ProtocolSpec(
        name="handoff",
        entity="block",
        states=("unsent", "inflight", "delivered", "corrupt",
                "injected", "failed"),
        initial="unsent",
        quiescent=("injected", "failed"),
        transitions=(
            Transition("send", "unsent", "inflight"),
            Transition("deliver", "inflight", "delivered"),
            Transition("corrupt", "inflight", "corrupt"),
            Transition("resend", "corrupt", "inflight"),
            Transition("escalate", "corrupt", "failed"),
            # receiver-side action: at-most-once is an invariant, not a
            # state hop (see the dedup mutant above)
            Transition("inject", None, None),
        ),
        invariants=("at-most-once", "attempt-budget"),
        init=init,
        moves=moves,
        violations=violations,
        entity_states=entity_states,
    )


# ---------------------------------------------------------------------------
# Spec 4: allocator block lifecycle (serving/kv_cache.py)


def allocator_spec(
    *,
    n_blocks: int = 3,
    max_ref: int = 2,
    cow: bool = True,
    conserve: bool = True,
) -> ProtocolSpec:
    """KV block pool lifecycle: refcount conservation (every block is
    exactly one of free / live(ref>=1) / cached(ref==0)) and
    copy-on-write before any write to a shared block.

    Mutation knobs: ``cow=False`` enables a direct write to a shared
    (ref>=2) block; ``conserve=False`` makes release leak — the ref
    drops to zero but the block never returns to free/cached.
    """
    blocks = tuple(f"b{i}" for i in range(n_blocks))

    # per-block: (status, ref); plus a latch recording a shared write
    # sys = (records, bad_write)
    def init():
        return (tuple(("free", 0) for _ in blocks), False)

    def _upd(records, i, rec):
        return tuple(rec if j == i else r for j, r in enumerate(records))

    def moves(sys):
        records, bad = sys
        out = []
        free_idx = [i for i, (st, _) in enumerate(records) if st == "free"]
        for i, (st, ref) in enumerate(records):
            b = blocks[i]
            if st == "free":
                out.append((
                    "alloc", b, (_upd(records, i, ("live", 1)), bad),
                ))
            elif st == "live":
                if ref < max_ref:
                    out.append((
                        "retain", b,
                        (_upd(records, i, ("live", ref + 1)), bad),
                    ))
                if ref == 1:
                    out.append((
                        "write", b, (records, bad),  # in-place, exclusive
                    ))
                    if conserve:
                        out.append((
                            "release", b,
                            (_upd(records, i, ("cached", 0)), bad),
                        ))
                    else:
                        out.append((
                            "release", b,
                            (_upd(records, i, ("live", 0)), bad),
                        ))
                else:
                    if not cow:
                        out.append((
                            "write", b, (records, True),  # shared write!
                        ))
                    if free_idx:
                        j = free_idx[0]
                        recs = _upd(records, i, ("live", ref - 1))
                        recs = _upd(recs, j, ("live", 1))
                        out.append(("cow", b, (recs, bad)))
                    out.append((
                        "release_shared", b,
                        (_upd(records, i, ("live", ref - 1)), bad),
                    ))
            elif st == "cached":
                out.append((
                    "reuse", b, (_upd(records, i, ("live", 1)), bad),
                ))
                out.append((
                    "evict", b, (_upd(records, i, ("free", 0)), bad),
                ))
        return tuple(out)

    def violations(sys):
        records, bad = sys
        out = []
        for i, (st, ref) in enumerate(records):
            if (st == "live") != (ref > 0):
                out.append((
                    "refcount-conservation",
                    f"block {blocks[i]} is {st} with ref={ref} — the "
                    "free + live + cached partition leaked",
                ))
        if bad:
            out.append((
                "cow-before-write",
                "a shared (ref>=2) block was written in place without "
                "copy-on-write",
            ))
        return tuple(out)

    def entity_states(sys):
        return {blocks[i]: rec[0] for i, rec in enumerate(sys[0])}

    return ProtocolSpec(
        name="allocator",
        entity="block",
        states=("free", "live", "cached"),
        initial="free",
        quiescent=("free", "cached", "live"),
        transitions=(
            Transition("alloc", "free", "live"),
            Transition("retain", "live", "live"),
            Transition("write", "live", "live"),
            Transition("cow", "live", "live"),
            Transition("release", "live", "cached"),
            Transition("release_shared", "live", "live"),
            Transition("reuse", "cached", "live"),
            Transition("evict", "cached", "free"),
        ),
        invariants=("refcount-conservation", "cow-before-write"),
        init=init,
        moves=moves,
        violations=violations,
        entity_states=entity_states,
    )


def default_specs() -> tuple[ProtocolSpec, ...]:
    """The shipped protocol suite, at the scope CI explores (2–4 actors,
    at least one fault each)."""
    return (
        rendezvous_spec(),
        router_spec(),
        handoff_spec(),
        allocator_spec(),
    )


def explore_all(
    specs: tuple[ProtocolSpec, ...] | None = None,
) -> list[ExploreReport]:
    return [explore(s) for s in (specs or default_specs())]
