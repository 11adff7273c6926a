"""Schedule-as-data lint: the pipeline tick table as a checkable IR.

The port's copy of the JAX package's ``analysis/schedule_lint.py``.
``parallel/pipeline_parallel.py`` runs its schedule as host control flow
(GPipe's loops, 1F1B's warm-up/steady/cool-down, the interleaved and zb
tick loops) — correct, but opaque: nothing outside the factory can answer
"which unit runs at tick 17 on stage 2?", so schedule bugs surface as
wrong losses, not as lint findings.  This module gives schedules a
**declarative IR**: an explicit (tick, stage, chunk, microbatch, phase)
table plus the collective/ring metadata, attached by the factory as
``step.schedule_ir`` — data, not code.  The builders here re-derive the
tables from the published schedule definitions (GPipe: arXiv
1811.06965; 1F1B/interleaved: arXiv 2104.04473 §2.2-2.3) independently
of the factory's tick arithmetic, so the lint is a real cross-check,
not the same formula evaluated twice.

Checks (rule ids in ``analysis.rules``):

- **SL301 schedule-malformed** — the table is not a valid pipeline:
  a (stage, chunk, microbatch, phase) unit missing or duplicated, a
  tick outside ``[0, ticks)``, forward not strictly advancing down the
  stages, backward not strictly advancing up, or a unit's backward not
  after its forward.
- **SL302 schedule-collectives** — the schedule's communication doesn't
  match reality: the boundary-hop collective isn't declared on the hop
  axis in the factory's collective manifest, or the recorded count
  disagrees with the table.  The reference compares its jaxpr's hops
  with ``hops_per_tick x ticks`` (a scan's every tick exchanges); an
  eager stage sends only what its units produce, so with ``stage=`` the
  recorded sends of one stage are held to ``stage_sends(ir, stage)``,
  the sends the table gives that stage, exactly.  Grad-sync tables keep
  ``hops_per_tick x ticks`` (one reduction a bucket).
- **SL303 cross-stage-donation** — the saved-activation ring donates a
  slot another in-flight unit still reads: a second write lands at or
  before the pending read's tick, or the ring declares fewer slots than
  the schedule's peak in-flight units need.
- **SL304 bubble-mismatch** — the analytic bubble fraction derived from
  the IR table disagrees with the factory's own accounting
  (``pp_bubble_fraction``): the schedule-as-data drifted from the code
  that runs.

Module-import rule: stdlib only (same contract as ``rules.py``).
"""

from __future__ import annotations

import dataclasses

from distributeddataparallel_tpu_torch.analysis.rules import Finding

#: phase tags: forward, activation-grad backward, weight-grad backward
#: (zb's deferrable W unit), grad-sync
PHASES = ("F", "B", "W", "S")


@dataclasses.dataclass(frozen=True)
class ScheduleUnit:
    """One cell of the schedule table: at ``tick``, ``stage`` runs
    ``phase`` of (chunk, microbatch)."""

    tick: int
    stage: int
    chunk: int
    microbatch: int
    phase: str


@dataclasses.dataclass(frozen=True)
class ScheduleIR:
    """A schedule as data.  ``units`` is the full table; the rest is
    the communication/memory contract the lint verifies against the
    factory's manifest and traced step."""

    kind: str                     # "gpipe" | "1f1b" | "zb" | "grad-sync"
    n_stages: int
    n_microbatches: int
    virtual: int                  # chunks per stage (1 = non-interleaved)
    ticks: int
    hop_prim: str                 # collective of the boundary hop
    hop_axis: str                 # mesh axis the hop runs over
    hops_per_tick: int
    exact_hops: bool              # scan-compiled: traced == per-tick x T
    units: tuple[ScheduleUnit, ...]
    #: saved-activation ring: {"n_slots": int, "modulus": int} — slot of
    #: (c, m) is c*modulus + m % modulus, last slot is the off-schedule
    #: scratch.  None for schedules without a ring (GPipe saves via AD).
    ring: dict | None = None
    #: phase -> [start, end) tick window in which that phase's slot
    #: EXISTS in the compiled rendering.  None means every phase's slot
    #: exists every tick (the uniform-body scans).  Segmented schedules
    #: (zb) declare their windows so capacity/hop accounting prices
    #: only the slots that actually execute.
    slot_windows: dict | None = None
    #: total boundary hops of the whole schedule when it is NOT
    #: hops_per_tick x ticks (segmented bodies); overrides the product
    #: in SL302 when set.
    hops_total: int | None = None

    def bubble_fraction(self) -> float:
        """Idle fraction straight from the table: stage-slot cells with
        no unit over all stage-slot cells.  Capacity is phases x stages
        x T for uniform-body schedules (one slot per phase per stage
        per tick); with ``slot_windows`` each phase's slot only exists
        inside its window, so capacity is the window lengths summed."""
        if self.slot_windows:
            per_stage = sum(
                int(end) - int(start)
                for start, end in self.slot_windows.values()
            )
            capacity = self.n_stages * per_stage
        else:
            phases = len({u.phase for u in self.units}) or 1
            capacity = phases * self.n_stages * self.ticks
        return round((capacity - len(self.units)) / capacity, 4)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["units"] = [dataclasses.astuple(u) for u in self.units]
        out["bubble_fraction"] = self.bubble_fraction()
        return out


def gpipe_schedule_ir(
    n_stages: int,
    microbatches: int,
    *,
    hop_axis: str = "pipe",
) -> ScheduleIR:
    """GPipe forward table: stage ``s`` runs microbatch ``m`` at tick
    ``s + m``; the backward emerges from AD, so the table (like the
    factory's unrolled loop) is forward-only and hop counts are a lower
    bound (``exact_hops=False``)."""
    n, M = n_stages, microbatches
    units = tuple(
        ScheduleUnit(tick=s + m, stage=s, chunk=0, microbatch=m, phase="F")
        for s in range(n) for m in range(M)
    )
    return ScheduleIR(
        kind="gpipe", n_stages=n, n_microbatches=M, virtual=1,
        ticks=M + n - 1, hop_prim="batch_isend_irecv", hop_axis=hop_axis,
        hops_per_tick=1, exact_hops=False, units=units,
    )


def one_f_one_b_schedule_ir(
    n_stages: int,
    microbatches: int,
    virtual: int = 1,
    *,
    hop_axis: str = "pipe",
) -> ScheduleIR:
    """1F1B / interleaved-1F1B table, derived from the schedule
    DEFINITION: microbatches proceed in groups of ``n``, groups cycle
    chunk-major; stage ``s`` runs forward of unit ``j`` at tick
    ``j + s`` and backward of unit ``j`` (chunk order reversed) at tick
    ``j + (v*n - 1) + (n - 1 - s)``.  Deliberately NOT a call into
    ``pipeline_parallel._1f1b_ticks`` — SL304 exists to catch the two
    derivations disagreeing."""
    n, M, v = n_stages, microbatches, virtual
    units = []
    last_tick = 0
    # enumerate unit indices j group-by-group until every microbatch is
    # covered: group g holds microbatches g*n .. g*n + n-1, each chunk
    groups = (M + n - 1) // n
    for g in range(groups):
        for c in range(v):
            for off in range(n):
                m = g * n + off
                if m >= M:
                    continue
                j = g * (n * v) + c * n + off
                for s in range(n):
                    tf = j + s
                    tb = j + (v * n - 1) + (n - 1 - s)
                    units.append(ScheduleUnit(tf, s, c, m, "F"))
                    units.append(ScheduleUnit(tb, s, v - 1 - c, m, "B"))
                    last_tick = max(last_tick, tf, tb)
    return ScheduleIR(
        kind="1f1b", n_stages=n, n_microbatches=M, virtual=v,
        ticks=last_tick + 1, hop_prim="batch_isend_irecv", hop_axis=hop_axis,
        hops_per_tick=2, exact_hops=True, units=tuple(units),
        ring={"n_slots": v * 2 * n + 1, "modulus": 2 * n},
    )


def zb_schedule_ir(
    n_stages: int,
    microbatches: int,
    virtual: int = 1,
    *,
    hop_axis: str = "pipe",
) -> ScheduleIR:
    """Zero-bubble (ZB-H1-style W/B split) table, derived from the
    schedule DEFINITION: the F and B placements are exactly 1F1B's
    (forward of unit ``j`` on stage ``s`` at tick ``j + s``; backward
    at ``j + (v·n - 1) + (n - 1 - s)``, chunk order reversed) and the
    weight-grad unit W runs the SAME tick as its B (deferral depth 0 —
    deferring W in the segmented-scan rendering lengthens the scan
    without creating capacity).  What changes is the CAPACITY model:
    phase slots only exist inside their windows (warm-up ticks have no
    B/W slot, drain ticks no F slot), declared via ``slot_windows``
    derived here from the table's own tick extents — deliberately NOT
    a call into ``pipeline_parallel._zb_segments``; SL304 exists to
    catch the two derivations disagreeing.  Boundary hops follow the
    windows too (one F hop per F-window tick, one B hop per B-window
    tick, W never hops), so ``hops_total`` replaces the uniform
    hops_per_tick x ticks product in SL302.
    """
    n, M, v = n_stages, microbatches, virtual
    units = []
    groups = (M + n - 1) // n
    for g in range(groups):
        for c in range(v):
            for off in range(n):
                m = g * n + off
                if m >= M:
                    continue
                j = g * (n * v) + c * n + off
                for s in range(n):
                    tf = j + s
                    tb = j + (v * n - 1) + (n - 1 - s)
                    units.append(ScheduleUnit(tf, s, c, m, "F"))
                    units.append(ScheduleUnit(tb, s, v - 1 - c, m, "B"))
                    units.append(ScheduleUnit(tb, s, v - 1 - c, m, "W"))
    f_ticks = [u.tick for u in units if u.phase == "F"]
    b_ticks = [u.tick for u in units if u.phase == "B"]
    ticks = max(b_ticks) + 1
    windows = {
        "F": (0, max(f_ticks) + 1),
        "B": (min(b_ticks), ticks),
        "W": (min(b_ticks), ticks),
    }
    hops_total = (windows["F"][1] - windows["F"][0]) \
        + (windows["B"][1] - windows["B"][0])
    return ScheduleIR(
        kind="zb", n_stages=n, n_microbatches=M, virtual=v,
        ticks=ticks, hop_prim="batch_isend_irecv", hop_axis=hop_axis,
        hops_per_tick=2, exact_hops=True, units=tuple(units),
        ring={"n_slots": v * 2 * n + 1, "modulus": 2 * n},
        slot_windows=windows, hops_total=hops_total,
    )


def grad_sync_schedule_ir(
    n_buckets: int,
    *,
    axis: str = "data",
    prim: str = "all_reduce",
) -> ScheduleIR:
    """Bucketed gradient sync as a 1-stage schedule: tick ``i`` reduces
    bucket ``i`` (``microbatch`` doubles as the bucket index).  Gives
    the overlap engine's bucket order the same lintable shape the
    pipeline tables have."""
    units = tuple(
        ScheduleUnit(tick=i, stage=0, chunk=0, microbatch=i, phase="S")
        for i in range(n_buckets)
    )
    return ScheduleIR(
        kind="grad-sync", n_stages=1, n_microbatches=n_buckets, virtual=1,
        ticks=n_buckets, hop_prim=prim, hop_axis=axis, hops_per_tick=1,
        exact_hops=True, units=units,
    )


def _check_table(ir: ScheduleIR, where: str) -> list:
    """SL301: the table is a well-formed pipeline."""
    findings = []
    expect_phases = {
        "1f1b": ("F", "B"),
        "zb": ("F", "B", "W"),
        "gpipe": ("F",),
    }.get(ir.kind, ("S",))
    seen: dict[tuple, ScheduleUnit] = {}
    for u in ir.units:
        if not 0 <= u.tick < ir.ticks:
            findings.append(Finding(
                "SL301", where,
                f"unit {u} has tick outside [0, {ir.ticks})",
            ))
        key = (u.stage, u.chunk, u.microbatch, u.phase)
        if key in seen:
            findings.append(Finding(
                "SL301", where,
                f"duplicate unit (stage={u.stage}, chunk={u.chunk}, "
                f"mb={u.microbatch}, {u.phase}) at ticks "
                f"{seen[key].tick} and {u.tick}",
            ))
        seen[key] = u
    for s in range(ir.n_stages):
        for c in range(ir.virtual):
            for m in range(ir.n_microbatches):
                for ph in expect_phases:
                    if (s, c, m, ph) not in seen:
                        findings.append(Finding(
                            "SL301", where,
                            f"missing unit (stage={s}, chunk={c}, "
                            f"mb={m}, {ph})",
                        ))
    if findings:
        return findings   # ordering checks need a complete table
    for c in range(ir.virtual):
        for m in range(ir.n_microbatches):
            for s in range(ir.n_stages - 1):
                f0 = seen[(s, c, m, "F")] if (s, c, m, "F") in seen else None
                f1 = seen.get((s + 1, c, m, "F"))
                if f0 and f1 and not f1.tick > f0.tick:
                    findings.append(Finding(
                        "SL301", where,
                        f"forward of (chunk={c}, mb={m}) reaches stage "
                        f"{s + 1} at tick {f1.tick}, not after stage "
                        f"{s} (tick {f0.tick}) — activations would "
                        "arrive before they are produced",
                    ))
                b0 = seen.get((s, c, m, "B"))
                b1 = seen.get((s + 1, c, m, "B"))
                if b0 and b1 and not b0.tick > b1.tick:
                    findings.append(Finding(
                        "SL301", where,
                        f"backward of (chunk={c}, mb={m}) reaches stage "
                        f"{s} at tick {b0.tick}, not after stage "
                        f"{s + 1} (tick {b1.tick}) — cotangents flow "
                        "up the pipe",
                    ))
            for s in range(ir.n_stages):
                f = seen.get((s, c, m, "F"))
                b = seen.get((s, c, m, "B"))
                # same tick is legal: within a tick F runs before B
                # (the last stage starts a unit's backward the tick its
                # forward completes — that IS 1F1B)
                if f and b and b.tick < f.tick:
                    findings.append(Finding(
                        "SL301", where,
                        f"(stage={s}, chunk={c}, mb={m}): backward at "
                        f"tick {b.tick} before forward at {f.tick}",
                    ))
                w = seen.get((s, c, m, "W"))
                # W consumes B's cotangent seed: it may run the same
                # tick (F -> B -> W within a tick) but never earlier.
                if w and b and w.tick < b.tick:
                    findings.append(Finding(
                        "SL301", where,
                        f"(stage={s}, chunk={c}, mb={m}): weight-grad "
                        f"W at tick {w.tick} before its activation-grad "
                        f"B at {b.tick}",
                    ))
    if ir.slot_windows:
        for u in ir.units:
            win = ir.slot_windows.get(u.phase)
            if win and not win[0] <= u.tick < win[1]:
                findings.append(Finding(
                    "SL301", where,
                    f"unit {u} outside its declared {u.phase}-slot "
                    f"window [{win[0]}, {win[1]}) — the segmented "
                    "rendering has no slot to run it in",
                ))
    return findings


def _check_ring(ir: ScheduleIR, where: str) -> list:
    """SL303: saved-activation ring slot lifetimes.  Slot of (c, m) is
    written at the unit's F tick and read at its B tick (zb's W unit
    reads the same slot the same tick as its B, so the B-read lifetime
    covers it); a second write landing at or before a pending read
    clobbers a live buffer (F runs before B within a tick, so equality
    is a clobber too)."""
    if not ir.ring or ir.kind not in ("1f1b", "zb"):
        return []
    findings = []
    modulus = int(ir.ring["modulus"])
    n_slots = int(ir.ring["n_slots"])
    required = ir.virtual * modulus + 1   # all residues per chunk + scratch
    if n_slots < required:
        findings.append(Finding(
            "SL303", where,
            f"ring declares {n_slots} slots but the schedule needs "
            f"{required} (virtual x modulus + scratch) — a donated "
            "slot would still have live cross-stage readers",
        ))
    # per stage: lifetime intervals [F tick, B tick] per slot
    lifetimes: dict[tuple[int, int], list] = {}
    by_key = {
        (u.stage, u.chunk, u.microbatch, u.phase): u.tick
        for u in ir.units
    }
    for (s, c, m, ph), tick in by_key.items():
        if ph != "F":
            continue
        rb = by_key.get((s, c, m, "B"))
        if rb is None:
            continue
        slot = c * modulus + m % modulus
        lifetimes.setdefault((s, slot), []).append((tick, rb, c, m))
    for (s, slot), spans in lifetimes.items():
        spans.sort()
        for (w1, r1, c1, m1), (w2, _r2, c2, m2) in zip(spans, spans[1:]):
            if w2 <= r1:
                findings.append(Finding(
                    "SL303", where,
                    f"stage {s} slot {slot}: write of (chunk={c2}, "
                    f"mb={m2}) at tick {w2} clobbers (chunk={c1}, "
                    f"mb={m1}), still unread until tick {r1}",
                ))
    return findings


def stage_sends(ir: ScheduleIR, stage: int) -> int:
    """The boundary sends the table gives ``stage`` in one step: a forward
    unit's output goes downstream unless it leaves the last chunk on the
    last stage, a backward unit's cotangent upstream unless it is the
    first chunk's on stage 0 (zb's W units send nothing).  GPipe's table
    is forward-only: its backwards (one a forward, in reverse) send each
    microbatch's cotangent upstream from every stage but the first."""
    n, v = ir.n_stages, ir.virtual
    sends = 0
    for u in ir.units:
        if u.stage != stage:
            continue
        if u.phase == "F":
            sends += not (stage == n - 1 and u.chunk == v - 1)
            sends += ir.kind == "gpipe" and stage > 0
        elif u.phase == "B":
            sends += not (stage == 0 and u.chunk == 0)
    return sends


def lint_schedule(
    ir: ScheduleIR,
    *,
    manifest: dict | None = None,
    traced_hops: int | None = None,
    bubble: dict | float | None = None,
    where: str | None = None,
    stage: int | None = None,
) -> list:
    """Run SL301–SL304 over one schedule IR.

    ``traced_hops``: the recorded count of ``ir.hop_prim`` on
    ``ir.hop_axis`` in one run of the real step (with ``stage``: the
    point-to-point sends that stage posted, held to ``stage_sends``).
    ``bubble``: the factory's own accounting (``pp_bubble_fraction()``
    dict or a bare fraction) to cross-check against the table's.
    """
    where = where or f"sched:{ir.kind}"
    findings = _check_table(ir, where)
    findings += _check_ring(ir, where)

    # SL302: manifest must declare the hop; recorded count must match.
    if manifest is not None:
        bounds = manifest.get("grad_reduce", {}).get(ir.hop_axis, {})
        hop = bounds.get(ir.hop_prim)
        if hop is None or (hop[1] is not None and hop[1] < 1):
            findings.append(Finding(
                "SL302", where,
                f"schedule hops via {ir.hop_prim} on axis "
                f"'{ir.hop_axis}' but the factory manifest does not "
                "declare it there — the graph linter would flag the "
                "step the schedule requires",
            ))
    if traced_hops is not None and stage is not None:
        expected = stage_sends(ir, stage)
        if traced_hops != expected:
            findings.append(Finding(
                "SL302", where,
                f"stage {stage} posted {traced_hops} sends on axis "
                f"'{ir.hop_axis}' but the {ir.kind} table gives it "
                f"{expected} — the step does not run this schedule",
            ))
    elif traced_hops is not None:
        if ir.hops_total is not None:
            expected = ir.hops_total
            how = "window-derived total"
        else:
            expected = ir.hops_per_tick * ir.ticks
            how = f"{ir.hops_per_tick}/tick x {ir.ticks} ticks"
        bad = (traced_hops != expected) if ir.exact_hops \
            else (traced_hops < expected)
        if bad:
            rel = "==" if ir.exact_hops else ">="
            findings.append(Finding(
                "SL302", where,
                f"recorded {ir.hop_prim} count {traced_hops} on axis "
                f"'{ir.hop_axis}' violates schedule expectation "
                f"{rel} {expected} ({how}) — the step does not run "
                "this schedule",
            ))

    # SL304: table bubble vs the factory's accounting.
    if bubble is not None:
        declared = bubble.get("bubble_fraction") \
            if isinstance(bubble, dict) else float(bubble)
        if declared is not None:
            analytic = ir.bubble_fraction()
            if abs(analytic - float(declared)) > 5e-4:
                findings.append(Finding(
                    "SL304", where,
                    f"schedule-table bubble fraction {analytic} != "
                    f"factory accounting {declared} — the "
                    "schedule-as-data drifted from the code that runs",
                ))
    return findings
