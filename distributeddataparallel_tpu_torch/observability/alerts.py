"""In-loop SLO alerting, evaluated only at throughput-window boundaries.

The event log and the report make a finished run legible; nothing else
watches a run while it trains.  ``AlertEngine`` does, without touching
the hot path: the trainer feeds it ONE ``observe()`` call per throughput
window — the same boundary where StepTimer already drained and the MFU
meter and memory sampler already run — so alerting adds zero per-step
work and zero extra host syncs by construction.  Every signal it sees is
a host float the boundary already computed; the engine never reads a
device value.

Rules are declarative: each is a small stateful object with thresholds
as constructor parameters, evaluated against the boundary's signal dict.
Firing follows a rising-edge + hysteresis discipline — a rule fires ONCE
when its condition becomes true, stays silent while the condition
persists, and re-arms only after its (stricter) clear condition holds —
so a sustained regression is one alert, not one per window.

A firing rule emits an ``alert`` event into the per-worker event log
(where ``scripts/ddp_monitor.py`` tails it live and ``ddp_report`` /
``ddp_trace`` surface it post-hoc), bumps ``alerts_total`` /
``alerts_<rule>`` registry counters, and is remembered in
``engine.fired`` for exit-status decisions.

Module-import rule: stdlib only (see schema.py) — the monitor and tests
run this in jax-free interpreters.
"""

from __future__ import annotations

import statistics


class AlertRule:
    """One SLO rule: ``evaluate(signals)`` returns ``None`` when its
    input signal is absent this window, else ``(fire, clear, payload)``
    — the raw conditions; edge/hysteresis logic lives in the engine."""

    #: spec key under which parse_alert_spec configures this rule
    name = "rule"

    def evaluate(self, signals: dict) -> tuple[bool, bool, dict] | None:
        raise NotImplementedError


class StepTimeSpike(AlertRule):
    """Window step time > ``factor`` x the rolling median of previous
    windows.  The spike window itself still enters the history, so a
    sustained regime change (bigger batch, slower interconnect) becomes
    the new normal instead of alerting forever."""

    name = "step_spike"

    def __init__(self, factor: float = 2.0, clear_factor: float = 1.5,
                 min_history: int = 3, history: int = 20):
        if factor <= 1.0:
            raise ValueError(f"step_spike factor must be > 1, got {factor}")
        self.factor = factor
        self.clear_factor = min(clear_factor, factor)
        self.min_history = max(min_history, 2)
        self.max_history = history
        self._window_s: list[float] = []

    def evaluate(self, signals):
        step_s = signals.get("step_s")
        if step_s is None:
            return None
        history = list(self._window_s)
        self._window_s.append(float(step_s))
        del self._window_s[:-self.max_history]
        if len(history) < self.min_history:
            return None
        median = statistics.median(history)
        threshold = self.factor * median
        return (
            step_s > threshold,
            step_s < self.clear_factor * median,
            {
                "value": round(step_s, 6),
                "threshold": round(threshold, 6),
                "median_s": round(median, 6),
            },
        )


class MfuFloor(AlertRule):
    """MFU below an absolute floor.  The default floor (5%) is a
    pathology detector, not a target — tune per model with
    ``--alerts mfu_floor=0.3``.  The first window is skipped: it can
    straddle residual warm-up even with the compile step split out."""

    name = "mfu_floor"

    def __init__(self, floor: float = 0.05, skip_windows: int = 1):
        if not 0.0 < floor < 1.0:
            raise ValueError(f"mfu_floor must be in (0, 1), got {floor}")
        self.floor = floor
        self.skip_windows = skip_windows
        self._seen = 0

    def evaluate(self, signals):
        mfu = signals.get("mfu")
        if mfu is None:
            return None
        self._seen += 1
        if self._seen <= self.skip_windows:
            return None
        return (
            mfu < self.floor,
            mfu >= 1.1 * self.floor,
            {"value": round(mfu, 6), "threshold": self.floor},
        )


class GoodputFloor(AlertRule):
    """Cumulative goodput fraction below ``floor`` once the run is old
    enough for the fraction to mean something (``min_elapsed_s``) — the
    'this run spends its life restarting/checkpointing' alarm."""

    name = "goodput_floor"

    def __init__(self, floor: float = 0.5, min_elapsed_s: float = 60.0):
        if not 0.0 < floor < 1.0:
            raise ValueError(f"goodput_floor must be in (0, 1), got {floor}")
        self.floor = floor
        self.min_elapsed_s = min_elapsed_s

    def evaluate(self, signals):
        goodput = signals.get("goodput")
        elapsed = signals.get("elapsed_s")
        if goodput is None or elapsed is None or elapsed < self.min_elapsed_s:
            return None
        return (
            goodput < self.floor,
            goodput >= min(1.1 * self.floor, 1.0),
            {"value": round(goodput, 4), "threshold": self.floor},
        )


class RestartStorm(AlertRule):
    """This incarnation's restart count reached ``max_restarts`` — the
    gang is cycling through respawns faster than it makes progress.
    Restart count is monotone, so the alert can only fire once."""

    name = "restart_storm"

    def __init__(self, max_restarts: int = 3):
        if max_restarts < 1:
            raise ValueError(
                f"restart_storm threshold must be >= 1, got {max_restarts}"
            )
        self.max_restarts = max_restarts

    def evaluate(self, signals):
        restarts = signals.get("restarts")
        if restarts is None:
            return None
        return (
            restarts >= self.max_restarts,
            False,  # monotone: never clears, never re-fires
            {"value": int(restarts), "threshold": self.max_restarts},
        )


class SdcStorm(AlertRule):
    """Silent-data-corruption detections (``training.integrity``)
    reached ``max_detects`` — one flip is a cosmic ray, a stream of them
    is failing hardware that eviction alone will not outrun (or a
    misconfigured digest domain flagging legitimate divergence).
    Detection count is monotone, so the alert fires at most once."""

    name = "sdc_storm"

    def __init__(self, max_detects: int = 2):
        if max_detects < 1:
            raise ValueError(
                f"sdc_storm threshold must be >= 1, got {max_detects}"
            )
        self.max_detects = max_detects

    def evaluate(self, signals):
        detects = signals.get("sdc_detects")
        if detects is None:
            return None
        return (
            detects >= self.max_detects,
            False,  # monotone: never clears, never re-fires
            {"value": int(detects), "threshold": self.max_detects},
        )


class GangSuspect(AlertRule):
    """At least ``max_suspects`` gang members are in the heartbeat-
    hysteresis window (slow-but-alive — flagged by the rendezvous store
    before the timeout tombstones them).  This is the straggler alarm
    the multi-host hardening layer promises: loud while the host is
    merely slow, so an operator can act before membership changes.
    Clears when the suspect set empties (the beat refreshed or the
    member was shed)."""

    name = "gang_suspect"

    def __init__(self, max_suspects: int = 1):
        if max_suspects < 1:
            raise ValueError(
                f"gang_suspect threshold must be >= 1, got {max_suspects}"
            )
        self.max_suspects = max_suspects

    def evaluate(self, signals):
        n = signals.get("gang_suspects")
        if n is None:
            return None
        return (
            n >= self.max_suspects,
            n == 0,
            {"value": int(n), "threshold": self.max_suspects},
        )


class LoaderStarvation(AlertRule):
    """Prefetch queue empty at ``windows`` consecutive boundaries: the
    input pipeline is gating the step loop (the live counterpart of the
    loader's own ``loader_starved`` event, which needs a 50-step empty
    streak; this sees the sustained-but-intermittent case too)."""

    name = "loader_starved"

    def __init__(self, windows: int = 3):
        if windows < 1:
            raise ValueError(
                f"loader_starved windows must be >= 1, got {windows}"
            )
        self.windows = windows
        self._empty_streak = 0

    def evaluate(self, signals):
        depth = signals.get("prefetch_depth")
        if depth is None:
            return None
        self._empty_streak = self._empty_streak + 1 if depth == 0 else 0
        return (
            self._empty_streak >= self.windows,
            depth > 0,
            {"value": self._empty_streak, "threshold": self.windows},
        )


class MemoryGrowth(AlertRule):
    """Live-array high-water mark still climbing after the run settled:
    HWM at this boundary exceeds the post-settle baseline by more than
    ``frac`` — the leak signal (params/opt state are steady-state after
    the first windows; what grows afterwards is retained garbage).
    Monotone vs a fixed baseline, so it fires at most once."""

    name = "mem_growth"

    def __init__(self, frac: float = 0.10, settle_windows: int = 2):
        if frac <= 0:
            raise ValueError(f"mem_growth frac must be > 0, got {frac}")
        self.frac = frac
        self.settle_windows = settle_windows
        self._seen = 0
        self._baseline: float | None = None

    def evaluate(self, signals):
        hwm = signals.get("live_hwm_bytes")
        if hwm is None:
            return None
        self._seen += 1
        if self._seen < self.settle_windows:
            return None
        if self._baseline is None:
            self._baseline = float(hwm)
            return None
        threshold = self._baseline * (1.0 + self.frac)
        return (
            hwm > threshold,
            False,  # HWM is monotone: no clear, no re-fire
            {
                "value": int(hwm),
                "threshold": int(threshold),
                "baseline_bytes": int(self._baseline),
            },
        )


#: rule name -> class, in evaluation order (also the --alerts spec keys)
RULE_CLASSES = {
    cls.name: cls
    for cls in (StepTimeSpike, MfuFloor, GoodputFloor, RestartStorm,
                SdcStorm, GangSuspect, LoaderStarvation, MemoryGrowth)
}


def default_rules() -> list[AlertRule]:
    return [cls() for cls in RULE_CLASSES.values()]


def parse_alert_spec(spec: str | None) -> list[AlertRule]:
    """``--alerts`` spec -> rule list.  Empty/None spec = every rule at
    defaults; ``"mfu_floor=0.3,step_spike=2.5"`` overrides the named
    rules' primary threshold (each rule's first constructor arg) and
    keeps the rest at defaults.  Unknown names raise ValueError at parse
    time, the same contract --chaos follows."""
    overrides: dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        if name not in RULE_CLASSES:
            raise ValueError(
                f"unknown alert rule {name!r}; one of "
                f"{', '.join(RULE_CLASSES)}"
            )
        if not sep:
            raise ValueError(
                f"alert rule {name!r} needs a threshold: {name}=VALUE"
            )
        try:
            overrides[name] = float(value)
        except ValueError:
            raise ValueError(
                f"alert rule {name!r}: threshold {value!r} is not a number"
            ) from None
    rules = []
    for name, cls in RULE_CLASSES.items():
        if name in overrides:
            v = overrides[name]
            rules.append(
                cls(
                    int(v)
                    if name in ("restart_storm", "sdc_storm", "gang_suspect")
                    else v
                )
            )
        else:
            rules.append(cls())
    return rules


class AlertEngine:
    """Evaluates the rule set against each window boundary's signals.

    ``observe`` is the only entry point and the caller contract is the
    StepTimer rule: call it where the loop already drained, never per
    step.  All inputs are host numbers the boundary already holds.
    """

    def __init__(self, rules: list[AlertRule] | None = None, *,
                 events=None, registry=None, on_fire=None):
        self.rules = rules if rules is not None else default_rules()
        self.events = events
        self.registry = registry
        self.on_fire = on_fire
        #: every alert this engine ever raised, in firing order
        self.fired: list[dict] = []
        self._active: dict[str, bool] = {}

    @property
    def firing(self) -> list[str]:
        """Names of rules currently in the fired-not-cleared state."""
        return [name for name, on in self._active.items() if on]

    def observe(self, *, step: int, **signals) -> list[dict]:
        """One boundary evaluation; returns the alerts that fired NOW
        (rising edges only).  Pure host arithmetic."""
        fired_now = []
        for rule in self.rules:
            result = rule.evaluate(signals)
            if result is None:
                continue
            fire, clear, payload = result
            if self._active.get(rule.name):
                if clear:
                    self._active[rule.name] = False
                continue
            if not fire:
                continue
            self._active[rule.name] = True
            alert = {"rule": rule.name, "step": step, **payload}
            self.fired.append(alert)
            fired_now.append(alert)
            if self.registry is not None:
                self.registry.counter("alerts_total").inc()
                self.registry.counter(f"alerts_{rule.name}").inc()
            if self.events is not None:
                self.events.emit("alert", **alert)
            if self.on_fire is not None:
                self.on_fire(alert)
        return fired_now

    def summary(self) -> dict:
        """Counts by rule + total, for run_summary / end-of-run logs."""
        by_rule: dict[str, int] = {}
        for a in self.fired:
            by_rule[a["rule"]] = by_rule.get(a["rule"], 0) + 1
        return {"total": len(self.fired), "by_rule": by_rule}
