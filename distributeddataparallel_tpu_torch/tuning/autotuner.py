"""Cost-model-guided config search with measured validation.

The search runs in three stages, each strictly cheaper than the next
one it feeds:

1. **enumerate** — the typed ``SearchSpace`` product (space.py), a few
   dozen to a few hundred trials, pure host arithmetic;
2. **prune analytically** — every trial gets a predicted step time
   (``cost_model.predict_step_s``) and a memory-fit verdict
   (``mesh_sim.analytic_memory_fit`` against
   ``memory.hbm_budget_bytes``); configs that don't fit are rejected
   without a compile, the rest are RANKED by predicted throughput
   (model FLOP/s — step time alone would reward small batches);
3. **measure the top-K survivors** — short timed windows; the optional
   ``prepare`` hook is called for the NEXT candidate while the current
   one is measured (the port passes none: see ``tuning.harness``).

The objective is the MFU gauge (model FLOP/s when the peak is unknown
— the same number up to a constant, so the ranking is identical).
Every trial's predicted-vs-measured drift is recorded: the search is
also a calibration probe for the cost model, surfaced in ddp_report's
"## Tuning" section.

A copy of the reference's ``tuning/autotuner.py`` with one divergence:
**only running out of memory is a trial's own failure.**  The reference's
``_measure_one`` records any exception as the trial's ``error: ...`` status
and goes on.  Here ``torch.cuda.OutOfMemoryError`` is recorded so (the
harness frees the trial's case first), and so is ``TrialRefused``: the step
factory's refusal of a trial's layout before anything is built or launched
(``zero=1`` with a bucket size, say), which the reference records as the
same ``error: ValueError: ...`` status.  Any other exception — a kernel
that fails to build or launch, a CUDA error, a wrapper that refuses its
inputs — ends the search with that error: recording it would hide a kernel
fault behind another trial, and a CUDA error leaves the context unusable
for the trials after it anyway.  ``_predict_one`` keeps the reference's
broad catch: prediction touches no device.  A ``TrialRecord`` (and its
``tune_trial`` event) also carries the trial's first step
(``first_step_s``) and its peak allocated bytes (``peak_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from distributeddataparallel_tpu_torch.tuning.space import TrialConfig
from distributeddataparallel_tpu_torch.utils.logging import get_logger


class TrialRefused(Exception):
    """The step factory refused a trial's layout before anything was built
    or launched; ``cause`` is its exception (the trial's ``error:``
    status names it, as the reference's does)."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


#: What a measurement may raise and still be a search result.
TRIAL_ERRORS = (torch.cuda.OutOfMemoryError, TrialRefused)


@dataclasses.dataclass
class TrialRecord:
    """One trial's full accounting, from prediction to (maybe)
    measurement."""

    trial: TrialConfig
    status: str = "pending"
    predicted_step_s: float | None = None
    predicted_score: float | None = None
    required_bytes: int | None = None
    budget_bytes: int | None = None
    measured_step_s: float | None = None
    score: float | None = None
    mfu: float | None = None
    drift_frac: float | None = None
    warm_mode: str | None = None
    # The port's additions: the trial's first step (accounted apart) and
    # the allocator's peak over the trial.
    first_step_s: float | None = None
    peak_bytes: int | None = None

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["trial"] = self.trial.label
        d["config"] = self.trial.as_dict()
        return d


class Autotuner:
    """Orchestrates prune → rank → measure over caller-supplied hooks.

    The hooks keep this class model- and backend-agnostic (harness.py
    provides them for the repo's models):

    - ``predict(trial) -> dict`` with ``model_flops``, ``step_s``
      (None when the peak is unknown), ``fit`` (an
      ``analytic_memory_fit`` dict, or None to skip memory pruning);
    - ``measure(trial) -> dict`` with ``step_s``, ``score``
      (model FLOP/s), ``mfu`` (None off known hardware), ``warm_mode``;
      it raises ``torch.cuda.OutOfMemoryError`` or ``TrialRefused`` for a
      trial that cannot run (recorded), anything else to end the search;
    - ``prepare(trial)`` (optional) — start the trial's build in the
      background; called for candidate i+1 right before candidate i is
      measured.
    """

    def __init__(
        self,
        *,
        predict: Callable[[TrialConfig], dict],
        measure: Callable[[TrialConfig], dict],
        prepare: Callable[[TrialConfig], Any] | None = None,
        top_k: int = 3,
        events=None,
    ):
        self.predict = predict
        self.measure = measure
        self.prepare = prepare
        self.top_k = max(1, int(top_k))
        self.events = events

    def search(
        self,
        trials: list[TrialConfig],
        *,
        baseline: TrialConfig | None = None,
    ) -> tuple[TrialRecord | None, list[TrialRecord]]:
        """Run the full search; returns ``(winner, records)``.

        ``baseline`` (the hand-picked default) is always measured and
        always eligible to win — so applying the search result can only
        tie or beat the default, and the reported gain is honest.
        Returns ``winner=None`` only when nothing could be measured.
        """
        log = get_logger()
        records = [self._predict_one(t) for t in self._dedupe(trials)]
        feasible = [r for r in records if r.status == "pending"]
        # Rank by predicted throughput when available; enumeration order
        # (already seed-shuffled) breaks ties and covers the no-peak
        # case, where every prediction is None.
        feasible.sort(
            key=lambda r: -(r.predicted_score or 0.0)
        )
        chosen = feasible[: self.top_k]
        for r in feasible[self.top_k:]:
            r.status = "pruned-cost"

        measure_list = list(chosen)
        if baseline is not None:
            base_rec = next(
                (r for r in chosen if r.trial == baseline), None
            )
            if base_rec is None:
                base_rec = self._predict_one(baseline)
                records.append(base_rec)
                measure_list.append(base_rec)
            base_rec.status = "baseline"

        for i, rec in enumerate(measure_list):
            if self.prepare is not None and i + 1 < len(measure_list):
                nxt = measure_list[i + 1]
                try:
                    self.prepare(nxt.trial)
                # A background build is an optimization; the candidate
                # builds cold on failure.
                except Exception as exc:  # noqa: BLE001
                    log.warning(
                        "background prepare of trial %s failed (%s: %s)",
                        nxt.trial.label, type(exc).__name__, exc,
                    )
            self._measure_one(rec)

        measured = [
            r for r in records
            if r.status in ("measured", "baseline") and r.score is not None
        ]
        winner = max(measured, key=lambda r: r.score, default=None)
        for rec in records:
            self._emit_trial(rec)
        return winner, records

    def _dedupe(self, trials) -> list[TrialConfig]:
        seen: set = set()
        out = []
        for t in trials:
            if t not in seen:
                seen.add(t)
                out.append(t)
        return out

    def _predict_one(self, trial: TrialConfig) -> TrialRecord:
        rec = TrialRecord(trial=trial)
        try:
            pred = self.predict(trial)
        # One unpredictable trial must not kill the search; it is recorded
        # and skipped (prediction touches no device).
        except Exception as exc:  # noqa: BLE001
            rec.status = f"error: {type(exc).__name__}: {exc}"
            return rec
        rec.predicted_step_s = pred.get("step_s")
        if rec.predicted_step_s:
            rec.predicted_score = (
                pred.get("model_flops", 0.0) / rec.predicted_step_s
            )
        fit = pred.get("fit")
        if fit is not None:
            rec.required_bytes = fit.get("required_bytes")
            rec.budget_bytes = fit.get("budget_bytes")
            if not fit.get("fits", True):
                rec.status = "pruned-memory"
        return rec

    def _measure_one(self, rec: TrialRecord) -> None:
        keep_status = rec.status if rec.status == "baseline" else "measured"
        try:
            m = self.measure(rec.trial)
        # Only these are the trial's own result (module docstring): any
        # other exception ends the search.
        except TRIAL_ERRORS as exc:
            exc = exc.cause if isinstance(exc, TrialRefused) else exc
            rec.status = f"error: {type(exc).__name__}: {exc}"
            get_logger().warning(
                "measuring trial %s failed (%s: %s)",
                rec.trial.label, type(exc).__name__, exc,
            )
            return
        rec.status = keep_status
        rec.measured_step_s = m.get("step_s")
        rec.score = m.get("score")
        rec.mfu = m.get("mfu")
        rec.warm_mode = m.get("warm_mode")
        rec.first_step_s = m.get("compile_or_load_s")
        rec.peak_bytes = m.get("peak_bytes")
        if rec.measured_step_s and rec.predicted_step_s:
            rec.drift_frac = (
                rec.measured_step_s - rec.predicted_step_s
            ) / rec.predicted_step_s

    def _emit_trial(self, rec: TrialRecord) -> None:
        if self.events is None:
            return
        self.events.emit(
            "tune_trial",
            trial=rec.trial.label,
            status=rec.status,
            config=rec.trial.as_dict(),
            predicted_step_s=rec.predicted_step_s,
            measured_step_s=rec.measured_step_s,
            required_bytes=rec.required_bytes,
            budget_bytes=rec.budget_bytes,
            score=rec.score,
            mfu=rec.mfu,
            drift_frac=rec.drift_frac,
            warm_mode=rec.warm_mode,
            first_step_s=rec.first_step_s,
            peak_bytes=rec.peak_bytes,
        )
