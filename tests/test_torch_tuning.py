"""The port's autotuner (``distributeddataparallel_tpu_torch.tuning``)
against the reference's (``distributeddataparallel_tpu.tuning``) on the CPU.

Every check feeds both packages the same inputs and holds the port's result
to the reference's exactly (the tuner is host arithmetic, so there is no
tolerance): the search space's trials, order and verdicts; the per-model
default spaces; the analytic memory fit and the step-time prediction; the
model statics; ``Autotuner.search`` over the same deterministic hooks;
``_apply_trial_to_args``; the store's round trip; and ``search_model``
over the tiny LM at the same data degree with its measurement replaced by
the same deterministic stub.  The stated divergences are pinned too: only
an out-of-memory error (or the step factory's refusal of a layout) is a
trial's own result, any other error ends the search; the tuned key is the
port's own, so a record the reference wrote does not match it.
"""

import dataclasses
import itertools
import json
import logging
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  (the reference entry point)
from distributeddataparallel_tpu import tuning as jtun  # noqa: E402
from distributeddataparallel_tpu.analysis import mesh_sim as jmesh  # noqa: E402
from distributeddataparallel_tpu.observability import cost_model as jcost  # noqa: E402
from distributeddataparallel_tpu.tuning import harness as jharness  # noqa: E402

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch import tuning as ttun  # noqa: E402
from distributeddataparallel_tpu_torch.analysis import mesh_sim as tmesh  # noqa: E402
from distributeddataparallel_tpu_torch.observability import cost_model as tcost  # noqa: E402
from distributeddataparallel_tpu_torch.tuning import harness as tharness  # noqa: E402
from distributeddataparallel_tpu_torch.utils.logging import get_logger  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

SPACE = dict(batch_per_chip=(8, 16, 32), accum_steps=(1, 2, 3), remat=(False, True), zero=(0, 1, 2, 3),
             moment_dtype=("f32", "bf16", "int8"), bucket_mb=(None, 4.0), dispatch_depth=(0, 2))


class _Capture(logging.Handler):
    """The port's logger does not propagate: capture by attaching."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _fields(t):
    return dataclasses.asdict(t)


def test_space_enumeration_and_verdicts_match_the_reference():
    mine, theirs = ttun.SearchSpace(**SPACE), jtun.SearchSpace(**SPACE)
    for seed in (None, 0, 7):
        a, b = mine.enumerate(seed=seed), theirs.enumerate(seed=seed)
        assert [t.label for t in a] == [t.label for t in b] and len(a) > 100
    assert mine.size() == theirs.size()
    # every combination, valid or not, gets the same verdicts and flags
    bad = dict(batch_per_chip=(0, 8, 12), accum_steps=(0, 1, 5), remat=(False,), zero=(0, 1, 4),
               moment_dtype=("f32", "bf16", "fp8"), bucket_mb=(None, -1.0, 2.5), dispatch_depth=(-1, 2))
    for combo in itertools.product(*bad.values()):
        t, j = ttun.TrialConfig(*combo), jtun.TrialConfig(*combo)
        assert t.problems() == j.problems() and t.label == j.label
        assert t.cli_flags() == j.cli_flags() and t.cli_flags(lm=False) == j.cli_flags(lm=False)
        assert ttun.TrialConfig.from_dict(j.as_dict()) == t


def test_default_spaces_match_the_reference():
    for model in ("mlp", "cnn", "tiny-lm", "gpt2", "gpt2-small"):
        assert _fields(tharness.default_space_for(model)) == _fields(jharness.default_space_for(model))
        assert tharness.canonical_model(model) == jharness.canonical_model(model)
    for fn in (tharness.canonical_model, jharness.canonical_model):
        with pytest.raises(ValueError, match="autotuner does not support model 'llama'"):
            fn("llama")


def test_memory_fit_and_step_prediction_are_exact():
    kw = dict(params_bytes=497_759_232, params_count=124_439_808, act_bytes=3_000_000_000,
              batch_bytes=16_388)
    for n in (1, 2, 8):
        for zero in (0, 1, 2, 3):
            for moment in (8.0, 4.0, 2.0):
                for budget in (2 * 2**30, 80 * 2**30):
                    args = dict(kw, n_devices=n, zero_level=zero, moment_bytes_per_param=moment,
                                budget_bytes=budget)
                    assert tmesh.analytic_memory_fit(**args) == jmesh.analytic_memory_fit(**args)
    assert tcost.DEFAULT_EFFICIENCY == jcost.DEFAULT_EFFICIENCY
    for flops in (0, 1.0, 3.7e12, 9.9e15):
        for n in (0, 1, 4):
            for peak in (None, 0.0, 67e12, 989e12):
                for eff in (0.35, 0.5):
                    kw2 = dict(n_chips=n, peak_flops_per_chip=peak, efficiency=eff)
                    assert tcost.predict_step_s(flops, **kw2) == jcost.predict_step_s(flops, **kw2)


@pytest.mark.parametrize("model", ["mlp", "cnn", "tiny-lm", "gpt2-small"])
def test_model_statics_match_the_reference(model):
    mine, theirs = tharness.model_statics(model, seq=1024), jharness.model_statics(model, seq=1024)
    for k in ("model", "seq", "params_count", "params_bytes"):
        assert mine[k] == theirs[k], k
    trials = [ttun.TrialConfig(batch_per_chip=b, accum_steps=a, remat=r)
              for b, a, r in ((1, 1, False), (4, 2, True), (8, 1, True))]
    for t in trials:
        assert mine["fwd_flops"](t.batch_per_chip * 3) == theirs["fwd_flops"](t.batch_per_chip * 3)
        assert mine["act_bytes"](t) == theirs["act_bytes"](t)
        assert mine["batch_bytes"](t) == theirs["batch_bytes"](t)


def _fake_hooks(step_s_by_label, *, no_fit=(), fail=None):
    """The reference test's deterministic predict/measure pair: measured is
    exactly 2x predicted (drift +1.0); ``fail`` maps a label to the
    exception its measurement raises."""

    def predict(trial):
        return {"model_flops": 100.0, "step_s": step_s_by_label[trial.label],
                "fit": {"required_bytes": 1, "budget_bytes": 2, "fits": trial.label not in no_fit,
                        "analytic": True}}

    def measure(trial):
        if trial.label in (fail or {}):
            raise fail[trial.label]
        s = 2.0 * step_s_by_label[trial.label]
        return {"step_s": s, "score": 100.0 / s, "mfu": None, "warm_mode": None}

    return predict, measure


def _records(records):
    return [(r.trial.label, r.status, r.predicted_step_s, r.predicted_score, r.measured_step_s, r.score,
             r.drift_frac) for r in records]


def test_autotuner_search_matches_the_reference():
    space = dict(batch_per_chip=(8, 16, 32, 64, 128), accum_steps=(1, 2), zero=(0, 1))
    labels = [t.label for t in jtun.SearchSpace(**space).enumerate()]
    by_label = {lab: 0.01 + 0.003 * (i % 7) for i, lab in enumerate(labels)}
    no_fit = set(labels[::5])
    for top_k in (1, 3, 6):
        for base in (None, dict(batch_per_chip=64, accum_steps=2, zero=1), dict(batch_per_chip=24)):
            if base is not None:
                by_label[jtun.TrialConfig(**base).label] = 0.004
            out = []
            for tun in (ttun, jtun):
                predict, measure = _fake_hooks(by_label, no_fit=no_fit)
                tuner = tun.Autotuner(predict=predict, measure=measure, top_k=top_k)
                winner, records = tuner.search(tun.SearchSpace(**space).enumerate(seed=3),
                                               baseline=tun.TrialConfig(**base) if base else None)
                out.append((winner.trial.label, winner.status, _records(records)))
            assert out[0] == out[1]


def test_only_running_out_of_memory_is_a_trials_own_error():
    trials = [ttun.TrialConfig(batch_per_chip=b) for b in (8, 16, 32)]
    by_label = {t.label: 0.01 * (i + 1) for i, t in enumerate(trials)}
    # An out-of-memory error and a refused layout are recorded, as the
    # reference records every error; the search goes on.
    refused = ttun.TrialRefused(ValueError("zero=1 does its own reduction"))
    predict, measure = _fake_hooks(by_label, fail={trials[0].label: torch.cuda.OutOfMemoryError("oom"),
                                                        trials[1].label: refused})
    winner, records = ttun.Autotuner(predict=predict, measure=measure, top_k=3).search(trials)
    by = {r.trial.label: r.status for r in records}
    assert by[trials[0].label] == "error: OutOfMemoryError: oom"
    assert by[trials[1].label] == "error: ValueError: zero=1 does its own reduction"
    assert winner.trial == trials[2]
    # The reference records a RuntimeError too; the port ends the search.
    predict, jmeasure = _fake_hooks(by_label, fail={trials[0].label: RuntimeError("CUDA error: launch")})
    _, jrecords = jtun.Autotuner(predict=predict, measure=jmeasure, top_k=3).search(
        [jtun.TrialConfig(batch_per_chip=b) for b in (8, 16, 32)])
    assert jrecords[0].status == "error: RuntimeError: CUDA error: launch"
    predict, measure = _fake_hooks(by_label, fail={trials[0].label: RuntimeError("CUDA error: launch")})
    with pytest.raises(RuntimeError, match="CUDA error: launch"):
        ttun.Autotuner(predict=predict, measure=measure, top_k=3).search(trials)
    # The harness refuses the layout before anything is built.
    with pytest.raises(ttun.TrialRefused, match="zero=1 does its own reduction"):
        tharness.build_trial_case("mlp", ttun.TrialConfig(batch_per_chip=8, zero=1, bucket_mb=4.0))


APPLY_CASES = [
    (["--model", "mlp", "--num-examples", "128", "--batch-size", "8"],
     dict(batch_per_chip=16, accum_steps=2, zero=1, dispatch_depth=0), 8),
    (["--model", "gpt2", "--num-examples", "64", "--batch-size", "8", "--remat", "on"],
     dict(batch_per_chip=4, accum_steps=2, remat=False, zero=2, moment_dtype="bf16", bucket_mb=4.0), 1),
    # the --num-examples cap keeps the CLI batch and accumulation
    (["--model", "gpt2", "--num-examples", "16", "--batch-size", "2", "--accum-steps", "2"],
     dict(batch_per_chip=4, accum_steps=1, remat=True, zero=1, moment_dtype="int8"), 8),
    (["--model", "cnn", "--num-examples", "100", "--batch-size", "4"], dict(batch_per_chip=64), 2),
]


def test_apply_trial_to_args_matches_the_reference():
    for argv, config, n_chips in APPLY_CASES:
        jargs, targs = jdpp.parse_args(["--device", "cpu", *argv]), tdpp.parse_args(["--device", "cpu", *argv])
        jdpp._apply_trial_to_args(jargs, config, n_chips=n_chips)
        tdpp._apply_trial_to_args(targs, config, n_chips=n_chips)
        for dest in ("batch_size", "accum_steps", "zero", "moment_dtype", "bucket_mb", "dispatch_depth",
                     "remat"):
            assert getattr(targs, dest) == getattr(jargs, dest), (argv, dest)


def test_tuning_store_round_trip_and_the_ports_own_key(devices, tmp_path):
    import distributeddataparallel_tpu as ddp

    store = ttun.TuningStore(str(tmp_path / "tuned"))
    key = ttun.tuned_key(n_devices=8, device_name="cpu", extra={"model": "mlp", "seq": 0})
    assert set(key) == {"store_version", "versions", "topology", "extra"}
    assert key["topology"] == {"device": "cpu", "n_devices": 8, "mesh_shape": {"data": 8}}
    trial = ttun.TrialConfig(batch_per_chip=16, zero=1)
    path = store.save("mlp@d8", key, config=trial.as_dict(), objective="model_flops/s", score=1.0,
                      measured_step_s=0.01, gain_frac=0.25)
    rec = store.load("mlp@d8", key)
    assert rec is not None and path == store.path("mlp@d8")
    assert ttun.TrialConfig.from_dict(rec["config"]) == trial and rec["gain_frac"] == 0.25
    assert store.index()["mlp@d8"]["score"] == 1.0
    # The record format is the reference's: its store reads the port's file
    # and the port's reads its (up to the key).
    jrec = json.loads(Path(path).read_text())
    jstore = jtun.TuningStore(str(tmp_path / "tuned"))
    assert jstore.load("mlp@d8", jrec["key"])["config"] == trial.as_dict()
    stale = ttun.tuned_key(n_devices=8, device_name="cpu", extra={"model": "mlp", "seq": 128})
    cap = _Capture()
    get_logger().addHandler(cap)
    try:
        assert store.load("mlp@d8", stale) is None
        assert store.load("other@d8", key) is None  # a cold store is silent
    finally:
        get_logger().removeHandler(cap)
    assert len(cap.messages) == 1 and "key mismatch" in cap.messages[0] and "extra.seq" in cap.messages[0]
    assert "falling back to untuned defaults" in cap.messages[0]
    with pytest.raises(ttun.store.WarmStartMismatch, match="key mismatch"):
        store.load("mlp@d8", stale, strict=True)
    # The divergence: a record the reference wrote (its executable_key)
    # does not match the port's key; the mismatch names the fields.
    jkey = jtun.tuned_key(mesh=ddp.make_mesh(("data",)), extra={"model": "mlp", "seq": 0})
    jstore.save("ref@d8", jkey, config=trial.as_dict(), objective="model_flops/s", score=1.0)
    with pytest.raises(ttun.store.WarmStartMismatch, match=r"versions\.torch: stored=None"):
        store.load("ref@d8", key, strict=True)


def test_search_model_over_the_tiny_lm_matches_the_reference(devices, tmp_path, monkeypatch):
    """The slice as a whole: statics, predictions, memory pruning, the
    search, the winner and the persisted record, at data degree 8, with
    the measured window replaced by the same deterministic stub in both
    packages (a function of the trial's knobs)."""
    import distributeddataparallel_tpu as ddp

    def stub(case, trial, **kw):
        s = 0.001 * (1 + trial.batch_per_chip) * (1.3 if trial.remat else 1.0) / (1 + 0.1 * trial.zero)
        s *= 1.0 + 0.05 * (trial.accum_steps - 1) + (0.02 if trial.bucket_mb else 0.0)
        return {"step_s": s, "score": 1e9 * trial.batch_per_chip / s, "mfu": None, "warm_mode": None}

    for mod in (jharness, tharness):
        monkeypatch.setattr(mod, "build_trial_case", lambda *a, **k: {})
        monkeypatch.setattr(mod, "measure_trial", stub)
    monkeypatch.setattr(jcost, "peak_flops_for", lambda *a, **k: 67e12)
    monkeypatch.setattr(tcost, "peak_flops_for", lambda *a, **k: 67e12)
    space = dataclasses.replace(jharness.default_space_for("tiny-lm"), zero=(0, 1))
    out = {}
    for name, mod, kw in (("jax", jharness, dict(mesh=ddp.make_mesh(("data",)))),
                          ("torch", tharness, dict(n_data=8))):
        tun = jtun if name == "jax" else ttun
        store = tun.TuningStore(str(tmp_path / name))
        summary = mod.search_model(
            "tiny-lm", seq=64, space=tun.SearchSpace(**_fields(space)), top_k=4, seed=5,
            baseline=tun.TrialConfig(batch_per_chip=2, remat=True), budget_bytes=1_500_000,
            tune_store=store, key={"k": 1}, **kw)
        rec = json.loads(Path(summary["store_path"]).read_text())
        keep = ("trial", "status", "predicted_step_s", "predicted_score", "required_bytes", "budget_bytes",
                "measured_step_s", "score", "drift_frac", "config")
        out[name] = (summary["name"], summary["winner"]["trial"], summary["gain_frac"],
                     [{k: r[k] for k in keep} for r in summary["records"]],
                     rec["config"], [{k: r[k] for k in keep} for r in rec["trials"]],
                     rec["score"], rec["measured_step_s"], rec["predicted_step_s"], rec["baseline_step_s"])
    assert out["torch"] == out["jax"]
    statuses = [r["status"] for r in out["torch"][3]]
    assert statuses.count("measured") + statuses.count("baseline") == 5 and "pruned-memory" in statuses
