"""``dpp --autotune`` in the port, on the CPU, as the reference's
``tests/test_autotune.py`` drives its ``dpp.py``.

- ``--autotune search`` persists a winner and emits ``tune_trial`` and
  ``tune_result`` events; a second run with ``--autotune apply`` reaches
  its first step with ZERO search trials, replaying the stored config, and
  the run's knobs are the winner's.
- ``apply`` on a cold store trains on the CLI's values (``applied:
  False``) and leaves them untouched.
- The argument gates and ``--tune-dir``'s default are the reference's.
"""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  (the reference entry point)

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402


def _argv(tmp_path, mode, events_sub):
    return ["--device", "cpu", "--model", "mlp", "--dataset", "synthetic", "--num-examples", "128",
            "--batch-size", "8", "--epochs", "1", "--log-every", "1000", "--autotune", mode,
            "--tune-trials", "1", "--tune-steps", "1", "--tune-dir", str(tmp_path / "tuned"),
            "--events-dir", str(tmp_path / events_sub)]


def _tune_events(tmp_path, events_sub):
    with open(tmp_path / events_sub / "timeline.jsonl") as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    return [r for r in recs if str(r.get("kind", "")).startswith("tune_")]


def test_autotune_search_then_apply(tmp_path):
    searched = tdpp.main(_argv(tmp_path, "search", "ev_search"))
    path = tmp_path / "tuned" / "mlp@d1.tuned.json"
    assert path.exists()
    stored = json.loads(path.read_text())
    events = _tune_events(tmp_path, "ev_search")
    trials = [r for r in events if r["kind"] == "tune_trial"]
    results = [r for r in events if r["kind"] == "tune_result"]
    # top-1 by prediction plus the CLI baseline (b8), both measured
    assert len(trials) > 0 and sum(r["status"] in ("measured", "baseline") for r in trials) == 2
    assert [r["mode"] for r in results] == ["search"] and results[0]["winner"]
    assert results[0]["config"] == stored["config"]
    tuned = searched["autotune"]
    assert tuned["mode"] == "search" and tuned["config"] == stored["config"]
    assert tuned["knobs"]["batch_size"] == stored["config"]["batch_per_chip"]
    assert searched["train_steps"] == 128 // stored["config"]["batch_per_chip"]

    applied = tdpp.main(_argv(tmp_path, "apply", "ev_apply"))
    events = _tune_events(tmp_path, "ev_apply")
    assert sum(1 for r in events if r["kind"] == "tune_trial") == 0, "apply must not search"
    results = [r for r in events if r["kind"] == "tune_result"]
    assert [r["mode"] for r in results] == ["apply"] and results[0]["applied"] is True
    assert results[0]["winner"]["batch_per_chip"] == stored["config"]["batch_per_chip"]
    assert applied["autotune"]["knobs"] == tuned["knobs"]
    assert applied["train_steps"] == searched["train_steps"]


def test_autotune_apply_cold_store_falls_back(tmp_path):
    summary = tdpp.main(_argv(tmp_path, "apply", "ev_cold"))
    assert all(x == x for x in summary["losses"])  # a finite run completed
    results = [r for r in _tune_events(tmp_path, "ev_cold") if r["kind"] == "tune_result"]
    assert [r["mode"] for r in results] == ["apply"] and results[0]["applied"] is False
    assert summary["autotune"]["applied"] is False
    assert summary["autotune"]["knobs"]["batch_size"] == 8  # defaults untouched
    assert summary["train_steps"] == 16


GATES = [
    ["--model", "gpt2", "--dataset", "synthetic-lm", "--autotune", "search", "--fsdp"],
    ["--model", "gpt2", "--autotune", "search", "--pp", "2"],
    ["--model", "gpt2", "--autotune", "apply", "--cp", "2", "--seq-len", "16"],
    ["--model", "mlp", "--autotune", "search", "--elastic", "--elastic-dir", "g"],
    ["--model", "llama", "--autotune", "search"],
    ["--model", "resnet18", "--autotune", "apply"],
    ["--model", "mlp", "--autotune", "search", "--tune-trials", "0"],
    ["--model", "mlp", "--autotune", "search", "--tune-steps", "0"],
    ["--model", "mlp", "--dataset", "synthetic", "--remat", "on"],
]


def test_autotune_arg_gates_match_the_reference(capsys):
    for argv in GATES:
        argv = ["--device", "cpu", *argv]
        with pytest.raises(SystemExit) as want:
            jdpp.validate_args(jdpp.parse_args(argv))
        capsys.readouterr()
        with pytest.raises(SystemExit) as got:
            tdpp.parse_args(argv)
        # The port's parser reports some gates through argparse's error
        # (exit 2, the message on stderr); the text is the reference's.
        said = str(got.value) if got.value.code != 2 else capsys.readouterr().err
        assert str(want.value) in said, argv


def test_tune_dir_default_matches_the_reference():
    for extra in ([], ["--tune-dir", "here"], ["--compile-cache", "cache"],
                  ["--compile-cache", "cache", "--tune-dir", "there"]):
        argv = ["--device", "cpu", "--model", "mlp", *extra]
        jargs, targs = jdpp.parse_args(argv), tdpp.parse_args(argv)
        want = jdpp._tune_dir_for(jargs)
        got = tdpp._tune_dir_for(targs)
        # The reference's parser makes --compile-cache absolute; compare
        # the same paths.
        assert os.path.abspath(got) == os.path.abspath(want), extra
