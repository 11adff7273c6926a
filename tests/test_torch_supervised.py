"""Supervised runs of the port's trainer (``--max-restarts``,
``runtime/launcher.py``), on the CPU with gloo.

- Chaos replay: two ranks, ``DDP_CHAOS=ckpt-io@0,preempt@6`` (epoch 0's
  save fails once and is retried; both ranks die before step 6, in epoch
  1), ``--max-restarts 2``: the run exits cleanly after one restart, resumed
  at epoch 1, and its final loss equals the uninterrupted run's.  CPU replay
  from a bitwise checkpoint is deterministic, so atol 1e-6 (the reference's
  test holds 5e-2, ``tests/test_fault_tolerance.py:403-437``).
- ``events-supervisor.jsonl`` holds one ``restart_attempt``; the merged
  ``timeline.jsonl`` passes ``scripts/check_events.py`` and holds the
  retry, the injections and both incarnations; ``--runs-dir`` gets the
  supervisor's record.
- A spent budget raises, after ``restart_exhausted``.
- ``slow-step`` under ``--step-timeout``: the worker exits 75 after
  ``watchdog_fire`` and the restart completes the run.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.observability import read_events

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--model", "mlp", "--dataset", "synthetic", "--num-examples", "128",
        "--batch-size", "4", "--epochs", "3", "--steps-per-epoch", "4", "--log-every", "1000"]


INHERITED = ("DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_CHAOS", "DDP_CHAOS_STATE", "_DDP_SUPERVISED")


@pytest.fixture(autouse=True)
def _no_inherited_telemetry(monkeypatch):
    for k in INHERITED:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    base = tmp_path_factory.mktemp("replay")
    with pytest.MonkeyPatch.context() as mp:
        for k in INHERITED:
            mp.delenv(k, raising=False)
        # The uninterrupted run, in a subprocess beside the supervised one.
        straight = subprocess.Popen([sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *BASE,
                                     "--num-processes", "2"], cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        mp.setenv("DDP_CHAOS", "ckpt-io@0,preempt@6")
        chaotic = dpp.main(BASE + ["--num-processes", "2", "--checkpoint-dir", str(base / "ck"),
                                   "--events-dir", str(base / "ev"), "--runs-dir", str(base / "runs"),
                                   "--max-restarts", "2"])
    out, err = straight.communicate(timeout=300)
    assert straight.returncode == 0, err[-3000:]
    return base, json.loads(out.strip().splitlines()[-1]), chaotic


def test_chaos_replay_ends_at_the_uninterrupted_loss(replay):
    _, straight, chaotic = replay
    assert chaotic["start_epoch"] == 1 and chaotic["world_size"] == 2 and chaotic["train_steps"] == 8
    assert chaotic["faults"]["restarts"] == 1
    assert abs(chaotic["losses"][-1] - straight["losses"][-1]) <= 1e-6
    assert chaotic["losses"] == pytest.approx(straight["losses"][4:], abs=1e-6)


def test_supervisor_events_and_merged_timeline(replay):
    base, _, _ = replay
    ev = base / "ev"
    sup = read_events(str(ev / "events-supervisor.jsonl"))
    assert [r["kind"] for r in sup] == ["restart_attempt", "gang_verdict"]
    assert sup[0]["attempt"] == 1 and sup[1]["rung"] == "restart"
    check = subprocess.run([sys.executable, "scripts/check_events.py", str(ev / "timeline.jsonl")],
                           cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    timeline = read_events(str(ev / "timeline.jsonl"))
    kinds = [r["kind"] for r in timeline]
    assert kinds.count("ckpt_retry") == 1 and kinds.count("restart_attempt") == 1
    assert sorted((r["proc"], r["entry"]) for r in timeline if r["kind"] == "chaos_inject") == [
        (0, "ckpt-io@0"), (0, "preempt@6"), (1, "preempt@6")]
    assert [r["attempt"] for r in timeline if r["kind"] == "run_start" and r["proc"] == 0] == [0, 1]
    assert [r["status"] for r in timeline if r["kind"] == "run_end" and r["proc"] == 0] == [
        "SimulatedPreemption", "ok"]
    (record,) = [json.loads(x) for x in (base / "runs" / "index.jsonl").read_text().splitlines()]
    assert record["source"] == "supervisor" and record["restarts"] == 1


def test_a_spent_budget_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("DDP_CHAOS", "preempt@1,preempt@2")
    with pytest.raises(RuntimeError, match="restart budget of 1 exhausted"):
        dpp.main(BASE + ["--checkpoint-dir", str(tmp_path / "ck"), "--events-dir", str(tmp_path / "ev"),
                         "--max-restarts", "1"])
    sup = read_events(str(tmp_path / "ev" / "events-supervisor.jsonl"))
    assert [r["kind"] for r in sup] == ["restart_attempt", "restart_exhausted", "gang_verdict"]
    assert sup[1]["failed"] == [[0, 1]] and sup[2]["rung"] == "fail"


def test_watchdog_exits_75_and_the_restart_completes(tmp_path):
    summary = dpp.main(BASE + ["--epochs", "2", "--checkpoint-dir", str(tmp_path / "ck"),
                               "--events-dir", str(tmp_path / "ev"), "--max-restarts", "1",
                               "--step-timeout", "1", "--chaos", "slow-step@2:30"])
    # The emergency save labelled the state after steps 0-1 as epoch 0.
    assert summary["start_epoch"] == 1 and summary["train_steps"] == 4 and summary["faults"]["restarts"] == 1
    timeline = read_events(str(tmp_path / "ev" / "timeline.jsonl"))
    (fire,) = [r for r in timeline if r["kind"] == "watchdog_fire"]
    assert fire["seconds_since_heartbeat"] > 1 and fire["last_known_state"]["batch"] == 1
    (restart,) = [r for r in timeline if r["kind"] == "restart_attempt"]
    assert restart["failed"] == [[0, 75]]
