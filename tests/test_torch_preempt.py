"""SIGTERM preemption of the port's trainer, on the CPU with gloo.

A real signal to a real process: the trainer runs as ``python -m
distributeddataparallel_tpu_torch.dpp`` with ``--checkpoint-dir`` and
``--events-dir``, and the test sends SIGTERM once the events show step 3.
``--chaos slow-step@4:3`` holds every rank for 3 s before step 4, so the
signal always lands in the same place.

- Two ranks, SIGTERM to rank 1 only: both ranks stop after the same batch,
  the first one on the 8-batch agreement cadence (batch 8), save the
  interrupted epoch as ``epoch_0.pt`` with its hash sidecar, and exit 0;
  ``--resume`` starts at epoch 1 and finishes it.
- One rank: it stops at the next batch boundary (after batch 4).
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.observability import read_events

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--device", "cpu", "--model", "mlp", "--dataset", "synthetic", "--num-examples", "256",
         "--batch-size", "4", "--epochs", "2", "--steps-per-epoch", "12", "--log-every", "1000",
         "--chaos", "slow-step@4:3"]


def _env() -> dict:
    drop = ("DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_CHAOS", "DDP_CHAOS_STATE", "_DDP_SUPERVISED")
    return {k: v for k, v in os.environ.items() if k not in drop}


def _start(d: Path, extra: list[str]) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *FLAGS, *extra,
         "--checkpoint-dir", str(d / "ck"), "--events-dir", str(d / "ev")],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _signal_at_step(runs: list, step: int) -> None:
    """Poll every run's events; send each run's SIGTERM once its file shows
    ``step`` (the runs start together, so neither waits on the other)."""
    pending, deadline = list(runs), time.monotonic() + 120
    while pending and time.monotonic() < deadline:
        for run in list(pending):
            events, proc, send = run
            assert proc.poll() is None, f"exited {proc.returncode} before step {step}"
            if events.exists() and step in _steps(events):
                send()
                pending.remove(run)
        time.sleep(0.05)
    assert not pending, f"no step {step} within 120 s"


def _rank_pids(parent: int) -> list[int]:
    """The launcher's rank processes, in start (rank) order."""
    kids = Path(f"/proc/{parent}/task/{parent}/children").read_text().split()
    return sorted(int(k) for k in kids if b"spawn_main" in Path(f"/proc/{k}/cmdline").read_bytes())


def _finish(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _steps(events: Path) -> list[int]:
    """The step spans in a (possibly still growing) events file."""
    out = []
    for line in events.read_text().splitlines():
        try:
            r = json.loads(line)
        except json.JSONDecodeError:  # a line being written
            continue
        if r["kind"] == "span" and r["name"] == "step":
            out.append(r["step"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("preempt")
    two, one = _start(base / "two", ["--num-processes", "2"]), _start(base / "one", [])
    _signal_at_step([
        (base / "two" / "ev" / "events-p1.jsonl", two,
         lambda: os.kill(_rank_pids(two.pid)[1], signal.SIGTERM)),  # rank 1 only
        (base / "one" / "ev" / "events-p0.jsonl", one, lambda: one.send_signal(signal.SIGTERM)),
    ], 3)
    return base, _finish(two), _finish(one)


def test_sigterm_to_one_rank_stops_both_at_the_same_batch(runs):
    base, two, _ = runs
    ev = base / "two" / "ev"
    assert _steps(ev / "events-p0.jsonl") == _steps(ev / "events-p1.jsonl") == list(range(9))
    assert two["preempted_epoch"] == 0 and two["train_steps"] == 9 and two["world_size"] == 2


def test_the_checkpoint_is_the_interrupted_epoch(runs):
    base, _, _ = runs
    ck = base / "two" / "ck"
    assert sorted(p.name for p in ck.iterdir() if not p.name.startswith(".")) == ["epoch_0.pt", "hash_0.json"]
    payload = torch.load(ck / "epoch_0.pt", weights_only=True)
    assert payload["epoch"] == 0 and payload["step"] == 9
    timeline = read_events(str(base / "two" / "ev" / "timeline.jsonl"))
    assert [r["epoch"] for r in timeline if r["kind"] == "ckpt_save"] == [0]
    assert {r["status"] for r in timeline if r["kind"] == "run_end"} == {"ok"}


def test_resume_starts_at_the_next_epoch(runs, monkeypatch):
    base, _, _ = runs
    for k in ("DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_CHAOS", "DDP_CHAOS_STATE"):
        monkeypatch.delenv(k, raising=False)
    resumed = dpp.main([*FLAGS, "--num-processes", "2", "--checkpoint-dir", str(base / "two" / "ck"),
                        "--resume"])
    assert resumed["start_epoch"] == 1 and resumed["train_steps"] == 12 and resumed["preempted_epoch"] is None
    assert np.isfinite(resumed["losses"]).all()


def test_one_rank_stops_at_the_next_batch(runs):
    base, _, one = runs
    assert _steps(base / "one" / "ev" / "events-p0.jsonl") == list(range(5))
    assert one["preempted_epoch"] == 0 and one["world_size"] == 1
    assert torch.load(base / "one" / "ck" / "epoch_0.pt", weights_only=True)["step"] == 5
