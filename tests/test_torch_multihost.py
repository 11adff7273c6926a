"""Multi-host process groups of the port's trainer (``--coordinator``,
``--num-processes`` hosts, ``--process-id``), on the CPU with gloo.

Two "hosts" are two process trees on this machine: each runs
``python -m distributeddataparallel_tpu_torch.dpp --coordinator
127.0.0.1:P --num-processes 2 --process-id {0,1} --fake-devices 2`` and
starts its two local ranks.  Their world of 4 (global rank = process_id x
2 + local rank) gives the same losses as one host of ``--num-processes 4``:
the same ranks in the same order read the same rows and reduce the same
gradients, so only gloo's summation order could differ (atol 1e-6).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.observability import read_events
from distributeddataparallel_tpu_torch.runtime import distributed as rt

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--device", "cpu", "--model", "mlp", "--dataset", "synthetic", "--num-examples", "128",
         "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "6", "--log-every", "1000"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("multihost")
    env = {k: v for k, v in os.environ.items() if k not in ("DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_CHAOS")}
    coord = f"127.0.0.1:{rt.free_port()}"
    hosts = [subprocess.Popen(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *FLAGS, "--coordinator", coord,
         "--num-processes", "2", "--process-id", str(pid), "--fake-devices", "2",
         "--events-dir", str(base / "ev")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for pid in (1, 0)]
    one_host = dpp.main(FLAGS + ["--num-processes", "4"])
    outs = []
    for h in hosts:
        out, err = h.communicate(timeout=300)
        assert h.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return base, outs, one_host


def test_two_hosts_equal_one_host_of_four_ranks(runs):
    _, (host1, host0), one_host = runs
    assert host1 is None  # rank 0 lives on host 0
    assert host0["world_size"] == one_host["world_size"] == 4
    assert host0["losses"] == pytest.approx(one_host["losses"], abs=1e-6)
    assert len(host0["losses"]) == 6


def test_global_rank_is_process_id_times_local_devices_plus_local_rank(runs):
    base, _, _ = runs
    for rank in range(4):
        (start,) = [r for r in read_events(str(base / "ev" / f"events-p{rank}.jsonl")) if r["kind"] == "run_start"]
        argv = start["argv"]
        assert int(argv[argv.index("--process-id") + 1]) == rank // 2, rank
        assert start["devices"] == 4


def test_coordinator_arguments_are_checked():
    with pytest.raises(ValueError, match="num_processes and process_id"):
        rt.init_process_group(coordinator_address="127.0.0.1:1", num_processes=2)
    with pytest.raises(ValueError, match=r"process_id 2 is not in \[0, 2\)"):
        rt.init_process_group(coordinator_address="127.0.0.1:1", num_processes=2, process_id=2)
