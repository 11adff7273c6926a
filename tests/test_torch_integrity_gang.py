"""The closed loop on one host through ``dpp --elastic --integrity-every``
(``training/integrity.py``, the gang's grow in ``runtime/{elastic_gang,
distributed,launcher}.py`` and ``dpp``), against the JAX package's
acceptance run (``tests/test_integrity.py::
test_bitflip_detect_evict_matches_clean_run``) on 3 gloo processes with
``--model mlp --zero 1``, so the grow reshards live ZeRO-1 flats.

- The flip-and-join run (``bitflip@2:2,worker-join@5:2``, supervised)
  against its control (``nan-grad@2,worker-kill@2:2,worker-join@5:2``):
  both discard step 2's update, lose member 2 after it and take a new
  process for it back before epoch 1's first step (step 5); the two runs'
  checkpoints are bitwise equal (their content hashes).
- The flip run's timeline: ``sdc_detect`` names rank 2 at step 2 by
  ``vote``, ``sdc_evict``, the workers' ``gang_resize`` 3 -> 2 and then
  2 -> 3 with ``joined == ["proc2"]``, the supervisor's ``gang_resize``
  with the join and a ``gang_verdict`` naming the ``worker-join`` entry,
  no ``restart_attempt``; no checkpoint is read.
- The grow is a resume: the control's epoch 1 (grown to 3) is bitwise a
  3-process ``--resume`` of its epoch-0 checkpoint, written on 2.
- A 2-rank tie (``bitflip@4:1`` on 2 processes) is resolved by the replay
  arbiter (``method == "replay"``) and rank 1 is evicted.
- ``--integrity-shadow`` at world 1 with no fault detects nothing, and its
  losses are the unarmed run's bit for bit.
- ``resize_index_plan`` deals to a larger world as the reference's, and a
  grow before an epoch's first batch deals that epoch as a fresh run at
  the new world does.
- The join rung: ``rejoin`` writes the request, the launcher starts the
  member's process; a joiner that fails ends the gang with an error, with
  no restart, and a joiner that never comes times the survivors out.  A
  survivor that fails while the join is open (its joiner hung before the
  store, or stuck in the transfer) is the join's failure too: an error,
  no restart.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.data.sharded import resize_index_plan  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import elastic_gang as tgang  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import launcher  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

DPP = [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp"]
COMMON = ["--device", "cpu", "--model", "mlp", "--fake-devices", "3", "--zero", "1", "--optimizer", "adamw",
          "--lr", "1e-3", "--batch-size", "4", "--epochs", "2", "--steps-per-epoch", "5", "--num-examples", "128",
          "--elastic", "--integrity-every", "2", "--nan-guard", "--log-every", "1000"]
FLIP, CONTROL = "bitflip@2:2,worker-join@5:2", "nan-grad@2,worker-kill@2:2,worker-join@5:2"
TIE = ["--device", "cpu", "--model", "mlp", "--fake-devices", "2", "--optimizer", "adamw", "--lr", "1e-3",
       "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "6", "--num-examples", "64", "--elastic",
       "--integrity-every", "2", "--chaos", "bitflip@4:1", "--log-every", "1000"]


def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("DDP_") and k != "_DDP_SUPERVISED"}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(argv, tmp: Path):
    return subprocess.Popen(DPP + argv, cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


class _Runs:
    """The module's dpp runs, started at once so they overlap: the flip
    run, its control, the 2-rank tie, and the resume of the control's
    epoch-0 checkpoint, started as soon as that checkpoint is written."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.procs = {
            "flip": _start(COMMON + ["--chaos", FLIP, "--max-restarts", "1", "--checkpoint-dir",
                                     str(tmp / "flip_ck"), "--events-dir", str(tmp / "flip_ev")], tmp),
            "control": _start(COMMON + ["--chaos", CONTROL, "--max-restarts", "1", "--checkpoint-dir",
                                        str(tmp / "ctl_ck"), "--events-dir", str(tmp / "ctl_ev")], tmp),
            "tie": _start(TIE + ["--events-dir", str(tmp / "tie_ev")], tmp),
        }
        self.out: dict = {}
        self.resumed = None
        self._resume = threading.Thread(target=self._start_resume, daemon=True)
        self._resume.start()

    def _start_resume(self):
        ck, mine = self.tmp / "ctl_ck", self.tmp / "res_ck"
        deadline = time.monotonic() + 240
        while not (ck / "hash_0.json").exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.2)  # the sidecar lands after the checkpoint it hashes
        mine.mkdir()
        for name in ("epoch_0.pt", "hash_0.json"):
            (mine / name).write_bytes((ck / name).read_bytes())
        # In this process (its launcher spawns the ranks): no interpreter
        # to start before them.
        self.resumed = tdpp.main(COMMON + ["--resume", "--checkpoint-dir", str(mine), "--elastic-dir",
                                           str(self.tmp / "res_gang")])

    def get(self, name: str) -> str:
        if name not in self.out:
            out, _ = self.procs[name].communicate(timeout=300)
            assert self.procs[name].returncode == 0, out[-4000:]
            self.out[name] = out
        return self.out[name]

    def close(self):
        self._resume.join(timeout=300)
        for p in self.procs.values():
            p.kill()
            p.wait()


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    r = _Runs(tmp_path_factory.mktemp("integrity_gang"))
    yield r
    r.close()


def _timeline(d: Path) -> list[dict]:
    return [json.loads(line) for line in open(d / "timeline.jsonl")]


def _hashes(ck: Path) -> dict:
    return {p.name: json.loads(p.read_text())["sha256"] for p in sorted(ck.glob("hash_*.json"))}


def _summary(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# -------------------------------------------------------- the grow's parts --

@pytest.mark.parametrize("old_world,new_world,consumed", [(2, 3, 0), (3, 4, 3), (2, 3, 5)])
def test_resize_plan_deals_to_a_larger_world_as_the_references(old_world, new_world, consumed):
    from distributeddataparallel_tpu.data.sharded import resize_index_plan as jplan

    kw = dict(per_replica_batch=4, old_world=old_world, new_world=new_world, consumed_steps=consumed, seed=3,
              epoch=1, membership_epoch=2)
    got, want = resize_index_plan(128, **kw), jplan(128, **kw)
    assert got.shape == want.shape and (got == want).all() and got.shape[0] == new_world
    done = set(np.random.default_rng(3 + 1).permutation(128)[: consumed * 4 * old_world].tolist())
    assert not done & set(got.ravel().tolist()) and len(set(got.ravel().tolist())) == got.size


def _join_fails(i, nprocs, store_address, root, how):
    from distributeddataparallel_tpu_torch.runtime.rendezvous import RendezvousStore

    store = RendezvousStore(root)
    if os.environ.get("DDP_ELASTIC_JOIN"):
        if how == "exits":
            raise SystemExit(3)  # the joiner fails to start
        if how == "transfer":
            store.join("proc1")  # in the store, then stuck in the state transfer
        time.sleep(30)  # "hangs": it never reaches the store
        return
    store.request_join("proc1")
    if how == "exits":
        time.sleep(30)  # the survivor waits; the launcher ends the gang
    time.sleep(1.0)  # await_members' timeout, or the transfer's broken collective
    raise SystemExit(1)


@pytest.mark.parametrize("how,failed", [("exits", "(1, 3)"), ("hangs", "(0, 1)"), ("transfer", "(0, 1)")])
def test_join_rung_starts_the_member_and_a_failed_join_is_an_error(tmp_path, how, failed, runs):
    """Any failure while the join is open ends the gang with an error and
    no restart: the joiner's own exit, or the survivor's, first, when its
    joiner hung before the store or in the transfer (the hung joiner is
    killed, not waited for).  ``runs``: the dpp runs work meanwhile."""
    root = tmp_path / "gang"
    gang = tgang.ElasticGangCoordinator(str(root), world=["proc0", "proc1"])
    gang.start()
    gang.rejoin("1")  # the chaos rank form: proc1
    assert list(gang.store.join_requests()) == ["proc1"]
    gang.store.clear_join("proc1")
    gang.kill("proc1")
    with pytest.raises(RuntimeError, match=r"elastic join: \['proc1'\] did not join"):
        gang.await_members(["proc1"], timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=re.escape(f"elastic join failed (rank, exitcode): [{failed}] while the "
                                                     f"join of ['proc1'] was open")):
        launcher.spawn(_join_fails, args=(str(tmp_path / "req"), how), nprocs=1, max_restarts=1,
                       elastic_store=str(tmp_path / "req"), events_dir=str(tmp_path / "ev"))
    assert time.monotonic() - t0 < 25  # ended at the failed join, not after a sleep
    kinds = [json.loads(line)["kind"] for line in open(tmp_path / "ev" / "timeline.jsonl")]
    assert "restart_attempt" not in kinds and kinds.count("gang_resize") == 1


def test_shadow_at_world_one_detects_nothing(tmp_path, runs):  # runs: the dpp runs work meanwhile
    base = ["--device", "cpu", "--model", "mlp", "--optimizer", "adamw", "--lr", "1e-3", "--batch-size", "4",
            "--epochs", "1", "--steps-per-epoch", "6", "--num-examples", "64", "--log-every", "1000"]
    armed = tdpp.main(base + ["--integrity-every", "2", "--integrity-shadow", "--events-dir", str(tmp_path)])
    plain = tdpp.main(base)
    kinds = [json.loads(line)["kind"] for line in open(tmp_path / "timeline.jsonl")]
    assert kinds.count("sdc_check") == 3 and "sdc_detect" not in kinds
    assert armed["faults"]["sdc_checks"] == 3 and armed["faults"]["sdc_detects"] == 0
    assert armed["losses"] == plain["losses"]


# ------------------------------------------------------- the closed loop --

def test_flip_and_join_run_is_bitwise_its_control(runs):
    flip, ctl = _summary(runs.get("flip")), _summary(runs.get("control"))
    want = _hashes(runs.tmp / "ctl_ck")
    assert list(want) == ["hash_0.json", "hash_1.json"]
    assert _hashes(runs.tmp / "flip_ck") == want
    assert flip["world_size"] == ctl["world_size"] == 3 and flip["train_steps"] == ctl["train_steps"] == 10
    assert [r["new_size"] for r in flip["elastic"]["resizes"]] == [2, 3]
    np.testing.assert_array_equal(np.delete(flip["losses"], 2), np.delete(ctl["losses"], 2))
    assert np.isnan(ctl["losses"][2]) and np.isfinite(flip["losses"][2])


def test_flip_is_voted_out_evicted_and_taken_back(runs):
    out = runs.get("flip")
    recs = _timeline(runs.tmp / "flip_ev")
    kinds = [r["kind"] for r in recs]
    detects = [r for r in recs if r["kind"] == "sdc_detect"]
    assert detects and {(r["rank"], r["step"], r["method"], r["tie"], tuple(r["ranks"])) for r in detects} == {
        (2, 2, "vote", False, (2,))}
    assert {(r["rank"], r["step"]) for r in recs if r["kind"] == "sdc_evict"} == {(2, 2)}
    workers = [(r["old_size"], r["new_size"], tuple(r["left"]), tuple(r["joined"])) for r in recs
               if r["kind"] == "gang_resize" and r["proc"] != "supervisor"]
    assert sorted(set(workers)) == [(2, 3, (), ("proc2",)), (3, 2, ("proc2",), ())]
    assert workers.count((3, 2, ("proc2",), ())) == 2 and workers.count((2, 3, (), ("proc2",))) == 2  # survivors
    sup = [r for r in recs if r["proc"] == "supervisor"]
    assert [(r["kind"], r.get("joined")) for r in sup if r["kind"] == "gang_resize"] == [("gang_resize", ["proc2"])]
    verdict = next(r for r in sup if r["kind"] == "gang_verdict")
    assert (verdict["rung"], verdict["fault_kind"], verdict["fault"]) == ("resize", "worker-join", "worker-join@5:2")
    assert "restart_attempt" not in kinds
    # No checkpoint read: neither at the start, nor at the eviction, nor by the joiner.
    assert "resumed at" not in out and out.count("— no checkpoint read") == 2
    join = json.loads((runs.tmp / "flip_ev" / "gang" / "blobs" / "join-proc2").read_text())
    assert (join["rank"], join["world"], join["step"]) == (2, 3, 5)
    assert join["process_start_s"] > 0 and join["group_s"] >= 0 and join["transfer_s"] >= 0 and join["bytes"] > 0


def test_grow_is_bitwise_a_resume_at_the_grown_world(runs):
    runs.get("control")
    runs._resume.join(timeout=300)
    assert runs.resumed["start_epoch"] == 1 and runs.resumed["world_size"] == 3
    assert _hashes(runs.tmp / "res_ck")["hash_1.json"] == _hashes(runs.tmp / "ctl_ck")["hash_1.json"]


def test_two_rank_tie_is_resolved_by_the_replay(runs):
    out = runs.get("tie")
    recs = _timeline(runs.tmp / "tie_ev")
    detects = {(r["rank"], r["step"], r["method"], r["tie"]) for r in recs if r["kind"] == "sdc_detect"}
    assert detects == {(1, 4, "replay", False)}
    assert "elastic resize: 2 -> 1 replicas" in out and _summary(out)["world_size"] == 1
