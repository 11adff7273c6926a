"""The elastic gang on one host (``runtime/{rendezvous,elastic_gang}.py``,
``data.sharded.resize_index_plan``, ``dpp --elastic``, the supervisor's
resize rung) against the JAX package's, on the CPU.

- The rendezvous store: the same sequence of operations into the port's
  store and the reference's gives the same answers and the same epoch
  history (time stamps aside), over files and over the TCP front-end.
- The coordinator: a chaos kill, then ``poll`` agrees the shrunk roster on
  both packages' coordinators with the same decision; a roster below
  ``--min-procs`` is refused with the reference's message.
- ``resize_index_plan`` equals the reference's (numpy only, exact).
- The in-place shrink 4 -> 3 on 4 gloo processes (one member per
  process): a chaos ``worker-kill`` at a step boundary, the survivors'
  ``poll``, ``dpp.elastic_resize`` (the live state resharded over the old
  gang, the gang rebuilt, no checkpoint read) is bitwise the state
  ``elastic_restore`` gives at 3 ranks from a checkpoint of the same state
  (parameters, optimizer state, step), and the two continuations' next
  losses and parameters are bitwise equal; plain DP and ZeRO-1.
- The same shrink through ``dpp --elastic`` itself, killed mid-epoch
  (``worker-kill@1:2`` of 4 steps an epoch, dispatch depth 2): every
  survivor agrees one resize 4 -> 3 after step 1, the tail of the epoch
  and the next epoch run at 3, and the run exits 0.
- The supervised run ``--elastic --chaos worker-kill@4:2,preempt@4
  --max-restarts 1`` on 4 processes: the supervisor respawns the gang at 3
  without a restart, with exactly one ``gang_resize`` (4 -> 3) in the
  timeline and no ``restart_attempt``, and exits 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.data.sharded import resize_index_plan  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import elastic_gang as tgang  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import rendezvous as trdzv  # noqa: E402
from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

LM = ["--model", "gpt2", "--d-model", "32", "--layers", "2", "--seq-len", "16", "--vocab-size", "64",
      "--num-examples", "64", "--batch-size", "3", "--epochs", "1", "--optimizer", "adamw", "--lr", "1e-2"]
ROWS = 12  # the global batch: divisible by 4 and by 3


def _supervised_argv(tmp):
    return [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", "--device", "cpu", "--model", "mlp",
            "--fake-devices", "4", "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "8",
            "--num-examples", "128", "--elastic", "--chaos", "worker-kill@4:2,preempt@4", "--max-restarts", "1",
            "--checkpoint-dir", str(tmp / "ck"), "--events-dir", str(tmp / "ev")]


def _mid_epoch_argv(tmp):
    return [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", "--device", "cpu", "--model", "mlp",
            "--fake-devices", "4", "--batch-size", "4", "--epochs", "2", "--steps-per-epoch", "4",
            "--num-examples", "128", "--elastic", "--elastic-dir", str(tmp / "gang"), "--chaos", "worker-kill@1:2",
            "--dispatch-depth", "2", "--events-dir", str(tmp / "ev")]


def _background(tmp_path_factory, name, argv):
    """``argv(tmp)`` started at once, so that it overlaps the in-process
    cases; killed at the module's end."""
    tmp = tmp_path_factory.mktemp(name)
    env = {k: v for k, v in os.environ.items() if k not in ("_DDP_SUPERVISED", "DDP_ELASTIC_WORLD")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(argv(tmp), cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield proc, tmp
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def supervised(tmp_path_factory):
    """The supervised kill-and-preempt run."""
    yield from _background(tmp_path_factory, "supervised", _supervised_argv)


@pytest.fixture(scope="module")
def mid_epoch(tmp_path_factory):
    """The in-place shrink through ``dpp --elastic``, killed mid-epoch."""
    yield from _background(tmp_path_factory, "mid_epoch", _mid_epoch_argv)


# ---------------------------------------------------------- rendezvous --

def _ops(store, stale_error):
    """One sequence of store operations; every answer, in order."""
    out = []
    for m in ("w0", "w1", "w2", "w3"):
        store.join(m)
    out.append(store.alive())
    out.append(store.epoch())
    out.append(store.propose(store.alive(), epoch=0))
    store.mark_dead("w2")
    store.leave("w3")
    out += [store.alive(), store.dead(), store.roster()]
    store.ack(1, "w1")
    out.append(store.transition("w0", timeout_s=10.0))
    out.append(store.propose(["w0", "w1"], epoch=1))  # the same epoch again: the first write stands
    try:
        store.propose(["w0"], epoch=0)
        out.append("not fenced")
    except stale_error as e:
        out.append(str(e))
    store.put_blob("rank:0", "w0")
    out += [store.get_blob("rank:0"), store.get_blob("rank:9")]
    store.join("w2")
    out += [store.alive(), store.dead(), store.history()]
    return _no_ts(out)


def _no_ts(x):
    if isinstance(x, dict):
        return {k: _no_ts(v) for k, v in x.items() if k != "ts"}
    if isinstance(x, (list, tuple)):
        return [_no_ts(v) for v in x]
    return x


@pytest.mark.parametrize("transport", ["files", "tcp"])
def test_rendezvous_store_answers_as_the_references(tmp_path, transport, supervised, mid_epoch, shrink):
    # supervised, mid_epoch, shrink: the subprocesses and the pool work meanwhile
    from distributeddataparallel_tpu.runtime import rendezvous as jrdzv

    got = {}
    for name, mod in (("port", trdzv), ("ref", jrdzv)):
        store = mod.RendezvousStore(str(tmp_path / name))
        if transport == "files":
            got[name] = _ops(store, mod.RendezvousFencedError)
            continue
        with mod.TCPRendezvousServer(store) as srv, mod.TCPRendezvousClient(srv.address) as client:
            got[name] = _ops(client, RuntimeError)
    assert got["port"] == got["ref"]
    assert got["port"][3] == ["w0", "w1"] and "fenced" in got["port"][-6]


# --------------------------------------------------------- coordinator --

def test_coordinator_kill_poll_decision_and_min_procs(tmp_path):
    """The reference's coordinator test, on both packages' coordinators:
    the same decision, and the same refusal below ``--min-procs``."""
    from distributeddataparallel_tpu.runtime import elastic_gang as jgang

    seen = {}
    for name, mod in (("port", tgang), ("ref", jgang)):
        world = [f"proc{i}" for i in range(4)]
        gang = mod.ElasticGangCoordinator(str(tmp_path / name), world=world, min_size=1)
        rec = gang.start()
        assert rec["epoch"] == 0 and rec["roster"] == sorted(world)
        assert gang.poll() is None  # stable membership: a cheap no-op
        gang.kill("2")  # the chaos rank-index form: proc2
        decision = gang.poll()
        assert gang.poll() is None
        gang.kill("proc0")
        with pytest.raises(RuntimeError, match="below --min-procs 3; falling back to gang restart"):
            mod.ElasticGangCoordinator(str(tmp_path / name), world=["proc1", "proc3"], min_size=3).poll()
        seen[name] = decision
    assert seen["port"].__dict__ == seen["ref"].__dict__
    d = seen["port"]
    assert (d.epoch, d.left, d.joined, d.old_size, d.new_size) == (1, ("proc2",), (), 4, 3)


@pytest.mark.parametrize("old_world,new_world,consumed_steps,membership_epoch",
                         [(8, 7, 3, 1), (8, 7, 0, 2), (4, 3, 5, 1), (4, 6, 2, 1)])
def test_resize_plan_is_the_references(old_world, new_world, consumed_steps, membership_epoch):
    from distributeddataparallel_tpu.data.sharded import resize_index_plan as jplan

    kw = dict(per_replica_batch=4, old_world=old_world, new_world=new_world, consumed_steps=consumed_steps,
              seed=7, epoch=2, membership_epoch=membership_epoch)
    got, want = resize_index_plan(256, **kw), jplan(256, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape and (got == want).all()
    assert got.shape[0] == new_world and len(set(got.ravel().tolist())) == got.size


# ------------------------------------------------------ in-place shrink --

def _batches():
    rng = np.random.default_rng(11)
    return [torch.from_numpy(rng.integers(0, 64, size=(ROWS, 17))) for _ in range(3)]


def _step(trainer, tokens, rank, world) -> float:
    rows = ROWS // world
    return float(trainer.step_fn(trainer.state, {"tokens": tokens[rank * rows : (rank + 1) * rows]})["loss"])


def _state(trainer) -> dict:
    """Parameters, optimizer state and step: copies."""
    opt = trainer.state.optimizer.state_dict()
    tensors = {f"opt/{i}/{k}": v.clone() for i, st in opt["state"].items() for k, v in st.items()
               if isinstance(v, torch.Tensor)}
    return {"model": {k: v.clone() for k, v in trainer.state.model.state_dict().items()}, "opt": tensors,
            "lr": [g["lr"] for g in opt["param_groups"]], "step": trainer.state.step}


def _shrink(zero, rank, world, directory):
    """4 ranks, 2 steps, a checkpoint, then the chaos kill of member 2 and
    the in-place resize; on the survivors the live state against the
    checkpoint restored at 3 ranks, and one more step on each."""
    d = Path(directory) / f"zero{zero}"
    args = tdpp.parse_args(["--device", "cpu", *LM, *(["--zero", "1"] if zero else []), "--elastic",
                            "--elastic-dir", str(d / "gang"), "--checkpoint-dir", str(d / "ck"),
                            "--chaos", "worker-kill@2:2"])
    cpu = torch.device("cpu")
    t = tdpp.build_trainer(args, cpu, rank, world)
    b = _batches()
    for x in b[:2]:
        _step(t, x, rank, world)
    payload = host_payload(t.state, 0)
    if rank == 0:
        CheckpointFiles(str(d / "ck")).write(t.state, 0, payload)
    tel = tdpp.build_telemetry(args, t, cpu, rank, world)
    faults = tdpp.build_faults(args, t.state, tel, rank, world)
    rt.barrier()  # every member has joined the epoch before the kill (the loop's injector.sync barriers too)
    faults.injector.before_step(2)
    faults.injector.after_step(2)
    c = faults.gang.coordinator
    decision = c.await_departure() if c.leaving() else c.poll()
    tail = tdpp.elastic_resize(args, t, cpu, tel, lambda *a: None, faults.gang, decision, 0, 2)
    if tail is None:
        return {"left": True, "rank": rank}
    new_rank, new_world = faults.gang.rank, faults.gang.world
    fresh = tdpp.build_trainer(args, cpu, new_rank, new_world)
    CheckpointFiles.load_into(fresh.state, CheckpointFiles(str(d / "ck")).read(0))
    live, restored = _state(t), _state(fresh)
    losses = [_step(x, b[2], new_rank, new_world) for x in (t, fresh)]
    return {"left": False, "rank": new_rank, "world": new_world, "live": live, "restored": restored,
            "losses": losses, "after": [_state(x)["model"] for x in (t, fresh)],
            "order": faults.gang.order}


def _worker(rank, world, stores, out_dir):
    torch.set_num_threads(1)
    # ZeRO shards stepped in pieces of 4096 elements: the piece count
    # differs between 4 ranks and fewer, as at GPT-2 124M's width.
    from distributeddataparallel_tpu_torch.parallel import zero

    zero.MAX_PIECE = 4096
    res = {}
    for zero, store in zip((0, 1), stores):  # each case's gang forms on a launcher-like store of its own
        rt.init_process_group(store_address=store, world_size=world, rank=rank, device="cpu")
        res[zero] = _shrink(zero, rank, world, out_dir)
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


class _Pool:
    """``_worker`` on 4 gloo processes, started at once; ``get()`` waits
    for them and returns each rank's results."""

    def __init__(self, out):
        import torch.distributed as dist
        import torch.multiprocessing as mp

        self.out = out
        self.hosts = [dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False) for _ in range(2)]
        self.ctx = mp.spawn(_worker, args=(4, [f"127.0.0.1:{h.port}" for h in self.hosts], str(out)), nprocs=4,
                            join=False)
        self.results = None

    def get(self) -> list[dict]:
        if self.results is None:
            while not self.ctx.join():
                pass
            self.results = [torch.load(self.out / f"rank{r}.pt", weights_only=False) for r in range(4)]
        return self.results


@pytest.fixture(scope="module")
def shrink(tmp_path_factory, supervised):
    pool = _Pool(tmp_path_factory.mktemp("shrink"))
    yield pool
    pool.get()  # no rank outlives the module


def _bitwise(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (what, k)
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs"


@pytest.mark.parametrize("zero", [0, 1], ids=["dp", "zero1"])
def test_in_place_shrink_is_bitwise_the_checkpoint_restore(shrink, zero):
    results = [r[zero] for r in shrink.get()]
    assert [r["left"] for r in results] == [False, False, True, False]
    assert sorted(r["rank"] for r in results if not r["left"]) == [0, 1, 2]
    for r in results:
        if r["left"]:
            continue
        assert r["world"] == 3 and r["order"] == ["proc0", "proc1", "proc3"]
        _bitwise(r["live"]["model"], r["restored"]["model"], "params")
        _bitwise(r["live"]["opt"], r["restored"]["opt"], "optimizer state")
        assert r["live"]["lr"] == r["restored"]["lr"] and r["live"]["step"] == r["restored"]["step"] == 2
        assert r["losses"][0] == r["losses"][1]
        _bitwise(r["after"][0], r["after"][1], "params after the next step")


def test_supervised_worker_kill_resizes_without_restart(supervised):
    proc, tmp = supervised
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out[-3000:]
    assert "elastic resize-respawn, restart budget untouched (0/1 used)" in out, out[-3000:]
    records = [json.loads(line) for line in open(tmp / "ev" / "timeline.jsonl")]
    kinds = [r.get("kind") for r in records]
    assert kinds.count("gang_resize") == 1 and "restart_attempt" not in kinds, kinds
    resize = next(r for r in records if r["kind"] == "gang_resize")
    assert (resize["old_size"], resize["new_size"], resize["left"]) == (4, 3, ["proc2"])
    assert "resize_downtime" in kinds
    verdict = next(r for r in records if r["kind"] == "gang_verdict")
    assert verdict["rung"] == "resize" and verdict["fault_kind"] == "preempt"
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["world_size"] == 3 and summary["train_steps"] > 0


def test_mid_epoch_worker_kill_shrinks_in_place(mid_epoch):
    proc, tmp = mid_epoch
    out, _ = proc.communicate(timeout=240)
    assert proc.returncode == 0, out[-3000:]
    records = [json.loads(line) for line in open(tmp / "ev" / "timeline.jsonl")]
    kills = sorted(r["proc"] for r in records if r.get("kind") == "chaos_inject" and r["step"] == 1)
    assert kills == [0, 1, 2, 3]  # every rank fired the kill after step 1
    resizes = [r for r in records if r.get("kind") == "gang_resize"]
    assert sorted(r["proc"] for r in resizes) == [0, 1, 3], resizes  # each survivor once, the leaver not
    assert {(r["epoch"], r["old_size"], r["new_size"], tuple(r["left"])) for r in resizes} == {(1, 4, 3, ("proc2",))}
    summary = json.loads(out.strip().splitlines()[-1])
    # 2 steps at 4, the epoch's other 2 at 3, then epoch 1's 4 at 3.
    assert summary["world_size"] == 3 and summary["train_steps"] == 8
    assert summary["elastic"]["resizes"][0]["old_size"] == 4 and len(summary["elastic"]["resizes"]) == 1
    assert all(np.isfinite(summary["losses"]))
