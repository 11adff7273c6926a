"""The port's bounded dispatch, guard on the device and kernel build cache
(``training/warm_start.py``, ``dpp._loop``, ``training/train_step.py``)
against the JAX package's, on the CPU.

- ``BoundedDispatch`` hands back the reference class's handles on the same
  push/drain script, at depths 0 to 3.
- The loop at ``--dispatch-depth`` 0, 2 and 4 gives the same losses, the
  same parameters and the same checkpoint files, bit for bit (tiny GPT-2,
  ``cnn``); at depth 2 the device is synchronised at drains only.
- The guard on a ``--chaos nan-grad@1`` run at depth 2 (a narrow ResNet, so
  BatchNorm buffers are in the state; AdamW with warmup and cosine) against
  the reference's ``make_train_step(nonfinite_guard=True)``: losses,
  parameters, buffers and AdamW's moments within f32 atol 2e-5 / rtol 1e-4
  (the same arithmetic in XLA's and torch's convolution and reduction
  orders, as ``test_torch_image_train.py`` holds them), the schedule's
  count equal to optax's; and bit for bit the port's own depth-0 run.
- The breaker trips within K steps of the poisoned step at depth K; an
  isolated NaN survives depth 2 bit for bit as at depth 0.
- ``--zero 2 --moment-dtype int8`` and PowerSGD under the guard on 2 gloo
  ranks: a NaN on one rank skips the step on both, leaving the int8
  moments, PowerSGD's error feedback and Q factors, the parameters and the
  schedule's count bitwise as they were.
- A guarded run with no nonfinite step is the unguarded run bit for bit
  (one fused update for both); a guarded checkpoint resumes into an
  unguarded run and the reverse, bit for bit.
- The build cache with the g++ host-kernel build: a miss, then a hit, a
  corrupted library rebuilt loudly, and a launcher child inheriting
  ``DDP_COMPILE_CACHE``.
- The loader's ``loader_starved`` event and ``prefetch_depth`` against the
  reference loader's on the same slow dataset.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch import native  # noqa: E402
from distributeddataparallel_tpu_torch.data.loader import DataLoader  # noqa: E402
from distributeddataparallel_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.observability import read_events  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import launcher  # noqa: E402
from distributeddataparallel_tpu_torch.training import checkpoint as ck  # noqa: E402
from distributeddataparallel_tpu_torch.training import fault_tolerance as ft  # noqa: E402
from distributeddataparallel_tpu_torch.training import warm_start as ws  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

LM = ["--device", "cpu", "--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16",
      "--vocab-size", "64", "--num-examples", "32", "--batch-size", "4", "--optimizer", "adamw",
      "--lr", "1e-2", "--log-every", "1000"]
CNN = ["--device", "cpu", "--model", "cnn", "--num-examples", "48", "--batch-size", "8", "--log-every", "1000",
       "--momentum", "0.9"]
MLP = ["--device", "cpu", "--model", "mlp", "--num-examples", "64", "--batch-size", "4", "--epochs", "1",
       "--steps-per-epoch", "8", "--log-every", "1000"]
ADAMW = ["--device", "cpu", "--optimizer", "adamw", "--lr", "0.01", "--weight-decay", "0.01",
         "--lr-schedule", "cosine", "--warmup-steps", "2"]
TOL = dict(atol=2e-5, rtol=1e-4)


def _state_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------ dispatch --

def test_bounded_dispatch_is_the_references():
    from distributeddataparallel_tpu.training.warm_start import BoundedDispatch as Ref

    script = ["push"] * 5 + ["drain"] + ["push"] * 3 + ["drain", "drain"] + ["push"] * 2 + ["drain"]
    for depth in range(4):
        mine, ref = ws.BoundedDispatch(depth), Ref(depth)
        for i, op in enumerate(script):
            got = mine.push(i, ("meta", i)) if op == "push" else mine.drain()
            want = ref.push(i, ("meta", i)) if op == "push" else ref.drain()
            assert got == want and len(mine) == len(ref), (depth, i)
    for cls in (ws.BoundedDispatch, Ref):
        with pytest.raises(ValueError, match="dispatch depth"):
            cls(-1)


@pytest.mark.parametrize("flags", [LM, CNN], ids=["gpt2", "cnn"])
def test_depths_are_bitwise_equal(flags, tmp_path):
    """Losses, parameters and the checkpoint files at depths 0, 2 and 4."""
    runs = {}
    for depth in (0, 2, 4):
        d = tmp_path / f"d{depth}"
        s = tdpp.main(flags + ["--epochs", "2", "--steps-per-epoch", "3", "--dispatch-depth", str(depth),
                               "--checkpoint-dir", str(d)])
        files = {e: ck.CheckpointFiles(str(d)).read(e) for e in (0, 1)}
        runs[depth] = (s["losses"], s["param_norm"], {e: ck.state_content_hash(p) for e, p in files.items()},
                       files[1]["model"])
        assert s["dispatch_depth"] == depth and len(s["losses"]) == 6
    for depth in (2, 4):
        assert runs[depth][:3] == runs[0][:3]
        assert _state_equal(runs[depth][3], runs[0][3])


def test_sync_only_at_drains(monkeypatch):
    """At depth 2 the device is synchronised at the drains alone (the first
    step, the last step's log line, the epoch's edge); at depth 0 also
    after every step."""
    calls = []
    monkeypatch.setattr(tdpp, "_sync", lambda device: calls.append(1))
    counts = {}
    for depth in (0, 2):
        calls.clear()
        tdpp.main(MLP + ["--dispatch-depth", str(depth)])
        counts[depth] = len(calls)
    assert counts == {2: 3, 0: 8 + 3}


# --------------------------------------------------------------- guard --

class _Rows:
    """64 seeded 8x8x3 images: the loader's dataset for both packages."""

    def __init__(self):
        rng = np.random.default_rng(11)
        self.a = {"image": rng.normal(size=(64, 8, 8, 3)).astype(np.float32),
                  "label": rng.integers(0, 10, size=64).astype(np.int32)}

    def __len__(self):
        return 64

    def arrays(self):
        return self.a


def _narrow_resnet():
    return tresnet.ResNet(block_cls=tresnet.BasicBlock, stage_sizes=(1, 1), num_classes=10, num_filters=4,
                          stem="cifar", generator=torch.Generator().manual_seed(1))


def _port_guarded(depth: int, steps: int):
    args = tdpp.parse_args(ADAMW + ["--nan-guard", "--chaos", "nan-grad@1", "--dispatch-depth", str(depth),
                                    "--epochs", "1", "--log-every", "1000"])
    model = _narrow_resnet()
    state = TrainState(model, *build_optimizer(args, model.parameters(), steps))
    loader = DataLoader(_Rows(), per_replica_batch=8, shuffle=True, seed=0, drop_last=True)
    trainer = tdpp.Trainer(state=state, step_fn=make_train_step(tdpp._image_loss_fn, nonfinite_guard=True),
                           loader=loader, steps_per_epoch=steps)
    summary = tdpp.train(args, trainer, torch.device("cpu"))
    return summary, state


def test_guard_matches_the_reference_skip_and_depth_0():
    import jax
    import jax.numpy as jnp
    import optax

    import dpp as jdpp
    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.models import resnet as jresnet
    from distributeddataparallel_tpu.ops import accuracy as j_acc
    from distributeddataparallel_tpu.ops import cross_entropy_loss as j_ce
    from distributeddataparallel_tpu.utils import chaos as jchaos

    steps = 4
    summary, state = _port_guarded(2, steps)
    _, plain = _port_guarded(0, steps)
    assert summary["faults"]["nonfinite_steps"] == 1 and np.isnan(summary["losses"][1])
    assert _state_equal(state.model.state_dict(), plain.model.state_dict())
    for p, q in zip(state.optimizer.state.values(), plain.optimizer.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in p)

    tm = _narrow_resnet()
    v = to_jax_params(tm.state_dict(), tm)
    ms = {k: x for k, x in v.items() if k != "params"}
    jm = jresnet.ResNet(block_cls=jresnet.BasicBlock, stage_sizes=(1, 1), num_classes=10, num_filters=4,
                        stem="cifar")

    def jloss(params, ms, batch, rng):
        logits, new = jm.apply({"params": params, **ms}, batch["image"], train=True, mutable=list(ms))
        return j_ce(logits, batch["label"]), ({"accuracy": j_acc(logits, batch["label"])}, new)

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jstate = ddp.broadcast_params(ddp.TrainState.create(
        apply_fn=jm.apply, params=v["params"], tx=jdpp.build_optimizer(jdpp.parse_args(ADAMW), total_steps=steps),
        model_state=ms), mesh)
    jstep = ddp.make_train_step(jloss, mesh=mesh, with_model_state=True, nonfinite_guard=True, donate=False)
    loader = DataLoader(_Rows(), per_replica_batch=8, shuffle=True, seed=0, drop_last=True)
    loader.set_epoch(0)
    inj, jlosses = jchaos.FaultInjector("nan-grad@1"), []
    for i, b in zip(range(steps), loader):
        batch = inj.corrupt_batch({"image": jnp.asarray(b["image"].numpy()),
                                   "label": jnp.asarray(b["label"].numpy().astype(np.int32))}, i)
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(0))
        jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(summary["losses"], jlosses, **TOL)  # NaN at step 1 on both
    jms = jax.tree.map(np.asarray, jstate.model_state)
    want = from_jax_params({"params": jax.tree.map(np.asarray, jstate.params), **jms}, tm)
    got = state.model.state_dict()
    assert any("running_var" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **TOL)
    names = {id(p): n for n, p in state.model.named_parameters()}
    for key, torch_key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        (tree,) = [t for _, t in optax.tree_utils.tree_get_all_with_path(jstate.opt_state, key)]
        moments = from_jax_params({"params": jax.tree.map(np.asarray, tree), **jms}, tm)
        for p, st in state.optimizer.state.items():
            np.testing.assert_allclose(st[torch_key].numpy(), moments[names[id(p)]].numpy(),
                                       err_msg=f"{key} {names[id(p)]}", **TOL)
    counts = {int(c) for _, c in optax.tree_utils.tree_get_all_with_path(jstate.opt_state, "count")}
    assert counts == {steps - 1} and state.scheduler.last_epoch == steps - 1
    assert {int(s["step"]) for s in state.optimizer.state.values()} == {steps - 1}
    assert int(jstate.step) == state.step == steps


def test_breaker_trips_within_k_steps(monkeypatch):
    """Poisoned steps 1 and 2 with ``--max-bad-steps 2``: the breaker reads
    step 2's flag when it leaves the window, K steps later, so 3 + K steps
    were dispatched when the run stops."""
    dispatched = []
    real = tdpp.build_trainer

    def counting(*a, **kw):
        tr = real(*a, **kw)
        step = tr.step_fn
        tr.step_fn = lambda *x: (dispatched.append(1), step(*x))[1]
        return tr

    monkeypatch.setattr(tdpp, "build_trainer", counting)
    for depth in (0, 2, 4):
        dispatched.clear()
        with pytest.raises(ft.TrainingDiverged, match="2 consecutive"):
            tdpp.main(MLP + ["--nan-guard", "--max-bad-steps", "2", "--chaos", "nan-grad@1,nan-grad@2",
                             "--dispatch-depth", str(depth)])
        assert len(dispatched) == 3 + depth


def test_an_isolated_nan_survives_at_depth_2(tmp_path):
    runs = {}
    for depth in (0, 2):
        ev = tmp_path / f"ev{depth}"
        s = tdpp.main(MLP + ["--nan-guard", "--chaos", "nan-grad@3", "--dispatch-depth", str(depth),
                             "--events-dir", str(ev)])
        skips = [(r["epoch"], r["batch"]) for r in read_events(str(ev / "timeline.jsonl"))
                 if r["kind"] == "nan_skip"]
        runs[depth] = (s["losses"], s["param_norm"], s["faults"]["nonfinite_steps"], skips)
    assert runs[2][2:] == runs[0][2:] == (1, [(0, 3)])
    assert np.isnan(runs[2][0][3]) and np.isfinite(np.delete(runs[2][0], 3)).all()
    np.testing.assert_array_equal(runs[2][0], runs[0][0])
    assert runs[2][1] == runs[0][1]


def test_guarded_run_without_a_bad_step_is_the_unguarded_run(tmp_path):
    """One update kind for both: ``build_optimizer`` builds the fused AdamW
    guarded or not, and ``DeviceSchedule``'s float64 LR rounds as
    ``LambdaLR``'s Python float, so a guarded run with no nonfinite step is
    the unguarded run bit for bit (losses, parameters, moments, steps), as
    the reference's guard selects the unguarded update."""
    base = ["--device", "cpu", "--model", "mlp", "--num-examples", "64", "--batch-size", "4",
            "--steps-per-epoch", "4", "--epochs", "2", "--log-every", "1000", "--optimizer", "adamw",
            "--weight-decay", "0.01", "--warmup-steps", "5"]
    runs = {}
    for name, extra in (("plain", []), ("guarded", ["--nan-guard"])):
        d = tmp_path / name
        s = tdpp.main(base + extra + ["--checkpoint-dir", str(d)])
        runs[name] = (s, ck.CheckpointFiles(str(d)).read(1))
    (plain, p_ck), (guarded, g_ck) = runs["plain"], runs["guarded"]
    assert guarded["faults"]["nonfinite_steps"] == 0
    np.testing.assert_array_equal(guarded["losses"], plain["losses"])
    assert g_ck["scheduler"]["last_epoch"] == p_ck["scheduler"]["last_epoch"] == 8
    for key in ("model", "optimizer"):
        flat_p, flat_g = _tensors(p_ck[key]), _tensors(g_ck[key])
        assert flat_p.keys() == flat_g.keys() and flat_p
        for k in flat_p:
            torch.testing.assert_close(flat_g[k], flat_p[k], rtol=0, atol=0, msg=f"{key} {k}")


def _tensors(tree, prefix="") -> dict:
    """Every tensor of a nested state dict by its path."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {}
    return {k: v for key, sub in items for k, v in _tensors(sub, f"{prefix}/{key}").items()}


def test_guarded_checkpoint_resumes_unguarded_and_back(tmp_path):
    """A guarded run's checkpoint (the device count saved as ``LambdaLR``'s
    ``last_epoch``: 7 of 8 steps applied) resumes into an unguarded run,
    and an unguarded one's into a guarded run; each resumed epoch equals
    the uninterrupted run's bit for bit (one fused update on both sides)."""
    # A warmup over 10 of the 12 steps: the resumed steps' LR is the saved
    # count's (a decay would also depend on --epochs, which the resume moves).
    base = ["--device", "cpu", "--model", "mlp", "--num-examples", "64", "--batch-size", "4",
            "--steps-per-epoch", "4", "--log-every", "1000", "--optimizer", "adamw", "--warmup-steps", "10"]
    guarded = ["--nan-guard", "--chaos", "nan-grad@1"]
    for first, then, applied in ((guarded, [], 7), ([], guarded, 8)):
        d = tmp_path / ("g" if first else "u")
        straight = tdpp.main(base + first + ["--epochs", "3"])
        tdpp.main(base + first + ["--epochs", "2", "--checkpoint-dir", str(d)])
        saved = ck.CheckpointFiles(str(d)).read(1)
        assert saved["scheduler"]["last_epoch"] == applied and saved["step"] == 8
        assert isinstance(saved["optimizer"]["param_groups"][0]["lr"], float)
        resumed = tdpp.main(base + then + ["--epochs", "3", "--checkpoint-dir", str(d), "--resume"])
        assert resumed["start_epoch"] == 2
        np.testing.assert_array_equal(resumed["losses"], straight["losses"][8:])


# --------------------------------------------------- two gloo ranks, guard --

GUARD_CASES = {"zero2_int8": ["--zero", "2", "--moment-dtype", "int8"],
               "powersgd": ["--grad-compress", "powersgd", "--powersgd-rank", "2"]}


def _guard_rank(rank: int, world: int, extra: list[str]) -> dict:
    """Three guarded steps of a tiny GPT-2 whose loss is NaN on rank 1 at
    step 1: the state before and after the skipped step."""
    args = tdpp.parse_args(LM + ["--num-examples", "64", "--nan-guard"] + extra)
    trainer = tdpp.build_trainer(args, torch.device("cpu"), rank, world)
    state, calls = trainer.state, []

    def loss_fn(model, batch, **kw):
        loss, aux = tdpp._loss_fn(model, batch)
        calls.append(None)
        return (loss * float("nan") if rank == 1 and len(calls) == 2 else loss), aux

    step = make_train_step(loss_fn, nonfinite_guard=True, zero=args.zero, grad_compress=args.grad_compress)

    def snap():
        moments = state.moments.state_dict()["packed"] if state.moments is not None else {}
        return {"params": [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]],
                "packed": {(i, k): (v["q"].clone(), v["scale"].clone()) if isinstance(v, dict) else v.clone()
                           for i, d in moments.items() for k, v in d.items()},
                "opt": [{k: v.clone() for k, v in s.items()} for s in state.optimizer.state.values()],
                "comm": [None if s is None else (s.q.clone(), s.err.clone()) for s in state.comm_state or []],
                "count": int(state.scheduler.count)}

    trainer.loader.set_epoch(0)
    out = {"flags": []}
    for i, b in zip(range(3), trainer.loader):
        if i == 1:
            out["before"] = snap()
        out["flags"].append(float(step(state, b)["nonfinite_grad"]))
        if i == 1:
            out["after"] = snap()
    out["count"] = int(state.scheduler.count)
    return out


def _guard_worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: _guard_rank(rank, world, extra) for name, extra in GUARD_CASES.items()}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_guard_on_two_ranks_keeps_low_bit_moments_and_powersgd(tmp_path):
    import torch.multiprocessing as mp

    mp.spawn(_guard_worker, args=(2, f"127.0.0.1:{rt.free_port()}", str(tmp_path)), nprocs=2, join=True)
    for rank in range(2):
        res = torch.load(tmp_path / f"rank{rank}.pt", weights_only=False)
        for name, r in res.items():
            assert r["flags"] == [0.0, 1.0, 0.0], (name, rank)
            assert _same(r["before"], r["after"]), (name, rank)  # bitwise, every piece of the state
            assert r["after"]["count"] == 1 and r["count"] == 2
        assert res["zero2_int8"]["before"]["packed"] and res["powersgd"]["before"]["comm"]


# ------------------------------------------------------- compile cache --

@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A fresh compile cache for this test; the process's own state put
    back after it."""
    monkeypatch.setattr(ws, "_cache_dir", None)
    monkeypatch.setenv(ws.ENV, "")
    monkeypatch.setattr(ws, "STATS", ws.CompileCacheStats())
    monkeypatch.setattr(native, "_lib", None)
    return Path(ws.enable_compile_cache(str(tmp_path / "cc")))


class _Warnings:
    def __init__(self):
        self.lines = []

    def warning(self, msg, *a):
        self.lines.append(msg % a)


def test_compile_cache_miss_hit_and_loud_rebuild(cache, monkeypatch):
    warned = _Warnings()
    monkeypatch.setattr(ws, "get_logger", lambda: warned)
    so = native.build()
    assert so.parent == cache / "build" and (ws.STATS.hits, ws.STATS.misses) == (0, 1)
    assert ws.warm_start_mode() == "cold"
    ws.STATS.reset()  # as a fresh process sees the cache
    assert native.build() == so and (ws.STATS.hits, ws.STATS.misses) == (1, 0)
    assert ws.warm_start_mode() == "cache-hit"
    # Truncated, as a fresh process would find it (a new file: this one
    # keeps the old library mapped).
    cut = so.with_name("cut.so")
    cut.write_bytes(so.read_bytes()[:4096])
    cut.replace(so)
    assert native.build() == so
    assert len(warned.lines) == 1 and "do not match the digest" in warned.lines[0]
    assert (ws.STATS.hits, ws.STATS.misses) == (1, 1)
    assert native.gather_rows(np.arange(12, dtype=np.float32).reshape(4, 3), np.array([2, 0]))[0, 0] == 6.0
    ws.STATS.reset()
    assert native.build() == so and ws.STATS.hits == 1


def _child_builds(i, nprocs, store_address, out):
    so = native.build()
    Path(out).write_text(ck.json.dumps({"root": str(ws.build_root()), "so": str(so), "hits": ws.STATS.hits,
                                        "misses": ws.STATS.misses, "mode": ws.warm_start_mode()}))


def test_launcher_child_inherits_the_compile_cache(cache, tmp_path):
    parent = native.build()
    out = tmp_path / "child.json"
    t0 = time.perf_counter()
    launcher.spawn(_child_builds, args=(str(out),), nprocs=1)
    child = ck.json.loads(out.read_text())
    assert child == {"root": str(cache / "build"), "so": str(parent), "hits": 1, "misses": 0, "mode": "cache-hit"}
    assert time.perf_counter() - t0 < 120


# -------------------------------------------------------------- loader --

class _Slow:
    """A dataset whose every gather takes 20 ms: the consumer outruns the
    producer."""

    def __init__(self, n):
        self.images = np.zeros((n, 4), np.float32)
        self.labels = np.zeros((n,), np.int64)

    def __len__(self):
        return len(self.images)

    def arrays(self):
        time.sleep(0.02)
        return {"image": self.images, "label": self.labels}


class _Events:
    def __init__(self):
        self.records = []

    def emit(self, kind, **fields):
        self.records.append((kind, fields))


def test_loader_starvation_events_are_the_references(monkeypatch):
    from distributeddataparallel_tpu.data import DataLoader as RefLoader
    from distributeddataparallel_tpu.runtime.distributed import make_mesh
    from distributeddataparallel_tpu.utils import logging as jlogging
    from distributeddataparallel_tpu_torch.data import loader as tloader

    warned = {"ref": [], "port": []}
    monkeypatch.setattr(jlogging, "warn_all", lambda msg, *a: warned["ref"].append(msg % a))
    monkeypatch.setattr(tloader, "warn_all", lambda msg, *a: warned["port"].append(msg % a))
    ref = RefLoader(_Slow(16), per_replica_batch=1, mesh=make_mesh(("data",)), shuffle=False, workers=1,
                    starvation_window=2)
    port = DataLoader(_Slow(16), per_replica_batch=1, shuffle=False, workers=True, starvation_window=2)
    seen = {}
    for name, loader in (("ref", ref), ("port", port)):
        loader.events = _Events()
        assert loader.prefetch_depth == 0  # no iteration active
        depths = [loader.prefetch_depth for _ in loader]
        assert all(isinstance(d, int) and d >= 0 for d in depths) and loader.prefetch_depth == 0
        seen[name] = loader.events.records
    assert seen["port"] == seen["ref"] == [("loader_starved", {"window": 2, "epoch": 0})]
    assert warned["port"] == warned["ref"] and len(warned["port"]) == 1
