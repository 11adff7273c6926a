"""The comm hooks under context parallelism (``--cp 2 --overlap``, ``--cp 2
--grad-compress powersgd``) against the JAX package's, on the CPU.

Four gloo ranks (data 2 x seq 2) are spawned once for the file; every case
reads what they computed.  The JAX side runs the reference's
``make_train_step(cp_axis="seq", overlap=... | grad_compress="powersgd")``
on 4 of its fake CPU devices on the same mesh, from the port's seeded
initial weights and the reference loader's batches (as
``test_torch_context_parallel.py`` does), GPT-2 in f32.

- ``--overlap``: the port launches each bucket's mean over the joint
  data x seq group from backward's hooks; the reference means over ``seq``
  and then over ``data``.  Over 3 SGD steps the losses agree within 1e-5
  and every parameter within 1e-5 of the reference's (f32; the joint sum
  adds the four ranks' values in another order than the two-step mean).
- PowerSGD: the reference's order (the seq mean, then the low-rank factors
  over the data group), from the reference's initial q: losses and
  parameters within the same bounds (the factors' f32 matmuls and QR in
  another order, three rounds), and every rank's error-feedback residual
  the reference's residual of its data position (atol 2e-5, rtol 1e-4, as
  ``test_torch_comm_hooks.py`` holds one PowerSGD round).
- Every bucket launches inside backward (none after).
- ``--nan-guard`` with ``--overlap``: a NaN in one seq rank's loss at step
  2 makes every rank skip the step (the verdict after the seq mean), the
  parameters unchanged across it and equal on every rank.
"""

import dataclasses
import functools
import itertools
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import overlap as tov  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.powersgd import PowerSGDLeaf  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture


@functools.cache
def ref():
    """The JAX side, imported here and not at the top: the gloo ranks
    import this module and need torch only."""
    import jax

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp  # the reference entry point
    from distributeddataparallel_tpu.data.loader import DataLoader, shard_lm_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import accuracy, lm_cross_entropy
    from distributeddataparallel_tpu.parallel import powersgd as jps

    return SimpleNamespace(jax=jax, ddp=ddp, jdpp=jdpp, DataLoader=DataLoader, shard_lm_batch=shard_lm_batch,
                           jtfm=jtfm, accuracy=accuracy, lm_ce=lm_cross_entropy, jps=jps)


WORLD, STEPS = 4, 3
LM = ["--model", "gpt2", "--layers", "2", "--d-model", "64", "--seq-len", "16", "--vocab-size", "256",
      "--num-examples", "32", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", str(STEPS),
      "--optimizer", "sgd", "--lr", "0.1", "--cp", "2"]
RUNS = {"overlap": LM + ["--overlap", "--bucket-mb", "0.01"],
        "powersgd": LM + ["--grad-compress", "powersgd", "--powersgd-rank", "2"]}
F32_ATOL = 1e-5
PSGD_TOL = dict(atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------- rank side --

def _params(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_flags(flags, rank, world, q0=None) -> dict:
    """``STEPS`` steps of the port's trainer for ``flags`` on this rank;
    PowerSGD from the reference's initial factors ``q0``."""
    args = tdpp.parse_args(["--device", "cpu", *flags])
    trainer = tdpp.build_trainer(args, torch.device("cpu"), rank, world)
    state = trainer.state
    if q0 is not None:
        state.comm_state = [None if s is None else PowerSGDLeaf(q=torch.from_numpy(q), err=s.err)
                            for s, q in zip(state.comm_state, q0)]
    trainer.loader.set_epoch(0)
    tov.reset_counts()
    losses = [float(trainer.step_fn(state, b)["loss"]) for b in itertools.islice(trainer.loader, STEPS)]
    out = {"losses": losses, "params": _params(state.model), "buckets": dict(tov.COUNTS),
           "coords": dict(rt.current_mesh().coords)}
    if state.comm_state is not None:
        out["err"] = [None if s is None else s.err.clone() for s in state.comm_state]
    return out


def guarded_nan(rank, world) -> dict:
    """``--overlap --nan-guard`` steps where step 2's loss is NaN on the
    rank at data 0, seq 1 only."""
    args = tdpp.parse_args(["--device", "cpu", *RUNS["overlap"], "--nan-guard"])
    trainer = tdpp.build_trainer(args, torch.device("cpu"), rank, world)
    poisoned = rt.current_mesh().coords == {"data": 0, "seq": 1}
    calls = []

    def loss_fn(model, batch):
        loss, aux = tdpp._loss_fn(model, batch)
        calls.append(None)
        return (loss * float("nan") if poisoned and len(calls) == 2 else loss), aux

    step = make_train_step(loss_fn, overlap=True, nonfinite_guard=True, cp_axis="seq",
                           bucket_bytes=int(0.01 * 2**20))
    trainer.loader.set_epoch(0)
    tov.reset_counts()
    out = {"flags": [], "params": []}
    for b in itertools.islice(trainer.loader, STEPS):
        out["flags"].append(float(step(trainer.state, b)["nonfinite_grad"]))
        out["params"].append(_params(trainer.state.model))
    out["buckets"] = dict(tov.COUNTS)
    return out


def _worker(rank, world, coordinator, out_dir, q0):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: run_flags(flags, rank, world, q0 if "powersgd" in name else None)
               for name, flags in RUNS.items()}
        res["nan"] = guarded_nan(rank, world)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


# ------------------------------------------------------------- JAX side --

def _init(flags):
    targs = tdpp.parse_args(["--device", "cpu", *flags])
    tcfg = tdpp.build_config(targs)
    init = ttfm.TransformerLM(tcfg, generator=torch.Generator().manual_seed(targs.seed))
    return to_jax_params(init.state_dict(), tcfg)


def _mesh():
    R = ref()
    return R.ddp.make_mesh(("data", "seq"), shape=(WORLD // 2, 2), devices=R.jax.devices()[:WORLD])


def jax_initial_q():
    """The reference's PowerSGD state for these flags (its seeded q)."""
    R = ref()
    jargs = R.jdpp.parse_args(["--device", "cpu", *RUNS["powersgd"]])
    return R.jps.powersgd_state(_init(RUNS["powersgd"]), WORLD // 2, jargs.powersgd_rank, seed=jargs.seed)


def jax_run(name) -> dict:
    """The reference's CP train step for ``RUNS[name]`` on the same mesh:
    losses, initial and final parameters and, under PowerSGD, each data
    position's residuals."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    flags = RUNS[name]
    jargs = R.jdpp.parse_args(["--device", "cpu", *flags])
    mesh = _mesh()
    params0 = _init(flags)
    dataset = R.jdpp.build_dataset(jargs, train=True)
    jmodel = R.jdpp.build_model(jargs, vocab_size=dataset.vocab_size)
    jmodel = R.jtfm.TransformerLM(dataclasses.replace(jmodel.cfg, attn_impl="xla"))

    def jloss(p, batch, rng):
        logits = jmodel.apply({"params": p}, batch["inputs"])
        return R.lm_ce(logits, batch["targets"]), {"accuracy": R.accuracy(logits, batch["targets"])}

    state = ddp.broadcast_params(ddp.TrainState.create(apply_fn=jmodel.apply, params=params0,
                                                       tx=R.jdpp.build_optimizer(jargs, total_steps=STEPS)), mesh)
    if jargs.grad_compress == "powersgd":
        state = state.replace(comm_state=R.jps.powersgd_state(state.params, WORLD // 2, jargs.powersgd_rank,
                                                              seed=jargs.seed, mesh=mesh))
    bb = int(jargs.bucket_mb * 2**20) if jargs.bucket_mb else None
    step = ddp.make_train_step(jloss, mesh=mesh, cp_axis="seq", overlap=jargs.overlap, bucket_bytes=bb,
                               grad_compress=jargs.grad_compress, donate=False)
    loader = R.DataLoader(dataset, per_replica_batch=jargs.batch_size, mesh=mesh, shuffle=True, seed=jargs.seed,
                          place_fn=lambda b: R.shard_lm_batch(b["tokens"], mesh))
    loader.set_epoch(0)
    losses = []
    for batch in itertools.islice(loader, STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params0": params0, "params": jax.tree.map(np.asarray, state.params)}
    if state.comm_state is not None:
        out["err"] = [None if s is None else np.asarray(s.err) for s in jax.tree.leaves(
            state.comm_state, is_leaf=lambda x: x is None or hasattr(x, "err"))]
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    q0 = [None if s is None else np.asarray(s.q) for s in ref().jax.tree.leaves(
        jax_initial_q(), is_leaf=lambda x: x is None or hasattr(x, "err"))]
    out = tmp_path_factory.mktemp("cp_hook_ranks")
    ctx = mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{rt.free_port()}", str(out), q0), nprocs=WORLD, join=False)
    want = {name: jax_run(name) for name in RUNS}  # while the ranks work
    while not ctx.join():
        pass
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)], want


def check_run(ranks, name):
    jax = ref().jax
    results, w = ranks[0], ranks[1][name]
    tcfg = tdpp.build_config(tdpp.parse_args(["--device", "cpu", *RUNS[name]]))
    for r in results:
        run = r[name]
        np.testing.assert_allclose(run["losses"], w["losses"], atol=F32_ATOL, rtol=0, err_msg=name)
        got = to_jax_params(run["params"], tcfg)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(w["params"])):
            np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0, err_msg=name)


# ----------------------------------------------------------------- tests --

def test_cp_overlap_matches_reference(ranks):
    check_run(ranks, "overlap")


def test_cp_powersgd_matches_reference(ranks):
    check_run(ranks, "powersgd")


def test_cp_overlap_launches_every_bucket_in_backward(ranks):
    results, _ = ranks
    counts = [r["overlap"]["buckets"] for r in results]
    assert all(c["after_backward"] == 0 and c["in_backward"] > 0 for c in counts), counts
    assert all(c == counts[0] for c in counts) and counts[0]["in_backward"] % STEPS == 0


def test_cp_powersgd_residuals_are_the_references(ranks):
    """Each rank's residual is its data position's in the reference (the
    two seq ranks of a data position hold the same one)."""
    results, want = ranks
    jerr = want["powersgd"]["err"]
    assert sum(e is not None for e in jerr) >= 2
    for r in results:
        d = r["powersgd"]["coords"]["data"]
        for got, w in zip(r["powersgd"]["err"], jerr):
            if w is None:
                assert got is None
                continue
            np.testing.assert_allclose(got.reshape(w.shape[1:]).numpy(), w[d], **PSGD_TOL)


def test_cp_nan_on_one_seq_rank_skips_every_rank(ranks):
    results, _ = ranks
    for r in results:
        nan = r["nan"]
        assert nan["flags"] == [0.0, 1.0, 0.0]
        for k, v in nan["params"][1].items():  # the skipped step changed nothing
            assert torch.equal(v, nan["params"][0][k]), k
        # Under the guard nothing launches before the verdict.
        assert nan["buckets"]["in_backward"] == 0 and nan["buckets"]["after_backward"] > 0
    for k, v in results[0]["nan"]["params"][2].items():  # lockstep after it
        assert all(torch.equal(v, r["nan"]["params"][2][k]) for r in results[1:]), k
