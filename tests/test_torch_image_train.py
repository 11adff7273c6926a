"""The port's image train step, eval step and CLI against the JAX package's,
on the CPU.

- Three SGD-momentum steps of ``SimpleCNN`` and of a narrow BatchNorm
  ResNet through the port's ``make_train_step`` equal three steps of the
  reference's ``make_train_step(with_model_state=True)``: losses, params and
  BatchNorm buffers, on one rank against a 1-device CPU mesh and on two
  gloo ranks against a 2-device mesh, under ``buffer_sync`` "mean" and
  "broadcast".  Tolerance: f32 with different summation orders over three
  updates, atol 2e-5 / rtol 1e-4 (as the LM step's parity test).  The two
  ranks' final states are bitwise equal.
- The masked eval step normalizes with the running statistics and
  weights by valid rows, as the reference's does.
- ``dpp.main`` trains the image models end to end with ``--device cpu``.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  the reference entry point

import distributeddataparallel_tpu as ddp  # noqa: E402
from distributeddataparallel_tpu.models import resnet as jresnet  # noqa: E402
from distributeddataparallel_tpu.models import simple_cnn as jcnn  # noqa: E402
from distributeddataparallel_tpu.training.train_step import make_eval_step as j_make_eval_step  # noqa: E402
from distributeddataparallel_tpu.ops import (  # noqa: E402
    accuracy as j_acc,
    cross_entropy_loss as j_ce,
    per_example_accuracy as j_pe_acc,
    per_example_cross_entropy as j_pe_ce,
)
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.data.sharded import write_synthetic_image_shards  # noqa: E402
from distributeddataparallel_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributeddataparallel_tpu_torch.models import simple_cnn as tcnn  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import (  # noqa: E402
    make_eval_step,
    make_train_step,
)

TOL = dict(atol=2e-5, rtol=1e-4)
OPT = ["--device", "cpu", "--optimizer", "sgd", "--lr", "0.1", "--momentum", "0.9"]
STEPS, GLOBAL_BATCH, SIZE = 3, 8, 8


def _models(kind):
    gen = torch.Generator().manual_seed(1)
    if kind == "cnn":
        return jcnn.SimpleCNN(num_classes=10, widths=(4, 8)), tcnn.SimpleCNN(10, (4, 8), generator=gen)
    kw = dict(stage_sizes=(1, 1), num_classes=10, num_filters=4, stem="cifar")
    return (jresnet.ResNet(block_cls=jresnet.BasicBlock, **kw),
            tresnet.ResNet(block_cls=tresnet.BasicBlock, generator=gen, **kw))


def _inputs(kind):
    """Initial port weights and three global batches."""
    _, tm = _models(kind)
    rng = np.random.default_rng(7)
    batches = [{"image": rng.normal(size=(GLOBAL_BATCH, SIZE, SIZE, 3)).astype(np.float32),
                "label": rng.integers(0, 10, size=GLOBAL_BATCH).astype(np.int32)}
               for _ in range(STEPS)]
    return {k: v.clone() for k, v in tm.state_dict().items()}, batches


def _jax_steps(kind, buffer_sync, ndev):
    jm, tm = _models(kind)
    sd, batches = _inputs(kind)
    v = to_jax_params(sd, tm)
    ms = {k: x for k, x in v.items() if k != "params"}

    if ms:
        def loss_fn(params, ms, batch, rng):
            logits, new = jm.apply({"params": params, **ms}, batch["image"], train=True,
                                   mutable=list(ms))
            return j_ce(logits, batch["label"]), ({"accuracy": j_acc(logits, batch["label"])}, new)
    else:
        def loss_fn(params, batch, rng):
            logits = jm.apply({"params": params}, batch["image"])
            return j_ce(logits, batch["label"]), {"accuracy": j_acc(logits, batch["label"])}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:ndev])
    tx = jdpp.build_optimizer(jdpp.parse_args(OPT), total_steps=STEPS)
    state = ddp.broadcast_params(ddp.TrainState.create(
        apply_fn=jm.apply, params=v["params"], tx=tx, model_state=ms), mesh)
    step = ddp.make_train_step(loss_fn, mesh=mesh, with_model_state=bool(ms),
                               buffer_sync=buffer_sync, donate=False)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(x) for k, x in b.items()}, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, {"params": state.params, **state.model_state})
    return losses, from_jax_params(final, tm)


def _torch_steps(kind, buffer_sync, rank, world):
    _, tm = _models(kind)
    sd, batches = _inputs(kind)
    tm.load_state_dict(sd)
    opt, sched = build_optimizer(tdpp.parse_args(OPT), tm.parameters(), STEPS)
    state = TrainState(tm, opt, sched)
    step = make_train_step(tdpp._image_loss_fn, buffer_sync=buffer_sync)
    rows = slice(rank * GLOBAL_BATCH // world, (rank + 1) * GLOBAL_BATCH // world)
    losses = [float(step(state, {"image": torch.from_numpy(b["image"][rows]),
                                 "label": torch.from_numpy(b["label"][rows]).long()})["loss"])
              for b in batches]
    return losses, {k: v.detach().clone() for k, v in tm.state_dict().items()}


def _check(got, want):
    losses, sd = got
    ref_losses, ref_sd = want
    np.testing.assert_allclose(losses, ref_losses, **TOL)
    assert sd.keys() == ref_sd.keys()
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(), ref_sd[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["cnn", "resnet"])
def test_one_rank_steps_match_jax(kind):
    _check(_torch_steps(kind, "mean", 0, 1), _jax_steps(kind, "mean", 1))


TWO_RANK_CASES = [("cnn", "mean"), ("resnet", "mean"), ("resnet", "broadcast")]


def _rank_worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0, world_size=world,
                          rank=rank, device="cpu")
    try:
        res = {case: _torch_steps(*case, rank, world) for case in TWO_RANK_CASES}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every two-rank case, run once in two gloo processes; each rank's
    results."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("two_ranks")
    mp.spawn(_rank_worker, args=(2, f"127.0.0.1:{rt.free_port()}", str(out)), nprocs=2, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]


@pytest.mark.parametrize("case", TWO_RANK_CASES, ids=lambda c: "-".join(c))
def test_two_gloo_ranks_match_two_device_mesh(two_ranks, case):
    rank0, rank1 = two_ranks[0][case], two_ranks[1][case]
    assert rank0[0] == rank1[0]  # the step's metrics are the global means
    for k in rank0[1]:  # the DDP invariant: replicas in lockstep, buffers too
        assert torch.equal(rank0[1][k], rank1[1][k]), k
    if case[1] == "broadcast":  # the two modes give different buffers
        mean = two_ranks[0][("resnet", "mean")][1]
        assert any(not torch.equal(mean[k], rank0[1][k]) for k in mean if "running" in k)
    _check(rank0, _jax_steps(*case, 2))


def test_masked_eval_uses_running_stats_like_jax():
    jm, tm = _models("resnet")
    sd, batches = _inputs("resnet")
    rng = np.random.default_rng(3)
    for k in sd:
        if "running" in k:  # statistics away from their 0/1 start
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, size=sd[k].shape).astype(np.float32))
    tm.load_state_dict(sd)
    v = to_jax_params(sd, tm)
    b = batches[0]
    valid = np.array([1, 1, 0, 1, 1, 0, 1, 1], np.float32)

    def metric_fn(params, ms, batch):
        logits = jm.apply({"params": params, **ms}, batch["image"], train=False)
        return {"loss": j_pe_ce(logits, batch["label"]), "accuracy": j_pe_acc(logits, batch["label"])}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jeval = j_make_eval_step(metric_fn, mesh=mesh, with_model_state=True, masked=True)
    want, want_n = jeval(v["params"], {"batch_stats": v["batch_stats"]},
                         {"image": b["image"], "label": b["label"], "valid": valid})
    tm.train()  # the eval step itself must switch to the running statistics
    got, n = make_eval_step(tdpp._image_metric_fn)(
        tm, {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long(),
             "valid": torch.from_numpy(valid)})
    assert float(n) == float(want_n) == 6.0
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), **TOL)
    for k, t in tm.state_dict().items():  # eval leaves the buffers alone
        assert torch.equal(t, sd[k]), k


@pytest.mark.parametrize("flags", [
    ["--model", "cnn", "--augment", "--num-examples", "64", "--epochs", "2"],
    ["--model", "mlp", "--dataset", "shards:{root}", "--epochs", "1"],
], ids=["cnn-augment", "mlp-shards"])
def test_dpp_image_cli_cpu(flags, tmp_path):
    root = tmp_path / "shards"
    write_synthetic_image_shards(str(root / "train"), 48, (8, 8, 3), 6, shard_rows=20)
    write_synthetic_image_shards(str(root / "val"), 20, (8, 8, 3), 6, seed=1)
    summary = tdpp.main(["--device", "cpu", "--batch-size", "8", "--eval", "--optimizer", "sgd",
                         "--momentum", "0.9", "--lr", "0.05", "--log-every", "1000"]
                        + [f.format(root=root) for f in flags])
    losses = summary["losses"]
    assert summary["train_steps"] == (16 if "cnn" in flags else 6)
    assert all(np.isfinite(losses)) and summary["images_per_s"] > 0
    # Wall clock over steps 2.. of each epoch: the step times and the loader's.
    assert summary["images_per_s_wall"] > 0 and summary["wall_step_time_s"] > 0
    assert np.isfinite(summary["eval"]["loss"]) and summary["start_epoch"] == 0


def test_dpp_flag_validation():
    for bad in (["--model", "gpt2", "--augment"], ["--model", "gpt2", "--dataset", "synthetic"],
                ["--model", "cnn", "--dataset", "synthetic-lm"], ["--resume"],
                ["--dataset", "imagenet"]):
        with pytest.raises(SystemExit):
            tdpp.parse_args(bad)
    assert tdpp.parse_args([]).dataset == "synthetic" and tdpp.parse_args([]).model == "cnn"
    assert tdpp.parse_args(["--model", "gpt2"]).dataset == "synthetic-lm"
