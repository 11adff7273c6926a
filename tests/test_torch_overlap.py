"""The port's overlapped gradient reduction (``parallel.overlap``), its trace
report, and the ZeRO-2 entry point end to end, on the CPU.

- Hook-driven buckets equal the unoverlapped bucketed mean bit for bit, at
  mixed dtypes and with the bf16 hook, on 2 gloo ranks (the same f32 or
  bf16 sums of the same values: only the launch time differs).
- They launch once per accumulation boundary, in the gradient-ready
  (reverse) order, from inside backward; under ``nonfinite_guard`` they
  wait for the verdict, and a bad step moves nothing.
- ``overlap_report`` on synthetic kernel intervals.
- ``dpp --zero 2 --num-processes 2`` gives the losses of one process on the
  global batch, and ``--resume`` at 2 ranks continues the uninterrupted run.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import overlap as ov  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.data_parallel import bucket_gradients  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

WORLD = 2
# bytes: buckets [c.bias, c.weight, b.bias] and [b.weight, a.bias] (f32 and
# bf16 leaves together), [a.weight]
BUCKET = 250


class Mixed(nn.Module):
    """Three layers, the middle one in bf16: buckets of f32 leaves, of bf16
    leaves and mixed ones."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.a, self.b, self.c = nn.Linear(12, 10), nn.Linear(10, 10), nn.Linear(10, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        self.b.to(torch.bfloat16)
        self.order: list[str] = []  # layers as backward reaches their outputs

    def _mark(self, out, name):
        if out.requires_grad:
            out.register_hook(lambda g: self.order.append(name))
        return out

    def forward(self, x):
        h = torch.tanh(self._mark(self.a(x), "a"))
        h = torch.tanh(self._mark(self.b(h.bfloat16()), "b").float())
        return self._mark(self.c(h), "c")


def _loss(model, batch):
    return (model(batch["x"]) - batch["y"]).pow(2).mean(), {}


def _batch(seed, rows=8):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(rows, 12, generator=g), "y": torch.randn(rows, 3, generator=g)}


def _grads_both_ways(rank, compress):
    """The same backward twice: hook-launched buckets, and
    ``bucket_gradients`` after it."""
    out = []
    for hooked in (True, False):
        model = Mixed()
        loss, _ = _loss(model, _batch(10 + rank))
        if hooked:
            red = ov.DPOverlap(list(model.parameters()), bucket_bytes=BUCKET, compress=compress)
            red.arm()
            loss.backward()
            red.finish()
            red.hooks.remove()
        else:
            loss.backward()
            bucket_gradients([p.grad for p in model.parameters()], bucket_bytes=BUCKET, compress=compress)
        out.append([p.grad.clone() for p in model.parameters()])
    return out


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {c: _grads_both_ways(rank, c) for c in (None, "bf16")}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def test_hook_buckets_equal_bucketed_mean_bitwise(tmp_path):
    import torch.multiprocessing as mp

    mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{rt.free_port()}", str(tmp_path)), nprocs=WORLD, join=True)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    dtypes = {g.dtype for g in ranks[0][None][0]}
    assert dtypes == {torch.float32, torch.bfloat16}
    for compress in (None, "bf16"):
        for r in range(WORLD):
            hooked, plain = ranks[r][compress]
            for a, b, c in zip(hooked, plain, ranks[0][compress][0]):
                assert torch.equal(a, b) and torch.equal(a, c), compress


def test_hooks_fire_once_per_boundary_in_reverse_inside_backward():
    """Under accumulation the first microbatch's backward launches nothing;
    the boundary's launches every bucket from its hooks, in bucket order
    (the reverse of registration, the ready order), each before backward
    reaches the layer in front of it; none is left for after backward.
    Through ``make_train_step`` the counts are one launch a bucket a step."""
    model = Mixed()
    red = ov.DPOverlap(list(model.parameters()), bucket_bytes=BUCKET)
    n = len(red.hooks.buckets)
    assert n == 3
    seen = []
    launch = red.hooks.launch
    red.hooks.launch = lambda b, s: (seen.append((b, list(model.order))), launch(b, s))[1]
    ov.reset_counts()
    _loss(model, _batch(0))[0].backward()
    assert seen == [] and ov.COUNTS == {"in_backward": 0, "after_backward": 0}
    red.arm(0.5)
    model.order.clear()
    _loss(model, _batch(1))[0].backward()
    assert [b for b, _ in seen] == list(range(n)) == red.hooks.order
    assert ov.COUNTS == {"in_backward": n, "after_backward": 0}
    # Bucket 0 (layers c and b) launches before backward reaches layer a.
    assert "a" not in seen[0][1] and model.order == ["c", "b", "a"]
    red.finish()
    red.hooks.remove()

    model = Mixed()
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    step = make_train_step(_loss, overlap=True, accum_steps=2, bucket_bytes=BUCKET)
    ov.reset_counts()
    for i in range(3):
        step(state, _batch(i))
    assert ov.COUNTS == {"in_backward": 3 * n, "after_backward": 0}


def test_nan_guard_defers_launches_and_skips_the_bad_step():
    """Under the guard no bucket leaves before the verdict: every launch
    comes after backward, a poisoned step (its gradients zeroed, synced and
    skipped in the fused update) changes no parameter, and the good steps
    equal the unoverlapped guard's bit for bit."""
    def run(overlap):
        model = Mixed()
        # The guard skips inside the fused update (its found_inf).
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1, fused=True))
        step = make_train_step(_loss, overlap=overlap, nonfinite_guard=True, bucket_bytes=BUCKET)
        flags = []
        for i in range(3):
            b = _batch(i)
            if i == 1:
                b["x"][0, 0] = float("nan")
            before = [p.detach().clone() for p in model.parameters()]
            flags.append(float(step(state, b)["nonfinite_grad"]))
            if i == 1:
                assert all(torch.equal(a, p) for a, p in zip(before, model.parameters()))
        return flags, [p.detach() for p in model.parameters()]

    ov.reset_counts()
    flags, hooked = run(True)
    n = ov.COUNTS["after_backward"]
    # All three steps sync after the verdict (the bad one's gradients as
    # zeros, as the reference's guard sends them): the same buckets each.
    assert flags == [0.0, 1.0, 0.0] and ov.COUNTS["in_backward"] == 0 and n > 0 and n % 3 == 0
    _, plain = run(False)
    assert all(torch.equal(a, b) for a, b in zip(hooked, plain))


def test_overlap_report_on_synthetic_intervals(tmp_path):
    """Comm kernels on stream 20 against compute on stream 7 (us): the
    first all-reduce [10, 30) is covered by compute [0, 20) for 10 us, the
    second [40, 60) by [45, 50) for 5 us; compute on the comm's own stream
    does not count."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "sm90_gemm", "ts": 0, "dur": 20, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32", "ts": 10, "dur": 20,
         "args": {"stream": 20}},
        {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce_Sum_f32", "ts": 40, "dur": 20,
         "args": {"stream": 20}},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel", "ts": 45, "dur": 5, "args": {"stream": 7}},
        {"ph": "X", "cat": "kernel", "name": "elementwise", "ts": 55, "dur": 10, "args": {"stream": 20}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 100},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    kernels = ov.trace_kernels(str(path))
    assert len(kernels) == 5
    rep = ov.overlap_report(kernels)
    assert rep["n_comm_kernels"] == 2
    assert rep["comm_ms"] == pytest.approx(0.040) and rep["overlapped_ms"] == pytest.approx(0.015)
    assert rep["overlap_frac"] == pytest.approx(0.375) and rep["compute_ms"] == pytest.approx(0.035)
    by = ov.kernel_time_by_name(kernels, {"nccl": "nccl", "attention": "flash"})
    assert by["by_name"] == pytest.approx({"nccl": 0.04, "attention": 0.005, "other": 0.03})
    assert ov.overlap_report([k for k in kernels if "nccl" not in k["name"]])["overlap_frac"] is None


# ---------------------------------------------------------- the entry point --

TINY = ["--device", "cpu", "--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16",
        "--vocab-size", "64", "--num-examples", "64", "--steps-per-epoch", "2", "--log-every", "1000",
        "--optimizer", "adamw", "--lr", "1e-2"]


def _cli(*args):
    """``dpp.main`` as the command line runs it (several ranks are spawned
    processes); rank 0's summary."""
    return tdpp.main(list(args))


@pytest.fixture(scope="module")
def zero2_runs(tmp_path_factory):
    """3 epochs of 2 steps: ZeRO-2 on 2 ranks with checkpoints, then the
    newest checkpoint dropped and the run resumed from epoch 1's; and plain
    DP in one process on the global batch."""
    ck = tmp_path_factory.mktemp("zero2_ck")
    common = [*TINY, "--epochs", "3", "--zero", "2", "--bucket-mb", "0.004", "--num-processes", "2",
              "--batch-size", "4", "--checkpoint-dir", str(ck)]
    full = _cli(*common)
    for f in ("epoch_2.pt", "hash_2.json"):
        (ck / f).unlink()
    resumed = _cli(*common, "--resume")
    one = _cli(*TINY, "--epochs", "3", "--batch-size", "8")
    return full, resumed, one


def test_cli_zero2_two_ranks_match_one_process(zero2_runs):
    """The DDP invariant under ZeRO-2: the same update as one process on
    the global batch (f32 sums in another order: rtol 1e-5)."""
    full, _, one = zero2_runs
    assert full["world_size"] == 2 and full["train_steps"] == one["train_steps"] == 6
    np.testing.assert_allclose(full["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(full["param_norm"], one["param_norm"], rtol=1e-6)


def test_cli_zero2_resume_continues_the_run(zero2_runs):
    """--resume at 2 ranks restores each rank's shard of the moments and
    continues epoch 2 with the uninterrupted run's losses, bit for bit."""
    full, resumed, _ = zero2_runs
    assert resumed["start_epoch"] == 2 and resumed["train_steps"] == 2
    assert resumed["losses"] == full["losses"][-2:]
    assert resumed["param_norm"] == full["param_norm"]
