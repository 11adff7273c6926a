"""The port's fault tolerance (``training/fault_tolerance.py``, the
checkpoint's content hash, the train step's ``nonfinite_guard``) against the
JAX package's, on the CPU.

- ``RetryPolicy`` backs off as the reference's (same seeded jitter), and
  ``NonFiniteBreaker`` counts and trips on the same observations.
- The step watchdog fires with its diagnostic under
  ``exit_process=False``; heartbeats keep it quiet.
- ``ckpt-io@0:2`` recovers through two retries; a spent retry budget
  raises ``CheckpointUnrecoverable``.
- A flipped byte in the newest checkpoint loads without error but fails its
  content hash: the checkpoint is quarantined and the previous one
  restored; all corrupt means a fresh start.
- Guard parity with the JAX package: TinyMLP, AdamW with warmup and cosine,
  ``nan-grad@1`` planted by each package's injector, 4 steps from the same
  weights (``models/io.py``): losses and final params agree (f32, atol
  1e-5: the same arithmetic in other summation orders over 3 applied
  updates, as the port's other parity tests hold), and the skipped step
  left the schedule where optax's count left it.
- A BatchNorm model (a narrow ResNet: the port's SimpleCNN has no
  BatchNorm) keeps its params, momentum and running buffers bitwise across
  a skipped step, and the guard on finite batches changes no bit.
- ``--nan-guard --max-bad-steps 2`` stops a run with two poisoned steps in
  a row as ``TrainingDiverged``.
"""

import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  the reference entry point

import distributeddataparallel_tpu as ddp  # noqa: E402
from distributeddataparallel_tpu.models import simple_cnn as jcnn  # noqa: E402
from distributeddataparallel_tpu.ops import cross_entropy_loss as j_ce  # noqa: E402
from distributeddataparallel_tpu.training import fault_tolerance as jft  # noqa: E402
from distributeddataparallel_tpu.utils import chaos as jchaos  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import resnet as tresnet  # noqa: E402
from distributeddataparallel_tpu_torch.models import simple_cnn as tcnn  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.training import checkpoint as ck  # noqa: E402
from distributeddataparallel_tpu_torch.training import fault_tolerance as ft  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import DeviceSchedule, build_optimizer, zero_momentum  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from distributeddataparallel_tpu_torch.utils.chaos import FaultInjector  # noqa: E402
from distributeddataparallel_tpu_torch.utils.metrics import FaultCounters  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

ADAMW = ["--device", "cpu", "--optimizer", "adamw", "--lr", "0.01", "--weight-decay", "0.01",
         "--lr-schedule", "cosine", "--warmup-steps", "2"]
STEPS, ROWS, SHAPE = 4, 8, (4, 4, 1)


def test_retry_policy_backoff_equals_the_reference(monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    mine = [ft.RetryPolicy(5, seed=3).sleep(k) for k in range(7)]
    ref = [jft.RetryPolicy(5, seed=3).sleep(k) for k in range(7)]
    assert mine == ref and slept == mine + ref
    # 0.5 s doubling, capped at 8 s, each stretched by at most 25%.
    for k, t in enumerate(mine):
        assert min(0.5 * 2**k, 8.0) <= t < 1.25 * min(0.5 * 2**k, 8.0)
    with pytest.raises(ValueError, match="retries"):
        ft.RetryPolicy(-1)


def test_nonfinite_breaker_trips_as_the_reference():
    seq = [0.0, 1.0, 0.0, 1.0, 1.0, 1.0]
    for mod in (ft, jft):
        b = mod.NonFiniteBreaker(max_consecutive=3)
        assert [b.observe(x) for x in seq[:-1]] == [0, 1, 0, 1, 2]
        with pytest.raises(mod.TrainingDiverged, match="3 consecutive"):
            b.observe(seq[-1])
        assert b.total == 4
    with pytest.raises(ValueError, match="max_consecutive"):
        ft.NonFiniteBreaker(0)


def test_watchdog_fires_with_diagnostic_and_heartbeats_keep_it_quiet():
    hook = {}
    wd = ft.StepWatchdog(0.25, on_timeout=hook.update, exit_process=False)
    wd.start(epoch=1, batch=7)
    deadline = time.monotonic() + 5.0
    while wd.fired is None and time.monotonic() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert wd.fired is not None and hook["last_known_state"] == {"epoch": 1, "batch": 7}
    assert hook["seconds_since_heartbeat"] > 0.25 and hook["devices"] == ["cpu"]

    quiet = ft.StepWatchdog(0.4, exit_process=False).start()
    assert quiet.running
    for i in range(16):  # 0.8 s of wall clock, beats well inside the deadline
        time.sleep(0.05)
        quiet.beat(i=i)
    quiet.stop()
    assert quiet.fired is None
    with pytest.raises(ValueError, match="timeout_s"):
        ft.StepWatchdog(0.0)


def _mlp_state(seed=0, lr=0.1):
    model = tcnn.TinyMLP((2, 2, 1), (3,), 2, generator=torch.Generator().manual_seed(seed))
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))


def _fill(state, value, step):
    with torch.no_grad():
        state.model.fc.bias.fill_(value)
    state.step = step
    return state


def test_ckpt_io_retry_recovers_and_a_spent_budget_raises(tmp_path, monkeypatch):
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    counters = FaultCounters()
    ckpt = ft.ResilientCheckpointer(str(tmp_path / "ok"), injector=FaultInjector("ckpt-io@0:2"),
                                    counters=counters)
    ckpt.save(_fill(_mlp_state(), 1.5, 7), 0)
    assert counters.io_retries == 2 and ckpt.all_steps() == [0] and len(slept) == 2
    fresh = _mlp_state(seed=1)
    _, nxt = ckpt.restore_latest(fresh)
    assert nxt == 1 and fresh.step == 7
    np.testing.assert_array_equal(fresh.model.fc.bias.detach().numpy(), 1.5)

    bad = ft.ResilientCheckpointer(str(tmp_path / "bad"), injector=FaultInjector("ckpt-io@0:99"))
    with pytest.raises(ft.CheckpointUnrecoverable, match="after 4 attempts"):
        bad.save(_mlp_state(), 0)
    assert bad.all_steps() == [] and len(slept) == 2 + 3


def _flip_a_data_byte(path: Path, value: float) -> None:
    """Flip one bit inside the stored bytes of a bias filled with
    ``value``: the file still loads, with one element changed."""
    raw = bytearray(path.read_bytes())
    at = raw.find(np.full(2, value, np.float32).tobytes())
    assert at > 0
    raw[at] ^= 0x01
    path.write_bytes(bytes(raw))


def test_a_flipped_byte_fails_the_hash_and_falls_back(tmp_path):
    counters = FaultCounters()
    ckpt = ft.ResilientCheckpointer(str(tmp_path), counters=counters)
    ckpt.save(_fill(_mlp_state(), 1.0, 10), 0)
    ckpt.save(_fill(_mlp_state(), 2.0, 20), 1)
    _flip_a_data_byte(tmp_path / "epoch_1.pt", 2.0)
    loaded = torch.load(tmp_path / "epoch_1.pt", weights_only=True)  # readable, but not what was saved
    assert not torch.equal(loaded["model"]["fc.bias"], torch.full((2,), 2.0))
    with pytest.raises(ValueError, match="content-hash"):
        ckpt.read(1)

    fresh = _mlp_state(seed=1)
    _, nxt = ckpt.restore_latest(fresh)
    assert nxt == 1 and fresh.step == 10  # fell back to epoch 0
    np.testing.assert_array_equal(fresh.model.fc.bias.detach().numpy(), 1.0)
    assert counters.ckpt_fallbacks == 1
    # Quarantined for post-mortem, with its sidecar, not deleted.
    assert (tmp_path / "epoch_1.pt.corrupt").exists() and (tmp_path / "hash_1.json.corrupt").exists()
    assert ckpt.all_steps() == [0]


def test_all_checkpoints_corrupt_means_a_fresh_start(tmp_path):
    ckpt = ft.ResilientCheckpointer(str(tmp_path), counters=FaultCounters())
    ckpt.save(_fill(_mlp_state(), 3.0, 5), 0)
    _flip_a_data_byte(tmp_path / "epoch_0.pt", 3.0)
    fresh = _fill(_mlp_state(seed=1), 7.0, 0)
    _, nxt = ckpt.restore_latest(fresh)
    assert nxt == 0 and fresh.step == 0  # nothing intact left: train from scratch
    np.testing.assert_array_equal(fresh.model.fc.bias.detach().numpy(), 7.0)
    # A payload's hash covers every tensor byte, dtype and shape, and the
    # step and schedule.
    p = ck.host_payload(_mlp_state(), 0)
    h = ck.state_content_hash(p)
    assert ck.state_content_hash(ck.host_payload(_mlp_state(), 0)) == h
    p["step"] = 1
    assert ck.state_content_hash(p) != h


def _batches():
    rng = np.random.default_rng(5)
    return [{"image": rng.normal(size=(ROWS, *SHAPE)).astype(np.float32),
             "label": rng.integers(0, 10, size=ROWS).astype(np.int32)} for _ in range(STEPS)]


def test_guard_matches_the_jax_skip_step():
    tm = tcnn.TinyMLP(SHAPE, (16,), 10, generator=torch.Generator().manual_seed(2))
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    jm = jcnn.TinyMLP(features=(16,), num_classes=10)

    def jloss(params, batch, rng):
        return j_ce(jm.apply({"params": params}, batch["image"]), batch["label"]), {}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jstate = ddp.broadcast_params(ddp.TrainState.create(
        apply_fn=jm.apply, params=to_jax_params(sd, tm)["params"],
        tx=jdpp.build_optimizer(jdpp.parse_args(ADAMW), total_steps=STEPS)), mesh)
    jstep = ddp.make_train_step(jloss, mesh=mesh, nonfinite_guard=True, donate=False)
    jinj, jlosses, jbad = jchaos.FaultInjector("nan-grad@1"), [], []
    for i, b in enumerate(_batches()):
        jstate, m = jstep(jstate, jinj.corrupt_batch({k: jnp.asarray(x) for k, x in b.items()}, i),
                          jax.random.PRNGKey(0))
        jlosses.append(float(m["loss"]))
        jbad.append(float(m["nonfinite_grad"]))

    opt, sched = build_optimizer(tdpp.parse_args(ADAMW + ["--nan-guard"]), tm.parameters(), STEPS)
    state = TrainState(tm, opt, sched)
    step = make_train_step(tdpp._image_loss_fn, nonfinite_guard=True)
    inj, losses, bad = FaultInjector("nan-grad@1"), [], []
    for i, b in enumerate(_batches()):
        batch = {"image": torch.from_numpy(b["image"]), "label": torch.from_numpy(b["label"]).long()}
        m = step(state, inj.corrupt_batch(batch, i))
        losses.append(float(m["loss"]))
        bad.append(float(m["nonfinite_grad"]))

    assert bad == jbad == [0.0, 1.0, 0.0, 0.0]
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)  # NaN at step 1 on both
    assert np.isnan(losses[1]) and np.isfinite(np.delete(losses, 1)).all()
    want = from_jax_params(jax.tree.map(np.asarray, {"params": jstate.params}), tm)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    # Three updates applied, one skipped: optax's counts and torch's agree.
    counts = {int(v) for _, v in optax.tree_utils.tree_get_all_with_path(jstate.opt_state, "count")}
    assert counts == {3} and int(jstate.step) == STEPS == state.step
    assert sched.last_epoch == 3 and {int(s["step"]) for s in opt.state.values()} == {3}


def _resnet_state(guard: bool):
    """A ResNet's state with torch's fused momentum SGD (the update the
    guard skips in) and the schedule ``1 / (s + 1)``: on the device's count
    under the guard, ``LambdaLR`` without it."""
    model = tresnet.ResNet(block_cls=tresnet.BasicBlock, stage_sizes=(1, 1), num_classes=10, num_filters=4,
                           stem="cifar", generator=torch.Generator().manual_seed(1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, fused=True)
    if guard:
        zero_momentum(opt)
        return TrainState(model, opt, DeviceSchedule(opt, lambda s: 1.0 / (s + 1), 8))
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0 / (s + 1)))


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            [s["momentum_buffer"].clone() for s in state.optimizer.state.values()],
            state.scheduler.last_epoch, float(state.optimizer.param_groups[0]["lr"]))


def test_guard_keeps_batchnorm_buffers_bitwise_across_a_skipped_step():
    rng = np.random.default_rng(3)
    batches = [{"image": torch.from_numpy(rng.normal(size=(ROWS, 8, 8, 3)).astype(np.float32)),
                "label": torch.from_numpy(rng.integers(0, 10, size=ROWS))} for _ in range(3)]
    state, plain = _resnet_state(True), _resnet_state(False)
    guarded = make_train_step(tdpp._image_loss_fn, nonfinite_guard=True)
    unguarded = make_train_step(tdpp._image_loss_fn)
    assert guarded(state, batches[0])["nonfinite_grad"] == 0.0
    unguarded(plain, batches[0])
    # The guard on a finite step changes no bit (against the same fused update).
    for a, b in zip(_snapshot(state)[0].values(), _snapshot(plain)[0].values()):
        assert torch.equal(a, b)
    assert _snapshot(state)[2:] == _snapshot(plain)[2:]
    before = _snapshot(state)
    assert any("running_var" in k for k in before[0])
    m = guarded(state, FaultInjector("nan-grad@1").corrupt_batch(batches[1], 1))
    assert m["nonfinite_grad"] == 1.0 and state.step == 2
    after = _snapshot(state)
    for k in before[0]:
        assert torch.equal(before[0][k], after[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
    assert before[2:] == after[2:]  # the schedule did not move
    guarded(state, batches[2])
    assert not torch.equal(state.model.state_dict()["fc.weight"], before[0]["fc.weight"])


def test_consecutive_bad_steps_stop_the_run():
    flags = ["--device", "cpu", "--model", "mlp", "--num-examples", "64", "--batch-size", "4",
             "--epochs", "1", "--steps-per-epoch", "5", "--log-every", "1000", "--nan-guard"]
    with pytest.raises(ft.TrainingDiverged, match="2 consecutive"):
        tdpp.main(flags + ["--max-bad-steps", "2", "--chaos", "nan-grad@1,nan-grad@2"])
    summary = tdpp.main(flags + ["--max-bad-steps", "2", "--chaos", "nan-grad@1,nan-grad@3"])
    assert summary["faults"]["nonfinite_steps"] == 2 and summary["train_steps"] == 5
