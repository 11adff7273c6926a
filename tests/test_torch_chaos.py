"""The port's chaos harness (``utils/chaos.py``) against the JAX package's,
on the CPU.

- ``parse_chaos_spec`` accepts and rejects the same specs as the
  reference's (its module is jax-free, so both are called here), with the
  same entry keys.
- Every ported hook fires at most once across two injectors on one
  ``state_dir`` (a supervised restart), and ``chaos_inject`` records land
  in the event log.
- ``corrupt_batch`` plants one NaN where the reference's does, and raises
  the reference's ``ValueError`` on a token batch and on a uint8 image
  batch.
- The gang and digest kinds are refused, naming their ROADMAP item: by the
  injector, and by ``dpp.parse_args`` for ``--chaos`` and ``DDP_CHAOS``;
  the fault-tolerance and multi-host flags are validated as the
  reference validates them.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.utils import chaos as jchaos
from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.observability import EventLog, read_events
from distributeddataparallel_tpu_torch.utils import chaos

SPECS = [
    "", "ckpt-io@0", "ckpt-io@0:2", " nan-grad@3 ", "slow-step@5", "slow-step@5:2.5", "preempt@12",
    "ckpt-io@0,preempt@6", "worker-kill@3", "worker-kill@3:1", "worker-join@4:0", "bitflip@4",
    "bitflip@4:1:Dense_0", "host-kill@2:1", "proposer-kill@3", "rdzv-kill@1", "slow-heartbeat@2",
    "slow-heartbeat@2:3.5:1", "partition@3:0", "torn-epoch@5",
    # rejected by both
    "bogus@2", "preempt", "preempt@-1", "preempt@x", "@3", "nan-grad@3:1", "preempt@3:1",
    "slow-step@5:abc", "ckpt-io@0:x", "bitflip@4:-1", "slow-heartbeat@2:x", "slow-heartbeat@2:1:-1",
    "worker-kill@3:x", "torn-epoch@5:1", "rdzv-kill@1:2", "preempt@3@4", "nan-grad@1,bogus@2",
]


def _parse(parse, spec):
    try:
        return [e.key for e in parse(spec)]
    except ValueError as e:
        return f"ValueError: {e}"


def test_spec_grammar_equals_the_reference():
    for spec in SPECS:
        assert _parse(chaos.parse_chaos_spec, spec) == _parse(jchaos.parse_chaos_spec, spec), spec
    assert chaos.KINDS == jchaos.KINDS
    assert _parse(chaos.parse_chaos_spec, "ckpt-io@0:2, nan-grad@3") == ["ckpt-io@0:2", "nan-grad@3"]


def test_hooks_fire_at_most_once_across_restarts(tmp_path):
    spec = "slow-step@1:0,preempt@4,nan-grad@2,ckpt-io@0:2"
    events = EventLog(str(tmp_path / "events-p0.jsonl"), 0)
    first = chaos.FaultInjector(spec, state_dir=str(tmp_path / "chaos"), events=events)
    assert first.enabled and not chaos.FaultInjector().enabled
    batch = {"image": torch.zeros(2, 3, 3, 1), "label": torch.zeros(2, dtype=torch.long)}
    first.before_step(1)  # slow-step of 0 s
    with pytest.raises(chaos.SimulatedPreemption, match="step 4"):
        first.before_step(4)
    assert torch.isnan(first.corrupt_batch(batch, 2)["image"]).any()
    for attempt in (0, 1):  # both attempts of save 0 fail, the third lands
        with pytest.raises(chaos.InjectedIOError, match="attempt"):
            first.fail_io(0, attempt)
    first.fail_io(0, 2)
    events.close()
    kinds = [(r["entry"], r["step"]) for r in read_events(str(tmp_path / "events-p0.jsonl"))]
    assert kinds == [("slow-step@1:0", 1), ("preempt@4", 4), ("nan-grad@2", 2), ("ckpt-io@0:2", 0),
                     ("ckpt-io@0:2", 0)]

    # A restarted incarnation sees the markers: nothing fires again.
    second = chaos.FaultInjector(spec, state_dir=str(tmp_path / "chaos"))
    for step in range(6):
        second.before_step(step)
        assert not torch.isnan(second.corrupt_batch(batch, step)["image"]).any()
    second.fail_io(0, 0)
    # Without a state dir an entry fires once per process.
    third = chaos.FaultInjector("preempt@4")
    with pytest.raises(chaos.SimulatedPreemption):
        third.before_step(4)
    third.before_step(4)
    # DDP_CHAOS / DDP_CHAOS_STATE: the same markers, read from the environment.
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DDP_CHAOS", spec)
        mp.setenv("DDP_CHAOS_STATE", str(tmp_path / "chaos"))
        from_env = chaos.FaultInjector.from_env()
    from_env.before_step(4)


def test_corrupt_batch_plants_the_references_nan():
    rng = np.random.default_rng(0)
    image = rng.normal(size=(4, 5, 5, 3)).astype(np.float32)
    label = rng.integers(0, 10, size=4).astype(np.int32)
    mine = chaos.FaultInjector("nan-grad@0").corrupt_batch(
        {"label": torch.from_numpy(label).long(), "image": torch.from_numpy(image)}, 0)
    ref = jchaos.FaultInjector("nan-grad@0").corrupt_batch(
        {"label": jnp.asarray(label), "image": jnp.asarray(image)}, 0)
    np.testing.assert_array_equal(np.isnan(mine["image"].numpy()), np.isnan(np.asarray(ref["image"])))
    assert int(torch.isnan(mine["image"]).sum()) == 1 and torch.isnan(mine["image"][0, 0, 0, 0])
    assert not np.isnan(image).any()  # the caller's batch is not modified
    np.testing.assert_array_equal(mine["label"].numpy(), label)


@pytest.mark.parametrize("batch", [
    {"tokens": torch.zeros(2, 9, dtype=torch.long)},
    {"image": torch.zeros(2, 32, 32, 3, dtype=torch.uint8), "label": torch.zeros(2, dtype=torch.long)},
], ids=["tokens", "u8_images"])
def test_corrupt_batch_needs_a_float_tensor(batch):
    with pytest.raises(ValueError, match="needs a float leaf"):
        chaos.FaultInjector("nan-grad@3").corrupt_batch(batch, 3)
    with pytest.raises(ValueError, match="needs a float leaf"):
        jchaos.FaultInjector("nan-grad@3").corrupt_batch({k: jnp.asarray(v.numpy()) for k, v in batch.items()}, 3)


def test_gang_and_digest_kinds_are_refused_naming_their_item(monkeypatch):
    with pytest.raises(NotImplementedError, match="items 13 and 20"):
        chaos.FaultInjector("preempt@3,worker-kill@5")
    with pytest.raises(SystemExit, match=r"--chaos: .*bitflip.*item 20: training/integrity.py"):
        dpp.parse_args(["--device", "cpu", "--chaos", "bitflip@4:1"])
    with pytest.raises(SystemExit, match="--chaos: bad chaos entry 'bogus@2'"):
        dpp.parse_args(["--device", "cpu", "--chaos", "bogus@2"])
    monkeypatch.setenv("DDP_CHAOS", "host-kill@2")
    with pytest.raises(SystemExit, match="DDP_CHAOS: .*host-kill.*items 13 and 20"):
        dpp.parse_args(["--device", "cpu"])


def test_fault_and_multihost_flags_are_validated(capsys):
    for flags in (
        ["--device", "cpu", "--max-restarts", "2"],  # needs --checkpoint-dir
        ["--device", "cpu", "--max-restarts", "-1"],
        ["--device", "cpu", "--step-timeout", "0"],
        ["--device", "cpu", "--nan-guard", "--max-bad-steps", "0"],
        ["--device", "cpu", "--coordinator", "127.0.0.1:1234", "--num-processes", "2"],
        ["--device", "cpu", "--coordinator", "127.0.0.1:1234", "--num-processes", "2", "--process-id", "2"],
        ["--device", "cpu", "--process-id", "0"],  # no --coordinator
        ["--fake-devices", "2"],  # --device cuda
    ):
        with pytest.raises(SystemExit):
            dpp.parse_args(flags)
        assert "error" in capsys.readouterr().err, flags
    args = dpp.parse_args(["--device", "cpu", "--coordinator", "h:1", "--num-processes", "2",
                           "--process-id", "1", "--fake-devices", "3"])
    assert dpp.local_ranks(args) == 3
    assert dpp.local_ranks(dpp.parse_args(["--device", "cpu", "--fake-devices", "2"])) == 2
    assert dpp.local_ranks(dpp.parse_args(["--device", "cpu", "--num-processes", "4"])) == 4


def test_chaos_inject_records_validate(tmp_path):
    from distributeddataparallel_tpu_torch.observability import validate_file

    path = tmp_path / "events-p0.jsonl"
    with EventLog(str(path), 0) as events:
        chaos.FaultInjector("preempt@0", events=events).before_step(1)
        with pytest.raises(chaos.SimulatedPreemption):
            chaos.FaultInjector("preempt@0", events=events).before_step(0)
    assert validate_file(str(path)) == []
    assert [json.loads(x)["kind"] for x in path.read_text().splitlines()] == ["chaos_inject"]
