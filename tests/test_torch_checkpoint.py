"""The port's epoch checkpoints and ``--resume``, on the CPU.

- ResNet-18 (BatchNorm buffers, SGD momentum state, CIFAR augmentation)
  trained 3 epochs straight, and 2 epochs then ``--resume`` to 3: the
  resumed run starts at epoch 2, its losses equal the straight run's epoch-2
  losses, and the final model and optimizer state are bitwise equal (the
  sampler, the augmentation draws and the optimizer state are functions of
  what the checkpoint holds, and the CPU kernels are deterministic).
- The same resume under ``--grad-compress powersgd``: the optimizer's
  momentum is saved beside the per-rank PowerSGD state.
- A checkpoint written by two ranks resumes in one process.
- ``max_to_keep`` prunes the oldest checkpoints, with their hash sidecars.
- A save that fails midway leaves no file under a checkpoint's name (nor
  its hash sidecar), and a checkpoint is renamed into place only once
  complete, after its sidecar.

All through the trainer's one checkpointer, ``ResilientCheckpointer``.
"""

import os

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.models.simple_cnn import TinyMLP
from distributeddataparallel_tpu_torch.training import checkpoint as ck
from distributeddataparallel_tpu_torch.training import fault_tolerance as ft
from distributeddataparallel_tpu_torch.training.state import TrainState
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

FLAGS = ["--device", "cpu", "--model", "resnet18", "--num-examples", "24", "--batch-size", "8",
         "--augment", "--optimizer", "sgd", "--momentum", "0.9", "--lr", "0.05",
         "--log-every", "1000"]


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    straight = dpp.main(FLAGS + ["--epochs", "3", "--checkpoint-dir", str(tmp_path / "a")])
    first = dpp.main(FLAGS + ["--epochs", "2", "--checkpoint-dir", str(tmp_path / "b")])
    resumed = dpp.main(FLAGS + ["--epochs", "3", "--checkpoint-dir", str(tmp_path / "b"), "--resume"])
    spe = 3
    assert resumed["start_epoch"] == 2 and resumed["train_steps"] == spe
    assert first["losses"] == straight["losses"][: 2 * spe]
    assert resumed["losses"] == straight["losses"][2 * spe :]
    a = torch.load(tmp_path / "a" / "epoch_2.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "epoch_2.pt", weights_only=True)
    assert a["step"] == b["step"] == 3 * spe
    assert a["model"].keys() == b["model"].keys()
    assert any("running_var" in k for k in a["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for pa, pb in zip(a["optimizer"]["state"].values(), b["optimizer"]["state"].values()):
        assert torch.equal(pa["momentum_buffer"], pb["momentum_buffer"])
    with pytest.raises(SystemExit, match="nothing left"):
        dpp.main(FLAGS + ["--epochs", "3", "--checkpoint-dir", str(tmp_path / "b"), "--resume"])


def test_powersgd_resume_keeps_the_optimizer_state(tmp_path):
    """Under ``--grad-compress powersgd`` (per-rank PowerSGD state) the
    checkpoint also holds the optimizer's momentum: the resumed epoch's
    losses equal the uninterrupted run's exactly."""
    flags = ["--device", "cpu", "--model", "mlp", "--num-examples", "48", "--batch-size", "8",
             "--optimizer", "sgd", "--momentum", "0.9", "--lr", "0.01", "--log-every", "1000",
             "--grad-compress", "powersgd", "--powersgd-rank", "1"]
    straight = dpp.main(flags + ["--epochs", "3", "--checkpoint-dir", str(tmp_path / "a")])
    dpp.main(flags + ["--epochs", "2", "--checkpoint-dir", str(tmp_path / "b")])
    resumed = dpp.main(flags + ["--epochs", "3", "--checkpoint-dir", str(tmp_path / "b"), "--resume"])
    spe = resumed["train_steps"]
    assert resumed["start_epoch"] == 2 and spe > 1
    assert resumed["losses"] == straight["losses"][2 * spe :]


def _state():
    model = TinyMLP((2, 2, 1), (3,), 2, generator=torch.Generator().manual_seed(0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))


def test_max_to_keep_prunes_and_restore_takes_the_newest(tmp_path):
    ckpt = ft.ResilientCheckpointer(str(tmp_path), max_to_keep=2)
    state = _state()
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(state) == (state, 0)
    for epoch in range(4):
        state.step = 10 * epoch
        with torch.no_grad():
            state.model.fc.bias.fill_(float(epoch))
        ckpt.save(state, epoch)
    assert ckpt.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["epoch_2.pt", "epoch_3.pt", "hash_2.json", "hash_3.json"]
    fresh = _state()
    _, next_epoch = ft.ResilientCheckpointer(str(tmp_path)).restore_latest(fresh)
    assert next_epoch == 4 and fresh.step == 30
    np.testing.assert_array_equal(fresh.model.fc.bias.detach().numpy(), [3.0, 3.0])


def test_no_partial_checkpoint_is_ever_visible(tmp_path, monkeypatch):
    monkeypatch.setattr(ft.time, "sleep", lambda s: None)  # the retries' backoff
    ckpt = ft.ResilientCheckpointer(str(tmp_path))
    real_save = torch.save
    seen = []

    def failing_save(obj, path):
        with open(path, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", failing_save)
    with pytest.raises(ft.CheckpointUnrecoverable, match="after 4 attempts") as failed:
        ckpt.save(_state(), 0)
    assert isinstance(failed.value.__cause__, OSError) and "disk full" in str(failed.value.__cause__)
    assert os.listdir(tmp_path) == [] and ckpt.latest_step() is None

    def watched_save(obj, path):
        real_save(obj, path)
        seen.append(sorted(os.listdir(tmp_path)))  # written, not yet renamed

    monkeypatch.setattr(ck.torch, "save", watched_save)
    ckpt.save(_state(), 0)
    assert seen == [[".epoch_0.pt.tmp", "hash_0.json"]]
    assert sorted(os.listdir(tmp_path)) == ["epoch_0.pt", "hash_0.json"]


def test_resume_with_another_number_of_processes(tmp_path):
    """Plain DP state is replicated: a checkpoint written by two gloo ranks
    (rank 0 writes, both wait at the barrier) resumes in one process."""
    flags = ["--device", "cpu", "--model", "cnn", "--num-examples", "32", "--batch-size", "4",
             "--checkpoint-dir", str(tmp_path), "--log-every", "1000"]
    two = dpp.main(flags + ["--epochs", "1", "--num-processes", "2"])
    assert two["world_size"] == 2 and sorted(os.listdir(tmp_path)) == ["epoch_0.pt", "hash_0.json"]
    one = dpp.main(flags + ["--epochs", "2", "--resume"])
    assert one["world_size"] == 1 and one["start_epoch"] == 1 and one["train_steps"] == 8
    assert all(np.isfinite(one["losses"]))
    assert torch.load(tmp_path / "epoch_1.pt", weights_only=True)["step"] == 4 + 8
