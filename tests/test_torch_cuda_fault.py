"""Card-only checks of the non-finite-gradient guard (marker ``cuda``).

They decide inside a fixture whether a GPU is present and skip without one;
the CPU tests hold the guard to the JAX package's skip-step.  This file
imports nothing of JAX, so on a machine with a GPU it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_fault.py -q

- A skipped step leaves the CUDA params, momentum buffers and BatchNorm
  running buffers bitwise unchanged, and the step's agreement all-reduce
  (an NCCL group of one) runs on a CUDA tensor.
- ``dpp.main --nan-guard --chaos nan-grad@1`` on the card skips exactly
  that step and trains on.
"""

import math

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.models import resnet as tresnet
from distributeddataparallel_tpu_torch.runtime import distributed as rt
from distributeddataparallel_tpu_torch.training import train_step as ts
from distributeddataparallel_tpu_torch.training.state import TrainState
from distributeddataparallel_tpu_torch.utils.chaos import FaultInjector

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the CPU tests hold the guard to the reference")
    return torch.device("cuda", 0)


def test_a_skipped_step_leaves_the_cuda_state_bitwise(cuda, monkeypatch):
    model = tresnet.ResNet(block_cls=tresnet.BasicBlock, stage_sizes=(1, 1), num_classes=10, num_filters=8,
                           stem="cifar", device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    state = TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))
    rng = np.random.default_rng(0)
    batches = [{"image": torch.from_numpy(rng.normal(size=(16, 16, 16, 3)).astype(np.float32)).to(cuda),
                "label": torch.from_numpy(rng.integers(0, 10, size=16)).to(cuda)} for _ in range(2)]
    reduced = []
    real = ts.dist.all_reduce

    def recording(t, *a, **kw):
        reduced.append((t.device.type, t.numel()))
        return real(t, *a, **kw)

    monkeypatch.setattr(ts.dist, "all_reduce", recording)
    rt.init_process_group(device=cuda)
    try:
        step = ts.make_train_step(dpp._image_loss_fn, nonfinite_guard=True)
        assert step(state, batches[0])["nonfinite_grad"] == 0.0
        before = ({k: v.clone() for k, v in model.state_dict().items()},
                  [s["momentum_buffer"].clone() for s in opt.state.values()])
        reduced.clear()
        m = step(state, FaultInjector("nan-grad@1").corrupt_batch(batches[1], 1))
        torch.cuda.synchronize()
    finally:
        rt.destroy_process_group()
    assert m["nonfinite_grad"] == 1.0 and state.step == 2 and state.scheduler.last_epoch == 1
    assert reduced[0] == ("cuda", 1)  # the flag, agreed before any gradient is reduced
    after = model.state_dict()
    assert any("running_mean" in k for k in after)
    for k, v in before[0].items():
        assert torch.equal(v, after[k]), k
    assert all(torch.equal(a, s["momentum_buffer"]) for a, s in zip(before[1], opt.state.values()))


def test_dpp_skips_the_poisoned_step_on_the_card(cuda):
    summary = dpp.main(["--model", "resnet18", "--num-examples", "96", "--batch-size", "8", "--epochs", "1",
                        "--steps-per-epoch", "4", "--log-every", "1000", "--nan-guard", "--chaos", "nan-grad@1"])
    losses = summary["losses"]
    assert summary["faults"]["nonfinite_steps"] == 1 and math.isnan(losses[1])
    assert all(math.isfinite(x) for i, x in enumerate(losses) if i != 1)
