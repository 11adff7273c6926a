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
- The guard's schedule on the card: torch's fused AdamW and momentum SGD
  with ``DeviceSchedule``'s float32 LR tensor give the Python-float LR's
  parameters bit for bit, and ``found_inf`` leaves them bitwise.
"""

import math

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp
from distributeddataparallel_tpu_torch.models import resnet as tresnet
from distributeddataparallel_tpu_torch.runtime import distributed as rt
from distributeddataparallel_tpu_torch.training import train_step as ts
from distributeddataparallel_tpu_torch.training.optim import DeviceSchedule, zero_momentum
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
    # The guard's update: fused SGD (it skips through found_inf) and the
    # schedule's count on the device.
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, fused=True)
    zero_momentum(opt)
    state = TrainState(model, opt, DeviceSchedule(opt, lambda s: 1.0, 4))
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
    assert float(m["nonfinite_grad"]) == 1.0 and state.step == 2 and state.scheduler.last_epoch == 1
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


def test_fused_update_with_the_device_lr_is_the_float_lrs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    p0 = torch.randn(100_000, device=cuda, generator=gen)
    grads = [torch.randn(100_000, device=cuda, generator=gen) for _ in range(5)]
    makers = {"adamw": lambda ps: torch.optim.AdamW(ps, lr=3e-4, weight_decay=0.01, fused=True),
              "sgd": lambda ps: torch.optim.SGD(ps, lr=3e-4, momentum=0.9, fused=True)}
    for name, make in makers.items():
        finals = []
        for device_lr in (False, True):
            p = torch.nn.Parameter(p0.clone())
            opt = make([p])
            if device_lr:
                zero_momentum(opt)
                sched = DeviceSchedule(opt, lambda s: 1.0, 8)
                assert opt.param_groups[0]["lr"].dtype == torch.float32
            for g in grads:
                p.grad = g.clone()
                opt.step()
                if device_lr:
                    sched.step(torch.ones((), dtype=torch.int64, device=cuda))
            finals.append(p.detach().clone())
            opt.found_inf = torch.ones((), device=cuda)
            p.grad = grads[0].clone()
            opt.step()
            assert torch.equal(finals[-1], p.detach()), name
        assert torch.equal(finals[0], finals[1]), name
