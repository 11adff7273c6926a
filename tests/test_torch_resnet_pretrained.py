"""``--pretrained`` for the port's ResNets against the JAX package's
torchvision converter, on the CPU.

A torchvision-format state dict (``conv1.weight`` .. ``fc.bias`` with
BatchNorm running statistics that are not 0 or 1, and torchvision's
``num_batches_tracked`` counters) is written from a seeded port model, as
``.pth`` and as safetensors.  The reference reads it with
``convert_resnet_torch`` (through its ``load_pretrained``), the port with
its own ``load_pretrained``.  ResNet-18 (CIFAR stem) and ResNet-50 at a
narrow width (8 filters, every block and key of the full model) give
eval-mode logits that agree within f32 tolerance: the same weights, f32
convolutions summed in another order over at most 50 layers, atol 1e-4 and
rtol 1e-4 on logits of order 1.  Then: ``export_resnet_torch`` round-trips,
an LM file on an image model and a class-count mismatch raise, and a 2-step
``--pretrained`` run of full-width ResNet-18 has the reference
``dpp.py``'s first two losses (f32, the same tolerance).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import io as jio
from distributeddataparallel_tpu.models import resnet as jresnet
from distributeddataparallel_tpu_torch import dpp as tdpp
from distributeddataparallel_tpu_torch.models import io as tio
from distributeddataparallel_tpu_torch.models import resnet as tresnet
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), stem="cifar", size=16),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), stem="imagenet", size=32),
}


def _blocks(name):
    return ((jresnet.BasicBlock, tresnet.BasicBlock) if name == "resnet18"
            else (jresnet.BottleneckBlock, tresnet.BottleneckBlock))


def _port_model(name, num_classes=10, num_filters=8, seed=0):
    a = ARCH[name]
    return tresnet.ResNet(a["stage_sizes"], _blocks(name)[1], num_classes=num_classes,
                          num_filters=num_filters, stem=a["stem"],
                          generator=torch.Generator().manual_seed(seed))


def torchvision_state_dict(model, seed=1):
    """``model``'s weights in torchvision's layout, with BatchNorm running
    statistics moved off 0 and 1 and the ``num_batches_tracked`` counters
    torchvision keeps."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        if k.endswith("running_mean"):
            v = torch.rand(v.shape, generator=g) - 0.5
        elif k.endswith("running_var"):
            v = torch.rand(v.shape, generator=g) + 0.5
        sd[k] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    return sd


def _write(sd, tmp_path, fmt):
    path = tmp_path / f"w.{fmt}"
    if fmt == "pth":
        torch.save(sd, path)
    else:
        tio.save_safetensors({k: v.numpy() for k, v in sd.items()}, str(path))
    return str(path)


def _reference_logits(name, path, x, num_filters=8):
    a = ARCH[name]
    jm = jresnet.ResNet(stage_sizes=a["stage_sizes"], block_cls=_blocks(name)[0], num_classes=10,
                        num_filters=num_filters, stem=a["stem"])
    like = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False))
    variables = jio.load_pretrained(path, jm, like)
    return np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)), variables


@pytest.mark.parametrize("name,fmt", [("resnet18", "pth"), ("resnet50", "safetensors")])
def test_load_pretrained_matches_the_reference_converter(name, fmt, tmp_path):
    sd = torchvision_state_dict(_port_model(name))
    path = _write(sd, tmp_path, fmt)
    model = _port_model(name, seed=5)  # other weights, overwritten by the load
    loaded = tio.load_pretrained(path, model)
    assert set(loaded) == set(model.state_dict())  # no num_batches_tracked
    for k, v in loaded.items():
        assert torch.equal(v, sd[k]), k  # the loaded state equals the file
    model.load_state_dict(loaded)
    model.eval()
    size = ARCH[name]["size"]
    x = np.random.default_rng(2).normal(size=(3, size, size, 3)).astype(np.float32)
    want, variables = _reference_logits(name, path, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # The flax tree carries the same weights both ways.
    for k, v in tio.from_jax_params(variables, model).items():
        assert torch.equal(v, sd[k]), k


def test_export_resnet_torch_round_trips(tmp_path):
    model = _port_model("resnet50")
    sd = torchvision_state_dict(model)
    model.load_state_dict({k: v for k, v in sd.items() if "num_batches" not in k})
    exported = tio.export_resnet_torch(model)
    back = tio.convert_resnet_torch(exported, _port_model("resnet50", seed=3))
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
    a = ARCH["resnet50"]
    ref = jio.export_resnet_torch(tio.to_jax_params(model.state_dict(), model), a["stage_sizes"],
                                  bottleneck=True)
    assert set(ref) == set(exported)
    assert all(np.array_equal(ref[k], exported[k]) for k in ref)


def test_lm_file_and_class_count_mismatch_raise(tmp_path):
    lm = tmp_path / "gpt2.safetensors"
    tio.save_safetensors({"wte.weight": np.zeros((8, 4), np.float32)}, str(lm))
    with pytest.raises(ValueError, match="LM checkpoint"):
        tio.load_pretrained(str(lm), _port_model("resnet18"))
    path = _write(torchvision_state_dict(_port_model("resnet18", num_classes=100)), tmp_path, "pth")
    with pytest.raises(ValueError, match="fc.weight: shape"):
        tio.load_pretrained(path, _port_model("resnet18", num_classes=10))
    with pytest.raises(ValueError, match="Dense_0"):  # the reference refuses it too
        _reference_logits("resnet18", path, np.zeros((1, 16, 16, 3), np.float32))


def reference_env() -> dict:
    """The environment for a reference ``dpp.py`` subprocess: this
    process's ``os.environ`` (passed explicitly, so variables a library set
    at the C level since start-up are not inherited) without the variables
    that make it join a multi-process job (libtpu, loaded by another test
    file in the same worker, sets ``CLOUD_TPU_TASK_ID``) or turn on
    telemetry."""
    drop = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "CLOUD_TPU_TASK_ID",
            "TPU_WORKER_ID", "DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_ALERTS")
    return {k: v for k, v in os.environ.items() if k not in drop}


# The reference trainer in a process of its own (its CPU device count is
# fixed when its backend starts), printing each step's loss as its per-step
# log call receives it, unrounded.
REFERENCE_RUN = """
import json, sys
sys.path.insert(0, {root!r})
import dpp
import distributeddataparallel_tpu.utils as u
losses, log0 = [], u.log0
def capture(msg, *args):
    if msg.startswith("Epoch %d, Batch %d, Loss"):
        losses.append(args[2])
    log0(msg, *args)
u.log0 = capture
dpp.main({argv!r})
print(json.dumps(losses))
"""


def test_two_step_pretrained_run_has_the_reference_losses(tmp_path):
    """Full-width ResNet-18 CIFAR, batch 4 of 16 synthetic images, SGD, no
    augment: the port's two losses against ``dpp.py --device cpu
    --fake-devices 1``'s."""
    model = tresnet.ResNet18(num_classes=10, stem="cifar", generator=torch.Generator().manual_seed(0))
    path = _write(torchvision_state_dict(model), tmp_path, "safetensors")
    flags = ["--model", "resnet18", "--dataset", "synthetic", "--num-examples", "16",
             "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "2", "--lr", "0.01",
             "--log-every", "1", "--pretrained", path]
    code = REFERENCE_RUN.format(root=str(ROOT), argv=["--device", "cpu", "--fake-devices", "1", *flags])
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=reference_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    mine = tdpp.main(["--device", "cpu", *flags])["losses"]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-2000:]
    ref = json.loads(out.strip().splitlines()[-1])
    assert len(mine) == len(ref) == 2
    np.testing.assert_allclose(mine, ref, **TOL)
