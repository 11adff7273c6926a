"""The port's telemetry against the JAX package's, on the CPU.

One ``--model cnn`` run of each trainer with every telemetry flag
(``--events-dir``, ``--metrics-every``, ``--mfu``, ``--memory-telemetry``,
``--alerts``, ``--runs-dir``, ``--profile-steps``), two epochs of 21 steps
with eval, so that a throughput window (20 steps after the first) closes in
each epoch.  The alert spec lowers ``mfu_floor`` so that no rule can fire on
a slow machine: on the CPU the reference divides by a nominal CPU peak and
the port reports no MFU at all.

- The repo's readers take the port's files: ``scripts/check_events.py``
  accepts them, ``scripts/ddp_report.py`` renders their goodput, MFU and
  memory sections.
- The sequence of events (kind, span name, step) equals the reference's,
  but for ``exec_memory``: the compiler's memory budget of the step
  program, which an eager PyTorch step does not have.
- ``--mfu``'s FLOP count equals the reference cost model's for GPT-2,
  Llama (remat on and off) and the cnn, exactly.
- The losses are bit-identical with telemetry on and off.
- Bad ``--alerts`` and ``--profile-steps`` specs, and ``--mfu`` on a
  ResNet, fail with the reference's messages.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dpp as jdpp  # noqa: E402  the reference entry point

from distributeddataparallel_tpu.observability import cost_model as jcost  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]
RUN = ["--model", "cnn", "--epochs", "2", "--num-examples", "96", "--batch-size", "4",
       "--steps-per-epoch", "21", "--log-every", "10", "--eval"]


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


def _telemetry(d: Path) -> list[str]:
    return ["--events-dir", str(d / "events"), "--metrics-every", "5", "--mfu", "--memory-telemetry",
            "--alerts", "mfu_floor=1e-9", "--runs-dir", str(d / "runs"), "--profile-steps", "3:5"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("obs")
    ref = subprocess.Popen(
        [sys.executable, "dpp.py", "--device", "cpu", "--fake-devices", "1", *RUN,
         *_telemetry(base / "ref")], cwd=ROOT, env=reference_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    with pytest.MonkeyPatch.context() as mp:
        for k in ("DDP_EVENTS_DIR", "DDP_RUNS_DIR", "DDP_ALERTS"):
            mp.delenv(k, raising=False)
        mine = tdpp.main(["--device", "cpu", *RUN, *_telemetry(base / "port")])
        plain = tdpp.main(["--device", "cpu", *RUN])
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-3000:]
    return base, mine, plain


def _events(d: Path) -> list[dict]:
    return [json.loads(line) for line in (d / "events" / "timeline.jsonl").read_text().splitlines()]


def test_repo_readers_accept_the_ports_files(runs):
    base, mine, _ = runs
    d = base / "port" / "events"
    check = subprocess.run([sys.executable, "scripts/check_events.py", str(d / "timeline.jsonl"),
                            str(d / "events-p0.jsonl")], cwd=ROOT, capture_output=True, text=True,
                           timeout=120)
    assert check.returncode == 0, check.stdout + check.stderr
    report = subprocess.run([sys.executable, "scripts/ddp_report.py", str(d), "--json"], cwd=ROOT,
                            capture_output=True, text=True, timeout=120)
    assert report.returncode == 0, report.stderr[-2000:]
    rep = json.loads(report.stdout)
    assert [m["step"] for m in rep["mfu"]] == [20, 40]
    assert rep["goodput"] is not None and rep["memory"]
    assert list((d / "xprof").glob("trace_window_3-4_p0.json"))
    (summary,) = [json.loads(x) for x in (base / "port" / "runs" / "index.jsonl").read_text().splitlines()]
    assert summary["windows"] == 2 and summary["steps_total"] == 41 and summary["status"] == "ok"
    assert len(mine["throughput_windows"]) == 2


def test_event_sequence_equals_the_reference(runs):
    base, _, _ = runs

    def seq(d):
        return [(e["kind"], e.get("name"), e.get("step")) for e in _events(d) if e["kind"] != "exec_memory"]

    ref, mine = seq(base / "ref"), seq(base / "port")
    assert mine == ref
    kinds = [k for k, _, _ in mine]
    assert kinds.count("metrics") == 42 // 5 + 1 + 1  # steps 0, 5, .., 40 and the final one
    assert {"run_start", "warm_start", "profile_start", "profile_stop", "mfu", "memory", "goodput",
            "run_summary", "run_end"} <= set(kinds)


def test_losses_bit_identical_with_telemetry_on_and_off(runs):
    _, mine, plain = runs
    assert mine["losses"] == plain["losses"] and len(mine["losses"]) == 42


def _ref_flops(model, flags, batch, image_shape=(32, 32, 3)):
    jargs = jdpp.parse_args(flags)
    if model == "cnn":
        fwd = jcost.simple_cnn_fwd_flops(batch=batch, image_shape=image_shape, num_classes=10)
        return jcost.train_step_flops(fwd)
    cfg = jdpp.build_model(jargs).cfg
    fwd = jcost.transformer_fwd_flops(cfg, batch=batch, seq_len=jargs.seq_len - 1)
    return jcost.train_step_flops(fwd, remat=bool(cfg.remat))


@pytest.mark.parametrize("model,extra", [
    ("gpt2", []), ("llama", []), ("llama", ["--remat", "off"]), ("cnn", []),
])
def test_mfu_flop_count_equals_the_reference_cost_model(model, extra):
    flags = ["--model", model, "--batch-size", "2", "--num-examples", "8", "--mfu", *extra]
    if model != "cnn":
        flags += ["--layers", "2", "--d-model", "64", "--seq-len", "16", "--vocab-size", "64"]
    args = tdpp.parse_args(["--device", "cpu", *flags])
    trainer = tdpp.build_trainer(args, torch.device("cpu"))
    meter = tdpp.build_telemetry(args, trainer, torch.device("cpu"), 0, 1).mfu_meter
    want = _ref_flops(model, flags, batch=2)
    assert (meter.model_flops, meter.hardware_flops) == (want["model_flops"], want["hardware_flops"])
    assert meter.peak is None  # no MFU against a made-up CPU peak
    if model == "llama":
        assert (meter.hardware_flops > meter.model_flops) == ("off" not in extra)


@pytest.mark.parametrize("cases", [
    [["--alerts", "nope=1"], ["--alerts", "mfu_floor"], ["--alerts", "mfu_floor=x"]],
    [["--profile-steps", "5"], ["--profile-steps", "5:3"], ["--profile-steps", "-1:3"]],
    [["--model", "resnet18", "--mfu"], ["--model", "resnet50", "--mfu"]],
], ids=["alerts", "profile-steps", "mfu-resnet"])
def test_bad_specs_fail_as_the_references_do(cases):
    for flags in cases:
        with pytest.raises(SystemExit) as ref:
            jdpp.parse_args(flags)
        with pytest.raises(SystemExit) as mine:
            tdpp.parse_args(flags)
        assert str(mine.value) == str(ref.value) and str(ref.value), flags
