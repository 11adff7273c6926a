"""The port's gradient all-reduce probes, straggler report and trace writer
against the reference's, on the CPU (gloo).

- ``allreduce_bandwidth`` returns the reference's keys; at world 1 the bus
  formula's ``2(N-1)/N`` is 0 (0 GB/s, utilization 0.0); over 2 gloo ranks
  (a ``dpp --num-processes 2 --bw-probe`` run) the bus bandwidth is
  ``2(N-1)/N * bytes / t`` of the measured time, and no utilization
  without a known link peak.
- ``overlap_probe`` at world 1: the reference's keys, ``overlap_frac``
  None; ``make_train_step(grad_sync=False)``, which it times, refuses what
  the reference's refuses and at one rank steps as the synced step does.
- ``straggler_report`` equals the reference's on the same records, and on
  the merged timeline of the 2-rank port run (whose ``--autotune search``
  picks the same winner on both ranks from the same agreed windows).
- ``write_trace`` round-trips through ``validate_trace``.
- ``--bw-probe`` logs its line and puts the probe in the summary.
"""

import json
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu.observability import straggler as jstraggler  # noqa: E402
from distributeddataparallel_tpu.observability import trace_export as jtrace  # noqa: E402

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models.simple_cnn import TinyMLP  # noqa: E402
from distributeddataparallel_tpu_torch.observability import straggler as tstraggler  # noqa: E402
from distributeddataparallel_tpu_torch.observability import trace_export as ttrace  # noqa: E402
from distributeddataparallel_tpu_torch.ops.losses import cross_entropy_loss  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from distributeddataparallel_tpu_torch.utils import metrics  # noqa: E402
from distributeddataparallel_tpu_torch.utils.logging import get_logger  # noqa: E402

#: the reference's result keys (utils/metrics.py:262-269, :323-330)
BW_KEYS = {"devices", "payload_mb", "time_s", "bus_bw_gb_s", "peak_gb_s", "utilization"}
OVERLAP_KEYS = {"devices", "grad_mb", "step_ms", "compute_ms", "comm_ms", "overlap_frac"}


def _loss(model, batch):
    return cross_entropy_loss(model(batch["image"]), batch["label"]), {}


def _mlp_case(seed=0):
    rng = np.random.default_rng(seed)
    model = TinyMLP((8,), features=(16,), generator=torch.Generator().manual_seed(seed))
    batch = {"image": torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)),
             "label": torch.from_numpy(rng.integers(0, 10, size=(4,)).astype(np.int32))}
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)), batch


def test_allreduce_bandwidth_at_world_1():
    probe = metrics.allreduce_bandwidth(size_mb=1.0, iters=2)
    assert set(probe) == BW_KEYS
    assert (probe["devices"], probe["payload_mb"], probe["bus_bw_gb_s"], probe["utilization"]) == (1, 1.0, 0.0, 0.0)
    assert probe["peak_gb_s"] is None and probe["time_s"] >= 0
    assert metrics.link_peak_for("cpu") is None and metrics.LINK_PEAK_BYTES_PER_S["h100"] == 450e9


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One ``dpp`` run on 2 gloo ranks with ``--bw-probe`` and ``--autotune
    search``: its summary and merged timeline."""
    d = tmp_path_factory.mktemp("two_ranks")
    summary = tdpp.main(["--device", "cpu", "--model", "mlp", "--num-processes", "2", "--num-examples", "64",
                         "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "4", "--bw-probe",
                         "--autotune", "search", "--tune-trials", "1", "--tune-steps", "1",
                         "--tune-dir", str(d / "tuned"), "--events-dir", str(d / "ev")])
    with open(d / "ev" / "timeline.jsonl") as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    return summary, records


def test_allreduce_bandwidth_over_two_gloo_ranks(two_ranks):
    summary, records = two_ranks
    probe = summary["bw_probe"]
    assert set(probe) == BW_KEYS and probe["devices"] == 2 and probe["payload_mb"] == 64.0
    bytes_ = int(64.0 * 1e6)
    assert probe["bus_bw_gb_s"] == pytest.approx(2 * (2 - 1) / 2 * bytes_ / probe["time_s"] / 1e9, rel=1e-12)
    assert probe["peak_gb_s"] is None and probe["utilization"] == 0.0
    # Both ranks searched in step: the same trials, statuses and agreed
    # (slowest-rank) windows, so the same winner.
    trials = {p: [(r["trial"], r["status"], r["measured_step_s"]) for r in records
                  if r["kind"] == "tune_trial" and r["proc"] == p] for p in (0, 1)}
    assert trials[0] == trials[1] and trials[0]
    results = [r["winner"] for r in records if r["kind"] == "tune_result"]
    assert len(results) == 2 and results[0] == results[1] == summary["autotune"]["winner"]


def test_straggler_report_on_a_two_rank_port_run(two_ranks):
    summary, records = two_ranks
    report = tstraggler.straggler_report(records)
    assert report == jstraggler.straggler_report(records)
    assert report["n_ranks"] == 2 and report["slowest_rank"] in (0, 1)
    assert report["steps_compared"] == summary["train_steps"] >= 1


def test_straggler_report_matches_the_reference_on_records():
    rng = np.random.default_rng(3)
    records = [{"kind": "span", "name": "step", "proc": None, "step": 0, "ts": 0.0, "dur_s": 1.0},
               {"kind": "span", "name": "epoch", "proc": 0, "step": 0, "ts": 1.0, "dur_s": 1.0},
               {"kind": "mfu", "proc": 1}]
    for step in range(40):
        for proc in range(3):
            ts = step * 0.2 + float(rng.exponential(0.02 if proc != 2 else 0.3))
            records.append({"kind": "span", "name": "step", "proc": proc, "step": step, "ts": ts,
                            "dur_s": float(rng.uniform(0.1, 0.2))})
    records.append({"kind": "span", "name": "step", "proc": 1, "step": 3, "ts": 99.0, "dur_s": 0.3})  # a replay
    records.append({"kind": "span", "name": "step", "proc": 0, "step": 77, "ts": 99.0, "dur_s": 0.1})  # torn
    records.append({"kind": "span", "name": "step", "proc": 0, "step": None, "ts": 99.5, "dur_s": 0.1})
    for recs in (records, [r for r in records if r.get("proc") in (0, None)], []):
        assert tstraggler.straggler_report(recs) == jstraggler.straggler_report(recs)
    assert tstraggler.straggler_report(records)["slowest_rank"] == 2
    assert tstraggler.straggler_report([r for r in records if r.get("proc") == 0])["skew_mean_s"] is None
    assert tstraggler.SKEW_EDGES == jstraggler.SKEW_EDGES


def test_write_trace_round_trips_through_validate_trace(two_ranks, tmp_path):
    _, records = two_ranks
    trace = ttrace.to_trace_events(records)
    assert trace == jtrace.to_trace_events(records)
    path = ttrace.write_trace(trace, str(tmp_path / "trace.json"))
    jtrace.write_trace(trace, str(tmp_path / "ref.json"))
    assert Path(path).read_bytes() == (tmp_path / "ref.json").read_bytes()
    loaded = json.loads(Path(path).read_text())
    assert loaded == trace and ttrace.validate_trace(loaded) == [] and len(loaded["traceEvents"]) > 10


def test_overlap_probe_at_world_1():
    state, batch = _mlp_case()
    probe = metrics.overlap_probe(_loss, state, batch, iters=2)
    assert set(probe) == OVERLAP_KEYS and probe["devices"] == 1 and probe["overlap_frac"] is None
    assert probe["step_ms"] > 0 and probe["compute_ms"] > 0 and probe["comm_ms"] >= 0
    assert probe["grad_mb"] == round(sum(p.numel() * 4 for p in state.model.parameters()) / 1e6, 2)


def test_grad_sync_false_refuses_what_the_reference_refuses_and_steps_alike():
    import jax
    import jax.numpy as jnp

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.training.train_step import make_train_step as jmake

    def jloss(params, batch, rng):
        return jnp.sum(params["w"] * batch["x"]), {}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    for kw in (dict(zero=1), dict(bucket_bytes=1024), dict(overlap=True), dict(grad_compress="bf16"),
               dict(grad_clip=1.0), dict(integrity_every=2)):
        with pytest.raises(ValueError) as want:
            jmake(jloss, mesh=mesh, grad_sync=False, **kw)
        with pytest.raises(ValueError) as got:
            make_train_step(_loss, grad_sync=False, **kw)
        assert str(got.value).split(";")[0] == str(want.value).split(";")[0], kw
    # One rank: no collective either way, the same update bit for bit.
    (a, batch), (b, _) = _mlp_case(), _mlp_case()
    ma = make_train_step(_loss)(a, batch)
    mb = make_train_step(_loss, grad_sync=False)(b, batch)
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(x, y) for x, y in zip(a.model.parameters(), b.model.parameters()))


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_bw_probe_logs_its_line():
    cap = _Capture()
    get_logger().addHandler(cap)
    try:
        summary = tdpp.main(["--device", "cpu", "--model", "mlp", "--num-examples", "16", "--batch-size", "4",
                             "--epochs", "1", "--steps-per-epoch", "2", "--bw-probe"])
    finally:
        get_logger().removeHandler(cap)
    line = [m for m in cap.messages if m.startswith("all-reduce probe:")]
    assert line == ["all-reduce probe: 1 dev, 64 MB -> 0.0 GB/s bus BW, 0.0% of unknown GB/s link peak"]
    assert set(summary["bw_probe"]) == BW_KEYS and summary["bw_probe"]["devices"] == 1
    assert summary["train_steps"] == 2
