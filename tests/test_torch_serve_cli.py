"""The port's serving entry points on the CPU: ``python -m
distributeddataparallel_tpu_torch.serve`` (the twin of
``scripts/ddp_serve.py``) and the trainer's ``--generate N
[--decode-quant int8]`` (the reference's flags, checks and log line).

- ``serve --device cpu --smoke`` exits 0, prints the summary JSON and its
  smoke verdict (a tiny burst, a valid timeline and trace export, then the
  fast path hitting the prefix cache and accepting drafts).
- ``dpp --device cpu --model gpt2 ... --generate 8`` prints the
  reference's ``generate:`` line (with `` [int8 weights]`` under
  ``--decode-quant int8``) and returns the continuation of the first two
  training rows' first quarter in its summary.
- Both default to the GPU and raise without one; the reference's flag
  checks raise with their messages, and the fleet's flags parse.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp, serve
from distributeddataparallel_tpu_torch.data.datasets import SyntheticLM


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parents[1]
LM_ARGS = ["--device", "cpu", "--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16",
           "--vocab-size", "64", "--num-examples", "48", "--epochs", "1"]


def test_serve_smoke_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.serve", "--device", "cpu", "--smoke",
         "--events-dir", str(tmp_path / "ev")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    summary = json.loads(text[text.index("{"):text.rindex("}") + 1])
    assert summary["completed"] == summary["requests"] >= 1
    for key in ("serve_tok_s", "serve_p50_ttft_s", "serve_p99_ttft_s", "mean_tok_latency_s",
                "kv_pool_bytes", "peak_live_blocks", "decode_step_ms"):
        assert key in summary, key
    assert "serving smoke OK" in text
    assert (tmp_path / "ev" / "timeline.jsonl").exists()
    assert (tmp_path / "ev" / "fastpath" / "timeline.jsonl").exists()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_dpp_generate_prints_the_reference_line(quant, capsys):
    argv = LM_ARGS + ["--generate", "8"] + (["--decode-quant", quant] if quant else [])
    summary = dpp.main(argv)
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("generate: "))
    gen = summary["generate"]
    last8 = np.asarray(gen["tokens"])[0, -8:].tolist()
    assert line == (f"generate: prompt (2, 4) -> (2, 12) (last 8 tokens: {last8})"
                    + (" [int8 weights]" if quant else ""))
    rows = SyntheticLM(num_examples=48, seq_len=16, vocab_size=64, seed=0).tokens[:2, :4]
    np.testing.assert_array_equal(np.asarray(gen["prompt"]), rows)
    np.testing.assert_array_equal(np.asarray(gen["tokens"])[:, :4], rows)
    assert gen["quantize"] == quant and gen["prefill_ms"] > 0 and gen["decode_ms_per_token"] > 0


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main([])
    with pytest.raises(RuntimeError, match="--device cpu"):
        dpp.main(["--model", "gpt2", "--generate", "4"])


def test_reference_flag_checks():
    with pytest.raises(SystemExit, match="--decode-quant only affects --generate"):
        dpp.parse_args(LM_ARGS + ["--decode-quant", "int8"])
    with pytest.raises(SystemExit, match="--generate requires an LM model"):
        dpp.parse_args(["--device", "cpu", "--model", "mlp", "--generate", "4"])
    # The fleet's flags (item 19b) are ported: they parse as the
    # reference's do (test_torch_fleet.py runs them).
    args = serve.parse_args(["--device", "cpu", "--fleet", "1:1", "--kill-engine", "auto", "--kill-after", "1.0"])
    assert (args.fleet, args.kill_engine, args.kill_after) == ("1:1", "auto", 1.0)
    assert not hasattr(serve, "_NOT_PORTED")
    # --store (item 11b) is ported: it parses as the reference's does.
    assert serve.parse_args(["--device", "cpu", "--store", "x"]).store == "x"
