"""The port's optimizer mapping, train step and entry point against the JAX
package's, on the CPU.

- The LR schedules follow optax step by step.
- Three train steps of the port equal three steps of the reference's
  ``make_train_step`` on a 1-device CPU mesh, for SGD with momentum and for
  AdamW with warmup + cosine, with ``accum_steps``, ``bucket_bytes`` and
  ``grad_clip`` on.  Tolerance: f32 with different summation orders over
  three updates, atol 2e-5 / rtol 1e-4 on losses and params.
- The DDP invariant: 2 gloo processes give the result of 1 process on the
  global batch.
- ``dpp.main`` runs end to end with ``--device cpu`` and refuses to fall
  back to the CPU when ``--device cuda`` finds no GPU.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  the reference entry point

import distributeddataparallel_tpu as ddp  # noqa: E402
from distributeddataparallel_tpu.models import transformer as jtfm  # noqa: E402
from distributeddataparallel_tpu.ops import accuracy as j_accuracy  # noqa: E402
from distributeddataparallel_tpu.ops import lm_cross_entropy as j_lm_ce  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import (  # noqa: E402
    make_eval_step,
    make_train_step,
)
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

TOL = dict(atol=2e-5, rtol=1e-4)
TINY = ["--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16", "--vocab-size", "64",
        "--num-examples", "48", "--epochs", "1", "--log-every", "1000"]


@pytest.mark.parametrize("flags", [
    ["--lr", "0.1"],
    ["--lr", "0.1", "--lr-schedule", "cosine", "--warmup-steps", "3", "--min-lr", "0.01"],
    ["--lr", "0.2", "--lr-schedule", "linear", "--min-lr", "0.05"],
    ["--lr", "0.1", "--warmup-steps", "4"],
])
def test_lr_schedule_follows_optax(flags):
    """The LR used by each optimizer step equals the reference's optax
    schedule at that step (read off a unit-gradient SGD update)."""
    total, n = 10, 13
    tx = jdpp.build_optimizer(jdpp.parse_args(["--device", "cpu"] + flags), total_steps=total)
    params = {"w": jnp.ones(())}
    state = tx.init(params)
    ref = []
    for _ in range(n):
        upd, state = tx.update({"w": jnp.ones(())}, state, params)
        ref.append(-float(upd["w"]))
    opt, sched = build_optimizer(tdpp.parse_args(["--device", "cpu"] + flags),
                                 [torch.nn.Parameter(torch.ones(()))], total)
    got = []
    for _ in range(n):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("flags", [
    pytest.param(["--optimizer", "sgd", "--lr", "0.05", "--momentum", "0.9"], id="sgd-momentum"),
    pytest.param(["--optimizer", "adamw", "--lr", "1e-2", "--weight-decay", "0.1",
                  "--lr-schedule", "cosine", "--warmup-steps", "1", "--min-lr", "1e-3"],
                 id="adamw-warmup-cosine"),
])
def test_train_steps_match_jax(flags):
    """3 steps, accum_steps=2, ~1 KiB buckets, grad_clip 0.5 (binding)."""
    kw = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=128, max_seq_len=16)
    jcfg, tcfg = jtfm.gpt2_124m(attn_impl="xla", **kw), ttfm.gpt2_124m(**kw)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 64, size=(4, 17)).astype(np.int32) for _ in range(3)]
    steps, bucket_bytes, clip = 3, 1024, 0.5

    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batches[0][:, :-1]))["params"]
    tx = jdpp.build_optimizer(jdpp.parse_args(["--device", "cpu"] + flags), total_steps=steps)

    def jloss(p, batch, rng):
        toks = batch["tokens"]
        logits = jmodel.apply({"params": p}, toks[:, :-1])
        return j_lm_ce(logits, toks[:, 1:]), {"accuracy": j_accuracy(logits, toks[:, 1:])}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jstate = ddp.broadcast_params(
        ddp.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx), mesh
    )
    jstep = ddp.make_train_step(jloss, mesh=mesh, accum_steps=2, bucket_bytes=bucket_bytes,
                                grad_clip=clip, donate=False)
    j_losses = []
    for b in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)}, jax.random.PRNGKey(0))
        j_losses.append(float(m["loss"]))

    model = ttfm.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    opt, sched = build_optimizer(tdpp.parse_args(["--device", "cpu"] + flags),
                                 model.parameters(), steps)
    state = TrainState(model, opt, sched)
    step = make_train_step(tdpp._loss_fn, accum_steps=2, bucket_bytes=bucket_bytes, grad_clip=clip)
    losses = [float(step(state, {"tokens": torch.from_numpy(b).long()})["loss"]) for b in batches]

    assert state.step == steps
    np.testing.assert_allclose(losses, j_losses, **TOL)
    expected = from_jax_params(jstate.params, tcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(), err_msg=name, **TOL)


def test_masked_eval_step_weights_by_valid_rows():
    model = ttfm.TransformerLM(ttfm.gpt2_124m(vocab_size=32, num_layers=1, num_heads=2,
                                              d_model=16, d_ff=32, max_seq_len=8),
                               generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 32, size=(4, 9))).long()
    ev = make_eval_step(tdpp._metric_fn)
    means, count = ev(model, {"tokens": toks, "valid": torch.tensor([1.0, 1.0, 0.0, 1.0])})
    with torch.no_grad():
        rows = tdpp._metric_fn(model, {"tokens": toks[[0, 1, 3]]})
    assert float(count) == 3.0
    np.testing.assert_allclose(float(means["loss"]), float(rows["loss"].mean()), rtol=1e-6)


def _cli(*args, timeout=240):
    out = subprocess.run(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ddp_two_gloo_processes_match_one_process_global_batch():
    """Per-step losses, eval and final params of 2 ranks x batch 4 equal
    1 rank x batch 8: the sampler gives the 2 ranks the rows of the global
    batch, and the mean all-reduce makes their update the global one."""
    common = ["--device", "cpu", *TINY, "--eval", "--optimizer", "sgd",
              "--momentum", "0.9", "--lr", "0.1", "--bucket-mb", "0.01"]
    two = _cli(*common, "--batch-size", "4", "--num-processes", "2")
    one = _cli(*common, "--batch-size", "8")
    assert two["world_size"] == 2 and one["world_size"] == 1
    assert two["train_steps"] == one["train_steps"] == 6
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(two["eval"]["loss"], one["eval"]["loss"], rtol=1e-5)
    np.testing.assert_allclose(two["param_norm"], one["param_norm"], rtol=1e-6)


def test_dpp_main_cpu_end_to_end():
    summary = tdpp.main(["--device", "cpu", *TINY, "--batch-size", "4", "--eval",
                         "--optimizer", "adamw", "--lr", "1e-2", "--accum-steps", "2",
                         "--grad-clip", "1.0", "--lr-schedule", "cosine", "--warmup-steps", "2"])
    losses = summary["losses"]
    assert summary["train_steps"] == 12 and summary["device"] == "cpu"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert summary["eval_batches"] == 12 and np.isfinite(summary["eval"]["loss"])


def test_dpp_main_without_cpu_flag_needs_a_gpu():
    """--device defaults to cuda and raises without a GPU rather than
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdpp.main(TINY)


def test_layouts_outside_the_slice_raise():
    """The reference's in-scan gradient sync is outside the port: it
    refuses, naming where it stands."""
    with pytest.raises(NotImplementedError, match="grad_sync_axis.*--overlap"):
        ttfm.TransformerLM(ttfm.llama3_8b(vocab_size=32, num_layers=1, num_heads=2, num_kv_heads=1,
                                          d_model=16, d_ff=32, max_seq_len=8, grad_sync_axis="data"))
