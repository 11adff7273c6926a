"""Activation checkpointing (``remat``) and residual dropout in the port, on
the CPU.

- remat on and off give the same logits and gradients, bit for bit, with
  dropout off and on: a checkpointed block's recompute draws the same
  masks (they come from a seed, not from the default generator that
  ``torch.utils.checkpoint`` saves and restores), and each block runs
  twice under remat.
- Dropout against flax's ``nn.Dropout`` (the reference's): the same
  distribution (keep rate within 5 standard deviations of the binomial's
  1 - rate, for the port's masks and for flax's), the same kept values
  exactly (x / (1 - rate), 1 - rate rounded to the input dtype as flax's
  weakly typed keep_prob is), zeros elsewhere.  The bits
  of the masks differ (Philox against threefry), so no mask is compared.
- Masks are functions of their seed; eval is deterministic; the train step
  folds the step's seed with the rank and the microbatch; ``dpp``'s step
  seed is a function of (seed + 1, epoch, step), so a ``--resume`` continues
  the uninterrupted run's losses exactly; two gloo ranks train with dropout
  and reproduce; the flags are validated as the reference validates them.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch import dpp as tdpp
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.ops.dropout import dropout, fold_seed
from distributeddataparallel_tpu_torch.training import train_step as ts
from distributeddataparallel_tpu_torch.training.state import TrainState
from torch_cores import share_of_the_cores  # noqa: F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=1, d_model=64, d_ff=128, max_seq_len=16)
TINY = ["--device", "cpu", "--model", "llama", "--layers", "2", "--d-model", "64", "--seq-len", "16",
        "--vocab-size", "64", "--num-examples", "32", "--batch-size", "4", "--optimizer", "adamw",
        "--lr", "1e-2", "--log-every", "1000"]


def _run(remat: bool, dtype, rate: float, impl: str):
    cfg = ttfm.llama3_8b(**KW, dtype=dtype, remat=remat, dropout_rate=rate, attn_impl=impl)
    model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).train()
    calls = []
    for layer in model.layers:  # counts the recompute too (forward hooks skip it)
        layer.forward = lambda *a, f=layer.forward: (calls.append(1), f(*a))[1]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, size=(2, 16))).long()
    logits = model(toks, dropout_seed=77 if rate else None)
    logits.pow(2).mean().backward()
    return logits.detach(), {n: p.grad for n, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("dtype,rate,impl", [
    (torch.float32, 0.0, "plain"), (torch.float32, 0.1, "kernel"), (torch.bfloat16, 0.1, "plain"),
])
def test_remat_gives_identical_gradients(dtype, rate, impl):
    on, off = _run(True, dtype, rate, impl), _run(False, dtype, rate, impl)
    assert on[2] == 2 * KW["num_layers"] and off[2] == KW["num_layers"]  # the recompute ran
    assert torch.equal(on[0], off[0])
    assert on[1].keys() == off[1].keys()
    for n in on[1]:
        assert torch.equal(on[1][n], off[1][n]), n


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)])
def test_dropout_matches_flax_distribution(tdt, jdt):
    rate, shape = 0.1, (64, 4096)
    x = np.random.default_rng(2).uniform(0.5, 2.0, size=shape).astype(np.float32)
    ours = dropout(torch.from_numpy(x).to(tdt), rate, seed=5).float().numpy()
    ref = nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x).astype(jdt), rngs={"dropout": jax.random.PRNGKey(5)})
    ref = np.asarray(ref.astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    kept_value = (xt / torch.tensor(1.0 - rate, dtype=tdt)).float().numpy()
    n, p = x.size, 1.0 - rate
    bound = 5 * math.sqrt(n * p * (1 - p))
    for out in (ours, ref):
        kept = out != 0
        assert abs(int(kept.sum()) - n * p) <= bound
        np.testing.assert_array_equal(out[kept], kept_value[kept])
    np.testing.assert_array_equal(ref[ref != 0], kept_value[ref != 0])
    assert not np.array_equal(ours != 0, ref != 0)  # another generator's bits


def test_masks_are_functions_of_the_seed():
    x = torch.ones(32, 256)
    state = torch.get_rng_state()
    a, b, c = dropout(x, 0.2, 9), dropout(x, 0.2, 9), dropout(x, 0.2, 10)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.get_rng_state(), state)  # the default generator is untouched
    assert fold_seed(1, 2, 3) == fold_seed(1, 2, 3) != fold_seed(1, 3, 2)
    assert 0 <= fold_seed(2**40, 7) < 2**64


def test_eval_is_deterministic_and_training_needs_a_seed():
    cfg = ttfm.llama3_8b(**KW, dtype=torch.float32, dropout_rate=0.3)
    model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    plain = ttfm.TransformerLM(ttfm.llama3_8b(**KW, dtype=torch.float32))
    plain.load_state_dict(model.state_dict())
    toks = torch.arange(32).view(2, 16) % 64
    with torch.no_grad():
        model.eval()
        first, second = model(toks), model(toks, dropout_seed=3)
        assert torch.equal(first, second) and torch.equal(first, plain.eval()(toks))
        model.train()
        assert not torch.equal(model(toks, dropout_seed=3), first)
        with pytest.raises(ValueError, match="dropout_seed"):
            model(toks)


def test_train_step_folds_rank_and_microbatch(monkeypatch):
    seen = []

    def loss_fn(model, batch, seed=None):
        seen.append(seed)
        return model(batch["x"]).pow(2).mean(), {}

    model = torch.nn.Linear(3, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    state = TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0))
    step = ts.make_train_step(loss_fn, accum_steps=2)
    batch = {"x": torch.ones(4, 3)}
    for rank in (0, 1, 0):
        monkeypatch.setattr(ts, "get_rank", lambda r=rank: r)
        step(state, batch, 123)
    assert seen[0:2] == [fold_seed(123, 0, 0), fold_seed(123, 0, 1)]
    assert seen[2:4] == [fold_seed(123, 1, 0), fold_seed(123, 1, 1)]
    assert seen[4:6] == seen[0:2] and len(set(seen[:4])) == 4
    step(state, batch)
    assert seen[6:] == [None, None]  # without a seed the loss_fn gets none


def test_step_seed_follows_seed_epoch_and_step():
    args = tdpp.parse_args(TINY + ["--dropout", "0.1", "--seed", "4"])
    assert tdpp.step_seed(args, 2, 3) == fold_seed(5, 2, 3)
    seeds = {tdpp.step_seed(args, e, s) for e in range(3) for s in range(4)}
    assert len(seeds) == 12
    assert tdpp.step_seed(tdpp.parse_args(TINY), 2, 3) is None


def test_resume_with_dropout_continues_the_same_losses(tmp_path):
    flags = TINY + ["--dropout", "0.1", "--accum-steps", "2", "--num-examples", "16"]
    straight = tdpp.main(flags + ["--epochs", "3"])
    tdpp.main(flags + ["--epochs", "2", "--checkpoint-dir", str(tmp_path)])
    resumed = tdpp.main(flags + ["--epochs", "3", "--checkpoint-dir", str(tmp_path), "--resume"])
    spe = 4
    assert resumed["start_epoch"] == 2 and resumed["train_steps"] == spe
    assert resumed["losses"] == straight["losses"][2 * spe:]
    assert resumed["param_norm"] == straight["param_norm"]


def _cli(*args, timeout=240):
    out = subprocess.run(
        [sys.executable, "-m", "distributeddataparallel_tpu_torch.dpp", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_two_gloo_ranks_train_with_dropout():
    """Two ranks with dropout (each rank its own masks) train, evaluate and
    reproduce their losses exactly on a second run."""
    flags = [*TINY, "--dropout", "0.2", "--epochs", "1", "--eval", "--num-processes", "2"]
    a, b = _cli(*flags), _cli(*flags)
    assert a["world_size"] == 2 and a["train_steps"] == 4
    assert all(np.isfinite(a["losses"])) and np.isfinite(a["eval"]["loss"])
    assert a["losses"] == b["losses"] and a["param_norm"] == b["param_norm"]


def test_dropout_and_remat_flags_are_validated(capsys):
    for flags, message in ((["--dropout", "1.0"], "must be in"),
                           (["--model", "cnn", "--dropout", "0.1"], "LM models"),
                           (["--model", "cnn", "--remat", "on"], "LM models")):
        with pytest.raises(SystemExit):
            tdpp.parse_args(["--device", "cpu", "--model", "llama", *flags])
        assert message in capsys.readouterr().err
