"""The port's ``--pp`` entry point (``dpp``'s pipeline path: the mesh's
``pipe`` axis, the stage model, ``make_pp_train_step`` /
``make_pp_eval_step``, checkpoints and the ``pp_phase`` event) against the
reference's ``dpp.py``, on the CPU.

Eight gloo ranks are spawned once for the file (data 4 x pipe 2).

- ``dpp --pp 2`` (GPT-2 shape, f32, GPipe) and ``--pp 2 --pp-schedule
  1f1b`` (Llama shape: bf16 activations, remat, ``--grad-clip``), each with
  ``--eval``, for 3 steps against the reference's own PP path in its
  ``dpp.py`` (``make_pp_train_step`` and ``make_pp_eval_step`` on the same
  mesh, its model, optimizer and loader), from the port's seeded weights:
  losses, parameters and the eval means.  The reference runs in this
  process, so no reference subprocess needs ``reference_env``.
- A checkpoint under ``--pp 2 --pp-schedule 1f1b`` with AdamW: each stage's
  parameters and optimizer state come back bit for bit and the next step's
  loss is the uninterrupted run's; the payload's merged model loads into a
  plain model whose masked eval equals the pipelined eval's; a checkpoint of
  another interleaved geometry is refused with the reference's message.
- The ``pp_phase`` event of a ``--pp 2 --pp-schedule 1f1b`` run, read by
  the reference's ``measured_bubble_fraction``.
- The flag refusals: the reference's messages, its zb and virtual value
  checks included; what it takes (zb, virtual stages, ``--pp`` with
  ``--cp``) the port takes too.

Tolerances: the GPT-2 run computes in f32 (summation order only): losses
within 1e-5, each parameter within 2e-5, the eval means 1e-5.  The Llama
run computes in bf16, where XLA and PyTorch round intermediates at
different points (``test_torch_context_parallel.py``'s bounds): losses
within 2e-3 over 3 steps, each update (final - initial) within 5e-2 of its
largest |update|, the eval means 2e-3.  A missing pipe sum halves the
embedding's update, a stage's wrong slice moves every layer's.
"""

import dataclasses
import functools
import itertools
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import Ranks  # noqa: E402

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.pipeline_parallel import (  # noqa: E402
    interleave_layer_perm,
    merge_pp_shards,
)
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

COMMON = ["--layers", "4", "--seq-len", "16", "--vocab-size", "64", "--num-examples", "64", "--batch-size", "2",
          "--epochs", "1", "--steps-per-epoch", "3", "--pp", "2"]
RUNS = {
    "gpipe_gpt2": ["--model", "gpt2", "--d-model", "32", "--lr", "0.1", "--eval", *COMMON],
    "1f1b_llama": ["--model", "llama", "--d-model", "64", "--lr", "0.1", "--eval", "--pp-schedule", "1f1b",
                   "--grad-clip", "0.5", *COMMON],
}
TOL = {"gpipe_gpt2": dict(loss_atol=1e-5, param_atol=2e-5), "1f1b_llama": dict(loss_atol=2e-3, update_rtol=5e-2)}
CKPT_FLAGS = ["--model", "gpt2", "--d-model", "32", "--optimizer", "adamw", "--lr", "1e-2", "--pp-schedule", "1f1b",
              *COMMON]
EVENT_FLAGS = CKPT_FLAGS + ["--pp-microbatches", "2", "--log-every", "1"]
BAD_BATCH = RUNS["gpipe_gpt2"] + ["--batch-size", "3"]


@functools.cache
def ref():
    """The JAX side, imported here: the gloo ranks need torch only."""
    import jax
    import jax.numpy as jnp

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp
    from distributeddataparallel_tpu.data.loader import DataLoader, shard_lm_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.observability.pipeline import measured_bubble_fraction
    from distributeddataparallel_tpu.parallel import pipeline_parallel as jpp

    return SimpleNamespace(jax=jax, jnp=jnp, ddp=ddp, jdpp=jdpp, DataLoader=DataLoader, jtfm=jtfm, jpp=jpp,
                           shard_lm_batch=shard_lm_batch, measured_bubble_fraction=measured_bubble_fraction)


def cpu_args(flags):
    return tdpp.parse_args(["--device", "cpu", *flags])


def initial_state_dict(args) -> dict:
    """The whole model ``dpp`` builds from the seed (before the stages)."""
    cfg = tdpp.build_config(args)
    return ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(args.seed)).state_dict()


# ------------------------------------------------------------- rank side --

def dpp_run(flags, rank, world) -> dict:
    """3 steps (and with ``--eval`` the eval) of ``dpp``'s trainer for
    ``flags``: losses, this stage's parameters, its coordinates, the eval
    means."""
    trainer = tdpp.build_trainer(cpu_args(flags), torch.device("cpu"), rank, world)
    trainer.loader.set_epoch(0)
    losses = [float(trainer.step_fn(trainer.state, b)["loss"]) for b in itertools.islice(trainer.loader, 3)]
    out = {"losses": losses, "params": {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()},
           "coords": dict(rt.current_mesh().coords), "eval": None}
    if trainer.eval_step is not None:
        parts = [trainer.eval_step(trainer.state.model, b) for b in trainer.eval_loader]
        total = sum(float(c) for _, c in parts)
        out["eval"] = {k: sum(float(m[k]) * float(c) for m, c in parts) / total for k in parts[0][0]}
    return out


def ckpt_roundtrip(rank, world, directory) -> dict:
    """Save after 2 steps, load into a fresh trainer: parameters, AdamW
    state and the third step's loss against the trainer that goes on; the
    merged model's plain eval against the pipelined eval; an interleaved
    geometry's payload."""
    from distributeddataparallel_tpu_torch.ops.losses import per_example_cross_entropy
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload

    args = cpu_args(CKPT_FLAGS)
    a, b = (tdpp.build_trainer(args, torch.device("cpu"), rank, world) for _ in range(2))
    a.loader.set_epoch(0)
    batches = list(itertools.islice(a.loader, 3))
    for batch in batches[:2]:
        a.step_fn(a.state, batch)
    files = CheckpointFiles(directory)
    payload = host_payload(a.state, 0)
    if rank == 0:
        files.write(a.state, 0, payload)
    rt.barrier()
    saved = files.read(0)
    CheckpointFiles.load_into(b.state, saved)
    same_params = all(torch.equal(x, y) for x, y in zip(a.state.model.state_dict().values(),
                                                        b.state.model.state_dict().values()))
    opt_a, opt_b = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    same_opt = len(opt_a) > 0 and all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    plain = ttfm.TransformerLM(tdpp.build_config(args))
    plain.load_state_dict(saved["model"])
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (2, 17)))  # the same on every rank
    with torch.no_grad():
        plain_loss = float(per_example_cross_entropy(plain.eval()(tokens[:, :-1]), tokens[:, 1:]).mean())
    eval_step = tdpp.pipeline_parallel.make_pp_eval_step(tdpp.build_config(args), microbatches=2)
    pp_loss = float(eval_step(b.state.model, {"tokens": tokens, "valid": torch.ones(len(tokens))})[0]["loss"])
    losses = [float(t.step_fn(t.state, batches[2])["loss"]) for t in (a, b)]
    try:
        CheckpointFiles.load_into(b.state, dict(saved, pp_virtual=2))
        refusal = "none"
    except ValueError as e:
        refusal = str(e)
    return {"same_params": same_params, "same_opt": same_opt, "losses": losses, "refusal": refusal,
            "plain_loss": plain_loss, "pp_loss": pp_loss, "layers_in_payload": len(
                {k.split(".")[1] for k in saved["model"] if k.startswith("layers.")})}


def event_run(rank, world, directory) -> dict:
    """``dpp.train`` for EVENT_FLAGS with ``--events-dir``: rank 0's summary."""
    args = cpu_args(EVENT_FLAGS + ["--events-dir", directory])
    summary = tdpp.train(args, tdpp.build_trainer(args, torch.device("cpu"), rank, world), torch.device("cpu"),
                         rank, world)
    return {"losses": summary["losses"]}


def bad_batch_message(rank, world) -> str:
    try:
        tdpp.build_trainer(cpu_args(BAD_BATCH), torch.device("cpu"), rank, world)
    except SystemExit as e:
        return str(e)
    return "no error"


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: dpp_run(flags, rank, world) for name, flags in RUNS.items()}
        res["ckpt"] = ckpt_roundtrip(rank, world, str(Path(out_dir) / "ckpt"))
        res["events"] = event_run(rank, world, str(Path(out_dir) / "events"))
        res["bad_batch"] = bad_batch_message(rank, world)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("pp_cli_ranks"))
    yield r
    r.get()


# ------------------------------------------------------------- JAX side --

def logical_layers(params, L: int, n: int, v: int):
    """A reference pipelined state's params with the stacked layer leaves
    back in logical order (``shard_state_pp(virtual=v)`` stores them in
    ``interleave_layer_perm`` order)."""
    if v == 1:
        return params
    inv = np.argsort(np.asarray(interleave_layer_perm(L, n, v)))
    return {**params, "layers": ref().jax.tree.map(lambda a: np.asarray(a)[inv], params["layers"])}


def jax_dpp_pp_run(flags, world=8, steps=3) -> dict:
    """The reference ``dpp.py``'s PP path for ``flags`` on ``world`` fake
    devices (``dpp.py:1459-1470``, ``:1606-1629``, ``:2000-2015``): its
    mesh (data, seq, pipe), model, optimizer, loaders (``shard_lm_batch``
    under ``--cp``), ``make_pp_train_step`` and, with ``--eval``,
    ``make_pp_eval_step``, from the port's seeded initial weights; the final
    params in logical layer order."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    jargs = R.jdpp.parse_args(["--device", "cpu", *flags])
    targs = cpu_args(flags)
    tcfg = tdpp.build_config(targs)
    params0 = to_jax_params(initial_state_dict(targs), tcfg)
    axes, sizes = ["data"], []
    for degree, axis in ((jargs.cp, "seq"), (jargs.pp, "pipe")):
        if degree > 1:
            axes.append(axis)
            sizes.append(degree)
    mesh = ddp.make_mesh(tuple(axes), shape=(world // math.prod(sizes), *sizes), devices=jax.devices()[:world])
    dataset = R.jdpp.build_dataset(jargs, train=True)
    jcfg = dataclasses.replace(R.jdpp.build_model(jargs, vocab_size=dataset.vocab_size).cfg, attn_impl="xla")
    M, v = jargs.pp_microbatches or jargs.pp, jargs.pp_virtual
    state = R.jpp.shard_state_pp(ddp.TrainState.create(apply_fn=None, params=params0,
                                                       tx=R.jdpp.build_optimizer(jargs, total_steps=steps)), mesh,
                                 virtual=v)
    step = R.jpp.make_pp_train_step(jcfg, mesh=mesh, microbatches=M, donate=False, schedule=jargs.pp_schedule,
                                    grad_clip=jargs.grad_clip, moe_aux_weight=0.0, virtual=v)
    place = (lambda b: R.shard_lm_batch(b["tokens"], mesh)) if jargs.cp > 1 else None
    loader = R.DataLoader(dataset, per_replica_batch=jargs.batch_size, mesh=mesh, shuffle=True, seed=jargs.seed,
                          place_fn=place)
    loader.set_epoch(0)
    losses = []
    for batch in itertools.islice(loader, steps):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    out = {"losses": losses, "params0": params0, "cfg": tcfg, "virtual": v, "eval": None,
           "params": logical_layers(jax.tree.map(np.asarray, state.params), tcfg.num_layers, jargs.pp, v)}
    if jargs.eval:
        evaluate = R.jpp.make_pp_eval_step(jcfg, mesh=mesh, microbatches=M)
        eval_loader = R.DataLoader(R.jdpp.build_dataset(jargs, train=False), per_replica_batch=jargs.batch_size,
                                   mesh=mesh, shuffle=False, seed=jargs.seed, drop_last=False, with_mask=True)
        parts = [evaluate(state.params, b) for b in eval_loader]
        total = sum(float(c) for _, c in parts)
        out["eval"] = {k: sum(float(m[k]) * float(c) for m, c in parts) / total for k in parts[0][0]}
    return out


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's runs, computed while the ranks work."""
    return {name: jax_dpp_pp_run(flags) for name, flags in RUNS.items()}


def port_params(runs, cfg, virtual: int = 1) -> dict:
    """The whole model as the reference's tree, in logical layer order: the
    stages of the ranks at data (and seq) index 0."""
    stages = sorted((r["coords"]["pipe"], r["params"]) for r in runs
                    if r["coords"]["data"] == 0 and r["coords"].get("seq", 0) == 0)
    return to_jax_params(merge_pp_shards([sd for _, sd in stages], virtual), cfg)


def check_run(ranks, want, name):
    jax = ref().jax
    tol, w = TOL[name], want[name]
    runs = [r[name] for r in ranks.get()]
    for run in runs:  # every rank reports the global (mean) loss and eval
        np.testing.assert_allclose(run["losses"], w["losses"], atol=tol["loss_atol"], rtol=0, err_msg=name)
        for k, v in w["eval"].items():
            assert abs(run["eval"][k] - v) <= tol["loss_atol"], f"{name} eval {k}: {run['eval'][k]} vs {v}"
    got = port_params(runs, w["cfg"])
    flat = jax.tree_util.tree_flatten_with_path(w["params"])[0]
    for (path, b), a, p0 in zip(flat, jax.tree.leaves(got), jax.tree.leaves(w["params0"])):
        where = f"{name} {jax.tree_util.keystr(path)}"
        if "param_atol" in tol:
            np.testing.assert_allclose(a, b, atol=tol["param_atol"], rtol=0, err_msg=where)
        else:
            scale, err = float(np.abs(b - p0).max()), float(np.abs((a - p0) - (b - p0)).max())
            assert err <= tol["update_rtol"] * scale + 1e-7, f"{where}: update off by {err} (largest {scale})"


# ----------------------------------------------------------------- tests --

def test_dpp_pp_gpipe_matches_reference(ranks, want):
    check_run(ranks, want, "gpipe_gpt2")


def test_dpp_pp_1f1b_llama_matches_reference(ranks, want):
    check_run(ranks, want, "1f1b_llama")


def test_pp_checkpoint_round_trip(ranks):
    for r in ranks.get():
        c = r["ckpt"]
        assert c["same_params"] and c["same_opt"], c
        assert c["losses"][0] == c["losses"][1], c["losses"]
        assert c["layers_in_payload"] == 4 and abs(c["plain_loss"] - c["pp_loss"]) <= 1e-6, c
        assert c["refusal"] == ("checkpoint layer storage is interleaved for (pp=2, virtual=2) but this run is "
                                "(pp=2, virtual=1) — interleaved layouts resume only at their exact pipeline "
                                "geometry"), c["refusal"]


def test_pp_phase_event_is_read_by_the_reference_report(ranks, tmp_path_factory):
    """One ``pp_phase`` event per rank's file; the merged timeline's, read
    by the reference's ``measured_bubble_fraction``, shows every stage's M
    forward and M backward units and the analytic bubble."""
    ranks.get()
    timeline = ranks.out / "events" / "timeline.jsonl"
    records = [json.loads(line) for line in timeline.read_text().splitlines()]
    assert sum(r["kind"] == "pp_phase" for r in records) == 8
    got = ref().measured_bubble_fraction(records)
    assert got["schedule"] == "1f1b" and got["n_stages"] == 2 and got["microbatches"] == 2
    assert [[s["F"], s["B"], s["W"]] for s in got["per_stage"]] == [[2, 2, 0], [2, 2, 0]]
    assert got["measured_bubble_fraction"] == got["analytic_bubble_fraction"] == ref().jpp.pp_bubble_fraction(
        2, 2)["bubble_fraction"]


REFUSALS = [
    (["--model", "cnn", "--pp", "2"], SystemExit, "--pp requires an LM model"),
    (["--model", "gpt2", "--pp", "2", "--bucket-mb", "1"], SystemExit, "--pp does not support --bucket-mb"),
    (["--model", "gpt2", "--layers", "3", "--pp", "2"], SystemExit, "--layers 3 must be divisible by --pp 2"),
    (["--model", "gpt2", "--pp", "2", "--overlap"], SystemExit, "--overlap applies to the DP all-reduce; drop --pp"),
    (["--model", "gpt2", "--pp", "2", "--grad-compress", "bf16"], SystemExit, "drop --zero/--fsdp/--pp"),
    (["--model", "gpt2", "--pp", "2", "--generate", "4"], SystemExit, "--generate needs replicated params"),
    (["--model", "gpt2", "--pp", "2", "--zero", "2"], SystemExit, "--zero 2 shards over the data axis only; drop --pp"),
    (["--model", "gpt2", "--pp", "2", "--dropout", "0.1"], SystemExit, "--fsdp and --pp do not support it"),
    (["--model", "gpt2", "--pp", "2", "--nan-guard"], SystemExit, "drop --fsdp/--pp"),
    (["--model", "gpt2", "--pp", "2", "--tp", "2", "--moe-experts", "2", "--ep", "2"], SystemExit,
     "--ep with BOTH --pp and --tp is untested"),
    (["--model", "gpt2", "--pp", "2", "--cp", "2", "--eval"], SystemExit, "--pp --eval does not support --cp"),
    (["--model", "gpt2", "--pp", "2", "--pp-schedule", "zb", "--pp-microbatches", "1"], SystemExit,
     "--pp-schedule zb needs --pp-microbatches >= --pp"),
    (["--model", "gpt2", "--pp", "2", "--cp", "2", "--pp-schedule", "zb"], SystemExit,
     "--pp-schedule zb does not compose with --cp yet"),
    (["--model", "gpt2", "--pp", "2", "--pp-schedule", "zb", "--moe-experts", "2"], SystemExit,
     "--pp-schedule zb does not support the MoE aux loss"),
    (["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-virtual", "2"], SystemExit,
     "--pp-virtual requires --pp-schedule 1f1b or zb"),
    (["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-schedule", "zb", "--pp-virtual", "2", "--zero", "1"],
     SystemExit, "--pp-virtual does not compose with --zero yet"),
    (["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2", "--eval"],
     SystemExit, "--pp-virtual does not support --eval/--generate"),
    (["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "3"], SystemExit,
     "--layers 4 must be divisible by --pp 2 x --pp-virtual 3"),
]
ACCEPTED = [
    ["--model", "gpt2", "--pp", "2", "--pp-schedule", "zb"],
    ["--model", "gpt2", "--layers", "4", "--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"],
    ["--model", "gpt2", "--pp", "2", "--cp", "2"],
]


def test_pp_flag_refusals(ranks):
    """What the reference refuses, the port refuses with its message
    (parse time; the batch check at the trainer's build, as the
    reference's); what it takes, the port takes."""
    jdpp = ref().jdpp
    for flags, err, match in REFUSALS:
        argv = ["--device", "cpu", *flags]
        with pytest.raises(err, match=match):
            jdpp.validate_args(jdpp.parse_args(argv))
        with pytest.raises(err, match=match):
            tdpp.parse_args(argv)
    for flags in ACCEPTED:
        argv = ["--device", "cpu", *flags]
        jargs = jdpp.parse_args(argv)
        jdpp.validate_args(jargs)
        args = tdpp.parse_args(argv)
        assert (args.pp_schedule, args.pp_virtual, args.cp) == (jargs.pp_schedule, jargs.pp_virtual, jargs.cp)
    for r in ranks.get():
        assert r["bad_batch"] == "--batch-size 3 must be divisible by --pp-microbatches 2"
