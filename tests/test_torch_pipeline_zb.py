"""The port's zero-bubble schedule and interleaved virtual stages
(``parallel.pipeline_parallel``: ``schedule="zb"``, ``virtual``) against the
JAX package's, on the CPU.

Four gloo ranks are spawned once for the file; every case reads what they
computed.  The weights are the port's seeded ones (``tiny_lm`` with scanned
layers, d_model 32), carried to the reference by ``to_jax_params``; every
stage holds its part through ``stage_model(..., virtual=)``, the shard the
reference's ``shard_state_pp(virtual=)`` places (checked leaf for leaf
through ``from_jax_params``).  Token batches are numpy-seeded.  The
reference runs ``make_pp_train_step`` on its fake CPU devices at the same
mesh, microbatch count and virtual chunks.

- ZB at n = 2 (M = 3, not divisible by n) and n = 4 (M = 6), v = 1 and 2:
  against the reference's ZB or 1F1B step (its ZB is not bitwise its 1F1B
  on this tree, so both are f32 oracles), and the port's ZB against the
  port's 1F1B bit for bit (losses, first-step gradients, final weights).
- Interleaved 1F1B (8 layers, n = 2, v = 2, M = 4: the reference's
  ``test_interleaved_1f1b_matches_single_device``) against one device and
  the reference's interleaved step; 3 Adam steps of interleaved 1F1B
  against the port's GPipe and one device.
- Each stage's executed [F, B, W] units and ``step.bubble_accounting``
  against the reference step's ``pp_phase_counts`` and accounting.
- A checkpoint of a ``--pp 2 --pp-virtual 2`` run: parameters and AdamW
  state bit for bit, the next loss the uninterrupted run's, the payload's
  model in logical layer order (a plain model's loss on it is the
  pipelined step's), and its refusal at another (pp, virtual).
- ``dpp --pp 2 --pp-schedule zb``, ``--pp-schedule 1f1b --pp-virtual 2`` and
  ``--pp-schedule zb --pp-virtual 2`` for 3 steps against the reference
  ``dpp.py``'s PP path on the same mesh, loader and seed.

Tolerances (the reference's own PP tests' bounds): f32 throughout, so the
two sides differ by summation order only: losses within 1e-5 relative,
parameters within 2e-5.  Interleaved 1F1B against GPipe over 3 Adam steps:
losses within 2e-5 relative (the reference's
``test_interleaved_1f1b_multi_step_matches_gpipe``), parameters within 2e-5
with Adam's eps at 1e-4 (``test_torch_pipeline.py``'s reason).  A chunk on
the wrong stage, a wrap link's swapped message or a missing W moves every
gradient of a layer by far more.
"""

import dataclasses
import functools
import itertools
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import Ranks  # noqa: E402
from test_torch_pipeline_cli import (  # noqa: E402
    cpu_args,
    dpp_run,
    jax_dpp_pp_run,
    logical_layers,
    port_params,
)

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import pipeline_parallel as tpp  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

SMALL = dict(num_heads=2, d_model=32, d_ff=64, max_seq_len=32, scan_layers=True)
# name -> ((data, pipe), layers, M, virtual, port schedules, reference schedule, optimizer, lr, seed, rows, steps)
CASES = {
    "n2_m3": ((2, 2), 4, 3, 1, ("zb", "1f1b"), "zb", "sgd", 0.1, 0, 6, 2),
    "n4_m6": ((1, 4), 4, 6, 1, ("zb", "1f1b"), "1f1b", "sgd", 0.1, 1, 6, 2),
    "n2_v2": ((2, 2), 8, 4, 2, ("zb", "1f1b"), "1f1b", "sgd", 0.1, 2, 8, 1),
    "n4_v2": ((1, 4), 8, 6, 2, ("zb", "1f1b"), "zb", "sgd", 0.1, 3, 6, 2),
    "v2_adam": ((2, 2), 4, 4, 2, ("1f1b", "gpipe"), None, "adam", 1e-2, 4, 8, 3),
}
WORLD = 4
LOSS_REL, PARAM_ATOL, MULTI_STEP_REL = 1e-5, 2e-5, 2e-5
ADAM_EPS = 1e-4
DPP_COMMON = ["--model", "gpt2", "--d-model", "32", "--layers", "4", "--seq-len", "16", "--vocab-size", "64",
              "--num-examples", "64", "--batch-size", "4", "--epochs", "1", "--steps-per-epoch", "3", "--lr", "0.1",
              "--pp", "2"]
DPP_RUNS = {
    "zb": DPP_COMMON + ["--pp-schedule", "zb"],
    "1f1b_v2": DPP_COMMON + ["--pp-schedule", "1f1b", "--pp-virtual", "2"],
    "zb_v2": DPP_COMMON + ["--pp-schedule", "zb", "--pp-virtual", "2"],
}
CKPT_FLAGS = ["--model", "gpt2", "--d-model", "32", "--layers", "4", "--seq-len", "16", "--vocab-size", "64",
              "--num-examples", "64", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "3",
              "--optimizer", "adamw", "--lr", "1e-2", "--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"]


@functools.cache
def ref():
    """The JAX side, imported here: the gloo ranks need torch only."""
    import jax
    import jax.numpy as jnp
    import optax

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.data.loader import shard_batch, shard_lm_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import lm_cross_entropy
    from distributeddataparallel_tpu.parallel import pipeline_parallel as jpp

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, ddp=ddp, shard_batch=shard_batch,
                           shard_lm_batch=shard_lm_batch, jtfm=jtfm, lm_ce=lm_cross_entropy, jpp=jpp)


def case_cfg(name):
    return ttfm.tiny_lm(**SMALL, num_layers=CASES[name][1])


def case_tokens(name):
    *_, seed, rows, steps = CASES[name]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(rows, 17)).astype(np.int64) for _ in range(steps)]


def seeded_state_dict(cfg) -> dict:
    return ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()


# ------------------------------------------------------------- rank side --

def _optimizer(kind, lr, params):
    return torch.optim.Adam(params, lr=lr, eps=ADAM_EPS) if kind == "adam" else torch.optim.SGD(params, lr=lr)


def run_case(name, schedule) -> dict:
    """The case's steps on this rank: losses, this stage's parameters, the
    first step's gradients, the unit counts, the accounting, its place."""
    shape, _, M, v, _, _, opt, lr, *_ = CASES[name]
    mesh = rt.make_mesh(("data", "pipe"), shape)
    cfg = case_cfg(name)
    virtual = 1 if schedule == "gpipe" else v
    model = tpp.stage_model(cfg, seeded_state_dict(cfg), mesh.index("pipe"), shape[1], virtual=virtual)
    state = TrainState(model, _optimizer(opt, lr, model.parameters()))
    step = tpp.make_pp_train_step(cfg, microbatches=M, schedule=schedule, virtual=virtual)
    d = mesh.index("data")
    losses, grads, counts = [], None, None
    for tokens in case_tokens(name):
        m = step(state, {"tokens": torch.from_numpy(tokens).chunk(shape[0])[d]})
        losses.append(float(m["loss"]))
        counts = m.get("pp_phase_counts")
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    return {"losses": losses, "params": {k: t.detach().clone() for k, t in model.state_dict().items()},
            "grads": grads, "counts": counts, "accounting": step.bubble_accounting, "virtual": virtual,
            "coords": dict(mesh.coords)}


def ckpt_roundtrip(rank, world, directory) -> dict:
    """Save a ``--pp-virtual 2`` run after 2 steps, load it into a fresh
    trainer: parameters, AdamW state and the next loss; the payload's model
    in a plain model; the geometry guard."""
    from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy
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
        plain_loss = float(lm_cross_entropy(plain(tokens[:, :-1]), tokens[:, 1:]))
    # Each step's loss is the one before its update: on ``tokens``, the
    # saved model's; then on the third batch, the same for both trainers.
    pp_losses = [float(t.step_fn(t.state, {"tokens": tokens})["loss"]) for t in (a, b)]
    losses = [float(t.step_fn(t.state, batches[2])["loss"]) for t in (a, b)]
    refusals = []
    for other in (dict(saved, pp_virtual=1), dict(saved, mesh={"axes": ["data", "pipe"], "shape": [2, 4]})):
        try:
            CheckpointFiles.load_into(b.state, other)
            refusals.append("none")
        except ValueError as e:
            refusals.append(str(e))
    return {"same_params": same_params, "same_opt": same_opt, "losses": pp_losses + losses, "plain_loss": plain_loss,
            "pp_loss": pp_losses[1], "refusals": refusals, "pp_virtual": saved.get("pp_virtual")}


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: {s: run_case(name, s) for s in CASES[name][4]} for name in CASES}
        res["ckpt"] = ckpt_roundtrip(rank, world, str(Path(out_dir) / "ckpt"))
        res["dpp"] = {name: dpp_run(flags, rank, world) for name, flags in DPP_RUNS.items()}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("pp_zb_ranks"), world=WORLD)
    yield r
    r.get()


# ------------------------------------------------------------- JAX side --

def _tx(kind, lr):
    optax = ref().optax
    return optax.adam(lr, eps=ADAM_EPS) if kind == "adam" else optax.sgd(lr)


def jax_single_device(name) -> dict:
    """The reference's single-device steps for the case."""
    R = ref()
    jax = R.jax
    _, L, *_, opt, lr, _, _, _ = CASES[name]
    cfg = case_cfg(name)
    model = R.jtfm.TransformerLM(R.jtfm.tiny_lm(attn_impl="xla", **SMALL, num_layers=L))
    params = to_jax_params(seeded_state_dict(cfg), cfg)
    tx = _tx(opt, lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, toks):
        val, g = jax.value_and_grad(lambda q: R.lm_ce(model.apply({"params": q}, toks[:, :-1]), toks[:, 1:]))(p)
        upd, s = tx.update(g, s, p)
        return R.optax.apply_updates(p, upd), s, val

    losses = []
    for tokens in case_tokens(name):
        params, opt_state, val = step(params, opt_state, R.jnp.asarray(tokens, R.jnp.int32))
        losses.append(float(val))
    return {"losses": losses, "params": jax.tree.map(np.asarray, params)}


def jax_pp(name) -> dict:
    """The reference's ``make_pp_train_step`` for the case (its reference
    schedule): losses, final params in logical order, the last step's
    ``pp_phase_counts`` and the step's accounting."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    shape, L, M, v, _, schedule, opt, lr, *_ = CASES[name]
    cfg = case_cfg(name)
    jcfg = R.jtfm.tiny_lm(attn_impl="xla", **SMALL, num_layers=L)
    mesh = ddp.make_mesh(("data", "pipe"), shape=shape, devices=jax.devices()[: math.prod(shape)])
    step = R.jpp.make_pp_train_step(jcfg, mesh=mesh, microbatches=M, donate=False, schedule=schedule, virtual=v)
    state = ddp.TrainState.create(apply_fn=None, params=to_jax_params(seeded_state_dict(cfg), cfg),
                                  tx=_tx(opt, lr))
    state = R.jpp.shard_state_pp(state, mesh, virtual=v)
    losses = []
    for tokens in case_tokens(name):
        state, m = step(state, R.shard_batch({"tokens": tokens.astype(np.int32)}, mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": logical_layers(jax.tree.map(np.asarray, state.params), L, shape[1], v),
            "counts": np.asarray(m["pp_phase_counts"]), "accounting": step.bubble_accounting}


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's results, computed while the ranks work."""
    return {
        "single": {name: jax_single_device(name) for name in ("n2_v2", "v2_adam")},
        "pp": {name: jax_pp(name) for name in CASES if CASES[name][5]},
        "dpp": {name: jax_dpp_pp_run(flags, world=WORLD) for name, flags in DPP_RUNS.items()},
    }


def check(runs, want_run, cfg, what, loss_rel=LOSS_REL, atol=PARAM_ATOL):
    jax = ref().jax
    for run in runs:  # every rank reports the global (mean) loss
        np.testing.assert_allclose(run["losses"], want_run["losses"], rtol=loss_rel, err_msg=what)
    got = port_params(runs, cfg, runs[0]["virtual"])
    flat = jax.tree_util.tree_flatten_with_path(want_run["params"])[0]
    for (path, b), a in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", ["n2_m3", "n4_m6", "n2_v2", "n4_v2"])
def test_zb_matches_reference(ranks, want, name):
    """The port's ZB (and its 1F1B) against the reference's pipelined step
    for the case: losses and final weights."""
    for schedule in CASES[name][4]:
        check([r[name][schedule] for r in ranks.get()], want["pp"][name], case_cfg(name),
              f"{name} {schedule} vs the reference's {CASES[name][5]}")


def test_zb_is_1f1b_bit_for_bit(ranks):
    """W runs the same GEMMs on the same tensors in the same microbatch
    order as 1F1B's backward: losses, every stage's first-step gradients
    and final weights are equal, in every case."""
    for r, name in itertools.product(ranks.get(), ("n2_m3", "n4_m6", "n2_v2", "n4_v2")):
        a, b = r[name]["zb"], r[name]["1f1b"]
        assert a["losses"] == b["losses"]
        for k in a["grads"]:
            assert torch.equal(a["grads"][k], b["grads"][k]), k
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k


def test_interleaved_1f1b_matches_single_device_and_gpipe(ranks, want):
    """8 layers on 2 stages of 2 chunks, M = 4, against one device; and 3
    Adam steps of interleaved 1F1B against the port's GPipe and one
    device."""
    check([r["n2_v2"]["1f1b"] for r in ranks.get()], want["single"]["n2_v2"], case_cfg("n2_v2"), "n2_v2 vs one device")
    runs = [r["v2_adam"]["1f1b"] for r in ranks.get()]
    check(runs, want["single"]["v2_adam"], case_cfg("v2_adam"), "v2_adam vs one device", loss_rel=MULTI_STEP_REL)
    for r in ranks.get():
        np.testing.assert_allclose(r["v2_adam"]["1f1b"]["losses"], r["v2_adam"]["gpipe"]["losses"],
                                   rtol=MULTI_STEP_REL)


def test_phase_counts_and_accounting_are_the_references(ranks, want):
    for name, w in want["pp"].items():
        shape, _, M, v, schedules, ref_schedule, *_ = CASES[name]
        for r in ranks.get():
            run = r[name][ref_schedule]
            np.testing.assert_array_equal(run["counts"].numpy(), w["counts"])
            assert run["accounting"] == w["accounting"] == tpp.pp_bubble_fraction(shape[1], M, v, ref_schedule)
        zb = [r[name]["zb"]["counts"].tolist() for r in ranks.get()]
        assert zb == [[[M * v] * 3] * shape[1]] * WORLD, (name, zb[0])


def test_virtual_shards_are_the_references():
    """Each stage's ``from_jax_params(virtual=)`` shard is the reference's
    device slice of ``shard_state_pp(virtual=)``'s interleaved layout."""
    R = ref()
    jax = R.jax
    cfg = ttfm.tiny_lm(**SMALL, num_layers=8)
    full = to_jax_params(seeded_state_dict(cfg), cfg)
    perm = np.asarray(tpp.interleave_layer_perm(8, 2, 2))
    np.testing.assert_array_equal(perm, R.jpp.interleave_layer_perm(8, 2, 2))
    for s in range(2):
        mine = to_jax_params(from_jax_params(full, cfg, pp_rank=s, pp_size=2, virtual=2),
                             dataclasses.replace(cfg, num_layers=4))
        for leaf, got in zip(jax.tree.leaves(full["layers"]), jax.tree.leaves(mine["layers"])):
            np.testing.assert_array_equal(got, np.asarray(leaf)[perm][4 * s : 4 * s + 4])
    with pytest.raises(ValueError, match="not divisible by 2 stages x 3 virtual chunks"):
        tpp.stage_layers(8, 2, 0, 3)


def test_virtual_checkpoint_round_trip_and_geometry_guard(ranks):
    for r in ranks.get():
        c = r["ckpt"]
        assert c["same_params"] and c["same_opt"] and c["pp_virtual"] == 2, c
        assert c["losses"][0] == c["losses"][1] and c["losses"][2] == c["losses"][3], c["losses"]
        assert abs(c["plain_loss"] - c["pp_loss"]) <= 1e-6, c
        assert c["refusals"] == [
            "checkpoint layer storage is interleaved for (pp=2, virtual=1) but this run is (pp=2, virtual=2) — "
            "interleaved layouts resume only at their exact pipeline geometry",
            "checkpoint layer storage is interleaved for (pp=4, virtual=2) but this run is (pp=2, virtual=2) — "
            "interleaved layouts resume only at their exact pipeline geometry"], c["refusals"]


@pytest.mark.parametrize("name", list(DPP_RUNS))
def test_dpp_zb_and_virtual_match_reference(ranks, want, name):
    """``dpp`` with zb and virtual stages for 3 steps against the reference
    ``dpp.py``: losses and final weights."""
    w = want["dpp"][name]
    runs = [dict(r["dpp"][name], virtual=w["virtual"]) for r in ranks.get()]
    check(runs, w, w["cfg"], f"dpp {name}", loss_rel=LOSS_REL)
