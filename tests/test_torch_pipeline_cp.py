"""The port's pipeline x context parallelism (``parallel.pipeline_parallel``
with ``cp_axis``: ring or Ulysses attention inside each stage) against the
JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file.  The weights are the port's
seeded ones (``tiny_lm`` with scanned layers, d_model 32), carried to the
reference by ``to_jax_params``; each rank's batch is its data replica's rows
and its seq chunk of the host-shifted next-token pairs (the reference's
``shard_lm_batch``).  The oracles are the reference's single-device step on
the whole batch and its ``make_pp_train_step`` on its fake CPU devices at
the same mesh.

- data 2 x seq 2 x pipe 2, ring and Ulysses, GPipe and 1F1B, one SGD step:
  against one device; the ring under 1F1B and Ulysses under GPipe also
  against the reference's pipelined CP step.  The [F, B, W] units of 1F1B
  are the reference table's on every seq rank.
- The same mesh with 2 virtual chunks a stage under 1F1B (the reference
  allows it) against one device.
- ZeRO-1 over ``data`` after the pipe sum and the seq mean, 2 Adam steps,
  against the replicated-optimizer step (the reference's
  ``test_cp_pp_zero_matches_replicated``) and one device.
- seq 2 x pipe 2 x model 2 (the reference's four-axis mesh test, GQA heads)
  under 1F1B against one device.
- ``dpp --pp 2 --cp 2 --cp-impl ring|ulysses`` for 3 steps against the
  reference ``dpp.py``'s PP path (its loader shifts and shards on the host).
- The refusals: pipelined eval under CP, zb under CP (the step factory's and
  the parser's messages, the reference's).

Tolerances: f32 throughout, summation order only: losses within 1e-5
relative, parameters within 2e-5 (3e-5 on the four-axis mesh, the
reference's own bound there); ZeRO against the replicated step 2e-6 (the
reference test's bound).  A missing seq mean doubles every update, wrong
positions or a missing ring hop move the attention's gradients by far more.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import Ranks  # noqa: E402
from test_torch_pipeline_cli import dpp_run, jax_dpp_pp_run, port_params  # noqa: E402
from test_torch_pipeline_zb import ADAM_EPS, LOSS_REL, PARAM_ATOL, _optimizer, ref, seeded_state_dict  # noqa: E402

from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import pipeline_parallel as tpp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.expert_parallel import shard_model_axes  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.zero import zero_state  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

SMALL = dict(num_layers=4, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, scan_layers=True)
MESH = (("data", "seq", "pipe"), (2, 2, 2))
# name -> (mesh, config overrides, schedule, virtual, optimizer, lr, token seed, rows, steps)
CASES = {
    "ring_gpipe": (MESH, dict(cp_impl="ring"), "gpipe", 1, "sgd", 0.1, 4, 8, 1),
    "ring_1f1b": (MESH, dict(cp_impl="ring"), "1f1b", 1, "sgd", 0.1, 4, 8, 1),
    "ulysses_gpipe": (MESH, dict(cp_impl="ulysses"), "gpipe", 1, "sgd", 0.1, 4, 8, 1),
    "ulysses_1f1b": (MESH, dict(cp_impl="ulysses"), "1f1b", 1, "sgd", 0.1, 4, 8, 1),
    "ring_1f1b_v2": (MESH, dict(cp_impl="ring"), "1f1b", 2, "sgd", 0.1, 4, 8, 1),
    "zero": (MESH, dict(cp_impl="ring"), "1f1b", 1, "adam", 1e-2, 31, 8, 2),
    "tp": ((("data", "seq", "pipe", "model"), (1, 2, 2, 2)), dict(num_heads=4, num_kv_heads=2), "1f1b", 1, "sgd",
           0.1, 6, 4, 1),
}
REFERENCE_PP = ("ring_1f1b", "ulysses_gpipe")
M = 2
ZERO_ATOL, TP_ATOL = 2e-6, 3e-5
DPP_COMMON = ["--model", "gpt2", "--d-model", "32", "--layers", "4", "--seq-len", "16", "--vocab-size", "64",
              "--num-examples", "64", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "3", "--lr", "0.1",
              "--pp", "2", "--cp", "2"]
DPP_RUNS = {impl: DPP_COMMON + ["--cp-impl", impl] for impl in ("ring", "ulysses")}


def case_cfg(name, **kw):
    return ttfm.tiny_lm(**{**SMALL, **CASES[name][1], **kw})


def case_tokens(name):
    *_, seed, rows, steps = CASES[name]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(rows, 33)).astype(np.int64) for _ in range(steps)]


# ------------------------------------------------------------- rank side --

def run_case(name, zero=False) -> dict:
    """The case's steps on this rank: losses, this stage's (TP shard's)
    parameters, the unit counts, its place."""
    (axes, shape), _, schedule, v, opt, lr, *_ = CASES[name]
    mesh = rt.make_mesh(axes, shape)
    cfg = case_cfg(name, cp_axis="seq", tp_axis="model" if "model" in axes else None)
    full = shard_model_axes(seeded_state_dict(dataclasses.replace(cfg, tp_axis=None)), cfg.tp_axis, None)
    model = tpp.stage_model(cfg, full, mesh.index("pipe"), mesh.size("pipe"), virtual=v)
    if zero:
        state = zero_state(model, lambda shards: (_optimizer(opt, lr, shards), None), level=1,
                           group=rt.axis_group("data"), pp_axis="pipe")
    else:
        state = TrainState(model, _optimizer(opt, lr, model.parameters()))
    step = tpp.make_pp_train_step(cfg, microbatches=M, schedule=schedule, virtual=v, zero=zero)
    d, n_data, q, n_seq = mesh.index("data"), mesh.size("data"), mesh.index("seq"), mesh.size("seq")
    losses, counts = [], None
    for tokens in case_tokens(name):
        rows = torch.from_numpy(tokens).chunk(n_data)[d]
        S = (rows.shape[1] - 1) // n_seq
        batch = {"inputs": rows[:, :-1][:, q * S : (q + 1) * S], "targets": rows[:, 1:][:, q * S : (q + 1) * S]}
        m = step(state, batch)
        losses.append(float(m["loss"]))
        counts = m.get("pp_phase_counts")
    return {"losses": losses, "params": {k: t.detach().clone() for k, t in model.state_dict().items()},
            "counts": counts, "virtual": v, "coords": dict(mesh.coords)}


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: run_case(name) for name in CASES}
        res["zero_on"] = run_case("zero", zero=True)
        res["dpp"] = {name: dpp_run(flags, rank, world) for name, flags in DPP_RUNS.items()}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("pp_cp_ranks"))
    yield r
    r.get()


# ------------------------------------------------------------- JAX side --

def jax_single_device(name) -> dict:
    """The reference's single-device steps on the whole batch."""
    R = ref()
    jax = R.jax
    _, over, _, _, opt, lr, *_ = CASES[name]
    cfg = case_cfg(name)
    model = R.jtfm.TransformerLM(R.jtfm.tiny_lm(attn_impl="xla", **{**SMALL, **over}))
    params = to_jax_params(seeded_state_dict(cfg), cfg)
    tx = R.optax.adam(lr, eps=ADAM_EPS) if opt == "adam" else R.optax.sgd(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, toks):
        val, g = jax.value_and_grad(lambda w: R.lm_ce(model.apply({"params": w}, toks[:, :-1]), toks[:, 1:]))(p)
        upd, s = tx.update(g, s, p)
        return R.optax.apply_updates(p, upd), s, val

    losses = []
    for tokens in case_tokens(name):
        params, opt_state, val = step(params, opt_state, R.jnp.asarray(tokens, R.jnp.int32))
        losses.append(float(val))
    return {"losses": losses, "params": jax.tree.map(np.asarray, params)}


def jax_pp(name) -> dict:
    """The reference's pipelined CP step (``cp_axis="seq"``) for the case:
    losses, final params, the 1F1B unit counts."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    (axes, shape), over, schedule, v, opt, lr, *_ = CASES[name]
    cfg = case_cfg(name)
    jcfg = R.jtfm.tiny_lm(attn_impl="xla", **{**SMALL, **over}, cp_axis="seq")
    mesh = ddp.make_mesh(axes, shape=shape, devices=jax.devices()[:8])
    step = R.jpp.make_pp_train_step(jcfg, mesh=mesh, microbatches=M, donate=False, schedule=schedule, virtual=v)
    state = ddp.TrainState.create(apply_fn=None, params=to_jax_params(seeded_state_dict(cfg), cfg),
                                  tx=R.optax.sgd(lr))
    state = R.jpp.shard_state_pp(state, mesh, virtual=v)
    losses = []
    for tokens in case_tokens(name):
        state, m = step(state, R.shard_lm_batch(tokens.astype(np.int32), mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    counts = m.get("pp_phase_counts")
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params),
            "counts": None if counts is None else np.asarray(counts)}


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's results, computed while the ranks work."""
    return {
        "single": {name: jax_single_device(name) for name in ("ring_1f1b", "zero", "tp")},
        "pp": {name: jax_pp(name) for name in REFERENCE_PP},
        "dpp": {name: jax_dpp_pp_run(flags) for name, flags in DPP_RUNS.items()},
    }


def merged(runs, cfg) -> dict:
    """The whole model as the reference's tree from the data-0, seq-0
    ranks: TP shards merged per stage, then the stages."""
    owners = [r for r in runs if r["coords"]["data"] == 0 and r["coords"]["seq"] == 0]
    stages = []
    for s in sorted({r["coords"]["pipe"] for r in owners}):
        row = sorted((r for r in owners if r["coords"]["pipe"] == s), key=lambda r: r["coords"].get("model", 0))
        stages.append(merge_tp_shards([r["params"] for r in row]))
    return to_jax_params(tpp.merge_pp_shards(stages, owners[0]["virtual"]), cfg)


def check(runs, want_run, cfg, what, atol=PARAM_ATOL):
    jax = ref().jax
    for run in runs:  # every rank reports the global (mean) loss
        np.testing.assert_allclose(run["losses"], want_run["losses"], rtol=LOSS_REL, err_msg=what)
    got = merged(runs, dataclasses.replace(cfg, cp_axis=None, tp_axis=None))
    flat = jax.tree_util.tree_flatten_with_path(want_run["params"])[0]
    for (path, b), a in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_pp_cp_matches_single_device_and_reference(ranks, want, impl):
    """GPipe and 1F1B with the ring or Ulysses inside each stage against
    one device, and against the reference's pipelined CP step."""
    for schedule in ("gpipe", "1f1b"):
        name = f"{impl}_{schedule}"
        runs = [r[name] for r in ranks.get()]
        check(runs, want["single"]["ring_1f1b"], case_cfg(name), f"{name} vs one device")
        if name in want["pp"]:
            check(runs, want["pp"][name], case_cfg(name), f"{name} vs the reference's pipeline")
    for r in ranks.get():  # every seq rank ran the reference's units
        np.testing.assert_array_equal(r["ring_1f1b"]["counts"].numpy(), want["pp"]["ring_1f1b"]["counts"])


def test_pp_cp_virtual_matches_single_device(ranks, want):
    """Two chunks a stage under 1F1B with the ring inside each chunk."""
    check([r["ring_1f1b_v2"] for r in ranks.get()], want["single"]["ring_1f1b"], case_cfg("ring_1f1b_v2"),
          "ring_1f1b_v2 vs one device")
    for r in ranks.get():
        assert r["ring_1f1b_v2"]["counts"].tolist() == [[2 * M, 2 * M, 0]] * 2


def test_pp_cp_zero_matches_replicated(ranks, want):
    """ZeRO-1 after the pipe sum and the seq mean, 2 Adam steps, against
    the replicated-optimizer step and one device."""
    plain = [r["zero"] for r in ranks.get()]
    check(plain, want["single"]["zero"], case_cfg("zero"), "plain vs one device")
    check([r["zero_on"] for r in ranks.get()], {"losses": plain[0]["losses"],
                                                "params": merged(plain, case_cfg("zero", cp_axis=None))},
          case_cfg("zero"), "zero vs plain", atol=ZERO_ATOL)


def test_pp_cp_tp_four_axis_mesh(ranks, want):
    check([r["tp"] for r in ranks.get()], want["single"]["tp"], case_cfg("tp"), "seq x pipe x model", atol=TP_ATOL)


@pytest.mark.parametrize("impl", list(DPP_RUNS))
def test_dpp_pp_cp_matches_reference(ranks, want, impl):
    """``dpp --pp 2 --cp 2`` for 3 steps against the reference ``dpp.py``:
    losses and final weights."""
    w = want["dpp"][impl]
    runs = [r["dpp"][impl] for r in ranks.get()]
    for run in runs:
        np.testing.assert_allclose(run["losses"], w["losses"], rtol=LOSS_REL, err_msg=impl)
    got = port_params(runs, dataclasses.replace(w["cfg"], cp_axis=None))
    jax = ref().jax
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(w["params"])[0], jax.tree.leaves(got)):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=f"{impl} {jax.tree_util.keystr(path)}")


def test_pp_cp_refusals():
    """The reference's refusals: pipelined eval under CP, zb under CP (the
    factory's and the parser's messages)."""
    from distributeddataparallel_tpu_torch import dpp as tdpp

    cfg = ttfm.tiny_lm(**SMALL, cp_axis="seq")
    with pytest.raises(ValueError, match="pipelined eval does not support cp_axis"):
        tpp.make_pp_eval_step(cfg, microbatches=2)
    with pytest.raises(ValueError, match="zb schedule does not compose with cp_axis yet"):
        tpp.make_pp_train_step(cfg, microbatches=2, schedule="zb")
    for flags, match in ((["--pp-schedule", "zb"], "--pp-schedule zb does not compose with --cp yet"),
                         (["--eval"], "--pp --eval does not support --cp")):
        with pytest.raises(SystemExit, match=match):
            tdpp.parse_args(["--device", "cpu", *DPP_RUNS["ring"], *flags])
