"""The port's collective recorder (``analysis.graph_lint``) and ``--lint-step``
against the JAX package's graph lint, on the CPU.

Two gloo ranks are spawned once for the file.  Each runs one step of the
port's step factories at a tiny width (``tiny_lm``: 2 layers, d_model 32)
under the recorder, in the layouts plain DP, ``--zero 1``, ``--tp 2``,
``--fsdp`` and ``--pp 2`` (GPipe, 2 microbatches), on the mesh ``dpp.py``
builds at world 2; meanwhile the reference's ``lint_train_step`` traces its
own factories for the same configuration on two fake devices.  Their
per-axis counts of gradient-sized collectives are held equal, by torch's
names for the reference's primitives (``all_reduce`` = ``psum``,
``reduce_scatter_tensor`` = ``reduce_scatter``, ``all_gather_into_tensor``
= ``all_gather``, ``batch_isend_irecv`` = ``ppermute``), up to the
differences by design pinned in ``BY_DESIGN`` with their reasons.

Also: GL001 fires in both packages on the same planted fault (one
gradient leaf's reduction dropped from the leaf-wise sync), and
``dpp.main([... "--lint-step", "--device", "cpu"])`` is clean, with the
losses of the run without the flag and the summary's ``collective_fp``
set to the lint's fingerprint.
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import Ranks  # noqa: E402

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.analysis import graph_lint  # noqa: E402
from distributeddataparallel_tpu_torch.analysis.rules import collective_manifest  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training import train_step as tts  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

WORLD = 2
CFG = dict(num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, vocab_size=64)
MODES = ("dp", "zero1", "tp2", "fsdp", "pp2")
#: the mesh dpp.py builds for each layout at world 2
MESHES = {"dp": (("data",), (2,)), "zero1": (("data",), (2,)), "tp2": (("data", "model"), (1, 2)),
          "fsdp": (("data",), (2,)), "pp2": (("data", "pipe"), (1, 2))}
#: the reference's primitive for each recorded torch function
TORCH_TO_JAX = {"all_reduce": "psum", "reduce_scatter_tensor": "reduce_scatter",
                "all_gather_into_tensor": "all_gather", "batch_isend_irecv": "ppermute"}
#: mode -> {"axis:prim": (port's count, reference's count)}: where the two
#: differ by design.
BY_DESIGN = {
    # The data axis has one rank under --tp 2 at world 2: the reference's
    # program still holds its psum of every gradient leaf; the port issues
    # no collective over a one-rank axis (data_parallel.group_active).  The
    # model axis's reductions are the same.
    "tp2": {"data:psum": (0, 34)},
    # GPipe at n = 2, M = 2: the reference's unrolled loop runs one
    # ppermute a tick (M + n - 1 = 3) and AD transposes the two that carry
    # activations; the port posts one batch_isend_irecv a transfer, where a
    # unit sends or receives (M forward, M backward on each stage).  The
    # one-rank data axis as under --tp 2.
    "pp2": {"data:psum": (0, 18), "pipe:ppermute": (4, 5)},
}


def tokens() -> np.ndarray:
    return np.random.default_rng(0).integers(0, CFG["vocab_size"], size=(4, 17)).astype(np.int64)


# ------------------------------------------------------------- rank side --

def port_case(mode: str):
    """``(step, state, batch)`` of the port at ``mode`` on this rank, built
    as ``dpp.build_trainer`` builds it."""
    from distributeddataparallel_tpu_torch.parallel import fsdp, pipeline_parallel
    from distributeddataparallel_tpu_torch.parallel.expert_parallel import shard_model_axes
    from distributeddataparallel_tpu_torch.parallel.zero import zero_state

    mesh = rt.make_mesh(*MESHES[mode])
    scan = mode in ("fsdp", "pp2")
    cfg = ttfm.tiny_lm(**CFG, scan_layers=scan, tp_axis="model" if mode == "tp2" else None)
    full = ttfm.TransformerLM(ttfm.tiny_lm(**CFG, scan_layers=scan),
                              generator=torch.Generator().manual_seed(0)).state_dict()
    rows = torch.from_numpy(tokens())
    d, n_data = mesh.index("data"), mesh.size("data")
    batch = {"tokens": rows[d * len(rows) // n_data:(d + 1) * len(rows) // n_data]}

    def adam(params):
        return torch.optim.Adam(params, lr=1e-2), None

    if mode == "fsdp":
        state = fsdp.fsdp_state(cfg, full, adam, group=mesh.group("data"))
        return fsdp.make_fsdp_train_step(tdpp._loss_fn), state, batch
    if mode == "pp2":
        model = pipeline_parallel.stage_model(cfg, full, mesh.index("pipe"), 2)
        return (pipeline_parallel.make_pp_train_step(cfg, microbatches=2), TrainState(model, *adam(model.parameters())),
                batch)
    model = ttfm.TransformerLM(cfg)
    model.load_state_dict(shard_model_axes(full, cfg.tp_axis, None) if mode == "tp2" else full)
    if mode == "zero1":
        return tts.make_train_step(tdpp._loss_fn, zero=1), zero_state(model, adam, group=mesh.group("data")), batch
    return tts.make_train_step(tdpp._loss_fn, tp_axis=cfg.tp_axis), TrainState(model, *adam(model.parameters())), batch


def dropped_leaf_step(step):
    """The plain step with its first gradient leaf's reduction dropped."""
    real = tts.all_reduce_gradients

    def planted(state, batch, seed=None):
        tts.all_reduce_gradients = lambda grads, **kw: real(grads[1:], **kw)
        try:
            return step(state, batch, seed)
        finally:
            tts.all_reduce_gradients = real

    planted.collective_manifest = step.collective_manifest
    return planted


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0, world_size=world,
                          rank=rank, device="cpu")
    out = {}
    try:
        for mode in MODES:
            step, state, batch = port_case(mode)
            rep = graph_lint.lint_train_step(step, state, batch)
            out[mode] = {"counts": rep.collective_counts, "findings": [str(f) for f in rep.findings]}
            if mode == "dp":
                step, state, batch = port_case(mode)
                planted = graph_lint.lint_train_step(dropped_leaf_step(step), state, batch)
                out["planted"] = [(f.rule, f.message) for f in planted.findings]
    finally:
        rt.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("lint_ranks"), world=WORLD)
    yield r
    r.get()  # no rank outlives the module


# ------------------------------------------------------------- JAX side --

def reference_reports() -> dict:
    """The reference's ``lint_train_step`` of each mode on two fake
    devices (trace only), and of the planted drop."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax
    from jax import lax

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.analysis import graph_lint as jgl
    from distributeddataparallel_tpu.analysis.rules import collective_manifest as jmanifest
    from distributeddataparallel_tpu.data.loader import shard_batch
    from distributeddataparallel_tpu.models import TransformerLM, tiny_lm
    from distributeddataparallel_tpu.ops import lm_cross_entropy
    from distributeddataparallel_tpu.parallel import make_pp_train_step, shard_state_pp
    from distributeddataparallel_tpu.parallel.fsdp import fsdp_state, make_fsdp_train_step

    devs = jax.devices()[:WORLD]
    toks = tokens().astype(np.int32)
    rng = jax.random.PRNGKey(0)
    out = {}
    inits = {}  # scan_layers -> params: one compiled init for each layout of the layers
    for mode in MODES:
        axes, shape = MESHES[mode]
        mesh = ddp.make_mesh(axes, shape, devices=devs)
        scan = mode in ("fsdp", "pp2")
        cfg = tiny_lm(**CFG, scan_layers=scan)
        if scan not in inits:
            inits[scan] = jax.jit(TransformerLM(cfg).init)(jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
        params = inits[scan]["params"]
        batch = shard_batch({"tokens": toks}, mesh)
        if mode == "fsdp":
            step, state = make_fsdp_train_step(cfg, mesh=mesh), fsdp_state(cfg, params, optax.adam(1e-2), mesh)
        elif mode == "pp2":
            state = shard_state_pp(ddp.TrainState.create(apply_fn=None, params=params, tx=optax.adam(1e-2)), mesh)
            step = make_pp_train_step(cfg, mesh=mesh, microbatches=2)
        else:
            model = TransformerLM(dataclasses.replace(cfg, tp_axis="model") if mode == "tp2" else cfg)

            def loss_fn(p, b, _rng, model=model):
                logits = model.apply({"params": p}, b["tokens"][:, :-1])
                return lm_cross_entropy(logits, b["tokens"][:, 1:]), {}

            state = (ddp.zero_state(apply_fn=model.apply, params=params, tx=optax.adam(1e-2), mesh=mesh)
                     if mode == "zero1" else
                     ddp.TrainState.create(apply_fn=model.apply, params=params, tx=optax.adam(1e-2)))
            if mode == "tp2":
                state = ddp.shard_state_tp(state, mesh)
            step = ddp.make_train_step(loss_fn, mesh=mesh, zero=mode == "zero1",
                                       tp_axis="model" if mode == "tp2" else None, donate=False)
            if mode == "dp":
                dp_parts = (mesh, model, state, batch)
        rep = jgl.lint_train_step(step, state, batch, rng, check_donation=False)
        out[mode] = {"counts": rep.collective_counts, "findings": [str(f) for f in rep.findings]}

    # The same planted fault: every leaf's mean but the first.
    mesh, model, state, batch = dp_parts

    def body(state, batch, rng):
        def loss(p):
            return lm_cross_entropy(model.apply({"params": p}, batch["tokens"][:, :-1]), batch["tokens"][:, 1:])

        value, g = jax.value_and_grad(loss)(state.params)
        leaves, tree = jax.tree.flatten(g)
        g = jax.tree.unflatten(tree, [leaves[0]] + [lax.pmean(x, "data") for x in leaves[1:]])
        return state.apply_gradients(grads=g), {"loss": lax.pmean(value, "data")}

    from jax.sharding import PartitionSpec as P

    planted = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("data"), P()), out_specs=(P(), P()),
                                    check_vma=False))
    man = jmanifest("dp", grad_reduce={"data": {"psum": (1, None)}}, donate=False, per_leaf_axes=("data",))
    rep = jgl.lint_train_step(planted, state, batch, rng, manifest=man, check_donation=False)
    out["planted"] = [(f.rule, f.message) for f in rep.findings]
    out["n_leaves"] = len(jax.tree.leaves(state.params))
    return out


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's reports, computed while the ranks work."""
    return reference_reports()


def as_reference_names(counts: dict) -> dict:
    out = {}
    for key, n in counts.items():
        axis, prim = key.split(":")
        out[f"{axis}:{TORCH_TO_JAX.get(prim, prim)}"] = n
    return out


# ------------------------------------------------------------------ tests --

@pytest.mark.parametrize("mode", MODES)
def test_recorded_counts_equal_the_references(ranks, want, mode):
    got = [r[mode] for r in ranks.get()]
    for rank in got:
        assert rank["findings"] == [], rank["findings"]
    assert want[mode]["findings"] == []
    mine = as_reference_names(got[0]["counts"])
    theirs = dict(want[mode]["counts"])
    for key, (port, reference) in BY_DESIGN.get(mode, {}).items():
        assert (mine.pop(key, 0), theirs.pop(key, 0)) == (port, reference), key
    assert mine == theirs, (mode, got[0]["counts"], want[mode]["counts"])


def test_gl001_fires_on_the_same_planted_drop(ranks, want):
    n = want["n_leaves"]
    for rank in ranks.get():
        assert [rule for rule, _ in rank["planted"]] == ["GL001"]
        assert f"expected exactly {n} all_reduces (one per param leaf), found {n - 1}" in rank["planted"][0][1]
    assert [rule for rule, _ in want["planted"]] == ["GL001"]
    assert f"expected exactly {n} psums (one per param leaf), found {n - 1}" in want["planted"][0][1]


def test_dpp_lint_step_is_the_runs_own_first_step(capsys):
    flags = ["--device", "cpu", "--model", "mlp", "--epochs", "1", "--num-examples", "64", "--batch-size", "8",
             "--log-every", "1000"]
    plain = tdpp.main(flags)
    linted = tdpp.main(flags + ["--lint-step"])
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("lint-step [dp] clean")]
    assert len(line) == 1 and f"collective fp={linted['collective_fp']}" in line[0]
    assert linted["losses"] == plain["losses"]
    assert plain["collective_fp"] == linted["collective_fp"] and len(linted["collective_fp"]) == 16
    # A manifest the step breaks stops the run before its second step.
    man = collective_manifest("dp", grad_reduce={"data": {"all_reduce": (0, 0)}})
    real = tts.make_train_step

    def strict(*a, **kw):
        step = real(*a, **kw)
        step.collective_manifest = man
        return step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdpp, "make_train_step", strict)
        with pytest.raises(SystemExit, match="GL001"):
            tdpp.main(flags + ["--lint-step"])


def test_the_recorder_hears_collectives_from_any_thread():
    """On CUDA, autograd issues the backward's collectives (FSDP's
    reduce-scatter, the bucket hooks' all-reduces) from its device thread:
    a step run on another thread is recorded as the same step run here."""
    args = tdpp.parse_args(["--device", "cpu", "--model", "mlp", "--num-examples", "64", "--batch-size", "8"])
    rt.init_process_group(device=torch.device("cpu"))
    try:
        trainer = tdpp.build_trainer(args, torch.device("cpu"))
        step, batch = trainer.step_fn, next(iter(trainer.loader))

        def elsewhere(state, batch, rng):
            out = {}
            t = threading.Thread(target=lambda: out.update(metrics=step(state, batch, rng)))
            t.start()
            t.join()
            return out["metrics"]

        elsewhere.collective_manifest = step.collective_manifest
        here = graph_lint.lint_train_step(step, trainer.state, batch, check_order=False)
        there = graph_lint.lint_train_step(elsewhere, trainer.state, batch, check_order=False)
    finally:
        rt.destroy_process_group()
    assert here.findings == there.findings == []
    assert there.collective_counts == here.collective_counts and here.collective_counts["data:all_reduce"] > 0
    assert there.fingerprint == here.fingerprint
