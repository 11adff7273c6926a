"""The port's expert parallelism (``parallel.expert_parallel``, ``--ep``) and
its compositions against the JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file; every case reads what they
computed.  Each case mirrors the reference test of the same name in
``tests/test_expert_parallel.py``: the same config (``tiny_lm``, 2 layers,
d_model 32, 4 experts), optimizer and numpy-seeded token batches, from the
port's seeded weights.  The oracle is the reference's single-device step
(``jax.value_and_grad`` and optax on the whole batch), which the
reference's own EP steps equal; the bounds are that test file's: losses
within 1e-5 relative, parameters within 2e-5 (f32, summation order).

- DP 2 x EP 4, dense dispatch, Adam; and top-2 token choice at capacity E
  (no drop: the all-to-all exchange changes the dataflow, not the math).
- DP 2 x EP 2 x TP 2 (the expert and model axes of one mesh), SGD.
- DP 2 x CP 2 x EP 2 (each sequence chunk routes its own tokens), SGD.
- ZeRO-1 x EP on DP 4 x EP 2, top-2 token choice, with ``grad_clip`` 0.5
  (binding), two Adam steps against the single-device steps under
  ``optax.clip_by_global_norm``.
- Accumulation: 2 microbatches under DP 2 x EP 4 against one
  single-device step on the whole batch.
- Dropout under EP: the expert ranks of a replica share its masks, so the
  step equals, on each rank, the replicas' losses computed one by one on
  the whole model with each replica's seed (f32, atol 1e-6).
- Checkpoints under ``--ep 2``: every rank's expert shard and optimizer
  state come back bit for bit and the next step's loss is the
  uninterrupted run's; the payload's merged model loads into a plain MoE
  model, whose logits equal the EP model's (atol 1e-6: the partial blends
  are summed over the ranks); another layout is refused.
- ``dpp --moe-experts 4 --ep 2 --eval`` (GPT-2 shape, aux weight 0.01) for
  3 steps against the reference's aux loss on the same batches: losses
  within 1e-5, parameters 2e-5, the eval means 1e-5.
- The refusals, with the reference's messages, and each expert rank's
  shard (EP alone and with TP) against the reference's specs.
"""

import dataclasses
import functools
import itertools
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
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.ops.dropout import fold_seed  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.expert_parallel import (  # noqa: E402
    merge_ep_shards,
    shard_model_axes,
)
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.zero import zero_state  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

SMALL = dict(num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, moe_experts=4)
# name -> (mesh axes, shape, config overrides, optimizer, lr, token seed, batch shape, steps, extra)
CASES = {
    "dp_ep": (("data", "expert"), (2, 4), {}, "adam", 1e-2, 0, (4, 33), 1, {}),
    "dp_ep_token_choice": (("data", "expert"), (2, 4), dict(moe_top_k=2, moe_capacity_factor=4.0), "adam",
                           1e-2, 0, (4, 33), 1, {}),
    "dp_ep_tp": (("data", "expert", "model"), (2, 2, 2), dict(num_heads=4, num_kv_heads=2), "sgd", 0.1, 3,
                 (4, 33), 1, {}),
    "dp_cp_ep": (("data", "seq", "expert"), (2, 2, 2), {}, "sgd", 0.1, 11, (4, 33), 1, {}),
    "ep_zero": (("data", "expert"), (4, 2), dict(moe_top_k=2, moe_capacity_factor=4.0), "adam", 1e-2, 23,
                (8, 17), 2, dict(zero=1, grad_clip=0.5)),
    "ep_accum": (("data", "expert"), (2, 4), {}, "sgd", 0.1, 9, (4, 33), 1, dict(accum_steps=2)),
}
LOSS_REL, PARAM_ATOL = 1e-5, 2e-5
# Adam's eps on both sides: at optax's default 1e-8 an f32 rounding
# difference in a near-zero gradient element (cancellation in a sum over
# tokens) moves that element's first step by a visible share of lr; what
# the Adam cases test is the state's sharding, which any eps exercises.
ADAM_EPS = 1e-4
DROPOUT = dict(rate=0.1, seed=5, lr=0.1)
GPT2 = ["--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16", "--vocab-size", "64",
        "--num-examples", "64", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "3"]
CLI_FLAGS = GPT2 + ["--moe-experts", "4", "--ep", "2", "--eval", "--lr", "0.1"]
CKPT_FLAGS = GPT2 + ["--moe-experts", "4", "--moe-top-k", "2", "--ep", "2", "--optimizer", "adamw",
                     "--lr", "1e-2"]


@functools.cache
def ref():
    """The JAX side, imported here: the gloo ranks import this module and
    need torch only."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp
    from distributeddataparallel_tpu.data.loader import DataLoader
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import accuracy, lm_cross_entropy
    from distributeddataparallel_tpu.ops.losses import per_example_accuracy, per_example_cross_entropy

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, P=P, ddp=ddp, jdpp=jdpp, DataLoader=DataLoader,
                           jtfm=jtfm, accuracy=accuracy, lm_ce=lm_cross_entropy, pe_acc=per_example_accuracy,
                           pe_ce=per_example_cross_entropy)


def case_cfg(name, **kw):
    return ttfm.tiny_lm(**{**SMALL, **CASES[name][2], **kw})


def case_tokens(name):
    *_, seed, shape, steps, _ = CASES[name]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=shape).astype(np.int64) for _ in range(steps)]


def seeded_state_dict(cfg) -> dict:
    """The whole model's port-seeded weights (no mesh axes)."""
    cfg = dataclasses.replace(cfg, ep_axis=None, tp_axis=None, cp_axis=None)
    return ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()


# ------------------------------------------------------------- rank side --

def _optimizer(kind, lr, params):
    return torch.optim.Adam(params, lr=lr, eps=ADAM_EPS) if kind == "adam" else torch.optim.SGD(params, lr=lr)


def run_case(name) -> dict:
    """The case's steps on this rank: losses, this rank's parameters and
    its mesh coordinates."""
    axes, shape, _, opt, lr, _, _, _, extra = CASES[name]
    mesh = rt.make_mesh(axes, shape)
    cp, tp = "seq" in axes, "model" in axes
    cfg = case_cfg(name, ep_axis="expert", cp_axis="seq" if cp else None, tp_axis="model" if tp else None)
    model = ttfm.TransformerLM(cfg)
    model.load_state_dict(shard_model_axes(seeded_state_dict(cfg), cfg.tp_axis, cfg.ep_axis))
    if extra.get("zero"):
        state = zero_state(model, lambda shards: (_optimizer(opt, lr, shards), None), level=1,
                           group=rt.axis_group("data"), ep_axis="expert")
    else:
        state = TrainState(model, _optimizer(opt, lr, model.parameters()))
    step = make_train_step(tdpp._loss_fn, cp_axis=cfg.cp_axis, tp_axis=cfg.tp_axis, ep_axis="expert",
                           accum_steps=extra.get("accum_steps", 1), zero=extra.get("zero", 0),
                           grad_clip=extra.get("grad_clip"))
    d, n_data = mesh.index("data"), mesh.size("data")
    losses = []
    for tokens in case_tokens(name):
        rows = torch.from_numpy(tokens).chunk(n_data)[d]
        if cp:
            s, L = mesh.index("seq"), (tokens.shape[1] - 1) // 2
            batch = {"inputs": rows[:, :-1][:, s * L:(s + 1) * L], "targets": rows[:, 1:][:, s * L:(s + 1) * L]}
        else:
            batch = {"tokens": rows}
        losses.append(float(step(state, batch)["loss"]))
    with state.full_params():
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"losses": losses, "params": params, "coords": dict(mesh.coords)}


def dropout_case() -> dict:
    """One SGD step with dropout under DP 4 x EP 2 beside, on this rank,
    the same step computed replica by replica on the whole model."""
    from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy

    mesh = rt.make_mesh(("data", "expert"), (4, 2))
    cfg = ttfm.tiny_lm(**SMALL, dropout_rate=DROPOUT["rate"])
    full = seeded_state_dict(cfg)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 17)))
    whole = ttfm.TransformerLM(cfg)
    whole.load_state_dict(full)
    whole.train()
    total = 0.0
    for d, rows in enumerate(tokens.chunk(4)):
        logits = whole(rows[:, :-1], dropout_seed=fold_seed(DROPOUT["seed"], d, 0))
        loss = lm_cross_entropy(logits, rows[:, 1:]) / 4
        loss.backward()
        total += float(loss.detach())
    want = {k: (p - DROPOUT["lr"] * p.grad).detach() for k, p in whole.named_parameters()}
    model = ttfm.TransformerLM(dataclasses.replace(cfg, ep_axis="expert"))
    model.load_state_dict(shard_model_axes(full, None, "expert"))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=DROPOUT["lr"]))
    got = make_train_step(tdpp._loss_fn, ep_axis="expert")(state, {"tokens": tokens.chunk(4)[mesh.index("data")]},
                                                           DROPOUT["seed"])
    mine = shard_model_axes(want, None, "expert")
    err = max(float((p.detach() - mine[k]).abs().max()) for k, p in model.named_parameters())
    return {"loss": float(got["loss"]), "want_loss": total, "max_param_err": err}


def ckpt_roundtrip(rank, world, directory) -> dict:
    """Save after 2 steps, load into a fresh trainer: parameters, AdamW
    state and the third step's loss against the trainer that goes on; the
    merged model in a plain MoE model; a payload of another layout."""
    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload

    args = tdpp.parse_args(["--device", "cpu", *CKPT_FLAGS])
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
    cfg = tdpp.build_config(args)
    plain = ttfm.TransformerLM(dataclasses.replace(cfg, ep_axis=None))
    plain.load_state_dict(saved["model"])
    probe = batches[0]["tokens"][:, :-1]
    with torch.no_grad():
        logits_err = float((plain.eval()(probe) - b.state.model.eval()(probe)).abs().max())
    same_params = all(torch.equal(x, y) for x, y in zip(a.state.model.state_dict().values(),
                                                        b.state.model.state_dict().values()))
    opt_a, opt_b = a.state.optimizer.state_dict()["state"], b.state.optimizer.state_dict()["state"]
    same_opt = len(opt_a) > 0 and all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    losses = [float(t.step_fn(t.state, batches[2])["loss"]) for t in (a, b)]
    other = dict(saved, topology=dict(saved["topology"], layout="zero1"))
    try:
        CheckpointFiles.load_into(b.state, other)
        refusal = "none"
    except ValueError as e:
        refusal = str(e)
    return {"same_params": same_params, "same_opt": same_opt, "losses": losses, "refusal": refusal,
            "plain_logits_err": logits_err, "experts_in_payload": int(saved["model"]["layers.0.mlp.experts_up"].shape[0])}


def cli_run(rank, world) -> dict:
    """``dpp``'s trainer for CLI_FLAGS: 3 steps, this rank's parameters and
    the eval means."""
    args = tdpp.parse_args(["--device", "cpu", *CLI_FLAGS])
    tr = tdpp.build_trainer(args, torch.device("cpu"), rank, world)
    tr.loader.set_epoch(0)
    metrics = [tr.step_fn(tr.state, b) for b in itertools.islice(tr.loader, 3)]
    parts = [tr.eval_step(tr.state.model, b) for b in tr.eval_loader]
    total = sum(float(c) for _, c in parts)
    return {"losses": [float(m["loss"]) for m in metrics], "moe_aux": [float(m["moe_aux"]) for m in metrics],
            "params": {k: v.detach().clone() for k, v in tr.state.model.state_dict().items()},
            "coords": dict(rt.current_mesh().coords),
            "eval": {k: sum(float(m[k]) * float(c) for m, c in parts) / total for k in parts[0][0]}}


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: run_case(name) for name in CASES}
        res["dropout"] = dropout_case()
        res["ckpt"] = ckpt_roundtrip(rank, world, str(Path(out_dir) / "ckpt"))
        res["cli"] = cli_run(rank, world)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("ep_ranks"))
    yield r
    r.get()


# ------------------------------------------------------------- JAX side --

def merged_params(runs, cfg) -> dict:
    """The whole model as the reference's tree, from the ranks at data (and
    seq) index 0: TP shards merged per expert index, then the experts."""
    owners = [r for r in runs if r["coords"]["data"] == 0 and r["coords"].get("seq", 0) == 0]
    rows = []
    for e in sorted({r["coords"]["expert"] for r in owners}):
        row = sorted((r for r in owners if r["coords"]["expert"] == e), key=lambda r: r["coords"].get("model", 0))
        rows.append(merge_tp_shards([r["params"] for r in row]))
    return to_jax_params(merge_ep_shards(rows), dataclasses.replace(cfg, ep_axis=None, tp_axis=None))


@functools.cache
def jax_loss_and_grad(over: tuple):
    """The reference model's jitted (loss, gradient) for config overrides
    ``over`` (one compile per config, shared by the cases)."""
    R = ref()
    model = R.jtfm.TransformerLM(R.jtfm.tiny_lm(attn_impl="xla", **{**SMALL, **dict(over)}))
    return R.jax.jit(R.jax.value_and_grad(
        lambda p, toks: R.lm_ce(model.apply({"params": p}, toks[:, :-1]), toks[:, 1:])))


def jax_single_device(name) -> dict:
    """The reference's single-device steps for the case: losses and the
    final params tree."""
    R = ref()
    jax, jnp, optax = R.jax, R.jnp, R.optax
    _, _, over, opt, lr, _, _, _, extra = CASES[name]
    cfg = case_cfg(name)
    params = to_jax_params(seeded_state_dict(cfg), cfg)
    tx = optax.adam(lr, eps=ADAM_EPS) if opt == "adam" else optax.sgd(lr)
    if extra.get("grad_clip"):
        tx = optax.chain(optax.clip_by_global_norm(extra["grad_clip"]), tx)
    opt_state = tx.init(params)
    loss_and_grad = jax_loss_and_grad(tuple(sorted(over.items())))

    @jax.jit
    def update(g, s, p):
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s

    losses = []
    for tokens in case_tokens(name):
        val, g = loss_and_grad(params, jnp.asarray(tokens, jnp.int32))
        params, opt_state = update(g, opt_state, params)
        losses.append(float(val))
    return {"losses": losses, "params": jax.tree.map(np.asarray, params)}


def jax_cli_run() -> dict:
    """The reference's model, optimizer, aux loss and loader for CLI_FLAGS
    on the whole batch (4 data replicas of 2 rows), one device."""
    R = ref()
    jax, jnp, optax = R.jax, R.jnp, R.optax
    jargs = R.jdpp.parse_args(["--device", "cpu", *CLI_FLAGS])
    tcfg = tdpp.build_config(tdpp.parse_args(["--device", "cpu", *CLI_FLAGS]))
    params = to_jax_params(seeded_state_dict(tcfg), dataclasses.replace(tcfg, ep_axis=None))
    dataset = R.jdpp.build_dataset(jargs, train=True)
    jmodel = R.jdpp.build_model(jargs, vocab_size=dataset.vocab_size)
    jmodel = R.jtfm.TransformerLM(dataclasses.replace(jmodel.cfg, attn_impl="xla", ep_axis=None))
    tx = R.jdpp.build_optimizer(jargs, total_steps=3)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, toks):
        def replica(q, rows):  # the reference's per-replica loss_fn (dpp.py:1555-1568)
            logits, col = jmodel.apply({"params": q}, rows[:, :-1], mutable=["intermediates"])
            aux = R.jtfm.moe_aux_from_intermediates(col)
            return R.lm_ce(logits, rows[:, 1:]) + jargs.moe_aux_weight * aux, aux

        def loss(q):  # the data replicas' mean: the aux term is per replica's rows
            vals, auxes = zip(*(replica(q, rows) for rows in jnp.split(toks, 4)))
            return sum(vals) / 4, sum(auxes) / 4

        (val, aux), g = jax.value_and_grad(loss, has_aux=True)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, val, aux

    mesh = R.ddp.make_mesh(("data",), devices=jax.devices()[:4])
    loader = R.DataLoader(dataset, per_replica_batch=2, mesh=mesh, shuffle=True, seed=jargs.seed)
    loader.set_epoch(0)
    losses, auxes = [], []
    for batch in itertools.islice(loader, 3):
        params, opt_state, val, aux = step(params, opt_state, jnp.asarray(np.asarray(batch["tokens"])))
        losses.append(float(val))
        auxes.append(float(aux))
    evaluate = jax.jit(lambda p, t: (R.pe_ce(jmodel.apply({"params": p}, t[:, :-1]), t[:, 1:]),
                                     R.pe_acc(jmodel.apply({"params": p}, t[:, :-1]), t[:, 1:])))
    eval_loader = R.DataLoader(R.jdpp.build_dataset(jargs, train=False), per_replica_batch=2, mesh=mesh,
                               shuffle=False, seed=jargs.seed, with_mask=True)
    sums, count = np.zeros(2), 0.0
    for batch in eval_loader:
        valid = np.asarray(batch["valid"])
        ce, acc = evaluate(params, jnp.asarray(np.asarray(batch["tokens"])))
        sums += [float((np.asarray(ce) * valid).sum()), float((np.asarray(acc) * valid).sum())]
        count += float(valid.sum())
    return {"losses": losses, "moe_aux": auxes, "params": jax.tree.map(np.asarray, params),
            "eval": {"loss": sums[0] / count, "accuracy": sums[1] / count}, "cfg": tcfg}


@pytest.fixture(scope="module")
def want(ranks):
    """Every case's reference results, computed while the ranks work."""
    return {**{name: jax_single_device(name) for name in CASES}, "cli": jax_cli_run()}


def check_case(ranks, want, name):
    jax = ref().jax
    runs = [r[name] for r in ranks.get()]
    for run in runs:  # every rank reports the global (mean) loss
        np.testing.assert_allclose(run["losses"], want[name]["losses"], rtol=LOSS_REL, err_msg=name)
    got = merged_params(runs, case_cfg(name))
    flat = jax.tree_util.tree_flatten_with_path(want[name]["params"])[0]
    for (path, b), a in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=f"{name} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------- tests --

def test_dp_ep_matches_single_device(ranks, want):
    check_case(ranks, want, "dp_ep")


def test_dp_ep_token_choice_matches_single_device(ranks, want):
    check_case(ranks, want, "dp_ep_token_choice")


def test_dp_ep_tp_matches_single_device(ranks, want):
    check_case(ranks, want, "dp_ep_tp")


def test_dp_cp_ep_matches_single_device(ranks, want):
    check_case(ranks, want, "dp_cp_ep")


def test_ep_zero_matches_plain_ep(ranks, want):
    """ZeRO-1 over each rank's expert shard with the clip: the optimizer
    state sharded data x expert ways, the norm counting each leaf once."""
    check_case(ranks, want, "ep_zero")


def test_ep_accum_matches_plain_ep(ranks, want):
    check_case(ranks, want, "ep_accum")


def test_ep_dropout_masks_are_shared_by_expert_ranks(ranks):
    for r in ranks.get():
        got = r["dropout"]
        assert abs(got["loss"] - got["want_loss"]) <= 1e-6, got
        assert got["max_param_err"] <= 1e-6, got


def test_ep_checkpoint_round_trip(ranks):
    for r in ranks.get():
        c = r["ckpt"]
        assert c["same_params"] and c["same_opt"], c
        assert c["losses"][0] == c["losses"][1], c["losses"]
        assert c["experts_in_payload"] == 4 and c["plain_logits_err"] <= 1e-6, c
        assert "checkpoint layout 'zero1' does not match the current run's 'replicated'" in c["refusal"], \
            c["refusal"]


def test_dpp_moe_ep_eval_matches_reference(ranks, want):
    """``--moe-experts 4 --ep 2 --eval`` on 8 ranks (data 4 x expert 2)."""
    jax = ref().jax
    w = want["cli"]
    runs = [r["cli"] for r in ranks.get()]
    for run in runs:
        np.testing.assert_allclose(run["losses"], w["losses"], rtol=LOSS_REL)
        np.testing.assert_allclose(run["moe_aux"], w["moe_aux"], rtol=LOSS_REL)
        for k, v in w["eval"].items():
            assert abs(run["eval"][k] - v) <= 1e-5, (k, run["eval"][k], v)
    got = merged_params(runs, w["cfg"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(w["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


REFUSALS = [
    (["--model", "gpt2", "--moe-experts", "4", "--ep", "2", "--zero", "2"], "--zero 2 shards over the data axis only"),
    (["--model", "gpt2", "--moe-experts", "4", "--ep", "2", "--grad-compress", "powersgd"],
     "--grad-compress powersgd supports DP/CP layouts; drop --tp/--ep"),
    (["--model", "gpt2", "--moe-experts", "4", "--ep", "2", "--generate", "4"], "--generate needs replicated params"),
    (["--model", "gpt2", "--moe-experts", "4", "--ep", "2", "--fsdp"], "--fsdp composes with --tp only; drop --ep"),
    (["--model", "gpt2", "--moe-experts", "3", "--ep", "2"], "--moe-experts 3 must be divisible by --ep 2"),
    (["--model", "gpt2", "--moe-experts", "4", "--ep", "2", "--cp", "2", "--tp", "2"],
     "--ep with --cp composes pairwise only"),
    (["--model", "cnn", "--moe-experts", "4"], "--moe-experts requires an LM model"),
]


def test_ep_flag_refusals():
    """What the reference refuses, the port refuses with its message;
    what it takes, the port takes."""
    jdpp = ref().jdpp
    for flags, match in REFUSALS:
        argv = ["--device", "cpu", *flags]
        with pytest.raises(SystemExit, match=match):
            jdpp.validate_args(jdpp.parse_args(argv))
        with pytest.raises(SystemExit, match=match):
            tdpp.parse_args(argv)
    for flags in (CLI_FLAGS, CKPT_FLAGS, GPT2 + ["--moe-experts", "4", "--ep", "2", "--tp", "2", "--zero", "1"]):
        argv = ["--device", "cpu", *flags]
        jdpp.validate_args(jdpp.parse_args(argv))
        args = tdpp.parse_args(argv)
        assert tdpp.build_config(args).ep_axis == "expert"


def test_ep_shards_are_the_references():
    """Each (expert, model) rank's shard (``from_jax_params(ep_rank=,
    tp_rank=)``) is the reference's device slice under
    ``model_axes_param_specs``, stacked layout, leaf for leaf."""
    R = ref()
    jax = R.jax
    from distributeddataparallel_tpu.parallel.expert_parallel import model_axes_param_specs

    cfg = ttfm.tiny_lm(**{**SMALL, "num_heads": 4, "num_kv_heads": 2, "scan_layers": True})
    full = to_jax_params(seeded_state_dict(cfg), cfg)
    specs = jax.tree.leaves(model_axes_param_specs(full, "model", "expert"), is_leaf=lambda x: isinstance(x, R.P))
    for e, t in itertools.product(range(2), range(2)):
        shard = from_jax_params(full, cfg, tp_rank=t, tp_size=2, ep_rank=e, ep_size=2)
        mine = to_jax_params(shard, cfg)
        for leaf, spec, got in zip(jax.tree.leaves(full), specs, jax.tree.leaves(mine)):
            rank = {"model": t, "expert": e}
            idx = tuple(slice(rank[a] * (s // 2), (rank[a] + 1) * (s // 2)) if a in rank else slice(None)
                        for s, a in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim))
            np.testing.assert_array_equal(got, leaf[idx])
    assert any("expert" in tuple(s) for s in specs) and any("model" in tuple(s) for s in specs)
