"""The port's tensor parallelism (``parallel.tensor_parallel``, ``--tp``) and
its compositions against the JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file; the same numpy-seeded
inputs and weights go through the reference on its fake CPU devices.

- Layout: each TP rank's shard (``models.io.from_jax_params(tp_rank=,
  tp_size=)``) is the reference's per-device shard of the same tree under
  ``tp_param_specs``, in both layer layouts and with GQA's kv heads,
  ``to_jax_params`` of a shard is that device's slice of the tree, and the
  shards merged (``merge_tp_shards``) give the whole tree back (exact:
  values only move).
- TP forward: 4-way TP logits against the reference's TP apply (MHA, 4
  heads), f32: atol 2e-5 (summation order, and the row-parallel products
  summed over the axis).
- DP x CP x TP on 8 ranks (data 2 x seq 2 x model 2) for 3 SGD steps, in
  ``tests/test_tensor_parallel.py::test_dp_cp_tp_train_step_matches_single_device``'s
  setup (tiny Llama-style config, GQA 4/2, d_model 32, lr 0.1, (4, 33)
  token batches), from the port's seeded weights: losses within 1e-5
  relative and parameters within 2e-5, that test's own bounds (f32), of
  the reference's ``make_train_step(cp_axis, tp_axis)`` on the same mesh.
- Checkpoints under ``--cp 2 --tp 2 --optimizer adamw``: every rank's TP
  shard and optimizer state come back bit for bit and the next step's loss
  is the uninterrupted run's exactly; a checkpoint of another layout is
  refused with the reference's message.
- ``dpp --tp 2`` and ``dpp --cp 2 --tp 2`` (Llama, bf16) and ``dpp --model
  gpt2 --tp 2 --zero 1 --grad-clip 0.5 --accum-steps 2`` (f32; the tied
  embedding and the biases added after the reduction) for 3 steps against
  the reference's run of the same flags (the harness and its bf16
  tolerances are ``test_torch_context_parallel.py``'s; the f32 run holds
  losses to 1e-5 and each update to 1e-4 of its largest value).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import (  # noqa: E402
    LM,
    WORLD,
    Ranks,
    check_dpp_run,
    dpp_run,
    jax_dpp_run,
    ref,
)

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

GPT2 = ["--model", "gpt2", *LM[2:]]
DPP_RUNS = {
    "tp2": LM + ["--tp", "2"],
    "cp2-tp2": LM + ["--cp", "2", "--tp", "2"],
    "gpt2-tp2-zero1-clip-accum": GPT2 + ["--tp", "2", "--zero", "1", "--grad-clip", "0.5", "--accum-steps", "2"],
}
F32_RUNS = {"gpt2-tp2-zero1-clip-accum": dict(loss_atol=1e-5, update_rtol=1e-4)}
CKPT_FLAGS = LM + ["--cp", "2", "--tp", "2", "--optimizer", "adamw", "--lr", "1e-2"]
# The reference test's setup.
XP_CFG = dict(num_heads=4, num_kv_heads=2, d_model=32, d_ff=64, max_seq_len=32)
XP_STEPS, XP_LR = 3, 0.1
FWD_CFG = dict(num_heads=4, d_model=32, d_ff=64, max_seq_len=16)


def xp_batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, size=(4, 33)).astype(np.int32) for _ in range(XP_STEPS)]


def fwd_tokens():
    return np.random.default_rng(1).integers(0, 256, size=(2, 16)).astype(np.int64)


# ------------------------------------------------------------- rank side --

def tp_forward(sd) -> tuple[int, np.ndarray]:
    """4-way TP logits (mesh data 2 x model 4)."""
    mesh = rt.make_mesh(("data", "model"), (WORLD // 4, 4))
    cfg = ttfm.tiny_lm(tp_axis="model", **FWD_CFG)
    model = ttfm.TransformerLM(cfg)
    from distributeddataparallel_tpu_torch.parallel.tensor_parallel import shard_state_dict_tp

    model.load_state_dict(shard_state_dict_tp(sd, mesh.index("model"), 4))
    with torch.no_grad():
        return mesh.index("model"), model(torch.from_numpy(fwd_tokens())).numpy()


def xp_train(sd) -> dict:
    """The 3-D composition: 3 SGD steps on the reference test's batches."""
    mesh = rt.make_mesh(("data", "seq", "model"), (2, 2, 2))
    cfg = ttfm.tiny_lm(cp_axis="seq", tp_axis="model", **XP_CFG)
    model = ttfm.TransformerLM(cfg)
    from distributeddataparallel_tpu_torch.parallel.tensor_parallel import shard_state_dict_tp

    model.load_state_dict(shard_state_dict_tp(sd, mesh.index("model"), 2))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=XP_LR))
    step = make_train_step(tdpp._loss_fn, cp_axis="seq", tp_axis="model")
    d, s = mesh.index("data"), mesh.index("seq")
    losses = []
    for tokens in xp_batches():
        rows = torch.from_numpy(tokens[2 * d : 2 * (d + 1)]).long()
        L = (tokens.shape[1] - 1) // 2
        batch = {"inputs": rows[:, :-1][:, s * L : (s + 1) * L], "targets": rows[:, 1:][:, s * L : (s + 1) * L]}
        losses.append(float(step(state, batch)["loss"]))
    return {"losses": losses, "coords": dict(mesh.coords),
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}


def ckpt_roundtrip(rank, world, directory) -> dict:
    """Save after 2 steps, load into a fresh trainer: parameters, AdamW
    state and the third step's loss against the trainer that goes on; then
    a payload of another layout (which no reshard converts)."""
    import itertools

    from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload

    args = tdpp.parse_args(["--device", "cpu", *CKPT_FLAGS])
    trainers = [tdpp.build_trainer(args, torch.device("cpu"), rank, world) for _ in range(2)]
    a, b = trainers
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
    same_opt = all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i])
    losses = [float(t.step_fn(t.state, batches[2])["loss"]) for t in trainers]
    other = dict(saved, topology=dict(saved["topology"], layout="zero1"))
    try:
        CheckpointFiles.load_into(b.state, other)
        refusal = "none"
    except ValueError as e:
        refusal = str(e)
    return {"same_params": same_params, "same_opt": same_opt and len(opt_a) > 0, "losses": losses,
            "refusal": refusal}


def _worker(rank, world, coordinator, out_dir, payload):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {"fwd": tp_forward(payload["fwd"]), "xp": xp_train(payload["xp"]),
               "ckpt": ckpt_roundtrip(rank, world, str(Path(out_dir) / "ckpt")),
               "dpp": {name: dpp_run(flags, rank, world) for name, flags in DPP_RUNS.items()}}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


# ------------------------------------------------------------- JAX side --

def seeded(**kw):
    """A tiny config's seeded port weights: the reference's model and tree."""
    cfg = ttfm.tiny_lm(**kw)
    params = to_jax_params(ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict(), cfg)
    return ref().jtfm.TransformerLM(ref().jtfm.tiny_lm(attn_impl="xla", **kw)), params


@pytest.fixture(scope="module")
def setup():
    return {"fwd": seeded(**FWD_CFG), "xp": seeded(**XP_CFG)}


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    payload = {"fwd": from_jax_params(setup["fwd"][1], ttfm.tiny_lm(**FWD_CFG)),
               "xp": from_jax_params(setup["xp"][1], ttfm.tiny_lm(**XP_CFG))}
    r = Ranks(_worker, tmp_path_factory.mktemp("tp_ranks"), payload)
    yield r
    r.get()


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("family,kw", [
    ("gpt2_124m", dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64, max_seq_len=16)),
    ("llama3_8b", dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, d_ff=128,
                       max_seq_len=16)),
], ids=["gpt2-flat", "llama-stacked-gqa"])
def test_tp_shards_are_the_references(family, kw):
    """Rank r's shard equals the reference's device-r slice of the tree
    under ``tp_param_specs`` (leaf for leaf, exactly), and the shards put
    back give the whole tree."""
    R = ref()
    jax = R.jax
    from distributeddataparallel_tpu.parallel.tensor_parallel import tp_param_specs

    cfg = getattr(ttfm, family)(**kw)
    full = to_jax_params(ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict(), cfg)
    specs = jax.tree.leaves(tp_param_specs(full), is_leaf=lambda x: isinstance(x, R.P))
    n = 2
    shards = []
    for r in range(n):
        shard = from_jax_params(full, cfg, tp_rank=r, tp_size=n)
        mine = to_jax_params(shard, cfg)
        for leaf, spec, got in zip(jax.tree.leaves(full), specs, jax.tree.leaves(mine)):
            idx = tuple(slice(r * (s // n), (r + 1) * (s // n)) if a == "model" else slice(None)
                        for s, a in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim))
            np.testing.assert_array_equal(got, leaf[idx])
        shards.append(shard)
    rebuilt = to_jax_params(merge_tp_shards(shards), cfg)
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(full)):
        np.testing.assert_array_equal(a, b)
    assert any("model" in tuple(s) for s in specs)


def jax_tp_forward(setup) -> np.ndarray:
    """The reference's 4-way TP logits."""
    R = ref()
    jax, jnp = R.jax, R.jnp
    from distributeddataparallel_tpu.parallel.tensor_parallel import tp_param_specs

    model, params = setup["fwd"]
    jmodel = R.jtfm.TransformerLM(dataclasses.replace(model.cfg, tp_axis="model"))
    mesh = R.ddp.make_mesh(("model",), devices=jax.devices()[:4])
    fn = jax.shard_map(lambda p, t: jmodel.apply({"params": p}, t), mesh=mesh,
                       in_specs=(tp_param_specs(params), R.P()), out_specs=R.P(), check_vma=False)
    return np.asarray(jax.jit(fn)(params, jnp.asarray(fwd_tokens(), jnp.int32)))


def jax_xp_train(setup) -> dict:
    """The reference's ``make_train_step(cp_axis="seq", tp_axis="model")``
    on its (2, 2, 2) mesh for the 3 batches: losses and parameters."""
    import optax

    R = ref()
    jax, ddp = R.jax, R.ddp
    model, params = setup["xp"]
    jmodel = R.jtfm.TransformerLM(dataclasses.replace(model.cfg, cp_axis="seq", tp_axis="model"))
    mesh = ddp.make_mesh(("data", "seq", "model"), shape=(2, 2, 2))

    def loss_fn(p, batch, rng):
        return R.lm_ce(jmodel.apply({"params": p}, batch["inputs"]), batch["targets"]), {}

    state = ddp.shard_state_tp(ddp.TrainState.create(apply_fn=jmodel.apply, params=params,
                                                     tx=optax.sgd(XP_LR)), mesh)
    step = ddp.make_train_step(loss_fn, mesh=mesh, cp_axis="seq", tp_axis="model", donate=False)
    losses = []
    for tokens in xp_batches():
        state, m = step(state, R.shard_lm_batch(tokens, mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def want(setup, ranks):
    """Every case's reference results, computed while the ranks work."""
    return {"fwd": jax_tp_forward(setup), "xp": jax_xp_train(setup),
            **{name: jax_dpp_run(flags) for name, flags in DPP_RUNS.items()}}


def test_tp_forward_matches_reference(ranks, want):
    for r in ranks.get():
        _, got = r["fwd"]
        np.testing.assert_allclose(got, want["fwd"], atol=2e-5, rtol=0)


def test_dp_cp_tp_three_steps_match_reference(ranks, want):
    """The reference test's setup for 3 steps: the port's 8 ranks against
    the reference's ``make_train_step(cp_axis="seq", tp_axis="model")`` on
    its (2, 2, 2) mesh."""
    jax = ref().jax
    ranks = ranks.get()
    shards = [r["xp"] for r in ranks if r["xp"]["coords"]["data"] == 0 and r["xp"]["coords"]["seq"] == 0]
    got = to_jax_params(merge_tp_shards([s["params"] for s in sorted(shards, key=lambda s: s["coords"]["model"])]),
                        ttfm.tiny_lm(**XP_CFG))
    for r in ranks:
        np.testing.assert_allclose(r["xp"]["losses"], want["xp"]["losses"], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want["xp"]["params"])):
        np.testing.assert_allclose(a, b, atol=2e-5)


def test_checkpoint_keeps_each_ranks_tp_shard(ranks):
    for r in ranks.get():
        c = r["ckpt"]
        assert c["same_params"] and c["same_opt"], c
        assert c["losses"][0] == c["losses"][1], c["losses"]
        assert "checkpoint layout 'zero1' does not match the current run's 'replicated'" in c["refusal"], \
            c["refusal"]


@pytest.mark.parametrize("name", list(DPP_RUNS))
def test_dpp_tp_matches_reference(ranks, want, name):
    check_dpp_run(ranks, name, want[name], **F32_RUNS.get(name, {}))
