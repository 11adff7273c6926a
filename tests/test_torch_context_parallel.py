"""The port's context parallelism (``parallel.context_parallel``, ``--cp``)
against the JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file (``ranks``); every case below
reads what they computed.  The same numpy-seeded inputs go through the JAX
function on its fake CPU devices (Pallas in interpret mode, as the
reference's own tests run it).

- The flash ring (``impl="kernel"``: K1-K3 per hop, here their plain
  versions, as CPU tensors take them) against the reference's
  ``flash_ring_attention(interpret=True)`` at n in {2, 4}, f32 and bf16,
  MHA and GQA: out, dq, dk, dv.  The reference also computes the masked
  (future) hops and multiplies them by 0; on these inputs it stays finite,
  which the test checks, so skipping them gives the same values.
- The einsum ring (``impl="plain"``) against the reference's XLA ring
  (GQA, the kv heads repeated on the reference's side as its model repeats
  them).
- ``dpp --cp 2 --cp-impl ring`` for 3 steps on 8 ranks (data 4 x seq 2)
  against the reference's ``make_train_step(cp_axis="seq")`` on the same
  mesh, from the port's seeded initial weights and the reference loader's
  batches: losses and parameters (``check_dpp_run``, the harness the
  Ulysses and TP files use too; with ``--eval`` also the eval means against
  the reference's CP eval step).
- ``--cp`` equal to the rank count (data 1 x seq 8, the seq axis the
  whole world): one step's loss and update against the unsharded model's
  step over the whole sequence.
- The global sequence-length guard, decode's refusal, and the entry point's
  flag errors.

Tolerances, stated at each check:

- f32 rings: both sides compute in f32 and differ by summation order: atol
  2e-5 (outputs and gradients are O(1)).
- bf16 flash ring: ``test_torch_flash_bf16.py``'s bound, |port - ref| <=
  1e-3 + 1e-2 |ref|, for out and dq (each rounded to bf16 once after f32
  math, whose p may round one ulp apart from the Pallas kernel's); dk and
  dv are summed across the ring in bf16, one rounding per hop, so a value
  may land one bf16 ulp (2^-8 relative) apart per live hop: rtol (n - 1)
  2^-8 + 1e-2.
- The Llama runs compute in bf16 (the family's activation dtype): XLA and
  PyTorch round intermediates at different points, 1.2e-4 on a loss and
  1.2% of a gradient's largest value in ``test_torch_llama.py``.  Losses
  within 2e-3 over 3 steps; each parameter's update (final - initial) within
  5e-2 of its largest |update| (plain SGD, so an update is lr x the summed
  gradients).  A missing seq-axis mean doubles every update, a missing dk/dv
  rotation or a wrong position moves them by far more.
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

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import context_parallel as tcp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture


@functools.cache
def ref():
    """The JAX side, imported here and not at the top: the gloo ranks
    import this module and need torch only."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp  # the reference entry point
    from distributeddataparallel_tpu.data.loader import DataLoader, shard_lm_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import accuracy, lm_cross_entropy
    from distributeddataparallel_tpu.ops.attention import repeat_kv
    from distributeddataparallel_tpu.ops.losses import per_example_accuracy, per_example_cross_entropy
    from distributeddataparallel_tpu.parallel import context_parallel as jcp

    return SimpleNamespace(jax=jax, jnp=jnp, P=P, ddp=ddp, jdpp=jdpp, DataLoader=DataLoader,
                           shard_lm_batch=shard_lm_batch, jtfm=jtfm, accuracy=accuracy,
                           lm_ce=lm_cross_entropy, repeat_kv=repeat_kv, jcp=jcp,
                           pe_acc=per_example_accuracy, pe_ce=per_example_cross_entropy)


WORLD = 8
B, SL, D = 1, 128, 32  # local chunk: the Pallas kernels' 128-row blocks
# (ring size, dtype, heads, kv heads, impl, causal)
RING_CASES = {
    "flash-n2-f32-mha": (2, "float32", 2, 2, "kernel", True),
    "flash-n4-f32-gqa": (4, "float32", 4, 2, "kernel", True),
    "flash-n2-bf16-gqa": (2, "bfloat16", 4, 2, "kernel", True),
    "flash-n4-bf16-mha": (4, "bfloat16", 2, 2, "kernel", True),
    "einsum-n4-f32-gqa": (4, "float32", 4, 2, "plain", True),
}
LM = ["--model", "llama", "--layers", "2", "--d-model", "64", "--seq-len", "16", "--vocab-size", "64",
      "--num-examples", "64", "--batch-size", "2", "--epochs", "1", "--steps-per-epoch", "3",
      "--lr", "0.1"]
DPP_RUNS = {"ring": LM + ["--cp", "2", "--cp-impl", "ring"]}
F32_ATOL = 2e-5
WHOLE_WORLD_LR = 0.1
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
LOSS_ATOL, UPDATE_RTOL = 2e-3, 5e-2


def ring_inputs(name):
    n, _, H, Hkv, _, _ = RING_CASES[name]
    rng = np.random.default_rng(sorted(RING_CASES).index(name))
    f = lambda h: rng.standard_normal((B, n * SL, h, D)).astype(np.float32)
    return f(H), f(Hkv), f(Hkv), f(H)  # q, k, v and the cotangent's weights


# ------------------------------------------------------------- rank side --

def ring_case(name, seq_index: int, group) -> dict:
    """This rank's chunk of a ring case: out and the gradients of
    sum(out * w) over every rank."""
    n, dtype, *_, impl, causal = RING_CASES[name]
    q, k, v, w = ring_inputs(name)
    sl = slice(seq_index * SL, (seq_index + 1) * SL)
    dt = getattr(torch, dtype)
    ql, kl, vl = (torch.from_numpy(x[:, sl].copy()).to(dt).requires_grad_() for x in (q, k, v))
    out = tcp.ring_attention(ql, kl, vl, group, causal=causal, impl=impl)
    (out.float() * torch.from_numpy(w[:, sl].copy())).sum().backward()
    return {"out": out.detach().float(), "dq": ql.grad.float(), "dk": kl.grad.float(), "dv": vl.grad.float()}


def seq_group_of(n: int):
    """(this rank's seq index, the seq group) on a mesh of ``n``-rank rings."""
    mesh = rt.make_mesh(("data", "seq"), (WORLD // n, n))
    return mesh.index("seq"), rt.axis_group("seq")


def dpp_run(flags, rank, world, steps: int = 3) -> dict:
    """``steps`` train steps of the port's trainer for ``flags`` on this
    rank (its loader's batches), the parameters after them (this rank's TP
    shard) and, with ``--eval``, the eval pass's means as ``dpp`` takes
    them."""
    args = tdpp.parse_args(["--device", "cpu", *flags])
    trainer = tdpp.build_trainer(args, torch.device("cpu"), rank, world)
    trainer.loader.set_epoch(0)
    losses = [float(trainer.step_fn(trainer.state, b)["loss"])
              for b in itertools.islice(trainer.loader, steps)]
    with trainer.state.full_params():
        params = {k: v.detach().clone() for k, v in trainer.state.model.state_dict().items()}
    out = {"losses": losses, "params": params, "coords": dict(rt.current_mesh().coords)}
    if trainer.eval_step is not None:
        parts = [trainer.eval_step(trainer.state.model, b) for b in trainer.eval_loader]
        total = sum(float(c) for _, c in parts)
        out["eval"] = {k: sum(float(m[k]) * float(c) for m, c in parts) / total for k in parts[0][0]}
    return out


def whole_world_step() -> dict:
    """One SGD step of ``make_train_step(cp_axis="seq")`` on a mesh whose
    seq axis spans the world (data 1 x seq 8: ``--cp`` equal to the rank
    count), beside the same step of the unsharded model over the whole
    sequence, computed on this rank with no collective."""
    rt.make_mesh(("data", "seq"), (1, WORLD))
    kw = dict(vocab_size=64, num_layers=1, num_heads=2, d_model=16, d_ff=32, max_seq_len=32)
    full = ttfm.TransformerLM(ttfm.tiny_lm(**kw), generator=torch.Generator().manual_seed(0))
    model = ttfm.TransformerLM(ttfm.tiny_lm(cp_axis="seq", **kw))
    model.load_state_dict(full.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 64, (2, 33))).long()
    loss = tdpp._loss_fn(full, {"tokens": tokens})[0]
    loss.backward()
    want = {k: (p - WHOLE_WORLD_LR * p.grad).detach() for k, p in full.named_parameters()}
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=WHOLE_WORLD_LR))
    sl = slice(rt.axis_index("seq") * 4, (rt.axis_index("seq") + 1) * 4)
    got = make_train_step(tdpp._loss_fn, cp_axis="seq")(state, {"inputs": tokens[:, :-1][:, sl],
                                                                "targets": tokens[:, 1:][:, sl]})
    return {"loss": float(got["loss"]), "want_loss": float(loss), "want": want,
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def guard_message() -> str:
    """The length guard's message for 12 local tokens on a 2-way seq axis."""
    rt.make_mesh(("data", "seq"), (WORLD // 2, 2))
    model = ttfm.TransformerLM(ttfm.tiny_lm(max_seq_len=16, cp_axis="seq"))
    try:
        model(torch.zeros(1, 12, dtype=torch.long))
    except ValueError as e:
        return str(e)
    return "no error"


def _worker(rank, world, coordinator, out_dir, ring_names, runs):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {"ring": {}, "dpp": {}}
        for name in ring_names:
            idx, group = seq_group_of(RING_CASES[name][0])
            res["ring"][name] = (idx, ring_case(name, idx, group))
        for name, flags in runs.items():
            res["dpp"][name] = dpp_run(flags, rank, world)
        res["guard"] = guard_message()
        res["whole_world"] = whole_world_step()
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


class Ranks:
    """``worker(rank, world, coordinator, out_dir, *args)`` started on
    ``world`` gloo processes; ``get()`` waits for them and returns each
    rank's saved results.  The JAX side of a test runs before its
    ``get()``, while the ranks work."""

    def __init__(self, worker, out_dir, *args, world=WORLD):
        import torch.multiprocessing as mp

        self.out, self.world, self._results = Path(out_dir), world, None
        self._ctx = mp.spawn(worker, args=(world, f"127.0.0.1:{rt.free_port()}", str(out_dir), *args),
                             nprocs=world, join=False)

    def get(self) -> list[dict]:
        if self._results is None:
            while not self._ctx.join():
                pass
            self._results = [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                             for r in range(self.world)]
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("cp_ranks"), list(RING_CASES), DPP_RUNS)
    yield r
    r.get()  # no rank outlives the module


@pytest.fixture(scope="module")
def want(ranks):
    """Every case's reference results, computed while the ranks work."""
    return {**{name: jax_ring(name) for name in RING_CASES},
            **{name: jax_dpp_run(flags) for name, flags in DPP_RUNS.items()}}


# ------------------------------------------------------------- JAX side --

def jax_ring(name):
    """The reference's ring on ``n`` fake devices: out and (dq, dk, dv)."""
    R = ref()
    jax, jnp, P = R.jax, R.jnp, R.P
    n, dtype, H, Hkv, impl, causal = RING_CASES[name]
    q, k, v, w = ring_inputs(name)
    dt = getattr(jnp, dtype)

    def local(q, k, v, w):
        if impl == "kernel":
            o = R.jcp.flash_ring_attention(q, k, v, "seq", True)
        else:  # the XLA ring contracts headwise: the model repeats kv first
            rep = H // Hkv
            o = R.jcp.ring_attention(q, R.repeat_kv(k, rep), R.repeat_kv(v, rep), axis_name="seq",
                                     causal=causal, impl="xla")
        return jnp.sum(o.astype(jnp.float32) * w), o

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq")
    fn = jax.shard_map(jax.value_and_grad(local, argnums=(0, 1, 2), has_aux=True), mesh=mesh,
                       in_specs=(spec,) * 4, out_specs=((P(), spec), (spec,) * 3), check_vma=False)
    (_, out), grads = jax.jit(fn)(*(jnp.asarray(x).astype(dt) for x in (q, k, v)), jnp.asarray(w))
    return {"out": out, **dict(zip(("dq", "dk", "dv"), grads))}


def gather_ring(ranks, name):
    """The port's per-rank chunks of ring case ``name``, in sequence order
    (the first ring's ranks)."""
    n = RING_CASES[name][0]
    chunks = sorted(r["ring"][name] for r in ranks[:n])
    assert [i for i, _ in chunks] == list(range(n))
    return {k: torch.cat([c[k] for _, c in chunks], dim=1).numpy() for k in ("out", "dq", "dk", "dv")}


def check_ring(ranks, want, name):
    n, dtype, *_ = RING_CASES[name]
    want = {k: np.asarray(v, np.float32) for k, v in want[name].items()}
    got = gather_ring(ranks.get(), name)
    for key in ("out", "dq", "dk", "dv"):
        assert np.isfinite(want[key]).all(), f"{name}: the reference's {key} is not finite"
        if dtype == "float32":
            np.testing.assert_allclose(got[key], want[key], atol=F32_ATOL, rtol=0, err_msg=f"{name} {key}")
        else:
            rtol = BF16_TOL["rtol"] + (n - 1) * 2.0 ** -8 if key in ("dk", "dv") else BF16_TOL["rtol"]
            np.testing.assert_allclose(got[key], want[key], atol=BF16_TOL["atol"], rtol=rtol,
                                       err_msg=f"{name} {key}")


def jax_dpp_run(flags, world=WORLD, steps: int = 3) -> dict:
    """The reference's train step for the same flags on ``world`` fake
    devices: its mesh, model, optimizer and loader, from the port's seeded
    initial weights.  Losses, initial and final parameters (the reference's
    tree) and, with ``--eval``, its CP eval step's means."""
    R = ref()
    jax, jnp, ddp = R.jax, R.jnp, R.ddp
    jargs = R.jdpp.parse_args(["--device", "cpu", *flags])
    targs = tdpp.parse_args(["--device", "cpu", *flags])
    tcfg = tdpp.build_config(targs)
    init = ttfm.TransformerLM(dataclasses.replace(tcfg, tp_axis=None),
                              generator=torch.Generator().manual_seed(targs.seed))
    params0 = to_jax_params(init.state_dict(), tcfg)
    axes, sizes = ["data"], []
    for degree, axis in ((jargs.cp, "seq"), (jargs.tp, "model")):
        if degree > 1:
            axes.append(axis)
            sizes.append(degree)
    mesh = ddp.make_mesh(tuple(axes), shape=(world // math.prod(sizes), *sizes), devices=jax.devices()[:world])
    cp, tp = jargs.cp > 1, jargs.tp > 1
    dataset = R.jdpp.build_dataset(jargs, train=True)
    jmodel = R.jdpp.build_model(jargs, vocab_size=dataset.vocab_size)
    jmodel = R.jtfm.TransformerLM(dataclasses.replace(jmodel.cfg, attn_impl="xla"))

    def pairs(batch):
        if "inputs" in batch:
            return batch["inputs"], batch["targets"]
        return batch["tokens"][:, :-1], batch["tokens"][:, 1:]

    def jloss(p, batch, rng):
        inputs, targets = pairs(batch)
        logits = jmodel.apply({"params": p}, inputs)
        return R.lm_ce(logits, targets), {"accuracy": R.accuracy(logits, targets)}

    tx = R.jdpp.build_optimizer(jargs, total_steps=steps)
    tp_axis = "model" if tp else None
    if jargs.zero:
        state = ddp.zero_state(apply_fn=jmodel.apply, params=params0 if tp else ddp.broadcast_params(params0, mesh),
                               tx=tx, mesh=mesh, tp_axis=tp_axis, level=jargs.zero)
    else:
        state = ddp.TrainState.create(apply_fn=jmodel.apply, params=params0, tx=tx)
        state = ddp.shard_state_tp(state, mesh) if tp else ddp.broadcast_params(state, mesh)
    step = ddp.make_train_step(jloss, mesh=mesh, accum_steps=jargs.accum_steps, zero=jargs.zero,
                               cp_axis="seq" if cp else None, tp_axis=tp_axis, grad_clip=jargs.grad_clip,
                               donate=False)
    place = (lambda b: R.shard_lm_batch(b["tokens"], mesh)) if cp else None
    loader = R.DataLoader(dataset, per_replica_batch=jargs.batch_size, mesh=mesh, shuffle=True,
                          seed=jargs.seed, place_fn=place)
    loader.set_epoch(0)
    losses = []
    for batch in itertools.islice(loader, steps):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    out = {"flags": flags, "losses": losses, "params0": params0, "params": jax.tree.map(np.asarray, state.params)}
    if jargs.eval:
        def metric_fn(p, batch):
            inputs, targets = pairs(batch)
            logits = jmodel.apply({"params": p}, inputs)
            return {"loss": R.pe_ce(logits, targets), "accuracy": R.pe_acc(logits, targets)}

        evaluate = R.jcp.make_cp_eval_step(metric_fn, mesh=mesh, masked=True)
        eval_loader = R.DataLoader(R.jdpp.build_dataset(jargs, train=False), per_replica_batch=jargs.batch_size,
                                   mesh=mesh, shuffle=False, seed=jargs.seed, with_mask=True,
                                   place_fn=lambda b: R.shard_lm_batch(b["tokens"], mesh, valid=b["valid"]))
        parts = [evaluate(state.params, b) for b in eval_loader]
        total = sum(float(c) for _, c in parts)
        out["eval"] = {k: sum(float(m[k]) * float(c) for m, c in parts) / total for k in parts[0][0]}
    return out


def port_params(ranks, name, flags):
    """The port's final parameters as the reference's tree: the model
    ranks' shards (data 0, seq 0) merged."""
    tcfg = tdpp.build_config(tdpp.parse_args(["--device", "cpu", *flags]))
    shards = sorted(((r["dpp"][name]["coords"].get("model", 0), r["dpp"][name]["params"]) for r in ranks
                     if r["dpp"][name]["coords"]["data"] == 0 and r["dpp"][name]["coords"].get("seq", 0) == 0),
                    key=lambda t: t[0])
    return to_jax_params(merge_tp_shards([sd for _, sd in shards]), tcfg)


def check_dpp_run(ranks, name, want, loss_atol=LOSS_ATOL, update_rtol=UPDATE_RTOL):
    """The port's run ``name`` against the reference's, ``want`` (the bf16
    tolerances in the module docstring by default)."""
    jax = ref().jax
    flags = want["flags"]
    ranks = ranks.get()
    runs = [r["dpp"][name] for r in ranks]
    for run in runs:  # every rank reports the global (mean) loss
        np.testing.assert_allclose(run["losses"], want["losses"], atol=loss_atol, rtol=0, err_msg=name)
    got = port_params(ranks, name, flags)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(want["params"])[0]]
    for path, p0, a, b in zip(paths, jax.tree.leaves(want["params0"]), jax.tree.leaves(got),
                              jax.tree.leaves(want["params"])):
        scale = float(np.abs(b - p0).max())
        err = float(np.abs((a - p0) - (b - p0)).max())
        assert err <= update_rtol * scale + 1e-7, f"{name} {path}: update off by {err} (largest {scale})"
    if "eval" in want:
        for run in runs:
            for k, v in want["eval"].items():
                assert abs(run["eval"][k] - v) <= loss_atol, f"{name} eval {k}: {run['eval'][k]} vs {v}"


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", [n for n in RING_CASES if n.startswith("flash")])
def test_flash_ring_matches_reference(ranks, want, name):
    check_ring(ranks, want, name)


def test_einsum_ring_matches_reference_xla_ring(ranks, want):
    check_ring(ranks, want, "einsum-n4-f32-gqa")


@pytest.mark.parametrize("name", list(DPP_RUNS))
def test_dpp_cp_matches_reference(ranks, want, name):
    check_dpp_run(ranks, name, want[name])


def test_seq_axis_spanning_the_world_matches_one_device(ranks):
    """``--cp`` equal to the rank count (data 1 x seq 8): the step's loss is
    the whole sequence's and its update the unsharded model's (f32: the loss
    within 1e-5, the parameters within F32_ATOL; summation order).  Without
    the seq-axis mean each rank would keep its own chunk's loss and
    gradient."""
    for r in ranks.get():
        got = r["whole_world"]
        assert abs(got["loss"] - got["want_loss"]) < 1e-5, (got["loss"], got["want_loss"])
        for name, p in got["params"].items():
            torch.testing.assert_close(p, got["want"][name], atol=F32_ATOL, rtol=0, msg=name)


def test_global_seq_len_guard_and_decode_refusal(ranks):
    """Under CP the length guard checks the global length, with the
    reference's message (computed on the ranks: 12 local tokens x 2 seq
    shards against max_seq_len 16); the decode twin has no
    sequence-sharded cache."""
    twin = ttfm.TransformerLM(ttfm.tiny_lm(max_seq_len=16, cp_axis="seq", decode=True))
    with pytest.raises(ValueError, match="decode does not compose with cp_axis/remat"):
        twin(torch.zeros(1, 2, dtype=torch.long), positions=torch.arange(2), cache=[])
    for r in ranks.get():
        assert r["guard"] == "global seq len 24 (12 local x 2 'seq' shards) > max_seq_len 16"


FLAG_ERRORS = [
    (["--model", "cnn", "--cp", "2"], SystemExit, "--cp requires an LM model"),
    (["--model", "gpt2", "--cp", "3", "--seq-len", "16"], SystemExit, "--seq-len must be divisible by --cp"),
    (["--model", "mlp", "--tp", "2"], SystemExit, "--tp requires an LM model"),
    (["--model", "gpt2", "--tp", "2", "--zero", "2"], SystemExit, "--zero 2 shards over the data axis only"),
    (["--model", "gpt2", "--tp", "2", "--grad-compress", "powersgd"], SystemExit, "supports DP/CP layouts"),
    (["--model", "gpt2", "--tp", "2", "--generate", "4"], SystemExit, "--generate needs replicated params"),
    (["--model", "gpt2", "--cp", "2", "--overlap", "--grad-compress", "powersgd"], SystemExit,
     "pick one mechanism"),
    (["--model", "gpt2", "--pp", "2", "--cp", "2", "--eval"], SystemExit, "--pp --eval does not support --cp"),
    (["--model", "gpt2", "--moe-experts", "2", "--ep", "2", "--cp", "2", "--tp", "2"], SystemExit,
     "--ep with --cp composes pairwise only"),
]


def test_dpp_flag_errors():
    """The reference's checks and messages (``dpp.py:554-560``, ``:757-840``);
    what the reference accepts and the port does not run yet names its
    ROADMAP item.  ``--overlap`` and PowerSGD parse with ``--cp`` (each
    alone, as the reference takes them)."""
    for flags, err, match in FLAG_ERRORS:
        with pytest.raises(err, match=match):
            tdpp.parse_args(["--device", "cpu", *flags])
    for extra in (["--overlap"], ["--grad-compress", "powersgd"]):
        args = tdpp.parse_args(["--device", "cpu", "--model", "gpt2", "--cp", "2", *extra])
        assert args.cp == 2 and (args.overlap or args.grad_compress == "powersgd")
