"""Resharding on resume (``training/elastic.py``, the checkpoint's topology
record) against the JAX package's ``training/elastic.py``, on the CPU.

One pool of 4 gloo processes runs every case.  Each case trains a tiny
GPT-2 for 2 steps at its saving geometry on 4 ranks and writes a
checkpoint, then goes on with a third step (the uninterrupted run).  The
resumes run in the same processes: at 4 ranks on another mesh, then after
the gang is rebuilt at 3 ranks (``rebuild_process_group``, one process
leaves), then at 2.  A resumed run loads the checkpoint into a trainer
built for its own geometry and takes the third step on the same global
batch, split over its data ranks.

- The reshard math: ``repad_flat`` and ``reshard_zero_model_flat`` equal
  the reference's ``repad_flat`` and ``_reshard_zero_model_flat`` on the
  same numpy arrays, bit for bit (the same values are only moved).
- Every resume at the same global batch matches the uninterrupted run,
  as the reference's tests hold theirs: the third step's loss within rtol
  1e-6 (the restored parameters are the saved ones; only the reduction
  of the loss over other ranks differs) and the whole model after it
  within atol 1e-5 (the gradient's mean over another number of ranks
  sums in another order).  Replicated: data 4 -> 2, TP (2, 2) -> (2, 1),
  pipeline stages 4 -> 2.  ZeRO-1: data 4 -> 2 and 4 -> 3 (another
  padding), TP (2, 2) -> (2, 1), EP (2, 2) -> (2, 1), PP (2, 2) -> (1, 4).
  FSDP: data 4 -> 2 and (2, tp 2) -> (4, tp 1).
- PowerSGD 4 -> 2 keeps rank 0's warm Q and starts the residuals at zero.
- The refusals, with the reference's messages: a layout mismatch, an
  interleaved geometry, a payload without the record into an interleaved
  run, ZeRO-2 at another data degree.
- End to end against the reference: ZeRO-1 4 -> 2 against the
  reference's ``zero_state`` on 4 of its fake CPU devices, its checkpoint
  and ``elastic_restore`` on 2, with momentum SGD: the restored parameters
  and each of the 2 ranks' momentum shard, and the losses of the 3 steps,
  within atol 2e-5 / rtol 1e-4 (``test_torch_zero.py``'s: XLA's and
  torch's matmuls sum in other orders).
"""

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
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training import elastic as tel  # noqa: E402
from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture


def ref():
    """The JAX side, imported here and not at the top: the gloo ranks
    import this module and need torch only."""
    import jax
    import optax

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp
    from distributeddataparallel_tpu.data.loader import shard_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import lm_cross_entropy
    from distributeddataparallel_tpu.training import elastic as jel
    from distributeddataparallel_tpu.training.checkpoint import Checkpointer

    return SimpleNamespace(jax=jax, optax=optax, ddp=ddp, jdpp=jdpp, shard_batch=shard_batch, jtfm=jtfm,
                           lm_ce=lm_cross_entropy, jel=jel, Checkpointer=Checkpointer)


LM = ["--model", "gpt2", "--d-model", "32", "--layers", "4", "--seq-len", "16", "--vocab-size", "64",
      "--num-examples", "64", "--batch-size", "2", "--epochs", "1", "--optimizer", "adamw", "--lr", "1e-2"]
GPT2 = dict(vocab_size=64, num_layers=4, num_heads=2, d_model=32, d_ff=128, max_seq_len=16)
ROWS = 12  # the global batch: divisible by every data degree below
MOE = ["--moe-experts", "4", "--moe-top-k", "2"]
# name: (flags at 4 ranks, flags of the resume, its world)
CASES = {
    "repl_dp": ([], [], 2),
    "repl_tp": (["--tp", "2"], [], 2),
    "repl_pp": (["--pp", "4", "--batch-size", "4"], ["--pp", "2"], 2),
    "powersgd": (["--grad-compress", "powersgd", "--powersgd-rank", "2"],
                 ["--grad-compress", "powersgd", "--powersgd-rank", "2"], 2),
    "zero1_4to2": (["--zero", "1"], ["--zero", "1"], 2),
    "zero1_4to3": (["--zero", "1"], ["--zero", "1"], 3),
    "zero1_tp": (["--zero", "1", "--tp", "2"], ["--zero", "1"], 2),
    "zero1_ep": (["--zero", "1", *MOE, "--ep", "2"], ["--zero", "1", *MOE], 2),
    "zero1_pp": (["--zero", "1", "--pp", "2"], ["--zero", "1", "--pp", "4", "--batch-size", "4"], 4),
    "fsdp_4to2": (["--fsdp"], ["--fsdp"], 2),
    "fsdp_tp": (["--fsdp", "--tp", "2"], ["--fsdp"], 4),
}
REFUSE = {  # name: (flags at 4 ranks, flags of the resume at 2 ranks, how the payload is forged)
    "layout": (["--zero", "1"], [], None),
    "interleaved": (["--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"],
                    ["--pp", "2", "--pp-schedule", "1f1b"], None),
    "legacy_into_interleaved": (["--pp", "2", "--pp-schedule", "1f1b"],
                                ["--pp", "2", "--pp-schedule", "1f1b", "--pp-virtual", "2"], "legacy"),
    "zero2": (["--zero", "2"], ["--zero", "2"], None),
}
# The case run against the reference, 4 -> 2: SGD with momentum, whose
# update does not normalize, so the two frameworks' rounding stays at the
# rounding's size (AdamW turns a near-zero gradient's rounding into a
# visible fraction of a step).
E2E = ["--zero", "1", "--optimizer", "sgd", "--momentum", "0.9", "--lr", "0.1"]


# ------------------------------------------------------------- the ranks --

def _batches():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 64, size=(ROWS, 17)) for _ in range(3)]


def _trainer(flags, rank, world):
    args = tdpp.parse_args(["--device", "cpu", *LM, *flags])
    return tdpp.build_trainer(args, torch.device("cpu"), rank, world)


def _step(trainer, tokens, rank, world) -> float:
    """One step on this rank's rows of the global batch."""
    d, n = tdpp.data_coords(rt.current_mesh(), rank, world)
    rows = len(tokens) // n
    return float(trainer.step_fn(trainer.state, {"tokens": torch.from_numpy(tokens[d * rows : (d + 1) * rows])})["loss"])


def _whole(state):
    """The whole model on rank 0 (None elsewhere), copied (on the CPU the
    payload's tensors are the live ones): a collective."""
    payload = host_payload(state, 0)
    return None if payload is None else {k: v.clone() for k, v in payload["model"].items()}


def _save(name, flags, rank, world, directory, sd=None):
    """2 steps at 4 ranks, a checkpoint, then the third step."""
    t = _trainer(flags, rank, world)
    if sd is not None:
        with t.state.full_params():
            t.state.model.load_state_dict(sd)
    b = _batches()
    losses = [_step(t, x, rank, world) for x in b[:2]]
    files = CheckpointFiles(str(Path(directory) / name))
    payload = host_payload(t.state, 0)
    if rank == 0:
        files.write(t.state, 0, payload)
    rt.barrier()
    losses.append(_step(t, b[2], rank, world))
    return {"losses": losses, "model": _whole(t.state)}


def _resume(name, flags, rank, world, directory):
    """The checkpoint into a trainer of this geometry, then the third step."""
    t = _trainer(flags, rank, world)
    saved = CheckpointFiles(str(Path(directory) / name)).read(0)
    nxt = CheckpointFiles.load_into(t.state, saved)
    out = {"next_epoch": nxt, "step": t.state.step, "restored": _whole(t.state)}
    if t.state.comm_state is not None:
        out["q"] = [None if s is None else s.q.clone() for s in t.state.comm_state]
        out["err_zero"] = all(s is None or not s.err.any() for s in t.state.comm_state)
        out["saved_q"] = [None if s is None else s["q"] for s in saved["ranks"][0]["comm_state"]]
    if t.state.zero is not None:
        sp, opt = t.state.zero.shard_params, t.state.optimizer
        out["flats"] = {k: torch.cat([opt.state[p][k] for p in sp]) for k, v in opt.state[sp[0]].items()
                        if v.dim() > 0}
    out["loss"] = _step(t, _batches()[2], rank, world)
    out["model"] = _whole(t.state)
    return out


def _save_untrained(name, flags, rank, world, directory):
    """A refusal case's checkpoint: the payload of a fresh trainer (the
    refusals come before any state is read)."""
    t = _trainer(flags, rank, world)
    payload = host_payload(t.state, 0)
    if rank == 0:
        CheckpointFiles(str(Path(directory) / name)).write(t.state, 0, payload)
    rt.barrier()


def _refusal(name, flags, forge, rank, world, directory):
    t = _trainer(flags, rank, world)
    saved = CheckpointFiles(str(Path(directory) / name)).read(0)
    if forge == "legacy":  # a payload written before the topology record
        saved = {k: v for k, v in saved.items() if k not in ("topology", "pp_virtual")}
    try:
        CheckpointFiles.load_into(t.state, saved)
    except ValueError as e:
        return str(e)
    return "none"


def _worker(rank, world, store, out_dir, sd):
    torch.set_num_threads(1)
    # ZeRO shards stepped in pieces of 4096 elements: the piece count
    # differs between 4 ranks and fewer, as at GPT-2 124M's width.
    from distributeddataparallel_tpu_torch.parallel import zero

    zero.MAX_PIECE = 4096
    rt.init_process_group(store_address=store, world_size=world, rank=rank, device="cpu")
    res = {"saved": {}, "resumed": {}, "refusals": {}}
    for name, (old, _, _) in CASES.items():
        res["saved"][name] = _save(name, old, rank, world, out_dir)
    for name, (old, _, _) in REFUSE.items():
        _save_untrained(name, old, rank, world, out_dir)
    res["saved"]["e2e"] = _save("e2e", E2E, rank, world, out_dir, sd)
    for size, epoch in ((4, None), (3, 1), (2, 2)):
        if epoch is not None and rt.rebuild_process_group(list(range(size)), epoch) is None:
            break  # this process left the gang
        for name, (_, new, n) in CASES.items():
            if n == size:
                res["resumed"][name] = _resume(name, new, rank, size, out_dir)
        if size == 2:
            res["resumed"]["e2e"] = _resume("e2e", E2E, rank, size, out_dir)
            for name, (_, new, forge) in REFUSE.items():
                res["refusals"][name] = _refusal(name, new, forge, rank, size, out_dir)
    rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


class Ranks:
    """``_worker`` on 4 gloo processes whose process group forms on a
    ``TCPStore`` this process holds (the launcher's arrangement, so the
    gang can be rebuilt on it); ``get()`` waits for them and returns each
    rank's results.  The JAX side runs before ``get()``."""

    def __init__(self, out_dir, sd, world=4):
        import torch.distributed as dist
        import torch.multiprocessing as mp

        self.store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
        self.out, self.world, self._results = Path(out_dir), world, None
        self._ctx = mp.spawn(_worker, args=(world, f"127.0.0.1:{self.store.port}", str(out_dir), sd),
                             nprocs=world, join=False)

    def get(self) -> list[dict]:
        if self._results is None:
            while not self._ctx.join():
                pass
            self._results = [torch.load(self.out / f"rank{r}.pt", weights_only=False) for r in range(self.world)]
        return self._results


def _init_sd():
    """The e2e case's initial weights (the port's seeded init)."""
    return ttfm.TransformerLM(ttfm.gpt2_124m(**GPT2), generator=torch.Generator().manual_seed(0)).state_dict()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("elastic_ranks"), _init_sd())
    yield r
    r.get()


# ----------------------------------------------------------------- tests --

def _geometries():
    """(geom, order, n_old, axn_old, n_new, axn_new) cases of the reshard:
    TP 2 -> 4 with the data degree 2 -> 1, EP 1 -> 2, PP 4 -> 2 (stacked
    layers), and all three at once with a 3-way data split."""
    T, E, P = "model", "expert", "pipe"
    base = [((4, 32, 2, 16), {2: T, 0: P}), ((4, 2, 16, 32), {1: T, 0: P}), ((4, 4, 32, 64), {1: E, 0: P}),
            ((64, 32), {}), ((5,), {})]
    return [
        (base, [T, E, P], 2, {T: 2}, 1, {T: 4}),
        (base, [T, E, P], 4, {}, 2, {E: 2}),
        (base, [T, E, P], 1, {P: 4}, 2, {P: 2}),
        (base, [T, E, P], 3, {T: 2, E: 2, P: 2}, 2, {T: 1, E: 4, P: 1}),
    ]


@pytest.mark.parametrize("which", ["repad", "zero_model_flat"])
def test_reshard_math_is_the_references(which, ranks):  # ranks: the pool works meanwhile
    jel = ref().jel
    rng = np.random.default_rng(0)
    if which == "repad":
        for shape, true, new in (((37,), 33, 40), ((3, 18), 17, 21), ((8,), 8, 8)):
            a = rng.standard_normal(shape).astype(np.float32)
            a[..., true:] = 0
            np.testing.assert_array_equal(tel.repad_flat(torch.from_numpy(a), true, new).numpy(),
                                          jel.repad_flat(a, true, new))
        return
    for geom, order, n_old, axn_old, n_new, axn_new in _geometries():
        lt_old, chunk_old = jel._zero_sizes(geom, n_old, axn_old)
        _, chunk_new = jel._zero_sizes(geom, n_new, axn_new)
        assert (lt_old, chunk_old) == tel.zero_sizes(geom, n_old, axn_old)
        m_old = int(np.prod([axn_old.get(a, 1) for a in order]))
        flat = rng.standard_normal(chunk_old * n_old * m_old).astype(np.float32)
        want = jel._reshard_zero_model_flat(flat, geom, order, n_old, axn_old, chunk_old, lt_old, n_new, axn_new,
                                            chunk_new)
        got = tel.reshard_zero_model_flat(torch.from_numpy(flat), geom, order, n_old, axn_old, chunk_old,
                                          lt_old, n_new, axn_new, chunk_new)
        np.testing.assert_array_equal(got.numpy(), want)


def test_zero1_resume_matches_the_references_elastic_restore(ranks, tmp_path):
    """The reference's own elastic path on the same weights and batches:
    ``zero_state`` on 4 of its fake CPU devices for 2 momentum-SGD steps, its
    checkpoint with ``topology_meta``, ``elastic_restore`` into a
    ``zero_state`` on 2, the third step."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    cfg = ttfm.gpt2_124m(**GPT2)
    jmodel = R.jtfm.TransformerLM(R.jtfm.gpt2_124m(attn_impl="xla", **GPT2))
    params = to_jax_params(_init_sd(), cfg)
    tx = R.jdpp.build_optimizer(R.jdpp.parse_args(["--device", "cpu", *LM, *E2E]), total_steps=32)

    def loss_fn(p, batch, rng):
        toks = batch["tokens"]
        return R.lm_ce(jmodel.apply({"params": p}, toks[:, :-1]), toks[:, 1:]), {}

    def fresh(n):
        mesh = ddp.make_mesh(("data",), devices=jax.devices()[:n])
        st = ddp.zero_state(apply_fn=jmodel.apply, params=ddp.broadcast_params(params, mesh), tx=tx, mesh=mesh)
        return mesh, st, ddp.make_train_step(loss_fn, mesh=mesh, zero=True, donate=False)

    b = [x.astype(np.int32) for x in _batches()]
    mesh4, st, step = fresh(4)
    losses = []
    for x in b[:2]:
        st, m = step(st, R.shard_batch({"tokens": x}, mesh4), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    ckpt = R.Checkpointer(str(tmp_path))
    ckpt.save(st, 0, meta=R.jel.topology_meta(mesh4, "zero1"))
    ckpt.wait()
    mesh2, st2, step2 = fresh(2)
    st2, nxt = R.jel.elastic_restore(ckpt, st2, mesh2, layout="zero1")
    trace = [s for s in jax.tree.leaves(st2.opt_state, is_leaf=lambda x: hasattr(x, "trace"))
             if hasattr(s, "trace")][0]
    trace = np.asarray(trace.trace)
    want = from_jax_params(jax.tree.map(np.array, st2.params), cfg)  # copies: the step reuses the buffers
    st2, m = step2(st2, R.shard_batch({"tokens": b[2]}, mesh2), jax.random.PRNGKey(0))
    losses.append(float(m["loss"]))
    tol = dict(atol=2e-5, rtol=1e-4)  # test_torch_zero.py's, for the same reason
    got = ranks.get()
    np.testing.assert_allclose(got[0]["saved"]["e2e"]["losses"][:2] + [got[0]["resumed"]["e2e"]["loss"]],
                               losses, **tol)
    for k, v in got[0]["resumed"]["e2e"]["restored"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **tol)
    for r in range(2):
        res = got[r]["resumed"]["e2e"]
        buf = res["flats"]["momentum_buffer"]
        local = buf.numel()
        assert nxt == res["next_epoch"] == 1 and local * 2 == trace.shape[0]
        np.testing.assert_allclose(buf.numpy(), trace[r * local : (r + 1) * local], **tol)


def _check_resume(ranks, name):
    saved, resumed = ranks[0]["saved"][name], ranks[0]["resumed"][name]
    assert resumed["next_epoch"] == 1 and resumed["step"] == 2, resumed
    np.testing.assert_allclose(resumed["loss"], saved["losses"][2], rtol=1e-6, atol=0)
    for k, v in saved["model"].items():
        np.testing.assert_allclose(resumed["model"][k].numpy(), v.numpy(), atol=1e-5, rtol=0, err_msg=f"{name} {k}")


def test_replicated_resumes_at_another_geometry(ranks):
    """Data 4 -> 2, TP (2, 2) -> (2, 1), pipeline stages 4 -> 2."""
    for name in ("repl_dp", "repl_tp", "repl_pp"):
        _check_resume(ranks.get(), name)


def test_powersgd_keeps_the_warm_q_and_zeroes_the_residuals(ranks):
    for r in ranks.get()[:2]:
        got = r["resumed"]["powersgd"]
        assert got["err_zero"]
        for a, b in zip(got["q"], got["saved_q"]):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
        assert np.isfinite(got["loss"])


def test_zero1_resumes_across_the_data_degree(ranks):
    """4 -> 2, and 4 -> 3, where the flat's padding differs."""
    for name in ("zero1_4to2", "zero1_4to3"):
        _check_resume(ranks.get(), name)


def test_zero1_resumes_across_the_model_axes(ranks):
    """TP (2, 2) -> (2, 1), EP (2, 2) -> (2, 1), PP (2, 2) -> (1, 4)."""
    for name in ("zero1_tp", "zero1_ep", "zero1_pp"):
        _check_resume(ranks.get(), name)


def test_fsdp_resumes_across_the_data_and_tp_degrees(ranks):
    """4 -> 2, and (2, tp 2) -> (4, tp 1)."""
    for name in ("fsdp_4to2", "fsdp_tp"):
        _check_resume(ranks.get(), name)


def test_refusals_are_the_references(ranks):
    interleaved = ("checkpoint layer storage is interleaved for (pp={}, virtual={}) but this run is (pp={}, "
                   "virtual={}) — interleaved layouts resume only at their exact pipeline geometry")
    want = {
        "layout": "checkpoint layout 'zero1' does not match the current run's 'replicated' — rebuild the state "
                  "the same way it was saved",
        "interleaved": interleaved.format(2, 2, 2, 1),
        "legacy_into_interleaved": interleaved.format(2, 1, 2, 2),
        "zero2": "unknown elastic layout 'zero2'",
    }
    for r in ranks.get()[:2]:
        assert r["refusals"] == want, r["refusals"]
