"""The port's comm hooks (the bf16 hook of ``parallel.data_parallel`` and
``parallel.powersgd``) against the JAX package's, on 2 gloo ranks against 2
of its 8 fake CPU devices, and the reference's layout refusals.

The same seeded numpy gradients enter both sides.  The bf16 hook's buckets
are bit-equal; PowerSGD's approximation and residual agree to f32 matmul
rounding, its factor ``q`` up to the sign of each column (thin QR's column
signs are a convention: ``P Pᵀ M`` does not depend on them).  The other
PowerSGD checks mirror ``tests/test_powersgd.py``.
"""

import functools
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces  # noqa: E402
from distributeddataparallel_tpu_torch.models.simple_cnn import TinyMLP  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import data_parallel as tdp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import powersgd as tps  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

WORLD = 2


@functools.cache
def ref():
    """The JAX side, imported here and not at the top: the gloo ranks
    import this module and need torch only."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp  # the reference entry point
    from distributeddataparallel_tpu.parallel import data_parallel as jdp
    from distributeddataparallel_tpu.parallel import powersgd as jps

    return SimpleNamespace(jax=jax, jnp=jnp, P=PartitionSpec, ddp=ddp, jdpp=jdpp, jdp=jdp, jps=jps)

# Leaves: two compressed matrices (one folded from 4-D), a dense 1-D leaf
# and a dense small one.
SHAPES = [(64, 300), (3, 3, 8, 300), (100,), (10, 10)]
RANK, ROUNDS = 4, 3
BF16_BUCKET = 4096


def _grads(seed: int) -> list[np.ndarray]:
    """Per-rank gradients: a (WORLD, *shape) array a leaf."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(WORLD, *s)).astype(np.float32) for s in SHAPES]


def _proto_batches(steps: int, rows: int, seed: int = 0):
    """The reference test's task: 10 prototypes of 16x16x1 images plus
    noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(10, 16, 16, 1)).astype(np.float32)
    out = []
    for _ in range(steps):
        labels = rng.integers(0, 10, size=(rows,))
        imgs = protos[labels] + 0.1 * rng.normal(size=(rows, 16, 16, 1)).astype(np.float32)
        out.append((imgs.astype(np.float32), labels))
    return out


def _image_loss(model, batch):
    return torch.nn.functional.cross_entropy(model(batch["image"]), batch["label"]), {}


def _mlp_train(rank, world, rank_req, steps, seed=0):
    model = TinyMLP((16, 16, 1), features=(128,), num_classes=10,
                    generator=torch.Generator().manual_seed(seed))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1))
    state.comm_state = tps.powersgd_state(tps.leaf_shapes(jax_leaf_pieces(model)), rank_req, seed=seed)
    q0 = [None if s is None else s.q.shape for s in state.comm_state]
    step = make_train_step(_image_loss, grad_compress="powersgd")
    rows = 8
    losses = []
    for x, y in _proto_batches(steps, rows * world):
        b = {"image": torch.from_numpy(x[rank * rows : (rank + 1) * rows]),
             "label": torch.from_numpy(y[rank * rows : (rank + 1) * rows]).long()}
        losses.append(float(step(state, b)["loss"]))
    q1 = [None if s is None else s.q.shape for s in state.comm_state]
    return {"losses": losses, "params": {k: v.detach().clone() for k, v in model.named_parameters()},
            "q_shapes": (q0, q1)}


def _scenarios(rank, world, payload):
    out = {}
    # bf16 hook: per leaf and bucketed.
    for mode, bb in (("leaf", None), ("bucketed", BF16_BUCKET)):
        gs = [torch.from_numpy(g[rank].copy()) for g in payload["bf16"]]
        tdp.all_reduce_gradients(gs, bucket_bytes=bb, compress="bf16")
        out[f"bf16_{mode}"] = gs
    out["wire_dtype"] = tdp.bucket_flat([torch.zeros(3), torch.zeros(2)], "bf16").dtype
    # PowerSGD from the reference's initial q, ROUNDS rounds.
    state = [None if q is None else tps.PowerSGDLeaf(q=torch.from_numpy(q), err=torch.zeros(s))
             for q, s in zip(payload["q0"], SHAPES)]
    rounds = []
    for g_round in payload["psgd"]:
        gs = [torch.from_numpy(g[rank].copy()) for g in g_round]
        prev = [None if s is None else s.err.clone() for s in state]
        synced, state = tps.powersgd_sync(gs, state)
        rounds.append({"synced": synced, "state": state, "grads": gs, "prev": prev})
    out["psgd"] = rounds
    # Full rank: the dense mean.
    gs = [torch.from_numpy(g[rank].copy()) for g in payload["psgd"][0]]
    full = tps.powersgd_state(gs, rank=10_000)
    out["full_rank"] = (tps.powersgd_sync(gs, full)[0], [g.clone() for g in gs])
    out["full_rank_sum"] = tps.powersgd_sync(gs, full, op="sum")[0]
    for g in out["full_rank"][1]:
        torch.distributed.all_reduce(g)
        g.div_(world)
    out["train_rank2"] = _mlp_train(rank, world, 2, 30)
    out["train_clamped"] = _mlp_train(rank, world, 512, 1)
    return out


def _worker(rank, world, coordinator, out_dir, payload):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = _scenarios(rank, world, payload)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


def _mesh():
    return ref().ddp.make_mesh(("data",), devices=ref().jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def payload():
    jnp = ref().jnp
    params = {f"l{i}": jnp.zeros(s, jnp.float32) for i, s in enumerate(SHAPES)}
    jstate = ref().jps.powersgd_state(params, WORLD, rank=RANK)
    q0 = [None if jstate[f"l{i}"] is None else np.asarray(jstate[f"l{i}"].q) for i in range(len(SHAPES))]
    return {"bf16": _grads(0), "psgd": [_grads(10 + t) for t in range(ROUNDS)], "q0": q0, "jstate": jstate}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("hook_ranks")
    sent = {k: v for k, v in payload.items() if k != "jstate"}
    mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{rt.free_port()}", str(out), sent), nprocs=WORLD, join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_per_rank(fn, stacked: list[np.ndarray]):
    """``fn`` (a list of leaves -> a list of leaves) in a shard_map over 2
    devices, each device getting its row of every stacked leaf; returns
    each device's outputs."""
    jax, P = ref().jax, ref().P
    sm = jax.shard_map(lambda *ls: [x[None] for x in fn([x[0] for x in ls])], mesh=_mesh(),
                       in_specs=tuple(P("data") for _ in stacked),
                       out_specs=[P("data") for _ in stacked], check_vma=False)
    return [np.asarray(o) for o in jax.jit(sm)(*[ref().jnp.asarray(s) for s in stacked])]


def test_bf16_hook_bit_equal_jax(payload, ranks):
    """Per leaf and bucketed, exact: both cast to bf16, sum two values once
    in bf16, multiply by bf16(1/2) and cast back."""
    for mode, bb in (("leaf", None), ("bucketed", BF16_BUCKET)):
        want = _jax_per_rank(functools.partial(ref().jdp.all_reduce_gradients, axis_name="data",
                                               compress="bf16", bucket_bytes=bb), payload["bf16"])
        for r in range(WORLD):
            for got, w in zip(ranks[r][f"bf16_{mode}"], want):
                np.testing.assert_array_equal(got.numpy(), w[r], err_msg=mode)
    assert ranks[0]["wire_dtype"] == torch.bfloat16


def test_powersgd_matches_jax(payload, ranks):
    """ROUNDS rounds from the reference's initial q, each side carrying its
    own state: the synced leaves and residuals within atol 2e-5 / rtol 1e-4
    (f32 matmuls and QR in another order, through three rounds), q within
    the same up to column signs; the dense leaves exactly."""
    jax, jnp, P, jps = ref().jax, ref().jnp, ref().P, ref().jps
    mesh = _mesh()
    jstate = payload["jstate"]
    specs = jps.powersgd_state_specs(jstate)

    def body(gs, st):
        synced, new = jps.powersgd_sync({f"l{i}": g[0] for i, g in enumerate(gs)}, st, "data")
        return [synced[f"l{i}"][None] for i in range(len(SHAPES))], new

    sm = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=([P("data")] * len(SHAPES), specs),
                               out_specs=([P("data")] * len(SHAPES), specs), check_vma=False))
    tol = dict(atol=2e-5, rtol=1e-4)
    for t, g_round in enumerate(payload["psgd"]):
        synced, jstate = sm([jnp.asarray(g) for g in g_round], jstate)
        for i in range(len(SHAPES)):
            js = jstate[f"l{i}"]
            for r in range(WORLD):
                got = ranks[r]["psgd"][t]
                if js is None:
                    np.testing.assert_array_equal(got["synced"][i].numpy(), np.asarray(synced[i])[r])
                    continue
                np.testing.assert_allclose(got["synced"][i].numpy(), np.asarray(synced[i])[r], **tol)
                np.testing.assert_allclose(got["state"][i].err.numpy(), np.asarray(js.err)[r], **tol)
                q, jq = got["state"][i].q.numpy(), np.asarray(js.q)
                signs = np.sign(np.sum(q * jq, axis=0))
                np.testing.assert_allclose(q * signs, jq, **tol)


def test_powersgd_error_feedback_conserved(ranks):
    """Per rank and round: ``err + m_hat == g + err_prev`` within f32
    rounding of the sum (atol 1e-5): the hook defers signal, never drops
    it; the approximation is the same on every rank (lockstep)."""
    for r in range(WORLD):
        for t, rd in enumerate(ranks[r]["psgd"]):
            for i, s in enumerate(rd["state"]):
                if s is None:
                    continue
                prev = rd["prev"][i]
                np.testing.assert_allclose((s.err + rd["synced"][i]).numpy(),
                                           (rd["grads"][i] + prev).numpy(), rtol=0, atol=1e-5)
                assert torch.equal(rd["synced"][i], ranks[0]["psgd"][t]["synced"][i])


def test_powersgd_full_rank_matches_dense(ranks):
    """rank >= min(n, m): the projector spans the column space and the hook
    is the dense mean up to the QR round-off (atol 2e-5); ``op="sum"`` is
    that mean times the world size, exactly (a power of two)."""
    for r in range(WORLD):
        synced, dense = ranks[r]["full_rank"]
        for a, b, c in zip(synced, dense, ranks[r]["full_rank_sum"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)
            assert torch.equal(c, a * WORLD)


def test_powersgd_low_rank_learns_in_lockstep(ranks):
    """Rank-2 compression still trains the reference test's MLP (the loss
    falls below half its start in 30 steps) and the ranks' parameters stay
    bitwise equal."""
    a, b = ranks[0]["train_rank2"], ranks[1]["train_rank2"]
    assert a["losses"][-1] < 0.5 * a["losses"][0], a["losses"]
    for k in a["params"]:
        assert torch.isfinite(a["params"][k]).all()
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_powersgd_wire_bytes_and_leaf_selection():
    """The reference's ledger case: 2-D+ leaves above the size floor
    compress, 1-D and tiny ones stay dense, the bytes follow the shapes."""
    leaves = [((1000, 64), torch.float32), ((3, 3, 32, 64), torch.float32),
              ((4096,), torch.float32), ((16, 16), torch.float32)]
    st = tps.powersgd_state(leaves, rank=2)
    assert [s is not None for s in st] == [True, True, False, False]
    assert st[0].q.shape == (64, 2) and st[0].err.shape == (1000, 64)
    led = tps.powersgd_wire_bytes(leaves, rank=2)
    assert led["n_compressed_leaves"] == 2 and led["n_dense_leaves"] == 2
    assert led["powersgd_wire_bytes"] == 4 * 2 * (1000 + 64) + 4 * 2 * (288 + 64) + 4096 * 4 + 16 * 16 * 4
    assert led == ref().jps.powersgd_wire_bytes({f"l{i}": ref().jnp.zeros(s) for i, (s, _) in enumerate(leaves)},
                                                rank=2)
    with pytest.raises(ValueError, match="rank"):
        tps.powersgd_state(leaves, rank=0)


def test_powersgd_rank_clamped_to_leaf_dims(ranks):
    """An oversized rank clamps to min(n, m) per leaf and q keeps its shape
    through a step (the MLP's input matrix is 256 x 128)."""
    before, after = ranks[0]["train_clamped"]["q_shapes"]
    assert [s for s in before if s is not None] == [(128, 128)]
    assert before == after


@pytest.mark.parametrize("flags,match", [
    (["--moment-dtype", "int8"], "--moment-dtype rides"),
    (["--zero", "--overlap"], "--overlap applies"),
    (["--zero", "2", "--grad-compress", "bf16"], "--grad-compress applies"),
    (["--grad-compress", "powersgd", "--overlap"], "pick one mechanism"),
    (["--grad-compress", "powersgd", "--powersgd-rank", "0"], "--powersgd-rank must be"),
])
def test_layout_refusals_match_reference(flags, match):
    """Each composition the reference's CLI refuses, the port's refuses
    with the same message; and make_train_step's ValueErrors."""
    argv = ["--device", "cpu", *flags]
    with pytest.raises(SystemExit, match=match):
        ref().jdpp.validate_args(ref().jdpp.parse_args(argv))
    with pytest.raises(SystemExit, match=match):
        tdpp.parse_args(argv)
    for kw, m in ((dict(zero=1, bucket_bytes=1024), "zero=1"), (dict(zero=2, grad_compress="bf16"), "grad_compress"),
                  (dict(zero=4), "zero=4")):
        with pytest.raises(ValueError, match=m):
            make_train_step(_image_loss, **kw)
