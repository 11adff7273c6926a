"""The port's silent-data-corruption defence (``training/integrity.py``,
``make_train_step(integrity_every=N)``, the ZeRO-1 select) against the JAX
package's ``training/integrity.py`` and ``make_train_step``, on the CPU.

Digests are compared only where the two packages hold the same bits: state
carried across by ``models/io.py`` and that state flipped.  After an update
the packages' floats differ in their last bits, so there the verdicts are
compared, not the digests.

- ``leaf_digest`` equals the reference's on the same bit patterns: f32,
  bf16, f16, int32 and bool, with -0.0 / 0.0 and NaN payloads (exact: an
  integer sum); an f64 digest is the sum of its two 32-bit halves.
- A tiny GPT-2 carried across (unrolled and stacked layers): every
  ``params/...`` column equals the reference's by name.  The optimizer
  columns differ by design: the reference digests optax's ``count``,
  ``mu/<leaf>`` and ``nu/<leaf>``, the port torch's ``step/<leaf>``,
  ``exp_avg/<leaf>`` and ``exp_avg_sq/<leaf>`` over the same leaves.
- ``vote``, ``ShadowArbiter.resolve`` and ``IntegrityChecker``'s events and
  counters decide as the reference's on the same matrices.
- ``apply_bitflip``: the port's flipped leaf, carried back by
  ``to_jax_params``, is the reference's flipped leaf bit for bit; a flip
  into a ``copy_tree`` leaves the live state alone.
- On 3 gloo ranks against the reference's step on 3 devices, from the same
  state with rank 2 flipped: the ``params`` columns of the gathered matrix
  are bitwise the reference's, ``sdc_mismatch`` is 1 in both, every rank's
  parameters are bitwise its input and the step counts advanced.  After two
  clean steps a flip on rank 2 gives the reference's verdict, and the port
  keeps every rank's parameters, moments and schedule count bitwise.
- Integrity armed with no fault is the unarmed run bit for bit, at
  ``zero=0`` and ``zero=1``.
- ZeRO-1 with the flip inside rank 2's own shard: every rank keeps its own
  input parameters (the gather would otherwise copy rank 2's shard into
  every rank).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.models.simple_cnn import TinyMLP  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import zero as tzero  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training import integrity as tinteg  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from distributeddataparallel_tpu_torch.utils.metrics import FaultCounters  # noqa: E402
from torch_cores import share_of_the_cores  # noqa: E402,F401 -- an autouse fixture

WORLD = 3
ROWS = 12  # the global batch: 4 rows a rank
SHAPE, FEATURES = (4, 4, 3), (16, 16)
ADAM = ["--device", "cpu", "--optimizer", "adam", "--lr", "0.01"]
FLIP_LEAF = "Dense_1/kernel"


def _mlp() -> TinyMLP:
    return TinyMLP(SHAPE, FEATURES, generator=torch.Generator().manual_seed(3))


def _batches(n: int = 4) -> list[dict]:
    rng = np.random.default_rng(5)
    return [{"image": rng.normal(size=(ROWS, *SHAPE)).astype(np.float32),
             "label": rng.integers(0, 10, size=ROWS).astype(np.int32)} for _ in range(n)]


def _mine(b: dict, rank: int) -> dict:
    rows = slice(rank * ROWS // WORLD, (rank + 1) * ROWS // WORLD)
    return {"image": torch.from_numpy(b["image"][rows]), "label": torch.from_numpy(b["label"][rows]).long()}


# -------------------------------------------------------- the gloo pool --

def _state(zero: int, armed: bool) -> TrainState:
    args = tdpp.parse_args(ADAM + (["--integrity-every", "2"] if armed else []))
    model = _mlp()
    if zero:
        return tzero.zero_state(model, lambda shard: build_optimizer(args, shard, 8), level=1)
    return TrainState(model, *build_optimizer(args, model.parameters(), 8))


def _snap(state: TrainState) -> dict:
    opt = {(i, k): v.clone() for i, p in enumerate(state.optimizer.param_groups[0]["params"])
           for k, v in state.optimizer.state.get(p, {}).items()}
    return {"params": {k: v.clone() for k, v in state.model.state_dict().items()}, "opt": opt,
            "count": int(state.scheduler.count) if hasattr(state.scheduler, "count") else None,
            "step": state.step,
            "flat": state.zero.flat.clone() if state.zero is not None else None}


def _rank_cases(rank: int) -> dict:
    out, b = {}, _batches()
    # A: one cadence step from the carried-across state, rank 2 flipped.
    state = _state(0, True)
    step = make_train_step(tdpp._image_loss_fn, integrity_every=2)
    tinteg.apply_bitflip(state, rank=2, leaf=FLIP_LEAF)
    before = _snap(state)
    m = step(state, _mine(b[0], rank))
    out["A"] = {"matrix": m["sdc_digest"].numpy(), "mismatch": float(m["sdc_mismatch"]), "before": before,
                "after": _snap(state),
                "names": tinteg.digest_leaf_names(tinteg.digest_parts(_state(0, True), 0))}
    # B: two clean steps, then rank 2 flipped before cadence step 2.
    state = _state(0, True)
    flags = [float(step(state, _mine(x, rank)).get("sdc_mismatch", 0.0)) for x in b[:2]]
    tinteg.apply_bitflip(state, rank=2, leaf=FLIP_LEAF)
    before = _snap(state)
    m = step(state, _mine(b[2], rank))
    out["B"] = {"flags": flags + [float(m["sdc_mismatch"])], "matrix": m["sdc_digest"].numpy(),
                "before": before, "after": _snap(state),
                "names": tinteg.digest_leaf_names(tinteg.digest_parts(state, 0))}
    # C: armed and clean against unarmed, four steps, zero 0 and 1.
    for zero in (0, 1):
        runs = []
        for armed in (False, True):
            state = _state(zero, armed)
            st = make_train_step(tdpp._image_loss_fn, zero=zero, integrity_every=2 if armed else None)
            losses = [float(st(state, _mine(x, rank))["loss"]) for x in b]
            runs.append({"losses": losses, **_snap(state)})
        out[f"C{zero}"] = runs
    # D: ZeRO-1, the flip inside rank 2's own shard.
    state = _state(1, True)
    layout = state.zero
    pieces = dict(tdpp.jax_leaf_pieces(state.model))
    first = {pc.param: pc.offset for pc in layout.pieces}
    chunk = layout.plan.sub[0]
    leaf = next(path for path, pcs in pieces.items() if first[pcs[0][0]] >= 2 * chunk)
    tinteg.apply_bitflip(state, rank=2, leaf=leaf)
    before = _snap(state)
    m = make_train_step(tdpp._image_loss_fn, zero=1, integrity_every=2)(state, _mine(b[0], rank))
    out["D"] = {"leaf": leaf, "mismatch": float(m["sdc_mismatch"]), "before": before, "after": _snap(state),
                "matrix": m["sdc_digest"].numpy()}
    return out


def _worker(rank, world, store, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(store_address=store, world_size=world, rank=rank, device="cpu")
    try:
        res = _rank_cases(rank)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


class _Pool:
    def __init__(self, out):
        import torch.distributed as dist
        import torch.multiprocessing as mp

        self.out = out
        self.host = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
        self.ctx = mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{self.host.port}", str(out)), nprocs=WORLD,
                            join=False)
        self.results = None

    def get(self) -> list[dict]:
        if self.results is None:
            while not self.ctx.join():
                pass
            self.results = [torch.load(self.out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
        return self.results


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = _Pool(tmp_path_factory.mktemp("integrity"))
    yield p
    p.get()  # no rank outlives the module


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------------- digests --

def test_leaf_digest_is_the_references(pool):
    import jax.numpy as jnp
    from jax import lax

    from distributeddataparallel_tpu.training import integrity as jinteg

    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(5, 7)).astype(np.float32)
    f32[0, :2] = (-0.0, 0.0)
    f32.view(np.uint32)[1, :2] = (0x7FC00001, 0xFFC12345)  # two NaN payloads
    u16 = rng.integers(0, 2**16, size=(6, 4), dtype=np.uint16)
    u16[0, :3] = (0x8000, 0x0000, 0x7FC1)  # -0.0, 0.0 and a NaN
    i32 = rng.integers(-2**31, 2**31 - 1, size=9, dtype=np.int32)
    flags = rng.random(11) > 0.5
    cases = {
        "f32": (jnp.asarray(f32), torch.from_numpy(f32.copy())),
        "bf16": (lax.bitcast_convert_type(jnp.asarray(u16), jnp.bfloat16),
                 torch.from_numpy(u16.view(np.int16).copy()).view(torch.bfloat16)),
        "f16": (lax.bitcast_convert_type(jnp.asarray(u16), jnp.float16),
                torch.from_numpy(u16.view(np.int16).copy()).view(torch.float16)),
        "int32": (jnp.asarray(i32), torch.from_numpy(i32.copy())),
        "bool": (jnp.asarray(flags), torch.from_numpy(flags.copy())),
    }
    for name, (j, t) in cases.items():  # exact: integer sums of the same bits
        assert int(tinteg.leaf_digest(t)) == int(jinteg.leaf_digest(j)), name
    # -0.0 and 0.0 differ, as do two NaN payloads.
    z = torch.tensor([0.0], dtype=torch.float32)
    assert int(tinteg.leaf_digest(-z)) != int(tinteg.leaf_digest(z))
    f64 = rng.normal(size=7)
    halves = f64.view(np.uint32).astype(np.uint64).sum() % 2**32
    assert int(tinteg.leaf_digest(torch.from_numpy(f64))) == int(halves)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_gpt2_digest_columns_are_the_references_by_name(scan):
    import jax
    import jax.numpy as jnp
    import optax

    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.training import integrity as jinteg

    kw = dict(vocab_size=97, num_layers=2, d_model=32, d_ff=64, max_seq_len=32, positional="learned",
              norm="layernorm", activation="gelu", tie_embeddings=True, scan_layers=scan)
    jmodel = jtfm.TransformerLM(jtfm.tiny_lm(attn_impl="xla", **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    cfg = ttfm.tiny_lm(attn_impl="plain", **kw)
    model = ttfm.TransformerLM(cfg)
    model.load_state_dict(from_jax_params(params, cfg))
    args = tdpp.parse_args(["--device", "cpu", "--optimizer", "adamw", "--integrity-every", "1"])
    state = TrainState(model, *build_optimizer(args, model.parameters(), 4))
    jparts = {"params": params, "opt_state": optax.adamw(1e-2).init(params)}
    want = dict(zip(jinteg.digest_leaf_names(jparts), np.asarray(jax.jit(jinteg.tree_digest)(jparts)).tolist()))
    parts = tinteg.digest_parts(state, 0)
    got = dict(zip(tinteg.digest_leaf_names(parts), tinteg.tree_digest(parts).tolist()))
    params_cols = [n for n in want if n.startswith("params/")]
    assert params_cols == [n for n in got if n.startswith("params/")] and len(params_cols) > 8
    assert {n: got[n] for n in params_cols} == {n: want[n] for n in params_cols}
    # The optimizer's columns: torch's, over the same leaves (after one step
    # the fused AdamW holds its state; optax's exists from init).
    loss = model(torch.zeros((2, 4), dtype=torch.long)).float().mean()
    loss.backward()
    state.apply_gradients()
    names = tinteg.digest_leaf_names(tinteg.digest_parts(state, 0))
    leaves = {n.removeprefix("params/") for n in params_cols}
    for key in ("exp_avg", "exp_avg_sq", "step"):
        assert {n.removeprefix(f"opt_state/{key}/") for n in names if n.startswith(f"opt_state/{key}/")} == leaves
    ref_opt = [n for n in want if n.startswith("opt_state/")]
    for key in ("mu", "nu"):
        assert {n.split(f"/{key}/", 1)[1] for n in ref_opt if f"/{key}/" in n} == leaves
    assert [n for n in ref_opt if n.endswith("count")]  # optax's single count: no port column


# ------------------------------------------------------------ attribution --

MATRICES = [
    np.array([[1, 2, 3], [1, 2, 3], [1, 2, 3]], np.uint32),        # clean
    np.array([[1, 2, 3], [1, 2, 3], [1, 9, 3], [1, 2, 3]], np.uint32),  # rank 2 corrupt
    np.array([[1, 2, 3], [4, 2, 3]], np.uint32),                   # 2-rank tie
    np.array([[1, 2, 3], [4, 2, 3], [1, 5, 3]], np.uint32),        # no majority
    np.array([[1, 2, 3], [7, 2, 8], [1, 2, 3], [1, 2, 3], [1, 2, 6]], np.uint32),
]


def test_vote_and_checker_events_are_the_references(tmp_path):
    from distributeddataparallel_tpu.observability.events import EventLog as JLog
    from distributeddataparallel_tpu.training import integrity as jinteg
    from distributeddataparallel_tpu.utils.metrics import FaultCounters as JCounters
    from distributeddataparallel_tpu_torch.observability import EventLog, read_events

    names = ["a", "b", "c"]
    for m in MATRICES:
        assert tinteg.vote(m, names) == tinteg.SdcVerdict(**jinteg.vote(m, names).__dict__)
        assert tinteg.vote(m).__dict__ == jinteg.vote(m).__dict__
    runs = {}
    for name, mod, log_cls, counters_cls in (("port", tinteg, EventLog, FaultCounters),
                                              ("ref", jinteg, JLog, JCounters)):
        log, counters = log_cls(str(tmp_path / f"{name}.jsonl"), 0), counters_cls()
        checker = mod.IntegrityChecker(every=2, leaf_names=names, events=log, counters=counters)
        assert [checker.due(s) for s in range(5)] == [True, False, True, False, True]
        verdicts = [checker.check(m, step=2 * i).__dict__ for i, m in enumerate(MATRICES)]
        checker.note_shadow_mismatch(step=12)
        checker.note_eviction(2, step=2)
        log.close()
        records = [{k: v for k, v in r.items() if k not in ("ts", "seq", "v", "host", "pid", "wall")}
                   for r in read_events(str(tmp_path / f"{name}.jsonl"))]
        runs[name] = (verdicts, records, (counters.sdc_checks, counters.sdc_detects, counters.sdc_evictions))
    assert runs["port"] == runs["ref"]
    assert runs["port"][2] == (5, 5, 1)
    with pytest.raises(ValueError, match="cadence must be >= 1"):
        tinteg.IntegrityChecker(every=0)


def test_shadow_arbiter_resolves_as_the_reference():
    """Two simulated ranks: the replay from a clean snapshot recomputes the
    digest row, and the live row that differs names its rank; a replay that
    diverges itself, or no snapshot, leaves the tie open (as the
    reference's, same matrices, same verdicts)."""
    import jax.numpy as jnp

    from distributeddataparallel_tpu.training import integrity as jinteg

    args = tdpp.parse_args(ADAM + ["--integrity-every", "2"])
    model = _mlp()
    state = TrainState(model, *build_optimizer(args, model.parameters(), 8))
    step = make_train_step(tdpp._image_loss_fn)
    b = _batches(3)
    bad = {"on": False}

    def two_rows(s):  # both simulated ranks' rows; a divergent replay differs in row 1
        row = tinteg.tree_digest(tinteg.digest_parts(s, 0))
        return torch.stack([row, row + int(bad["on"])])

    arb = tinteg.ShadowArbiter(step, two_rows)
    assert arb.resolve(np.zeros((2, 3), np.int64)).tie
    arb.commit(tinteg.copy_tree(state), state)
    for x in b[:2]:
        arb.hold(_mine(x, 0), None)
        step(state, _mine(x, 0))
    truth = two_rows(state)[0].numpy()
    live_now = tinteg.copy_tree(state)
    corrupt = np.stack([truth, truth.copy()])
    corrupt[1, 3] += 1
    got = [arb.resolve(corrupt), arb.resolve(np.stack([truth, truth]))]
    bad["on"] = True
    got.append(arb.resolve(corrupt))
    assert _equal(state.model.state_dict(), live_now.model) and state.step == live_now.step  # put back

    ref = []
    for rows, diverged in ((corrupt, False), (np.stack([truth, truth]), False), (corrupt, True)):
        replay = np.stack([truth, truth + int(diverged)]).astype(np.uint32)  # the reference's uint32
        jarb = jinteg.ShadowArbiter(lambda s, bt, r: (s, {}), lambda s, rows=replay: jnp.asarray(rows))
        jarb.commit({"w": jnp.zeros(1)})
        ref.append(jarb.resolve(rows.astype(np.uint32)))
    assert [g.__dict__ for g in got] == [r.__dict__ for r in ref]
    assert got[0].corrupt == (1,) and got[0].method == "replay" and got[1].tie and got[2].tie


def test_apply_bitflip_is_the_references():
    import jax

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.models.simple_cnn import TinyMLP as JMLP
    from distributeddataparallel_tpu.training import integrity as jinteg

    model = _mlp()
    args = tdpp.parse_args(ADAM)
    state = TrainState(model, *build_optimizer(args, model.parameters(), 8))
    tree = to_jax_params(model.state_dict(), model)
    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jstate = ddp.TrainState.create(apply_fn=JMLP(features=FEATURES).apply, params=tree["params"],
                                   tx=_adam())
    copy = tinteg.copy_tree(state)
    for leaf, bit in ((FLIP_LEAF, 1), ("Dense_2/bias", 31), (None, 5)):
        tinteg.apply_bitflip(state, rank=0, leaf=leaf, bit=bit)
        jstate = jinteg.apply_bitflip(jstate, rank=0, mesh=mesh, leaf=leaf, bit=bit)
        got = to_jax_params(model.state_dict(), model)["params"]
        want = jax.tree.map(np.asarray, jstate.params)
        for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(want)):
            assert g.view(np.uint32).tobytes() == w.view(np.uint32).tobytes(), (leaf, path)
    # A flip into a copy leaves the live state alone, and load_tree brings it in.
    live = {k: v.clone() for k, v in model.state_dict().items()}
    tinteg.apply_bitflip(state, rank=0, leaf=FLIP_LEAF, copy=copy)
    assert _equal(model.state_dict(), live)
    tinteg.load_tree(state, copy)
    diff = [k for k in live if not torch.equal(live[k], model.state_dict()[k])]
    assert diff  # the copy predates the three flips and carries a fourth
    for bad, match in ((dict(rank=1), "out of range"), (dict(rank=0, leaf="nope"), "no param leaf")):
        with pytest.raises(ValueError, match=match):
            tinteg.apply_bitflip(state, **bad)


def _adam():
    import optax

    return optax.adam(1e-2)


# ------------------------------------------------------ the step, 3 ranks --

def _reference_step(flip_at: int, steps: int):
    """The reference's ``make_train_step(integrity_every=2)`` on 3 devices
    from the carried-across state, device 2's buffer flipped before step
    ``flip_at``: each step's matrix and verdict, and the per-device
    parameter buffers before and after the last step."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.models.simple_cnn import TinyMLP as JMLP
    from distributeddataparallel_tpu.ops import cross_entropy_loss as j_ce
    from distributeddataparallel_tpu.training import integrity as jinteg

    model = _mlp()
    jm = JMLP(features=FEATURES)

    def jloss(params, batch, rng):
        return j_ce(jm.apply({"params": params}, batch["image"]), batch["label"]), {}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:WORLD])
    state = ddp.broadcast_params(ddp.TrainState.create(
        apply_fn=jm.apply, params=to_jax_params(model.state_dict(), model)["params"], tx=_adam()), mesh)
    step = ddp.make_train_step(jloss, mesh=mesh, integrity_every=2, donate=False)
    out = []
    for i, b in enumerate(_batches()[:steps]):
        if i == flip_at:
            state = jinteg.apply_bitflip(state, rank=2, mesh=mesh, leaf=FLIP_LEAF)
            before = [[np.asarray(s.data) for s in leaf.addressable_shards] for leaf in jax.tree.leaves(state.params)]
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data"))) for k, v in b.items()}
        state, m = step(state, batch, jax.random.PRNGKey(0))
        mat = np.asarray(m["sdc_digest"])
        out.append((mat, float(m["sdc_mismatch"]),
                    jinteg.vote(mat, jinteg.digest_leaf_names(jinteg.digest_parts(state, 0)))))
    after = [[np.asarray(s.data) for s in leaf.addressable_shards] for leaf in jax.tree.leaves(state.params)]
    return out, before, after, int(state.step), jinteg.digest_leaf_names(jinteg.digest_parts(state, 0))


def test_flipped_cadence_step_is_the_references(pool):
    ref, before, after, step, names = _reference_step(0, 1)
    mat, mismatch, verdict = ref[0]
    res = pool.get()
    cols = [i for i, n in enumerate(names) if n.startswith("params/")]
    for r in res:
        a = r["A"]
        mine = [i for i, n in enumerate(a["names"]) if n.startswith("params/")]
        assert [a["names"][i] for i in mine] == [names[i] for i in cols]
        # The carried-across state, flipped on rank 2: the same bits, the same digests.
        np.testing.assert_array_equal(a["matrix"][:, mine].astype(np.uint32), mat[:, cols])
        assert a["mismatch"] == mismatch == 1.0
        assert _equal(a["after"]["params"], a["before"]["params"])  # every rank keeps its own input
        assert a["before"]["step"] == 0 and a["after"]["step"] == 1 == step
        assert tinteg.vote(a["matrix"], a["names"]).corrupt == verdict.corrupt == (2,)
    # The reference keeps every device's own buffer too.
    for b_leaf, a_leaf in zip(before, after):
        for x, y in zip(b_leaf, a_leaf):
            np.testing.assert_array_equal(x, y)


def test_mismatch_after_an_update_discards_it_as_the_references(pool):
    ref, _, _, step, _ = _reference_step(2, 3)
    for r in pool.get():
        b = r["B"]
        assert b["flags"] == [0.0, 0.0, 1.0] and [m for _, m, _ in ref] == [0.0, 0.0, 1.0]
        assert tinteg.vote(b["matrix"], b["names"]).corrupt == ref[2][2].corrupt == (2,)
        assert _equal(b["after"]["params"], b["before"]["params"])
        assert b["after"]["opt"].keys() == b["before"]["opt"].keys()
        assert all(torch.equal(b["after"]["opt"][k], b["before"]["opt"][k]) for k in b["before"]["opt"])
        assert b["before"]["count"] == b["after"]["count"] == 2  # the schedule's count did not advance
        assert (b["before"]["step"], b["after"]["step"]) == (2, 3) and step == 3


@pytest.mark.parametrize("zero", [0, 1], ids=["dp", "zero1"])
def test_armed_clean_run_is_the_unarmed_run(pool, zero):
    for r in pool.get():
        plain, armed = r[f"C{zero}"]
        assert armed["losses"] == plain["losses"]
        assert _equal(armed["params"], plain["params"])
        assert armed["opt"].keys() == plain["opt"].keys()
        assert all(torch.equal(armed["opt"][k], plain["opt"][k]) for k in plain["opt"])
        assert armed["step"] == plain["step"] == 4


def test_zero1_mismatch_keeps_each_ranks_own_parameters(pool):
    res = pool.get()
    for rank, r in enumerate(res):
        d = r["D"]
        assert d["mismatch"] == 1.0
        assert tinteg.vote(d["matrix"]).corrupt == (2,)
        # Every rank's flat, its own shard and the others', is its input.
        assert torch.equal(d["after"]["flat"], d["before"]["flat"]), rank
        assert _equal(d["after"]["params"], d["before"]["params"])
    clean = [r["D"]["before"]["flat"] for r in res]
    assert torch.equal(clean[0], clean[1]) and not torch.equal(clean[0], clean[2])
    assert torch.equal(res[0]["D"]["after"]["flat"], clean[0])  # rank 2's flipped shard did not spread
