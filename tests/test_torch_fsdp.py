"""The port's FSDP (``parallel.fsdp``, ``--fsdp``) against the JAX package's
``parallel/fsdp.py``, on the CPU.

Four gloo ranks are spawned once for the file; every case reads what they
computed, and the JAX side runs on 4 of the conftest's fake CPU devices
while they work, from the port's seeded initial weights and the same
numpy-seeded tokens (``tests/test_fsdp.py``'s setups: a 3-layer tiny LM,
scanned, f32).

- Layout: ``FsdpMeta.flatten_full`` equals the reference's ``_Meta``'s
  exactly (the same f32 values, moved) at 4 data ranks and at 2 data x 2
  model ranks, ``unflatten_full`` inverts it, and each rank's shard is its
  slice of the reference's global flats; between steps a rank holds 1/N of
  the flats (residency).
- Training: 3 AdamW steps (remat off and on), one SGD step under
  ``accum_steps=2`` against one big batch, and FSDP x TP (2 x 2), against
  the reference's ``make_fsdp_train_step`` on the same mesh: losses within
  1e-5 and parameters within 1e-4 (f32 both; the reduce-scatter sums four
  ranks in another order, and AdamW's rsqrt amplifies those last bits, as
  ``tests/test_fsdp.py`` allows 1e-4 against one device).
- The host gather equals the device gather bit for bit; streaming eval
  equals the direct masked eval of the whole model (rel 1e-5, padded rows
  excluded); the bf16 gather's loss is within 2e-2 relative of the f32
  gather's (the reference's bound) and within 1e-3 of the reference's bf16
  loss (both round the same weights to bf16; the products' order differs).
- Checkpoints: an FSDP save resumes at the same mesh bitwise, its payload's
  model loads into a plain model, and a plain checkpoint into an FSDP run
  (the optimizer state moved between the flats and the parameters).
- The guards and the CLI's refusals carry the reference's messages; the
  entry point's ``--fsdp --tp 2 --eval --generate`` runs on the gloo ranks.
"""

import dataclasses
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
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import fsdp as tfsdp  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.checkpoint import CheckpointFiles, host_payload  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture


@functools.cache
def ref():
    """The JAX side, imported here and not at the top: the gloo ranks
    import this module and need torch only."""
    import jax
    import jax.numpy as jnp

    import distributeddataparallel_tpu as ddp
    import dpp as jdpp  # the reference entry point
    from distributeddataparallel_tpu.data.loader import shard_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.parallel import fsdp as jfsdp

    return SimpleNamespace(jax=jax, jnp=jnp, ddp=ddp, jdpp=jdpp, shard_batch=shard_batch, jtfm=jtfm,
                           jfsdp=jfsdp)


WORLD, STEPS = 4, 3
CFG = dict(vocab_size=64, num_layers=3, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, scan_layers=True)
TP_CFG = dict(CFG, num_heads=4, num_kv_heads=2)
FLAGS = ["--optimizer", "adamw", "--lr", "1e-2", "--weight-decay", "0.1", "--lr-schedule", "cosine",
         "--warmup-steps", "1", "--min-lr", "1e-3"]
SGD = ["--optimizer", "sgd", "--lr", "0.1"]
LOSS_ATOL, PARAM_ATOL = 1e-5, 1e-4
VALID = np.array([1] * 13 + [0] * 3, np.float32)
CLI = ["--device", "cpu", "--model", "llama", "--layers", "2", "--d-model", "128", "--seq-len", "16",
       "--vocab-size", "64", "--num-examples", "32", "--batch-size", "2", "--epochs", "1",
       "--steps-per-epoch", "2", "--eval", "--optimizer", "adamw", "--lr", "1e-2", "--tp", "2"]


def tokens(seed: int, rows: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 64, size=(rows, 17)).astype(np.int64)


def init_sd(kw: dict) -> dict:
    model = ttfm.TransformerLM(ttfm.tiny_lm(**kw), generator=torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def opt(flags, steps=STEPS):
    args = tdpp.parse_args(["--device", "cpu", *flags])
    return lambda params: build_optimizer(args, params, steps)


# ------------------------------------------------------------- rank side --

def _rows(batch: np.ndarray, d: int, n: int) -> dict:
    k = batch.shape[0] // n
    return {"tokens": torch.from_numpy(batch[d * k : (d + 1) * k])}


def fsdp_run(kw, flags, batches, *, tp=1, accum=1, gather_dtype=None) -> dict:
    """Steps of ``make_fsdp_train_step`` over a fresh mesh: losses, this
    rank's initial and final shards, the host-gathered whole model."""
    mesh = rt.make_mesh(("data", "model"), (WORLD // tp, tp)) if tp > 1 else rt.make_mesh(("data",))
    tp_axis = "model" if tp > 1 else None
    cfg = ttfm.tiny_lm(**kw, tp_axis=tp_axis)
    group = rt.axis_group("data")
    state = tfsdp.fsdp_state(cfg, init_sd(kw), opt(flags, len(batches)), group=group, tp_axis=tp_axis,
                             gather_dtype=gather_dtype)
    shards0 = (state.fsdp.layers.clone(), state.fsdp.rest_shard.detach().clone())
    step = tfsdp.make_fsdp_train_step(tdpp._loss_fn, accum_steps=accum, tp_axis=tp_axis)
    d, n = mesh.index("data"), mesh.size("data")
    losses = [float(step(state, _rows(b, d, n))["loss"]) for b in batches]
    return {"losses": losses, "shards0": shards0, "coords": dict(mesh.coords), "state": state,
            "params": tfsdp.fsdp_gather_params(state.fsdp, host=True)}


def checkpoints(directory: str) -> dict:
    """FSDP: 2 AdamW steps, save, a third; a fresh state loads the save and
    takes the third again.  Plain DP: 2 steps and a save, which a fresh
    FSDP state loads and continues; an FSDP save loaded into a plain state."""
    rt.make_mesh(("data",))
    batches = [tokens(40 + i) for i in range(3)]
    r, files = rt.get_rank(), CheckpointFiles(directory)
    rows = [_rows(b, r, WORLD) for b in batches]

    def fsdp_state():
        return tfsdp.fsdp_state(ttfm.tiny_lm(**CFG), init_sd(CFG), opt(FLAGS))

    def plain_state():
        model = ttfm.TransformerLM(ttfm.tiny_lm(**CFG))
        model.load_state_dict(init_sd(CFG))
        return TrainState(model, *opt(FLAGS)(list(model.parameters())))

    def save(state, epoch):
        payload = host_payload(state, epoch)
        if r == 0:
            files.write(state, epoch, payload)
        rt.barrier()

    fstep, pstep = tfsdp.make_fsdp_train_step(tdpp._loss_fn), make_train_step(tdpp._loss_fn)
    out = {}
    a = fsdp_state()
    out["fsdp_straight"] = [float(fstep(a, b)["loss"]) for b in rows]
    b = fsdp_state()
    for x in rows[:2]:
        fstep(b, x)
    save(b, 0)
    c = fsdp_state()
    files.load_into(c, files.read(0))
    out["fsdp_resumed"] = float(fstep(c, rows[2])["loss"])
    out["fsdp_resumed_shards"] = torch.equal(c.fsdp.layers, a.fsdp.layers)
    p = plain_state()
    files.load_into(p, files.read(0))  # the FSDP save into a plain run
    out["plain_from_fsdp"] = float(pstep(p, rows[2])["loss"])
    q = plain_state()
    out["plain_straight"] = [float(pstep(q, x)["loss"]) for x in rows[:2]]
    save(q, 1)
    out["plain_straight"].append(float(pstep(q, rows[2])["loss"]))
    f = fsdp_state()
    files.load_into(f, files.read(1))  # a plain save into an FSDP run
    out["fsdp_from_plain"] = float(fstep(f, rows[2])["loss"])
    out["payload_model"] = files.read(0)["model"] if r == 0 else None
    return out


def cli_run(rank, world) -> dict:
    """The entry point's trainer and loop, as ``dpp.run`` drives them on
    each rank: ``--fsdp --tp 2 --eval --generate 4``, and ``--tp 2`` alone."""
    out = {}
    for name, extra in (("fsdp_tp", ["--fsdp", "--generate", "4"]), ("tp", [])):
        args = tdpp.parse_args(CLI + extra)
        cpu = torch.device("cpu")
        out[name] = tdpp.train(args, tdpp.build_trainer(args, cpu, rank, world), cpu, rank, world)
    return out


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    res = {}
    try:
        train_batches = [tokens(10 + i) for i in range(STEPS)]
        for remat in (False, True):
            run = fsdp_run(dict(CFG, remat=remat), FLAGS, train_batches)
            st = run.pop("state")
            if not remat:
                sizes = [p.numel() for p in st.model.parameters()]
                run["resident"] = (sum(sizes), max(sizes), st.fsdp.meta.total)
                run["device_gather"] = tfsdp.fsdp_gather_params(st.fsdp, host=False)
                mask = torch.from_numpy(VALID[rank * 4 : (rank + 1) * 4])
                ev = tfsdp.make_fsdp_eval_step()(st.model, {**_rows(tokens(3), rank, world), "valid": mask})
                run["eval"] = ({k: float(v) for k, v in ev[0].items()}, float(ev[1]))
            res[f"adamw_remat{int(remat)}"] = run
        for accum in (1, 2):
            res[f"accum{accum}"] = fsdp_run(CFG, SGD, [tokens(5)], accum=accum)
            res[f"accum{accum}"].pop("state")
        res["tp"] = fsdp_run(TP_CFG, FLAGS, train_batches, tp=2)
        res["tp"].pop("state")
        for name, dt in (("f32", None), ("bf16", torch.bfloat16)):
            res[f"gather_{name}"] = fsdp_run(CFG, SGD, [tokens(11, 8)], gather_dtype=dt)
            res[f"gather_{name}"].pop("state")
        res["ckpt"] = checkpoints(str(Path(out_dir) / "ckpt"))
        res["cli"] = cli_run(rank, world)
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


class Ranks:
    def __init__(self, out_dir):
        import torch.multiprocessing as mp

        self.out, self._results = Path(out_dir), None
        self._ctx = mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{rt.free_port()}", str(out_dir)),
                             nprocs=WORLD, join=False)

    def get(self) -> list[dict]:
        if self._results is None:
            while not self._ctx.join():
                pass
            self._results = [torch.load(self.out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
        return self._results


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(tmp_path_factory.mktemp("fsdp_ranks"))
    yield r
    r.get()  # no rank outlives the module


# ------------------------------------------------------------- JAX side --

def jax_cfg(kw, **over):
    return ref().jtfm.tiny_lm(**kw, attn_impl="xla", **over)


def jax_tx(flags, steps=STEPS):
    R = ref()
    return R.jdpp.build_optimizer(R.jdpp.parse_args(["--device", "cpu", *flags]), total_steps=steps)


def jax_mesh(tp=1):
    R = ref()
    devices = R.jax.devices()[:WORLD]
    if tp > 1:
        return R.ddp.make_mesh(("data", "model"), shape=(WORLD // tp, tp), devices=devices)
    return R.ddp.make_mesh(("data",), devices=devices)


def jax_fsdp(kw, flags, batches, *, tp=1, accum=1, gather_dtype=None) -> dict:
    """The reference's fsdp_state + make_fsdp_train_step for the same run."""
    R = ref()
    jax, jf = R.jax, R.jfsdp
    tp_axis = "model" if tp > 1 else None
    cfg = jax_cfg(kw, tp_axis=tp_axis)
    mesh = jax_mesh(tp)
    state = jf.fsdp_state(cfg, to_jax_params(init_sd(kw), ttfm.tiny_lm(**kw)), jax_tx(flags, len(batches)), mesh,
                          tp_axis=tp_axis)
    step = jf.make_fsdp_train_step(cfg, mesh=mesh, tp_axis=tp_axis, accum_steps=accum, donate=False,
                                   gather_dtype=gather_dtype)
    losses = []
    for b in batches:
        state, m = step(state, R.shard_batch({"tokens": b.astype(np.int32)}, mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": jax.tree.map(
        np.asarray, jf.fsdp_gather_params(cfg, state, mesh, tp_axis=tp_axis, host=True))}


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's runs, computed while the ranks work."""
    batches = [tokens(10 + i) for i in range(STEPS)]
    out = {f"adamw_remat{int(r)}": jax_fsdp(dict(CFG, remat=r), FLAGS, batches) for r in (False, True)}
    out["accum2"] = jax_fsdp(CFG, SGD, [tokens(5)], accum=2)
    out["tp"] = jax_fsdp(TP_CFG, FLAGS, batches, tp=2)
    out["gather_bf16"] = jax_fsdp(CFG, SGD, [tokens(11, 8)], gather_dtype=ref().jnp.bfloat16)
    return out


def check_run(got: dict, want: dict, kw: dict, what: str) -> None:
    jax = ref().jax
    np.testing.assert_allclose(got["losses"], want["losses"], atol=LOSS_ATOL, rtol=0, err_msg=what)
    tree = to_jax_params(got["params"], ttfm.tiny_lm(**kw))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(tree)[0], jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------- tests --

def test_flat_layout_and_shards_match_reference(ranks):
    """flatten_full / unflatten_full at 4 data ranks and at 2 x 2 data x
    model are the reference's exactly; each rank's initial shard is its
    slice of them; a rank keeps 1/4 of the flats between steps."""
    jf = ref().jfsdp
    for kw, n, tp, run in ((CFG, 4, 1, "adamw_remat0"), (TP_CFG, 2, 2, "tp")):
        sd = init_sd(kw)
        tp_axis = "model" if tp > 1 else None
        meta = tfsdp.FsdpMeta(ttfm.tiny_lm(**kw, tp_axis=tp_axis), n, tp_axis, tp)
        jmeta = jf._Meta(jax_cfg(kw, tp_axis=tp_axis), n, tp_axis, tp)
        flat = meta.flatten_full(sd)
        jflat = jmeta.flatten_full(to_jax_params(sd, ttfm.tiny_lm(**kw)))
        for k in ("layers", "rest"):
            np.testing.assert_array_equal(flat[k].numpy(), jflat[k], err_msg=k)
        back = meta.unflatten_full(flat)
        assert all(torch.equal(back[k], v) for k, v in sd.items())
        c, rc, w = meta.layer_chunk, meta.rest_chunk, meta.layer.padded
        for r in ranks.get():
            d, j = r[run]["coords"]["data"], r[run]["coords"].get("model", 0)
            layers, rest = r[run]["shards0"]
            np.testing.assert_array_equal(layers.numpy(), jflat["layers"][:, j * w + d * c : j * w + (d + 1) * c])
            np.testing.assert_array_equal(rest.numpy(), jflat["rest"][j * meta.rest.padded + d * rc:][:rc])
    for r in ranks.get():
        total_shard, largest, whole = r["adamw_remat0"]["resident"]
        assert total_shard * 4 <= whole + 4 * (CFG["num_layers"] + 1) and largest < whole / 4


@pytest.mark.parametrize("remat", [0, 1], ids=["plain", "remat"])
def test_adamw_steps_match_reference(ranks, want, remat):
    name = f"adamw_remat{remat}"
    for r in ranks.get():
        np.testing.assert_allclose(r[name]["losses"], want[name]["losses"], atol=LOSS_ATOL, rtol=0)
    check_run(ranks.get()[0][name], want[name], CFG, name)


def test_accumulation_matches_one_big_batch(ranks, want):
    """2 microbatches accumulated in the shards == the one-batch step (the
    same f32 sums regrouped: within 1e-6), and == the reference's."""
    r0 = ranks.get()[0]
    assert r0["accum2"]["losses"][0] == pytest.approx(r0["accum1"]["losses"][0], rel=1e-6)
    for k, v in r0["accum1"]["params"].items():
        np.testing.assert_allclose(r0["accum2"]["params"][k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
    check_run(r0["accum2"], want["accum2"], CFG, "accum2")


def test_guards_carry_the_reference_messages():
    """The reference's guards (``fsdp.py:76-92``, ``:115-121``) and its CLI
    refusals (``dpp.py:620-651``, ``:709-713``, ``:795-840``), message for
    message."""
    R = ref()
    for over, match in ((dict(scan_layers=False), "scan_layers"), (dict(cp_axis="seq"), "TP only"),
                        (dict(dropout_rate=0.1), "dropout"), (dict(tp_axis="model"), "BOTH")):
        for make in (lambda c: tfsdp.FsdpMeta(ttfm.tiny_lm(**c), 4),
                     lambda c: R.jfsdp._Meta(jax_cfg(c), 4)):
            with pytest.raises(ValueError, match=match):
                make({**CFG, **over})
    base = ["--device", "cpu", "--model", "llama", "--fsdp"]
    for extra, match in ((["--zero"], "composes with --tp only; drop --zero"),
                         (["--cp", "2", "--seq-len", "16"], "drop --cp"),
                         (["--bucket-mb", "1"], "drop --bucket-mb"),
                         (["--dropout", "0.1"], "--fsdp and --pp do not support it"),
                         (["--nan-guard"], "drop --fsdp/--pp"),
                         (["--overlap"], "--overlap applies to the DP all-reduce; drop --fsdp"),
                         (["--grad-compress", "bf16"], "drop --zero/--fsdp/--pp")):
        with pytest.raises(SystemExit, match=match):
            R.jdpp.validate_args(R.jdpp.parse_args(base + extra))
        with pytest.raises(SystemExit, match=match):
            tdpp.parse_args(base + extra)
    with pytest.raises(SystemExit, match="--fsdp requires an LM model"):
        tdpp.parse_args(["--device", "cpu", "--model", "cnn", "--fsdp"])
    assert tdpp.build_config(tdpp.parse_args(base + ["--model", "gpt2", "--tp", "2", "--generate", "4"])).scan_layers
    with pytest.raises(ValueError, match="owns its reduction"):
        make_train_step(tdpp._loss_fn, fsdp=True, overlap=True)


def test_fsdp_tp_matches_reference(ranks, want):
    """2 data x 2 model ranks: each model position's flats hold its TP
    shard, the gathers ride the data axis: the reference's losses and
    merged parameters."""
    for r in ranks.get():
        np.testing.assert_allclose(r["tp"]["losses"], want["tp"]["losses"], atol=LOSS_ATOL, rtol=0)
    check_run(ranks.get()[0]["tp"], want["tp"], TP_CFG, "tp")


def test_host_gather_equals_device_gather(ranks, want):
    """The host gather (one layer on the device at a time) and the device
    gather give the same whole model on every rank, bit for bit."""
    for r in ranks.get():
        run = r["adamw_remat0"]
        assert set(run["params"]) == set(run["device_gather"])
        for k, v in run["params"].items():
            assert v.device.type == "cpu" and torch.equal(v, run["device_gather"][k]), k
        assert all(torch.equal(v, ranks.get()[0]["adamw_remat0"]["params"][k]) for k, v in run["params"].items())


def test_streaming_eval_matches_direct(ranks):
    """The per-layer-gather eval of the trained shards == the whole trained
    model's masked metrics over the 13 valid rows of 16 (rel 1e-5: the same
    f32 math in another summation order)."""
    from distributeddataparallel_tpu_torch.ops.losses import per_example_accuracy, per_example_cross_entropy

    r0 = ranks.get()[0]["adamw_remat0"]
    model = ttfm.TransformerLM(ttfm.tiny_lm(**CFG))
    model.load_state_dict(r0["params"])
    t = torch.from_numpy(tokens(3))
    with torch.no_grad():
        logits = model(t[:, :-1])
    v = torch.from_numpy(VALID)
    loss = float((per_example_cross_entropy(logits, t[:, 1:]) * v).sum() / v.sum())
    acc = float((per_example_accuracy(logits, t[:, 1:]) * v).sum() / v.sum())
    for r in ranks.get():
        means, count = r["adamw_remat0"]["eval"]
        assert count == 13.0
        assert means["loss"] == pytest.approx(loss, rel=1e-5) and means["accuracy"] == pytest.approx(acc, abs=1e-6)


def test_bf16_gather_tracks_f32_and_reference(ranks, want):
    r0 = ranks.get()[0]
    f32, bf16 = r0["gather_f32"]["losses"][0], r0["gather_bf16"]["losses"][0]
    assert f32 != bf16 and bf16 == pytest.approx(f32, rel=2e-2)
    assert abs(bf16 - want["gather_bf16"]["losses"][0]) <= 1e-3


def test_checkpoint_resumes_and_interchanges_with_plain(ranks):
    """An FSDP save resumes at the same mesh bit for bit; the same save
    loads into a plain run and a plain save into an FSDP run, each
    continuing the other's next loss (within 1e-5: the plain and FSDP
    steps sum the gradients in another order)."""
    for r in ranks.get():
        ck = r["ckpt"]
        assert ck["fsdp_resumed"] == ck["fsdp_straight"][2] and ck["fsdp_resumed_shards"]
        assert abs(ck["plain_from_fsdp"] - ck["fsdp_straight"][2]) <= 1e-5
        assert abs(ck["fsdp_from_plain"] - ck["plain_straight"][2]) <= 1e-5
    model = ttfm.TransformerLM(ttfm.tiny_lm(**CFG))
    model.load_state_dict(ranks.get()[0]["ckpt"]["payload_model"])  # the whole model, plain layout


def test_cli_fsdp_tp_eval_generate(ranks):
    """``--fsdp --tp 2 --eval --generate 4`` through the entry point's
    trainer on 2 x 2 gloo ranks: the layout is named, the losses are the
    ``--tp 2`` run's (bf16 activations: within 2e-3, as the CP/TP tests
    hold them), the streaming eval is finite, and rank 0 decodes 4 tokens
    past each 4-token prompt from the host-gathered model."""
    s0 = ranks.get()[0]["cli"]
    fs, tp = s0["fsdp_tp"], s0["tp"]
    assert fs["layout"] == "fsdp" and tp["layout"] == "replicated"
    np.testing.assert_allclose(fs["losses"], tp["losses"], atol=2e-3, rtol=0)
    assert np.isfinite(fs["eval"]["loss"]) and abs(fs["eval"]["loss"] - tp["eval"]["loss"]) <= 2e-3
    toks = np.asarray(fs["generate"]["tokens"])
    assert toks.shape == (2, 8) and (toks[:, :4] == np.asarray(fs["generate"]["prompt"])).all()
    assert ((0 <= toks) & (toks < 64)).all()
    assert fs["fsdp_collectives"]["gather"] > 0 and fs["fsdp_collectives"]["scatter"] > 0
