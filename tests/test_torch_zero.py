"""The port's ZeRO sharded update (``parallel.zero``) and low-bit moments
(``ops.quant``) against the JAX package's, on the CPU.

- Layout: the flat vector, the bucket plan (padding included) and each
  rank's shard equal the reference's element for element (exact: the same
  f32 values are only moved).
- Training: ZeRO-1/2/3 over 3 AdamW steps of a tiny GPT-2 on 2 gloo ranks
  equal the reference's ``zero_state`` + ``make_train_step(zero=level)`` on
  2 of its 8 fake CPU devices (parameters and each rank's moment shards),
  with accumulation and a binding clip on levels 2 and 3; and equal the
  port's plain DP on the same ranks.  Tolerances are stated at each check.
- ZeRO-3: shard -> gather is the identity; the state a rank keeps falls
  with the world size.  The functional bucketed reduce-scatter and gather
  give the mean; ``flat_chunk_sumsq`` is the reference's.
- Quantizers: bit-equal to the reference's given its own random draws; the
  low-bit convergence and compressed-bytes checks of ``test_zero23.py``.
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
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import (  # noqa: E402
    from_jax_params,
    jax_leaf_pieces,
    ref_view,
    to_jax_params,
)
from distributeddataparallel_tpu_torch.models.simple_cnn import TinyMLP  # noqa: E402
from distributeddataparallel_tpu_torch.ops import quant as tquant  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import data_parallel as tdp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import zero as tzero  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
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
    from distributeddataparallel_tpu.ops import accuracy, lm_cross_entropy
    from distributeddataparallel_tpu.ops import quant
    from distributeddataparallel_tpu.parallel import data_parallel, zero

    return SimpleNamespace(jax=jax, jnp=jnp, ddp=ddp, jdpp=jdpp, shard_batch=shard_batch, jtfm=jtfm,
                           accuracy=accuracy, lm_ce=lm_cross_entropy, quant=quant, zero=zero,
                           dp=data_parallel)


GPT2 = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=128, max_seq_len=16)
LLAMA = dict(vocab_size=64, num_layers=2, num_heads=4, num_kv_heads=1, d_model=64, d_ff=128,
             max_seq_len=16)
FLAGS = ["--optimizer", "adamw", "--lr", "1e-2", "--weight-decay", "0.1", "--lr-schedule", "cosine",
         "--warmup-steps", "1", "--min-lr", "1e-3"]
BUCKET = 4096  # bytes: several buckets at this size, big leaves alone
WORLD, STEPS = 2, 3
# (level, accum_steps, grad_clip): the clip (0.5) binds at these weights.
CASES = [(1, 1, None), (2, 2, 0.5), (3, 2, 0.5)]


def _jax_init(family, kw):
    """The reference model and the port's seeded initial weights in the
    reference's tree (no flax init to compile)."""
    jtfm = ref().jtfm
    jmodel = jtfm.TransformerLM(getattr(jtfm, family)(attn_impl="xla", **kw))
    cfg = getattr(ttfm, family)(**kw)
    tmodel = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    return jmodel, to_jax_params(tmodel.state_dict(), cfg)


def _ref_leaves(tmodel):
    """The port's parameters as the reference's leaves (copies)."""
    out = []
    for _, pieces in jax_leaf_pieces(tmodel):
        flat = [ref_view(p.detach(), kind).reshape(shape) for p, kind, shape in pieces]
        out.append(flat[0] if len(flat) == 1 else torch.stack(flat))
    return out


@pytest.mark.parametrize("family,kw,shards", [("gpt2_124m", GPT2, 2), ("llama3_8b", LLAMA, 4)],
                         ids=["gpt2-2", "llama-scan-4"])
def test_layout_matches_jax(family, kw, shards):
    """flatten_f32 / unflatten / bucket_plan, and every rank's shard of the
    layout, are the reference's exactly (the same f32 values, moved)."""
    jax, jnp, jzero = ref().jax, ref().jnp, ref().zero
    _, params = _jax_init(family, kw)
    tmodel = ttfm.TransformerLM(getattr(ttfm, family)(**kw))
    tmodel.load_state_dict(from_jax_params(params, tmodel.cfg))
    jl, tl = jax.tree.leaves(params), _ref_leaves(tmodel)
    padded, chunk = jzero.flat_size(params, shards)
    assert tzero.flat_size(tl, shards) == (padded, chunk)
    flat = tzero.flatten_f32(tl, padded)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jzero.flatten_f32(params, padded)))
    for a, b in zip(tzero.unflatten(flat, tl), jax.tree.leaves(jzero.unflatten(jnp.asarray(flat.numpy()), params))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jplan, tplan = jzero.bucket_plan(params, shards, BUCKET), tzero.bucket_plan(tl, shards, BUCKET)
    assert (tplan.buckets, tplan.padded, tplan.sub, tplan.local) == \
        (jplan.buckets, jplan.padded, jplan.sub, jplan.local)
    assert tplan.n_buckets > 3
    # The clip's sum of squares over one chunk, leaves held twice weighted
    # 1/2: the reference's, up to f32 summation order (rtol 1e-6).
    sizes = [leaf.size for leaf in jl]
    dups = [2 if i % 3 == 0 else 1 for i in range(len(jl))]
    want = ref().dp.flat_chunk_sumsq(jnp.asarray(flat[chunk:2 * chunk].numpy()), chunk, sizes, dups)
    got = tdp.flat_chunk_sumsq(flat[chunk : 2 * chunk], chunk, sizes, dups)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for level, plan in ((1, tzero.flat_plan(tl, shards)), (2, tplan)):
        for r in range(shards):
            model = ttfm.TransformerLM(tmodel.cfg)
            model.load_state_dict(from_jax_params(params, tmodel.cfg))
            layout = tzero.ZeroLayout(model, level, rank=r, world=shards, bucket_bytes=BUCKET)
            want = flat[r * chunk : (r + 1) * chunk] if level == 1 else \
                tzero.shard_params_bucketed(tl, plan, r)
            got = torch.cat([sp.detach() for sp in layout.shard_params])
            np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_flatten_cast_modes():
    f32 = [torch.ones(3), torch.zeros(2, 2)]
    bf16 = [t.bfloat16() for t in f32]
    assert tzero.flatten_f32(bf16, 8).dtype == torch.float32
    assert tzero.flatten_f32(bf16, 8, cast="preserve").dtype == torch.bfloat16
    with pytest.raises(TypeError, match="mix"):
        tzero.flatten_f32([f32[0], bf16[1]], 8, cast="preserve")
    with pytest.raises(TypeError, match="non-f32"):
        tzero.flatten_f32(bf16, 8, cast="strict")
    with pytest.raises(ValueError, match="unknown cast"):
        tzero.flatten_f32(f32, 8, cast="bf16")


# ------------------------------------------------ 2 gloo ranks vs 2 devices --

def _train(payload, level, accum, clip, rank, world):
    model = ttfm.TransformerLM(ttfm.gpt2_124m(**GPT2))
    model.load_state_dict(payload["sd"])
    args = tdpp.parse_args(["--device", "cpu", *FLAGS])
    bb = BUCKET if level >= 2 else None
    if level:
        state = tzero.zero_state(model, lambda ps: build_optimizer(args, ps, STEPS), level=level,
                                 bucket_bytes=bb)
    else:
        state = TrainState(model, *build_optimizer(args, model.parameters(), STEPS))
    step = make_train_step(tdpp._loss_fn, accum_steps=accum, grad_clip=clip, zero=level, bucket_bytes=bb)
    rows = payload["batches"][0].shape[0] // world
    losses = [float(step(state, {"tokens": torch.from_numpy(b[rank * rows : (rank + 1) * rows]).long()})["loss"])
              for b in payload["batches"]]
    with state.full_params():
        params = {k: v.detach().clone() for k, v in model.named_parameters()}
    out = {"losses": losses, "params": params}
    if level:
        sp = state.zero.shard_params
        out["mu"] = torch.cat([state.optimizer.state[p]["exp_avg"] for p in sp])
        out["nu"] = torch.cat([state.optimizer.state[p]["exp_avg_sq"] for p in sp])
        if level == 3:  # between steps the model holds no parameter
            out["released"] = all(p.numel() == 0 for p in model.parameters())
            out["roundtrip"] = [torch.equal(a, b) for a, b in zip(
                tzero.zero3_gather_params(state).values(), params.values())]
    return out


def _scatter_gather(rank, world):
    """The functional bucketed reduce-scatter and all-gather on seeded
    leaves (rank r's leaves from seed r): the gathered mean, and the mean
    computed here from every rank's leaves."""
    def leaves(r):
        g = torch.Generator().manual_seed(r)
        return [torch.randn(s, generator=g) for s in ((33, 7), (5,), (300, 4), (2, 2, 3))]

    mine = leaves(rank)
    plan = tzero.bucket_plan(mine, world, 256)
    shard = tzero.scatter_grads_bucketed(mine, plan, world)
    got = tzero.gather_params_bucketed(shard, mine, plan)
    want = [sum(ls) / world for ls in zip(*(leaves(r) for r in range(world)))]
    return got, want, plan.n_buckets


def _worker(rank, world, coordinator, out_dir, payload):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {case: _train(payload, *case, rank, world) for case in CASES}
        res["bucketed"] = _scatter_gather(rank, world)
        res["plain"] = {case[1:]: _train(payload, 0, *case[1:], rank, world) for case in CASES}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def setup():
    jmodel, params = _jax_init("gpt2_124m", GPT2)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 64, size=(8, 17)).astype(np.int32) for _ in range(STEPS)]
    return jmodel, params, batches


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every training case, run once on 2 gloo processes: each rank's
    results."""
    import torch.multiprocessing as mp

    _, params, batches = setup
    payload = {"sd": from_jax_params(params, ttfm.gpt2_124m(**GPT2)), "batches": batches}
    out = tmp_path_factory.mktemp("zero_ranks")
    mp.spawn(_worker, args=(WORLD, f"127.0.0.1:{rt.free_port()}", str(out), payload), nprocs=WORLD,
             join=True)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_run(setup, level, accum, clip):
    jax, ddp, jdpp, jzero = ref().jax, ref().ddp, ref().jdpp, ref().zero
    j_lm_ce, j_accuracy, shard_batch = ref().lm_ce, ref().accuracy, ref().shard_batch
    jmodel, params, batches = setup

    def jloss(p, batch, rng):
        toks = batch["tokens"]
        logits = jmodel.apply({"params": p}, toks[:, :-1])
        return j_lm_ce(logits, toks[:, 1:]), {"accuracy": j_accuracy(logits, toks[:, 1:])}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:WORLD])
    tx = jdpp.build_optimizer(jdpp.parse_args(["--device", "cpu", *FLAGS]), total_steps=STEPS)
    bb = BUCKET if level >= 2 else None
    state = ddp.zero_state(apply_fn=jmodel.apply, params=ddp.broadcast_params(params, mesh), tx=tx,
                           mesh=mesh, level=level, bucket_bytes=bb)
    step = ddp.make_train_step(jloss, mesh=mesh, zero=level, accum_steps=accum, grad_clip=clip,
                               bucket_bytes=bb, donate=False)
    losses = []
    for b in batches:
        state, m = step(state, shard_batch({"tokens": b}, mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    final = jzero.zero3_gather_params(state, mesh) if level == 3 else state.params
    adam = [s for s in jax.tree.leaves(state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
            if hasattr(s, "mu")][0]
    return losses, final, np.asarray(adam.mu), np.asarray(adam.nu)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"zero{c[0]}-accum{c[1]}-clip{c[2]}")
def test_zero_training_matches_jax_and_plain_dp(setup, ranks, case):
    """Tolerances: against the reference, f32 with other summation orders
    (XLA's and torch's matmuls) over three AdamW updates: atol 2e-5 / rtol
    1e-4 on losses, parameters and first moments; the second moments, sums
    of squared gradients near 1e-6, within rtol 2e-3 + atol 1e-9.  Against
    the port's plain DP on the same ranks: the same elementwise update on
    the same reduced gradients, so equal up to the clip's norm, whose f32
    sum runs over the shards instead of the leaves (an ulp of the scale):
    losses within 1e-6; parameters within atol 1e-5 / rtol 1e-5, because
    the key projection's bias has a gradient of pure rounding noise
    (attention ignores it) that AdamW normalizes into ~1e-6 steps, so an
    ulp there moves it by ~1e-6."""
    level = case[0]
    losses, final, mu, nu = _jax_run(setup, *case)
    want = from_jax_params(final, ttfm.gpt2_124m(**GPT2))
    tol = dict(atol=2e-5, rtol=1e-4)
    plain = ranks[0]["plain"][case[1:]]
    for r, res in enumerate(ranks):
        got = res[case]
        np.testing.assert_allclose(got["losses"], losses, **tol)
        np.testing.assert_allclose(got["losses"], plain["losses"], atol=1e-6, rtol=1e-6)
        for k, v in got["params"].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **tol)
            np.testing.assert_allclose(v.numpy(), plain["params"][k].numpy(), err_msg=k, atol=1e-5, rtol=1e-5)
            assert torch.equal(v, ranks[0][case]["params"][k])  # replicas in lockstep
        local = got["mu"].numel()
        assert local * WORLD == mu.shape[0]
        np.testing.assert_allclose(got["mu"].numpy(), mu[r * local : (r + 1) * local], **tol)
        np.testing.assert_allclose(got["nu"].numpy(), nu[r * local : (r + 1) * local], rtol=2e-3, atol=1e-9)
        if level == 3:
            assert got["released"] and all(got["roundtrip"])


def test_bucketed_scatter_and_gather_are_the_mean(ranks):
    """scatter_grads_bucketed then gather_params_bucketed give every rank
    the mean of the ranks' leaves, exactly (two f32 values summed once,
    then halved), over several buckets."""
    for res in ranks:
        got, want, n_buckets = res["bucketed"]
        assert n_buckets > 2
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_zero3_state_bytes_fall_with_world_size():
    """What a rank keeps between steps at level 3: its shard of the
    parameters (and so of the moments), 1/N of the total plus at most one
    padding element a bucket."""
    total = sum(p.numel() for p in ttfm.TransformerLM(ttfm.gpt2_124m(**GPT2)).parameters())
    for n in (1, 2, 4):
        m = ttfm.TransformerLM(ttfm.gpt2_124m(**GPT2))
        layout = tzero.ZeroLayout(m, 3, rank=n - 1, world=n, bucket_bytes=BUCKET)
        kept = layout.shard.numel() * layout.shard.element_size()
        assert sum(p.numel() for p in m.parameters()) == 0  # nothing replicated
        assert kept == sum(sp.numel() for sp in layout.shard_params) * 4
        assert total * 4 / n <= kept <= 4 * (total / n + layout.plan.n_buckets)


# ------------------------------------------------------------ quantizers --

def test_quantizers_bit_equal_jax():
    """Given the reference's own draws, the pure quantizers return its
    bits exactly (the same IEEE f32 operations in the same order)."""
    jax, jnp, jquant = ref().jax, ref().jnp, ref().quant
    rng = np.random.default_rng(0)
    n = 3 * tquant.MOMENT_BLOCK + 77
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-25, 5, n))).astype(np.float32)
    x[5], x[9] = 0.0, -0.0
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.bits(key, x.shape, jnp.uint32) & jnp.uint32(0xFFFF)).astype(np.int32)
    want = np.asarray(jquant.stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)
    got = tquant.stochastic_round_bf16_with(torch.from_numpy(x), torch.from_numpy(noise))
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    jm = jquant.quantize_moment_int8(jnp.asarray(x), key)
    u = np.array(jax.random.uniform(key, (tquant.moment_blocks(n), tquant.MOMENT_BLOCK), dtype=jnp.float32))
    tm = tquant.quantize_moment_int8_with(torch.from_numpy(x), torch.from_numpy(u))
    np.testing.assert_array_equal(tm.q.numpy(), np.asarray(jm.q))
    np.testing.assert_array_equal(tm.scale.numpy(), np.asarray(jm.scale))
    np.testing.assert_array_equal(tquant.dequantize_moment(tm).numpy(), np.asarray(jquant.dequantize_moment(jm)))
    np.testing.assert_array_equal(tquant._q8_codebook().numpy(), jquant._q8_codebook())


@functools.cache
def _mlp_run(moment_dtype, steps=50):
    """ZeRO-2 Adam (lr 1e-2) on the reference test's TinyMLP task at one
    rank: the mean loss of the last 10 steps, and the first step's."""
    rng = np.random.default_rng(1)
    batches = [(torch.from_numpy(rng.normal(size=(16, 32, 32, 3)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, size=(16,))).long()) for _ in range(10)]
    model = TinyMLP((32, 32, 3), num_classes=10, generator=torch.Generator().manual_seed(0))
    state = tzero.zero_state(model, lambda ps: (torch.optim.Adam(ps, lr=1e-2, eps=1e-8), None), level=2,
                             moment_dtype=moment_dtype)

    def loss_fn(m, batch):
        return torch.nn.functional.cross_entropy(m(batch["image"]), batch["label"]), {}

    step = make_train_step(loss_fn, zero=2)
    losses = [float(step(state, {"image": x, "label": y})["loss"]) for x, y in
              (batches[i % 10] for i in range(steps))]
    return losses, state


@pytest.mark.parametrize("moment_dtype", ["bf16", "int8"])
def test_low_bit_moments_convergence(moment_dtype):
    """Stochastically rounded low-bit moments track f32 training (the
    reference's check): both runs fit the batches (last loss under a tenth
    of the first) and end within 10% of each other, or 0.01 near zero."""
    ref, _ = _mlp_run(None)
    low, _ = _mlp_run(moment_dtype)
    assert ref[-1] < 0.1 * ref[0] and low[-1] < 0.1 * low[0]
    assert abs(low[-1] - ref[-1]) <= max(0.1 * ref[-1], 0.01)


def test_low_bit_moments_state_is_compressed():
    """bf16 halves the compressed moments' bytes exactly and int8 about
    quarters them (int8 codes padded to whole blocks, an f32 scale a
    block); step counters and vectors under ``min_size`` stay f32."""
    f32 = _mlp_run(None, steps=1)[1]
    big = sum(v.numel() * 4 for s in f32.optimizer.state.values() for k, v in s.items()
              if k != "step" and v.numel() >= 256)
    for md, lo, hi in (("bf16", 0.5, 0.5), ("int8", 0.25, 0.26)):
        nbytes = _mlp_run(md, steps=1)[1].moments.nbytes()
        assert lo * big <= nbytes["packed"] <= hi * big, (md, nbytes, big)
    with pytest.raises(ValueError, match="moment_dtype"):
        tzero.LowBitMoments(f32.optimizer, "fp8")
