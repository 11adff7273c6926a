"""The port's pipeline parallelism (``parallel.pipeline_parallel``: GPipe and
1F1B over a ``pipe`` axis) against the JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file; every case reads what they
computed.  Each case mirrors the reference test of the same name in
``tests/test_pipeline_parallel.py``: ``tiny_lm`` with scanned layers (4
layers, d_model 32; ``llama_style`` is its RoPE / RMSNorm / SwiGLU default,
``gpt2_style`` LayerNorm / GELU / learned positions / biases), the same
optimizer, numpy-seeded token batches and the port's seeded weights, which
``to_jax_params`` carries to the reference.  Every microbatch count is
larger than the stage count.  The oracles are the reference's
single-device step (``jax.value_and_grad`` and optax on the whole batch)
and its ``make_pp_train_step`` on its fake CPU devices at the same mesh,
schedule and microbatch count.

- DP x PP, both families, GPipe and 1F1B (llama_style data 2 x pipe 4 at
  M = 8; gpt2_style data 4 x pipe 2 at M = 4), 3 SGD steps: losses and
  parameters; and the port's 1F1B against its GPipe (losses, first-step
  gradients).
- PP x TP (data 2 x pipe 2 x model 2, 1F1B) against one device.
- PP x EP (data 2 x pipe 2 x expert 2): top-2 token choice at capacity E (no
  drop), the aux loss at weight 0.01 through both schedules, against the
  reference's 1F1B step with the same aux weight on data 2 x pipe 2.
- ZeRO-1 under PP with ``grad_clip`` 0.5 (binding), both schedules, two
  Adam steps: against plain PP with the clip and the single-device steps
  under ``optax.clip_by_global_norm``.
- Pipelined eval against the unsharded masked eval, 3 rows a replica at
  M = 2 (the tail padded), and the sequence-length guard.
- The counters: ``pp_bubble_fraction`` against the reference's over a grid
  of (n, M, v, schedule), and the 1F1B step's ``pp_phase_counts`` against
  the reference step's.  The stage inputs 1F1B holds: at most n - s
  microbatches on stage s at M = 4, 8 and 16 (GPipe: M).
- Each stage's shard (``from_jax_params(pp_rank=, tp_rank=)``) against the
  reference's device slice under ``pp_param_specs``.

Tolerances (the reference's own PP tests' bounds): f32 throughout, so the
two sides differ by summation order only: losses within 1e-5 relative,
parameters (and gradients) within 2e-5.  ZeRO against plain PP: 2e-6, the
same gradients reduced in another order.  A missing pipe sum leaves the
embedding's update at a stage's share, a doubled one doubles it, and a wrong
stage slice moves every layer's: each is far beyond these bounds.
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

from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.parallel import pipeline_parallel as tpp  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.expert_parallel import shard_model_axes  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.expert_parallel import merge_ep_shards  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import merge_tp_shards  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.zero import zero_state  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

SMALL = dict(num_layers=4, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, scan_layers=True)
GPT2_STYLE = dict(norm="layernorm", activation="gelu", positional="learned", use_bias=True)
# name -> (mesh axes, shape, config overrides, optimizer, lr, token seed, batch shape, steps, extra)
CASES = {
    "llama_n4": (("data", "pipe"), (2, 4), {}, "sgd", 0.1, 0, (16, 17), 3, dict(M=8)),
    "gpt2_n2": (("data", "pipe"), (4, 2), GPT2_STYLE, "sgd", 0.1, 1, (16, 17), 3, dict(M=4)),
    "pp_tp": (("data", "pipe", "model"), (2, 2, 2), dict(num_heads=4, num_kv_heads=2), "sgd", 0.1, 3, (8, 17),
              3, dict(M=4, schedules=("1f1b",))),
    "pp_ep": (("data", "pipe", "expert"), (2, 2, 2), dict(moe_experts=4, moe_top_k=2, moe_capacity_factor=4.0),
              "sgd", 0.1, 8, (8, 17), 2, dict(M=4, aux=0.01)),
    "pp_zero": (("data", "pipe"), (2, 4), {}, "adam", 1e-2, 21, (16, 17), 2, dict(M=8, clip=0.5)),
}
SCHEDULES = ("gpipe", "1f1b")
LOSS_REL, PARAM_ATOL, ZERO_ATOL = 1e-5, 2e-5, 2e-6
# Adam's eps on both sides, as test_torch_expert_parallel.py sets it: at
# optax's 1e-8 an f32 rounding difference in a near-zero gradient element
# moves that element's first step by a visible share of lr.
ADAM_EPS = 1e-4
EVAL_ROWS, EVAL_M = 6, 2
HELD_M = (4, 8, 16)


@functools.cache
def ref():
    """The JAX side, imported here: the gloo ranks need torch only."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import PartitionSpec as P

    import distributeddataparallel_tpu as ddp
    from distributeddataparallel_tpu.data.loader import shard_batch
    from distributeddataparallel_tpu.models import transformer as jtfm
    from distributeddataparallel_tpu.ops import lm_cross_entropy
    from distributeddataparallel_tpu.parallel import pipeline_parallel as jpp

    return SimpleNamespace(jax=jax, jnp=jnp, optax=optax, P=P, ddp=ddp, shard_batch=shard_batch, jtfm=jtfm,
                           lm_ce=lm_cross_entropy, jpp=jpp)


def case_cfg(name, **kw):
    return ttfm.tiny_lm(**{**SMALL, **CASES[name][2], **kw})


def case_tokens(name):
    *_, seed, shape, steps, _ = CASES[name]
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=shape).astype(np.int64) for _ in range(steps)]


def schedules_of(name):
    return CASES[name][8].get("schedules", SCHEDULES)


def seeded_state_dict(cfg) -> dict:
    """The whole model's port-seeded weights (no mesh axes)."""
    cfg = dataclasses.replace(cfg, ep_axis=None, tp_axis=None)
    return ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).state_dict()


# ------------------------------------------------------------- rank side --

def _optimizer(kind, lr, params):
    return torch.optim.Adam(params, lr=lr, eps=ADAM_EPS) if kind == "adam" else torch.optim.SGD(params, lr=lr)


def _stage(cfg):
    return tpp.stage_model(cfg, shard_model_axes(seeded_state_dict(cfg), cfg.tp_axis, cfg.ep_axis),
                           rt.axis_index("pipe"), rt.axis_size("pipe"))


def run_case(name, schedule, zero=False) -> dict:
    """The case's steps on this rank: losses, this stage's parameters, the
    first step's gradients, the 1F1B unit counts, its mesh coordinates."""
    axes, shape, _, opt, lr, _, _, _, extra = CASES[name]
    mesh = rt.make_mesh(axes, shape)
    cfg = case_cfg(name, tp_axis="model" if "model" in axes else None,
                   ep_axis="expert" if "expert" in axes else None)
    model = _stage(cfg)
    if zero:
        state = zero_state(model, lambda shards: (_optimizer(opt, lr, shards), None), level=1,
                           group=rt.axis_group("data"), pp_axis="pipe")
    else:
        state = TrainState(model, _optimizer(opt, lr, model.parameters()))
    step = tpp.make_pp_train_step(cfg, microbatches=extra["M"], schedule=schedule, zero=zero,
                                  grad_clip=extra.get("clip"), moe_aux_weight=extra.get("aux", 0.0))
    d, n_data = mesh.index("data"), mesh.size("data")
    losses, grads, counts = [], None, None
    for tokens in case_tokens(name):
        m = step(state, {"tokens": torch.from_numpy(tokens).chunk(n_data)[d]})
        losses.append(float(m["loss"]))
        counts = m.get("pp_phase_counts")
        if grads is None:
            grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return {"losses": losses, "params": params, "grads": grads, "counts": counts, "coords": dict(mesh.coords)}


def held_case() -> dict:
    """The most microbatches each schedule held on this stage (data 2 x
    pipe 4), one step at each M of HELD_M, M rows a replica."""
    mesh = rt.make_mesh(("data", "pipe"), (2, 4))
    cfg = ttfm.tiny_lm(**SMALL)
    out = {}
    for schedule, M in itertools.product(SCHEDULES, HELD_M):
        model = _stage(cfg)
        step = tpp.make_pp_train_step(cfg, microbatches=M, schedule=schedule)
        tokens = torch.from_numpy(np.random.default_rng(M).integers(0, 256, (2 * M, 17)))
        step(TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)),
             {"tokens": tokens.chunk(2)[mesh.index("data")]})
        out[schedule, M] = step.last.max_held
    return {"held": out, "stage": mesh.index("pipe")}


def eval_case() -> dict:
    """Pipelined eval of the seeded model on data 2 x pipe 4 with a tail
    the microbatches do not divide, and the length guard's message."""
    mesh = rt.make_mesh(("data", "pipe"), (2, 4))
    cfg = ttfm.tiny_lm(**SMALL)
    model = _stage(cfg)
    tokens, valid = eval_inputs()
    d = mesh.index("data")
    step = tpp.make_pp_eval_step(cfg, microbatches=EVAL_M)
    means, count = step(model, {"tokens": torch.from_numpy(tokens).chunk(2)[d],
                                "valid": torch.from_numpy(valid).chunk(2)[d]})
    short = tpp.make_pp_eval_step(dataclasses.replace(cfg, max_seq_len=16), microbatches=EVAL_M)
    guard = _stage(dataclasses.replace(cfg, max_seq_len=16))
    try:
        short(guard, {"tokens": torch.zeros(4, 33, dtype=torch.long), "valid": torch.ones(4)})
        message = "no error"
    except ValueError as e:
        message = str(e)
    return {"means": {k: float(v) for k, v in means.items()}, "count": float(count), "guard": message}


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {name: {s: run_case(name, s) for s in schedules_of(name)} for name in CASES if name != "pp_zero"}
        res["pp_zero"] = {(s, zero): run_case("pp_zero", s, zero) for s in SCHEDULES for zero in (False, True)}
        res["held"] = held_case()
        res["eval"] = eval_case()
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("pp_ranks"))
    yield r
    r.get()


# ------------------------------------------------------------- JAX side --

def eval_inputs():
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(EVAL_ROWS, 33)).astype(np.int64)
    return tokens, np.array([1, 1, 1, 1, 1, 0], np.int64)


def merged_params(runs, cfg) -> dict:
    """The whole model as the reference's tree, from the ranks at data
    index 0: TP or expert shards merged per stage, then the stages."""
    owners = [r for r in runs if r["coords"]["data"] == 0]
    stages = []
    for s in sorted({r["coords"]["pipe"] for r in owners}):
        rows = []
        for e in sorted({r["coords"].get("expert", 0) for r in owners}):
            row = sorted((r for r in owners if r["coords"]["pipe"] == s and r["coords"].get("expert", 0) == e),
                         key=lambda r: r["coords"].get("model", 0))
            rows.append(merge_tp_shards([r["params"] for r in row]))
        stages.append(merge_ep_shards(rows))
    return to_jax_params(tpp.merge_pp_shards(stages), dataclasses.replace(cfg, ep_axis=None, tp_axis=None))


def _tx(name):
    R = ref()
    _, _, _, opt, lr, _, _, _, extra = CASES[name]
    tx = R.optax.adam(lr, eps=ADAM_EPS) if opt == "adam" else R.optax.sgd(lr)
    return R.optax.chain(R.optax.clip_by_global_norm(extra["clip"]), tx) if extra.get("clip") else tx


def jax_single_device(name) -> dict:
    """The reference's single-device steps for the case: losses and the
    final params tree."""
    R = ref()
    jax, jnp, optax = R.jax, R.jnp, R.optax
    cfg = case_cfg(name)
    model = R.jtfm.TransformerLM(R.jtfm.tiny_lm(attn_impl="xla", **{**SMALL, **CASES[name][2]}))
    params = to_jax_params(seeded_state_dict(cfg), cfg)
    tx = _tx(name)
    opt_state = tx.init(params)

    @jax.jit
    def step(p, s, toks):
        val, g = jax.value_and_grad(lambda q: R.lm_ce(model.apply({"params": q}, toks[:, :-1]), toks[:, 1:]))(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, val

    losses = []
    for tokens in case_tokens(name):
        params, opt_state, val = step(params, opt_state, jnp.asarray(tokens, jnp.int32))
        losses.append(float(val))
    return {"losses": losses, "params": jax.tree.map(np.asarray, params)}


def jax_pp(name, schedule, mesh_shape=None) -> dict:
    """The reference's ``make_pp_train_step`` for the case (its data x
    pipe mesh; no model axis: TP and EP are exact): losses, final params,
    the last step's ``pp_phase_counts``."""
    R = ref()
    jax, ddp = R.jax, R.ddp
    _, shape, over, _, _, _, _, _, extra = CASES[name]
    mesh_shape = mesh_shape or shape[:2]
    cfg = case_cfg(name)
    jcfg = R.jtfm.tiny_lm(attn_impl="xla", **{**SMALL, **over})
    mesh = ddp.make_mesh(("data", "pipe"), shape=mesh_shape, devices=jax.devices()[: mesh_shape[0] * mesh_shape[1]])
    step = R.jpp.make_pp_train_step(jcfg, mesh=mesh, microbatches=extra["M"], donate=False, schedule=schedule,
                                    moe_aux_weight=extra.get("aux", 0.0))
    state = ddp.TrainState.create(apply_fn=None, params=to_jax_params(seeded_state_dict(cfg), cfg), tx=_tx(name))
    state = R.jpp.shard_state_pp(state, mesh)
    losses = []
    for tokens in case_tokens(name):
        state, m = step(state, R.shard_batch({"tokens": tokens.astype(np.int32)}, mesh), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    counts = m.get("pp_phase_counts")
    return {"losses": losses, "params": jax.tree.map(np.asarray, state.params),
            "counts": None if counts is None else np.asarray(counts)}


def jax_eval() -> dict:
    """The unsharded model's masked eval means of eval_inputs."""
    R = ref()
    from distributeddataparallel_tpu.ops.losses import per_example_accuracy, per_example_cross_entropy

    cfg = ttfm.tiny_lm(**SMALL)
    model = R.jtfm.TransformerLM(R.jtfm.tiny_lm(attn_impl="xla", **SMALL))
    tokens, valid = eval_inputs()

    @R.jax.jit
    def per_row(params, toks):
        logits = model.apply({"params": params}, toks[:, :-1])
        return per_example_cross_entropy(logits, toks[:, 1:]), per_example_accuracy(logits, toks[:, 1:])

    ce, hit = (np.asarray(x) for x in per_row(to_jax_params(seeded_state_dict(cfg), cfg), tokens.astype(np.int32)))
    v = valid.astype(np.float32)
    return {"loss": float((ce * v).sum() / v.sum()), "accuracy": float((hit * v).sum() / v.sum()),
            "count": float(v.sum())}


@pytest.fixture(scope="module")
def want(ranks):
    """The reference's results, computed while the ranks work."""
    return {
        "single": {name: jax_single_device(name) for name in ("llama_n4", "gpt2_n2", "pp_tp", "pp_zero")},
        "llama_n4": jax_pp("llama_n4", "1f1b"),
        "gpt2_n2": jax_pp("gpt2_n2", "gpipe"),
        "pp_ep": jax_pp("pp_ep", "1f1b"),
        "eval": jax_eval(),
    }


def check(runs, want_run, cfg, what, loss_rel=LOSS_REL, atol=PARAM_ATOL):
    jax = ref().jax
    for run in runs:  # every rank reports the global (mean) loss
        np.testing.assert_allclose(run["losses"], want_run["losses"], rtol=loss_rel, err_msg=what)
    got = merged_params(runs, cfg)
    flat = jax.tree_util.tree_flatten_with_path(want_run["params"])[0]
    for (path, b), a in zip(flat, jax.tree.leaves(got)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ----------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", ["llama_n4", "gpt2_n2"])
def test_dp_pp_matches_single_device_and_reference(ranks, want, name):
    """Both schedules against one device, and against the reference's
    pipelined step (1F1B at n = 4, GPipe at n = 2)."""
    for schedule in SCHEDULES:
        runs = [r[name][schedule] for r in ranks.get()]
        check(runs, want["single"][name], case_cfg(name), f"{name} {schedule} vs one device")
        check(runs, want[name], case_cfg(name), f"{name} {schedule} vs the reference's pipeline")


@pytest.mark.parametrize("name", ["llama_n4", "gpt2_n2", "pp_ep"])
def test_1f1b_matches_gpipe(ranks, name):
    """The port's 1F1B (recompute in the backward unit) against its GPipe:
    losses, and every stage's first-step gradients."""
    for r in ranks.get():
        a, b = r[name]["1f1b"], r[name]["gpipe"]
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=LOSS_REL)
        for k in a["grads"]:
            np.testing.assert_allclose(a["grads"][k], b["grads"][k], atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_dp_pp_tp_matches_single_device(ranks, want):
    runs = [r["pp_tp"]["1f1b"] for r in ranks.get()]
    check(runs, want["single"]["pp_tp"], case_cfg("pp_tp"), "pp_tp")


def test_dp_pp_ep_moe_aux_matches_reference(ranks, want):
    """MoE token choice with the aux loss, both schedules, against the
    reference's 1F1B step (its aux value and cotangent riding the
    recompute)."""
    for schedule in SCHEDULES:
        runs = [r["pp_ep"][schedule] for r in ranks.get()]
        check(runs, want["pp_ep"], case_cfg("pp_ep"), f"pp_ep {schedule}")


def test_pp_zero_matches_plain_pp(ranks, want):
    """ZeRO-1 over each stage's flat layout with the binding clip (its
    norm over the pipe), both schedules, against plain PP and one device."""
    for schedule in SCHEDULES:
        plain = [r["pp_zero"][schedule, False] for r in ranks.get()]
        zero = [r["pp_zero"][schedule, True] for r in ranks.get()]
        check(plain, want["single"]["pp_zero"], case_cfg("pp_zero"), f"plain {schedule}")
        check(zero, {"losses": plain[0]["losses"], "params": merged_params(plain, case_cfg("pp_zero"))},
              case_cfg("pp_zero"), f"zero {schedule}", atol=ZERO_ATOL)


def test_pp_eval_matches_unsharded(ranks, want):
    for r in ranks.get():
        got = r["eval"]
        assert got["count"] == want["eval"]["count"]
        np.testing.assert_allclose(got["means"]["loss"], want["eval"]["loss"], rtol=LOSS_REL)
        np.testing.assert_allclose(got["means"]["accuracy"], want["eval"]["accuracy"], rtol=LOSS_REL)
        assert got["guard"] == "global seq len 32 > max_seq_len 16"


def test_pp_phase_counts_and_bubble_are_the_references(ranks, want):
    jpp = ref().jpp
    for n, M, v, schedule in itertools.product((2, 4, 8), (1, 3, 4, 8, 13), (1, 2), ("1f1b", "zb")):
        assert tpp.pp_bubble_fraction(n, M, v, schedule) == jpp.pp_bubble_fraction(n, M, v, schedule)
    for r in ranks.get():
        np.testing.assert_array_equal(r["llama_n4"]["1f1b"]["counts"].numpy(), want["llama_n4"]["counts"])
        assert r["llama_n4"]["gpipe"]["counts"] is None


def test_1f1b_holds_at_most_n_microbatches(ranks):
    for r in ranks.get():
        s = r["held"]["stage"]
        for M in HELD_M:
            assert r["held"]["held"]["1f1b", M] == 4 - s, (s, M, r["held"]["held"])
            assert r["held"]["held"]["gpipe", M] == M


def test_pp_shards_are_the_references():
    """Each (pipe, model) position's shard is the reference's device slice
    under ``pp_param_specs``, leaf for leaf."""
    R = ref()
    jax = R.jax
    cfg = ttfm.tiny_lm(**{**SMALL, "num_heads": 4, "num_kv_heads": 2})
    full = to_jax_params(seeded_state_dict(cfg), cfg)
    specs = jax.tree.leaves(R.jpp.pp_param_specs(full, "pipe", tp_axis="model"), is_leaf=lambda x: isinstance(x, R.P))
    for p, t in itertools.product(range(2), range(2)):
        shard = from_jax_params(full, cfg, tp_rank=t, tp_size=2, pp_rank=p, pp_size=2)
        mine = to_jax_params(shard, dataclasses.replace(cfg, num_layers=2))
        for leaf, spec, got in zip(jax.tree.leaves(full), specs, jax.tree.leaves(mine)):
            rank = {"pipe": p, "model": t}
            idx = tuple(slice(rank[a] * (s // 2), (rank[a] + 1) * (s // 2)) if a in rank else slice(None)
                        for s, a in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim))
            np.testing.assert_array_equal(got, leaf[idx])
    assert any("pipe" in tuple(s) for s in specs) and any("model" in tuple(s) for s in specs)
