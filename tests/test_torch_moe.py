"""The port's mixture of experts (``ops/moe.py``, ``models.transformer.MoEMLP``,
the aux loss, MoE generation and weight I/O) against the JAX package's, on
the CPU, in one process.  Weights come from the reference's init (or the
port's seeded init) and cross with ``models.io``; inputs are numpy-seeded.

- ``ops.moe``: capacities, slot assignment (the reference test's priority
  and drop case, and random routings at tight and loose capacity),
  dispatch and combine: exact (integer routing, copies, and one multiply
  and at most K adds a token).  The gates' gradient through the slots:
  atol 1e-6 (f32 sums of the same few terms).
- ``MoEMLP`` forward and gradients (x, router, the expert stacks) against
  flax's for top-1 / top-2 x GELU / SwiGLU, dense and token-choice
  dispatch, f32 and bf16.  Both routers run in f32 on the same inputs, so
  the routing is the same.  f32: atol 2e-5 relative to the largest value
  (summation order).  bf16: XLA and PyTorch round the bf16 products and
  the activation's intermediates at different points, so values may sit a
  few bf16 ulps (2^-8 relative each) apart: 3e-2 of the largest value.
- The aux term and the router's gradient of ``CE + 0.01 aux`` over 2
  layers, unrolled and ``scan_layers``: atol 1e-6 / 1e-5 relative (f32).
- Dropped tokens: with capacity below the load a dropped token's MoE
  output is exactly 0 (the residual carries it) and a kept one equals the
  loose-capacity output (atol 1e-6).
- ``dpp`` for 3 AdamW steps with ``--moe-experts 4 --moe-top-k 2
  --moe-capacity-factor 1.25 --remat on`` (GPT-2 shape, f32) against the
  reference's ``make_train_step`` with its aux ``loss_fn``: losses, the
  aux term and parameters within 2e-5 + 1e-4 relative (test_torch_train's
  f32 bound over three updates).
- ``generate`` through MoE blocks, dense and token-choice, greedy: the
  reference's ids token for token (f32 logits agree to ~1e-6).
- ``models.io``: the flat and stacked round trips are exact, the leaf
  order is the reference's (ZeRO's flat layout follows it), and every
  expert rank's shard is the reference's slice.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dpp as jdpp  # noqa: E402  the reference entry point

import distributeddataparallel_tpu as ddp  # noqa: E402
from distributeddataparallel_tpu.models import transformer as jtfm  # noqa: E402
from distributeddataparallel_tpu.ops import accuracy as j_accuracy  # noqa: E402
from distributeddataparallel_tpu.ops import lm_cross_entropy as j_lm_ce  # noqa: E402
from distributeddataparallel_tpu.ops import moe as jmoe  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.generate import generate as tgenerate  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import (  # noqa: E402
    from_jax_params,
    jax_leaf_pieces,
    to_jax_params,
)
from distributeddataparallel_tpu_torch.ops import moe as tmoe  # noqa: E402
from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.expert_parallel import merge_ep_shards  # noqa: E402
from distributeddataparallel_tpu_torch.training.optim import build_optimizer  # noqa: E402
from distributeddataparallel_tpu_torch.training.state import TrainState  # noqa: E402
from distributeddataparallel_tpu_torch.training.train_step import make_train_step  # noqa: E402

jgen = importlib.import_module("distributeddataparallel_tpu.models.generate")

SMALL = dict(num_layers=2, num_heads=2, d_model=32, d_ff=64, max_seq_len=32, moe_experts=4)
F32_REL, BF16_REL = 2e-5, 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-7, f"{what}: max |err| {err:.3e} > {rel} x {scale:.3e}"


def _routing(seed, T, K, E):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(E, K, replace=False) for _ in range(T)]).astype(np.int32)
    gates = rng.random((T, K)).astype(np.float32)
    return idx, gates


def test_ops_match_reference():
    """Capacity, slots, dispatch, combine and the gates' gradient."""
    for args in ((16, 4, 1, 1.25), (4096, 8, 2, 1.25), (7, 3, 2, 0.1), (32, 4, 2, 4.0)):
        assert tmoe.moe_capacity(*args) == jmoe.moe_capacity(*args), args
    T, K, E, d = 24, 2, 4, 8
    x = np.random.default_rng(9).standard_normal((T, d)).astype(np.float32)
    for seed, C in ((0, 3), (1, 12), (2, 24)):  # overflow, balanced, none
        idx, gates = _routing(seed, T, K, E)
        jt, jg = jmoe.token_choice_slots(jnp.asarray(idx), jnp.asarray(gates), E, C)
        tt, tg = tmoe.token_choice_slots(torch.from_numpy(idx), torch.from_numpy(gates), E, C)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        z = tmoe.dispatch(torch.from_numpy(x), tt)
        np.testing.assert_array_equal(z.numpy(), np.asarray(jmoe.dispatch(jnp.asarray(x), jt)))
        y = z * 1.5 + 0.25
        out = tmoe.combine(y, tt, tg, T)
        want = jmoe.combine(jnp.asarray(y.numpy()), jt, jg, T)
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6, rtol=0)

        if C != 3:
            continue
        # At the overflowing capacity, d/dgates of sum(combine(...) * cot):
        # through the scatter and gather, dropped pairs included.
        cot = np.random.default_rng(seed + 5).standard_normal((T, d)).astype(np.float32)

        def jf(g):
            tok, gs = jmoe.token_choice_slots(jnp.asarray(idx), g, E, C)
            return jnp.sum(jmoe.combine(jmoe.dispatch(jnp.asarray(x), tok), tok, gs, T) * cot)

        tg_in = torch.from_numpy(gates).requires_grad_()
        tok, gs = tmoe.token_choice_slots(torch.from_numpy(idx), tg_in, E, C)
        (tmoe.combine(tmoe.dispatch(torch.from_numpy(x), tok), tok, gs, T) * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(tg_in.grad.numpy(), np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(gates))),
                                   atol=1e-6, rtol=0)


def test_token_choice_slots_priority_and_drop():
    """The reference test's case: earlier tokens win the slots (the stable
    sort's priority), overflow vanishes (gate 0), kept gates land in their
    expert's slots."""
    idx = torch.tensor([[2], [2], [0], [2]])
    gates = torch.tensor([[0.9], [0.8], [0.7], [0.6]])
    tok, gate = tmoe.token_choice_slots(idx, gates, num_experts=4, capacity=2)
    tok, gate = tok.numpy().reshape(4, 2), gate.numpy().reshape(4, 2)
    assert tok[0, 0] == 2 and gate[0, 0] == pytest.approx(0.7)
    assert list(tok[2]) == [0, 1]
    np.testing.assert_allclose(gate[2], [0.9, 0.8])
    assert gate[1].sum() == 0 and gate[3].sum() == 0
    assert not np.isclose(gate, 0.6).any()
    # Many tokens on one expert: the first C in token order keep their slots.
    idx = torch.tensor([[1]] * 300 + [[0]] * 5)
    tok, gate = tmoe.token_choice_slots(idx, torch.ones(305, 1), num_experts=2, capacity=200)
    np.testing.assert_array_equal(tok.numpy()[200:], np.arange(200))


def _moe_mlp_pair(dtype, capacity_factor, top_k, activation, seed):
    """The flax MoEMLP's config and numpy-seeded params (a router wide
    enough to route unevenly), and the port's MoEMLP holding them."""
    cfg = dict(SMALL, num_layers=1, moe_top_k=top_k, moe_capacity_factor=capacity_factor, activation=activation)
    jcfg = jtfm.tiny_lm(dtype=getattr(jnp, dtype), **cfg)
    tcfg = ttfm.tiny_lm(dtype=getattr(torch, dtype), **cfg)
    rng = np.random.default_rng(seed)
    d, f, E = 32, 64, 4
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    shapes = {"experts_up": (E, d, f), "experts_down": (E, f, d)}
    if activation == "swiglu":
        shapes["experts_gate"] = (E, d, f)
    mp = {k: (0.1 * rng.standard_normal(v)).astype(np.float32) for k, v in shapes.items()}
    mp["router"] = {"kernel": (0.3 * rng.standard_normal((d, E))).astype(np.float32)}
    mlp = ttfm.MoEMLP(tcfg)
    mlp.load_state_dict({"router.weight": torch.tensor(mp["router"]["kernel"].T),
                         **{k: torch.tensor(mp[k]) for k in shapes}})
    return jcfg, mp, mlp, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [0.0, 1.25], ids=["dense", "token-choice"])
def test_moe_mlp_matches_flax(dtype, capacity_factor):
    """Forward and gradients (x, router, expert stacks) for top-1/top-2 x
    GELU/SwiGLU; tolerances in the module docstring."""
    rel = F32_REL if dtype == "float32" else BF16_REL
    for i, (top_k, act) in enumerate([(1, "gelu"), (2, "gelu"), (1, "swiglu"), (2, "swiglu")]):
        jcfg, mp, mlp, x = _moe_mlp_pair(dtype, capacity_factor, top_k, act, seed=i)
        cot = np.random.default_rng(i + 20).standard_normal(x.shape).astype(np.float32)
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))

        def jf(p, xx):
            out = jtfm.MoEMLP(jcfg).apply({"params": p}, xx).astype(jnp.float32)
            return jnp.sum(out * cot), out

        (_, want), (gp, gx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(mp, xj)
        xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
        out, aux = mlp(xt)
        (out.float() * torch.from_numpy(cot)).sum().backward()
        what = f"{dtype} cf={capacity_factor} top{top_k} {act}"
        _close(out.detach().float(), want, rel, what + " out")
        _close(xt.grad.float(), np.asarray(gx.astype(jnp.float32)), rel, what + " dx")
        _close(mlp.router.weight.grad.t(), gp["router"]["kernel"], rel, what + " router")
        for name in ("experts_up", "experts_down") + (("experts_gate",) if act == "swiglu" else ()):
            _close(getattr(mlp, name).grad, gp[name], rel, f"{what} {name}")
        assert np.isfinite(float(aux.detach()))


@pytest.mark.parametrize("scan_layers", [False, True], ids=["flat", "stacked"])
def test_aux_and_router_gradient_over_layers(scan_layers):
    """The mean of the per-layer aux terms (the reference's
    ``moe_aux_from_intermediates``) and every router's gradient of
    CE + 0.01 aux, over 2 layers, top-2 token choice."""
    cfg = dict(SMALL, moe_top_k=2, moe_capacity_factor=1.25, scan_layers=scan_layers)
    jcfg, tcfg = jtfm.tiny_lm(attn_impl="xla", **cfg), ttfm.tiny_lm(**cfg)
    toks = np.random.default_rng(4).integers(0, 256, (4, 17))
    jm = jtfm.TransformerLM(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(toks[:, :-1]))["params"]

    def jloss(p):
        logits, col = jm.apply({"params": p}, jnp.asarray(toks[:, :-1]), mutable=["intermediates"])
        aux = jtfm.moe_aux_from_intermediates(col)
        return j_lm_ce(logits, jnp.asarray(toks[:, 1:])) + 0.01 * aux, aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = ttfm.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    t = torch.from_numpy(toks)
    logits, aux = model(t[:, :-1], with_aux=True)
    loss = lm_cross_entropy(logits, t[:, 1:]) + 0.01 * aux
    loss.backward()
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6 and abs(float(loss.detach()) - float(jl)) <= 1e-5
    grads = to_jax_params({k: p.grad for k, p in model.named_parameters()}, tcfg)
    routers = ([grads["layers"]["block"]["mlp"]["router"]["kernel"]] if scan_layers
               else [grads[f"layer_{i}"]["mlp"]["router"]["kernel"] for i in range(2)])
    wants = ([jg["layers"]["block"]["mlp"]["router"]["kernel"]] if scan_layers
             else [jg[f"layer_{i}"]["mlp"]["router"]["kernel"] for i in range(2)])
    for got, want in zip(routers, wants):
        assert float(np.abs(want).max()) > 0
        _close(got, want, 1e-5, "router grad")


def test_dropped_tokens_pass_through_residual():
    """Capacity below the load: dropped tokens' MoE output is exactly 0 and
    kept tokens equal the drop-free output; in a block, a dropped token's
    hidden state is the attention residual alone."""
    cfg = dict(SMALL, num_layers=1, moe_top_k=1)
    tight = ttfm.tiny_lm(moe_capacity_factor=0.5, **cfg)
    loose = ttfm.tiny_lm(moe_capacity_factor=4.0, **cfg)
    a, b = ttfm.MoEMLP(tight), ttfm.MoEMLP(loose)
    torch.manual_seed(0)
    for p in a.parameters():
        torch.nn.init.normal_(p, 0.0, 0.3)
    b.load_state_dict(a.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 16, 32)).astype(np.float32))
    with torch.no_grad():
        got_t, got_l = a(x)[0][0], b(x)[0][0]
        probs = torch.softmax(x[0] @ a.router.weight.t(), -1)
        vals, idx = probs.max(-1)
        tok, gate = tmoe.token_choice_slots(idx[:, None], vals[:, None], 4, tmoe.moe_capacity(16, 4, 1, 0.5))
    kept = torch.zeros(16, dtype=torch.bool)
    kept[tok[gate > 0]] = True
    assert 0 < int(kept.sum()) < 16, "the fixture must overflow"
    assert torch.equal(got_t[~kept], torch.zeros_like(got_t[~kept]))
    torch.testing.assert_close(got_t[kept], got_l[kept], atol=1e-6, rtol=0)
    # Through a block: a dropped token's hidden state is x + attention, exactly.
    blk = ttfm.DecoderBlock(tight)
    blk.mlp.load_state_dict(a.state_dict())
    rope = ttfm.rope_frequencies(16, 32, theta=tight.rope_theta)
    with torch.no_grad():
        y, _ = blk(x, rope)
        h = x + blk.attn(blk.attn_norm(x), rope)
        dropped = (blk.mlp(blk.mlp_norm(h))[0][0] == 0).all(-1)
    assert bool(dropped.any())
    assert torch.equal(y[0][dropped], h[0][dropped])


MOE_FLAGS = ["--model", "gpt2", "--layers", "2", "--d-model", "32", "--seq-len", "16", "--vocab-size", "64",
             "--moe-experts", "4", "--moe-top-k", "2", "--moe-capacity-factor", "1.25", "--remat", "on",
             "--optimizer", "adamw", "--lr", "1e-2", "--weight-decay", "0.1"]


def test_dpp_three_adamw_steps_match_reference():
    """``dpp``'s loss_fn and step for the MoE flags against the reference's
    ``make_train_step`` with its aux ``loss_fn`` (``dpp.py:1549-1568``)."""
    targs = tdpp.parse_args(["--device", "cpu", *MOE_FLAGS])
    jargs = jdpp.parse_args(["--device", "cpu", *MOE_FLAGS])
    tcfg = tdpp.build_config(targs)
    jmodel = jdpp.build_model(jargs, vocab_size=64)
    jmodel = jtfm.TransformerLM(dataclasses.replace(jmodel.cfg, attn_impl="xla"))
    assert (jmodel.cfg.moe_experts, jmodel.cfg.moe_top_k, jmodel.cfg.moe_capacity_factor, jmodel.cfg.remat) == (
        tcfg.moe_experts, tcfg.moe_top_k, tcfg.moe_capacity_factor, tcfg.remat)
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 64, size=(4, 17)).astype(np.int32) for _ in range(3)]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(batches[0][:, :-1]))["params"]
    tx = jdpp.build_optimizer(jargs, total_steps=3)

    def jloss(p, batch, rng_):
        toks = batch["tokens"]
        logits, col = jmodel.apply({"params": p}, toks[:, :-1], mutable=["intermediates"])
        aux = jtfm.moe_aux_from_intermediates(col)
        loss = j_lm_ce(logits, toks[:, 1:]) + jargs.moe_aux_weight * aux
        return loss, {"accuracy": j_accuracy(logits, toks[:, 1:]), "moe_aux": aux}

    mesh = ddp.make_mesh(("data",), devices=jax.devices()[:1])
    jstate = ddp.broadcast_params(ddp.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx), mesh)
    jstep = ddp.make_train_step(jloss, mesh=mesh, donate=False)
    want = []
    for b in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)}, jax.random.PRNGKey(0))
        want.append((float(m["loss"]), float(m["moe_aux"])))

    model = ttfm.TransformerLM(tcfg)
    model.load_state_dict(from_jax_params(params, tcfg))
    state = TrainState(model, *build_optimizer(targs, model.parameters(), 3))
    step = make_train_step(tdpp.lm_loss_fn(targs))
    got = []
    for b in batches:
        m = step(state, {"tokens": torch.from_numpy(b).long()})
        got.append((float(m["loss"]), float(m["moe_aux"])))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    expected = from_jax_params(jstate.params, tcfg)
    for name, p in model.named_parameters():
        if name.endswith("k_proj.bias"):
            # Its gradient is 0 in exact arithmetic (a key bias shifts a
            # query's scores alike, which the softmax cancels): both sides
            # step on rounding noise, which Adam scales up to ~lr.  Held to
            # that noise level instead.
            assert float(p.detach().abs().max()) < 1e-3 and float(expected[name].abs().max()) < 1e-3, name
            continue
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(), atol=2e-5, rtol=1e-4, err_msg=name)


def test_generate_matches_reference():
    """Greedy KV-cache generation through MoE blocks, dense and token-choice
    (whose capacity comes from each call's own token count): the
    reference's ids."""
    for capacity_factor in (0.0, 1.25):
        cfg = dict(SMALL, vocab_size=97, moe_top_k=2, moe_capacity_factor=capacity_factor, num_heads=4,
                   num_kv_heads=2, tie_embeddings=False)
        jcfg, tcfg = jtfm.tiny_lm(attn_impl="xla", **cfg), ttfm.tiny_lm(**cfg)
        prompt = np.random.default_rng(7).integers(0, 97, (2, 5)).astype(np.int32)
        params = jax.jit(jtfm.TransformerLM(jcfg).init)(jax.random.PRNGKey(2), jnp.asarray(prompt))["params"]
        want = np.asarray(jgen.generate(jtfm.TransformerLM(jcfg), params, jnp.asarray(prompt), 12))
        model = ttfm.TransformerLM(tcfg)
        model.load_state_dict(from_jax_params(params, tcfg))
        got = tgenerate(model, torch.from_numpy(prompt), 12).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"capacity factor {capacity_factor}")


def test_io_round_trip_both_layouts():
    """Flat and stacked trees cross exactly, in the reference's leaf order,
    and each expert rank's shard is the reference's slice (merged back:
    the whole tree)."""
    for scan_layers, act in ((False, "gelu"), (True, "swiglu")):
        cfg = dict(SMALL, scan_layers=scan_layers, activation=act)
        jcfg, tcfg = jtfm.tiny_lm(**cfg), ttfm.tiny_lm(**cfg)
        like = jax.eval_shape(jtfm.TransformerLM(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        rng = np.random.default_rng(1)
        params = jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), like["params"])
        sd = from_jax_params(params, tcfg)
        model = ttfm.TransformerLM(tcfg)
        model.load_state_dict(sd)
        back = to_jax_params(model.state_dict(), tcfg)
        flat = jax.tree_util.tree_flatten_with_path(params)[0]
        assert jax.tree.structure(back) == jax.tree.structure(params)
        assert [jax.tree_util.keystr(p, simple=True, separator="/") for p, _ in flat] == \
            [path for path, _ in jax_leaf_pieces(model)]
        for (path, a), b in zip(flat, jax.tree.leaves(back)):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(path))
        shards = [from_jax_params(params, tcfg, ep_rank=r, ep_size=2) for r in range(2)]
        for r, shard in enumerate(shards):
            for (path, a), b in zip(flat, jax.tree.leaves(to_jax_params(shard, tcfg))):
                name = jax.tree_util.keystr(path, simple=True, separator="/")
                a = np.asarray(a)
                if name.split("/")[-1].startswith("experts_"):
                    a = np.split(a, 2, axis=a.ndim - 3)[r]
                np.testing.assert_array_equal(a, b, err_msg=name)
        merged = merge_ep_shards(shards)
        assert all(torch.equal(merged[k], sd[k]) for k in sd)
