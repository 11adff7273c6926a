"""The port's Ulysses sequence parallelism (``ulysses_attention``,
``--cp-impl ulysses``) against the JAX package's, on the CPU.

Eight gloo ranks are spawned once for the file; the same numpy-seeded
inputs go through the reference's ``ulysses_attention`` on its fake CPU
devices.

- The GQA-native path (the kv heads divide the axis and travel at their own
  count) and the expand path (they do not: repeated to lcm(Hkv, n) first),
  through the flash kernels' plain versions (``impl="kernel"``, what CUDA
  tensors launch) against the reference's XLA attention: out, dq, dk, dv.
- The head-divisibility guard, with the reference's message.
- ``dpp --cp 2 --cp-impl ulysses --zero 1 --accum-steps 2 --eval`` for 3
  steps on 8 ranks (data 4 x seq 2; the Llama's one kv head takes the
  expand path) against the reference's train step and CP eval step on the
  same mesh (the harness and its tolerances are
  ``test_torch_context_parallel.py``'s).

Tolerance of the attention cases: f32 on both sides, summation order only:
atol 2e-5.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_context_parallel import (  # noqa: E402
    F32_ATOL,
    LM,
    WORLD,
    Ranks,
    check_dpp_run,
    dpp_run,
    jax_dpp_run,
    ref,
)

from distributeddataparallel_tpu_torch.parallel import context_parallel as tcp  # noqa: E402
from distributeddataparallel_tpu_torch.runtime import distributed as rt  # noqa: E402
from torch_cores import one_thread  # noqa: E402,F401 -- an autouse fixture

B, SL, D = 2, 8, 16
# (axis size, heads, kv heads)
CASES = {"native-n4": (4, 8, 4), "expand-n4": (4, 8, 2), "expand-n8": (8, 8, 2)}
DPP_RUNS = {"ulysses-zero1-accum-eval": LM + ["--cp", "2", "--cp-impl", "ulysses", "--zero", "1",
                                              "--accum-steps", "2", "--eval"]}


def inputs(name):
    n, H, Hkv = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    f = lambda h: rng.standard_normal((B, n * SL, h, D)).astype(np.float32)
    return f(H), f(Hkv), f(Hkv), f(H)


def ulysses_case(name) -> tuple[int, dict]:
    n = CASES[name][0]
    mesh = rt.make_mesh(("data", "seq"), (WORLD // n, n))
    idx = mesh.index("seq")
    sl = slice(idx * SL, (idx + 1) * SL)
    q, k, v, w = inputs(name)
    ql, kl, vl = (torch.from_numpy(x[:, sl].copy()).requires_grad_() for x in (q, k, v))
    out = tcp.ulysses_attention(ql, kl, vl, rt.axis_group("seq"), causal=True, impl="kernel")
    (out * torch.from_numpy(w[:, sl].copy())).sum().backward()
    return idx, {"out": out.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad}


def guard_message() -> str:
    """Ulysses on 6 heads over a 4-way axis."""
    rt.make_mesh(("data", "seq"), (WORLD // 4, 4))
    x = torch.zeros(1, SL, 6, D)
    try:
        tcp.ulysses_attention(x, x, x, rt.axis_group("seq"))
    except ValueError as e:
        return str(e)
    return "no error"


def _worker(rank, world, coordinator, out_dir):
    torch.set_num_threads(1)
    rt.init_process_group(coordinator_address=coordinator, num_processes=1, process_id=0,
                          world_size=world, rank=rank, device="cpu")
    try:
        res = {"ops": {name: ulysses_case(name) for name in CASES}, "guard": guard_message(),
               "dpp": {name: dpp_run(flags, rank, world) for name, flags in DPP_RUNS.items()}}
    finally:
        rt.destroy_process_group()
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(_worker, tmp_path_factory.mktemp("ulysses_ranks"))
    yield r
    r.get()


@pytest.fixture(scope="module")
def want(ranks):
    """Every case's reference results, computed while the ranks work."""
    return {**{name: jax_ulysses(name) for name in CASES},
            **{name: jax_dpp_run(flags) for name, flags in DPP_RUNS.items()}}


def jax_ulysses(name):
    R = ref()
    jax, jnp, P = R.jax, R.jnp, R.P
    n = CASES[name][0]
    q, k, v, w = inputs(name)

    def local(q, k, v, w):
        o = R.jcp.ulysses_attention(q, k, v, axis_name="seq", causal=True, impl="xla")
        return jnp.sum(o * w), o

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq")
    fn = jax.shard_map(jax.value_and_grad(local, argnums=(0, 1, 2), has_aux=True), mesh=mesh,
                       in_specs=(spec,) * 4, out_specs=((P(), spec), (spec,) * 3), check_vma=False)
    (_, out), grads = jax.jit(fn)(*(jnp.asarray(x) for x in (q, k, v, w)))
    return {"out": out, **dict(zip(("dq", "dk", "dv"), grads))}


@pytest.mark.parametrize("name", list(CASES))
def test_ulysses_matches_reference(ranks, want, name):
    n = CASES[name][0]
    want = want[name]
    chunks = sorted(r["ops"][name] for r in ranks.get()[:n])
    assert [i for i, _ in chunks] == list(range(n))
    for key in ("out", "dq", "dk", "dv"):
        got = torch.cat([c[key] for _, c in chunks], dim=1).numpy()
        np.testing.assert_allclose(got, np.asarray(want[key]), atol=F32_ATOL, rtol=0, err_msg=f"{name} {key}")


def test_ulysses_head_divisibility_guard(ranks):
    for r in ranks.get():
        assert r["guard"] == "ulysses requires num_heads % axis size == 0, got 6 % 4"


@pytest.mark.parametrize("name", list(DPP_RUNS))
def test_dpp_ulysses_matches_reference(ranks, want, name):
    check_dpp_run(ranks, name, want[name])
