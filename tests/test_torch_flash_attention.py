"""The plain versions of the port's three flash kernels against the Pallas
kernels, on the CPU.

K1 (forward), K2 (dq) and K3 (dk/dv) in plain PyTorch are held to the
Pallas kernels run in interpret mode, and the ``FlashAttention`` autograd
function to ``jax.vjp`` of the Pallas ``flash_attention``.  Inputs come from
a seeded numpy generator and go to both packages as numpy arrays.

Tolerance: f32 throughout; the two sides sum in different orders (blockwise
online softmax on the Pallas side, whole rows here), which moves results by
a few ulps of values of order 1-10, so atol = rtol = 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.ops import pallas_attention as jpa
from distributeddataparallel_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=2e-5)

# (B, Sq, Skv, H, Hkv, D, causal): S in {128, 256}, D in {64, 128}, causal
# and not, GQA groups 1 and 4, Sq < Skv.
CASES = [
    pytest.param(1, 128, 128, 2, 2, 64, True, id="s128-d64-causal-g1"),
    pytest.param(1, 256, 256, 4, 1, 64, False, id="s256-d64-full-g4"),
    pytest.param(1, 128, 256, 4, 1, 128, True, id="sq128-skv256-d128-causal-g4"),
    pytest.param(1, 256, 256, 2, 2, 128, True, id="s256-d128-causal-g1"),
    pytest.param(2, 128, 256, 2, 2, 64, False, id="sq128-skv256-d64-full-g1"),
]


def _arrays(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(B, Sq, H, D), f(B, Skv, Hkv, D), f(B, Skv, Hkv, D), f(B, Sq, H, D)


def _t(*xs):
    return [torch.from_numpy(np.array(x, np.float32)) for x in xs]


def _close(actual, expected, what):
    np.testing.assert_allclose(
        np.asarray(actual, np.float32), np.asarray(expected, np.float32),
        err_msg=what, **TOL,
    )


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", CASES)
def test_flash_fwd_plain_matches_pallas(B, Sq, Skv, H, Hkv, D, causal):
    q, k, v, _ = _arrays(0, B, Sq, Skv, H, Hkv, D)
    j_out, j_lse8 = jpa._flash_fwd_impl(q, k, v, causal=causal, interpret=True)
    # The Pallas lse is (B*H, 8, Sq), broadcast over 8 TPU sublanes.
    j_lse = np.asarray(j_lse8)[:, 0, :].reshape(B, H, Sq)
    out, lse = tfa.flash_fwd_plain(*_t(q, k, v), causal)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    _close(out, j_out, "out")
    _close(lse, j_lse, "lse")


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", CASES)
def test_flash_bwd_plain_matches_pallas(B, Sq, Skv, H, Hkv, D, causal):
    q, k, v, do = _arrays(1, B, Sq, Skv, H, Hkv, D)
    j_out, j_lse8 = jpa._flash_fwd_impl(q, k, v, causal=causal, interpret=True)
    j_dq, j_dk, j_dv = jpa._bwd(causal, True, (q, k, v, j_out, j_lse8), do)
    lse = np.asarray(j_lse8)[:, 0, :].reshape(B, H, Sq)
    dq, dk, dv = tfa.flash_bwd_plain(*_t(q, k, v, j_out, lse, do), causal)
    _close(dq, j_dq, "dq")
    _close(dk, j_dk, "dk")
    _close(dv, j_dv, "dv")


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [CASES[1], CASES[2]])
def test_flash_attention_autograd_matches_jax_vjp(B, Sq, Skv, H, Hkv, D, causal):
    q, k, v, do = _arrays(2, B, Sq, Skv, H, Hkv, D)
    j_out, vjp = jax.vjp(
        lambda q, k, v: jpa.flash_attention(q, k, v, causal, True),
        *map(jnp.asarray, (q, k, v)),
    )
    j_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(torch.from_numpy(do))
    _close(out.detach(), j_out, "out")
    for name, t, j in zip(("dq", "dk", "dv"), (tq, tk, tv), j_grads):
        _close(t.grad, j, name)
