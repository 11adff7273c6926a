"""The plain versions of the port's flash kernels against the Pallas kernels
in bf16, on the CPU.

The Pallas kernels round the probabilities and the score gradients to the
inputs' dtype before the second product of each pair
(``pallas_attention.py``: ``p.astype(v_ref.dtype)`` in the forward,
``ds.astype(k_ref.dtype)`` in dq, ``p.astype(do.dtype)`` and
``ds.astype(q.dtype)`` in dk/dv).  The port's plain versions, which are
also the card-side oracle of the CUDA kernels, must round at the same
places.  Inputs come from a seeded numpy generator in f32 and are cast to
bf16 on both sides (both round to nearest even, so they hold equal values).

Tolerance: bf16 outputs |port - pallas| <= 1e-3 + 1e-2 |pallas|.  Both sides
compute in f32 from equal bf16 inputs and round p (or ds) to bf16, the
Pallas forward per kv block against a running max and the plain version per
row against the row's max, so single p entries may land one bf16 ulp apart;
that moves an output by far less than its own bf16 ulp.  The outputs are
then rounded to bf16 once: rtol 1e-2 covers one bf16 ulp (at most 2^-7
relative) of the result and atol 1e-3 about one ulp near |x| = 0.25, where
the f32 differences before the final rounding can tip it.  lse is f32 on
both sides and summed in different orders: atol = rtol = 2e-5, as in
``test_torch_flash_attention.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.ops import pallas_attention as jpa
from distributeddataparallel_tpu_torch.ops import flash_attention as tfa

BF16_TOL = dict(atol=1e-3, rtol=1e-2)
LSE_TOL = dict(atol=2e-5, rtol=2e-5)

# (B, Sq, Skv, H, Hkv, D, causal).  At seed 3 the unrounded plain versions
# fall outside BF16_TOL in every output of the causal case and in dv of
# the full one (a full row averages over more keys, so its errors shrink).
CASES = [
    pytest.param(1, 256, 256, 4, 1, 64, True, id="s256-d64-causal-g4"),
    pytest.param(1, 128, 256, 4, 1, 64, False, id="sq128-skv256-d64-full-g4"),
]


def _arrays(seed, B, Sq, Skv, H, Hkv, D):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(B, Sq, H, D), f(B, Skv, Hkv, D), f(B, Skv, Hkv, D), f(B, Sq, H, D)


def _jax_bf16(*xs):
    return [jnp.asarray(x).astype(jnp.bfloat16) for x in xs]


def _torch_bf16(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16) for x in xs]


def _close(actual, expected, what, tol=BF16_TOL):
    a = actual.float().numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual, np.float32)
    np.testing.assert_allclose(a, np.asarray(expected, np.float32), err_msg=what, **tol)


@pytest.mark.parametrize("seed", [3, 0])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", CASES)
def test_flash_fwd_plain_matches_pallas_bf16(B, Sq, Skv, H, Hkv, D, causal, seed):
    q, k, v, _ = _arrays(seed, B, Sq, Skv, H, Hkv, D)
    j_out, j_lse8 = jpa._flash_fwd_impl(*_jax_bf16(q, k, v), causal=causal, interpret=True)
    j_lse = np.asarray(j_lse8)[:, 0, :].reshape(B, H, Sq)
    out, lse = tfa.flash_fwd_plain(*_torch_bf16(q, k, v), causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, j_out, "out")
    _close(lse, j_lse, "lse", LSE_TOL)


@pytest.mark.parametrize("seed", [3, 1])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", CASES)
def test_flash_bwd_plain_matches_pallas_bf16(B, Sq, Skv, H, Hkv, D, causal, seed):
    q, k, v, do = _arrays(seed, B, Sq, Skv, H, Hkv, D)
    jq, jk, jv, jdo = _jax_bf16(q, k, v, do)
    j_out, j_lse8 = jpa._flash_fwd_impl(jq, jk, jv, causal=causal, interpret=True)
    j_dq, j_dk, j_dv = jpa._bwd(causal, True, (jq, jk, jv, j_out, j_lse8), jdo)
    lse = torch.from_numpy(np.array(j_lse8)[:, 0, :].reshape(B, H, Sq))
    tq, tk, tv, tout, tdo = _torch_bf16(q, k, v, j_out, do)
    dq, dk, dv = tfa.flash_bwd_plain(tq, tk, tv, tout, lse, tdo, causal)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    _close(dq, j_dq, "dq")
    _close(dk, j_dk, "dk")
    _close(dv, j_dv, "dv")


def test_rounding_is_identity_in_f32():
    """For f32 inputs the rounding changes nothing: the plain versions give
    the unrounded f32 formulas bit for bit."""
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(5, 1, 64, 96, 4, 2, 32))
    out, lse = tfa.flash_fwd_plain(q, k, v, True)
    s = tfa._scores(q, k, True)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", p, tfa._expand_kv(v, 4)) / p.sum(-1).transpose(1, 2)[..., None]
    assert torch.equal(out, want)
    delta = tfa.attention_delta(out, do)
    p, ds = tfa._p_ds(q, k, v, do, lse, delta, True)
    dv = tfa._group_sum(torch.einsum("bhqk,bqhd->bkhd", p, do), 2)
    assert torch.equal(tfa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True)[1], dv)
