"""The port's attention ops against the JAX package's, on the CPU.

RoPE, ``repeat_kv``, ``causal_mask_bias``, ``dot_product_attention`` and the
``attention()`` dispatch are held to the reference's functions; the flash
wrappers take their plain versions only for CPU tensors and refuse inputs
outside the kernels' envelope.  (The plain kernels against the Pallas
kernels: ``test_torch_flash_attention.py``.)  Inputs come from a seeded
numpy generator and go to both packages as numpy arrays.

Tolerance: f32 throughout; the two sides sum in different orders, which
moves results by a few ulps, so atol = rtol = 2e-5.
"""

import importlib

import numpy as np
import pytest
import torch

from distributeddataparallel_tpu_torch.ops import attention as tatt
from distributeddataparallel_tpu_torch.ops import flash_attention as tfa

# The JAX package's ops/__init__ re-exports the function ``attention`` under
# the module's name.
jatt = importlib.import_module("distributeddataparallel_tpu.ops.attention")

TOL = dict(atol=2e-5, rtol=2e-5)


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


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    """The wrappers compute on CPU tensors through the plain versions, and
    refuse any other device instead of falling back."""
    q, k, v, do = _t(*_arrays(3, 1, 64, 64, 2, 1, 16))
    out, lse = tfa.flash_fwd(q, k, v, True)
    ref_out, ref_lse = tfa.flash_fwd_plain(q, k, v, True)
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)
    delta = tfa.attention_delta(out, do)
    assert torch.equal(
        tfa.flash_bwd_dq(q, k, v, do, lse, delta, True),
        tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True),
    )
    meta = [x.to("meta") for x in (q, k, v)]
    with pytest.raises(ValueError, match="devices"):
        tfa.flash_fwd(*meta, True)


@pytest.mark.parametrize(
    "shape_q,shape_kv,msg",
    [
        ((1, 64, 2, 12), (1, 64, 2, 12), "head dim"),   # D % 8
        ((1, 64, 2, 264), (1, 64, 2, 264), "head dim"),  # D > 256
        ((1, 128, 2, 16), (1, 64, 2, 16), "Sq <= Skv"),
        ((1, 64, 3, 16), (1, 64, 2, 16), "multiple of kv heads"),
    ],
)
def test_kernel_envelope_raises(shape_q, shape_kv, msg):
    q = torch.zeros(shape_q)
    k = torch.zeros(shape_kv)
    with pytest.raises(ValueError, match=msg):
        tatt.attention(q, k, k.clone(), impl="kernel")


def test_attention_dispatch_matches_jax_gqa():
    """plain and kernel impls on the CPU both equal the reference's XLA
    attention, GQA included; auto on the CPU takes the plain path even
    outside the kernel envelope (D = 12)."""
    q, k, v, _ = _arrays(4, 2, 32, 32, 4, 2, 16)
    ref = jatt.attention(q, k, v, causal=True, impl="xla")
    for impl in ("plain", "kernel", "auto"):
        _close(tatt.attention(*_t(q, k, v), causal=True, impl=impl), ref, impl)
    q12, k12, v12, _ = _arrays(5, 1, 8, 8, 2, 2, 12)
    _close(
        tatt.attention(*_t(q12, k12, v12), impl="auto"),
        jatt.attention(q12, k12, v12, impl="xla"), "auto-d12",
    )
    with pytest.raises(ValueError, match="unknown attention impl"):
        tatt.attention(*_t(q, k, v), impl="xla")


@pytest.mark.parametrize("causal", [True, False])
def test_dot_product_attention_matches_jax(causal):
    q, k, v, _ = _arrays(6, 2, 12, 20, 3, 3, 8)
    _close(
        tatt.dot_product_attention(*_t(q, k, v), causal=causal),
        jatt.dot_product_attention(q, k, v, causal=causal), "dpa",
    )


def test_causal_mask_bias_and_repeat_kv_match_jax():
    for args, kw in (((5, 9), {}), ((4, 4), dict(q_offset=3, kv_offset=1))):
        np.testing.assert_array_equal(
            tatt.causal_mask_bias(*args, **kw).numpy(),
            np.asarray(jatt.causal_mask_bias(*args, **kw)),
        )
    _, k, _, _ = _arrays(7, 2, 4, 6, 2, 3, 8)
    np.testing.assert_array_equal(
        tatt.repeat_kv(torch.from_numpy(k), 4).numpy(), np.asarray(jatt.repeat_kv(k, 4))
    )


def test_rope_matches_jax():
    """RoPE tables and rotation, over a short sequence and over the whole
    table.  f32 pow/cos/sin differ by ulps between the two libraries and the
    angle error grows with position (up to ~1e-5 rad at position 63 here)."""
    cos, sin = tatt.rope_frequencies(16, 64, theta=500000.0)
    j_cos, j_sin = jatt.rope_frequencies(16, 64, theta=500000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(j_cos), atol=5e-5)
    np.testing.assert_allclose(sin.numpy(), np.asarray(j_sin), atol=5e-5)
    for S in (10, 64):
        x = _arrays(8, 2, S, S, 3, 3, 16)[0]
        np.testing.assert_allclose(
            tatt.apply_rope(torch.from_numpy(x), cos, sin).numpy(),
            np.asarray(jatt.apply_rope(x, j_cos, j_sin)), atol=5e-5,
        )
