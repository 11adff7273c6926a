"""The port's transformer LM against the JAX package's, on the CPU.

JAX-initialized params go through ``from_jax_params``; the same seeded
tokens go through both models (the reference with ``attn_impl="xla"``).
Logits, the LM loss and every parameter gradient must agree.

Tolerance: f32; layer norms, softmax and the matmuls sum in different
orders in XLA and PyTorch, which moves logits by ~1e-6 and gradients by a
few ulps, so atol 2e-5 / rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.ops import lm_cross_entropy as j_lm_ce
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params
from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy

TOL = dict(atol=2e-5, rtol=1e-4)

CONFIGS = {
    # GPT-2 shape: LayerNorm, GELU, learned positions, tied head, MHA.
    "gpt2-2l": ("gpt2_124m", dict(vocab_size=96, num_layers=2, num_heads=2, d_model=32,
                                  d_ff=128, max_seq_len=24)),
    # Llama shape at test size: RMSNorm, SwiGLU, RoPE, GQA (2 q heads per kv).
    "tiny-gqa": ("tiny_lm", dict(num_kv_heads=1, vocab_size=80, max_seq_len=24)),
    # Untied head, no biases, 4 q heads per kv head.
    "tiny-untied": ("tiny_lm", dict(num_heads=4, num_kv_heads=1, tie_embeddings=False,
                                    use_bias=False, vocab_size=80, max_seq_len=24)),
}


def _setup(name, attn_impl):
    family, kw = CONFIGS[name]
    jcfg = getattr(jtfm, family)(attn_impl="xla", **kw)
    tcfg = getattr(ttfm, family)(attn_impl=attn_impl, **kw)
    tokens = np.random.default_rng(0).integers(0, kw["vocab_size"], size=(3, 17)).astype(np.int32)
    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens[:, :-1]))["params"]
    tmodel = ttfm.TransformerLM(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel, tcfg, tokens


@pytest.mark.parametrize("attn_impl", ["auto", "kernel"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_logits_loss_and_grads_match_jax(name, attn_impl):
    """``auto`` is the plain attention on the CPU; ``kernel`` runs the
    FlashAttention function (its kernels' plain versions on the CPU)."""
    jmodel, params, tmodel, tcfg, tokens = _setup(name, attn_impl)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(inputs))
        return j_lm_ce(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tmodel(torch.from_numpy(inputs).long())
    loss = lm_cross_entropy(logits, torch.from_numpy(targets).long())
    loss.backward()
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **TOL)
    expected = from_jax_params(j_grads, tcfg)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(expected)
    for n in sorted(expected):
        np.testing.assert_allclose(got[n].numpy(), expected[n].numpy(), err_msg=n, **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_param_transfer_round_trip(name):
    _, params, tmodel, tcfg, _ = _setup(name, "auto")
    back = to_jax_params(tmodel.state_dict(), tcfg)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        jax.tree.map(np.asarray, dict(params)), back,
    )
