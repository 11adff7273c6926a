"""The port's Llama-3 against the JAX package's, on the CPU.

- A tiny Llama-shaped config (RMSNorm, SwiGLU, RoPE θ 500000, GQA 4/2,
  untied head, no biases, remat on; the JAX side in its ``scan_layers``
  layout) in f32 and bf16, through the plain and the kernel attention
  impls: logits, loss and every gradient against the JAX package, from
  the same params (``from_jax_params`` reads the stacked tree).
- The bf16 LM head: the logits are the f32 product of the bf16-rounded
  operands (the reference's ``preferred_element_type=float32``), not a
  bf16 product cast up, tied and untied, and equal the reference's
  ``LMHead``.
- The stacked layout: the port's state_dict -> ``to_jax_params`` -> the
  JAX model's ``apply`` -> ``from_jax_params`` round trip.
- ``llama3_8b`` and ``dpp.build_config`` against the reference's config
  and ``build_model`` (``--d-model``'s kv-head rule, ``--remat``,
  ``--dropout``); the bucket plan keeps Llama's large leaves apart.

Tolerances.  f32: XLA and PyTorch sum in different orders (~1e-7 on these
logits), atol 2e-5 / rtol 1e-4 as in ``test_torch_transformer.py``.
bf16: activations carry 8 bits, and XLA and PyTorch round intermediate
results at different points (e.g. SwiGLU's product, the attention
probabilities), so hidden states differ by an ulp (2^-8 relative) here and
there and that propagates: measured 2.8e-3 on logits of |logit| <= 0.56,
1.2e-4 on the loss and 1.2% of a gradient's largest |value|.  Bounds:
logits 1e-2 absolute, loss 1e-3, each gradient 3e-2 of its largest
|value|.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import dpp as jdpp  # noqa: E402  the reference entry point

from distributeddataparallel_tpu.models import transformer as jtfm  # noqa: E402
from distributeddataparallel_tpu.ops import lm_cross_entropy as j_lm_ce  # noqa: E402
from distributeddataparallel_tpu_torch import dpp as tdpp  # noqa: E402
from distributeddataparallel_tpu_torch.models import transformer as ttfm  # noqa: E402
from distributeddataparallel_tpu_torch.models.io import from_jax_params, to_jax_params  # noqa: E402
from distributeddataparallel_tpu_torch.ops.losses import lm_cross_entropy  # noqa: E402
from distributeddataparallel_tpu_torch.parallel.data_parallel import plan_buckets  # noqa: E402

KW = dict(vocab_size=96, num_layers=2, num_heads=4, num_kv_heads=2, d_model=64, d_ff=128, max_seq_len=24)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _models(dtype: str, attn_impl: str = "plain", **kw):
    jdt, tdt = DTYPES[dtype]
    kw = {**KW, **kw}
    jcfg = jtfm.llama3_8b(attn_impl="xla", dtype=jdt, **kw)
    tcfg = ttfm.llama3_8b(attn_impl=attn_impl, dtype=tdt, **kw)
    tokens = np.random.default_rng(0).integers(0, kw["vocab_size"], size=(3, 17)).astype(np.int32)
    jmodel = jtfm.TransformerLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(tokens[:, :-1]))["params"]
    tmodel = ttfm.TransformerLM(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel, tcfg, tokens


@pytest.mark.parametrize("attn_impl", ["plain", "kernel"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_matches_jax(dtype, attn_impl):
    jmodel, params, tmodel, tcfg, tokens = _models(dtype, attn_impl)
    assert tcfg.remat and tcfg.scan_layers and "layers" in params  # the stacked JAX layout
    inputs, targets = tokens[:, :-1], tokens[:, 1:]

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(inputs))
        return j_lm_ce(logits, jnp.asarray(targets)), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = tmodel(torch.from_numpy(inputs).long())
    loss = lm_cross_entropy(logits, torch.from_numpy(targets).long())
    loss.backward()
    assert logits.dtype == torch.float32
    expected = from_jax_params(j_grads, tcfg)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(expected)
    if dtype == "float32":
        tol = dict(atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **tol)
        np.testing.assert_allclose(float(loss.detach()), float(j_loss), **tol)
        for n in sorted(expected):
            np.testing.assert_allclose(got[n].numpy(), expected[n].numpy(), err_msg=n, **tol)
        return
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), atol=1e-2, rtol=0)
    assert abs(float(loss.detach()) - float(j_loss)) <= 1e-3
    for n in sorted(expected):
        scale = float(expected[n].abs().max())
        assert float((got[n] - expected[n]).abs().max()) <= 3e-2 * scale, n


@pytest.mark.parametrize("tied", [False, True])
def test_bf16_head_is_the_f32_product_of_bf16_operands(tied):
    """The port's bf16 logits are exactly the f32 product of the
    bf16-rounded final hidden state and head weight (a bf16 product cast
    up would leave every logit a bf16 value), and equal the reference's
    ``LMHead`` on the same operands."""
    cfg = ttfm.llama3_8b(**{**KW, "vocab_size": 512}, tie_embeddings=tied)
    model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    seen = {}
    model.final_norm.register_forward_hook(lambda m, i, o: seen.update(x=o))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, size=(2, 16))).long()
    with torch.no_grad():
        logits = model(toks)
    w = model.token_embed.weight if tied else model.lm_head.weight
    x16, w16 = seen["x"].to(torch.bfloat16), w.detach().to(torch.bfloat16)
    want = x16.float() @ w16.float().T
    assert logits.dtype == torch.float32
    assert torch.equal(logits, want)
    assert (logits != logits.to(torch.bfloat16).float()).float().mean() > 0.9
    if not tied:
        head = jtfm.LMHead(512, jnp.bfloat16)
        ref = head.apply({"params": {"kernel": jnp.asarray(w.detach().numpy().T)}},
                         jnp.asarray(seen["x"].float().numpy()).astype(jnp.bfloat16))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)


def test_stacked_layout_round_trip():
    """A port model's state_dict in the stacked layout runs in the JAX
    model (scan_layers) to the port's logits, and comes back unchanged."""
    cfg = ttfm.llama3_8b(**KW, dtype=torch.float32)
    model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(2))
    tree = to_jax_params(model.state_dict(), cfg)
    jmodel = jtfm.TransformerLM(jtfm.llama3_8b(**KW, dtype=jnp.float32, attn_impl="xla"))
    toks = np.random.default_rng(3).integers(0, KW["vocab_size"], size=(2, 16)).astype(np.int32)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(toks))["params"]
    shapes = lambda t: jax.tree.map(lambda a: np.shape(a), jax.tree.map(np.asarray, dict(t)))
    assert shapes(tree) == shapes(init)
    assert tree["layers"]["block"]["attn"]["k_proj"]["kernel"].shape == (2, 64, 2, 16)
    ref = jmodel.apply({"params": tree}, jnp.asarray(toks))
    with torch.no_grad():
        ours = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)
    back = from_jax_params(tree, cfg)
    sd = model.state_dict()
    assert set(back) == set(k for k in sd if "rope" not in k)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k


def test_llama3_8b_config_is_the_references():
    cfg, jcfg = ttfm.llama3_8b(), jtfm.llama3_8b()
    for f in dataclasses.fields(cfg):
        if f.name != "dtype" and hasattr(jcfg, f.name):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    with torch.device("meta"):
        full = ttfm.TransformerLM(ttfm.llama3_8b())
        cut = ttfm.TransformerLM(ttfm.llama3_8b(num_layers=8))
    assert sum(p.numel() for p in full.parameters()) == 8_030_261_248
    assert sum(p.numel() for p in cut.parameters()) == 2_795_573_248


@pytest.mark.parametrize("flags", [
    ["--model", "llama", "--d-model", "64", "--layers", "2"],
    ["--model", "llama", "--d-model", "384", "--remat", "off", "--dropout", "0.1", "--seq-len", "64"],
    ["--model", "gpt2", "--d-model", "32", "--remat", "on", "--vocab-size", "64"],
])
def test_build_config_is_the_references(flags):
    """``dpp.build_config`` makes the reference CLI's config (``--d-model``'s
    head and kv-head rule, ``--remat``, ``--dropout``, ``--seq-len``)."""
    args = ["--device", "cpu", "--dataset", "synthetic-lm", *flags]
    ours = tdpp.build_config(tdpp.parse_args(args))
    ref = jdpp.build_model(jdpp.parse_args(args)).cfg
    for f in dataclasses.fields(ours):
        if f.name != "dtype":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert str(ours.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name


def test_bucket_plan_keeps_llama_leaves_apart():
    """``--bucket-mb`` at Llama-3 8B width (8 layers): every leaf larger than
    a bucket gets a bucket of its own, so no flat buffer holds more than
    one such leaf (the 2.1 GB embedding and head gradients included)."""
    with torch.device("meta"):
        model = ttfm.TransformerLM(ttfm.llama3_8b(num_layers=8))
    sizes = [p.numel() * 4 for p in model.parameters()]
    cap = 25 * 1024 * 1024
    buckets = plan_buckets(sizes, cap)
    assert sorted(i for b in buckets for i in b) == list(range(len(sizes)))
    for b in buckets:
        total = sum(sizes[i] for i in b)
        assert len(b) == 1 or total <= cap
    assert max(sum(sizes[i] for i in b) for b in buckets) == 128256 * 4096 * 4
