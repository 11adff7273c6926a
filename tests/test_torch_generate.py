"""The port's KV-cache generation (``models/generate.py``, the decode twin
of ``models/transformer.py``) against the JAX package's, on the CPU.

Tiny GPT-2-shaped (learned positions, LayerNorm, GELU, tied head) and
Llama-shaped (RoPE at explicit positions, RMSNorm, SwiGLU, GQA 4/2, untied
head) configs, each in the unrolled and the stacked (``scan_layers``)
layout, from the same JAX params (``from_jax_params``).

- Incremental decode: a contiguous prefill, single-token steps, a per-row
  ``(B, S)`` verify window and a per-row step with the rows at different
  positions; each call's logits equal the port's full forward and the JAX
  decode twin's.  Tolerance: f32 atol 1e-5 (XLA and PyTorch sum the same
  f32 products in different orders, ~1e-7 on these logits; the cache's
  masked rows get exactly zero weight).
- Greedy ``generate`` (dense and int8 weights) gives JAX's ids.  Where an
  id differs, JAX's own top-2 logit gap at that position must be under
  1e-5, so only a true tie passes; the sequences may part after it.
- Sampling draws from a ``torch.Generator``, which cannot reproduce
  ``jax.random.categorical``'s draws: top-k sampling is held to emitting
  only top-k tokens (by the port's teacher-forced logits) and to being
  reproducible under one generator seed.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.ops import quant as jq
from distributeddataparallel_tpu_torch.models import generate as tgen
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.io import from_jax_params
from distributeddataparallel_tpu_torch.ops import quant as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The module (the package exports its ``generate`` function under that name).
jgen = importlib.import_module("distributeddataparallel_tpu.models.generate")

ATOL = 1e-5
TIE = 1e-5
FAMILIES = {
    "gpt2": dict(positional="learned", norm="layernorm", activation="gelu", tie_embeddings=True),
    "llama": dict(num_heads=4, num_kv_heads=2, tie_embeddings=False),
}
SMALL = dict(vocab_size=97, num_layers=2, d_model=32, d_ff=64, max_seq_len=32)
# int8: the embedding (512 x 64) and MLP (64 x 256) reach MIN_QUANT_ELEMS.
QUANT = dict(vocab_size=512, num_layers=2, d_model=64, d_ff=256, max_seq_len=32)


@functools.lru_cache(maxsize=None)
def _pair(family, scan, quant=False):
    kw = {**(QUANT if quant else SMALL), **FAMILIES[family], "scan_layers": scan}
    jmodel = jtfm.TransformerLM(jtfm.tiny_lm(attn_impl="xla", **kw))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    tcfg = ttfm.tiny_lm(attn_impl="plain", **kw)
    tmodel = ttfm.TransformerLM(tcfg)
    tmodel.load_state_dict(from_jax_params(params, tcfg))
    return jmodel, params, tmodel


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decode_logits_match_full_forward_and_jax(family, scan):
    jmodel, params, tmodel = _pair(family, scan)
    toks = np.random.default_rng(1).integers(0, 97, (2, 12)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        full = tmodel(tt)
    jprefill, jdecode = (jax.jit(f) for f in jgen.make_step_fns(jmodel))
    tprefill, tdecode = tgen.make_step_fns(tmodel)
    dm = tgen.decode_model(tmodel)
    P = 5
    jcache = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                          jax.eval_shape(lambda: jgen.init_cache(jmodel, 2)))
    tcache = tgen.init_cache(dm, 2)
    if scan:  # the stacked cache: every layer's pair is a view of one tensor
        assert tcache[0][0].untyped_storage().data_ptr() == tcache[1][0].untyped_storage().data_ptr()

    def both(jfn, tfn, tokens, pos):
        nonlocal jcache
        jl, jcache = jfn(params, jcache, jnp.asarray(tokens), jnp.asarray(pos))
        with torch.no_grad():
            tl, _ = tfn(tcache, torch.from_numpy(np.asarray(tokens)).long(), torch.as_tensor(np.asarray(pos)))
        _close(tl, jl)
        return tl

    _close(both(jprefill, tprefill, toks[:, :P], np.arange(P)), full[:, :P])
    # a contiguous single-token step
    _close(both(jdecode, tdecode, toks[:, P:P + 1], np.array([P]))[:, 0], full[:, P])
    # a per-row verify window, then one whose rows sit at different
    # positions: row 1 re-decodes position 8 (the same token at the same
    # position writes the same KV) while row 0 moves on to 9
    win = np.tile(np.arange(6, 9), (2, 1))
    _close(both(jdecode, tdecode, toks[:, 6:9], win), full[:, 6:9])
    lg = both(jdecode, tdecode, np.stack([toks[0, 9:12], toks[1, 8:11]]), win + np.array([[3], [2]]))
    _close(lg[0], full[0, 9:12])
    _close(lg[1], full[1, 8:11])


def _assert_ids_up_to_ties(jmodel, jparams, jout, tout, P):
    """Equal ids, or the first difference at a true tie of JAX's logits."""
    jout, tout = np.asarray(jout), np.asarray(tout)
    assert jout.shape == tout.shape
    for b in range(jout.shape[0]):
        diff = np.nonzero(jout[b] != tout[b])[0]
        if diff.size == 0:
            continue
        t = int(diff[0])
        assert t >= P, "the prompt must come back unchanged"
        logits = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(jout[b:b + 1, :t])))[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < TIE, (b, t, top2)


@pytest.mark.parametrize("family,scan", [("gpt2", False), ("llama", True)])
def test_greedy_generate_matches_jax(family, scan):
    jmodel, params, tmodel = _pair(family, scan)
    prompt = np.random.default_rng(2).integers(0, 97, (2, 5)).astype(np.int32)
    jout = jgen.generate(jmodel, params, jnp.asarray(prompt), 10)
    tout = tgen.generate(tmodel, torch.from_numpy(prompt), 10)
    assert tout.dtype == torch.long and tuple(tout.shape) == (2, 15)
    _assert_ids_up_to_ties(jmodel, params, jout, tout, 5)


@pytest.mark.parametrize("family,scan", [("gpt2", False), ("llama", True)])
def test_int8_generate_matches_jax(family, scan):
    """int8 weights: the same int8 tree (``test_torch_quant.py``), each
    layer dequantized inside its call; ties judged on JAX's dequantized
    model.  A pre-quantized tree gives the same ids."""
    jmodel, params, tmodel = _pair(family, scan, quant=True)
    prompt = np.random.default_rng(3).integers(0, 512, (2, 6)).astype(np.int32)
    jout = jgen.generate(jmodel, params, jnp.asarray(prompt), 10, quantize="int8")
    tout = tgen.generate(tmodel, torch.from_numpy(prompt), 10, quantize="int8")
    qtree = tgen.quantize_model(tmodel)
    assert isinstance(qtree["token_embed"]["embedding"], tq.QuantLeaf)
    deq = jq.dequantize(jq.quantize_for_decode(params, scan), jnp.float32)
    _assert_ids_up_to_ties(jmodel, deq, jout, tout, 6)
    again = tgen.generate(tmodel, torch.from_numpy(prompt), 10, qparams=qtree)
    torch.testing.assert_close(again, tout, rtol=0, atol=0)


def test_top_k_sampling_stays_in_top_k_and_reproduces():
    _, _, tmodel = _pair("llama", False)
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (3, 4)))
    k = 3

    def sample(seed):
        return tgen.generate(tmodel, prompt, 12, temperature=1.0, top_k=k,
                             generator=torch.Generator().manual_seed(seed))

    out = sample(0)
    with torch.no_grad():
        logits = tmodel(out[:, :-1])[:, 3:]  # the logits each sample was drawn from
    kth = torch.topk(logits, k, dim=-1).values[..., -1]
    chosen = logits.gather(-1, out[:, 4:, None])[..., 0]
    assert bool((chosen >= kth).all())
    torch.testing.assert_close(sample(0), out, rtol=0, atol=0)
    assert not torch.equal(sample(1), out)
    with pytest.raises(ValueError, match="generator"):
        tgen.generate(tmodel, prompt, 4, temperature=1.0)
