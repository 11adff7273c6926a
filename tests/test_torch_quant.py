"""The port's int8 weight-only quantization (``ops/quant.py``) against the
JAX package's, on the CPU.

- ``quantize_int8`` / ``quantize_for_decode`` give the same tree as the
  reference's jitted quantization (``quantize_int8_jit``, what its decode
  path runs), bit for bit in both ``q`` and ``scale``: both compute the
  absmax in f32, scale it by the f32 reciprocal of 127 (XLA's rewrite of
  the division by a constant), divide in f32 and round half to even, over
  the same scale groups, so no tolerance is needed.  Held on a model's
  params in both layer layouts and on loose leaves whose shapes walk
  ``_scale_reduce_axes``' coarsening.
- Leaf selection (``MIN_QUANT_ELEMS``, rank, dtype), ``dequantize`` (the
  f32 product, then the cast: bit-equal in f32 and bf16), the row lookup
  the decode twin uses for embeddings, and ``quantized_bytes``.
- ``models.io.jax_layout``, the reference-layout tree the port quantizes,
  equals ``to_jax_params`` of the same model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.ops import quant as jq
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.models.io import from_jax_params, jax_layout, to_jax_params
from distributeddataparallel_tpu_torch.ops import quant as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# Sizes at which the embedding (512 x 64) and the MLP (64 x 256) reach
# MIN_QUANT_ELEMS and the attention projections do not.
KW = dict(vocab_size=512, num_layers=2, num_heads=4, d_model=64, d_ff=256, max_seq_len=32)


def _jax_params(scan: bool):
    cfg = jtfm.tiny_lm(scan_layers=scan, num_kv_heads=2, tie_embeddings=False, **KW)
    params = jtfm.TransformerLM(cfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 4), jnp.int32))["params"]
    return cfg, params


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_same(jtree, ttree, path=""):
    """Same structure; QuantLeaf q and scale bit-equal; other leaves equal."""
    if isinstance(jtree, jq.QuantLeaf):
        assert isinstance(ttree, tq.QuantLeaf), path
        np.testing.assert_array_equal(ttree.q.numpy(), np.asarray(jtree.q), err_msg=path)
        np.testing.assert_array_equal(ttree.scale.numpy(), np.asarray(jtree.scale), err_msg=path)
        assert ttree.q.dtype == torch.int8 and ttree.scale.dtype == torch.float32
        return
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_same(jtree[k], ttree[k], f"{path}/{k}")
        return
    assert not isinstance(ttree, tq.QuantLeaf), path
    np.testing.assert_array_equal(np.asarray(ttree.float() if ttree.dtype == torch.bfloat16 else ttree),
                                  np.asarray(jnp.asarray(jtree, jnp.float32) if jtree.dtype == jnp.bfloat16
                                             else jtree), err_msg=path)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_quantize_for_decode_is_bit_equal(scan):
    _, params = _jax_params(scan)
    jtree = jq.quantize_for_decode(params, scan)
    ttree = tq.quantize_for_decode(_to_torch(params), scan)
    assert jq.is_quantized(jtree) and tq.is_quantized(ttree)
    _assert_same(jtree, ttree)


def test_scale_groups_walk_the_coarsening_bit_equal():
    """Loose leaves: stacked and unstacked, rank 2-4, shapes where the
    coarsening keeps, drops one and drops every kept axis; values spanning
    orders of magnitude per layer."""
    rng = np.random.default_rng(0)
    shapes = [(64, 300), (300, 64), (32, 4, 128), (4, 16, 64), (3, 128, 4, 16), (2, 64, 256),
              (130, 130), (8, 2048), (3, 64, 8, 32)]
    for stacked in (False, True):
        for shape in shapes:
            assert jq._scale_reduce_axes(shape, stacked) == tq._scale_reduce_axes(shape, stacked)
            x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 3, size=(shape[0],) + (1,) * (len(shape) - 1)))
            x = x.astype(np.float32)
            jt = jq.quantize_int8_jit({"w": jnp.asarray(x)}, stacked_first_dim=stacked)
            tt = tq.quantize_int8({"w": torch.from_numpy(x)}, stacked_first_dim=stacked)
            _assert_same(jt, tt, f"{shape} stacked={stacked}")


def test_leaf_selection_matches():
    assert tq.MIN_QUANT_ELEMS == jq.MIN_QUANT_ELEMS
    leaves = {
        "matrix": np.ones((128, 128), np.float32),             # quantized
        "small": np.ones((64, 64), np.float32),                # below MIN_QUANT_ELEMS
        "vector": np.ones((20000,), np.float32),               # rank 1
        "ints": np.ones((200, 200), np.int32),                 # not floating
        "zeros": np.zeros((128, 128), np.float32),             # absmax 0: scale 1/127
    }
    jt = jq.quantize_int8_jit({k: jnp.asarray(v) for k, v in leaves.items()})
    tt = tq.quantize_int8({k: torch.from_numpy(v) for k, v in leaves.items()})
    assert {k for k, v in tt.items() if isinstance(v, tq.QuantLeaf)} == {"matrix", "zeros"}
    _assert_same(jt, tt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_and_bytes_match(dtype):
    """dequantize: q * scale in f32, then one cast to the compute dtype, so
    bit-equal; pass-through float leaves are cast too.  The byte ledgers
    count the same bytes."""
    _, params = _jax_params(True)
    jtree = jq.quantize_for_decode(params, True)
    ttree = tq.quantize_for_decode(_to_torch(params), True)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    _assert_same(jq.dequantize(jtree, jdt), tq.dequantize(ttree, tdt))
    assert tq.quantized_bytes(ttree) == jq.quantized_bytes(jtree)
    assert tq.quantized_bytes(_to_torch(params)) == jq.quantized_bytes(params)


def test_dequantize_rows_is_the_lookup_of_dequantize():
    _, params = _jax_params(False)
    tree = tq.quantize_for_decode(_to_torch(params), False)
    emb = tree["token_embed"]["embedding"]
    assert isinstance(emb, tq.QuantLeaf)
    idx = torch.tensor([[0, 5, 511], [7, 7, 3]])
    want = tq.dequantize(emb, torch.float32)[idx]
    torch.testing.assert_close(tq.dequantize_rows(emb, idx, torch.float32), want, rtol=0, atol=0)


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "stacked"])
def test_jax_layout_equals_to_jax_params(scan):
    """The port's torch-tensor reference layout (views of the model's
    params) is exactly ``to_jax_params``' numpy tree."""
    cfg = ttfm.gpt2_124m(scan_layers=scan, dtype=torch.bfloat16, **{**KW, "max_seq_len": 16})
    model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    want = to_jax_params(model.state_dict(), cfg)
    got = jax_layout(model)

    def same(w, g, path=""):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                same(w[k], g[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)

    same(want, got)
    # and back: the layout round-trips through from_jax_params
    sd = from_jax_params({k: v for k, v in want.items()}, cfg)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)
