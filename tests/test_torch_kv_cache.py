"""The port's paged KV cache (``serving/kv_cache.py``) against the JAX
package's, on the CPU.

- ``block_hash``, ``kv_pool_bytes`` and ``make_pool``'s leaf shapes (per
  layer; the stacked layout's one ``(L, ...)`` tensor) equal the
  reference's.
- ``gather_block_cache`` and ``scatter_{decode,prefill,spec}`` on the same
  numpy pools give the same dense caches and pools, f32 and int8, in both
  layer layouts.  Pools are compared on every block but the scratch block:
  idle slots, chunk padding and a verify window's overhanging rows all
  land in scratch, where several rows may hit one place in an unspecified
  order (``index_put_`` as XLA's scatter), and scratch is never read
  unmasked.  The reference runs jitted, as its engine does: the values are
  moved, not computed, so they must be equal, and int8 rows quantize as
  ``_quant_rows`` does, bit for bit.
- ``BlockAllocator`` (a copy) under one seeded random sequence of
  ``alloc``, ``alloc_shared``, ``extend``, ``register_progress``,
  ``match_prefix``, ``cow``, ``release`` and ``retire``: the same return
  values, tables, refcounts, evictions and free/cached state after every
  operation, and ``check()`` holds throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.serving import kv_cache as jkv
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.serving import kv_cache as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

L, N, BS, H, D, T = 2, 12, 4, 2, 16, 32  # layers, blocks, block size, kv heads, head dim, max_seq_len
KW = dict(vocab_size=64, num_layers=L, num_heads=4, num_kv_heads=H, d_model=64, d_ff=64, max_seq_len=T)
LAYOUTS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["unrolled", "stacked", "unrolled-int8", "stacked-int8"]


def _leaf(rng, shape, quant):
    if quant:
        return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                "scale": rng.random(shape[:-1] + (1,)).astype(np.float32) + 0.01}
    return rng.standard_normal(shape).astype(np.float32)


def _pools(rng, scan, quant):
    """The same random pool as the reference's pytree and the port's list."""
    if scan:
        k, v = (_leaf(rng, (L, N, BS, H, D), quant) for _ in range(2))
        jpool = {"layers": {"block": {"attn": {"cached_key": k, "cached_value": v}}}}
        per = [(_at(k, i), _at(v, i)) for i in range(L)]
    else:
        per = [tuple(_leaf(rng, (N, BS, H, D), quant) for _ in range(2)) for _ in range(L)]
        jpool = {f"layer_{i}": {"attn": {"cached_key": k, "cached_value": v}} for i, (k, v) in enumerate(per)}
    jpool = jax.tree.map(jnp.asarray, jpool)
    tpool = [tuple(_torch(x) for x in pair) for pair in per]
    return jpool, tpool


def _at(x, i):
    return {k: v[i] for k, v in x.items()} if isinstance(x, dict) else x[i]


def _torch(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


def _per_layer(jtree, scan):
    """The reference's pool/cache pytree as per-layer (k, v) numpy pairs."""
    def one(a, i):
        if isinstance(a, jax.ShapeDtypeStruct):
            return a if i is None else jax.ShapeDtypeStruct(a.shape[1:], a.dtype)
        return np.asarray(a if i is None else a[i])

    def pair(attn, i=None):
        return tuple(jax.tree.map(lambda a: one(a, i), attn[n]) for n in ("cached_key", "cached_value"))

    if scan:
        return [pair(jtree["layers"]["block"]["attn"], i) for i in range(L)]
    return [pair(jtree[f"layer_{i}"]["attn"]) for i in range(L)]


def _assert_pools(jtree, tpool, scan, skip_scratch=True):
    for (jk, jv), (tk, tv) in zip(_per_layer(jtree, scan), tpool):
        for j, t in ((jk, tk), (jv, tv)):
            js, ts = (j, t) if isinstance(j, dict) else ({"x": j}, {"x": t})
            for name in js:
                lo = 1 if skip_scratch else 0
                np.testing.assert_array_equal(ts[name][lo:].numpy(), js[name][lo:], err_msg=name)


def test_hash_bytes_and_pool_shapes_match():
    rng = np.random.default_rng(0)
    h_j = h_t = jkv._ROOT_HASH
    for _ in range(20):
        chunk = rng.integers(0, 50257, BS)
        h_j, h_t = jkv.block_hash(h_j, chunk), tkv.block_hash(h_t, chunk)
        assert h_j == h_t
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        for quant in (False, True):
            for scan in (False, True):
                jcfg = jtfm.tiny_lm(dtype=dt_j, scan_layers=scan, **KW)
                tcfg = ttfm.tiny_lm(dtype=dt_t, scan_layers=scan, **KW)
                assert (tkv.kv_pool_bytes(tcfg, N, BS, quantized_kv=quant)
                        == jkv.kv_pool_bytes(jcfg, N, BS, quantized_kv=quant))
                jshape = jax.eval_shape(lambda: jkv.make_pool(jtfm.TransformerLM(jcfg), N, BS,
                                                              quantized_kv=quant))
                tpool = tkv.make_pool(ttfm.TransformerLM(tcfg), N, BS, quantized_kv=quant)
                for (jk, jv), (tk, tv) in zip(_per_layer(jshape, scan), tpool):
                    for j, t in ((jk, tk), (jv, tv)):
                        js, ts = (j, t) if quant else ({"x": j}, {"x": t})
                        for name in js:
                            assert tuple(ts[name].shape) == tuple(js[name].shape)
                            assert ts[name].dtype == {"int8": torch.int8, "float32": torch.float32,
                                                      "bfloat16": torch.bfloat16}[str(js[name].dtype)]
                if scan:  # one stacked (L, N, bs, H, D) tensor, as the reference's leaf
                    base = tpool[0][0]["q"] if quant else tpool[0][0]
                    assert base.untyped_storage().nbytes() == L * base.numel() * base.element_size()


@pytest.mark.parametrize("scan,quant", LAYOUTS, ids=IDS)
def test_gather_matches(scan, quant):
    rng = np.random.default_rng(1)
    jpool, tpool = _pools(rng, scan, quant)
    tables = rng.integers(0, N, (3, T // BS))
    jd = jkv.gather_block_cache(jpool, jnp.asarray(tables), dtype=jnp.float32)
    td = tkv.gather_block_cache(tpool, torch.from_numpy(tables), dtype=torch.float32)
    for (jk, jv), (tk, tv) in zip(_per_layer(jd, scan), td):
        np.testing.assert_array_equal(tk.numpy(), jk)
        np.testing.assert_array_equal(tv.numpy(), jv)


def _dense(rng, B, scan):
    per = [tuple(rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(2)) for _ in range(L)]
    if scan:
        jd = {"layers": {"block": {"attn": {
            "cached_key": np.stack([p[0] for p in per]), "cached_value": np.stack([p[1] for p in per])}}}}
    else:
        jd = {f"layer_{i}": {"attn": {"cached_key": k, "cached_value": v}} for i, (k, v) in enumerate(per)}
    return jax.tree.map(jnp.asarray, jd), [tuple(torch.from_numpy(x) for x in p) for p in per]


@pytest.mark.parametrize("scan,quant", LAYOUTS, ids=IDS)
def test_scatters_match(scan, quant):
    rng = np.random.default_rng(2)
    B = 3
    # Distinct non-scratch blocks per slot; slot 2 idle (all scratch, pos 0).
    tables = np.zeros((B, T // BS), np.int64)
    tables[0, :4] = [3, 7, 1, 9]
    tables[1, :8] = [2, 4, 5, 6, 8, 10, 11, 1]
    pos = np.array([13, 30, 0])
    checks = []
    jpool, tpool = _pools(rng, scan, quant)
    jdense, tdense = _dense(rng, B, scan)
    jpool = jax.jit(jkv.scatter_decode, static_argnames="block_size")(
        jpool, jdense, jnp.asarray(tables), jnp.asarray(pos), block_size=BS)
    tkv.scatter_decode(tpool, tdense, torch.from_numpy(tables), torch.from_numpy(pos), block_size=BS)
    checks.append((jpool, tpool))
    # prefill: one B=1 chunk of 8 rows from start 20 whose real rows end at
    # 25; and one whose window overhangs the end (start 28), clamped
    for start, limit in ((20, 25), (28, 31)):
        jpool, tpool = _pools(rng, scan, quant)
        jdense, tdense = _dense(rng, 1, scan)
        jpool = jax.jit(jkv.scatter_prefill, static_argnames=("length", "block_size"))(
            jpool, jdense, jnp.asarray(tables[1]), start, 8, limit, block_size=BS)
        tkv.scatter_prefill(tpool, tdense, torch.from_numpy(tables[1]), start, 8, limit, block_size=BS)
        checks.append((jpool, tpool))
    # spec: windows of 4 from each slot's position; slot 1's overhangs T
    jpool, tpool = _pools(rng, scan, quant)
    jdense, tdense = _dense(rng, B, scan)
    jpool = jax.jit(jkv.scatter_spec, static_argnames=("width", "max_seq_len", "block_size"))(
        jpool, jdense, jnp.asarray(tables), jnp.asarray(pos), width=4, max_seq_len=T, block_size=BS)
    tkv.scatter_spec(tpool, tdense, torch.from_numpy(tables), torch.from_numpy(pos), width=4,
                     max_seq_len=T, block_size=BS)
    checks.append((jpool, tpool))
    for jp, tp in checks:
        _assert_pools(jp, tp, scan)


def test_block_copy_and_set_match():
    for scan, quant in ((False, False), (True, True)):
        _copy_and_set(scan, quant)


def _copy_and_set(scan, quant):
    rng = np.random.default_rng(3)
    jpool, tpool = _pools(rng, scan, quant)
    jpool = jkv.copy_pool_block(jpool, 5, 2)
    tkv.copy_pool_block(tpool, 5, 2)
    _assert_pools(jpool, tpool, scan, skip_scratch=False)
    # land two blocks of rows (a handoff's landing half) at 7 and 3
    dst = np.array([7, 3])
    n_rows = [tuple(_leaf(rng, (2, BS, H, D), quant) for _ in range(2)) for _ in range(L)]
    if scan:
        attn = {n: jax.tree.map(lambda *xs: np.stack(xs, axis=1), *[p[j] for p in n_rows])
                for j, n in enumerate(("cached_key", "cached_value"))}
        jrows = {"layers": {"block": {"attn": attn}}}
    else:
        jrows = {f"layer_{i}": {"attn": {"cached_key": k, "cached_value": v}} for i, (k, v) in enumerate(n_rows)}
    jpool = jkv.set_pool_blocks(jpool, jax.tree.map(jnp.asarray, jrows), jnp.asarray(dst))
    tkv.set_pool_blocks(tpool, [tuple(_torch(x) for x in p) for p in n_rows], torch.from_numpy(dst))
    _assert_pools(jpool, tpool, scan, skip_scratch=False)


def test_quant_rows_bit_equal():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 7, H, D)) * 10.0 ** rng.integers(-4, 3, (5, 7, H, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row: the scale floors at _SCALE_EPS
    jq_, js = jax.jit(jkv._quant_rows)(jnp.asarray(x))
    tq_, ts = tkv._quant_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    xb = jnp.asarray(x, jnp.bfloat16)
    jq_, js = jax.jit(jkv._quant_rows)(xb)
    tq_, ts = tkv._quant_rows(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _state(a):
    return (dict(a._tables), dict(a._ref), list(a._free), list(a._cached), dict(a._retired),
            a.evictions, a.evicted_blocks, dict(a._node_of))


def test_allocator_random_sequence_matches():
    rng = np.random.default_rng(5)
    ja, ta = jkv.BlockAllocator(24, 4), tkv.BlockAllocator(24, 4)
    prefixes = [list(rng.integers(0, 20, 12)) for _ in range(3)]
    ids: dict[int, list[int]] = {}
    next_rid = 0
    counts: dict[str, int] = {}
    for _ in range(400):
        op = rng.choice(["alloc", "alloc_shared", "extend", "register", "match", "cow", "release", "retire"])
        live = sorted(ja._tables)
        if op in ("alloc", "alloc_shared"):
            toks = prefixes[rng.integers(3)][: rng.integers(1, 13)] + list(rng.integers(0, 20, rng.integers(0, 9)))
            n = len(toks) + int(rng.integers(1, 4))
            if op == "alloc":
                if not ja.can_alloc(n):
                    continue
                got = (ja.alloc(next_rid, n), ta.alloc(next_rid, n))
            else:
                if not ja.can_alloc_shared(n, toks):
                    continue
                got = (ja.alloc_shared(next_rid, n, toks), ta.alloc_shared(next_rid, n, toks))
            ids[next_rid] = toks
            next_rid += 1
        elif not live:
            continue
        else:
            rid = live[rng.integers(len(live))]
            toks = ids[rid]
            if op == "extend":
                n = len(ja._tables[rid]) * 4 + int(rng.integers(1, 6))
                if not ja.can_extend(rid, n):
                    continue
                got = (ja.extend(rid, n), ta.extend(rid, n))
            elif op == "register":
                upto = int(rng.integers(0, len(toks) + 1))
                got = (ja.register_progress(rid, toks, upto), ta.register_progress(rid, toks, upto))
            elif op == "match":
                q = prefixes[rng.integers(3)][: rng.integers(1, 13)]
                got = (ja.match_prefix(q), ta.match_prefix(q))
            elif op == "cow":
                idx = int(rng.integers(len(ja._tables[rid])))
                if not ja.needs_cow(rid, idx) or ja.free_blocks + ja.evictable_blocks < 1:
                    continue
                got = (ja.cow(rid, idx), ta.cow(rid, idx))
            else:
                got = (getattr(ja, op)(rid), getattr(ta, op)(rid))
        counts[op] = counts.get(op, 0) + 1
        assert got[0] == got[1], op
        assert _state(ja) == _state(ta), op
        ta.check()
    # the sequence reached every kind of operation, shared blocks and evictions
    assert len(counts) == 8 and min(counts.values()) >= 5, counts
    assert ta.evictions > 0
