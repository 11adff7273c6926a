"""The port's KV handoff (``serving/handoff.py``, the engine's
``extract_handoff`` / ``inject_handoff``) against the JAX package's, on the
CPU.

- Wire bytes: the same numpy-seeded pool contents give the reference's
  ``extract_kv_blocks`` bytes and ``block_nbytes``, byte for byte, for an
  unrolled bf16 pool at 12 layers (the reference's leaves go layer_0,
  layer_1, layer_10, layer_11, layer_2, ...: its dict keys sort), a
  scanned f32 pool (block-major ``(L, bs, H, D)``) and an int8 pool (q
  before scale); those bytes land bitwise through ``unpack_blocks`` ->
  ``set_pool_blocks`` and ``unpack_block_rows`` -> ``set_pool_block``.
- Frames: the port's sender and receiver write the reference's frames for
  the same payload (header, blocks, ACK), over a pipe and a socket pair.
- Integrity: a block corrupted once is NAKed and re-sent alone, and the
  decode stream stays the single engine's; one corrupted on every
  attempt raises ``HandoffError`` after ``MAX_ATTEMPTS`` = 4 deliveries
  and nothing is injected.
- ``extract_handoff`` -> ``inject_handoff`` between two port engines lands
  the blocks bitwise and decodes the single engine's tokens, unrolled and
  scanned; malformed payloads raise the reference's messages.
"""

import importlib
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddataparallel_tpu.models import transformer as jtfm
from distributeddataparallel_tpu.serving import handoff as jh
from distributeddataparallel_tpu.serving import kv_cache as jkv
from distributeddataparallel_tpu_torch.models import transformer as ttfm
from distributeddataparallel_tpu_torch.serving import handoff as th
from distributeddataparallel_tpu_torch.serving import kv_cache as tkv
from distributeddataparallel_tpu_torch.serving.engine import EngineConfig, InferenceEngine

jgen = importlib.import_module("distributeddataparallel_tpu.models.generate")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread, so that parallel test workers do
    not oversubscribe the cores (OpenMP's barriers then stall every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# 12 layers: the lexicographic-order case; 2 kv heads under 4 query heads.
POOLS = {
    "unrolled12_bf16": (dict(vocab_size=64, num_layers=12, num_heads=4, num_kv_heads=2, d_model=32,
                             d_ff=64, max_seq_len=32, dtype="bfloat16"), False),
    "scanned_f32": (dict(vocab_size=64, num_layers=3, num_heads=4, num_kv_heads=2, d_model=32, d_ff=64,
                         max_seq_len=32, scan_layers=True), False),
    "int8": (dict(vocab_size=64, num_layers=3, num_heads=2, d_model=32, d_ff=64, max_seq_len=32), True),
}
N_BLOCKS, BS = 6, 4
ENGINE = dict(num_slots=2, num_blocks=16, block_size=8, prefill_chunk=8)


def _configs(kw):
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    jcfg = jtfm.tiny_lm(attn_impl="xla", dtype=getattr(jnp, dtype), **kw)
    tcfg = ttfm.tiny_lm(attn_impl="plain", dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _seeded_pools(name, monkeypatch):
    """The reference's pool and the port's, holding the same numpy-seeded
    contents: leaf (layer, k|v, q|scale) gets the same values in both.  The
    reference's ``make_pool`` reads only its cache's shapes, so its decode
    twin's init is traced abstractly (``jax.eval_shape``), not run."""
    kw, quant = POOLS[name]
    jcfg, tcfg = _configs(kw)
    init_cache = jgen.init_cache
    monkeypatch.setattr(jgen, "init_cache", lambda m, b: jax.eval_shape(lambda: init_cache(m, b)))
    jpool = jkv.make_pool(jtfm.TransformerLM(jcfg), N_BLOCKS, BS, quantized_kv=quant)
    tpool = tkv.make_pool(ttfm.TransformerLM(tcfg), N_BLOCKS, BS, quantized_kv=quant)
    rng = np.random.default_rng(0)

    def values(shape, dtype):
        if dtype == jnp.int8:
            return rng.integers(-127, 128, shape, dtype=np.int8)
        return rng.standard_normal(shape).astype(np.float32)

    def fill(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        kv = 0 if "cached_key" in keys else 1
        part = keys[-1] if keys[-1] in ("q", "scale") else None
        layers = [int(k[len("layer_"):]) for k in keys if isinstance(k, str) and k.startswith("layer_")]
        x = values(leaf.shape, leaf.dtype)
        for i in (layers or range(tcfg.num_layers)):
            t = tpool[i][kv]
            t = t[part] if part else t
            t.copy_(torch.from_numpy(x if layers else x[i]).to(t.dtype))
        return jnp.asarray(x, leaf.dtype)

    jpool = jax.tree_util.tree_map_with_path(fill, jpool)
    return jpool, tpool, tcfg.scan_layers


@pytest.mark.parametrize("name", list(POOLS))
def test_wire_bytes_are_the_references_and_land_bitwise(name, monkeypatch):
    jpool, tpool, scanned = _seeded_pools(name, monkeypatch)
    ids = [3, 1, 5]
    want = jh.extract_kv_blocks(jpool, ids)
    got = th.extract_kv_blocks(tpool, ids, scanned=scanned)
    assert th.block_nbytes(tpool) == jh.block_nbytes(jpool) == len(want[0])
    assert got == want

    # Batched landing: blocks 3, 1, 5 into 2, 4, 1 of the same pool's twin.
    fresh = [tuple(_clone(leaf) for leaf in pair) for pair in tpool]
    dst = [2, 4, 1]
    tkv.set_pool_blocks(fresh, th.unpack_blocks(fresh, got, scanned=scanned), torch.tensor(dst))
    assert th.extract_kv_blocks(fresh, dst, scanned=scanned) == want
    # One block through set_pool_block.
    tkv.set_pool_block(fresh, th.unpack_block_rows(fresh, want[2], scanned=scanned), 3)
    assert th.extract_kv_blocks(fresh, [3], scanned=scanned) == want[2:]
    with pytest.raises(th.HandoffError, match="block size mismatch"):
        th.unpack_blocks(fresh, [want[0][:-1]], scanned=scanned)


def _clone(leaf):
    return {k: v.clone() for k, v in leaf.items()} if tkv._is_qkv(leaf) else leaf.clone()


class _Record:
    """A channel that keeps every frame it is asked to send."""

    def __init__(self):
        self.frames = []

    def send(self, frame):
        self.frames.append(bytes(frame))

    def try_recv(self):
        return None


def test_frames_are_the_references_over_pipe_and_socket():
    rng = np.random.default_rng(1)
    blocks = [rng.integers(0, 256, 96, dtype=np.uint8).tobytes() for _ in range(3)]
    meta = {"rid": 4, "prompt": [1, 2, 3], "generated": [9], "max_new_tokens": 5, "fid": 7}
    sent = {}
    for pkg in (th, jh):
        chan = _Record()
        pkg.HandoffSender(chan, time_fn=lambda: 0.0).offer(pkg.HandoffPayload(dict(meta), list(blocks)))
        sent[pkg] = chan.frames
    assert sent[th] == sent[jh] and len(sent[th]) == 4
    assert th.block_digest(blocks[0]) == jh.block_digest(blocks[0])

    acks = {}
    for pkg in (th, jh):
        a, b = pkg.PipeChannel.pair()
        recv = pkg.HandoffReceiver(b)
        for f in sent[pkg]:
            a.send(f)
        (payload,) = recv.poll()
        assert payload.blocks == blocks and payload.meta == meta
        acks[pkg] = a.try_recv()
    assert acks[th] == acks[jh] == b'{"kind":"ack","hid":0,"bad":[]}'

    # The same frames over TCP framing (a connected socket pair).
    s1, s2 = socket.socketpair()
    tx, rx = th.SocketChannel(s1), th.SocketChannel(s2)
    sender, receiver = th.HandoffSender(tx), th.HandoffReceiver(rx)
    sender.offer(th.HandoffPayload(dict(meta), list(blocks)))
    got = []
    for _ in range(100):
        got += receiver.poll()
        if got:
            break
    (done,) = sender.poll() or [None]
    assert got[0].blocks == blocks and done["attempts"] == 1 and done["bytes"] == 288
    tx.close()
    rx.close()


@pytest.fixture(scope="module")
def model():
    cfg = ttfm.tiny_lm(attn_impl="plain", vocab_size=97, num_layers=2, num_heads=2, d_model=32, d_ff=64,
                       max_seq_len=64, positional="learned", norm="layernorm", activation="gelu")
    return ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(0))


def _prefilled(model, prompt, **over):
    eng = InferenceEngine(model, EngineConfig(**{**ENGINE, **over}))
    rid = eng.submit(prompt, 1)
    eng.run()
    return eng, rid


def _single(model, prompt, n, **over):
    eng = InferenceEngine(model, EngineConfig(**{**ENGINE, **over}))
    rid = eng.submit(prompt, n)
    eng.run()
    return list(eng.completed[rid].generated)


class _FlipOnce:
    """Channel wrapper that flips one byte of the ``nth`` send, once."""

    def __init__(self, chan, nth):
        self._chan, self._nth, self._sends = chan, nth, 0

    def send(self, frame):
        self._sends += 1
        if self._sends == self._nth or self._nth == "blocks" and len(frame) > 512:
            frame = bytearray(frame)
            frame[len(frame) // 2] ^= 0xFF
        self._chan.send(bytes(frame))

    def __getattr__(self, name):
        return getattr(self._chan, name)


def test_corrupted_block_is_resent_alone_and_a_dead_link_raises(model):
    prompt = np.random.default_rng(2).integers(1, 97, 21).tolist()  # 3 blocks of 8
    prefill, rid = _prefilled(model, prompt)
    payload = prefill.extract_handoff(rid, max_new_tokens=8)
    assert len(payload.blocks) == 3 and payload.meta["generated"] == _single(model, prompt, 1)

    a, b = th.PipeChannel.pair()
    sender, receiver = th.HandoffSender(_FlipOnce(a, 3), time_fn=lambda: 0.0), th.HandoffReceiver(b)
    sender.offer(payload)                  # frame 3 is block 1
    assert receiver.poll() == [] and receiver.rejected_blocks == 1
    assert sender.poll() == [] and sender.redelivered_blocks == 1   # NAK of [1]: block 1 re-sent alone
    (got,) = receiver.poll()
    (rec,) = sender.poll()
    assert got.blocks == payload.blocks and rec["attempts"] == 2 and sender.in_flight == 0
    decode = InferenceEngine(model, EngineConfig(**ENGINE))
    new = decode.inject_handoff(got)
    decode.run()
    assert list(decode.completed[new].generated) == _single(model, prompt, 8)

    a, b = th.PipeChannel.pair()
    sender, receiver = th.HandoffSender(_FlipOnce(a, "blocks")), th.HandoffReceiver(b)
    sender.offer(payload)
    with pytest.raises(th.HandoffError, match="still corrupt after 4 attempts"):
        for _ in range(th.MAX_ATTEMPTS + 1):
            assert receiver.poll() == []   # every delivery rejected: nothing to inject
            sender.poll()
    assert receiver.received == 0 and receiver.rejected_blocks == 3 * th.MAX_ATTEMPTS


@pytest.mark.parametrize("layout", ["unrolled", "scanned_int8"])
def test_extract_inject_between_engines_lands_bitwise(layout, model):
    if layout == "scanned_int8":
        cfg = ttfm.tiny_lm(attn_impl="plain", vocab_size=97, num_layers=3, num_heads=4, num_kv_heads=2,
                           d_model=32, d_ff=64, max_seq_len=64, scan_layers=True)
        model = ttfm.TransformerLM(cfg, generator=torch.Generator().manual_seed(1))
    over = {"quantized_kv": True} if layout == "scanned_int8" else {}
    prompt = np.random.default_rng(3).integers(1, 97, 16).tolist()  # block-exact
    prefill, rid = _prefilled(model, prompt, **over)
    src = list(prefill.completed[rid].final_blocks)
    scanned = model.cfg.scan_layers
    shipped = th.extract_kv_blocks(prefill.pool, src, scanned=scanned)
    decode = InferenceEngine(model, EngineConfig(**ENGINE, **over))
    decode.submit(np.arange(1, 12), 2)      # occupy some blocks first
    decode.step()
    new = decode.inject_handoff(prefill.extract_handoff(rid, max_new_tokens=6))
    landed = decode.allocator.table_of(new)[:len(src)]
    assert landed != src and decode.handoffs_in == 1
    assert th.extract_kv_blocks(decode.pool, landed, scanned=scanned) == shipped
    decode.run()
    assert decode.completed[new].handoff
    assert list(decode.completed[new].generated) == _single(model, prompt, 6, **over)


def test_malformed_payloads_raise_the_references_messages(model):
    prompt = list(range(1, 14))
    prefill, rid = _prefilled(model, prompt)
    payload = prefill.extract_handoff(rid, max_new_tokens=4)
    decode = InferenceEngine(model, EngineConfig(**ENGINE))
    with pytest.raises(th.HandoffError, match="carries no pending token"):
        decode.inject_handoff(th.HandoffPayload({**payload.meta, "generated": []}, payload.blocks))
    with pytest.raises(th.HandoffError, match="needs 2 blocks, payload ships 1"):
        decode.inject_handoff(th.HandoffPayload(payload.meta, payload.blocks[:1]))
    with pytest.raises(th.HandoffError, match="exceeds max_seq_len 64"):
        decode.inject_handoff(th.HandoffPayload({**payload.meta, "max_new_tokens": 60}, payload.blocks))
    assert not decode.has_work()
    with pytest.raises(KeyError):
        prefill.extract_handoff(rid)        # the request left with its first extraction
