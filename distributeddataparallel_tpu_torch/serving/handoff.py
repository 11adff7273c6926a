"""KV-block handoff between a prefill-tier and a decode-tier engine.

Counterpart of ``distributeddataparallel_tpu/serving/handoff.py``.  The
disaggregated fleet (``serving.fleet``) runs chunked prefill to completion
on one engine, then ships the sequence's KV blocks to a decode engine that
owns the token stream from there on.  This module is the wire layer of
that move:

- **extraction**: one gather per pool leaf of exactly the blocks the
  sequence owns, concatenated on the device into one ``(n, block_nbytes)``
  byte tensor and copied once to pinned host memory (``extract_kv_blocks``);
- **landing**: the received blocks are written once into a pinned buffer,
  go to the device as one byte tensor and are cut into the pool's leaves
  there (``unpack_blocks``), which ``kv_cache.set_pool_blocks`` lands in
  one write per leaf;
- **framing**: length-prefixed frames over either an in-memory
  ``PipeChannel`` pair (deterministic single-process fleets, tests) or a
  ``SocketChannel`` over TCP with ``RetryPolicy`` backoff on connect
  (``serve --fleet`` multi-process mode);
- **integrity**: a per-block sha256 digest rides in the header frame; the
  receiver NAKs the indices that fail verification and the sender re-ships
  only those blocks, up to ``MAX_ATTEMPTS`` deliveries, so a corrupted
  frame costs a retry, never silent divergence of the decode stream.

**Wire bytes.** A block's bytes are the reference's for the same pool
contents, so ``block_nbytes``, the frames and the digests agree across the
two packages.  The reference serializes its cache pytree's leaves in
``jax.tree.leaves`` order: dict keys sorted, so unrolled layers (named
``layer_{i}``) go ``layer_0, layer_1, layer_10, layer_11, layer_2, ...``;
within a layer ``cached_key`` before ``cached_value``; within an int8 leaf
``q`` before ``scale``.  Scanned pools hold two leaves, k and v, each
``(L, N, bs, H, D)``, shipped block-major as ``(L, bs, H, D)`` a block.
The port's pool is a per-layer list of ``(k, v)``, the scanned one a list
of views of the stacked tensors (``kv_cache.make_pool``); ``scanned=``
says which order applies.

Sender and receiver are poll-driven state machines (no thread blocks
waiting for an ACK), so the same protocol runs synchronously inside one
process and asynchronously across processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import select
import socket
import struct
from collections import deque
from typing import Callable

import numpy as np
import torch

# The redelivery budget and the verdict rungs are the protocol checker's
# own objects (``analysis.protocol``): the plan it explores is the plan
# that runs (``serving.router.Router.mark_dead`` consults the rungs).
from distributeddataparallel_tpu_torch.analysis.protocol import (  # noqa: F401
    HANDOFF_MAX_ATTEMPTS,
    VERDICT_RUNGS,
    verdict_rung,
)
from distributeddataparallel_tpu_torch.runtime.retry import RetryPolicy, retry_call
from distributeddataparallel_tpu_torch.serving.kv_cache import _is_qkv

MAX_ATTEMPTS = HANDOFF_MAX_ATTEMPTS

_LEN = struct.Struct(">I")


class HandoffError(RuntimeError):
    """A handoff could not be completed (redelivery budget exhausted or a
    protocol frame arrived out of order)."""


def block_digest(data: bytes) -> str:
    """Integrity digest of one block's wire bytes (truncated sha256:
    collision resistance is irrelevant, corruption detection is not)."""
    return hashlib.sha256(data).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Block serialization
# ---------------------------------------------------------------------------


def _wire_leaves(pool: list, scanned: bool) -> list[list[torch.Tensor]]:
    """The reference's leaves in its wire order, each as the port's
    per-layer tensors ``(N, bs, H, D)``: one per unrolled leaf, the ``L``
    layers of a scanned one (module docstring)."""
    def parts(leaf):
        return [leaf["q"], leaf["scale"]] if _is_qkv(leaf) else [leaf]

    if scanned:
        return [list(group) for j in (0, 1)
                for group in zip(*(parts(pair[j]) for pair in pool))]
    return [[t] for i in sorted(range(len(pool)), key=str)
            for j in (0, 1) for t in parts(pool[i][j])]


def _group_nbytes(group: list[torch.Tensor]) -> int:
    return len(group) * math.prod(group[0].shape[1:]) * group[0].element_size()


def block_nbytes(pool: list) -> int:
    """Wire bytes of one block across every pool leaf."""
    return sum(_group_nbytes(g) for g in _wire_leaves(pool, False))


def extract_kv_blocks(pool: list, block_ids, *, scanned: bool = False) -> list[bytes]:
    """Pull exactly ``block_ids`` out of the pool as per-block wire bytes:
    one gather per leaf, one byte tensor on the device, one copy to the
    host (the whole transfer cost of a handoff)."""
    groups = _wire_leaves(pool, scanned)
    ids = torch.as_tensor(list(block_ids), dtype=torch.long).to(groups[0][0].device)
    n = int(ids.numel())
    if n == 0:
        return []
    cols = [torch.stack([t.index_select(0, ids) for t in group], dim=1).reshape(n, -1).view(torch.uint8)
            for group in groups]
    dev = torch.cat(cols, dim=1)
    host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=dev.is_cuda)
    host.copy_(dev)  # synchronous: the bytes are read next
    return [row.tobytes() for row in host.numpy()]


def unpack_blocks(pool: list, blocks: list[bytes], *, scanned: bool = False) -> list:
    """The rows ``kv_cache.set_pool_blocks`` lands, from ``blocks``' wire
    bytes: a per-layer list of ``(k, v)`` with a leading block axis, on the
    receiving pool's device, cut by the *receiving* pool's leaf shapes and
    dtypes (both tiers run the same model config).  One host-to-device
    copy for the whole handoff; the bytes are raw pool content, never
    re-quantized."""
    want = block_nbytes(pool)
    for data in blocks:
        if len(data) != want:
            raise HandoffError(
                f"handoff block size mismatch: {len(data)} wire bytes for a "
                f"{want}-byte pool block (tier configs differ?)"
            )
    n = len(blocks)
    groups = _wire_leaves(pool, scanned)
    first = groups[0][0]
    buf = torch.empty((n, want), dtype=torch.uint8, pin_memory=first.is_cuda)
    rows = buf.numpy()
    for i, data in enumerate(blocks):
        rows[i] = np.frombuffer(data, np.uint8)
    if first.is_cuda:
        buf = buf.to(first.device, non_blocking=True)
    cut: dict[int, torch.Tensor] = {}  # id of a pool tensor -> its (n, bs, H, D) rows
    off = 0
    for group in groups:
        size = _group_nbytes(group)
        t = group[0]
        rows = buf[:, off:off + size].contiguous().view(t.dtype).view(n, len(group), *t.shape[1:])
        for layer, tensor in enumerate(group):
            cut[id(tensor)] = rows[:, layer]
        off += size

    def one(leaf):
        if _is_qkv(leaf):
            return {"q": cut[id(leaf["q"])], "scale": cut[id(leaf["scale"])]}
        return cut[id(leaf)]

    return [(one(k), one(v)) for k, v in pool]


def unpack_block_rows(pool: list, data: bytes, *, scanned: bool = False) -> list:
    """The ``rows`` ``kv_cache.set_pool_block`` expects (block axis
    dropped) from one block's wire bytes."""
    def first(leaf):
        return {k: v[0] for k, v in leaf.items()} if _is_qkv(leaf) else leaf[0]

    return [(first(k), first(v)) for k, v in unpack_blocks(pool, [data], scanned=scanned)]


# ---------------------------------------------------------------------------
# Channels: framed byte transport
# ---------------------------------------------------------------------------


class PipeChannel:
    """In-memory framed channel: one direction of a ``pair()``.

    Deterministic and buffer-unbounded, so a single-process fleet can push
    a whole handoff and pump the receiving end in the same step without OS
    socket buffering in the loop.
    """

    def __init__(self):
        self._rx: deque[bytes] = deque()
        self._peer: PipeChannel | None = None
        self.closed = False

    @classmethod
    def pair(cls) -> tuple["PipeChannel", "PipeChannel"]:
        a, b = cls(), cls()
        a._peer, b._peer = b, a
        return a, b

    def send(self, frame: bytes) -> None:
        if self.closed or self._peer is None or self._peer.closed:
            raise ConnectionError("pipe channel closed")
        self._peer._rx.append(bytes(frame))

    def try_recv(self) -> bytes | None:
        return self._rx.popleft() if self._rx else None

    def close(self) -> None:
        self.closed = True


class SocketChannel:
    """Length-prefixed frames over a connected TCP socket.

    Reads are non-blocking (``select`` + reassembly buffer) so an engine
    loop can poll between scheduler steps; writes use ``sendall``.
    """

    def __init__(self, sock: socket.socket):
        sock.setblocking(True)
        sock.settimeout(None)
        self._sock = sock
        self._buf = bytearray()

    @classmethod
    def connect(cls, addr, *, policy: RetryPolicy | None = None) -> "SocketChannel":
        sock = retry_call(
            lambda: socket.create_connection(tuple(addr), timeout=5.0),
            policy=policy or RetryPolicy(attempts=6, base_s=0.1, max_s=1.0),
        )
        return cls(sock)

    def send(self, frame: bytes) -> None:
        self._sock.sendall(_LEN.pack(len(frame)) + frame)

    def try_recv(self) -> bytes | None:
        while True:
            r, _, _ = select.select([self._sock], [], [], 0)
            if not r:
                break
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("handoff peer closed")
            self._buf += chunk
        if len(self._buf) >= _LEN.size:
            (n,) = _LEN.unpack_from(self._buf)
            if len(self._buf) >= _LEN.size + n:
                frame = bytes(self._buf[_LEN.size:_LEN.size + n])
                del self._buf[:_LEN.size + n]
                return frame
        return None

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _json_frame(msg: dict) -> bytes:
    return json.dumps(msg, separators=(",", ":")).encode()


# ---------------------------------------------------------------------------
# Payload + sender/receiver state machines
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HandoffPayload:
    """One sequence's KV move: JSON-safe request metadata (prompt, first
    sampled token, remaining budget, timing) plus the raw block bytes in
    table order."""

    meta: dict
    blocks: list[bytes]

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.blocks)


class HandoffSender:
    """Prefill-tier end: ``offer()`` ships header + block frames,
    ``poll()`` consumes ACK/NAK frames, re-shipping NAKed blocks until the
    redelivery budget runs out."""

    def __init__(self, channel, *, max_attempts: int = MAX_ATTEMPTS,
                 time_fn: Callable[[], float] | None = None):
        import time as _time

        self._chan = channel
        self._max_attempts = int(max_attempts)
        self._time = time_fn or _time.monotonic
        self._pending: dict[int, list] = {}  # hid -> [payload, t0, tries]
        self._next_hid = 0
        self.offered = 0
        self.redelivered_blocks = 0

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def abort_all(self) -> list[dict]:
        """Drop every in-flight handoff (the peer died mid-transfer);
        returns their metas so the caller can requeue the requests."""
        metas = [entry[0].meta for entry in self._pending.values()]
        self._pending.clear()
        return metas

    def offer(self, payload: HandoffPayload) -> int:
        hid = self._next_hid
        self._next_hid += 1
        header = {
            "kind": "handoff",
            "hid": hid,
            "meta": payload.meta,
            "digests": [block_digest(b) for b in payload.blocks],
        }
        self._chan.send(_json_frame(header))
        for b in payload.blocks:
            self._chan.send(b)
        self._pending[hid] = [payload, self._time(), 1]
        self.offered += 1
        return hid

    def poll(self) -> list[dict]:
        """Drain ACK/NAK frames; returns a record per completed handoff
        (``hid``/``meta``/``blocks``/``bytes``/``attempts``/``handoff_s``)."""
        done = []
        while True:
            frame = self._chan.try_recv()
            if frame is None:
                break
            msg = json.loads(frame)
            if msg.get("kind") != "ack" or msg.get("hid") not in self._pending:
                raise HandoffError(f"unexpected sender frame: {msg!r}")
            hid = msg["hid"]
            payload, t0, tries = self._pending[hid]
            bad = msg.get("bad") or []
            if bad:
                if tries >= self._max_attempts:
                    del self._pending[hid]
                    raise HandoffError(
                        f"handoff {hid}: {len(bad)} blocks still corrupt "
                        f"after {tries} attempts"
                    )
                self._chan.send(_json_frame({"kind": "resend", "hid": hid, "indices": bad}))
                for i in bad:
                    self._chan.send(payload.blocks[i])
                self._pending[hid][2] = tries + 1
                self.redelivered_blocks += len(bad)
            else:
                del self._pending[hid]
                done.append({
                    "hid": hid,
                    "meta": payload.meta,
                    "blocks": len(payload.blocks),
                    "bytes": payload.nbytes,
                    "attempts": tries,
                    "handoff_s": self._time() - t0,
                })
        return done


class HandoffReceiver:
    """Decode-tier end: ``poll()`` reassembles header + block frames,
    verifies every block digest, NAKs the bad indices, and yields fully
    verified payloads ready for injection."""

    def __init__(self, channel):
        self._chan = channel
        # hid currently streaming block frames: [hid, expected indices, at]
        self._cursor: list | None = None
        self._inflight: dict[int, dict] = {}
        self.received = 0
        self.rejected_blocks = 0

    def poll(self) -> list[HandoffPayload]:
        out = []
        while True:
            frame = self._chan.try_recv()
            if frame is None:
                break
            if self._cursor is None:
                msg = json.loads(frame)
                hid = msg.get("hid")
                if msg.get("kind") == "handoff":
                    self._inflight[hid] = {
                        "meta": msg["meta"],
                        "digests": msg["digests"],
                        "blocks": [None] * len(msg["digests"]),
                    }
                    want = list(range(len(msg["digests"])))
                elif msg.get("kind") == "resend" and hid in self._inflight:
                    want = list(msg["indices"])
                else:
                    raise HandoffError(f"unexpected receiver frame: {msg!r}")
                self._cursor = [hid, want, 0] if want else None
                if not want:
                    out.extend(self._verify(hid))
            else:
                hid, want, at = self._cursor
                self._inflight[hid]["blocks"][want[at]] = frame
                self._cursor[2] = at + 1
                if self._cursor[2] == len(want):
                    self._cursor = None
                    out.extend(self._verify(hid))
        return out

    def _verify(self, hid: int) -> list[HandoffPayload]:
        entry = self._inflight[hid]
        bad = [i for i, (b, d) in enumerate(zip(entry["blocks"], entry["digests"]))
               if b is None or block_digest(b) != d]
        self._chan.send(_json_frame({"kind": "ack", "hid": hid, "bad": bad}))
        if bad:
            self.rejected_blocks += len(bad)
            return []
        del self._inflight[hid]
        self.received += 1
        return [HandoffPayload(entry["meta"], entry["blocks"])]
