"""Session-affinity router: the fleet's front door.

Copy of ``distributeddataparallel_tpu/serving/router.py``.  One
:class:`Router` stands in front of N engines (a prefill tier and a decode
tier) and makes the three host-side decisions the fleet needs per request,
on plain host data (no tensor, no device):

- **admission** — fresh requests go to the least-outstanding-tokens
  engine of each tier (outstanding = prompt + budget tokens of every
  request currently owned), the serving analog of least-loaded;
- **session affinity** — multi-turn follow-ups extend their prior
  prompt, so their first KV block is content-identical to the turn
  before; the router keys on the radix trie's root-level block hash
  (the same FNV-1a chain ``kv_cache.block_hash`` uses) and pins the
  session to the decode engine already holding those prefix-cache
  blocks.  An affinity hit skips the prefill tier entirely — the home
  engine's own prefix cache serves the shared context;
- **health** — engines heartbeat; silence crosses a *suspect* rung
  (``gang_suspect``, same hysteresis shape as ``rendezvous.py``) before
  the timeout tombstones the engine.  Death drains the engine's
  outstanding requests for requeue and records the degradation rung as
  an ``engine_verdict`` (``drain`` while the tier has survivors,
  ``fail`` when it does not), the serving counterpart of the launcher's
  ``gang_verdict``.

The router deals in plain dict records and engine *names*; moving the
bytes (submit RPCs, KV handoff frames) is ``serving.fleet``'s job.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from distributeddataparallel_tpu_torch.serving.handoff import verdict_rung

#: FNV-1a 64-bit offset basis / prime: MUST match
#: ``serving.kv_cache.block_hash`` (the affinity key is the trie's
#: root-level child hash).
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


class RouterError(RuntimeError):
    """No engine can take the request (tier empty or all dead)."""


def root_block_hash(tokens, block_size: int):
    """Affinity key of a prompt: the radix trie's root-level block hash
    over the first ``block_size`` tokens (bitwise the same value
    ``kv_cache.block_hash(_ROOT_HASH, chunk)`` yields), or the raw
    token tuple for prompts shorter than one block."""
    toks = [int(t) for t in tokens]
    if len(toks) < block_size:
        return tuple(toks)
    h = _FNV_OFFSET
    for t in toks[:block_size]:
        h = ((h ^ (t + 1)) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h


class _EngineState:
    __slots__ = (
        "name", "tier", "alive", "suspect", "last_beat_s",
        "outstanding", "outstanding_tokens",
    )

    def __init__(self, name: str, tier: str, now: float):
        self.name = name
        self.tier = tier
        self.alive = True
        self.suspect = False
        self.last_beat_s = now
        self.outstanding: dict[Any, dict] = {}  # fid -> route record
        self.outstanding_tokens = 0


class Router:
    """Admission + affinity + health over named engines.

    ``time_fn`` is injectable (virtual clock in tests); ``events`` is
    an ``EventLog`` or None.  Heartbeat hysteresis: an engine silent
    for ``suspect_after_s`` (default half the timeout) is *suspected*
    (one ``gang_suspect`` event, still routable); silent past
    ``heartbeat_timeout_s`` it is tombstoned and drained.
    """

    def __init__(
        self,
        *,
        block_size: int,
        heartbeat_timeout_s: float = 2.0,
        suspect_after_s: float | None = None,
        events=None,
        time_fn: Callable[[], float] = time.monotonic,
    ):
        self.block_size = int(block_size)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.suspect_after_s = (
            0.5 * self.heartbeat_timeout_s
            if suspect_after_s is None else float(suspect_after_s)
        )
        self.events = events
        self._time = time_fn
        self.engines: dict[str, _EngineState] = {}
        self._affinity: dict[Any, str] = {}  # root hash -> decode engine
        self.routed = 0
        self.affinity_hits = 0

    def emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    # -- membership ---------------------------------------------------
    def register_engine(self, name: str, tier: str) -> None:
        if tier not in ("prefill", "decode"):
            raise ValueError(f"unknown tier {tier!r}")
        self.engines[name] = _EngineState(name, tier, self._time())

    def alive_engines(self, tier: str) -> list[str]:
        return sorted(
            e.name for e in self.engines.values()
            if e.alive and e.tier == tier
        )

    def _least_loaded(self, tier: str) -> str | None:
        best = None
        for name in self.alive_engines(tier):  # sorted: ties stay
            eng = self.engines[name]           # deterministic
            if best is None or (
                eng.outstanding_tokens
                < self.engines[best].outstanding_tokens
            ):
                best = name
        return best

    @property
    def queue_depth(self) -> int:
        return sum(len(e.outstanding) for e in self.engines.values())

    # -- admission ----------------------------------------------------
    def affinity_key(self, prompt):
        return root_block_hash(prompt, self.block_size)

    def route(
        self, fid, prompt, max_new_tokens: int, *, session=None,
        trace: dict | None = None,
    ) -> dict:
        """Decide owners for one request; returns the route record
        (``prefill`` is None on an affinity hit — the home decode
        engine serves the whole request from its prefix cache).

        ``trace`` is the request's root span-context fields — carried
        on the route record (so drain/requeue keeps the trace) and
        stamped onto the ``route_admit`` event as plain data."""
        key = self.affinity_key(prompt)
        home = self._affinity.get(key)
        affinity = home is not None and self.engines[home].alive
        decode = home if affinity else self._least_loaded("decode")
        if decode is None:
            raise RouterError("no live decode engine")
        prefill = None if affinity else self._least_loaded("prefill")
        self._affinity[key] = decode
        record = {
            "fid": fid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "session": session,
            "decode": decode,
            "prefill": prefill,
            "tokens": len(prompt) + int(max_new_tokens),
            "trace": trace,
        }
        owner = prefill or decode
        eng = self.engines[owner]
        eng.outstanding[fid] = record
        eng.outstanding_tokens += record["tokens"]
        self.routed += 1
        if affinity:
            self.affinity_hits += 1
        # Membership annotation (trace + root span, no parent edge):
        # the admission decision belongs to the request's root span.
        tfields = {
            k: trace[k] for k in ("trace", "span")
            if isinstance(trace, dict) and trace.get(k)
        }
        self.emit(
            "route_admit",
            req=fid,
            engine=decode,
            prefill=prefill,
            affinity=affinity,
            session=session,
            queue_depth=self.queue_depth,
            **tfields,
        )
        return record

    def handoff_done(self, fid) -> dict:
        """Move ownership prefill → decode once the KV blocks landed."""
        for eng in self.engines.values():
            if eng.tier == "prefill" and fid in eng.outstanding:
                record = eng.outstanding.pop(fid)
                eng.outstanding_tokens -= record["tokens"]
                home = self.engines[record["decode"]]
                home.outstanding[fid] = record
                home.outstanding_tokens += record["tokens"]
                return record
        raise KeyError(f"fid {fid!r} not outstanding on any prefill engine")

    def complete(self, fid) -> dict | None:
        """Drop a finished request from whichever engine owns it (None
        when already gone — e.g. completed after a drain requeued it)."""
        for eng in self.engines.values():
            if fid in eng.outstanding:
                record = eng.outstanding.pop(fid)
                eng.outstanding_tokens -= record["tokens"]
                return record
        return None

    # -- health -------------------------------------------------------
    def heartbeat(self, name: str) -> None:
        eng = self.engines[name]
        eng.last_beat_s = self._time()
        eng.suspect = False

    def check(self) -> list[dict]:
        """Advance the health state machine; returns the route records
        drained off engines that just died (the caller requeues them
        through :meth:`route`)."""
        drained: list[dict] = []
        now = self._time()
        for eng in list(self.engines.values()):
            if not eng.alive:
                continue
            age = now - eng.last_beat_s
            if age >= self.heartbeat_timeout_s:
                drained.extend(self.mark_dead(eng.name, reason="heartbeat"))
            elif age >= self.suspect_after_s and not eng.suspect:
                eng.suspect = True
                self.emit("gang_suspect", member=eng.name, age_s=age)
        return drained

    def mark_dead(self, name: str, *, reason: str = "dead") -> list[dict]:
        """Tombstone an engine (EOF, kill signal, or heartbeat timeout)
        and drain its outstanding requests for requeue.  Purges affinity
        entries pointing at it — follow-ups re-pin to whichever engine
        re-serves the session."""
        eng = self.engines[name]
        if not eng.alive:
            return []
        eng.alive = False
        drained = list(eng.outstanding.values())
        eng.outstanding.clear()
        eng.outstanding_tokens = 0
        for key in [k for k, v in self._affinity.items() if v == name]:
            del self._affinity[key]
        # rung names: handoff.VERDICT_RUNGS, the reference's declared
        # protocol ladder that scripts/check_events.py --conformance replays
        rung = verdict_rung(bool(self.alive_engines(eng.tier)))
        self.emit(
            "engine_verdict",
            engine=name,
            rung=rung,
            tier=eng.tier,
            requeued=len(drained),
            reason=reason,
        )
        return drained
