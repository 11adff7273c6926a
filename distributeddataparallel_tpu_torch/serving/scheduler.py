"""Continuous-batching scheduler: host-side admission / chunking / slots.

One :class:`Scheduler` step produces a :class:`StepPlan` — the mixed
prefill+decode work the engine executes on device this iteration:

1. **Grow running sequences first.**  Each in-flight decode slot whose
   next token crosses a block boundary extends its table; extension has
   priority over admission (new work must never starve sequences
   already holding a slot), and when the pool cannot cover it even
   after eviction the sequence is **preempted**: blocks released, slot
   freed, request requeued at the FRONT of the waiting queue for
   recompute (prefill over prompt + tokens generated so far — the
   recompute-not-swap policy, since there is no host offload tier).
2. **Admit** waiting requests while a slot is free and the allocator
   can cover their context; admission may evict retired (finished)
   sequences' blocks, never live ones.
3. **Schedule at most ``max_prefill_chunks_per_step`` prefill chunks**
   (fixed ``prefill_chunk`` tokens each — one compiled program) across
   admitted-but-not-yet-running requests, FIFO.  Bounding chunks per
   step is the starvation guard: a 10k-token prompt prefills across
   many steps while the decode batch keeps stepping every iteration.
4. **Decode** every running slot (minus this step's preemptions).

Slot accounting is padding-free in the occupancy sense: a slot is
either bound to a live request or idle (scratch table, masked lanes);
``n_active`` in the ``decode_step`` event counts only bound slots, so
occupancy = n_active / num_slots is honest even though the device batch
shape is fixed.

Everything here is plain host bookkeeping over numpy token arrays — no
jax imports, no device values — which is what makes the seeded-loadgen
replay test exactly deterministic.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np


@dataclasses.dataclass
class Request:
    """One inference request and its mutable serving progress."""

    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new_tokens: int
    arrival_s: float = 0.0
    #: Multi-turn session id (router affinity key); None for one-shots.
    session: Any = None

    # Progress (scheduler/engine mutate):
    generated: list[int] = dataclasses.field(default_factory=list)
    prefilled: int = 0          # context tokens whose KV is in the pool
    slot: int = -1              # decode slot while admitted, else -1
    admit_s: float | None = None
    first_token_s: float | None = None
    done_s: float | None = None
    preemptions: int = 0
    prefix_hit_tokens: int = 0  # context tokens served from the cache
    #: Snapshot of the table's context blocks, stashed at finish time —
    #: what a prefill-tier engine ships in a KV handoff (the live table
    #: is gone once the allocator retires the sequence).
    final_blocks: tuple = ()
    #: True when this request's context KV arrived via a prefill→decode
    #: handoff instead of local prefill.
    handoff: bool = False
    #: Trace-context envelope fields as plain data ({"trace", "span",
    #: "parent"}, see observability/tracecontext) — rides the request
    #: across router / handoff / process boundaries; None when the
    #: caller doesn't trace.
    trace: dict | None = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("prompt must have at least one token")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def ctx_len(self) -> int:
        """Tokens whose KV must be resident before decode (re)starts:
        the prompt, plus all generated tokens EXCEPT the last — the
        last generated token is the decode input that inserts its own
        KV on the next step."""
        return self.prompt_len + max(0, len(self.generated) - 1)

    def ctx_tokens(self) -> np.ndarray:
        g = self.generated[:-1]
        if not g:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(g, np.int32)]
        )

    @property
    def next_pos(self) -> int:
        """Global position the NEXT decode step writes (the position of
        the pending token ``generated[-1]``, or of the first sampled
        token when prefill hasn't finished)."""
        return self.prompt_len + max(0, len(self.generated) - 1)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass
class StepPlan:
    """Work for one engine iteration (host decisions only)."""

    admitted: list[Request]
    prefill_chunks: list[tuple[Request, int, int]]  # (req, start, n_tokens)
    decode: list[Request]
    preempted: list[tuple[Request, int]]  # (req, released_blocks)
    evicted: list[tuple[Any, int]]  # (rid, n_blocks) LRU reclaims
    # Copy-on-write ops (req, src_block, dst_block): the engine must
    # copy the pool rows BEFORE executing this plan's prefill/decode —
    # the table already points at dst.
    cow: list[tuple[Request, int, int]] = dataclasses.field(
        default_factory=list
    )

    @property
    def empty(self) -> bool:
        return not (self.prefill_chunks or self.decode)


class Scheduler:
    """Slot + queue state machine over a :class:`BlockAllocator`."""

    def __init__(
        self,
        allocator,
        *,
        num_slots: int,
        prefill_chunk: int,
        max_seq_len: int,
        max_prefill_chunks_per_step: int = 1,
        prefix_cache: bool = False,
        lookahead: int = 0,
    ):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if prefill_chunk < 1 or max_seq_len % prefill_chunk:
            raise ValueError(
                f"prefill_chunk ({prefill_chunk}) must divide "
                f"max_seq_len ({max_seq_len}) so chunk windows never "
                "overrun the positional tables"
            )
        if max_prefill_chunks_per_step < 1:
            raise ValueError("max_prefill_chunks_per_step must be >= 1")
        if not 0 <= lookahead <= max_seq_len - 1:
            raise ValueError(
                f"lookahead ({lookahead}) must be in [0, max_seq_len - 1]"
            )
        self.alloc = allocator
        self.num_slots = num_slots
        self.prefill_chunk = prefill_chunk
        self.max_seq_len = max_seq_len
        self.max_prefill_chunks = max_prefill_chunks_per_step
        # Prefix caching: admission maps the longest registered prefix
        # as shared blocks and skips its prefill.  Lookahead: extra
        # write-window tokens per decode step (speculative verify
        # writes positions [next_pos, next_pos + lookahead]), so table
        # growth and CoW must cover them.
        self.prefix_cache = prefix_cache
        self.lookahead = lookahead
        self.waiting: deque[Request] = deque()
        self.prefilling: list[Request] = []
        self.running: dict[int, Request] = {}  # slot -> Request
        self._free_slots = list(range(num_slots - 1, -1, -1))

    # -- intake -------------------------------------------------------
    def submit(self, req: Request) -> None:
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.prompt_len} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"max_seq_len {self.max_seq_len}"
            )
        if self.alloc.blocks_for(total) > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs "
                f"{self.alloc.blocks_for(total)} blocks, pool holds "
                f"{self.alloc.num_blocks - 1} allocatable — it could "
                "never be admitted"
            )
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.prefilling or self.running)

    # -- planning -----------------------------------------------------
    def _cow_window(
        self,
        req: Request,
        lo_pos: int,
        hi_pos: int,
        cow: list[tuple[Request, int, int]],
        evicted: list[tuple[Any, int]],
    ) -> bool:
        """Make the blocks covering positions ``[lo_pos, hi_pos]``
        privately writable (copy-on-write where shared/registered).
        Returns False when the pool cannot supply a copy target."""
        bs = self.alloc.block_size
        for idx in range(lo_pos // bs, hi_pos // bs + 1):
            if not self.alloc.needs_cow(req.rid, idx):
                continue
            if self.alloc.free_blocks + self.alloc.evictable_blocks < 1:
                return False
            src, dst, ev = self.alloc.cow(req.rid, idx)
            evicted.extend(ev)
            cow.append((req, src, dst))
        return True

    def plan_step(self) -> StepPlan:
        evicted: list[tuple[Any, int]] = []
        preempted: list[tuple[Request, int]] = []
        cow: list[tuple[Request, int, int]] = []

        # 1) grow running sequences (priority over admission), then
        # make their decode write window [next_pos, next_pos +
        # lookahead] privately writable — a speculative verify writes
        # the whole window, and none of it may land in a shared or
        # published (trie-registered) block.
        for slot in sorted(self.running):
            req = self.running[slot]
            need = min(
                req.next_pos + 1 + self.lookahead, self.max_seq_len
            )
            if not self.alloc.can_extend(req.rid, need):
                preempted.append((req, self._preempt(req)))
                continue
            evicted.extend(self.alloc.extend(req.rid, need))
            if not self._cow_window(
                req, req.next_pos, need - 1, cow, evicted
            ):
                preempted.append((req, self._preempt(req)))

        # 2) admission.  Allocate ctx_len + 1 tokens: the first decode
        # step after prefill writes position ctx_len itself (and runs
        # in the same engine step as the final chunk, BEFORE the next
        # plan's extend phase), so a prompt that exactly fills its
        # blocks would otherwise spill its first decode row to scratch.
        # Lookahead widens that to ctx_len + 1 + lookahead for the
        # verify window's sake.  With the prefix cache on, admission
        # walks the trie: matched blocks map shared, their prefill is
        # skipped (req.prefilled starts at the match length).
        admitted: list[Request] = []
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            tokens = min(
                req.ctx_len + 1 + self.lookahead, self.max_seq_len
            )
            if self.prefix_cache:
                ids = req.ctx_tokens()
                if not self.alloc.can_alloc_shared(tokens, ids):
                    break  # FIFO: a small request never jumps a big one
                self.waiting.popleft()
                ev, matched = self.alloc.alloc_shared(
                    req.rid, tokens, ids
                )
                evicted.extend(ev)
                req.prefilled = matched
                req.prefix_hit_tokens = matched
            else:
                if not self.alloc.can_alloc(tokens):
                    break
                self.waiting.popleft()
                evicted.extend(self.alloc.alloc(req.rid, tokens))
                req.prefilled = 0
                req.prefix_hit_tokens = 0
            req.slot = self._free_slots.pop()
            self.prefilling.append(req)
            admitted.append(req)

        # 3) prefill chunks, FIFO across mid-prefill requests.  Each
        # scheduled chunk's write window must be privately writable
        # (the first chunk after a partial-block prefix hit writes
        # into the shared tail block -> CoW); a chunk whose CoW can't
        # be supplied is simply deferred to a later step.
        chunks: list[tuple[Request, int, int]] = []
        budget = self.max_prefill_chunks
        for req in self.prefilling:
            if budget == 0:
                break
            n = min(self.prefill_chunk, req.ctx_len - req.prefilled)
            if not self._cow_window(
                req, req.prefilled, req.prefilled + n - 1, cow, evicted
            ):
                continue
            chunks.append((req, req.prefilled, n))
            budget -= 1

        # 4) decode everyone still running.
        decode = [self.running[s] for s in sorted(self.running)]
        return StepPlan(admitted, chunks, decode, preempted, evicted, cow)

    def can_adopt(self, tokens: int) -> bool:
        """True when a handed-off sequence covering ``tokens`` could be
        placed right now: a decode slot is free and the allocator can
        cover a fresh table (evicting retired/cached blocks if needed).
        """
        return bool(self._free_slots) and self.alloc.can_alloc(tokens)

    def adopt(self, req: Request) -> None:
        """Place a handed-off request straight into a decode slot,
        skipping waiting/prefilling entirely — its context KV was
        injected by the engine (``serving.handoff``), so the caller has
        already allocated the table and set ``prefilled``/``generated``.
        """
        if not self._free_slots:
            raise RuntimeError("adopt() with no free slot")
        if req.prefilled < req.ctx_len or not req.generated:
            raise ValueError(
                f"request {req.rid}: adopt() needs fully-resident "
                f"context and a pending token (prefilled "
                f"{req.prefilled} / ctx {req.ctx_len})"
            )
        req.slot = self._free_slots.pop()
        self.running[req.slot] = req

    # -- transitions (engine drives these) ----------------------------
    def advance_prefill(self, req: Request, n_tokens: int) -> bool:
        """Record ``n_tokens`` more context prefilled; move the request
        into its decode slot when the context is complete.  Returns
        True on the prefill->running transition."""
        req.prefilled += n_tokens
        if req.prefilled < req.ctx_len:
            return False
        self.prefilling.remove(req)
        self.running[req.slot] = req
        return True

    def finish(self, req: Request) -> int:
        """Completed request: retire blocks (LRU-evictable), free the
        slot.  Returns the retired block count."""
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        return self.alloc.retire(req.rid)

    def _preempt(self, req: Request) -> int:
        """Recompute-style preemption: blocks back to the free list,
        slot freed, request to the FRONT of the waiting queue so it
        re-admits (and re-prefills prompt + generated-so-far) first.
        Returns the released block count."""
        del self.running[req.slot]
        self._free_slots.append(req.slot)
        req.slot = -1
        req.prefilled = 0
        req.preemptions += 1
        released = self.alloc.release(req.rid)
        self.waiting.appendleft(req)
        return released
