"""Continuous-batching inference engine over the paged KV pool.

Counterpart of ``distributeddataparallel_tpu/serving/engine.py`` (the
single-engine core).  Three device programs serve any traffic mix, each a
sequence of eager torch ops on fixed shapes:

- the **decode program** steps every slot of the fixed ``num_slots``
  batch at once: gather dense caches from the pool through the slot block
  tables, one per-row-position decode apply (every slot at its own
  length), scatter the newly inserted KV rows back into the pool in place,
  greedy-sample on the device;
- the **prefill program** consumes one fixed-size chunk
  (``prefill_chunk`` tokens, B=1) of one request's context: gather, one
  prefill apply at positions ``start + arange(chunk)``, scatter through
  the request's table with padding rows routed to scratch, and the
  argmax of the chunk's last real row (the final chunk's is the request's
  first generated token);
- the **verify program** (``spec_k > 0``) replaces the decode program with
  a fixed ``(num_slots, spec_k + 1)`` window: every slot applies its
  pending token plus ``spec_k`` n-gram-drafted tokens at its own
  contiguous positions, and the host accepts the longest draft prefix
  whose greedy verdicts agree.

Decode and prefill attend with the plain f32-softmax attention over the
whole cache, as the reference does (XLA attention, not the flash kernels).
The pool is written in place (``index_put_``), so memory never holds two
pools.  The host reads one small tensor a step, the argmax ids (and a
finished prefill's first token, as the reference does); index tensors go
to the card from pinned memory without a wait.

The prefix cache rides on the same programs: admission maps cached blocks
into the new request's table, the skipped tokens never get prefill
chunks, and copy-on-write block copies run before the step's programs
whenever a write window touches a shared or published block.

The host loop is the scheduler's :class:`StepPlan` executed verbatim,
emitting ``request_admit`` / ``prefill_chunk`` / ``decode_step`` /
``request_done`` / ``kv_evict`` (+ ``prefix_hit``, ``spec_verify``) and a
``request:<rid>`` span per completion through the port's
``observability`` schema.

Greedy decoding only: the engine's contract with the parity tests is the
same continuations as ``generate()`` at temperature 0.

``EngineConfig.store_dir`` roots this process's kernel builds at the store
(``training.warm_start.enable_compile_cache``).  The reference stored its
compiled decode, prefill and verify programs there; the port's eager engine
has no such program (its decode attention is plain PyTorch, as the
reference's is XLA's), so the store holds only what the process builds.

The KV handoff of the disaggregated fleet (``serving.fleet``):
``extract_handoff`` ships a finished prefill's context blocks as wire bytes
(``serving.handoff``), and ``inject_handoff`` lands them on a decode-tier
engine in one ``set_pool_blocks`` write per leaf and adopts the request
straight into a decode slot, queueing it while slots or blocks are short.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from distributeddataparallel_tpu_torch.observability.tracecontext import (
    SpanContext,
    from_fields,
    root_context,
)
from distributeddataparallel_tpu_torch.serving.handoff import (
    HandoffError,
    HandoffPayload,
    extract_kv_blocks,
    unpack_blocks,
)
from distributeddataparallel_tpu_torch.serving.kv_cache import (
    SCRATCH_BLOCK,
    BlockAllocator,
    copy_pool_block,
    gather_block_cache,
    make_pool,
    scatter_decode,
    scatter_prefill,
    scatter_spec,
    set_pool_blocks,
)
from distributeddataparallel_tpu_torch.serving.scheduler import Request, Scheduler


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine shape knobs."""

    num_slots: int = 8
    num_blocks: int = 64
    block_size: int = 16
    prefill_chunk: int = 32
    max_prefill_chunks_per_step: int = 1
    quantized_kv: bool = False
    quantize_weights: bool = False
    store_dir: str | None = None  # the kernel build cache's root (training.warm_start)
    # Serving fast path: radix prefix caching (share KV blocks across
    # requests with a common prompt prefix) and speculative decoding
    # (spec_k > 0: an n-gram self-draft proposer suggests spec_k tokens
    # per step, one (num_slots, spec_k + 1) verify dispatch accepts the
    # longest matching prefix — greedy output stays the one-token decode
    # path's).
    prefix_cache: bool = False
    spec_k: int = 0
    spec_ngram: int = 3


class InferenceEngine:
    """Drive the decode twin step by step under continuous batching.

    ``model`` is a TransformerLM on its device (a training config is fine:
    the engine builds the decode twin, casting f32 params to a lower
    compute dtype once).  ``qparams`` is an int8 tree of
    ``models.generate.quantize_model`` for ``quantize_weights`` (made here
    when not given).  ``time_fn`` is injectable (the loadgen's virtual
    clock in replay tests); it must be monotonic.  ``events`` is an
    ``EventLog`` (or None), ``registry`` a ``MetricsRegistry`` (or None).
    """

    def __init__(
        self,
        model,
        config: EngineConfig = EngineConfig(),
        *,
        qparams=None,
        events=None,
        registry=None,
        time_fn=time.monotonic,
        name: str = "engine",
    ):
        from distributeddataparallel_tpu_torch.models.generate import (
            _quant_decode_model,
            decode_model,
            quantize_model,
        )

        cfg = model.cfg
        self.model = model
        if config.store_dir:
            from distributeddataparallel_tpu_torch.training.warm_start import enable_compile_cache

            enable_compile_cache(config.store_dir)
        if cfg.max_seq_len % config.block_size:
            raise ValueError(
                f"block_size ({config.block_size}) must divide "
                f"max_seq_len ({cfg.max_seq_len})"
            )
        self.config = config
        self.events = events
        self.registry = registry
        self._time = time_fn
        #: Engine name; span ids derive from it, so it must be stable
        #: across a VirtualClock replay.
        self.name = name
        self._step_idx = 0
        self._next_rid = 0
        self.completed: dict[int, Request] = {}
        # rids whose trace root this engine created itself: _finish emits
        # the root span record for these.
        self._own_roots: set[int] = set()

        if config.quantize_weights:
            self.qparams = qparams if qparams is not None else quantize_model(model)
            self._dm = _quant_decode_model(model)
        else:
            self.qparams = None
            self._dm = decode_model(model)  # bf16 configs: cast once here
        self.device = self._dm.token_embed.weight.device

        self.blocks_per_seq = cfg.max_seq_len // config.block_size
        self.pool = make_pool(
            self._dm, config.num_blocks, config.block_size,
            quantized_kv=config.quantized_kv, device=self.device,
        )
        self.allocator = BlockAllocator(config.num_blocks, config.block_size)
        if not 0 <= config.spec_k <= cfg.max_seq_len - 1:
            raise ValueError(
                f"spec_k ({config.spec_k}) must be in "
                f"[0, max_seq_len - 1]"
            )
        self.scheduler = Scheduler(
            self.allocator,
            num_slots=config.num_slots,
            prefill_chunk=config.prefill_chunk,
            max_seq_len=cfg.max_seq_len,
            max_prefill_chunks_per_step=config.max_prefill_chunks_per_step,
            prefix_cache=config.prefix_cache,
            lookahead=config.spec_k,
        )
        # Fast-path counters (loadgen's summary reads these).
        self.prefix_admits = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_ctx_tokens = 0
        self.cow_copies = 0
        self.spec_rows = 0        # verified (slot, step) rows
        self.spec_drafted = 0     # drafted tokens across rows
        self.spec_accepted = 0    # tokens emitted by verify rows
        self.peak_live_blocks = 0  # the allocator's peak, for the pool's sizing
        # Host clock over each decode/verify call through its host read.
        self.decode_calls = 0
        self.decode_time_s = 0.0
        # KV handoff: sequences waiting for a slot / blocks to land in.
        self._pending_injections: deque = deque()
        self.handoffs_in = 0
        self._chunk_pos = torch.arange(config.prefill_chunk, device=self.device)
        self._window = torch.arange(config.spec_k + 1, device=self.device)

    # -- device programs ----------------------------------------------
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host index array on the card: pinned and copied without a
        wait (a pageable copy would wait for the queued work)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _apply(self, dense, tokens, positions):
        """The twin over gathered caches ``dense``, written in place."""
        return self._dm(tokens, positions=positions, cache=dense, qparams=self.qparams)

    def _decode_program(self, tables, toks, pos):
        cfg = self._dm.cfg
        dense = gather_block_cache(self.pool, tables, dtype=cfg.dtype)
        logits = self._apply(dense, toks, pos[:, None])
        scatter_decode(self.pool, dense, tables, pos, block_size=self.config.block_size)
        return logits[:, -1].float().argmax(dim=-1)

    def _prefill_program(self, table, tokens, start: int, limit: int):
        cfg = self._dm.cfg
        chunk = self.config.prefill_chunk
        dense = gather_block_cache(self.pool, table[None], dtype=cfg.dtype)
        logits = self._apply(dense, tokens[None], start + self._chunk_pos)
        scatter_prefill(self.pool, dense, table, start, chunk, limit,
                        block_size=self.config.block_size)
        return logits[0, min(max(limit - 1 - start, 0), chunk - 1)].float().argmax()

    def _verify_program(self, tables, toks, pos0):
        # toks (B, k+1): [pending, draft_1..draft_k] per row; row i applies
        # at global position pos0 + i, clamped at the last position
        # (overhanging rows write scratch and are never read: acceptance
        # is capped by the remaining token budget).
        cfg = self._dm.cfg
        dense = gather_block_cache(self.pool, tables, dtype=cfg.dtype)
        positions = (pos0[:, None] + self._window[None, :]).clamp(max=cfg.max_seq_len - 1)
        logits = self._apply(dense, toks, positions)
        scatter_spec(self.pool, dense, tables, pos0, width=self.config.spec_k + 1,
                     max_seq_len=cfg.max_seq_len, block_size=self.config.block_size)
        return logits.float().argmax(dim=-1)  # (B, k+1)

    # -- intake -------------------------------------------------------
    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        arrival_s: float | None = None,
        session=None,
        trace: dict | None = None,
    ) -> int:
        """``trace`` is the PARENT span-context fields; without it the
        engine starts a trace of its own.  Ids derive from ``(self.name,
        rid)``, so a VirtualClock replay reproduces them."""
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=int(max_new_tokens),
            arrival_s=(
                self._time() if arrival_s is None else float(arrival_s)
            ),
            session=session,
            trace=self._parent_ctx(trace, rid).to_fields(),
        )
        self.scheduler.submit(req)
        return rid

    def _parent_ctx(self, trace: dict | None, rid: int) -> SpanContext:
        """The context this request's engine-local spans parent to."""
        ctx = from_fields(trace)
        if ctx is None:
            ctx = root_context("engine", self.name, rid)
            self._own_roots.add(rid)
        return ctx

    def has_work(self) -> bool:
        return bool(self._pending_injections) or self.scheduler.has_work()

    # -- KV handoff (disaggregated prefill/decode, serving.fleet) -----
    def extract_handoff(self, rid: int, *, max_new_tokens: int | None = None) -> HandoffPayload:
        """Pull a just-completed request's context KV off this engine as a
        :class:`HandoffPayload` for a decode-tier peer.

        Contract: call between the ``step()`` that completed ``rid`` and
        this engine's NEXT ``step()``: the retired blocks keep their content
        until a later plan reclaims them under allocation pressure, which
        only happens inside ``plan_step``.  The request leaves
        ``self.completed`` (the decode tier owns it from here).
        ``max_new_tokens`` overrides the shipped budget: a prefill-tier
        engine runs the request at ``max_new_tokens=1`` and restores the
        fleet-level budget here.
        """
        req = self.completed.pop(rid)
        meta = {
            "rid": rid,
            "session": req.session,
            "prompt": [int(t) for t in req.prompt],
            "generated": [int(t) for t in req.generated],
            "max_new_tokens": int(max_new_tokens or req.max_new_tokens),
            "arrival_s": req.arrival_s,
            "first_token_s": req.first_token_s,
            "ctx_len": req.ctx_len,
            # Parent span-context fields ride the header frame as plain
            # data: the decode engine derives ITS spans from the same
            # parent, so the request's span tree stays connected across
            # the process boundary.
            "trace": req.trace,
        }
        return HandoffPayload(meta, extract_kv_blocks(self.pool, req.final_blocks,
                                                      scanned=self._dm.cfg.scan_layers))

    def inject_handoff(self, payload: HandoffPayload) -> int:
        """Adopt a handed-off sequence: allocate a fresh table, land the
        shipped blocks bitwise, and place the request straight into a
        decode slot.  Queued when slots/pool are full; the queue drains here
        and at each ``step()`` start, so a busy decode tier backpressures
        instead of dropping."""
        meta = payload.meta
        rid = self._next_rid
        self._next_rid += 1
        req = Request(
            rid=rid,
            prompt=np.asarray(meta["prompt"], np.int32),
            max_new_tokens=int(meta["max_new_tokens"]),
            arrival_s=float(meta.get("arrival_s") or 0.0),
            session=meta.get("session"),
            trace=self._parent_ctx(meta.get("trace"), rid).to_fields(),
        )
        req.generated = [int(t) for t in meta.get("generated") or ()]
        req.first_token_s = meta.get("first_token_s")
        req.handoff = True
        if not req.generated:
            raise HandoffError(
                f"handoff for rid {meta.get('rid')!r} carries no "
                "pending token (prefill tier must generate one)"
            )
        sched = self.scheduler
        total = req.prompt_len + req.max_new_tokens
        if total > sched.max_seq_len:
            raise HandoffError(
                f"handoff request {rid}: prompt {req.prompt_len} + "
                f"budget {req.max_new_tokens} exceeds max_seq_len "
                f"{sched.max_seq_len}"
            )
        want = self.allocator.blocks_for(req.ctx_len)
        if want != len(payload.blocks):
            raise HandoffError(
                f"handoff request {rid}: ctx {req.ctx_len} needs "
                f"{want} blocks, payload ships {len(payload.blocks)}"
            )
        self._pending_injections.append((req, payload))
        self._drain_injections()
        return rid

    def _drain_injections(self) -> None:
        sched = self.scheduler
        while self._pending_injections:
            req, payload = self._pending_injections[0]
            tokens = min(req.ctx_len + 1 + sched.lookahead, sched.max_seq_len)
            if not sched.can_adopt(tokens):
                break
            self._pending_injections.popleft()
            for rid_, blocks in self.allocator.alloc(req.rid, tokens):
                self.emit("kv_evict", blocks=blocks, req=rid_, reason="lru")
            table = self.allocator.table_of(req.rid)
            n = len(payload.blocks)
            rows = unpack_blocks(self.pool, payload.blocks, scanned=self._dm.cfg.scan_layers)
            # ddplint: allow[serve-host-sync] — the block table is a host list
            set_pool_blocks(self.pool, rows, self._dev(np.asarray(table[:n])))
            req.prefilled = req.ctx_len
            sched.adopt(req)
            req.admit_s = self._time()
            self.handoffs_in += 1
            self.emit(
                "request_admit",
                req=req.rid,
                prompt_tokens=req.prompt_len,
                ctx_tokens=req.ctx_len,
                slot=req.slot,
                queued_s=req.admit_s - req.arrival_s,
                handoff=True,
                engine=self.name,
                **self._span_of(req, "decode"),
            )
            if self.config.prefix_cache:
                # Publish the landed context into the prefix trie so
                # session-affinity follow-ups hit it like any local
                # prefill would.
                self.prefix_admits += 1
                self.prefix_ctx_tokens += req.ctx_len
                self.allocator.register_progress(req.rid, req.ctx_tokens(), upto=req.ctx_len)

    # -- telemetry helpers --------------------------------------------
    def emit(self, kind: str, **fields) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    def _child_fields(self, req: Request, role: str) -> dict:
        """Span-context fields for this engine's ``role`` span of ``req``:
        a deterministic child of the request's parent context."""
        ctx = from_fields(req.trace)
        if ctx is None:
            return {}
        return ctx.child(role, self.name, req.rid).to_fields()

    def _span_of(self, req: Request, role: str) -> dict:
        """trace + span (no parent) marking a non-span record as belonging
        to one of this request's spans."""
        fields = self._child_fields(req, role)
        fields.pop("parent", None)
        return fields

    def _observe_ttft(self, req: Request) -> None:
        req.first_token_s = self._time()
        start = req.admit_s if req.admit_s is not None else req.arrival_s
        self.emit(
            "span",
            name=f"prefill:{req.rid}",
            dur_s=req.first_token_s - start,
            start_s=start,
            end_s=req.first_token_s,
            req=req.rid,
            engine=self.name,
            **self._child_fields(req, "prefill"),
        )
        if self.registry is not None:
            self.registry.histogram("serve_ttft_s").observe(
                req.first_token_s - req.arrival_s
            )

    def _finish(self, req: Request) -> None:
        req.done_s = self._time()
        req.final_blocks = tuple(
            self.allocator.table_of(req.rid)[
                : self.allocator.blocks_for(req.ctx_len)
            ]
        )
        retired = self.scheduler.finish(req)
        self.completed[req.rid] = req
        ttft = (req.first_token_s or req.done_s) - req.arrival_s
        self.emit(
            "request_done",
            req=req.rid,
            ttft_s=ttft,
            tokens=len(req.generated),
            latency_s=req.done_s - req.arrival_s,
            preemptions=req.preemptions,
            retired_blocks=retired,
            engine=self.name,
            **self._span_of(req, "serve"),
        )
        self.emit(
            "span",
            name=f"request:{req.rid}",
            dur_s=req.done_s - req.arrival_s,
            start_s=req.arrival_s,
            end_s=req.done_s,
            req=req.rid,
            engine=self.name,
            **self._child_fields(req, "serve"),
        )
        dstart = req.first_token_s or req.done_s
        if req.done_s > dstart:
            self.emit(
                "span",
                name=f"decode:{req.rid}",
                dur_s=req.done_s - dstart,
                start_s=dstart,
                end_s=req.done_s,
                req=req.rid,
                engine=self.name,
                **self._child_fields(req, "decode"),
            )
        if req.rid in self._own_roots:
            # Standalone run: the engine closes the trace with the root
            # span itself.
            self._own_roots.discard(req.rid)
            self.emit(
                "span",
                name=f"req:{req.rid}",
                dur_s=req.done_s - req.arrival_s,
                start_s=req.arrival_s,
                end_s=req.done_s,
                ttft_s=ttft,
                req=req.rid,
                engine=self.name,
                **(req.trace or {}),
            )
        if self.registry is not None:
            self.registry.counter("serve_requests_done").inc()
            self.registry.counter("serve_tokens_out").inc(len(req.generated))
            if len(req.generated) > 1 and req.first_token_s is not None:
                self.registry.histogram("serve_tok_latency_s").observe(
                    (req.done_s - req.first_token_s)
                    / (len(req.generated) - 1)
                )

    # -- speculative drafts -------------------------------------------
    def _ngram_next(self, ctx: np.ndarray, length: int) -> int:
        """Continuation after the most recent earlier occurrence of the
        longest matchable suffix (``spec_ngram`` down to 1 tokens) of
        ``ctx[:length]``; falls back to repeating the last token."""
        for n in range(min(self.config.spec_ngram, length - 1), 0, -1):
            pat = ctx[length - n:length]
            # Candidate starts 0..length-n-1: windows strictly before the
            # suffix itself, each with a continuation token.
            eq = np.ones(length - n, dtype=bool)
            for j in range(n):
                eq &= ctx[j:length - n + j] == pat[j]
            idx = np.nonzero(eq)[0]
            if idx.size:
                return int(ctx[int(idx[-1]) + n])
        return int(ctx[length - 1])

    def _propose_drafts(self, req: Request) -> list[int]:
        """``spec_k`` self-drafted tokens continuing prompt+generated."""
        k = self.config.spec_k
        n_ctx = req.prompt_len + len(req.generated)
        ctx = np.empty(n_ctx + k, dtype=np.int64)
        ctx[:req.prompt_len] = req.prompt
        ctx[req.prompt_len:n_ctx] = req.generated
        out: list[int] = []
        for i in range(k):
            nxt = self._ngram_next(ctx, n_ctx + i)
            ctx[n_ctx + i] = nxt
            out.append(nxt)
        return out

    # -- the step -----------------------------------------------------
    @torch.no_grad()
    def step(self) -> dict:
        """Execute one scheduler plan; returns host-side step stats."""
        self._drain_injections()
        plan = self.scheduler.plan_step()
        for rid, blocks in plan.evicted:
            self.emit("kv_evict", blocks=blocks, req=rid, reason="lru")
        for req, released in plan.preempted:
            self.emit("kv_evict", blocks=released, req=req.rid, reason="preempt")
        # Copy-on-write FIRST: the tables already point at the private
        # copies, so the pool rows must exist before any read/write goes
        # through them this step.
        for req, src, dst in plan.cow:
            copy_pool_block(self.pool, src, dst)
            self.cow_copies += 1
        for req in plan.admitted:
            req.admit_s = self._time()
            self.emit(
                "request_admit",
                req=req.rid,
                prompt_tokens=req.prompt_len,
                ctx_tokens=req.ctx_len,
                slot=req.slot,
                queued_s=req.admit_s - req.arrival_s,
                engine=self.name,
                **self._span_of(req, "serve"),
            )
            if self.config.prefix_cache:
                self.prefix_admits += 1
                self.prefix_ctx_tokens += req.ctx_len
                if req.prefix_hit_tokens > 0:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += req.prefix_hit_tokens
                    self.emit(
                        "prefix_hit",
                        req=req.rid,
                        tokens=req.prefix_hit_tokens,
                        ctx=req.ctx_len,
                        **self._span_of(req, "serve"),
                    )

        c = self.config
        for req, start, n in plan.prefill_chunks:
            ctx = req.ctx_tokens()
            tokens = np.zeros((c.prefill_chunk,), np.int64)
            tokens[:n] = ctx[start:start + n]
            table = self.allocator.table_array(req.rid, self.blocks_per_seq)
            first = self._prefill_program(self._dev(table), self._dev(tokens), start, start + n)
            self.emit(
                "prefill_chunk", req=req.rid, start=start, len=n,
                **self._span_of(req, "prefill"),
            )
            if self.config.prefix_cache:
                # Rows [0, start + n) are finalized: publish the full
                # blocks into the prefix trie.
                self.allocator.register_progress(req.rid, ctx, upto=start + n)
            if self.scheduler.advance_prefill(req, n):
                if not req.generated:
                    # Fresh prefill: the final chunk's last-row argmax is
                    # the request's first token (TTFT clock stops).
                    req.generated.append(int(first))
                    self._observe_ttft(req)
                    if req.done:
                        self._finish(req)
                # else: recompute after preemption — the pending token is
                # already known, decode just resumes.

        running = dict(self.scheduler.running)
        n_active = len(running)
        if running:
            k = c.spec_k
            tables = np.full((c.num_slots, self.blocks_per_seq), SCRATCH_BLOCK, np.int64)
            toks = np.zeros((c.num_slots, k + 1), np.int64)
            pos = np.zeros((c.num_slots,), np.int64)
            drafts: dict[int, list[int]] = {}
            for slot, req in running.items():
                tables[slot] = self.allocator.table_array(req.rid, self.blocks_per_seq)
                toks[slot, 0] = req.generated[-1]
                pos[slot] = req.next_pos
                if k:
                    d = self._propose_drafts(req)
                    toks[slot, 1:] = d
                    drafts[slot] = d
            if k:
                # One (num_slots, k + 1) verify dispatch, one host read of
                # every row's greedy next token.
                # ddplint: allow[wallclock] — the engine's own dispatch-time counter, no decision reads it
                t0 = time.perf_counter()
                g = self._verify_program(self._dev(tables), self._dev(toks), self._dev(pos))
                # ddplint: allow[serve-host-sync] — the one budgeted host read a verify step (its greedy tokens)
                g = g.cpu().numpy()
                self._timed(t0)
                drafted = accepted = 0
                for slot, req in running.items():
                    d = drafts[slot]
                    a = 0
                    while a < k and d[a] == int(g[slot, a]):
                        a += 1
                    # Row i's output is the model's greedy token after
                    # position pos + i, valid through the first draft
                    # mismatch: accept those plus the bonus token, capped
                    # by the request's remaining budget.
                    take = min(a + 1, req.max_new_tokens - len(req.generated))
                    for i in range(take):
                        req.generated.append(int(g[slot, i]))
                    drafted += k
                    accepted += take
                    self.spec_rows += 1
                    if self.config.prefix_cache:
                        self.allocator.register_progress(
                            req.rid, req.ctx_tokens(), upto=req.ctx_len
                        )
                    if req.done:
                        self._finish(req)
                self.spec_drafted += drafted
                self.spec_accepted += accepted
                self.emit(
                    "spec_verify",
                    step=self._step_idx,
                    drafted=drafted,
                    accepted=accepted,
                    rows=n_active,
                )
            else:
                # ddplint: allow[wallclock] — the engine's own dispatch-time counter, no decision reads it
                t0 = time.perf_counter()
                nxt = self._decode_program(self._dev(tables), self._dev(toks), self._dev(pos))
                # The one host read per engine step: completion detection
                # needs the slot batch's next tokens.
                # ddplint: allow[serve-host-sync] — the one budgeted host read a decode step (completion detection)
                nxt = nxt.cpu().numpy()
                self._timed(t0)
                for slot, req in running.items():
                    req.generated.append(int(nxt[slot]))
                    if self.config.prefix_cache:
                        self.allocator.register_progress(
                            req.rid, req.ctx_tokens(), upto=req.ctx_len
                        )
                    if req.done:
                        self._finish(req)
            self.emit("decode_step", step=self._step_idx, n_active=n_active)
        self.peak_live_blocks = max(self.peak_live_blocks, self.allocator.live_blocks)
        if self.registry is not None:
            self.registry.gauge("serve_slots_active").set(n_active)
            self.registry.gauge("serve_blocks_live").set(self.allocator.live_blocks)
        self._step_idx += 1
        return {
            "step": self._step_idx - 1,
            "n_active": n_active,
            "prefill_chunks": len(plan.prefill_chunks),
            "admitted": len(plan.admitted),
            "preempted": len(plan.preempted),
            "free_blocks": self.allocator.free_blocks,
        }

    def _timed(self, t0: float) -> None:
        self.decode_calls += 1
        # ddplint: allow[wallclock] — the engine's own dispatch-time counter, no decision reads it
        self.decode_time_s += time.perf_counter() - t0

    def decode_step_ms(self) -> float | None:
        """Mean host-clock ms of a decode (or verify) call through its
        host read; it includes the index uploads and the enqueue."""
        return self.decode_time_s * 1e3 / self.decode_calls if self.decode_calls else None

    def run(self, *, max_steps: int = 100_000) -> dict[int, Request]:
        """Step until drained (no waiting/prefilling/running work)."""
        steps = 0
        while self.has_work():
            if steps >= max_steps:
                raise RuntimeError(f"engine did not drain within {max_steps} steps")
            self.step()
            steps += 1
        return self.completed

    def output_tokens(self, rid: int) -> np.ndarray:
        """prompt + generated continuation of a completed request."""
        req = self.completed[rid]
        return np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
