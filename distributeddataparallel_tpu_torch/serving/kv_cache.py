"""Paged (block) KV cache: pool layout, gather/scatter, host allocator.

Counterpart of ``distributeddataparallel_tpu/serving/kv_cache.py``.  The
decode twin reads a dense per-sequence cache, a per-layer list of ``(k, v)``
of shape ``(B, max_seq_len, kv_heads, head_dim)``.  The paged layout stores
KV in fixed-size blocks inside one preallocated pool and maps each sequence
to blocks through a small integer table:

- pool leaf (one per layer, k and v): ``(num_blocks, block_size, H, D)``;
  under ``scan_layers`` the leaves are views of one stacked
  ``(L, num_blocks, block_size, H, D)`` tensor, the reference's layout;
- block table per sequence: ``(max_seq_len // block_size,)`` int.

Every step the engine gathers the slot batch's dense caches from the pool
(``gather_block_cache``), runs the decode twin unmodified, and writes only
the newly inserted rows back (``scatter_decode`` / ``scatter_prefill`` /
``scatter_spec``).  The writes land in the pool in place (``index_put_``,
``copy_``), the counterpart of the reference's donated pool: memory never
holds two pools.

Block 0 is RESERVED scratch: unallocated table entries point at it, and
prefill rows past the prompt (chunk padding) are routed into it.  Reads
through scratch return finite garbage that the decode twin's positional
masking multiplies by an exactly-zero softmax weight (f32 ``NEG_INF``
bias), so scratch never perturbs logits.

int8 KV (``quantized_kv=True``): pool leaves become ``{"q": int8,
"scale": f32}`` pairs with one absmax scale per (block row, kv head).
Gather dequantizes into the compute dtype; scatter quantizes the inserted
rows.

The host side (``BlockAllocator``, ``block_hash``) is the reference's,
copied: free-list allocation, per-sequence tables, immediate release on
preemption, deferred release on completion (an LRU evictable park), and
the refcounted radix prefix tree with copy-on-write.

Indices arrive as device tensors (``torch.long``); ``start``/``limit`` of
a prefill chunk are host ints.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Any

import torch

Pytree = Any

#: Reserved block: never allocated, target of unallocated table entries
#: and of junk rows (chunk padding, idle decode slots).
SCRATCH_BLOCK = 0

_SCALE_EPS = 1e-8


def _is_qkv(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def _leaves(pool):
    """(layer, k|v index, leaf) over a pool or cache."""
    for i, pair in enumerate(pool):
        for j, leaf in enumerate(pair):
            yield i, j, leaf


def _quant_rows(rows: torch.Tensor):
    """int8-quantize KV rows ``(..., H, D)`` with one absmax scale per
    (row, head): head_dim shares a scale, heads/rows do not."""
    # Times the f32 reciprocal of 127, as XLA compiles the reference's
    # division by the constant inside the engine's jitted programs.
    scale = rows.abs().amax(dim=-1, keepdim=True).float() * (1.0 / 127.0)
    scale = torch.clamp(scale, min=_SCALE_EPS)
    q = torch.round(rows.float() / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def make_pool(model, num_blocks: int, block_size: int, *, quantized_kv: bool = False,
              device=None) -> list:
    """Preallocate the block pool: a per-layer list of ``(k, v)`` leaves
    shaped as the decode twin's cache with its ``(B, max_seq_len)``
    leading dims replaced by ``(num_blocks, block_size)``."""
    if num_blocks < 2:
        raise ValueError(
            f"num_blocks must be >= 2 (block {SCRATCH_BLOCK} is reserved "
            f"scratch), got {num_blocks}"
        )
    cfg = model.cfg
    device = device or model.token_embed.weight.device
    shape = (num_blocks, block_size, cfg.kv_heads, cfg.dims_per_head)
    lead = (cfg.num_layers,) if cfg.scan_layers else ()

    def leaf():
        if quantized_kv:
            return {
                "q": torch.zeros(lead + shape, dtype=torch.int8, device=device),
                "scale": torch.full(lead + shape[:-1] + (1,), _SCALE_EPS, dtype=torch.float32,
                                    device=device),
            }
        return torch.zeros(lead + shape, dtype=cfg.dtype, device=device)

    def layer(x, i):
        if _is_qkv(x):
            return {k: v[i] for k, v in x.items()}
        return x[i]

    if cfg.scan_layers:
        k, v = leaf(), leaf()
        return [(layer(k, i), layer(v, i)) for i in range(cfg.num_layers)]
    return [(leaf(), leaf()) for _ in range(cfg.num_layers)]


def kv_pool_bytes(cfg, num_blocks: int, block_size: int, *, quantized_kv: bool = False) -> int:
    """Pool bytes for a model config: ``2 (k+v) x layers x num_blocks x
    block_size x kv_heads x head_dim`` x itemsize, plus the f32
    per-(row, head) scales when int8."""
    heads = cfg.num_kv_heads or cfg.num_heads
    head_dim = cfg.head_dim or cfg.d_model // cfg.num_heads
    rows = 2 * cfg.num_layers * num_blocks * block_size * heads
    if quantized_kv:
        return rows * head_dim * 1 + rows * 4
    return rows * head_dim * cfg.dtype.itemsize


def gather_block_cache(pool: list, tables: torch.Tensor, *, dtype) -> list:
    """Materialize dense per-slot caches from the pool: ``tables`` is
    ``(B, max_seq_len // block_size)``; returns a per-layer list of
    ``(k, v)`` of shape ``(B, max_seq_len, H, D)`` (new tensors, the
    step's scratch).  int8 leaves dequantize into ``dtype``."""
    B, nb = tables.shape

    def take(leaf):
        g = leaf[tables]  # (B, nb, bs, H, D)
        return g.reshape(B, nb * leaf.shape[1], *leaf.shape[2:])

    def one(leaf):
        if _is_qkv(leaf):
            return (take(leaf["q"]).float() * take(leaf["scale"])).to(dtype)
        return take(leaf)

    return [(one(k), one(v)) for k, v in pool]


def _put(pl, blk, off, new) -> None:
    """Write rows ``new`` at (block, offset) into one pool leaf, in place."""
    if _is_qkv(pl):
        q, s = _quant_rows(new)
        pl["q"].index_put_((blk, off), q)
        pl["scale"].index_put_((blk, off), s)
    else:
        pl.index_put_((blk, off), new.to(pl.dtype))


def scatter_decode(pool: list, dense: list, tables: torch.Tensor, pos: torch.Tensor, *,
                   block_size: int) -> list:
    """Write each slot's newly inserted decode row back into the pool.

    ``dense`` is the cache after a per-row decode apply (row ``b``'s new KV
    sits at ``pos[b]``); the write lands at block ``tables[b, pos[b] //
    block_size]``, offset ``pos[b] % block_size``.  Idle slots (all-scratch
    tables, pos 0) write into the scratch block; those writes may collide
    with each other, invisibly (scratch is never read unmasked)."""
    B = tables.shape[0]
    row = torch.arange(B, device=tables.device)
    blk = tables[row, pos // block_size]
    off = pos % block_size
    for i, j, pl in _leaves(pool):
        _put(pl, blk, off, dense[i][j][row, pos])
    return pool


def scatter_prefill(pool: list, dense: list, table: torch.Tensor, start: int, length: int,
                    limit: int, *, block_size: int) -> list:
    """Write one B=1 prefill chunk's rows ``[start, start + length)`` into
    the pool through ``table`` (1-D per-sequence block table).

    Rows at global position ``>= limit`` (chunk padding past the real
    prompt) are routed to the scratch block.  The rows read from ``dense``
    start at ``start`` clamped so ``length`` rows fit, as the reference's
    ``dynamic_slice`` clamps."""
    p = start + torch.arange(length, device=table.device)
    nb = table.shape[0]
    blk = torch.where(p < limit, table[(p // block_size).clamp(max=nb - 1)], SCRATCH_BLOCK)
    off = p % block_size
    for i, j, pl in _leaves(pool):
        dn = dense[i][j]
        s0 = min(max(start, 0), dn.shape[1] - length)
        _put(pl, blk, off, dn[0, s0:s0 + length])
    return pool


def scatter_spec(pool: list, dense: list, tables: torch.Tensor, pos0: torch.Tensor, *,
                 width: int, max_seq_len: int, block_size: int) -> list:
    """Write each slot's speculative verify window back into the pool.

    ``dense`` is the cache after a ``(B, width)`` per-row-window apply:
    slot ``b``'s row ``i`` holds the KV inserted at global position
    ``pos0[b] + i``.  Rows past ``max_seq_len - 1`` (a window hanging over
    the end of the sequence) are routed to the scratch block.  Rows past a
    slot's accepted length are rejected-draft garbage that the next verify
    window overwrites before any attention read."""
    B = tables.shape[0]
    row = torch.arange(B, device=tables.device)[:, None]
    p = pos0[:, None] + torch.arange(width, device=tables.device)[None, :]  # (B, width)
    pc = p.clamp(max=max_seq_len - 1)
    blk = torch.where(p < max_seq_len, tables[row, pc // block_size], SCRATCH_BLOCK)
    off = pc % block_size
    for i, j, pl in _leaves(pool):
        _put(pl, blk, off, dense[i][j][row, pc])
    return pool


def copy_pool_block(pool: list, src: int, dst: int) -> list:
    """Copy one physical block ``src`` -> ``dst`` across every leaf (q and
    scale alike), in place: the device half of copy-on-write."""
    for _, _, pl in _leaves(pool):
        for t in (pl.values() if _is_qkv(pl) else (pl,)):
            t[dst].copy_(t[src])
    return pool


def set_pool_block(pool: list, rows: list, dst: int) -> list:
    """Write one block's worth of rows into physical block ``dst`` across
    every leaf (the landing half of a KV handoff).  ``rows`` mirrors the
    pool with the block axis dropped, ``(bs, H, D)`` leaves (int8 leaves as
    q/scale dicts): raw pool content, never re-quantized."""
    return set_pool_blocks(pool, [tuple(_unsqueeze(r) for r in pair) for pair in rows],
                           torch.tensor([dst]))


def _unsqueeze(leaf):
    if _is_qkv(leaf):
        return {k: v[None] for k, v in leaf.items()}
    return leaf[None]


def set_pool_blocks(pool: list, rows: list, dst: torch.Tensor) -> list:
    """Batched :func:`set_pool_block`: land ``n`` blocks in one write per
    leaf.  ``rows`` mirrors the pool with a leading block axis, ``(n, bs,
    H, D)`` leaves, and ``dst`` is the ``(n,)`` vector of destinations."""
    for (pk, pv), (rk, rv) in zip(pool, rows):
        for pl, rw in ((pk, rk), (pv, rv)):
            pairs = ((pl[k], rw[k]) for k in pl) if _is_qkv(pl) else ((pl, rw),)
            for t, r in pairs:
                t.index_copy_(0, dst.to(t.device), r.to(device=t.device, dtype=t.dtype))
    return pool


#: FNV-1a 64-bit offset basis — the rolling-hash seed for the trie root.
_ROOT_HASH = 0xCBF29CE484222325

#: Registration-chain sentinel: the chain's trie node was evicted out
#: from under the sequence, so it can never register further blocks.
_DEAD = object()


def block_hash(parent_hash: int, chunk) -> int:
    """Rolling content hash of one full block of token ids, chained
    through the parent block's hash so equal chunks at different tree
    depths never collide structurally."""
    h = parent_hash
    for t in chunk:
        h = ((h ^ (int(t) + 1)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class BlockAllocator:
    """Host-side block accounting for one pool.

    Invariants (asserted by :meth:`check`):

    - block ``SCRATCH_BLOCK`` is never allocated;
    - every other block is in exactly one of {free, live (in >= 1
      table), retired park, cached LRU}; free/retired/cached are
      pairwise disjoint and disjoint from live;
    - a block's refcount equals its multiplicity across live tables —
      shared (prefix-cache-hit) blocks count once per holder;
    - eviction only reclaims refcount-0 blocks: retired (finished,
      unregistered) sequences first, then the cached LRU, oldest first,
      and only under allocation pressure;
    - the radix trie is consistent: every registered block is live or
      cached (never free/retired), every edge's child points back at
      its parent, and cached blocks are always registered (that is what
      makes them worth keeping).

    All methods are plain host work — the allocator never touches a
    device value.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2, got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # Stack: pop() hands out low block ids first (stable layouts
        # make pool dumps readable).
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: dict[Any, list[int]] = {}
        self._retired: OrderedDict[Any, list[int]] = OrderedDict()
        # Refcounts: block -> live-table multiplicity (allocated only).
        self._ref: dict[int, int] = {}
        # Prefix-cache state.  Trie nodes are canonical block ids (root
        # = None); edges are keyed by the child's rolling content hash
        # with the exact token chunk stored alongside for verification.
        self._children: dict[Any, dict[int, tuple[tuple[int, ...], int]]] = {}
        self._node_of: dict[int, tuple[Any, int]] = {}  # block -> (parent, h)
        self._hash_of: dict[int, int] = {}  # registered block -> its hash
        # Refcount-0 registered blocks, LRU order (oldest first).
        self._cached: OrderedDict[int, None] = OrderedDict()
        # Per-sequence registration chain: trie node reached so far and
        # the number of full blocks already processed.
        self._reg_node: dict[Any, Any] = {}
        self._reg_blocks: dict[Any, int] = {}
        self.evictions = 0
        self.evicted_blocks = 0

    # -- capacity -----------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def evictable_blocks(self) -> int:
        return sum(len(b) for b in self._retired.values()) + len(
            self._cached
        )

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def live_blocks(self) -> int:
        return sum(len(b) for b in self._tables.values())

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    def can_alloc(self, tokens: int) -> bool:
        return (
            self.free_blocks + self.evictable_blocks
            >= self.blocks_for(tokens)
        )

    def can_extend(self, rid, tokens: int) -> bool:
        need = self.blocks_for(tokens) - len(self._tables[rid])
        return need <= 0 or self.free_blocks + self.evictable_blocks >= need

    # -- trie internals -----------------------------------------------
    def _node_hash(self, node) -> int:
        return _ROOT_HASH if node is None else self._hash_of[node]

    def _evict_cached(self, block: int) -> int:
        """Detach one cached block (already popped from ``_cached``)
        from the trie and cascade: refcount-0 descendants are freed
        with it, live descendants stay allocated but become
        unmatchable.  Returns the number of blocks freed."""
        parent, h = self._node_of.pop(block)
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(h, None)
            if not kids:
                self._children.pop(parent, None)
        freed = 0
        stack = [block]
        while stack:
            x = stack.pop()
            self._hash_of.pop(x, None)
            for _chunk, child in self._children.pop(x, {}).values():
                self._node_of.pop(child, None)
                stack.append(child)
            if x in self._ref:
                continue  # live elsewhere: allocated, now unregistered
            self._cached.pop(x, None)
            self._free.append(x)
            freed += 1
        # Any registration chain parked on a detached node is broken
        # for good — never let it register under a recycled node id.
        for rid, node in self._reg_node.items():
            if (
                node is not None
                and node is not _DEAD
                and node not in self._node_of
            ):
                self._reg_node[rid] = _DEAD
        return freed

    def _acquire(self, block: int) -> None:
        """Take one reference on a matched block (reviving it from the
        cached LRU if it was parked there)."""
        self._ref[block] = self._ref.get(block, 0) + 1
        self._cached.pop(block, None)

    def _drop_ref(self, block: int) -> bool:
        """Release one reference; returns True when the block reached
        refcount 0 and is NOT registered (caller owns its disposal —
        free list or retired park).  Registered blocks at refcount 0
        park themselves in the cached LRU."""
        n = self._ref[block] - 1
        if n > 0:
            self._ref[block] = n
            return False
        del self._ref[block]
        if block in self._node_of:
            self._cached[block] = None  # LRU append (newest last)
            return False
        return True

    # -- allocation ---------------------------------------------------
    def _reclaim(self, need: int) -> list[tuple[Any, int]]:
        """Evict refcount-0 blocks until ``need`` are free: retired
        (finished, unregistered) sequences first, oldest retirement
        first, then the cached-prefix LRU; returns ``(rid, n_blocks)``
        per eviction (rid = ``"prefix-cache"`` for cache reclaims)."""
        evicted = []
        while len(self._free) < need and (self._retired or self._cached):
            if self._retired:
                rid, blocks = self._retired.popitem(last=False)
                self._free.extend(blocks)
                n = len(blocks)
            else:
                rid = "prefix-cache"
                block, _ = self._cached.popitem(last=False)
                n = self._evict_cached(block)
            self.evictions += 1
            self.evicted_blocks += n
            evicted.append((rid, n))
        return evicted

    def alloc(self, rid, tokens: int) -> list[tuple[Any, int]]:
        """Allocate a fresh table covering ``tokens``; returns the
        evictions it forced.  Callers gate on :meth:`can_alloc`."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already has a table")
        need = self.blocks_for(tokens)
        if not self.can_alloc(tokens):
            raise RuntimeError(
                f"pool exhausted: need {need} blocks, have "
                f"{self.free_blocks} free + {self.evictable_blocks} "
                "evictable"
            )
        evicted = self._reclaim(need)
        table = [self._free.pop() for _ in range(need)]
        for b in table:
            self._ref[b] = 1
        self._tables[rid] = table
        self._reg_node[rid] = None
        self._reg_blocks[rid] = 0
        return evicted

    def extend(self, rid, tokens: int) -> list[tuple[Any, int]]:
        """Grow ``rid``'s table to cover ``tokens`` total; returns the
        evictions it forced.  Callers gate on :meth:`can_extend`."""
        table = self._tables[rid]
        need = self.blocks_for(tokens) - len(table)
        if need <= 0:
            return []
        if self.free_blocks + self.evictable_blocks < need:
            raise RuntimeError(
                f"pool exhausted extending {rid!r}: need {need} more"
            )
        evicted = self._reclaim(need)
        fresh = [self._free.pop() for _ in range(need)]
        for b in fresh:
            self._ref[b] = 1
        table.extend(fresh)
        return evicted

    # -- prefix cache -------------------------------------------------
    def match_prefix(
        self, token_ids, *, limit: int | None = None
    ) -> tuple[list[int], int]:
        """Longest registered prefix of ``token_ids`` (capped at
        ``limit`` tokens): full-block trie walk, then one partial scan
        of the frontier node's children for a shared tail block.
        Returns ``(blocks, matched_tokens)`` without taking refs."""
        toks = [int(t) for t in token_ids]
        limit = len(toks) if limit is None else min(limit, len(toks))
        bs = self.block_size
        node = None
        blocks: list[int] = []
        matched = 0
        while True:
            kids = self._children.get(node)
            if not kids:
                break
            rest = toks[matched:limit]
            if len(rest) >= bs:
                chunk = tuple(rest[:bs])
                hit = kids.get(block_hash(self._node_hash(node), chunk))
                if hit is not None and hit[0] == chunk:
                    blocks.append(hit[1])
                    matched += bs
                    node = hit[1]
                    continue
            # Partial tail: longest common prefix (>= 1 token) with any
            # child's chunk; ties broken by smallest block id so the
            # walk is deterministic under replay.
            best_len, best_blk = 0, -1
            for chunk, blk in kids.values():
                n = 0
                for a, b in zip(chunk, rest):
                    if a != b:
                        break
                    n += 1
                if n > best_len or (n == best_len and n > 0 and blk < best_blk):
                    best_len, best_blk = n, blk
            if best_len > 0:
                blocks.append(best_blk)
                matched += best_len
            break
        return blocks, matched

    def _shared_plan(
        self, tokens: int, token_ids
    ) -> tuple[list[int], int, int]:
        """(matched blocks, matched tokens, fresh blocks needed) for a
        shared allocation.  The match is capped at ``tokens - 1`` so at
        least one context token always prefills — a fully-cached prompt
        still needs a final-chunk logit row to sample its first token
        from."""
        limit = min(tokens, len(token_ids)) - 1
        blocks, matched = self.match_prefix(token_ids, limit=limit)
        return blocks, matched, self.blocks_for(tokens) - len(blocks)

    def can_alloc_shared(self, tokens: int, token_ids) -> bool:
        blocks, _, fresh = self._shared_plan(tokens, token_ids)
        cached_matched = sum(1 for b in blocks if b in self._cached)
        return (
            self.free_blocks + self.evictable_blocks - cached_matched
            >= fresh
        )

    def alloc_shared(
        self, rid, tokens: int, token_ids
    ) -> tuple[list[tuple[Any, int]], int]:
        """Allocate a table covering ``tokens``, mapping the longest
        registered prefix of ``token_ids`` as shared blocks.  Returns
        ``(evictions, matched_tokens)``; the caller skips prefill for
        the matched tokens (their KV is already resident).  Callers
        gate on :meth:`can_alloc_shared`."""
        if rid in self._tables:
            raise ValueError(f"request {rid!r} already has a table")
        blocks, matched, fresh = self._shared_plan(tokens, token_ids)
        cached_matched = sum(1 for b in blocks if b in self._cached)
        if (
            self.free_blocks + self.evictable_blocks - cached_matched
            < fresh
        ):
            raise RuntimeError(
                f"pool exhausted: need {fresh} fresh blocks for "
                f"{rid!r}, have {self.free_blocks} free + "
                f"{self.evictable_blocks} evictable"
            )
        # Take refs FIRST so reclaim can never evict a matched block.
        for b in blocks:
            self._acquire(b)
        evicted = self._reclaim(fresh)
        tail = [self._free.pop() for _ in range(fresh)]
        for b in tail:
            self._ref[b] = 1
        self._tables[rid] = blocks + tail
        full = matched // self.block_size
        self._reg_node[rid] = blocks[full - 1] if full else None
        self._reg_blocks[rid] = full
        return evicted, matched

    def register_progress(self, rid, token_ids, upto: int) -> int:
        """Register ``rid``'s full blocks whose every row holds
        finalized KV (positions ``< upto``) into the prefix trie.
        Idempotent per block; duplicate content dedups onto the
        existing canonical block (the sequence keeps its private copy
        unregistered).  Returns the number of newly registered blocks.
        """
        node = self._reg_node.get(rid)
        bs = self.block_size
        table = self._tables[rid]
        full = min(upto // bs, len(table))
        done = self._reg_blocks.get(rid, 0)
        if node is _DEAD or full <= done:
            self._reg_blocks[rid] = max(done, full)
            return 0
        toks = [int(t) for t in token_ids]
        new = 0
        for j in range(done, full):
            chunk = tuple(toks[j * bs:(j + 1) * bs])
            h = block_hash(self._node_hash(node), chunk)
            kids = self._children.setdefault(node, {})
            hit = kids.get(h)
            if hit is not None:
                if hit[0] != chunk:  # hash collision: stop registering
                    node = _DEAD
                    break
                node = hit[1]  # dedup: our copy stays private
            else:
                b = table[j]
                if b in self._node_of:
                    # Matched shared block whose edge survived; walking
                    # it is the no-op registration.
                    node = b
                else:
                    kids[h] = (chunk, b)
                    self._node_of[b] = (node, h)
                    self._hash_of[b] = h
                    node = b
                    new += 1
            self._reg_blocks[rid] = j + 1
        self._reg_node[rid] = node
        return new

    def needs_cow(self, rid, block_idx: int) -> bool:
        """True when writing into table entry ``block_idx`` would
        mutate state another holder or the prefix cache depends on:
        the block is shared (refcount > 1) or registered in the trie
        (its content is a published prefix)."""
        b = self._tables[rid][block_idx]
        return self._ref.get(b, 0) > 1 or b in self._node_of

    def cow(self, rid, block_idx: int) -> tuple[int, int, list[tuple[Any, int]]]:
        """Copy-on-write: rewire ``rid``'s table entry ``block_idx`` to
        a fresh private block.  Returns ``(src, dst, evictions)``; the
        caller must copy the pool rows ``src -> dst`` on device before
        the next write/read through the table."""
        table = self._tables[rid]
        src = table[block_idx]
        if self.free_blocks + self.evictable_blocks < 1:
            raise RuntimeError(f"pool exhausted: no block to CoW for {rid!r}")
        evicted = self._reclaim(1)
        dst = self._free.pop()
        self._ref[dst] = 1
        table[block_idx] = dst
        if self._drop_ref(src):
            self._free.append(src)
        return src, dst, evicted

    # -- release ------------------------------------------------------
    def release(self, rid) -> int:
        """Drop ``rid``'s references: exclusively-held unregistered
        blocks return to the free list immediately (the preemption
        path — a preempted sequence is recomputed, its private KV is
        garbage), registered blocks park in the cached LRU at refcount
        0, shared blocks stay with their other holders.  Returns the
        table's block count."""
        blocks = self._tables.pop(rid)
        self._reg_node.pop(rid, None)
        self._reg_blocks.pop(rid, None)
        for b in blocks:
            if self._drop_ref(b):
                self._free.append(b)
        return len(blocks)

    def retire(self, rid) -> int:
        """Finished sequence: unregistered refcount-0 blocks park in
        the per-rid LRU evictable list, registered ones in the cached
        LRU; both are reclaimed by :meth:`alloc`/:meth:`extend` only
        under pressure.  Returns the table's block count."""
        blocks = self._tables.pop(rid)
        self._reg_node.pop(rid, None)
        self._reg_blocks.pop(rid, None)
        park = [b for b in blocks if self._drop_ref(b)]
        if park:
            self._retired[rid] = park
        return len(blocks)

    # -- tables -------------------------------------------------------
    def table_of(self, rid) -> tuple[int, ...]:
        return tuple(self._tables[rid])

    def table_array(self, rid, blocks_per_seq: int):
        """Fixed-shape int32 table padded with the scratch block."""
        import numpy as np

        out = np.full((blocks_per_seq,), SCRATCH_BLOCK, np.int32)
        blocks = self._tables[rid]
        if len(blocks) > blocks_per_seq:
            raise ValueError(
                f"table of {rid!r} ({len(blocks)} blocks) exceeds "
                f"blocks_per_seq {blocks_per_seq}"
            )
        out[: len(blocks)] = blocks
        return out

    def check(self) -> None:
        """Assert the partition + refcount + trie invariants (tests
        call this liberally)."""

        def _range(b):
            if b == SCRATCH_BLOCK:
                raise AssertionError("scratch block allocated")
            if not 0 < b < self.num_blocks:
                raise AssertionError(f"block {b} out of range")

        live: dict[int, int] = {}
        for blocks in self._tables.values():
            for b in blocks:
                _range(b)
                live[b] = live.get(b, 0) + 1
        idle: set[int] = set()
        for blocks in (
            [self._free, list(self._cached)]
            + list(self._retired.values())
        ):
            for b in blocks:
                _range(b)
                if b in idle or b in live:
                    raise AssertionError(f"block {b} double-owned")
                idle.add(b)
        if len(live) + len(idle) != self.num_blocks - 1:
            raise AssertionError(
                f"{self.num_blocks - 1 - len(live) - len(idle)} "
                "blocks leaked"
            )
        # Refcounts mirror live-table multiplicity exactly.
        if self._ref != live:
            raise AssertionError(
                f"refcounts {self._ref} != table multiplicity {live}"
            )
        # Trie: registered blocks are live or cached; cached blocks are
        # registered; retired/free blocks are never registered.
        for b in self._node_of:
            if b not in live and b not in self._cached:
                raise AssertionError(
                    f"registered block {b} is neither live nor cached"
                )
        for b in self._cached:
            if b not in self._node_of:
                raise AssertionError(f"cached block {b} not registered")
        # Edge <-> node consistency, both directions.
        for node, kids in self._children.items():
            if node is not None and node not in self._node_of:
                raise AssertionError(
                    f"trie node {node} has children but no registration"
                )
            for h, (chunk, child) in kids.items():
                if len(chunk) != self.block_size:
                    raise AssertionError(
                        f"edge chunk of {child} has {len(chunk)} tokens"
                    )
                if self._node_of.get(child) != (node, h):
                    raise AssertionError(
                        f"edge {node}->{child} not mirrored in _node_of"
                    )
        for child, (parent, h) in self._node_of.items():
            edge = self._children.get(parent, {}).get(h)
            if edge is None or edge[1] != child:
                raise AssertionError(
                    f"registration of {child} has no parent edge"
                )
            if child not in self._hash_of:
                raise AssertionError(f"registered {child} missing hash")
        # Registration chains point at valid nodes.
        for rid, node in self._reg_node.items():
            if rid not in self._tables:
                raise AssertionError(f"chain for dead request {rid!r}")
            if (
                node is not None
                and node is not _DEAD
                and node not in self._node_of
            ):
                raise AssertionError(
                    f"chain of {rid!r} parked on unregistered {node}"
                )
