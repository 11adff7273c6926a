"""Context parallelism: attention over a sequence sharded on the ``seq`` axis.

Counterpart of ``distributeddataparallel_tpu/parallel/context_parallel.py``.
Each rank of the axis holds a contiguous ``(B, S/N, H, D)`` chunk of q, k
and v; the global sequence is the chunks in axis order.  Embeddings, norms
and MLPs are per token; attention is the one collective:

- ``ring_attention``: the kv chunks travel around the ring (``dist.
  batch_isend_irecv`` to the next rank) while each rank attends its queries
  to the visiting chunk.  ``impl="kernel"`` is the flash ring
  (``flash_ring_attention``): K1 once per hop, causal on the diagonal hop
  and not on the others, the hops' normalized outputs merged through their
  ``lse``; its backward runs K2 and K3 once per hop from the global ``(out,
  lse)``, and each chunk's dk/dv travel around the ring with it, one final
  rotation delivering them to their owner.  ``impl="plain"`` is the einsum
  ring (online softmax in f32).  ``"auto"`` takes the kernels for CUDA
  tensors and the plain ring for CPU tensors; on CUDA a shape outside the
  kernels' envelope raises, with no fall-back.
- ``ulysses_attention``: two all-to-alls turn the sequence-sharded layout
  into a head-sharded one; attention (``ops.attention.attention``: K1-K3 on
  CUDA) then runs over the whole sequence for ``H / N`` heads.

The flash ring posts the next hop's exchange before the current hop's
kernel, so the transfer can run under it (the reference's ``ppermute``,
which XLA overlaps).  Under causal masking a hop whose chunk lies wholly in
the future contributes nothing: the reference computes it and multiplies it
by 0 (``:76-82``, ``:141-144``); the flash ring skips it, so rank ``r`` of
``n`` runs K1 ``1 + r`` times a forward and K2, K3 ``1 + r`` times each a
backward.  The chunks still travel every hop: later ranks need them.  The
einsum ring computes every hop, as the reference's does (the causal bias
zeroes a dead one).

Both collectives take their exchange as an argument, so the module's own
loops also run for ``n`` ranks inside one process: ``flash_ring_forward`` /
``flash_ring_backward`` take a ring exchange (``_Ring`` over a process
group), ``ulysses_ranks`` an all-to-all over a list of ranks' blocks.  The
model's entry points (``ring_attention`` and ``ulysses_attention``, which
``Attention`` calls) take either a process group or such an exchange
object, passed down from the caller (``is_exchange``): ``idx`` and ``n``,
the ring's ``post`` and ``wait``, and Ulysses' differentiable
``all_to_all`` (dim 0 in equal blocks).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.ops import flash_attention as fa
from distributeddataparallel_tpu_torch.ops.attention import NEG_INF, attention, causal_mask_bias, repeat_kv


def is_exchange(group) -> bool:
    """Is ``group`` an exchange object (module docstring), not a process
    group?"""
    return hasattr(group, "post")


def group_coords(group) -> tuple[int, int]:
    """(this rank's index, size) of ``group`` (None: the world; an
    exchange object: its ``idx`` and ``n``)."""
    if is_exchange(group):
        return group.idx, group.n
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def cp_positions(seq_len_local: int, group, device=None) -> torch.Tensor:
    """Global token positions of this rank's chunk of the sequence."""
    idx, _ = group_coords(group)
    return idx * seq_len_local + torch.arange(seq_len_local, device=device)


class _Ring:
    """Point-to-point exchange with the ring's neighbours over a process
    group: ``post`` sends tensors to the next rank (the previous one with
    ``reverse``) and receives the same shapes from the other side; ``wait``
    returns them.  ``idx`` and ``n`` are this rank's place in the ring.
    The flash ring needs only these four: any object with them can stand
    in (ranks of one process stepping in lockstep)."""

    def __init__(self, group, reverse: bool = False):
        self.group = group
        self.idx, self.n = group_coords(group)
        glob = (lambda i: i) if group is None else (lambda i: dist.get_global_rank(group, i))
        step = -1 if reverse else 1
        self.to, self.frm = glob((self.idx + step) % self.n), glob((self.idx - step) % self.n)

    def post(self, tensors):
        sends = [t.contiguous() for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self.to, self.group) for t in sends]
        ops += [dist.P2POp(dist.irecv, r, self.frm, self.group) for r in recvs]
        return dist.batch_isend_irecv(ops), sends, recvs

    @staticmethod
    def wait(pending):
        works, _, recvs = pending
        for w in works:
            w.wait()
        return recvs


def hop_live(idx: int, hop: int) -> bool:
    """Does rank ``idx`` attend to the chunk it holds after ``hop`` hops
    (chunk ``idx - hop``) under causal masking?  Not when that chunk lies
    wholly in its future (it wrapped around the ring)."""
    return idx - hop >= 0




def ring_merge(of, lse, oh, lseh):
    """Merge a hop's normalized output into the running one through their
    logsumexps: ``o = o * exp(lse - lse') + oh * exp(lseh - lse')`` with
    ``lse' = logaddexp(lse, lseh)``, in f32.  ``of`` is f32 (B, S, H, D),
    ``oh`` the hop's output in q's dtype, widened here as the reference
    widens it."""
    lse_new = torch.logaddexp(lse, lseh)
    w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
    w_new = torch.exp(lseh - lse_new).transpose(1, 2)[..., None]
    return of * w_old + oh.float() * w_new, lse_new


def _hop_bwd(q, kc, vc, do, lse, delta, diagonal: bool):
    """One hop of the flash ring's backward: K2 and K3 over the visiting
    chunk, fed the global ``lse`` (so ``exp(s - lse)`` is that chunk's exact
    slice of the softmax) and ``delta``.  Returns ``(dq, dk, dv)`` pieces."""
    dq = fa.flash_bwd_dq(q, kc, vc, do, lse, delta, causal=diagonal)
    dk, dv = fa.flash_bwd_dkv(q, kc, vc, do, lse, delta, causal=diagonal)
    return dq, dk, dv


def flash_ring_forward(q, k, v, ring):
    """The flash ring's forward on rank ``ring.idx`` of ``ring.n`` (``ring``:
    the exchange, ``_Ring``): ``(out, lse)``, out rounded to q's dtype once
    at the end, lse (B, H, S) f32 over the global keys.  Each hop is K1 over
    the visiting chunk, causal on the diagonal hop (the rank's own chunk),
    unmasked on earlier chunks."""
    idx, n = ring.idx, ring.n
    oh, lse = fa.flash_fwd(q, k, v, causal=True)
    of = oh.float()
    pending = ring.post([k, v]) if n > 1 else None
    for s in range(1, n):
        kc, vc = ring.wait(pending)
        # The next hop's exchange goes out before this hop's kernel.
        pending = ring.post([kc, vc]) if s < n - 1 else None
        if hop_live(idx, s):
            oh, lseh = fa.flash_fwd(q, kc, vc, causal=False)
            of, lse = ring_merge(of, lse, oh, lseh)
    return of.to(q.dtype), lse


def flash_ring_backward(q, k, v, out, lse, do, ring):
    """The flash ring's backward on rank ``ring.idx``: ``(dq, dk, dv)``.
    ``delta`` is computed once; dq accumulates in q's dtype, each chunk's
    dk and dv in k's and v's dtypes as they travel with it."""
    idx, n = ring.idx, ring.n
    delta = fa.attention_delta(out, do)
    dq, dk, dv = _hop_bwd(q, k, v, do, lse, delta, diagonal=True)
    if n == 1:
        return dq, dk, dv
    kv = ring.post([k, v])
    dkv = ring.post([dk, dv])
    for s in range(1, n):
        kc, vc = ring.wait(kv)
        kv = ring.post([kc, vc]) if s < n - 1 else None
        dkc, dvc = ring.wait(dkv)
        if hop_live(idx, s):
            dq_h, dk_h, dv_h = _hop_bwd(q, kc, vc, do, lse, delta, diagonal=False)
            dq = dq + dq_h
            dkc = dkc + dk_h.to(dkc.dtype)
            dvc = dvc + dv_h.to(dvc.dtype)
        dkv = ring.post([dkc, dvc])
    # After n - 1 hops each chunk's gradient sits one hop short of its
    # owner: the last rotation delivers it.
    dk, dv = ring.wait(dkv)
    return dq, dk, dv


class FlashRingAttention(torch.autograd.Function):
    """Causal ring attention through K1-K3 per hop; saves ``(q, k, v, out,
    lse)`` as the reference's ``custom_vjp`` does."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        out, lse = flash_ring_forward(q, k, v, _ring(group))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group = group
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_ring_backward(q, k, v, out, lse, do.contiguous(), _ring(ctx.group))
        return dq, dk, dv, None


def _ring(group):
    """The ring exchange over ``group``: an exchange object as it is, a
    process group's ``_Ring``."""
    return group if is_exchange(group) else _Ring(group)


def flash_ring_attention(q, k, v, group=None):
    """q (B, S/N, H, D), k/v (B, S/N, Hkv, D) local chunks -> the local
    (B, S/N, H, D) chunk of causal attention over the global sequence.  GQA
    is native (the kernels index the shared kv head), so the ring carries kv
    at its own head count."""
    return FlashRingAttention.apply(q, k, v, group)


class _Rotate(torch.autograd.Function):
    """Tensors from the previous rank of the ring (sent to the next); the
    backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ring = _Ring(group)
        return tuple(ring.wait(ring.post(xs)))

    @staticmethod
    def backward(ctx, *gs):
        ring = _Ring(ctx.group, reverse=True)
        return (None, *ring.wait(ring.post(gs)))


def _plain_ring(q, k, v, group, causal: bool):
    """The einsum ring (ref ``:200-252``): an online softmax over the
    visiting chunks in f32, differentiated through the rotations.  Every
    hop is computed, a dead one (wholly in the future) zeroed by the causal
    bias, so every rank runs every rotation forward and backward."""
    if is_exchange(group):
        raise TypeError("the einsum ring rotates over a process group; an exchange object runs the flash ring "
                        "(impl='kernel')")
    idx, n = group_coords(group)
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qf = q.float()

    def accumulate(stats, kc, vc, src):
        m, l, acc = stats
        kf, vf = repeat_kv(kc, H // kc.shape[2]).float(), repeat_kv(vc, H // vc.shape[2]).float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if causal:
            logits = logits + causal_mask_bias(S, S, q_offset=idx * S, kv_offset=src * S,
                                               device=q.device)[None, None]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vf)
        return m_new, l_new, acc_new

    m0 = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    stats = accumulate((m0, torch.zeros_like(m0), torch.zeros(B, H, S, D, device=q.device)), k, v, idx)
    kc, vc = k, v
    for s in range(1, n):
        kc, vc = _Rotate.apply(group, kc, vc)
        stats = accumulate(stats, kc, vc, (idx - s) % n)
    _, l, acc = stats
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).transpose(1, 2).to(q.dtype)


def ring_attention(q, k, v, group=None, causal: bool = True, impl: str = "auto"):
    """Blockwise ring attention over ``group``'s ranks (None: the world;
    an exchange object, module docstring, for the flash ring).

    q (B, S_local, H, D), k/v (B, S_local, Hkv, D) local chunks; returns
    the local chunk of attention over the global sequence.  ``impl``:
    ``"kernel"`` the flash ring, ``"plain"`` the einsum ring, ``"auto"``
    the kernel for CUDA tensors and the plain ring for CPU tensors.  The
    flash ring is causal only, as the reference's; it raises (a
    ``ValueError``) for a non-causal call or a shape outside the kernels'
    envelope."""
    if impl not in ("auto", "plain", "kernel"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if impl == "kernel" or (impl == "auto" and q.is_cuda):
        if not causal:
            raise ValueError("the flash ring is causal only (its wrap masking assumes it); "
                             "use impl='plain' for non-causal ring attention")
        fa.check_envelope(q, k, v)
        return flash_ring_attention(q, k, v, group)
    return _plain_ring(q, k, v, group, causal)


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over dim 0 split in equal blocks; its own
    transpose, so the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    x = x.contiguous()  # and so the output: empty_like keeps x's strides
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _split_heads(x, n: int):
    """(B, S/n, Hx, D) -> (n, B, S/n, Hx/n, D): head block j in block j,
    contiguous, for the exchange (``all_to_all_single`` splits dim 0)."""
    B, Sl, Hx, D = x.shape
    return x.reshape(B, Sl, n, Hx // n, D).permute(2, 0, 1, 3, 4).contiguous()


def _join_seq(y):
    """Received blocks -> (B, S, Hx/n, D): block j is rank j's chunk, so
    the chunks concatenate in rank order, the global order."""
    n, B, Sl, Hl, D = y.shape
    return y.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, Hl, D)


def _split_seq(x, n: int):
    """(B, S, H/n, D) -> (n, B, S/n, H/n, D): sequence chunk j in block j."""
    B, S, Hl, D = x.shape
    return x.reshape(B, n, S // n, Hl, D).permute(1, 0, 2, 3, 4).contiguous()


def _join_heads(y):
    """Received blocks -> (B, S/n, H, D): block j is rank j's heads."""
    n, B, Sl, Hl, D = y.shape
    return y.permute(1, 2, 0, 3, 4).reshape(B, Sl, n * Hl, D)


def ulysses_kv_repeat(H: int, Hkv: int, n: int) -> int:
    """How many times Ulysses repeats each kv head on an ``n``-way axis: 1
    when ``n`` divides ``Hkv`` (GQA-native), else ``lcm(Hkv, n) / Hkv``,
    which always divides the GQA group (``H % n == 0`` forces it)."""
    if Hkv % n == 0:
        return 1
    rep = n // math.gcd(Hkv, n)
    assert H % (Hkv * rep) == 0, (H, Hkv, n)
    return rep


def ulysses_ranks(qs, ks, vs, n: int, exchange, causal: bool = True, impl: str = "auto"):
    """Ulysses for the ranks of an ``n``-way axis whose local chunks are in
    the lists: this rank's alone on the distributed path, all ``n`` in a
    replay inside one process.  ``exchange(blocks) -> blocks`` is the
    all-to-all over those ranks: block j of rank r's result is block r of
    rank j's input.  Returns the ranks' local outputs."""
    H, Hkv = qs[0].shape[2], ks[0].shape[2]
    rep = ulysses_kv_repeat(H, Hkv, n)

    def to_seq(xs):
        return [_join_seq(y) for y in exchange([_split_heads(x, n) for x in xs])]

    qh = to_seq(qs)
    kh = to_seq([repeat_kv(k, rep) for k in ks])
    vh = to_seq([repeat_kv(v, rep) for v in vs])
    outs = [attention(a, b, c, causal=causal, impl=impl) for a, b, c in zip(qh, kh, vh)]
    return [_join_heads(y) for y in exchange([_split_seq(o, n) for o in outs])]


def ulysses_attention(q, k, v, group=None, causal: bool = True, impl: str = "auto"):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention over
    ``group`` (a process group, or an exchange object with ``all_to_all``).

    Over the ring's layout (local chunks (B, S/N, H, D)) two exchanges
    trade the N-1 hops: the first scatters heads and gathers the sequence,
    attention (``ops.attention.attention`` with ``impl``: K1-K3 for CUDA
    tensors) runs over the whole sequence for ``H / N`` heads, the second
    restores the sequence-sharded layout.  Needs ``H % N == 0``.  GQA: kv
    travels at its own head count when ``Hkv % N == 0`` (query-head block
    j then pairs with kv-head block j); otherwise kv heads are first
    repeated to ``lcm(Hkv, N)``, the fewest the exchange can split, which
    keeps query head j on its kv head ``j // (H / Hkv)``."""
    _, n = group_coords(group)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses requires num_heads % axis size == 0, got {H} % {n}")
    if n == 1:
        return attention(q, k, v, causal=causal, impl=impl)
    exchange = group.all_to_all if is_exchange(group) else (lambda y: _AllToAll.apply(y, group))
    return ulysses_ranks([q], [k], [v], n, lambda ys: [exchange(ys[0])], causal, impl)[0]
