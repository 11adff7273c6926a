"""Data-parallel gradient synchronization on ``torch.distributed``.

Counterpart of ``distributeddataparallel_tpu/parallel/data_parallel.py``,
written out explicitly instead of wrapping the model in
``torch.nn.parallel.DistributedDataParallel``:

- ``broadcast_params``: rank 0's parameters and buffers to every rank.
- ``all_reduce_gradients``: mean of every gradient over the ranks, per leaf
  or coalesced into ~``bucket_bytes`` buckets (``bucket_gradients``);
  ``compress="bf16"`` is the reference's bf16 comm hook.
- ``clip_scale`` / ``sumsq_f32`` / ``flat_chunk_sumsq``: the global-norm
  clip factor, and the norm of a ZeRO flat shard.
- ``masked_tree_mean``: exact masked means for evaluation.

Gradients are reduced in place (the port owns the ``.grad`` buffers, so no
second copy of the gradient is kept).  Every function is a no-op reduction
when no process group is initialized.  ``group=`` names the process group
to reduce over (a mesh axis's, ``runtime.distributed.axis_group``); the
default, None, is the whole world.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.runtime.distributed import get_world_size

#: DDP's default bucket size: 25 MiB (torch Reducer default).
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024

#: ``--overlap``'s bucket size (the reference's): leaves above 1 MiB ride
#: solo, the small ones (biases, norms) coalesce.
OVERLAP_BUCKET_BYTES = 1 * 1024 * 1024


def _check_compress(compress: str | None) -> None:
    if compress not in (None, "bf16"):
        raise ValueError(f"compress must be None or 'bf16', got {compress!r}")


def plan_buckets(leaf_bytes, bucket_bytes: int) -> list[list[int]]:
    """DDP Reducer bucket assignment: reverse-order grouping of leaves into
    ~bucket_bytes buckets.  Returns bucket -> [leaf indices] in reduction
    order (a copy of the reference's pure-Python planner)."""
    leaf_bytes = list(leaf_bytes)
    buckets: list[list[int]] = []
    cur: list[int] = []
    used = 0
    for k in range(len(leaf_bytes) - 1, -1, -1):
        b = leaf_bytes[k]
        if cur and used + b > bucket_bytes:
            buckets.append(cur)
            cur, used = [], 0
        cur.append(k)
        used += b
    if cur:
        buckets.append(cur)
    return buckets


def group_size(group=None) -> int:
    """Ranks in ``group`` (None: the world; 1 without a process group)."""
    if not dist.is_initialized():
        return 1
    return dist.get_world_size(group) if group is not None else get_world_size()


def _inv(t: torch.Tensor, group=None) -> torch.Tensor:
    """``1 / n`` rounded to ``t``'s dtype (the reference multiplies by
    ``jnp.asarray(inv_n, dtype)``)."""
    return torch.tensor(1.0 / group_size(group), dtype=t.dtype)


def group_active(group) -> bool:
    """Is there a collective to run over ``group``?  The world's runs
    whenever a process group exists, even one of a single rank; a mesh
    axis's only when the axis has more than one rank."""
    return dist.is_initialized() and (group is None or dist.get_world_size(group) > 1)


def metric_pack(t: torch.Tensor) -> torch.Tensor:
    """Mark ``t`` as a step's scalar metrics stacked for one reduction: the
    collective recorder (``analysis.graph_lint``) counts it as scalar
    reductions, as the reference's per-metric means are.

    The recorder sees only the tensor handed to ``dist.all_reduce``, and
    nothing there tells this vector from a gradient: a bias or a norm's
    scale at a small width is as short and as f32, and the order does not
    tell either (the pipe's loop reduces it among the gradients; under
    ``--overlap`` the buckets go out during backward).  So the step names
    it, with a Python attribute that costs nothing."""
    t.ddp_metric_pack = True
    return t


def _sum(t: torch.Tensor, group=None) -> None:
    if group_active(group):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


def all_reduce_gradients(
    grads: list[torch.Tensor],
    *,
    bucket_bytes: int | None = None,
    compress: str | None = None,
    group=None,
) -> None:
    """Mean of each gradient tensor across the ranks of ``group``, in place.

    The mean is DDP's divide-by-world-size, which keeps every replica in
    lockstep under a local optimizer step.  With ``bucket_bytes`` the leaves
    are coalesced (``bucket_gradients``).

    ``compress="bf16"`` is the reference's bf16 comm hook, on f32 gradients
    only: each is cast to bf16, summed on the wire in bf16, multiplied by
    the bf16 value of ``1 / world`` in bf16 and cast back.  The order is the
    reference's, not torch's ``bf16_compress_hook`` (which divides before
    the sum).  Every rank sees the same rounded mean, so replicas stay in
    lockstep."""
    _check_compress(compress)
    if bucket_bytes is not None:
        bucket_gradients(grads, bucket_bytes=bucket_bytes, compress=compress, group=group)
        return
    inv_n = 1.0 / group_size(group)
    for g in grads:
        if compress == "bf16" and g.dtype == torch.float32:
            wire = g.to(torch.bfloat16)
            _sum(wire, group)
            g.copy_(wire.mul_(_inv(wire, group)))
        else:
            _sum(g, group)
            g.mul_(inv_n)


def bucket_gradients(
    grads: list[torch.Tensor],
    *,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
    compress: str | None = None,
    group=None,
) -> None:
    """Coalesced mean all-reduce, in place: leaves grouped into
    ~bucket_bytes buckets in reverse order (DDP's Reducer order), each
    bucket reduced as one flat vector and scattered back into its leaves'
    dtypes.  The flat vector is f32, or bf16 under ``compress="bf16"`` when
    every leaf of the bucket is f32 (``all_reduce_gradients``)."""
    _check_compress(compress)
    buckets = plan_buckets([g.numel() * g.element_size() for g in grads], bucket_bytes)
    for bucket in buckets:
        leaves = [grads[i] for i in bucket]
        flat = bucket_flat(leaves, compress)
        _sum(flat, group)
        bucket_unflat(flat, leaves, group)


def bucket_flat(leaves: list[torch.Tensor], compress: str | None = None) -> torch.Tensor:
    """One bucket's wire vector: the leaves concatenated in f32 (bf16 under
    ``compress="bf16"`` when all of them are f32).  A lone leaf already of
    the wire dtype is reduced in place, without a copy."""
    dtype = torch.float32
    if compress == "bf16" and all(g.dtype == torch.float32 for g in leaves):
        dtype = torch.bfloat16
    if len(leaves) == 1 and leaves[0].dtype == dtype and leaves[0].is_contiguous():
        return leaves[0].view(-1)
    return torch.cat([g.reshape(-1).to(dtype) for g in leaves])


def bucket_unflat(flat: torch.Tensor, leaves: list[torch.Tensor], group=None) -> None:
    """The summed wire vector times ``1 / n`` (in its own dtype, n the
    ranks of ``group``), back into its leaves."""
    flat.mul_(_inv(flat, group))
    offset = 0
    for g in leaves:
        n = g.numel()
        part = flat[offset : offset + n]
        if part.data_ptr() != g.data_ptr():
            g.copy_(part.view_as(g))
        offset += n


def sumsq_f32(tensors) -> torch.Tensor:
    """Sum of squares of every tensor, accumulated in float32."""
    return sum(t.float().pow(2).sum() for t in tensors)


def flat_chunk_sumsq(chunk: torch.Tensor, chunk_start: int, leaf_sizes, leaf_dup) -> torch.Tensor:
    """Sum of squares of one flat-layout chunk in f32, each element of a
    leaf held by ``leaf_dup[i]`` model-axis positions weighted ``1 / dup``
    (the reference's ``flat_chunk_sumsq``): the flat vector concatenates
    leaves of ``leaf_sizes`` elements, then zero padding; ``chunk`` starts
    at element ``chunk_start``.  With every ``dup`` 1 it is ``sumsq_f32``."""
    x2 = chunk.float().pow(2)
    pos = chunk_start + torch.arange(chunk.shape[0], device=chunk.device)
    w = torch.ones_like(x2)
    off = 0
    for size, dup in zip(leaf_sizes, leaf_dup):
        if dup != 1:
            w = torch.where((pos >= off) & (pos < off + size), torch.full_like(w, 1.0 / dup), w)
        off += size
    return (x2 * w).sum()


def clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, clip/norm): the clip_grad_norm_ scale factor (epsilon as in
    the reference)."""
    return torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)


@torch.no_grad()
def broadcast_params(module: nn.Module, group=None) -> None:
    """Overwrite every rank's parameters and buffers with those of the
    first rank of ``group`` — DDP's construction-time broadcast."""
    if not group_active(group):
        return
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


def masked_tree_mean(
    metrics: dict[str, torch.Tensor], mask: torch.Tensor, group=None, seq_group=None,
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Global masked mean of per-row metrics: ``(means, count)``.

    ``metrics`` values are per-row vectors on this rank; ``mask`` is the
    matching (rows,) validity mask (0 on sampler-padded duplicate rows).
    One all-reduce over ``group`` carries the count and every numerator.
    With ``seq_group`` (context parallelism) each rank's per-row values
    cover its chunk of the sequence: they are first averaged over that
    group (the chunks are equal, so this is each row's exact mean), in one
    all-reduce of every metric's rows."""
    mask = mask.float()
    keys = list(metrics)
    rows = [metrics[k].float() for k in keys]
    # None means no sequence axis here (not the world, as for ``group``).
    n_seq = group_size(seq_group) if seq_group is not None else 1
    if n_seq > 1:
        stacked = torch.stack(rows)
        _sum(stacked, seq_group)
        rows = list((stacked / n_seq).unbind())
    parts = [mask.sum()] + [(r * mask).sum() for r in rows]
    total = torch.stack(parts)
    _sum(total, group)
    den = total[0]
    return {k: total[i + 1] / den.clamp(min=1.0) for i, k in enumerate(keys)}, den
