"""Data-parallel gradient synchronization on ``torch.distributed``.

Counterpart of ``distributeddataparallel_tpu/parallel/data_parallel.py``,
written out explicitly instead of wrapping the model in
``torch.nn.parallel.DistributedDataParallel``:

- ``broadcast_params``: rank 0's parameters and buffers to every rank.
- ``all_reduce_gradients``: mean of every gradient over the ranks, per leaf
  or coalesced into ~``bucket_bytes`` buckets (``bucket_gradients``).
- ``clip_scale`` / ``sumsq_f32``: the global-norm clip factor.
- ``masked_tree_mean``: exact masked means for evaluation.

Gradients are reduced in place (the port owns the ``.grad`` buffers, so no
second copy of the gradient is kept).  Every function is a no-op reduction
when no process group is initialized.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.runtime.distributed import get_world_size

#: DDP's default bucket size: 25 MiB (torch Reducer default).
DEFAULT_BUCKET_BYTES = 25 * 1024 * 1024


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


def _sum(t: torch.Tensor) -> None:
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)


def all_reduce_gradients(
    grads: list[torch.Tensor],
    *,
    bucket_bytes: int | None = None,
) -> None:
    """Mean of each gradient tensor across the ranks, in place.

    The mean is DDP's divide-by-world-size, which keeps every replica in
    lockstep under a local optimizer step.  With ``bucket_bytes`` the leaves
    are coalesced (``bucket_gradients``)."""
    if bucket_bytes is not None:
        bucket_gradients(grads, bucket_bytes=bucket_bytes)
        return
    inv_n = 1.0 / get_world_size()
    for g in grads:
        _sum(g)
        g.mul_(inv_n)


def bucket_gradients(
    grads: list[torch.Tensor],
    *,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> None:
    """Coalesced mean all-reduce, in place: leaves grouped into
    ~bucket_bytes buckets in reverse order (DDP's Reducer order), each
    bucket reduced as one flat f32 vector and scattered back into its
    leaves' dtypes."""
    buckets = plan_buckets([g.numel() * g.element_size() for g in grads], bucket_bytes)
    inv_n = 1.0 / get_world_size()
    for bucket in buckets:
        flat = torch.cat([grads[i].reshape(-1).float() for i in bucket])
        _sum(flat)
        flat.mul_(inv_n)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            grads[i].copy_(flat[offset : offset + n].view_as(grads[i]))
            offset += n


def sumsq_f32(tensors) -> torch.Tensor:
    """Sum of squares of every tensor, accumulated in float32."""
    return sum(t.float().pow(2).sum() for t in tensors)


def clip_scale(gnorm: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """min(1, clip/norm): the clip_grad_norm_ scale factor (epsilon as in
    the reference)."""
    return torch.clamp(clip_norm / (gnorm + 1e-12), max=1.0)


@torch.no_grad()
def broadcast_params(module: nn.Module) -> None:
    """Overwrite every rank's parameters and buffers with rank 0's — DDP's
    construction-time broadcast."""
    if not dist.is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)


def masked_tree_mean(
    metrics: dict[str, torch.Tensor], mask: torch.Tensor
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Global masked mean of per-row metrics: ``(means, count)``.

    ``metrics`` values are per-row vectors on this rank; ``mask`` is the
    matching (rows,) validity mask (0 on sampler-padded duplicate rows).
    One all-reduce carries the count and every numerator."""
    mask = mask.float()
    keys = list(metrics)
    parts = [mask.sum()] + [(metrics[k].float() * mask).sum() for k in keys]
    total = torch.stack(parts)
    _sum(total)
    den = total[0]
    return {k: total[i + 1] / den.clamp(min=1.0) for i, k in enumerate(keys)}, den
