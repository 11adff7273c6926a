"""The data-parallel train step and the masked eval step.

Counterpart of the DP subset of ``make_train_step`` and of ``make_eval_step``
in ``distributeddataparallel_tpu/training/train_step.py``.  One step on one
replica (one process per device):

1. forward, loss and backward on this rank's batch; with
   ``accum_steps > 1`` the batch splits into microbatches whose gradients
   accumulate locally (DDP's ``no_sync``) and are averaged;
2. one all-reduce per accumulation boundary: the mean over ranks, per leaf
   or in ~``bucket_bytes`` buckets (``parallel.data_parallel``);
3. ``grad_clip``: the synced gradient scaled to that global L2 norm;
4. the optimizer step and the schedule's advance;
5. the model's buffers (BatchNorm running statistics, which each rank
   updated from its own batch) made equal across ranks: ``buffer_sync=
   "mean"`` averages them, ``"broadcast"`` adopts rank 0's (DDP's
   ``broadcast_buffers``); either way in one coalesced collective.

The reported metrics (loss and the loss_fn's aux values) are averaged over
the microbatches and over ranks.

``step(state, batch, seed)`` with an integer ``seed`` (the trainer's per-step
seed, a function of the run's seed, the epoch and the step) calls
``loss_fn(model, microbatch, seed=...)`` with the seed folded with this
rank and the microbatch's index, as the reference folds its step rng per
replica and microbatch (``train_step.py:457,520``): dropout masks differ
across ranks and microbatches and are the same on a rerun or a resume.
Without ``seed`` the loss_fn is called as ``loss_fn(model, microbatch)``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    all_reduce_gradients,
    clip_scale,
    masked_tree_mean,
    sumsq_f32,
)
from distributeddataparallel_tpu_torch.ops.dropout import fold_seed
from distributeddataparallel_tpu_torch.runtime.distributed import get_rank, get_world_size
from distributeddataparallel_tpu_torch.training.state import TrainState

# loss_fn(model, batch[, seed=int]) -> (scalar loss, aux dict of scalars)
LossFn = Callable[[nn.Module, dict], tuple[torch.Tensor, dict]]


def _mean_over_ranks(values: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    keys = list(values)
    vec = torch.stack([values[k].detach().float() for k in keys])
    if dist.is_initialized():
        dist.all_reduce(vec, op=dist.ReduceOp.SUM)
        vec = vec / dist.get_world_size()
    return dict(zip(keys, vec.unbind()))


def model_buffers(model: nn.Module) -> list[torch.Tensor]:
    """The model's state outside its parameters: every floating-point buffer
    saved in its ``state_dict`` (BatchNorm running statistics; not the
    derived non-persistent ones such as rotary tables)."""
    names = {name for name, _ in model.named_buffers()}
    return [t for k, t in model.state_dict(keep_vars=True).items()
            if k in names and t.is_floating_point()]


@torch.no_grad()
def sync_buffers(buffers: list[torch.Tensor], mode: str) -> None:
    """Make ``buffers`` equal on every rank, in place, with one collective:
    ``"mean"`` averages them, ``"broadcast"`` copies rank 0's."""
    if not buffers:
        return
    flat = torch.cat([b.reshape(-1).float() for b in buffers])
    if mode == "mean":
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(dist.get_world_size())
    else:
        dist.broadcast(flat, src=0)
    offset = 0
    for b in buffers:
        b.copy_(flat[offset : offset + b.numel()].view_as(b))
        offset += b.numel()


def _split(batch: dict, n: int) -> list[dict]:
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(
                f"per-replica batch {v.shape[0]} ({k!r}) is not divisible by "
                f"accum_steps={n}; choose a batch size that is a multiple of "
                f"accum_steps"
            )
    parts = {k: v.chunk(n) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(
    loss_fn: LossFn,
    *,
    accum_steps: int = 1,
    bucket_bytes: int | None = None,
    grad_clip: float | None = None,
    buffer_sync: str = "mean",
    overlap: bool = False,
    zero: bool | int = False,
    grad_compress: str | None = None,
):
    """Build ``step(state, batch) -> metrics`` for plain data parallelism.

    ``overlap``, ``zero`` and ``grad_compress`` are the reference's other
    layouts; they raise ``NotImplementedError`` until ported (ROADMAP.md
    Queue 1: parallel/overlap.py, parallel/zero.py, parallel/powersgd.py).
    """
    for flag, value, item in (
        ("overlap", overlap, "parallel/overlap.py"),
        ("zero", zero, "parallel/zero.py"),
        ("grad_compress", grad_compress, "parallel/powersgd.py and the bf16 comm hook"),
    ):
        if value:
            raise NotImplementedError(
                f"make_train_step({flag}={value!r}) is not ported yet: "
                f"ROADMAP.md Queue 1, {item}"
            )
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if buffer_sync not in ("mean", "broadcast"):
        raise ValueError(f"buffer_sync must be 'mean' or 'broadcast'; got {buffer_sync!r}")

    def step(state: TrainState, batch: dict, seed: int | None = None) -> dict[str, torch.Tensor]:
        model = state.model
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        totals: dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            kw = {} if seed is None else {"seed": fold_seed(seed, get_rank(), i)}
            loss, aux = loss_fn(model, mb, **kw)
            loss.backward()  # .grad accumulates over microbatches
            for k, v in {"loss": loss, **aux}.items():
                totals[k] = totals.get(k, 0.0) + v.detach()
        grads = []
        for p in params:
            if p.grad is None:  # unused by the loss: a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            for g in grads:
                g.mul_(inv)
            totals = {k: v * inv for k, v in totals.items()}
        all_reduce_gradients(grads, bucket_bytes=bucket_bytes)
        if grad_clip is not None:
            # Grads are complete per rank after the sync, so the local norm
            # is the global norm.
            scale = clip_scale(torch.sqrt(sumsq_f32(grads)), grad_clip)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        state.apply_gradients()
        if get_world_size() > 1:  # one rank's buffers are already its own
            sync_buffers(model_buffers(model), buffer_sync)
        return _mean_over_ranks(totals)

    return step


def make_eval_step(metric_fn: Callable[[nn.Module, dict], dict]):
    """``eval_step(model, batch) -> (means, count)`` without gradients, in
    eval mode (BatchNorm normalizes with its running statistics).

    ``metric_fn(model, batch)`` returns per-row metric vectors; the batch
    carries ``"valid"`` (``DataLoader(with_mask=True)``), 0 on the sampler's
    padded duplicate rows.  The step returns the global masked means and the
    global valid-row count, so weighting each batch's means by its count
    gives the mean over unique samples."""

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: dict):
        model.eval()
        batch = dict(batch)
        mask = batch.pop("valid")
        return masked_tree_mean(metric_fn(model, batch), mask)

    return eval_step
