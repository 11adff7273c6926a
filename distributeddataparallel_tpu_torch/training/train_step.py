"""The data-parallel train step and the masked eval step.

Counterpart of the DP and ZeRO layouts of ``make_train_step`` and of
``make_eval_step`` in ``distributeddataparallel_tpu/training/train_step.py``.
One step on one replica (one process per device):

1. forward, loss and backward on this rank's batch; with
   ``accum_steps > 1`` the batch splits into microbatches whose gradients
   accumulate locally (DDP's ``no_sync``) and are averaged;
2. one reduction per accumulation boundary: the mean over ranks, per leaf
   or in ~``bucket_bytes`` buckets (``parallel.data_parallel``), launched
   from backward's hooks under ``overlap`` (``parallel.overlap``), through
   a comm hook (bf16, PowerSGD), or ZeRO's reduce-scatter into this rank's
   shard (``parallel.zero``);
3. ``grad_clip``: the synced gradient scaled to that global L2 norm;
4. the optimizer step (on the shard under ZeRO, then the parameters
   gathered) and the schedule's advance;
5. the model's buffers (BatchNorm running statistics, which each rank
   updated from its own batch) made equal across ranks: ``buffer_sync=
   "mean"`` averages them, ``"broadcast"`` adopts rank 0's (DDP's
   ``broadcast_buffers``); either way in one coalesced collective.

The reported metrics (loss and the loss_fn's aux values) are averaged over
the microbatches and over ranks.

``nonfinite_guard=True`` adds the reference's numerical fault guard, decided
on the device with no host read: after the backward (after the last
microbatch under ``accum_steps``) the step computes one "all gradients
finite" flag and agrees on it across ranks with one ``all_reduce(MIN)``,
before any gradient enters the gradient sync.  A bad step's gradients
become exact zeros there (filled, not multiplied: NaN times 0 is NaN), so
no NaN reaches the wire, PowerSGD's error feedback or ZeRO's
reduce-scatter, and the sync, clip and update run on every step, as the
reference's do.  The update skips on the device: the fused optimizer reads
``found_inf`` (the parameters, moments and per-parameter ``step`` keep
their bits), ``LowBitMoments``' stored moments, PowerSGD's error feedback
and Q factors and the BatchNorm running buffers (snapshotted before the
forward, synced as usual, then selected) are put back by a select, and the
schedule's count (``training.optim.DeviceSchedule``) advances by the
verdict.  ``state.step`` advances on every step.  The state must come from
``build_optimizer`` with the guard (a fused optimizer and a
``DeviceSchedule`` or no schedule).  The step reports
``metrics["nonfinite_grad"]``, a device tensor (0.0 or 1.0) the train
loop reads when the step leaves its dispatch window;
``training.fault_tolerance.NonFiniteBreaker`` turns a run of them into a
hard stop.

``integrity_every=N`` arms the silent-data-corruption probe
(``training.integrity``, the reference's ``train_step.py:298-330`` and
``:743-806``): on a step whose ``state.step`` is a multiple of N (the host's
count: no device read) the step digests its INPUT state before the forward
and all-gathers the ``(n_ranks, n_leaves)`` digest matrix over the data
group, and decides on the device whether every row is equal.  That verdict
joins the guard's: keep = finite AND agree, through the same ``found_inf``,
buffer select and schedule count, so a mismatching step discards its update
and ``state.step`` advances.  Under ZeRO-1 the parameters' all-gather would
spread a corrupt rank's own shard into every rank, so on a cadence step
each rank keeps its own input parameters on a rejected verdict (a select
after the gather).  The step reports ``metrics["sdc_mismatch"]`` (0.0 or
1.0) and ``metrics["sdc_digest"]``; off cadence it computes no digest and
reports neither.  The state needs ``build_optimizer``'s fused update and
``DeviceSchedule`` (built under ``--integrity-every``, as under the guard).

``step(state, batch, seed)`` with an integer ``seed`` (the trainer's per-step
seed, a function of the run's seed, the epoch and the step) calls
``loss_fn(model, microbatch, seed=...)`` with the seed folded with this
rank and the microbatch's index, as the reference folds its step rng per
replica and microbatch (``train_step.py:457,520``): dropout masks differ
across ranks and microbatches and are the same on a rerun or a resume.
Without ``seed`` the loss_fn is called as ``loss_fn(model, microbatch)``.

Over a mesh (``runtime.distributed.make_mesh``) the step is the reference's
DP x CP x TP composition (``train_step.py:166-188``):

- ``cp_axis``: each rank's loss saw its chunk of the sequence, so the
  gradients (and the metrics) are first averaged over the ``seq`` group.
  That completes the gradient of the sharded loss; it is model math, not
  data-parallel sync.  The dropout seed folds in the ``seq`` index too.
  Under ``overlap`` the hooks instead mean each bucket over the joint
  data x seq group (``runtime.distributed.DATA_SEQ``: for equal group
  sizes the seq mean and the data mean in one, up to summation order), and
  ZeRO-2/3's hooks reduce-scatter over data first and average the shard
  over seq after (the scatter is a sum, so linear); PowerSGD keeps the
  reference's order, the seq mean and then the factors over data, so every
  rank's error feedback is its data position's.
- ``tp_axis``: the model's copy/reduce pairs leave every gradient complete
  per rank (a shard for the sharded leaves, the same whole gradient on
  every ``model`` rank for the replicated ones), so nothing is reduced
  over the ``model`` group; the clip's norm sums the sharded leaves' parts
  over it and counts the replicated leaves once.
- ``ep_axis`` (MoE expert parallelism, ``parallel.expert_parallel``): the
  same on the ``expert`` group for the expert stacks; the expert ranks of a
  data replica see the same rows and share its dropout seed.  The clip's
  norm sums the expert shards' parts over the ``expert`` group.
- then the data-parallel sync (any layout above) over the ``data`` group:
  an expert shard is averaged with the same shard of the other replicas.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces
from distributeddataparallel_tpu_torch.parallel import overlap as ov
from distributeddataparallel_tpu_torch.parallel import zero as z
from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    all_reduce_gradients,
    clip_scale,
    group_active,
    group_size,
    masked_tree_mean,
    sumsq_f32,
)
from distributeddataparallel_tpu_torch.parallel.expert_parallel import ep_dim
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import tp_dim
from distributeddataparallel_tpu_torch.parallel.powersgd import select_state, sync_model_grads
from distributeddataparallel_tpu_torch.ops.dropout import fold_seed
from distributeddataparallel_tpu_torch.runtime.distributed import (
    DATA_AXIS,
    DATA_SEQ,
    axis_group,
    axis_index,
    axis_size,
    current_mesh,
    get_rank,
    get_world_size,
)
from distributeddataparallel_tpu_torch.training.integrity import make_digest_fn
from distributeddataparallel_tpu_torch.training.optim import DeviceSchedule, is_fused
from distributeddataparallel_tpu_torch.training.state import TrainState

# loss_fn(model, batch[, seed=int]) -> (scalar loss, aux dict of scalars)
LossFn = Callable[[nn.Module, dict], tuple[torch.Tensor, dict]]


def _mean_over_ranks(values: dict[str, torch.Tensor], groups=(None,)) -> dict[str, torch.Tensor]:
    """The metrics averaged over each of ``groups`` in turn (the world by
    default; over a mesh the ``seq`` group, then the ``data`` group: the
    ``model`` ranks hold the same values)."""
    keys = list(values)
    vec = torch.stack([values[k].detach().float() for k in keys])
    for g in groups:
        if group_active(g):
            dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=g)
            vec = vec / group_size(g)
    return dict(zip(keys, vec.unbind()))


def _data_bound() -> bool:
    mesh = current_mesh()
    return mesh is not None and DATA_AXIS in mesh.axes


def _data_group():
    """The data-parallel group: the mesh's ``data`` axis, or the world
    (None) without a mesh."""
    return axis_group(DATA_AXIS) if _data_bound() else None


class _Axes:
    """The step's process groups, resolved from the current mesh when the
    step first runs: ``data`` (None: the world, as without a mesh), and
    the ``seq`` / ``model`` / ``expert`` groups with their sizes (size 1
    when unused)."""

    def __init__(self, cp_axis: str | None, tp_axis: str | None, ep_axis: str | None = None):
        self.data = _data_group()
        self.n_seq, self.n_tp, self.n_ep = axis_size(cp_axis), axis_size(tp_axis), axis_size(ep_axis)
        self.seq = axis_group(cp_axis) if self.n_seq > 1 else None
        self.seq_index = axis_index(cp_axis)
        # --overlap's group under CP: one mean over every (data, seq) rank
        # of this model line is the seq mean and then the data mean.
        self.data_seq = axis_group(DATA_SEQ) if self.seq is not None else self.data
        self.model = axis_group(tp_axis) if self.n_tp > 1 else None
        self.expert = axis_group(ep_axis) if self.n_ep > 1 else None
        self._bound = _data_bound()
        if (cp_axis or tp_axis or ep_axis) and not self._bound:
            raise ValueError(f"cp_axis/tp_axis/ep_axis need a mesh with the {DATA_AXIS!r} axis "
                             f"(runtime.distributed.make_mesh)")

    @property
    def data_index(self) -> int:
        return axis_index(DATA_AXIS) if self._bound else get_rank()

    @property
    def metric_groups(self):
        return ((self.seq,) if self.seq is not None else ()) + (self.data,)

    def seed(self, seed: int, micro: int) -> int:
        """The microbatch's dropout seed: folded with the data index (the
        rank without a mesh), the ``seq`` index under CP, and the
        microbatch; the ``model`` and ``expert`` ranks share it, as they
        share the activations it masks."""
        if self.seq is not None:
            return fold_seed(seed, self.data_index, self.seq_index, micro)
        return fold_seed(seed, self.data_index, micro)


def _seq_mean(tensors: list[torch.Tensor], group, n: int) -> None:
    """Average each tensor over the ``seq`` group, in place (ref ``pmean``
    over ``cp_axis``)."""
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)


def _model_axes_sumsq(model: nn.Module, ax: "_Axes") -> torch.Tensor:
    """The global sum of squares of the gradients under TP and EP (ref
    ``model_axes_sumsq``): the TP-sharded leaves' parts summed over the
    ``model`` group, the expert stacks' over the ``expert`` group, the
    replicated leaves (whole and equal on every rank) counted once."""
    named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
    total = sumsq_f32([g for n, g in named if tp_dim(n) is None and ep_dim(n) is None])
    for group, on in ((ax.model, lambda n: tp_dim(n) is not None), (ax.expert, lambda n: ep_dim(n) is not None)):
        if group is not None:
            part = torch.as_tensor(sumsq_f32([g for n, g in named if on(n)]), dtype=torch.float32,
                                   device=named[0][1].device)
            dist.all_reduce(part, group=group)
            total = part + total
    return total


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


def _all_finite(grads: list[torch.Tensor]) -> torch.Tensor:
    """1.0 if every element of every gradient is finite, else 0.0: an f32
    tensor on the gradients' device, from GradScaler's multi-tensor check
    (its unscale by 1.0 leaves the gradients untouched)."""
    found = torch.zeros(1, device=grads[0].device)
    torch._amp_foreach_non_finite_check_and_unscale_(grads, found, torch.ones_like(found))
    return 1.0 - found


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


def _check_layout(zero_level: int, bucket_bytes, overlap, grad_compress, accum_steps, buffer_sync,
                  cp_axis=None, tp_axis=None, fsdp=False, nonfinite_guard=False, ep_axis=None) -> None:
    """The reference's composition rules (``train_step.py:233-280``; FSDP's
    step, ``parallel/fsdp.py:493``, has none of the other layouts'
    options)."""
    if fsdp and (zero_level or bucket_bytes is not None or overlap or grad_compress or cp_axis
                 or nonfinite_guard or ep_axis):
        raise ValueError("fsdp=True owns its reduction (the gathers' reduce-scatters) and composes with "
                         "tp_axis, accum_steps and grad_clip only")
    if zero_level not in (0, 1, 2, 3):
        raise ValueError(f"zero={zero_level!r} (want False/True or a level 0-3)")
    if zero_level >= 2 and (tp_axis is not None or ep_axis is not None):
        raise ValueError("zero=2/3 shard over the data axis only; compose tp/ep with zero=1 or the fsdp path")
    if grad_compress == "powersgd" and (tp_axis is not None or ep_axis is not None):
        raise ValueError("grad_compress='powersgd' does not compose with tp_axis/ep_axis: the low-rank "
                         "factor reduction and error-feedback state are data-axis-only")
    if zero_level == 1 and (bucket_bytes is not None or overlap):
        raise ValueError("zero=1 does its own reduction; drop bucket_bytes/overlap (or use zero=2/3, "
                         "whose bucketed stream composes with both)")
    if grad_compress not in (None, "bf16", "powersgd"):
        raise ValueError(f"grad_compress must be None, 'bf16' or 'powersgd'; got {grad_compress!r}")
    if grad_compress is not None and zero_level:
        raise ValueError("grad_compress requires grad_sync=True and zero=False")
    if grad_compress == "powersgd" and overlap:
        raise ValueError("grad_compress='powersgd' replaces the bucketed all-reduce that overlap "
                         "schedules; pick one mechanism")
    if buffer_sync not in ("mean", "broadcast"):
        raise ValueError(f"buffer_sync must be 'mean' or 'broadcast'; got {buffer_sync!r}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")


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
    nonfinite_guard: bool = False,
    cp_axis: str | None = None,
    tp_axis: str | None = None,
    fsdp: bool = False,
    ep_axis: str | None = None,
    integrity_every: int | None = None,
    grad_sync: bool = True,
):
    """Build ``step(state, batch[, seed]) -> metrics`` for data parallelism
    (over the mesh's ``data`` group when a mesh is bound), composed
    with ``cp_axis`` / ``tp_axis`` / ``ep_axis`` (module docstring).

    The gradient reduction is one of the reference's layouts:

    - plain: the mean all-reduce per leaf, or in ``bucket_bytes`` buckets;
      ``grad_compress="bf16"`` sends f32 gradients in bf16 (the comm hook);
    - ``overlap=True``: the buckets (``bucket_bytes``, default 1 MiB) are
      all-reduced from backward's hooks as their gradients become ready
      (``parallel.overlap.DPOverlap``), on the boundary microbatch only;
    - ``grad_compress="powersgd"``: the low-rank hook on the reference's
      leaves, its state in ``state.comm_state`` (``parallel.powersgd``);
    - ``fsdp=True``: the state comes from ``parallel.fsdp.fsdp_state``;
      the model's gathers reduce-scatter every gradient into this rank's
      shard during backward, and the step divides the shards by the data
      ranks (``parallel.fsdp.make_fsdp_train_step`` builds this step);
    - ``zero=1|2|3`` (``True`` is 1): the state comes from
      ``parallel.zero.zero_state`` at the same level; the gradients are
      reduce-scattered into this rank's shard (per bucket at 2/3, from the
      hooks under ``overlap``), the shard is updated and the parameters
      gathered (at 3, gathered at the step's top and dropped after the
      backward).  The clip's global norm is the sum of the shards'.

    Composition is the reference's: ``zero=1`` rejects ``bucket_bytes`` and
    ``overlap``, ``grad_compress`` rejects ``zero``, PowerSGD rejects
    ``overlap`` (``ValueError``).  Under ``nonfinite_guard`` the verdict
    comes before any gradient leaves the rank: the hooks launch nothing,
    and a bad step's gradients are zeros before the wire, PowerSGD's error
    feedback or ZeRO's reduce-scatter see them.  ``integrity_every``: the
    replica digest (module docstring), with the reference's gates.

    ``grad_sync=False`` is the reference's ``DDP.no_sync()`` analog: the
    same compute with no gradient collective (the sequence mean under
    ``cp_axis`` is model math and stays); each rank applies its local
    gradients and the replicas diverge.  ``utils.metrics.overlap_probe``
    times it against the full step.  The reference's gates: it refuses
    ``zero``, ``bucket_bytes``, ``overlap``, ``grad_compress``,
    ``grad_clip`` and ``integrity_every`` (and the port's ``fsdp``).
    """
    zero_level = int(zero)
    if not grad_sync:
        # The reference's gates (train_step.py:254-287, :312-316).
        if zero_level or bucket_bytes is not None or overlap or fsdp:
            raise ValueError("grad_sync=False skips the reduction entirely; it does not compose with "
                             "zero/bucket_bytes/overlap (nor the fsdp path's own reduction)")
        if grad_compress is not None:
            raise ValueError("grad_compress requires grad_sync=True and zero=False")
        if grad_clip is not None:
            raise ValueError("grad_clip requires grad_sync=True")
        if integrity_every is not None:
            raise ValueError("integrity_every requires grad_sync=True: unsynced replicas legitimately "
                             "diverge, so a digest mismatch means nothing")
    _check_layout(zero_level, bucket_bytes, overlap, grad_compress, accum_steps, buffer_sync, cp_axis, tp_axis,
                  fsdp, nonfinite_guard, ep_axis)
    if integrity_every is not None:
        # The reference's gates (train_step.py:298-330): the digest compares
        # state that is bitwise replicated over the data axis.
        if integrity_every < 1:
            raise ValueError(f"integrity_every must be >= 1, got {integrity_every}")
        if zero_level >= 2 or fsdp:
            raise ValueError("integrity_every needs bitwise-replicated state to compare; zero=2/3 shard it "
                             "— use zero<=1")
        if tp_axis is not None or ep_axis is not None or cp_axis is not None:
            raise ValueError("integrity_every composes with the data axis only; tp/ep/cp-sharded layouts "
                             "have no replicated digest domain over 'data' alone")
    digests: list = []  # the digest function over the data group, made on the first cadence step
    hooks = {}  # the model's reducer hooks, made on the first step
    resolved: list[_Axes] = []

    def axes() -> _Axes:
        if not resolved:
            resolved.append(_Axes(cp_axis, tp_axis, ep_axis))
        return resolved[0]

    def reducer(state: TrainState):
        key = id(state.model)
        if key not in hooks:
            if zero_level:
                layout = state.zero

                def launch(b, scale):
                    if scale is not None:
                        layout.bucket_grad(b).mul_(scale)
                    return layout.reduce_scatter(b, async_op=True)

                hooks[key] = ov.BucketHooks(ov.zero_bucket_params(layout), launch)
            else:
                hooks[key] = ov.DPOverlap([p for p in state.model.parameters() if p.requires_grad],
                                          bucket_bytes=bucket_bytes, compress=grad_compress,
                                          group=axes().data_seq)
        return hooks[key]

    def step(state: TrainState, batch: dict, seed: int | None = None) -> dict[str, torch.Tensor]:
        ax = axes()
        model = state.model
        model.train()
        layout = state.zero
        if zero_level and (layout is None or layout.level != zero_level):
            raise ValueError(f"zero={zero_level} needs a state from parallel.zero.zero_state(level={zero_level})")
        if fsdp and (state.fsdp is None or state.fsdp.meta.tp_axis != tp_axis):
            raise ValueError("fsdp=True needs a state from parallel.fsdp.fsdp_state; pass tp_axis to BOTH "
                             "the config and the factory")
        if grad_compress == "powersgd" and state.comm_state is None:
            raise ValueError("grad_compress='powersgd' needs state.comm_state (parallel.powersgd.powersgd_state)")
        if (nonfinite_guard or integrity_every) and not (
                is_fused(state.optimizer) and isinstance(state.scheduler, (DeviceSchedule, type(None)))):
            raise ValueError("nonfinite_guard=True skips inside the fused optimizer: build the state with "
                             "training.optim.build_optimizer under --nan-guard (fused=True, a DeviceSchedule)")
        sdc_ok = None
        if integrity_every is not None and state.step % integrity_every == 0:
            # The INPUT state's fingerprint, before this step's reduction
            # could spread a corrupt rank's gradients.
            if not digests:
                digests.append(make_digest_fn(ax.data, zero_level))
            matrix = digests[0](state)
            sdc_ok = (matrix == matrix[0:1]).all()
        guarded = nonfinite_guard or sdc_ok is not None
        if zero_level == 3:
            layout.gather_params()
        params = [p for p in model.parameters() if p.requires_grad]
        if layout is not None:
            layout.prepare_grads()
        else:
            for p in params:
                p.grad = None
        if guarded:
            # The forward updates the BatchNorm running buffers; a skipped
            # step puts them back.
            buffers = model_buffers(model)
            saved = [b.detach().clone() for b in buffers]
        red = reducer(state) if overlap else None
        # Under the guard nothing launches before the verdict.
        armed = red is not None and not nonfinite_guard
        micro = [batch] if accum_steps == 1 else _split(batch, accum_steps)
        inv = 1.0 / accum_steps
        totals: dict[str, torch.Tensor] = {}
        for i, mb in enumerate(micro):
            kw = {} if seed is None else {"seed": ax.seed(seed, i)}
            loss, aux = loss_fn(model, mb, **kw)
            if armed and i == len(micro) - 1:
                # The boundary microbatch's hooks launch each bucket, its
                # accumulated gradient averaged over the microbatches first.
                red.arm(inv if accum_steps > 1 else None)
            loss.backward()  # .grad accumulates over microbatches
            for k, v in {"loss": loss, **aux}.items():
                totals[k] = totals.get(k, 0.0) + v.detach()
        grads = []
        for p in params:
            if p.grad is None:  # unused by the loss: a zero gradient
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if accum_steps > 1:
            if not armed:
                for g in ([layout.grad] if layout is not None else grads):
                    g.mul_(inv)
            totals = {k: v * inv for k, v in totals.items()}
        if ax.seq is not None and not armed:
            # Complete the sequence-sharded gradient (model math: before any
            # data-parallel layout sees it).  Armed hooks took it along:
            # DPOverlap's buckets mean over the joint data x seq group, and
            # ZeRO's shards are averaged over seq once their reduce-scatter
            # (a sum, so linear) is done.
            _seq_mean([layout.grad] if layout is not None else grads, ax.seq, ax.n_seq)
        ok = None
        if nonfinite_guard:
            finite = _all_finite([layout.grad] if layout is not None else grads)
            if dist.is_initialized():
                dist.all_reduce(finite, op=dist.ReduceOp.MIN)
            ok = finite.reshape(())
            # Zeroed, not skipped: every path below runs as on a good step,
            # and the selects and found_inf undo its effect on the device.
            bad = ok == 0
            with torch.no_grad():
                for g in ([layout.grad] if layout is not None else grads):
                    g.masked_fill_(bad, 0.0)
        finite, keep = ok, ok
        if sdc_ok is not None:
            agree = sdc_ok.to(torch.float32)
            keep = agree if ok is None else ok * agree
        # Under ZeRO-1 the parameters' all-gather would copy a corrupt rank's
        # own shard into every rank: on a rejected verdict each rank keeps
        # its own input parameters, a select on cadence steps only.
        own = state.zero.flat.clone() if sdc_ok is not None and zero_level == 1 else None
        _reduce_and_update(state, grads, red, ax, armed, keep)
        if own is not None:
            with torch.no_grad():
                state.zero.flat.copy_(torch.where(keep.reshape(()) > 0, state.zero.flat, own))
        if get_world_size() > 1:  # one rank's buffers are already its own
            sync_buffers(model_buffers(model), buffer_sync)
        metrics = _mean_over_ranks(totals, ax.metric_groups)
        if guarded:
            with torch.no_grad():
                for b, old in zip(buffers, saved):
                    b.copy_(torch.where(keep == 0, old, b))
        if nonfinite_guard:
            metrics["nonfinite_grad"] = 1.0 - finite
        if sdc_ok is not None:
            metrics["sdc_mismatch"] = 1.0 - agree
            metrics["sdc_digest"] = matrix
        return metrics

    def _reduce_and_update(state: TrainState, grads: list[torch.Tensor], red, ax: _Axes, armed: bool,
                           ok: torch.Tensor | None) -> None:
        if fsdp:
            # The backward's reduce-scatters summed the data ranks'
            # gradients into the shards: their mean, then the global clip.
            n = group_size(state.fsdp.group)
            if n > 1:
                for g in grads:
                    g.div_(n)
            if grad_clip is not None:
                scale = clip_scale(torch.sqrt(state.fsdp.grad_sumsq()), grad_clip)
                for g in grads:
                    g.mul_(scale)
            state.apply_gradients()
            return
        if zero_level:
            reduced = False
            if red is not None:
                for work in red.finish():
                    if work is not None:
                        work.wait()
                reduced = True
                if armed and ax.seq is not None:
                    layout = state.zero
                    _seq_mean([layout.grad_shard(b) for b in range(layout.plan.n_buckets)], ax.seq, ax.n_seq)
            update = {1: z.zero_update, 2: z.zero2_update, 3: z.zero3_update}[zero_level]
            update(state, grad_clip, reduced=reduced, ok=ok)
            return
        if red is not None:
            red.finish()
        elif grad_compress == "powersgd":
            new = sync_model_grads(jax_leaf_pieces(state.model), state.comm_state, ax.data)
            state.comm_state = new if ok is None else select_state(ok, new, state.comm_state)
        elif grad_sync:
            all_reduce_gradients(grads, bucket_bytes=bucket_bytes, compress=grad_compress, group=ax.data)
        if grad_clip is not None:
            # Grads are complete per rank after the sync (and the seq
            # mean), so the local norm is the global norm; under TP / EP
            # the sharded leaves' parts sum over their groups.
            sumsq = (sumsq_f32(grads) if ax.model is None and ax.expert is None
                     else _model_axes_sumsq(state.model, ax))
            scale = clip_scale(torch.sqrt(sumsq), grad_clip)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        state.apply_gradients(ok)

    return step


def make_eval_step(metric_fn: Callable[[nn.Module, dict], dict], *, seq_axis: str | None = None):
    """``eval_step(model, batch) -> (means, count)`` without gradients, in
    eval mode (BatchNorm normalizes with its running statistics).

    ``metric_fn(model, batch)`` returns per-row metric vectors; the batch
    carries ``"valid"`` (``DataLoader(with_mask=True)``), 0 on the sampler's
    padded duplicate rows.  The step returns the global masked means and the
    global valid-row count, so weighting each batch's means by its count
    gives the mean over unique samples.  Over a mesh the masked sums run
    over the ``data`` group; with ``seq_axis`` (the reference's
    ``make_cp_eval_step``) each row's values are first averaged over the
    sequence chunks."""
    groups: list = []

    @torch.no_grad()
    def eval_step(model: nn.Module, batch: dict):
        if not groups:
            groups.append(_data_group())
            groups.append(axis_group(seq_axis) if axis_size(seq_axis) > 1 else None)
        model.eval()
        batch = dict(batch)
        mask = batch.pop("valid")
        return masked_tree_mean(metric_fn(model, batch), mask, groups[0], groups[1])

    return eval_step
