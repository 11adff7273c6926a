"""ZeRO weight-update sharding across the data-parallel ranks.

Counterpart of ``distributeddataparallel_tpu/parallel/zero.py``.  Plain DP
keeps the optimizer state whole on every rank; ZeRO keeps 1/N of it on each:

    grads --reduce_scatter--> this rank's 1/N gradient shard (the mean)
          --optimizer step on the shard (its moments live only here)
          --all_gather--> every rank's updated parameters

The update is DDP's, elementwise; the wire carries about one all-reduce.

Layout.  Parameters and gradients are flat f32 vectors in the reference's
element order: its leaves in ``jax.tree.leaves`` order, each leaf's
elements row-major in the reference's layout (``models.io.jax_leaf_pieces``:
Dense kernels transposed, conv kernels HWIO, stacked ``scan_layers``
leaves).  So a rank's shard of the moments holds the same elements as the
reference's rank's, and the per-bucket padding falls where the reference's
does.

- level 1: one flat vector, padded to a multiple of the world size
  (``flat_size``); rank r owns elements ``[r*chunk, (r+1)*chunk)``.
- levels 2 and 3: ``bucket_plan``: the leaves grouped into ~``bucket_bytes``
  buckets in reverse leaf order, each bucket padded to a multiple of the
  world size; a rank's shard is its sub-chunk of every bucket.  Each bucket
  is reduce-scattered (and its parameters gathered) on its own.
- level 3: the parameters stay sharded between steps; the step gathers
  them at its top and frees them after the backward.

The trainer's state (``ZeroLayout``) holds the model's parameters as views
into one flat parameter buffer (levels 1 and 2) and their ``.grad`` as views
into one flat gradient buffer, as DDP's ``gradient_as_bucket_view`` does:
backward accumulates straight into the flat layout, the reduce-scatter runs
in place into this rank's slice of it, and the all-gather in place into the
parameter buffer, so no second copy of the gradients or parameters exists.
The optimizer (built by the caller over ``ZeroLayout.shard_params``, one
flat piece per bucket, or several for a bucket over ``MAX_PIECE``) steps
the shard in place.  ``LowBitMoments`` keeps
its moments in bf16 or blockwise int8 between steps.

The functions ``flatten_f32`` .. ``gather_params_bucketed`` are the
reference's, on lists of tensors in its leaf order, with the collectives of
the default process group (none without one).

Over a mesh (``runtime.distributed.make_mesh``) the layout shards over the
``data`` axis's group (``group=``): under context parallelism the ``seq``
ranks hold the same shard, under tensor or expert parallelism (level 1
only, as the reference) each ``model`` / ``expert`` rank flattens its own
shard of the parameters (its heads and hidden units, its experts), so the
optimizer state is sharded n_data x n_tp x n_ep ways and the clip's norm
weights each leaf ``1 / (the model-axis ranks holding it whole)`` and sums
over the data group and each model-axis group (``tp_axis``, ``ep_axis``).
A pipeline stage (``parallel.pipeline_parallel``, ``pp_axis``) flattens its
layers and the replicated leaves the same way: each stage's flat vector is
its own, sharded over its data group.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces, port_view, ref_view
from distributeddataparallel_tpu_torch.ops import quant
from distributeddataparallel_tpu_torch.parallel.data_parallel import (
    clip_scale,
    flat_chunk_sumsq,
    group_active,
    plan_buckets,
    sumsq_f32,
)
from distributeddataparallel_tpu_torch.parallel.expert_parallel import flax_ep_dim
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import flax_tp_dim
from distributeddataparallel_tpu_torch.runtime.distributed import axis_group, axis_size, get_rank, get_world_size
from distributeddataparallel_tpu_torch.training.state import TrainState

#: Default bucket size of the level 2/3 layout (the reference's).
ZERO_BUCKET_BYTES = 1 << 20

#: Most elements of one optimizer piece: a bucket's shard longer than this
#: is stepped as several pieces, so ``LowBitMoments`` decompresses at most
#: this many elements of each moment at once (a multiple of MOMENT_BLOCK).
MAX_PIECE = 1 << 25


def _numel(leaf) -> int:
    return leaf if isinstance(leaf, int) else leaf.numel()


def flat_size(leaves, num_shards: int) -> tuple[int, int]:
    """``(padded_total, chunk)``: the elements of ``leaves`` (tensors or
    sizes) padded to a multiple of ``num_shards``, and one shard's length."""
    total = sum(_numel(leaf) for leaf in leaves)
    chunk = -(-total // num_shards)
    return chunk * num_shards, chunk


def flatten_f32(leaves: list[torch.Tensor], padded: int, cast: str = "f32") -> torch.Tensor:
    """The leaves concatenated into one vector zero-padded to ``padded``.
    ``cast``: ``"f32"`` upcasts every leaf (the f32 master copy);
    ``"preserve"`` keeps the leaves' one dtype and raises on a mix;
    ``"strict"`` raises unless every leaf is f32."""
    dtypes = {leaf.dtype for leaf in leaves}
    if cast == "f32":
        parts = [leaf.reshape(-1).float() for leaf in leaves]
    elif cast == "preserve":
        if len(dtypes) > 1:
            raise TypeError(f"flatten_f32(cast='preserve'): leaves mix dtypes {sorted(map(str, dtypes))}; "
                            "concatenation would silently promote them")
        parts = [leaf.reshape(-1) for leaf in leaves]
    elif cast == "strict":
        bad = dtypes - {torch.float32}
        if bad:
            raise TypeError(f"flatten_f32(cast='strict'): non-f32 leaves present ({sorted(map(str, bad))})")
        parts = [leaf.reshape(-1) for leaf in leaves]
    else:
        raise ValueError(f"flatten_f32: unknown cast={cast!r} (want 'f32', 'preserve' or 'strict')")
    flat = torch.cat(parts)
    return torch.nn.functional.pad(flat, (0, padded - flat.shape[0]))


def unflatten(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Inverse of ``flatten_f32``: ``like``'s shapes and dtypes."""
    out, offset = [], 0
    for leaf in like:
        n = leaf.numel()
        out.append(flat[offset : offset + n].view(leaf.shape).to(leaf.dtype))
        offset += n
    return out


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """The bucketed flat layout: ``buckets`` holds each bucket's leaf
    indices in flattening order, ``padded`` each bucket's length padded to
    a multiple of the world size, ``sub`` one rank's sub-chunk of each
    (``padded // world``), ``local`` one rank's shard length."""

    buckets: tuple[tuple[int, ...], ...]
    padded: tuple[int, ...]
    sub: tuple[int, ...]
    local: int

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)

    @property
    def offsets(self) -> list[int]:
        """Each bucket's start in the full flat vector."""
        out, o = [], 0
        for p in self.padded:
            out.append(o)
            o += p
        return out


def _plan(groups, sizes, num_shards) -> BucketPlan:
    padded = [-(-sum(sizes[i] for i in g) // num_shards) * num_shards for g in groups]
    sub = [p // num_shards for p in padded]
    return BucketPlan(tuple(tuple(g) for g in groups), tuple(padded), tuple(sub), sum(sub))


def bucket_plan(leaves, num_shards: int, bucket_bytes: int | None = None) -> BucketPlan:
    """The level 2/3 layout of ``leaves`` (tensors or sizes) over
    ``num_shards``: ``plan_buckets`` on the f32 byte sizes (reverse leaf
    order, the order gradients become ready in the reference's backward),
    each bucket padded on its own."""
    sizes = [_numel(leaf) for leaf in leaves]
    groups = plan_buckets([n * 4 for n in sizes], bucket_bytes or ZERO_BUCKET_BYTES)
    return _plan(groups, sizes, num_shards)


def flat_plan(leaves, num_shards: int) -> BucketPlan:
    """The level 1 layout as a plan: one bucket of every leaf in leaf
    order, padded as ``flat_size`` pads."""
    sizes = [_numel(leaf) for leaf in leaves]
    return _plan([list(range(len(sizes)))], sizes, num_shards)


def _flatten_bucket(leaves, idxs, padded_b) -> torch.Tensor:
    return flatten_f32([leaves[i] for i in idxs], padded_b)


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor) -> None:
    if dist.is_initialized():
        dist.reduce_scatter_tensor(out, inp)
    else:
        out.copy_(inp[: out.numel()])


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    if dist.is_initialized():
        dist.all_gather_into_tensor(out, inp, group=group)
    else:
        out[: inp.numel()].copy_(inp)


def scatter_grads_bucketed(grads: list[torch.Tensor], plan: BucketPlan, num_shards: int) -> torch.Tensor:
    """This rank's per-leaf gradients -> its reduce-scattered flat shard,
    the mean over the ranks: one ``reduce_scatter_tensor`` per bucket."""
    subs = []
    for idxs, padded_b, sub_b in zip(plan.buckets, plan.padded, plan.sub):
        out = torch.empty(sub_b, dtype=torch.float32, device=grads[0].device)
        _reduce_scatter(out, _flatten_bucket(grads, idxs, padded_b))
        subs.append(out)
    return torch.cat(subs) / num_shards


def shard_params_bucketed(params: list[torch.Tensor], plan: BucketPlan, rank: int) -> torch.Tensor:
    """Replicated parameters -> this rank's flat f32 shard in ``plan``'s
    layout (element i is the parameter of element i of the scattered
    gradient shard)."""
    return torch.cat([
        _flatten_bucket(params, idxs, padded_b)[rank * sub_b : (rank + 1) * sub_b]
        for idxs, padded_b, sub_b in zip(plan.buckets, plan.padded, plan.sub)
    ])


def gather_params_bucketed(shard: torch.Tensor, like: list[torch.Tensor], plan: BucketPlan) -> list[torch.Tensor]:
    """This rank's flat shard -> every leaf, one ``all_gather_into_tensor``
    per bucket."""
    out: list = [None] * len(like)
    off = 0
    for idxs, padded_b, sub_b in zip(plan.buckets, plan.padded, plan.sub):
        full = torch.empty(padded_b, dtype=torch.float32, device=shard.device)
        _all_gather(full, shard[off : off + sub_b].contiguous())
        for i, t in zip(idxs, unflatten(full, [like[i] for i in idxs])):
            out[i] = t
        off += sub_b
    return out


# --------------------------------------------------------------- the state --

@dataclasses.dataclass
class _Piece:
    param: nn.Parameter
    kind: str
    shape: torch.Size
    offset: int  # in the full flat vector


class ZeroLayout:
    """A model's parameters and gradients in the ZeRO flat layout of
    ``level`` on this rank of ``world`` (see the module docstring).

    ``shard_params`` are the flat pieces (one per bucket, split at
    ``MAX_PIECE``) this rank updates: the optimizer is built over them.  Levels 1 and 2 keep the
    full flat parameter vector ``flat`` with the model's parameters as
    views into it; level 3 keeps only the shard and gathers the rest inside
    the step (``gather_params`` / ``release_params``, ``full_params`` for
    evaluation and saving)."""

    def __init__(self, model: nn.Module, level: int, *, bucket_bytes: int | None = None,
                 rank: int | None = None, world: int | None = None, group=None, tp_axis: str | None = None,
                 ep_axis: str | None = None, pp_axis: str | None = None):
        level = int(level)
        if level not in (1, 2, 3):
            raise ValueError(f"ZeRO level={level!r} (want 1, 2 or 3)")
        n_tp, n_ep, n_pp = axis_size(tp_axis), axis_size(ep_axis), axis_size(pp_axis)
        if (n_tp > 1 or n_ep > 1 or n_pp > 1) and level != 1:
            raise ValueError("zero=2/3 shard over the data axis only; compose tp/ep/pp with zero=1 or the fsdp path")
        self.model, self.level, self.group = model, level, group
        if group is not None:
            rank, world = dist.get_rank(group), dist.get_world_size(group)
        self.rank = get_rank() if rank is None else rank
        self.world = get_world_size() if world is None else world
        named = jax_leaf_pieces(model)
        # Under TP / EP / PP: how many model-axis ranks hold each leaf whole
        # (the clip's weights; None without any) and those axes' groups.  A
        # pipeline stage holds its own layers and every replicated leaf.
        self.dup = ([(1 if flax_tp_dim(path) is not None else n_tp) * (1 if flax_ep_dim(path) is not None else n_ep)
                     * (1 if path.split("/")[0] == "layers" else n_pp)
                     for path, _ in named] if n_tp > 1 or n_ep > 1 or n_pp > 1 else None)
        self.model_groups = [axis_group(a) for a, n in ((tp_axis, n_tp), (ep_axis, n_ep), (pp_axis, n_pp)) if n > 1]
        leaf_pieces = [[(p, kind) for p, kind, _ in pieces] for _, pieces in named]
        self.sizes = [sum(p.numel() for p, _ in pieces) for pieces in leaf_pieces]
        self.plan = (flat_plan(self.sizes, self.world) if level == 1
                     else bucket_plan(self.sizes, self.world, bucket_bytes))
        params = [p for pieces in leaf_pieces for p, _ in pieces]
        if len({id(p) for p in params}) != len(list(model.parameters())):
            raise ValueError("the reference layout does not cover the model's parameters")
        self.device = params[0].device
        self.total = sum(self.plan.padded)
        # Every piece's place in the full flat vector.
        self.pieces: list[_Piece] = []
        self.bucket_pieces: list[list[_Piece]] = []
        for idxs, start in zip(self.plan.buckets, self.plan.offsets):
            o, bp = start, []
            for i in idxs:
                for p, kind in leaf_pieces[i]:
                    bp.append(_Piece(p, kind, p.shape, o))
                    o += p.numel()
            self.bucket_pieces.append(bp)
            self.pieces += bp
        with torch.no_grad():
            full = torch.zeros(self.total, dtype=torch.float32, device=self.device)
            for pc in self.pieces:
                full[pc.offset : pc.offset + pc.param.numel()].copy_(
                    ref_view(pc.param.detach(), pc.kind).reshape(-1))
        self.grad = None  # the flat gradient buffer, made on first use
        if level == 3:
            self.shard = torch.cat([full[o + self.rank * s : o + (self.rank + 1) * s]
                                    for o, s in zip(self.plan.offsets, self.plan.sub)])
            del full
            self.flat = None
            self.release_params()
            base, offs = self.shard, self._shard_offsets()
        else:
            self.flat, self.shard = full, None
            self._point_params(full)
            base, offs = full, [o + self.rank * s for o, s in zip(self.plan.offsets, self.plan.sub)]
        # (bucket, start in its sub-chunk, length) of each optimizer piece.
        self.piece_slices = [(b, a, min(MAX_PIECE, s - a)) for b, s in enumerate(self.plan.sub)
                             for a in range(0, s, MAX_PIECE)]
        self.shard_params = [nn.Parameter(base[offs[b] + a : offs[b] + a + n], requires_grad=True)
                             for b, a, n in self.piece_slices]

    def optimizer_state(self, flats: dict, scalars: dict, param_groups: list) -> dict:
        """An optimizer ``state_dict`` over ``shard_params`` from this
        rank's whole shard of each per-element state (``flats[key]``, its
        buckets' sub-chunks in order) and the scalars every piece shares
        (AdamW's step): what a reshard loads (``training.elastic``,
        ``runtime.elastic_gang``)."""
        offs, state = self._shard_offsets(), {}
        for i, (b, a, n) in enumerate(self.piece_slices):
            st = {k: v[offs[b] + a : offs[b] + a + n].clone() for k, v in flats.items()}
            st.update((k, v.clone()) for k, v in scalars.items())
            if st:
                state[i] = st
        return {"state": state, "param_groups": param_groups}

    def _shard_offsets(self) -> list[int]:
        out, o = [], 0
        for s in self.plan.sub:
            out.append(o)
            o += s
        return out

    def _point_params(self, full: torch.Tensor) -> None:
        for pc in self.pieces:
            pc.param.data = port_view(full[pc.offset : pc.offset + pc.shape.numel()], pc.shape, pc.kind)

    def _point_grads(self, full: torch.Tensor) -> None:
        for pc in self.pieces:
            pc.param.grad = port_view(full[pc.offset : pc.offset + pc.shape.numel()], pc.shape, pc.kind)

    # ------------------------------------------------------ the step -------
    def prepare_grads(self) -> None:
        """Zero the flat gradient buffer and make every parameter's
        ``.grad`` its view into it: backward accumulates in place there."""
        if self.grad is None:
            self.grad = torch.zeros(self.total, dtype=torch.float32, device=self.device)
        else:
            self.grad.zero_()
        self._point_grads(self.grad)

    def bucket_grad(self, b: int) -> torch.Tensor:
        o = self.plan.offsets[b]
        return self.grad[o : o + self.plan.padded[b]]

    def grad_shard(self, b: int) -> torch.Tensor:
        """This rank's slice of bucket ``b``'s gradient: where its
        reduce-scatter lands."""
        s = self.plan.sub[b]
        return self.bucket_grad(b)[self.rank * s : (self.rank + 1) * s]

    def reduce_scatter(self, b: int, async_op: bool = False):
        """Bucket ``b``'s gradient summed over the ranks into this rank's
        slice of it, in place; a work handle with ``async_op``."""
        if not dist.is_initialized():
            return None
        return dist.reduce_scatter_tensor(self.grad_shard(b), self.bucket_grad(b), group=self.group,
                                          async_op=async_op)

    def finish_grads(self) -> None:
        """The reduced shard divided by the world size (the mean, as the
        reference divides) and handed to ``shard_params`` as their grads."""
        for b in range(self.plan.n_buckets):
            self.grad_shard(b).div_(self.world)
        for sp, (b, a, n) in zip(self.shard_params, self.piece_slices):
            sp.grad = self.grad_shard(b)[a : a + n]

    def all_gather_params(self) -> None:
        """Levels 1 and 2: every rank's updated shard into the full flat
        parameter vector, in place, one collective per bucket."""
        if not dist.is_initialized():
            return
        for b, o in enumerate(self.plan.offsets):
            full = self.flat[o : o + self.plan.padded[b]]
            s = self.plan.sub[b]
            dist.all_gather_into_tensor(full, full[self.rank * s : (self.rank + 1) * s], group=self.group)

    def gather_params(self) -> None:
        """Level 3: the full parameters from every rank's shard, one
        all-gather per bucket, with the model's parameters as views of
        them until ``release_params``."""
        full = torch.empty(self.total, dtype=torch.float32, device=self.device)
        for b, (o, so) in enumerate(zip(self.plan.offsets, self._shard_offsets())):
            s = self.plan.sub[b]
            _all_gather(full[o : o + self.plan.padded[b]], self.shard[so : so + s], self.group)
        self.flat = full
        self._point_params(full)

    def load_shard_from_flat(self) -> None:
        """Level 3: this rank's shard from the gathered parameters (the
        model's views into ``flat``, after a checkpoint was loaded into
        them)."""
        if self.level != 3:
            return
        with torch.no_grad():
            for (o, so), s in zip(zip(self.plan.offsets, self._shard_offsets()), self.plan.sub):
                self.shard[so : so + s].copy_(self.flat[o + self.rank * s : o + (self.rank + 1) * s])

    def release_params(self) -> None:
        """Level 3: drop the gathered parameters (the shard stays)."""
        self.flat = None
        for pc in self.pieces:
            pc.param.data = torch.empty(0, dtype=torch.float32, device=self.device)

    @contextlib.contextmanager
    def full_params(self):
        """The model's full parameters for the block (a gather and a
        release at level 3; the parameters are already whole otherwise).
        A collective at level 3: every rank enters it."""
        if self.level != 3 or self.flat is not None:
            yield
            return
        self.gather_params()
        try:
            yield
        finally:
            self.release_params()


def zero3_gather_params(state) -> dict[str, torch.Tensor]:
    """The full (replicated) parameters of a level-3 state, as a
    ``state_dict`` of copies: one gather, for evaluation or export."""
    with state.zero.full_params():
        return {k: v.detach().clone() for k, v in state.model.named_parameters()}


# ------------------------------------------------------- low-bit moments --

class LowBitMoments:
    """``optimizer``'s moment vectors stored in ``moment_dtype`` between
    steps: ``"bf16"`` (2 bytes an element) or ``"int8"`` (blockwise
    dynamic-codebook int8, ~1 byte; ``ops.quant.Q8Moment``).  Each step
    decompresses a parameter's moments, runs the optimizer's own update on
    it in f32 and recompresses them with stochastic rounding (noise from a
    generator seeded with ``seed``), so the rounding error is zero-mean.
    The parameters are stepped one at a time (one bucket's piece each under
    ZeRO-2/3): the update is elementwise, and only one piece's f32 moments
    exist at once.  Vectors under ``min_size`` elements and scalars (step
    counts) stay f32."""

    def __init__(self, optimizer: torch.optim.Optimizer, moment_dtype: str, *, seed: int = 0,
                 min_size: int = 256):
        if moment_dtype not in ("bf16", "int8"):
            raise ValueError(f"LowBitMoments: moment_dtype={moment_dtype!r} (want 'bf16' or 'int8')")
        self.optimizer, self.moment_dtype, self.min_size = optimizer, moment_dtype, min_size
        device = optimizer.param_groups[0]["params"][0].device
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self.packed: dict[int, dict] = {}  # param index -> {state key: compressed}

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _compressible(self, v) -> bool:
        return isinstance(v, torch.Tensor) and v.is_floating_point() and v.ndim == 1 \
            and v.numel() >= self.min_size

    def _pack(self, i: int, p) -> None:
        state = self.optimizer.state[p]
        for k in [k for k, v in state.items() if self._compressible(v)]:
            v = state.pop(k)
            self.packed.setdefault(i, {})[k] = (
                quant.quantize_moment_int8(v, self.generator) if self.moment_dtype == "int8"
                else quant.stochastic_round_bf16(v, self.generator))

    def _unpack(self, i: int, p) -> None:
        for k, v in self.packed.pop(i, {}).items():
            self.optimizer.state[p][k] = (quant.dequantize_moment(v) if isinstance(v, quant.Q8Moment)
                                          else v.float())

    @torch.no_grad()
    def step(self, ok: torch.Tensor | None = None) -> None:
        """The optimizer's step, one parameter at a time.  With the
        nonfinite guard's verdict ``ok`` (a 0-d tensor on the device; the
        optimizer then skips through its ``found_inf``), a skipped step's
        recompressed moments are put back to the stored ones by a select on
        the device: the stored piece is kept until its select, one
        parameter's compressed moments at a time (bf16: 2 bytes an element
        a moment; int8: 1 byte and 4 a block of 256)."""
        params = self.params
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        keep = None if ok is None else ok.reshape(()) > 0
        try:
            for i, (p, g) in enumerate(zip(params, grads)):
                if g is None:
                    continue
                p.grad = g
                old = self.packed.get(i)
                self._unpack(i, p)
                self.optimizer.step()
                self._pack(i, p)
                if keep is not None and old is not None:
                    new = self.packed[i]
                    self.packed[i] = {k: _select(keep, new[k], old[k]) for k in new}
                p.grad = None
        finally:
            for p, g in zip(params, grads):
                p.grad = g

    def nbytes(self) -> dict:
        """Bytes of the stored moments: compressed and f32-left."""
        packed = sum(v.nbytes() if isinstance(v, quant.Q8Moment) else v.numel() * v.element_size()
                     for d in self.packed.values() for v in d.values())
        dense = sum(v.numel() * v.element_size() for s in self.optimizer.state.values()
                    for v in s.values() if isinstance(v, torch.Tensor))
        return {"packed": packed, "dense": dense}

    def state_dict(self) -> dict:
        def host(v):
            if isinstance(v, quant.Q8Moment):
                # ddplint: allow[host-sync] — the checkpoint's host copy of the moments, off the step path
                return {"q": v.q.cpu(), "scale": v.scale.cpu(), "n": v.n}
            return v.cpu()

        return {"packed": {i: {k: host(v) for k, v in d.items()} for i, d in self.packed.items()},
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict) -> None:
        device = self.params[0].device

        def dev(v):
            if isinstance(v, dict):
                return quant.Q8Moment(q=v["q"].to(device), scale=v["scale"].to(device), n=v["n"])
            return v.to(device)

        self.packed = {int(i): {k: dev(v) for k, v in d.items()} for i, d in sd["packed"].items()}
        self.generator.set_state(sd["generator"])


def _select(keep: torch.Tensor, new, old):
    """``new`` where ``keep`` (a 0-d bool tensor), else ``old``: a
    compressed moment of ``LowBitMoments``."""
    if isinstance(new, quant.Q8Moment):
        return quant.Q8Moment(q=torch.where(keep, new.q, old.q), scale=torch.where(keep, new.scale, old.scale),
                              n=new.n)
    return torch.where(keep, new, old)


def zero_state(model: nn.Module, build_optimizer, *, level: int = 1, moment_dtype: str | None = None,
               bucket_bytes: int | None = None, seed: int = 0, group=None, tp_axis: str | None = None,
               ep_axis: str | None = None, pp_axis: str | None = None):
    """A ``TrainState`` whose optimizer state is ZeRO-sharded: ``model``'s
    parameters in ``ZeroLayout(level)``, and ``build_optimizer(params)``
    (returning ``(optimizer, scheduler)``) called on this rank's shard
    pieces.  ``moment_dtype`` ``"bf16"``/``"int8"`` wraps the optimizer in
    ``LowBitMoments`` (``None``/``"f32"``: unchanged).  ``bucket_bytes``
    sizes the level 2/3 buckets.  ``group``: the data axis's process group
    (None: the world); ``tp_axis`` / ``ep_axis``: the mesh axes the
    model's parameters are tensor- / expert-parallel over, ``pp_axis`` the
    pipe axis of a pipeline stage's model (level 1 only)."""
    layout = ZeroLayout(model, level, bucket_bytes=bucket_bytes, group=group, tp_axis=tp_axis, ep_axis=ep_axis,
                        pp_axis=pp_axis)
    optimizer, scheduler = build_optimizer(layout.shard_params)
    moments = None
    if moment_dtype not in (None, "f32"):
        moments = LowBitMoments(optimizer, moment_dtype, seed=seed)
    return TrainState(model, optimizer, scheduler, zero=layout, moments=moments)


def _clip_shard(state, clip_norm: float | None) -> None:
    if clip_norm is None:
        return
    layout = state.zero
    grads = [sp.grad for sp in layout.shard_params]
    # The shards partition the gradient (padding is zero): the global norm
    # is one sum of the shards' sums of squares.  Under TP / EP each model
    # rank holds its own shards of the sharded leaves and the whole of the
    # replicated ones: a leaf held whole by k ranks counts 1 / k on each,
    # and the sum runs over the model axes too.
    if layout.dup is None:
        total = sumsq_f32(grads)
    else:
        total = flat_chunk_sumsq(layout.grad_shard(0), layout.rank * layout.plan.sub[0], layout.sizes,
                                 layout.dup)
    if group_active(layout.group):
        dist.all_reduce(total, group=layout.group)
    for g in layout.model_groups:
        dist.all_reduce(total, group=g)
    scale = clip_scale(torch.sqrt(total), clip_norm)
    for g in grads:
        g.mul_(scale)


def _step_shard(state, clip_norm: float | None, ok=None) -> None:
    state.zero.finish_grads()
    _clip_shard(state, clip_norm)
    state.apply_gradients(ok)


def zero_update(state, clip_norm: float | None = None, *, reduced: bool = False, ok=None) -> None:
    """Level 1 after the backward: reduce-scatter of the flat gradient, the
    optimizer step on this rank's shard (clipped to ``clip_norm``, exactly:
    the shards partition the gradient), all-gather of the parameters.
    ``reduced``: the reduce-scatters already ran.  ``ok``: the nonfinite
    guard's verdict on the device (``TrainState.apply_gradients``)."""
    zero2_update(state, clip_norm, reduced=reduced, ok=ok)


def zero2_update(state, clip_norm: float | None = None, *, reduced: bool = False, ok=None) -> None:
    """Level 2 after the backward: one reduce-scatter per bucket into this
    rank's slice of the gradient buffer, the sharded step, one all-gather
    per bucket into the parameter buffer."""
    layout = state.zero
    if not reduced:
        for b in range(layout.plan.n_buckets):
            layout.reduce_scatter(b)
    _step_shard(state, clip_norm, ok)
    layout.all_gather_params()


def zero3_update(state, clip_norm: float | None = None, *, reduced: bool = False, ok=None) -> None:
    """Level 3 after the backward: one reduce-scatter per bucket, the
    gathered parameters dropped, the sharded step; the updated shard is the
    next step's parameters (gathered at its top)."""
    layout = state.zero
    if not reduced:
        for b in range(layout.plan.n_buckets):
            layout.reduce_scatter(b)
    layout.release_params()
    _step_shard(state, clip_norm, ok)
