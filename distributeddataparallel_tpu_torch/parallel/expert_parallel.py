"""Expert parallelism: the MoE expert stacks sharded over an ``expert`` axis.

Counterpart of ``distributeddataparallel_tpu/parallel/expert_parallel.py``.
Each rank of the ``expert`` axis holds ``E / ep`` experts of every MoE
block (``models.transformer.MoEMLP``), experts ``[r*E/ep, (r+1)*E/ep)``;
everything else is replicated, and every expert rank of a data replica
sees the same rows.  The model completes every gradient itself, so the
data-parallel sync needs to know nothing of EP:

- dense dispatch enters the expert region through ``copy_to_tp`` and
  leaves it through ``reduce_from_tp`` over the expert group
  (``parallel.tensor_parallel``'s pair);
- token-choice dispatch slices the replicated tokens 1/ep per rank
  (``ep_shard_tokens``), sends each expert's slots to its rank and back
  with an all-to-all (``ep_all_to_all``), and gathers the combined slices
  (``ep_unshard_tokens``).  The slice and the gather are each other's
  backward with no reduction: the cotangent at the exit is the same on
  every rank, so a sum there would count it ``ep`` times.

Parameter layout is by name (``EP_RULES``; ``FLAX_EP_RULES`` for the
reference's tree, where the expert dim is the third from the right, so a
stacked layer dim in front changes nothing).  ``shard_state_dict_ep`` cuts
a rank's experts out of a whole ``state_dict`` and ``merge_ep_shards``
puts them back; the model, ``models.io``, ``parallel.zero`` and the
checkpoints take the rules from here.

The reference's ``ep_memory_evidence`` (compiled memory analysis for a TPU
topology) has no torch counterpart; the allocator's per-card peak under
``--ep`` stands in for it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.parallel.context_parallel import _AllToAll
from distributeddataparallel_tpu_torch.runtime.distributed import axis_group, axis_index, axis_size


class _ShardTokens(torch.autograd.Function):
    """Forward: this rank's 1/n slice of a replicated buffer along dim 0.
    Backward: the ranks' cotangent slices all-gathered, so the gradient of
    everything upstream comes out whole and equal on every rank."""

    @staticmethod
    def forward(ctx, x, group, rank: int, n: int):
        ctx.group, ctx.n = group, n
        size = x.shape[0] // n
        return x[rank * size : (rank + 1) * size]

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n), None, None, None


class _UnshardTokens(torch.autograd.Function):
    """Forward: the ranks' slices all-gathered into the replicated buffer.
    Backward: this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, group, rank: int, n: int):
        ctx.rank, ctx.n = rank, n
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        size = g.shape[0] // ctx.n
        return g[ctx.rank * size : (ctx.rank + 1) * size], None, None, None


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def ep_shard_tokens(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """This rank's 1/n slice along dim 0 of a buffer replicated over
    ``axis_name`` (backward: all-gather, no reduction)."""
    return _ShardTokens.apply(x, axis_group(axis_name), axis_index(axis_name), axis_size(axis_name))


def ep_unshard_tokens(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The ranks' slices along dim 0 gathered, in rank order (backward:
    this rank's slice, no reduction)."""
    return _UnshardTokens.apply(x, axis_group(axis_name), axis_index(axis_name), axis_size(axis_name))


def ep_all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The all-to-all of ``x``'s dim-0 blocks over ``axis_name``: block j
    goes to rank j, and received block j came from rank j (Ulysses'
    exchange, its own backward)."""
    return _AllToAll.apply(x, axis_group(axis_name))


# --- Parameter layout ----------------------------------------------------

#: Parameter-name suffix -> the expert dim of the port's tensor: the stacks
#: keep the reference's element order, (E, d, f) and (E, f, d).
EP_RULES: tuple[tuple[str, int], ...] = (
    ("mlp.experts_up", 0),
    ("mlp.experts_gate", 0),
    ("mlp.experts_down", 0),
)

#: The same rules in the reference's flax layout (``_EP_RULES``): leaf name
#: -> the expert dim counted from the right.
FLAX_EP_RULES: tuple[tuple[str, int], ...] = (("experts_up", -3), ("experts_gate", -3), ("experts_down", -3))


def ep_dim(name: str) -> int | None:
    """The expert dim of parameter ``name`` (None: replicated over EP)."""
    return next((dim for suffix, dim in EP_RULES if name.endswith(suffix)), None)


def flax_ep_dim(path) -> int | None:
    """The expert dim (negative) of the reference leaf at ``path`` (a tuple
    of keys, or a ``/``-joined string), None when replicated."""
    if isinstance(path, str):
        path = tuple(path.split("/"))
    return next((dim for leaf, dim in FLAX_EP_RULES if path[-1] == leaf), None)


def shard_state_dict_ep(state_dict: dict, rank: int, n: int) -> dict:
    """Expert rank ``rank``'s shard of a whole MoE ``state_dict``: each
    expert stack's ``rank``-th of ``n`` chunks along its expert dim, the
    rest unchanged.  ``ValueError`` when ``n`` does not divide a stack."""
    out = {}
    for name, t in state_dict.items():
        dim = ep_dim(name)
        if dim is None or n == 1:
            out[name] = t
            continue
        if t.shape[dim] % n:
            raise ValueError(
                f"EP degree {n} does not divide dim {dim} of param {name} (shape {tuple(t.shape)}) — "
                f"moe_experts must be divisible by the expert-axis size")
        out[name] = t.chunk(n, dim=dim)[rank].clone()
    return out


def merge_ep_shards(shards: list[dict]) -> dict:
    """Inverse of ``shard_state_dict_ep``: the whole ``state_dict`` from
    every expert rank's shard, in rank order (the rest from rank 0)."""
    out = {}
    for name, t in shards[0].items():
        dim = ep_dim(name)
        out[name] = t if dim is None or len(shards) == 1 else torch.cat([s[name] for s in shards], dim=dim)
    return out


def shard_model_axes(state_dict: dict, tp_axis: str | None = None, ep_axis: str | None = None) -> dict:
    """This rank's shard of a whole LM ``state_dict`` over the current
    mesh's TP and EP axes (the two rule sets hit disjoint parameters; the
    reference's ``shard_state_model_axes`` for one rank)."""
    from distributeddataparallel_tpu_torch.parallel.tensor_parallel import shard_state_dict_tp

    sd = shard_state_dict_ep(state_dict, axis_index(ep_axis), axis_size(ep_axis))
    return shard_state_dict_tp(sd, axis_index(tp_axis), axis_size(tp_axis))
