"""Tensor parallelism: Megatron column/row sharding over the ``model`` axis.

Counterpart of ``distributeddataparallel_tpu/parallel/tensor_parallel.py``.
Each rank of the ``model`` axis holds ``H / tp`` query heads, ``Hkv / tp``
kv heads and ``d_ff / tp`` hidden units:

- column-parallel projections (q/k/v, MLP up/gate) keep their output
  features' shard, their biases with them;
- row-parallel projections (attention o, MLP down) keep their input
  features' shard; their partial products are summed over the axis, and
  their replicated biases are added after that sum (before it, they would
  count ``tp`` times);
- an activation enters a sharded region through ``copy_to_tp`` (identity
  forward, all-reduce backward) and leaves it through ``reduce_from_tp``
  (all-reduce forward, identity backward), so every replicated parameter's
  gradient comes out complete and equal on every rank of the axis, and the
  data-parallel sync needs to know nothing of TP.

The model finds the axis through ``runtime.distributed``'s current mesh
(``tp_size``); without one (or without the axis) it has the full shapes.
Parameter layout is by name (``TP_RULES``, the reference's ``_TP_RULES`` for
the port's module names); ``shard_state_dict_tp`` cuts a rank's shard out of
a full ``state_dict`` and ``merge_tp_shards`` puts the shards back together.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.runtime.distributed import axis_group, axis_size


def tp_size(axis_name: str | None) -> int:
    """Size of the TP axis in the current mesh; 1 when the axis is None or
    unbound (the full, unsharded shapes)."""
    return axis_size(axis_name)


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce backward: entry into a sharded region.
    Each rank's column-parallel layers give only its shard's part of the
    input's gradient; the backward's sum completes it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)  # the incoming gradient may be shared
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce forward, identity backward: exit from a sharded region.
    The row-parallel layers' partial sums are completed in the forward; the
    cotangent is already replicated, so the backward passes it on (a sum
    there would count it ``tp`` times)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return _CopyToTP.apply(x, axis_group(axis_name))


def reduce_from_tp(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return _ReduceFromTP.apply(x, axis_group(axis_name))


# --- Parameter layout ----------------------------------------------------

#: Parameter-name suffix -> the dim of the port's tensor that is sharded
#: over the axis (None: replicated).  Linear weights are ``(out, in)``, so a
#: column-parallel weight shards dim 0 and a row-parallel one dim 1; heads
#: are contiguous along the ``H * D`` features, so a rank's heads are one
#: contiguous chunk.
TP_RULES: tuple[tuple[str, int | None], ...] = (
    ("attn.q_proj.weight", 0),
    ("attn.k_proj.weight", 0),
    ("attn.v_proj.weight", 0),
    ("attn.q_proj.bias", 0),
    ("attn.k_proj.bias", 0),
    ("attn.v_proj.bias", 0),
    ("attn.o_proj.weight", 1),
    ("attn.o_proj.bias", None),   # added after the reduction
    ("mlp.up_proj.weight", 0),
    ("mlp.gate_proj.weight", 0),
    ("mlp.up_proj.bias", 0),
    ("mlp.gate_proj.bias", 0),
    ("mlp.down_proj.weight", 1),
    ("mlp.down_proj.bias", None),  # added after the reduction
)


#: The same rules in the reference's flax layout (``_TP_RULES``): leaf path
#: suffix -> the sharded dim counted from the right, so a stacked layer dim
#: in front changes nothing.
FLAX_TP_RULES: tuple[tuple[tuple[str, str], int], ...] = (
    (("q_proj", "kernel"), -2), (("k_proj", "kernel"), -2), (("v_proj", "kernel"), -2),  # (d, H, D)
    (("q_proj", "bias"), -2), (("k_proj", "bias"), -2), (("v_proj", "bias"), -2),  # (H, D)
    (("o_proj", "kernel"), -3),  # (H, D, d)
    (("up_proj", "kernel"), -1), (("gate_proj", "kernel"), -1),  # (d, f)
    (("up_proj", "bias"), -1), (("gate_proj", "bias"), -1),
    (("down_proj", "kernel"), -2),  # (f, d)
)


def tp_dim(name: str) -> int | None:
    """The sharded dim of parameter ``name`` under TP (None: replicated)."""
    for suffix, dim in TP_RULES:
        if name.endswith(suffix):
            return dim
    return None


def flax_tp_dim(path) -> int | None:
    """The sharded dim (negative) of the reference leaf at ``path`` (a
    tuple of keys, or a ``/``-joined string), None when replicated."""
    if isinstance(path, str):
        path = tuple(path.split("/"))
    return next((dim for suffix, dim in FLAX_TP_RULES if tuple(path[-2:]) == suffix), None)


def shard_state_dict_tp(state_dict: dict, rank: int, n: int) -> dict:
    """This rank's shard of a full TransformerLM ``state_dict`` (the
    reference's ``shard_state_tp`` for one rank): each sharded tensor's
    ``rank``-th of ``n`` equal chunks along its rule's dim, the rest
    unchanged.  ``ValueError`` when ``n`` does not divide a sharded dim."""
    out = {}
    for name, t in state_dict.items():
        dim = tp_dim(name)
        if dim is None or n == 1:
            out[name] = t
            continue
        if t.shape[dim] % n:
            raise ValueError(
                f"TP degree {n} does not divide dim {dim} of param {name} (shape "
                f"{tuple(t.shape)}) — the model's head/kv-head/d_ff counts must all be "
                f"divisible by the size of the 'model' mesh axis")
        out[name] = t.chunk(n, dim=dim)[rank].clone()
    return out


def merge_tp_shards(shards: list[dict]) -> dict:
    """Inverse of ``shard_state_dict_tp``: the full ``state_dict`` from every
    rank's shard, in rank order (replicated tensors from rank 0)."""
    out = {}
    for name, t in shards[0].items():
        dim = tp_dim(name)
        out[name] = t if dim is None or len(shards) == 1 else torch.cat([s[name] for s in shards], dim=dim)
    return out

