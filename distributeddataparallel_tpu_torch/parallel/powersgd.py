"""PowerSGD gradient compression: DDP's low-rank comm hook.

Counterpart of ``distributeddataparallel_tpu/parallel/powersgd.py`` (Vogels
et al., NeurIPS 2019).  Instead of all-reducing a gradient matrix
``M (n x m)``, the ranks all-reduce the rank-``r`` factors of one power
iteration and keep the approximation error for the next step.  Per step and
per compressed leaf:

1. ``M += err``                    (error feedback, this rank's own)
2. ``P = mean_allreduce(M @ Q)``   (Q warm-started across steps, m x r)
3. ``P = orth(P)``                 (thin QR, f32)
4. ``Q = mean_allreduce(M^T @ P)``
5. ``M_hat = P @ Q^T``             (the same on every rank: lockstep)
6. ``err = M - M_hat``             (kept for the next step)

The leaves are the reference's (``models.io.jax_leaf_pieces``), so a leaf's
matrix is the reference's: its leading dims folded, its last kept (a
stacked ``scan_layers`` leaf folds its layers too).  Leaves under
``MIN_COMPRESS_ELEMS`` elements or of rank < 2 are all-reduced dense.  With
``rank >= min(n, m)`` the projector spans the whole column space and the
hook is the dense mean up to float error.

The state is a list over the leaves: ``PowerSGDLeaf(q, err)`` for a
compressed leaf (``q`` the same on every rank, ``err`` this rank's), None
for a dense one.  ``q`` starts as the same seeded Gaussian on every rank,
from a CPU ``torch.Generator``, so no broadcast is needed.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.models.io import ref_view
from distributeddataparallel_tpu_torch.parallel.data_parallel import group_active, group_size

#: Leaves with fewer elements stay dense: two factor all-reduces cost more
#: launches than the payload they save.
MIN_COMPRESS_ELEMS = 16384


@dataclasses.dataclass
class PowerSGDLeaf:
    """One compressed leaf's hook state: the warm-started factor ``q``
    (m x r, f32) and this rank's error residual ``err`` (the leaf's shape
    and dtype)."""

    q: torch.Tensor
    err: torch.Tensor


def _matrix_shape(shape) -> tuple[int, int] | None:
    """The ``(n, m)`` matrix PowerSGD compresses a leaf of ``shape`` (the
    reference's layout) into, or None for a dense leaf: the leading dims
    fold, the last stays (HWIO convs keep their channel structure)."""
    size = math.prod(shape)
    if len(shape) < 2 or size < MIN_COMPRESS_ELEMS:
        return None
    m = shape[-1]
    return size // m, m


def _leaf_rank(nm: tuple[int, int], rank: int) -> int:
    """The rank a leaf gets: thin QR caps the basis at min(n, m), so a
    larger request would make q shrink after the first step."""
    return min(rank, *nm)


def powersgd_state(leaves, rank: int = 4, *, seed: int = 0, device=None) -> list:
    """The hook state of ``leaves`` (tensors in the reference's layout, or
    ``(shape, dtype)`` pairs): ``PowerSGDLeaf(q=(m, min(rank, n, m)),
    err=zeros(leaf))`` for a compressed leaf, None for a dense one.  ``q``
    of leaf i is ``torch.randn`` from a CPU generator seeded with ``seed``
    and then advanced over the leaves before it, the same on every rank."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    gen = torch.Generator().manual_seed(seed)
    out = []
    for leaf in leaves:
        shape, dtype = (tuple(leaf.shape), leaf.dtype) if isinstance(leaf, torch.Tensor) else leaf
        nm = _matrix_shape(shape)
        if nm is None:
            out.append(None)
            continue
        q = torch.randn(nm[1], _leaf_rank(nm, rank), generator=gen, dtype=torch.float32)
        out.append(PowerSGDLeaf(q=q.to(device), err=torch.zeros(shape, dtype=dtype, device=device)))
    return out


def _orthonormalize(p: torch.Tensor) -> torch.Tensor:
    """The thin-QR orthonormal basis of P's columns, in f32."""
    return torch.linalg.qr(p.float(), mode="reduced").Q


def _mean(t: torch.Tensor, n: int, group=None) -> torch.Tensor:
    if group_active(group):
        dist.all_reduce(t, group=group)
    return t.div_(n)


def powersgd_sync(grads: list[torch.Tensor], state: list, *, op: str = "mean",
                  group=None) -> tuple[list, list]:
    """One PowerSGD round over the ranks of ``group`` (None: the world; a
    mesh's ``data`` axis under context parallelism, after the ``seq``
    mean): ``(synced grads, new state)``.

    ``grads`` are this rank's leaves in the reference's layout.  A
    compressed leaf comes back as the rank-r approximation of the mean over
    the ranks (the same on every rank), a dense one as the plain mean.
    ``op="sum"`` scales the approximation by the world size after the mean
    round (summing P and Q separately would not approximate the summed
    matrix).  The inputs are not modified."""
    if op not in ("mean", "sum"):
        raise ValueError(f"op must be 'mean' or 'sum', got {op!r}")
    n_world = group_size(group)
    out_g, out_s = [], []
    for g, s in zip(grads, state):
        if s is None:
            red = g.clone()
            if group_active(group):
                dist.all_reduce(red, group=group)
            out_g.append(red.div_(n_world) if op == "mean" else red)
            out_s.append(None)
            continue
        n, m = _matrix_shape(tuple(g.shape))
        mat = (g + s.err.to(g.dtype)).reshape(n, m)
        mat32 = mat.float()
        p = _orthonormalize(_mean(mat32 @ s.q, n_world, group))
        q = _mean(mat32.t() @ p, n_world, group)
        m_hat = (p @ q.t()).to(g.dtype)
        err = (mat - m_hat).reshape(g.shape)
        if op == "sum":
            m_hat = m_hat * torch.tensor(n_world, dtype=m_hat.dtype)
        out_g.append(m_hat.reshape(g.shape))
        out_s.append(PowerSGDLeaf(q=q, err=err))
    return out_g, out_s


def powersgd_wire_bytes(leaves, rank: int = 4) -> dict:
    """Wire bytes a step sends dense and under PowerSGD (f32 factors),
    from the leaves' shapes (tensors or ``(shape, dtype)`` pairs)."""
    dense = comp = n_compressed = n_dense = 0
    for leaf in leaves:
        shape, dtype = (tuple(leaf.shape), leaf.dtype) if isinstance(leaf, torch.Tensor) else leaf
        nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        nm = _matrix_shape(shape)
        dense += nbytes
        if nm is None:
            comp += nbytes
            n_dense += 1
        else:
            comp += 4 * _leaf_rank(nm, rank) * (nm[0] + nm[1])  # the P round and the Q round
            n_compressed += 1
    return {
        "rank": rank,
        "dense_wire_bytes": dense,
        "powersgd_wire_bytes": comp,
        "compression_ratio": round(dense / comp, 1) if comp else None,
        "n_compressed_leaves": n_compressed,
        "n_dense_leaves": n_dense,
    }


# ----------------------------------------------- the model's gradients ---

def leaf_shapes(pieces) -> list[tuple[tuple, torch.dtype]]:
    """``(shape, dtype)`` of each reference leaf of ``models.io.
    jax_leaf_pieces(model)``."""
    out = []
    for _, ps in pieces:
        shape = ps[0][2] if len(ps) == 1 else (len(ps), *ps[0][2])
        out.append((tuple(shape), ps[0][0].dtype))
    return out


@torch.no_grad()
def sync_model_grads(pieces, state: list, group=None) -> list:
    """PowerSGD over a model's ``.grad``s in place, leaf by leaf (only one
    leaf's matrix exists at a time), over ``group``'s ranks; returns the
    new state.  ``pieces`` is ``models.io.jax_leaf_pieces(model)``."""
    new_state = []
    for (_, ps), s in zip(pieces, state):
        grads = [ref_view(p.grad, kind).reshape(shape) for p, kind, shape in ps]
        g = grads[0] if len(grads) == 1 else torch.stack(grads)
        (out,), (ns,) = powersgd_sync([g], [s], group=group)
        for (p, kind, _), part in zip(ps, out.unbind(0) if len(ps) > 1 else [out]):
            view = ref_view(p.grad, kind)
            view.copy_(part.reshape(view.shape))
        new_state.append(ns)
    return new_state


@torch.no_grad()
def select_state(ok: torch.Tensor, new: list, old: list) -> list:
    """The nonfinite guard's select over the hook state: ``new`` where
    ``ok`` (a 0-d tensor on the device, 1.0 for a good step), else
    ``old``, written into ``new`` leaf by leaf with no host read.  Beyond
    the two states it allocates one tensor of a leaf at a time."""
    keep = ok.reshape(()) > 0
    for n, o in zip(new, old):
        if n is not None:
            n.q.copy_(torch.where(keep, n.q, o.q))
            n.err.copy_(torch.where(keep, n.err, o.err))
    return new
