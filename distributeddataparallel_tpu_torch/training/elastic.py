"""Elastic checkpoint restore: resume at another geometry.

Counterpart of ``distributeddataparallel_tpu/training/elastic.py`` on the
port's checkpoint payloads (``training.checkpoint``).  Every save records
``topology_meta`` in the payload beside its mesh: the weight-update layout
and the degrees of the data, tensor (``model``), expert and pipe axes, and
a pipeline's virtual chunks a stage.  ``elastic_restore`` takes the
reference's decisions in its order (``elastic.py:264-310``):

1. a layout that is not the run's is refused (``zero1`` into a
   replicated run...), but for the port's FSDP <-> plain conversions;
2. an interleaved pipeline resumes only at its ``(pp, virtual)``
   geometry, and an interleaved run only from a checkpoint of its own;
3. the same geometry restores exactly, each rank its own part;
4. ``replicated`` reshards for free: the payload's ``model`` is the whole
   model, cut for the new mesh; without model axes the optimizer state is
   the whole model's, and with them every model position's is merged and
   re-cut with the model's own rules (``merge_positions`` /
   ``cut_mine``: ``merge_tp_shards``, ``merge_ep_shards``,
   ``merge_pp_shards`` and their inverses), a change of stage count
   included.  PowerSGD across a change of the data degree keeps the warm
   Q and starts the residuals at zero on the device; the old residuals
   stay on the host;
5. ``zero1`` reshards its flat moments across the data degree and the
   TP, EP and PP degrees (``reshard_zero_model_flat``, the reference's
   ``_reshard_zero_model_flat``): the old ranks' chunks are laid out as
   the reference's global flat, ``content || tail padding`` per model
   position, reassembled into whole leaves, and re-cut and re-padded at
   the new geometry;
6. ``fsdp`` reshards across the data and TP degrees through the whole
   model's optimizer state (``parallel.fsdp.plain_optimizer_state`` at
   the old geometry, ``shard_optimizer_state`` at the new);
7. any other layout at another geometry raises the reference's
   ``unknown elastic layout 'zero2'``.

A payload without a topology record (written before this module) resumes
only at its own recorded mesh: the reference's rule for a legacy sidecar.
All of this runs on host tensors; each rank then copies its part into the
run's state on its device once.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from distributeddataparallel_tpu_torch.parallel.expert_parallel import flax_ep_dim, merge_ep_shards, shard_model_axes
from distributeddataparallel_tpu_torch.parallel.pipeline_parallel import merge_pp_shards, shard_state_dict_pp
from distributeddataparallel_tpu_torch.parallel.tensor_parallel import flax_tp_dim, merge_tp_shards
from distributeddataparallel_tpu_torch.runtime.distributed import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    axis_index,
    axis_size,
    current_mesh,
    get_rank,
    get_world_size,
)
from distributeddataparallel_tpu_torch.training.optim import load_optimizer_state, optimizer_state_dict

#: The model axes a ZeRO-1 flat interleaves over, in the reference's order
#: (``zero._leaf_spec``: data, then tp, ep, pp); an axis at degree 1 takes
#: part with size 1.
ZERO_ORDER = (MODEL_AXIS, EXPERT_AXIS, PIPE_AXIS)
_DEGREE_KEYS = {MODEL_AXIS: "n_tp", EXPERT_AXIS: "n_ep", PIPE_AXIS: "n_pp"}


def layout_of(state) -> str:
    """The weight-update layout of ``state``, as the topology record names
    it (``dpp.py:1910-1914``)."""
    if state.fsdp is not None:
        return "fsdp"
    if state.zero is not None:
        return f"zero{state.zero.level}"
    return "replicated"


def _degree(mesh, axis: str) -> int:
    return mesh.size(axis) if mesh is not None and axis in mesh.axes else 1


def topology_meta(mesh, layout: str, *, world: int = 1, pp_virtual: int = 1) -> dict:
    """The topology record of a save on ``mesh`` (a ``runtime.distributed``
    mesh, or None for plain DP over ``world`` ranks), with the reference's
    keys: ``layout``, the data, TP, EP and PP degrees (1 where the axis is
    absent), the virtual chunks a stage, and the name of each model axis of
    degree > 1."""
    meta = {"layout": layout, "n_data": _degree(mesh, DATA_AXIS) if mesh is not None else int(world),
            "n_tp": _degree(mesh, MODEL_AXIS), "n_ep": _degree(mesh, EXPERT_AXIS),
            "n_pp": _degree(mesh, PIPE_AXIS), "n_virtual": int(pp_virtual)}
    for key, axis in (("tp_axis", MODEL_AXIS), ("ep_axis", EXPERT_AXIS), ("pp_axis", PIPE_AXIS)):
        if _degree(mesh, axis) > 1:
            meta[key] = axis
    return meta


def state_topology(state) -> dict:
    """``topology_meta`` of this run's state on the current mesh."""
    return topology_meta(current_mesh(), layout_of(state), world=get_world_size(),
                         pp_virtual=getattr(state.model, "virtual", 1))


# ------------------------------------------------------ the flat math ----

def repad_flat(arr, true: int, padded_new: int) -> torch.Tensor:
    """A ``content || tail padding`` flat (its last dim) truncated to its
    ``true`` content and zero-padded to ``padded_new``: the positional
    reshard rule of every flat layout (the reference's ``repad_flat``)."""
    arr = torch.as_tensor(arr)
    return F.pad(arr[..., :true], (0, padded_new - true))


def zero_sizes(geom: list, n: int, axn: dict) -> tuple[int, int]:
    """``(local_total, chunk)`` of one model position's ZeRO-1 flat at data
    degree ``n`` and model-axis degrees ``axn`` (the reference's
    ``_zero_sizes``)."""
    total = 0
    for shape, dims in geom:
        size = math.prod(shape)
        for ax in dims.values():
            size //= axn.get(ax, 1)
        total += size
    return total, -(-total // n)


def _midx(j: int, sizes: list) -> list:
    out = []
    for s in reversed(sizes):
        out.append(j % s)
        j //= s
    return list(reversed(out))


def reshard_zero_model_flat(flat_old: torch.Tensor, geom: list, order, n_old: int, axn_old: dict,
                            chunk_old: int, local_total_old: int, n_new: int, axn_new: dict,
                            chunk_new: int) -> torch.Tensor:
    """One ZeRO-1 flat of per-element optimizer state, ``(data,
    model-position)``-interleaved chunks at the old geometry -> the same at
    the new (the reference's ``_reshard_zero_model_flat``).

    ``geom``: each leaf's ``(global shape, {dim: axis})`` in flat order;
    ``order``: the model axes whose positions ``j`` enumerate row-major;
    block ``d * m + j`` holds data rank ``d``'s chunk of position ``j``'s
    local flat.  Each old position's local flat is reassembled (tail padding
    dropped), unflattened into its leaf shards, which are put together into
    whole leaves (a leaf no axis shards is the same in every position: one
    copy), then each new position's shards are cut, flattened, padded and
    dealt to the new data ranks.  Linear and positional, so it carries Adam
    moments exactly."""
    order = list(order)
    axidx = {ax: i for i, ax in enumerate(order)}

    def sizes(axn):
        return [max(int(axn.get(ax, 1)), 1) for ax in order]

    def leaf_slice(shape, dims, mi, axn):
        sl = [slice(None)] * len(shape)
        for dim, ax in dims.items():
            k = mi[axidx[ax]] if ax in axidx else 0
            step = shape[dim] // max(int(axn.get(ax, 1)), 1)
            sl[dim] = slice(k * step, (k + 1) * step)
        return tuple(sl)

    sz_old = sizes(axn_old)
    m_old = math.prod(sz_old)
    locals_old = [torch.cat([flat_old[(d * m_old + j) * chunk_old : (d * m_old + j + 1) * chunk_old]
                             for d in range(n_old)])[:local_total_old] for j in range(m_old)]
    full, offs = [], [0] * m_old
    for shape, dims in geom:
        lshape = list(shape)
        for dim, ax in dims.items():
            lshape[dim] //= max(int(axn_old.get(ax, 1)), 1)
        size = math.prod(lshape)
        arr = torch.zeros(shape, dtype=flat_old.dtype)
        for j in range(m_old):
            if dims or j == 0:
                arr[leaf_slice(shape, dims, _midx(j, sz_old), axn_old)] = \
                    locals_old[j][offs[j] : offs[j] + size].reshape(lshape)
            offs[j] += size
        full.append(arr)
    sz_new = sizes(axn_new)
    m_new = math.prod(sz_new)
    out = torch.zeros(chunk_new * n_new * m_new, dtype=flat_old.dtype)
    for j in range(m_new):
        mi = _midx(j, sz_new)
        loc = torch.cat([leaf[leaf_slice(shape, dims, mi, axn_new)].reshape(-1)
                         for (shape, dims), leaf in zip(geom, full)])
        loc = F.pad(loc, (0, chunk_new * n_new - loc.numel()))
        for d in range(n_new):
            out[(d * m_new + j) * chunk_new : (d * m_new + j + 1) * chunk_new] = \
                loc[d * chunk_new : (d + 1) * chunk_new]
    return out


def zero_geometry(model, degrees: dict) -> list:
    """``(global shape, {dim: axis})`` of each leaf of a ZeRO-1 flat, in
    flat order (the reference's ``_zero_model_geometry``): the leaves of
    ``model`` (this rank's shard, ``models.io.jax_leaf_pieces``) with their
    TP, EP and (the stacked layers') PP dims scaled by ``degrees``."""
    from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces

    geom = []
    for path, pieces in jax_leaf_pieces(model):
        shape = list(pieces[0][2])
        stacked = path.split("/")[0] == "layers"  # scan_layers: one piece a layer
        if stacked:
            shape = [len(pieces), *shape]
        dims = {}
        for axis, dim in ((MODEL_AXIS, flax_tp_dim(path)), (EXPERT_AXIS, flax_ep_dim(path)),
                          (PIPE_AXIS, 0 if stacked else None)):
            if dim is not None:
                dims[dim % len(shape)] = axis
        for dim, axis in dims.items():
            shape[dim] *= degrees.get(axis, 1)
        geom.append((tuple(shape), dims))
    return geom


# --------------------------------------------- model positions' state ---

def merge_positions(parts: dict, n_tp: int, n_ep: int, n_pp: int, virtual: int = 1, *, cat: bool = True) -> dict:
    """The whole model's ``state_dict`` (or any tensors named as its
    parameters) from every model position's, ``parts[(tp, ep, pp)]``: TP
    shards merged per expert index, then the experts, then the stages.
    ``cat=False`` (a scalar a parameter, the same in every position):
    only the stages' names are merged."""
    stages = []
    for s in range(n_pp):
        if cat:
            rows = [merge_tp_shards([parts[(t, e, s)] for t in range(n_tp)]) for e in range(n_ep)]
            stages.append(merge_ep_shards(rows))
        else:
            stages.append(parts[(0, 0, s)])
    return merge_pp_shards(stages, virtual) if n_pp > 1 else stages[0]


def cut_mine(whole: dict, state, *, cat: bool = True) -> dict:
    """This rank's part of a whole model's tensors on the current mesh,
    the inverse of ``merge_positions`` (``cat=False``: scalars, named
    only)."""
    cfg = getattr(state.model, "cfg", None)
    sd = shard_model_axes(whole, getattr(cfg, "tp_axis", None), getattr(cfg, "ep_axis", None)) if cat else whole
    if getattr(state.model, "n_stages", 1) > 1:
        sd = shard_state_dict_pp(sd, axis_index(PIPE_AXIS), axis_size(PIPE_AXIS), getattr(state.model, "virtual", 1))
    return sd


def _unravel(rank: int, shape) -> tuple:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def old_coords(ckpt: dict, n: int) -> list[dict]:
    """The mesh coordinates of each of the payload's ``n`` saving ranks."""
    mesh = ckpt.get("mesh")
    if mesh is None:
        return [{DATA_AXIS: r} for r in range(n)]
    return [dict(zip(mesh["axes"], _unravel(r, mesh["shape"]))) for r in range(n)]


def _position(coords: dict) -> tuple[int, int, int]:
    return coords.get(MODEL_AXIS, 0), coords.get(EXPERT_AXIS, 0), coords.get(PIPE_AXIS, 0)


def saved_groups(saved: dict, optimizer) -> list:
    """The saved param groups' hyperparameters over this optimizer's
    parameters (a resharded optimizer may hold another count of them: a
    ZeRO shard is stepped in pieces of at most ``zero.MAX_PIECE``)."""
    mine = optimizer_state_dict(optimizer)["param_groups"]
    return [{**g, "params": m["params"]} for g, m in zip(saved["param_groups"], mine)]


def _by_name(names: list, opt_sd: dict) -> dict:
    return {n: opt_sd["state"][i] for i, n in enumerate(names) if i in opt_sd["state"]}


def _whole_optimizer(ckpt: dict, topo: dict) -> tuple[dict, dict]:
    """The whole model's optimizer state by parameter name, and a saved
    optimizer ``state_dict`` (its hyperparameters): from the payload's own
    (saved without model axes) or every model position's owner, merged."""
    if "optimizer" in ckpt:
        return _by_name(ckpt["param_names"], ckpt["optimizer"]), ckpt["optimizer"]
    parts = ckpt["ranks"]
    owners = {_position(c): p for c, p in zip(old_coords(ckpt, len(parts)), parts) if "param_names" in p}
    per_pos = {j: _by_name(p["param_names"], p["optimizer"]) for j, p in owners.items()}
    keys = {k for st in per_pos.values() for s in st.values() for k in s}
    whole: dict = {}
    for key in sorted(keys):
        parts_k = {j: {n: s[key] for n, s in st.items() if key in s} for j, st in per_pos.items()}
        scalar = next(t for sd in parts_k.values() for t in sd.values()).dim() == 0
        merged = merge_positions(parts_k, topo["n_tp"], topo["n_ep"], topo["n_pp"], topo["n_virtual"], cat=not scalar)
        for n, t in merged.items():
            whole.setdefault(n, {})[key] = t
    return whole, next(iter(owners.values()))["optimizer"]


def _cut_optimizer(state, whole: dict, saved: dict) -> dict:
    """This rank's optimizer ``state_dict`` from the whole model's state by
    name: every per-element state cut as the model is."""
    names = [n for n, _ in state.model.named_parameters()]
    keys = {k for s in whole.values() for k in s}
    mine: dict = {}
    for key in keys:
        have = {n: s[key] for n, s in whole.items() if key in s}
        for n, t in cut_mine(have, state, cat=next(iter(have.values())).dim() > 0).items():
            mine.setdefault(n, {})[key] = t
    return {"state": {i: mine[n] for i, n in enumerate(names) if n in mine},
            "param_groups": saved_groups(saved, state.optimizer)}


# ------------------------------------------------------------ restore ---

def _same_geometry(ckpt: dict) -> bool:
    """Was the payload saved on this run's mesh, by as many ranks?"""
    from distributeddataparallel_tpu_torch.training.checkpoint import _mesh_record

    return ckpt.get("mesh") == _mesh_record() and len(ckpt.get("ranks") or [0] * get_world_size()) == get_world_size()


def _check_pp_geometry(state, ckpt: dict) -> None:
    """The reference's restore guard (``training/elastic.py:293-308``): a
    pipeline's layers are stored in its ``(pp, virtual)`` order, so an
    interleaved checkpoint resumes only at that geometry, and an
    interleaved run only from a checkpoint of its own geometry (a payload
    without the record is contiguous: virtual 1)."""
    old_v, new_v = int(ckpt.get("pp_virtual", 1)), getattr(state.model, "virtual", 1)
    mesh = ckpt.get("mesh") or {"axes": [], "shape": []}
    old_pp, new_pp = dict(zip(mesh["axes"], mesh["shape"])).get(PIPE_AXIS, 1), axis_size(PIPE_AXIS)
    if old_v != new_v or (new_v > 1 and old_pp != new_pp):
        raise ValueError(f"checkpoint layer storage is interleaved for (pp={old_pp}, virtual={old_v}) but this run "
                         f"is (pp={new_pp}, virtual={new_v}) — interleaved layouts resume only at their exact "
                         f"pipeline geometry")


def saved_layout(ckpt: dict) -> str:
    """The layout a payload was saved in: its topology record's, or for a
    payload without one, what its parts show."""
    if ckpt.get("topology") is not None:
        return ckpt["topology"]["layout"]
    level = (ckpt.get("ranks") or [{}])[0].get("zero_level")
    return ckpt.get("layout") or (f"zero{level}" if level else "replicated")


def elastic_restore(ckpt: dict, state) -> int:
    """Copy the checkpoint payload ``ckpt`` into ``state`` (built for this
    run's mesh), resharding wherever the geometry differs (module
    docstring); returns the next epoch, as ``CheckpointFiles.load_into``."""
    layout, topo = layout_of(state), ckpt.get("topology")
    old_layout = saved_layout(ckpt)
    if old_layout != layout and {old_layout, layout} != {"fsdp", "replicated"}:
        raise ValueError(f"checkpoint layout {old_layout!r} does not match the current run's {layout!r} — "
                         f"rebuild the state the same way it was saved")
    if state.fsdp is not None or old_layout == "fsdp":
        _load_fsdp(state, ckpt, topo)
    else:
        _check_pp_geometry(state, ckpt)
        if _same_geometry(ckpt):
            _load_exact(state, ckpt)
        elif topo is None:
            from distributeddataparallel_tpu_torch.training.checkpoint import _mesh_record

            raise ValueError(f"the checkpoint has no topology record (written before resharding was ported): it "
                             f"resumes only on its own mesh {ckpt.get('mesh')} ({len(ckpt.get('ranks') or [])} "
                             f"ranks' parts); this run's is {_mesh_record()} of {get_world_size()} ranks")
        elif layout == "replicated":
            _load_replicated(state, ckpt, topo)
        elif layout == "zero1":
            _load_zero1(state, ckpt, topo)
        else:
            raise ValueError(f"unknown elastic layout {layout!r}")
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = ckpt["step"]
    return ckpt["epoch"] + 1


def _load_model(state, ckpt: dict) -> None:
    with state.full_params():
        state.model.load_state_dict(cut_mine(ckpt["model"], state))
        if state.zero is not None:
            state.zero.load_shard_from_flat()


def _load_exact(state, ckpt: dict) -> None:
    """The same geometry: the model cut for this rank, and this rank's own
    part of the per-rank state."""
    from distributeddataparallel_tpu_torch.training.checkpoint import _model_axes, _shard_owner, per_rank

    if per_rank(state) != ("ranks" in ckpt):
        raise ValueError("the checkpoint's layout (per-rank ZeRO/PowerSGD/TP/EP state or not) is not "
                         "this run's: resume with the flags it was saved with")
    _load_model(state, ckpt)
    if "optimizer" in ckpt:
        load_optimizer_state(state.optimizer, ckpt["optimizer"])
    if "ranks" not in ckpt:
        return
    parts = ckpt["ranks"]
    part = parts[get_rank()]
    if state.zero is not None:
        if part.get("zero_level") != state.zero.level:
            raise ValueError(f"checkpoint of ZeRO level {part.get('zero_level')}, this run is at "
                             f"{state.zero.level}")
        if state.moments is not None:
            state.moments.load_state_dict(part["moments"])
        load_optimizer_state(state.optimizer, part["optimizer"])
    elif _model_axes(state):
        load_optimizer_state(state.optimizer, parts[_shard_owner(_model_axes(state).values())]["optimizer"])
    _load_comm_state(state, ckpt, part)


def _load_comm_state(state, ckpt: dict, part: dict | None) -> None:
    """PowerSGD's state: this rank's own (``part``), or across a change of
    the data degree the warm Q of rank 0 with the residuals started at
    zero on the device (the reference's ``elastic.py:310-362``; the old
    residuals stay on the host)."""
    saved = (ckpt.get("ranks") or [{}])[0].get("comm_state")
    if (state.comm_state is None) != (saved is None):
        raise ValueError("the checkpoint's comm-hook state (PowerSGD) is not this run's: resume with the flags "
                         "it was saved with")
    if state.comm_state is None:
        return
    from distributeddataparallel_tpu_torch.parallel.powersgd import PowerSGDLeaf

    device = next(state.model.parameters()).device
    if part is not None:
        state.comm_state = [None if s is None else PowerSGDLeaf(q=s["q"].to(device), err=s["err"].to(device))
                            for s in part["comm_state"]]
        return
    state.comm_state = [None if s is None else PowerSGDLeaf(q=s["q"].to(device), err=torch.zeros_like(e.err))
                        for s, e in zip(saved, state.comm_state)]


def _load_replicated(state, ckpt: dict, topo: dict) -> None:
    """``replicated`` at another geometry: the whole model and the whole
    model's optimizer state, cut for this rank."""
    _load_model(state, ckpt)
    whole, saved = _whole_optimizer(ckpt, topo)
    load_optimizer_state(state.optimizer, _cut_optimizer(state, whole, saved))
    if state.comm_state is None and not any("comm_state" in p for p in ckpt.get("ranks") or []):
        return
    mesh = current_mesh()
    d = mesh.index(DATA_AXIS) if mesh is not None else get_rank()
    part = None
    if topo["n_data"] == (mesh.size(DATA_AXIS) if mesh is not None else get_world_size()):
        # The same data degree: this data index's residual, from its seq
        # rank 0 (the seq ranks' residuals are equal: the hook runs after
        # the seq mean).
        coords = old_coords(ckpt, len(ckpt["ranks"]))
        part = next(p for c, p in zip(coords, ckpt["ranks"]) if c[DATA_AXIS] == d and c.get(SEQ_AXIS, 0) == 0)
    _load_comm_state(state, ckpt, part)


def _load_zero1(state, ckpt: dict, topo: dict) -> None:
    """``zero1`` at another geometry: the model, and this rank's chunk of
    every per-element optimizer state resharded from the old ranks'."""
    if state.moments is not None or any("moments" in p for p in ckpt["ranks"]):
        raise ValueError("low-bit moments (--moment-dtype) resume only at the geometry they were saved at")
    _load_model(state, ckpt)
    layout, parts = state.zero, ckpt["ranks"]
    coords = old_coords(ckpt, len(parts))
    mesh = current_mesh()
    axn_old = {a: int(topo[k]) for a, k in _DEGREE_KEYS.items()}
    axn_new = {a: axis_size(a) for a in ZERO_ORDER}
    n_old, n_new = int(topo["n_data"]), layout.world
    if any(n > 1 for n in (*axn_old.values(), *axn_new.values())):
        geom = zero_geometry(state.model, axn_new)
    else:  # no model axes: one positional flat
        geom = [((sum(layout.sizes),), {})]
    lt_old, chunk_old = zero_sizes(geom, n_old, axn_old)
    lt_new, chunk_new = zero_sizes(geom, n_new, axn_new)
    if (lt_new, chunk_new) != (sum(layout.sizes), layout.plan.sub[0]):
        raise ValueError(f"ZeRO-1 reshard geometry ({lt_new}, {chunk_new}) is not this run's layout "
                         f"({sum(layout.sizes)}, {layout.plan.sub[0]})")
    sz_old = [axn_old[a] for a in ZERO_ORDER]
    m_old = math.prod(sz_old)
    blocks = [None] * (n_old * m_old)
    for c, p in zip(coords, parts):
        if c.get(SEQ_AXIS, 0) == 0:
            j = sum(i * math.prod(sz_old[k + 1:]) for k, i in enumerate(_position(c)))
            blocks[c[DATA_AXIS] * m_old + j] = p["optimizer"]["state"]
    sz_new = [axn_new[a] for a in ZERO_ORDER]
    j_new = sum(axis_index(a) * math.prod(sz_new[k + 1:]) for k, a in enumerate(ZERO_ORDER))
    d_new = mesh.index(DATA_AXIS) if mesh is not None else get_rank()
    mine = (d_new * math.prod(sz_new) + j_new) * chunk_new
    flats, scalars = {}, {}
    for key, v in blocks[0].get(0, {}).items():
        if v.dim() == 0:
            scalars[key] = v
            continue
        flat_old = torch.cat([torch.cat([b[i][key] for i in sorted(b)]) for b in blocks])
        if len(geom) == 1:  # one positional flat: truncate, re-pad, cut (what the live reshard does)
            flats[key] = repad_flat(flat_old, lt_old, chunk_new * n_new)[mine : mine + chunk_new].clone()
            continue
        flats[key] = reshard_zero_model_flat(flat_old, geom, ZERO_ORDER, n_old, axn_old, chunk_old, lt_old, n_new,
                                             axn_new, chunk_new)[mine : mine + chunk_new]
    load_optimizer_state(state.optimizer, layout.optimizer_state(
        flats, scalars, saved_groups(parts[0]["optimizer"], state.optimizer)))


def _load_fsdp(state, ckpt: dict, topo: dict | None) -> None:
    """An FSDP payload into an FSDP state (resharded across the data and TP
    degrees), or into a plain state; a plain payload into an FSDP state."""
    from distributeddataparallel_tpu_torch.parallel import fsdp
    from distributeddataparallel_tpu_torch.training.checkpoint import _mesh_record, per_rank

    groups = optimizer_state_dict(state.optimizer)["param_groups"]
    if state.fsdp is not None and ckpt.get("layout") == "fsdp":
        state.fsdp.load_full(ckpt["model"])
        if _same_geometry(ckpt):
            load_optimizer_state(state.optimizer, ckpt["ranks"][get_rank()]["optimizer"])
            return
        if topo is None:
            raise ValueError(f"the FSDP checkpoint was saved on {len(ckpt['ranks'])} ranks (mesh "
                             f"{ckpt.get('mesh')}) without a topology record (written before resharding was "
                             f"ported), this run has {get_world_size()} (mesh {_mesh_record()}): resume it on "
                             f"that mesh")
        plain = fsdp.plain_optimizer_state(_old_fsdp_meta(state.fsdp, topo),
                                           [p["optimizer"] for p in _position_major(ckpt)], groups)
        load_optimizer_state(state.optimizer, fsdp.shard_optimizer_state(
            state.fsdp, plain, saved_groups(ckpt["ranks"][0]["optimizer"], state.optimizer)))
    elif state.fsdp is not None:
        if "ranks" in ckpt:
            raise ValueError("an FSDP run loads an FSDP or a plain checkpoint (not ZeRO/TP/PowerSGD state)")
        state.fsdp.load_full(ckpt["model"])
        load_optimizer_state(state.optimizer, fsdp.shard_optimizer_state(state.fsdp, ckpt["optimizer"], groups))
    else:
        mesh = ckpt.get("mesh") or {"axes": [], "shape": []}
        if per_rank(state) or dict(zip(mesh["axes"], mesh["shape"])).get(MODEL_AXIS, 1) > 1:
            raise ValueError("an FSDP checkpoint without TP loads into an FSDP run or a plain one (not "
                             "ZeRO/TP/PowerSGD state)")
        cfg = dataclasses.replace(state.model.cfg, scan_layers=True, dropout_rate=0.0, cp_axis=None)
        meta = fsdp.FsdpMeta(cfg, len(ckpt["ranks"]))
        state.model.load_state_dict(ckpt["model"])
        load_optimizer_state(state.optimizer,
                             fsdp.plain_optimizer_state(meta, [p["optimizer"] for p in ckpt["ranks"]], groups))


def _old_fsdp_meta(model, topo: dict):
    """The FSDP flat layout the checkpoint was saved in."""
    from distributeddataparallel_tpu_torch.parallel.fsdp import FsdpMeta

    tp_axis = MODEL_AXIS if topo["n_tp"] > 1 else None
    cfg = dataclasses.replace(model.cfg, tp_axis=tp_axis)
    return FsdpMeta(cfg, int(topo["n_data"]), tp_axis, int(topo["n_tp"]))


def _position_major(ckpt: dict) -> list[dict]:
    """The payload's rank parts ordered by (model position, data index)."""
    coords = old_coords(ckpt, len(ckpt["ranks"]))
    order = sorted(range(len(coords)), key=lambda r: (coords[r].get(MODEL_AXIS, 0), coords[r][DATA_AXIS]))
    return [ckpt["ranks"][r] for r in order]

