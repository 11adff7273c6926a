"""Process-group runtime on ``torch.distributed``.

Counterpart of ``distributeddataparallel_tpu/runtime/distributed.py`` with
the world shaped the GPU way: one process per device, NCCL between CUDA
devices and gloo on the CPU.  Rendezvous is an explicit TCP address with
the world size and rank given by the caller; nothing is read from the
environment.  A multi-host job takes the reference's triple
(``coordinator_address``, ``num_processes`` hosts, this host's
``process_id``): each host runs one process per local device, so the world
is hosts x local devices and a process's global rank is
``process_id * local_devices + local_rank``.

A gang formed on a launcher's store can be re-formed at another size in
the same processes (``rebuild_process_group``, the elastic resize): every
group is destroyed and the surviving members join a new one on the same
store, under a prefix of the membership epoch, ranked in roster order.  A
process that was not in the current group (an elastic grow's joiner) enters
the re-formed one there too (``enter_process_group``).
"""

from __future__ import annotations

import itertools
import math
import random
import socket

import torch
import torch.distributed as dist


#: Where ``free_port`` looks: below Linux's default ephemeral range
#: (32768-60999) and IANA's (49152-65535).
_FIXED_PORTS = (20000, 32767)


def free_port() -> int:
    """A localhost TCP port that is free now, for a rendezvous that another
    process binds later.  It lies outside the ephemeral ranges, so no
    outgoing connection and no ``bind(0)`` (NCCL's, gloo's) can take it in
    between: only another explicit bind can, and the pick is random."""
    rng = random.SystemRandom()
    for _ in range(100):
        port = rng.randint(*_FIXED_PORTS)
        # ddplint: allow[blocking-socket] — a free-port probe's bind, not a dial
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free localhost port in {_FIXED_PORTS}")


def init_process_group(
    *,
    store_address: str | None = None,
    world_size: int = 1,
    rank: int = 0,
    device: torch.device | str = "cpu",
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the process group (one process per device); returns this
    process's ``(global rank, world size)``.

    The backend is NCCL for a CUDA ``device`` and gloo otherwise.  With
    ``coordinator_address`` (``host:port``, the TCP rendezvous) the job is
    ``num_processes`` hosts of ``world_size`` local ranks each: ``rank`` is
    this process's local rank and ``process_id`` its host's index.
    Otherwise a group of several forms through ``store_address``
    (``host:port`` of a ``TCPStore`` that its launcher already holds, so
    there is no port to race another process for), and a single process
    forms its group on an in-process store.  A CUDA device becomes this
    process's current device before the group forms."""
    global _STORE_ADDRESS
    if dist.is_initialized():
        raise RuntimeError(
            "init_process_group called twice; call destroy_process_group first"
        )
    device = torch.device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id} is not in [0, {num_processes})")
        rank = process_id * world_size + rank
        world_size = num_processes * world_size
        # The coordinator is the rendezvous (global rank 0 binds it); a
        # launcher's store is local to one host.
        rendezvous = {"init_method": f"tcp://{coordinator_address}"}
    elif store_address is not None:
        host, port = store_address.rsplit(":", 1)
        rendezvous = {"store": dist.TCPStore(host, int(port), world_size, is_master=False)}
    elif world_size == 1:
        rendezvous = {"store": dist.HashStore()}
    else:
        raise ValueError("store_address or coordinator_address is required for world_size > 1")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", world_size=world_size, rank=rank, **rendezvous,
    )
    _STORE_ADDRESS = store_address
    return rank, world_size


#: The launcher store this process's group formed on (``store_address``),
#: which ``rebuild_process_group`` forms the next one on.
_STORE_ADDRESS: str | None = None


_NO_STORE = ("needs a group formed on a launcher's store (store_address): a --coordinator gang resizes "
             "through hostgang (ROADMAP item 20b)")


def rebuild_process_group(members: list[int | None], epoch: int) -> tuple[int, int] | None:
    """Re-form the process group over ``members`` (global ranks of the
    current group, in the new roster's order; None for a member that joins
    from outside it, ``enter_process_group``) after a membership change:
    the mesh and every group (NCCL's communicators with them) are
    destroyed, and each member joins a new group on the launcher's store
    under the prefix ``gang{epoch}/``, as rank ``members.index(rank)`` of
    ``len(members)``, on the backend and device it had.  Every rank of the
    current group calls it; one that is not a member leaves (the store
    stays the launcher's) and gets None, a member its ``(rank, world
    size)``.  The caller builds the mesh again (``make_mesh``)."""
    if not dist.is_initialized():
        raise RuntimeError("rebuild_process_group: no process group to rebuild")
    if _STORE_ADDRESS is None:
        raise RuntimeError(f"rebuild_process_group {_NO_STORE}")
    old, backend = dist.get_rank(), dist.get_backend()
    address = _STORE_ADDRESS
    destroy_process_group()
    if old not in members:
        return None
    return _enter(address, backend, members.index(old), len(members), epoch)


def enter_process_group(rank: int, world: int, epoch: int, *, store_address: str | None,
                        device: torch.device | str = "cpu") -> tuple[int, int]:
    """Enter the group the current members re-form at membership epoch
    ``epoch`` (``rebuild_process_group``) from outside it: an elastic grow's
    joiner, as rank ``rank`` of ``world``, on the launcher's store under
    the same ``gang{epoch}/`` prefix, on the backend its device takes (the
    gang's: a CUDA device is made current first)."""
    if dist.is_initialized():
        raise RuntimeError("enter_process_group: this process is already in a group")
    if store_address is None:
        raise RuntimeError(f"enter_process_group {_NO_STORE}")
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return _enter(store_address, "nccl" if device.type == "cuda" else "gloo", rank, world, epoch)


def _enter(address: str, backend: str, rank: int, world: int, epoch: int) -> tuple[int, int]:
    global _STORE_ADDRESS
    host, port = address.rsplit(":", 1)
    store = dist.PrefixStore(f"gang{epoch}/", dist.TCPStore(host, int(port), world, is_master=False))
    dist.init_process_group(backend, store=store, world_size=world, rank=rank)
    _STORE_ADDRESS = address
    return rank, world


def destroy_process_group() -> None:
    global _MESH, _STORE_ADDRESS
    _MESH = _STORE_ADDRESS = None
    if dist.is_initialized():
        dist.destroy_process_group()


#: The mesh's axis names, the reference's (``dpp.py:511-533``), in its
#: canonical order: the data-parallel replicas outermost, then the sequence
#: shards (``--cp``), the pipeline stages (``--pp``), the expert shards
#: (``--ep``), the tensor-parallel shards (``--tp``).
DATA_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS, MODEL_AXIS = "data", "seq", "pipe", "expert", "model"
#: The joint data x seq axis: every (data, seq) rank of one model line.
#: One mean over it is the seq mean followed by the data mean (equal group
#: sizes), which ``--overlap`` launches from backward under ``--cp``.
DATA_SEQ = (DATA_AXIS, SEQ_AXIS)


class Mesh:
    """The ranks laid out row-major over named axes (the reference's device
    mesh, ``distributed.py:180-203``): rank ``r`` sits at the coordinates of
    ``r`` in an array of ``shape``, so the first axis is outermost.  Each axis
    has one process group per line of ranks along it; ``group(axis)`` is the
    one through this rank."""

    def __init__(self, axes, shape, rank: int, groups: dict):
        self.axes, self.shape = tuple(axes), tuple(shape)
        self.rank = rank
        self._groups = groups
        self.coords = dict(zip(self.axes, _unravel(rank, self.shape)))

    def size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def coords_of(self, rank: int) -> dict:
        """The coordinates of ``rank`` on this mesh."""
        return dict(zip(self.axes, _unravel(rank, self.shape)))

    def rank_at(self, coords: dict) -> int:
        """The rank at ``coords`` (an axis missing from it: index 0)."""
        return int(sum(coords.get(a, 0) * s for a, s in zip(self.axes, _strides(self.shape))))

    def group(self, axis):
        """The process group of ``axis`` (a name, or ``DATA_SEQ``) through
        this rank (None without a process group)."""
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({dict(zip(self.axes, self.shape))}, rank {self.rank} at {self.coords})"


_MESH: Mesh | None = None


def _unravel(rank: int, shape) -> tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def make_mesh(axes=("data",), shape=None) -> Mesh:
    """Lay the world's ranks out over ``axes`` (``shape`` defaults to every
    rank on the first axis) and build one process group per line of ranks
    along each axis (and, on a mesh with both, one over the ``data`` x
    ``seq`` ranks of each model line: ``DATA_SEQ``); the mesh becomes the
    current one (``current_mesh``,
    ``axis_size``), as a ``shard_map`` binds its axes in the reference.  A
    collective: every rank calls it with the same arguments, since every
    rank must join the creation of every group."""
    global _MESH
    world, rank = get_world_size(), get_rank()
    axes = tuple(axes)
    shape = tuple(shape) if shape is not None else (world,) + (1,) * (len(axes) - 1)
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} over axes {axes} does not cover {world} ranks")
    groups = {}
    for a, axis in enumerate(axes):
        # A group of its own even where the axis spans the world: None
        # stands for "no such axis" in the callers.
        groups[axis] = _line_groups(shape, (a,), rank)
    if all(axis in axes for axis in DATA_SEQ):
        groups[DATA_SEQ] = _line_groups(shape, tuple(axes.index(axis) for axis in DATA_SEQ), rank)
    _MESH = Mesh(axes, shape, rank, groups)
    return _MESH


def _line_groups(shape, dims: tuple[int, ...], rank: int):
    """One process group per set of ranks that differ only along ``dims``
    (every rank creates every group, in one order); returns this rank's."""
    mine = None
    others = [d for d in range(len(shape)) if d not in dims]
    for rest in itertools.product(*(range(shape[d]) for d in others)):
        ranks = []
        for inner in itertools.product(*(range(shape[d]) for d in dims)):
            coord = [0] * len(shape)
            for d, c in zip(others, rest):
                coord[d] = c
            for d, c in zip(dims, inner):
                coord[d] = c
            ranks.append(int(sum(c * s for c, s in zip(coord, _strides(shape)))))
        g = dist.new_group(ranks) if dist.is_initialized() else None
        if rank in ranks:
            mine = g
    return mine


def _strides(shape) -> list[int]:
    out, s = [], 1
    for n in reversed(shape):
        out.append(s)
        s *= n
    return list(reversed(out))


def current_mesh() -> Mesh | None:
    return _MESH


def clear_mesh() -> None:
    """No current mesh (plain DP): a trainer built after a meshed one in
    the same process must not see that one's axes."""
    global _MESH
    _MESH = None


def axis_size(axis: str | None) -> int:
    """The size of ``axis`` in the current mesh; 1 when the axis is None or
    not bound (no mesh, or a mesh without it): the unsharded shapes, as the
    reference's ``tp_size`` outside ``shard_map``."""
    if axis is None or _MESH is None or axis not in _MESH.axes:
        return 1
    return _MESH.size(axis)


def axis_index(axis: str | None) -> int:
    """This rank's index along ``axis`` (0 when it is not bound)."""
    if axis_size(axis) == 1:
        return 0
    return _MESH.index(axis)


def axis_group(axis):
    """The process group of ``axis`` (a name, or ``DATA_SEQ``) through this
    rank (None only without a process group: one rank)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    if _MESH is None or any(a not in _MESH.axes for a in names):
        raise ValueError(f"mesh axis {axis!r} is not bound (make_mesh first)")
    return _MESH.group(axis)


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _collective_device() -> torch.device:
    """Where a collective's tensor lives: the current CUDA device under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _reduce_flag(flag: bool, op) -> bool:
    if get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([float(flag)], device=_collective_device())
    dist.all_reduce(t, op=op)
    return bool(t.item())


def agree(flag: bool) -> bool:
    """True on every rank iff ``flag`` is true on every rank (one
    all-reduce, MIN)."""
    return _reduce_flag(flag, dist.ReduceOp.MIN)


def any_rank(flag: bool) -> bool:
    """True on every rank iff ``flag`` is true on some rank (one all-reduce,
    MAX)."""
    return _reduce_flag(flag, dist.ReduceOp.MAX)


def broadcast_object(obj):
    """Rank 0's ``obj`` (a picklable value) on every rank."""
    if get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_collective_device())
    return box[0]
