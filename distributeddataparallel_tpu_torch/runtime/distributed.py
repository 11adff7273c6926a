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
"""

from __future__ import annotations

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
    return rank, world_size


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


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
