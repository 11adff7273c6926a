"""Process-group runtime on ``torch.distributed``.

Counterpart of ``distributeddataparallel_tpu/runtime/distributed.py`` with
the world shaped the GPU way: one process per device, NCCL between CUDA
devices and gloo on the CPU.  Rendezvous is an explicit TCP address
(``tcp://localhost:<port>``) with the world size and rank given by the
caller; nothing is read from the environment.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist


def free_port() -> int:
    """A currently free localhost TCP port for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(
    *,
    init_method: str | None = None,
    world_size: int = 1,
    rank: int = 0,
    device: torch.device | str = "cpu",
) -> None:
    """Join the process group (one process per device).

    The backend is NCCL for a CUDA ``device`` and gloo otherwise.
    ``init_method`` is required when ``world_size > 1``; a single process
    gets a fresh localhost port.  A CUDA device becomes this process's
    current device before the group forms."""
    if dist.is_initialized():
        raise RuntimeError(
            "init_process_group called twice; call destroy_process_group first"
        )
    device = torch.device(device)
    if init_method is None:
        if world_size != 1:
            raise ValueError("init_method (tcp://host:port) is required for world_size > 1")
        init_method = f"tcp://localhost:{free_port()}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=init_method,
        world_size=world_size, rank=rank,
    )


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
