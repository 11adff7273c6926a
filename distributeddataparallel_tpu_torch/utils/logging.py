"""Rank-0-gated logging: the analog of ``if rank == 0: print(...)``.

A copy of the JAX package's ``utils/logging.py`` gated on this process's
rank in the ``torch.distributed`` group (0 when no group is formed) instead
of ``process_index()``.  Callers pass metrics that are already
host-side, or log at a cadence where reading a device value is off the hot
path.
"""

from __future__ import annotations

import logging
import os
import sys


def process_index() -> int:
    """This process's rank in the default process group; 0 without one."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

_LOGGER: logging.Logger | None = None


def _level_from_env() -> int:
    """Resolve DDP_LOG_LEVEL ("DEBUG"/"INFO"/"warning"/numeric) to a
    logging level; unknown values fall back to INFO rather than erroring
    — a typo in an env var must not take down a training run."""
    name = os.environ.get("DDP_LOG_LEVEL", "").strip()
    if not name:
        return logging.INFO
    if name.isdigit():
        return int(name)
    level = logging.getLevelName(name.upper())
    return level if isinstance(level, int) else logging.INFO


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("ddp_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("[%(asctime)s ddp-torch] %(message)s", "%H:%M:%S")
            )
            logger.addHandler(h)
            logger.propagate = False
        logger.setLevel(_level_from_env())
        _LOGGER = logger
    return _LOGGER


def log0(msg: str, *args) -> None:
    """Log from process 0 only (analog of the rank-0 gate at ref dpp.py:54)."""
    if process_index() == 0:
        get_logger().info(msg, *args)


def warn0(msg: str, *args) -> None:
    """Warning-level rank-0 log — fault-path events (checkpoint retries,
    skipped non-finite steps, watchdog fires) that must stand out from
    the loss cadence in the stream."""
    if process_index() == 0:
        get_logger().warning(msg, *args)


def warn_all(msg: str, *args) -> None:
    """Warning from EVERY process, prefixed with its index — for faults
    that are per-worker facts (a watchdog firing on rank 3 must not be
    silenced by the rank-0 gate; rank 0 may be the healthy one)."""
    get_logger().warning(f"[proc {process_index()}] {msg}", *args)
