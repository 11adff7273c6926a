"""Warm start: the kernel build cache and bounded dispatch.

Counterpart of ``distributeddataparallel_tpu/training/warm_start.py``, the
parts that have a meaning for an eager PyTorch trainer:

- ``enable_compile_cache(dir)``: one switch that roots every kernel build
  of this process at ``dir/build/`` (``build_root``) and exports
  ``DDP_COMPILE_CACHE``, so spawned and respawned gang members (fresh
  interpreters) inherit it before their first build
  (``runtime.launcher``).  Without it the builds go to the package's own
  ``_build/``, as before.
- ``build_library``: the one build path of the port's hand-written
  kernels (``ops.flash_attention``'s ``nvcc`` build, ``native``'s ``g++``
  build).  A library is keyed by its source's digest, the compiler flags
  and the toolchain (``runtime_versions()`` for ``nvcc``; the compiler's
  own version for the host library), so a cache written by one toolchain
  is never loaded by another.  A library found under its key is a hit,
  once its sidecar digest matches and it loads; a truncated, altered or
  unloadable one is rebuilt loudly (a warning names it).  A failed build
  raises: nothing ever gives way to a kernel's plain version.
- ``CompileCacheStats`` (``STATS``): the builds that hit and the builds
  that missed in this process; ``warm_start_mode`` turns them into the
  ``warm_start`` event's mode: ``cold`` when this process built a kernel,
  ``cache-hit`` when every build was found, ``eager`` without the cache.
- ``runtime_versions()``: torch, the CUDA runtime, ``nvcc --version``, the
  device's name and capability.
- ``BoundedDispatch``: the train loop's bounded run-ahead: at most K steps
  in flight, each settled when it leaves the window or at a boundary drain.

Left out, with no torch counterpart: ``ExecutableStore``,
``executable_key``'s executable use, ``warm_train_step``, ``warm_program``,
``precompile_step``, ``BackgroundPrecompiler`` and
``probe_reserialize_capability``.  They persist and reload serialized XLA
executables of a traced step; an eager PyTorch step is no such program (its
kernels are cuBLAS's, cuDNN's, PyTorch's own and the port's hand-written
ones, which this cache keeps).  Capturing the step or the serving engine's
decode as a CUDA graph is speed work, not a port of these.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Callable

from distributeddataparallel_tpu_torch.utils.logging import get_logger

_PKG = Path(__file__).resolve().parents[1]
#: The builds' root without ``--compile-cache``: the package's own,
#: git-ignored ``_build/``.
DEFAULT_BUILD_DIR = _PKG / "_build"
ENV = "DDP_COMPILE_CACHE"

_cache_dir: str | None = None
_lock = threading.Lock()


def enable_compile_cache(cache_dir: str) -> str:
    """Root this process's kernel builds at ``cache_dir/build/`` and export
    ``DDP_COMPILE_CACHE`` so child processes inherit the cache; returns the
    absolute directory.  Libraries already loaded stay loaded."""
    global _cache_dir
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(os.path.join(cache_dir, "build"), exist_ok=True)
    _cache_dir = cache_dir
    os.environ[ENV] = cache_dir
    return cache_dir


def build_root() -> Path:
    """Where kernel libraries are built and looked up."""
    return Path(_cache_dir) / "build" if _cache_dir else DEFAULT_BUILD_DIR


class CompileCacheStats:
    """Builds that were found under their key (``hits``) and builds that
    ran a compiler (``misses``) in this process, with one record a build.
    A respawn that was meant to hit the cache and shows misses is a
    warm-start regression, visible in the fault summary."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.records: list[dict] = []

    def note(self, name: str, path: Path, hit: bool, seconds: float) -> None:
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        self.records.append({"name": name, "path": str(path), "hit": hit, "seconds": seconds})

    def reset(self) -> None:
        self.hits = self.misses = 0
        self.records = []


#: This process's build accounting.
STATS = CompileCacheStats()


def warm_start_mode() -> str:
    """The ``warm_start`` event's mode: ``eager`` without the compile cache,
    ``cold`` when this process built a library, else ``cache-hit``."""
    if _cache_dir is None:
        return "eager"
    return "cold" if STATS.misses else "cache-hit"


def _first_line(cmd: list[str]) -> str | None:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    text = (out.stdout or out.stderr).strip()
    return text.splitlines()[-1] if out.returncode == 0 and text else None


def nvcc_path() -> str | None:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    return None


@functools.lru_cache(maxsize=None)
def _nvcc_version() -> str | None:
    nvcc = nvcc_path()
    return _first_line([nvcc, "--version"]) if nvcc else None


def runtime_versions() -> dict:
    """The toolchain part of a kernel build's key: torch, the CUDA runtime
    torch was built with, ``nvcc --version`` (its last line), the device's
    name and compute capability (None where absent)."""
    import torch

    device = capability = None
    if torch.cuda.is_available():
        device = torch.cuda.get_device_name(0)
        capability = list(torch.cuda.get_device_capability(0))
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": _nvcc_version(),
            "device": device, "capability": capability}


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def library_path(name: str, source: Path, flags, toolchain: dict) -> Path:
    """The library's path under ``build_root()``: its name and a digest of
    the source, the flags and the toolchain."""
    key = source.read_bytes() + json.dumps([list(flags), toolchain], sort_keys=True).encode()
    return build_root() / f"lib{name}_{hashlib.sha256(key).hexdigest()[:16]}.so"


def _intact(so: Path) -> str | None:
    """None if ``so`` matches its sidecar digest and loads, else why not."""
    sidecar = so.with_name(so.name + ".sha256")
    if not sidecar.exists():
        return "no digest sidecar"
    if sidecar.read_text().strip() != _sha256(so):
        return "its bytes do not match the digest written at build time"
    try:
        ctypes.CDLL(str(so))
    except OSError as e:
        return f"it does not load ({e})"
    return None


def build_library(name: str, source: Path, flags, toolchain: dict,
                  compile_fn: Callable[[Path], None]) -> Path:
    """The library ``name`` built from ``source``: found under its key (a
    hit) or compiled by ``compile_fn(tmp_path)`` (a miss), which raises on
    failure.  The result is published by an atomic rename, with a sidecar
    of its sha256.  A library whose bytes or load fail the check is
    rebuilt, with a warning."""
    so = library_path(name, source, flags, toolchain)
    t0 = time.perf_counter()
    with _lock:
        if so.exists():
            why = _intact(so)
            if why is None:
                STATS.note(name, so, True, time.perf_counter() - t0)
                return so
            get_logger().warning("kernel cache: %s is unusable (%s): rebuilding it", so, why)
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
        try:
            compile_fn(tmp)
            digest = _sha256(tmp)
            side = so.with_name(so.name + ".sha256")
            side_tmp = side.with_name(side.name + f".{os.getpid()}.tmp")
            side_tmp.write_text(digest + "\n")
            os.replace(tmp, so)  # atomic: concurrent builds each publish a whole file
            os.replace(side_tmp, side)
        finally:
            tmp.unlink(missing_ok=True)
        STATS.note(name, so, False, time.perf_counter() - t0)
        return so


class BoundedDispatch:
    """Bounded run-ahead: at most ``depth`` steps in flight.

    The train loop pushes one handle per step (with the nonfinite guard
    armed the step's flag, else its loss); once more than ``depth`` are
    outstanding the oldest is handed back to be settled (read on the
    host), so the host never runs more than ``depth`` steps ahead of the
    device.  ``depth=0`` settles every step at once.  The guard skips a
    bad step's update on the device, so the steps dispatched past it are
    no corruption; the breaker still observes every flag in order, with a
    lag of at most ``depth`` steps.  ``drain()`` at windows, log lines,
    checkpoints and epoch edges hands back everything in flight."""

    def __init__(self, depth: int):
        if depth < 0:
            raise ValueError(f"dispatch depth must be >= 0, got {depth}")
        self.depth = depth
        self._q: Any = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, handle, meta=None) -> list[tuple[Any, Any]]:
        """Enqueue one step's handle; returns the (handle, meta) pairs that
        fell out of the window and must be settled now."""
        self._q.append((handle, meta))
        out = []
        while len(self._q) > self.depth:
            out.append(self._q.popleft())
        return out

    def drain(self) -> list[tuple[Any, Any]]:
        """Hand back everything in flight (a boundary sync)."""
        out = list(self._q)
        self._q.clear()
        return out
