"""Native (C++) host kernels of the input path, bound with ctypes.

Counterpart of ``distributeddataparallel_tpu/native/__init__.py``, built from
the port's own copy of the source, ``csrc/ddp_native.cpp``:

- ``gather_rows``: ``out[i] = src[idx[i]]`` over float32 rows;
- ``gather_normalize_u8``: the gather fused with ToTensor + Normalize,
  ``(src[idx[i]] / 255 - shift) / scale`` computed as
  ``(x * f32(1/255) - shift) * f32(1/scale)``;
- ``gather_augment_u8``: the gather, RandomCrop(pad) at given offsets with a
  fill, the horizontal flip and the normalize in one pass;
- ``chw_to_hwc``: (N, C, H, W) float32 -> (N, H, W, C).

A call spreads its rows over up to ``DEFAULT_THREADS`` threads, one per
``BYTES_PER_THREAD`` of output (``threads_for``): the reference always
starts up to 8, which costs more than a small batch's copy.

Each keeps its numpy version beside it (``*_numpy``), which computes the
same float32 operations in the same order, so the two are bit-equal.  The
native path is taken where the reference's takes it: a C-contiguous source
of the kernel's dtype (float32 rows for ``gather_rows`` and ``chw_to_hwc``,
uint8 for the other two); other sources get the numpy version.  Indices
follow numpy's rules: negatives count from the end, and one out of range
raises ``IndexError``.

The library is compiled with ``g++`` on first use into
``training.warm_start.build_root()`` (the package's git-ignored ``_build/``,
or ``DIR/build/`` under ``--compile-cache DIR``), under a name keyed by the
source's digest, the flags and the compiler's version: a temporary name,
then an atomic rename, under a lock (``warm_start.build_library``, which
also rebuilds a cached library that fails its digest or its load).  Unlike
the reference there is no quiet fallback: a
missing compiler or a failed build or load raises with the compiler's
message.  ``CALLS`` counts the native calls of each function since the last
``reset_calls()``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from distributeddataparallel_tpu_torch.training import warm_start

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "ddp_native.cpp"
# The reference's Makefile flags, with products and sums kept apart
# (-ffp-contract=off): a fused multiply-add would round once where numpy
# rounds twice.
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-ffp-contract=off",
             "-shared", "-pthread")

#: most worker threads of one call (the reference's count)
DEFAULT_THREADS = min(8, os.cpu_count() or 1)
#: output bytes a worker thread must have before the call starts another:
#: the kernels start their threads afresh on every call, at ~0.25 ms each on
#: the H100 machine's host, which 32 CIFAR rows (393 KB) do not repay
BYTES_PER_THREAD = 4 << 20

#: Native calls per function since the last ``reset_calls()``.
CALLS = {"gather_rows": 0, "gather_normalize_u8": 0, "gather_augment_u8": 0, "chw_to_hwc": 0}

_lock = threading.Lock()
_lib = None


def reset_calls() -> None:
    for name in CALLS:
        CALLS[name] = 0


def _cxx() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++")


def _toolchain() -> dict:
    cxx = _cxx()
    return {"cxx": os.path.basename(cxx) if cxx else None,
            "version": warm_start._first_line([cxx, "--version"]) if cxx else None}


def build() -> Path:
    """The library, compiled unless it is in the build cache intact.
    Raises ``RuntimeError`` with the compiler's output when it fails."""
    cxx = _cxx()
    if not cxx:
        raise RuntimeError(
            f"g++ not found (set CXX or put g++ on PATH): the native input kernels "
            f"are built from {SOURCE} on first use")

    def compile_to(tmp: Path) -> None:
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"building {SOURCE.name} failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cxx)} failed ({proc.returncode}) building {SOURCE.name}:\n"
                f"{proc.stderr[-4000:]}")

    return warm_start.build_library("ddp_native", SOURCE, CXX_FLAGS, _toolchain(), compile_to)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int
            lib.ddp_gather_rows_f32.argtypes = [ptr, ptr, i64, i64, ptr, i32]
            lib.ddp_gather_norm_u8.argtypes = [ptr, ptr, i64, i64, f32, f32, ptr, i32]
            lib.ddp_chw_to_hwc_f32.argtypes = [ptr, i64, i64, i64, i64, ptr, i32]
            lib.ddp_gather_augment_u8.argtypes = [
                ptr, ptr, i64, i64, i64, i64, ptr, ptr, ptr, i64, f32, f32, f32, ptr, i32]
            for fn in (lib.ddp_gather_rows_f32, lib.ddp_gather_norm_u8, lib.ddp_chw_to_hwc_f32,
                       lib.ddp_gather_augment_u8):
                fn.restype = None
            _lib = lib
        return _lib


def _indices(idx, n: int) -> np.ndarray:
    """``idx`` as C-contiguous int64 in [0, n), by numpy's rules."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.ndim != 1:
        raise IndexError(f"expected a 1-d index array, got shape {idx.shape}")
    if len(idx) and (idx.min() < -n or idx.max() >= n):
        bad = idx[(idx < -n) | (idx >= n)][0]
        raise IndexError(f"index {bad} is out of bounds for axis 0 with size {n}")
    return np.where(idx < 0, idx + n, idx) if len(idx) and idx.min() < 0 else idx


def threads_for(out_bytes: int) -> int:
    """Worker threads for a call writing ``out_bytes``: one per
    ``BYTES_PER_THREAD``, between 1 and ``DEFAULT_THREADS``.  Each output
    row is computed alike whatever the count."""
    return max(1, min(DEFAULT_THREADS, out_bytes // BYTES_PER_THREAD))


def _native(src: np.ndarray, dtype, min_ndim: int = 1) -> bool:
    return src.dtype == dtype and src.flags.c_contiguous and src.ndim >= min_ndim


def _normalize_numpy(x: np.ndarray, shift: float, scale: float) -> np.ndarray:
    return (x.astype(np.float32) * np.float32(1.0 / 255.0) - np.float32(shift)) \
        * np.float32(1.0 / scale)


# ------------------------------------------------------------ gather_rows ----

def gather_rows_numpy(src: np.ndarray, idx) -> np.ndarray:
    return src[np.asarray(idx, dtype=np.int64)]


def gather_rows(src: np.ndarray, idx) -> np.ndarray:
    """``out[i] = src[idx[i]]``; native for C-contiguous float32 rows."""
    if not _native(src, np.float32, 2):
        return gather_rows_numpy(src, idx)
    idx = _indices(idx, len(src))
    out = np.empty((len(idx),) + src.shape[1:], np.float32)
    _load().ddp_gather_rows_f32(src.ctypes.data, idx.ctypes.data, len(idx),
                                int(np.prod(src.shape[1:])), out.ctypes.data, threads_for(out.nbytes))
    CALLS["gather_rows"] += 1
    return out


# ---------------------------------------------------- gather_normalize_u8 ----

def gather_normalize_u8_numpy(src: np.ndarray, idx, *, shift: float = 0.5,
                              scale: float = 0.5) -> np.ndarray:
    return _normalize_numpy(src[np.asarray(idx, dtype=np.int64)], shift, scale)


def gather_normalize_u8(src: np.ndarray, idx, *, shift: float = 0.5,
                        scale: float = 0.5) -> np.ndarray:
    """``(src[idx[i]] / 255 - shift) / scale`` as float32: ToTensor +
    Normalize fused into the gather; native for C-contiguous uint8."""
    if not _native(src, np.uint8):
        return gather_normalize_u8_numpy(src, idx, shift=shift, scale=scale)
    idx = _indices(idx, len(src))
    out = np.empty((len(idx),) + src.shape[1:], np.float32)
    _load().ddp_gather_norm_u8(src.ctypes.data, idx.ctypes.data, len(idx),
                               int(np.prod(src.shape[1:])), shift, scale, out.ctypes.data,
                               threads_for(out.nbytes))
    CALLS["gather_normalize_u8"] += 1
    return out


# ------------------------------------------------------ gather_augment_u8 ----

def gather_augment_u8_numpy(src, idx, oy, ox, flip, *, padding: int, shift: float = 0.5,
                            scale: float = 0.5, fill: float = -1.0) -> np.ndarray:
    from distributeddataparallel_tpu_torch.data.transforms import _crop_at, _flip

    imgs = gather_normalize_u8_numpy(src, idx, shift=shift, scale=scale)
    return _flip(_crop_at(imgs, np.asarray(oy), np.asarray(ox), padding, fill),
                 np.asarray(flip).astype(bool))


def gather_augment_u8(src: np.ndarray, idx, oy, ox, flip, *, padding: int,
                      shift: float = 0.5, scale: float = 0.5, fill: float = -1.0) -> np.ndarray:
    """``out[i] = normalize(flip_i(crop_i(src[idx[i]])))`` in one pass.

    ``src`` (N, H, W, C) uint8; ``oy``/``ox`` per-row crop offsets in
    [0, 2 * padding]; ``flip`` per-row 0/1; ``fill`` in normalized units
    (-1.0 is black).  Native for C-contiguous 4-d uint8."""
    if not _native(src, np.uint8, 4) or src.ndim != 4:
        return gather_augment_u8_numpy(src, idx, oy, ox, flip, padding=padding, shift=shift,
                                       scale=scale, fill=fill)
    idx = _indices(idx, len(src))
    n, h, w, c = src.shape
    oy = np.ascontiguousarray(oy, dtype=np.int64)
    ox = np.ascontiguousarray(ox, dtype=np.int64)
    flip = np.ascontiguousarray(flip, dtype=np.uint8)
    if not len(oy) == len(ox) == len(flip) == len(idx):
        raise ValueError(f"{len(idx)} rows but {len(oy)}/{len(ox)}/{len(flip)} offsets/flips")
    if len(idx) and (min(oy.min(), ox.min()) < 0 or max(oy.max(), ox.max()) > 2 * padding):
        raise ValueError(f"crop offsets must lie in [0, {2 * padding}]")
    out = np.empty((len(idx), h, w, c), np.float32)
    _load().ddp_gather_augment_u8(src.ctypes.data, idx.ctypes.data, len(idx), h, w, c,
                                  oy.ctypes.data, ox.ctypes.data, flip.ctypes.data, int(padding),
                                  shift, scale, fill, out.ctypes.data, threads_for(out.nbytes))
    CALLS["gather_augment_u8"] += 1
    return out


# ------------------------------------------------------------- chw_to_hwc ----

def chw_to_hwc_numpy(src: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(src.transpose(0, 2, 3, 1))


def chw_to_hwc(src: np.ndarray) -> np.ndarray:
    """(N, C, H, W) -> (N, H, W, C); native for C-contiguous float32."""
    if not _native(src, np.float32, 4) or src.ndim != 4:
        return chw_to_hwc_numpy(src)
    n, c, h, w = src.shape
    out = np.empty((n, h, w, c), np.float32)
    _load().ddp_chw_to_hwc_f32(src.ctypes.data, n, c, h, w, out.ctypes.data, threads_for(out.nbytes))
    CALLS["chw_to_hwc"] += 1
    return out
