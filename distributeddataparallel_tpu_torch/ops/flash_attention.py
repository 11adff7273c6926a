"""Flash attention: three hand-written Hopper kernels and their plain versions.

Counterpart of ``distributeddataparallel_tpu/ops/pallas_attention.py``.  The
kernels live in ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``, plain C
interface, loaded with ctypes):

- K1 ``flash_fwd``: forward, ``(out, lse)`` — replaces ``_flash_kernel``.
- K2 ``flash_bwd_dq``: dq — replaces ``_bwd_dq_kernel``.
- K3 ``flash_bwd_dkv``: (dk, dv) — replaces ``_bwd_dkv_kernel``.

Each wrapper checks its inputs and, for CUDA tensors, launches its kernel on
the current stream or raises; only tensors that lie on the CPU take the plain
PyTorch version (``*_plain`` below), which the CPU tests hold to the Pallas
kernels.  There is no fallback from a failed launch.  ``LAUNCHES`` counts the
kernel launches of each wrapper, so a run can show that it went through them.

Layouts follow the reference: q/k/v/out are ``(B, S, H, D)``; k/v may carry
fewer heads (GQA: query head h reads kv head ``h // (H // Hkv)``); lse and
delta are plain ``(B, H, Sq)`` f32 (the TPU's ``(B*H, 8, Sq)`` sublane
layout is not carried over).  ``delta = rowsum(do * out)`` is ordinary torch,
as it is XLA in the reference (``pallas_attention.py:370``).

The kernels build on first use: ``nvcc`` compiles the source into
``distributeddataparallel_tpu_torch/_build/`` (git-ignored) under a name keyed
by the source's hash, and an up-to-date library is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from distributeddataparallel_tpu_torch.ops.attention import NEG_INF

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "flash_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches per wrapper since the last ``reset_launches()``.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# --------------------------------------------------------------- build ----

def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the flash "
        "attention kernels are built from csrc/flash_attention.cu on first use"
    )


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libflash_attention_{digest}.so"


def build() -> Path:
    """Compile the kernels unless an up-to-date library exists; return it.

    The compiler's per-kernel register and shared-memory report (``ptxas
    -v``) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = so.with_suffix(".log")
    log.write_text(
        f"$ {' '.join(cmd)}\n# {time.perf_counter() - t0:.1f} s, rc "
        f"{proc.returncode}\n{proc.stdout}{proc.stderr}"
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so)  # atomic: concurrent builds each publish a whole file
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            shape = [i32] * 7 + [ptr]  # B, Sq, Skv, H, Hkv, D, causal, stream
            lib.ddp_flash_fwd.argtypes = [i32] + [ptr] * 6 + shape
            lib.ddp_flash_bwd_dq.argtypes = [i32] + [ptr] * 8 + shape
            lib.ddp_flash_bwd_dkv.argtypes = [i32] + [ptr] * 9 + shape
            for fn in (lib.ddp_flash_fwd, lib.ddp_flash_bwd_dq, lib.ddp_flash_bwd_dkv):
                fn.restype = i32
            _lib = lib
        return _lib


# ------------------------------------------------------------ checking ----

def check_envelope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless (q, k, v) is inside the kernels' envelope:
    (B, S, H, D) f32 or bf16, ``D % 8 == 0`` and ``D <= 256``,
    ``0 < Sq <= Skv`` (rows with no visible key are undefined under the
    align-to-end convention), ``H % Hkv == 0``.  Sequence lengths need not
    be multiples of any tile: the kernels mask the ragged edge."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, S, H, D) tensors, got {q.shape} {k.shape} {v.shape}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of float32, bfloat16")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head dim {D} outside the kernel envelope (multiple of 8, <= 256)")
    if not 0 < Sq <= Skv:
        raise ValueError(f"need 0 < Sq <= Skv, got Sq={Sq} Skv={Skv}")
    if B == 0 or Hkv == 0 or H % Hkv:
        raise ValueError(f"num_heads {H} not a multiple of kv heads {Hkv}")


def _on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain path); False when
    every tensor is on one CUDA device (the kernel path); raise otherwise."""
    devs = {t.device for t in ts}
    if all(d.type == "cpu" for d in devs):
        return True
    if len(devs) == 1 and next(iter(devs)).type == "cuda":
        return False
    raise ValueError(f"flash attention inputs on devices {sorted(map(str, devs))}")


def _strides(*ts: torch.Tensor):
    """(b, s, h) element strides of each (B, S, H, D) tensor, checked for
    what the kernels' 16-byte copies need: a contiguous head dim, the other
    strides whole multiples of 16 bytes, and a 16-byte aligned base."""
    flat = []
    for t in ts:
        row_bytes = [s * t.element_size() for s in t.stride()[:3]]
        if t.stride(3) != 1 or any(b % 16 for b in row_bytes) or t.data_ptr() % 16:
            raise ValueError(
                f"tensor of shape {tuple(t.shape)} strides {t.stride()} is not "
                f"laid out for the kernel (contiguous head dim, 16-byte rows)"
            )
        flat.extend(t.stride()[:3])
    return (ctypes.c_longlong * len(flat))(*flat)


def _rows(t: torch.Tensor, B: int, H: int, S: int, name: str) -> None:
    if t.shape != (B, H, S) or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 {(B, H, S)}, got {t.dtype} {tuple(t.shape)}")


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: cudaError_t {rc} (1 is an argument "
            f"outside the kernel's envelope, e.g. a sequence longer than 32 x 65535)"
        )


# -------------------------------------------------------- plain versions ----

def _expand_kv(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D): query head h reads kv head
    h // (H // Hkv), the order of ``repeat_kv``'s broadcast."""
    return x.repeat_interleave(H // x.shape[2], dim=2)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores (B, H, Sq, Skv), causal entries set to NEG_INF."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), _expand_kv(k, H).float())
    s = s * (1.0 / math.sqrt(D))
    if causal:
        q_pos = (Skv - Sq) + torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, NEG_INF)
    return s


def _as_input(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Round an f32 operand to the inputs' dtype before its product, as the
    Pallas kernels do (``p.astype(v.dtype)``, ``ds.astype(k.dtype)``); the
    identity for f32 inputs."""
    return x.to(like.dtype).float()


def flash_fwd_plain(q, k, v, causal: bool = True):
    """K1's function in plain PyTorch: ``(out, lse)`` with out in q's dtype
    and lse f32 (B, H, Sq), computed in f32 with p rounded to q's dtype
    before the product with v (``l`` sums the f32 p)."""
    H = q.shape[2]
    s = _scores(q, k, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", _as_input(p, q), _expand_kv(v, H).float())
    out = out / l_safe.transpose(1, 2)[..., None]
    return out.to(q.dtype), m + torch.log(l_safe)


def _p_ds(q, k, v, do, lse, delta, causal):
    """Recomputed probabilities and their score gradients, (B, H, Sq, Skv):
    ``p = exp(s - lse)`` (masked entries give exactly 0) and
    ``ds = p * (do v^T - delta)``."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), _expand_kv(v, q.shape[2]).float())
    return p, p * (dp - delta[..., None])


def _group_sum(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, S, H, D) per-query-head gradient -> (B, S, Hkv, D) kv gradient."""
    B, S, H, D = x.shape
    return x.view(B, S, Hkv, H // Hkv, D).sum(dim=3)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True):
    """K2's function in plain PyTorch: dq in q's dtype (ds rounded to it
    before the product with k)."""
    _, ds = _p_ds(q, k, v, do, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", _as_input(ds, q), _expand_kv(k, q.shape[2]).float())
    return (dq * (1.0 / math.sqrt(q.shape[3]))).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True):
    """K3's function in plain PyTorch: (dk, dv) in k's and v's dtypes, the
    GQA group's query heads summed into their shared kv head (ds and p
    rounded to the inputs' dtype before their products)."""
    p, ds = _p_ds(q, k, v, do, lse, delta, causal)
    Hkv = k.shape[2]
    dk = _group_sum(torch.einsum("bhqk,bqhd->bkhd", _as_input(ds, q), q.float()), Hkv)
    dv = _group_sum(torch.einsum("bhqk,bqhd->bkhd", _as_input(p, do), do.float()), Hkv)
    return (dk * (1.0 / math.sqrt(q.shape[3]))).to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``rowsum(do * out)`` in f32 as (B, H, Sq) — ordinary torch."""
    return (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_bwd_plain(q, k, v, out, lse, do, causal: bool = True):
    """The whole backward in plain PyTorch: ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# ------------------------------------------------------------ wrappers ----

def flash_fwd(q, k, v, causal: bool = True):
    """K1: ``(out, lse)``.  CUDA tensors launch the kernel (or raise); CPU
    tensors take ``flash_fwd_plain``."""
    check_envelope(q, k, v)
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, causal)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, out)
    with torch.cuda.device(q.device):
        rc = _load().ddp_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
            B, Sq, Skv, H, Hkv, D, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_rc(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True):
    """K2: dq.  CUDA tensors launch the kernel (or raise); CPU tensors take
    ``flash_bwd_dq_plain``."""
    check_envelope(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q {q.dtype} {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    _rows(lse, B, H, Sq, "lse")
    _rows(delta, B, H, Sq, "delta")
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    Skv, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = _strides(q, k, v, do, dq)
    with torch.cuda.device(q.device):
        rc = _load().ddp_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            ctypes.addressof(strides), B, Sq, Skv, H, Hkv, D, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_rc(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True):
    """K3: (dk, dv).  CUDA tensors launch the kernel (or raise); CPU tensors
    take ``flash_bwd_dkv_plain``."""
    check_envelope(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {do.dtype} {tuple(do.shape)} does not match q {q.dtype} {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    _rows(lse, B, H, Sq, "lse")
    _rows(delta, B, H, Sq, "delta")
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    Skv, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = _strides(q, k, v, do, dk, dv)
    with torch.cuda.device(q.device):
        rc = _load().ddp_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ctypes.addressof(strides), B, Sq, Skv, H, Hkv, D,
            int(causal), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_rc(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd(q, k, v, out, lse, do, causal: bool = True):
    """The backward through K2 and K3: ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with the kernels' backward; saves (q, k, v, out, lse)
    as the reference's ``custom_vjp`` does (``pallas_attention.py:220-229``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D)."""
    return FlashAttention.apply(q, k, v, causal)
