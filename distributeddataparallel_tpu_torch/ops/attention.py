"""Attention ops: causal multi-head / grouped-query attention + RoPE.

Counterpart of ``distributeddataparallel_tpu/ops/attention.py``; public
functions keep its layouts (q/k/v ``(B, S, H, D)``).

- ``dot_product_attention`` is the plain reference: f32 logits and softmax,
  matmuls in the input dtype.
- ``attention()`` dispatches between it and the flash kernels
  (``ops.flash_attention``) through ``impl``: ``"plain"``, ``"kernel"`` or
  ``"auto"``.  ``auto`` sends CUDA tensors to the kernels, which raise for a
  shape outside their envelope, and CPU tensors to the plain version.  There
  is no compile probe and no fall-back on failure.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30  # softmax-safe -inf that survives bf16 casts


def rope_frequencies(
    head_dim: int, max_len: int, *, theta: float = 10000.0, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Precompute RoPE cos/sin tables of shape (max_len, head_dim // 2)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponent)
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # (max_len, head_dim/2)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotate query/key halves by position-dependent angles.

    x: (B, S, H, D); cos/sin: (max_len, D/2); positions: (S,) or (B, S)
    int positions into the tables (default arange(S)).  Positions past the
    tables read their last row, as XLA's clamping gather does.
    """
    S = x.shape[1]
    if positions is None:
        c, s = cos[None, :S], sin[None, :S]  # (1, S, D/2)
    else:
        idx = positions.clamp(0, cos.shape[0] - 1)
        c, s = cos[idx], sin[idx]  # (S, D/2) or (B, S, D/2)
        if c.dim() == 2:
            c, s = c[None], s[None]
    c = c[:, :, None, :]  # (B|1, S, 1, D/2)
    s = s[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return rotated.to(x.dtype)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: (B,S,Hkv,D) -> (B,S,Hkv*n,D)."""
    if n_rep == 1:
        return x
    B, S, H, D = x.shape
    return x[:, :, :, None, :].expand(B, S, H, n_rep, D).reshape(B, S, H * n_rep, D)


def causal_mask_bias(
    q_len: int,
    kv_len: int,
    *,
    q_offset: int | torch.Tensor = 0,
    kv_offset: int | torch.Tensor = 0,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """(q_len, kv_len) additive bias: 0 where kv_pos <= q_pos, NEG_INF above.

    Offsets give the global position of each chunk's first element (ints,
    or 0-d tensors on ``device`` so no host read is needed)."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    kv_pos = kv_offset + torch.arange(kv_len, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=device)
    return torch.where(kv_pos <= q_pos, zero, neg).to(dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain attention. q: (B,Sq,H,D); k/v: (B,Skv,H,D) -> (B,Sq,H,D).

    Logits and softmax in float32; matmuls in the input dtype.  ``bias``
    (broadcastable to (B, H, Sq, Skv)) is added to the f32 logits: the KV
    cache's positional mask, whose finite ``NEG_INF`` gives rows past a
    sequence's position exactly zero weight."""
    Sq, D = q.shape[1], q.shape[3]
    Skv = k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (1.0 / math.sqrt(D))
    if causal:
        # Sq != Skv: queries are the LAST Sq positions of the kv sequence.
        logits = logits + causal_mask_bias(Sq, Skv, q_offset=Skv - Sq, device=q.device)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch: ``"plain"`` reference, ``"kernel"`` flash kernels, or
    ``"auto"`` (kernels for CUDA tensors, plain for CPU tensors).

    GQA: k/v may carry fewer heads than q (H % Hkv == 0).  The kernels read
    the shared kv head per query-head group; the plain path expands it with
    ``repeat_kv``.
    """
    if impl not in ("auto", "plain", "kernel"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "kernel" or (impl == "auto" and q.is_cuda):
        from distributeddataparallel_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal)
    H, Hkv = q.shape[2], k.shape[2]
    if Hkv != H:
        if H % Hkv:
            raise ValueError(f"num_heads {H} not a multiple of kv heads {Hkv}")
        k = repeat_kv(k, H // Hkv)
        v = repeat_kv(v, H // Hkv)
    return dot_product_attention(q, k, v, causal=causal)
