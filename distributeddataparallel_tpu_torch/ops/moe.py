"""Token-choice MoE dispatch primitives (GShard / Switch convention).

Counterpart of ``distributeddataparallel_tpu/ops/moe.py``.  The dense
dispatch of ``models.transformer.MoEMLP`` pushes every token through every
local expert; token choice materialises each token in at most K expert
slots of a per-expert ``capacity``, so the expert FLOPs scale with K, not E:

- ``capacity = max(1, ceil(K * T / E * capacity_factor))`` slots an expert.
- Priority is token order: when an expert overflows, the later tokens drop
  (their MoE output is zero and the residual carries them).
- Dispatch and combine are sort-based: a stable ``argsort`` by expert id,
  then two O(T*K) gathers and scatters.

Every shape is static and nothing is read back to the host: the counts per
expert are a scatter-add of ones (the reference's ``.at[e].add(1)``), not
``torch.bincount``, whose CUDA version reads the input's max on the host.
Overflowed pairs go to a sentinel slot ``E*C`` of a buffer one longer,
which is then cut off (the reference's ``mode="drop"`` scatter).
"""

from __future__ import annotations

import math

import torch


def moe_capacity(num_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Static per-expert slot count for a (sub-)batch of ``num_tokens``."""
    return max(1, math.ceil(top_k * num_tokens / num_experts * capacity_factor))


def token_choice_slots(idx: torch.Tensor, gates: torch.Tensor, num_experts: int, capacity: int):
    """Assign each (token, k) routing pair to an expert slot.

    idx: (T, K) expert choices; gates: (T, K) combine weights.  Returns
    ``(tok_for_slot, gate_for_slot)`` of shape (E*C,): slot ``e*C + p``
    holds the token routed to expert ``e`` at position ``p`` and its gate.
    Empty and overflowed slots keep gate 0 and token 0, which the combine
    multiplies by that 0.  Differentiable in ``gates`` (a gather and an
    out-of-place scatter); ``idx`` is integer routing."""
    T, K = idx.shape
    E, C = num_experts, capacity
    dev = idx.device
    flat_e = idx.reshape(-1).long()  # token-major: (t0 k0, t0 k1, t1 k0, ...)
    flat_g = gates.reshape(-1)
    flat_t = torch.arange(T * K, device=dev) // K
    # Stable: token order within an expert is the drop priority.
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], flat_g[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts  # exclusive
    pos = torch.arange(T * K, device=dev) - starts[se]
    slot = torch.where(pos < C, se * C + pos, torch.full_like(pos, E * C))
    tok_for_slot = torch.zeros(E * C + 1, dtype=torch.long, device=dev).scatter(0, slot, st)[: E * C]
    gate_for_slot = torch.zeros(E * C + 1, dtype=flat_g.dtype, device=dev).scatter(0, slot, sg)[: E * C]
    return tok_for_slot, gate_for_slot


def dispatch(xt: torch.Tensor, tok_for_slot: torch.Tensor) -> torch.Tensor:
    """Gather tokens into the slot buffer: (T, d) -> (E*C, d)."""
    return xt.index_select(0, tok_for_slot)


def combine(y_flat: torch.Tensor, tok_for_slot: torch.Tensor, gate_for_slot: torch.Tensor,
            num_tokens: int) -> torch.Tensor:
    """Scatter-add the gated expert outputs back to token positions, in
    ``y_flat``'s dtype: (E*C, d) -> (T, d); dropped tokens get zero."""
    weighted = y_flat * gate_for_slot[:, None].to(y_flat.dtype)
    out = torch.zeros(num_tokens, y_flat.shape[-1], dtype=y_flat.dtype, device=y_flat.device)
    return out.index_add(0, tok_for_slot, weighted)
