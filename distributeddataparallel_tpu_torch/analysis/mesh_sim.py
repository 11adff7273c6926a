"""The analytic memory-fit verdict of the reference's
``analysis/mesh_sim.py`` (``analytic_memory_fit``, a copy): the
autotuner's first pruning stage, pure arithmetic over the ZeRO ladder.

The reference's compile-only simulation (``simulate``: AOT lowering on
abstract state and the compiler's ``memory_analysis()``) has no eager
PyTorch counterpart and is kept out: an eager step has no lowered program
to analyse before it runs.

Module-import rule: stdlib only.
"""

from __future__ import annotations


def analytic_memory_fit(
    *,
    params_bytes: int,
    params_count: int,
    n_devices: int,
    zero_level: int = 0,
    moment_bytes_per_param: float = 8.0,
    act_bytes: int = 0,
    batch_bytes: int = 0,
    budget_bytes: int,
) -> dict:
    """Per-device memory-fit verdict WITHOUT running a step.

    Residency follows the ZeRO ladder (parallel.zero): optimizer moments
    shard 1/N at level >= 1, gradients at level >= 2, params at level
    >= 3.  ``moment_bytes_per_param`` defaults to adam's two f32 moments
    (8 B); low-bit moment storage (``--moment-dtype``) passes 4 (bf16)
    or 2 (int8).  ``act_bytes``/``batch_bytes`` are the caller's
    per-device activation / input estimates.  Deliberately coarse but
    directionally right, which is all analytic pruning (the autotuner's
    first stage) needs.
    """
    n = max(1, int(n_devices))
    required = (
        params_bytes / (n if zero_level >= 3 else 1)      # resident params
        + params_bytes / (n if zero_level >= 2 else 1)    # gradients
        + params_count * moment_bytes_per_param
        / (n if zero_level >= 1 else 1)                   # optimizer moments
        + act_bytes
        + batch_bytes
    )
    return {
        "required_bytes": int(required),
        "budget_bytes": int(budget_bytes),
        "fits": bool(required <= budget_bytes),
        "analytic": True,
    }
