"""Seeded dropout: masks that are a pure function of an integer seed.

Counterpart of the reference's ``flax.linen.Dropout`` under an rng that the
trainer folds per (seed + 1, epoch, step, replica, microbatch) and the
model splits per layer (``dpp.py:2364-2371``, ``training/train_step.py:457,
520``, ``models/transformer.py:650,831``).

- ``fold_seed(seed, *data)``: a 64-bit seed derived from ``seed`` and the
  integers ``data`` (numpy's ``SeedSequence`` mixing), the analog of
  ``jax.random.fold_in`` chains.
- ``dropout(x, rate, seed)``: zero each element with probability ``rate``
  and scale the kept ones by ``1 / (1 - rate)``, as flax does
  (``where(keep, x / keep_prob, 0)``, ``keep_prob`` in ``x``'s dtype).  The
  mask is drawn from a generator made from ``seed`` inside the call, so
  running the call again (activation checkpointing's recompute) draws the
  same mask; the default generator's state is neither read nor advanced.

The bits differ from JAX's threefry masks: the port matches the
reference's distribution (keep rate, scale, independence across seeds),
not its masks.
"""

from __future__ import annotations

import numpy as np
import torch


def fold_seed(seed: int, *data: int) -> int:
    """A 64-bit seed that depends on ``seed`` and every integer of ``data``
    (all non-negative), in order."""
    ss = np.random.SeedSequence([int(seed), *(int(d) for d in data)])
    return int(ss.generate_state(1, np.uint64)[0])


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """``x`` with each element zeroed with probability ``rate`` and the rest
    scaled by ``1 / (1 - rate)``; the mask is a function of ``seed``."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    # 1 - rate in x's dtype, as flax divides by the weakly typed keep_prob.
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
