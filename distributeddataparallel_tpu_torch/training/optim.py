"""Optimizer + LR schedule from flags: the reference's ``build_optimizer``
(``dpp.py:1047-1080``) mapped onto ``torch.optim`` and ``LambdaLR``.

The mapping keeps optax's semantics:

- ``sgd``: ``optax.sgd(lr, momentum=args.momentum or None)`` — no momentum
  buffer at momentum 0; optax's trace ``t = g + m t`` equals torch's
  momentum buffer with no dampening.
- ``adam`` / ``adamw``: b1 0.9, b2 0.999, eps 1e-8; adamw decays every
  param by ``lr * weight_decay`` (optax adds ``wd * p`` before scaling by
  lr; torch multiplies by ``1 - lr * wd`` — the same update).
- Schedules are evaluated at the pre-increment count: optimizer step k
  (from 0) uses ``schedule(k)``, which is what ``LambdaLR`` gives when it
  steps after every optimizer step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule(init, end, steps)."""
    def f(count: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init, decay_steps, alpha)."""
    def f(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return f


def lr_schedule(args, total_steps: int) -> Callable[[int], float]:
    """The learning rate at each (pre-increment) step count."""
    if args.lr_schedule == "constant" and not args.warmup_steps:
        return lambda count: args.lr
    decay = max(total_steps - args.warmup_steps, 1)
    if args.lr_schedule == "cosine":
        sched = _cosine(args.lr, decay, (args.min_lr / args.lr) if args.lr else 0.0)
    elif args.lr_schedule == "linear":
        sched = _linear(args.lr, args.min_lr, decay)
    elif args.lr_schedule == "constant":
        sched = lambda count: args.lr
    else:
        raise ValueError(f"unknown lr schedule {args.lr_schedule!r}")
    if not args.warmup_steps:
        return sched
    warm, boundary = _linear(0.0, args.lr, args.warmup_steps), args.warmup_steps
    # optax.join_schedules: the second schedule restarts its count at 0.
    return lambda count: warm(count) if count < boundary else sched(count - boundary)


def build_optimizer(args, params: Iterable[torch.nn.Parameter], total_steps: int):
    """``(optimizer, scheduler)`` for ``args.optimizer`` and the schedule."""
    params = list(params)
    if args.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=args.lr, momentum=args.momentum or 0.0)
    elif args.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8)
    elif args.optimizer == "adamw":
        opt = torch.optim.AdamW(
            params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=args.weight_decay,
        )
    else:
        raise ValueError(f"unknown optimizer {args.optimizer!r}")
    sched = lr_schedule(args, total_steps)
    base = args.lr
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: sched(count) / base if base else 0.0
    )
    return opt, scheduler
