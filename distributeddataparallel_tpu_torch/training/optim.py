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

Under ``--nan-guard`` the step decides its skip on the device
(``training.train_step``), so the update runs on every step and skips
inside the optimizer's kernel: the optimizer is torch's fused one, which
reads ``found_inf`` (a bad step leaves the parameters, the moments and the
per-parameter ``step`` as they were), and the schedule is a
``DeviceSchedule``, whose count lives on the device and advances by the
verdict (optax's count, part of the discarded state in the reference's
skip).  Unguarded runs build the same fused update and keep ``LambdaLR``,
whose learning rates round as ``DeviceSchedule``'s do (its docstring): a
guarded run with no nonfinite step is the unguarded run bit for bit, as the
reference's guard selects the update an unguarded step computes.
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


def build_optimizer(args, params: Iterable[torch.nn.Parameter], total_steps: int, *,
                    fused: bool | None = None):
    """``(optimizer, scheduler)`` for ``args.optimizer`` and the schedule.
    The update is torch's fused one, guarded or not; with ``args.nan_guard``
    or ``args.integrity_every`` the scheduler is a ``DeviceSchedule``, else
    ``LambdaLR`` (module
    docstring).  ``fused=False`` asks for the foreach update (a guarded
    step refuses it)."""
    params = list(params)
    # The replica digest's verdict skips the same way (``training.integrity``).
    guard = bool(getattr(args, "nan_guard", False) or getattr(args, "integrity_every", 0))
    kw = {"fused": True} if fused is None or fused else {}
    if args.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=args.lr, momentum=args.momentum or 0.0, **kw)
    elif args.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8, **kw)
    elif args.optimizer == "adamw":
        opt = torch.optim.AdamW(
            params, lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=args.weight_decay, **kw,
        )
    else:
        raise ValueError(f"unknown optimizer {args.optimizer!r}")
    sched = lr_schedule(args, total_steps)
    base = args.lr
    factor = lambda count: sched(count) / base if base else 0.0  # noqa: E731
    if guard:
        zero_momentum(opt)
        return opt, DeviceSchedule(opt, factor, total_steps)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def is_fused(optimizer: torch.optim.Optimizer) -> bool:
    return all(g.get("fused") for g in optimizer.param_groups)


class DeviceSchedule:
    """``LambdaLR(optimizer, lr_lambda)`` with its count on the device.

    Each group's learning rate is a 0-d tensor on the parameters' device
    (the fused optimizers take a tensor LR): float64 on the CPU, whose
    fused kernels then compute what they compute from ``LambdaLR``'s Python
    float, bit for bit; float32 on the card, whose fused kernels read a
    float LR only and round a Python-float LR to float too (an H100 probe
    gave the same parameters bit for bit either way).  The values ``base * lr_lambda(c)`` for ``c`` in ``0..steps``
    are computed on the host once, as ``LambdaLR`` computes them, into a
    table on the device; ``step(advance)`` adds ``advance`` (a 0-d integer
    tensor: the guard's verdict) to the count and selects the next LR with
    no host read.  Counts past ``steps`` take the last value (the port's
    schedules are constant there).  ``state_dict`` and ``load_state_dict``
    speak ``LambdaLR``'s format, so a checkpoint moves between a guarded
    and an unguarded run; reading the count for a save is a host read."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr_lambda, steps: int):
        self.optimizer = optimizer
        groups = optimizer.param_groups
        device = groups[0]["params"][0].device
        for g in groups:
            g.setdefault("initial_lr", float(g["lr"]))
        self.base_lrs = [float(g["initial_lr"]) for g in groups]
        dtype = torch.float32 if device.type == "cuda" else torch.float64
        self.table = torch.tensor([[base * lr_lambda(c) for c in range(steps + 1)] for base in self.base_lrs],
                                  dtype=dtype, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lrs = [torch.zeros((), dtype=dtype, device=device) for _ in groups]
        self._link()

    def _link(self) -> None:
        """Point every group's LR at its tensor and set it from the count."""
        for g, lr in zip(self.optimizer.param_groups, self.lrs):
            g["lr"] = lr
        idx = self.count.clamp(max=self.table.shape[1] - 1).reshape(1)
        for lr, row in zip(self.lrs, torch.index_select(self.table, 1, idx).unbind(0)):
            lr.copy_(row.reshape(()))

    def step(self, advance: torch.Tensor | None = None) -> None:
        """Advance the count by ``advance`` (1 when None) and set the LR."""
        self.count.add_(1 if advance is None else advance)
        self._link()

    @property
    def last_epoch(self) -> int:
        return int(self.count)

    def state_dict(self) -> dict:
        count = int(self.count)
        return {"base_lrs": list(self.base_lrs), "last_epoch": count, "_step_count": count + 1,
                "_is_initial": False, "_get_lr_called_within_step": False,
                "_last_lr": [float(lr) for lr in self.lrs], "lr_lambdas": [None] * len(self.lrs)}

    def load_state_dict(self, sd: dict) -> None:
        self.count.fill_(int(sd["last_epoch"]))
        self._link()


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with a tensor LR as its Python float, so
    the file loads into a foreach optimizer too."""
    sd = optimizer.state_dict()
    for g in sd["param_groups"]:
        if isinstance(g.get("lr"), torch.Tensor):
            g["lr"] = float(g["lr"])
    return sd


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: dict) -> None:
    """``optimizer.load_state_dict(sd)``, keeping this optimizer's kind of
    update (fused or foreach) whatever the saved one's was, and its
    per-parameter ``step`` where that kind keeps it (the parameter's device
    for the fused update, the host for foreach)."""
    modes = [{k: g.get(k) for k in ("fused", "foreach", "capturable")} for g in optimizer.param_groups]
    optimizer.load_state_dict(sd)
    for g, mode in zip(optimizer.param_groups, modes):
        g.update(mode)
        on_device = bool(mode["fused"] or mode["capturable"])
        for p in g["params"]:
            st = optimizer.state.get(p, {})
            if isinstance(st.get("step"), torch.Tensor):
                st["step"] = st["step"].to(device=p.device if on_device else "cpu", dtype=torch.float32)
    if is_fused(optimizer):
        zero_momentum(optimizer)


def zero_momentum(optimizer: torch.optim.Optimizer) -> None:
    """Give a fused momentum SGD its buffers as zeros before its first step.
    Torch's fused SGD makes them with ``empty_like`` on the step it finds
    none and fills them in its kernel, which a skipped step never runs;
    from zeros the first update's buffer is ``momentum * 0 + g``, the
    gradient, as from the copy."""
    if not isinstance(optimizer, torch.optim.SGD):
        return
    for g in optimizer.param_groups:
        if g["momentum"]:
            for p in g["params"]:
                st = optimizer.state[p]
                if st.get("momentum_buffer") is None:
                    st["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
