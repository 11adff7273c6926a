"""Typed search space for the autotuner.

A trial is one assignment of the knobs dpp.py otherwise takes from the
CLI: per-chip batch size, gradient-accumulation degree, remat policy,
ZeRO level, optimizer-moment dtype, gradient bucket size, and bounded
dispatch depth.  The space is declarative (tuples per axis) and
enumeration is deterministic: the cartesian product in field order,
invalid combinations dropped by the same rules ``dpp.validate_args``
enforces, then an optional seeded shuffle — so the same seed yields the
same trial order on every host, which is what makes search results
reproducible and the determinism test meaningful.

A copy of the reference's ``tuning/space.py``: the same trials, labels,
validity verdicts and seeded order, so a search over the same space
measures the same candidates in both packages.

Module-import rule: stdlib only.
"""

from __future__ import annotations

import dataclasses
import itertools
import random

#: legal ``moment_dtype`` values (parallel.zero.low_bit_moments)
MOMENT_DTYPES = ("f32", "bf16", "int8")


@dataclasses.dataclass(frozen=True)
class TrialConfig:
    """One candidate configuration — the unit the autotuner prices,
    measures, persists, and ``dpp.py --autotune apply`` replays."""

    batch_per_chip: int = 32
    accum_steps: int = 1
    remat: bool = False
    zero: int = 0
    moment_dtype: str = "f32"
    bucket_mb: float | None = None
    dispatch_depth: int = 2

    def problems(self) -> list[str]:
        """Why this combination is invalid (empty = valid).  Mirrors the
        dpp.py argument gates so a tuned winner is always replayable."""
        out = []
        if self.batch_per_chip < 1:
            out.append(f"batch_per_chip {self.batch_per_chip} < 1")
        if self.accum_steps < 1:
            out.append(f"accum_steps {self.accum_steps} < 1")
        elif self.batch_per_chip % self.accum_steps:
            out.append(
                f"accum_steps {self.accum_steps} does not divide "
                f"batch_per_chip {self.batch_per_chip}"
            )
        if self.zero not in (0, 1, 2, 3):
            out.append(f"zero level {self.zero} not in 0..3")
        if self.moment_dtype not in MOMENT_DTYPES:
            out.append(f"moment_dtype {self.moment_dtype!r} unknown")
        elif self.moment_dtype != "f32" and self.zero < 1:
            out.append(
                "low-bit moments require the ZeRO optimizer-state path "
                "(zero >= 1)"
            )
        if self.bucket_mb is not None and self.bucket_mb <= 0:
            out.append(f"bucket_mb {self.bucket_mb} <= 0")
        if self.dispatch_depth < 0:
            out.append(f"dispatch_depth {self.dispatch_depth} < 0")
        return out

    @property
    def label(self) -> str:
        """Compact stable id — the ``trial`` field of tune_* events and
        the warm-store entry suffix."""
        bits = [
            f"b{self.batch_per_chip}",
            f"a{self.accum_steps}",
            "r1" if self.remat else "r0",
            f"z{self.zero}",
            f"m{self.moment_dtype}",
        ]
        if self.bucket_mb is not None:
            bits.append(f"k{self.bucket_mb:g}")
        bits.append(f"q{self.dispatch_depth}")
        return "-".join(bits)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrialConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def cli_flags(self, *, lm: bool = True) -> list[str]:
        """The dpp.py argv fragment that reproduces this trial.

        ``lm=False`` drops ``--remat`` — dpp.py rejects it for models
        without a remat knob (mlp/cnn), where the axis is degenerate.
        """
        out = [
            "--batch-size", str(self.batch_per_chip),
            "--accum-steps", str(self.accum_steps),
        ]
        if lm:
            out += ["--remat", "on" if self.remat else "off"]
        out += ["--dispatch-depth", str(self.dispatch_depth)]
        if self.zero:
            out += ["--zero", str(self.zero)]
        if self.moment_dtype != "f32":
            out += ["--moment-dtype", self.moment_dtype]
        if self.bucket_mb is not None:
            out += ["--bucket-mb", f"{self.bucket_mb:g}"]
        return out


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Tuple-valued axes; ``enumerate()`` yields the valid product."""

    batch_per_chip: tuple = (8, 16, 32)
    accum_steps: tuple = (1, 2)
    remat: tuple = (False, True)
    zero: tuple = (0, 1, 2)
    moment_dtype: tuple = ("f32",)
    bucket_mb: tuple = (None,)
    dispatch_depth: tuple = (2,)

    def enumerate(self, *, seed: int | None = None) -> list[TrialConfig]:
        """Every valid trial, in deterministic order.

        Field-order cartesian product filtered by ``problems()``; with a
        seed, a ``random.Random(seed)`` shuffle on top — still fully
        deterministic per seed, but decorrelates the measured top-K from
        the axis ordering when predictions tie.
        """
        axes = [
            getattr(self, f.name) for f in dataclasses.fields(TrialConfig)
        ]
        out = [
            trial
            for combo in itertools.product(*axes)
            if not (trial := TrialConfig(*combo)).problems()
        ]
        if seed is not None:
            random.Random(seed).shuffle(out)
        return out

    def size(self) -> int:
        """Product of axis lengths (before validity filtering)."""
        total = 1
        for f in dataclasses.fields(TrialConfig):
            total *= len(getattr(self, f.name))
        return total
