"""Silent-data-corruption (SDC) defence: replica digests, corrupt-rank
voting, and the glue for a checkpoint-free eviction.

Counterpart of ``distributeddataparallel_tpu/training/integrity.py``.  A
rank that computes finite but wrong values is invisible to the nonfinite
guard, and its gradients reach every replica through the next all-reduce.
The defence has four parts, as the reference's:

1. **Digest** (``make_train_step(integrity_every=N)``): after a synced
   update the data-parallel replicas hold the same bits, so a per-rank
   digest of the state's bit patterns is a replica-consistency probe.
   ``leaf_digest`` sums a tensor's bit patterns, read as unsigned integers,
   mod 2**32: integer sums are exact, so the reduction order cannot change
   the answer.  Every ``N`` steps the step digests its INPUT state before
   the forward and all-gathers the ``(n_ranks, n_leaves)`` matrix over the
   data group; the verdict "all rows equal" is decided on the device.
2. **Attribution** (``vote``): the strict-majority row is the truth and
   every other row's rank is corrupt; the differing columns name the
   leaves.  Two ranks have no majority: ``ShadowArbiter`` replays the held
   steps from the last clean snapshot and matches the live rows against
   the replay's digest.
3. **Containment**: the step that detects a mismatch discards its own
   update (the verdict joins the nonfinite guard's: the fused optimizer's
   ``found_inf``, the buffers' select, the schedule's count), and under
   ZeRO-1 every rank keeps its own input parameters.
4. **Eviction** (``dpp``): the corrupt rank is tombstoned in the
   rendezvous store and the gang shrinks in place, as for a worker kill;
   a later ``worker-join`` takes a new process for the member back.

``--integrity-shadow`` covers world 1: on a cadence step the step is run
again on a copy of its inputs, and two runs of one deterministic step that
disagree are a transient compute fault.

The digest columns (``digest_parts``): the parameters by the reference's
flax leaf names (``models.io.jax_leaf_pieces``; a column is the sum of its
pieces, whose element order does not change a sum), the model's floating
buffers (BatchNorm's ``batch_stats``), and under ``zero_level=0`` the
optimizer state, named torch's way (``opt_state/<key>/<leaf>``: optax's
single ``count`` has no per-parameter counterpart).  PowerSGD's
per-replica error feedback is never digested.  The state copies
(``copy_tree``) live on the state's device; ``load_tree`` puts one back
into the live state in place, so the shadow and the replay run the same
step function on the same tensors.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from distributeddataparallel_tpu_torch.models.io import jax_leaf_pieces

_MASK = 0xFFFFFFFF


# -- digests -------------------------------------------------------------


def leaf_digest(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``'s bit patterns mod 2**32, as a 0-d int64 tensor on
    ``x``'s device (the reference's uint32 digest).  Floats are viewed as
    integers of their width, never converted by value, so -0.0 and 0.0,
    and NaN payloads, stay distinct; a 16- or 8-bit pattern is widened as
    unsigned; an f64 element counts as its two 32-bit halves.  Booleans
    and integers count their value's low 32 bits (the reference's
    ``astype(uint32)``)."""
    if x.is_floating_point():
        n = x.element_size()
        if n == 4:
            s = x.view(torch.int32).sum(dtype=torch.int64)
        elif n == 2:
            s = (x.view(torch.int16).to(torch.int32) & 0xFFFF).sum(dtype=torch.int64)
        elif n == 1:
            s = x.view(torch.uint8).sum(dtype=torch.int64)
        else:
            v = x.view(torch.int64)
            s = (v & _MASK).sum() + ((v >> 32) & _MASK).sum()
    elif x.dtype == torch.bool:
        s = x.sum(dtype=torch.int64)
    else:
        s = (x.to(torch.int64) & _MASK).sum()
    return s & _MASK


def _buffer_names(model) -> dict[str, str]:
    """Port buffer name -> the reference's ``batch_stats`` path."""
    from distributeddataparallel_tpu_torch.models import io

    try:
        names = io._image_names(model)
    except (TypeError, AttributeError):
        return {}
    out = {}
    for path, pre, kind in names:
        if kind == "bn":
            out[f"{pre}.running_mean"] = f"batch_stats/{path}/mean"
            out[f"{pre}.running_var"] = f"batch_stats/{path}/var"
    return out


#: A model's parameter pieces and buffer columns, which do not change
#: between steps (ZeRO re-points a parameter's data, not the parameter).
_MODEL_COLUMNS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _model_columns(model) -> tuple[list, list]:
    if model not in _MODEL_COLUMNS:
        from distributeddataparallel_tpu_torch.training.train_step import model_buffers

        pieces = [(path, [p for p, _, _ in pcs]) for path, pcs in jax_leaf_pieces(model)]
        buffers = {id(t) for t in model_buffers(model)}
        flax = _buffer_names(model) if buffers else {}
        named = [(flax.get(n, n), t) for n, t in model.state_dict(keep_vars=True).items() if id(t) in buffers]
        _MODEL_COLUMNS[model] = (pieces, sorted(((n, [t]) for n, t in named), key=lambda c: c[0]))
    return _MODEL_COLUMNS[model]


def digest_parts(state, zero_level: int = 0) -> dict[str, list[tuple[str, list[torch.Tensor]]]]:
    """The state that must be bitwise replicated over the data ranks after
    a synced update, as ``{part: [(column name, tensors), ...]}``: the
    parameters (``params``), the model's floating buffers
    (``model_state``), and the optimizer state only at ``zero_level`` 0
    (ZeRO-1 shards it).  PowerSGD's ``comm_state`` diverges per replica by
    design and is never a part."""
    pieces, buffers = _model_columns(state.model)
    parts = {"params": pieces}
    if zero_level == 0:
        cols: dict[str, list[torch.Tensor]] = {}
        for path, params in pieces:
            for p in params:
                for key, v in sorted(state.optimizer.state.get(p, {}).items()):
                    if isinstance(v, torch.Tensor):
                        cols.setdefault(f"{key}/{path}", []).append(v)
        if cols:
            parts["opt_state"] = sorted(cols.items())
    if buffers:
        parts["model_state"] = buffers
    return {k: parts[k] for k in sorted(parts)}  # the reference's flatten order: model_state, opt_state, params


#: 32-bit words a prefix sum of ``tree_digest`` covers at most (its int64
#: buffer is 8 bytes a word); a larger column is summed on its own.
DIGEST_CHUNK = 1 << 26


def _words(t: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``t`` as 1-D int32 words whose sum mod 2**32 is ``leaf_digest(t)``,
    and whether they are a view of ``t`` (4- and 8-byte types laid out
    densely in any dimension order: a sum does not depend on the order)
    rather than a conversion computed now."""
    if t.is_contiguous():
        flat = t.view(-1)
    else:
        order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
        flat = t.permute(order).reshape(-1)
    view = flat.data_ptr() == t.data_ptr() and flat.is_contiguous() and t.numel() > 0
    n = t.element_size()
    if n == 4:
        return (flat if t.dtype == torch.int32 else flat.view(torch.int32)), view
    if n == 8:
        # An f64 element: both halves; an int64: its low word (little-endian).
        words = flat.view(torch.int32)
        return (words if t.is_floating_point() else words[0::2]), view
    if t.is_floating_point() and n == 2:
        return flat.view(torch.int16).to(torch.int32) & 0xFFFF, False
    if t.is_floating_point():
        return flat.view(torch.uint8).to(torch.int32), False
    return flat.to(torch.int32), False


class _DigestPlan:
    """How ``tree_digest`` sums a fixed set of columns: their words in
    chunks of at most ``DIGEST_CHUNK`` (views made once where the words are
    views of the state's own tensors), each chunk's column ends and places
    on the device; a larger column on its own."""

    def __init__(self, cols: list[list[torch.Tensor]]):
        self.tensors = [t for ts in cols for t in ts]  # held: a plan is only reused for these objects
        self.n = len(cols)
        self.device = cols[0][0].device
        self.chunks: list[tuple[list, torch.Tensor, torch.Tensor]] = []
        self.big: list[tuple[int, list]] = []
        words: list = []
        where: list[int] = []
        ends: list[int] = []

        def flush():
            if words:
                self.chunks.append((list(words), torch.as_tensor(ends, device=self.device) - 1,
                                    torch.as_tensor(where, device=self.device)))
            words.clear(), where.clear(), ends.clear()

        for j, tensors in enumerate(cols):
            n = sum(t.numel() for t in tensors)
            if n == 0:
                continue
            mine = []
            for t in tensors:
                w, view = _words(t)
                mine.append(w if view else t)
            if n > DIGEST_CHUNK:
                self.big.append((j, mine))
                continue
            if ends and ends[-1] + n > DIGEST_CHUNK:
                flush()
            words.extend(mine)
            where.append(j)
            ends.append((ends[-1] if ends else 0) + n)
        flush()

    def matches(self, cols: list[list[torch.Tensor]]) -> bool:
        flat = [t for ts in cols for t in ts]
        return len(flat) == len(self.tensors) and all(a is b for a, b in zip(flat, self.tensors))

    @staticmethod
    def _now(items: list) -> list:
        # A cached view is int32 words already; a tensor held is converted now.
        return [w if w.dtype == torch.int32 and w.dim() == 1 and w.is_contiguous() else _words(w)[0]
                for w in items]

    def run(self) -> torch.Tensor:
        out = torch.zeros(self.n, dtype=torch.int64, device=self.device)
        for items, ends, where in self.chunks:
            cs = torch.cumsum(torch.cat(self._now(items)), 0, dtype=torch.int64)
            at = cs[ends]
            out[where] = at - torch.nn.functional.pad(at[:-1], (1, 0))
        for j, items in self.big:
            out[j] = sum(w.sum(dtype=torch.int64) for w in self._now(items))
        return out & _MASK


def _columns(parts: dict) -> list[list[torch.Tensor]]:
    return [tensors for c in parts.values() for _, tensors in c]


def tree_digest(parts: dict) -> torch.Tensor:
    """``(n_leaves,)`` int64 digests, one a column of ``digest_parts``, in
    the order of ``digest_leaf_names``: each ``leaf_digest``'s sum, taken
    for many columns at once (their words concatenated, one int64 prefix
    sum, the differences at the columns' ends), so the device work is a few
    launches, not a few a column."""
    return _DigestPlan(_columns(parts)).run()


def digest_leaf_names(parts: dict) -> list[str]:
    """The digest vector's column names: ``part/leaf path``."""
    return [f"{part}/{name}" for part, cols in parts.items() for name, _ in cols]


def make_digest_fn(group=None, zero_level: int = 0) -> Callable:
    """``fn(state) -> (n_ranks, n_leaves)`` int64 digest matrix on the
    state's device: this rank's digest row all-gathered over ``group`` (the
    data group; None: the world).  The same fingerprint the train step
    takes, for the checks that run outside it (the shadow, the replay)."""
    plan: list = []  # the last call's plan, reused while the state's tensors are the same objects

    def digest(state) -> torch.Tensor:
        cols = _columns(digest_parts(state, zero_level))
        if not plan or not plan[0].matches(cols):
            plan[:] = [_DigestPlan(cols)]
        row = plan[0].run()
        if not dist.is_initialized():
            return row.reshape(1, -1)
        n = dist.get_world_size(group)
        out = torch.empty(n * row.numel(), dtype=row.dtype, device=row.device)
        dist.all_gather_into_tensor(out, row, group=group)
        return out.reshape(n, -1)

    return digest


# -- state copies --------------------------------------------------------


@dataclasses.dataclass
class StateCopy:
    """A device-side copy of a ``TrainState``'s values (``copy_tree``):
    the model's parameters and buffers by name, the optimizer's state by
    parameter index, the schedule's count, the step, and PowerSGD's and
    the low-bit moments' state."""
    model: dict
    optimizer: dict
    schedule: object
    step: int
    comm_state: object = None
    moments: object = None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in _tensors(
            [self.model, self.optimizer, self.schedule, self.comm_state, self.moments]))


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _clone(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _clone(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def _opt_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def _schedule(state):
    from distributeddataparallel_tpu_torch.training.optim import DeviceSchedule

    s = state.scheduler
    if s is None:
        return None
    if isinstance(s, DeviceSchedule):
        return s.count.clone()
    return (s.state_dict(), [g["lr"] for g in state.optimizer.param_groups])


def _copies(tensors: list) -> list:
    """Device copies of ``tensors`` (their layouts kept), in a few batched
    launches."""
    with torch.no_grad():
        out = [torch.empty_like(t) for t in tensors]
        if out:
            torch._foreach_copy_(out, [t.detach() for t in tensors])
    return out


def copy_tree(state) -> StateCopy:
    """An independent copy of ``state``'s values on its device (ZeRO levels
    0 and 1: a level-1 parameter is a view into the flat vector, copied by
    value).  A replica's own bits are copied, so a divergent replica stays
    divergent in its copy."""
    if state.zero is not None and state.zero.level > 1 or state.fsdp is not None:
        raise ValueError("copy_tree supports replicated DP and ZeRO-1 (the integrity layouts)")
    sd = state.model.state_dict()
    opt = [(i, state.optimizer.state[p]) for i, p in enumerate(_opt_params(state.optimizer))
           if p in state.optimizer.state]
    slots = [(i, k) for i, st in opt for k, v in st.items() if isinstance(v, torch.Tensor)]
    copies = iter(_copies(list(sd.values()) + [st[k] for (i, st) in opt for k, v in st.items()
                                               if isinstance(v, torch.Tensor)]))
    model = {k: next(copies) for k in sd}
    optimizer = {i: {k: v for k, v in st.items()} for i, st in opt}
    for i, k in slots:
        optimizer[i][k] = next(copies)
    return StateCopy(
        model=model, optimizer=optimizer, schedule=_schedule(state), step=state.step,
        comm_state=_clone(state.comm_state),
        moments=None if state.moments is None else (_clone(state.moments.packed),
                                                     state.moments.generator.get_state()),
    )


@torch.no_grad()
def load_tree(state, snap: StateCopy) -> None:
    """Put ``snap`` back into ``state`` in place: the model's and the
    optimizer's tensors by batched copies (views stay views; an optimizer
    entry the snapshot lacks is dropped, one it has alone is cloned in),
    the schedule's count, the step, and the hook and moment state as copies
    of the snapshot's (it stays reusable)."""
    from distributeddataparallel_tpu_torch.training.optim import DeviceSchedule

    live = state.model.state_dict()
    dst, src = [live[k] for k in snap.model], list(snap.model.values())
    for i, p in enumerate(_opt_params(state.optimizer)):
        saved, cur = snap.optimizer.get(i), state.optimizer.state.get(p)
        if saved is None:
            state.optimizer.state.pop(p, None)
        elif cur is None or cur.keys() != saved.keys():
            state.optimizer.state[p] = _clone(saved)
        else:
            for k, v in saved.items():
                if isinstance(v, torch.Tensor):
                    dst.append(cur[k])
                    src.append(v)
                else:
                    cur[k] = v
    if dst:
        torch._foreach_copy_(dst, src)
    s = state.scheduler
    if isinstance(s, DeviceSchedule):
        s.count.copy_(snap.schedule)
        s._link()
    elif s is not None:
        sd, lrs = snap.schedule
        s.load_state_dict(sd)
        for g, lr in zip(state.optimizer.param_groups, lrs):
            g["lr"] = lr
    state.step = snap.step
    state.comm_state = _clone(snap.comm_state)
    if snap.moments is not None:
        state.moments.packed = _clone(snap.moments[0])
        state.moments.generator.set_state(snap.moments[1])


# -- fault injection (chaos `bitflip` backend) ---------------------------


def _data_rank(group=None) -> tuple[int, int]:
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


@torch.no_grad()
def apply_bitflip(state, *, rank: int, leaf: str | None = None, bit: int = 1, group=None,
                  copy: StateCopy | None = None):
    """XOR bit ``bit`` of element 0 of one parameter leaf of ``state`` on
    data rank ``rank``'s process only (the single-event upset in device
    memory); with ``copy`` (a ``copy_tree`` of ``state``) the bit flips in
    the copy instead.  Returns ``state``.

    ``leaf`` selects the first leaf whose reference name contains it (None:
    the first leaf), as the reference's; element 0 of a leaf in the
    reference's order is element 0 of its first piece in every layout.
    ``bit`` defaults to a low mantissa bit, so the value stays finite and
    the nonfinite guard cannot see it."""
    pieces = jax_leaf_pieces(state.model)
    names = [path for path, _ in pieces]
    if leaf is None:
        target = 0
    else:
        matches = [i for i, n in enumerate(names) if leaf in n]
        if not matches:
            raise ValueError(f"bitflip: no param leaf matching {leaf!r} (leaves: {names})")
        target = matches[0]
    me, n_ranks = _data_rank(group)
    if not 0 <= rank < n_ranks:
        raise ValueError(f"bitflip: rank {rank} out of range for {n_ranks}-way 'data' axis")
    p = pieces[target][1][0][0]
    if not p.is_floating_point():
        raise ValueError(f"bitflip targets float leaves; {names[target]!r} is {p.dtype}")
    if me != rank:
        return state
    if copy is not None:
        x = copy.model[{id(v): k for k, v in state.model.named_parameters()}[id(p)]]
    else:
        x = p.data
    n = x.element_size()
    itype = {4: torch.int32, 2: torch.int16, 1: torch.uint8, 8: torch.int64}[n]
    mask = 1 << (bit % (8 * min(n, 4)))
    if itype is not torch.uint8 and mask >= 1 << (8 * n - 1):
        mask -= 1 << (8 * n)  # the sign bit, as the signed integer of that width
    x[(0,) * x.ndim].view(itype).bitwise_xor_(mask)
    return state


# -- attribution ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SdcVerdict:
    """Outcome of one on-cadence integrity check."""

    ok: bool
    corrupt: tuple[int, ...] = ()   # rank indices voted out
    leaves: tuple[str, ...] = ()    # digest columns that disagreed
    tie: bool = False               # no strict majority (unresolved)
    method: str = "vote"            # "vote" | "replay" | "shadow"


def vote(matrix: np.ndarray, leaf_names: Sequence[str] | None = None) -> SdcVerdict:
    """Majority-vote attribution over a ``(n_ranks, n_leaves)`` digest
    matrix.  The strict-majority row is the truth; every other row's rank
    is corrupt.  No strict majority (the 2-rank split, or 3+ ranks all
    disagreeing) gives ``tie=True`` and the caller escalates to the replay
    tiebreak."""
    rows = [tuple(int(v) for v in r) for r in np.asarray(matrix)]
    ref, count = Counter(rows).most_common(1)[0]
    if count == len(rows):
        return SdcVerdict(ok=True)
    if 2 * count <= len(rows):
        return SdcVerdict(ok=False, tie=True)
    corrupt = tuple(i for i, r in enumerate(rows) if r != ref)
    bad_cols = sorted({j for i in corrupt for j in range(len(ref)) if rows[i][j] != ref[j]})
    leaves = tuple(leaf_names[j] if leaf_names else str(j) for j in bad_cols)
    return SdcVerdict(ok=False, corrupt=corrupt, leaves=leaves)


def replay_digest(state, snap: StateCopy, steps, step_fn, digest_fn) -> torch.Tensor:
    """Run ``steps`` (``(batch, seed)`` pairs) from ``snap`` in ``state``'s
    own tensors and return ``digest_fn`` of the result; ``state``'s live
    values are copied aside and put back after (the shadow re-run and the
    arbiter's replay)."""
    live = copy_tree(state)
    try:
        load_tree(state, snap)
        for batch, seed in steps:
            step_fn(state, batch, seed)
        return digest_fn(state)
    finally:
        load_tree(state, live)


class ShadowArbiter:
    """The 2-rank (no-majority) tiebreak: the digest recomputed by REPLAY.

    At every clean cadence check the loop commits a copy of that step's
    input state (the replicas agreed on it) and then holds the ``(batch,
    seed)`` of every step it runs.  On a tied mismatch the held steps are
    replayed from the snapshot in the live state's tensors (the live values
    are copied aside and put back after), the flip being a one-time event,
    and each live row is matched against the replay's digest: the rank
    that matches is healthy.  Both ranks resolve together (the tie is seen
    by both), so the replay's collectives pair up."""

    def __init__(self, step_fn, digest_fn):
        self._step_fn = step_fn
        self._digest_fn = digest_fn
        self._snapshot: StateCopy | None = None
        self._state = None
        self._held: list[tuple[dict, object]] = []

    def commit(self, snapshot: StateCopy, state=None) -> None:
        """Adopt ``snapshot`` (a ``copy_tree`` of a verified-clean step
        input of ``state``) as the new replay base; forget the held steps
        before it."""
        self._snapshot = snapshot
        if state is not None:
            self._state = state
        self._held = []

    def hold(self, batch, seed) -> None:
        """Record one consumed ``(batch, seed)`` for a possible replay."""
        self._held.append((batch, seed))

    def resolve(self, live_matrix: np.ndarray) -> SdcVerdict:
        """Replay the held steps from the snapshot and name the corrupt rank."""
        if self._snapshot is None or self._state is None:
            return SdcVerdict(ok=False, tie=True, method="replay")
        ref = replay_digest(self._state, self._snapshot, self._held, self._step_fn, self._digest_fn).cpu().numpy()
        if not (ref == ref[0:1]).all():
            # The replay itself diverged: a persistent fault, which the
            # replay cannot arbitrate; the tie stays open.
            return SdcVerdict(ok=False, tie=True, method="replay")
        live = np.asarray(live_matrix)
        corrupt = tuple(i for i in range(live.shape[0]) if not (live[i] == ref[0]).all())
        if not corrupt or len(corrupt) == live.shape[0]:
            return SdcVerdict(ok=False, tie=True, method="replay")
        bad_cols = sorted({int(j) for i in corrupt for j in np.nonzero(live[i] != ref[0])[0]})
        return SdcVerdict(ok=False, corrupt=corrupt, leaves=tuple(str(j) for j in bad_cols), method="replay")


# -- host orchestration --------------------------------------------------


class IntegrityChecker:
    """The host side of the detect -> attribute loop (the reference's):
    the vote, the optional replay arbiter and the telemetry (events and
    counters), so the train loop only asks who is corrupt.  Eviction stays
    with the caller (it needs the gang) and is reported back through
    ``note_eviction``."""

    def __init__(self, *, every: int, leaf_names: Sequence[str] = (), events=None, counters=None,
                 arbiter=None):
        if every < 1:
            raise ValueError(f"integrity cadence must be >= 1, got {every}")
        self.every = every
        self.leaf_names = list(leaf_names)
        self.events = events
        self.counters = counters
        self.arbiter = arbiter

    def due(self, state_step: int) -> bool:
        """The step's own cadence gate, ``state.step % every == 0``, on the
        host's step count."""
        return state_step % self.every == 0

    def check(self, matrix: np.ndarray, *, step: int) -> SdcVerdict:
        """Vote on one cadence digest matrix; escalate a tie to the replay
        arbiter; emit ``sdc_check`` / ``sdc_detect``."""
        if self.counters is not None:
            self.counters.sdc_checks += 1
        verdict = vote(matrix, self.leaf_names)
        if verdict.tie and self.arbiter is not None:
            verdict = self.arbiter.resolve(matrix)
        if self.events is not None:
            self.events.emit("sdc_check", step=step, ok=verdict.ok)
        if not verdict.ok:
            if self.counters is not None:
                self.counters.sdc_detects += 1
            if self.events is not None:
                self.events.emit("sdc_detect", step=step, rank=(verdict.corrupt[0] if verdict.corrupt else -1),
                                 ranks=list(verdict.corrupt), leaves=list(verdict.leaves),
                                 method=verdict.method, tie=verdict.tie)
        return verdict

    def note_shadow_mismatch(self, *, step: int) -> None:
        """A transient fault caught by ``--integrity-shadow``'s second run:
        no rank to attribute (rank -1), no eviction."""
        if self.counters is not None:
            self.counters.sdc_detects += 1
        if self.events is not None:
            self.events.emit("sdc_detect", step=step, rank=-1, ranks=[], leaves=[], method="shadow", tie=False)

    def note_eviction(self, rank: int, *, step: int) -> None:
        if self.counters is not None:
            self.counters.sdc_evictions += 1
        if self.events is not None:
            self.events.emit("sdc_evict", step=step, rank=rank)
