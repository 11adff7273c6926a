"""Elastic gang runtime: resize the gang instead of restarting it.

Counterpart of ``distributeddataparallel_tpu/runtime/elastic_gang.py`` in
its one-member-per-process mode (``elastic_gang.py:20-27``): each trainer
process is one member, ``proc{rank}``.

1. membership drift (a death, a chaos ``worker-kill``) is observed in the
   rendezvous store (``runtime.rendezvous``): heartbeats and tombstones;
2. the survivors run one membership-epoch transition (``poll``): a
   barrier, the epoch-(k+1) roster written by the smallest survivor; a
   member that was tombstoned at a step boundary and is still running
   waits for that record instead (``leaving`` / ``await_departure``);
3. the live ZeRO-1 state is resharded over the OLD group, the leaving
   member included (``reshard_live_state``: a host round trip of the
   flats through ``training.elastic.repad_flat``, no checkpoint read),
   then the process group is re-formed over the survivors
   (``runtime.distributed.rebuild_process_group``), and the leaving
   member exits 0;
4. the data is re-dealt deterministically (``data.sharded.
   resize_index_plan``, the loader's ``index_shards``).

The grow (a chaos ``worker-join``, an evicted member repaired): ``rejoin``
writes a join request into the store, the launcher starts a new process
for the member, which joins the store and takes part in the next
transition (``poll``) while the survivors wait for it at the boundary
(``await_members``).  The survivors reshard the ZeRO-1 flats over the OLD
group as for a shrink, the group is re-formed with the joiner in it
(``runtime.distributed.rebuild_process_group`` on the survivors,
``enter_process_group`` on the joiner), and one healthy survivor sends the
joiner its re-padded chunk, the scalars, the parameter groups, the
replicated parameters, the schedule and the loader's position
(``send_live_state`` / ``recv_live_state``).  A gang's rank order is its
members' indices (``member_index``), so a member that comes back takes its
old place.

``state_template_for`` / ``batch_template_for`` serve the reference's
background pre-compile of XLA executables and have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from distributeddataparallel_tpu_torch.runtime.rendezvous import (
    RendezvousFencedError,
    RendezvousStore,
)


@dataclasses.dataclass(frozen=True)
class ResizeDecision:
    """One agreed membership-epoch transition, as seen by a survivor."""

    epoch: int
    roster: tuple[str, ...]
    prev_roster: tuple[str, ...]
    left: tuple[str, ...]
    joined: tuple[str, ...]

    @property
    def old_size(self) -> int:
        return len(self.prev_roster)

    @property
    def new_size(self) -> int:
        return len(self.roster)


class ElasticGangCoordinator:
    """Membership-epoch coordinator for one process's gang members.

    ``world`` is the list of member names THIS process hosts: one name
    per process in the port's trainer (``proc{rank}``), several when one
    process hosts a whole simulated gang (the tests).  ``poll()`` is the step-
    boundary hook — cheap (a few ``os.stat`` calls) when membership is
    stable, and when it has drifted it runs the epoch transition and
    returns the :class:`ResizeDecision` every survivor agrees on.
    """

    def __init__(
        self,
        store: RendezvousStore | str,
        *,
        world: Sequence[str | int],
        min_size: int = 1,
        events=None,
        transition_timeout_s: float = 30.0,
        heartbeat_timeout_s: float | None = None,
        suspect_after_s: float | None = None,
    ):
        if isinstance(store, (str, bytes)):
            kw = {}
            if heartbeat_timeout_s is not None:
                kw["heartbeat_timeout_s"] = float(heartbeat_timeout_s)
            if suspect_after_s is not None:
                kw["suspect_after_s"] = float(suspect_after_s)
            store = RendezvousStore(store, **kw)
        self.store = store
        self.world = [str(w) for w in world]
        if not self.world:
            raise ValueError("world must name at least one hosted member")
        self.min_size = int(min_size)
        self.events = events
        self.transition_timeout_s = float(transition_timeout_s)
        self.epoch = -1
        self.roster: tuple[str, ...] = ()
        #: members currently in the suspect window, refreshed every poll
        self.suspects_now: tuple[str, ...] = ()
        self._suspected: set[str] = set()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> dict:
        """Join all hosted members and establish the membership epoch.

        No epoch in the store → propose epoch 0 over the live set.  An
        existing epoch whose roster no longer matches the live set is a
        resized respawn (the supervisor tombstoned the dead gang's whole
        roster before relaunching at the surviving size — see
        ``launcher.spawn(elastic_store=...)``): propose the next epoch
        over the members that actually came back, so epochs stay
        monotonic across the respawn.

        Race-tolerant for the one-member-per-process topology: N
        processes start concurrently and every one of them runs this,
        so the epoch-0 proposal can lose the store's epoch fence to a
        peer's — a fenced loser re-reads and adopts the winner.

        On a LIVE epoch the move depends on who disagrees with its
        roster.  A live member OUTSIDE the roster (a late joiner —
        possibly this process) means incumbents may be mid-run: adopt
        as-is and let ``poll()`` run the barriered transition on the
        first step, with every survivor acking — proposing here would
        skip the ack barrier and strand the incumbents in a transition
        we never participate in.  A roster with only GHOSTS missing
        (every live member inside it — a respawned gang over a stale
        store, where every live member is starting right here) is
        re-proposed over the live set directly, so the respawn doesn't
        burn a poll-time resize on members that died with the old
        incarnation.
        """
        for m in self.world:
            self.store.join(m)
        deadline = time.monotonic() + self.transition_timeout_s
        while True:
            rec = self.store.epoch()
            alive = self.store.alive()
            if rec["epoch"] >= 0:
                roster = set(rec["roster"])
                if set(alive) == roster or not set(alive) <= roster:
                    break  # matching, or a joiner: poll() converges it
            try:
                if rec["epoch"] < 0:
                    rec = self.store.propose(alive, epoch=0)
                else:
                    rec = self.store.propose(alive)
                self._emit_epoch(rec)
                break
            except RendezvousFencedError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.02)
        self.epoch = rec["epoch"]
        self.roster = tuple(rec["roster"])
        return rec

    def stop(self) -> None:
        for m in self._hosted_live():
            self.store.leave(m)

    def kill(self, member: str | int) -> None:
        """Mark one member dead (the chaos ``worker-kill`` hook): the
        NEXT ``poll()`` on any survivor sees the tombstone and runs the
        resize protocol.  A bare integer is a rank index into this
        process's hosted world (the chaos grammar's ``:RANK`` argument);
        a string names the member directly."""
        member = str(member)
        if member not in self.world and member.isdigit() \
                and int(member) < len(self.world):
            member = self.world[int(member)]
        self.store.mark_dead(member)

    def rejoin(self, member: str | int) -> None:
        """Ask for a previously-killed member back (the chaos ``worker-join``
        hook / a repaired process): one process per member here, so the
        member returns as a new process, which the launcher watching the
        store starts on this request; its joining the store makes the next
        ``poll()`` see a larger live set and resize up."""
        member = str(member)
        if member not in self.world and member.isdigit() \
                and int(member) < len(self.world):
            member = self.world[int(member)]
        self.store.request_join(member)

    def await_members(self, members, timeout_s: float | None = None, poll_s: float = 0.02) -> None:
        """Wait, beating this process's heartbeats, until every member of
        ``members`` is alive in the store (a joiner has started and joined);
        bounded by the heartbeat timeout.  A joiner that does not come is an
        error, not a silent restart."""
        timeout_s = self.store.heartbeat_timeout_s if timeout_s is None else timeout_s
        deadline = time.monotonic() + timeout_s
        while not set(members) <= set(self.store.alive()):
            for m in self._hosted_live():
                self.store.heartbeat(m)
            if time.monotonic() >= deadline:
                raise RuntimeError(f"elastic join: {sorted(set(members) - set(self.store.alive()))} did not "
                                   f"join the gang's store within {timeout_s:.0f}s")
            time.sleep(poll_s)

    def _hosted_live(self) -> list[str]:
        dead = set(self.store.dead())
        return [m for m in self.world if m not in dead]

    # -- the step-boundary hook -----------------------------------------

    def poll(self) -> ResizeDecision | None:
        """Heartbeat, then detect and agree on membership drift.

        Returns None while membership matches the current epoch's roster.
        On drift: every hosted surviving member acks the next epoch, the
        transition runs (this process proposes iff it hosts the smallest
        survivor), and the agreed decision is returned — the caller then
        rebuilds mesh/state/data for ``decision.new_size``.
        """
        hosted = self._hosted_live()
        for m in hosted:
            self.store.heartbeat(m)
        if not hosted:
            raise RuntimeError(
                "every member hosted by this process is dead — nothing "
                "left to resize around (supervised restart territory)"
            )
        self._watch_suspects()
        # Failure detector: a member whose heartbeat aged past the full
        # timeout without any tombstone is a host that died (or was
        # partitioned away) without anyone observing it — promote the
        # expiry to a tombstone so the transition below doesn't wait on a
        # ghost.  The suspect window above already flagged it loudly.
        for m in self.store.expired():
            self.store.mark_dead(m)
        alive = self.store.alive()
        if set(alive) == set(self.roster):
            return None
        if len(alive) < self.min_size:
            raise RuntimeError(
                f"surviving roster {alive} is below --min-procs "
                f"{self.min_size}; falling back to gang restart"
            )
        rec = None
        for attempt in (0, 1):
            hosted = self._hosted_live()
            if not hosted:
                raise RuntimeError(
                    "every member hosted by this process was lost during "
                    "the epoch transition"
                )
            nxt = self.store.epoch()["epoch"] + 1
            for m in hosted:
                self.store.ack(nxt, m)
            try:
                rec = self.store.transition(
                    hosted[0], timeout_s=self.transition_timeout_s
                )
                break
            except RuntimeError:
                # hosted[0] was tombstoned mid-transition (proposer
                # kill): retry once as the next surviving hosted member.
                # A second loss means the gang is shedding faster than it
                # agrees — surface it.
                if attempt:
                    raise
        if rec is None:
            raise RuntimeError(
                "epoch transition returned nothing — store unreachable "
                "(partitioned?)"
            )
        decision = self._decide(rec)
        self._emit_epoch(rec)
        if self.events is not None:
            self.events.emit(
                "gang_resize",
                epoch=decision.epoch,
                old_size=decision.old_size,
                new_size=decision.new_size,
                left=list(decision.left),
                joined=list(decision.joined),
            )
        return decision

    def _decide(self, rec: dict) -> ResizeDecision:
        """Adopt the agreed epoch record ``rec`` and return its decision."""
        prev = self.roster or tuple(rec.get("prev_roster", ()))
        decision = ResizeDecision(
            epoch=rec["epoch"],
            roster=tuple(rec["roster"]),
            prev_roster=tuple(prev),
            left=tuple(m for m in prev if m not in set(rec["roster"])),
            joined=tuple(m for m in rec["roster"] if m not in set(prev)),
        )
        self.epoch = decision.epoch
        self.roster = decision.roster
        return decision

    # -- one member per process: the member that leaves ------------------

    def leaving(self) -> bool:
        """Is every member this process hosts tombstoned?  In the
        one-member-per-process gang a chaos ``worker-kill`` tombstones a
        member at a step boundary, and that member's process is still
        running: it takes part in the resize's collectives and then
        leaves, instead of polling."""
        return not self._hosted_live()

    def await_departure(self, poll_s: float = 0.02) -> ResizeDecision:
        """The leaving member's view of the transition its survivors run
        (``poll`` on each of them): wait for the next epoch record and
        return the decision they agree on."""
        deadline = time.monotonic() + self.transition_timeout_s
        while True:
            rec = self.store.epoch()
            if rec["epoch"] > self.epoch:
                return self._decide(rec)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"epoch {self.epoch + 1} was never agreed by the "
                    f"survivors of {list(self.world)}"
                )
            time.sleep(poll_s)

    def _watch_suspects(self) -> None:
        """Surface the heartbeat-hysteresis window: a member whose beat
        is old-but-unexpired is flagged ONCE per suspicion (straggler
        event + alert upstream) and cleared when its beat refreshes —
        loud before the timeout tombstones it, silent while healthy."""
        ages = None
        sus = self.store.suspects()
        self.suspects_now = tuple(sus)
        for m in sus:
            if m in self._suspected:
                continue
            self._suspected.add(m)
            if self.events is not None:
                if ages is None:
                    ages = self.store.heartbeat_ages()
                self.events.emit(
                    "gang_suspect",
                    member=m,
                    age_s=round(float(ages.get(m, -1.0)), 3),
                    epoch=self.epoch,
                )
        self._suspected &= set(sus)

    def _emit_epoch(self, rec: dict) -> None:
        if self.events is not None:
            self.events.emit(
                "membership_epoch",
                epoch=rec["epoch"],
                roster=list(rec["roster"]),
                size=len(rec["roster"]),
            )


# -- in-memory (checkpoint-free) state reshard ---------------------------


def member_index(member: str) -> int:
    """``proc{r}`` -> r: a gang's rank order (the start's ranks; a member
    that comes back takes its old place)."""
    return int(str(member).removeprefix("proc"))


def reshard_live_state(state, new_rank: int | None, new_world: int, extra_ranks=()) -> dict | None:
    """Checkpoint-free reshard of a live ZeRO-1 state to ``new_world``
    data ranks: a collective over the current (old) group, which every old
    member joins, the leaving ones too.  Each per-element optimizer state
    (the concatenation of this rank's pieces) is all-gathered over the data
    group, brought to the host, truncated to its true content and re-padded
    for the new world (``training.elastic.repad_flat``), and ``new_rank``'s
    chunk is cut from it: the same math ``elastic_restore`` applies to a
    checkpoint, so the two routes agree bit for bit.  Returns, on the host,
    ``{"flats": {key: chunk}, "scalars": {key: value}, "param_groups":
    [...]}`` for a survivor, None for a leaving member (``new_rank`` None)
    and for a state with no sharded optimizer state (plain DP: every rank
    keeps its whole copy).  In a grow the survivor that sends the joiners
    their state passes their new ranks as ``extra_ranks`` and gets their
    chunks too (``"extra": {rank: {key: chunk}}``).  Supported layouts match
    the ``--elastic`` gate: plain DP and ZeRO-1 over the data axis (no model
    axes, no low-bit moments)."""
    import torch
    import torch.distributed as dist

    from distributeddataparallel_tpu_torch.parallel.zero import flat_size
    from distributeddataparallel_tpu_torch.training.elastic import repad_flat
    from distributeddataparallel_tpu_torch.training.optim import optimizer_state_dict

    layout = state.zero
    if layout is None:
        return None
    if layout.level != 1 or layout.dup is not None or state.moments is not None:
        raise ValueError(
            f"reshard_live_state supports replicated DP and ZeRO-1 over the data axis "
            f"(got zero={layout.level}); ZeRO-2/3 resident shards go through elastic_restore"
        )
    true = sum(layout.sizes)
    padded_new, chunk = flat_size(layout.sizes, new_world)
    first = state.optimizer.state.get(layout.shard_params[0], {})
    flats, scalars, extra = {}, {}, {r: {} for r in extra_ranks}
    for key, v in sorted(first.items()):
        if v.dim() == 0:
            scalars[key] = v.detach().cpu().clone()
            continue
        local = torch.cat([state.optimizer.state[p][key] for p in layout.shard_params])
        full = torch.empty(local.numel() * layout.world, dtype=local.dtype, device=local.device)
        if dist.is_initialized():
            dist.all_gather_into_tensor(full, local.contiguous(), group=layout.group)
        else:
            full.copy_(local)
        if new_rank is not None:
            new = repad_flat(full.cpu(), true, padded_new)
            flats[key] = new[new_rank * chunk : (new_rank + 1) * chunk].clone()
            for r in extra_ranks:
                extra[r][key] = new[r * chunk : (r + 1) * chunk].clone()
    if new_rank is None:
        return None
    groups = optimizer_state_dict(state.optimizer)["param_groups"]
    return {"flats": flats, "scalars": scalars, "param_groups": groups, "extra": extra}


# -- the grow: live state to a joiner -------------------------------------


_TENSOR = "__tensor__"


def _strip(obj, tensors: list):
    """``obj`` with every tensor replaced by ``(_TENSOR, its place in
    tensors)``, the tensor appended there."""
    import torch

    if isinstance(obj, torch.Tensor):
        tensors.append(obj.detach())
        return (_TENSOR, len(tensors) - 1)
    if isinstance(obj, dict):
        return {k: _strip(v, tensors) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strip(v, tensors) for v in obj]
    return obj


def _fill(obj, tensors: list):
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _TENSOR:
        return tensors[obj[1]]
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_fill(v, tensors) for v in obj]
    return obj


def send_live_state(payload: dict, dst: int, device) -> int:
    """Send ``payload`` (nested dicts and lists of tensors and plain values:
    the live state a joiner needs) to rank ``dst`` of the current group:
    its structure and the tensors' shapes and dtypes as one object, every
    tensor's bytes as one flat buffer on ``device``.  Returns the bytes
    sent."""
    import torch
    import torch.distributed as dist

    tensors: list = []
    meta = _strip(payload, tensors)
    specs = [(tuple(t.shape), str(t.dtype).removeprefix("torch.")) for t in tensors]
    flat = (torch.cat([t.reshape(-1).contiguous().view(torch.uint8).to(device) for t in tensors])
            if tensors else torch.empty(0, dtype=torch.uint8, device=device))
    dist.send_object_list([meta, specs, flat.numel()], dst=dst, device=device)
    if flat.numel():
        dist.send(flat, dst=dst)
    return flat.numel()


def recv_live_state(src: int, device) -> tuple[dict, int]:
    """The ``payload`` rank ``src`` sends with ``send_live_state``, its
    tensors on ``device``, and its tensors' bytes."""
    import math

    import torch
    import torch.distributed as dist

    got = [None, None, None]
    dist.recv_object_list(got, src=src, device=device)
    meta, specs, nbytes = got
    flat = torch.empty(nbytes, dtype=torch.uint8, device=device)
    if nbytes:
        dist.recv(flat, src=src)
    tensors, o = [], 0
    for shape, dtype in specs:
        dt = getattr(torch, dtype)
        n = math.prod(shape) * dt.itemsize
        tensors.append(flat[o : o + n].clone().view(dt).reshape(shape))
        o += n
    return _fill(meta, tensors), nbytes


def measure_downtime(t_start: float) -> float:
    """Seconds since ``t_start`` (perf_counter domain) — the number that
    lands in the ``resize_downtime`` event and the goodput ``resize``
    bucket."""
    return time.perf_counter() - t_start
