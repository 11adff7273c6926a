"""File/TCP rendezvous with membership epochs for the elastic gang runtime.

The port's copy of the JAX package's ``runtime/rendezvous.py`` (stdlib
only, so it runs unchanged): ``RetryPolicy`` / ``retry_call`` come from
the port's ``runtime/retry.py`` and ``elect_rehost`` delegates to the
port's ``analysis.protocol.elect_rehost_owner``.

The store is the gang's source of truth about *who is in the gang*: every
member maintains a heartbeat file, deliberate departures (clean leave,
chaos kill, supervisor-observed death) leave a tombstone, and the agreed
roster lives in a versioned ``epoch.json`` — membership epoch k is the
k-th roster the gang has ever agreed on.  A resize is exactly one epoch
transition: survivors observe the drift, barrier on the new epoch number,
one deterministic proposer (the lexicographically-smallest survivor)
writes the epoch-(k+1) roster atomically, and everyone else waits for the
file to advance.  There is no leader state to lose — any survivor can
propose, and ``os.replace`` makes the last write win atomically.

Two transports share the protocol:

- ``RendezvousStore`` — a directory on a filesystem every member can see
  (the single-host / NFS case).  All mutations are tmp-write + atomic
  rename; reads tolerate concurrent writers.
- ``TCPRendezvousServer`` / ``TCPRendezvousClient`` — a thin JSON-lines
  socket front-end over one server-side ``RendezvousStore``, for gangs
  whose members don't share a filesystem.  One request per line, one
  JSON reply per line; the op names mirror the store methods.

The multi-host hardening layer treats the store itself as a
component that fails:

- every client RPC runs under :class:`RetryPolicy` — bounded retries
  with exponential backoff and jitter, reconnecting (and re-resolving
  the address through an :class:`AddressBook`) between attempts, so a
  connection reset during a server re-host is a delay, not a crash;
- when the TCP server dies, the deterministic smallest-name survivor
  re-hosts it (:func:`rehost_store`): the epoch log is replayed from the
  survivor's client-side epoch cache and the new server is published
  with a bumped *generation* — every reply carries the generation, and
  a client that has seen generation g treats any reply from a lower
  generation as a stale, fenced-off server (reconnect, don't obey);
- ``propose`` fences epoch regression (:class:`RendezvousFencedError`):
  a resurrected stale server (or a partitioned proposer) cannot move
  membership history backwards — first write per epoch wins;
- heartbeat hysteresis: a member whose beat is old-but-not-expired is
  ``suspect`` (:meth:`RendezvousStore.suspects`) — flagged loudly
  (straggler event + alert upstream) before anyone tombstones it.

Module-import rule: stdlib only.  The launcher supervisor and the chaos
injector import this in fresh interpreters; torch must not load here.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
import uuid

from distributeddataparallel_tpu_torch.runtime.retry import RETRYABLE_ERRORS, RetryPolicy, retry_call  # noqa: F401

# A heartbeat older than this many seconds marks its member dead; the
# coordinator treats expired members like tombstoned members when
# computing the next roster.  Generous by default — CPU-simulation steps
# are slow.
DEFAULT_HEARTBEAT_TIMEOUT_S = 60.0

#: Fraction of the heartbeat timeout after which a member is *suspect*:
#: still in ``alive()`` (no membership change yet) but surfaced by
#: ``suspects()`` so the gang can flag the straggler before the timeout
#: tombstones it — hysteresis between "slow" and "gone".
DEFAULT_SUSPECT_FRACTION = 0.5


class RendezvousFencedError(RuntimeError):
    """A stale actor tried to move the epoch history backwards — a
    resurrected old server, or a proposer acting on a pre-partition view.
    The write was refused; the caller must re-read the current epoch."""


def _atomic_write(path: str, payload: str) -> None:
    tmp = f"{path}.tmp.{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as fh:
        fh.write(payload)
    os.replace(tmp, path)


class AddressBook:
    """File-published server address with a generation fence.

    The one piece of shared state the re-host protocol needs: where is
    the store *now*?  ``publish`` refuses to move the address backwards
    (a stale server re-publishing generation g-1 is ignored), ``lookup``
    returns ``(address, generation)`` or None.  The file lives on the
    one path every member can already reach (the launcher's shared
    scratch dir); on a real fleet this is a cluster-metadata entry."""

    def __init__(self, path: str):
        self.path = str(path)

    def publish(self, address: str, generation: int) -> bool:
        cur = self.lookup()
        if cur is not None and int(generation) < cur[1]:
            return False  # stale publisher, fenced
        _atomic_write(self.path, json.dumps(
            {"address": str(address), "generation": int(generation)}
        ))
        return True

    def lookup(self) -> tuple[str, int] | None:
        for _ in range(5):
            try:
                with open(self.path) as fh:
                    rec = json.loads(fh.read())
                return str(rec["address"]), int(rec["generation"])
            except FileNotFoundError:
                return None
            except (json.JSONDecodeError, KeyError, ValueError):
                time.sleep(0.02)  # torn read mid-publish
        return None


class RendezvousStore:
    """Directory-backed membership store with atomic epoch transitions.

    Layout under ``root``::

        members/<name>.json   heartbeat file; mtime = last beat
        dead/<name>           tombstone (clean leave or observed death)
        joins/<name>          a grow's request for a new process (launcher)
        epoch.json            {"epoch": k, "roster": [...], "ts": ...}
        epochs.jsonl          append-only transition log (one line/epoch)
        acks/<epoch>/<name>   barrier acknowledgements for epoch k
    """

    def __init__(
        self,
        root: str,
        *,
        heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
        suspect_after_s: float | None = None,
    ):
        self.root = str(root)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.suspect_after_s = float(
            suspect_after_s
            if suspect_after_s is not None
            else self.heartbeat_timeout_s * DEFAULT_SUSPECT_FRACTION
        )
        for sub in ("members", "dead", "acks", "blobs"):
            os.makedirs(os.path.join(self.root, sub), exist_ok=True)

    # -- membership -----------------------------------------------------

    def _member_path(self, name: str) -> str:
        name = str(name)
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad member name {name!r}")
        return os.path.join(self.root, "members", f"{name}.json")

    def join(self, name: str, **info) -> None:
        """Register ``name`` as a live member (clears any tombstone, so a
        respawned worker can rejoin under its old name)."""
        tomb = os.path.join(self.root, "dead", str(name))
        if os.path.exists(tomb):
            os.remove(tomb)
        _atomic_write(
            self._member_path(name),
            json.dumps({"name": str(name), "ts": time.time(), **info}),
        )

    def heartbeat(self, name: str) -> None:
        path = self._member_path(name)
        if os.path.exists(path):
            os.utime(path)
        else:  # first beat doubles as a join
            self.join(name)

    def leave(self, name: str) -> None:
        """Clean departure: tombstone + heartbeat removal."""
        self.mark_dead(name)
        try:
            os.remove(self._member_path(name))
        except FileNotFoundError:
            pass

    def mark_dead(self, name: str) -> None:
        """Tombstone ``name`` without touching its heartbeat file — the
        form used by the chaos injector and by a supervisor that watched
        the process die (the member itself never gets to call leave)."""
        _atomic_write(os.path.join(self.root, "dead", str(name)), "")

    def dead(self) -> list[str]:
        return sorted(os.listdir(os.path.join(self.root, "dead")))

    def _heartbeat_ages(self) -> dict[str, float]:
        """Seconds since each untombstoned member's last beat."""
        now = time.time()
        dead = set(self.dead())
        ages: dict[str, float] = {}
        for fname in os.listdir(os.path.join(self.root, "members")):
            if not fname.endswith(".json"):
                continue
            name = fname[: -len(".json")]
            if name in dead:
                continue
            try:
                ages[name] = now - os.stat(
                    os.path.join(self.root, "members", fname)
                ).st_mtime
            except FileNotFoundError:
                continue  # concurrent leave()
        return ages

    def alive(self) -> list[str]:
        """Members with a fresh heartbeat and no tombstone, sorted — this
        IS the deterministic next-roster every survivor computes.
        Suspects (old-but-unexpired beats) are still alive: membership
        only changes at the full timeout, after the suspect window gave
        the gang a chance to flag the straggler."""
        return sorted(
            n for n, age in self._heartbeat_ages().items()
            if age <= self.heartbeat_timeout_s
        )

    def suspects(self) -> list[str]:
        """Members in the hysteresis window: heartbeat older than
        ``suspect_after_s`` but not yet expired — slow-but-alive hosts
        the gang should flag (straggler event + alert) BEFORE the
        timeout tombstones them.  A refreshed beat clears the flag."""
        return sorted(
            n for n, age in self._heartbeat_ages().items()
            if self.suspect_after_s < age <= self.heartbeat_timeout_s
        )

    def expired(self) -> list[str]:
        """Members whose heartbeat aged past the full timeout without a
        tombstone — a host that stopped beating without anyone observing
        its death.  The coordinator promotes these to tombstones (the
        suspect → expired → tombstoned ladder's last rung)."""
        return sorted(
            n for n, age in self._heartbeat_ages().items()
            if age > self.heartbeat_timeout_s
        )

    def heartbeat_ages(self) -> dict[str, float]:
        """Public (and TCP-exposed) face of :meth:`_heartbeat_ages` —
        the coordinator reports a suspect's observed age in its
        ``gang_suspect`` event."""
        return {
            n: round(age, 3) for n, age in self._heartbeat_ages().items()
        }

    # -- join requests --------------------------------------------------

    def request_join(self, name: str) -> None:
        """Ask the launcher that watches this store for a new process for
        member ``name`` (the grow: ``joins/<name>`` holds the request's
        time)."""
        os.makedirs(os.path.join(self.root, "joins"), exist_ok=True)
        self._member_path(name)  # validates the name
        _atomic_write(os.path.join(self.root, "joins", str(name)), repr(time.time()))

    def join_requests(self) -> dict[str, float]:
        """The pending join requests: member -> request time (unix)."""
        d = os.path.join(self.root, "joins")
        out = {}
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            if name.startswith("."):
                continue
            try:
                with open(os.path.join(d, name)) as fh:
                    out[name] = float(fh.read() or 0.0)
            except (OSError, ValueError):
                continue
        return out

    def clear_join(self, name: str) -> None:
        """The request for ``name`` is served."""
        try:
            os.remove(os.path.join(self.root, "joins", str(name)))
        except FileNotFoundError:
            pass

    # -- blobs ----------------------------------------------------------

    def _blob_path(self, key: str) -> str:
        key = str(key)
        if not key or "/" in key or key.startswith("."):
            raise ValueError(f"bad blob key {key!r}")
        return os.path.join(self.root, "blobs", key)

    def put_blob(self, key: str, data: str) -> None:
        """Small out-of-band payload board (text; callers base64 binary).
        The scale-up path rides on this: a survivor publishes its live
        state snapshot keyed by membership epoch and the joiner catches
        up from it — no checkpoint read, no cross-process collective."""
        _atomic_write(self._blob_path(key), str(data))

    def get_blob(self, key: str) -> str | None:
        try:
            with open(self._blob_path(key)) as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    # -- epochs ---------------------------------------------------------

    def epoch(self) -> dict:
        """Current agreed epoch record ({"epoch": -1, "roster": []} before
        the first transition).

        A missing file genuinely means "no transition yet".  A file that
        EXISTS but fails to decode is a torn read — a transient one
        (concurrent atomic replace on NFS-ish rename semantics) clears on
        a brief retry; a PERSISTENT one is a torn write, the artifact of
        a host dying inside a non-atomic overwrite.  Defaulting there
        would silently reset the epoch to -1 and fork membership history,
        so instead the store SELF-HEALS: the append-only ``epochs.jsonl``
        log holds every record the gang ever agreed on, and its last
        valid line is re-promoted to ``epoch.json`` (atomically this
        time).  Only a store with a torn head AND no usable log raises.
        """
        path = os.path.join(self.root, "epoch.json")
        last_err = None
        for _ in range(5):
            try:
                with open(path) as fh:
                    return json.loads(fh.read())
            except FileNotFoundError:
                return {"epoch": -1, "roster": []}
            except json.JSONDecodeError as exc:
                last_err = exc
                time.sleep(0.05)
        recovered = None
        for rec in self.history():
            if isinstance(rec, dict) and "epoch" in rec:
                if recovered is None or rec["epoch"] > recovered["epoch"]:
                    recovered = rec
        if recovered is not None:
            _atomic_write(path, json.dumps(recovered))
            return recovered
        raise RuntimeError(
            f"rendezvous epoch.json at {path!r} is persistently "
            f"unparseable ({last_err}) and epochs.jsonl has no valid "
            f"record to heal from — torn or corrupt epoch history"
        )

    def roster(self) -> list[str]:
        return list(self.epoch().get("roster", []))

    def propose(self, roster: list[str], *, epoch: int | None = None) -> dict:
        """Write the next epoch record atomically and append it to the
        transition log.  ``epoch`` defaults to current+1.

        Epoch-version fence: a proposal for the CURRENT epoch is a
        duplicate — first write won, the existing record is returned
        unchanged (a proposer promoted after the original proposer died
        races the original's late write harmlessly).  A proposal for an
        OLDER epoch is a stale actor — a resurrected server replaying a
        pre-partition view — and raises :class:`RendezvousFencedError`
        instead of forking membership history."""
        cur = self.epoch()
        nxt = cur["epoch"] + 1 if epoch is None else int(epoch)
        if nxt <= cur["epoch"]:
            if nxt == cur["epoch"]:
                return dict(cur)
            raise RendezvousFencedError(
                f"stale proposal for epoch {nxt}: membership history is "
                f"already at epoch {cur['epoch']} — fenced"
            )
        rec = {
            "epoch": nxt,
            "roster": sorted(str(r) for r in roster),
            "prev_roster": cur.get("roster", []),
            "ts": time.time(),
        }
        _atomic_write(os.path.join(self.root, "epoch.json"), json.dumps(rec))
        with open(os.path.join(self.root, "epochs.jsonl"), "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        return rec

    def history(self) -> list[dict]:
        """All epoch transitions, oldest first.  Undecodable lines (a
        torn final append from a dying writer) are skipped — the log is
        the self-heal source for a torn ``epoch.json``, so it must
        degrade to its valid prefix, not amplify the corruption."""
        out = []
        try:
            with open(os.path.join(self.root, "epochs.jsonl")) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        except FileNotFoundError:
            pass
        return out

    # -- barrier + transition -------------------------------------------

    def ack(self, epoch: int, name: str) -> None:
        d = os.path.join(self.root, "acks", str(int(epoch)))
        os.makedirs(d, exist_ok=True)
        _atomic_write(os.path.join(d, str(name)), "")

    def acked(self, epoch: int) -> set[str]:
        d = os.path.join(self.root, "acks", str(int(epoch)))
        try:
            return set(os.listdir(d))
        except FileNotFoundError:
            return set()

    def barrier(
        self,
        epoch: int,
        name: str,
        participants: list[str],
        *,
        timeout_s: float = 30.0,
        poll_s: float = 0.02,
    ) -> bool:
        """Ack epoch ``epoch`` and wait until every participant has too.
        Returns False on timeout (the caller decides whether to re-run the
        transition with a smaller roster)."""
        self.ack(epoch, name)
        want = {str(p) for p in participants}
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if want <= self.acked(epoch):
                return True
            time.sleep(poll_s)
        return want <= self.acked(epoch)

    def transition(
        self,
        name: str,
        *,
        timeout_s: float = 30.0,
    ) -> dict:
        """Run one full epoch transition from ``name``'s point of view:
        compute survivors, barrier with them on the next epoch number,
        have the deterministic proposer (smallest survivor name) write the
        roster, and wait for ``epoch.json`` to advance.  Every survivor
        calls this and every survivor returns the same record."""
        name = str(name)
        cur = self.epoch()
        nxt = cur["epoch"] + 1
        survivors = self.alive()
        if name not in survivors:
            raise RuntimeError(
                f"member {name!r} is not in the surviving roster "
                f"{survivors} (tombstoned or heartbeat expired)"
            )
        ok = self.barrier(nxt, name, survivors, timeout_s=timeout_s)
        if not ok:
            # Someone died DURING the transition: retry against whoever is
            # still breathing.  The acked set only grows, so survivors of
            # the retry still pass the barrier.
            survivors = [s for s in self.alive() if s in set(survivors)]
            if name not in survivors:
                raise RuntimeError(
                    f"member {name!r} lost during epoch transition"
                )
            self.barrier(nxt, name, survivors, timeout_s=timeout_s)
        # Proposer-death tolerance: the deterministic proposer is the
        # smallest SURVIVING member, re-evaluated each wait iteration.
        # If the original proposer is tombstoned after the barrier but
        # before its write lands, the next-smallest survivor promotes
        # itself and proposes the still-alive subset; a late write from
        # the original is absorbed by propose()'s same-epoch dedup.
        deadline = time.monotonic() + timeout_s
        last_proposer = None
        while time.monotonic() < deadline:
            rec = self.epoch()
            if rec["epoch"] >= nxt:
                return rec
            self.heartbeat(name)  # waiting must not expire our own beat
            live = [s for s in survivors if s in set(self.alive())]
            if name not in live:
                raise RuntimeError(
                    f"member {name!r} lost during epoch transition"
                )
            last_proposer = live[0]
            if name == live[0]:
                self.propose(live, epoch=nxt)
                continue  # next read observes our own write
            time.sleep(0.02)
        raise TimeoutError(
            f"epoch {nxt} was never proposed (proposer "
            f"{last_proposer!r} wedged?)"
        )


# -- TCP transport ------------------------------------------------------

_TCP_OPS = (
    "join", "heartbeat", "leave", "mark_dead", "alive", "dead",
    "epoch", "roster", "propose", "history", "ack", "barrier",
    "transition", "suspects", "expired", "heartbeat_ages",
    "put_blob", "get_blob",
)

#: op -> positional-arg names for the client facade
_TCP_OP_ARGS = {
    "join": ("name",), "heartbeat": ("name",), "leave": ("name",),
    "mark_dead": ("name",), "propose": ("roster",),
    "ack": ("epoch", "name"), "barrier": ("epoch", "name", "participants"),
    "transition": ("name",), "put_blob": ("key", "data"),
    "get_blob": ("key",),
}


class _Handler(socketserver.StreamRequestHandler):
    def setup(self):
        super().setup()
        conns = getattr(self.server, "live_connections", None)
        if conns is not None:
            conns.add(self.connection)

    def finish(self):
        conns = getattr(self.server, "live_connections", None)
        if conns is not None:
            conns.discard(self.connection)
        super().finish()

    def handle(self):
        store = self.server.store  # type: ignore[attr-defined]
        gen = getattr(self.server, "generation", 0)
        for raw in self.rfile:
            if getattr(self.server, "dying", False):
                # kill() severs live connections too: a dead server
                # process answers nobody.  Dropping the socket mid-
                # request is exactly the reset the client must absorb.
                return
            tfields = {}
            try:
                req = json.loads(raw.decode())
                op = req.pop("op")
                # Trace-context envelope (schema v2): plain-data fields
                # riding the payload, NOT store-method kwargs — pop
                # before dispatch, echo in the reply so both sides of
                # the RPC correlate under one span context.
                tfields = {
                    k: req.pop(k)
                    for k in ("trace", "span", "parent") if k in req
                }
                if op not in _TCP_OPS:
                    raise ValueError(f"unknown op {op!r}")
                result = getattr(store, op)(**req)
                if isinstance(result, set):
                    result = sorted(result)
                reply = {"ok": True, "result": result, "gen": gen, **tfields}
            # ddplint: allow[broad-except] — protocol boundary: every
            # failure becomes a structured error reply, never a dead socket
            except Exception as exc:  # noqa: BLE001
                reply = {
                    "ok": False, "gen": gen,
                    "error": f"{type(exc).__name__}: {exc}",
                    "fenced": isinstance(exc, RendezvousFencedError),
                    **tfields,
                }
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()


class TCPRendezvousServer:
    """Serve one ``RendezvousStore`` over a localhost-style TCP socket.

    ``with TCPRendezvousServer(store) as srv: ... srv.address ...`` — the
    server thread is a daemon; ``close()`` (or the context exit) shuts it
    down.  Members use ``TCPRendezvousClient(address)``, which exposes the
    same method names as the store.

    ``generation`` stamps every reply: a re-hosted server publishes a
    higher generation, and clients refuse to go backwards — the fence
    that keeps a zombie original server from resurrecting stale
    membership after a re-host.  ``kill()`` (chaos) drops the listener
    without the graceful shutdown handshake, the way a real server
    process dies.
    """

    def __init__(self, store: RendezvousStore, host: str = "127.0.0.1",
                 port: int = 0, *, generation: int = 0,
                 address_book: AddressBook | None = None):
        self.store = store
        self.generation = int(generation)
        self._srv = socketserver.ThreadingTCPServer(
            (host, port), _Handler, bind_and_activate=True
        )
        self._srv.daemon_threads = True
        self._srv.store = store  # type: ignore[attr-defined]
        self._srv.generation = self.generation  # type: ignore[attr-defined]
        self._srv.live_connections = set()  # type: ignore[attr-defined]
        self.address = "%s:%d" % self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        if address_book is not None:
            address_book.publish(self.address, self.generation)

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=5.0)

    def kill(self) -> None:
        """Chaos hook: die abruptly — close the listener AND sever every
        live connection (the handler loop checks ``dying`` per request),
        leaving clients' in-flight RPCs to hit connection resets/EOF the
        way a dead server process would (what ``rdzv-kill`` injects)."""
        self._srv.dying = True  # type: ignore[attr-defined]
        try:
            self._srv.server_close()
        except OSError:
            pass
        # Reset established connections too: a client blocked on a
        # long-running op (barrier) must see EOF NOW, not the op's
        # eventual reply — a dead process's kernel does exactly this.
        for conn in list(
            getattr(self._srv, "live_connections", ())
        ):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._srv.shutdown()
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TCPRendezvousClient:
    """JSON-lines client for ``TCPRendezvousServer``; method-per-op facade
    so call sites are transport-agnostic (duck-typed with the store).

    Hardened transport:

    - every RPC runs under ``retry`` (:class:`RetryPolicy`): connection
      refused/reset — including mid-``barrier()`` while the server is
      being killed and re-hosted — reconnects with backoff+jitter
      instead of raising through the membership protocol;
    - ``address_book`` re-resolves the server address between attempts,
      so the retry lands on the re-hosted server, not the dead one;
    - generation fence: replies carry the server's generation; once the
      client has seen generation g, a reply from g' < g is a stale
      (pre-re-host) server — discarded and retried via the book;
    - ``epoch_cache`` records every epoch record this client ever saw —
      the survivor-side material :func:`rehost_store` replays when this
      member is elected to re-host the store.
    """

    def __init__(self, address: str | None = None, *,
                 timeout_s: float = 60.0,
                 retry: RetryPolicy | None = None,
                 address_book: AddressBook | None = None,
                 trace: dict | None = None):
        if address is None and address_book is None:
            raise ValueError("need an address or an address_book")
        self._static_address = address
        self._book = address_book
        self._timeout_s = float(timeout_s)
        # Span-context fields stamped onto every RPC payload (and echoed
        # back by the server).  Plain data — the server pops them before
        # dispatching to the store, so old servers that predate schema
        # v2 are the only ones that would choke; within one build the
        # wire stays compatible in both directions (absent = no trace).
        self.trace = {
            k: str(v) for k, v in (trace or {}).items()
            if k in ("trace", "span", "parent") and v
        }
        self.retry = retry or RetryPolicy()
        self.generation_seen = -1
        self.epoch_cache: dict[int, dict] = {}
        self._sock = None
        self._rfile = None
        try:
            self._connect()
        except RETRYABLE_ERRORS:
            # The address may be a just-published book entry racing the
            # server's listen, or a stale entry a respawned server is
            # about to overwrite: stay lazy — the first RPC reconnects
            # under the retry policy, re-resolving through the book.
            self._disconnect()

    # -- transport ------------------------------------------------------

    def _resolve(self) -> str:
        if self._book is not None:
            rec = self._book.lookup()
            if rec is not None:
                addr, gen = rec
                if gen >= self.generation_seen:
                    return addr
                # The book itself is stale (it fences on publish, so
                # this is a torn read) — fall through and retry.
            if self._static_address is None:
                raise ConnectionError(
                    "rendezvous address book is empty and no static "
                    "address was given"
                )
        return self._static_address

    def _connect(self) -> None:
        self._disconnect()
        addr = self._resolve()
        host, port = addr.rsplit(":", 1)
        # ddplint: allow[blocking-socket] — retry lives one level up:
        # every RPC goes through _call, whose RetryPolicy loop
        # reconnects on refused/reset; wrapping the dial here too would
        # square the backoff
        self._sock = socket.create_connection(
            (host, int(port)), timeout=self._timeout_s
        )
        self._rfile = self._sock.makefile("rb")

    def _disconnect(self) -> None:
        if self._rfile is not None:
            try:
                self._rfile.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = self._rfile = None

    def _rpc_once(self, op: str, kw: dict):
        if self._sock is None:
            self._connect()
        self._sock.sendall(
            (json.dumps({"op": op, **self.trace, **kw}) + "\n").encode()
        )
        raw = self._rfile.readline()
        if not raw:
            raise ConnectionError("rendezvous server closed the connection")
        reply = json.loads(raw.decode())
        gen = int(reply.get("gen", 0))
        if gen < self.generation_seen:
            # Stale pre-re-host server still answering: fence it off and
            # make the retry path re-resolve through the address book.
            raise ConnectionError(
                f"stale rendezvous server (generation {gen} < "
                f"{self.generation_seen}) — fenced"
            )
        self.generation_seen = max(self.generation_seen, gen)
        if not reply.get("ok"):
            if reply.get("fenced"):
                raise RendezvousFencedError(str(reply.get("error")))
            raise RuntimeError(f"rendezvous: {reply.get('error')}")
        return reply.get("result")

    def _call(self, op: str, **kw):
        def attempt():
            return self._rpc_once(op, kw)

        def reconnect(exc, delay):
            self._disconnect()
            try:
                self._connect()
            except RETRYABLE_ERRORS:
                pass  # next attempt() reconnects again

        result = retry_call(attempt, policy=self.retry, on_retry=reconnect)
        if op in ("epoch", "transition", "propose") and isinstance(
            result, dict
        ) and "epoch" in result and result["epoch"] >= 0:
            self.epoch_cache[int(result["epoch"])] = dict(result)
        elif op == "history" and isinstance(result, list):
            for rec in result:
                if isinstance(rec, dict) and "epoch" in rec:
                    self.epoch_cache[int(rec["epoch"])] = dict(rec)
        return result

    def cached_history(self) -> list[dict]:
        """Every epoch record this client has observed, oldest first —
        the replay material for :func:`rehost_store`."""
        return [self.epoch_cache[k] for k in sorted(self.epoch_cache)]

    def close(self) -> None:
        self._disconnect()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _make_op(op):
    def call(self, *args, **kw):
        # Positional args map onto the store's signatures by op.
        kw.update(zip(_TCP_OP_ARGS.get(op, ()), args))
        return self._call(op, **kw)

    call.__name__ = op
    return call


for _op in _TCP_OPS:
    setattr(TCPRendezvousClient, _op, _make_op(_op))
del _op


# -- store re-hosting ----------------------------------------------------


def elect_rehost(survivors: list[str]) -> str:
    """The deterministic re-host owner: the lexicographically smallest
    survivor — same rule as the epoch proposer, so no election protocol
    is needed on top of the membership the gang already agrees on.

    Delegates to ``analysis.protocol.elect_rehost_owner`` (both stdlib
    only), so the rule the model checker explores is the rule the gang
    executes."""
    from distributeddataparallel_tpu_torch.analysis.protocol import elect_rehost_owner

    return elect_rehost_owner(survivors)


def rehost_store(
    root: str,
    epoch_records: list[dict],
    *,
    generation: int,
    members: list[str] = (),
    host: str = "127.0.0.1",
    port: int = 0,
    address_book: AddressBook | None = None,
    heartbeat_timeout_s: float = DEFAULT_HEARTBEAT_TIMEOUT_S,
    suspect_after_s: float | None = None,
) -> TCPRendezvousServer:
    """Stand the rendezvous store back up on a survivor after the server
    died: seed a fresh :class:`RendezvousStore` at ``root`` by replaying
    ``epoch_records`` (a survivor's :meth:`TCPRendezvousClient.
    cached_history` — the append-only epoch log reconstructed from what
    the gang actually agreed on), re-join ``members`` (the re-hoster's
    own hosted members; peers re-join via their own heartbeats), and
    serve it at ``generation`` (strictly greater than the dead server's)
    published through ``address_book``.

    The epoch fence holds across the re-host: the replayed ``epoch.json``
    lands on the NEWEST cached epoch, so a stale proposal — or the old
    server's disk resurrected at an earlier epoch — is refused by
    ``propose``'s version check, and the generation stamp keeps clients
    off the old server entirely.
    """
    store = RendezvousStore(
        root,
        heartbeat_timeout_s=heartbeat_timeout_s,
        suspect_after_s=suspect_after_s,
    )
    records = sorted(
        (dict(r) for r in epoch_records if "epoch" in r),
        key=lambda r: int(r["epoch"]),
    )
    if records:
        log_path = os.path.join(store.root, "epochs.jsonl")
        with open(log_path, "a") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
        _atomic_write(
            os.path.join(store.root, "epoch.json"), json.dumps(records[-1])
        )
    for m in members:
        store.join(m)
    return TCPRendezvousServer(
        store, host, port, generation=int(generation),
        address_book=address_book,
    )
