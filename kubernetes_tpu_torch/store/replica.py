"""WAL-shipping store replication: a follower that serves reads/watches
and can be promoted when the primary dies.

Reference: the reference's storage.Interface lands on a raft-replicated
etcd quorum (staging/.../storage/etcd3/store.go; etcd's raft log), so a
member loss never loses committed writes and watches survive failover.
This is the single-follower equivalent for the single-writer store
(store/kv.py): every committed mutation record (the same tuples the WAL
appends) is SHIPPED to connected followers; in sync mode (default) the
primary's commit blocks until the follower acknowledges the record's
revision, so an acknowledged client write is on at least two stores —
kill the primary, promote the follower, and informers relist against it
with zero lost committed writes (tests/test_torch_store_replica.py runs
that chaos sequence on this package, and holds it frame for frame
against the JAX package's module of the same name).

Protocol (length-prefixed JSON frames over TCP):
  follower -> primary   {"type": "hello", "rev": <highest applied>,
                         "epoch": <highest seen>}
  primary  -> follower  {"type": "snapshot", "rev": N, "epoch": E,
                         "data": {...}}
  primary  -> follower  {"type": "recs", "epoch": E, "recs": [[op, rev,
                         res, key, obj], ...]}
  primary  -> follower  {"type": "ping", "epoch": E}      (heartbeat)
  primary  -> follower  {"type": "fenced", "epoch": E}    (refusal)
  follower -> primary   {"type": "ack", "rev": N}

Failover (the etcd-raft capability a single-follower seam needs):

  * Every frame carries the primary's EPOCH (its term).  A follower
    tracks the highest epoch it has seen and drops a stream whose epoch
    is lower — a deposed primary's records can never be applied.
  * auto_promote_after(grace): a follower-side failure detector — when
    the stream (recs OR heartbeat pings) goes silent for `grace`
    seconds, the follower promotes itself with epoch+1.
  * fencing=True on the hub: an acked write is then GUARANTEED on the
    follower — a sync-ack timeout FENCES the primary (store raises
    FencedError to that writer and every later one) instead of
    degrading to async.  The fenced table may hold a tail of dirty
    never-acked writes; they are discarded by the snapshot when the
    deposed primary rejoins.  Pick grace > sync_timeout so the old
    primary stops acking before the follower starts a new term.
  * rejoin(): a deposed (fenced) primary re-enters as a follower of the
    new primary; a hello claiming a HIGHER epoch than the hub's own
    fences the HUB instead (it is the stale side of the partition).

This module is a copy of the JAX package's store/replica.py: the same
classes, names, logic and frames, so a follower of either package
bootstraps from and streams a hub of the other.  The one place where the
two packages' stores differ on its path is MemoryStore.bind_many (this
package's builds the bound pods outside the store lock and commits them
under it); its commit records are the JAX store's, record for record, so
nothing here changes for it.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
import time

from . import kv
from . import wal as wal_mod

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME = 512 << 20


def _send_frame(sock: socket.socket, payload: dict) -> None:
    data = json.dumps(payload).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Read exactly n bytes.  TimeoutError mid-buffer RETRIES instead of
    discarding: a concurrent ship()/heartbeat legitimately toggles a
    send timeout on the shared socket, and dropping partial bytes would
    desync the frame stream permanently (observed: primary ack reader
    lost framing under load and fenced a healthy pair).  A timeout at a
    clean frame boundary propagates so callers can treat it as 'no
    frame right now'."""
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (TimeoutError, BlockingIOError):
            # BlockingIOError: defense against a concurrent settimeout
            # flipping the fd's O_NONBLOCK under a blocking-mode recv
            if buf:
                continue  # mid-frame: keep what we have, keep reading
            raise TimeoutError("no frame")
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> dict | None:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (size,) = _LEN.unpack(head)
    if size > MAX_FRAME:
        raise OSError(f"replication frame {size} exceeds cap")
    while True:
        try:
            body = _recv_exact(sock, size)
            break
        except TimeoutError:
            continue  # head consumed: the body MUST be read to keep framing
    if body is None:
        return None
    return json.loads(body)


class _FollowerConn:
    """Primary-side state for one connected follower."""

    def __init__(self, sock: socket.socket, addr):
        self.sock = sock
        self.addr = addr
        self.acked_rev = 0
        self.lock = threading.Lock()  # serializes sends
        self.dead = False


class ReplicationHub:
    """Attached to the PRIMARY store: accepts follower connections,
    bootstraps them with a snapshot, ships commit records, and (in sync
    mode) blocks the committing writer until the newest record is
    acknowledged.

    sync_timeout bounds how long a commit waits for a follower: a dead
    or lagging follower degrades the primary to async shipping (logged)
    instead of freezing the cluster — the availability/durability trade
    etcd resolves with quorum, degraded here to primary-keeps-serving.
    """

    def __init__(self, store: kv.MemoryStore, host: str = "127.0.0.1",
                 port: int = 0, sync: bool = True,
                 sync_timeout: float = 2.0, fencing: bool = False,
                 heartbeat_interval: float = 0.25):
        self.store = store
        self.sync = sync
        self.sync_timeout = sync_timeout
        # fencing mode: an acked write is guaranteed replicated — a sync
        # ack timeout fences this primary instead of degrading to async
        self.fencing = fencing
        self.heartbeat_interval = heartbeat_interval
        self._followers: list[_FollowerConn] = []
        self._flock = threading.Lock()
        self._ack_cond = threading.Condition(self._flock)
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(4)
        self.address = self._listener.getsockname()
        self._stopped = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="repl-accept", daemon=True)
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, name="repl-heartbeat", daemon=True)

    @property
    def epoch(self) -> int:
        return self.store.epoch

    def start(self) -> "ReplicationHub":
        self.store._repl = self
        self._accept_thread.start()
        self._hb_thread.start()
        return self

    def stop(self) -> None:
        self._stopped = True
        if self.store._repl is self:
            self.store._repl = None
        try:
            self._listener.close()
        except OSError:
            pass
        with self._flock:
            for f in self._followers:
                f.dead = True
                try:
                    f.sock.close()
                except OSError:
                    pass
            self._followers.clear()
            self._ack_cond.notify_all()

    def _heartbeat_loop(self) -> None:
        """Liveness signal for follower-side failure detectors: followers
        promote on stream SILENCE, so an idle-but-healthy primary must
        keep the stream warm."""
        while not self._stopped:
            time.sleep(self.heartbeat_interval)
            with self._flock:
                followers = list(self._followers)
            ping = {"type": "ping", "epoch": self.epoch}
            for f in followers:
                try:
                    with f.lock:
                        _send_frame(f.sock, ping)
                except OSError:
                    self._drop(f)

    @property
    def follower_count(self) -> int:
        with self._flock:
            return len(self._followers)

    # -- primary side -----------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopped:
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_follower,
                             args=(sock, addr), daemon=True,
                             name="repl-follower").start()

    def _serve_follower(self, sock: socket.socket, addr) -> None:
        conn = _FollowerConn(sock, addr)
        try:
            hello = _recv_frame(sock)
            if not hello or hello.get("type") != "hello":
                sock.close()
                return
            claimed = int(hello.get("epoch", 0))
            if claimed > self.epoch:
                # the connecting "follower" has seen a newer primary term
                # than ours: WE are the stale side of a healed partition.
                # Fence ourselves and refuse the stream.
                self.store.fence(
                    f"follower {addr} reports epoch {claimed} > "
                    f"our {self.epoch}")
                try:
                    _send_frame(sock, {"type": "fenced",
                                       "epoch": claimed})
                finally:
                    sock.close()
                return
            # Registration and the snapshot send happen under conn.lock:
            # a commit racing the bootstrap blocks in ship() on that lock
            # until the snapshot frame is fully on the wire, so the
            # stream can neither interleave bytes mid-frame nor deliver
            # 'recs' before 'snapshot'.  The image itself is captured
            # under the store lock (consistent at one revision), and the
            # follower registers before that lock drops, so nothing
            # committed after the image can be missed.
            with conn.lock:
                with self.store._lock:
                    image = {res: dict(tbl)
                             for res, tbl in self.store._data.items()}
                    rev = self.store._rev
                    with self._flock:
                        self._followers.append(conn)
                _send_frame(sock, {"type": "snapshot", "rev": rev,
                                   "epoch": self.epoch, "data": image})
            conn.acked_rev = rev
            # ONE permanent timeout for this connection from here on:
            # ship()/heartbeat sends are bounded by it, and the ack
            # reader retries through it.  Toggling settimeout per send
            # (the old scheme) flips O_NONBLOCK under the reader's feet
            # — a recv that starts in the toggle window gets EAGAIN.
            sock.settimeout(self.sync_timeout)
        except OSError:
            self._drop(conn)
            return
        # ack reader loop
        try:
            while not conn.dead:
                try:
                    frame = _recv_frame(sock)
                except TimeoutError:
                    # a concurrent ship() temporarily put a send timeout
                    # on the shared socket; ack frames are single-write
                    # tiny, so a quiet-stream timeout is retryable
                    continue
                if frame is None:
                    break
                if frame.get("type") == "ack":
                    with self._flock:
                        conn.acked_rev = max(conn.acked_rev,
                                             int(frame.get("rev", 0)))
                        self._ack_cond.notify_all()
        except OSError:
            pass
        finally:
            self._drop(conn)

    def _drop(self, conn: _FollowerConn) -> None:
        conn.dead = True
        try:
            conn.sock.close()
        except OSError:
            pass
        with self._flock:
            if conn in self._followers:
                self._followers.remove(conn)
                logger.warning("replication follower %s dropped",
                               conn.addr)
            self._ack_cond.notify_all()

    def ship(self, recs: list[tuple]) -> None:
        """Called by the store under ITS lock for every commit.  Sends
        the records to every follower; in sync mode, waits until some
        follower acknowledges the newest revision (or the timeout
        passes — degraded async, logged)."""
        with self._flock:
            followers = list(self._followers)
        if not followers:
            if self.fencing:
                # fencing contract: an acked write IS on a follower; with
                # none connected this commit cannot be guaranteed — fence
                # now so the writer sees the failure instead of an ack
                # (the already-applied table mutation is a dirty
                # never-acked tail, discarded at rejoin())
                self.store.fence("no follower connected for a fencing-"
                                 "mode commit")
                raise kv.FencedError(
                    "store fenced: no follower to guarantee the write")
            return
        top_rev = max(r[1] for r in recs)
        payload = {"type": "recs", "epoch": self.epoch,
                   "recs": [list(r) for r in recs]}
        for f in followers:
            try:
                with f.lock:
                    # the connection's permanent timeout bounds this
                    # send: a stalled (SIGSTOPped) follower fills its
                    # TCP window and an untimed sendall would freeze
                    # the whole store under its lock
                    _send_frame(f.sock, payload)
            except OSError:
                self._drop(f)
        if not self.sync:
            return
        deadline = time.monotonic() + self.sync_timeout
        with self._flock:
            while not self._stopped:
                live = [f for f in self._followers if not f.dead]
                if not live:
                    break  # all followers died mid-wait
                if any(f.acked_rev >= top_rev for f in live):
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._ack_cond.wait(remaining)
            else:
                return  # hub stopped: shutdown path, not a failure
        if self.fencing:
            # the ack never came: fence so THIS writer (and all later
            # ones) fail instead of acking a write the new primary may
            # never have — raft's "deposed leader cannot commit"
            self.store.fence(
                f"replication ack timeout at rev {top_rev}")
            raise kv.FencedError(
                f"store fenced: rev {top_rev} unacknowledged")
        logger.warning("replication sync ack timed out at rev %d; "
                       "degrading this commit to async", top_rev)


class FollowerStore(kv.MemoryStore):
    """A read-only replica fed by a ReplicationHub stream.

    Serves get/list/watch like any MemoryStore (informers point at it
    via LocalClient or an APIServer); every write verb raises until
    promote() flips it into a writable primary that continues from the
    last applied revision.  A promoted follower can carry its own WAL
    (durable_dir) and its own ReplicationHub — the next follower in the
    chain."""

    def __init__(self, history: int = 100_000,
                 transformers: dict | None = None,
                 durable_dir: str | None = None):
        super().__init__(history=history, transformers=transformers,
                         durable_dir=durable_dir)
        self._promoted = False
        self._conn: socket.socket | None = None
        self._follow_thread: threading.Thread | None = None
        self._synced = threading.Event()
        # failover state: highest primary epoch observed on the stream,
        # last time any frame arrived (the failure detector's signal),
        # and the watchdog thread auto_promote_after starts
        self._seen_epoch = 0
        self._last_frame = 0.0
        self._watchdog: threading.Thread | None = None
        self._watchdog_grace: float | None = None
        self._watchdog_stop = threading.Event()
        self.promoted_event = threading.Event()

    # -- write fencing ----------------------------------------------------

    def _check_writable(self) -> None:
        if not self._promoted:
            raise kv.StoreError("store is a read-only replica "
                                "(promote() to accept writes)")

    def create(self, *a, **k):
        self._check_writable()
        return super().create(*a, **k)

    def create_many(self, *a, **k):
        self._check_writable()
        return super().create_many(*a, **k)

    def update(self, *a, **k):
        self._check_writable()
        return super().update(*a, **k)

    def delete(self, *a, **k):
        self._check_writable()
        return super().delete(*a, **k)

    def bind_many(self, *a, **k):
        self._check_writable()
        return super().bind_many(*a, **k)

    def guaranteed_update(self, *a, **k):
        self._check_writable()
        return super().guaranteed_update(*a, **k)

    # -- following --------------------------------------------------------

    def follow(self, host: str, port: int,
               timeout: float = 10.0) -> "FollowerStore":
        """Connect to the primary's ReplicationHub and start applying
        its stream; returns once the bootstrap snapshot is installed."""
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._conn = sock
        _send_frame(sock, {"type": "hello", "rev": self._rev,
                           "epoch": max(self._seen_epoch, self.epoch)})
        snap = _recv_frame(sock)
        if not snap:
            raise kv.StoreError("replication bootstrap failed")
        if snap.get("type") == "fenced":
            raise kv.FencedError(
                "primary refused the stream: it fenced itself against "
                f"our epoch {max(self._seen_epoch, self.epoch)}")
        if snap.get("type") != "snapshot":
            raise kv.StoreError("replication bootstrap failed")
        new_data = {res: dict(tbl)
                    for res, tbl in (snap.get("data") or {}).items()}
        snap_rev = int(snap.get("rev", 0))
        with self._lock:
            old_data = self._data
            if self._rev > 0 or any(old_data.values()):
                # Rejoin (this store served — or followed — a previous
                # term): attached watchers hold a view that may contain a
                # dirty never-acked tail, and the new primary's revision
                # sequence can numerically overlap it.  Installing the
                # snapshot wholesale would leave those watchers with
                # stale keys forever and let later emissions run
                # backwards.  Instead: restart the watch ring (resumes
                # from old-term revisions must relist — TooOldError), and
                # converge attached watchers onto the snapshot with
                # synthesized diff events stamped ABOVE everything they
                # have seen, so the stream stays strictly monotonic.
                base = max(self._rev, snap_rev)
                self._history.clear()
                self._floor = base
                for res in sorted(set(old_data) | set(new_data)):
                    old_tbl = old_data.get(res) or {}
                    new_tbl = new_data.get(res) or {}
                    evs: list[kv.WatchEvent] = []
                    for key in sorted(old_tbl):
                        if key in new_tbl:
                            continue
                        base += 1
                        opened = self._open(res, old_tbl[key])
                        tomb = dict(opened)
                        tomb["metadata"] = dict(
                            opened.get("metadata") or {})
                        tomb["metadata"]["resourceVersion"] = base
                        evs.append(kv.WatchEvent(kv.DELETED, tomb, base))
                    for key in sorted(new_tbl):
                        stored = new_tbl[key]
                        stale = old_tbl.get(key)
                        opened = self._open(res, stored)
                        if stale is not None:
                            stale_rv = (self._open(res, stale).get(
                                "metadata") or {}).get("resourceVersion")
                            if stale_rv == (opened.get("metadata")
                                            or {}).get("resourceVersion"):
                                continue  # watcher view already current
                        base += 1
                        evs.append(kv.WatchEvent(
                            kv.MODIFIED if stale is not None else kv.ADDED,
                            opened, base))
                    self._emit_many(res, evs)
                self._data = new_data
                self._rev = base
            else:
                # first bootstrap of a fresh follower: nobody watched the
                # empty store, plain install
                self._data = new_data
                self._rev = snap_rev
                self._floor = snap_rev  # pre-snapshot revs unobservable
            self._seen_epoch = max(self._seen_epoch,
                                   int(snap.get("epoch", 0)))
        self._last_frame = time.monotonic()
        sock.settimeout(None)
        self._synced.set()
        self._follow_thread = threading.Thread(
            target=self._follow_loop, name="repl-follow", daemon=True)
        self._follow_thread.start()
        return self

    def auto_promote_after(self, grace: float) -> "FollowerStore":
        """Start the failure detector: when the replication stream goes
        silent (no recs and no heartbeat pings) for `grace` seconds,
        promote this follower with a new epoch.  Pick grace > the hub's
        sync_timeout so a fencing-mode primary stops acking writes
        before the new term starts (the zero-acked-loss ordering)."""
        self._watchdog_grace = grace

        def watch() -> None:
            while not self._watchdog_stop.wait(grace / 4):
                if self._promoted:
                    return
                if time.monotonic() - self._last_frame > grace:
                    logger.warning(
                        "replication stream silent %.1fs: auto-promoting "
                        "at epoch %d", grace, self._seen_epoch + 1)
                    self.promote()
                    return

        self._watchdog = threading.Thread(target=watch,
                                          name="repl-watchdog", daemon=True)
        self._watchdog.start()
        return self

    def _follow_loop(self) -> None:
        sock = self._conn
        try:
            while not self._promoted:
                frame = _recv_frame(sock)
                if frame is None:
                    logger.warning("replication stream closed by primary")
                    return
                epoch = int(frame.get("epoch", self._seen_epoch))
                if epoch < self._seen_epoch:
                    # a deposed primary's stream: its records must never
                    # apply (fencing).  Drop the connection; the stale
                    # primary discovers the new term when it rejoins.
                    logger.warning(
                        "dropping replication stream at stale epoch %d "
                        "(seen %d)", epoch, self._seen_epoch)
                    return
                self._seen_epoch = max(self._seen_epoch, epoch)
                self._last_frame = time.monotonic()
                if frame.get("type") != "recs":
                    continue  # ping / unknown: liveness only
                recs = frame.get("recs") or []
                self._apply_records(recs)
                top = max((int(r[1]) for r in recs), default=0)
                if top:
                    _send_frame(sock, {"type": "ack", "rev": top})
        except OSError as e:
            if not self._promoted:
                logger.warning("replication stream error: %s", e)

    def _apply_records(self, recs: list) -> None:
        """Replay shipped commit records: table writes + watch emission,
        exactly the primary's commit effects (objects arrive sealed; the
        watch ring serves opened plaintext like the primary's).  The
        records also re-enter _commit, so a follower with its own WAL
        persists them and a chained downstream follower receives them."""
        with self._lock:
            for rec in recs:
                op, rev, resource, key = rec[0], int(rec[1]), rec[2], rec[3]
                obj = rec[4] if len(rec) > 4 else None
                table = self._table(resource)
                if rev > self._rev:
                    self._rev = rev
                else:
                    # post-rejoin plateau: the new primary's sequence is
                    # still below what attached watchers observed (old
                    # term's dirty tail or the synthesized rejoin diff) —
                    # step past it so the emitted stream stays strictly
                    # monotonic until the primary's numbering catches up
                    self._rev += 1
                if op == wal_mod.PUT:
                    existed = key in table
                    table[key] = obj
                    self._emit(resource,
                               kv.MODIFIED if existed else kv.ADDED,
                               self._open(resource, obj))
                else:  # DELETE; obj is the tombstone (may be None from
                    table.pop(key, None)       # an old-format primary)
                    tomb = obj or {"metadata": {
                        "name": key.rpartition("/")[2],
                        "namespace": key.rpartition("/")[0],
                        "resourceVersion": self._rev}}
                    self._emit(resource, kv.DELETED, tomb)
            if self._logging:
                self._commit([tuple(r) for r in recs])

    # -- promotion --------------------------------------------------------

    def promote(self) -> "FollowerStore":
        """Become the writable primary: stop following, accept writes,
        continue the revision sequence from the last applied record —
        under a NEW epoch (seen+1), so the deposed primary's stream and
        rejoin attempts are recognizably stale (fencing).  Watches
        opened against this store stay attached; informers of clients
        that re-point here relist and resume."""
        self.epoch = self._seen_epoch + 1
        self._seen_epoch = self.epoch
        self._fenced = False  # a new term clears any old fence
        self._promoted = True
        self._watchdog_stop.set()
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        logger.warning("follower promoted to primary at rev %d epoch %d",
                       self._rev, self.epoch)
        self.promoted_event.set()
        return self

    def rejoin(self, host: str, port: int,
               timeout: float = 10.0) -> "FollowerStore":
        """Re-enter the cluster as a follower of the (new) primary: a
        deposed/fenced primary calls this after a partition heals.  Any
        dirty never-acked tail in the table is discarded by the
        bootstrap snapshot — follow() converges attached watchers onto
        it with synthesized DELETED/ADDED/MODIFIED diff events and
        restarts the watch ring, so a watcher spanning fence→rejoin
        sees vanished keys deleted and strictly monotonic revisions.
        The write fence flips back on (this store is a replica again)."""
        self._promoted = False
        self._fenced = False
        self._fence_reason = ""
        self.promoted_event.clear()
        self._watchdog_stop = threading.Event()
        self._synced = threading.Event()
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
        self.follow(host, port, timeout=timeout)
        if getattr(self, "_watchdog_grace", None):
            # the failure detector died with the old term (promote()
            # stops it); a rejoined replica keeps the automatic-failover
            # contract it was configured with
            self.auto_promote_after(self._watchdog_grace)
        return self
