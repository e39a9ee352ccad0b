"""Versioned in-memory MVCC store with watch — the etcd3-equivalent.

Reference semantics this reproduces (not the implementation):
  staging/src/k8s.io/apiserver/pkg/storage/interfaces.go:159 (storage.Interface)
  staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go:154,331,526,798
    (Create / GuaranteedUpdate CAS / GetList / Watch)
  staging/src/k8s.io/apiserver/pkg/storage/cacher/ (watch ring buffer,
    "too old resource version" -> client relists)

Design:
  * single monotonically-increasing int64 revision shared by all resources
    (like etcd's store revision); every write stamps the object's
    metadata.resourceVersion with it.
  * per-resource maps keyed by "ns/name".
  * optimistic concurrency: update/delete take an expected resourceVersion and
    raise ConflictError on mismatch (the CAS txn in etcd3/store.go:331).
  * watch: per-watcher unbounded-ish queue fed synchronously under the write
    lock (so event order == revision order); a bounded history ring lets
    watchers resume from a recent revision, older resumes raise TooOldError
    which informers answer by re-listing (reflector.go:256 semantics).

Thread-safe; all blocking happens in Watch.next(), never under the lock.

Durability (etcd WAL + snapshot equivalent, store/wal.py): pass
durable_dir= to persist every mutation to an append-only checksummed log
with periodic snapshot compaction; a restarted store recovers state + the
revision counter from disk, and watch resumes below the recovery floor
raise TooOldError (the serving history ring is process-local, exactly
like the reference's cacher atop a persistent etcd).

Object-sharing contract (same as client-go's informer cache): objects
RETURNED by get/list/watch are shared references and MUST NOT be mutated by
callers — mutate a deep copy and write it back.  Inbound objects on
create/update are deep-copied by the store, so the stored state is always
private.  This removes a deep copy from every read, which profiling shows
dominates end-to-end scheduling throughput.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Iterator

from ..api import meta
from ..api.meta import Obj
from . import wal as wal_mod

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"
BOOKMARK = "BOOKMARK"
ERROR = "ERROR"


class StoreError(Exception):
    pass


class NotFoundError(StoreError):
    pass


class AlreadyExistsError(StoreError):
    pass


class FencedError(StoreError):
    """The store was fenced: a newer primary epoch exists (replication
    failover promoted a follower) and this instance must not accept
    writes — the split-brain guard etcd gets from raft terms
    (etcd3/store.go:798 sits on a raft log whose deposed leaders cannot
    commit).  Reads keep serving; rejoin as a follower to resume."""


class ConflictError(StoreError):
    """resourceVersion mismatch — caller should re-get and retry."""


class BindConflict(ConflictError):
    """A bind lost the optimistic race: the pod was claimed by a peer
    scheduler instance (Omega-style shared-state scheduling resolves
    multi-scheduler contention at commit time, not at dispatch time).

    Subclasses ConflictError so every existing 409/retry path keeps
    working; carries structured fields so the losing scheduler can
    classify the outcome without parsing the message — ``current_node``
    is who actually owns the pod now (None when only the resourceVersion
    precondition failed), ``wanted_node`` is where the caller tried to
    put it."""

    def __init__(self, message: str, *, key: str = "",
                 current_node: str | None = None,
                 wanted_node: str | None = None):
        super().__init__(message)
        self.key = key
        self.current_node = current_node
        self.wanted_node = wanted_node


class TooOldError(StoreError):
    """Requested watch revision has been compacted — caller must re-list."""


class WatchEvent:
    # _wire: lazily-cached serialized form ({"type","object"} JSON line).
    # One WatchEvent instance fans out to EVERY watcher of a resource
    # (plus the history ring), so the apiserver's watch streams used to
    # re-encode the same ~1KB object once per watcher per event; the
    # cache makes it once per event (server.py _serve_watch fills it for
    # the plain-identity case only — field-selected or version-converted
    # streams bypass it).
    __slots__ = ("type", "object", "revision", "_wire")

    def __init__(self, type_: str, obj: Obj, revision: int):
        self.type = type_
        self.object = obj
        self.revision = revision
        self._wire = None

    def __repr__(self) -> str:  # pragma: no cover
        return f"WatchEvent({self.type}, rv={self.revision}, {meta.namespaced_name(self.object)})"


class Watch:
    """A single watch stream. Iterate or call next(timeout)."""

    def __init__(self, store: "MemoryStore", resource: str):
        self._store = store
        self._resource = resource
        self._cond = threading.Condition()
        self._queue: deque[WatchEvent] = deque()
        self._stopped = False

    def _push(self, ev: WatchEvent) -> None:
        with self._cond:
            if not self._stopped:
                self._queue.append(ev)
                self._cond.notify()

    def _push_many(self, evs: list[WatchEvent]) -> None:
        """Deliver a write burst with ONE wakeup.  Waking a blocked consumer
        is a futex syscall (~10-20µs); per-event delivery made that the
        dominant cost of bulk store writes at bench scale."""
        with self._cond:
            if not self._stopped:
                self._queue.extend(evs)
                self._cond.notify()

    def next(self, timeout: float | None = None) -> WatchEvent | None:
        with self._cond:
            if not self._queue and not self._stopped:
                self._cond.wait(timeout)
            if self._queue:
                return self._queue.popleft()
            return None

    def next_batch(self, timeout: float | None = None) -> list[WatchEvent]:
        """Drain everything queued (blocking up to timeout for the first
        event).  Consumers that can apply events in bulk (informers) use
        this to amortize their own locking over a write burst."""
        with self._cond:
            if not self._queue and not self._stopped:
                self._cond.wait(timeout)
            if not self._queue:
                return []
            out = list(self._queue)
            self._queue.clear()
            return out

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._store._remove_watch(self._resource, self)

    @property
    def stopped(self) -> bool:
        return self._stopped

    def __iter__(self) -> Iterator[WatchEvent]:
        while True:
            ev = self.next()
            if ev is None:
                return
            yield ev


class MemoryStore:
    """The cluster store. One instance == one 'etcd'."""

    def __init__(self, history: int = 100_000, transformers: dict | None = None,
                 durable_dir: str | None = None, wal_fsync: bool = False,
                 compact_every: int = 200_000):
        self._lock = threading.RLock()
        self._rev = 0
        # resource -> {"ns/name": obj}
        self._data: dict[str, dict[str, Obj]] = {}
        # resource -> ring of WatchEvent for resumable watches
        self._history: dict[str, deque[WatchEvent]] = {}
        self._history_len = history
        # resource -> oldest revision still in history (compaction floor)
        self._watchers: dict[str, list[Watch]] = {}
        # resource -> EnvelopeTransformer (encryption.py): values of these
        # resources are sealed AT REST in the table; reads/watches serve
        # plaintext (the watch ring is a serving cache, like the reference's
        # cacher, and holds decrypted objects — at-rest covers the table)
        self._transformers = dict(transformers or {})
        # watch completeness floor: resumes below it must relist.  Starts
        # at the recovered revision after a restart (the in-memory history
        # ring did not survive, so pre-crash revisions are unobservable —
        # etcd compaction semantics).
        self._floor = 0
        self._wal = None
        self._repl = None  # replication hub (replica.ReplicationHub)
        # fencing state (replica.py failover): epoch is this store's
        # primary term — promotion bumps it; a fenced store rejects
        # writes until it rejoins the new primary as a follower
        self.epoch = 0
        self._fenced = False
        self._fence_reason = ""
        self._compact_every = compact_every
        self._snapshot_thread: threading.Thread | None = None
        if durable_dir is not None:
            rev, data, valid, replayed = wal_mod.WriteAheadLog.recover(
                durable_dir)
            self._rev = rev
            self._floor = rev
            self._data = {res: dict(tbl) for res, tbl in data.items()}
            self._wal = wal_mod.WriteAheadLog(durable_dir, fsync=wal_fsync,
                                              truncate_log_to=valid,
                                              pending_records=replayed)

    # -- internals -------------------------------------------------------

    def _table(self, resource: str) -> dict[str, Obj]:
        return self._data.setdefault(resource, {})

    def _seal(self, resource: str, obj: Obj) -> Obj:
        t = self._transformers.get(resource)
        return t.encrypt_obj(obj) if t is not None else obj

    def _open(self, resource: str, stored: Obj) -> Obj:
        t = self._transformers.get(resource)
        return t.decrypt_obj(stored) if t is not None else stored

    def _emit(self, resource: str, type_: str, obj: Obj) -> None:
        ev = WatchEvent(type_, obj, self._rev)
        hist = self._history.setdefault(resource, deque(maxlen=self._history_len))
        hist.append(ev)
        for w in self._watchers.get(resource, ()):  # synchronous, ordered
            w._push(ev)

    def _emit_many(self, resource: str, evs: list[WatchEvent]) -> None:
        """Bulk _emit: one history extend + one wakeup per watcher."""
        if not evs:
            return
        hist = self._history.setdefault(resource,
                                        deque(maxlen=self._history_len))
        hist.extend(evs)
        for w in self._watchers.get(resource, ()):
            w._push_many(evs)

    def _remove_watch(self, resource: str, w: Watch) -> None:
        with self._lock:
            try:
                self._watchers.get(resource, []).remove(w)
            except ValueError:
                pass

    @staticmethod
    def _key(obj_or_ns: Obj | str, nm: str | None = None) -> str:
        if isinstance(obj_or_ns, dict):
            return meta.namespaced_name(obj_or_ns)
        return f"{obj_or_ns}/{nm}" if obj_or_ns else (nm or "")

    @property
    def _logging(self) -> bool:
        """Should mutation sites build commit records?"""
        return self._wal is not None or self._repl is not None

    def _check_fence(self) -> None:
        """Raise on a fenced store (replica.py failover).  Called at the
        top of every write verb; the flag read is GIL-atomic so the
        un-fenced fast path costs one attribute load."""
        if self._fenced:
            raise FencedError(f"store fenced: {self._fence_reason}")

    def fence(self, reason: str) -> None:
        """Stop accepting writes (idempotent).  Reads/watches continue —
        a fenced deposed primary can still serve stale reads while the
        operator or failover logic re-points clients."""
        self._fence_reason = reason
        self._fenced = True

    def _commit(self, recs: list[tuple]) -> None:
        """Route committed mutation records (op, rev, resource, key, obj)
        to the WAL and any attached replication hub, under the store
        lock.  DELETE records carry the tombstone for the hub (follower
        watches need it); the WAL stores only the key.  Tombstones of
        encrypted-at-rest resources are stripped to metadata before they
        leave the process: PUTs ship sealed, and a plaintext delete tomb
        would defeat the envelope exactly once per object."""
        if self._wal is not None:
            self._wal.append_many(
                [r if r[0] == wal_mod.PUT else r[:4] for r in recs])
            self._maybe_compact()
        if self._repl is not None:
            if self._transformers:
                recs = [
                    r if (r[0] == wal_mod.PUT
                          or r[2] not in self._transformers
                          or len(r) < 5 or r[4] is None)
                    else (*r[:4], {"metadata": dict(r[4]["metadata"])})
                    for r in recs]
            self._repl.ship(recs)

    def _maybe_compact(self) -> None:
        """Kick off a snapshot once the log holds enough records that a
        replay would cost more than a snapshot load.  Called under the
        store lock right after an append.  Only the log rotation + a
        2-level state copy happen under the lock; serialization and disk
        writes run on a background thread (objects in the tables are
        immutable by the sharing contract, so the copy stays a consistent
        image of this revision).
        """
        if self._wal.records_since_snapshot < self._compact_every:
            return
        if self._snapshot_thread is not None and self._snapshot_thread.is_alive():
            return  # one snapshot in flight is enough
        rev, image = self._begin_snapshot_locked()
        t = threading.Thread(target=self._wal.finish_snapshot,
                             args=(rev, image), name="store-snapshot",
                             daemon=True)
        self._snapshot_thread = t
        t.start()

    def _begin_snapshot_locked(self) -> tuple[int, dict]:
        self._wal.begin_snapshot()
        return self._rev, {res: dict(tbl) for res, tbl in self._data.items()}

    # -- durability ------------------------------------------------------

    @property
    def durable(self) -> bool:
        return self._wal is not None

    def checkpoint(self) -> None:
        """Force a snapshot now (etcd `snapshot` / compaction); returns
        once it is on disk."""
        if self._wal is None:
            return
        t = None
        with self._lock:
            t = self._snapshot_thread
        if t is not None and t.is_alive():
            t.join()
        with self._lock:
            rev, image = self._begin_snapshot_locked()
        self._wal.finish_snapshot(rev, image)

    def close(self) -> None:
        t = self._snapshot_thread
        if t is not None and t.is_alive():
            t.join()
        with self._lock:
            if self._wal is not None:
                self._wal.close()

    # -- storage.Interface -----------------------------------------------

    @property
    def revision(self) -> int:
        with self._lock:
            return self._rev

    def create(self, resource: str, obj: Obj) -> Obj:
        self._check_fence()
        with self._lock:
            key = meta.namespaced_name(obj)
            table = self._table(resource)
            if key in table:
                raise AlreadyExistsError(f"{resource} {key!r} already exists")
            obj = meta.deep_copy(obj)
            meta.finalize_new(obj)
            self._rev += 1
            meta.set_resource_version(obj, self._rev)
            sealed = self._seal(resource, obj)
            table[key] = sealed
            if self._logging:
                self._commit([(wal_mod.PUT, self._rev, resource, key,
                               sealed)])
            self._emit(resource, ADDED, obj)
            return obj

    def create_many(self, resource: str, objs: list[Obj],
                    copy: bool = True
                    ) -> list[tuple[Obj | None, StoreError | None]]:
        """Bulk create: one lock round trip, per-entry results.  Used by the
        event broadcaster to flush its buffer without taking the store lock
        once per event (the reference's EventBroadcaster batches through a
        single sink goroutine; here the lock is the serialization point).

        copy=False skips the inbound deep copy for callers that hand over
        OWNERSHIP of freshly-built objects they never touch again (the
        event broadcaster); the caller must guarantee no later mutation."""
        self._check_fence()
        out: list[tuple[Obj | None, StoreError | None]] = []
        evs: list[WatchEvent] = []
        recs: list[tuple] = []
        now = time.time()  # one clock read per burst (finalize semantics)
        transform = self._transformers.get(resource)
        with self._lock:
            logging_on = self._logging  # invariant while the lock is held
            table = self._table(resource)
            rev = self._rev
            for obj in objs:
                md = obj["metadata"]
                ns = md.get("namespace", "")
                key = f"{ns}/{md['name']}" if ns else md["name"]
                if key in table:
                    out.append((None, AlreadyExistsError(
                        f"{resource} {key!r} already exists")))
                    continue
                if copy:
                    obj = meta.deep_copy(obj)
                    md = obj["metadata"]
                if not md.get("uid"):
                    md["uid"] = meta.new_uid()
                if not md.get("creationTimestamp"):
                    md["creationTimestamp"] = now
                rev += 1
                md["resourceVersion"] = rev
                sealed = (transform.encrypt_obj(obj)
                          if transform is not None else obj)
                table[key] = sealed
                if logging_on:
                    recs.append((wal_mod.PUT, rev, resource, key, sealed))
                evs.append(WatchEvent(ADDED, obj, rev))
                out.append((obj, None))
            self._rev = rev
            if recs:
                self._commit(recs)
            self._emit_many(resource, evs)
        return out

    def get(self, resource: str, namespace: str, name: str) -> Obj:
        with self._lock:
            table = self._table(resource)
            key = self._key(namespace, name)
            if key not in table:
                raise NotFoundError(f"{resource} {key!r} not found")
            return self._open(resource, table[key])

    def update(self, resource: str, obj: Obj, expect_rv: int | None = None) -> Obj:
        """CAS update: expect_rv defaults to the object's own resourceVersion."""
        self._check_fence()
        with self._lock:
            table = self._table(resource)
            key = meta.namespaced_name(obj)
            if key not in table:
                raise NotFoundError(f"{resource} {key!r} not found")
            cur = table[key]
            want = expect_rv if expect_rv is not None else meta.resource_version(obj)
            if want and want != meta.resource_version(cur):
                raise ConflictError(
                    f"{resource} {key!r}: rv {want} != current {meta.resource_version(cur)}")
            obj = meta.deep_copy(obj)
            obj["metadata"]["uid"] = meta.uid(cur) or meta.uid(obj)
            obj["metadata"].setdefault("creationTimestamp", meta.creation_timestamp(cur))
            self._rev += 1
            meta.set_resource_version(obj, self._rev)
            # deleteWithoutFinalizers: stripping the last finalizer off a
            # terminating object completes its deletion
            if (obj["metadata"].get("deletionTimestamp")
                    and not obj["metadata"].get("finalizers")):
                del table[key]
                if self._logging:
                    self._commit([(wal_mod.DELETE, self._rev, resource,
                                   key, obj)])
                self._emit(resource, DELETED, obj)
                return obj
            sealed = self._seal(resource, obj)
            table[key] = sealed
            if self._logging:
                self._commit([(wal_mod.PUT, self._rev, resource, key,
                               sealed)])
            self._emit(resource, MODIFIED, obj)
            return obj

    def guaranteed_update(self, resource: str, namespace: str, name: str,
                          fn: Callable[[Obj], Obj], max_retries: int = 16) -> Obj:
        """GuaranteedUpdate (etcd3/store.go:331): get -> transform -> CAS, retry on conflict."""
        self._check_fence()
        for _ in range(max_retries):
            cur = self.get(resource, namespace, name)
            updated = fn(meta.deep_copy(cur))
            try:
                return self.update(resource, updated, expect_rv=meta.resource_version(cur))
            except ConflictError:
                continue
        raise ConflictError(f"{resource} {namespace}/{name}: too many CAS retries")

    def delete(self, resource: str, namespace: str, name: str,
               expect_rv: int | None = None) -> Obj:
        self._check_fence()
        with self._lock:
            table = self._table(resource)
            key = self._key(namespace, name)
            if key not in table:
                raise NotFoundError(f"{resource} {key!r} not found")
            cur = table[key]
            if expect_rv is not None and expect_rv != meta.resource_version(cur):
                raise ConflictError(f"{resource} {key!r}: stale delete")
            # finalizer semantics (registry/generic/registry/store.go Delete):
            # an object carrying finalizers is not removed — it gets a
            # deletionTimestamp and stays until a controller strips the last
            # finalizer (the update() path below then really deletes it)
            if cur["metadata"].get("finalizers"):
                if cur["metadata"].get("deletionTimestamp"):
                    return self._open(resource, cur)  # already terminating
                marked = dict(self._open(resource, cur))
                marked["metadata"] = dict(cur["metadata"])
                marked["metadata"]["deletionTimestamp"] = time.time()
                self._rev += 1
                meta.set_resource_version(marked, self._rev)
                sealed = self._seal(resource, marked)
                table[key] = sealed
                if self._logging:
                    self._commit([(wal_mod.PUT, self._rev, resource, key,
                                   sealed)])
                self._emit(resource, MODIFIED, marked)
                return marked
            del table[key]
            self._rev += 1
            # tombstone: shallow copy with fresh metadata (readers may still
            # hold the stored object; never mutate it in place)
            tomb = dict(self._open(resource, cur))
            tomb["metadata"] = dict(cur["metadata"])
            meta.set_resource_version(tomb, self._rev)
            if self._logging:
                self._commit([(wal_mod.DELETE, self._rev, resource, key,
                               tomb)])
            self._emit(resource, DELETED, tomb)
            return tomb

    def bind_many(self, resource: str,
                  bindings: list[tuple]
                  ) -> list[tuple[Obj | None, StoreError | None]]:
        """Bulk Binding write: one lock round trip for a whole TPU batch.

        Each (namespace, name, node_name[, expect_rv]) entry follows
        BindingREST semantics (pkg/registry/core/pod/storage — fail if the
        pod is already bound); results are per-entry so one conflict doesn't
        poison the batch.  The reference has no bulk verb (scheduler binds
        one pod per goroutine); batched assignment makes the 1-write-per-pod
        pattern the bottleneck, so the store grows a transactional
        multi-bind instead.

        Compare-and-bind: an entry whose pod already carries spec.nodeName —
        or, when the optional 4th element expect_rv is given, whose stored
        resourceVersion moved past it — returns a structured BindConflict
        instead of silently double-binding, so N scheduler instances can
        commit optimistically against one shared store and losers detect it.
        """
        self._check_fence()
        out: list[tuple[Obj | None, StoreError | None]] = []
        evs: list[WatchEvent] = []
        recs: list[tuple] = []
        transform = self._transformers.get(resource)
        with self._lock:
            logging_on = self._logging  # invariant while the lock is held
            table = self._table(resource)
            rev = self._rev
            for entry in bindings:
                ns, nm, node = entry[0], entry[1], entry[2]
                expect_rv = entry[3] if len(entry) > 3 else None
                key = f"{ns}/{nm}" if ns else nm
                if not node:
                    # a falsy nodeName would store a bind that every
                    # reader treats as "unbound" — the pod is silently
                    # lost (seen under churn when a caller resolves a
                    # name across a node's in-place removal).  Refuse
                    # loudly; the scheduler's failure path requeues.
                    out.append((None, StoreError(
                        f"bind {key!r}: empty node name refused")))
                    continue
                cur = table.get(key)
                if cur is None:
                    out.append((None, NotFoundError(
                        f"{resource} {key!r} not found")))
                    continue
                if transform is not None:
                    cur = transform.decrypt_obj(cur)
                if (cur.get("spec") or {}).get("nodeName"):
                    bound_to = cur["spec"]["nodeName"]
                    out.append((None, BindConflict(
                        f"pod {key!r} is already bound to {bound_to!r}",
                        key=key, current_node=bound_to, wanted_node=node)))
                    continue
                if expect_rv is not None and \
                        cur["metadata"].get("resourceVersion") != expect_rv:
                    out.append((None, BindConflict(
                        f"pod {key!r} moved past resourceVersion "
                        f"{expect_rv!r} (now "
                        f"{cur['metadata'].get('resourceVersion')!r})",
                        key=key, current_node=None, wanted_node=node)))
                    continue
                # 2-level copy, not deep: only metadata/spec/status own
                # mutated slots; nested values are shared with the prior
                # stored object, which is safe under the read contract
                # (returned objects are never mutated in place — the store
                # itself always writes fresh containers)
                status = cur.get("status") or {}
                rev += 1
                obj = {**cur,
                       "metadata": {**cur["metadata"], "resourceVersion": rev},
                       "spec": {**(cur.get("spec") or {}), "nodeName": node},
                       "status": {**status,
                                  "conditions": list(status.get(
                                      "conditions") or ()) + [
                                      {"type": "PodScheduled",
                                       "status": "True"}]}}
                sealed = (transform.encrypt_obj(obj)
                          if transform is not None else obj)
                table[key] = sealed
                if logging_on:
                    recs.append((wal_mod.PUT, rev, resource, key, sealed))
                evs.append(WatchEvent(MODIFIED, obj, rev))
                out.append((obj, None))
            self._rev = rev
            if recs:
                self._commit(recs)
            self._emit_many(resource, evs)
        return out

    def list(self, resource: str, namespace: str | None = None) -> tuple[list[Obj], int]:
        """GetList (etcd3/store.go:526): returns (items, list revision)."""
        with self._lock:
            table = self._table(resource)
            t = self._transformers.get(resource)
            if namespace:
                prefix = namespace + "/"
                items = [o for k, o in table.items() if k.startswith(prefix)]
            else:
                items = list(table.values())
            if t is not None:  # decrypt only transformed resources
                items = [t.decrypt_obj(o) for o in items]
            return items, self._rev

    def count(self, resource: str) -> int:
        with self._lock:
            return len(self._table(resource))

    def watch(self, resource: str, since_rv: int | None = None) -> Watch:
        """Open a watch delivering every event with revision > since_rv.

        since_rv=None means "from now".  since_rv=0 is a real revision (the
        rv an empty-store list returns) and replays ALL retained history —
        conflating it with "from now" loses events created between a client's
        list and the watch registration.  Raises TooOldError if since_rv
        predates the retained history (client must re-list, reflector.go
        semantics).
        """
        with self._lock:
            w = Watch(self, resource)
            hist = self._history.get(resource)
            if since_rv is not None and since_rv < self._floor:
                # revisions below the floor predate this process (the
                # history ring died with the previous one) — the client
                # cannot be given a complete replay, so it must relist
                raise TooOldError(
                    f"watch {resource} from rv {since_rv}: compacted "
                    f"(recovery floor {self._floor})")
            if since_rv is not None and hist:
                # If the ring is full, events older than hist[0] were dropped;
                # we can only guarantee completeness for since_rv at or past
                # hist[0].revision - 1 (conservative, like etcd compaction).
                if len(hist) == hist.maxlen and since_rv < hist[0].revision - 1:
                    raise TooOldError(f"watch {resource} from rv {since_rv}: compacted")
                for ev in hist:
                    if ev.revision > since_rv:
                        w._push(ev)
            self._watchers.setdefault(resource, []).append(w)
            return w
