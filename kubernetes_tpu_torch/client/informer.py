"""Reflector + shared informer + lister.

Reference semantics:
  staging/src/k8s.io/client-go/tools/cache/reflector.go:256 (ListAndWatch:
    list -> sync handlers -> watch from list rv; on "too old" -> relist)
  tools/cache/shared_informer.go (one informer per resource shared by all
    consumers; handlers receive add/update/delete in event order)
  tools/cache/thread_safe_store.go (indexer) + listers

Differences from the reference, on purpose:
  * No DeltaFIFO: our store's Watch already delivers a linearized, complete
    event stream per resource (same lock that orders writes orders events),
    so the informer thread applies events straight to the indexer and calls
    handlers synchronously on that single thread.  This preserves the only
    property consumers rely on — per-resource events are delivered in order,
    and the indexer is updated before handlers run.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Callable

from ..api import meta
from ..api.meta import Obj
from ..store import kv
from ..utils import fasthost
from .clientset import Client

logger = logging.getLogger(__name__)

EventHandler = Callable[[str, Obj, Obj | None], None]
# signature: (event_type, obj, old_obj_or_None)


class Informer:
    """List+watch one resource into an in-memory indexer; fan out to handlers."""

    def __init__(self, client: Client, resource: str):
        self.client = client
        self.resource = resource
        # _lock guards the indexer for READERS (get/list); _dispatch_lock
        # serializes handler invocation + registration.  Split so readers
        # never wait behind handler execution (the old single lock cost
        # ~20µs of contention per event at bench scale).  Lock order:
        # _dispatch_lock -> _lock, never the reverse.
        self._lock = threading.RLock()
        self._dispatch_lock = threading.RLock()
        self._indexer: dict[str, Obj] = {}  # guarded-by: _lock
        self._handlers: list[EventHandler] = []  # guarded-by: _dispatch_lock
        self._bulk_handlers: list[Callable[[list], None]] = []  # guarded-by: _dispatch_lock
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # relist accounting ({reason: count}, drained into the
        # informer_relist_total counter) + seeded per-informer jitter so
        # every informer's retry clock is decorrelated deterministically
        self._relist_pending: dict[str, int] = {}  # guarded-by: _lock
        self._retry_rng = random.Random(
            hash(resource) & 0xFFFFFFFF)
        # deterministic per-INSTANCE relist offset (scale-out): N
        # processes restarting after an apiserver blip would otherwise
        # thundering-herd it with simultaneous LISTs; the factory sets
        # this to a fixed offset derived from the instance index
        self.relist_stagger = 0.0
        # warm-start seed (prime()): consumed ONCE in place of the first
        # LIST, so a checkpointed restart replays only the watch delta
        # since the checkpoint's resourceVersion.  last_rv tracks the
        # newest revision applied (list rv, then per watch batch) — the
        # value a checkpoint records so the next restart can prime.
        self._warm: tuple[list, int] | None = None
        self.last_rv = 0

    # -- lister ----------------------------------------------------------

    def get(self, namespace: str, name: str) -> Obj | None:
        with self._lock:
            key = f"{namespace}/{name}" if namespace else name
            return self._indexer.get(key)

    def get_by_key(self, key: str) -> Obj | None:
        with self._lock:
            return self._indexer.get(key)

    def list(self, namespace: str | None = None) -> list[Obj]:
        with self._lock:
            if namespace:
                prefix = namespace + "/"
                return [o for k, o in self._indexer.items() if k.startswith(prefix)]
            return list(self._indexer.values())

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._indexer.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._indexer)

    # -- lifecycle -------------------------------------------------------

    def add_event_handler(self, handler: EventHandler) -> None:
        """Register a handler. If already synced, replays adds (shared_informer
        semantics: late handlers get a full resync of existing objects).
        Registration takes the dispatch lock, so it is atomic with respect
        to in-flight events: the handler sees either the replayed state or
        the live event stream from its registration point, never a gap."""
        with self._dispatch_lock:
            self._handlers.append(handler)
            if self._synced.is_set():
                with self._lock:
                    objs = list(self._indexer.values())
                for obj in objs:
                    handler(kv.ADDED, obj, None)

    def add_bulk_event_handler(self, handler: Callable[[list], None]) -> None:
        """Register a BULK handler: called with a list of
        (event_type, obj, old) triples covering a whole watch burst, after
        per-event handlers.  Consumers with per-event lock overhead (the
        scheduler's queue/cache) use this to amortize it; semantics are
        identical to receiving the triples one at a time, in order."""
        with self._dispatch_lock:
            self._bulk_handlers.append(handler)
            if self._synced.is_set():
                with self._lock:
                    objs = list(self._indexer.values())
                if objs:
                    handler([(kv.ADDED, obj, None) for obj in objs])

    def prime(self, objs: list, rv: int) -> None:
        """Warm-start seed: the reflector's next cycle consumes (objs,
        rv) in place of its initial LIST and opens the watch at `rv`, so
        a process restarting from a checkpoint replays only the delta
        since it — deletions included, as ordinary DELETED events.  The
        seed is one-shot: if the watch window at `rv` has been compacted
        (TooOldError) the normal relist recovery does a REAL list, so a
        stale seed costs one extra round trip, never wrong state.  Call
        before start()."""
        self._warm = (list(objs), int(rv))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.resource}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def wait_for_cache_sync(self, timeout: float = 30.0) -> bool:
        return self._synced.wait(timeout)

    @property
    def has_synced(self) -> bool:
        return self._synced.is_set()

    # -- reflector loop --------------------------------------------------

    def _run(self) -> None:
        consecutive_failures = 0
        while not self._stop.is_set():
            try:
                self._list_and_watch()
                consecutive_failures = 0
            except kv.TooOldError:
                # the relist itself recovers the window: no backoff, but
                # the instance stagger still applies — every instance
                # overruns its watch window at the same moment when the
                # store compacts, and N synchronized LISTs is exactly the
                # herd the offset exists to spread
                logger.info("informer %s: watch too old, relisting", self.resource)
                self._tally_relist("too_old")
                consecutive_failures = 0
                if self.relist_stagger:
                    self._stop.wait(self.relist_stagger)
                continue
            except Exception:  # pragma: no cover - defensive, crash-only restart
                # jittered exponential backoff: a down store must not get a
                # synchronized relist storm from every informer the moment
                # it returns (they'd all retry in lockstep on a fixed sleep)
                self._tally_relist("error")
                consecutive_failures += 1
                delay = min(30.0, 1.0 * 2 ** (consecutive_failures - 1))
                delay *= 0.5 + self._retry_rng.random()  # +/-50%
                delay += self.relist_stagger  # deterministic instance offset
                logger.exception("informer %s: list/watch failed, retrying "
                                 "in %.1fs", self.resource, delay)
                self._stop.wait(delay)

    def _tally_relist(self, reason: str) -> None:
        with self._lock:
            self._relist_pending[reason] = (
                self._relist_pending.get(reason, 0) + 1)

    def drain_relist_total(self) -> dict[str, int]:
        """Pop the pending {reason: count} relist tallies (aggregated per
        resource by SharedInformerFactory.drain_relist_total and drained
        into informer_relist_total by Scheduler.expose_metrics)."""
        with self._lock:
            out, self._relist_pending = self._relist_pending, {}
        return out

    def _list_and_watch(self) -> None:
        warm, self._warm = self._warm, None
        if warm is not None:
            items, rv = warm
        else:
            items, rv = self.client.list(self.resource)
        self.last_rv = rv
        fresh = {meta.namespaced_name(o): o for o in items}
        # Each event: indexer update + handler calls under _dispatch_lock
        # (atomic wrt handler registration); the indexer write itself under
        # the narrow _lock so get/list readers never wait behind handler
        # execution (the old single lock cost ~20µs x 2 events/pod).
        with self._dispatch_lock:
            with self._lock:
                old = self._indexer
                self._indexer = fresh
            # Replace semantics: diff old vs new and emit synthetic events
            # (DeltaFIFO Replace -> Sync/Delete).
            triples = []
            for key, obj in fresh.items():
                prev = old.get(key)
                if prev is None:
                    triples.append((kv.ADDED, obj, None))
                elif meta.resource_version(prev) != meta.resource_version(obj):
                    triples.append((kv.MODIFIED, obj, prev))
            for key, prev in old.items():
                if key not in fresh:
                    triples.append((kv.DELETED, prev, None))
            self._dispatch_all(triples)
            self._synced.set()  # inside the lock: registration either
            # replays this state or receives the live stream — no gap

        w = self.client.watch(self.resource, since_rv=rv)
        try:
            while not self._stop.is_set():
                evs = w.next_batch(timeout=0.5)
                if not evs:
                    if w.stopped:
                        return
                    continue
                # apply the whole burst to the indexer under ONE lock
                # acquisition, then dispatch; per-resource ordering is
                # preserved (single informer thread, in-order drain).
                # The apply itself is one fasthost C pass when built
                # (pure-Python fallback is the identical loop).
                with self._dispatch_lock:
                    with self._lock:
                        triples = fasthost.watch_apply(evs, self._indexer)
                    self.last_rv = evs[-1].revision
                    self._dispatch_all(triples)
        finally:
            w.stop()

    def _dispatch_all(self, triples: list) -> None:
        """Run per-event handlers event-by-event, then bulk handlers once.
        Caller holds _dispatch_lock."""
        if not triples:
            return
        for type_, obj, old in triples:
            for h in self._handlers:
                try:
                    h(type_, obj, old)
                except Exception:  # pragma: no cover
                    logger.exception("informer %s: handler error on %s",
                                     self.resource, type_)
        for bh in self._bulk_handlers:
            try:
                bh(triples)
            except Exception:  # pragma: no cover
                logger.exception("informer %s: bulk handler error",
                                 self.resource)

    def _dispatch(self, type_: str, obj: Obj, old: Obj | None) -> None:
        for h in self._handlers:
            try:
                h(type_, obj, old)
            except Exception:  # pragma: no cover
                logger.exception("informer %s: handler error on %s", self.resource, type_)


class SharedInformerFactory:
    """One Informer per resource, shared (client-go informers.SharedInformerFactory)."""

    def __init__(self, client: Client):
        self.client = client
        self._lock = threading.Lock()
        self._informers: dict[str, Informer] = {}
        self._started = False
        self._relist_stagger = 0.0

    def set_relist_stagger(self, offset: float) -> None:
        """Set the deterministic relist offset (seconds) on every
        informer, existing and future — wired from the scaleOut: stanza
        as a fixed function of the instance index so N processes never
        relist in lockstep."""
        with self._lock:
            self._relist_stagger = max(0.0, offset)
            informers = list(self._informers.values())
        for inf in informers:
            inf.relist_stagger = self._relist_stagger

    def informer(self, resource: str) -> Informer:
        with self._lock:
            inf = self._informers.get(resource)
            if inf is None:
                inf = self._informers[resource] = Informer(self.client, resource)
                inf.relist_stagger = self._relist_stagger
                if self._started:
                    # factory already running: late informers start eagerly
                    # (client-go restarts the factory; we just start the one)
                    inf.start()
            return inf

    def start(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
            self._started = True
        for inf in informers:
            inf.start()

    def wait_for_cache_sync(self, timeout: float = 30.0) -> bool:
        with self._lock:
            informers = list(self._informers.values())
        return all(inf.wait_for_cache_sync(timeout) for inf in informers)

    def stop(self) -> None:
        with self._lock:
            informers = list(self._informers.values())
        for inf in informers:
            inf.stop()

    def drain_relist_total(self) -> dict[tuple[str, str], int]:
        """Pop {(resource, reason): count} relist tallies across every
        informer (feeds the informer_relist_total counter)."""
        with self._lock:
            informers = list(self._informers.items())
        out: dict[tuple[str, str], int] = {}
        for resource, inf in informers:
            for reason, n in inf.drain_relist_total().items():
                key = (resource, reason)
                out[key] = out.get(key, 0) + n
        return out
