"""Client interface to the API.

Reference: staging/src/k8s.io/client-go (typed clientset).  Two
implementations share one interface:

  LocalClient - in-process, directly over store.MemoryStore.  This is what
      integration tests and scheduler_perf use (the reference does the same:
      its integration harness runs an in-process apiserver,
      test/integration/framework/test_server.go:62).
  HTTPClient  - over the REST apiserver (apiserver/server.py), for
      multi-process deployments.  (added by apiserver module)

All methods deal in JSON-shaped dict objects (api.meta.Obj).
"""

from __future__ import annotations

from typing import Callable

from ..api import meta
from ..api.meta import Obj
from ..store import kv
from ..store.kv import MemoryStore, NotFoundError, Watch

# Canonical resource names (plural, lowercase — like REST paths).
PODS = "pods"
NODES = "nodes"
SERVICES = "services"
ENDPOINTS = "endpoints"
EVENTS = "events"
LEASES = "leases"
REPLICASETS = "replicasets"
DEPLOYMENTS = "deployments"
JOBS = "jobs"
NAMESPACES = "namespaces"
CONFIGMAPS = "configmaps"
SECRETS = "secrets"
PVCS = "persistentvolumeclaims"
PVS = "persistentvolumes"
PDBS = "poddisruptionbudgets"
PODGROUPS = "podgroups"
STATEFULSETS = "statefulsets"
DAEMONSETS = "daemonsets"
REPLICATIONCONTROLLERS = "replicationcontrollers"
PRIORITYCLASSES = "priorityclasses"
STORAGECLASSES = "storageclasses"
CSINODES = "csinodes"
CRONJOBS = "cronjobs"
RESOURCEQUOTAS = "resourcequotas"
SERVICEACCOUNTS = "serviceaccounts"
LIMITRANGES = "limitranges"
HPAS = "horizontalpodautoscalers"
ENDPOINTSLICES = "endpointslices"
CSRS = "certificatesigningrequests"
VOLUMEATTACHMENTS = "volumeattachments"
ROLES = "roles"
CLUSTERROLES = "clusterroles"
ROLEBINDINGS = "rolebindings"
CLUSTERROLEBINDINGS = "clusterrolebindings"

# the ONE cluster-scoped set: REST routing (apiserver/server.py) and client
# path building (http_client.py) both key off it — divergence routes writes
# to the wrong key (tests/test_verify_static.py guards the sharing)
CLUSTER_SCOPED_RESOURCES = frozenset({
    NODES, PVS, NAMESPACES, PRIORITYCLASSES, STORAGECLASSES, CSINODES,
    CSRS, VOLUMEATTACHMENTS, CLUSTERROLES, CLUSTERROLEBINDINGS,
    "apiservices", "customresourcedefinitions", "storageversions",
    "flowschemas", "prioritylevelconfigurations",
})


class Client:
    """Abstract client; see LocalClient."""

    def create(self, resource: str, obj: Obj) -> Obj:
        raise NotImplementedError

    def get(self, resource: str, namespace: str, name: str) -> Obj:
        raise NotImplementedError

    def update(self, resource: str, obj: Obj) -> Obj:
        raise NotImplementedError

    def guaranteed_update(self, resource: str, namespace: str, name: str,
                          fn: Callable[[Obj], Obj]) -> Obj:
        raise NotImplementedError

    def delete(self, resource: str, namespace: str, name: str) -> Obj:
        raise NotImplementedError

    def list(self, resource: str, namespace: str | None = None) -> tuple[list[Obj], int]:
        raise NotImplementedError

    def watch(self, resource: str, since_rv: int | None = None) -> Watch:
        raise NotImplementedError

    # -- conveniences used across the tree --------------------------------

    def bind(self, pod: Obj, node_name: str,
             expect_rv: int | None = None) -> Obj:
        """POST pods/{name}/binding equivalent: set spec.nodeName atomically.

        Reference: pkg/registry/core/pod/storage BindingREST — fails if the
        pod is already bound (the scheduler relies on this for correctness
        under races).  With N scheduler instances committing optimistically
        against one store, losing that race raises a structured BindConflict
        (kv.py) naming the current owner; the optional expect_rv tightens
        the precondition to compare-and-bind on the pod's resourceVersion.
        """
        ns, nm = meta.namespace(pod), meta.name(pod)
        if not node_name:
            # an empty nodeName stores as "unbound" to every reader: the
            # pod would be silently lost.  Same guard as the store's
            # bulk bind_many — refuse loudly so the caller requeues.
            raise kv.StoreError(f"bind {ns}/{nm}: empty node name refused")

        def apply(cur: Obj) -> Obj:
            if cur["spec"].get("nodeName"):
                bound_to = cur["spec"]["nodeName"]
                raise kv.BindConflict(
                    f"pod {ns}/{nm} is already bound to {bound_to!r}",
                    key=f"{ns}/{nm}" if ns else nm,
                    current_node=bound_to, wanted_node=node_name)
            if expect_rv is not None and \
                    cur["metadata"].get("resourceVersion") != expect_rv:
                raise kv.BindConflict(
                    f"pod {ns}/{nm} moved past resourceVersion "
                    f"{expect_rv!r}",
                    key=f"{ns}/{nm}" if ns else nm,
                    current_node=None, wanted_node=node_name)
            cur["spec"]["nodeName"] = node_name
            conds = cur.setdefault("status", {}).setdefault("conditions", [])
            conds.append({"type": "PodScheduled", "status": "True"})
            return cur

        return self.guaranteed_update(PODS, ns, nm, apply)

    def bind_many(self, bindings: list[tuple]
                  ) -> list[tuple[Obj | None, Exception | None]]:
        """Bulk bind: (namespace, name, node_name[, expect_rv]) entries,
        per-entry results.  Generic clients fall back to per-pod bind();
        LocalClient uses the store's transactional multi-bind.  Entries that
        lose the optimistic bind race come back as kv.BindConflict."""
        out: list[tuple[Obj | None, Exception | None]] = []
        for entry in bindings:
            ns, nm, node = entry[0], entry[1], entry[2]
            expect_rv = entry[3] if len(entry) > 3 else None
            try:
                out.append((self.bind({"metadata": {"namespace": ns,
                                                    "name": nm}}, node,
                                      expect_rv=expect_rv), None))
            except Exception as e:
                # per-entry, and not just StoreError: one pod's transport
                # blip must not abort the rest of the batch — the caller
                # classifies each entry on its own
                out.append((None, e))
        return out

    def update_status(self, resource: str, obj: Obj) -> Obj:
        """Status-subresource write: merge .status only."""
        status = obj.get("status") or {}

        def apply(cur: Obj) -> Obj:
            cur["status"] = status
            return cur

        return self.guaranteed_update(resource, meta.namespace(obj), meta.name(obj), apply)

    # EventAggregator semantics (client-go record/events_cache.go:60-120):
    # more than maxEvents "similar" events (same involved kind/ns/reason/
    # type — everything but name+message) inside maxIntervalInSeconds get
    # collapsed into ONE aggregate record whose count bumps.  At bench
    # scale this is also the perf contract: 50k binds emit 50k Scheduled
    # events that collapse into aggregate count bumps, not 50k writes.
    EVENT_AGGREGATE_MAX = 10          # record.defaultAggregateMaxEvents
    EVENT_AGGREGATE_WINDOW = 600.0    # defaultAggregateIntervalInSeconds

    def create_event(self, regarding: Obj, reason: str, message: str,
                     type_: str = "Normal") -> None:
        """Fire-and-forget Event via a background broadcaster thread
        (reference: record.EventBroadcaster buffers and writes async; events
        must never sit on the scheduling/binding critical path).  Overflow
        drops events, like the broadcaster's bounded queue.  Only a compact
        tuple is built here — dict construction, correlation and the store
        write all happen on the broadcaster thread."""
        md = regarding["metadata"]
        self._event_sink((regarding.get("kind"), md.get("namespace", ""),
                          md["name"], md.get("uid", ""), reason, message,
                          type_))

    def create_event_burst(self, items: list[tuple[Obj, str, str]]) -> None:
        """create_event for a whole batch with ONE queue round:
        (regarding, reason, message) triples.  The bulk bind tail emits
        one Scheduled event per pod — per-pod create_event costs ~7µs of
        binder-thread time each at 100k-tier scale; the burst enqueue is
        one deque.extend."""
        recs = []
        for regarding, reason, message in items:
            md = regarding["metadata"]
            recs.append((regarding.get("kind"), md.get("namespace", ""),
                         md["name"], md.get("uid", ""), reason, message,
                         "Normal"))
        self._event_sink_many(recs)

    def _event_sink_many(self, recs: list[tuple]) -> None:
        if not recs:
            return
        q = getattr(self, "_event_queue", None)
        if q is None:
            self._event_sink(recs[0])  # starts the broadcaster thread
            recs = recs[1:]
            q = self._event_queue
            if q is None or not recs:  # racing close()
                return
        room = self.EVENT_BUF_MAX - len(q)
        if room > 0:
            q.extend(recs[:room])
            # racing producers can overshoot the cap by up to one burst
            # each (room was read non-atomically); shed our own newest
            # records so the bounded-queue contract holds
            while len(q) > self.EVENT_BUF_MAX:
                try:
                    q.pop()
                except IndexError:  # pragma: no cover - consumer drained
                    break
            wake = self._event_wake
            if not wake.is_set():
                wake.set()

    _event_init_lock = __import__("threading").Lock()

    EVENT_BUF_MAX = 50_000

    def _event_sink(self, rec: tuple) -> None:
        import threading
        from collections import deque
        q = getattr(self, "_event_queue", None)
        if q is None:
            with Client._event_init_lock:
                q = getattr(self, "_event_queue", None)
                if q is None:
                    q = deque()
                    self._event_wake = threading.Event()
                    t = threading.Thread(target=self._event_drain_loop,
                                         args=(q, self._event_wake),
                                         name="event-broadcaster",
                                         daemon=True)
                    t.start()
                    self._event_thread = t
                    self._event_queue = q
        # lock-free enqueue: deque.append is GIL-atomic (a queue.Queue's
        # mutex cost ~1µs per event on the binder hot path); overflow
        # drops, like the reference broadcaster's bounded channel.  The
        # LOCAL q: close() may null _event_queue concurrently (an event
        # racing close lands in the drained queue = dropped).
        if len(q) < self.EVENT_BUF_MAX:
            q.append(rec)
            wake = self._event_wake
            if not wake.is_set():
                wake.set()

    def _event_drain_loop(self, q, wake) -> None:
        """Broadcaster thread: drain compact records in chunks, correlate
        (aggregate beyond the similar-events threshold), flush one bulk
        create for individual events + one count-bump write per aggregate
        key per chunk."""
        import time as _t
        # key -> [count, window_start, aggregate_name_or_None]
        corr: dict[tuple, list] = {}
        while True:
            if not q:
                wake.wait(0.2)
            wake.clear()
            chunk = []
            try:
                while len(chunk) < 4096:
                    chunk.append(q.popleft())
            except IndexError:
                pass
            if not chunk:
                continue
            stop = None in chunk  # close() sentinel
            now = _t.time()
            fresh: list[Obj] = []
            bumps: dict[tuple, tuple[int, tuple]] = {}  # key -> (delta, rec)
            for rec in chunk:
                if rec is None:
                    continue
                kind, ns, nm, uid, reason, message, type_ = rec
                key = (kind, ns, reason, type_)
                st = corr.get(key)
                if st is None or now - st[1] > self.EVENT_AGGREGATE_WINDOW:
                    st = corr[key] = [0, now, None]
                st[0] += 1
                if st[0] <= self.EVENT_AGGREGATE_MAX:
                    fresh.append(self._build_event(rec, now))
                else:
                    delta, _ = bumps.get(key, (0, rec))
                    bumps[key] = (delta + 1, rec)
            try:
                if fresh:
                    self.create_events(fresh)
                for key, (delta, rec) in bumps.items():
                    self._bump_aggregate(corr[key], key, rec, delta, now)
            except kv.StoreError:
                pass
            if stop:
                return

    @staticmethod
    def _build_event(rec: tuple, now: float) -> Obj:
        kind, ns, nm, uid, reason, message, type_ = rec
        return {"apiVersion": "v1", "kind": "Event",
                "metadata": {"name": f"{nm}.{int(now * 1e6):x}",
                             "namespace": ns or "default"},
                "type": type_, "reason": reason, "message": message,
                "count": 1,
                "involvedObject": {"kind": kind, "namespace": ns,
                                   "name": nm, "uid": uid}}

    def _bump_aggregate(self, st: list, key: tuple, rec: tuple, delta: int,
                        now: float) -> None:
        """Write/bump the aggregate record for a similar-events key
        (events_cache.go EventAggregate: '(combined from similar events)')."""
        kind, ns, nm, uid, reason, message, type_ = rec
        ns_eff = ns or "default"
        if st[2] is None:
            agg = self._build_event(rec, now)
            agg["message"] = f"(combined from similar events): {message}"
            agg["count"] = self.EVENT_AGGREGATE_MAX + delta
            st[2] = agg["metadata"]["name"]
            try:
                self.create(EVENTS, agg)
                return
            except kv.StoreError:
                st[2] = None
                return
        name = st[2]

        def bump(cur: Obj) -> Obj:
            cur["count"] = int(cur.get("count", 1)) + delta
            cur["message"] = f"(combined from similar events): {message}"
            return cur

        try:
            self.guaranteed_update(EVENTS, ns_eff, name, bump)
        except kv.StoreError:
            st[2] = None  # aggregate evaporated (GC'd): recreate next time

    def close(self) -> None:
        """Stop the event-broadcaster thread, flushing buffered events
        (joins the drain thread so the flush completes before return;
        the broadcaster restarts lazily if events are recorded later)."""
        q = getattr(self, "_event_queue", None)
        t = getattr(self, "_event_thread", None)
        if q is None:
            return
        self._event_queue = None  # next create_event restarts the thread
        q.append(None)  # close sentinel
        self._event_wake.set()
        if t is not None:
            t.join(timeout=5.0)

    def create_events(self, events: list[Obj]) -> None:
        """Write a burst of Events. Generic clients write one by one;
        LocalClient uses the store's bulk create."""
        for ev in events:
            try:
                self.create(EVENTS, ev)
            except kv.StoreError:
                pass


class LocalClient(Client):
    """Direct in-process client over a MemoryStore."""

    def __init__(self, store: MemoryStore):
        self.store = store

    def create(self, resource: str, obj: Obj) -> Obj:
        return self.store.create(resource, obj)

    def get(self, resource: str, namespace: str, name: str) -> Obj:
        return self.store.get(resource, namespace, name)

    def update(self, resource: str, obj: Obj) -> Obj:
        return self.store.update(resource, obj)

    def guaranteed_update(self, resource: str, namespace: str, name: str,
                          fn: Callable[[Obj], Obj]) -> Obj:
        return self.store.guaranteed_update(resource, namespace, name, fn)

    def delete(self, resource: str, namespace: str, name: str,
               propagation_policy: str | None = None) -> Obj:
        fin = meta.propagation_finalizer(propagation_policy)
        if fin is not None:
            def park(cur, fin=fin):
                fins = cur["metadata"].setdefault("finalizers", [])
                if fin not in fins:
                    fins.append(fin)
                return cur
            self.store.guaranteed_update(resource, namespace, name, park)
        return self.store.delete(resource, namespace, name)

    def apply(self, resource: str, obj: Obj, field_manager: str,
              force: bool = False) -> Obj:
        """Server-side apply (managedfields.py semantics, in process)."""
        from ..apiserver import managedfields as mf
        ns, nm = obj["metadata"].get("namespace", ""), obj["metadata"]["name"]

        def merge(cur):
            new = mf.apply_merge(cur, obj, field_manager, force=force)
            new["metadata"]["resourceVersion"] = \
                cur["metadata"].get("resourceVersion")
            return new

        for _ in range(2):
            try:
                return self.store.guaranteed_update(resource, ns, nm, merge)
            except NotFoundError:
                pass
            try:
                return self.store.create(
                    resource, mf.apply_merge(None, obj, field_manager))
            except kv.AlreadyExistsError:
                continue  # lost the create race: merge with the winner
        return self.store.guaranteed_update(resource, ns, nm, merge)

    def list(self, resource: str, namespace: str | None = None) -> tuple[list[Obj], int]:
        return self.store.list(resource, namespace)

    def watch(self, resource: str, since_rv: int | None = None) -> Watch:
        return self.store.watch(resource, since_rv)

    def bind_many(self, bindings: list[tuple[str, str, str]]
                  ) -> list[tuple[Obj | None, Exception | None]]:
        return self.store.bind_many(PODS, bindings)

    def create_events(self, events: list[Obj]) -> None:
        # broadcaster-owned objects, never touched after the flush:
        # ownership transfer, no inbound copy
        self.store.create_many(EVENTS, events, copy=False)

    def create_bulk(self, resource: str, objs: list[Obj]) -> None:
        """Bulk object submission (perf-harness transport analog of the
        reference's 5000-QPS burst client, util.go:92).  Ownership
        transfer: the caller must not touch the objects after this call
        (copy=False).  Raises on the first error — harness payloads are
        generated, not user input."""
        for obj, err in self.store.create_many(resource, objs, copy=False):
            if err is not None:
                raise err
