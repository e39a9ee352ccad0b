"""Horizontal scale-out: partition assignment + instance liveness for N
cooperating scheduler instances over one shared store.

A copy of kubernetes_tpu/scheduler/scaleout.py (host code, its logic
unchanged): the same policies, keys, lease tables and clock give
the same ownership answers and the same Lease objects in the store
(tests/test_torch_scaleout.py holds the two against each other).  One
addition: start_heartbeat / stop_heartbeat renew the instance's Lease
from a thread of its own while its scheduling loop runs (below, "Lease
renewal").

Design lineage is Omega-style shared-state scheduling: every instance
runs the full pipeline (informers, cache, queue, device backend) against
one store and commits binds optimistically — the compare-and-bind
precondition in the store (kv.bind_many) is what prevents double-binds,
and a structured kv.BindConflict tells the loser to Forget and requeue.
Partitioning therefore only exists to keep the conflict rate near zero:
it routes work, it does not enforce correctness.

Partitioning (ScaleOutPolicy, scheduler/config.py `scaleOut:` stanza):

  nodePoolRing (default)   node names AND pod keys hash (crc32, stable
                           across processes) onto `ring_slices` virtual
                           slices; slice s belongs to instance
                           s % instance_count.  When that home instance
                           is dead, the slice falls back to the live
                           instance at s % len(live) — every survivor
                           computes the same map from the same lease
                           table, no coordination round.
  namespaceHash (fallback) pods partition by namespace hash; every
                           instance sees all nodes.  For clusters whose
                           node names hash unevenly or that want
                           namespace affinity to instance-local caches.

Liveness rides the store, the same seam replication fencing uses
(the JAX package's store/replica.py; not in this package yet, ROADMAP
item 10b): each instance renews a Lease object under
kube-system every renew_interval; a lease unrenewed for lease_duration
marks the instance dead and its slices are absorbed by survivors on
their next sweep.  An instance that loses its own lease (partitioned,
suspended, or fenced by a store failover) flips self_live to False and
the scheduler stops committing binds — its in-flight batch lands in the
backoff tiers, never on a node a peer now owns.

Lease renewal.  The JAX package renews only from tick(), on the
scheduling loop.  With N instances in one process at 100,000 nodes a
loop iteration can outlast the 2 s lease (on an H100 host, two ticks of
one loop 5.4 s apart while the node flood arrived, and a resync 2.5-7.3
s): the first instance to tick again declares its peers dead,
absorbs their slices past its backend's node capacity, and its batches
fall to the per-pod path.  Here the Scheduler, while its loop runs,
also renews from start_heartbeat's thread, as client-go's LeaderElector
renews from a goroutine of its own; sweeps, resyncs and the bind fence
stay on the loop, and a retired instance stops renewing as before.
The thread renews only while the loop has ticked within
LOOP_STALL_LEASES lease durations (renew_off_loop).  The trade-off
against the JAX package: a loop that hangs keeps its lease for that
window after its last tick (20 s at the default 2 s lease) and loses
it one lease_duration later, where the JAX instance loses it one
lease_duration after its last tick; until then its ring slices stay
with it and its pending pods wait.

Reference: staging/src/k8s.io/client-go/tools/leaderelection/leaderelection.go
(Lease acquire/renew discipline, here per-instance instead of
single-winner) + pkg/scheduler/schedule_one.go:1023 (the bind
conflict -> Forget -> requeue tail this coordinator's fence protects).
"""

from __future__ import annotations

import threading
import time
import zlib

from ..api.meta import Obj
from ..client.clientset import LEASES
from ..store import kv

LEASE_NAMESPACE = "kube-system"
LEASE_PREFIX = "scheduler-instance-"
# the renewal thread renews only while the loop ticked within this many
# lease durations, so a hung loop still fails over ("Lease renewal")
LOOP_STALL_LEASES = 10


def _slice(key: str, slices: int) -> int:
    """Stable cross-process hash (Python's str hash is salted)."""
    return zlib.crc32(key.encode()) % slices


class ScaleOutCoordinator:
    """One per scheduler instance: ownership queries + lease liveness.

    Ownership queries (owns_pod/owns_node) sit on the informer hot path,
    so membership is kept as an immutable sorted tuple swapped under a
    lock and read without one (GIL-atomic reference read, the same
    discipline as the store's fence flag)."""

    def __init__(self, policy, now_fn=time.time):
        self.policy = policy
        self._now = now_fn
        self._lock = threading.Lock()
        self._live: tuple[int, ...] = tuple(range(policy.instance_count))
        self._retired = False
        self._last_tick = float("-inf")
        self._boot = now_fn()
        self._loop_seen = self._boot  # the last tick() call's now
        self._beat: tuple[threading.Event, threading.Thread] | None = None

    # -- identity ---------------------------------------------------------

    @property
    def index(self) -> int:
        return self.policy.instance_index

    @property
    def live(self) -> tuple[int, ...]:
        return self._live

    @property
    def self_live(self) -> bool:
        """False once this instance retired or lost its lease: the write
        fence for binds (scheduler._bulk_bind_commit checks it)."""
        return not self._retired and self.index in self._live

    # -- ownership --------------------------------------------------------

    def _owner(self, s: int) -> int:
        """Home instance of slice s, falling back round-robin over the
        live membership when the home is dead — minimal-motion: a live
        instance's slices never move, only a dead one's reassign."""
        home = s % self.policy.instance_count
        live = self._live
        if not live or home in live:
            return home
        return live[s % len(live)]

    def owns_pod(self, namespace: str, name: str) -> bool:
        namespace = namespace or "default"  # one normal form, every caller
        if self.policy.partition_by == "namespaceHash":
            key = namespace
        else:
            key = f"{namespace}/{name}"
        return self._owner(_slice(key, self.policy.ring_slices)) == self.index

    def owns_node(self, node_name: str) -> bool:
        if self.policy.partition_by == "namespaceHash":
            return True  # pods partition; the node view is shared
        return self._owner(
            _slice(node_name, self.policy.ring_slices)) == self.index

    # -- membership -------------------------------------------------------

    def set_live(self, indices) -> bool:
        """Install a membership view; True when it changed (the caller
        must then resync ownership — Scheduler._scaleout_resync)."""
        new = tuple(sorted(set(indices)))
        with self._lock:
            changed = new != self._live
            self._live = new
        return changed

    def retire(self) -> None:
        """Stop renewing and stop binding — the instance-kill switch the
        chaos harness flips (a real deployment gets here through lease
        expiry or a store fence)."""
        self._retired = True

    def revive(self) -> None:
        self._retired = False
        self._boot = self._now()  # fresh grace window for our own lease

    # -- lease heartbeat + sweep ------------------------------------------

    def _lease_name(self, index: int) -> str:
        return f"{LEASE_PREFIX}{index}"

    def heartbeat(self, client, now: float) -> None:
        """Renew this instance's Lease (create on first touch)."""
        name = self._lease_name(self.index)
        body = {"kind": "Lease", "apiVersion": "coordination.k8s.io/v1",
                "metadata": {"namespace": LEASE_NAMESPACE, "name": name},
                "spec": {"holderIdentity": str(self.index),
                         "renewTime": now}}
        try:
            client.create(LEASES, body)
        except kv.AlreadyExistsError:
            def renew(cur: Obj) -> Obj:
                cur.setdefault("spec", {})["renewTime"] = now
                cur["spec"]["holderIdentity"] = str(self.index)
                return cur
            client.guaranteed_update(LEASES, LEASE_NAMESPACE, name, renew)

    def sweep(self, client, now: float) -> bool:
        """Recompute the live set from the shared lease table; True when
        membership changed.  An instance whose lease has never appeared
        is granted one lease_duration of boot grace so a cold start is
        not a churn storm."""
        leases, _ = client.list(LEASES, LEASE_NAMESPACE)
        renewed: dict[int, float] = {}
        for lease in leases:
            name = (lease.get("metadata") or {}).get("name", "")
            if not name.startswith(LEASE_PREFIX):
                continue
            try:
                idx = int(name[len(LEASE_PREFIX):])
            except ValueError:
                continue
            renewed[idx] = float(
                (lease.get("spec") or {}).get("renewTime") or 0.0)
        live = []
        for idx in range(self.policy.instance_count):
            seen = renewed.get(idx)
            if seen is None:
                alive = now - self._boot <= self.policy.lease_duration
            else:
                alive = now - seen <= self.policy.lease_duration
            if alive:
                live.append(idx)
        return self.set_live(live)

    def tick(self, client, now: float | None = None) -> bool:
        """Heartbeat + sweep, rate-limited to renew_interval; called from
        the scheduling loop (no extra thread).  Returns True when the
        membership changed and the caller must resync its partition."""
        if now is None:
            now = self._now()
        self._loop_seen = now
        if now - self._last_tick < self.policy.renew_interval:
            return False
        self._last_tick = now
        if not self._retired:
            try:
                self.heartbeat(client, now)
            except (kv.StoreError, OSError):
                # fenced / read-only / partitioned store, or an apiserver
                # mid-handoff (connection refused): we cannot renew, so
                # the sweep below will eventually drop us from live.  An
                # exception here must never kill the scheduling loop —
                # the lease protocol already handles a silent instance.
                pass
        try:
            return self.sweep(client, now)
        except (kv.StoreError, OSError):
            return False

    # -- renewal off the loop (this package's addition) -------------------

    def renew_off_loop(self, client, now: float | None = None) -> bool:
        """The renewal thread's step: renew this instance's Lease unless it
        is retired or its loop has not ticked for LOOP_STALL_LEASES lease
        durations; True when it renewed."""
        if now is None:
            now = self._now()
        stalled = now - self._loop_seen > (LOOP_STALL_LEASES
                                           * self.policy.lease_duration)
        if self._retired or stalled:
            return False
        name = self._lease_name(self.index)
        body = {"kind": "Lease", "apiVersion": "coordination.k8s.io/v1",
                "metadata": {"namespace": LEASE_NAMESPACE, "name": name},
                "spec": {"holderIdentity": str(self.index),
                         "renewTime": now}}
        try:
            # heartbeat's Lease in one store write (an update with no
            # resourceVersion is unconditional): heartbeat's create, get
            # and update wait for the store lock three times, behind the
            # peers' bulk binds
            client.update(LEASES, body)
        except kv.NotFoundError:
            try:
                self.heartbeat(client, now)
            except (kv.StoreError, OSError):
                return False
        except (kv.StoreError, OSError):
            return False  # as in tick: the sweep handles a silent lease
        return True

    def start_heartbeat(self, client) -> None:
        """Call renew_off_loop now and every renew_interval from a thread
        of its own until stop_heartbeat().  The Scheduler starts it with
        its loop, so a loop iteration longer than lease_duration does not
        lapse a live instance.  Idempotent."""
        if self._beat is not None:
            return
        self._loop_seen = self._now()  # the loop starts now
        stop = threading.Event()

        def renew() -> None:
            while True:
                self.renew_off_loop(client)
                if stop.wait(self.policy.renew_interval):
                    return
        t = threading.Thread(target=renew, daemon=True,
                             name=f"scaleout-lease-{self.index}")
        self._beat = (stop, t)
        t.start()

    def stop_heartbeat(self) -> None:
        """Stop the renewal thread (the lease then lapses unless tick()
        renews it); idempotent."""
        beat, self._beat = self._beat, None
        if beat is not None:
            beat[0].set()
            beat[1].join()
