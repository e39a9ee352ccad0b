"""Scheduling queue: activeQ / backoffQ / unschedulablePods.

Reference semantics: pkg/scheduler/internal/queue/scheduling_queue.go
  PriorityQueue (:140-181): three tiers —
    activeQ            heap ordered by the QueueSort plugin (priority, FIFO ties)
    podBackoffQ        heap ordered by backoff expiry
    unschedulablePods  parking lot, re-activated by cluster events that a
                       pod's failed plugins registered for (EventsToRegister)
  flushBackoffQCompleted (:440)  every 1 s
  flushUnschedulablePodsLeftover (:471)  every 30 s, pods parked > 5 min
  MoveAllToActiveOrBackoffQueue + moveRequestCycle race guard: an event that
    arrives while a pod is mid-cycle must not strand it in unschedulable.
  PodNominator: bookkeeping of preemption-nominated pods per node.
  PreEnqueue gating (set_gate): a parked pod the gate holds stays parked
    whatever event or backoff expiry would release it; the flush loop
    re-checks the held pods.

Pop() additionally supports pop_batch(max_n) — the TPU batch path drains up
to K pods at once; this is the only queue-surface addition vs the reference.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Callable, Iterable

from ..api import meta
from ..api.meta import Obj
from .types import ClusterEvent, PodInfo, QueuedPodInfo

DEFAULT_POD_INITIAL_BACKOFF = 1.0     # scheduler.go:188
DEFAULT_POD_MAX_BACKOFF = 10.0        # scheduler.go:193
DEFAULT_UNSCHEDULABLE_TIMEOUT = 300.0  # flushUnschedulablePodsLeftover

# system-cluster-critical / system-node-critical priority floor; pods at or
# above this are in the "system" band and exempt from admission shedding
SYSTEM_PRIORITY_BAND = 2_000_000_000


def default_sort_key(qpi: QueuedPodInfo) -> tuple:
    """PrioritySort plugin order: higher .spec.priority first, then FIFO."""
    return (-qpi.pod_info.priority, qpi.timestamp)


class _Heap:
    """Heap with lazy deletion keyed by pod key (internal/heap/heap.go)."""

    def __init__(self, key_fn: Callable[[QueuedPodInfo], tuple]):
        self._key_fn = key_fn
        self._heap: list[tuple[tuple, int, QueuedPodInfo]] = []
        self._entries: dict[str, QueuedPodInfo] = {}
        self._counter = itertools.count()

    def push(self, qpi: QueuedPodInfo) -> None:
        self._entries[qpi.key] = qpi
        heapq.heappush(self._heap, (self._key_fn(qpi), next(self._counter), qpi))

    def pop(self) -> QueuedPodInfo | None:
        while self._heap:
            _, _, qpi = heapq.heappop(self._heap)
            if self._entries.get(qpi.key) is qpi:
                del self._entries[qpi.key]
                return qpi
        return None

    def peek(self) -> QueuedPodInfo | None:
        while self._heap:
            _, _, qpi = self._heap[0]
            if self._entries.get(qpi.key) is qpi:
                return qpi
            heapq.heappop(self._heap)
        return None

    def remove(self, key: str) -> QueuedPodInfo | None:
        return self._entries.pop(key, None)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def items(self) -> list[QueuedPodInfo]:
        return list(self._entries.values())


class _BucketQueue:
    """Priority-bucketed FIFO active queue — the fast replacement for
    _Heap when the queue-sort is priority-FIFO shaped (PrioritySort /
    default sort): one deque per distinct priority, entries dict for lazy
    deletion.  push/pop are O(1) dict+deque ops instead of O(log n)
    heap churn with a key_fn call per push (~8µs/pod saved at bench
    scale; almost all pods share one priority).

    Ordering note: within a priority the order is INSERTION order.  For
    fresh adds that equals the timestamp order the heap used; a pod
    re-activated from backoff/unschedulable joins at the tail instead of
    jumping ahead of fresher pods by its older park timestamp — the
    reference's activeQ refreshes Timestamp on requeue, which makes
    insertion order the faithful equivalent."""

    def __init__(self) -> None:
        self._buckets: dict[int, deque] = {}
        self._prios: list[int] = []  # heap of active -priority values
        self._entries: dict[str, QueuedPodInfo] = {}

    def push(self, qpi: QueuedPodInfo) -> None:
        self._entries[qpi.key] = qpi
        p = -qpi.pod_info.priority
        d = self._buckets.get(p)
        if d is None:
            d = self._buckets[p] = deque()
            heapq.heappush(self._prios, p)
        d.append(qpi)

    def pop(self) -> QueuedPodInfo | None:
        entries = self._entries
        while self._prios:
            p = self._prios[0]
            d = self._buckets[p]
            while d:
                qpi = d.popleft()
                if entries.get(qpi.key) is qpi:
                    del entries[qpi.key]
                    return qpi
            heapq.heappop(self._prios)
            del self._buckets[p]
        return None

    def peek(self) -> QueuedPodInfo | None:
        entries = self._entries
        while self._prios:
            p = self._prios[0]
            d = self._buckets[p]
            while d:
                qpi = d[0]
                if entries.get(qpi.key) is qpi:
                    return qpi
                d.popleft()
            heapq.heappop(self._prios)
            del self._buckets[p]
        return None

    def remove(self, key: str) -> QueuedPodInfo | None:
        return self._entries.pop(key, None)

    def pop_tail(self) -> QueuedPodInfo | None:
        """Pop the LOWEST-priority, youngest pod — the shed victim order
        for bounded admission.  Walks buckets from the largest -priority
        key (lowest priority) and takes the deque tail (latest insertion).
        Emptied buckets are left in place: their key is still in the
        _prios heap and pop()/peek() retire the pair together."""
        entries = self._entries
        for p in sorted(self._buckets, reverse=True):
            d = self._buckets[p]
            while d:
                qpi = d.pop()
                if entries.get(qpi.key) is qpi:
                    del entries[qpi.key]
                    return qpi
        return None

    def pop_n(self, max_n: int) -> list[QueuedPodInfo]:
        """Drain up to max_n pods in priority/FIFO order.  The full-drain
        case (the TPU batch path's dominant shape: the whole queue fits
        one batch) validates ghosts against the entries dict bucket by
        bucket and retires the dict with ONE clear() instead of a del
        per pod — measurably cheaper at 16k-pod drains."""
        entries = self._entries
        if len(entries) <= max_n:
            out: list[QueuedPodInfo] = []
            while self._prios:
                p = heapq.heappop(self._prios)
                for qpi in self._buckets.pop(p):
                    if entries.get(qpi.key) is qpi:
                        out.append(qpi)
            entries.clear()
            return out
        out = []
        while len(out) < max_n:
            qpi = self.pop()
            if qpi is None:
                break
            out.append(qpi)
        return out

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def items(self) -> list[QueuedPodInfo]:
        return list(self._entries.values())


class PodNominator:
    """Nominated-pod bookkeeping (scheduling_queue.go nominator)."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._node_to_pods: dict[str, dict[str, PodInfo]] = {}
        self._pod_to_node: dict[str, str] = {}

    def add_nominated_pod(self, pi: PodInfo, node_name: str | None = None) -> None:
        node = node_name or pi.nominated_node_name
        if not node:
            return
        with self._lock:
            self.delete_nominated_pod_if_exists(pi.pod)
            self._node_to_pods.setdefault(node, {})[pi.key] = pi
            self._pod_to_node[pi.key] = node

    def delete_nominated_pod_if_exists(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        if key not in self._pod_to_node:
            return  # lock-free precheck: dict reads are GIL-atomic and the
            # hot caller (bulk bind-confirm delete) never nominated the pod
        with self._lock:
            node = self._pod_to_node.pop(key, None)
            if node:
                pods = self._node_to_pods.get(node)
                if pods:
                    pods.pop(key, None)
                    if not pods:
                        del self._node_to_pods[node]

    def nominated_pods_for_node(self, node_name: str) -> list[PodInfo]:
        with self._lock:
            return list(self._node_to_pods.get(node_name, {}).values())

    def all_nominations(self) -> list[tuple[PodInfo, str]]:
        """(pod_info, node_name) for every live nomination — the batched
        preemption path folds these into the device's per-priority-group
        claimed capacity (RunFilterPluginsWithNominatedPods parity)."""
        with self._lock:
            return [(pi, node)
                    for node, pods in self._node_to_pods.items()
                    for pi in pods.values()]


class SchedulingQueue:
    """The 3-tier priority queue."""

    def __init__(
        self,
        sort_key: Callable[[QueuedPodInfo], tuple] = default_sort_key,
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        unschedulable_timeout: float = DEFAULT_UNSCHEDULABLE_TIMEOUT,
        cluster_event_map: dict[str, list[ClusterEvent]] | None = None,
        priority_fifo: bool | None = None,
        queue_cap: int = 0,
        shed_protect_priority: int = 1000,
        shed_protect_age: float = 30.0,
    ):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # priority-FIFO-shaped sorts (the default + PrioritySort) take the
        # O(1) bucket queue; a custom QueueSort keeps the generic heap
        if priority_fifo is None:
            priority_fifo = sort_key is default_sort_key
        # the three tiers move pods between them under one lock; _cond
        # shares it (Condition(self._lock)), so either name proves a
        # mutation site to the lock-discipline rule
        self._active = _BucketQueue() if priority_fifo else _Heap(sort_key)  # guarded-by: _lock|_cond
        self._backoff = _Heap(lambda q: (self._backoff_expiry(q),))  # guarded-by: _lock|_cond
        self._unschedulable: dict[str, QueuedPodInfo] = {}  # guarded-by: _lock|_cond
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff
        self._unschedulable_timeout = unschedulable_timeout
        # plugin name -> events it re-queues on (from EnqueueExtensions)
        self._cluster_event_map = cluster_event_map or {}
        self.nominator = PodNominator()
        self._scheduling_cycle = 0
        self._move_request_cycle = -1
        self._closed = False
        self._flush_thread: threading.Thread | None = None
        # bounded admission (overload: stanza) — 0 = unbounded
        self._queue_cap = queue_cap
        self._shed_protect_priority = shed_protect_priority
        self._shed_protect_age = shed_protect_age
        self._shed_pending: dict[tuple[str, str], int] = {}  # guarded-by: _lock|_cond
        # engagement gate (overload: engagement): when the scheduler's
        # engagement controller drives this queue it parks the cap until
        # the pipeline is actually drowning — the disengaged hot path
        # then costs one attribute read in _shed_over_cap_locked.
        # Default True: a cap set without a controller (tests, legacy
        # `engagement: always`) enforces immediately, as it always has.
        self._overload_engaged = True
        # pre-enqueue gate (set_gate) and the parked pods it holds
        self._gate: Callable[[QueuedPodInfo], bool] | None = None
        self._held: set[str] = set()  # guarded-by: _lock|_cond

    # -- backoff ---------------------------------------------------------

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        d = self._initial_backoff
        for _ in range(qpi.attempts - 1):
            d *= 2
            if d >= self._max_backoff:
                return self._max_backoff
        return d

    def _backoff_expiry(self, qpi: QueuedPodInfo) -> float:
        return qpi.timestamp + self._backoff_duration(qpi)

    def _is_backing_off(self, qpi: QueuedPodInfo) -> bool:
        return qpi.attempts > 0 and self._backoff_expiry(qpi) > time.monotonic()

    # -- pre-enqueue gate ------------------------------------------------

    def set_gate(self, held: Callable[[QueuedPodInfo], bool] | None) -> None:
        """Keep a failed pod parked in unschedulable while held(qpi) is
        true: no event move, backoff expiry or pod update releases it
        (the PreEnqueue point, checked when a pod would leave the parking
        lot).  held runs under the queue lock; the flush loop re-checks
        the held pods every tick."""
        with self._cond:
            self._gate = held

    def _hold_locked(self, qpi: QueuedPodInfo) -> bool:
        """Park qpi if the gate holds it; whether it did.  The caller holds
        the queue lock."""
        if self._gate is None or not self._gate(qpi):
            self._held.discard(qpi.key)
            return False
        self._unschedulable[qpi.key] = qpi
        self._held.add(qpi.key)
        return True

    def _release_held_locked(self) -> bool:
        """Move the held pods the gate now lets go; whether one reached
        activeQ."""
        notified = False
        for key in list(self._held):
            qpi = self._unschedulable.get(key)
            if qpi is None:
                self._held.discard(key)
            elif not self._hold_locked(qpi):
                del self._unschedulable[key]
                if self._is_backing_off(qpi):
                    self._backoff.push(qpi)
                else:
                    self._active.push(qpi)
                    notified = True
        return notified

    # -- bounded admission (overload: stanza) ----------------------------

    def set_overload_policy(self, queue_cap: int,
                            shed_protect_priority: int = 1000,
                            shed_protect_age: float = 30.0) -> None:
        with self._lock:
            self._queue_cap = queue_cap
            self._shed_protect_priority = shed_protect_priority
            self._shed_protect_age = shed_protect_age

    def set_overload_engaged(self, engaged: bool) -> None:
        """Gate bounded admission on the engagement state machine.  While
        False the cap is dormant (adds never shed); flipping True does
        NOT retro-shed — call enforce_cap() for that."""
        with self._lock:
            self._overload_engaged = engaged

    def enforce_cap(self) -> None:
        """One-shot cap enforcement against the CURRENT queue: the
        engagement controller calls this at the disengaged->engaged edge
        so backlog admitted while dormant is shed immediately instead of
        waiting for the next add/event to trip the cap."""
        with self._lock:
            self._shed_over_cap_locked("engaged")

    def _priority_band(self, priority: int) -> str:
        if priority >= SYSTEM_PRIORITY_BAND:
            return "system"
        if priority >= self._shed_protect_priority:
            return "high"
        if priority > 0:
            return "normal"
        return "best_effort"

    def _shed_victim_locked(self) -> QueuedPodInfo | None:
        """Lowest-priority-first, youngest-first-within-priority victim.
        O(1)-ish on the bucket queue; generic heaps take an O(n) scan."""
        pop_tail = getattr(self._active, "pop_tail", None)
        if pop_tail is not None:
            return pop_tail()
        items = self._active.items()
        if not items:
            return None
        victim = min(items, key=lambda q: (q.pod_info.priority, -q.timestamp))
        return self._active.remove(victim.key)

    def _shed_over_cap_locked(self, reason: str) -> None:
        """Shed activeQ down to the cap: move excess pods to the backoff
        tier, lowest priority first.  Shedding is never a drop — the pod
        keeps its initial_attempt_timestamp and re-enters through the
        backoff flush; attempts is bumped so repeat sheds wait out a
        growing backoff instead of hot-looping shed→flush→shed.

        Protection (pods put back untouched, making the cap soft):
          - priority >= shed_protect_priority (system/high band), and
          - pods queued longer than shed_protect_age — which bounds the
            shed loop: every pod's age only grows, so eventual admission
            is guaranteed."""
        cap = self._queue_cap
        if cap <= 0 or not self._overload_engaged:
            return
        excess = len(self._active) - cap
        if excess <= 0:
            return
        now = time.monotonic()
        protected: list[QueuedPodInfo] = []
        for _ in range(excess):
            qpi = self._shed_victim_locked()
            if qpi is None:
                break
            if (qpi.pod_info.priority >= self._shed_protect_priority
                    or now - qpi.initial_attempt_timestamp
                    >= self._shed_protect_age):
                protected.append(qpi)
                continue
            qpi.attempts += 1
            qpi.timestamp = now
            self._backoff.push(qpi)
            band = self._priority_band(qpi.pod_info.priority)
            key = (reason, band)
            self._shed_pending[key] = self._shed_pending.get(key, 0) + 1
        for qpi in protected:
            self._active.push(qpi)

    def drain_shed_total(self) -> dict[tuple[str, str], int]:
        """Drained by Scheduler.expose_metrics into
        scheduler_queue_shed_total{reason,priority_band}."""
        with self._lock:
            out, self._shed_pending = self._shed_pending, {}
        return out

    # -- add/pop ---------------------------------------------------------

    def add(self, pod: Obj) -> None:
        qpi = QueuedPodInfo(PodInfo(pod))
        with self._cond:
            self._backoff.remove(qpi.key)
            self._unschedulable.pop(qpi.key, None)
            self._active.push(qpi)
            self.nominator.add_nominated_pod(qpi.pod_info)
            self._shed_over_cap_locked("admission")
            self._cond.notify()

    def add_many(self, pods: list[Obj]) -> None:
        """Bulk add: PodInfo parsing happens OUTSIDE the lock (it is the
        expensive part), then one locked loop + one wakeup for the burst."""
        qpis = [QueuedPodInfo(PodInfo(p)) for p in pods]
        with self._cond:
            for qpi in qpis:
                self._backoff.remove(qpi.key)
                self._unschedulable.pop(qpi.key, None)
                self._active.push(qpi)
                self.nominator.add_nominated_pod(qpi.pod_info)
            self._shed_over_cap_locked("admission")
            self._cond.notify()

    def delete_many(self, pods: list[Obj]) -> None:
        """Bulk delete (scheduler bind confirmations) under one lock."""
        with self._cond:
            for pod in pods:
                key = meta.namespaced_name(pod)
                self._active.remove(key)
                self._backoff.remove(key)
                self._unschedulable.pop(key, None)
                self.nominator.delete_nominated_pod_if_exists(pod)

    def scheduling_cycle(self) -> int:
        with self._lock:
            return self._scheduling_cycle

    def stats(self) -> dict[str, int]:
        """Queue sizes for the pending_pods{queue=} gauge."""
        with self._lock:
            return {"active": len(self._active),
                    "backoff": len(self._backoff),
                    "unschedulable": len(self._unschedulable)}

    def has(self, pod: Obj) -> bool:
        """Whether the pod sits in ANY tier — the scale-out partition
        resync uses this to avoid re-admitting pods it already holds
        (a duplicate active entry would schedule the pod twice and
        manufacture a self-conflict at bind time)."""
        key = meta.namespaced_name(pod)
        with self._lock:
            return (key in self._active or key in self._backoff
                    or key in self._unschedulable)

    def pop(self, timeout: float | None = None) -> QueuedPodInfo | None:
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not len(self._active) and not self._closed:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._closed and not len(self._active):
                return None
            qpi = self._active.pop()
            if qpi is not None:
                qpi.attempts += 1
                self._scheduling_cycle += 1
            return qpi

    def pop_batch(self, max_n: int, timeout: float | None = None) -> list[QueuedPodInfo]:
        """Drain up to max_n pods for a TPU batch. Blocks for the first pod
        only; the rest are taken non-blocking so latency stays bounded."""
        first = self.pop(timeout)
        if first is None:
            return []
        batch = [first]
        with self._cond:
            pop_n = getattr(self._active, "pop_n", None)
            if pop_n is not None:
                rest = pop_n(max_n - 1)
                for qpi in rest:
                    qpi.attempts += 1
                self._scheduling_cycle += len(rest)
                batch.extend(rest)
            else:
                while len(batch) < max_n:
                    qpi = self._active.pop()
                    if qpi is None:
                        break
                    qpi.attempts += 1
                    self._scheduling_cycle += 1
                    batch.append(qpi)
        return batch

    def requeue_backoff(self, qpis: Iterable[QueuedPodInfo]) -> None:
        """Return a popped batch whose BACKEND failed (remote seam down,
        device lost — see scheduler.BackendUnavailableError) to the backoff
        tier.

        Unlike add_unschedulable_if_not_present this records no per-pod
        failure: the pods were never scheduled against, so they keep their
        unschedulable_plugins and are not parked.  attempts was already
        incremented by pop/pop_batch, so the refreshed timestamp makes each
        pod wait out its exponential backoff before the flush loop moves it
        back to activeQ — a dead seam cannot spin the scheduling loop hot."""
        with self._cond:
            now = time.monotonic()
            for qpi in qpis:
                key = qpi.key
                if (key in self._active or key in self._backoff
                        or key in self._unschedulable):
                    continue  # re-added by an event while the batch was out
                qpi.timestamp = now
                self._backoff.push(qpi)
            # no notify: nothing landed in activeQ (the flush loop promotes
            # pods as their backoff expires)

    def add_unschedulable_if_not_present(self, qpi: QueuedPodInfo,
                                         pod_scheduling_cycle: int) -> None:
        """Park a pod that failed scheduling (scheduling_queue.go:374).

        If a move request raced with this pod's cycle, send it to backoff/
        active instead of the parking lot (the moveRequestCycle guard).
        """
        with self._cond:
            key = qpi.key
            if key in self._active or key in self._backoff or key in self._unschedulable:
                return
            qpi.timestamp = time.monotonic()
            self.nominator.add_nominated_pod(qpi.pod_info)
            if self._hold_locked(qpi):
                return
            if self._move_request_cycle >= pod_scheduling_cycle:
                self._backoff.push(qpi)
            else:
                self._unschedulable[key] = qpi

    def update(self, old: Obj, new: Obj) -> None:
        """Pod updated while pending: refresh in place; an update that could
        make it schedulable moves it out of unschedulable (simplified
        updatePodMayBeMakeSchedulable)."""
        key = meta.namespaced_name(new)
        with self._cond:
            qpi = self._unschedulable.get(key)
            if qpi is not None:
                qpi.pod_info.update(new)
                if self._hold_locked(qpi):
                    return
                del self._unschedulable[key]
                if self._is_backing_off(qpi):
                    self._backoff.push(qpi)
                else:
                    self._active.push(qpi)
                    self._cond.notify()
                return
            if key in self._active:
                q = self._active.remove(key)
                q.pod_info.update(new)
                self._active.push(q)
            elif key in self._backoff:
                q = self._backoff.remove(key)
                q.pod_info.update(new)
                self._backoff.push(q)

    def delete(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        with self._cond:
            self._active.remove(key)
            self._backoff.remove(key)
            self._unschedulable.pop(key, None)
            self._held.discard(key)
            self.nominator.delete_nominated_pod_if_exists(pod)

    # -- event-driven requeue -------------------------------------------

    def _pod_matches_event(self, qpi: QueuedPodInfo, event: ClusterEvent) -> bool:
        if event == ClusterEvent("*", "*"):
            return True
        if not qpi.unschedulable_plugins:
            return True
        for plugin in qpi.unschedulable_plugins:
            for ev in self._cluster_event_map.get(plugin, ()):
                if ev.match(event):
                    return True
        return False

    def move_all_to_active_or_backoff(self, event: ClusterEvent) -> None:
        """MoveAllToActiveOrBackoffQueue: cluster changed — unpark pods whose
        failure could be resolved by `event`."""
        with self._cond:
            moved = []
            for key, qpi in list(self._unschedulable.items()):
                if (self._pod_matches_event(qpi, event)
                        and not self._hold_locked(qpi)):
                    moved.append(key)
                    if self._is_backing_off(qpi):
                        self._backoff.push(qpi)
                    else:
                        self._active.push(qpi)
            for key in moved:
                del self._unschedulable[key]
            self._move_request_cycle = self._scheduling_cycle
            if moved:
                self._shed_over_cap_locked("event_move")
                self._cond.notify_all()

    def assigned_pod_added(self, pod: Obj) -> None:
        """A pod got bound: affinity-failed pods may now fit (simplified
        AssignedPodAdded — we move pods failed on InterPodAffinity)."""
        self.move_all_to_active_or_backoff(ClusterEvent("AssignedPod", "Add"))

    # -- flush loops (Run, :298) ----------------------------------------

    def run(self) -> None:
        if self._flush_thread is not None:
            return
        self._flush_thread = threading.Thread(
            target=self._flush_loop, name="queue-flush", daemon=True)
        self._flush_thread.start()

    def _flush_loop(self) -> None:
        last_unsched_flush = time.monotonic()
        while not self._closed:
            time.sleep(0.2)  # reference: 1s backoff flush; we poll faster
            with self._cond:
                now = time.monotonic()
                notified = False
                while True:
                    head = self._backoff.peek()
                    if head is None or self._backoff_expiry(head) > now:
                        break
                    qpi = self._backoff.pop()
                    if not self._hold_locked(qpi):
                        self._active.push(qpi)
                        notified = True
                notified |= self._release_held_locked()
                if now - last_unsched_flush > 5.0:
                    last_unsched_flush = now
                    for key, qpi in list(self._unschedulable.items()):
                        if now - qpi.timestamp > self._unschedulable_timeout:
                            del self._unschedulable[key]
                            self._held.discard(key)
                            if self._is_backing_off(qpi):
                                self._backoff.push(qpi)
                            else:
                                self._active.push(qpi)
                                notified = True
                if notified:
                    self._shed_over_cap_locked("backoff_promotion")
                    self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- introspection ---------------------------------------------------

    def pending_pods(self) -> tuple[list[Obj], str]:
        with self._lock:
            active = [q.pod for q in self._active.items()]
            backoff = [q.pod for q in self._backoff.items()]
            unsched = [q.pod for q in self._unschedulable.values()]
        summary = (f"activeQ:{len(active)} backoffQ:{len(backoff)} "
                   f"unschedulable:{len(unsched)}")
        return active + backoff + unsched, summary
