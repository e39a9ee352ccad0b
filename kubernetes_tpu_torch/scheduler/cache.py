"""Scheduler cache: authoritative in-memory cluster mirror with the
assume/confirm lifecycle and incremental snapshotting.

Reference semantics:
  pkg/scheduler/internal/cache/interface.go:59-104 (Cache contract)
  pkg/scheduler/internal/cache/cache.go:197 (UpdateSnapshot: generation-based
    delta copy — only NodeInfos whose generation advanced since the last
    snapshot are re-cloned)
  pkg/scheduler/internal/cache/snapshot.go:29-43 (Snapshot: ordered node list
    + affinity sublists + usedPVCSet; implements SharedLister)

The assume/confirm protocol is what lets scheduling run ahead of the
apiserver: `assume` optimistically adds the pod to the target node before the
Binding write lands; the informer's Add event later *confirms* it; `forget`
rolls it back on bind failure.  The TPU batch path relies on this exactly as
the per-pod path does — each assignment out of a batch is assumed
individually so failure handling stays per-pod.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterable

from ..api import meta
from ..api.meta import Obj
from .types import NodeInfo, PodInfo, _generation

logger = logging.getLogger(__name__)


class Snapshot:
    """Immutable per-cycle view of the cluster (snapshot.go:29).

    `generation` is the max NodeInfo generation included; UpdateSnapshot uses
    it to copy only dirty nodes.  The TPU flattener keys its dirty-row
    re-encode off per-node generations too (ops/flatten.py).
    """

    def __init__(self) -> None:
        self.node_info_map: dict[str, NodeInfo] = {}
        self.node_info_list: list[NodeInfo] = []
        self.have_pods_with_affinity_list: list[NodeInfo] = []
        self.have_pods_with_required_anti_affinity_list: list[NodeInfo] = []
        self.used_pvc_set: set[str] = set()
        self.generation: int = 0

    # SharedLister surface (framework.SharedLister)
    def get(self, node_name: str) -> NodeInfo | None:
        return self.node_info_map.get(node_name)

    def list(self) -> list[NodeInfo]:
        return self.node_info_list

    def __len__(self) -> int:
        return len(self.node_info_list)


class _PodState:
    __slots__ = ("pod", "assumed", "binding_finished", "deadline")

    def __init__(self, pod: Obj, assumed: bool = False):
        self.pod = pod
        self.assumed = assumed
        self.binding_finished = False
        self.deadline: float | None = None


class Cache:
    """scheduler cache (cache.go)."""

    def __init__(self, ttl: float = 0.0):
        self._lock = threading.RLock()
        self._nodes: dict[str, NodeInfo] = {}
        self._pod_states: dict[str, _PodState] = {}
        self._assumed_pods: set[str] = set()
        self._ttl = ttl  # 0 = assumed pods never expire (reference default, scheduler.go:54)
        # Bumped on every mutation the TPU batch backend does NOT already
        # know about (everything except bulk batch-assume, the matching
        # confirm fast path, and finish_binding).  The backend's host
        # mirror replays its own batches' commits, so when this epoch is
        # unchanged between dispatches the whole node re-encode + mirror
        # diff is provably a no-op and is skipped (ops/backend.py).
        self.mutation_epoch = 0
        # Incremental flatten feed: names of nodes whose NodeInfo changed /
        # went dead since the last drain.  ONE consumer (the scheduler's
        # batch backend via CacheFlattenView.run_locked_dirty) — a second
        # draining view would starve the first.  _flatten_synced gates the
        # first drain to a full scan so a consumer attaching to a
        # pre-populated cache misses nothing.
        self._dirty_nodes: set[str] = set()
        self._removed_nodes: set[str] = set()
        self._flatten_synced = False

    # -- pods ------------------------------------------------------------

    def stats(self) -> dict[str, int]:
        """Cache sizes for the scheduler_cache_size{type=} gauge."""
        with self._lock:
            return {"nodes": len(self._nodes),
                    "pods": len(self._pod_states),
                    "assumed_pods": len(self._assumed_pods)}

    def assume_pod(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        with self._lock:
            if key in self._pod_states:
                raise ValueError(f"pod {key} already in cache")
            self.mutation_epoch += 1
            self._add_pod_to_node(pod)
            ps = _PodState(pod, assumed=True)
            self._pod_states[key] = ps
            self._assumed_pods.add(key)

    def assume_pods(self, items: list[tuple[Obj, "PodInfo"]]
                    ) -> list[str | None]:
        """Bulk assume under ONE lock acquisition (batch tail hot path).

        Each item is (assumed_pod, pod_info) where pod_info is a
        clone_with_pod of the already-parsed PodInfo — skips both the
        per-pod lock round trip and the PodInfo re-parse.  Returns one
        error string (or None) per item, same order."""
        errs: list[str | None] = []
        with self._lock:
            for pod, pi in items:
                key = pi.key
                if key in self._pod_states:
                    errs.append(f"pod {key} already in cache")
                    continue
                node_name = meta.pod_node_name(pod)
                if node_name:
                    ni = self._nodes.get(node_name)
                    if ni is None:
                        ni = self._nodes[node_name] = NodeInfo()
                    ni.add_pod(pi)
                    self._dirty_nodes.add(node_name)
                ps = _PodState(pod, assumed=True)
                self._pod_states[key] = ps
                self._assumed_pods.add(key)
                errs.append(None)
        return errs

    def finish_binding(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps and ps.assumed:
                ps.binding_finished = True
                if self._ttl > 0:
                    ps.deadline = time.monotonic() + self._ttl

    def finish_bindings(self, pods: list[Obj]) -> None:
        """Bulk finish_binding under one lock (batch bind tail)."""
        with self._lock:
            now = time.monotonic() if self._ttl > 0 else 0.0
            for pod in pods:
                ps = self._pod_states.get(meta.namespaced_name(pod))
                if ps and ps.assumed:
                    ps.binding_finished = True
                    if self._ttl > 0:
                        ps.deadline = now + self._ttl

    def forget_pod(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None:
                return
            if not ps.assumed:
                raise ValueError(f"pod {key} is not assumed; cannot forget")
            self.mutation_epoch += 1
            self._remove_pod_from_node(ps.pod)
            del self._pod_states[key]
            self._assumed_pods.discard(key)

    def add_pod(self, pod: Obj) -> None:
        """Informer confirm: pod observed bound via watch."""
        key = meta.namespaced_name(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is not None and ps.assumed:
                # confirmation of an assumed pod
                if meta.pod_node_name(ps.pod) != meta.pod_node_name(pod):
                    # scheduled somewhere else than assumed: fix up
                    self.mutation_epoch += 1
                    self._remove_pod_from_node(ps.pod)
                    self._add_pod_to_node(pod)
                self._pod_states[key] = _PodState(pod)
                self._assumed_pods.discard(key)
            elif ps is None:
                self.mutation_epoch += 1
                self._add_pod_to_node(pod)
                self._pod_states[key] = _PodState(pod)
            else:
                # duplicate add — treat as update
                self.mutation_epoch += 1
                self._remove_pod_from_node(ps.pod)
                self._add_pod_to_node(pod)
                self._pod_states[key] = _PodState(pod)

    def confirm_or_add_pods(self, pods: list[Obj]) -> None:
        """Bulk add_pod for a burst of newly-bound watch events (the
        scheduler's own binds coming back).  Fast path: the pod is assumed
        on the same node — just swap in the confirmed state.  Everything
        else takes the ordinary add_pod route.  One lock round per burst."""
        states = self._pod_states
        assumed = self._assumed_pods
        mk = _PodState
        with self._lock:
            for pod in pods:
                md = pod["metadata"]
                ns = md.get("namespace", "")
                key = f"{ns}/{md['name']}" if ns else md["name"]
                ps = states.get(key)
                if ps is not None and ps.assumed and (
                        (ps.pod.get("spec") or {}).get("nodeName")
                        == (pod.get("spec") or {}).get("nodeName")):
                    states[key] = mk(pod)
                    assumed.discard(key)
                else:
                    self.add_pod(pod)  # RLock: safe to re-enter

    def update_pod(self, old: Obj, new: Obj) -> None:
        key = meta.namespaced_name(new)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None:
                self.add_pod(new)
                return
            self.mutation_epoch += 1
            self._remove_pod_from_node(ps.pod)
            self._add_pod_to_node(new)
            self._pod_states[key] = _PodState(new)
            self._assumed_pods.discard(key)

    def remove_pod(self, pod: Obj) -> None:
        key = meta.namespaced_name(pod)
        with self._lock:
            ps = self._pod_states.get(key)
            if ps is None:
                return
            self.mutation_epoch += 1
            self._remove_pod_from_node(ps.pod)
            del self._pod_states[key]
            self._assumed_pods.discard(key)

    def is_assumed_pod(self, pod: Obj) -> bool:
        with self._lock:
            return meta.namespaced_name(pod) in self._assumed_pods

    def get_pod(self, pod: Obj) -> Obj | None:
        with self._lock:
            ps = self._pod_states.get(meta.namespaced_name(pod))
            return ps.pod if ps else None

    def holds(self, key: str) -> bool:
        """Whether the cache holds the pod with this 'ns/name' key."""
        with self._lock:
            return key in self._pod_states

    def assumed_pod_count(self) -> int:
        with self._lock:
            return len(self._assumed_pods)

    def _add_pod_to_node(self, pod: Obj) -> None:
        node_name = meta.pod_node_name(pod)
        if not node_name:
            return
        ni = self._nodes.get(node_name)
        if ni is None:
            # pod bound to a node we haven't seen yet: create placeholder
            # (reference keeps imaginary nodes for this case)
            ni = self._nodes[node_name] = NodeInfo()
        ni.add_pod(PodInfo(pod))
        self._dirty_nodes.add(node_name)

    def _remove_pod_from_node(self, pod: Obj) -> None:
        node_name = meta.pod_node_name(pod)
        ni = self._nodes.get(node_name)
        if ni is not None:
            ni.remove_pod(pod)
            self._dirty_nodes.add(node_name)
            if ni.node is None and not ni.pods:
                del self._nodes[node_name]

    # -- nodes -----------------------------------------------------------

    def add_node(self, node: Obj) -> None:
        self.add_nodes([node])

    def add_nodes(self, nodes: list[Obj]) -> None:
        """Bulk add/update: one lock round for a registration flood (a
        100k-node creation burst otherwise pays a lock acquire + epoch
        bump per node on the informer thread)."""
        with self._lock:
            self.mutation_epoch += 1
            table = self._nodes
            dirty = self._dirty_nodes
            removed = self._removed_nodes
            for node in nodes:
                name = meta.name(node)
                ni = table.get(name)
                if ni is None:
                    ni = table[name] = NodeInfo()
                ni.set_node(node)
                dirty.add(name)
                removed.discard(name)

    def update_node(self, node: Obj) -> None:
        self.add_node(node)

    def remove_node(self, node: Obj) -> None:
        name = meta.name(node)
        with self._lock:
            ni = self._nodes.get(name)
            if ni is None:
                return
            self.mutation_epoch += 1
            if ni.pods:
                # keep NodeInfo for remaining (possibly assumed) pods
                ni.node = None
                ni.generation = next(_generation)
            else:
                del self._nodes[name]
            # either way the node left the schedulable set
            self._dirty_nodes.discard(name)
            self._removed_nodes.add(name)

    def node_count(self) -> int:
        with self._lock:
            return len(self._nodes)

    def pod_count(self) -> int:
        with self._lock:
            return sum(len(ni.pods) for ni in self._nodes.values())

    # -- snapshot --------------------------------------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incremental snapshot refresh (cache.go:197).

        Copies only NodeInfos whose generation advanced past the snapshot's;
        rebuilds the ordered lists only when membership or affinity-list
        composition changed.
        """
        with self._lock:
            changed = False
            max_gen = snapshot.generation
            for name, ni in self._nodes.items():
                if ni.node is None:
                    continue  # placeholder for orphaned assumed pods
                if ni.generation > snapshot.generation:
                    snapshot.node_info_map[name] = ni.clone()
                    changed = True
                    if ni.generation > max_gen:
                        max_gen = ni.generation
            # removals
            live = {n for n, ni in self._nodes.items() if ni.node is not None}
            if len(snapshot.node_info_map) != len(live):
                for name in list(snapshot.node_info_map):
                    if name not in live:
                        del snapshot.node_info_map[name]
                changed = True
            snapshot.generation = max_gen
            if changed:
                snapshot.node_info_list = list(snapshot.node_info_map.values())
                snapshot.have_pods_with_affinity_list = [
                    ni for ni in snapshot.node_info_list if ni.pods_with_affinity]
                snapshot.have_pods_with_required_anti_affinity_list = [
                    ni for ni in snapshot.node_info_list
                    if ni.pods_with_required_anti_affinity]
                snapshot.used_pvc_set = {
                    pvc for ni in snapshot.node_info_list for pvc in ni.pvc_ref_counts}
            return snapshot

    def flatten_view(self) -> "CacheFlattenView":
        """Zero-copy view for the TPU batch flattener (see
        CacheFlattenView)."""
        return CacheFlattenView(self)

    def comparison_snapshot(self) -> tuple[set[str], set[str], set[str]]:
        """(node names, pod keys, assumed pod keys) under one lock — the
        comparer's view (internal/cache/debugger/comparer.go)."""
        with self._lock:
            return ({n for n, ni in self._nodes.items() if ni.node is not None},
                    set(self._pod_states), set(self._assumed_pods))

    def dump(self) -> dict:
        """Debug dump (internal/cache/debugger semantics)."""
        with self._lock:
            return {
                "nodes": {n: len(ni.pods) for n, ni in self._nodes.items()},
                "assumed_pods": sorted(self._assumed_pods),
                "pod_count": self.pod_count(),
            }


class CacheFlattenView:
    """Zero-copy alternative to update_snapshot for the TPU batch path.

    The per-pod oracle path needs an immutable Snapshot because its
    Filter/Score loops read NodeInfos over a long cycle.  The batch
    flattener only needs each NodeInfo for the microseconds it takes to
    re-encode its row, so it can read the cache's live NodeInfos directly —
    under the cache lock — and skip the NodeInfo.clone per dirty node
    (~8µs/pod at bench scale, reference analog: the generation-delta copy
    in internal/cache/cache.go:197 that this view makes unnecessary)."""

    def __init__(self, cache: Cache):
        self._cache = cache

    def epoch(self) -> int:
        """The cache's external-mutation epoch (int read; GIL-atomic).
        Unchanged epoch == every change since the last read came from the
        batch backend's own assume/confirm lifecycle."""
        return self._cache.mutation_epoch

    def run_locked(self, fn):
        c = self._cache
        with c._lock:
            return fn([ni for ni in c._nodes.values() if ni.node is not None])

    def run_locked_dirty(self, fn):
        """Incremental feed: fn(dirty_pairs, removed_names) under the cache
        lock, where dirty_pairs is [(name, NodeInfo)] for every node whose
        state changed since the last drain and removed_names lists nodes
        that left the schedulable set.  The first drain falls back to a
        full scan (fn(all_pairs, []) with every node marked) so a consumer
        attaching late sees the whole cluster.  O(changed), not O(nodes) —
        at 100k nodes the full scan cost ~0.8s per sync."""
        c = self._cache
        with c._lock:
            if not c._flatten_synced:
                pairs = [(name, ni) for name, ni in c._nodes.items()
                         if ni.node is not None]
                out = fn(pairs, [])  # raises -> stay unsynced, retry full
                c._flatten_synced = True
                c._dirty_nodes.clear()
                c._removed_nodes.clear()
                return out
            dirty, c._dirty_nodes = c._dirty_nodes, set()
            removed, c._removed_nodes = c._removed_nodes, set()
            nodes = c._nodes
            pairs = []
            for name in dirty:
                ni = nodes.get(name)
                if ni is None or ni.node is None:
                    removed.add(name)  # died between dirty and drain
                else:
                    pairs.append((name, ni))
            try:
                return fn(pairs, list(removed))
            except BaseException:
                # a failed (e.g. VocabFull) sync must not lose the delta:
                # un-drain so the retry revisits every pending node
                c._dirty_nodes |= dirty
                c._removed_nodes |= removed
                raise

    def run_locked_node(self, name: str, fn):
        """Event-patch feed: fn(NodeInfo | None) for ONE node under the
        cache lock — NodeInfo when the node is live, None when it has left
        the schedulable set.  On success the node's pending dirty/removed
        delta entry is discarded (the patch consumed it); a later mutation
        re-adds it, and the wave-time run_locked_dirty drain remains the
        authoritative backstop.  Before the first full drain the delta is
        left untouched: a consumer that has never seen the whole cluster
        must still take the full scan."""
        c = self._cache
        with c._lock:
            ni = c._nodes.get(name)
            if ni is not None and ni.node is None:
                ni = None
            out = fn(ni)  # raises -> delta stays pending for the drain
            if c._flatten_synced:
                c._dirty_nodes.discard(name)
                if ni is None:
                    c._removed_nodes.discard(name)
            return out
