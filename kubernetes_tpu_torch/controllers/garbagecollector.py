"""Garbage collector: ownerReference dependency graph + cascading deletion.

Reference: pkg/controller/garbagecollector/ —
  graph_builder.go: a GraphBuilder watches every resource and maintains
    an owner->dependents uid graph (including "virtual" nodes for owners
    it has only seen referenced, never observed);
  garbagecollector.go attemptToDeleteItem: classify an item's owners as
    solid (exists), dangling (gone), or waitingForDependentsDeletion
    (terminating in foreground); any solid owner keeps the item, all
    dangling deletes it, waiting owners + blockOwnerDeletion push the
    delete down in foreground;
  foregroundDeletion finalizer: a Foreground delete parks the owner
    terminating until no blocking dependents remain, then the GC strips
    the finalizer and the storage layer completes the delete;
  orphan finalizer: an Orphan delete strips ownerReferences from all
    dependents first, so they survive the owner.

Deviation from the reference: discovery-driven "watch the world" becomes
a fixed list of the resources this control plane serves (we have one
API surface, not arbitrary CRD sets — CRD-backed resources can be added
to WATCHED at construction).

A copy of kubernetes_tpu/controllers/garbagecollector.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import (
    CONFIGMAPS, CRONJOBS, DAEMONSETS, DEPLOYMENTS, ENDPOINTSLICES, JOBS,
    PODGROUPS, PODS, PVCS, REPLICASETS, REPLICATIONCONTROLLERS, SECRETS,
    SERVICES, STATEFULSETS,
)
from ..store import kv
from .base import Controller

logger = logging.getLogger(__name__)

FOREGROUND_FINALIZER = meta.FOREGROUND_FINALIZER
ORPHAN_FINALIZER = meta.ORPHAN_FINALIZER

KIND_TO_RESOURCE = {
    "Pod": PODS, "ReplicaSet": REPLICASETS, "Deployment": DEPLOYMENTS,
    "Job": JOBS, "CronJob": CRONJOBS, "StatefulSet": STATEFULSETS,
    "DaemonSet": DAEMONSETS,
    "ReplicationController": REPLICATIONCONTROLLERS,
    "Service": SERVICES, "ConfigMap": CONFIGMAPS, "Secret": SECRETS,
    "PersistentVolumeClaim": PVCS, "PodGroup": PODGROUPS,
    "EndpointSlice": ENDPOINTSLICES,
}

WATCHED = (PODS, REPLICASETS, DEPLOYMENTS, JOBS, CRONJOBS, STATEFULSETS,
           DAEMONSETS, REPLICATIONCONTROLLERS, SERVICES, CONFIGMAPS,
           SECRETS, PVCS, PODGROUPS, ENDPOINTSLICES)


class _Node:
    """One object in the dependency graph (graph_builder.go node)."""

    __slots__ = ("uid", "resource", "ns", "name", "owner_refs",
                 "dependents", "virtual", "terminating_foreground")

    def __init__(self, uid, resource="", ns="", name="", virtual=False):
        self.uid = uid
        self.resource = resource
        self.ns = ns
        self.name = name
        self.owner_refs: list[dict] = []
        self.dependents: set[str] = set()  # uids
        self.virtual = virtual
        self.terminating_foreground = False


def owner_references(obj: Obj) -> list[dict]:
    return (obj.get("metadata") or {}).get("ownerReferences") or []


class GarbageCollector(Controller):
    """Graph builder + deletion workers in one controller."""

    name = "garbagecollector"
    workers = 2

    def __init__(self, client, factory, watched=WATCHED):
        super().__init__(client, factory)
        self._glock = threading.Lock()
        self._graph: dict[str, _Node] = {}  # uid -> node
        self._informers = {}
        for res in watched:
            inf = factory.informer(res)
            self._informers[res] = inf
            inf.add_event_handler(
                lambda t, obj, old, res=res: self._on_event(t, obj, res))

    # -- graph maintenance (graph_builder.go processGraphChanges) --------

    def _on_event(self, type_: str, obj: Obj, res: str) -> None:
        uid = meta.uid(obj)
        if not uid:
            return
        md = obj.get("metadata") or {}
        if type_ == kv.DELETED:
            with self._glock:
                node = self._graph.pop(uid, None)
                if node:
                    for ref in node.owner_refs:
                        owner = self._graph.get(ref.get("uid", ""))
                        if owner:
                            owner.dependents.discard(uid)
                dependents = list(node.dependents) if node else []
                owner_uids = [r.get("uid", "") for r in
                              (node.owner_refs if node else [])]
            # dependents may now be orphans; owners waiting in foreground
            # may now be unblocked
            for dep_uid in dependents:
                self._enqueue_uid("delete", dep_uid)
            for ouid in owner_uids:
                self._enqueue_uid("delete", ouid)
            return

        refs = owner_references(obj)
        terminating = bool(md.get("deletionTimestamp"))
        fins = md.get("finalizers") or []
        with self._glock:
            node = self._graph.get(uid)
            if node is None:
                node = self._graph[uid] = _Node(uid)
            elif node.virtual:
                node.virtual = False  # observed for real now
            node.resource, node.ns, node.name = \
                res, md.get("namespace", ""), md.get("name", "")
            # re-point owner edges
            for ref in node.owner_refs:
                o = self._graph.get(ref.get("uid", ""))
                if o:
                    o.dependents.discard(uid)
            node.owner_refs = refs
            for ref in refs:
                ouid = ref.get("uid", "")
                if not ouid:
                    continue
                owner = self._graph.get(ouid)
                if owner is None:
                    # virtual node: referenced but never observed — it
                    # may exist outside our watch set or not at all
                    owner = self._graph[ouid] = _Node(
                        ouid,
                        KIND_TO_RESOURCE.get(ref.get("kind", ""), ""),
                        md.get("namespace", ""), ref.get("name", ""),
                        virtual=True)
                owner.dependents.add(uid)
            node.terminating_foreground = (
                terminating and FOREGROUND_FINALIZER in fins)

        if refs:
            self._enqueue_uid("delete", uid)
        if terminating and FOREGROUND_FINALIZER in fins:
            # push the foreground delete down, and check whether it can
            # already complete
            with self._glock:
                deps = list(self._graph.get(uid, _Node(uid)).dependents)
            for dep_uid in deps:
                self._enqueue_uid("delete", dep_uid)
            self._enqueue_uid("delete", uid)
        if terminating and ORPHAN_FINALIZER in fins:
            self._enqueue_uid("orphan", uid)

    def _enqueue_uid(self, action: str, uid: str) -> None:
        if uid:
            self.enqueue_key(f"{action}|{uid}")

    # -- workers ---------------------------------------------------------

    def sync(self, key: str) -> None:
        action, _, uid = key.partition("|")
        with self._glock:
            node = self._graph.get(uid)
            snapshot = None
            if node is not None:
                snapshot = (node.resource, node.ns, node.name,
                            list(node.owner_refs), node.virtual,
                            node.terminating_foreground,
                            list(node.dependents))
        if snapshot is None:
            return
        res, ns, name, _, virtual, _, dependents = snapshot
        if virtual or not res:
            return
        # decide from the LIVE object, not the graph snapshot — informer
        # lag would otherwise delete freshly-detached dependents
        # (the reference's attemptToDeleteItem also re-reads, gc.go:507)
        try:
            live = self.client.get(res, ns, name)
        except kv.NotFoundError:
            return
        if meta.uid(live) != uid:
            return  # same name, different object
        md = live.get("metadata") or {}
        refs = owner_references(live)
        term_fg = bool(md.get("deletionTimestamp")) and \
            FOREGROUND_FINALIZER in (md.get("finalizers") or [])
        if action == "orphan":
            self._attempt_to_orphan(res, ns, name, uid, dependents)
        else:
            self._attempt_to_delete(res, ns, name, uid, refs, term_fg,
                                    dependents)

    # attemptToDeleteItem (garbagecollector.go:497)
    def _attempt_to_delete(self, res, ns, name, uid, refs, term_fg,
                           dependents) -> None:
        if term_fg:
            self._maybe_finish_foreground(res, ns, name, uid, dependents)
            # fall through: a foreground-terminating item can itself be a
            # dependent of something else, but its own deletion is already
            # in progress — nothing more to do for its owners
            return
        if not refs:
            return
        solid, dangling, waiting = [], [], []
        for ref in refs:
            owner_res = KIND_TO_RESOURCE.get(ref.get("kind", ""))
            if owner_res is None:
                solid.append(ref)  # unknown kind: never cascade (be safe)
                continue
            owner_ns = "" if owner_res in ("nodes",) else ns
            try:
                owner = self.client.get(owner_res, owner_ns,
                                        ref.get("name", ""))
            except kv.NotFoundError:
                dangling.append(ref)
                continue
            if meta.uid(owner) != ref.get("uid"):
                dangling.append(ref)  # owner was recreated: not my owner
                continue
            omd = owner.get("metadata") or {}
            if omd.get("deletionTimestamp") and FOREGROUND_FINALIZER in (
                    omd.get("finalizers") or []):
                waiting.append(ref)
            else:
                solid.append(ref)
        if solid:
            return
        if waiting:
            blocking = [r for r in waiting if r.get("blockOwnerDeletion")]
            # owner is foreground-terminating: propagate the delete down,
            # in foreground if this item blocks and has dependents itself
            policy = "Foreground" if (blocking and dependents) else None
            self._delete(res, ns, name, uid, policy)
            return
        if dangling:
            logger.info("gc: deleting %s/%s %s (all owners gone)",
                        res, ns, name)
            self._delete(res, ns, name, uid,
                         "Foreground" if dependents else None)

    def _delete(self, res, ns, name, uid, policy) -> None:
        try:
            cur = self.client.get(res, ns, name)
            if meta.uid(cur) != uid:
                return  # recreated under the same name: leave it alone
            self.client.delete(res, ns, name, propagation_policy=policy)
        except kv.NotFoundError:
            pass

    # the foregroundDeletion finalizer strip
    # (garbagecollector.go processDeletingDependentsItem)
    def _maybe_finish_foreground(self, res, ns, name, uid,
                                 dependents) -> None:
        blocking = []
        with self._glock:
            for dep_uid in dependents:
                dep = self._graph.get(dep_uid)
                if dep is None:
                    continue
                for ref in dep.owner_refs:
                    if ref.get("uid") == uid and ref.get(
                            "blockOwnerDeletion"):
                        blocking.append(dep_uid)
        if blocking:
            return  # still waiting on dependents
        def strip(cur):
            fins = (cur["metadata"].get("finalizers") or [])
            cur["metadata"]["finalizers"] = [
                f for f in fins if f != FOREGROUND_FINALIZER]
            return cur
        try:
            self.client.guaranteed_update(res, ns, name, strip)
        except kv.NotFoundError:
            pass

    # attemptToOrphan: detach dependents, then release the owner
    def _attempt_to_orphan(self, res, ns, name, uid, dependents) -> None:
        with self._glock:
            dep_info = [(d.resource, d.ns, d.name)
                        for d in (self._graph.get(u) for u in dependents)
                        if d is not None and not d.virtual]
        for dres, dns, dname in dep_info:
            def detach(cur):
                cur["metadata"]["ownerReferences"] = [
                    r for r in owner_references(cur)
                    if r.get("uid") != uid]
                if not cur["metadata"]["ownerReferences"]:
                    del cur["metadata"]["ownerReferences"]
                return cur
            try:
                self.client.guaranteed_update(dres, dns, dname, detach)
            except kv.NotFoundError:
                pass
        def strip(cur):
            fins = (cur["metadata"].get("finalizers") or [])
            cur["metadata"]["finalizers"] = [
                f for f in fins if f != ORPHAN_FINALIZER]
            return cur
        try:
            self.client.guaranteed_update(res, ns, name, strip)
        except kv.NotFoundError:
            pass

    # -- introspection (debugger / tests) --------------------------------

    def graph_size(self) -> int:
        with self._glock:
            return len(self._graph)

    def dependents_of(self, uid: str) -> set[str]:
        with self._glock:
            node = self._graph.get(uid)
            return set(node.dependents) if node else set()
