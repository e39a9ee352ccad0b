"""ReplicaSet controller.

Reference: pkg/controller/replicaset/replica_set.go
  syncReplicaSet (:660): list owned pods via selector + controllerRef
  adoption, diff against spec.replicas, slowStartBatch create / scored
  delete, update status (replicas/readyReplicas/availableReplicas).

Simplifications vs reference: no expectations cache (our informer delivery
is synchronous with the store, so the sync that follows a create/delete
already observes it); deletion picks unready-then-youngest pods.

A copy of kubernetes_tpu/controllers/replicaset.py: the same classes,
names and logic, over this package's api/, client/ and store/.
Pod names take a random five-character suffix, as in the reference.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.labels import selector_from_dict
from ..api.meta import Obj
from ..client.clientset import PODS, REPLICASETS
from ..store import kv
from .base import Controller, Expectations, is_owned_by, owner_ref, split_key

logger = logging.getLogger(__name__)


def pod_is_ready(pod: Obj) -> bool:
    phase = (pod.get("status") or {}).get("phase")
    if phase != "Running":
        return False
    conds = (pod.get("status") or {}).get("conditions") or []
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in conds)


def pod_is_active(pod: Obj) -> bool:
    return (not meta.pod_is_terminal(pod)
            and meta.deletion_timestamp(pod) is None)


class ReplicaSetController(Controller):
    name = "replicaset"
    kind = "ReplicaSet"          # controllerRef kind owned pods carry
    resource = REPLICASETS       # status-update target resource

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.rs_informer = factory.informer(self.resource)
        self.pod_informer = factory.informer(PODS)
        self.expectations = Expectations()
        self.rs_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_: str, pod: Obj, old: Obj | None) -> None:
        ref = meta.controller_ref(pod)
        if ref and ref.get("kind") == self.kind:
            key = f"{meta.namespace(pod)}/{ref['name']}"
            if type_ == kv.ADDED:
                self.expectations.creation_observed(key)
            elif type_ == kv.DELETED:
                self.expectations.deletion_observed(key)
            self.enqueue_key(key)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        rs = self.rs_informer.get(ns, name)
        if rs is None:
            self.expectations.delete(key)
            return
        rs = self._normalize(rs)
        spec = rs.get("spec") or {}
        want = spec.get("replicas", 1)
        selector = selector_from_dict(spec.get("selector") or {})
        pods = [p for p in self.pod_informer.list(ns)
                if is_owned_by(p, rs) and pod_is_active(p)]
        # adoption: orphaned pods matching the selector
        for p in self.pod_informer.list(ns):
            if (not meta.owner_references(p) and pod_is_active(p)
                    and selector.matches(meta.labels(p))):
                self._adopt(p, rs)
                pods.append(p)

        diff = want - len(pods)
        if self.expectations.satisfied(key):
            if diff > 0:
                self.expectations.expect_creations(key, diff)
                for i in range(diff):
                    try:
                        if not self._create_pod(rs):
                            self.expectations.creation_observed(key)
                    except Exception:
                        # lower remaining slots so the retry isn't gated
                        # for TIMEOUT (slowStartBatch semantics)
                        for _ in range(diff - i):
                            self.expectations.creation_observed(key)
                        raise
            elif diff < 0:
                # prefer deleting not-ready, then youngest
                victims = sorted(pods, key=lambda p: (
                    pod_is_ready(p), meta.creation_timestamp(p)))[:(-diff)]
                self.expectations.expect_deletions(key, len(victims))
                for i, p in enumerate(victims):
                    try:
                        self.client.delete(PODS, ns, meta.name(p))
                    except kv.NotFoundError:
                        self.expectations.deletion_observed(key)
                    except Exception:
                        for _ in range(len(victims) - i):
                            self.expectations.deletion_observed(key)
                        raise
        self._update_status(rs, pods)

    def _normalize(self, rs: Obj) -> Obj:
        """Hook for subclasses reshaping the object before sync (RC)."""
        return rs

    def _adopt(self, pod: Obj, rs: Obj) -> None:
        def patch(p):
            p["metadata"].setdefault("ownerReferences", []).append(
                owner_ref(rs, self.kind))
            return p
        try:
            self.client.guaranteed_update(PODS, meta.namespace(pod),
                                          meta.name(pod), patch)
        except kv.StoreError:
            pass

    def _create_pod(self, rs: Obj) -> None:
        tmpl = (rs.get("spec") or {}).get("template") or {}
        ns = meta.namespace(rs)
        pod = meta.new_object("Pod", "", ns)
        pod["metadata"]["generateName"] = meta.name(rs) + "-"
        pod["metadata"]["name"] = f"{meta.name(rs)}-{meta.uid(rs)[:5]}-" + \
            __import__("uuid").uuid4().hex[:5]
        tmpl_meta = tmpl.get("metadata") or {}
        pod["metadata"]["labels"] = dict(tmpl_meta.get("labels") or {})
        if tmpl_meta.get("annotations"):
            pod["metadata"]["annotations"] = dict(tmpl_meta["annotations"])
        pod["metadata"]["ownerReferences"] = [owner_ref(rs, self.kind)]
        pod["spec"] = meta.deep_copy(tmpl.get("spec") or {"containers": [
            {"name": "c0", "image": "img"}]})
        pod["spec"].setdefault("schedulerName", "default-scheduler")
        try:
            self.client.create(PODS, pod)
            return True
        except kv.AlreadyExistsError:
            return False

    def _update_status(self, rs: Obj, pods: list[Obj]) -> None:
        ready = sum(1 for p in pods if pod_is_ready(p))
        status = {"replicas": len(pods), "readyReplicas": ready,
                  "availableReplicas": ready,
                  "observedGeneration": rs["metadata"].get("generation", 0)}
        if (rs.get("status") or {}) == status:
            return

        def patch(o):
            o["status"] = status
            return o
        try:
            self.client.guaranteed_update(self.resource, meta.namespace(rs),
                                          meta.name(rs), patch)
        except kv.NotFoundError:
            pass
