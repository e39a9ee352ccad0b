"""Deployment controller.

Reference: pkg/controller/deployment/ — syncDeployment: find/create the
ReplicaSet for the current pod template (identified by a template hash
label), scale it to spec.replicas, scale old ReplicaSets down (rolling
update reduced to: surge the new RS fully, drain old RSes as new pods
become ready; Recreate = drain first), and mirror status.

A copy of kubernetes_tpu/controllers/deployment.py: the same classes,
names and logic, over this package's api/, client/ and store/.
ROADMAP R15 pins its rollout in both packages: an update creates the
new ReplicaSet at the whole replica count at once (no maxSurge or
maxUnavailable) and drains the old ones only as new pods turn Ready, so
for a while the Deployment holds twice its pods.
"""

from __future__ import annotations

import hashlib
import json
import logging

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import DEPLOYMENTS, REPLICASETS
from ..store import kv
from .base import Controller, is_owned_by, owner_ref, split_key
from .replicaset import pod_is_ready

logger = logging.getLogger(__name__)

HASH_LABEL = "pod-template-hash"


def template_hash(template: Obj) -> str:
    canon = json.dumps(template, sort_keys=True)
    return hashlib.sha1(canon.encode()).hexdigest()[:10]


class DeploymentController(Controller):
    name = "deployment"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.dep_informer = factory.informer(DEPLOYMENTS)
        self.rs_informer = factory.informer(REPLICASETS)
        self.dep_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.rs_informer.add_event_handler(self._on_rs)

    def _on_rs(self, type_, rs: Obj, old) -> None:
        ref = meta.controller_ref(rs)
        if ref and ref.get("kind") == "Deployment":
            self.enqueue_key(f"{meta.namespace(rs)}/{ref['name']}")

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        dep = self.dep_informer.get(ns, name)
        if dep is None:
            return
        spec = dep.get("spec") or {}
        replicas = spec.get("replicas", 1)
        template = spec.get("template") or {}
        thash = template_hash(template)
        strategy = (spec.get("strategy") or {}).get("type", "RollingUpdate")

        owned = [rs for rs in self.rs_informer.list(ns) if is_owned_by(rs, dep)]
        new_rs = next((rs for rs in owned
                       if meta.labels(rs).get(HASH_LABEL) == thash), None)
        old_rses = [rs for rs in owned
                    if meta.labels(rs).get(HASH_LABEL) != thash]

        if new_rs is None:
            if strategy == "Recreate" and any(
                    (rs.get("status") or {}).get("replicas", 0) > 0
                    for rs in old_rses):
                self._scale_all(old_rses, 0)
                return  # next sync creates the new RS once old ones drain
            new_rs = self._create_rs(dep, template, thash, replicas)
            if new_rs is None:
                return

        if (new_rs.get("spec") or {}).get("replicas") != replicas:
            self._scale(new_rs, replicas)

        # rolling: drain old RSes as the new one becomes ready
        new_ready = (new_rs.get("status") or {}).get("readyReplicas", 0)
        for rs in old_rses:
            cur = (rs.get("spec") or {}).get("replicas", 0)
            if cur > 0:
                target = max(0, replicas - new_ready)
                if target < cur:
                    self._scale(rs, target)
        # GC fully-drained old RSes beyond revisionHistoryLimit (default 10)
        drained = [rs for rs in old_rses
                   if (rs.get("spec") or {}).get("replicas", 0) == 0
                   and (rs.get("status") or {}).get("replicas", 0) == 0]
        limit = spec.get("revisionHistoryLimit", 10)
        for rs in drained[:-limit] if limit else drained:
            try:
                self.client.delete(REPLICASETS, ns, meta.name(rs))
            except kv.NotFoundError:
                pass

        self._update_status(dep, new_rs, old_rses, replicas)

    def _create_rs(self, dep: Obj, template: Obj, thash: str,
                   replicas: int) -> Obj | None:
        ns = meta.namespace(dep)
        rs = meta.new_object("ReplicaSet", f"{meta.name(dep)}-{thash}", ns)
        labels = dict((template.get("metadata") or {}).get("labels") or {})
        labels[HASH_LABEL] = thash
        tmpl = meta.deep_copy(template)
        tmpl.setdefault("metadata", {}).setdefault("labels", {})[HASH_LABEL] = thash
        rs["metadata"]["labels"] = labels
        rs["metadata"]["ownerReferences"] = [owner_ref(dep, "Deployment")]
        rs["spec"] = {"replicas": replicas,
                      "selector": {"matchLabels": labels},
                      "template": tmpl}
        try:
            return self.client.create(REPLICASETS, rs)
        except kv.AlreadyExistsError:
            return self.rs_informer.get(ns, meta.name(rs))

    def _scale(self, rs: Obj, replicas: int) -> None:
        def patch(o):
            o.setdefault("spec", {})["replicas"] = replicas
            return o
        try:
            self.client.guaranteed_update(REPLICASETS, meta.namespace(rs),
                                          meta.name(rs), patch)
        except kv.NotFoundError:
            pass

    def _scale_all(self, rses: list[Obj], replicas: int) -> None:
        for rs in rses:
            if (rs.get("spec") or {}).get("replicas", 0) != replicas:
                self._scale(rs, replicas)

    def _update_status(self, dep: Obj, new_rs: Obj, old_rses: list[Obj],
                       want: int) -> None:
        total = ready = updated = 0
        for rs in [new_rs, *old_rses]:
            st = rs.get("status") or {}
            total += st.get("replicas", 0)
            ready += st.get("readyReplicas", 0)
        updated = (new_rs.get("status") or {}).get("replicas", 0)
        conds = []
        if ready >= want:
            conds.append({"type": "Available", "status": "True"})
        status = {"replicas": total, "readyReplicas": ready,
                  "updatedReplicas": updated, "availableReplicas": ready,
                  "conditions": conds,
                  "observedGeneration": dep["metadata"].get("generation", 0)}
        if (dep.get("status") or {}) == status:
            return

        def patch(o):
            o["status"] = status
            return o
        try:
            self.client.guaranteed_update(DEPLOYMENTS, meta.namespace(dep),
                                          meta.name(dep), patch)
        except kv.NotFoundError:
            pass
