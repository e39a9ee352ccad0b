"""StatefulSet controller.

Reference: pkg/controller/statefulset/ — stable identities: pods are named
<set>-0..<replicas-1>; OrderedReady management creates ordinal i+1 only
once ordinal i is running and ready, and scales down from the highest
ordinal; Parallel management creates/deletes all at once.  Each
volumeClaimTemplate yields a PVC <claim>-<pod> that survives pod deletion.

A copy of kubernetes_tpu/controllers/statefulset.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import PODS, PVCS, STATEFULSETS
from ..store import kv
from .base import Controller, Expectations, is_owned_by, owner_ref, split_key
from .replicaset import pod_is_active, pod_is_ready

logger = logging.getLogger(__name__)


def ordinal_of(pod_name: str, set_name: str) -> int:
    suffix = pod_name[len(set_name) + 1:]
    try:
        return int(suffix)
    except ValueError:
        return -1


class StatefulSetController(Controller):
    name = "statefulset"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.set_informer = factory.informer(STATEFULSETS)
        self.pod_informer = factory.informer(PODS)
        self.expectations = Expectations()
        self.set_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        ref = meta.controller_ref(pod)
        if ref and ref.get("kind") == "StatefulSet":
            key = f"{meta.namespace(pod)}/{ref['name']}"
            if type_ == kv.ADDED:
                self.expectations.creation_observed(key)
            elif type_ == kv.DELETED:
                self.expectations.deletion_observed(key)
            self.enqueue_key(key)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        sts = self.set_informer.get(ns, name)
        if sts is None:
            self.expectations.delete(key)
            return
        spec = sts.get("spec") or {}
        want = spec.get("replicas", 1)
        parallel = (spec.get("podManagementPolicy") == "Parallel")
        owned = {ordinal_of(meta.name(p), name): p
                 for p in self.pod_informer.list(ns)
                 if is_owned_by(p, sts) and pod_is_active(p)
                 and ordinal_of(meta.name(p), name) >= 0}

        if self.expectations.satisfied(key):
            self._manage(key, sts, ns, name, want, parallel, owned)

        ready = sum(1 for p in owned.values() if pod_is_ready(p))
        status = {"replicas": len(owned), "readyReplicas": ready,
                  "currentReplicas": len(owned),
                  "updatedReplicas": len(owned),
                  "observedGeneration": sts["metadata"].get("generation", 0)}
        if (sts.get("status") or {}) != status:
            def patch(o):
                o["status"] = status
                return o
            try:
                self.client.guaranteed_update(STATEFULSETS, ns, name, patch)
            except kv.NotFoundError:
                pass

    def _manage(self, key, sts, ns, name, want, parallel, owned) -> None:
        missing = [i for i in range(want) if i not in owned]
        extra = sorted((i for i in owned if i >= want), reverse=True)
        if missing:
            if parallel:
                self.expectations.expect_creations(key, len(missing))
                for i in missing:
                    self._safe_create(key, sts, i)
            else:
                # OrderedReady: only the lowest missing ordinal, and only
                # if every lower ordinal is running and ready
                i = missing[0]
                lower_ok = all(j in owned and pod_is_ready(owned[j])
                               for j in range(i))
                if lower_ok or i == 0:
                    self.expectations.expect_creations(key, 1)
                    self._safe_create(key, sts, i)
        elif extra:
            # scale down from the top, one at a time unless Parallel
            victims = extra if parallel else extra[:1]
            self.expectations.expect_deletions(key, len(victims))
            for i in victims:
                try:
                    self.client.delete(PODS, ns, f"{name}-{i}")
                except kv.NotFoundError:
                    self.expectations.deletion_observed(key)

    def _safe_create(self, key, sts, ordinal) -> None:
        try:
            if not self._create_pod(sts, ordinal):
                self.expectations.creation_observed(key)
        except Exception:
            self.expectations.creation_observed(key)
            raise

    def _create_pod(self, sts: Obj, ordinal: int) -> bool:
        ns, set_name = meta.namespace(sts), meta.name(sts)
        tmpl = (sts.get("spec") or {}).get("template") or {}
        pod = meta.new_object("Pod", f"{set_name}-{ordinal}", ns)
        tmpl_meta = tmpl.get("metadata") or {}
        pod["metadata"]["labels"] = dict(tmpl_meta.get("labels") or {})
        pod["metadata"]["labels"]["statefulset.kubernetes.io/pod-name"] = \
            meta.name(pod)
        pod["metadata"]["ownerReferences"] = [owner_ref(sts, "StatefulSet")]
        pod["spec"] = meta.deep_copy(tmpl.get("spec") or {"containers": [
            {"name": "c0", "image": "img"}]})
        pod["spec"]["hostname"] = meta.name(pod)
        pod["spec"]["subdomain"] = (sts.get("spec") or {}).get("serviceName", "")
        pod["spec"].setdefault("schedulerName", "default-scheduler")
        # stable storage: one PVC per volumeClaimTemplate, named
        # <claim>-<pod>; pre-existing PVCs are reused (identity survives)
        for vct in (sts.get("spec") or {}).get("volumeClaimTemplates", []):
            claim = meta.name(vct) or (vct.get("metadata") or {}).get("name", "data")
            pvc_name = f"{claim}-{meta.name(pod)}"
            pvc = meta.new_object("PersistentVolumeClaim", pvc_name, ns)
            pvc["spec"] = meta.deep_copy(vct.get("spec") or {})
            try:
                self.client.create(PVCS, pvc)
            except kv.AlreadyExistsError:
                pass
            pod["spec"].setdefault("volumes", []).append(
                {"name": claim,
                 "persistentVolumeClaim": {"claimName": pvc_name}})
        try:
            self.client.create(PODS, pod)
            return True
        except kv.AlreadyExistsError:
            return False
