"""Disruption controller.

Reference: pkg/controller/disruption/ — maintains PodDisruptionBudget
status: expectedPods (from the owning controller's scale), currentHealthy,
desiredHealthy (from minAvailable/maxUnavailable IntOrString), and
disruptionsAllowed, which the apiserver's eviction subresource consumes.

A copy of kubernetes_tpu/controllers/disruption.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import PDBS, PODS
from ..store import kv
from .base import Controller, split_key
from .replicaset import pod_is_ready

logger = logging.getLogger(__name__)


def _scaled(value, expected: int) -> int:
    if isinstance(value, str) and value.endswith("%"):
        return -(-int(float(value[:-1]) * expected) // 100)  # ceil
    return int(value)


class DisruptionController(Controller):
    name = "disruption"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pdb_informer = factory.informer(PDBS)
        self.pod_informer = factory.informer(PODS)
        self.pdb_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        labels = meta.labels(pod)
        for pdb in self.pdb_informer.list(meta.namespace(pod)):
            sel = ((pdb.get("spec") or {}).get("selector") or {}) \
                .get("matchLabels", {})
            if sel and all(labels.get(k) == v for k, v in sel.items()):
                self.enqueue(pdb)

    def _expected(self, matching: list[Obj], ns: str) -> int:
        """Sum the scale of every distinct owning controller (upstream
        getExpectedScale); unowned pods count themselves."""
        owners: dict[tuple, int] = {}
        unowned = 0
        for p in matching:
            ref = meta.controller_ref(p)
            if ref and ref.get("kind") in ("ReplicaSet", "StatefulSet",
                                           "ReplicationController"):
                key = (ref["kind"], ref["name"])
                if key in owners:
                    continue
                try:
                    owner = self.client.get(ref["kind"].lower() + "s", ns,
                                            ref["name"])
                    owners[key] = int((owner.get("spec") or {})
                                      .get("replicas", 1))
                except kv.NotFoundError:
                    owners[key] = 0
            else:
                unowned += 1
        if not owners:
            return len(matching)
        return sum(owners.values()) + unowned

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pdb = self.pdb_informer.get(ns, name)
        if pdb is None:
            return
        spec = pdb.get("spec") or {}
        sel = (spec.get("selector") or {}).get("matchLabels", {})
        matching = [p for p in self.pod_informer.list(ns)
                    if sel and all(meta.labels(p).get(k) == v
                                   for k, v in sel.items())]
        # upstream counts only Ready pods as healthy (disruption.go
        # countHealthyPods); the hollow kubelet sets the Ready condition
        healthy = sum(1 for p in matching
                      if pod_is_ready(p)
                      and meta.deletion_timestamp(p) is None)
        expected = self._expected(matching, ns)
        if "minAvailable" in spec:
            desired = _scaled(spec["minAvailable"], expected)
        elif "maxUnavailable" in spec:
            desired = expected - _scaled(spec["maxUnavailable"], expected)
        else:
            desired = 0
        allowed = max(0, healthy - desired)
        status = {"expectedPods": expected, "currentHealthy": healthy,
                  "desiredHealthy": desired, "disruptionsAllowed": allowed,
                  "observedGeneration": pdb["metadata"].get("generation", 0)}
        if (pdb.get("status") or {}) != status:
            def patch(o):
                o["status"] = status
                return o
            try:
                self.client.guaranteed_update(PDBS, ns, name, patch)
            except kv.NotFoundError:
                pass
