"""Namespace controller.

Reference: pkg/controller/namespace/ — when a namespace is deleted, every
namespaced object inside it is deleted (content finalization), then the
kubernetes finalizer is removed.  Our store deletes the namespace object
immediately, so the controller reacts to the DELETED event and sweeps all
known namespaced resources; it also sets status.phase on live namespaces.

A copy of kubernetes_tpu/controllers/namespace.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.meta import Obj
from ..client import clientset as cs
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)

# the namespaced resource sweep list (namespace_controller discovers these
# via the discovery API; ours is static like the rest of the type system)
NAMESPACED_RESOURCES = (
    cs.PODS, cs.SERVICES, cs.ENDPOINTS, cs.REPLICASETS, cs.DEPLOYMENTS,
    cs.JOBS, cs.CRONJOBS, cs.STATEFULSETS, cs.DAEMONSETS, cs.CONFIGMAPS,
    cs.SECRETS, cs.PVCS, cs.PDBS, cs.PODGROUPS, cs.RESOURCEQUOTAS,
    cs.SERVICEACCOUNTS, cs.LIMITRANGES, cs.HPAS, cs.LEASES, cs.EVENTS,
    cs.ENDPOINTSLICES, cs.REPLICATIONCONTROLLERS,
)


class NamespaceController(Controller):
    name = "namespace"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.ns_informer = factory.informer(cs.NAMESPACES)
        self.ns_informer.add_event_handler(self._on_ns)
        self._deleted: set[str] = set()

    def _on_ns(self, type_, ns_obj: Obj, old) -> None:
        name = meta.name(ns_obj)
        if type_ == kv.DELETED:
            self._deleted.add(name)
        self.enqueue_key(name)

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        ns_obj = self.ns_informer.get("", name)
        if ns_obj is None:
            if name in self._deleted:
                self._sweep(name)
                self._deleted.discard(name)
            return
        # live namespace: ensure Active phase
        phase = (ns_obj.get("status") or {}).get("phase")
        want = "Terminating" if meta.deletion_timestamp(ns_obj) else "Active"
        if phase != want:
            def patch(o):
                o.setdefault("status", {})["phase"] = want
                return o
            try:
                self.client.guaranteed_update(cs.NAMESPACES, "", name, patch)
            except kv.NotFoundError:
                pass
        if want == "Terminating":
            self._sweep(name)

    def _sweep(self, namespace: str) -> None:
        """Delete all content of the namespace (deleteAllContent)."""
        for resource in NAMESPACED_RESOURCES:
            try:
                items, _ = self.client.list(resource, namespace)
            except Exception:  # noqa: BLE001 — resource table may not exist
                continue
            for obj in items:
                try:
                    self.client.delete(resource, namespace, meta.name(obj))
                except kv.NotFoundError:
                    pass
