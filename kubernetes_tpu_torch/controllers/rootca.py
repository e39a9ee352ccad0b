"""Root CA certificate publisher.

Reference: pkg/controller/certificates/rootcacertpublisher/publisher.go —
every Namespace gets a `kube-root-ca.crt` ConfigMap carrying the cluster
CA bundle (what pods mount to trust the apiserver); recreated on delete,
repaired on drift.

A copy of kubernetes_tpu/controllers/rootca.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..client.clientset import CONFIGMAPS, NAMESPACES
from ..store import kv
from .base import Controller, split_key
from .certificates import ClusterCA

logger = logging.getLogger(__name__)

ROOT_CA_CONFIGMAP = "kube-root-ca.crt"


class RootCACertPublisher(Controller):
    name = "root-ca-cert-publisher"

    def __init__(self, client, factory, ca: ClusterCA | None = None):
        super().__init__(client, factory)
        self.ca_pem = (ca or ClusterCA.shared()).ca_pem()
        self.ns_informer = factory.informer(NAMESPACES)
        self.cm_informer = factory.informer(CONFIGMAPS)
        self.ns_informer.add_event_handler(
            lambda t, obj, old: self.enqueue_key(meta.name(obj)))
        self.cm_informer.add_event_handler(self._on_cm)

    def _on_cm(self, type_, cm, old) -> None:
        if meta.name(cm) == ROOT_CA_CONFIGMAP:
            self.enqueue_key(meta.namespace(cm))

    def sync(self, key: str) -> None:
        _, ns = split_key(key)
        if self.ns_informer.get("", ns) is None:
            return
        cm = self.cm_informer.get(ns, ROOT_CA_CONFIGMAP)
        if cm is None:
            obj = meta.new_object("ConfigMap", ROOT_CA_CONFIGMAP, ns)
            obj["data"] = {"ca.crt": self.ca_pem}
            try:
                self.client.create(CONFIGMAPS, obj)
            except kv.AlreadyExistsError:
                pass
            return
        if (cm.get("data") or {}).get("ca.crt") != self.ca_pem:
            def patch(o):
                o.setdefault("data", {})["ca.crt"] = self.ca_pem
                return o
            try:
                self.client.guaranteed_update(CONFIGMAPS, ns,
                                              ROOT_CA_CONFIGMAP, patch)
            except kv.NotFoundError:
                pass
