"""Endpoints controller: Services -> ready pod IPs.

Reference: pkg/controller/endpoint/ — for each Service, select ready pods
by spec.selector and write an Endpoints object with their podIPs + ports.

A copy of kubernetes_tpu/controllers/endpoints.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.labels import selector_from_match_labels
from ..api.meta import Obj
from ..client.clientset import ENDPOINTS, PODS, SERVICES
from ..store import kv
from .base import Controller, split_key
from .replicaset import pod_is_ready

logger = logging.getLogger(__name__)


class EndpointsController(Controller):
    name = "endpoints"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.svc_informer = factory.informer(SERVICES)
        self.pod_informer = factory.informer(PODS)
        self.svc_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        ns = meta.namespace(pod)
        for svc in self.svc_informer.list(ns):
            sel = (svc.get("spec") or {}).get("selector") or {}
            if sel and selector_from_match_labels(sel).matches(meta.labels(pod)):
                self.enqueue(svc)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = self.svc_informer.get(ns, name)
        if svc is None:
            try:
                self.client.delete(ENDPOINTS, ns, name)
            except kv.NotFoundError:
                pass
            return
        sel = (svc.get("spec") or {}).get("selector") or {}
        if not sel:
            return  # headless/external services manage their own endpoints
        selector = selector_from_match_labels(sel)
        addresses = []
        for pod in self.pod_informer.list(ns):
            if (selector.matches(meta.labels(pod)) and pod_is_ready(pod)
                    and (pod.get("status") or {}).get("podIP")):
                addresses.append({"ip": pod["status"]["podIP"],
                                  "nodeName": meta.pod_node_name(pod),
                                  "targetRef": {"kind": "Pod",
                                                "name": meta.name(pod),
                                                "uid": meta.uid(pod)}})
        ports = [{"name": p.get("name", ""), "port": p.get("targetPort",
                                                           p.get("port")),
                  "protocol": p.get("protocol", "TCP")}
                 for p in (svc.get("spec") or {}).get("ports") or ()]
        subsets = [{"addresses": addresses, "ports": ports}] if addresses else []
        ep = meta.new_object("Endpoints", name, ns)
        ep["subsets"] = subsets
        try:
            cur = self.client.get(ENDPOINTS, ns, name)
            if cur.get("subsets") != subsets:
                self.client.guaranteed_update(
                    ENDPOINTS, ns, name,
                    lambda o: {**o, "subsets": subsets})
        except kv.NotFoundError:
            self.client.create(ENDPOINTS, ep)
