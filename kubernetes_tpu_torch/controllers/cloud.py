"""Cloud controller manager: the cloud-provider-facing controllers.

Reference: cmd/cloud-controller-manager + staging/src/k8s.io/cloud-provider
— out-of-tree controllers driving a CloudProvider interface:
  service controller  (cloud-provider/controllers/service) - provision a
      cloud load balancer for Service type=LoadBalancer, publish its
      ingress IP in status.loadBalancer; deprovision on type change/delete
  route controller    (cloud-provider/controllers/route) - program cloud
      routes so each node's podCIDR is reachable; reconciled against the
      node list
  node controller     (cloud-provider/controllers/node) - decorate nodes
      with cloud metadata (provider id, zone/region labels) and clear the
      uninitialized taint

FakeCloudProvider is the in-process cloud (the reference ships exactly
this shape in cloud-provider/fake for its tests); a real provider
implements the same three surfaces.

A copy of kubernetes_tpu/controllers/cloud.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import NODES, SERVICES
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)

UNINITIALIZED_TAINT = "node.cloudprovider.kubernetes.io/uninitialized"


class FakeCloudProvider:
    """cloud-provider/fake shape: LBs from an IP pool, route table dict,
    static zone metadata."""

    def __init__(self, zone: str = "tpu-zone-a", region: str = "tpu-region"):
        self.zone, self.region = zone, region
        self._lock = threading.Lock()
        self._lbs: dict[str, str] = {}      # service key -> external ip
        self._next_ip = 1
        self.routes: dict[str, str] = {}    # node name -> podCIDR

    # LoadBalancer surface (cloudprovider.LoadBalancer)
    def ensure_load_balancer(self, svc_key: str) -> str:
        with self._lock:
            ip = self._lbs.get(svc_key)
            if ip is None:
                ip = f"203.0.113.{self._next_ip}"
                self._next_ip += 1
                self._lbs[svc_key] = ip
            return ip

    def ensure_load_balancer_deleted(self, svc_key: str) -> None:
        with self._lock:
            self._lbs.pop(svc_key, None)

    # Routes surface (cloudprovider.Routes)
    def create_route(self, node: str, cidr: str) -> None:
        with self._lock:
            self.routes[node] = cidr

    def delete_route(self, node: str) -> None:
        with self._lock:
            self.routes.pop(node, None)

    # InstancesV2 surface
    def instance_metadata(self, node: str) -> dict:
        return {"providerID": f"fake://{self.region}/{self.zone}/{node}",
                "zone": self.zone, "region": self.region}


class CloudServiceController(Controller):
    """Service type=LoadBalancer <-> cloud LB (service_controller.go)."""

    name = "cloud-service"

    def __init__(self, client, factory, cloud: FakeCloudProvider | None = None):
        super().__init__(client, factory)
        self.cloud = cloud or FakeCloudProvider()
        self.svc_informer = factory.informer(SERVICES)
        self.svc_informer.add_event_handler(self._on_svc)

    def _on_svc(self, type_, svc, old) -> None:
        self.enqueue(svc)
        if type_ == kv.DELETED:
            self.cloud.ensure_load_balancer_deleted(meta.namespaced_name(svc))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = self.svc_informer.get(ns, name)
        if svc is None:
            self.cloud.ensure_load_balancer_deleted(key)
            return
        if (svc.get("spec") or {}).get("type") != "LoadBalancer":
            # type changed away: deprovision + clear published ingress
            self.cloud.ensure_load_balancer_deleted(key)
            if ((svc.get("status") or {}).get("loadBalancer") or {}).get(
                    "ingress"):
                def clear(o):
                    (o.get("status") or {}).pop("loadBalancer", None)
                    return o
                try:
                    self.client.guaranteed_update(SERVICES, ns, name, clear)
                except kv.NotFoundError:
                    pass
            return
        ip = self.cloud.ensure_load_balancer(key)
        ingress = [{"ip": ip}]
        if ((svc.get("status") or {}).get("loadBalancer") or {}).get(
                "ingress") == ingress:
            return

        def publish(o):
            o.setdefault("status", {})["loadBalancer"] = {"ingress": ingress}
            return o
        try:
            self.client.guaranteed_update(SERVICES, ns, name, publish)
        except kv.NotFoundError:
            pass


class CloudRouteController(Controller):
    """node podCIDR -> cloud route table (route_controller.go)."""

    name = "cloud-route"

    def __init__(self, client, factory, cloud: FakeCloudProvider | None = None):
        super().__init__(client, factory)
        self.cloud = cloud or FakeCloudProvider()
        self.node_informer = factory.informer(NODES)
        self.node_informer.add_event_handler(self._on_node)

    def _on_node(self, type_, node, old) -> None:
        if type_ == kv.DELETED:
            self.cloud.delete_route(meta.name(node))
        else:
            self.enqueue(node)

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        node = self.node_informer.get("", name)
        if node is None:
            self.cloud.delete_route(name)
            return
        cidr = (node.get("spec") or {}).get("podCIDR")
        if cidr:
            self.cloud.create_route(name, cidr)
            # NetworkUnavailable=False once the route exists
            conds = (node.get("status") or {}).get("conditions") or []
            if not any(c.get("type") == "NetworkUnavailable"
                       and c.get("status") == "False" for c in conds):
                def patch(o):
                    cs = o.setdefault("status", {}).setdefault(
                        "conditions", [])
                    cs[:] = [c for c in cs
                             if c.get("type") != "NetworkUnavailable"]
                    cs.append({"type": "NetworkUnavailable",
                               "status": "False",
                               "reason": "RouteCreated"})
                    return o
                try:
                    self.client.guaranteed_update(NODES, "", name, patch)
                except kv.NotFoundError:
                    pass


class CloudNodeController(Controller):
    """Cloud metadata onto nodes + uninitialized-taint removal
    (node_controller.go)."""

    name = "cloud-node"

    def __init__(self, client, factory, cloud: FakeCloudProvider | None = None):
        super().__init__(client, factory)
        self.cloud = cloud or FakeCloudProvider()
        self.node_informer = factory.informer(NODES)
        self.node_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        node = self.node_informer.get("", name)
        if node is None:
            return
        md = self.cloud.instance_metadata(name)
        labels = meta.labels(node)
        want_labels = {"topology.kubernetes.io/zone": md["zone"],
                       "topology.kubernetes.io/region": md["region"]}
        has_taint = any(
            t.get("key") == UNINITIALIZED_TAINT
            for t in (node.get("spec") or {}).get("taints") or ())
        done = ((node.get("spec") or {}).get("providerID") == md["providerID"]
                and all(labels.get(k) == v for k, v in want_labels.items())
                and not has_taint)
        if done:
            return

        def patch(o):
            o.setdefault("spec", {})["providerID"] = md["providerID"]
            o["metadata"].setdefault("labels", {}).update(want_labels)
            taints = (o.get("spec") or {}).get("taints") or []
            o["spec"]["taints"] = [t for t in taints
                                   if t.get("key") != UNINITIALIZED_TAINT]
            return o
        try:
            self.client.guaranteed_update(NODES, "", name, patch)
        except kv.NotFoundError:
            pass


class CloudControllerManager:
    """cmd/cloud-controller-manager: the three controllers over one cloud."""

    def __init__(self, client, factory, cloud: FakeCloudProvider | None = None):
        self.cloud = cloud or FakeCloudProvider()
        self.controllers = [
            CloudServiceController(client, factory, self.cloud),
            CloudRouteController(client, factory, self.cloud),
            CloudNodeController(client, factory, self.cloud),
        ]

    def run(self) -> None:
        for c in self.controllers:
            c.run()

    def stop(self) -> None:
        for c in self.controllers:
            c.stop()
