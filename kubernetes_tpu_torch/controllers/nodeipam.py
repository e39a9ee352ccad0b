"""NodeIPAM controller.

Reference: pkg/controller/nodeipam/ (range_allocator.go) — carves the
cluster CIDR into fixed-size per-node pod CIDRs and writes
node.spec.podCIDR/podCIDRs on registration; released when the node goes.
Allocation state is an in-memory bitmap rebuilt from informer state on
start (the reference's cidrset.CidrSet).

A copy of kubernetes_tpu/controllers/nodeipam.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import ipaddress
import logging
import threading

from ..api import meta
from ..client.clientset import NODES
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)


class CidrSet:
    """Bitmap allocator over cluster_cidr split at node_mask (cidrset.go)."""

    def __init__(self, cluster_cidr: str = "10.244.0.0/16",
                 node_mask: int = 24):
        self.net = ipaddress.ip_network(cluster_cidr)
        self.node_mask = node_mask
        self.subnets = list(self.net.subnets(new_prefix=node_mask))
        self._used: dict[str, int] = {}   # cidr -> subnet index
        self._free = set(range(len(self.subnets)))
        self._lock = threading.Lock()

    def allocate(self) -> str | None:
        with self._lock:
            if not self._free:
                return None
            i = min(self._free)
            self._free.discard(i)
            cidr = str(self.subnets[i])
            self._used[cidr] = i
            return cidr

    def occupy(self, cidr: str) -> None:
        with self._lock:
            i = self._used.get(cidr)
            if i is None:
                try:
                    i = self.subnets.index(ipaddress.ip_network(cidr))
                except ValueError:
                    return  # outside our range (reference logs + skips)
                self._used[cidr] = i
                self._free.discard(i)

    def release(self, cidr: str) -> None:
        with self._lock:
            i = self._used.pop(cidr, None)
            if i is not None:
                self._free.add(i)


class NodeIpamController(Controller):
    name = "nodeipam"

    def __init__(self, client, factory, cluster_cidr: str = "10.244.0.0/16",
                 node_mask: int = 24):
        super().__init__(client, factory)
        self.cidrs = CidrSet(cluster_cidr, node_mask)
        self.node_informer = factory.informer(NODES)
        # rebuild occupancy from informer state before handling events
        for n in self.node_informer.list(None):
            cidr = (n.get("spec") or {}).get("podCIDR")
            if cidr:
                self.cidrs.occupy(cidr)
        self.node_informer.add_event_handler(self._on_node)

    def _on_node(self, type_, node, old) -> None:
        if type_ == kv.DELETED:
            cidr = (node.get("spec") or {}).get("podCIDR")
            if cidr:
                self.cidrs.release(cidr)
            return
        self.enqueue(node)

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        node = self.node_informer.get("", name)
        if node is None:
            return
        if (node.get("spec") or {}).get("podCIDR"):
            self.cidrs.occupy(node["spec"]["podCIDR"])
            return
        cidr = self.cidrs.allocate()
        if cidr is None:
            logger.error("nodeipam: cluster CIDR exhausted for node %s", name)
            return
        ok = False
        try:
            def patch(o):
                spec = o.setdefault("spec", {})
                if not spec.get("podCIDR"):
                    spec["podCIDR"] = cidr
                    spec["podCIDRs"] = [cidr]
                return o
            updated = self.client.guaranteed_update(NODES, "", name, patch)
            ok = (updated.get("spec") or {}).get("podCIDR") == cidr
        except kv.NotFoundError:
            pass
        finally:
            if not ok:
                self.cidrs.release(cidr)
