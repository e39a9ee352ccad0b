"""Eviction manager.

Reference: pkg/kubelet/eviction — observes node resource pressure against
signal thresholds (memory.available, nodefs.available, pid.available);
under pressure it sets the node condition (MemoryPressure/DiskPressure),
ranks pods (BestEffort first, then Burstable exceeding requests, by
priority) and evicts until the signal clears, stamping the pod Failed with
reason Evicted.

Stats come from a pluggable provider; the default derives memory usage
from pod requests (kubemark-style synthetic stats).

A copy of kubernetes_tpu/kubelet/eviction.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from ..api import meta, quantity
from ..api.meta import Obj
from ..client.clientset import NODES, PODS, Client
from ..store import kv
from .qos import eviction_rank

logger = logging.getLogger(__name__)


def requests_stats_provider(pods: List[Obj]) -> int:
    """-> memory working set in bytes, synthesized from requests."""
    total = 0
    for p in pods:
        for c in (p.get("spec") or {}).get("containers") or ():
            req = (c.get("resources") or {}).get("requests") or {}
            total += quantity.parse_mem_bytes(req.get("memory", "0"))
    return total


class EvictionManager:
    def __init__(self, client: Client, node_name: str,
                 memory_capacity: int,
                 memory_available_threshold: float = 0.05,
                 stats_provider: Callable = requests_stats_provider,
                 list_pods: Optional[Callable] = None):
        self.client = client
        self.node_name = node_name
        self.memory_capacity = memory_capacity
        # threshold as a fraction of capacity (eviction-hard
        # memory.available<5% equivalent)
        self.memory_available_threshold = memory_available_threshold
        self.stats_provider = stats_provider
        self.list_pods = list_pods or (lambda: [])
        self.under_pressure = False

    def synchronize(self) -> List[str]:
        """One reconcile (eviction manager main loop body).  Returns the
        names of pods evicted this round."""
        pods = [p for p in self.list_pods()
                if not meta.pod_is_terminal(p)
                and meta.deletion_timestamp(p) is None]
        evicted: List[str] = []
        while True:
            used = self.stats_provider(pods)
            available = self.memory_capacity - used
            pressure = available < (self.memory_capacity
                                    * self.memory_available_threshold)
            if pressure != self.under_pressure:
                self.under_pressure = pressure
                self._set_node_condition(pressure)
            if not pressure or not pods:
                break
            victim = min(pods, key=eviction_rank)
            self._evict(victim)
            evicted.append(meta.name(victim))
            pods.remove(victim)
        return evicted

    def _evict(self, pod: Obj) -> None:
        logger.info("evicting pod %s: node %s under memory pressure",
                    meta.namespaced_name(pod), self.node_name)
        try:
            def patch(p):
                p.setdefault("status", {}).update({
                    "phase": "Failed", "reason": "Evicted",
                    "message": "The node was low on resource: memory."})
                return p
            self.client.guaranteed_update(PODS, meta.namespace(pod),
                                          meta.name(pod), patch)
        except kv.StoreError:
            pass

    def _set_node_condition(self, pressure: bool) -> None:
        cond = {"type": "MemoryPressure",
                "status": "True" if pressure else "False",
                "lastTransitionTime": time.time()}
        try:
            def patch(n):
                conds = [c for c in (n.get("status") or {})
                         .get("conditions", [])
                         if c.get("type") != "MemoryPressure"]
                conds.append(cond)
                n.setdefault("status", {})["conditions"] = conds
                return n
            self.client.guaranteed_update(NODES, "", self.node_name, patch)
        except kv.StoreError:
            pass
