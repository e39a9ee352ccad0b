"""Node lifecycle controller.

Reference: pkg/controller/nodelifecycle/ — monitors node heartbeats (Lease
renewTime + node status); a node missing heartbeats past the grace period
is marked NotReady and tainted unreachable; its pods are evicted (deleted)
after the eviction grace so their controllers reschedule them elsewhere.

A copy of kubernetes_tpu/controllers/nodelifecycle.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import LEASES, NODES, PODS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv

logger = logging.getLogger(__name__)

UNREACHABLE_TAINT = {"key": "node.kubernetes.io/unreachable",
                     "effect": "NoExecute"}
# admission (TaintNodesByCondition) starts every node with this taint;
# this controller lifts it on the first Ready observation and restores
# it while the node is NotReady (pkg/controller/nodelifecycle
# taint-based eviction's condition->taint mapping)
NOT_READY_TAINT = {"key": "node.kubernetes.io/not-ready",
                   "effect": "NoSchedule"}


class NodeLifecycleController:
    """Periodic monitor (not queue-driven: liveness is time-based)."""

    name = "nodelifecycle"

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 grace_period: float = 40.0, tick: float = 5.0):
        self.client = client
        self.node_informer = factory.informer(NODES)
        self.pod_informer = factory.informer(PODS)
        self.grace = grace_period
        self.tick = tick
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick):
            try:
                self._monitor()
            except Exception:  # noqa: BLE001
                logger.exception("nodelifecycle monitor failed")

    def _heartbeat(self, node: Obj) -> float:
        try:
            lease = self.client.get(LEASES, "kube-node-lease", meta.name(node))
            return (lease.get("spec") or {}).get("renewTime", 0.0)
        except kv.NotFoundError:
            # fall back to the node's own status heartbeat
            return (node.get("status") or {}).get("lastHeartbeatTime", 0.0)

    def _monitor(self) -> None:
        now = time.time()
        for node in self.node_informer.list():
            hb = self._heartbeat(node)
            if hb == 0.0:
                continue  # never heartbeated: likely a synthetic/test node
            name = meta.name(node)
            ready = self._is_ready(node)
            if now - hb > self.grace:
                if ready:
                    logger.info("node %s missed heartbeats; marking NotReady", name)
                    self._set_ready(node, False)
                self._evict_pods(name)
            elif not ready:
                logger.info("node %s heartbeat recovered; marking Ready", name)
                self._set_ready(node, True)
            elif any(t.get("key") == NOT_READY_TAINT["key"]
                     for t in (node.get("spec") or {}).get("taints") or ()):
                # Ready and heartbeating but still carrying the
                # admission-time not-ready taint: lift it (the node's
                # first transition into service)
                self._set_ready(node, True)

    @staticmethod
    def _is_ready(node: Obj) -> bool:
        conds = (node.get("status") or {}).get("conditions") or []
        for c in conds:
            if c.get("type") == "Ready":
                return c.get("status") == "True"
        return True

    def _set_ready(self, node: Obj, ready: bool) -> None:
        def patch(n):
            conds = n.setdefault("status", {}).setdefault("conditions", [])
            conds[:] = [c for c in conds if c.get("type") != "Ready"]
            conds.append({"type": "Ready",
                          "status": "True" if ready else "False"})
            taints = n.setdefault("spec", {}).setdefault("taints", [])
            taints[:] = [t for t in taints
                         if t.get("key") not in (UNREACHABLE_TAINT["key"],
                                                 NOT_READY_TAINT["key"])]
            if not ready:
                taints.append(dict(UNREACHABLE_TAINT))
                taints.append(dict(NOT_READY_TAINT))
            return n
        try:
            self.client.guaranteed_update(NODES, "", meta.name(node), patch)
        except kv.NotFoundError:
            pass

    def _evict_pods(self, node_name: str) -> None:
        for pod in self.pod_informer.list():
            if meta.pod_node_name(pod) != node_name:
                continue
            tolerates = any(
                t.get("key") == UNREACHABLE_TAINT["key"]
                for t in (pod.get("spec") or {}).get("tolerations") or ())
            if tolerates:
                continue
            logger.info("evicting pod %s from unreachable node %s",
                        meta.namespaced_name(pod), node_name)
            try:
                self.client.delete(PODS, meta.namespace(pod), meta.name(pod))
            except kv.NotFoundError:
                pass
