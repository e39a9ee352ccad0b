"""Pod garbage collector.

Reference: pkg/controller/podgc/ — periodic sweep that deletes:
(1) terminated pods (Succeeded/Failed) beyond terminated-pod-gc-threshold,
oldest first; (2) pods bound to nodes that no longer exist; (3) unscheduled
pods marked for deletion.

A copy of kubernetes_tpu/controllers/podgc.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import NODES, PODS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv

logger = logging.getLogger(__name__)


class PodGCController:
    name = "podgc"

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 terminated_pod_threshold: int = 12500, tick: float = 20.0):
        self.client = client
        self.pod_informer = factory.informer(PODS)
        self.node_informer = factory.informer(NODES)
        self.threshold = terminated_pod_threshold
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
                self.gc_once()
            except Exception:  # noqa: BLE001
                logger.exception("podgc sweep failed")

    def gc_once(self) -> None:
        pods = self.pod_informer.list(None)
        nodes = {meta.name(n) for n in self.node_informer.list(None)}
        self._gc_terminated(pods)
        self._gc_orphaned(pods, nodes)
        self._gc_unscheduled_terminating(pods)

    def _gc_terminated(self, pods: list[Obj]) -> None:
        terminated = [p for p in pods
                      if (p.get("status") or {}).get("phase")
                      in ("Succeeded", "Failed")]
        excess = len(terminated) - self.threshold
        if excess <= 0:
            return
        terminated.sort(key=meta.creation_timestamp)
        for p in terminated[:excess]:
            self._delete(p)

    def _gc_orphaned(self, pods: list[Obj], nodes: set[str]) -> None:
        for p in pods:
            node = meta.pod_node_name(p)
            if node and node not in nodes:
                self._delete(p)

    def _gc_unscheduled_terminating(self, pods: list[Obj]) -> None:
        for p in pods:
            if (meta.deletion_timestamp(p) is not None
                    and not meta.pod_node_name(p)):
                self._delete(p)

    def _delete(self, pod: Obj) -> None:
        try:
            self.client.delete(PODS, meta.namespace(pod), meta.name(pod))
        except kv.NotFoundError:
            pass
