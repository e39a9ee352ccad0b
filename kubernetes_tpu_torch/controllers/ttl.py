"""TTL controller.

Reference: pkg/controller/ttl/ttl_controller.go — annotates every Node with
`node.alpha.kubernetes.io/ttl`, the secret/configmap cache TTL kubelets may
use, scaled by cluster size (ttlBoundaries: 0s up to 100 nodes, 15s to 500,
30s to 1000, 60s to 2000, 300s above).

A copy of kubernetes_tpu/controllers/ttl.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..client.clientset import NODES
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)

TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"
# (max cluster size for this tier, ttl seconds) — ttl_controller.go:82
TTL_BOUNDARIES = [(100, 0), (500, 15), (1000, 30), (2000, 60)]
TTL_MAX = 300


class TTLController(Controller):
    name = "ttl"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.node_informer = factory.informer(NODES)
        self._last_ttl: int | None = None
        self.node_informer.add_event_handler(self._on_node)

    def _on_node(self, type_, node, old) -> None:
        # adds AND deletes can shift the cluster-size tier; when it moves,
        # every node's annotation is stale, not just the event's node
        ttl = self.desired_ttl()
        if ttl != self._last_ttl:
            self._last_ttl = ttl
            for n in self.node_informer.list(None):
                self.enqueue(n)
        if type_ != kv.DELETED:
            self.enqueue(node)

    def desired_ttl(self) -> int:
        n = len(self.node_informer.list(None))
        for bound, ttl in TTL_BOUNDARIES:
            if n <= bound:
                return ttl
        return TTL_MAX

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        node = self.node_informer.get("", name)
        if node is None:
            return
        want = str(self.desired_ttl())
        annotations = (node["metadata"].get("annotations") or {})
        if annotations.get(TTL_ANNOTATION) == want:
            return

        def patch(o):
            o["metadata"].setdefault("annotations", {})[TTL_ANNOTATION] = want
            return o
        try:
            self.client.guaranteed_update(NODES, "", name, patch)
        except kv.NotFoundError:
            pass
