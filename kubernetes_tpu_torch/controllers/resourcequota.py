"""ResourceQuota controller.

Reference: pkg/controller/resourcequota/ — recalculates each quota's
status.used from live objects whenever quota or pods change (plus a full
resync), so kubectl and the admission plugin see current usage.

A copy of kubernetes_tpu/controllers/resourcequota.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta, quantity
from ..api.meta import Obj
from ..client.clientset import PODS, RESOURCEQUOTAS
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)


class ResourceQuotaController(Controller):
    name = "resourcequota"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.rq_informer = factory.informer(RESOURCEQUOTAS)
        self.pod_informer = factory.informer(PODS)
        self.rq_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        for rq in self.rq_informer.list(meta.namespace(pod)):
            self.enqueue(rq)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        rq = self.rq_informer.get(ns, name)
        if rq is None:
            return
        hard = (rq.get("spec") or {}).get("hard") or {}
        pods = [p for p in self.pod_informer.list(ns)
                if (p.get("status") or {}).get("phase")
                not in ("Succeeded", "Failed")]
        cpu = sum(self._cpu(p) for p in pods)
        mem = sum(self._mem(p) for p in pods)
        used = {}
        for k in hard:
            if k == "pods":
                used[k] = str(len(pods))
            elif k in ("cpu", "requests.cpu"):
                used[k] = quantity.format_cpu_milli(cpu)
            elif k in ("memory", "requests.memory"):
                used[k] = quantity.format_mem_bytes(mem)
        status = {"hard": dict(hard), "used": used}
        if (rq.get("status") or {}) != status:
            def patch(o):
                o["status"] = status
                return o
            try:
                self.client.guaranteed_update(RESOURCEQUOTAS, ns, name, patch)
            except kv.NotFoundError:
                pass

    @staticmethod
    def _cpu(pod) -> int:
        return sum(quantity.parse_cpu_milli(
            ((c.get("resources") or {}).get("requests") or {}).get("cpu", "0"))
            for c in (pod.get("spec") or {}).get("containers", []))

    @staticmethod
    def _mem(pod) -> int:
        return sum(quantity.parse_mem_bytes(
            ((c.get("resources") or {}).get("requests") or {})
            .get("memory", "0"))
            for c in (pod.get("spec") or {}).get("containers", []))
