"""Pod status manager.

Reference: pkg/kubelet/status — the kubelet's single writer to pod status:
callers set the local view; the manager syncs to the apiserver only when
the status actually changed (versioned cache), absorbing the N probe/PLEG
updates per change into one PATCH.

A copy of kubernetes_tpu/kubelet/status_manager.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import PODS, Client
from ..store import kv

logger = logging.getLogger(__name__)


class StatusManager:
    def __init__(self, client: Client):
        self.client = client
        self._lock = threading.Lock()
        # uid -> (version, status); version bumps on every local set
        self._statuses: Dict[str, Tuple[int, dict]] = {}
        self._synced_version: Dict[str, int] = {}
        self.api_writes = 0  # observability: how many PATCHes actually went

    def set_pod_status(self, pod: Obj, status: dict) -> None:
        uid = meta.uid(pod)
        with self._lock:
            version, old = self._statuses.get(uid, (0, None))
            if old == status:
                return
            self._statuses[uid] = (version + 1, status)
        self._sync(pod)

    def get_pod_status(self, uid: str) -> Optional[dict]:
        with self._lock:
            entry = self._statuses.get(uid)
            return entry[1] if entry else None

    def remove_pod(self, uid: str) -> None:
        with self._lock:
            self._statuses.pop(uid, None)
            self._synced_version.pop(uid, None)

    def _sync(self, pod: Obj) -> None:
        uid = meta.uid(pod)
        with self._lock:
            entry = self._statuses.get(uid)
            if entry is None:
                return
            version, status = entry
            if self._synced_version.get(uid, -1) >= version:
                return
        try:
            def patch(p):
                p.setdefault("status", {}).update(status)
                return p
            self.client.guaranteed_update(PODS, meta.namespace(pod),
                                          meta.name(pod), patch)
            with self._lock:
                self._synced_version[uid] = version
                self.api_writes += 1
        except kv.NotFoundError:
            self.remove_pod(uid)
        except kv.StoreError as e:
            logger.warning("status sync failed for %s: %s",
                           meta.namespaced_name(pod), e)
