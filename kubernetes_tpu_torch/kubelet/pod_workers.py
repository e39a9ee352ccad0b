"""Pod workers: per-pod serialized update pipelines.

Reference: pkg/kubelet/pod_workers.go — syncLoopIteration never blocks on a
pod; each pod gets its own goroutine+channel processing updates in order,
with "work coalescing": if updates arrive while a sync runs, only the
latest is kept.  Reproduced with a small shared thread pool and per-pod
FIFO-of-one pending slots.

A copy of kubernetes_tpu/kubelet/pod_workers.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


class PodWorkers:
    def __init__(self, sync_fn: Callable[[str, dict], None],
                 max_workers: int = 8):
        self.sync_fn = sync_fn  # sync_fn(update_type, pod)
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="pod-worker")
        self._lock = threading.Lock()
        # uid -> {"running": bool, "pending": (type, pod) | None}
        self._state: Dict[str, dict] = {}
        self._closed = False

    def update_pod(self, update_type: str, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if self._closed:
                return
            st = self._state.setdefault(uid,
                                        {"running": False, "pending": None})
            if st["running"]:
                st["pending"] = (update_type, pod)  # coalesce: latest wins
                return
            st["running"] = True
        self._pool.submit(self._drain, uid, update_type, pod)

    def _drain(self, uid: str, update_type: str, pod: dict) -> None:
        while True:
            try:
                self.sync_fn(update_type, pod)
            except Exception:  # noqa: BLE001 — a pod sync must not kill the pool
                logger.exception("pod worker sync failed for %s", uid)
            with self._lock:
                st = self._state.get(uid)
                if st is None:
                    return
                if st["pending"] is None:
                    st["running"] = False
                    return
                update_type, pod = st["pending"]
                st["pending"] = None

    def forget_pod(self, uid: str) -> None:
        with self._lock:
            self._state.pop(uid, None)

    def stop(self) -> None:
        with self._lock:
            self._closed = True
        self._pool.shutdown(wait=False)
