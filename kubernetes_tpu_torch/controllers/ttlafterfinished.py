"""TTL-after-finished controller.

Reference: pkg/controller/ttlafterfinished/ — Jobs with
spec.ttlSecondsAfterFinished are deleted TTL seconds after they reach
Complete/Failed.  Completion time comes from status.completionTime (we
stamp it when the condition appears if absent).

A copy of kubernetes_tpu/controllers/ttlafterfinished.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import JOBS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv

logger = logging.getLogger(__name__)


def _finished_at(job: Obj) -> float | None:
    status = job.get("status") or {}
    conds = status.get("conditions") or []
    if not any(c.get("type") in ("Complete", "Failed")
               and c.get("status") == "True" for c in conds):
        return None
    ct = status.get("completionTime")
    return float(ct) if ct is not None else None


class TTLAfterFinishedController:
    name = "ttlafterfinished"

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 tick: float = 5.0):
        self.client = client
        self.job_informer = factory.informer(JOBS)
        self.tick = tick
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # completionTime is stamped by the job controller in the same
        # status write that sets the Complete/Failed condition; stamping it
        # here too would race that writer and shift the TTL deadline.

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick):
            try:
                self.sweep_once(time.time())
            except Exception:  # noqa: BLE001
                logger.exception("ttl-after-finished sweep failed")

    def sweep_once(self, now: float) -> None:
        for job in self.job_informer.list(None):
            ttl = (job.get("spec") or {}).get("ttlSecondsAfterFinished")
            if ttl is None:
                continue
            done_at = _finished_at(job)
            if done_at is not None and now >= done_at + float(ttl):
                try:
                    self.client.delete(JOBS, meta.namespace(job),
                                       meta.name(job))
                except kv.NotFoundError:
                    pass
