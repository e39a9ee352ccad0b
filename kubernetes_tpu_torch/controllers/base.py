"""Controller skeleton: informer events -> rate-limited workqueue ->
N sync workers -> idempotent sync(key).

Reference: the canonical controller pattern (SURVEY.md §3.4):
pkg/controller/replicaset/replica_set.go:528,533 (worker/processNextWorkItem)
— informer handlers enqueue keys, workers pop, sync, forget on success /
rate-limited requeue on error.

A copy of kubernetes_tpu/controllers/base.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import Client
from ..client.informer import SharedInformerFactory
from ..client.workqueue import RateLimitingQueue

logger = logging.getLogger(__name__)


class Controller:
    name = "controller"
    workers = 2
    max_requeues = 15

    def __init__(self, client: Client, factory: SharedInformerFactory):
        self.client = client
        self.factory = factory
        self.queue = RateLimitingQueue()
        self._threads: list[threading.Thread] = []
        self._stopped = threading.Event()

    # subclasses wire informers in __init__ and implement sync()
    def sync(self, key: str) -> None:
        raise NotImplementedError

    def enqueue(self, obj: Obj) -> None:
        self.queue.add(meta.namespaced_name(obj))

    def enqueue_key(self, key: str) -> None:
        self.queue.add(key)

    def run(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(target=self._worker,
                                 name=f"{self.name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stopped.set()
        self.queue.shut_down()

    def _worker(self) -> None:
        while True:
            key, shutdown = self.queue.get()
            if shutdown:
                return
            try:
                self.sync(key)
            except Exception:  # noqa: BLE001 - controller must survive
                if self.queue.rate_limiter.num_requeues(key) < self.max_requeues:
                    logger.exception("%s: sync(%s) failed; requeueing",
                                     self.name, key)
                    self.queue.add_rate_limited(key)
                else:
                    logger.exception("%s: sync(%s) failed too often; dropping",
                                     self.name, key)
                    self.queue.forget(key)
            else:
                self.queue.forget(key)
            finally:
                self.queue.done(key)


class Expectations:
    """Controller expectations (pkg/controller/controller_utils.go
    ControllerExpectations): dampen informer lag.  After a sync creates or
    deletes N children, it records N expected add/delete events; until the
    informer has delivered them (or the expectation times out), further
    syncs of that key must not mutate children — otherwise a second sync
    racing the informer re-creates/re-deletes the same diff."""

    TIMEOUT = 300.0  # ExpectationsTimeout (controller_utils.go:328)

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # key -> [pending_adds, pending_dels, set_time]
        self._by_key: dict[str, list] = {}

    def expect_creations(self, key: str, n: int) -> None:
        with self._lock:
            self._by_key[key] = [n, 0, time.monotonic()]

    def expect_deletions(self, key: str, n: int) -> None:
        with self._lock:
            self._by_key[key] = [0, n, time.monotonic()]

    def creation_observed(self, key: str) -> None:
        self._observed(key, 0)

    def deletion_observed(self, key: str) -> None:
        self._observed(key, 1)

    def _observed(self, key: str, idx: int) -> None:
        with self._lock:
            e = self._by_key.get(key)
            if e is not None:
                e[idx] -= 1

    def satisfied(self, key: str) -> bool:
        with self._lock:
            e = self._by_key.get(key)
            if e is None:
                return True
            if e[0] <= 0 and e[1] <= 0:
                del self._by_key[key]
                return True
            if time.monotonic() - e[2] > self.TIMEOUT:
                del self._by_key[key]
                return True
            return False

    def delete(self, key: str) -> None:
        with self._lock:
            self._by_key.pop(key, None)


def split_key(key: str) -> tuple[str, str]:
    ns, _, name = key.partition("/")
    return (ns, name) if name else ("", ns)


def owner_ref(obj: Obj, kind: str) -> Obj:
    return {"apiVersion": "v1", "kind": kind, "name": meta.name(obj),
            "uid": meta.uid(obj), "controller": True,
            "blockOwnerDeletion": True}


def is_owned_by(obj: Obj, owner: Obj) -> bool:
    ref = meta.controller_ref(obj)
    return ref is not None and ref.get("uid") == meta.uid(owner)
