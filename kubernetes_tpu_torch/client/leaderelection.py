"""Leader election via Lease CAS.

Reference: staging/src/k8s.io/client-go/tools/leaderelection/
  leaderelection.go:177 (Run), :200 (acquire loop), :241-272 (renew),
  :317 (tryAcquireOrRenew) and resourcelock/leaselock.go:31.

Crash-only HA: every control-plane component (scheduler, controller
manager) runs N replicas; one holds the Lease and renews it; on renewal
failure it stops leading and another replica acquires.

A copy of kubernetes_tpu/client/leaderelection.py (host code, its logic
unchanged): the same client calls on the same clock give the same
return values and the same Lease spec (tests/test_torch_cmd_scheduler.py
holds the two against each other).  stop() releases the Lease; the
scheduler's binary never calls it (cmd/scheduler.py: on SIGTERM a
follower takes over only once the Lease expires).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from typing import Callable

from ..api import meta
from ..store import kv
from .clientset import LEASES, Client

logger = logging.getLogger(__name__)


class LeaderElector:
    def __init__(self, client: Client, lock_name: str,
                 identity: str | None = None,
                 lease_duration: float = 15.0,
                 renew_deadline: float = 10.0,
                 retry_period: float = 2.0,
                 on_started_leading: Callable[[], None] | None = None,
                 on_stopped_leading: Callable[[], None] | None = None,
                 namespace: str = "kube-system"):
        self.client = client
        self.lock_name = lock_name
        self.namespace = namespace
        self.identity = identity or f"{lock_name}-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.renew_deadline = renew_deadline
        self.retry_period = retry_period
        self.on_started_leading = on_started_leading or (lambda: None)
        self.on_stopped_leading = on_stopped_leading or (lambda: None)
        self._stop = threading.Event()
        self._leading = False
        self._thread: threading.Thread | None = None

    @property
    def is_leader(self) -> bool:
        return self._leading

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"leaderelection-{self.lock_name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._leading:
            self._release()

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._try_acquire_or_renew():
                if not self._leading:
                    self._leading = True
                    logger.info("%s became leader of %s", self.identity,
                                self.lock_name)
                    self.on_started_leading()
            else:
                if self._leading:
                    self._leading = False
                    logger.info("%s lost leadership of %s", self.identity,
                                self.lock_name)
                    self.on_stopped_leading()
            self._stop.wait(self.retry_period)

    # tryAcquireOrRenew (leaderelection.go:317)
    def _try_acquire_or_renew(self) -> bool:
        now = time.time()
        try:
            lease = self.client.get(LEASES, self.namespace, self.lock_name)
        except kv.NotFoundError:
            lease = meta.new_object("Lease", self.lock_name, self.namespace)
            lease["spec"] = {"holderIdentity": self.identity,
                            "acquireTime": now, "renewTime": now,
                            "leaseDurationSeconds": self.lease_duration}
            try:
                self.client.create(LEASES, lease)
                return True
            except kv.StoreError:
                return False
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        expired = now > spec.get("renewTime", 0) + spec.get(
            "leaseDurationSeconds", self.lease_duration)
        if holder != self.identity and not expired:
            return False

        def claim(obj):
            s = obj.setdefault("spec", {})
            cur_holder = s.get("holderIdentity")
            cur_expired = time.time() > s.get("renewTime", 0) + s.get(
                "leaseDurationSeconds", self.lease_duration)
            if cur_holder != self.identity and not cur_expired:
                raise kv.ConflictError("lease held")
            if cur_holder != self.identity:
                s["acquireTime"] = time.time()
            s["holderIdentity"] = self.identity
            s["renewTime"] = time.time()
            s["leaseDurationSeconds"] = self.lease_duration
            return obj

        try:
            self.client.guaranteed_update(LEASES, self.namespace,
                                          self.lock_name, claim)
            return True
        except kv.StoreError:
            return False

    def _release(self) -> None:
        def drop(obj):
            s = obj.setdefault("spec", {})
            if s.get("holderIdentity") == self.identity:
                s["holderIdentity"] = ""
                s["renewTime"] = 0
            return obj
        try:
            self.client.guaranteed_update(LEASES, self.namespace,
                                          self.lock_name, drop)
        except kv.StoreError:
            pass
