"""StorageVersion publishing + garbage collection.

Reference: pkg/controller/storageversiongc/gc_controller.go — each
kube-apiserver publishes an identity Lease (kube-system, labeled
apiserver.kubernetes.io/identity=kube-apiserver) plus StorageVersion
objects recording, per resource, which encoding version THAT server
writes (serverStorageVersions entries keyed by apiServerID).  The GC
controller watches the identity leases: when a server's lease is deleted
or expires, its entries are stripped from every StorageVersion, and
StorageVersion objects left with no entries are deleted — so readers
always know the set of encodings possibly present in storage.

This control plane has one wire form per resource (SURVEY §2.5 —
code-generator N/A by design), so encodingVersion is always "v1"-shaped;
the machinery still matters for rolling multi-apiserver deployments,
which is why the VERDICT asked the row to stop being out of scope.

A copy of kubernetes_tpu/controllers/storageversion.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import LEASES
from ..store import kv
from .base import Controller

logger = logging.getLogger(__name__)

STORAGEVERSIONS = "storageversions"
IDENTITY_LABEL = "apiserver.kubernetes.io/identity"
IDENTITY_VALUE = "kube-apiserver"
LEASE_DURATION = 60.0  # identity lease TTL (controller-manager default-ish)

# the resources an apiserver publishes storage versions for (one wire
# form each — the point is the per-server bookkeeping, not conversions)
PUBLISHED_RESOURCES = ("pods", "nodes", "services", "deployments",
                      "replicasets", "secrets", "configmaps")


def publish_identity(client, server_id: str) -> None:
    """Create/renew the apiserver identity Lease (kube-system)."""
    lease = meta.new_object("Lease", server_id, "kube-system")
    lease["metadata"]["labels"] = {IDENTITY_LABEL: IDENTITY_VALUE}
    now = time.time()
    lease["spec"] = {"holderIdentity": server_id, "renewTime": now,
                     "leaseDurationSeconds": LEASE_DURATION}
    try:
        client.create(LEASES, lease)
    except kv.AlreadyExistsError:
        def renew(cur):
            cur.setdefault("spec", {})["renewTime"] = time.time()
            cur["spec"]["holderIdentity"] = server_id
            return cur
        client.guaranteed_update(LEASES, "kube-system", server_id, renew)


def publish_storage_versions(client, server_id: str,
                             resources=PUBLISHED_RESOURCES,
                             encoding: str = "v1") -> None:
    """Upsert this server's serverStorageVersions entries."""
    for res in resources:
        name = f"core.{res}"
        entry = {"apiServerID": server_id, "encodingVersion": encoding,
                 "decodableVersions": [encoding]}
        try:
            sv = meta.new_object("StorageVersion", name, None)
            sv["status"] = {"storageVersions": [entry],
                            "commonEncodingVersion": encoding}
            client.create(STORAGEVERSIONS, sv)
        except kv.AlreadyExistsError:
            def upsert(cur, entry=entry):
                entries = (cur.setdefault("status", {})
                           .setdefault("storageVersions", []))
                entries[:] = [e for e in entries
                              if e.get("apiServerID") != server_id]
                entries.append(entry)
                encs = {e.get("encodingVersion") for e in entries}
                cur["status"]["commonEncodingVersion"] = (
                    encs.pop() if len(encs) == 1 else None)
                return cur
            client.guaranteed_update(STORAGEVERSIONS, "", name, upsert)


class StorageVersionGC(Controller):
    """Strip dead servers' entries; delete empty StorageVersions."""

    name = "storage-version-gc"
    workers = 1

    def __init__(self, client, factory, resync: float = 30.0):
        super().__init__(client, factory)
        self.lease_informer = factory.informer(LEASES)
        self.sv_informer = factory.informer(STORAGEVERSIONS)
        self.lease_informer.add_event_handler(self._on_lease_event)
        self.sv_informer.add_event_handler(
            lambda t, obj, old: self.enqueue_key("sweep"))
        self._resync = resync
        self._ticker: threading.Thread | None = None

    def run(self) -> None:
        super().run()
        # expiry produces no watch event: periodic sweep (gc_controller's
        # lease re-list cadence)
        def tick():
            while not self._stopped.wait(self._resync):
                self.enqueue_key("sweep")
        self._ticker = threading.Thread(target=tick, daemon=True,
                                        name=f"{self.name}-resync")
        self._ticker.start()

    def _on_lease_event(self, type_: str, obj: Obj, old) -> None:
        labels = meta.labels(obj)
        if labels.get(IDENTITY_LABEL) == IDENTITY_VALUE:
            self.enqueue_key("sweep")

    def _live_server_ids(self) -> set[str]:
        now = time.time()
        out = set()
        for lease in self.lease_informer.list("kube-system"):
            if meta.labels(lease).get(IDENTITY_LABEL) != IDENTITY_VALUE:
                continue
            spec = lease.get("spec") or {}
            renew = spec.get("renewTime", 0)
            ttl = spec.get("leaseDurationSeconds", LEASE_DURATION)
            if now <= renew + ttl:
                out.add(spec.get("holderIdentity") or meta.name(lease))
        return out

    def sync(self, key: str) -> None:
        live = self._live_server_ids()
        for sv in self.sv_informer.list(None):
            entries = (sv.get("status") or {}).get("storageVersions") or []
            keep = [e for e in entries if e.get("apiServerID") in live]
            if len(keep) == len(entries):
                continue
            name = meta.name(sv)
            if not keep:
                logger.info("storage-version-gc: deleting %s "
                            "(no live servers)", name)
                try:
                    self.client.delete(STORAGEVERSIONS, "", name)
                except kv.NotFoundError:
                    pass
                continue

            def strip(cur, keep_ids=live):
                entries = (cur.setdefault("status", {})
                           .setdefault("storageVersions", []))
                entries[:] = [e for e in entries
                              if e.get("apiServerID") in keep_ids]
                encs = {e.get("encodingVersion") for e in entries}
                cur["status"]["commonEncodingVersion"] = (
                    encs.pop() if len(encs) == 1 else None)
                return cur
            try:
                self.client.guaranteed_update(STORAGEVERSIONS, "", name,
                                              strip)
            except kv.NotFoundError:
                pass
