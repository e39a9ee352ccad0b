"""tests/test_egress_storageversion.py's StorageVersion GC scenarios on
the port's classes (kubernetes_tpu_torch/controllers/storageversion.py),
the same code with the imports pointing at the port, bar one wait.

test_publish_and_gc_on_lease_delete waits, with a bound, until the
controller's Lease informer holds both identity Leases before the storage
versions are published.  The reference's test publishes at once: a sweep
that runs before the informer has the second Lease strips the second
server's entry as dead, and the test's read of two entries then fails
(ROADMAP R2 lists it among the reference tests that fail in some runs).

Reference:
  pkg/controller/storageversiongc/gc_controller.go
"""

import time

import pytest

from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import LEASES
from kubernetes_tpu_torch.controllers.storageversion import (
    STORAGEVERSIONS, StorageVersionGC, publish_identity,
    publish_storage_versions,
)
from kubernetes_tpu_torch.store import kv


def wait_for(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def gc_env():
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    ctrl = StorageVersionGC(client, factory, resync=0.2)
    factory.start()
    factory.wait_for_cache_sync()
    ctrl.run()
    yield store, client, ctrl
    ctrl.stop()
    factory.stop()


class TestStorageVersionGC:
    def test_publish_and_gc_on_lease_delete(self, gc_env):
        store, client, ctrl = gc_env
        publish_identity(client, "apiserver-a")
        publish_identity(client, "apiserver-b")
        # a sweep must not find apiserver-b's entry before its Lease
        assert wait_for(lambda: {"apiserver-a", "apiserver-b"}
                        <= ctrl._live_server_ids())
        publish_storage_versions(client, "apiserver-a")
        publish_storage_versions(client, "apiserver-b")
        sv = store.get(STORAGEVERSIONS, "", "core.pods")
        assert len(sv["status"]["storageVersions"]) == 2
        assert sv["status"]["commonEncodingVersion"] == "v1"

        # server B dies: its lease is deleted -> entries stripped
        client.delete(LEASES, "kube-system", "apiserver-b")
        assert wait_for(lambda: len(
            store.get(STORAGEVERSIONS, "", "core.pods")["status"]
            ["storageVersions"]) == 1)
        left = store.get(STORAGEVERSIONS, "", "core.pods")
        assert left["status"]["storageVersions"][0][
            "apiServerID"] == "apiserver-a"

    def test_sv_object_deleted_when_no_servers_remain(self, gc_env):
        store, client, ctrl = gc_env
        publish_identity(client, "apiserver-x")
        publish_storage_versions(client, "apiserver-x", resources=("pods",))
        client.delete(LEASES, "kube-system", "apiserver-x")

        def gone():
            try:
                store.get(STORAGEVERSIONS, "", "core.pods")
                return False
            except kv.NotFoundError:
                return True
        assert wait_for(gone)

    def test_expired_lease_is_dead(self, gc_env):
        store, client, ctrl = gc_env
        publish_identity(client, "apiserver-old")
        publish_storage_versions(client, "apiserver-old",
                                 resources=("pods",))
        # age the lease past its TTL (no delete event — the periodic
        # sweep must catch it)
        def age(cur):
            cur["spec"]["renewTime"] = time.time() - 3600
            return cur
        client.guaranteed_update(LEASES, "kube-system", "apiserver-old",
                                 age)

        def gone():
            try:
                store.get(STORAGEVERSIONS, "", "core.pods")
                return False
            except kv.NotFoundError:
                return True
        assert wait_for(gone)

    def test_renewal_keeps_entries(self, gc_env):
        store, client, ctrl = gc_env
        publish_identity(client, "apiserver-live")
        publish_storage_versions(client, "apiserver-live",
                                 resources=("pods",))
        time.sleep(0.6)  # several sweep cycles
        sv = store.get(STORAGEVERSIONS, "", "core.pods")
        assert len(sv["status"]["storageVersions"]) == 1
