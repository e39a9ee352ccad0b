"""tests/test_garbagecollector.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

Garbage collector: dependency graph, cascading deletion, finalizers.

Reference semantics:
  pkg/controller/garbagecollector/garbagecollector.go attemptToDeleteItem
  (solid/dangling/waiting owner classification),
  graph_builder.go (uid graph over ownerReferences),
  foregroundDeletion / orphan finalizer processing,
  blockOwnerDeletion.
"""

import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.controllers.garbagecollector import GarbageCollector
from kubernetes_tpu_torch.store import kv


def wait_for(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def gc_cluster():
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    gc = GarbageCollector(client, factory)
    factory.start()
    factory.wait_for_cache_sync()
    gc.run()
    yield store, client, gc
    gc.stop()
    factory.stop()


def owner_ref(owner, block=False, controller=True):
    ref = {"apiVersion": owner.get("apiVersion", "v1"),
           "kind": owner["kind"], "name": meta.name(owner),
           "uid": meta.uid(owner), "controller": controller}
    if block:
        ref["blockOwnerDeletion"] = True
    return ref


def make_owned(kind, name, owners, ns="default"):
    obj = meta.new_object(kind, name, ns)
    obj["metadata"]["ownerReferences"] = [
        owner_ref(o, block=b) for o, b in owners]
    return obj


def gone(store, resource, ns, name):
    def check():
        try:
            store.get(resource, ns, name)
            return False
        except kv.NotFoundError:
            return True
    return check


class TestBackgroundCascade:
    def test_two_level_cascade(self, gc_cluster):
        store, client, gc = gc_cluster
        dep = client.create("deployments",
                            meta.new_object("Deployment", "web"))
        rs = client.create("replicasets", make_owned(
            "ReplicaSet", "web-1", [(dep, False)]))
        for i in range(3):
            client.create("pods", make_owned(
                "Pod", f"web-1-{i}", [(rs, False)]))
        assert wait_for(lambda: gc.graph_size() >= 5)

        client.delete("deployments", "default", "web")
        assert wait_for(gone(store, "replicasets", "default", "web-1"))
        for i in range(3):
            assert wait_for(gone(store, "pods", "default", f"web-1-{i}"))

    def test_solid_owner_keeps_dependent(self, gc_cluster):
        store, client, gc = gc_cluster
        rs = client.create("replicasets",
                           meta.new_object("ReplicaSet", "keep"))
        client.create("pods", make_owned("Pod", "keep-0", [(rs, False)]))
        time.sleep(0.5)  # give the GC a chance to do the wrong thing
        assert store.get("pods", "default", "keep-0") is not None

    def test_one_solid_owner_among_dangling_keeps(self, gc_cluster):
        store, client, gc = gc_cluster
        a = client.create("replicasets", meta.new_object("ReplicaSet", "a"))
        b = client.create("jobs", meta.new_object("Job", "b"))
        client.create("pods", make_owned("Pod", "shared",
                                         [(a, False), (b, False)]))
        client.delete("replicasets", "default", "a")
        time.sleep(0.5)
        assert store.get("pods", "default", "shared") is not None
        client.delete("jobs", "default", "b")
        assert wait_for(gone(store, "pods", "default", "shared"))

    def test_recreated_owner_is_not_my_owner(self, gc_cluster):
        store, client, gc = gc_cluster
        rs = client.create("replicasets", meta.new_object("ReplicaSet", "r"))
        client.create("pods", make_owned("Pod", "r-0", [(rs, False)]))
        client.delete("replicasets", "default", "r")
        # recreate under the same name: new uid, so the pod is STILL an
        # orphan (uid mismatch = dangling)
        client.create("replicasets", meta.new_object("ReplicaSet", "r"))
        assert wait_for(gone(store, "pods", "default", "r-0"))

    def test_unknown_owner_kind_never_cascades(self, gc_cluster):
        store, client, gc = gc_cluster
        pod = meta.new_object("Pod", "cr-owned")
        pod["metadata"]["ownerReferences"] = [{
            "apiVersion": "example.com/v1", "kind": "Widget",
            "name": "w", "uid": "w-uid-1"}]
        client.create("pods", pod)
        time.sleep(0.5)
        assert store.get("pods", "default", "cr-owned") is not None


class TestForegroundDeletion:
    def test_foreground_deletes_blocking_dependents_first(self, gc_cluster):
        store, client, gc = gc_cluster
        rs = client.create("replicasets", meta.new_object("ReplicaSet", "fg"))
        for i in range(2):
            client.create("pods", make_owned("Pod", f"fg-{i}",
                                             [(rs, True)]))
        assert wait_for(lambda: gc.graph_size() >= 3)
        client.delete("replicasets", "default", "fg",
                      propagation_policy="Foreground")
        # the owner parks terminating until its blocking dependents go
        cur = store.get("replicasets", "default", "fg")
        assert cur["metadata"]["deletionTimestamp"]
        assert meta.FOREGROUND_FINALIZER in cur["metadata"]["finalizers"]
        for i in range(2):
            assert wait_for(gone(store, "pods", "default", f"fg-{i}"))
        # ... then the GC strips the finalizer and the delete completes
        assert wait_for(gone(store, "replicasets", "default", "fg"))

    def test_nonblocking_dependents_do_not_block(self, gc_cluster):
        store, client, gc = gc_cluster
        rs = client.create("replicasets", meta.new_object("ReplicaSet", "nb"))
        client.create("pods", make_owned("Pod", "nb-0", [(rs, False)]))
        assert wait_for(lambda: gc.graph_size() >= 2)
        client.delete("replicasets", "default", "nb",
                      propagation_policy="Foreground")
        # owner completes without waiting on the non-blocking dependent
        assert wait_for(gone(store, "replicasets", "default", "nb"))
        # and the dependent is then collected as an orphan
        assert wait_for(gone(store, "pods", "default", "nb-0"))


class TestOrphanPropagation:
    def test_orphan_detaches_dependents(self, gc_cluster):
        store, client, gc = gc_cluster
        rs = client.create("replicasets", meta.new_object("ReplicaSet", "op"))
        for i in range(2):
            client.create("pods", make_owned("Pod", f"op-{i}",
                                             [(rs, True)]))
        assert wait_for(lambda: gc.graph_size() >= 3)
        client.delete("replicasets", "default", "op",
                      propagation_policy="Orphan")
        assert wait_for(gone(store, "replicasets", "default", "op"))
        time.sleep(0.5)
        for i in range(2):
            pod = store.get("pods", "default", f"op-{i}")
            assert "ownerReferences" not in pod["metadata"]


class TestHTTPDeleteOptions:
    def test_propagation_policy_over_http(self):
        from kubernetes_tpu_torch.apiserver import APIServer
        from kubernetes_tpu_torch.client.http_client import HTTPClient
        store = kv.MemoryStore()
        server = APIServer(store).start()
        try:
            c = HTTPClient.from_url(server.url)
            c.create("replicasets", meta.new_object("ReplicaSet", "h"))
            c.delete("replicasets", "default", "h",
                     propagation_policy="Foreground")
            cur = store.get("replicasets", "default", "h")
            assert meta.FOREGROUND_FINALIZER in cur["metadata"]["finalizers"]
        finally:
            server.stop()
