"""Crash-only recovery in the port: a scheduler that dies mid-flight is
replaced by a fresh one that rebuilds from the store, a restarted
controller manager reconverges a ReplicaSet changed while it was down,
and HTTP watch clients relist once the apiserver's serving layer
restarts.  The port's counterparts of tests/test_chaos_recovery.py's
three classes.
"""

import time

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import NODES, PODS
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.scheduler import (
    Profile, Scheduler, new_default_framework,
)
from kubernetes_tpu_torch.store import kv
from kubernetes_tpu_torch.testing import make_node, make_pod


def wait_for(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def new_scheduler(client):
    factory = SharedInformerFactory(client)
    fw = new_default_framework(client, factory)
    sched = Scheduler(client, factory, {"default-scheduler": Profile(fw)})
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    return sched, factory


def scheduled(client):
    return [p for p in client.list(PODS, "default")[0]
            if meta.pod_node_name(p)]


class TestSchedulerCrashRecovery:
    def test_scheduler_restart_resumes_pending_pods(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        for i in range(4):
            client.create(NODES, make_node(f"cr-{i}").build())
        sched, factory = new_scheduler(client)
        for i in range(10):
            client.create(PODS,
                          make_pod(f"a{i}").req(cpu="100m").build())
        assert wait_for(lambda: len(scheduled(client)) == 10)

        # crash: scheduler + informers die with in-memory state
        sched.stop()
        factory.stop()

        # pods created while nobody is scheduling pile up pending
        for i in range(10):
            client.create(PODS,
                          make_pod(f"b{i}").req(cpu="100m").build())
        assert len(scheduled(client)) == 10

        # fresh scheduler = re-list + re-watch; cache rebuilt, backlog drains
        sched2, factory2 = new_scheduler(client)
        try:
            assert wait_for(lambda: len(scheduled(client)) == 20)
            # the rebuilt cache agrees with the apiserver
            from kubernetes_tpu_torch.scheduler.debugger import CacheDebugger
            diff = CacheDebugger(sched2, client).compare()
            assert not diff["nodes"]["missing"] and not diff["pods"]["missing"]
        finally:
            sched2.stop()
            factory2.stop()


class TestControllerCrashRecovery:
    def test_controller_manager_restart_reconverges(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        factory = SharedInformerFactory(client)
        mgr = ControllerManager(client, factory,
                                controllers=("replicaset",))
        factory.start()
        factory.wait_for_cache_sync()
        mgr.run()

        rs = meta.new_object("ReplicaSet", "cr-rs", "default")
        rs["spec"] = {"replicas": 3,
                      "selector": {"matchLabels": {"app": "cr"}},
                      "template": {"metadata": {"labels": {"app": "cr"}},
                                   "spec": {"containers": [
                                       {"name": "c0", "image": "img"}]}}}
        client.create("replicasets", rs)
        assert wait_for(lambda: len(client.list(PODS, "default")[0]) == 3)
        mgr.stop()
        factory.stop()

        # scale up while the controller is down; delete a pod too
        def scale(o):
            o["spec"]["replicas"] = 5
            return o
        client.guaranteed_update("replicasets", "default", "cr-rs", scale)
        victim = client.list(PODS, "default")[0][0]
        client.delete(PODS, "default", meta.name(victim))
        assert len(client.list(PODS, "default")[0]) == 2

        factory2 = SharedInformerFactory(client)
        mgr2 = ControllerManager(client, factory2,
                                 controllers=("replicaset",))
        factory2.start()
        factory2.wait_for_cache_sync()
        mgr2.run()
        try:
            assert wait_for(lambda: len([
                p for p in client.list(PODS, "default")[0]
                if meta.deletion_timestamp(p) is None]) == 5)
        finally:
            mgr2.stop()
            factory2.stop()


class TestApiserverRestart:
    def test_http_clients_relist_after_apiserver_restart(self):
        """Store survives (etcd role); the HTTP serving layer restarts and
        watch clients recover via relist (reflector TooOld semantics)."""
        from kubernetes_tpu_torch.apiserver import APIServer
        from kubernetes_tpu_torch.client.http_client import HTTPClient

        store = kv.MemoryStore()
        server = APIServer(store).start()
        url = server.url
        client = HTTPClient.from_url(url)
        factory = SharedInformerFactory(client)
        factory.start()
        factory.wait_for_cache_sync()
        store.create(NODES, make_node("ar-1").build())
        inf = factory.informer(NODES)
        assert wait_for(lambda: inf.get("", "ar-1") is not None)

        server.stop()
        # object written while the API is down (by a co-located writer)
        store.create(NODES, make_node("ar-2").build())
        server2 = APIServer(store, port=server.port).start()
        try:
            assert wait_for(lambda: inf.get("", "ar-2") is not None,
                            timeout=30.0)
        finally:
            factory.stop()
            server2.stop()
