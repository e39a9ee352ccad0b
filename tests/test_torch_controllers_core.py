"""tests/test_controllers.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

Controller tests: ReplicaSet/Deployment/Job reconcile loops, garbage
collection, leader election. Mirrors pkg/controller/*/..._test.go reduced
to the behavioral contracts."""

import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import (
    DEPLOYMENTS, JOBS, LEASES, PODS, REPLICASETS,
)
from kubernetes_tpu_torch.client.leaderelection import LeaderElector
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.store import kv


def wait_for(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


@pytest.fixture
def cluster():
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    mgr = ControllerManager(client, factory)
    factory.start()
    factory.wait_for_cache_sync()
    mgr.run()
    yield store, client
    mgr.stop()
    factory.stop()


def make_rs(name, replicas, labels=None, ns="default"):
    labels = labels or {"app": name}
    rs = meta.new_object("ReplicaSet", name, ns)
    rs["spec"] = {
        "replicas": replicas,
        "selector": {"matchLabels": labels},
        "template": {"metadata": {"labels": dict(labels)},
                     "spec": {"containers": [{"name": "c0", "image": "img"}]}},
    }
    return rs


def make_deployment(name, replicas, image="img:v1", ns="default"):
    dep = meta.new_object("Deployment", name, ns)
    dep["spec"] = {
        "replicas": replicas,
        "selector": {"matchLabels": {"app": name}},
        "template": {"metadata": {"labels": {"app": name}},
                     "spec": {"containers": [{"name": "c0", "image": image}]}},
    }
    return dep


def pods_of(client, ns="default"):
    return client.list(PODS, ns)[0]


class TestReplicaSet:
    def test_scales_up(self, cluster):
        store, client = cluster
        client.create(REPLICASETS, make_rs("web", 3))
        assert wait_for(lambda: len(pods_of(client)) == 3)
        for p in pods_of(client):
            ref = meta.controller_ref(p)
            assert ref["kind"] == "ReplicaSet" and ref["name"] == "web"

    def test_scales_down(self, cluster):
        store, client = cluster
        client.create(REPLICASETS, make_rs("web", 3))
        assert wait_for(lambda: len(pods_of(client)) == 3)
        client.guaranteed_update(REPLICASETS, "default", "web",
                                 lambda o: {**o, "spec": {**o["spec"], "replicas": 1}})
        assert wait_for(lambda: len(pods_of(client)) == 1)

    def test_replaces_deleted_pod(self, cluster):
        store, client = cluster
        client.create(REPLICASETS, make_rs("web", 2))
        assert wait_for(lambda: len(pods_of(client)) == 2)
        victim = pods_of(client)[0]
        client.delete(PODS, "default", meta.name(victim))
        assert wait_for(lambda: len(pods_of(client)) == 2)

    def test_status_updated(self, cluster):
        store, client = cluster
        client.create(REPLICASETS, make_rs("web", 2))
        assert wait_for(lambda: (client.get(REPLICASETS, "default", "web")
                                 .get("status") or {}).get("replicas") == 2)


class TestDeployment:
    def test_creates_rs_and_pods(self, cluster):
        store, client = cluster
        client.create(DEPLOYMENTS, make_deployment("api", 2))
        assert wait_for(lambda: len(client.list(REPLICASETS, "default")[0]) == 1)
        assert wait_for(lambda: len(pods_of(client)) == 2)

    def test_rolling_update_creates_new_rs(self, cluster):
        store, client = cluster
        client.create(DEPLOYMENTS, make_deployment("api", 2, image="img:v1"))
        assert wait_for(lambda: len(pods_of(client)) == 2)

        def set_image(o):
            o["spec"]["template"]["spec"]["containers"][0]["image"] = "img:v2"
            return o
        client.guaranteed_update(DEPLOYMENTS, "default", "api", set_image)
        assert wait_for(lambda: len(client.list(REPLICASETS, "default")[0]) == 2)
        # v2 pods get created (old ones drain once new are Ready; without a
        # kubelet nothing reports Ready, so we just assert the surge)
        def v2_pods():
            return [p for p in pods_of(client)
                    if p["spec"]["containers"][0]["image"] == "img:v2"]
        assert wait_for(lambda: len(v2_pods()) == 2)

    def test_cascading_delete_via_gc(self, cluster):
        store, client = cluster
        client.create(DEPLOYMENTS, make_deployment("api", 2))
        assert wait_for(lambda: len(pods_of(client)) == 2)
        client.delete(DEPLOYMENTS, "default", "api")
        assert wait_for(lambda: len(client.list(REPLICASETS, "default")[0]) == 0,
                        timeout=15)
        assert wait_for(lambda: len(pods_of(client)) == 0, timeout=15)


class TestJob:
    def test_runs_to_completion(self, cluster):
        store, client = cluster
        job = meta.new_object("Job", "batch1", "default")
        job["spec"] = {"completions": 2, "parallelism": 2,
                       "template": {"spec": {"containers": [
                           {"name": "c0", "image": "worker"}]}}}
        client.create(JOBS, job)
        assert wait_for(lambda: len(pods_of(client)) == 2)
        # simulate kubelet finishing the pods
        for p in pods_of(client):
            client.update_status(PODS, {**p, "status": {"phase": "Succeeded"}})
        assert wait_for(lambda: any(
            c.get("type") == "Complete"
            for c in (client.get(JOBS, "default", "batch1")
                      .get("status") or {}).get("conditions", [])), timeout=15)

    def test_failed_pods_retried_and_backoff_limit(self, cluster):
        store, client = cluster
        job = meta.new_object("Job", "flaky", "default")
        job["spec"] = {"completions": 1, "parallelism": 1, "backoffLimit": 1,
                       "template": {"spec": {"containers": [
                           {"name": "c0", "image": "worker"}]}}}
        client.create(JOBS, job)

        def fail_active():
            for p in pods_of(client):
                if (meta.controller_ref(p) or {}).get("name") == "flaky" \
                        and (p.get("status") or {}).get("phase") not in (
                            "Succeeded", "Failed"):
                    client.update_status(PODS, {**p, "status": {"phase": "Failed"}})
                    return True
            return False

        assert wait_for(fail_active)           # first failure
        assert wait_for(fail_active, timeout=15)  # retry also fails
        assert wait_for(lambda: any(
            c.get("type") == "Failed"
            for c in (client.get(JOBS, "default", "flaky")
                      .get("status") or {}).get("conditions", [])), timeout=15)


class TestLeaderElection:
    def test_single_leader_and_failover(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        a = LeaderElector(client, "test-lock", identity="a",
                          lease_duration=0.6, retry_period=0.1)
        b = LeaderElector(client, "test-lock", identity="b",
                          lease_duration=0.6, retry_period=0.1)
        a.run()
        assert wait_for(lambda: a.is_leader)
        b.run()
        time.sleep(0.5)
        assert not b.is_leader
        a.stop()  # releases the lease
        assert wait_for(lambda: b.is_leader, timeout=5)
        b.stop()
