"""tests/test_controllers_breadth.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

Controller breadth: StatefulSet, DaemonSet, CronJob, Disruption,
Namespace, ResourceQuota, ServiceAccount, PodGC, TTLAfterFinished, HPA.

Behavioral contracts from pkg/controller/{statefulset,daemon,cronjob,
disruption,namespace,resourcequota,serviceaccount,podgc,ttlafterfinished,
podautoscaler}.
"""

import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import (
    CRONJOBS, DAEMONSETS, HPAS, JOBS, NAMESPACES, NODES, PDBS, PODS, PVCS,
    REPLICASETS, RESOURCEQUOTAS, SECRETS, SERVICEACCOUNTS, STATEFULSETS,
)
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.controllers.cronjob import CronSchedule
from kubernetes_tpu_torch.controllers.hpa import USAGE_ANNOTATION
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
    yield store, client, mgr
    mgr.stop()
    factory.stop()


def pods_of(client, ns="default"):
    return client.list(PODS, ns)[0]


def set_phase(client, pod, phase):
    client.update_status(PODS, {**pod, "status": {"phase": phase}})


def mark_ready(client, pod):
    client.update_status(PODS, {**pod, "status": {
        "phase": "Running",
        "conditions": [{"type": "Ready", "status": "True"}]}})


# -- StatefulSet -----------------------------------------------------------

def make_sts(name, replicas, policy=None, vcts=None):
    sts = meta.new_object("StatefulSet", name, "default")
    sts["spec"] = {
        "replicas": replicas, "serviceName": name,
        "selector": {"matchLabels": {"app": name}},
        "template": {"metadata": {"labels": {"app": name}},
                     "spec": {"containers": [{"name": "c0", "image": "i"}]}},
    }
    if policy:
        sts["spec"]["podManagementPolicy"] = policy
    if vcts:
        sts["spec"]["volumeClaimTemplates"] = vcts
    return sts


class TestStatefulSet:
    def test_ordered_creation_with_stable_names(self, cluster):
        store, client, _ = cluster
        client.create(STATEFULSETS, make_sts("db", 3))
        # ordinal 0 first; 1 only after 0 is ready
        assert wait_for(lambda: any(meta.name(p) == "db-0"
                                    for p in pods_of(client)))
        time.sleep(0.3)
        assert not any(meta.name(p) == "db-1" for p in pods_of(client))
        mark_ready(client, client.get(PODS, "default", "db-0"))
        assert wait_for(lambda: any(meta.name(p) == "db-1"
                                    for p in pods_of(client)))
        mark_ready(client, client.get(PODS, "default", "db-1"))
        assert wait_for(lambda: any(meta.name(p) == "db-2"
                                    for p in pods_of(client)))

    def test_parallel_policy_creates_all(self, cluster):
        store, client, _ = cluster
        client.create(STATEFULSETS, make_sts("par", 3, policy="Parallel"))
        assert wait_for(lambda: {meta.name(p) for p in pods_of(client)}
                        >= {"par-0", "par-1", "par-2"})

    def test_scale_down_highest_ordinal_first(self, cluster):
        store, client, _ = cluster
        client.create(STATEFULSETS, make_sts("sd", 2, policy="Parallel"))
        assert wait_for(lambda: len(pods_of(client)) == 2)
        for p in pods_of(client):
            mark_ready(client, p)

        def scale(o):
            o["spec"]["replicas"] = 1
            return o
        client.guaranteed_update(STATEFULSETS, "default", "sd", scale)
        assert wait_for(lambda: [meta.name(p) for p in pods_of(client)
                                 if meta.deletion_timestamp(p) is None]
                        == ["sd-0"])

    def test_pvc_per_volume_claim_template(self, cluster):
        store, client, _ = cluster
        vct = [{"metadata": {"name": "data"},
                "spec": {"resources": {"requests": {"storage": "1Gi"}}}}]
        client.create(STATEFULSETS, make_sts("pv", 1, vcts=vct))
        assert wait_for(lambda: any(
            meta.name(c) == "data-pv-0" for c in client.list(PVCS,
                                                             "default")[0]))
        pod = client.get(PODS, "default", "pv-0")
        assert pod["spec"]["volumes"][0]["persistentVolumeClaim"][
            "claimName"] == "data-pv-0"


# -- DaemonSet -------------------------------------------------------------

def make_node(name, labels=None, taints=None):
    node = meta.new_object("Node", name, "")
    node["metadata"]["labels"] = labels or {}
    node["spec"] = {"taints": taints or []}
    node["status"] = {"allocatable": {"cpu": "4", "memory": "8Gi",
                                      "pods": "110"}}
    return node


class TestDaemonSet:
    def test_pod_per_node(self, cluster):
        store, client, _ = cluster
        for i in range(3):
            client.create(NODES, make_node(f"n{i}"))
        ds = meta.new_object("DaemonSet", "agent", "default")
        ds["spec"] = {"template": {
            "metadata": {"labels": {"app": "agent"}},
            "spec": {"containers": [{"name": "c0", "image": "i"}]}}}
        client.create(DAEMONSETS, ds)
        assert wait_for(lambda: len(pods_of(client)) == 3)
        # a new node gets a pod too
        client.create(NODES, make_node("n3"))
        assert wait_for(lambda: len(pods_of(client)) == 4)

    def test_node_selector_respected(self, cluster):
        store, client, _ = cluster
        client.create(NODES, make_node("gpu-1", labels={"accel": "tpu"}))
        client.create(NODES, make_node("cpu-1"))
        ds = meta.new_object("DaemonSet", "tpud", "default")
        ds["spec"] = {"template": {
            "metadata": {"labels": {"app": "tpud"}},
            "spec": {"nodeSelector": {"accel": "tpu"},
                     "containers": [{"name": "c0", "image": "i"}]}}}
        client.create(DAEMONSETS, ds)
        assert wait_for(lambda: len(pods_of(client)) == 1)
        time.sleep(0.2)
        assert len(pods_of(client)) == 1

    def test_untolerated_taint_excludes_node(self, cluster):
        store, client, _ = cluster
        client.create(NODES, make_node("ok"))
        client.create(NODES, make_node(
            "tainted", taints=[{"key": "dedicated", "value": "x",
                                "effect": "NoSchedule"}]))
        ds = meta.new_object("DaemonSet", "d", "default")
        ds["spec"] = {"template": {
            "metadata": {"labels": {"app": "d"}},
            "spec": {"containers": [{"name": "c0", "image": "i"}]}}}
        client.create(DAEMONSETS, ds)
        assert wait_for(lambda: len(pods_of(client)) == 1)
        status = client.get(DAEMONSETS, "default", "d").get("status") or {}
        assert status.get("desiredNumberScheduled") == 1


# -- CronJob ---------------------------------------------------------------

class TestCronSchedule:
    def test_every_minute(self):
        s = CronSchedule("* * * * *")
        assert s.matches(time.localtime())

    def test_specific_minute(self):
        s = CronSchedule("30 14 * * *")
        t = time.struct_time((2026, 7, 29, 14, 30, 0, 2, 210, -1))
        assert s.matches(t)
        t2 = time.struct_time((2026, 7, 29, 14, 31, 0, 2, 210, -1))
        assert not s.matches(t2)

    def test_step_and_range(self):
        s = CronSchedule("*/15 9-17 * * 1-5")
        assert 0 in s.minutes and 45 in s.minutes and 20 not in s.minutes
        assert 9 in s.hours and 17 in s.hours and 8 not in s.hours
        assert 1 in s.dow and 5 in s.dow and 0 not in s.dow

    def test_next_after(self):
        s = CronSchedule("0 * * * *")  # top of every hour
        nxt = s.next_after(0.0)
        assert nxt is not None and nxt % 3600 == 0

    def test_range_step_anchors_at_range_start(self):
        # vixie cron: 1-23/2 selects the odd hours, not the even ones
        s = CronSchedule("0 1-23/2 * * *")
        assert 1 in s.hours and 23 in s.hours
        assert 2 not in s.hours and 0 not in s.hours

    def test_invalid_rejected(self):
        from kubernetes_tpu_torch.controllers.cronjob import CronParseError
        with pytest.raises(CronParseError):
            CronSchedule("99 * * * *")
        with pytest.raises(CronParseError):
            CronSchedule("* * *")


class TestCronJob:
    def test_creates_job_when_due(self, cluster):
        store, client, mgr = cluster
        cj = meta.new_object("CronJob", "tick", "default")
        cj["spec"] = {"schedule": "* * * * *",
                      "jobTemplate": {"spec": {
                          "completions": 1,
                          "template": {"spec": {"containers": [
                              {"name": "c0", "image": "i"}]}}}}}
        client.create(CRONJOBS, cj)
        ctrl = mgr.controllers["cronjob"]
        # drive deterministically instead of waiting a wall minute
        wait_for(lambda: ctrl.cj_informer.get("default", "tick") is not None)
        ctrl.reconcile_once(time.time() + 60)
        jobs, _ = client.list(JOBS, "default")
        assert len(jobs) == 1
        assert meta.name(jobs[0]).startswith("tick-")
        # same tick is idempotent
        ctrl.reconcile_once(time.time() + 61)
        assert len(client.list(JOBS, "default")[0]) == 1

    def test_forbid_concurrency(self, cluster):
        store, client, mgr = cluster
        cj = meta.new_object("CronJob", "fb", "default")
        cj["spec"] = {"schedule": "* * * * *",
                      "concurrencyPolicy": "Forbid",
                      "jobTemplate": {"spec": {
                          "template": {"spec": {"containers": [
                              {"name": "c0", "image": "i"}]}}}}}
        client.create(CRONJOBS, cj)
        ctrl = mgr.controllers["cronjob"]
        wait_for(lambda: ctrl.cj_informer.get("default", "fb") is not None)
        now = time.time()
        ctrl.reconcile_once(now + 60)
        assert wait_for(
            lambda: len([j for j in ctrl.job_informer.list("default")]) == 1)
        ctrl.reconcile_once(now + 120)  # previous job still active
        assert len(client.list(JOBS, "default")[0]) == 1

    def test_suspend(self, cluster):
        store, client, mgr = cluster
        cj = meta.new_object("CronJob", "sus", "default")
        cj["spec"] = {"schedule": "* * * * *", "suspend": True,
                      "jobTemplate": {"spec": {}}}
        client.create(CRONJOBS, cj)
        ctrl = mgr.controllers["cronjob"]
        wait_for(lambda: ctrl.cj_informer.get("default", "sus") is not None)
        ctrl.reconcile_once(time.time() + 60)
        assert client.list(JOBS, "default")[0] == []


# -- Disruption ------------------------------------------------------------

class TestDisruption:
    def test_pdb_status_maintained(self, cluster):
        store, client, _ = cluster
        for i in range(3):
            p = meta.new_object("Pod", f"w{i}", "default")
            p["metadata"]["labels"] = {"app": "web"}
            p["spec"] = {"containers": [{"name": "c", "image": "i"}]}
            mark_ready(client, client.create(PODS, p))
        pdb = meta.new_object("PodDisruptionBudget", "pdb", "default")
        pdb["spec"] = {"minAvailable": 2,
                       "selector": {"matchLabels": {"app": "web"}}}
        client.create(PDBS, pdb)
        assert wait_for(lambda: (client.get(PDBS, "default", "pdb")
                                 .get("status") or {})
                        .get("disruptionsAllowed") == 1)
        st = client.get(PDBS, "default", "pdb")["status"]
        assert st["currentHealthy"] == 3 and st["desiredHealthy"] == 2

    def test_allowed_drops_after_pod_failure(self, cluster):
        store, client, _ = cluster
        for i in range(2):
            p = meta.new_object("Pod", f"x{i}", "default")
            p["metadata"]["labels"] = {"app": "x"}
            p["spec"] = {"containers": [{"name": "c", "image": "i"}]}
            mark_ready(client, client.create(PODS, p))
        pdb = meta.new_object("PodDisruptionBudget", "px", "default")
        pdb["spec"] = {"minAvailable": 2,
                       "selector": {"matchLabels": {"app": "x"}}}
        client.create(PDBS, pdb)
        assert wait_for(lambda: (client.get(PDBS, "default", "px")
                                 .get("status") or {})
                        .get("disruptionsAllowed") == 0)
        set_phase(client, client.get(PODS, "default", "x0"), "Failed")
        assert wait_for(lambda: (client.get(PDBS, "default", "px")
                                 .get("status") or {})
                        .get("currentHealthy") == 1)


# -- Namespace -------------------------------------------------------------

class TestNamespace:
    def test_delete_sweeps_content(self, cluster):
        store, client, _ = cluster
        client.create(NAMESPACES, meta.new_object("Namespace", "doomed", ""))
        p = meta.new_object("Pod", "inside", "doomed")
        p["spec"] = {"containers": [{"name": "c", "image": "i"}]}
        client.create(PODS, p)
        cm = meta.new_object("ConfigMap", "cfg", "doomed")
        client.create("configmaps", cm)
        client.delete(NAMESPACES, "", "doomed")
        assert wait_for(lambda: client.list(PODS, "doomed")[0] == [])
        assert wait_for(lambda: client.list("configmaps", "doomed")[0] == [])

    def test_active_phase_set(self, cluster):
        store, client, _ = cluster
        client.create(NAMESPACES, meta.new_object("Namespace", "living", ""))
        assert wait_for(lambda: (client.get(NAMESPACES, "", "living")
                                 .get("status") or {}).get("phase") == "Active")


# -- ResourceQuota status --------------------------------------------------

class TestResourceQuotaController:
    def test_status_used_tracked(self, cluster):
        store, client, _ = cluster
        rq = meta.new_object("ResourceQuota", "rq", "default")
        rq["spec"] = {"hard": {"pods": "10", "requests.cpu": "2"}}
        client.create(RESOURCEQUOTAS, rq)
        p = meta.new_object("Pod", "billed", "default")
        p["spec"] = {"containers": [{"name": "c", "image": "i",
                                     "resources": {"requests": {
                                         "cpu": "500m"}}}]}
        client.create(PODS, p)
        assert wait_for(lambda: ((client.get(RESOURCEQUOTAS, "default", "rq")
                                  .get("status") or {}).get("used") or {})
                        .get("pods") == "1")
        used = client.get(RESOURCEQUOTAS, "default", "rq")["status"]["used"]
        assert used["requests.cpu"] == "500m"


# -- ServiceAccount --------------------------------------------------------

class TestServiceAccount:
    def test_default_sa_and_token_created(self, cluster):
        store, client, _ = cluster
        client.create(NAMESPACES, meta.new_object("Namespace", "team-a", ""))
        assert wait_for(lambda: client.list(SERVICEACCOUNTS, "team-a")[0])
        assert wait_for(lambda: (client.get(SERVICEACCOUNTS, "team-a",
                                            "default").get("secrets")))
        secret_name = client.get(SERVICEACCOUNTS, "team-a",
                                 "default")["secrets"][0]["name"]
        secret = client.get(SECRETS, "team-a", secret_name)
        assert secret["type"] == "kubernetes.io/service-account-token"
        assert secret["data"]["token"]


# -- PodGC -----------------------------------------------------------------

class TestPodGC:
    def test_orphaned_pods_on_deleted_node(self, cluster):
        store, client, mgr = cluster
        client.create(NODES, make_node("gone"))
        p = meta.new_object("Pod", "orphan", "default")
        p["spec"] = {"containers": [{"name": "c", "image": "i"}],
                     "nodeName": "gone"}
        client.create(PODS, p)
        client.delete(NODES, "", "gone")
        ctrl = mgr.controllers["podgc"]
        wait_for(lambda: ctrl.node_informer.get("", "gone") is None)
        ctrl.gc_once()
        assert wait_for(lambda: not any(meta.name(p) == "orphan"
                                        for p in pods_of(client)))

    def test_terminated_pods_over_threshold(self, cluster):
        store, client, mgr = cluster
        ctrl = mgr.controllers["podgc"]
        ctrl.threshold = 2
        for i in range(4):
            p = meta.new_object("Pod", f"done{i}", "default")
            p["spec"] = {"containers": [{"name": "c", "image": "i"}]}
            created = client.create(PODS, p)
            set_phase(client, created, "Succeeded")
        wait_for(lambda: sum(
            1 for p in ctrl.pod_informer.list("default")
            if (p.get("status") or {}).get("phase") == "Succeeded") == 4)
        ctrl.gc_once()
        assert wait_for(lambda: len(pods_of(client)) == 2)


# -- TTL after finished ----------------------------------------------------

class TestTTLAfterFinished:
    def test_finished_job_deleted_after_ttl(self, cluster):
        store, client, mgr = cluster
        job = meta.new_object("Job", "brief", "default")
        job["spec"] = {"ttlSecondsAfterFinished": 5, "completions": 1,
                       "template": {"spec": {"containers": [
                           {"name": "c0", "image": "i"}]}}}
        client.create(JOBS, job)
        assert wait_for(lambda: len(pods_of(client)) == 1)
        set_phase(client, pods_of(client)[0], "Succeeded")
        assert wait_for(lambda: (client.get(JOBS, "default", "brief")
                                 .get("status") or {}).get("completionTime"))
        ctrl = mgr.controllers["ttlafterfinished"]
        done_at = client.get(JOBS, "default", "brief")["status"]["completionTime"]
        # the stamp is stable: status rewrites by the job controller must
        # not wipe it (would otherwise defer TTL forever)
        time.sleep(0.3)
        assert client.get(JOBS, "default",
                          "brief")["status"]["completionTime"] == done_at
        ctrl.sweep_once(done_at + 2)  # before TTL: stays
        assert client.get(JOBS, "default", "brief")
        ctrl.sweep_once(done_at + 6)  # after TTL: gone
        with pytest.raises(kv.NotFoundError):
            client.get(JOBS, "default", "brief")


# -- HPA -------------------------------------------------------------------

class TestHPA:
    def _setup_target(self, client, usage="800m"):
        rs = meta.new_object("ReplicaSet", "web", "default")
        rs["spec"] = {"replicas": 2,
                      "selector": {"matchLabels": {"app": "web"}},
                      "template": {"metadata": {"labels": {"app": "web"}},
                                   "spec": {"containers": [
                                       {"name": "c0", "image": "i",
                                        "resources": {"requests": {
                                            "cpu": "500m"}}}]}}}
        client.create(REPLICASETS, rs)
        assert wait_for(
            lambda: len(client.list(PODS, "default")[0]) == 2)
        for p in client.list(PODS, "default")[0]:
            def ann(o, u=usage):
                o["metadata"].setdefault("annotations", {})[
                    USAGE_ANNOTATION] = u
                return o
            client.guaranteed_update(PODS, "default", meta.name(p), ann)

    def test_scales_up_on_high_utilization(self, cluster):
        store, client, mgr = cluster
        self._setup_target(client, usage="800m")  # 160% of request
        hpa = meta.new_object("HorizontalPodAutoscaler", "hpa", "default")
        hpa["spec"] = {"scaleTargetRef": {"kind": "ReplicaSet", "name": "web"},
                       "minReplicas": 1, "maxReplicas": 10,
                       "targetCPUUtilizationPercentage": 80}
        client.create(HPAS, hpa)
        ctrl = mgr.controllers["horizontalpodautoscaler"]
        wait_for(lambda: ctrl.hpa_informer.get("default", "hpa") is not None)
        wait_for(lambda: len(ctrl.pod_informer.list("default")) == 2)
        ctrl.reconcile_once(time.time())
        # desired = ceil(2 * 160 / 80) = 4
        assert wait_for(lambda: client.get(REPLICASETS, "default",
                                           "web")["spec"]["replicas"] == 4)

    def test_respects_max_replicas(self, cluster):
        store, client, mgr = cluster
        self._setup_target(client, usage="5000m")  # 1000% of request
        hpa = meta.new_object("HorizontalPodAutoscaler", "hpa2", "default")
        hpa["spec"] = {"scaleTargetRef": {"kind": "ReplicaSet", "name": "web"},
                       "minReplicas": 1, "maxReplicas": 5,
                       "targetCPUUtilizationPercentage": 80}
        client.create(HPAS, hpa)
        ctrl = mgr.controllers["horizontalpodautoscaler"]
        wait_for(lambda: ctrl.hpa_informer.get("default", "hpa2") is not None)
        wait_for(lambda: len(ctrl.pod_informer.list("default")) == 2)
        ctrl.reconcile_once(time.time())
        assert wait_for(lambda: client.get(REPLICASETS, "default",
                                           "web")["spec"]["replicas"] == 5)

    def test_no_metrics_holds(self, cluster):
        store, client, mgr = cluster
        rs = meta.new_object("ReplicaSet", "quiet", "default")
        rs["spec"] = {"replicas": 2,
                      "selector": {"matchLabels": {"app": "quiet"}},
                      "template": {"metadata": {"labels": {"app": "quiet"}},
                                   "spec": {"containers": [
                                       {"name": "c0", "image": "i"}]}}}
        client.create(REPLICASETS, rs)
        hpa = meta.new_object("HorizontalPodAutoscaler", "hq", "default")
        hpa["spec"] = {"scaleTargetRef": {"kind": "ReplicaSet",
                                          "name": "quiet"},
                       "minReplicas": 1, "maxReplicas": 10,
                       "targetCPUUtilizationPercentage": 80}
        client.create(HPAS, hpa)
        ctrl = mgr.controllers["horizontalpodautoscaler"]
        wait_for(lambda: ctrl.hpa_informer.get("default", "hq") is not None)
        ctrl.reconcile_once(time.time())
        assert client.get(REPLICASETS, "default", "quiet")["spec"][
            "replicas"] == 2


# -- review regressions ----------------------------------------------------

class TestControllerReviewRegressions:
    def test_bad_cron_does_not_starve_others(self, cluster):
        store, client, mgr = cluster
        bad = meta.new_object("CronJob", "aaa-bad", "default")
        bad["spec"] = {"schedule": "1-x * * * *", "jobTemplate": {"spec": {}}}
        good = meta.new_object("CronJob", "zzz-good", "default")
        good["spec"] = {"schedule": "* * * * *",
                        "jobTemplate": {"spec": {"template": {"spec": {
                            "containers": [{"name": "c0", "image": "i"}]}}}}}
        client.create(CRONJOBS, bad)
        client.create(CRONJOBS, good)
        ctrl = mgr.controllers["cronjob"]
        wait_for(lambda: len(ctrl.cj_informer.list("default")) == 2)
        ctrl.reconcile_once(time.time() + 60)  # must not raise
        jobs = [meta.name(j) for j in client.list(JOBS, "default")[0]]
        assert any(n.startswith("zzz-good-") for n in jobs)

    def test_impossible_dom_schedule_rejected(self):
        from kubernetes_tpu_torch.controllers.cronjob import CronParseError
        with pytest.raises(CronParseError):
            CronSchedule("0 0 31 2 *")  # Feb 31 never exists
        with pytest.raises(CronParseError):
            CronSchedule("*/0 * * * *")  # zero step
        CronSchedule("0 0 31 2 0")  # dow restricted: fires on Sundays

    def test_daemonset_respects_template_affinity(self, cluster):
        store, client, _ = cluster
        client.create(NODES, make_node("tpu-node", labels={"accel": "tpu"}))
        client.create(NODES, make_node("plain-node"))
        ds = meta.new_object("DaemonSet", "affin", "default")
        ds["spec"] = {"template": {
            "metadata": {"labels": {"app": "affin"}},
            "spec": {
                "affinity": {"nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [{"matchExpressions": [
                            {"key": "accel", "operator": "In",
                             "values": ["tpu"]}]}]}}},
                "containers": [{"name": "c0", "image": "i"}]}}}
        client.create(DAEMONSETS, ds)
        assert wait_for(lambda: len(pods_of(client)) == 1)
        time.sleep(0.3)
        assert len(pods_of(client)) == 1  # plain-node excluded

    def test_pdb_expected_sums_multiple_owners(self, cluster):
        store, client, mgr = cluster
        for rs_name in ("rs-a", "rs-b"):
            rs = meta.new_object("ReplicaSet", rs_name, "default")
            rs["spec"] = {"replicas": 3,
                          "selector": {"matchLabels": {"tier": rs_name}},
                          "template": {"metadata": {"labels": {
                              "tier": rs_name, "shared": "yes"}},
                              "spec": {"containers": [
                                  {"name": "c0", "image": "i"}]}}}
            client.create(REPLICASETS, rs)
        assert wait_for(lambda: len(pods_of(client)) == 6)
        for p in pods_of(client):
            mark_ready(client, p)
        pdb = meta.new_object("PodDisruptionBudget", "span", "default")
        pdb["spec"] = {"minAvailable": "50%",
                       "selector": {"matchLabels": {"shared": "yes"}}}
        client.create(PDBS, pdb)
        assert wait_for(lambda: (client.get(PDBS, "default", "span")
                                 .get("status") or {})
                        .get("expectedPods") == 6)
        st = client.get(PDBS, "default", "span")["status"]
        assert st["desiredHealthy"] == 3 and st["disruptionsAllowed"] == 3
