"""tests/test_hpa_v2.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

HPA autoscaling/v2 semantics: multi-metric, tolerance, stabilization
windows, behavior policies.

Reference: pkg/controller/podautoscaler/horizontal.go —
computeReplicasForMetrics (max across metrics), tolerance,
stabilizeRecommendationWithBehaviors, normalizeDesiredReplicasWithBehaviors.
"""

import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import HPAS, PODS, REPLICASETS
from kubernetes_tpu_torch.controllers.hpa import (
    CUSTOM_PREFIX, MEMORY_ANNOTATION, USAGE_ANNOTATION,
    HorizontalPodAutoscaler,
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
def hpa_env():
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    ctrl = HorizontalPodAutoscaler(client, factory, tick=3600.0)
    factory.start()
    factory.wait_for_cache_sync()
    yield store, client, ctrl
    factory.stop()


def make_rs(client, replicas=2, cpu_req="500m", mem_req="256Mi"):
    rs = meta.new_object("ReplicaSet", "web", "default")
    rs["spec"] = {"replicas": replicas,
                  "selector": {"matchLabels": {"app": "web"}}}
    client.create(REPLICASETS, rs)
    for i in range(replicas):
        pod = meta.new_object("Pod", f"web-{i}", "default")
        pod["metadata"]["labels"] = {"app": "web"}
        pod["spec"] = {"containers": [{
            "name": "c0", "image": "i",
            "resources": {"requests": {"cpu": cpu_req,
                                       "memory": mem_req}}}]}
        client.create(PODS, pod)


def annotate(client, anns):
    for p in client.list(PODS, "default")[0]:
        def patch(o, anns=anns):
            o["metadata"].setdefault("annotations", {}).update(anns)
            return o
        client.guaranteed_update(PODS, "default", meta.name(p), patch)


def make_hpa(client, spec):
    hpa = meta.new_object("HorizontalPodAutoscaler", "h", "default")
    hpa["spec"] = {"scaleTargetRef": {"kind": "ReplicaSet", "name": "web"},
                   "minReplicas": 1, "maxReplicas": 20, **spec}
    client.create(HPAS, hpa)


def replicas(client):
    return client.get(REPLICASETS, "default", "web")["spec"]["replicas"]


def sync(ctrl, client, now=None):
    assert wait_for(lambda: ctrl.hpa_informer.get("default", "h") is not None)
    assert wait_for(lambda: len(ctrl.pod_informer.list("default")) >= 1)
    ctrl.reconcile_once(now if now is not None else time.time())


class TestMultiMetric:
    def test_max_of_metrics_wins(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        # cpu at target (no scale), memory at 2x target -> memory wins
        annotate(client, {USAGE_ANNOTATION: "500m",
                          MEMORY_ANNOTATION: "512Mi"})
        make_hpa(client, {"metrics": [
            {"type": "Resource", "resource": {
                "name": "cpu", "target": {"type": "Utilization",
                                          "averageUtilization": 100}}},
            {"type": "Resource", "resource": {
                "name": "memory", "target": {"type": "Utilization",
                                             "averageUtilization": 100}}},
        ]})
        sync(ctrl, client)
        assert replicas(client) == 4  # ceil(2 * 200 / 100)

    def test_pods_custom_metric(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {CUSTOM_PREFIX + "qps": "300"})
        make_hpa(client, {"metrics": [
            {"type": "Pods", "pods": {
                "metric": {"name": "qps"},
                "target": {"averageValue": "100"}}}]})
        sync(ctrl, client)
        assert replicas(client) == 6  # ceil(2 * 300/100)

    def test_average_value_resource_target(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "400m"})
        make_hpa(client, {"metrics": [
            {"type": "Resource", "resource": {
                "name": "cpu", "target": {"type": "AverageValue",
                                          "averageValue": "200m"}}}]})
        sync(ctrl, client)
        assert replicas(client) == 4


class TestTolerance:
    def test_within_tolerance_holds(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "525m"})  # 105% of 500m target
        make_hpa(client, {"metrics": [
            {"type": "Resource", "resource": {
                "name": "cpu", "target": {"type": "Utilization",
                                          "averageUtilization": 100}}}]})
        sync(ctrl, client)
        assert replicas(client) == 2  # ratio 1.05 within the 0.1 band


class TestStabilization:
    def test_scale_down_waits_out_window(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=4)
        # first reconcile at target: the window records "4 is right"
        annotate(client, {USAGE_ANNOTATION: "400m"})  # exactly 80% of 500m
        make_hpa(client, {"targetCPUUtilizationPercentage": 80})
        t0 = time.time()
        sync(ctrl, client, now=t0)
        assert replicas(client) == 4
        # load drops: the 300s window still holds the higher recommendation
        annotate(client, {USAGE_ANNOTATION: "50m"})  # 10%
        assert wait_for(lambda: all(
            (p["metadata"].get("annotations") or {}).get(
                USAGE_ANNOTATION) == "50m"
            for p in ctrl.pod_informer.list("default")))
        ctrl.reconcile_once(t0 + 10)
        assert replicas(client) == 4
        # window expired: the low recommendation finally wins
        ctrl.reconcile_once(t0 + 301)
        assert replicas(client) == 1

    def test_scale_up_window_picks_min_recommendation(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "800m"})  # 160%
        make_hpa(client, {
            "targetCPUUtilizationPercentage": 80,
            "behavior": {"scaleUp": {"stabilizationWindowSeconds": 120}}})
        t0 = time.time()
        sync(ctrl, client, now=t0)
        # up-stabilization: the window min includes this first (low)
        # recommendation moment? The first rec IS 4; min over window = 4
        assert replicas(client) == 4


class TestBehaviorPolicies:
    def test_scale_up_pods_policy_limits_step(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "4000m"})  # 800% -> wants 20
        make_hpa(client, {
            "targetCPUUtilizationPercentage": 80,
            "behavior": {"scaleUp": {"policies": [
                {"type": "Pods", "value": 3, "periodSeconds": 60}]}}})
        t0 = time.time()
        sync(ctrl, client, now=t0)
        assert replicas(client) == 5  # 2 + 3 max per period
        # same period: the event history blocks further growth
        ctrl.reconcile_once(t0 + 1)
        assert replicas(client) == 5
        # next period: another step of 3 allowed (relative to current=5)
        ctrl.reconcile_once(t0 + 61)
        assert replicas(client) == 8

    def test_opposite_direction_events_do_not_inflate_budget(self, hpa_env):
        """A recent scale-UP must not grant extra scale-DOWN room (the
        reference keeps separate scaleUpEvents/scaleDownEvents)."""
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "4000m"})  # wants max
        make_hpa(client, {
            "targetCPUUtilizationPercentage": 80,
            "maxReplicas": 8,
            "behavior": {
                "scaleUp": {"policies": [
                    {"type": "Pods", "value": 6, "periodSeconds": 60}]},
                "scaleDown": {
                    "stabilizationWindowSeconds": 0,
                    "policies": [{"type": "Pods", "value": 2,
                                  "periodSeconds": 60}]}}})
        t0 = time.time()
        sync(ctrl, client, now=t0)
        assert replicas(client) == 8  # scaled up +6 (event recorded)
        # load vanishes: scale-down budget is 2/period regardless of the
        # +6 up-event sitting in the same window
        annotate(client, {USAGE_ANNOTATION: "10m"})
        assert wait_for(lambda: all(
            (p["metadata"].get("annotations") or {}).get(
                USAGE_ANNOTATION) == "10m"
            for p in ctrl.pod_informer.list("default")))
        ctrl.reconcile_once(t0 + 1)
        assert replicas(client) == 6  # 8 - 2, NOT 8 - (2 + 6)

    def test_scale_down_percent_policy(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=10)
        annotate(client, {USAGE_ANNOTATION: "10m"})
        make_hpa(client, {
            "targetCPUUtilizationPercentage": 80,
            "behavior": {"scaleDown": {
                "stabilizationWindowSeconds": 0,
                "policies": [{"type": "Percent", "value": 50,
                              "periodSeconds": 60}]}}})
        t0 = time.time()
        sync(ctrl, client, now=t0)
        assert replicas(client) == 5  # at most 50% per period

    def test_scale_down_disabled(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=6)
        annotate(client, {USAGE_ANNOTATION: "10m"})
        make_hpa(client, {
            "targetCPUUtilizationPercentage": 80,
            "behavior": {"scaleDown": {
                "stabilizationWindowSeconds": 0,
                "selectPolicy": "Disabled"}}})
        sync(ctrl, client)
        assert replicas(client) == 6

    def test_v1_status_compat_field(self, hpa_env):
        store, client, ctrl = hpa_env
        make_rs(client, replicas=2)
        annotate(client, {USAGE_ANNOTATION: "500m"})
        make_hpa(client, {"targetCPUUtilizationPercentage": 100})
        sync(ctrl, client)
        hpa = client.get(HPAS, "default", "h")
        assert hpa["status"]["currentCPUUtilizationPercentage"] == 100
        assert hpa["status"]["currentMetrics"]