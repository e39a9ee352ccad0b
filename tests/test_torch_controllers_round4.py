"""tests/test_controllers_round4.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

Round-4 controller additions: ClusterRole aggregation, EndpointSlice
mirroring, PVC expansion.

Behavioral contracts from pkg/controller/{clusterroleaggregation,
endpointslicemirroring,volume/expand}.
"""

import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import (
    CLUSTERROLES, ENDPOINTS, ENDPOINTSLICES, PVCS, PVS, SERVICES,
    STORAGECLASSES,
)
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
    yield store, client, mgr
    mgr.stop()
    factory.stop()
    client.close()


class TestClusterRoleAggregation:
    def test_union_of_selected_roles(self, cluster):
        _, client, _ = cluster
        agg = meta.new_object("ClusterRole", "admin-agg", "")
        agg["aggregationRule"] = {"clusterRoleSelectors": [
            {"matchLabels": {"rbac/aggregate-to-admin": "true"}}]}
        agg["rules"] = []
        client.create(CLUSTERROLES, agg)
        for i, res in enumerate(("widgets", "gadgets")):
            r = meta.new_object("ClusterRole", f"part-{i}", "")
            r["metadata"]["labels"] = {"rbac/aggregate-to-admin": "true"}
            r["rules"] = [{"apiGroups": ["example.com"],
                           "resources": [res], "verbs": ["get", "list"]}]
            client.create(CLUSTERROLES, r)

        def aggregated():
            role = client.get(CLUSTERROLES, "", "admin-agg")
            res = {tuple(rule["resources"]) for rule in role.get("rules")
                   or ()}
            return res == {("widgets",), ("gadgets",)}
        assert wait_for(aggregated)

    def test_label_change_updates_union(self, cluster):
        _, client, _ = cluster
        agg = meta.new_object("ClusterRole", "view-agg", "")
        agg["aggregationRule"] = {"clusterRoleSelectors": [
            {"matchLabels": {"agg": "view"}}]}
        client.create(CLUSTERROLES, agg)
        r = meta.new_object("ClusterRole", "late", "")
        r["rules"] = [{"apiGroups": [""], "resources": ["pods"],
                       "verbs": ["get"]}]
        client.create(CLUSTERROLES, r)
        time.sleep(0.3)
        assert not (client.get(CLUSTERROLES, "", "view-agg").get("rules")
                    or [])

        def label(cur):
            cur["metadata"].setdefault("labels", {})["agg"] = "view"
            return cur
        client.guaranteed_update(CLUSTERROLES, "", "late", label)
        assert wait_for(lambda: (client.get(CLUSTERROLES, "", "view-agg")
                                 .get("rules") or []))


class TestEndpointSliceMirroring:
    def _custom_endpoints(self, client, name="ext-svc"):
        svc = meta.new_object("Service", name, "default")
        svc["spec"] = {"ports": [{"port": 80, "protocol": "TCP"}]}
        client.create(SERVICES, svc)  # NO selector: custom endpoints
        ep = meta.new_object("Endpoints", name, "default")
        ep["subsets"] = [{
            "addresses": [{"ip": "10.1.2.3"}, {"ip": "10.1.2.4"}],
            "ports": [{"port": 80, "protocol": "TCP"}]}]
        client.create(ENDPOINTS, ep)
        return svc, ep

    def test_mirrors_custom_endpoints(self, cluster):
        _, client, _ = cluster
        self._custom_endpoints(client)

        def mirrored():
            slices, _ = client.list(ENDPOINTSLICES, "default")
            mine = [s for s in slices
                    if meta.labels(s).get(
                        "kubernetes.io/service-name") == "ext-svc"]
            if not mine:
                return False
            ips = {a for s in mine for e in s["endpoints"]
                   for a in e["addresses"]}
            return ips == {"10.1.2.3", "10.1.2.4"}
        assert wait_for(mirrored)

    def test_skip_mirror_label_respected(self, cluster):
        _, client, _ = cluster
        svc = meta.new_object("Service", "skip-svc", "default")
        svc["spec"] = {"ports": [{"port": 80}]}
        client.create(SERVICES, svc)
        ep = meta.new_object("Endpoints", "skip-svc", "default")
        ep["metadata"]["labels"] = {
            "endpointslice.kubernetes.io/skip-mirror": "true"}
        ep["subsets"] = [{"addresses": [{"ip": "10.9.9.9"}],
                          "ports": [{"port": 80}]}]
        client.create(ENDPOINTS, ep)
        time.sleep(0.4)
        slices, _ = client.list(ENDPOINTSLICES, "default")
        assert not [s for s in slices if meta.labels(s).get(
            "kubernetes.io/service-name") == "skip-svc"]

    def test_mirror_survives_service_events_and_slice_deletion(
            self, cluster):
        """A Service event must not let the normal EndpointSlice
        controller delete the mirror (managed-by filter), and a mirror
        deleted by hand must be recreated (the mirroring controller
        watches slices)."""
        _, client, _ = cluster
        self._custom_endpoints(client, "live-svc")

        def mirror_names():
            return [meta.name(s) for s in
                    client.list(ENDPOINTSLICES, "default")[0]
                    if meta.labels(s).get(
                        "kubernetes.io/service-name") == "live-svc"]
        assert wait_for(mirror_names)
        # poke the Service: annotation edit fires the normal controller
        def annotate(cur):
            cur["metadata"].setdefault("annotations", {})["x"] = "y"
            return cur
        client.guaranteed_update(SERVICES, "default", "live-svc",
                                 annotate)
        time.sleep(0.5)
        assert mirror_names(), "service event deleted the mirror"
        # delete the mirror by hand: must come back
        for nm in mirror_names():
            client.delete(ENDPOINTSLICES, "default", nm)
        assert wait_for(mirror_names), "mirror not recreated"

    def test_deleting_endpoints_removes_mirror(self, cluster):
        _, client, _ = cluster
        self._custom_endpoints(client, "gone-svc")
        assert wait_for(lambda: [
            s for s in client.list(ENDPOINTSLICES, "default")[0]
            if meta.labels(s).get(
                "kubernetes.io/service-name") == "gone-svc"])
        client.delete(ENDPOINTS, "default", "gone-svc")
        assert wait_for(lambda: not [
            s for s in client.list(ENDPOINTSLICES, "default")[0]
            if meta.labels(s).get(
                "kubernetes.io/service-name") == "gone-svc"])


class TestVolumeExpand:
    def _bound_claim(self, client, expandable=True):
        sc = meta.new_object("StorageClass", "fast", "")
        sc["provisioner"] = "sim"
        sc["allowVolumeExpansion"] = expandable
        client.create(STORAGECLASSES, sc)
        pv = meta.new_object("PersistentVolume", "pv-x", "")
        pv["spec"] = {"capacity": {"storage": "1Gi"},
                      "accessModes": ["ReadWriteOnce"],
                      "storageClassName": "fast"}
        client.create(PVS, pv)
        pvc = meta.new_object("PersistentVolumeClaim", "data", "default")
        pvc["spec"] = {"storageClassName": "fast",
                       "accessModes": ["ReadWriteOnce"],
                       "volumeName": "pv-x",
                       "resources": {"requests": {"storage": "1Gi"}}}
        client.create(PVCS, pvc)
        client.update_status(PVCS, {**client.get(PVCS, "default", "data"),
                                    "status": {"phase": "Bound",
                                               "capacity": {
                                                   "storage": "1Gi"}}})
        return pvc

    def test_expands_bound_claim(self, cluster):
        _, client, _ = cluster
        self._bound_claim(client)

        def grow(cur):
            cur["spec"]["resources"]["requests"]["storage"] = "5Gi"
            return cur
        client.guaranteed_update(PVCS, "default", "data", grow)
        assert wait_for(lambda: client.get(PVS, "", "pv-x")["spec"][
            "capacity"]["storage"] == "5Gi")
        assert wait_for(lambda: (client.get(PVCS, "default", "data")
                                 .get("status", {}).get("capacity", {})
                                 .get("storage")) == "5Gi")

    def test_oversized_static_pv_never_shrunk(self, cluster):
        """A 100Gi static PV bound to a 1Gi claim must stay 100Gi (the
        expander compares against the VOLUME's capacity, never a
        status-derived zero)."""
        _, client, _ = cluster
        sc = meta.new_object("StorageClass", "fast", "")
        sc["provisioner"] = "sim"
        sc["allowVolumeExpansion"] = True
        client.create(STORAGECLASSES, sc)
        pv = meta.new_object("PersistentVolume", "pv-big", "")
        pv["spec"] = {"capacity": {"storage": "100Gi"},
                      "accessModes": ["ReadWriteOnce"],
                      "storageClassName": "fast"}
        client.create(PVS, pv)
        pvc = meta.new_object("PersistentVolumeClaim", "small", "default")
        pvc["spec"] = {"storageClassName": "fast",
                       "accessModes": ["ReadWriteOnce"],
                       "volumeName": "pv-big",
                       "resources": {"requests": {"storage": "1Gi"}}}
        client.create(PVCS, pvc)
        client.update_status(PVCS, {
            **client.get(PVCS, "default", "small"),
            "status": {"phase": "Bound"}})
        time.sleep(0.4)
        assert client.get(PVS, "", "pv-big")["spec"]["capacity"][
            "storage"] == "100Gi"

    def test_class_flip_wakes_stalled_expansion(self, cluster):
        """Request grows while the class forbids expansion; flipping
        allowVolumeExpansion on must retry the claim without any other
        PVC event."""
        _, client, _ = cluster
        self._bound_claim(client, expandable=False)

        def grow(cur):
            cur["spec"]["resources"]["requests"]["storage"] = "3Gi"
            return cur
        client.guaranteed_update(PVCS, "default", "data", grow)
        time.sleep(0.3)
        assert client.get(PVS, "", "pv-x")["spec"]["capacity"][
            "storage"] == "1Gi"

        def allow(cur):
            cur["allowVolumeExpansion"] = True
            return cur
        client.guaranteed_update(STORAGECLASSES, "", "fast", allow)
        assert wait_for(lambda: client.get(PVS, "", "pv-x")["spec"][
            "capacity"]["storage"] == "3Gi")

    def test_no_expansion_without_class_permission(self, cluster):
        _, client, _ = cluster
        self._bound_claim(client, expandable=False)

        def grow(cur):
            cur["spec"]["resources"]["requests"]["storage"] = "5Gi"
            return cur
        client.guaranteed_update(PVCS, "default", "data", grow)
        time.sleep(0.4)
        assert client.get(PVS, "", "pv-x")["spec"]["capacity"][
            "storage"] == "1Gi"
