"""tests/test_controllers_fleet.py's scenarios on the port's classes
(kubernetes_tpu_torch), the same code with the imports pointing
at the port.

Controller fleet round 2: endpointslice, replication controller,
certificates (approve/sign), ttl, nodeipam, root-ca publisher, bootstrap
tokens, PV binder, pvc/pv protection, attach/detach, ephemeral volumes.

Behavioral contracts from pkg/controller/{endpointslice,replication,
certificates,ttl,nodeipam,bootstrap,volume}.
"""

import base64
import importlib.util
import time

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
from kubernetes_tpu_torch.client.clientset import (
    CONFIGMAPS, CSRS, ENDPOINTSLICES, NAMESPACES, NODES, PODS, PVCS, PVS,
    REPLICATIONCONTROLLERS, SECRETS, SERVICES, STORAGECLASSES,
    VOLUMEATTACHMENTS,
)
from kubernetes_tpu_torch.controllers import ControllerManager
from kubernetes_tpu_torch.store import kv
from kubernetes_tpu_torch.testing import make_node, make_pod, wait_for

requires_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None,
    reason="CSR signing/root CA need the cryptography package")


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


def bound_running_pod(name, node="n1", labels=None, ns="default"):
    p = make_pod(name, ns).labels(**(labels or {})).node(node).build()
    p["status"] = {"phase": "Running",
                   "podIP": "10.0.0.9",
                   "conditions": [{"type": "Ready", "status": "True"}]}
    return p


class TestEndpointSlice:
    def test_slices_track_service_pods(self, cluster):
        _, client, _ = cluster
        svc = meta.new_object("Service", "web", "default")
        svc["spec"] = {"selector": {"app": "web"},
                       "ports": [{"port": 80, "protocol": "TCP"}]}
        client.create(SERVICES, svc)
        client.create(PODS, bound_running_pod("w1", labels={"app": "web"}))
        client.create(PODS, bound_running_pod("w2", labels={"app": "web"}))
        client.create(PODS, bound_running_pod("other", labels={"app": "db"}))

        def slice_has_two():
            sls = [s for s in client.list(ENDPOINTSLICES, "default")[0]
                   if meta.labels(s).get("kubernetes.io/service-name") == "web"]
            return sls and sum(len(s.get("endpoints") or ()) for s in sls) == 2
        assert wait_for(slice_has_two)
        # pod deletion shrinks the slice
        client.delete(PODS, "default", "w2")
        assert wait_for(lambda: sum(
            len(s.get("endpoints") or ())
            for s in client.list(ENDPOINTSLICES, "default")[0]) == 1)
        # service deletion removes the slices
        client.delete(SERVICES, "default", "web")
        assert wait_for(
            lambda: not client.list(ENDPOINTSLICES, "default")[0])


class TestEndpointSliceNamedPorts:
    def test_named_target_port_resolves_per_pod(self, cluster):
        """String targetPorts resolve against each pod's container ports;
        pods with different mappings land in separate slices (reference
        endpointslice/reconciler.go resolves named ports per endpoint)."""
        _, client, _ = cluster
        svc = meta.new_object("Service", "api", "default")
        svc["spec"] = {"selector": {"app": "api"},
                       "ports": [{"port": 80, "targetPort": "http",
                                  "protocol": "TCP"}]}
        client.create(SERVICES, svc)
        p1 = bound_running_pod("a1", labels={"app": "api"})
        p1["spec"]["containers"] = [{"name": "c0", "image": "img",
                                     "ports": [{"name": "http",
                                                "containerPort": 8080}]}]
        p2 = bound_running_pod("a2", labels={"app": "api"})
        p2["spec"]["containers"] = [{"name": "c0", "image": "img",
                                     "ports": [{"name": "http",
                                                "containerPort": 9090}]}]
        client.create(PODS, p1)
        client.create(PODS, p2)

        def resolved():
            sls = [s for s in client.list(ENDPOINTSLICES, "default")[0]
                   if meta.labels(s).get("kubernetes.io/service-name")
                   == "api"]
            got = {}
            for s in sls:
                for ep in s.get("endpoints") or ():
                    got[ep["targetRef"]["name"]] = [
                        pt["port"] for pt in s.get("ports") or ()]
            return got == {"a1": [8080], "a2": [9090]}
        assert wait_for(resolved)
        # no slice may carry a non-numeric port (the proxier consumes these)
        for s in client.list(ENDPOINTSLICES, "default")[0]:
            for pt in s.get("ports") or ():
                assert isinstance(pt["port"], int)


class TestReplicationController:
    def test_scales_up_and_down(self, cluster):
        _, client, _ = cluster
        rc = meta.new_object("ReplicationController", "rc1", "default")
        rc["spec"] = {"replicas": 3, "selector": {"app": "rc1"},
                      "template": {"metadata": {"labels": {"app": "rc1"}},
                                   "spec": {"containers": [
                                       {"name": "c0", "image": "img"}]}}}
        client.create(REPLICATIONCONTROLLERS, rc)
        assert wait_for(lambda: len(client.list(PODS, "default")[0]) == 3)

        def scale(o):
            o["spec"]["replicas"] = 1
            return o
        client.guaranteed_update(REPLICATIONCONTROLLERS, "default", "rc1",
                                 scale)
        assert wait_for(lambda: len([
            p for p in client.list(PODS, "default")[0]
            if meta.deletion_timestamp(p) is None]) == 1)


@requires_crypto
class TestCertificates:
    def _make_csr_pem(self):
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
        key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        csr = (x509.CertificateSigningRequestBuilder()
               .subject_name(x509.Name([x509.NameAttribute(
                   NameOID.COMMON_NAME, "system:node:n1")]))
               .sign(key, hashes.SHA256()))
        return csr.public_bytes(serialization.Encoding.PEM)

    def test_approve_and_sign_kubelet_csr(self, cluster):
        _, client, _ = cluster
        csr = meta.new_object("CertificateSigningRequest", "csr-n1", None)
        csr["spec"] = {
            "signerName": "kubernetes.io/kube-apiserver-client-kubelet",
            "usages": ["key encipherment", "digital signature", "client auth"],
            "request": base64.b64encode(self._make_csr_pem()).decode(),
        }
        client.create(CSRS, csr)

        def signed():
            c = client.get(CSRS, "", "csr-n1")
            st = c.get("status") or {}
            approved = any(x.get("type") == "Approved"
                           for x in st.get("conditions") or ())
            return approved and st.get("certificate")
        assert wait_for(signed)
        # the issued cert chains to the cluster CA
        from cryptography import x509
        from kubernetes_tpu_torch.controllers.certificates import ClusterCA
        pem = base64.b64decode(client.get(CSRS, "", "csr-n1")
                               ["status"]["certificate"])
        cert = x509.load_pem_x509_certificate(pem)
        assert cert.issuer == ClusterCA.shared().cert.subject

    def test_unknown_signer_not_approved(self, cluster):
        _, client, _ = cluster
        csr = meta.new_object("CertificateSigningRequest", "csr-x", None)
        csr["spec"] = {"signerName": "example.com/custom",
                       "usages": ["client auth"], "request": ""}
        client.create(CSRS, csr)
        time.sleep(0.3)
        st = client.get(CSRS, "", "csr-x").get("status") or {}
        assert not any(x.get("type") == "Approved"
                       for x in st.get("conditions") or ())


class TestTTLAndRootCA:
    def test_nodes_annotated_with_ttl(self, cluster):
        _, client, _ = cluster
        client.create(NODES, make_node("n1").build())
        assert wait_for(lambda: (client.get(NODES, "", "n1")["metadata"]
                                 .get("annotations") or {})
                        .get("node.alpha.kubernetes.io/ttl") == "0")

    @requires_crypto
    def test_root_ca_configmap_published(self, cluster):
        _, client, _ = cluster
        client.create(NAMESPACES, meta.new_object("Namespace", "team-a", None))
        assert wait_for(lambda: client.list(CONFIGMAPS, "team-a")[0])
        cm = client.get(CONFIGMAPS, "team-a", "kube-root-ca.crt")
        assert "BEGIN CERTIFICATE" in cm["data"]["ca.crt"]


class TestNodeIpam:
    def test_pod_cidr_allocation_and_reuse(self, cluster):
        store, client, mgr = cluster
        from kubernetes_tpu_torch.client import SharedInformerFactory
        from kubernetes_tpu_torch.controllers.nodeipam import NodeIpamController
        factory = SharedInformerFactory(client)
        ipam = NodeIpamController(client, factory,
                                  cluster_cidr="10.244.0.0/22", node_mask=24)
        factory.start()
        factory.wait_for_cache_sync()
        ipam.run()
        try:
            client.create(NODES, make_node("ip-1").build())
            client.create(NODES, make_node("ip-2").build())
            assert wait_for(lambda: all(
                (client.get(NODES, "", n).get("spec") or {}).get("podCIDR")
                for n in ("ip-1", "ip-2")))
            c1 = client.get(NODES, "", "ip-1")["spec"]["podCIDR"]
            c2 = client.get(NODES, "", "ip-2")["spec"]["podCIDR"]
            assert c1 != c2
            # release on delete, reallocate to a new node
            client.delete(NODES, "", "ip-1")
            assert wait_for(lambda: ipam.cidrs._used.get(c1) is None)
            client.create(NODES, make_node("ip-3").build())
            assert wait_for(lambda: (client.get(NODES, "", "ip-3").get("spec")
                                     or {}).get("podCIDR") == c1)
        finally:
            ipam.stop()
            factory.stop()


class TestBootstrapTokens:
    def test_expired_token_cleaned_and_cluster_info_signed(self, cluster):
        store, client, mgr = cluster
        from kubernetes_tpu_torch.controllers.bootstrap import (
            BootstrapSigner, TokenCleaner)
        factory = SharedInformerFactory(client)
        cleaner = TokenCleaner(client, factory)
        cleaner.resync_seconds = 0.1
        signer = BootstrapSigner(client, factory)
        factory.start()
        factory.wait_for_cache_sync()
        cleaner.run()
        signer.run()
        try:
            live = meta.new_object("Secret", "bootstrap-token-abc123",
                                   "kube-system")
            live["type"] = "bootstrap.kubernetes.io/token"
            live["data"] = {"token-id": "abc123", "token-secret": "s3cret",
                            "expiration": str(time.time() + 3600)}
            client.create(SECRETS, live)
            dead = meta.new_object("Secret", "bootstrap-token-dead00",
                                   "kube-system")
            dead["type"] = "bootstrap.kubernetes.io/token"
            dead["data"] = {"token-id": "dead00", "token-secret": "x",
                            "expiration": str(time.time() - 1)}
            client.create(SECRETS, dead)
            assert wait_for(lambda: not any(
                meta.name(s) == "bootstrap-token-dead00"
                for s in client.list(SECRETS, "kube-system")[0]))
            assert wait_for(lambda: "jws-kubeconfig-abc123" in (
                (client.get(CONFIGMAPS, "kube-public", "cluster-info")
                 .get("data") or {})
                if client.list(CONFIGMAPS, "kube-public")[0] else {}))
        finally:
            cleaner.stop()
            signer.stop()
            factory.stop()


class TestVolumeControllers:
    def _pvc(self, name, ns="default", storage="1Gi", cls=None):
        pvc = meta.new_object("PersistentVolumeClaim", name, ns)
        pvc["spec"] = {"accessModes": ["ReadWriteOnce"],
                       "resources": {"requests": {"storage": storage}}}
        if cls:
            pvc["spec"]["storageClassName"] = cls
        return pvc

    def _pv(self, name, storage="2Gi", cls=None, policy="Retain"):
        pv = meta.new_object("PersistentVolume", name, None)
        pv["spec"] = {"capacity": {"storage": storage},
                      "accessModes": ["ReadWriteOnce"],
                      "persistentVolumeReclaimPolicy": policy}
        if cls:
            pv["spec"]["storageClassName"] = cls
        return pv

    def test_static_binding(self, cluster):
        _, client, _ = cluster
        client.create(PVS, self._pv("pv-a"))
        client.create(PVCS, self._pvc("claim-a"))
        assert wait_for(lambda: (client.get(PVCS, "default", "claim-a")
                                 .get("spec") or {}).get("volumeName") == "pv-a")
        pv = client.get(PVS, "", "pv-a")
        assert (pv.get("spec") or {}).get("claimRef", {}).get("name") == "claim-a"
        assert (pv.get("status") or {}).get("phase") == "Bound"

    def test_too_small_pv_not_bound(self, cluster):
        _, client, _ = cluster
        client.create(PVS, self._pv("pv-small", storage="512Mi"))
        client.create(PVCS, self._pvc("claim-big", storage="1Gi"))
        time.sleep(0.3)
        assert not (client.get(PVCS, "default", "claim-big")
                    .get("spec") or {}).get("volumeName")

    def test_dynamic_provisioning(self, cluster):
        _, client, _ = cluster
        sc = meta.new_object("StorageClass", "fast", None)
        sc["provisioner"] = "tpu.kubernetes.io/host-provisioner"
        client.create(STORAGECLASSES, sc)
        client.create(PVCS, self._pvc("claim-dyn", cls="fast"))
        assert wait_for(lambda: (client.get(PVCS, "default", "claim-dyn")
                                 .get("spec") or {}).get("volumeName"))

    def test_delete_reclaim(self, cluster):
        _, client, _ = cluster
        pv = self._pv("pv-del", policy="Delete")
        client.create(PVS, pv)
        client.create(PVCS, self._pvc("claim-del"))
        assert wait_for(lambda: (client.get(PVCS, "default", "claim-del")
                                 .get("spec") or {}).get("volumeName"))
        client.delete(PVCS, "default", "claim-del")
        # claim unprotected (no pod uses it) -> gone -> PV reclaimed
        assert wait_for(lambda: not any(
            meta.name(p) == "pv-del" for p in client.list(PVS, None)[0]))

    def test_pvc_protection_blocks_delete_while_in_use(self, cluster):
        _, client, _ = cluster
        client.create(PVCS, self._pvc("claim-p"))
        assert wait_for(lambda: "kubernetes.io/pvc-protection" in (
            client.get(PVCS, "default", "claim-p")["metadata"]
            .get("finalizers") or []))
        pod = make_pod("user-pod").node("n1").build()
        pod["spec"]["volumes"] = [{"name": "v",
                                   "persistentVolumeClaim":
                                   {"claimName": "claim-p"}}]
        client.create(PODS, pod)
        time.sleep(0.2)
        client.delete(PVCS, "default", "claim-p")  # -> terminating, not gone
        time.sleep(0.3)
        pvc = client.get(PVCS, "default", "claim-p")
        assert pvc["metadata"].get("deletionTimestamp")
        # pod goes away -> finalizer stripped -> PVC really deleted
        client.delete(PODS, "default", "user-pod")
        assert wait_for(lambda: not any(
            meta.name(c) == "claim-p"
            for c in client.list(PVCS, "default")[0]))

    def test_attach_detach_and_ephemeral(self, cluster):
        _, client, _ = cluster
        client.create(NODES, make_node("vn1").build())
        client.create(PVS, self._pv("pv-att"))
        client.create(PVCS, self._pvc("claim-att"))
        assert wait_for(lambda: (client.get(PVCS, "default", "claim-att")
                                 .get("spec") or {}).get("volumeName"))
        pod = make_pod("att-pod").node("vn1").build()
        pod["spec"]["volumes"] = [
            {"name": "v", "persistentVolumeClaim": {"claimName": "claim-att"}},
            {"name": "scratch", "ephemeral": {"volumeClaimTemplate": {
                "spec": {"accessModes": ["ReadWriteOnce"],
                         "resources": {"requests": {"storage": "1Gi"}}}}}},
        ]
        client.create(PODS, pod)
        assert wait_for(lambda: any(
            (va.get("spec") or {}).get("nodeName") == "vn1"
            for va in client.list(VOLUMEATTACHMENTS, None)[0]))
        assert wait_for(lambda: any(
            meta.name(c) == "att-pod-scratch"
            for c in client.list(PVCS, "default")[0]))
        node = client.get(NODES, "", "vn1")
        assert wait_for(lambda: (client.get(NODES, "", "vn1").get("status")
                                 or {}).get("volumesAttached"))
        # pod deleted -> detach
        client.delete(PODS, "default", "att-pod")
        assert wait_for(lambda: not any(
            (va.get("spec") or {}).get("nodeName") == "vn1"
            for va in client.list(VOLUMEATTACHMENTS, None)[0]))


class TestCascadeDeletion:
    def test_rc_delete_cascades_to_pods(self, cluster):
        _, client, _ = cluster
        rc = meta.new_object("ReplicationController", "rc-gc", "default")
        rc["spec"] = {"replicas": 2, "selector": {"app": "rc-gc"},
                      "template": {"metadata": {"labels": {"app": "rc-gc"}},
                                   "spec": {"containers": [
                                       {"name": "c0", "image": "img"}]}}}
        client.create(REPLICATIONCONTROLLERS, rc)
        assert wait_for(lambda: len(client.list(PODS, "default")[0]) == 2)
        client.delete(REPLICATIONCONTROLLERS, "default", "rc-gc")
        assert wait_for(lambda: not client.list(PODS, "default")[0])

    def test_pod_delete_cascades_to_ephemeral_pvc(self, cluster):
        _, client, _ = cluster
        pod = make_pod("eph-pod").node("n1").build()
        pod["spec"]["volumes"] = [
            {"name": "scratch", "ephemeral": {"volumeClaimTemplate": {
                "spec": {"accessModes": ["ReadWriteOnce"],
                         "resources": {"requests": {"storage": "1Gi"}}}}}}]
        client.create(PODS, pod)
        assert wait_for(lambda: any(
            meta.name(c) == "eph-pod-scratch"
            for c in client.list(PVCS, "default")[0]))
        client.delete(PODS, "default", "eph-pod")
        assert wait_for(lambda: not any(
            meta.name(c) == "eph-pod-scratch"
            for c in client.list(PVCS, "default")[0]))


class TestBinderWakeups:
    def test_claim_created_before_pv_binds_when_pv_arrives(self, cluster):
        _, client, _ = cluster
        pvc = meta.new_object("PersistentVolumeClaim", "early-claim", "default")
        pvc["spec"] = {"accessModes": ["ReadWriteOnce"],
                       "resources": {"requests": {"storage": "1Gi"}}}
        client.create(PVCS, pvc)
        time.sleep(0.3)  # claim syncs with no PV available
        pv = meta.new_object("PersistentVolume", "late-pv", None)
        pv["spec"] = {"capacity": {"storage": "2Gi"},
                      "accessModes": ["ReadWriteOnce"],
                      "persistentVolumeReclaimPolicy": "Retain"}
        client.create(PVS, pv)
        assert wait_for(lambda: (client.get(PVCS, "default", "early-claim")
                                 .get("spec") or {}).get("volumeName")
                        == "late-pv")


class TestCloudControllerManager:
    def _ccm(self, client):
        from kubernetes_tpu_torch.client import SharedInformerFactory
        from kubernetes_tpu_torch.controllers.cloud import CloudControllerManager
        factory = SharedInformerFactory(client)
        ccm = CloudControllerManager(client, factory)
        factory.start()
        factory.wait_for_cache_sync()
        ccm.run()
        return factory, ccm

    def test_loadbalancer_lifecycle(self, cluster):
        _, client, _ = cluster
        factory, ccm = self._ccm(client)
        try:
            svc = meta.new_object("Service", "lb-svc", "default")
            svc["spec"] = {"type": "LoadBalancer", "clusterIP": "10.96.9.9",
                           "ports": [{"port": 443}]}
            client.create(SERVICES, svc)
            assert wait_for(lambda: ((client.get(SERVICES, "default",
                                                 "lb-svc").get("status")
                                      or {}).get("loadBalancer") or {})
                            .get("ingress"))
            ip = client.get(SERVICES, "default", "lb-svc")[
                "status"]["loadBalancer"]["ingress"][0]["ip"]
            assert ip.startswith("203.0.113.")
            # type change -> deprovision + status cleared
            def retype(o):
                o["spec"]["type"] = "ClusterIP"
                return o
            client.guaranteed_update(SERVICES, "default", "lb-svc", retype)
            assert wait_for(lambda: not (client.get(SERVICES, "default",
                                                    "lb-svc").get("status")
                                         or {}).get("loadBalancer"))
            assert "default/lb-svc" not in ccm.cloud._lbs
        finally:
            ccm.stop()
            factory.stop()

    def test_node_metadata_routes_and_taint(self, cluster):
        _, client, _ = cluster
        factory, ccm = self._ccm(client)
        try:
            n = make_node("cloud-1").build()
            n["spec"]["taints"] = [{
                "key": "node.cloudprovider.kubernetes.io/uninitialized",
                "value": "true", "effect": "NoSchedule"}]
            n["spec"]["podCIDR"] = "10.244.9.0/24"
            client.create(NODES, n)
            assert wait_for(lambda: (client.get(NODES, "", "cloud-1")
                                     .get("spec") or {}).get("providerID"))
            got = client.get(NODES, "", "cloud-1")
            assert meta.labels(got)["topology.kubernetes.io/zone"] \
                == "tpu-zone-a"
            assert not any(
                t.get("key").startswith("node.cloudprovider")
                for t in got["spec"].get("taints") or ())
            assert wait_for(
                lambda: ccm.cloud.routes.get("cloud-1") == "10.244.9.0/24")
            assert wait_for(lambda: any(
                c.get("type") == "NetworkUnavailable"
                and c.get("status") == "False"
                for c in (client.get(NODES, "", "cloud-1").get("status")
                          or {}).get("conditions") or ()))
        finally:
            ccm.stop()
            factory.stop()
