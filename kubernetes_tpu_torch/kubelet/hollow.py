"""Hollow kubelet — the node agent with a fake runtime.

Reference: pkg/kubelet (syncLoop, kubelet.go:2019) driven through the
kubemark hollow-node shape (pkg/kubemark/hollow_kubelet.go:87): real
kubelet logic, fake CRI, fake cadvisor.  The loop here is event-driven off
the pod informer (ADD/UPDATE/DELETE -> per-pod sync, kubelet
syncLoopIteration) plus a PLEG-like relist that surfaces container exits
(pkg/kubelet/pleg/generic.go), and a heartbeat loop renewing the node
Lease + status (kubelet nodestatus + nodelease).

A copy of kubernetes_tpu/kubelet/hollow.py: the same classes, names and
logic, over this package's api/, client/ and store/.
ROADMAP R14 pins three of its traits in both packages.  (a) Every event
of a node's pod, the event of the kubelet's own status write included,
makes the kubelet write the pod's status again, so a running pod's
status is rewritten without pause; the PLEG loop rewrites it once more
each second and finds each pod by a scan of the informer; and every
kubelet's handler sees every pod event.  (b) hostIP and podIP come from
hash() of strings, which PYTHONHASHSEED salts per process.  (c)
_register_node swallows AlreadyExistsError, so two hollow binaries
against one apiserver claim the same nodes.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..api.resources import make_resource_list
from ..client.clientset import LEASES, NODES, PODS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv
from .cri import EXITED, RUNNING, FakeRuntimeService

logger = logging.getLogger(__name__)

LEASE_NS = "kube-node-lease"


class HollowKubelet:
    def __init__(self, client: Client, factory: SharedInformerFactory,
                 node_name: str, cpu: str = "32", memory: str = "256Gi",
                 pods: int = 110, labels: dict[str, str] | None = None,
                 heartbeat_interval: float = 10.0,
                 runtime: FakeRuntimeService | None = None,
                 container_manager=None, kubelet_server=None):
        self.client = client
        self.node_name = node_name
        self.cpu, self.memory, self.max_pods = cpu, memory, pods
        self.labels = labels or {}
        self.heartbeat_interval = heartbeat_interval
        self.runtime = runtime or FakeRuntimeService()
        # optional cm.ContainerManager: runs resource admission (cpu/memory/
        # device/topology managers) before containers start
        self.container_manager = container_manager
        # optional server.KubeletServer: serves logs/exec/attach/
        # portForward for this node; its port lands in node status
        self.kubelet_server = kubelet_server
        self.pod_informer = factory.informer(PODS)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # pod uid -> {"sandbox": id, "containers": {name: id},
        #             "key": (ns, podname)}
        self._pod_state: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "HollowKubelet":
        if self.kubelet_server is not None:
            self.kubelet_server.register(self)
        self._register_node()
        if self.container_manager is not None:
            # reconcile checkpointed allocations against live pods: anything
            # restored for a pod that vanished while we were down leaks
            # forever otherwise (callers start the informer factory before
            # kubelets, so the view is synced here)
            live = {meta.uid(p) for p in self.pod_informer.list()
                    if meta.pod_node_name(p) == self.node_name
                    and not meta.pod_is_terminal(p)}
            self.container_manager.reconcile(live)
        self.pod_informer.add_event_handler(self._on_pod_event)
        for target, name in ((self._heartbeat_loop, "heartbeat"),
                             (self._pleg_loop, "pleg")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"kubelet-{self.node_name}-{name}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.kubelet_server is not None:
            self.kubelet_server.unregister(self)

    # -- node registration + heartbeats ----------------------------------

    def _register_node(self) -> None:
        rl = make_resource_list(
            cpu_milli=int(float(self.cpu) * 1000),
            mem=self._mem_bytes(), pods=self.max_pods)
        if self.container_manager is not None:
            # device plugins surface as scalar allocatable (devicemanager
            # feeding nodestatus, e.g. google.com/tpu)
            for res, n in self.container_manager.devices.allocatable().items():
                rl[res] = str(n)
        node = meta.new_object("Node", self.node_name, None)
        node["metadata"]["labels"] = {
            "kubernetes.io/hostname": self.node_name, **self.labels}
        node["spec"] = {}
        node["status"] = {
            "capacity": rl, "allocatable": rl,
            "conditions": [{"type": "Ready", "status": "True"}],
            "nodeInfo": {"kubeletVersion": "hollow", "architecture": "tpu"},
            "lastHeartbeatTime": time.time(),
        }
        if self.kubelet_server is not None:
            # nodestatus daemonEndpoints: how the apiserver's node tunnel
            # finds this kubelet (pkg/kubelet/nodestatus/setters.go)
            node["status"]["addresses"] = [
                {"type": "InternalIP",
                 "address": self.kubelet_server.host}]
            node["status"]["daemonEndpoints"] = {
                "kubeletEndpoint": {"Port": self.kubelet_server.port}}
        try:
            self.client.create(NODES, node)
        except kv.AlreadyExistsError:
            pass
        lease = meta.new_object("Lease", self.node_name, LEASE_NS)
        lease["spec"] = {"holderIdentity": self.node_name,
                         "renewTime": time.time(),
                         "leaseDurationSeconds": 40}
        try:
            self.client.create(LEASES, lease)
        except kv.AlreadyExistsError:
            pass

    def _mem_bytes(self) -> int:
        from ..api.quantity import parse_mem_bytes
        return parse_mem_bytes(self.memory)

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            now = time.time()
            try:
                self.client.guaranteed_update(
                    LEASES, LEASE_NS, self.node_name,
                    lambda l: {**l, "spec": {**l.get("spec", {}),
                                             "renewTime": now}})
                self.client.guaranteed_update(
                    NODES, "", self.node_name,
                    lambda n: {**n, "status": {**n.get("status", {}),
                                               "lastHeartbeatTime": now}})
            except kv.StoreError:
                pass

    # -- pod sync (syncLoopIteration -> SyncPod) -------------------------

    def _on_pod_event(self, type_: str, pod: Obj, old: Obj | None) -> None:
        mine = meta.pod_node_name(pod) == self.node_name
        was_mine = old is not None and meta.pod_node_name(old) == self.node_name
        if not mine and not was_mine:
            return
        if type_ == kv.DELETED or not mine:
            self._kill_pod(pod)
        elif meta.pod_is_terminal(pod):
            # terminal pods keep their API object but give back their
            # sandbox and resource-manager allocations (devicemanager
            # reclaims terminated pods' devices via activePods)
            self._kill_pod(pod)
        else:
            self._sync_pod(pod)

    def _sync_pod(self, pod: Obj) -> None:
        """kuberuntime SyncPod (kuberuntime_manager.go:672): ensure sandbox,
        start missing containers, then report status."""
        uid = meta.uid(pod)
        if self.container_manager is not None:
            with self._lock:
                new_pod = uid not in self._pod_state
            if new_pod and not self._admit(pod):
                return
        with self._lock:
            st = self._pod_state.get(uid)
            if st is None:
                sandbox = self.runtime.run_pod_sandbox(
                    {"name": meta.name(pod), "uid": uid})
                st = self._pod_state[uid] = {
                    "sandbox": sandbox, "containers": {},
                    "key": (meta.namespace(pod), meta.name(pod))}
            for c in (pod.get("spec") or {}).get("containers") or ():
                if c["name"] in st["containers"]:
                    continue
                self.runtime.pull_image(c.get("image", ""))
                cid = self.runtime.create_container(st["sandbox"], {
                    "name": c["name"], "image": c.get("image", ""),
                    "annotations": meta.annotations(pod),
                    "env": c.get("env"), "ports": c.get("ports")})
                self.runtime.start_container(cid)
                st["containers"][c["name"]] = cid
        self._report_status(pod)

    def _admit(self, pod: Obj) -> bool:
        """kubelet admission (HandlePodAdditions -> canAdmitPod): resource
        managers allocate or the pod is failed with the admission reason."""
        from .cm import AdmissionError
        try:
            self.container_manager.admit_pod(pod)
            return True
        except AdmissionError as e:
            def patch(p):
                p.setdefault("status", {}).update({
                    "phase": "Failed", "reason": "UnexpectedAdmissionError",
                    "message": str(e)})
                return p
            try:
                self.client.guaranteed_update(PODS, meta.namespace(pod),
                                              meta.name(pod), patch)
            except kv.StoreError:
                pass
            return False

    def _kill_pod(self, pod: Obj) -> None:
        uid = meta.uid(pod)
        if self.container_manager is not None:
            self.container_manager.release_pod(uid)
        with self._lock:
            st = self._pod_state.pop(uid, None)
        if st:
            self.runtime.stop_pod_sandbox(st["sandbox"])
            self.runtime.remove_pod_sandbox(st["sandbox"])

    def _report_status(self, pod: Obj) -> None:
        uid = meta.uid(pod)
        with self._lock:
            st = self._pod_state.get(uid)
        if st is None:
            return
        containers = self.runtime.list_containers(st["sandbox"])
        running = [c for c in containers if c["state"] == RUNNING]
        exited = [c for c in containers if c["state"] == EXITED]
        if containers and not running and exited:
            failed = any(c.get("exitCode") not in (0, None) for c in exited)
            phase = "Failed" if failed else "Succeeded"
            ready = False
        else:
            phase = "Running"
            ready = bool(running)
        status = {
            "phase": phase,
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Ready", "status": "True" if ready else "False"},
            ],
            "containerStatuses": [
                {"name": c["name"], "state": c["state"],
                 "exitCode": c.get("exitCode")} for c in containers],
            "hostIP": f"10.0.0.{abs(hash(self.node_name)) % 250 + 1}",
            "podIP": f"10.{abs(hash(uid)) % 250}.{abs(hash(uid) >> 8) % 250}."
                     f"{abs(hash(uid) >> 16) % 250 + 1}",
        }
        try:
            def patch(p):
                # terminal phases never regress (status_manager versioned
                # updates): a stale Running report must not resurrect a
                # pod that went Succeeded/Failed meanwhile
                if (p.get("status") or {}).get("phase") in ("Succeeded",
                                                            "Failed"):
                    return p
                p.setdefault("status", {}).update(status)
                return p
            self.client.guaranteed_update(PODS, meta.namespace(pod),
                                          meta.name(pod), patch)
        except kv.StoreError:
            pass

    # -- PLEG: relist container states, surface exits --------------------

    def _pleg_loop(self) -> None:
        while not self._stop.wait(1.0):
            with self._lock:
                uids = list(self._pod_state)
            for uid in uids:
                pod = self._find_pod(uid)
                if pod is not None and not meta.pod_is_terminal(pod):
                    self._report_status(pod)

    def _find_pod(self, uid: str) -> Obj | None:
        for p in self.pod_informer.list():
            if meta.uid(p) == uid:
                return p
        return None

    # -- streaming-server lookups ---------------------------------------

    def lookup_pod(self, ns: str, name: str) -> dict | None:
        """(sandbox id, container name->id) for a pod this node runs."""
        with self._lock:
            for st in self._pod_state.values():
                if st.get("key") == (ns, name):
                    return {"sandbox": st["sandbox"],
                            "containers": dict(st["containers"])}
        return None

    def list_pod_keys(self) -> list[tuple[str, str]]:
        with self._lock:
            return [st["key"] for st in self._pod_state.values()
                    if "key" in st]


def start_hollow_nodes(client: Client, factory: SharedInformerFactory,
                       count: int, prefix: str = "hollow-",
                       **kwargs) -> list[HollowKubelet]:
    """kubemark: register `count` hollow nodes against the control plane."""
    return [HollowKubelet(client, factory, f"{prefix}{i}", **kwargs).start()
            for i in range(count)]
