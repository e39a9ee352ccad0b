"""The container-manager layer in the port (kubernetes_tpu_torch/kubelet/
cm.py: the CPU, memory, device and topology managers and ContainerManager)
held against the JAX package's on the CPU.

  (a) Parity: seeded sequences of admissions, releases and reconciles
      over seeded pods (Guaranteed with whole and fractional CPUs,
      Burstable, BestEffort, device requests) through both packages'
      ContainerManagers, under every topology policy and with one and
      two NUMA nodes: each provider's hints before each admission, each
      admission's merged hint, cores, memory banks and devices or its
      error, and the managers' tables after each step are the same; each
      package restores the other's checkpoints.
  (b) tests/test_kubelet_cm.py's 16 scenarios on the port's classes.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")

from kubernetes_tpu_torch.kubelet.cm import (  # noqa: E402
    TOPOLOGY_RESTRICTED, TOPOLOGY_SINGLE_NUMA, AdmissionError,
    ContainerManager, CPUManager, DeviceManager, DevicePlugin, MemoryManager,
    TopologyHint, TopologyManager, merge_hints,
)

JAX, PORT = "kubernetes_tpu", "kubernetes_tpu_torch"
POLICIES = ("none", "best-effort", "restricted", "single-numa-node")


def cm_mod(pkg):
    return importlib.import_module(f"{pkg}.kubelet.cm")


def seeded_pod(rng, i):
    """A pod of one of the shapes the managers tell apart."""
    kind = int(rng.integers(5))
    uid = f"p{i}"
    cpu = ["1", "2", "3", "1500m"][int(rng.integers(4))]
    mem = ["512Mi", "1Gi", "3Gi", "5Gi"][int(rng.integers(4))]
    req = {"cpu": cpu, "memory": mem}
    if kind == 4 or rng.random() < 0.3:
        req["google.com/tpu"] = str(int(rng.integers(1, 4)))
    if kind in (0, 1, 4):      # Guaranteed: limits equal to requests
        res = {"requests": dict(req), "limits": dict(req)}
    elif kind == 2:            # Burstable
        res = {"requests": {"cpu": cpu}}
    else:                      # BestEffort
        res = {}
    return {"metadata": {"uid": uid, "name": uid},
            "spec": {"containers": [{"name": "c0", "image": "img",
                                     "resources": res}]}}


def hints_of(hints):
    return [(h.numa_mask, h.preferred) for h in hints]


def tables(cm):
    return (dict(cm.cpu.assignments),
            {u: dict(a) for u, a in cm.memory.assignments.items()},
            {u: dict(a) for u, a in cm.devices.allocations.items()},
            {u: (h.numa_mask, h.preferred)
             for u, h in cm.topology.pod_hints.items()})


def cm_script(pkg, seed, policy, num_numa, checkpoint_dir=None):
    """One seeded sequence through one package's ContainerManager."""
    mod = cm_mod(pkg)
    rng = np.random.default_rng(seed)
    cm = mod.ContainerManager(num_cpus=8, memory_bytes=8 << 30,
                              num_numa=num_numa, topology_policy=policy,
                              checkpoint_dir=checkpoint_dir)
    cm.devices.register(mod.DevicePlugin(
        "google.com/tpu", {f"tpu{i}": i % num_numa for i in range(4)}))
    trace, live = [], []
    for i in range(60):
        op = rng.random()
        if op < 0.6 or not live:
            pod = seeded_pod(rng, i)
            uid = pod["metadata"]["uid"]
            step = [hints_of(cm.cpu.hints(pod)),
                    hints_of(cm.memory.hints(pod)),
                    hints_of(cm.devices.hints(pod))]
            try:
                cm.admit_pod(pod)
                live.append(uid)
                step.append("admitted")
            except mod.AdmissionError as e:
                step.append(("refused", str(e)))
        elif op < 0.9:
            uid = live.pop(int(rng.integers(len(live))))
            cm.release_pod(uid)
            step = ["released", uid]
        else:
            keep = set(live[::2])
            cm.reconcile(keep)
            live = [u for u in live if u in keep]
            step = ["reconciled", sorted(keep)]
        trace.append((step, tables(cm)))
    return trace, cm


@pytest.mark.parametrize("num_numa", [1, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_admissions_match(policy, num_numa):
    jax_trace, _ = cm_script(JAX, 7 + num_numa, policy, num_numa)
    port_trace, _ = cm_script(PORT, 7 + num_numa, policy, num_numa)
    outcomes = [step[-1] for step, _ in jax_trace]
    assert "admitted" in outcomes
    assert port_trace == jax_trace


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
def test_checkpoints_restore_across_packages(writer, reader, tmp_path):
    _trace, cm = cm_script(writer, 11, "best-effort", 2, str(tmp_path))
    assert tables(cm)[0] or tables(cm)[2]
    mod = cm_mod(reader)
    restored = mod.ContainerManager(num_cpus=8, memory_bytes=8 << 30,
                                    num_numa=2, topology_policy="best-effort",
                                    checkpoint_dir=str(tmp_path))
    restored.devices.register(mod.DevicePlugin(
        "google.com/tpu", {f"tpu{i}": i % 2 for i in range(4)}))
    got, want = tables(restored), tables(cm)
    assert got[:3] == want[:3]     # the topology table is not checkpointed


# -- (b) tests/test_kubelet_cm.py's scenarios on the port -------------------

def guaranteed_pod(uid, cpu="2", memory="2Gi", extra_requests=None):
    req = {"cpu": cpu, "memory": memory, **(extra_requests or {})}
    return {"metadata": {"uid": uid, "name": uid},
            "spec": {"containers": [{"name": "c0", "image": "img",
                                     "resources": {"requests": dict(req),
                                                   "limits": dict(req)}}]}}


def burstable_pod(uid, cpu="2"):
    return {"metadata": {"uid": uid, "name": uid},
            "spec": {"containers": [{"name": "c0", "image": "img",
                                     "resources": {"requests": {"cpu": cpu}}}]}}


class TestCPUManager:
    def test_exclusive_cores_for_guaranteed_integer(self):
        m = CPUManager(num_cpus=8, reserved=1)
        cores = m.allocate(guaranteed_pod("p1", cpu="2"))
        assert len(cores) == 2 and all(c >= 1 for c in cores)
        # second pod gets disjoint cores
        cores2 = m.allocate(guaranteed_pod("p2", cpu="3"))
        assert not set(cores) & set(cores2)
        m.release("p1")
        assert set(m.allocate(guaranteed_pod("p3", cpu="2"))) == set(cores)

    def test_non_integer_or_burstable_stay_shared(self):
        m = CPUManager(num_cpus=8)
        assert m.allocate(guaranteed_pod("p1", cpu="1500m")) == []
        assert m.allocate(burstable_pod("p2")) == []

    def test_exhaustion_raises(self):
        m = CPUManager(num_cpus=4, reserved=1)
        m.allocate(guaranteed_pod("p1", cpu="3"))
        with pytest.raises(AdmissionError):
            m.allocate(guaranteed_pod("p2", cpu="1"))

    def test_checkpoint_restore(self, tmp_path):
        from kubernetes_tpu_torch.kubelet.checkpoint import CheckpointManager
        ck = CheckpointManager(str(tmp_path))
        m = CPUManager(num_cpus=8, checkpoints=ck)
        cores = m.allocate(guaranteed_pod("p1", cpu="2"))
        m2 = CPUManager(num_cpus=8, checkpoints=ck)
        assert m2.assignments["p1"] == cores


class TestMemoryManager:
    def test_numa_bank_allocation(self):
        m = MemoryManager(numa_banks=[4 << 30, 4 << 30])
        alloc = m.allocate(guaranteed_pod("p1", memory="3Gi"),
                           TopologyHint(0b01, True))
        assert alloc == {0: 3 << 30}
        # spills across banks when one can't hold it
        alloc2 = m.allocate(guaranteed_pod("p2", memory="4Gi"))
        assert sum(alloc2.values()) == 4 << 30 and len(alloc2) == 2

    def test_exhaustion(self):
        m = MemoryManager(numa_banks=[2 << 30])
        with pytest.raises(AdmissionError):
            m.allocate(guaranteed_pod("p1", memory="3Gi"))


class TestDeviceManager:
    def _mgr(self):
        m = DeviceManager()
        m.register(DevicePlugin("google.com/tpu",
                                {"tpu0": 0, "tpu1": 0, "tpu2": 1, "tpu3": 1}))
        return m

    def test_allocatable_and_allocate(self):
        m = self._mgr()
        assert m.allocatable() == {"google.com/tpu": 4}
        pod = guaranteed_pod("p1", extra_requests={"google.com/tpu": "2"})
        alloc = m.allocate(pod, TopologyHint(0b10, True))
        assert alloc["google.com/tpu"] == ["tpu2", "tpu3"]  # NUMA-1 first
        pod2 = guaranteed_pod("p2", extra_requests={"google.com/tpu": "3"})
        with pytest.raises(AdmissionError):
            m.allocate(pod2)

    def test_hints_prefer_single_numa(self):
        m = self._mgr()
        pod = guaranteed_pod("p1", extra_requests={"google.com/tpu": "2"})
        hints = m.hints(pod)
        assert TopologyHint(0b01, True) in hints
        assert TopologyHint(0b10, True) in hints
        # 3 devices cannot come from one NUMA node: only the wide fallback
        pod3 = guaranteed_pod("p3", extra_requests={"google.com/tpu": "3"})
        hints3 = m.hints(pod3)
        assert hints3 == [TopologyHint(0b11, False)]


class TestTopologyManager:
    def test_merge_prefers_narrow_preferred(self):
        merged = merge_hints([[TopologyHint(0b01, True),
                               TopologyHint(0b11, False)],
                              [TopologyHint(0b01, True)]], 2)
        assert merged == TopologyHint(0b01, True)

    def test_restricted_rejects_unpreferred(self):
        tm = TopologyManager(TOPOLOGY_RESTRICTED, num_numa=2)
        with pytest.raises(AdmissionError):
            tm.admit("p1", [[TopologyHint(0b11, False)]])

    def test_single_numa_rejects_wide(self):
        tm = TopologyManager(TOPOLOGY_SINGLE_NUMA, num_numa=2)
        with pytest.raises(AdmissionError):
            tm.admit("p1", [[TopologyHint(0b11, True)]])
        assert tm.admit("p2", [[TopologyHint(0b10, True)]]).numa_mask == 0b10


class TestContainerManager:
    def test_admit_and_release_roundtrip(self, tmp_path):
        cm = ContainerManager(num_cpus=8, memory_bytes=8 << 30, num_numa=2,
                              topology_policy=TOPOLOGY_SINGLE_NUMA,
                              checkpoint_dir=str(tmp_path))
        cm.devices.register(DevicePlugin("google.com/tpu",
                                         {"tpu0": 0, "tpu1": 1}))
        pod = guaranteed_pod("p1", cpu="2", memory="2Gi",
                             extra_requests={"google.com/tpu": "1"})
        cm.admit_pod(pod)
        assert cm.cpu.assignments["p1"]
        assert cm.devices.allocations["p1"]["google.com/tpu"]
        # everything the pod got sits on ONE numa node
        numa = cm.topology.pod_hints["p1"].numa_mask
        assert bin(numa).count("1") == 1
        cm.release_pod("p1")
        assert "p1" not in cm.cpu.assignments
        assert "p1" not in cm.devices.allocations

    def test_admission_failure_rolls_back(self):
        cm = ContainerManager(num_cpus=4, memory_bytes=2 << 30)
        # memory is the blocker; CPU allocation must be rolled back
        pod = guaranteed_pod("p1", cpu="2", memory="4Gi")
        with pytest.raises(AdmissionError):
            cm.admit_pod(pod)
        assert "p1" not in cm.cpu.assignments
        assert "p1" not in cm.memory.assignments


class TestKubeletAdmissionIntegration:
    def test_hollow_kubelet_admits_and_fails_pods(self):
        import time as _t

        from kubernetes_tpu_torch.api import meta
        from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
        from kubernetes_tpu_torch.client.clientset import PODS
        from kubernetes_tpu_torch.kubelet.hollow import HollowKubelet
        from kubernetes_tpu_torch.store import kv as kvs

        def wait_for(pred, timeout=10.0):
            deadline = _t.time() + timeout
            while _t.time() < deadline:
                if pred():
                    return True
                _t.sleep(0.02)
            return False

        store = kvs.MemoryStore()
        client = LocalClient(store)
        factory = SharedInformerFactory(client)
        cm = ContainerManager(num_cpus=4, memory_bytes=8 << 30)
        cm.devices.register(DevicePlugin("google.com/tpu", {"tpu0": 0}))
        kubelet = HollowKubelet(client, factory, "cm-node",
                                container_manager=cm)
        factory.start()
        factory.wait_for_cache_sync()
        kubelet.start()
        try:
            # device allocatable surfaced on the node
            node = client.get("nodes", "", "cm-node")
            assert node["status"]["allocatable"]["google.com/tpu"] == "1"
            ok = guaranteed_pod("ok-pod", cpu="2", memory="1Gi",
                                extra_requests={"google.com/tpu": "1"})
            ok["metadata"]["namespace"] = "default"
            ok["spec"]["nodeName"] = "cm-node"
            client.create(PODS, ok)
            assert wait_for(lambda: (client.get(PODS, "default", "ok-pod")
                                     .get("status") or {}).get("phase")
                            == "Running")
            assert cm.devices.allocations  # admitted through the cm
            # second TPU pod must fail admission (only one chip)
            bad = guaranteed_pod("bad-pod", cpu="1", memory="1Gi",
                                 extra_requests={"google.com/tpu": "1"})
            bad["metadata"]["namespace"] = "default"
            bad["spec"]["nodeName"] = "cm-node"
            client.create(PODS, bad)
            assert wait_for(lambda: (client.get(PODS, "default", "bad-pod")
                                     .get("status") or {}).get("reason")
                            == "UnexpectedAdmissionError")
            # deleting the good pod releases its devices
            client.delete(PODS, "default", "ok-pod")
            assert wait_for(lambda: not cm.devices.allocations)
        finally:
            kubelet.stop()
            factory.stop()


class TestTerminalReclaimAndReconcile:
    def test_terminal_pod_releases_devices(self):
        import time as _t

        from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
        from kubernetes_tpu_torch.client.clientset import PODS
        from kubernetes_tpu_torch.kubelet.hollow import HollowKubelet
        from kubernetes_tpu_torch.store import kv as kvs

        store = kvs.MemoryStore()
        client = LocalClient(store)
        factory = SharedInformerFactory(client)
        cm = ContainerManager(num_cpus=8, memory_bytes=8 << 30)
        cm.devices.register(DevicePlugin("google.com/tpu", {"tpu0": 0}))
        kubelet = HollowKubelet(client, factory, "t-node",
                                container_manager=cm)
        factory.start()
        factory.wait_for_cache_sync()
        kubelet.start()
        try:
            pod = guaranteed_pod("term-pod", cpu="1", memory="1Gi",
                                 extra_requests={"google.com/tpu": "1"})
            pod["metadata"]["namespace"] = "default"
            pod["spec"]["nodeName"] = "t-node"
            client.create(PODS, pod)
            deadline = _t.time() + 10
            while _t.time() < deadline and not cm.devices.allocations:
                _t.sleep(0.02)
            assert cm.devices.allocations
            # pod turns terminal (NOT deleted): devices must come back
            client.update_status(PODS, {**client.get(PODS, "default",
                                                     "term-pod"),
                                        "status": {"phase": "Succeeded"}})
            deadline = _t.time() + 10
            while _t.time() < deadline and cm.devices.allocations:
                _t.sleep(0.02)
            assert not cm.devices.allocations
        finally:
            kubelet.stop()
            factory.stop()

    def test_restart_reconciles_stale_checkpoint(self, tmp_path):
        cm = ContainerManager(num_cpus=8, memory_bytes=8 << 30,
                              checkpoint_dir=str(tmp_path))
        cm.devices.register(DevicePlugin("google.com/tpu", {"tpu0": 0}))
        cm.admit_pod(guaranteed_pod("ghost", cpu="1", memory="1Gi",
                                    extra_requests={"google.com/tpu": "1"}))
        # simulated restart: fresh managers restore the checkpoint...
        cm2 = ContainerManager(num_cpus=8, memory_bytes=8 << 30,
                               checkpoint_dir=str(tmp_path))
        cm2.devices.register(DevicePlugin("google.com/tpu", {"tpu0": 0}))
        assert "ghost" in cm2.devices.allocations
        # ...and reconcile against live pods (ghost vanished meanwhile)
        cm2.reconcile(set())
        assert "ghost" not in cm2.devices.allocations
        assert "ghost" not in cm2.cpu.assignments
