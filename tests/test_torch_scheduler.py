"""The port's scheduler loop held against the JAX package's on the CPU.

Both packages get the same nodes and pods (plain dicts from a numpy seed)
in their own MemoryStore, behind their own LocalClient, informers,
default framework and Scheduler; the JAX side's batch profile holds
TPUBatchBackend at KTPU_PALLAS=0, the port's TorchBatchBackend(device=
"cpu", claims_noise="murmur").  With the informers synced and the loop
thread NOT started, the same batch is popped with queue.pop_batch and
scheduled with schedule_batch on both; every pod's spec.nodeName and every
unschedulable pod's PodScheduled reason must then be identical in the two
stores.  The pipelined cases step schedule_step by hand (depth 2, a
FLUSH_FIRST re-dispatch, a wave deadline that resolves on the
wave-resolve thread).

Then the TestBasicScheduling scenarios of tests/test_scheduler_e2e.py run
with the loop started on the port's Scheduler, with a TorchBatchBackend
profile and with the per-pod profile; the batch verdicts are held against
the port's own per-pod NodeResourcesFit check (tests/test_tpu_batch.py's
TestOracleParity); and batched preemption through the Scheduler's batch
profile: a high-priority pod that fits only by evicting a lower-priority
one is nominated and its victim evicted as under the JAX package, on one
node and on a seeded multi-node cluster.
"""

import time

import numpy as np
import pytest

pytest.importorskip("jax")

from torch_cases import (  # noqa: E402
    LOOP_CAPS as CAPS, PORT_PKG as PORT, Stack, mixed_nodes, mixed_pods,
    pipelined_run, wait_for,
)

JAX = "kubernetes_tpu"
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


# -- seeded workloads (builders take a package's testing kit) --------------

def zoned_nodes(n):
    def make(testing):
        return [testing.make_node(f"z{i}").capacity(cpu="8", mem="16Gi")
                .labels(**{HOST: f"z{i}"}).zone("abc"[i % 3]).build()
                for i in range(n)]
    return make


def constraint_pods(seed, n):
    """Hard zone spread (maxSkew 1) and hostname anti-affinity, mixed."""
    def make(testing):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            w = testing.make_pod(f"c{i:03d}").req(
                cpu=f"{int(rng.integers(1, 5)) * 100}m", mem="256Mi")
            if rng.random() < 0.5:
                w = w.labels(app="spread").topology_spread(
                    ZONE, max_skew=1, match_labels={"app": "spread"})
            else:
                w = w.labels(app="anti").pod_affinity(
                    HOST, {"app": "anti"}, anti=True)
            out.append(w.build())
        return out
    return make


def with_gt_pod(make_pods):
    """make_pods plus one pod with a Gt node-affinity term: the encoder
    escapes it to the per-pod plugins."""
    def make(testing):
        pods = make_pods(testing)
        gt = testing.make_pod("gt").req(cpu="100m").build()
        gt["spec"]["affinity"] = {"nodeAffinity": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchExpressions": [
                    {"key": "rack", "operator": "Gt", "values": ["3"]}]}]}}}
        return pods[:len(pods) // 2] + [gt] + pods[len(pods) // 2:]
    return make


def racked_nodes(n):
    def make(testing):
        return [testing.make_node(f"r{i}").capacity(cpu="4", mem="8Gi")
                .labels(rack=str(i)).build() for i in range(n)]
    return make


def with_huge_pod(make_pods):
    def make(testing):
        return make_pods(testing) + [
            testing.make_pod("huge").req(cpu="100", mem="1Ti").build()]
    return make


CASES = {
    # 600 > TAIL_P (512): the main phase, then the compacted tail; the
    # cluster holds fewer pods than the batch, so some stay unschedulable
    "plain-mixed-tail": (lambda: mixed_nodes(3, 24),
                         lambda: mixed_pods(4, 600), 600),
    "constraints": (lambda: zoned_nodes(12),
                    lambda: constraint_pods(5, 40), 48),
    "gt-escape": (lambda: racked_nodes(8),
                  lambda: with_gt_pod(mixed_pods(6, 30)), 48),
    "fits-nowhere": (lambda: mixed_nodes(7, 6),
                     lambda: with_huge_pod(mixed_pods(8, 20)), 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_batch_matches_jax(pallas_off, case):
    make_nodes, make_pods, batch_size = CASES[case]
    outs = {}
    for pkg in (JAX, PORT):
        s = Stack(pkg, batch_size)
        try:
            n = s.load(make_nodes(), make_pods())
            s.schedule_all(n)
        finally:
            s.stop()
        outs[pkg] = s.outcome()
    jax_out, port_out = outs[JAX], outs[PORT]
    assert port_out == jax_out
    placed = [v for v in port_out.values() if v[0]]
    assert placed, "nothing was placed"
    if case in ("plain-mixed-tail", "fits-nowhere"):
        assert any(reason == "Unschedulable" and node is None
                   for node, reason in port_out.values())
    if case == "fits-nowhere":
        assert port_out["huge"] == (None, "Unschedulable")
    if case == "gt-escape":
        node = port_out["gt"][0]
        assert node is not None and int(node[1:]) > 3


def test_pipelined_flush_first_matches_jax(pallas_off):
    jax_out, jax_stats, _ = pipelined_run(JAX)
    port_out, stats, _ = pipelined_run(PORT)
    assert port_out == jax_out
    assert stats["flush_first"] >= 1
    assert stats["batches"] == 4
    assert stats["event_patches"] == jax_stats["event_patches"] >= 1


def test_depth2_with_wave_deadline_resolves_off_thread(pallas_off):
    """Depth 2 with the stuck-wave watchdog armed: every resolve() runs on
    a wave-resolve thread (the backend's lock and _Result wait work across
    threads) and the placements equal the run without the watchdog."""
    plain_out, _, plain_threads = pipelined_run(PORT)
    out, stats, threads = pipelined_run(PORT, deadline=60.0)
    assert out == plain_out
    assert threads == {"wave-resolve"}
    assert plain_threads and "wave-resolve" not in plain_threads
    assert stats.get("abandoned_waves", 0) == 0
    assert sum(1 for node, _ in out.values() if node) == 96


# -- tests/test_scheduler_e2e.py TestBasicScheduling, on a batch profile ----

@pytest.fixture(params=["batch", "per-pod"])
def cluster(request):
    """The port's control plane with the loop running: a batch profile
    (TorchBatchBackend, depth 2), or the default per-pod profile (the
    copied plugins alone, as tests/test_scheduler_e2e.py runs the JAX
    package)."""
    if request.param == "batch":
        s = Stack(PORT, 16, caps=dict(CAPS, n_cap=16), depth=2)
        s.backend.warmup()   # as setup_cluster does: no build in a cycle
        store, client, factory, sched = s.store, s.client, s.factory, s.sched
    else:
        from kubernetes_tpu_torch.client import (
            LocalClient, SharedInformerFactory,
        )
        from kubernetes_tpu_torch.scheduler import new_scheduler
        from kubernetes_tpu_torch.store import kv
        store = kv.MemoryStore()
        client = LocalClient(store)
        factory = SharedInformerFactory(client)
        sched = new_scheduler(client, factory)
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    yield store, client, sched
    sched.stop()
    factory.stop()


def pod_bound(client, name, ns="default"):
    from kubernetes_tpu_torch.api import meta
    from kubernetes_tpu_torch.client.clientset import PODS

    def check():
        return bool(meta.pod_node_name(client.get(PODS, ns, name)))
    return check


class TestBasicScheduling:
    """The JAX e2e scenarios with the same assertions, on the port's loop
    with a TorchBatchBackend(device="cpu") profile and with the per-pod
    profile."""

    @pytest.fixture(autouse=True)
    def _imports(self):
        from kubernetes_tpu_torch.api import meta
        from kubernetes_tpu_torch.client.clientset import NODES, PODS
        from kubernetes_tpu_torch.testing import make_node, make_pod
        self.meta, self.NODES, self.PODS = meta, NODES, PODS
        self.make_node, self.make_pod = make_node, make_pod

    def node_of(self, client, name):
        return self.meta.pod_node_name(client.get(self.PODS, "default", name))

    def test_single_pod_binds(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1").build())
        client.create(self.PODS, self.make_pod("p1").req(cpu="100m").build())
        assert wait_for(pod_bound(client, "p1"))
        assert self.node_of(client, "p1") == "n1"

    def test_spreads_by_least_allocated(self, cluster):
        store, client, sched = cluster
        for n in ("n1", "n2"):
            client.create(self.NODES, self.make_node(n)
                          .capacity(cpu="2", mem="4Gi").build())
        for i in range(4):
            client.create(self.PODS, self.make_pod(f"p{i}")
                          .req(cpu="500m", mem="512Mi").build())
        assert wait_for(lambda: all(pod_bound(client, f"p{i}")()
                                    for i in range(4)))
        assert {self.node_of(client, f"p{i}") for i in range(4)} == \
            {"n1", "n2"}

    def test_unschedulable_then_node_arrives(self, cluster):
        store, client, sched = cluster
        client.create(self.PODS, self.make_pod("p1").req(cpu="1").build())

        def unschedulable():
            p = client.get(self.PODS, "default", "p1")
            conds = (p.get("status") or {}).get("conditions") or []
            return any(c.get("reason") == "Unschedulable" for c in conds)
        assert wait_for(unschedulable)
        assert not self.node_of(client, "p1")
        client.create(self.NODES, self.make_node("n1").build())
        assert wait_for(pod_bound(client, "p1"))

    def test_resource_exhaustion(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1")
                      .capacity(cpu="1", mem="2Gi").build())
        client.create(self.PODS, self.make_pod("big1").req(cpu="800m").build())
        assert wait_for(pod_bound(client, "big1"))
        client.create(self.PODS, self.make_pod("big2").req(cpu="800m").build())
        time.sleep(0.3)
        assert not self.node_of(client, "big2")

    def test_released_resources_reusable(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1")
                      .capacity(cpu="1", mem="2Gi").build())
        client.create(self.PODS, self.make_pod("a").req(cpu="800m").build())
        assert wait_for(pod_bound(client, "a"))
        client.create(self.PODS, self.make_pod("b").req(cpu="800m").build())
        time.sleep(0.2)
        client.delete(self.PODS, "default", "a")
        assert wait_for(pod_bound(client, "b"))

    def test_node_selector_respected(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1").labels(disk="hdd")
                      .build())
        client.create(self.NODES, self.make_node("n2").labels(disk="ssd")
                      .build())
        client.create(self.PODS, self.make_pod("p").node_selector(disk="ssd")
                      .build())
        assert wait_for(pod_bound(client, "p"))
        assert self.node_of(client, "p") == "n2"

    def test_taints_respected(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1").taint("dedicated", "db")
                      .build())
        client.create(self.NODES, self.make_node("n2").build())
        client.create(self.PODS, self.make_pod("p").build())
        assert wait_for(pod_bound(client, "p"))
        assert self.node_of(client, "p") == "n2"

    def test_priority_order(self, cluster):
        store, client, sched = cluster
        client.create(self.PODS, self.make_pod("low").priority(1)
                      .req(cpu="800m").build())
        client.create(self.PODS, self.make_pod("high").priority(100)
                      .req(cpu="800m").build())
        time.sleep(0.3)
        client.create(self.NODES, self.make_node("n1")
                      .capacity(cpu="1", mem="2Gi").build())
        assert wait_for(pod_bound(client, "high"))
        time.sleep(0.2)
        assert not self.node_of(client, "low")

    def test_anti_affinity_spread(self, cluster):
        store, client, sched = cluster
        for n in ("n1", "n2", "n3"):
            client.create(self.NODES, self.make_node(n)
                          .labels(**{HOST: n}).build())
        for i in range(3):
            client.create(self.PODS, self.make_pod(f"p{i}").labels(app="web")
                          .pod_affinity(HOST, {"app": "web"}, anti=True)
                          .build())
        assert wait_for(lambda: all(pod_bound(client, f"p{i}")()
                                    for i in range(3)), timeout=15)
        assert len({self.node_of(client, f"p{i}") for i in range(3)}) == 3

    def test_topology_spread(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("a1").zone("a").build())
        client.create(self.NODES, self.make_node("b1").zone("b").build())
        for i in range(4):
            client.create(self.PODS, self.make_pod(f"p{i}").labels(app="web")
                          .topology_spread(ZONE, max_skew=1,
                                           match_labels={"app": "web"})
                          .build())
        assert wait_for(lambda: all(pod_bound(client, f"p{i}")()
                                    for i in range(4)), timeout=15)
        zones = {}
        for i in range(4):
            zone = "a" if self.node_of(client, f"p{i}").startswith("a") \
                else "b"
            zones[zone] = zones.get(zone, 0) + 1
        assert zones == {"a": 2, "b": 2}

    def test_metrics_recorded(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1").build())
        client.create(self.PODS, self.make_pod("p1").build())
        assert wait_for(pod_bound(client, "p1"))
        assert wait_for(
            lambda: sched.metrics.schedule_attempts.get("scheduled", 0) >= 1)
        backend = sched.profiles["default-scheduler"].batch_backend
        assert backend is None or backend.stats["batches"] >= 1

    def test_cache_confirms_assumed_pod(self, cluster):
        store, client, sched = cluster
        client.create(self.NODES, self.make_node("n1").build())
        client.create(self.PODS, self.make_pod("p1").build())
        assert wait_for(pod_bound(client, "p1"))
        assert wait_for(lambda: sched.cache.assumed_pod_count() == 0)
        assert sched.cache.pod_count() == 1


def test_batch_verdicts_agree_with_the_per_pod_plugins():
    """Every batch placement passes the port's per-pod NodeResourcesFit
    check, replayed in any order (resource fit is additive), and every
    refusal fails it on every node of the final state: the wave solver
    refuses a pod only when nothing fits given everything placed."""
    from kubernetes_tpu_torch.ops.backend import TorchBatchBackend
    from kubernetes_tpu_torch.ops.flatten import Caps
    from kubernetes_tpu_torch.scheduler.cache import Cache, Snapshot
    from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
        insufficient_resources,
    )
    from kubernetes_tpu_torch.scheduler.types import UNSCHEDULABLE, PodInfo
    from kubernetes_tpu_torch.testing import make_node, make_pod
    rng = np.random.default_rng(42)
    refused = 0
    for trial in range(5):
        nodes = [make_node(f"n{i}").capacity(
            cpu=str(int(rng.integers(1, 5))),
            mem=f"{int(rng.integers(2, 9))}Gi").build() for i in range(6)]
        cache = Cache()
        for n in nodes:
            cache.add_node(n)
        backend = TorchBatchBackend(Caps(**dict(CAPS, n_cap=16)),
                                    batch_size=16, device="cpu")
        infos = [PodInfo(make_pod(f"t{trial}p{i}").req(
            cpu=f"{int(rng.integers(100, 2001))}m",
            mem=f"{int(rng.integers(128, 4097))}Mi").build())
            for i in range(16)]
        results = backend.assign(infos, cache.flatten_view())
        final = Cache()
        for n in nodes:
            final.add_node(n)
        snap = final.update_snapshot(Snapshot())
        for pi, (name, _st) in zip(infos, results):
            if name is not None:
                assert insufficient_resources(pi, snap.get(name)) == [], \
                    f"the plugin rejects {pi.key} on {name}"
                final.add_pod({**pi.pod, "spec": {**pi.pod["spec"],
                                                  "nodeName": name}})
                snap = final.update_snapshot(snap)
        for pi, (name, st) in zip(infos, results):
            if name is None:
                refused += 1
                assert st is not None and st.code == UNSCHEDULABLE
                for ni in snap.list():
                    assert insufficient_resources(pi, ni), \
                        f"the plugin would place {pi.key} on {ni.name}"
    assert refused > 0


# -- preemption through the batch profile (Scheduler._batch_preempt) ------

def preemption_run(pkg, make_nodes=None, make_low=None, make_high=None):
    """Low-priority pods scheduled first, then high-priority pods that fit
    only if some of them are evicted, popped as one batch: the batch fails
    and _batch_preempt nominates and evicts.  Defaults: one node full of
    two low-priority pods and one high-priority pod."""
    s = Stack(pkg, 8)

    def nodes(testing):
        return [testing.make_node("n1").capacity(cpu="2", mem="4Gi").build()]

    def low(testing):
        return [testing.make_pod(f"low{i}").priority(1).req(cpu="900m")
                .build() for i in range(2)]

    def high(testing):
        return [testing.make_pod("high").priority(1000).req(cpu="900m")
                .build()]
    try:
        n = s.load(make_nodes or nodes, make_low or low)
        s.schedule_all(n)
        highs = (make_high or high)(s.testing)
        for pod in highs:
            s.client.create(s.PODS, pod)
        assert wait_for(
            lambda: s.sched.queue.stats()["active"] == len(highs))
        s.schedule_all(len(highs))
    finally:
        s.stop()
    pods = {s.meta.name(p): p for p in s.store.list(s.PODS)[0]}
    return pods, s.sched.metrics.preemption_attempts


def nominations(pods):
    return {name: (p.get("status") or {}).get("nominatedNodeName")
            for name, p in pods.items()}


def test_no_batched_preemption_on_the_port(pallas_off):
    """The pin of the port's missing preemption, turned around: the port's
    batch profile now preempts as the JAX package's does: `high` is
    nominated to n1, the same one low-priority pod is evicted, and a
    preemption attempt is counted."""
    jpods, jattempts = preemption_run(JAX)
    ppods, pattempts = preemption_run(PORT)
    assert nominations(jpods)["high"] == "n1"
    assert nominations(ppods) == nominations(jpods)
    assert sorted(ppods) == sorted(jpods)
    assert len([n for n in ppods if n.startswith("low")]) == 1
    assert pattempts == jattempts >= 1
    assert not (ppods["high"].get("spec") or {}).get("nodeName")


def test_batched_preemption_matches_jax_on_a_seeded_cluster(pallas_off):
    """Six nodes of 2-4 CPUs filled with low-priority pods of mixed
    priorities and requests, then eight preemptors at two priorities:
    both Schedulers nominate the same node for every pod and delete the
    same pods."""
    def nodes(testing):
        rng = np.random.default_rng(31)
        return [testing.make_node(f"n{i}")
                .capacity(cpu=str(int(rng.integers(2, 5))), mem="16Gi")
                .build() for i in range(6)]

    def low(testing):
        rng = np.random.default_rng(32)
        return [testing.make_pod(f"low{i:02d}")
                .priority(int(rng.integers(0, 4)))
                .req(cpu=f"{int(rng.integers(2, 9)) * 100}m", mem="256Mi")
                .build() for i in range(24)]

    def high(testing):
        rng = np.random.default_rng(33)
        return [testing.make_pod(f"high{i}")
                .priority(int(rng.choice([10, 20])))
                .req(cpu=f"{int(rng.integers(8, 21)) * 100}m", mem="256Mi")
                .build() for i in range(8)]

    outs = {pkg: preemption_run(pkg, nodes, low, high) for pkg in (JAX, PORT)}
    (jpods, jattempts), (ppods, pattempts) = outs[JAX], outs[PORT]
    assert nominations(ppods) == nominations(jpods)
    assert sorted(ppods) == sorted(jpods)        # the same pods deleted
    assert pattempts == jattempts >= 1
    assert sum(1 for v in nominations(ppods).values() if v) >= 2
    assert len(ppods) < 32                       # something was evicted
