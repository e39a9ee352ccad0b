"""Gang scheduling through the port's Scheduler on the batch backend, held
against the JAX package's Scheduler: tests/test_coscheduling.py's
TestGangAdversarial on both packages.

Each package gets its own store, informers, a default framework with the
Coscheduling plugin (Permit barrier, PreFilter membership gate), and a
batch profile: TPUBatchBackend at KTPU_PALLAS=0 on the JAX side,
TorchBatchBackend(device="cpu", claims_noise="murmur") on the port's.  The
same pods are created in the same order and the loop runs; every pod's
spec.nodeName and PodScheduled reason must then be identical in the two
stores.

  * A gang of 10 straddling batches of 4, interleaved with 20 competitors
    on 4 nodes: every pod binds, the gang all at once.  The pods are all
    queued before the loop starts, so every batch holds the same pods in
    both packages.
  * A starved Permit: a gang of 3 x 1 CPU on two nodes (1 and 1.5 CPU)
    that fit 2; the two members hold their CPUs at the barrier, a plain
    pod of 1.2 CPU that fits only the larger node once its member is
    released stays pending, a member is deleted, the barrier times out
    into Unreserve, and the plain pod binds; no gang member binds.
"""

import importlib
import time

import pytest

pytest.importorskip("jax")

from torch_cases import LOOP_CAPS, PORT_PKG, wait_for  # noqa: E402

JAX = "kubernetes_tpu"
GROUP_LABEL = "scheduling.x-k8s.io/pod-group"


class GangStack:
    """One package's control plane with the Coscheduling plugin enabled
    and a batch profile (tests/test_coscheduling.py's _batch_cluster)."""

    def __init__(self, pkg, batch_size):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")
        self.meta, self.testing = m("api.meta"), m("testing")
        clientset = m("client.clientset")
        self.NODES, self.PODS = clientset.NODES, clientset.PODS
        self.PODGROUPS = clientset.PODGROUPS
        client_mod, sched_mod = m("client"), m("scheduler")
        plugins = m("scheduler.plugins").DEFAULT_PLUGINS
        caps = m("ops.flatten").Caps(**LOOP_CAPS)
        backends = m("ops.backend")
        if pkg == JAX:
            backend = backends.TPUBatchBackend(caps, batch_size=batch_size)
        else:
            backend = backends.TorchBatchBackend(
                caps, batch_size=batch_size, device="cpu",
                claims_noise="murmur")
        self.store = m("store.kv").MemoryStore()
        self.client = client_mod.LocalClient(self.store)
        self.factory = client_mod.SharedInformerFactory(self.client)
        fw = sched_mod.new_default_framework(
            self.client, self.factory,
            enabled=plugins[:-1] + ["Coscheduling", "DefaultBinder"])
        self.sched = sched_mod.Scheduler(
            self.client, self.factory, {"default-scheduler": sched_mod.Profile(
                fw, batch_backend=backend, batch_size=batch_size)})
        self.running = False

    def node(self, name, cpu, mem):
        self.client.create(self.NODES, self.testing.make_node(name)
                           .capacity(cpu=cpu, mem=mem).build())

    def group(self, name, min_member, timeout):
        pg = self.meta.new_object("PodGroup", name, "default")
        pg["spec"] = {"minMember": min_member,
                      "scheduleTimeoutSeconds": timeout}
        self.client.create(self.PODGROUPS, pg)

    def pod(self, name, cpu="100m", group=None):
        w = self.testing.make_pod(name).req(cpu=cpu)
        if group:
            w = w.labels(**{GROUP_LABEL: group})
        self.client.create(self.PODS, w.build())

    def start(self, queued=None):
        """Start the informers (and wait for `queued` pods in the active
        queue), then the loop."""
        self.factory.start()
        self.factory.wait_for_cache_sync()
        if queued is not None:
            assert wait_for(
                lambda: self.sched.queue.stats()["active"] == queued)
        self.sched.run()
        self.running = True

    def stop(self):
        self.sched.stop()
        self.factory.stop()

    def node_of(self, name):
        return self.meta.pod_node_name(
            self.client.get(self.PODS, "default", name)) or None

    def bound(self, prefix=""):
        pods, _ = self.store.list(self.PODS)
        return sum(1 for p in pods if self.meta.name(p).startswith(prefix)
                   and self.meta.pod_node_name(p))

    def outcome(self):
        pods, _ = self.store.list(self.PODS)
        out = {}
        for p in pods:
            reason = next((c.get("reason") for c in
                           (p.get("status") or {}).get("conditions") or ()
                           if c.get("type") == "PodScheduled"), None)
            out[self.meta.name(p)] = (self.meta.pod_node_name(p) or None,
                                      reason)
        return out


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


def straddling(pkg):
    """batch_size 4, a gang of 10 interleaved with 20 competitors on 4
    nodes of 16 CPU."""
    s = GangStack(pkg, 4)
    try:
        for i in range(4):
            s.node(f"bn{i}", "16", "64Gi")
        s.group("bigg", 10, 60)
        order = ([("bigg", i) for i in range(10)]
                 + [("comp", i) for i in range(20)])
        for i in range(30):
            kind, j = order[(i * 7) % 30]
            s.pod(f"{kind}-{j}", group="bigg" if kind == "bigg" else None)
        s.start(queued=30)
        assert wait_for(lambda: s.bound("bigg-") == 10, timeout=60)
        assert wait_for(lambda: s.bound() == 30, timeout=60)
        return s.outcome()
    finally:
        s.stop()


def test_gang_straddling_batches_with_competitors(pallas_off):
    want = straddling(JAX)
    got = straddling(PORT_PKG)
    assert got == want
    assert sum(1 for n, _ in got.values() if n) == 30


def starved_permit(pkg):
    s = GangStack(pkg, 8)
    try:
        s.node("tiny0", "1", "4Gi")
        s.node("tiny1", "1500m", "4Gi")
        s.group("doomed", 3, 6)
        for i in range(3):
            s.pod(f"doomed-{i}", cpu="1", group="doomed")
        s.start(queued=3)
        # two members assume (hold both nodes' CPUs) and WAIT at Permit
        assert wait_for(lambda: len(list(
            s.sched.profiles["default-scheduler"].framework.handle
            .iterate_waiting_pods())) == 2, timeout=30)
        held = {wp.pod_info.pod["metadata"]["name"] for wp in
                s.sched.profiles["default-scheduler"].framework.handle
                .iterate_waiting_pods()}
        s.pod("victim", cpu="1200m")
        time.sleep(0.5)
        assert s.node_of("victim") is None   # starved behind the barrier
        # a member that never reached the barrier goes: minMember is out
        # of reach, so only the barrier's timeout can free the CPUs
        gone = sorted({"doomed-0", "doomed-1", "doomed-2"} - held)[0]
        s.client.delete(s.PODS, "default", gone)
        assert wait_for(lambda: s.node_of("victim"), timeout=30)
        assert s.bound("doomed-") == 0       # all-or-nothing
        # the released members settle as unschedulable (PreFilter: the
        # group is short of minMember)
        assert wait_for(lambda: all(
            r is not None for n, (_node, r) in s.outcome().items()
            if n.startswith("doomed-")), timeout=30)
        return s.outcome(), held
    finally:
        s.stop()


def test_starved_permit_times_out_and_unreserves(pallas_off):
    want, jax_held = starved_permit(JAX)
    got, held = starved_permit(PORT_PKG)
    assert held == jax_held
    assert got == want
    assert got["victim"][0] == "tiny1"
    assert all(node is None for name, (node, _r) in got.items()
               if name.startswith("doomed-"))
