"""Loop parity behind the front door: each package's Scheduler behind its
own HTTPClient -> APIServer (the scheduler_perf harness's flags: RBAC,
the default admission chain, a bearer token), as tests/
test_torch_scheduler.py holds them behind LocalClient.  The same seeded
nodes and pods are created over HTTP, the informers sync over the HTTP
watch, and with the loop thread NOT started the same batch is popped with
queue.pop_batch and scheduled with schedule_batch on both: the JAX side's
TPUBatchBackend at KTPU_PALLAS=0, the port's TorchBatchBackend(device=
"cpu", claims_noise="murmur").  Every pod's spec.nodeName (bound through
POST .../binding) and PodScheduled reason must then be identical in the
two servers' stores.

Then the port's harness runs a tiny SchedulingBasicLarge with
via_http=True (the apiserver in process over a WAL) and
via_http="process" (python -m kubernetes_tpu_torch.cmd.apiserver in a
child process, gone once run_named_workload returns; killed in a finally
if not): every pod bound within its node's CPU, memory and pod count,
nothing escaped to the per-pod path.  Each test has a SIGALRM deadline of
its own.
"""

import importlib
import signal

import pytest

pytest.importorskip("jax")

from torch_cases import (  # noqa: E402
    LOOP_CAPS, PORT_PKG as PORT, Stack, mixed_nodes, mixed_pods, wait_for,
)
from torch_front_door import ADMIN, harness_kwargs, package  # noqa: E402

JAX = "kubernetes_tpu"
ZONE = "topology.kubernetes.io/zone"
DEADLINE_S = 120


@pytest.fixture(autouse=True)
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"front-door test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


class HTTPStack(Stack):
    """Stack with the front door between the scheduler and its store: the
    package's APIServer over a MemoryStore, and the Scheduler, its
    informers and the object loader all speaking HTTP to it."""

    def __init__(self, pkg, batch_size, caps=LOOP_CAPS, device="cpu"):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")
        p = package(pkg)
        self.pkg = pkg
        self.kv, self.meta, self.testing = p.kv, p.meta, p.testing
        self.NODES, self.PODS = p.clientset.NODES, p.clientset.PODS
        caps = m("ops.flatten").Caps(**caps)
        backends = m("ops.backend")
        if pkg == JAX:
            self.backend = backends.TPUBatchBackend(caps,
                                                    batch_size=batch_size)
        else:
            self.backend = backends.TorchBatchBackend(
                caps, batch_size=batch_size, device=device,
                claims_noise="murmur")
        self.store = p.kv.MemoryStore()
        self.server = p.apiserver.APIServer(self.store,
                                            **harness_kwargs(p)).start()
        self.client = p.http_client.HTTPClient.from_url(self.server.url,
                                                        token=ADMIN)
        self.factory = p.client.SharedInformerFactory(self.client)
        fw = p.scheduler.new_default_framework(self.client, self.factory)
        self.profile = p.scheduler.Profile(fw, batch_backend=self.backend,
                                           batch_size=batch_size)
        self.sched = p.scheduler.Scheduler(
            self.client, self.factory, {"default-scheduler": self.profile})

    def stop(self):
        try:
            super().stop()
            self.client.close()
        finally:
            self.server.stop()

    def settle(self, n_pods):
        """Wait until every pod the batch placed is bound in the store and
        every unplaced one carries its PodScheduled condition."""
        def done():
            out = self.outcome()
            return len(out) == n_pods and all(node or reason
                                              for node, reason in
                                              out.values())
        assert wait_for(done)


def zoned_nodes(n):
    def make(testing):
        return [testing.make_node(f"z{i}").capacity(cpu="8", mem="16Gi")
                .labels(**{"kubernetes.io/hostname": f"z{i}"})
                .zone("abc"[i % 3]).build() for i in range(n)]
    return make


def spread_pods(seed, n):
    def make(testing):
        import numpy as np
        rng = np.random.default_rng(seed)
        return [testing.make_pod(f"s{i:03d}").req(
            cpu=f"{int(rng.integers(1, 5)) * 100}m", mem="256Mi")
            .labels(app="spread").topology_spread(
                ZONE, max_skew=1, match_labels={"app": "spread"}).build()
            for i in range(n)]
    return make


def with_huge_pod(make_pods):
    def make(testing):
        return make_pods(testing) + [
            testing.make_pod("huge").req(cpu="100", mem="1Ti").build()]
    return make


CASES = {
    # more pods than the cluster holds: some end Unschedulable
    "plain-mixed": (lambda: mixed_nodes(3, 24),
                    lambda: mixed_pods(4, 600), 600),
    "constraints": (lambda: zoned_nodes(12), lambda: spread_pods(5, 30), 32),
    "fits-nowhere": (lambda: mixed_nodes(7, 6),
                     lambda: with_huge_pod(mixed_pods(8, 20)), 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_schedule_batch_over_http_matches_jax(pallas_off, case):
    make_nodes, make_pods, batch_size = CASES[case]
    outs = {}
    for pkg in (JAX, PORT):
        s = HTTPStack(pkg, batch_size)
        try:
            n = s.load(make_nodes(), make_pods())
            s.schedule_all(n)
            s.settle(n)
            outs[pkg] = s.outcome()
        finally:
            s.stop()
    assert outs[PORT] == outs[JAX]
    placed = [node for node, _ in outs[PORT].values() if node]
    assert placed, "nothing was placed"
    if case == "plain-mixed":
        assert any(reason == "Unschedulable" and node is None
                   for node, reason in outs[PORT].values())
    if case == "fits-nowhere":
        assert outs[PORT]["huge"] == (None, "Unschedulable")


# -- the harness through the front door -------------------------------------

N_NODES, N_PODS, BATCH = 40, 400, 128


@pytest.mark.parametrize("via_http", [True, "process"],
                         ids=["in-process", "process"])
def test_run_named_workload_via_http_binds_every_pod(via_http):
    from kubernetes_tpu_torch import perf as port_perf
    from kubernetes_tpu_torch.perf import bench
    cfg = bench._basic_large(N_NODES, N_PODS)
    seen = {}

    def after(cluster):
        seen["front"] = cluster.front
        seen["placements"] = bench.check_placements(cluster.store,
                                                    N_PODS + 1000)
    try:
        summary, stats = port_perf.run_named_workload(
            cfg, caps=port_perf.caps_for_nodes(N_NODES), batch_size=BATCH,
            pipeline_depth=2, device="cpu", via_http=via_http, after=after)
    finally:
        proc = getattr(seen.get("front"), "proc", None)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    front = seen["front"]
    if via_http == "process":
        assert front.proc is not None and front.server is None
        assert front.proc.poll() is not None       # stopped at shutdown
    else:
        assert front.proc is None and front.server is not None
    assert stats["barrier_ok"], stats
    pl = seen["placements"]
    assert pl["pods"] == pl["bound"] == N_PODS + 1000, pl
    assert pl["nodes_over_capacity"] == 0, pl
    assert pl["max_pods_per_node"] <= 110
    assert stats["escape_rate"] == 0.0
    assert summary.total_pods == N_PODS
