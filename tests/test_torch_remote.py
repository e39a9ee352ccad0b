"""The port's remote device worker (kubernetes_tpu_torch/ops/remote.py)
held against the JAX package's (kubernetes_tpu/ops/remote.py) on the CPU.

tests/test_remote_worker.py's four cases over both transports (HTTP/1.1
and gRPC): each runs the same nodes and pods through the port's
RemoteTorchBatchBackend on a port DeviceWorker / GrpcDeviceWorker
(device="cpu", claims_noise="murmur") and through the JAX package's
RemoteTPUBatchBackend on its own worker (KTPU_PALLAS=0), and the
(node, status) lists must be identical.  Then the wire itself: the port's
client against a JAX worker and a JAX client against the port's worker,
each giving the assignments of the matching single-package pair; the
harness's setup_cluster(remote_seam=...) against the JAX harness's; the
worker command in a process of its own.

Every worker is stopped in a fixture finalizer, and every test runs under
a deadline (SIGALRM), so a seam test cannot hang the suite.
"""

import json
import signal
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import pytest

pytest.importorskip("jax")
pytest.importorskip("grpc")

import kubernetes_tpu.scheduler.cache as jax_cache  # noqa: E402
import kubernetes_tpu.scheduler.types as jax_types  # noqa: E402
import kubernetes_tpu.testing as jax_testing  # noqa: E402
from kubernetes_tpu.ops import remote as jax_remote  # noqa: E402
from kubernetes_tpu.ops.flatten import Caps as JaxCaps  # noqa: E402
import kubernetes_tpu_torch.scheduler.cache as port_cache  # noqa: E402
import kubernetes_tpu_torch.scheduler.types as port_types  # noqa: E402
import kubernetes_tpu_torch.testing as port_testing  # noqa: E402
from kubernetes_tpu_torch.ops import remote as port_remote  # noqa: E402
from kubernetes_tpu_torch.ops.backend import TorchBatchBackend  # noqa: E402
from kubernetes_tpu_torch.ops.flatten import Caps  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CAPS = dict(n_cap=32, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
            sg_cap=8, asg_cap=8)
DEADLINE_S = 150


@pytest.fixture(autouse=True)
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"seam test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


class Pkg:
    """One package's seam: its Cache, PodInfo, testing helpers, worker
    classes and remote client, with the port's client and worker on the
    CPU at murmur noise."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.cache_mod = port_cache if port else jax_cache
        self.types = port_types if port else jax_types
        self.testing = port_testing if port else jax_testing
        self.remote = port_remote if port else jax_remote
        self.caps = Caps(**CAPS) if port else JaxCaps(**CAPS)

    def worker(self, kind):
        if self.name == "port":
            return port_remote.make_worker(kind, device="cpu",
                                           claims_noise="murmur").start()
        cls = (jax_remote.GrpcDeviceWorker if kind == "grpc"
               else jax_remote.DeviceWorker)
        return cls().start()

    def client(self, url, **kw):
        if self.name == "port":
            return port_remote.RemoteTorchBatchBackend(
                url, self.caps, claims_noise="murmur", **kw)
        return jax_remote.RemoteTPUBatchBackend(url, self.caps, **kw)

    def snapshot(self, nodes, pods=()):
        cache = self.cache_mod.Cache()
        for n in nodes:
            cache.add_node(n)
        for p in pods:
            cache.add_pod(p)
        return cache.update_snapshot(self.cache_mod.Snapshot())

    def infos(self, pods):
        return [self.types.PodInfo(p) for p in pods]


PKGS = {name: Pkg(name) for name in ("port", "jax")}


@pytest.fixture(params=["http", "grpc"])
def workers(request):
    """A port worker and a JAX worker over the same transport."""
    started = {}
    try:
        for name, pkg in PKGS.items():
            started[name] = pkg.worker(request.param)
        yield started
    finally:
        for w in started.values():
            w.stop()


def outcome(results):
    return [(name, None if st is None else st.code) for name, st in results]


def plain_case(pkg):
    t = pkg.testing
    nodes = [t.make_node(f"n{i}").capacity(cpu="4", mem="16Gi").build()
             for i in range(8)]
    pods = [t.make_pod(f"p{i}").req(cpu="500m", mem="512Mi").build()
            for i in range(16)]
    return nodes, pods


def spread_case(pkg):
    t = pkg.testing
    nodes = [t.make_node(f"z{i}").zone("abc"[i % 3])
             .capacity(cpu="8", mem="32Gi").build() for i in range(9)]
    pods = [t.make_pod(f"s{i}").labels(app="web").req(cpu="100m")
            .topology_spread("topology.kubernetes.io/zone", max_skew=2,
                             match_labels={"app": "web"}).build()
            for i in range(12)]
    return nodes, pods


def run_case(pkg, url, case, batches=1, **kw):
    nodes, pods = case(pkg)
    snap = pkg.snapshot(nodes)
    client = pkg.client(url, **kw)
    try:
        return [outcome(client.assign(pkg.infos(pods), snap))
                for _ in range(batches)]
    finally:
        client.close()


class TestRemoteBackendParity:
    def test_remote_assignments_match_local(self, workers):
        got = {name: run_case(pkg, workers[name].url, plain_case,
                              batch_size=16)
               for name, pkg in PKGS.items()}
        nodes, pods = plain_case(PKGS["port"])
        local = TorchBatchBackend(Caps(**CAPS), batch_size=16, device="cpu",
                                  claims_noise="murmur")
        want = outcome(local.assign(PKGS["port"].infos(pods),
                                    PKGS["port"].snapshot(nodes)))
        assert got["port"] == got["jax"] == [want]
        assert all(n for n, _c in want)

    def test_remote_constraint_batch_chunks(self, workers):
        got = {name: run_case(pkg, workers[name].url, spread_case,
                              batch_size=16, full_batch_cap=4)
               for name, pkg in PKGS.items()}
        assert got["port"] == got["jax"]
        placed = [n for n, _c in got["port"][0] if n]
        assert len(placed) == 12  # chunked through the full variant
        by_zone = Counter(int(n[1:]) % 3 for n in placed)
        assert max(by_zone.values()) - min(by_zone.values()) <= 2

    def test_remote_resident_state_chains(self, workers):
        """Two batches, no refresh between them: the worker's resident
        state carries the first batch's claim."""
        got = {}
        for name, pkg in PKGS.items():
            t = pkg.testing
            snap = pkg.snapshot([t.make_node("small").capacity(
                cpu="1", mem="2Gi").build()])
            client = pkg.client(workers[name].url, batch_size=4)
            try:
                got[name] = [outcome(client.assign(pkg.infos(
                    [t.make_pod(p).req(cpu="800m").build()]), snap))
                    for p in ("a", "b")]
            finally:
                client.close()
        assert got["port"] == got["jax"]
        assert got["port"][0][0][0] == "small"
        assert got["port"][1][0][0] is None  # the worker kept the claim


@pytest.mark.parametrize("kind", ["http", "grpc"])
def test_census_over_the_seam_equals_the_in_process_census(kind):
    """RemoteTorchBatchBackend.device_census posts /census, and the
    worker's census of its resident state (both variants) equals
    TorchBatchBackend.device_census in process after the same batches:
    every field, device_ms included (0.0 on the CPU on both sides)."""
    pkg = PKGS["port"]
    nodes, _pods = spread_case(pkg)
    snap = pkg.snapshot(nodes)
    t = pkg.testing
    batches = [[t.make_pod(f"p{i}").req(cpu="300m", mem="256Mi").build()
                for i in range(10)], spread_case(pkg)[1]]
    worker = pkg.worker(kind)
    try:
        client = pkg.client(worker.url, batch_size=16, full_batch_cap=8)
        local = TorchBatchBackend(Caps(**CAPS), batch_size=16, device="cpu",
                                  claims_noise="murmur", full_batch_cap=8)
        try:
            for pods in batches:
                got = [outcome(b.assign(pkg.infos(pods), snap))
                       for b in (client, local)]
                assert got[0] == got[1]
                assert all(n for n, _c in got[0])
            remote, want = client.device_census(), local.device_census()
        finally:
            client.close()
    finally:
        worker.stop()
    assert remote == want
    assert set(remote) == {"full", "plain"}
    # the claims kernel's plain version ran: counted, never launched
    assert remote["plain"]["kernels"]["claims"]["launches"] == 0
    assert worker.core.served["/census"] == 1


def wait_for(pred, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


class TestRemoteEndToEnd:
    def test_full_scheduler_over_remote_worker(self, workers):
        """Each package's Scheduler over its own worker binds every pod,
        within the nodes' capacity."""
        for name, pkg in PKGS.items():
            if name == "port":
                from kubernetes_tpu_torch.api import meta
                from kubernetes_tpu_torch.client import (
                    LocalClient, SharedInformerFactory)
                from kubernetes_tpu_torch.client.clientset import NODES, PODS
                from kubernetes_tpu_torch.scheduler import (
                    Profile, Scheduler, new_default_framework)
                from kubernetes_tpu_torch.store import kv
            else:
                from kubernetes_tpu.api import meta
                from kubernetes_tpu.client import (
                    LocalClient, SharedInformerFactory)
                from kubernetes_tpu.client.clientset import NODES, PODS
                from kubernetes_tpu.scheduler import (
                    Profile, Scheduler, new_default_framework)
                from kubernetes_tpu.store import kv
            client = LocalClient(kv.MemoryStore())
            factory = SharedInformerFactory(client)
            fw = new_default_framework(client, factory)
            backend = pkg.client(workers[name].url, batch_size=8)
            sched = Scheduler(client, factory, {"default-scheduler": Profile(
                fw, batch_backend=backend, batch_size=8)})
            factory.start()
            factory.wait_for_cache_sync()
            sched.run()
            try:
                for i in range(4):
                    client.create(NODES, pkg.testing.make_node(f"rw-{i}")
                                  .capacity(cpu="8", mem="32Gi").build())
                for i in range(20):
                    client.create(PODS, pkg.testing.make_pod(f"rp{i}")
                                  .req(cpu="250m").build())
                assert wait_for(lambda: all(
                    meta.pod_node_name(p)
                    for p in client.list(PODS, "default")[0])), name
                assert backend.stats["batches"] >= 1
            finally:
                sched.stop()
                factory.stop()
                backend.close()


# -- the wire between the packages -------------------------------------------

@pytest.mark.parametrize("kind", ["http", "grpc"])
@pytest.mark.parametrize("client_pkg,worker_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_cross_package_wire(kind, client_pkg, worker_pkg):
    """One package's client against the other package's worker: the same
    verbs, frames and payloads.  A plain batch twice (the resident state
    chains) and a chunked constraint batch give the assignments of the
    client package's own pair."""
    cp, wp = PKGS[client_pkg], PKGS[worker_pkg]
    cross = wp.worker(kind)
    same = cp.worker(kind)
    try:
        for case, kw, batches in ((plain_case, {"batch_size": 16}, 2),
                                  (spread_case, {"batch_size": 16,
                                                 "full_batch_cap": 4}, 1)):
            got = run_case(cp, cross.url, case, batches, **kw)
            want = run_case(cp, same.url, case, batches, **kw)
            assert got == want, case.__name__
            assert any(n for n, _c in got[0])
    finally:
        cross.stop()
        same.stop()


# -- the harness and the worker command ---------------------------------------

@pytest.mark.parametrize("kind", ["http", "grpc"])
def test_setup_cluster_remote_seam_binds_as_the_jax_harness(kind):
    """setup_cluster(remote_seam=kind) runs the port's Scheduler over an
    in-process port worker on the CPU; the bench's SchedulingBasic at 200
    nodes binds what the JAX harness over its own worker binds."""
    import kubernetes_tpu.perf as jax_perf

    import kubernetes_tpu_torch.perf as port_perf
    from test_torch_perf import tiny_basic
    runs = {}
    for name, perf_mod, kw in (("jax", jax_perf, {"tpu": True}),
                               ("port", port_perf, {"device": "cpu"})):
        summary, stats = perf_mod.run_named_workload(
            tiny_basic(perf_mod), caps=perf_mod.caps_for_nodes(200),
            batch_size=256, pipeline_depth=2, remote_seam=kind, **kw)
        runs[name] = (stats["barrier_ok"], summary.total_pods,
                      stats["created_pods"], stats["escape_rate"])
    assert runs["port"] == runs["jax"] == (True, 1000, 2000, 0.0)


def test_worker_command_serves_in_a_process_of_its_own(tmp_path):
    """python -m kubernetes_tpu_torch.cmd.tpu_worker --port 0 --device cpu
    prints its URL, serves a client and the debug pages, and stops on
    SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubernetes_tpu_torch.cmd.tpu_worker",
         "--port", "0", "--device", "cpu", "--claims-noise", "murmur"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("tpu-worker listening on http://"), line
        url = line.split()[-1]
        pkg = PKGS["port"]
        got = run_case(pkg, url, plain_case, 1, batch_size=16)
        assert all(n for n, _c in got[0])
        import urllib.request
        with urllib.request.urlopen(url + "/debug/kernels") as r:
            page = json.loads(r.read())
        assert page["served"]["/step"] >= 1 and "claims" in page["launches"]
        with urllib.request.urlopen(url + "/debug/timeline") as r:
            rows = json.loads(r.read())["interval_rows"]
        assert any(r["stage"] == "device-step" for r in rows)
    finally:
        proc.terminate()
        assert proc.wait(timeout=30) == 0
