"""The port's all-in-one cluster binary (kubernetes_tpu_torch/cmd/cluster.py)
held against the JAX package's on the CPU.

  (d) The binaries as processes: chip_smoke.py's phase 36 script
      (cluster_run) drives the port's binary through --cluster-child with
      --device cpu --tpu-batch at 20 nodes and 10 replicas, and the JAX
      binary (JAX_PLATFORMS=cpu, KTPU_PALLAS=0) through the same steps;
      both reach the same normalized state after the update and after the
      delete.  Without --device cpu the port's binary exits non-zero here.
      A restart on the same --data-dir keeps the Deployment and its
      ReplicaSet.  --devices-per-node 2 gives nodes that show their
      devices as the JAX binary's do.  --tpu-worker drives the port's
      cmd.tpu_worker --device cpu.
  (e) Phase 36 on the CPU: every check of cluster_run holds, the run's
      scheduler batches on the CPU with no escape, and its recorded first
      wave equals the plain version (the card's checks, the claims
      launches, are phase 36's own and not made here).
  ROADMAP R14(g), pinned in both packages: a stopped hollow kubelet keeps
  rewriting its pods' statuses while the informers deliver their events.

Every process runs under a deadline, on one CPU thread, and stops in a
finalizer.
"""

import importlib
import json
import pathlib
import signal
import sys
import time
import urllib.request

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from torch_cases import PORT_PKG as PORT, wait_for  # noqa: E402

from kubernetes_tpu_torch.client.http_client import HTTPClient  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = "kubernetes_tpu"
DEADLINE_S = 150


@pytest.fixture
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"cluster test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Every child process computes on one CPU thread: a child's torch
    ops on eight threads beside the other test workers' run up to 40
    times slower than on one (the oversubscribed pool spins)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture
def start():
    """Start a binary of either package as a ChildLog on port 0 (it
    prints the URL it bound); every one started is stopped at the end."""
    procs = []

    def spawn(pkg, *args, module="cmd.cluster"):
        flag = "--port" if module == "cmd.tpu_worker" else "--secure-port"
        child = chip_smoke.ChildLog(
            [sys.executable, "-u", "-m", f"{pkg}.{module}", flag, "0",
             *args], f"{pkg}.{module}", str(ROOT))
        procs.append(child)
        return child
    yield spawn
    for child in reversed(procs):
        child.stop()


def up(child, timeout=60):
    """Wait for the cluster's start; returns its apiserver's URL."""
    _t, hit = child.wait_line(r"cluster up: apiserver=(\S+)", "its start",
                              timeout=timeout)
    return hit[1]


def term(child):
    child.proc.send_signal(signal.SIGTERM)
    assert child.proc.wait(timeout=30) == 0, child.lines[-20:]


def web(replicas):
    return chip_smoke.web_deployment(replicas, "img:v1")


# -- (d) and (e): phase 36's script through both binaries -------------------

@pytest.fixture(scope="module")
def port_run():
    """cluster_run through the port's binary on the CPU, once a module."""
    return chip_smoke.cluster_run("cpu", nodes=20, replicas=10, batch=64,
                                  device="cpu")


def test_phase_36_runs_on_the_cpu(port_run):
    got = port_run
    sched = got["cluster"]
    assert sched["device"] == "cpu" and sched["batches"] > 0
    assert sched["escaped"] == 0 and not sched["by_reason"]
    assert sched["plain"] == sched["batches"]
    wave = got["wave"]
    assert wave["max_abs_err"] == 0.0 and wave["live"] > 0
    assert wave["shape"][1] == 1024   # Caps(n_cap=max(1024, 2 * nodes))
    assert got["peak"] >= 20          # R15: the whole count surged
    assert len(got["started"]) == 31 and not got["disabled"]
    assert got["updated"]["pods"] == {"web-df3440989b-* Running": 10}
    assert not got["deleted"]["pods"] and not got["deleted"]["replicasets"]


def test_jax_binary_reaches_the_same_state(port_run, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("KTPU_PALLAS", "0")
    got = chip_smoke.cluster_run(
        "cpu", nodes=20, replicas=10, batch=64,
        argv=[sys.executable, "-u", "-m", f"{JAX}.cmd.cluster"])
    assert got["cluster"] is None and got["wave"] is None
    assert got["updated"] == port_run["updated"]
    assert got["deleted"] == port_run["deleted"]
    assert got["started"] == port_run["started"]
    assert got["disabled"] == port_run["disabled"]


def test_without_device_cpu_the_binary_exits_non_zero(start, deadline):
    child = start(PORT, "--nodes", "1", "--tpu-batch")
    rc = child.proc.wait(timeout=60)
    child._reader.join(timeout=5)
    assert rc != 0
    assert any("no CUDA device is available" in line
               for _t, line in child.lines), child.lines[-10:]
    assert not any("cluster up" in line for _t, line in child.lines)


def test_a_restart_on_the_same_data_dir_keeps_the_deployment(
        start, deadline, tmp_path):
    args = ("--nodes", "3", "--tpu-batch", "--device", "cpu",
            "--batch-size", "64", "--data-dir", str(tmp_path / "data"))
    child = start(PORT, *args)
    admin = HTTPClient.from_url(up(child))
    admin.create("deployments", web(2))

    def ready():
        rs = admin.list("replicasets", "default")[0]
        return rs and (rs[0].get("status") or {}).get("readyReplicas") == 2
    assert wait_for(ready, timeout=60)
    before = {o["metadata"]["name"]: o["metadata"]["uid"]
              for res in ("deployments", "replicasets")
              for o in admin.list(res, "default")[0]}
    term(child)
    child = start(PORT, *args)
    admin = HTTPClient.from_url(up(child))
    after = {o["metadata"]["name"]: o["metadata"]["uid"]
             for res in ("deployments", "replicasets")
             for o in admin.list(res, "default")[0]}
    assert after == before and len(before) == 2
    assert wait_for(ready, timeout=60)
    term(child)


def node_devices(url):
    """Each node's capacity and allocatable, by name."""
    admin = HTTPClient.from_url(url)
    return {n["metadata"]["name"]: {k: n["status"][k] for k in
                                    ("capacity", "allocatable")}
            for n in admin.list("nodes")[0]}


def test_devices_per_node_match_the_jax_binary(start, deadline,
                                               monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    got = {}
    for pkg in (JAX, PORT):
        child = start(pkg, "--nodes", "2", "--devices-per-node", "2")
        url = up(child)
        assert wait_for(lambda: len(node_devices(url)) == 2, timeout=30)
        got[pkg] = node_devices(url)
        term(child)
    assert got[PORT] == got[JAX]
    assert all(n["allocatable"].get("google.com/tpu") in (2, "2")
               for n in got[PORT].values()), got[PORT]


def test_tpu_worker_drives_the_clusters_scheduler(start, deadline):
    worker = start(PORT, "--device", "cpu", module="cmd.tpu_worker")
    _t, hit = worker.wait_line(r"tpu-worker listening on (\S+)",
                               "the worker's start", timeout=60)
    child = start(PORT, "--nodes", "3", "--tpu-batch", "--tpu-worker",
                  hit[1], "--batch-size", "64")
    admin = HTTPClient.from_url(up(child))
    admin.create("deployments", web(3))

    def running():
        pods = admin.list("pods", "default")[0]
        return len(pods) == 3 and all(
            (p.get("status") or {}).get("phase") == "Running"
            and p["spec"].get("nodeName") for p in pods)
    assert wait_for(running, timeout=60)
    assert any("scheduler=tpu-batch" in line for _t, line in child.lines)
    with urllib.request.urlopen(f"{hit[1]}/debug/kernels") as r:
        served = json.loads(r.read())["served"]
    assert served.get("/step", 0) > 0, served   # the waves ran there
    term(child)
    worker.proc.send_signal(signal.SIGTERM)
    worker.proc.wait(timeout=30)


# -- R14(g): a stopped hollow kubelet keeps writing -------------------------

@pytest.mark.parametrize("pkg", (JAX, PORT))
def test_r14g_stopped_kubelets_write_until_the_informers_stop(pkg):
    """cmd/cluster.py stops its hollow kubelets but not the informers:
    each pod event still reaches the stopped kubelets' handlers, which
    rewrite the pod's status (R14(a)'s loop), until the informers stop
    or the process ends."""
    mod = importlib.import_module
    store = mod(f"{pkg}.store.kv").MemoryStore()
    client_mod = mod(f"{pkg}.client")
    client = client_mod.LocalClient(store)
    factory = client_mod.SharedInformerFactory(client)
    kubelets = mod(f"{pkg}.kubelet").start_hollow_nodes(
        client, factory, 2, heartbeat_interval=3600)
    factory.start()
    try:
        factory.wait_for_cache_sync()
        pod = mod(f"{pkg}.api.meta").new_object("Pod", "p", "default")
        pod["spec"] = {"nodeName": "hollow-0",
                       "containers": [{"name": "c0", "image": "img"}]}
        client.create("pods", pod)

        def rv():
            return int(client.get("pods", "default", "p")["metadata"][
                "resourceVersion"])
        assert wait_for(lambda: (client.get("pods", "default", "p")
                                 .get("status") or {}).get("phase")
                        == "Running", timeout=30)
        for k in kubelets:
            k.stop()
        before = rv()
        assert wait_for(lambda: rv() > before + 10, timeout=30)
        factory.stop()

        def quiet():
            now = rv()
            time.sleep(0.3)
            return rv() == now
        assert wait_for(quiet, timeout=30)
    finally:
        factory.stop()
