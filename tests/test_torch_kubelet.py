"""The node agent in the port (kubernetes_tpu_torch/kubelet/ and
cmd/kubelet.py) held against the JAX package's on the CPU.

  (a) Every module is a copy: its code, docstrings aside, is the JAX
      package's module of the same name.
  (b) Seeded parity scripts, each run through both packages with the
      same result required: the fake CRI's verbs (ids numbered in order
      of appearance, states, logs, exec output and exit codes, tar in
      and out, port-forward, checkpoints, images); pod_qos and
      eviction_rank over seeded pods, and the eviction manager's victims;
      the status manager's deduplicated writes; checkpoint files byte for
      byte, with each package reading the other's and both refusing a
      tampered one.
  (c) Hollow nodes under each package's Scheduler (the port's
      TorchBatchBackend on the CPU at murmur, the JAX TPUBatchBackend at
      KTPU_PALLAS=0): the same spec.nodeName and the same status per pod,
      hostIP and podIP included, which agree because both packages run
      in one process (R14(b)).
  (d) The port's kubelet binary, --hollow-nodes 3, against the port's
      apiserver process: its nodes and Leases register and a pod runs;
      a second binary claims the same nodes (R14(c)); SIGTERM ends both
      with 0.  chip_smoke.py's phase 35 at 20 nodes and 40 pods with the
      scheduler binary on the CPU.
  (e) ROADMAP R14, pinned in both packages: (a) a hollow kubelet
      rewrites a running pod's status on every event of the pod, its own
      writes' events included, so the status is rewritten without pause;
      the PLEG loop rewrites it once more each second, finding it by a
      scan of the informer; and every kubelet's handler sees every pod
      event;
      (b) hostIP and podIP depend on the process's hash seed; (c) two
      sets of hollow kubelets claim the same nodes; (d) a restarted full
      kubelet reports its restored pods Running, Ready=False, with no
      containerStatuses, and leaves a terminal pod as it was; (e) a
      container that exits turns its pod terminal before any sync can
      restart it, so restartPolicy Always restarts it only through a
      liveness probe, with the crash backoff, while the pod reads Failed;
      (f) the binary holds two threads a hollow node and, on SIGTERM,
      stops its nodes one by one on the main thread (each package's
      binary at 1,000 nodes, its time from SIGTERM to exit printed).
  (f) tests/test_kubelet_depth.py's 27 scenarios on the port's classes.

Every wait has its own bound; heartbeats are an hour apart unless a test
reads them, and every process test stops its children in a finalizer.
"""

import importlib
import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import tarfile
import threading
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from torch_cases import PORT_PKG as PORT, Stack, code_of  # noqa: E402
from torch_cases import wait_for as bounded_wait  # noqa: E402

from kubernetes_tpu_torch.api import meta  # noqa: E402
from kubernetes_tpu_torch.client import (  # noqa: E402
    LocalClient, SharedInformerFactory,
)
from kubernetes_tpu_torch.client.clientset import NODES, PODS  # noqa: E402
from kubernetes_tpu_torch.kubelet.checkpoint import (  # noqa: E402
    CheckpointManager, CorruptCheckpointError,
)
from kubernetes_tpu_torch.kubelet.cri import (  # noqa: E402
    EXITED, RUNNING, FakeRuntimeService,
)
from kubernetes_tpu_torch.kubelet.eviction import EvictionManager  # noqa: E402
from kubernetes_tpu_torch.kubelet.images import ImageGCManager  # noqa: E402
from kubernetes_tpu_torch.kubelet.kubelet import Kubelet  # noqa: E402
from kubernetes_tpu_torch.kubelet.pod_workers import PodWorkers  # noqa: E402
from kubernetes_tpu_torch.kubelet.probes import (  # noqa: E402
    LIVENESS, READINESS, ProbeManager,
)
from kubernetes_tpu_torch.kubelet.qos import (  # noqa: E402
    BEST_EFFORT, BURSTABLE, GUARANTEED, pod_qos,
)
from kubernetes_tpu_torch.kubelet.status_manager import (  # noqa: E402
    StatusManager,
)
from kubernetes_tpu_torch.store import kv  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = "kubernetes_tpu"
PKGS = (JAX, PORT)
DEADLINE_S = 120


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"kubelet test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# -- (a) every module a copy ------------------------------------------------

MODULES = [*(f"kubelet/{p.stem}" for p in
             sorted((ROOT / JAX / "kubelet").glob("*.py"))), "cmd/kubelet"]


@pytest.mark.parametrize("name", MODULES)
def test_module_is_a_copy(name):
    assert len(MODULES) == 15
    assert code_of(ROOT / PORT / f"{name}.py") == \
        code_of(ROOT / JAX / f"{name}.py")


# -- (b) seeded parity scripts ----------------------------------------------

class ScriptIO:
    """The CRI's IO adapter for exec, attach and port-forward: stdin (or
    port-forward data) from a list, output kept by channel."""

    def __init__(self, stdin=()):
        self.stdin = list(stdin)
        self.out = []

    def read_stdin(self):
        return self.stdin.pop(0) if self.stdin else None

    read_data = read_stdin

    def write_stdout(self, data):
        self.out.append(("stdout", data))

    def write_stderr(self, data):
        self.out.append(("stderr", data))

    def write_data(self, data):
        self.out.append(("data", data))

    def error(self, msg):
        self.out.append(("error", msg))


def tar_of(files):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for path, data in sorted(files.items()):
            ti = tarfile.TarInfo(path)
            ti.size = len(data)
            tf.addfile(ti, io.BytesIO(data))
    return buf.getvalue()


TIMES = ("createdAt", "startedAt", "exitAt", "nextLogAt", "at")


class Ids:
    """Runtime ids (uuid4 hex) numbered in order of appearance."""

    def __init__(self):
        self.seen = {}

    def __call__(self, x):
        if isinstance(x, str):
            if x in self.seen:
                return self.seen[x]
            if len(x) == 12 and all(c in "0123456789abcdef" for c in x):
                self.seen[x] = f"id{len(self.seen)}"
                return self.seen[x]
            if x.startswith("checkpoint-"):
                return x.rsplit("-", 1)[0]   # its time stamp
            return x
        if isinstance(x, dict):
            return {self(k): self(v) for k, v in x.items()
                    if k not in TIMES}
        if isinstance(x, (list, tuple)):
            return [self(v) for v in x]
        return x


def cri_script(pkg, seed, steps=160):
    """One seeded sequence of CRI calls; returns every answer, ids
    numbered in order and time stamps dropped."""
    cri = m(pkg, "kubelet.cri")
    rt = cri.FakeRuntimeService()
    rng = np.random.default_rng(seed)
    ids = Ids()
    log, sandboxes, containers = [], [], []
    tar_in = tar_of({"d/a.txt": b"alpha\n", "d/sub/b.txt": b"beta\n"})
    commands = [
        (["echo", "hello", "tpu"], ()), (["cat"], (b"x\n", b"y\n")),
        (["env"], ()), (["hostname"], ()), (["true"], ()), (["false"], ()),
        (["exit", "3"], ()), (["sh", "-c", "exit 7"], ()),
        (["sh", "-c", "echo from sh"], ()), (["no-such"], ()),
        (["tar", "xf", "-", "-C", "/srv"], (tar_in,)),
        (["tar", "cf", "-", "/srv/d"], ()), (["tar", "cf", "-", "/none"], ()),
        (["ls", "/srv"], ()), (["ls", "/none"], ()),
        (["cat", "/srv/d/a.txt", "/srv/nope"], ()), (["sleep", "0"], ()),
        (["tar"], ()), ([], ())]
    for _ in range(steps):
        op = int(rng.integers(12))
        if op == 0 or not sandboxes:
            sid = rt.run_pod_sandbox({"name": f"pod-{len(sandboxes)}",
                                      "uid": f"u{len(sandboxes)}"})
            sandboxes.append(sid)
            log.append(("sandbox", ids(sid)))
        elif op in (1, 2):
            sid = sandboxes[int(rng.integers(len(sandboxes)))]
            ann = {}
            if rng.random() < 0.3:
                ann = {"hollow/run-seconds": "0",
                       "hollow/exit-code": str(int(rng.integers(3)))}
            cfg = {"name": f"c{len(containers)}", "image":
                   f"img:{int(rng.integers(4))}", "annotations": ann,
                   "env": [{"name": "MODE", "value": str(int(
                       rng.integers(9)))}],
                   "ports": [{"containerPort": 8000 + int(
                       rng.integers(3))}]}
            rt.pull_image(cfg["image"])
            cid = rt.create_container(sid, cfg)
            containers.append(cid)
            log.append(("create", ids(cid)))
            if op == 1:
                rt.start_container(cid)
        elif op == 3 and containers:
            cid = containers[int(rng.integers(len(containers)))]
            try:
                rt.start_container(cid)
                log.append(("start", ids(cid)))
            except KeyError:
                log.append(("start", ids(cid), "KeyError"))
        elif op == 4 and containers:
            rt.stop_container(containers[int(rng.integers(len(containers)))])
        elif op == 5 and containers and rng.random() < 0.3:
            rt.remove_container(containers[int(rng.integers(
                len(containers)))])
        elif op == 6 and rng.random() < 0.2:
            sid = sandboxes[int(rng.integers(len(sandboxes)))]
            rt.stop_pod_sandbox(sid)
            if rng.random() < 0.5:
                rt.remove_pod_sandbox(sid)
            log.append(("sandbox status", ids(rt.pod_sandbox_status(sid))))
        elif op == 7 and containers:
            cid = containers[int(rng.integers(len(containers)))]
            argv, stdin = commands[int(rng.integers(len(commands)))]
            sio = ScriptIO(stdin)
            code = rt.exec_stream(cid, list(argv), sio)
            log.append(("exec", ids(cid), argv, code, sio.out))
        elif op == 8 and containers:
            cid = containers[int(rng.integers(len(containers)))]
            tail = [None, 1, 5][int(rng.integers(3))]
            try:
                log.append(("logs", ids(cid), tail,
                            list(rt.read_logs(cid, tail=tail))))
            except KeyError:
                log.append(("logs", ids(cid), "KeyError"))
        elif op == 9:
            sid = sandboxes[int(rng.integers(len(sandboxes)))]
            port = 8000 + int(rng.integers(4))
            sio = ScriptIO([b"ping", b"pong"])
            rt.portforward_stream(sid, port, sio)
            log.append(("portforward", ids(sid), port, sio.out))
        elif op == 10 and containers:
            cid = containers[int(rng.integers(len(containers)))]
            try:
                log.append(("checkpoint", ids(rt.checkpoint_container(cid))))
            except KeyError:
                log.append(("checkpoint", ids(cid), "KeyError"))
        else:
            sid = (None if rng.random() < 0.3 else
                   sandboxes[int(rng.integers(len(sandboxes)))])
            log.append(("list", ids(sid), ids(rt.list_containers(sid))))
    log.append(("images", rt.list_images()))
    log.append(("all", ids(rt.list_containers())))
    return log


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cri_verbs_match(seed):
    jax_log, port_log = (cri_script(pkg, seed) for pkg in PKGS)
    assert len(jax_log) > 100
    assert any(e[0] == "exec" and e[3] == 0 for e in jax_log)
    assert port_log == jax_log


def resource_pod(rng, i):
    pod = {"metadata": {"name": f"p{i}", "namespace": "default",
                        "uid": f"uid-{i}"},
           "spec": {"containers": [], "priority": int(rng.integers(3))}}
    for c in range(int(rng.integers(0, 3))):
        res = {}
        for side in ("requests", "limits"):
            if rng.random() < 0.6:
                res[side] = {}
                for k in ("cpu", "memory", "google.com/tpu"):
                    if rng.random() < 0.6:
                        res[side][k] = {"cpu": ["1", "500m", "2"],
                                        "memory": ["1Gi", "64Mi", "2Gi"],
                                        "google.com/tpu": ["1", "2"]}[k][
                            int(rng.integers(2 if k == "google.com/tpu"
                                             else 3))]
        pod["spec"]["containers"].append({"name": f"c{c}", "image": "img",
                                          "resources": res})
    return pod


def test_qos_and_eviction_rank_match():
    rng = np.random.default_rng(5)
    pods = [resource_pod(rng, i) for i in range(400)]
    jq, pq = m(JAX, "kubelet.qos"), m(PORT, "kubelet.qos")
    got = [(pq.pod_qos(p), pq.eviction_rank(p)) for p in pods]
    assert got == [(jq.pod_qos(p), jq.eviction_rank(p)) for p in pods]
    assert {q for q, _ in got} == {BEST_EFFORT, BURSTABLE, GUARANTEED}
    order = [p["metadata"]["name"] for p in sorted(pods,
                                                   key=pq.eviction_rank)]
    assert order == [p["metadata"]["name"] for p in
                     sorted(pods, key=jq.eviction_rank)]


def eviction_run(pkg, pods, capacity):
    """Each package's EvictionManager over its own store: the victims in
    order, the node's condition and the pods' phases and reasons."""
    store = m(pkg, "store.kv").MemoryStore()
    client = m(pkg, "client").LocalClient(store)
    node = m(pkg, "api.meta").new_object("Node", "n1", "")
    node["status"] = {"conditions": []}
    client.create("nodes", node)
    for p in pods:
        client.create("pods", dict(p, spec=dict(p["spec"], nodeName="n1")))
    em = m(pkg, "kubelet.eviction").EvictionManager(
        client, "n1", memory_capacity=capacity,
        memory_available_threshold=0.2,
        list_pods=lambda: client.list("pods")[0])
    evicted = [em.synchronize(), em.synchronize()]
    conds = [(c["type"], c["status"]) for c in
             client.get("nodes", "", "n1")["status"]["conditions"]]
    phases = sorted((p["metadata"]["name"], (p.get("status") or {})
                     .get("phase"), (p.get("status") or {}).get("reason"))
                    for p in client.list("pods")[0])
    return evicted, conds, phases, em.under_pressure


@pytest.mark.parametrize("capacity", [8 << 30, 24 << 30, 200 << 30])
def test_eviction_matches(capacity):
    rng = np.random.default_rng(capacity % 97)
    pods = [resource_pod(rng, i) for i in range(40)]
    jax_run = eviction_run(JAX, pods, capacity)
    assert eviction_run(PORT, pods, capacity) == jax_run


def status_run(pkg, seed):
    """One seeded sequence of set_pod_status / remove_pod over three
    pods (one never created): api_writes after each call and the stored
    statuses at the end."""
    store = m(pkg, "store.kv").MemoryStore()
    client = m(pkg, "client").LocalClient(store)
    new = m(pkg, "api.meta").new_object
    pods = []
    for i in range(3):
        pod = new("Pod", f"s{i}", "default")
        pod["metadata"]["uid"] = f"uid-s{i}"
        pod["spec"] = {"containers": [{"name": "c0", "image": "img"}]}
        if i < 2:
            client.create("pods", pod)
        pods.append(pod)
    sm = m(pkg, "kubelet.status_manager").StatusManager(client)
    choices = [{"phase": "Pending"}, {"phase": "Running"},
               {"phase": "Running", "podIP": "10.0.0.1"},
               {"phase": "Succeeded"}]
    rng = np.random.default_rng(seed)
    trace = []
    for _ in range(120):
        i = int(rng.integers(3))
        if rng.random() < 0.1:
            sm.remove_pod(f"uid-s{i}")
        else:
            sm.set_pod_status(pods[i], dict(choices[int(rng.integers(4))]))
        trace.append((sm.api_writes, sm.get_pod_status(f"uid-s{i}")))
    stored = {p["metadata"]["name"]: p.get("status")
              for p in client.list("pods")[0]}
    return trace, stored


@pytest.mark.parametrize("seed", [3, 4])
def test_status_manager_dedupes_alike(seed):
    jax_run = status_run(JAX, seed)
    assert jax_run[0][-1][0] < 120
    assert status_run(PORT, seed) == jax_run


CHECKPOINTS = {
    "pod_state": {"uid-a": {"sandbox": "s1", "containers": {"c0": "k1"}},
                  "uid-b": {"sandbox": "s2", "containers": {}}},
    "cpu_manager_state": {"p1": [1, 2], "p2": [5]},
    "unicode": {"name": "nœud-✓", "n": [1.5, None, True]},
}


def test_checkpoint_files_are_byte_identical(tmp_path):
    dirs = {pkg: tmp_path / pkg for pkg in PKGS}
    mgrs = {pkg: m(pkg, "kubelet.checkpoint").CheckpointManager(str(d))
            for pkg, d in dirs.items()}
    for name, data in CHECKPOINTS.items():
        for mgr in mgrs.values():
            mgr.create_checkpoint(name, data)
        assert (dirs[JAX] / name).read_bytes() == \
            (dirs[PORT] / name).read_bytes()
    # each package reads the other's directory
    for reader, writer in ((JAX, PORT), (PORT, JAX)):
        other = m(reader, "kubelet.checkpoint").CheckpointManager(
            str(dirs[writer]))
        assert other.list_checkpoints() == sorted(CHECKPOINTS)
        for name, data in CHECKPOINTS.items():
            assert other.get_checkpoint(name) == data
    # a tampered file is refused by both
    doc = json.loads((dirs[PORT] / "pod_state").read_text())
    doc["data"] = json.dumps({"uid-a": {}})
    (dirs[PORT] / "pod_state").write_text(json.dumps(doc))
    for pkg in PKGS:
        ck = m(pkg, "kubelet.checkpoint")
        with pytest.raises(ck.CorruptCheckpointError):
            ck.CheckpointManager(str(dirs[PORT])).get_checkpoint("pod_state")


# -- (c) hollow nodes under each package's Scheduler ------------------------

@pytest.fixture
def pallas_off(monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")


def hollow_run(pkg, n_nodes=6, n_pods=40):
    """Hollow nodes register through their kubelets, the Scheduler binds
    a seeded batch of pods, and every pod must be Running: returns each
    pod's (nodeName, status)."""
    stack = Stack(pkg, batch_size=64)
    hollow = m(pkg, "kubelet.hollow")
    stack.factory.start()
    stack.factory.wait_for_cache_sync()
    kubelets = hollow.start_hollow_nodes(
        stack.client, stack.factory, n_nodes, cpu="4", memory="8Gi",
        pods=110, heartbeat_interval=3600)
    try:
        assert bounded_wait(lambda: stack.sched.cache.node_count()
                               == n_nodes)
        rng = np.random.default_rng(9)
        for i in range(n_pods):
            w = stack.testing.make_pod(f"p{i}").req(
                cpu=f"{int(rng.integers(1, 8)) * 100}m",
                mem=f"{int(rng.integers(1, 8)) * 128}Mi")
            pod = w.build()
            pod["metadata"]["uid"] = f"uid-p{i}"
            stack.client.create(stack.PODS, pod)
        assert bounded_wait(lambda: stack.sched.queue.stats()["active"]
                               == n_pods)
        stack.schedule_all(n_pods)

        def running():
            pods = stack.client.list(stack.PODS)[0]
            return all((p.get("status") or {}).get("phase") == "Running"
                       and (p["status"].get("containerStatuses") or [])
                       for p in pods)
        assert bounded_wait(running)
        return {p["metadata"]["name"]: (p["spec"].get("nodeName"),
                                        p["status"])
                for p in stack.client.list(stack.PODS)[0]}
    finally:
        for k in kubelets:
            k.stop()
        stack.stop()


def test_hollow_nodes_run_what_each_scheduler_binds(pallas_off, deadline):
    jax_out, port_out = hollow_run(JAX), hollow_run(PORT)
    assert len({node for node, _ in port_out.values()}) > 1
    for name, (node, status) in port_out.items():
        assert node and status["hostIP"].startswith("10.0.0.")
        assert status["containerStatuses"][0]["state"] == RUNNING
    assert port_out == jax_out


# -- (d) the port's kubelet binary ------------------------------------------

ADMIN = "admin-token"
HARNESS_DISABLED = "ServiceAccount,TaintNodesByCondition,Priority"


def spawn(argv, name):
    return chip_smoke.ChildLog([sys.executable, "-u", *argv], name,
                               str(ROOT))


@pytest.fixture
def apiserver(tmp_path, deadline):
    """The port's apiserver as a process (RBAC, a token file, the default
    admission chain less the harness's list, a WAL) and a superuser
    HTTPClient; every process a test starts through `start` is stopped
    at the end."""
    http = m(PORT, "client.http_client")
    tokens = tmp_path / "tokens.csv"
    tokens.write_text(f"{ADMIN},admin,system:masters\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []

    def start(argv, name):
        p = spawn(argv, name)
        procs.append(p)
        return p
    api = start(["-m", f"{PORT}.cmd.apiserver", "--secure-port", str(port),
                 "--token-file", str(tokens), "--authorization-mode", "RBAC",
                 "--enable-default-admission", "--disable-admission-plugins",
                 HARNESS_DISABLED, "--data-dir", str(tmp_path / "wal")],
                "apiserver")
    url = f"http://127.0.0.1:{port}"
    try:
        api.wait_line("apiserver listening on", "its start", timeout=60)
        yield url, http.HTTPClient.from_url(url, token=ADMIN), start
    finally:
        for p in reversed(procs):
            p.stop()


def test_binary_registers_hollow_nodes_and_runs_a_pod(apiserver):
    url, admin, start = apiserver
    kubelet = start(["-m", f"{PORT}.cmd.kubelet", "--server", url,
                     "--token", ADMIN, "--hollow-nodes", "3", "--cpu", "8"],
                    "kubelet")
    kubelet.wait_line("kubemark: 3 hollow nodes registered", "its start",
                      timeout=60)
    nodes = {n["metadata"]["name"]: n for n in admin.list("nodes")[0]}
    assert set(nodes) == {"hollow-0", "hollow-1", "hollow-2"}
    assert nodes["hollow-1"]["status"]["allocatable"]["cpu"] in ("8",
                                                                 "8000m")
    leases = {o["metadata"]["name"]: o["spec"] for o in
              admin.list("leases", "kube-node-lease")[0]}
    assert set(leases) == set(nodes)
    assert leases["hollow-2"]["holderIdentity"] == "hollow-2"
    pod = meta.new_object("Pod", "web", "default")
    pod["spec"] = {"nodeName": "hollow-1",
                   "containers": [{"name": "c0", "image": "img"}]}
    admin.create("pods", pod)

    def status():
        return admin.get("pods", "default", "web").get("status") or {}
    assert bounded_wait(lambda: status().get("phase") == "Running")
    assert status()["containerStatuses"][0]["state"] == RUNNING
    assert {"type": "Ready", "status": "True"} in status()["conditions"]
    # R14(c): a second binary's nodes are the first one's
    other = start(["-m", f"{PORT}.cmd.kubelet", "--server", url, "--token",
                   ADMIN, "--hollow-nodes", "2"], "kubelet-2")
    other.wait_line("kubemark: 2 hollow nodes registered", "its start",
                    timeout=60)
    assert {n["metadata"]["name"] for n in admin.list("nodes")[0]} == \
        set(nodes)
    for p in (kubelet, other):
        p.proc.send_signal(signal.SIGTERM)
        assert p.proc.wait(timeout=10) == 0, p.lines[-20:]


def test_phase_35_runs_on_the_cpu(monkeypatch, deadline):
    """chip_smoke's phase 35 at a small size with the scheduler binary on
    the CPU (the card's checks, its claims launches, are phase 35's own
    and not made here): every check of the run holds."""
    monkeypatch.setattr(chip_smoke, "device_memory", lambda: (0.0, ""))
    got = chip_smoke.kubelet_run("cpu", nodes=20, pods=40, batch=64,
                                 device="cpu")
    sched = got["scheduler"]
    assert sched["device"] == "cpu" and sched["batches"] > 0
    assert sched["escaped"] == 0 and not sched["by_reason"]
    assert got["backoff"] == (0.25, 0.5)
    assert "Failed" in got["crashy_phases"]
    assert got["restored"] == ["default/probed"]
    assert got["terminal"] == ["default/crashy"]


# -- (e) R14, pinned in both packages ---------------------------------------

def node_pod(pkg, name, node, **spec):
    pod = m(pkg, "api.meta").new_object("Pod", name, "default")
    pod["metadata"]["uid"] = f"uid-{name}"
    pod["spec"] = {"nodeName": node,
                   "containers": [{"name": "c0", "image": "img"}], **spec}
    return pod


class Cluster:
    """One package's store, LocalClient and informer factory."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.store = m(pkg, "store.kv").MemoryStore()
        self.client = m(pkg, "client").LocalClient(self.store)
        self.factory = m(pkg, "client").SharedInformerFactory(self.client)
        self.kubelets = []

    def hollow(self, count, prefix="hollow-"):
        self.factory.start()
        self.factory.wait_for_cache_sync()
        made = m(self.pkg, "kubelet.hollow").start_hollow_nodes(
            self.client, self.factory, count, prefix=prefix,
            heartbeat_interval=3600)
        self.kubelets += made
        return made

    def status(self, name):
        return self.client.get("pods", "default", name).get("status") or {}

    def stop(self):
        for k in self.kubelets:
            k.stop()
        self.factory.stop()


@pytest.fixture
def clusters():
    made = []

    def make(pkg):
        c = Cluster(pkg)
        made.append(c)
        return c
    yield make
    for c in made:
        c.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_r14a_pleg_rewrites_and_fan_out(pkg, clusters, deadline):
    c = clusters(pkg)
    seen = {0: 0, 1: 0}
    kls = []
    hollow = m(pkg, "kubelet.hollow")
    c.factory.start()
    c.factory.wait_for_cache_sync()
    for i in range(2):
        kl = hollow.HollowKubelet(c.client, c.factory, f"hollow-{i}",
                                  heartbeat_interval=3600)
        handler = kl._on_pod_event

        def counted(type_, pod, old, i=i, handler=handler):
            if pod["metadata"]["name"] == "busy":
                seen[i] += 1
            handler(type_, pod, old)
        kl._on_pod_event = counted
        kls.append(kl.start())
    c.kubelets += kls
    scans = []
    listing = c.factory.informer("pods").list

    def counted_list():
        scans.append(1)
        return listing()
    c.factory.informer("pods").list = counted_list
    c.client.create("pods", node_pod(pkg, "busy", "hollow-0"))
    assert bounded_wait(lambda: c.status("busy").get("phase")
                           == "Running")
    rv0 = int(c.client.get("pods", "default", "busy")["metadata"]
              ["resourceVersion"])
    st0 = c.status("busy")
    time.sleep(0.5)
    rv1 = int(c.client.get("pods", "default", "busy")["metadata"]
              ["resourceVersion"])
    # nothing changed, yet within half a second (before PLEG's first
    # relist could run twice) the status was written again and again:
    # each write's own event makes the kubelet write it once more
    assert c.status("busy") == st0
    assert rv1 - rv0 >= 10, (rv0, rv1)
    seen1, scans0 = dict(seen), len(scans)
    time.sleep(2.2)
    # the other node's kubelet saw every one of those events
    assert seen[1] - seen1[1] >= 10
    assert abs((seen[0] - seen1[0]) - (seen[1] - seen1[1])) <= 2
    # and each relist scanned the informer to find the pod (a relist
    # comes a second after the last one ended, later on a loaded host)
    assert bounded_wait(lambda: len(scans) - scans0 >= 2, timeout=10)


IPS_SCRIPT = r"""
import importlib, sys, time
pkg = sys.argv[1]
def m(n): return importlib.import_module(pkg + "." + n)
client = m("client").LocalClient(m("store.kv").MemoryStore())
factory = m("client").SharedInformerFactory(client)
factory.start(); factory.wait_for_cache_sync()
k = m("kubelet.hollow").HollowKubelet(client, factory, "hollow-0",
                                      heartbeat_interval=3600).start()
pod = m("api.meta").new_object("Pod", "p", "default")
pod["metadata"]["uid"] = "uid-p"
pod["spec"] = {"nodeName": "hollow-0", "containers": [{"name": "c0"}]}
client.create("pods", pod)
for _ in range(1000):
    st = client.get("pods", "default", "p").get("status") or {}
    if st.get("podIP"):
        break
    time.sleep(0.01)
print(st["hostIP"], st["podIP"])
"""


@pytest.mark.parametrize("pkg", PKGS)
def test_r14b_ips_follow_the_hash_seed(pkg, deadline):
    def ips(seed):
        out = subprocess.run(
            [sys.executable, "-c", IPS_SCRIPT, pkg], cwd=ROOT, timeout=60,
            capture_output=True, text=True,
            env={**os.environ, "PYTHONHASHSEED": str(seed),
                 "JAX_PLATFORMS": "cpu"})
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout.split()
    a, b, a2 = ips(1), ips(2), ips(1)
    assert a == a2
    assert a[1] != b[1]     # podIP: three hash-derived octets


@pytest.mark.parametrize("pkg", PKGS)
def test_r14c_two_hollow_sets_claim_the_same_nodes(pkg, clusters, deadline):
    c = clusters(pkg)
    first, second = c.hollow(2), c.hollow(2)
    assert sorted(n["metadata"]["name"] for n in
                  c.client.list("nodes")[0]) == ["hollow-0", "hollow-1"]
    assert len(c.client.list("leases", "kube-node-lease")[0]) == 2
    c.client.create("pods", node_pod(pkg, "shared", "hollow-0"))
    # both kubelets named hollow-0 start its containers
    assert bounded_wait(lambda: "uid-shared" in first[0]._pod_state
                           and "uid-shared" in second[0]._pod_state)
    sandboxes = {first[0]._pod_state["uid-shared"]["sandbox"],
                 second[0]._pod_state["uid-shared"]["sandbox"]}
    assert len(sandboxes) == 2
    assert "uid-shared" not in first[1]._pod_state


def full_kubelet(pkg, c, root):
    kl = m(pkg, "kubelet.kubelet").Kubelet(
        c.client, c.factory, "n1", root_dir=str(root),
        heartbeat_interval=3600)
    c.kubelets.append(kl)
    return kl


def probed_and_crashy(pkg, run_s="0.3", period=0.05):
    probed = node_pod(pkg, "probed", "n1", restartPolicy="Always")
    probed["spec"]["containers"][0]["readinessProbe"] = {
        "periodSeconds": period}
    crashy = node_pod(pkg, "crashy", "n1", restartPolicy="Always")
    crashy["spec"]["containers"][0]["livenessProbe"] = {
        "periodSeconds": period}
    crashy["metadata"]["annotations"] = {"hollow/run-seconds": run_s,
                                         "hollow/exit-code": "1"}
    return probed, crashy


@pytest.mark.parametrize("pkg", PKGS)
def test_r14d_a_restarted_kubelet_reports_restored_pods_not_ready(
        pkg, clusters, tmp_path, deadline):
    c = clusters(pkg)
    kl = full_kubelet(pkg, c, tmp_path)
    c.factory.start()
    c.factory.wait_for_cache_sync()
    kl.start()
    for pod in probed_and_crashy(pkg):
        c.client.create("pods", pod)
    assert bounded_wait(lambda: c.status("crashy").get("phase")
                           == "Failed" and {"type": "Ready", "status":
                                            "True"} in
                           c.status("probed").get("conditions", []))
    kl._checkpoint_state()
    before = {n: c.status(n) for n in ("probed", "crashy")}
    # the crash: no stop(), its threads and handler just go away with
    # its informer factory
    kl._stop.set()
    kl.probes.stop()
    c.factory.stop()
    c.factory = m(pkg, "client").SharedInformerFactory(c.client)
    kl2 = full_kubelet(pkg, c, tmp_path)
    assert kl2.restore_state() is True
    assert set(kl2._pod_state) == {"uid-probed", "uid-crashy"}
    assert kl2.runtime.list_containers() == []
    c.factory.start()
    c.factory.wait_for_cache_sync()
    kl2.start()
    assert bounded_wait(lambda: c.status("probed").get(
        "containerStatuses") == [])
    time.sleep(0.5)
    after = c.status("probed")
    assert after["phase"] == "Running"
    assert {"type": "Ready", "status": "False"} in after["conditions"]
    assert after["containerStatuses"] == []
    assert chip_smoke.restored_status(after)
    # the terminal pod is left as it was
    assert c.status("crashy") == before["crashy"]
    assert kl2.runtime.list_containers() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_r14e_an_exited_container_fails_its_pod(pkg, clusters, tmp_path,
                                                deadline):
    c = clusters(pkg)
    kl = full_kubelet(pkg, c, tmp_path)
    c.factory.start()
    c.factory.wait_for_cache_sync()
    kl.start()
    _probed, crashy = probed_and_crashy(pkg)
    plain = node_pod(pkg, "plain", "n1", restartPolicy="Always")
    plain["metadata"]["annotations"] = dict(crashy["metadata"]
                                            ["annotations"])
    c.client.create("pods", crashy)
    c.client.create("pods", plain)
    # with a liveness probe: restarted twice, 0.25 s then 0.5 s of backoff
    assert bounded_wait(lambda: kl._backoff.get(
        ("uid-crashy", "c0"), (0,))[0] >= 1.0)
    assert c.status("crashy")["phase"] == "Failed"
    # without one: Failed at PLEG's relist and never restarted
    assert bounded_wait(lambda: c.status("plain").get("phase")
                           == "Failed")
    time.sleep(1.5)
    assert ("uid-plain", "c0") not in kl._backoff
    cid = kl._pod_state["uid-plain"]["containers"]["c0"]
    assert [x["state"] for x in kl.runtime.list_containers()
            if x["id"] == cid] == [EXITED]


R14F_NODES = 1000   # phase 35's failed size: the binary outlived SIGTERM
R14F_PODS = 100     # by 10 s at 1,000 nodes with 100 to 250 pods


@pytest.mark.parametrize("pkg", PKGS)
def test_r14f_sigterm_stops_the_nodes_one_by_one(pkg, apiserver):
    """cmd/kubelet.py's main, on SIGTERM, stops its N hollow kubelets one
    after another on the main thread, while the 2N threads they hold (a
    heartbeat and a PLEG loop a node) run on beside it in one interpreter.
    Pinned: two threads a node and an exit with 0, each package's binary
    against the port's apiserver process.  The time from SIGTERM to the
    exit is printed (run with -s): it varies from run to run with what
    those threads are doing when the signal comes."""
    url, admin, start = apiserver
    t0 = time.monotonic()
    kubelet = start(["-m", f"{pkg}.cmd.kubelet", "--server", url, "--token",
                     ADMIN, "--hollow-nodes", str(R14F_NODES)], "kubelet")
    kubelet.wait_line(f"kubemark: {R14F_NODES} hollow nodes registered",
                      "its start", timeout=60)
    registered = time.monotonic() - t0
    pods = []
    for i in range(R14F_PODS):
        pod = meta.new_object("Pod", f"p{i}", "default")
        pod["spec"] = {"nodeName": f"hollow-{i * R14F_NODES // R14F_PODS}",
                       "containers": [{"name": "c0", "image": "img"}]}
        pods.append(pod)
    admin.create_bulk("pods", pods)

    def running():
        return sum((o.get("status") or {}).get("phase") == "Running"
                   for o in admin.list("pods", "default")[0])
    assert bounded_wait(lambda: running() == R14F_PODS, timeout=60,
                        interval=0.2)
    _rss, threads = chip_smoke.process_rss_mib(kubelet.proc.pid)
    assert 2 * R14F_NODES <= threads <= 2 * R14F_NODES + 8, threads
    t1 = time.monotonic()
    kubelet.proc.send_signal(signal.SIGTERM)
    rc = kubelet.proc.wait(timeout=60)
    took = time.monotonic() - t1
    print(f"R14(f) {pkg}: {R14F_NODES} hollow nodes registered in "
          f"{registered:.3f} s, {R14F_PODS} pods Running, {threads} "
          f"threads; SIGTERM to exit {took:.3f} s, rc {rc}")
    assert rc == 0, kubelet.lines[-20:]


# -- (f) tests/test_kubelet_depth.py's scenarios on the port ------------

def wait_for(predicate, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def make_pod(name, node="n1", requests=None, limits=None, **spec_extra):
    pod = meta.new_object("Pod", name, "default")
    pod["metadata"]["uid"] = f"uid-{name}"
    res = {}
    if requests:
        res["requests"] = requests
    if limits:
        res["limits"] = limits
    pod["spec"] = {"nodeName": node,
                   "containers": [{"name": "c0", "image": "img:v1",
                                   "resources": res}],
                   **spec_extra}
    return pod


# -- checkpoint manager ----------------------------------------------------

class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.create_checkpoint("state", {"a": [1, 2], "b": "x"})
        assert cm.get_checkpoint("state") == {"a": [1, 2], "b": "x"}
        assert cm.list_checkpoints() == ["state"]
        cm.remove_checkpoint("state")
        assert cm.list_checkpoints() == []

    def test_missing_raises_keyerror(self, tmp_path):
        with pytest.raises(KeyError):
            CheckpointManager(str(tmp_path)).get_checkpoint("nope")

    def test_corrupt_checksum_detected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.create_checkpoint("state", {"v": 1})
        path = tmp_path / "state"
        doc = json.loads(path.read_text())
        doc["data"] = json.dumps({"v": 2})  # tampered, checksum stale
        path.write_text(json.dumps(doc))
        with pytest.raises(CorruptCheckpointError):
            cm.get_checkpoint("state")

    def test_torn_write_detected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        (tmp_path / "torn").write_text('{"data": "{\\"v\\"')
        with pytest.raises(CorruptCheckpointError):
            cm.get_checkpoint("torn")

    def test_invalid_names_rejected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        with pytest.raises(ValueError):
            cm.create_checkpoint("../escape", {})


# -- QoS -------------------------------------------------------------------

class TestQoS:
    def test_guaranteed(self):
        p = make_pod("g", requests={"cpu": "1", "memory": "1Gi"},
                     limits={"cpu": "1", "memory": "1Gi"})
        assert pod_qos(p) == GUARANTEED

    def test_limits_only_is_guaranteed(self):
        p = make_pod("g2", limits={"cpu": "1", "memory": "1Gi"})
        assert pod_qos(p) == GUARANTEED

    def test_burstable(self):
        p = make_pod("b", requests={"cpu": "1"})
        assert pod_qos(p) == BURSTABLE

    def test_best_effort(self):
        assert pod_qos(make_pod("be")) == BEST_EFFORT

    def test_mismatched_request_limit_burstable(self):
        p = make_pod("m", requests={"cpu": "1", "memory": "1Gi"},
                     limits={"cpu": "2", "memory": "1Gi"})
        assert pod_qos(p) == BURSTABLE


# -- probes ----------------------------------------------------------------

class TestProbes:
    def test_readiness_gates_until_success(self):
        results = []
        pm = ProbeManager(
            handler=lambda pod, c, t, running: True,
            on_readiness_change=lambda p, c, ok: results.append(ok))
        pod = make_pod("r")
        pod["spec"]["containers"][0]["readinessProbe"] = {
            "initialDelaySeconds": 0.3, "periodSeconds": 0.05}
        pm.add_pod(pod)
        assert pm.pod_ready(pod) is False  # gated until first success
        assert wait_for(lambda: pm.pod_ready(pod), timeout=5)
        assert results == [True]
        pm.stop()

    def test_failure_threshold_before_liveness_restart(self):
        restarts = []
        pm = ProbeManager(
            handler=lambda pod, c, t, running: False,
            on_liveness_failure=lambda p, c: restarts.append(c))
        pod = make_pod("l")
        pod["spec"]["containers"][0]["livenessProbe"] = {
            "periodSeconds": 0.05, "failureThreshold": 3}
        pm.add_pod(pod)
        assert wait_for(lambda: restarts, timeout=5)
        assert restarts[0] == "c0"
        pm.stop()

    def test_remove_pod_stops_workers(self):
        pm = ProbeManager(handler=lambda *a: True)
        pod = make_pod("gone")
        pod["spec"]["containers"][0]["readinessProbe"] = {"periodSeconds": 1}
        pm.add_pod(pod)
        pm.remove_pod(pod)
        assert pm.readiness == {}
        assert pm._workers == {}

    def test_annotation_handler_fails_probe(self):
        from kubernetes_tpu_torch.kubelet.probes import default_handler
        pod = make_pod("ann")
        pod["metadata"]["annotations"] = {"hollow/fail-readiness": "true"}
        assert default_handler(pod, {"name": "c0"}, READINESS, True) is False
        assert default_handler(pod, {"name": "c0"}, LIVENESS, True) is True


# -- eviction --------------------------------------------------------------

class TestEviction:
    def _cluster(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        return store, client

    def test_evicts_best_effort_first_under_pressure(self):
        store, client = self._cluster()
        node = meta.new_object("Node", "n1", "")
        node["status"] = {"conditions": []}
        client.create(NODES, node)
        be = make_pod("besteffort")
        bu = make_pod("burstable", requests={"memory": "900Mi"})
        client.create(PODS, be)
        client.create(PODS, bu)
        pods = [client.get(PODS, "default", "besteffort"),
                client.get(PODS, "default", "burstable")]
        em = EvictionManager(
            client, "n1", memory_capacity=1 << 30,  # 1Gi, ~900Mi used
            memory_available_threshold=0.15,  # 12% free < 15% -> pressure
            stats_provider=lambda ps: sum(
                0 if meta.name(p) == "besteffort" else 943718400
                for p in ps),
            list_pods=lambda: [client.get(PODS, "default", meta.name(p))
                               for p in pods
                               if meta.name(p) in {
                                   meta.name(x)
                                   for x in client.list(PODS, "default")[0]}])
        evicted = em.synchronize()
        # BestEffort dies first even though Burstable is the hog
        assert evicted[0] == "besteffort"
        assert (client.get(PODS, "default", "besteffort")["status"]["reason"]
                == "Evicted")
        node = client.get(NODES, "", "n1")
        assert any(c["type"] == "MemoryPressure"
                   for c in node["status"]["conditions"])

    def test_no_pressure_no_eviction(self):
        store, client = self._cluster()
        node = meta.new_object("Node", "n1", "")
        client.create(NODES, node)
        p = make_pod("calm", requests={"memory": "64Mi"})
        client.create(PODS, p)
        em = EvictionManager(client, "n1", memory_capacity=1 << 30,
                             list_pods=lambda: [p])
        assert em.synchronize() == []
        assert em.under_pressure is False


# -- status manager --------------------------------------------------------

class TestStatusManager:
    def test_dedupes_identical_statuses(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        pod = make_pod("s")
        client.create(PODS, pod)
        sm = StatusManager(client)
        for _ in range(5):
            sm.set_pod_status(pod, {"phase": "Running"})
        assert sm.api_writes == 1
        sm.set_pod_status(pod, {"phase": "Succeeded"})
        assert sm.api_writes == 2
        assert client.get(PODS, "default", "s")["status"]["phase"] == "Succeeded"

    def test_missing_pod_dropped(self):
        store = kv.MemoryStore()
        client = LocalClient(store)
        sm = StatusManager(client)
        pod = make_pod("ghost")
        sm.set_pod_status(pod, {"phase": "Running"})  # pod never created
        assert sm.get_pod_status("uid-ghost") is None


# -- pod workers -----------------------------------------------------------

class TestPodWorkers:
    def test_serialized_per_pod_and_coalesced(self):
        seen = []
        gate = threading.Event()

        def sync(update_type, pod):
            if not seen:
                gate.wait(5)
            seen.append((update_type, pod["metadata"]["labels"]["v"]))

        pw = PodWorkers(sync)
        pod = make_pod("w")
        for v in ("1", "2", "3"):  # arrive while sync #1 blocks
            pod = meta.deep_copy(pod)
            pod["metadata"]["labels"] = {"v": v}
            pw.update_pod("SYNC", pod)
        gate.set()
        assert wait_for(lambda: len(seen) == 2, timeout=5)
        time.sleep(0.1)
        # v=2 was coalesced away: only the first and the latest ran
        assert [v for _, v in seen] == ["1", "3"]
        pw.stop()

    def test_worker_exception_does_not_kill_pool(self):
        calls = []

        def sync(update_type, pod):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("boom")

        pw = PodWorkers(sync)
        pod = make_pod("e")
        pw.update_pod("SYNC", pod)
        assert wait_for(lambda: len(calls) == 1)
        pw.update_pod("SYNC", pod)
        assert wait_for(lambda: len(calls) == 2)
        pw.stop()


# -- image GC --------------------------------------------------------------

class TestImageGC:
    def test_gc_when_over_threshold(self):
        rt = FakeRuntimeService()
        gc = ImageGCManager(rt, disk_capacity=10, image_size=1,
                            high_threshold_percent=85,
                            low_threshold_percent=50)
        for i in range(9):  # 90% > 85%
            rt.pull_image(f"img:{i}")
            gc.image_used(f"img:{i}")
        deleted = gc.garbage_collect(in_use={"img:8"})
        assert "img:8" not in deleted
        assert gc.usage_percent() <= 50
        # oldest-used deleted first
        assert deleted[0] == "img:0"

    def test_no_gc_below_threshold(self):
        rt = FakeRuntimeService()
        gc = ImageGCManager(rt, disk_capacity=10, image_size=1)
        rt.pull_image("img:a")
        assert gc.garbage_collect(in_use=set()) == []


# -- full kubelet: restart policy + crash backoff + probes ----------------

@pytest.fixture
def kubelet_cluster(tmp_path):
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    kl = Kubelet(client, factory, "n1", root_dir=str(tmp_path),
                 heartbeat_interval=3600)
    factory.start()
    factory.wait_for_cache_sync()
    kl.start()
    yield store, client, kl
    kl.stop()
    factory.stop()


class TestKubeletFull:
    def test_pod_runs_and_reports_qos(self, kubelet_cluster):
        store, client, kl = kubelet_cluster
        client.create(PODS, make_pod("app", requests={"cpu": "1"}))
        assert wait_for(lambda: (client.get(PODS, "default", "app")
                                 .get("status") or {}).get("phase") == "Running")
        assert client.get(PODS, "default", "app")["status"]["qosClass"] == \
            BURSTABLE

    def test_restart_policy_always_restarts_exited(self, kubelet_cluster):
        store, client, kl = kubelet_cluster
        pod = make_pod("crashy")
        pod["metadata"]["annotations"] = {"hollow/run-seconds": "0.05",
                                          "hollow/exit-code": "1"}
        client.create(PODS, pod)
        assert wait_for(lambda: kl._container_running(pod, "c0"), timeout=10)
        # wait for the planned exit, then the restart
        assert wait_for(
            lambda: (kl.runtime.list_containers()
                     and any(c["state"] == EXITED
                             for c in kl.runtime.list_containers()))
            or kl._backoff, timeout=10)
        kl.workers.update_pod("SYNC", client.get(PODS, "default", "crashy"))
        assert wait_for(lambda: ("uid-crashy", "c0") in kl._backoff,
                        timeout=10)

    def test_restart_policy_never_stays_dead(self, kubelet_cluster):
        store, client, kl = kubelet_cluster
        pod = make_pod("oneshot", restartPolicy="Never")
        pod["metadata"]["annotations"] = {"hollow/run-seconds": "0.05",
                                          "hollow/exit-code": "0"}
        client.create(PODS, pod)
        assert wait_for(lambda: (client.get(PODS, "default", "oneshot")
                                 .get("status") or {}).get("phase")
                        == "Succeeded", timeout=10)

    def test_readiness_probe_gates_ready_condition(self, kubelet_cluster):
        store, client, kl = kubelet_cluster
        pod = make_pod("gated")
        pod["metadata"]["annotations"] = {"hollow/fail-readiness": "true"}
        pod["spec"]["containers"][0]["readinessProbe"] = {
            "periodSeconds": 0.05}
        client.create(PODS, pod)
        assert wait_for(lambda: (client.get(PODS, "default", "gated")
                                 .get("status") or {}).get("phase")
                        == "Running", timeout=10)
        time.sleep(0.3)
        conds = client.get(PODS, "default", "gated")["status"]["conditions"]
        ready = next(c for c in conds if c["type"] == "Ready")
        assert ready["status"] == "False"

    def test_checkpoint_and_restore(self, kubelet_cluster, tmp_path):
        store, client, kl = kubelet_cluster
        client.create(PODS, make_pod("persist"))
        assert wait_for(lambda: kl._pod_state, timeout=10)
        kl._checkpoint_state()
        # a fresh kubelet over the same root restores allocation state
        factory2 = SharedInformerFactory(client)
        kl2 = Kubelet(client, factory2, "n1", root_dir=str(tmp_path),
                      heartbeat_interval=3600)
        assert kl2.restore_state() is True
        assert "uid-persist" in kl2._pod_state
