"""The scheduler's binary in the port (cmd/scheduler.py, client/
leaderelection.py, scheduler/debugger.py and scheduler/config.py's
load_config) held against the JAX package on the CPU.

  (a) LeaderElector: both packages' electors go through one scripted
      sequence (acquire, renew, a held Lease, expiry, release) on their
      own package's LocalClient with one hand clock patched into both
      modules' `time`; every step's return value and Lease spec are
      equal.  A failed renewal fires on_stopped_leading in both.  Each
      package's elector over HTTP to its own apiserver under RBAC: the
      scheduler's token takes the Lease, a token with no binding gets
      the GET's 403 raised out of the elector in both.  Then
      tests/test_controllers.py's single-leader-and-failover case on the
      port.
  (b) CacheDebugger: the same store contents through each package's
      Scheduler (the per-pod profile, and the batch profile: the port's
      TorchBatchBackend(device="cpu"), the JAX TPUBatchBackend) give
      equal dump() and compare(), clean, with an assumed unconfirmed pod
      (kept out of `extra`), and with a poisoned cache.
  (c) load_config: one KubeSchedulerConfiguration as YAML to the JAX
      package and as JSON (file and text) and as a dict to the port give
      equal SchedulerConfigs; with PyYAML blocked the port still loads
      the JSON file and refuses YAML with a message naming the package.
  (d) main(argv): for the same argv (default, --tpu-batch, --config with
      two profiles) both packages' binaries build the same profiles
      (names, plugins a point, score weights, batch size, caps) and make
      their calls in the same order; the backends are constructed but
      their warmup, the informers and the loop are recorded, not run.
  (e) The live binary on the CPU behind the port's apiserver process
      (RBAC, the scheduler's own token, the default admission chain):
      alone, it binds 200 pods on 50 nodes within caps, logs "in sync"
      on SIGUSR2 and exits 0 on SIGTERM; as a pair with --leader-elect,
      the leader is SIGKILLed and the other takes over after the 15 s
      Lease and binds the rest, no pod's nodeName ever changing; without
      --device cpu on a machine with no GPU, --tpu-batch exits non-zero.
Each test that starts threads or processes runs under a SIGALRM
deadline (DEADLINE_S) and stops its processes in a finalizer.
"""

import dataclasses
import importlib
import json
import logging
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys
import time

import pytest

pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from torch_cases import wait_for  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = "kubernetes_tpu"
PORT = "kubernetes_tpu_torch"
PKGS = (JAX, PORT)
DEADLINE_S = 120


def m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture
def deadline():
    """Each test's own deadline: SIGALRM raises in the test's thread."""
    def expire(*_a):
        raise TimeoutError(f"binary test exceeded {DEADLINE_S} s")
    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


# -- (a) the elector --------------------------------------------------------

class HandClock:
    def __init__(self, t):
        self.t = t

    def time(self):
        return self.t


def lease_spec(client, clientset):
    lease = client.get(clientset.LEASES, "kube-system", "test-lock")
    md = lease["metadata"]
    return (lease["kind"], lease["apiVersion"], md["namespace"],
            md["name"], dict(lease["spec"]))


def elector_script(pkg, clock):
    """Two electors on one LocalClient stepped by hand; returns each
    step's (label, return value, Lease)."""
    le, kv = m(pkg, "client.leaderelection"), m(pkg, "store.kv")
    clientset = m(pkg, "client.clientset")
    client = clientset.LocalClient(kv.MemoryStore())
    a = le.LeaderElector(client, "test-lock", identity="a")
    b = le.LeaderElector(client, "test-lock", identity="b")
    trace = []

    def step(label, fn):
        got = fn()
        try:
            lease = lease_spec(client, clientset)
        except kv.NotFoundError:
            lease = None
        trace.append((label, clock.t, got, lease))
    step("nothing yet", lambda: None)
    step("a acquires (create)", a._try_acquire_or_renew)
    clock.t += 1.0
    step("b: held", b._try_acquire_or_renew)
    clock.t += 2.0
    step("a renews", a._try_acquire_or_renew)
    clock.t += 14.9
    step("b: held, 0.1 s short of expiry", b._try_acquire_or_renew)
    clock.t += 0.2
    step("b takes the expired Lease", b._try_acquire_or_renew)
    step("a: held by b", a._try_acquire_or_renew)
    clock.t += 5.0
    step("b renews", b._try_acquire_or_renew)
    step("a releases a Lease it does not hold", a._release)
    step("b releases", b._release)
    clock.t += 0.5
    step("a takes the released Lease", a._try_acquire_or_renew)
    b._leading = True   # stop() releases only while leading
    step("b stops (leading by its own view)", b.stop)
    a._leading = True
    step("a stops", a.stop)
    clock.t += 0.1
    step("b takes it again", b._try_acquire_or_renew)
    return trace


def test_elector_steps_match(monkeypatch):
    clock = HandClock(1_000.0)
    for pkg in PKGS:
        monkeypatch.setattr(m(pkg, "client.leaderelection"), "time", clock)
    traces = []
    for pkg in PKGS:
        clock.t = 1_000.0
        traces.append(elector_script(pkg, clock))
    jax_trace, port_trace = traces
    assert port_trace == jax_trace
    got = [(label, ret) for label, _t, ret, _l in port_trace]
    assert got == [
        ("nothing yet", None), ("a acquires (create)", True),
        ("b: held", False), ("a renews", True),
        ("b: held, 0.1 s short of expiry", False),
        ("b takes the expired Lease", True), ("a: held by b", False),
        ("b renews", True), ("a releases a Lease it does not hold", None),
        ("b releases", None), ("a takes the released Lease", True),
        ("b stops (leading by its own view)", None), ("a stops", None),
        ("b takes it again", True)]
    spec = {label: lease[4] for label, _t, _r, lease in port_trace
            if lease is not None}
    assert spec["a acquires (create)"] == {
        "holderIdentity": "a", "acquireTime": 1_000.0,
        "renewTime": 1_000.0, "leaseDurationSeconds": 15.0}
    assert spec["a renews"]["acquireTime"] == 1_000.0
    assert spec["a renews"]["renewTime"] == 1_003.0
    assert spec["b takes the expired Lease"]["holderIdentity"] == "b"
    assert spec["b releases"]["holderIdentity"] == ""
    assert spec["b releases"]["renewTime"] == 0


class FailingRenewals:
    """A client whose Lease updates fail once `failing` is set."""

    def __init__(self, client, kv):
        self._client, self._kv = client, kv
        self.failing = False

    def guaranteed_update(self, *a, **kw):
        if self.failing:
            raise self._kv.StoreError("apiserver unreachable")
        return self._client.guaranteed_update(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._client, name)


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_renewal_stops_leading(pkg, deadline):
    le, kv = m(pkg, "client.leaderelection"), m(pkg, "store.kv")
    client = FailingRenewals(
        m(pkg, "client.clientset").LocalClient(kv.MemoryStore()), kv)
    events = []
    e = le.LeaderElector(client, "test-lock", identity="a",
                         lease_duration=0.6, retry_period=0.05,
                         on_started_leading=lambda: events.append("start"),
                         on_stopped_leading=lambda: events.append("stop"))
    e.run()
    try:
        assert wait_for(lambda: e.is_leader, timeout=5)
        assert wait_for(lambda: len(events) == 1 and e.is_leader)
        client.failing = True
        assert wait_for(lambda: not e.is_leader, timeout=5)
        assert events == ["start", "stop"]
    finally:
        e._stop.set()


def test_single_leader_and_failover(deadline):
    """tests/test_controllers.py TestLeaderElection, on the port."""
    le, kv = m(PORT, "client.leaderelection"), m(PORT, "store.kv")
    client = m(PORT, "client.clientset").LocalClient(kv.MemoryStore())
    a = le.LeaderElector(client, "test-lock", identity="a",
                         lease_duration=0.6, retry_period=0.1)
    b = le.LeaderElector(client, "test-lock", identity="b",
                         lease_duration=0.6, retry_period=0.1)
    a.run()
    assert wait_for(lambda: a.is_leader, timeout=10)
    b.run()
    time.sleep(0.5)
    assert not b.is_leader
    a.stop()  # releases the lease
    assert wait_for(lambda: b.is_leader, timeout=5)
    b.stop()


def test_elector_over_rbac_matches(deadline):
    """Each package's elector through its own HTTPClient to its own
    apiserver (the harness's flags: RBAC, the default admission chain):
    under system:kube-scheduler's token it creates and renews the Lease
    in kube-system.  Under a token no binding names, the Lease GET's 403
    (an HTTPError, a kv.StoreError) is not caught: the reference reads
    the Lease outside its try, so the error leaves _try_acquire_or_renew
    and would end the elector's thread.  Both packages give the same
    answers."""
    from torch_front_door import DEV, SCHED, start_pair
    sides = start_pair()
    try:
        got = []
        for side in sides:
            pkg = side.pkg
            http = pkg.http_client
            url = f"http://127.0.0.1:{side.port}"
            le = importlib.import_module(
                f"{pkg.root}.client.leaderelection")
            answers = []
            for name, token in (("dev", DEV), ("sched", SCHED)):
                client = http.HTTPClient.from_url(url, token=token)
                e = le.LeaderElector(client, "kube-scheduler",
                                     identity=name)
                for _ in range(2):
                    try:
                        answers.append((name, e._try_acquire_or_renew()))
                    except pkg.kv.StoreError as err:
                        answers.append((name, type(err).__name__,
                                        err.code))
                client.close()
            lease = side.store.get("leases", "kube-system",
                                   "kube-scheduler")
            answers.append(lease["spec"]["holderIdentity"])
            got.append(answers)
        assert got[1] == got[0]
        assert got[1] == [("dev", "HTTPError", 403),
                          ("dev", "HTTPError", 403), ("sched", True),
                          ("sched", True), "sched"]
    finally:
        for side in sides:
            side.stop()


def test_elector_defaults_match():
    for cls in (m(pkg, "client.leaderelection").LeaderElector for pkg in PKGS):
        e = cls(None, "kube-scheduler")
        assert (e.lease_duration, e.renew_deadline, e.retry_period,
                e.namespace) == (15.0, 10.0, 2.0, "kube-system")
        assert re.fullmatch(r"kube-scheduler-[0-9a-f]{8}", e.identity)


# -- (b) the debugger -------------------------------------------------------

def debugger_run(pkg, batch, caplog):
    """One package's Scheduler over a fresh store: two nodes, a bound and
    a pending pod; then the pending pod assumed in the cache, then the
    cache poisoned.  Returns (dumps, compares, log verdicts)."""
    kv, client_mod = m(pkg, "store.kv"), m(pkg, "client")
    sched_mod, testing = m(pkg, "scheduler"), m(pkg, "testing")
    clientset = m(pkg, "client.clientset")
    dbg_mod = m(pkg, "scheduler.debugger")
    client = client_mod.LocalClient(kv.MemoryStore())
    factory = client_mod.SharedInformerFactory(client)
    fw = sched_mod.new_default_framework(client, factory)
    backend = None
    if batch:
        flatten = m(pkg, "ops.flatten")
        caps = flatten.Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4, pt_cap=4,
                            s_cap=1, sg_cap=2, asg_cap=2)
        if pkg == PORT:
            backend = m(PORT, "ops.backend").TorchBatchBackend(
                caps, batch_size=8, device="cpu")
        else:
            backend = m(JAX, "ops.backend").TPUBatchBackend(caps,
                                                             batch_size=8)
    profile = sched_mod.Profile(fw, batch_backend=backend, batch_size=8)
    sched = sched_mod.Scheduler(client, factory,
                                {"default-scheduler": profile})
    factory.start()
    factory.wait_for_cache_sync()
    dumps, diffs, verdicts = [], [], []
    dbg = dbg_mod.CacheDebugger(sched, client)

    def look():
        dumps.append(dbg.dump())
        diffs.append(dbg.compare())
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=dbg_mod.logger.name):
            dbg.log_all()
        verdicts.append([r.getMessage().split(":")[1].strip()[:12]
                         for r in caplog.records
                         if r.getMessage().startswith("cache comparer")])
    try:
        for name in ("dbg-1", "dbg-2"):
            client.create(clientset.NODES, testing.make_node(name).capacity(
                cpu="4", mem="8Gi").build())
        client.create(clientset.PODS, testing.make_pod("p1").req(
            cpu="1", mem="1Gi").node("dbg-1").build())
        client.create(clientset.PODS, testing.make_pod("p2").req(
            cpu="1", mem="1Gi").build())
        assert wait_for(lambda: sched.cache.node_count() == 2
                        and sched.cache.pod_count() == 1
                        and sched.queue.stats()["active"] == 1, timeout=10)
        look()                                   # clean
        pending = client.get(clientset.PODS, "default", "p2")
        pending["spec"]["nodeName"] = "dbg-2"
        sched.cache.assume_pod(pending)
        look()                                   # assumed, unconfirmed
        sched.cache.remove_node(client.get(clientset.NODES, "", "dbg-1"))
        ghost = testing.make_pod("ghost").req(cpu="1").node("dbg-2").build()
        sched.cache.add_pod(ghost)
        look()                                   # poisoned
    finally:
        factory.stop()
    return dumps, diffs, verdicts


@pytest.mark.parametrize("batch", [False, True], ids=["per-pod", "batch"])
def test_debugger_matches(batch, caplog, deadline):
    jax_run = debugger_run(JAX, batch, caplog)
    port_run = debugger_run(PORT, batch, caplog)
    assert port_run == jax_run
    dumps, diffs, verdicts = port_run
    clean = {"nodes": {"missing": [], "extra": []},
             "pods": {"missing": [], "extra": []}}
    assert dumps[0] == {"cache": {"nodes": {"dbg-1": 1, "dbg-2": 0},
                                  "assumed_pods": [], "pod_count": 1},
                        "queue": {"active": 1, "backoff": 0,
                                  "unschedulable": 0}}
    assert diffs[0] == clean and diffs[1] == clean
    assert dumps[1]["cache"]["assumed_pods"] == ["default/p2"]
    assert diffs[2] == {"nodes": {"missing": ["dbg-1"], "extra": []},
                        "pods": {"missing": [], "extra": ["default/ghost"]}}
    assert verdicts == [["cache is in "], ["cache is in "],
                        ["DISCREPANCIE"]]


# -- (c) load_config --------------------------------------------------------

CONFIG = {
    "apiVersion": "kubescheduler.config.k8s.io/v1",
    "kind": "KubeSchedulerConfiguration",
    "parallelism": 8,
    "percentageOfNodesToScore": 40,
    "podInitialBackoffSeconds": 2,
    "podMaxBackoffSeconds": 20,
    "profiles": [
        {"schedulerName": "default-scheduler",
         "plugins": {"multiPoint": {"disabled": [{"name": "ImageLocality"}]},
                     "score": {"disabled": [{"name": "NodeResourcesFit"}],
                               "enabled": [{"name": "TaintToleration",
                                            "weight": 3}]}},
         "pluginConfig": [{"name": "NodeResourcesFit",
                           "args": {"strategy": "MostAllocated"}}]},
        {"schedulerName": "gang-scheduler", "percentageOfNodesToScore": 10,
         "plugins": {"multiPoint": {"enabled": [{"name": "Coscheduling"}]}}},
    ],
    "remoteSeam": {"stepTimeoutSeconds": 30, "maxRetries": 2},
    "backend": {"kind": "tpu", "batchSize": 4096},
    "tracing": {"samplingRatePerMillion": 10000},
    "overload": {"queueCap": 16384, "sloP99Ms": 250},
    "scaleOut": {"instanceCount": 2, "instanceIndex": 1,
                 "partitionBy": "namespaceHash"},
}


def config_fields(cfg):
    return dataclasses.asdict(cfg)


def test_load_config_json_matches_jax_yaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    want = config_fields(m(JAX, "scheduler.config").load_config(
        yaml.safe_dump(CONFIG)))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(CONFIG))
    load = m(PORT, "scheduler.config").load_config
    for source in (str(path), json.dumps(CONFIG), CONFIG):
        assert config_fields(load(source)) == want
    # a YAML source still loads where PyYAML is installed
    yaml_path = tmp_path / "config.yaml"
    yaml_path.write_text(yaml.safe_dump(CONFIG))
    assert config_fields(load(str(yaml_path))) == want
    assert len(want["profiles"]) == 2


def test_load_config_bad_json_file(tmp_path):
    config = m(PORT, "scheduler.config")
    path = tmp_path / "broken.json"
    path.write_text('{"kind": ')
    with pytest.raises(config.ConfigError, match="invalid JSON"):
        config.load_config(str(path))
    empty = tmp_path / "empty.json"
    empty.write_text("")
    assert config_fields(config.load_config(str(empty))) == config_fields(
        m(JAX, "scheduler.config").load_config({}))


_NO_YAML = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
from kubernetes_tpu_torch.scheduler.config import ConfigError, load_config
cfg = load_config(sys.argv[1])
assert [p.scheduler_name for p in cfg.profiles] == [
    "default-scheduler", "gang-scheduler"], cfg.profiles
assert cfg.scale_out.instance_count == 2
try:
    load_config("kind: KubeSchedulerConfiguration\nparallelism: 4\n")
except ConfigError as e:
    assert "PyYAML" in str(e), e
else:
    raise AssertionError("YAML loaded without PyYAML")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu", "yaml"))
assert not bad, bad
print("OK")
"""


def test_load_config_json_without_yaml(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(CONFIG))
    proc = subprocess.run([sys.executable, "-c", _NO_YAML, str(path)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout


# -- (d) the binary's construction -----------------------------------------

class Built(Exception):
    """Raised from the recorded sched.run: main has built everything."""


def construct(pkg, argv, monkeypatch):
    """Run one package's main(argv) until it starts the scheduler: the
    HTTP client is a LocalClient, the backend's warmup, the informers
    and the loop are recorded instead of run.  Returns (profiles, calls).
    """
    calls = []
    kv, clientset = m(pkg, "store.kv"), m(pkg, "client.clientset")
    http = m(pkg, "client.http_client")
    monkeypatch.setattr(http.HTTPClient, "from_url", staticmethod(
        lambda *a, **kw: (calls.append(("client", a)),
                          clientset.LocalClient(kv.MemoryStore()))[1]))
    monkeypatch.setattr(m(pkg, "utils.gctune"), "tune_for_throughput",
                        lambda *a, **kw: calls.append(("tune",)))
    backend_cls = (m(PORT, "ops.backend").TorchBatchBackend if pkg == PORT
                   else m(JAX, "ops.backend").TPUBatchBackend)
    monkeypatch.setattr(backend_cls, "warmup",
                        lambda self: calls.append(("warmup",)))
    informer = m(pkg, "client.informer").SharedInformerFactory
    monkeypatch.setattr(informer, "start",
                        lambda self: calls.append(("informers start",)))
    monkeypatch.setattr(informer, "wait_for_cache_sync",
                        lambda self, *a, **kw: calls.append(("synced",)))
    seen = {}

    def run(self):
        calls.append(("run",))
        seen["sched"] = self
        raise Built
    monkeypatch.setattr(m(pkg, "scheduler.scheduler").Scheduler, "run", run)
    if pkg == PORT:
        argv = [*argv, "--device", "cpu"] if "--tpu-batch" in argv else argv
    with pytest.raises(Built):
        m(pkg, "cmd.scheduler").main(argv)
    return seen["sched"], calls


def profile_shape(sched):
    out = {}
    for name, prof in sched.profiles.items():
        fw = prof.framework
        points = {point: [p.name for p in getattr(fw, point)]
                  for point in ("pre_filter", "filter", "post_filter",
                                "pre_score", "reserve", "permit",
                                "pre_bind", "bind", "post_bind")}
        points["queue_sort"] = fw.queue_sort and fw.queue_sort.name
        points["score"] = [(p.name, w) for p, w in fw.score]
        b = prof.batch_backend
        out[name] = {
            "framework": fw.profile_name, "points": points,
            "percentage": prof.percentage_of_nodes_to_score,
            "batch_size": prof.batch_size,
            "backend": b and {"caps": dataclasses.asdict(b.caps),
                              "batch_size": b.batch_size,
                              "full_cap": b.full_cap}}
    return out


@pytest.mark.parametrize("argv", [
    [], ["--tpu-batch"],
    ["--tpu-batch", "--batch-size", "4096", "--node-capacity", "5632"],
    ["--config", "CONFIG"], ["--config", "CONFIG", "--tpu-batch",
                             "--batch-size", "64", "--node-capacity", "256"],
], ids=["default", "tpu-batch", "tpu-batch-5k", "config", "config-tpu-batch"])
def test_main_builds_the_jax_profiles(argv, tmp_path, monkeypatch):
    if "CONFIG" in argv:
        path = tmp_path / "config.json"
        path.write_text(json.dumps(CONFIG))
        argv = [str(path) if a == "CONFIG" else a for a in argv]
    shapes, orders = [], []
    for pkg in PKGS:
        sched, calls = construct(pkg, ["--server", "http://h:1",
                                       "--token", "t", *argv], monkeypatch)
        shapes.append(profile_shape(sched))
        orders.append(calls)
        if "--config" in argv:
            assert sched.queue._initial_backoff == 2
    assert shapes[1] == shapes[0]
    assert orders[1] == orders[0]
    assert orders[0][0] == ("tune",)
    if "--tpu-batch" in argv:
        assert orders[0].index(("warmup",)) < orders[0].index(
            ("informers start",))
        assert all(s["backend"] for s in shapes[1].values())
    else:
        assert not any(s["backend"] for s in shapes[1].values())
    assert len(shapes[1]) == (2 if "--config" in argv else 1)


def test_main_builds_a_torch_backend_on_the_named_device(monkeypatch):
    sched, _ = construct(PORT, ["--tpu-batch"], monkeypatch)
    b = sched.profiles["default-scheduler"].batch_backend
    assert type(b).__name__ == "TorchBatchBackend"
    assert b.device.type == "cpu"


# -- (e) the live binary ----------------------------------------------------

ADMIN, SCHED = "admin-token", "sched-token"
HARNESS_DISABLED = "ServiceAccount,TaintNodesByCondition,Priority"
BIN_ARGS = ["--tpu-batch", "--device", "cpu", "--batch-size", "64",
            "--node-capacity", "256"]


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv, name):
    """A child python process read line by line (chip_smoke's ChildLog,
    which phase 32 runs its binaries through)."""
    return chip_smoke.ChildLog([sys.executable, "-u", *argv], name,
                               str(ROOT))


@pytest.fixture
def cluster(tmp_path, deadline):
    """The port's apiserver as a process (RBAC, the default admission
    chain less the harness's list, a WAL), a superuser client and a way
    to start scheduler binaries under system:kube-scheduler's token."""
    http = m(PORT, "client.http_client")
    tokens = tmp_path / "tokens.csv"
    tokens.write_text(f"{ADMIN},admin,system:masters\n"
                      f"{SCHED},system:kube-scheduler\n")
    port = free_port()
    procs = []
    api = spawn(["-m", f"{PORT}.cmd.apiserver", "--secure-port", str(port),
                "--token-file", str(tokens), "--authorization-mode", "RBAC",
                "--enable-default-admission", "--disable-admission-plugins",
                HARNESS_DISABLED, "--data-dir", str(tmp_path / "wal")],
               "apiserver")
    procs.append(api)
    url = f"http://127.0.0.1:{port}"
    try:
        api.wait_line("apiserver listening on", "its start", timeout=60)
        admin = http.HTTPClient.from_url(url, token=ADMIN)

        def binary(*extra, name="scheduler"):
            p = spawn(["-m", f"{PORT}.cmd.scheduler", "--server", url,
                      "--token", SCHED, *extra], name)
            procs.append(p)
            return p
        yield admin, binary
    finally:
        for p in reversed(procs):
            p.stop()


def create(admin, what, count, offset=0, prefix="pod-"):
    sp = m(PORT, "perf.scheduler_perf")
    build = sp._default_node if what == "nodes" else sp._default_pod
    sp._bulk_create(admin, what, count, offset, build,
                    {"podNamePrefix": prefix})


def usr2_in_sync(binary):
    since = len(binary.lines)
    binary.proc.send_signal(signal.SIGUSR2)
    _t, hit = binary.wait_line(r"cache comparer: (.*)", "SIGUSR2", since,
                               timeout=20)
    assert hit[1].startswith("cache is in sync with apiserver"), hit[1]


def test_live_binary_binds_and_stops(cluster):
    admin, binary = cluster
    create(admin, "nodes", 50)
    b = binary(*BIN_ARGS)
    b.wait_line(r"scheduler running \(tpu-batch profile\)", "its start",
                timeout=90)
    watch = chip_smoke.BindWatch(admin)
    try:
        create(admin, "pods", 200)
        assert wait_for(lambda: watch.bound() == 200, timeout=60), \
            watch.bound()
        # every pod asks 100m / 128Mi of a 32-CPU, 256Gi, 110-pod node
        chip_smoke.check_binary_caps(admin, 200, "the binary")
        assert set(watch.binds.values()) == {1} and not watch.changed
    finally:
        watch.close()
    usr2_in_sync(b)
    b.proc.send_signal(signal.SIGTERM)
    assert b.proc.wait(timeout=10) == 0, b.lines[-20:]


def test_live_pair_fails_over(cluster):
    admin, binary = cluster
    create(admin, "nodes", 50)
    pair = [binary(*BIN_ARGS, "--leader-elect", name=f"scheduler-{i}")
            for i in range(2)]
    for p in pair:
        p.wait_line(r"scheduler running", "its start", timeout=90)
    assert wait_for(lambda: any(p.find("became leader") for p in pair),
                    timeout=30)
    leader = next(p for p in pair if p.find("became leader"))
    follower = next(p for p in pair if p is not leader)
    ident = leader.find(r"(kube-scheduler-[0-9a-f]{8}) became leader")[1][1]
    lease = admin.get("leases", "kube-system", "kube-scheduler")
    assert lease["spec"]["holderIdentity"] == ident
    watch = chip_smoke.BindWatch(admin)
    try:
        create(admin, "pods", 100)
        assert wait_for(lambda: watch.bound() == 100, timeout=60)
        leader.proc.kill()
        leader.proc.wait()
        t_kill = time.monotonic()
        create(admin, "pods", 100, offset=100)
        follower.wait_line("became leader", "the takeover", timeout=30)
        took = time.monotonic() - t_kill
        assert wait_for(lambda: watch.bound() == 200, timeout=60), \
            watch.bound()
        chip_smoke.check_binary_caps(admin, 200, "the pair")
        assert set(watch.binds.values()) == {1} and not watch.changed
        # the Lease expired (15 s) before the follower could take it
        assert took > 10.0, took
        lease = admin.get("leases", "kube-system", "kube-scheduler")
        assert lease["spec"]["holderIdentity"] != ident
    finally:
        watch.close()
    usr2_in_sync(follower)
    follower.proc.send_signal(signal.SIGTERM)
    assert follower.proc.wait(timeout=10) == 0, follower.lines[-20:]


def test_tpu_batch_without_a_gpu_exits(tmp_path):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.cmd.scheduler", "--server",
         f"http://127.0.0.1:{free_port()}", "--tpu-batch"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]
    assert "scheduler running" not in proc.stdout
