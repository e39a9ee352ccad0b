"""Zero-downtime operations in the port: the seeded upgrade and churn
schedules, the drivers that apply them to the process supervisor, the
wire bind ledger, the child's /readyz-vs-/healthz split, the rolling
restart and the config hot reload over SIGHUP.

Held against the JAX package in this process, on the same seeds and
scripts: UpgradeSchedule and ScaleOutSchedule give identical action
streams; ProcessChurner and UpgradeDriver from both packages, driven
against one recording fake cluster, make identical calls and keep
identical `injected` and `log`; WireBindLedger from both packages over
each package's LocalClient sees the same nodes through one scripted
bind / rebind sequence and raises the same assertion.  The rest runs the
port alone: tests/test_upgrade.py's counterparts, with a JSON config for
the hot reload (the port reads JSON without PyYAML).  Tier-1 runs the
shrunk 2-process pass; the full matrix keeps the reference's slow mark.
"""

import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from kubernetes_tpu.client.clientset import LocalClient as JaxClient
from kubernetes_tpu.ops import faults as jax_faults
from kubernetes_tpu.scheduler import procrun as jax_procrun
from kubernetes_tpu.store import kv as jax_kv
from kubernetes_tpu_torch.client.clientset import (
    NODES, PODS, LocalClient as PortClient,
)
from kubernetes_tpu_torch.ops import faults as port_faults
from kubernetes_tpu_torch.ops.faults import (
    ROLL_INSTANCE, UpgradeDriver, UpgradeSchedule,
)
from kubernetes_tpu_torch.scheduler import procrun as port_procrun
from kubernetes_tpu_torch.scheduler.procrun import (
    ProcCluster, WireBindLedger, _ChildHTTP,
)
from kubernetes_tpu_torch.store import kv as port_kv
from kubernetes_tpu_torch.testing import make_node, make_pod

pytestmark = pytest.mark.upgrade

PKGS = {"jax": (jax_faults, jax_procrun, JaxClient, jax_kv),
        "port": (port_faults, port_procrun, PortClient, port_kv)}


def wait_for(pred, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.1)
    return False


def fill_cluster(admin, nodes: int):
    for i in range(nodes):
        admin.create(NODES, make_node(f"n{i}")
                     .capacity(cpu="16", mem="64Gi", pods=110).build())


def submit_pods(admin, count: int, offset: int = 0):
    for i in range(offset, offset + count):
        admin.create(PODS, make_pod(f"p{i}")
                     .req(cpu="100m", mem="128Mi").build())


# -- the seeded schedules and drivers against the JAX package ---------------


def test_constants_equal_the_reference():
    for name in ("ROLL_INSTANCE", "HANDOFF_APISERVER", "KILL_INSTANCE",
                 "REVIVE_INSTANCE", "NONE"):
        assert getattr(port_faults, name) == getattr(jax_faults, name)


UPGRADE_CASES = [(seed, count, rate, script)
                 for seed, count in ((5, 3), (11, 2))
                 for rate in (0.0, 0.3, 1.0)
                 for script in ({}, {1: ("roll_instance", 2, True),
                                     4: ("handoff_apiserver", 0, False)})]


@pytest.mark.parametrize("seed,count,rate,script", UPGRADE_CASES)
def test_upgrade_schedule_streams_match(seed, count, rate, script):
    a, b = (f.UpgradeSchedule(seed=seed, instance_count=count,
                              sabotage_rate=rate, script=script)
            for f in (jax_faults, port_faults))
    assert [a.action(i) for i in range(40)] == \
        [b.action(i) for i in range(40)]


SCALEOUT_CASES = [(seed, count, kill, revive, script)
                  for seed, count in ((7, 2), (13, 4))
                  for kill, revive in ((0.0, 0.0), (0.3, 0.3), (1.0, 0.0))
                  for script in ({}, {0: ("kill_instance", 0),
                                      3: ("revive_instance", 0)})]


@pytest.mark.parametrize("seed,count,kill,revive,script", SCALEOUT_CASES)
def test_scaleout_schedule_streams_match(seed, count, kill, revive, script):
    a, b = (f.ScaleOutSchedule(seed=seed, instance_count=count,
                               kill_rate=kill, revive_rate=revive,
                               script=script)
            for f in (jax_faults, port_faults))
    assert [a.action(i) for i in range(40)] == \
        [b.action(i) for i in range(40)]


def test_upgrade_stream_stability():
    """tests/test_upgrade.py's case on the port: a scripted entry wins
    without consuming an extra draw, and rolls go round robin."""
    plain = UpgradeSchedule(seed=5, instance_count=3, sabotage_rate=0.5)
    scripted = UpgradeSchedule(seed=5, instance_count=3, sabotage_rate=0.5,
                               script={1: (ROLL_INSTANCE, 2, True)})
    a = [plain.action(i) for i in range(6)]
    b = [scripted.action(i) for i in range(6)]
    assert b[1] == (ROLL_INSTANCE, 2, True)
    assert [x for i, x in enumerate(a) if i != 1] \
        == [x for i, x in enumerate(b) if i != 1]
    assert [idx for _, idx, _ in a] == [0, 1, 2, 0, 1, 2]


class FakeCluster:
    """ProcCluster's surface for the drivers, recording every call."""

    def __init__(self, n: int):
        self.n = n
        self.live = set(range(n))
        self.calls: list[tuple] = []

    def alive(self, index):
        self.calls.append(("alive", index))
        return index in self.live

    def live_indices(self):
        self.calls.append(("live_indices",))
        return sorted(self.live)

    def kill(self, index):
        self.calls.append(("kill", index))
        self.live.discard(index)

    def drain(self, index, timeout=20.0):
        self.calls.append(("drain", index, timeout))
        self.live.discard(index)
        return 0

    def respawn(self, index, wait_ready=True):
        self.calls.append(("respawn", index, wait_ready))
        self.live.add(index)

    def wait_child_ready(self, index, timeout=60.0):
        self.calls.append(("wait_child_ready", index, timeout))

    def handoff_apiserver(self):
        self.calls.append(("handoff_apiserver",))


@pytest.mark.parametrize("seed,count,kill,revive,min_live", [
    (7, 2, 0.4, 0.4, 1), (13, 4, 0.5, 0.3, 2), (21, 3, 1.0, 0.0, 1),
    (3, 3, 0.2, 0.6, 0)])
def test_process_churner_matches(seed, count, kill, revive, min_live):
    runs = []
    for f in (jax_faults, port_faults):
        cluster = FakeCluster(count)
        churner = f.ProcessChurner(cluster, f.ScaleOutSchedule(
            seed=seed, instance_count=count, kill_rate=kill,
            revive_rate=revive, script={2: ("kill_instance", count + 1)}),
            min_live=min_live)
        out = [churner.step() for _ in range(60)]
        runs.append((out, cluster.calls, churner.injected, churner.log,
                     churner.waves))
    assert runs[0] == runs[1]
    assert runs[1][2]["kill_instance"] > 0


@pytest.mark.parametrize("seed,count,rate,script,rolls", [
    (23, 3, 0.0, {}, 2),
    (11, 2, 0.0, {0: ("roll_instance", 0, True)}, 2),
    (5, 3, 0.5, {1: ("handoff_apiserver", 0, False)}, 3),
    (9, 4, 1.0, {2: ("roll_instance", 7, False)}, 2)])
def test_upgrade_driver_matches(seed, count, rate, script, rolls):
    runs = []
    for f in (jax_faults, port_faults):
        cluster = FakeCluster(count)
        cluster.live.discard(count - 1)   # one child already down
        upgrader = f.UpgradeDriver(cluster, f.UpgradeSchedule(
            seed=seed, instance_count=count, sabotage_rate=rate,
            script=script), drain_timeout=12.5, ready_timeout=33.0)
        out = [upgrader.roll_all() for _ in range(rolls)]
        runs.append((out, cluster.calls, upgrader.injected, upgrader.log,
                     upgrader.steps))
    assert runs[0] == runs[1]
    assert runs[1][2][ROLL_INSTANCE] > 0


def ledger_script(client, kv):
    """A scripted bind / rebind sequence: three pods bound, one of them
    moved to another node behind the scheduler's back."""
    for i in range(3):
        client.create(NODES, make_node(f"n{i}").build())
    for i in range(4):
        client.create(PODS, make_pod(f"p{i}").req(cpu="100m").build())
    for i, node in ((0, "n0"), (1, "n1"), (2, "n0")):
        pod = client.get(PODS, "default", f"p{i}")
        client.bind(pod, node)

    def move(cur):
        cur["spec"]["nodeName"] = "n2"
        return cur
    client.guaranteed_update(PODS, "default", "p2", move)


@pytest.mark.parametrize("rebind", [False, True])
def test_wire_bind_ledger_matches(rebind):
    seen, raised = [], []
    for faults, procrun, client_cls, kv in PKGS.values():
        client = client_cls(kv.MemoryStore())
        ledger = procrun.WireBindLedger(client)
        if rebind:
            ledger_script(client, kv)
        else:
            for i in range(2):
                client.create(NODES, make_node(f"n{i}").build())
                client.create(PODS, make_pod(f"p{i}").build())
                client.bind(client.get(PODS, "default", f"p{i}"), f"n{i}")
        seen.append({k: sorted(v) for k, v in ledger.drain().items()})
        try:
            ledger.assert_no_double_binds()
            raised.append(None)
        except AssertionError as e:
            raised.append(str(e))
        assert ledger.bound_total() == len(seen[-1])
        ledger.stop()
    assert seen[0] == seen[1]
    assert raised[0] == raised[1]
    assert (raised[1] is not None) == rebind


# -- the child's endpoints ---------------------------------------------------


class TestReadyzSplit:
    """The port's child endpoint with a stub scheduler: /healthz is pure
    liveness (200 while the process serves), /readyz is readiness (503
    while draining or fenced)."""

    @pytest.fixture
    def endpoint(self):
        class _Scaleout:
            self_live = True

        class _Sched:
            scaleout = _Scaleout()

            def expose_metrics(self):
                return "stub_metric 1\n"

        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                 _ChildHTTP)
        server.sched = _Sched()
        server.draining = False
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        yield server
        server.shutdown()

    def _get(self, server, path):
        url = f"http://127.0.0.1:{server.server_address[1]}{path}"
        try:
            with urllib.request.urlopen(url, timeout=5.0) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def test_live_and_ready(self, endpoint):
        assert self._get(endpoint, "/healthz") == (200, b"ok")
        assert self._get(endpoint, "/readyz") == (200, b"ok")
        assert self._get(endpoint, "/metrics") == (200, b"stub_metric 1\n")

    def test_fenced_fails_readiness_not_liveness(self, endpoint):
        endpoint.sched.scaleout.self_live = False
        assert self._get(endpoint, "/readyz") == (503, b"fenced")
        assert self._get(endpoint, "/healthz") == (200, b"ok")

    def test_draining_fails_readiness_not_liveness(self, endpoint):
        endpoint.draining = True
        assert self._get(endpoint, "/readyz") == (503, b"draining")
        assert self._get(endpoint, "/healthz") == (200, b"ok")


# -- the live topology -------------------------------------------------------


@pytest.mark.proc
class TestRollingUpgrade:
    def test_rolling_restart_exactly_once(self, proc_reaper):
        """Roll both children while pods stream, the first roll
        sabotaged by a mid-drain SIGKILL: the escalation is counted, the
        roll completes, and every pod binds exactly once."""
        cluster = ProcCluster(2, nodes=8,
                              lease_duration=1.0, renew_interval=0.2)
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        fill_cluster(admin, 8)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 20)
        assert wait_for(lambda: ledger.bound_total() >= 10)

        upgrader = UpgradeDriver(
            cluster,
            UpgradeSchedule(seed=11, instance_count=2,
                            script={0: (ROLL_INSTANCE, 0, True)}),
            drain_timeout=20.0)
        assert upgrader.step() == (ROLL_INSTANCE, 0)  # sabotaged
        assert cluster.drain_escalations == 1
        assert ("scheduler_proc_drain_escalated_total 1.0"
                in cluster.supervisor_metrics_text())
        submit_pods(admin, 20, offset=20)  # pods stream mid-roll
        assert upgrader.step() == (ROLL_INSTANCE, 1)  # graceful
        assert upgrader.injected[ROLL_INSTANCE] == 2
        assert upgrader.injected["sabotaged"] == 1
        assert sorted(cluster.live_indices()) == [0, 1]

        submit_pods(admin, 20, offset=40)
        assert wait_for(lambda: ledger.bound_total() >= 60), \
            f"only {ledger.bound_total()}/60 bound through the roll"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 60
        ledger.stop()

    def test_hot_reload_over_sighup(self, proc_reaper, tmp_path):
        """SIGHUP makes the child re-read its JSON --config: a valid edit
        applies without a restart (the reload counter moves in its
        /metrics), an invalid one is rejected with the child alive and
        the old config kept live."""
        cfg = tmp_path / "sched.json"

        def write(overload):
            cfg.write_text(json.dumps({"kind": "KubeSchedulerConfiguration",
                                       "overload": overload}))
        write({"queueCap": 512})
        cluster = ProcCluster(1, nodes=4, config_path=str(cfg))
        proc_reaper(cluster)
        cluster.start()

        def reload_counts():
            texts = cluster.metrics_texts()
            out = {"applied": 0, "rejected": 0}
            for line in "".join(texts).splitlines():
                if line.startswith("scheduler_config_reload_total{"):
                    for k in out:
                        if f'result="{k}"' in line:
                            out[k] = float(line.rsplit(" ", 1)[1])
            return out

        assert reload_counts()["applied"] == 1  # boot-time apply

        write({"queueCap": 1024, "sloP99Ms": 100})
        assert cluster.hot_reload() == [0]
        assert wait_for(lambda: reload_counts()["applied"] >= 2,
                        timeout=15.0), reload_counts()

        write({"queueCap": -7})
        cluster.hot_reload()
        assert wait_for(lambda: reload_counts()["rejected"] >= 1,
                        timeout=15.0), reload_counts()
        assert cluster.alive(0)  # a rejected reload never kills the child
        # a refused roll: the preflight reads the same bad file
        with pytest.raises(RuntimeError, match="refusing rolling restart"):
            cluster.rolling_restart()
        assert cluster.alive(0)
        write({"queueCap": 256})
        cluster.hot_reload()
        assert wait_for(lambda: reload_counts()["applied"] >= 3,
                        timeout=15.0), reload_counts()
        assert cluster.drain(0) == 0


@pytest.mark.proc
@pytest.mark.slow
class TestFullUpgradeMatrix:
    def test_warm_roll_with_handoff(self, proc_reaper, tmp_path):
        """Three children with a TorchBatchBackend on the CPU and a warm
        checkpoint dir over a WAL-backed apiserver: roll everything
        while pods stream, hand the apiserver off mid-stream, roll again
        (warm-starting from the drain checkpoints): exactly once through
        all of it."""
        warm = tmp_path / "warm"
        warm.mkdir()
        cluster = ProcCluster(
            3, nodes=8, backend="tpu", device="cpu", batch_size=64,
            lease_duration=1.5, renew_interval=0.25,
            warm_dir=str(warm), data_dir=str(tmp_path / "wal"))
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        fill_cluster(admin, 8)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 30)
        assert wait_for(lambda: ledger.bound_total() >= 15)

        upgrader = UpgradeDriver(
            cluster, UpgradeSchedule(seed=23, instance_count=3),
            drain_timeout=30.0, ready_timeout=120.0)
        rolled = upgrader.roll_all()
        assert [idx for _, idx in rolled] == [0, 1, 2]
        for i in range(3):
            assert (warm / f"sched-{i}.ckpt").exists()

        submit_pods(admin, 30, offset=30)
        cluster.handoff_apiserver()
        assert wait_for(lambda: ledger.bound_total() >= 60, timeout=120.0)

        upgrader.roll_all()
        warm_logs = [ln for i in range(3)
                     for ln in cluster._children[i].tail(60)
                     if "warm start:" in ln]
        assert warm_logs, "no child logged a warm start on the second roll"

        submit_pods(admin, 30, offset=60)
        assert wait_for(lambda: ledger.bound_total() >= 90, timeout=120.0), \
            f"only {ledger.bound_total()}/90 bound"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 90
        ledger.stop()
