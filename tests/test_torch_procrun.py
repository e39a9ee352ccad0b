"""The port's process supervisor (kubernetes_tpu_torch/scheduler/
procrun.py): an apiserver process (kubernetes_tpu_torch.cmd.apiserver)
plus N scheduler processes of the port, wired only over HTTP, on the CPU.

  * the counterparts of tests/test_procrun.py (two processes bind every
    pod exactly once, federate their /metrics and drain to exit 0; a
    seeded SIGKILL fails over), of tests/test_scaleout.py's
    TestCrossProcessConflictTaxonomy (one feasible node, both children
    own every pod, the race probes pin the interleaving: exactly one
    lost_to_peer, in the held child, and the diverted bind stands) and
    of tests/test_timeline.py's test_federation_under_seeded_churn;
  * two `tpu` children (a TorchBatchBackend on the CPU in each) with a
    warm-start directory: rolling_restart() binds every pod exactly once
    and each respawned child logs a warm start of its checkpointed rows;
  * handoff_apiserver() over the WAL: pods created after the handoff
    bind and the WireBindLedger re-arms against the replacement;
  * two kubernetes_tpu_torch.cmd.scheduler binaries, each with a JSON
    --config carrying its scaleOut stanza, bind a flood exactly once;
  * the argv ProcCluster builds names only kubernetes_tpu_torch modules,
    and a `tpu` child asked for CUDA on a machine without it ends with
    resolve_device's message before it connects.

Every process test takes proc_reaper (tests/conftest.py): registered
clusters and processes are reaped on teardown, and a watchdog kills
them if a test outlives its ceiling.
"""

import json
import os
import re
import sys
import time

import pytest

import chip_smoke
from kubernetes_tpu_torch.client.clientset import NODES, PODS
from kubernetes_tpu_torch.component_base.profiling import (
    federate_texts, parse_prometheus_text,
)
from kubernetes_tpu_torch.component_base.timeline import device_idle_share
from kubernetes_tpu_torch.ops.faults import (
    KILL_INSTANCE, ProcessChurner, ScaleOutSchedule,
)
from kubernetes_tpu_torch.scheduler import procrun
from kubernetes_tpu_torch.scheduler.procrun import ProcCluster, WireBindLedger
from kubernetes_tpu_torch.testing import make_node, make_pod

pytestmark = pytest.mark.proc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


class TestProcessTopology:
    def test_two_process_exactly_once_and_drain(self, proc_reaper):
        cluster = ProcCluster(2, nodes=16)
        proc_reaper(cluster)
        cluster.start()
        assert cluster.live_indices() == [0, 1]
        admin = cluster.admin_client()
        fill_cluster(admin, 16)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 80)

        assert wait_for(lambda: ledger.bound_total() >= 80), \
            f"only {ledger.bound_total()}/80 pods bound; " \
            f"live={cluster.live_indices()}"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 80  # zero lost pods
        ledger.stop()

        texts = cluster.metrics_texts()
        assert len(texts) == 2
        fed = federate_texts(texts)
        assert any(name.startswith("scheduler_") for name in fed), \
            f"no scheduler metrics federated: {sorted(fed)[:5]}"

        # SIGTERM -> retire lease -> flush -> exit 0
        assert cluster.drain(0) == 0
        assert cluster.drain(1) == 0

    def test_crash_failover_under_seeded_churn(self, proc_reaper):
        cluster = ProcCluster(2, nodes=8,
                              lease_duration=1.0, renew_interval=0.2)
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        fill_cluster(admin, 8)
        ledger = WireBindLedger(admin)

        submit_pods(admin, 20)
        assert wait_for(lambda: ledger.bound_total() >= 10)

        churner = ProcessChurner(
            cluster,
            ScaleOutSchedule(seed=7, instance_count=2,
                             script={0: (KILL_INSTANCE, 0)}),
            min_live=1)
        assert churner.step() == (KILL_INSTANCE, 0)
        assert not cluster.alive(0) and cluster.alive(1)
        assert churner.injected[KILL_INSTANCE] == 1

        # pods submitted AFTER the crash prove the survivor absorbed the
        # dead instance's partition, not just finished its own backlog
        submit_pods(admin, 20, offset=20)
        assert wait_for(lambda: ledger.bound_total() >= 40), \
            f"only {ledger.bound_total()}/40 bound after crash"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 40
        ledger.stop()


class TestCrossProcessConflictTaxonomy:
    """Both children run solo ownership (instanceCount 1), so both
    schedule the one pod, and only n0 fits it.  Child 1 holds its first
    bind 2.0 s and commits it diverted to n1; child 0 holds 4.5 s, so its
    commit lands after the peer's and loses.  The holds are longer than
    the reference's (0.5 s and 2.5 s): each must cover the gap between
    the two children's scheduling cycles for the pod, and on a busy host
    (beside `pytest -n 6`) child 0 reached its cycle more than 0.5 s
    after child 1 had bound the pod, saw it bound and never raced."""

    def test_exactly_one_lost_to_peer(self, proc_reaper):
        cluster = ProcCluster(
            2, solo_ownership=True, nodes=2,
            child_env={0: {"KTPU_PROC_BIND_HOLD": "4.5"},
                       1: {"KTPU_PROC_BIND_HOLD": "2.0",
                           "KTPU_PROC_BIND_DIVERT": "n1"}})
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        admin.create(NODES, make_node("n0")
                     .capacity(cpu="16", mem="64Gi", pods=110).build())
        admin.create(NODES, make_node("n1")
                     .capacity(cpu="100m", mem="64Mi", pods=110).build())
        admin.create(PODS, make_pod("racer").req(cpu="4", mem="1Gi").build())

        def lost_to_peer_counts():
            out = []
            for text in cluster.metrics_texts():
                series = parse_prometheus_text(text).get(
                    "scheduler_bind_conflict_total", {})
                out.append(sum(v for labels, v in series.items()
                               if "lost_to_peer" in labels))
            return out

        assert wait_for(lambda: sum(lost_to_peer_counts()) >= 1,
                        timeout=60.0), \
            f"no lost_to_peer surfaced: {lost_to_peer_counts()}"
        assert lost_to_peer_counts() == [1.0, 0.0]
        pod = admin.get(PODS, "default", "racer")
        assert (pod.get("spec") or {}).get("nodeName") == "n1"
        # and it stays won: the loser neither requeues nor rebinds it
        time.sleep(1.0)
        assert lost_to_peer_counts() == [1.0, 0.0]
        assert admin.get(PODS, "default",
                         "racer")["spec"]["nodeName"] == "n1"


class TestProcFederation:
    def test_federation_under_seeded_churn(self, proc_reaper):
        env = {"KTPU_PROC_TIMELINE": "1"}
        cluster = ProcCluster(2, backend="null", nodes=8,
                              child_env={0: env, 1: env})
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        for i in range(8):
            admin.create(NODES, make_node(f"n{i}").capacity(
                cpu="16", mem="64Gi", pods=110).build())
        ledger = WireBindLedger(admin)
        for i in range(40):
            admin.create(PODS, make_pod(f"p{i}").req(cpu="100m").build())

        assert wait_for(lambda: ledger.bound_total() >= 40)
        assert len(ledger.observed_at) >= 40
        assert all(v <= time.time() for v in ledger.observed_at.values())

        snaps = cluster.timeline_snapshots()
        assert sorted(snaps) == [0, 1]
        assert all(doc["enabled"] for doc in snaps.values())
        assert any(doc["interval_rows"] for doc in snaps.values()), \
            "no child recorded intervals"
        fed = cluster.federated_timeline()
        rows = fed.intervals()
        procs = {r["proc"] for r in rows}
        assert procs and procs <= {"sched0", "sched1"}
        assert device_idle_share(rows) is not None
        text = cluster.supervisor_metrics_text()
        assert "scheduler_proc_wave_device_idle_share" in text

        churner = ProcessChurner(
            cluster,
            ScaleOutSchedule(seed=11, instance_count=2,
                             script={0: (KILL_INSTANCE, 0)}),
            min_live=1)
        assert churner.step() == (KILL_INSTANCE, 0)
        assert not cluster.alive(0) and cluster.alive(1)
        snaps = cluster.timeline_snapshots()
        assert sorted(snaps) == [1]
        fed = cluster.federated_timeline()
        assert {r["proc"] for r in fed.intervals()} <= {"sched1"}
        ledger.stop()


WARM_LINE = re.compile(r"warm start: (\d+) rows pending adoption")


class TestTorchChildren:
    def test_warm_rolling_restart_of_tpu_children(self, proc_reaper,
                                                  tmp_path):
        """Two children each with a TorchBatchBackend on the CPU: every
        drain checkpoints the child's mirror, every respawn warm-starts
        from it, and every pod (before, during and after the roll) binds
        exactly once."""
        warm = tmp_path / "warm"
        warm.mkdir()
        cluster = ProcCluster(2, backend="tpu", device="cpu", nodes=8,
                              batch_size=64, warm_dir=str(warm),
                              lease_duration=1.5, renew_interval=0.25)
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        fill_cluster(admin, 8)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 30)
        assert wait_for(lambda: ledger.bound_total() >= 30)

        assert cluster.rolling_restart() == [0, 1]
        for i in range(2):
            assert (warm / f"sched-{i}.ckpt").exists()
            rows = [int(hit[1]) for line in cluster._children[i].tail(200)
                    for hit in [WARM_LINE.search(line)] if hit]
            assert rows and rows[0] > 0, cluster._children[i].tail()
        assert sorted(cluster.live_indices()) == [0, 1]

        submit_pods(admin, 30, offset=30)
        assert wait_for(lambda: ledger.bound_total() >= 60), \
            f"only {ledger.bound_total()}/60 bound after the roll"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 60
        ledger.stop()

    def test_tpu_child_without_a_gpu_exits(self):
        """The child resolves its device before it connects: asked for
        CUDA without a GPU it ends with resolve_device's message, which
        sys.exit turns into exit status 1."""
        torch = pytest.importorskip("torch")
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is valid")
        with pytest.raises(SystemExit, match="no CUDA device is available"):
            procrun.main(["--child", "--server", "http://127.0.0.1:1",
                          "--backend", "tpu"])


class TestApiserverHandoff:
    def test_handoff_binds_and_rearms_the_ledger(self, proc_reaper,
                                                 tmp_path):
        cluster = ProcCluster(1, nodes=8, data_dir=str(tmp_path / "wal"))
        proc_reaper(cluster)
        cluster.start()
        admin = cluster.admin_client()
        fill_cluster(admin, 8)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 20)
        assert wait_for(lambda: ledger.bound_total() >= 20)
        before = ledger._watch

        cluster.handoff_apiserver()
        submit_pods(admin, 20, offset=20)
        assert wait_for(lambda: ledger.bound_total() >= 40), \
            f"only {ledger.bound_total()}/40 bound after the handoff"
        assert ledger._watch is not before and not ledger._watch.stopped
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 40
        pods, _ = admin.list(PODS)
        assert len(pods) == 40
        assert all(p["spec"].get("nodeName") for p in pods)
        ledger.stop()


class TestScaleOutBinaries:
    def test_two_binaries_with_scale_out_configs(self, proc_reaper,
                                                 tmp_path):
        """The scheduler binary (cmd/scheduler.py) as a scale-out pair:
        each reads a JSON --config whose scaleOut stanza names its index;
        both hold their own Lease, and a flood binds exactly once."""
        cluster = ProcCluster(0)
        proc_reaper(cluster)
        cluster.start()
        binaries = []
        for i in range(2):
            cfg = tmp_path / f"sched-{i}.json"
            cfg.write_text(json.dumps({
                "kind": "KubeSchedulerConfiguration",
                "scaleOut": {"instanceCount": 2, "instanceIndex": i,
                             "ringSlices": 64,
                             "leaseDurationSeconds": 1.5,
                             "renewIntervalSeconds": 0.25}}))
            p = chip_smoke.ChildLog(
                [sys.executable, "-u", "-m", "kubernetes_tpu_torch.cmd."
                 "scheduler", "--server", cluster.url,
                 f"--token={cluster.token}", "--config", str(cfg)],
                f"scheduler-{i}", ROOT)
            proc_reaper(p.proc)
            binaries.append(p)
        for p in binaries:
            p.wait_line(r"scheduler running", "its start", timeout=90)
        admin = cluster.admin_client()

        def leases():
            items, _ = admin.list("leases", "kube-system")
            return {lease["metadata"]["name"] for lease in items}
        # both instances hold their Lease before the flood (a loop that
        # ticks late would otherwise see its slices absorbed by the peer)
        assert wait_for(lambda: {"scheduler-instance-0",
                                 "scheduler-instance-1"} <= leases(),
                        timeout=60.0), leases()
        fill_cluster(admin, 16)
        ledger = WireBindLedger(admin)
        submit_pods(admin, 120)
        assert wait_for(lambda: ledger.bound_total() >= 120), \
            f"only {ledger.bound_total()}/120 bound"
        ledger.assert_no_double_binds()
        assert ledger.bound_total() == 120
        ledger.stop()
        for p in binaries:
            p.proc.terminate()
            assert p.proc.wait(timeout=20) == 0, p.lines[-20:]


class _FakeProc:
    stdout: list = []
    made: list = []

    def __init__(self, argv, **kw):
        self.argv, self.env = argv, kw.get("env")
        _FakeProc.made.append(self)

    def poll(self):
        return None


def test_argv_names_only_port_modules(monkeypatch):
    """No argv the supervisor builds starts a module of the JAX package,
    and no child environment carries JAX_PLATFORMS of the supervisor's
    making: the apiserver is kubernetes_tpu_torch.cmd.apiserver, a child
    kubernetes_tpu_torch.scheduler.procrun --child with --device when
    the cluster names one."""
    monkeypatch.setattr(_FakeProc, "made", [])
    monkeypatch.setattr(procrun.subprocess, "Popen", _FakeProc)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for backend, device in (("tpu", "cpu"), ("null", None),
                            ("none", None), ("sharded", "cuda")):
        cluster = ProcCluster(2, backend=backend, device=device,
                              warm_dir="/w", data_dir="/d")
        cluster.url, cluster.token, cluster._api_port = "http://x:1", "t", 1
        api = cluster.apiserver_argv()
        assert api[1:3] == ["-m", "kubernetes_tpu_torch.cmd.apiserver"]
        assert api[api.index("--data-dir") + 1] == "/d"
        for i in range(2):
            cluster._spawn(i)
        for fake in _FakeProc.made[-2:]:
            argv = fake.argv
            assert argv[1:4] == ["-m", "kubernetes_tpu_torch.scheduler."
                                 "procrun", "--child"]
            assert "JAX_PLATFORMS" not in fake.env
            assert argv[argv.index("--backend") + 1] == backend
            if device is None:
                assert "--device" not in argv
            else:
                assert argv[argv.index("--device") + 1] == device
        for argv in [api, *(f.argv for f in _FakeProc.made)]:
            assert not any(a.startswith("kubernetes_tpu.") for a in argv)
