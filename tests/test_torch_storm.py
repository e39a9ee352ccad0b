"""The churn-storm chaos tier on the port: the shrunk SchedulingChurnStorm
workload end to end through the port's harness (store, informers, queue,
Scheduler, TorchBatchBackend on the CPU at depth 2, binder) with the
default overload policy, as tests/test_churn_storm.py's
TestChurnStormE2E::test_shrunk_storm_depth2 runs the JAX package.

The nodeStorm opcode drives the port's NodeStormDriver (seeded node adds,
drains and relabels through the store while the pod flood is in flight);
the port's store-watch bind ledger (perf/bench.py BindLedger) asserts
the same invariants: exactly-once binds
(a pod's nodeName never moves), no lost pod (the closing barrier sees
every flood pod bound), no system- or high-band shed, bounded engagement
transitions, and storm actions of every kind that reached the backend's
tensor maintenance.  The storm's decisions are the JAX package's for the
same seed (tests/test_torch_faults.py).
"""

from __future__ import annotations

import pytest

pytest.importorskip("jax")

from test_churn_storm import (  # noqa: E402
    _assert_invariants, _shrunk_storm,
)
from kubernetes_tpu_torch.perf import (  # noqa: E402
    caps_for_nodes, load_workloads,
)
from kubernetes_tpu_torch.perf.scheduler_perf import (  # noqa: E402
    ThroughputCollector, run_workload, setup_cluster,
)
from kubernetes_tpu_torch.perf.bench import BindLedger  # noqa: E402
from kubernetes_tpu_torch.scheduler.config import OverloadPolicy  # noqa: E402,E501

pytestmark = pytest.mark.storm


def run_port_storm(nodes: int, pods: int, timeout: float = 180.0):
    """test_churn_storm._run_storm on the port: the shrunk storm on the
    depth-2 pipelined TorchBatchBackend (CPU) with the default overload
    policy, a bind ledger on the store; returns the stats and the
    ledger."""
    cfg = _shrunk_storm(nodes, pods, timeout)
    # the same JSON workload in both packages (test_torch_perf.py)
    assert [op["opcode"] for op in cfg["workloadTemplate"]] == [
        op["opcode"] for op in
        load_workloads()["SchedulingChurnStorm"]["workloadTemplate"]]
    cluster = setup_cluster(caps=caps_for_nodes(nodes + 64), batch_size=64,
                            pipeline_depth=2, overload=OverloadPolicy(),
                            device="cpu")
    ledger = BindLedger(cluster.store)
    collector = ThroughputCollector(cluster.store)
    try:
        stats = run_workload(cluster, cfg["workloadTemplate"], collector)
        collector.stop()
        ledger.drain()
        sched = cluster.scheduler
        sched.expose_metrics()
        prom = sched.metrics.prom
        stats["sheds"] = dict(prom.queue_shed_total.values())
        stats["transitions"] = dict(prom.overload_transition_total.values())
        stats["engagement"] = sched.overload_engagement
        backend = sched.profiles["default-scheduler"].batch_backend
        stats["backend_stats"] = dict(backend.stats)
        stats["tensor_maintenance"] = backend.maintenance_snapshot()
        return stats, ledger
    finally:
        ledger.stop()
        cluster.shutdown()


class TestPortChurnStormE2E:
    def test_shrunk_storm_depth2(self):
        stats, ledger = run_port_storm(nodes=24, pods=600)
        _assert_invariants(stats, ledger, 600)
        # the storm's node events reached the resident tensors
        assert stats["tensor_maintenance"]["event_patches"] > 0
        assert stats["backend_stats"]["batches"] > 0
