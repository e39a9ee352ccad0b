"""The scheduler_perf workloads end to end through the port's Scheduler at
toy scale, on the device path: a TorchBatchBackend(device="cpu") profile
behind the real store -> informers -> queue -> scheduler -> bind
pipeline.

Counts are shrunk as tests/test_perf_workloads.py shrinks them (that file
runs the JAX package's per-pod oracle on the same definitions).  Every
workload must pass its barriers and report escape_rate == 0.0: the
tensor path encodes every pod of these workloads, so none falls back to
the per-pod plugins.  PreemptionBasic and PreemptionDense go through the
port's batched preemption (Scheduler._batch_preempt ->
TorchBatchBackend.preempt_batch): every high-priority pod must bind, and
a preemption attempt must be counted.
"""

from __future__ import annotations

import copy

import pytest

from kubernetes_tpu_torch.api import meta
from kubernetes_tpu_torch.client.clientset import PODS
from kubernetes_tpu_torch.ops.flatten import Caps
from kubernetes_tpu_torch.perf import load_workloads, run_named_workload
from kubernetes_tpu_torch.store import kv

CAPS = Caps(n_cap=64, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8, s_cap=2,
            sg_cap=8, asg_cap=8, c_cap=2, ns_cap=256)

# (workload, node_shrink, pod_shrink), as in tests/test_perf_workloads.py
CASES = [
    ("SchedulingSecrets", 100, 100),
    ("SchedulingPodAffinity", 100, 100),
    ("SchedulingPreferredPodAffinity", 100, 100),
    ("SchedulingPreferredPodAntiAffinity", 100, 100),
    ("SchedulingNodeAffinity", 100, 100),
    ("PreferredTopologySpreading", 100, 100),
    ("MixedSchedulingBasePod", 100, 100),
    ("Unschedulable", 100, 100),
    ("SchedulingWithMixedChurn", 100, 100),
    ("SchedulingRequiredPodAntiAffinityWithNSSelector", 100, 100),
    ("SchedulingPreferredAffinityWithNSSelector", 100, 100),
    ("SchedulingNSSelectorDense", 100, 100),
    ("TopologySpreading", 20, 100),
    ("SchedulingPodAntiAffinity", 100, 100),
    ("PreemptionBasic", 25, 25),
    ("PreemptionDense", 25, 25),
    ("CoschedulingGang", 100, 100),
    ("SchedulingHighCardinality", 100, 100),
    ("SchedulingPreferredAntiAffinityWithNSSelector", 100, 100),
    ("SchedulingRequiredPodAffinityWithNSSelector", 100, 100),
]


def shrink(cfg: dict, node_div: int, pod_div: int) -> dict:
    cfg = copy.deepcopy(cfg)
    for op in cfg["workloadTemplate"]:
        if op["opcode"] == "createNodes":
            op["count"] = max(2, op["count"] // node_div)
        elif op["opcode"] == "createPods":
            op["count"] = max(4, op["count"] // pod_div)
        elif op["opcode"] == "barrier":
            op["timeout"] = 120.0
        elif op["opcode"] == "churn":
            op["intervalMilliseconds"] = 100
    return cfg


@pytest.mark.parametrize("name,ndiv,pdiv", CASES, ids=[c[0] for c in CASES])
def test_workload_completes_on_the_device_path(name, ndiv, pdiv):
    cfg = shrink(load_workloads()[name], ndiv, pdiv)
    store = kv.MemoryStore()
    _summary, stats = run_named_workload(cfg, caps=CAPS, batch_size=64,
                                         pipeline_depth=2, device="cpu",
                                         store=store)
    assert stats.get("barrier_ok"), stats
    assert stats["backend_stats"]["pods"] > 0, stats
    assert stats["schedule_attempts"]["error"] == 0, stats
    assert stats["escape_rate"] == 0.0, stats
    if name == "Unschedulable":
        # the skipWaitToCompletion pods stay parked, every other pod binds
        pods, _ = store.list(PODS)
        unbound = sum(1 for p in pods if not meta.pod_node_name(p))
        parked = next(op["count"] for op in cfg["workloadTemplate"]
                      if op.get("skipWaitToCompletion"))
        assert unbound == parked
    if name.startswith("Preemption"):
        pods, _ = store.list(PODS)
        high = [p for p in pods if (p["spec"].get("priority") or 0) > 0]
        want = next(op["count"] for op in cfg["workloadTemplate"]
                    if op.get("collectMetrics"))
        assert len(high) == want
        assert all(meta.pod_node_name(p) for p in high)
        assert stats["preemption_attempts"] > 0, stats
