"""scheduler_perf harness (reference: test/integration/scheduler_perf).

The workload definitions are the JAX package's performance-config.yaml,
converted once to JSON (config/performance-config.json): the port reads
them with the standard library, so nothing on its path needs PyYAML."""

import json
import os

from .scheduler_perf import (  # noqa: F401
    PerfCluster, ThroughputCollector, ThroughputSummary, run_named_workload,
    run_workload, setup_cluster, wait_for_pods_scheduled,
)

_CONFIG = os.path.join(os.path.dirname(__file__), "config",
                       "performance-config.json")


def load_workloads(path: str | None = None) -> dict[str, dict]:
    with open(path or _CONFIG) as f:
        entries = json.load(f)
    return {e["name"]: e for e in entries}


def caps_for_nodes(n_nodes: int):
    """THE bench cap policy: node capacity rounded up to a 256 multiple
    with ~10% headroom; c_cap=2 because every tracked workload carries <=1
    constraint per pod and each constraint slot costs [P,P] conflict work
    per wave in the full kernel — pods with more constraints escape to the
    per-pod oracle."""
    from ..ops.flatten import Caps
    n_cap = max(1024, -(-int(n_nodes * 1.1) // 256) * 256)
    return Caps(n_cap=n_cap, l_cap=256, kl_cap=62, t_cap=16, pt_cap=16,
                s_cap=3, sg_cap=16, asg_cap=16, c_cap=2, ns_cap=256)
