"""Pod QoS classification.

Reference: pkg/apis/core/v1/helper/qos/qos.go GetPodQOS — Guaranteed when
every container has equal, non-empty requests and limits for cpu+memory;
BestEffort when no container has any request/limit; Burstable otherwise.
Eviction ranks BestEffort < Burstable < Guaranteed.

A copy of kubernetes_tpu/kubelet/qos.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

GUARANTEED = "Guaranteed"
BURSTABLE = "Burstable"
BEST_EFFORT = "BestEffort"

_QOS_RESOURCES = ("cpu", "memory")


def pod_qos(pod: dict) -> str:
    requests: dict = {}
    limits: dict = {}
    guaranteed = True
    containers = (pod.get("spec") or {}).get("containers") or []
    for c in containers:
        res = c.get("resources") or {}
        req = res.get("requests") or {}
        lim = res.get("limits") or {}
        for k in _QOS_RESOURCES:
            if k in req:
                requests[k] = True
            if k in lim:
                limits[k] = True
        # guaranteed requires limits for both resources on every container
        # and requests (if set) equal to limits
        for k in _QOS_RESOURCES:
            if k not in lim:
                guaranteed = False
            elif k in req and req[k] != lim[k]:
                guaranteed = False
    if not requests and not limits:
        return BEST_EFFORT
    if guaranteed and containers:
        return GUARANTEED
    return BURSTABLE


def eviction_rank(pod: dict) -> tuple:
    """Lower sorts first (evicted earlier): BestEffort, then Burstable,
    then Guaranteed; ties by priority then creation recency."""
    order = {BEST_EFFORT: 0, BURSTABLE: 1, GUARANTEED: 2}
    prio = (pod.get("spec") or {}).get("priority", 0)
    return (order[pod_qos(pod)], prio)
