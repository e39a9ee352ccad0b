"""NodeResourcesFit + NodeResourcesBalancedAllocation.

Reference: pkg/scheduler/framework/plugins/noderesources/
  fit.go:160 computePodResourceRequest (done in api/resources.py)
  fit.go:253-335 fitsRequest: pod count, CPU, memory, ephemeral storage and
    scalar resources checked against Allocatable - Requested
  least_allocated.go / most_allocated.go / requested_to_capacity_ratio.go
    score strategies
  balanced_allocation.go: std-dev of per-resource utilization

These are pure arithmetic over NodeInfo aggregates — exactly what the TPU
path turns into one broadcast compare / ratio matmul (ops/predicates.py).
"""

from __future__ import annotations

from ...api.resources import Resource
from ..framework import (
    MAX_NODE_SCORE, CycleState, FilterPlugin, PreFilterPlugin, PreFilterResult,
    ScorePlugin,
)
from ..types import (
    UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    ClusterEvent, NodeInfo, PodInfo, Status,
)

_STATE_KEY = "PreFilterNodeResourcesFit"

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"


def insufficient_resources(pod_info: PodInfo, node_info: NodeInfo) -> list[str]:
    """fitsRequest (fit.go:253): returns list of insufficient resource names."""
    out: list[str] = []
    if len(node_info.pods) + 1 > node_info.allocatable.allowed_pod_number:
        out.append("Too many pods")
    req = pod_info.request
    if (req.milli_cpu == 0 and req.memory == 0 and req.ephemeral_storage == 0
            and not req.scalar):
        return out
    alloc, used = node_info.allocatable, node_info.requested
    if req.milli_cpu > alloc.milli_cpu - used.milli_cpu:
        out.append("Insufficient cpu")
    if req.memory > alloc.memory - used.memory:
        out.append("Insufficient memory")
    if req.ephemeral_storage > alloc.ephemeral_storage - used.ephemeral_storage:
        out.append("Insufficient ephemeral-storage")
    for name, v in req.scalar.items():
        if v > alloc.scalar.get(name, 0) - used.scalar.get(name, 0):
            out.append(f"Insufficient {name}")
    return out


class NodeResourcesFit(PreFilterPlugin, FilterPlugin, ScorePlugin):
    name = "NodeResourcesFit"

    def __init__(self, strategy: str = LEAST_ALLOCATED,
                 resource_weights: dict[str, int] | None = None,
                 shape: list[tuple[float, float]] | None = None):
        self.strategy = strategy
        # utilization shape points for RequestedToCapacityRatio:
        # [(utilization 0..1, score 0..MAX)], linear interpolation
        self.shape = shape or [(0.0, 0.0), (1.0, float(MAX_NODE_SCORE))]
        self.resource_weights = resource_weights or {"cpu": 1, "memory": 1}

    def events_to_register(self):
        return [ClusterEvent("Pod", "Delete"), ClusterEvent("Node", "Add"),
                ClusterEvent("Node", "Update")]

    def pre_filter(self, state: CycleState, pod_info: PodInfo, snapshot):
        state.write(_STATE_KEY, pod_info.request)
        return None, None

    def filter(self, state: CycleState, pod_info: PodInfo,
               node_info: NodeInfo) -> Status | None:
        missing = insufficient_resources(pod_info, node_info)
        if missing:
            return Status(UNSCHEDULABLE, *missing)
        return None

    # -- scoring ---------------------------------------------------------

    def _utilizations(self, pod_info: PodInfo, node_info: NodeInfo) -> list[tuple[float, int]]:
        """[(requested_fraction, weight)] per resource, after placing the pod."""
        req = pod_info.request_nonzero
        alloc, used = node_info.allocatable, node_info.non_zero_requested
        out: list[tuple[float, int]] = []
        for rname, w in self.resource_weights.items():
            if rname == "cpu":
                want, have = used.milli_cpu + req.milli_cpu, alloc.milli_cpu
            elif rname == "memory":
                want, have = used.memory + req.memory, alloc.memory
            elif rname == "ephemeral-storage":
                want, have = (used.ephemeral_storage + req.ephemeral_storage,
                              alloc.ephemeral_storage)
            else:
                want = used.scalar.get(rname, 0) + req.scalar.get(rname, 0)
                have = alloc.scalar.get(rname, 0)
            out.append((min(want / have, 1.0) if have > 0 else 1.0, w))
        return out

    def score(self, state: CycleState, pod_info: PodInfo,
              node_info: NodeInfo) -> tuple[int, Status | None]:
        utils = self._utilizations(pod_info, node_info)
        total_w = sum(w for _, w in utils) or 1
        if self.strategy == LEAST_ALLOCATED:
            # least_allocated.go:29 — score = sum_r w_r * (1-util) * 100 / sum_w
            s = sum(w * (1.0 - u) * MAX_NODE_SCORE for u, w in utils) / total_w
        elif self.strategy == MOST_ALLOCATED:
            s = sum(w * u * MAX_NODE_SCORE for u, w in utils) / total_w
        else:  # RequestedToCapacityRatio: piecewise-linear shape per resource
            s = sum(w * self._shape_score(u) for u, w in utils) / total_w
        return int(s), None

    def _shape_score(self, util: float) -> float:
        pts = self.shape
        if util <= pts[0][0]:
            return pts[0][1]
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if util <= x1:
                if x1 == x0:
                    return y1
                return y0 + (y1 - y0) * (util - x0) / (x1 - x0)
        return pts[-1][1]


class NodeResourcesBalancedAllocation(ScorePlugin):
    """balanced_allocation.go — favors nodes where per-resource utilization
    is balanced: score = (1 - std(utilizations)) * 100."""

    name = "NodeResourcesBalancedAllocation"

    def __init__(self, resources: list[str] | None = None):
        self.resources = resources or ["cpu", "memory"]

    def score(self, state: CycleState, pod_info: PodInfo,
              node_info: NodeInfo) -> tuple[int, Status | None]:
        req = pod_info.request_nonzero
        alloc, used = node_info.allocatable, node_info.non_zero_requested
        utils: list[float] = []
        for rname in self.resources:
            if rname == "cpu":
                want, have = used.milli_cpu + req.milli_cpu, alloc.milli_cpu
            elif rname == "memory":
                want, have = used.memory + req.memory, alloc.memory
            else:
                want = used.scalar.get(rname, 0) + req.scalar.get(rname, 0)
                have = alloc.scalar.get(rname, 0)
            utils.append(min(want / have, 1.0) if have > 0 else 1.0)
        mean = sum(utils) / len(utils)
        var = sum((u - mean) ** 2 for u in utils) / len(utils)
        return int((1.0 - var ** 0.5) * MAX_NODE_SCORE), None
