"""Simple per-node plugins: NodeName, NodePorts, NodeUnschedulable,
NodeAffinity, TaintToleration, ImageLocality.

Reference: pkg/scheduler/framework/plugins/{nodename,nodeports,
nodeunschedulable,nodeaffinity,tainttoleration,imagelocality}/
"""

from __future__ import annotations

from ...api import meta
from ..framework import (
    MAX_NODE_SCORE, CycleState, FilterPlugin, PreFilterPlugin, PreFilterResult,
    PreScorePlugin, ScorePlugin,
)
from ..types import (
    SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    ClusterEvent, NodeInfo, PodInfo, Status, node_selector_terms_match,
)


class NodeName(FilterPlugin):
    """nodename/node_name.go — .spec.nodeName must equal the node, if set."""

    name = "NodeName"

    def filter(self, state, pod_info, node_info):
        want = (pod_info.pod.get("spec") or {}).get("nodeName")
        if want and want != node_info.name:
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE, "node didn't match Spec.NodeName")
        return None


class NodePorts(PreFilterPlugin, FilterPlugin):
    """nodeports/node_ports.go — requested host ports must be free."""

    name = "NodePorts"

    def pre_filter(self, state, pod_info, snapshot):
        if not pod_info.host_ports:
            return None, Status(SKIP)
        return None, None

    def filter(self, state, pod_info, node_info):
        for proto, ip, port in pod_info.host_ports:
            for uproto, uip, uport in node_info.used_ports:
                if port == uport and proto == uproto and (
                        ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip):
                    return Status(UNSCHEDULABLE, "node(s) didn't have free ports")
        return None


class NodeUnschedulable(FilterPlugin):
    """nodeunschedulable/node_unschedulable.go — .spec.unschedulable nodes
    only admit pods tolerating the unschedulable taint."""

    name = "NodeUnschedulable"

    def filter(self, state, pod_info, node_info):
        node = node_info.node
        if node and (node.get("spec") or {}).get("unschedulable"):
            tolerated = any(
                t.get("key") == "node.kubernetes.io/unschedulable"
                and t.get("effect") in (None, "", "NoSchedule")
                for t in pod_info.tolerations)
            if not tolerated:
                return Status(UNSCHEDULABLE_AND_UNRESOLVABLE,
                              "node(s) were unschedulable")
        return None


class NodeAffinity(FilterPlugin, PreScorePlugin, ScorePlugin):
    """nodeaffinity/node_affinity.go — nodeSelector + node affinity terms.

    Filter: .spec.nodeSelector labels must all match AND required node
    affinity terms (OR over terms) must match.
    Score: sum of weights of matching preferred terms, normalized.
    """

    name = "NodeAffinity"

    def events_to_register(self):
        return [ClusterEvent("Node", "Add"), ClusterEvent("Node", "Update")]

    def filter(self, state, pod_info, node_info):
        node = node_info.node
        labels = meta.labels(node)
        for k, v in pod_info.node_selector.items():
            if labels.get(k) != v:
                return Status(UNSCHEDULABLE_AND_UNRESOLVABLE,
                              "node(s) didn't match Pod's node affinity/selector")
        if not node_selector_terms_match(pod_info.node_affinity_required, node):
            return Status(UNSCHEDULABLE_AND_UNRESOLVABLE,
                          "node(s) didn't match Pod's node affinity/selector")
        return None

    def pre_score(self, state, pod_info, nodes):
        if not pod_info.node_affinity_preferred:
            return Status(SKIP)
        return None

    def score(self, state, pod_info, node_info):
        total = 0
        for weight, (lab, fields) in pod_info.node_affinity_preferred:
            node_labels = meta.labels(node_info.node)
            node_fields = {"metadata.name": node_info.name}
            if lab.matches(node_labels) and fields.matches(node_fields):
                total += weight
        return total, None

    def normalize_scores(self, state, pod_info, scores):
        mx = max(scores.values(), default=0)
        if mx > 0:
            for k in scores:
                scores[k] = scores[k] * MAX_NODE_SCORE // mx
        return None


def toleration_tolerates_taint(tol: dict, taint: dict) -> bool:
    """v1 helper ToleratesTaint (apimachinery/../v1/toleration.go)."""
    if tol.get("effect") and tol["effect"] != taint.get("effect"):
        return False
    if tol.get("key") and tol["key"] != taint.get("key"):
        return False
    op = tol.get("operator", "Equal")
    if op == "Exists":
        return True
    return tol.get("value", "") == taint.get("value", "")


def find_untolerated_taint(taints: list[dict], tolerations: list[dict],
                           effects: tuple[str, ...]) -> dict | None:
    for taint in taints:
        if taint.get("effect") not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
            return taint
    return None


class TaintToleration(FilterPlugin, PreScorePlugin, ScorePlugin):
    """tainttoleration/taint_toleration.go — Filter on NoSchedule/NoExecute;
    Score counts intolerable PreferNoSchedule taints (fewer = better)."""

    name = "TaintToleration"

    def events_to_register(self):
        return [ClusterEvent("Node", "Add"), ClusterEvent("Node", "Update")]

    def filter(self, state, pod_info, node_info):
        taints = (node_info.node.get("spec") or {}).get("taints") or []
        taint = find_untolerated_taint(taints, pod_info.tolerations,
                                       ("NoSchedule", "NoExecute"))
        if taint is not None:
            return Status(
                UNSCHEDULABLE_AND_UNRESOLVABLE,
                f"node(s) had untolerated taint {{{taint.get('key')}: "
                f"{taint.get('value', '')}}}")
        return None

    def pre_score(self, state, pod_info, nodes):
        return None

    def score(self, state, pod_info, node_info):
        taints = (node_info.node.get("spec") or {}).get("taints") or []
        count = sum(
            1 for t in taints
            if t.get("effect") == "PreferNoSchedule"
            and not any(toleration_tolerates_taint(tol, t)
                        for tol in pod_info.tolerations))
        return count, None

    def normalize_scores(self, state, pod_info, scores):
        # fewer intolerable taints -> higher score (reverse + scale)
        mx = max(scores.values(), default=0)
        for k in scores:
            scores[k] = ((mx - scores[k]) * MAX_NODE_SCORE // mx) if mx else MAX_NODE_SCORE
        return None


# imagelocality/image_locality.go thresholds
_MIN_THRESHOLD = 23 * 1024 * 1024
_MAX_CONTAINER_THRESHOLD = 1024 * 1024 * 1024


class ImageLocality(ScorePlugin):
    """imagelocality/image_locality.go — prefer nodes that already have the
    pod's images, scaled by how widely each image is spread."""

    name = "ImageLocality"

    def __init__(self, total_nodes_getter=None):
        self._total_nodes = total_nodes_getter or (lambda: 1)

    def score(self, state, pod_info, node_info):
        containers = (pod_info.pod.get("spec") or {}).get("containers") or []
        if not containers:
            return 0, None
        total_nodes = max(self._total_nodes(), 1)
        sum_scores = 0.0
        for c in containers:
            img = c.get("image", "")
            size = node_info.image_sizes.get(img, 0)
            if size:
                # spread factor omitted node-count bookkeeping: approximate 1
                sum_scores += size
        max_threshold = _MAX_CONTAINER_THRESHOLD * len(containers)
        if sum_scores < _MIN_THRESHOLD:
            return 0, None
        score = int((min(sum_scores, max_threshold) - _MIN_THRESHOLD) * MAX_NODE_SCORE
                    / (max_threshold - _MIN_THRESHOLD))
        return score, None
