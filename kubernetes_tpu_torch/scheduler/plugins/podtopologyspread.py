"""PodTopologySpread plugin.

Reference: pkg/scheduler/framework/plugins/podtopologyspread/
  filtering.go:40-51  preFilterState: per-constraint TpPairToMatchNum +
    per-topology-key minimum match (the "critical paths" 2-min trick at
    :109-118 lets AddPod/RemovePod updates avoid full rescans; we keep the
    plain min and recompute on mutation — same semantics, simpler)
  filtering.go:238 calPreFilterState; :334 Filter:
    matchNum + selfMatch - minMatch  must be <= maxSkew
  scoring.go:195 Score + :231 NormalizeScore for ScheduleAnyway constraints

On the TPU path these per-(key,value) match counts are segment-sums over the
node axis (ops/predicates.py topology_spread_*).
"""

from __future__ import annotations

from ...api import meta
from ...api.labels import Selector, selector_from_dict
from ..framework import (
    MAX_NODE_SCORE, CycleState, FilterPlugin, PreFilterPlugin, PreScorePlugin,
    ScorePlugin,
)
from ..types import (
    SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    ClusterEvent, NodeInfo, PodInfo, Status, node_selector_terms_match,
)

_STATE_KEY = "PreFilterPodTopologySpread"
_SCORE_STATE_KEY = "PreScorePodTopologySpread"

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


class _Constraint:
    __slots__ = ("max_skew", "topology_key", "when_unsatisfiable", "selector",
                 "min_domains")

    def __init__(self, c: dict, default_ns: str):
        self.max_skew = c.get("maxSkew", 1)
        self.topology_key = c["topologyKey"]
        self.when_unsatisfiable = c.get("whenUnsatisfiable", DO_NOT_SCHEDULE)
        self.selector = selector_from_dict(c.get("labelSelector"))
        self.min_domains = c.get("minDomains")


def _compile(pod_info: PodInfo, action: str) -> list[_Constraint]:
    ns = meta.namespace(pod_info.pod)
    return [_Constraint(c, ns) for c in pod_info.topology_spread_constraints
            if c.get("whenUnsatisfiable", DO_NOT_SCHEDULE) == action]


def _node_matches_pod_node_affinity(pod_info: PodInfo, node) -> bool:
    """Spread counts only nodes the pod could land on per nodeSelector/affinity
    (filtering.go:261 nodeLabelsMatchSpreadConstraints precondition)."""
    labels = meta.labels(node)
    for k, v in pod_info.node_selector.items():
        if labels.get(k) != v:
            return False
    return node_selector_terms_match(pod_info.node_affinity_required, node)


class _PreFilterState:
    __slots__ = ("constraints", "tp_pair_to_match_num", "tp_key_min_match")

    def __init__(self) -> None:
        self.constraints: list[_Constraint] = []
        # (topologyKey, value) -> count of matching pods in that domain
        self.tp_pair_to_match_num: dict[tuple[str, str], int] = {}
        # topologyKey -> min match count across domains
        self.tp_key_min_match: dict[str, int] = {}


def _cal_state(pod_info: PodInfo, nodes: list[NodeInfo],
               constraints: list[_Constraint]) -> _PreFilterState:
    st = _PreFilterState()
    st.constraints = constraints
    ns = meta.namespace(pod_info.pod)
    for c in constraints:
        domains: dict[str, int] = {}
        for ni in nodes:
            node = ni.node
            if node is None:
                continue
            labels = meta.labels(node)
            if c.topology_key not in labels:
                continue
            if not _node_matches_pod_node_affinity(pod_info, node):
                continue
            val = labels[c.topology_key]
            count = domains.get(val, 0)
            for pi in ni.pods:
                if (meta.namespace(pi.pod) == ns and not meta.deletion_timestamp(pi.pod)
                        and c.selector.matches(pi.labels)):
                    count += 1
            domains[val] = count
        for val, count in domains.items():
            st.tp_pair_to_match_num[(c.topology_key, val)] = count
        if domains:
            st.tp_key_min_match[c.topology_key] = min(domains.values())
    return st


class PodTopologySpread(PreFilterPlugin, FilterPlugin, PreScorePlugin, ScorePlugin):
    name = "PodTopologySpread"

    def events_to_register(self):
        return [ClusterEvent("Pod", "*"), ClusterEvent("Node", "Add"),
                ClusterEvent("Node", "Update")]

    # -- filtering -------------------------------------------------------

    def pre_filter(self, state: CycleState, pod_info: PodInfo, snapshot):
        constraints = _compile(pod_info, DO_NOT_SCHEDULE)
        if not constraints:
            return None, Status(SKIP)
        st = _cal_state(pod_info, snapshot.list(), constraints)
        state.write(_STATE_KEY, st)
        return None, None

    def add_pod(self, state, pod_info, to_add: PodInfo, node_info: NodeInfo):
        self._update(state, pod_info, to_add, node_info, +1)
        return None

    def remove_pod(self, state, pod_info, to_remove: PodInfo, node_info: NodeInfo):
        self._update(state, pod_info, to_remove, node_info, -1)
        return None

    def _update(self, state, pod_info, other: PodInfo, node_info: NodeInfo,
                delta: int) -> None:
        st: _PreFilterState | None = state.read(_STATE_KEY)
        if st is None or node_info.node is None:
            return
        ns = meta.namespace(pod_info.pod)
        if meta.namespace(other.pod) != ns:
            return
        labels = meta.labels(node_info.node)
        for c in st.constraints:
            val = labels.get(c.topology_key)
            if val is None or not c.selector.matches(other.labels):
                continue
            pair = (c.topology_key, val)
            st.tp_pair_to_match_num[pair] = st.tp_pair_to_match_num.get(pair, 0) + delta
            # recompute min for the key (reference keeps 2 critical paths;
            # recompute is O(domains) and semantically identical)
            vals = [v for (k, _), v in st.tp_pair_to_match_num.items()
                    if k == c.topology_key]
            if vals:
                st.tp_key_min_match[c.topology_key] = min(vals)

    def filter(self, state: CycleState, pod_info: PodInfo,
               node_info: NodeInfo) -> Status | None:
        st: _PreFilterState | None = state.read(_STATE_KEY)
        if st is None:
            return None
        node = node_info.node
        labels = meta.labels(node)
        for c in st.constraints:
            val = labels.get(c.topology_key)
            if val is None:
                return Status(UNSCHEDULABLE_AND_UNRESOLVABLE,
                              "node(s) didn't match pod topology spread constraints "
                              "(missing required label)")
            self_match = 1 if c.selector.matches(pod_info.labels) else 0
            match_num = st.tp_pair_to_match_num.get((c.topology_key, val), 0)
            min_match = st.tp_key_min_match.get(c.topology_key, 0)
            if match_num + self_match - min_match > c.max_skew:
                return Status(UNSCHEDULABLE,
                              "node(s) didn't match pod topology spread constraints")
        return None

    # -- scoring (scoring.go) -------------------------------------------

    def pre_score(self, state: CycleState, pod_info: PodInfo, nodes):
        constraints = _compile(pod_info, SCHEDULE_ANYWAY)
        if not constraints:
            return Status(SKIP)
        st = _cal_state(pod_info, nodes, constraints)
        state.write(_SCORE_STATE_KEY, st)
        return None

    def score(self, state: CycleState, pod_info: PodInfo,
              node_info: NodeInfo) -> tuple[int, Status | None]:
        st: _PreFilterState | None = state.read(_SCORE_STATE_KEY)
        if st is None:
            return 0, None
        labels = meta.labels(node_info.node)
        total = 0
        for c in st.constraints:
            val = labels.get(c.topology_key)
            if val is None:
                continue
            total += st.tp_pair_to_match_num.get((c.topology_key, val), 0)
        return total, None

    def normalize_scores(self, state, pod_info, scores):
        # scoring.go:231 — fewer matching pods in the node's domains = better
        if not scores:
            return None
        mx, mn = max(scores.values()), min(scores.values())
        spread = mx - mn
        for k in scores:
            scores[k] = (MAX_NODE_SCORE * (mx - scores[k]) // spread
                         if spread else MAX_NODE_SCORE)
        return None
