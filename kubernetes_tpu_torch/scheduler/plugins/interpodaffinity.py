"""InterPodAffinity plugin.

Reference: pkg/scheduler/framework/plugins/interpodaffinity/
  filtering.go:90-150  preFilterState: three (topologyKey,value)->count maps
    - existing_anti: counts of existing pods whose REQUIRED anti-affinity
      terms match the incoming pod (scanned from
      nodeInfo.pods_with_required_anti_affinity, :155)
    - affinity: counts of existing pods matching each of the incoming pod's
      required affinity terms (:187)
    - anti_affinity: counts of existing pods matching the incoming pod's
      required anti-affinity terms
  filtering.go:367 Filter — a node passes iff
    (1) no existing pod's anti-affinity matches the incoming pod in the
        node's topology domains,
    (2) every incoming affinity term has a match in the node's domain (with
        the self-match bootstrap exception, :439), and
    (3) no incoming anti-affinity term has a match in the node's domain.
  scoring.go:232 Score (weighted preferred-term matches, both directions),
  :254 NormalizeScore (shift negatives, scale to 0..100).

On the TPU path these become label-match boolean matrices x topology one-hot
segment sums (ops/predicates.py interpod_*).
"""

from __future__ import annotations

from ...api import meta
from ..framework import (
    MAX_NODE_SCORE, CycleState, FilterPlugin, PreFilterPlugin, PreScorePlugin,
    ScorePlugin,
)
from ..types import (
    SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    AffinityTerm, ClusterEvent, NodeInfo, PodInfo, Status,
)

_STATE_KEY = "PreFilterInterPodAffinity"
_SCORE_STATE_KEY = "PreScoreInterPodAffinity"

TPCounts = dict[tuple[str, str], int]


class _PreFilterState:
    __slots__ = ("existing_anti", "affinity_counts", "anti_affinity_counts",
                 "pod_info", "ns_labels", "anti_keys")

    def __init__(self) -> None:
        self.existing_anti: TPCounts = {}
        # one count-map per required affinity term of the incoming pod
        self.affinity_counts: list[TPCounts] = []
        self.anti_affinity_counts: TPCounts = {}
        self.pod_info: PodInfo | None = None
        self.ns_labels: dict | None = None
        # distinct topology KEYS present in existing_anti: Filter does
        # one node-label lookup per KEY + one dict get, instead of
        # scanning every (key,value) entry per node — with hostname
        # anti-affinity the map holds one entry PER NODE and the scan
        # made Filter O(nodes) per node (measured: the NSSelector
        # workload spent its entire wall in that loop)
        self.anti_keys: tuple = ()


def _topo(node, key: str) -> str | None:
    return meta.labels(node).get(key)


def _count_existing_anti(pod_info: PodInfo, nodes: list[NodeInfo],
                         ns_labels=None) -> TPCounts:
    """getExistingAntiAffinityCounts (:155): existing pods whose required
    anti-affinity matches the incoming pod, keyed by their node's topology."""
    counts: TPCounts = {}
    for ni in nodes:
        if ni.node is None:
            continue
        for pi in ni.pods_with_required_anti_affinity:
            for term in pi.required_anti_affinity_terms:
                val = _topo(ni.node, term.topology_key)
                if val is None:
                    continue
                if term.matches(pod_info.pod, pod_info.labels, ns_labels):
                    counts[(term.topology_key, val)] = \
                        counts.get((term.topology_key, val), 0) + 1
    return counts


def _count_incoming(pod_info: PodInfo, nodes: list[NodeInfo],
                    ns_labels=None) -> tuple[list[TPCounts], TPCounts]:
    """getIncomingAffinityAntiAffinityCounts (:187)."""
    affinity = [dict() for _ in pod_info.required_affinity_terms]
    anti: TPCounts = {}
    if not pod_info.required_affinity_terms and not pod_info.required_anti_affinity_terms:
        return affinity, anti
    for ni in nodes:
        if ni.node is None:
            continue
        for pi in ni.pods:
            for i, term in enumerate(pod_info.required_affinity_terms):
                if term.matches(pi.pod, pi.labels, ns_labels):
                    val = _topo(ni.node, term.topology_key)
                    if val is not None:
                        affinity[i][(term.topology_key, val)] = \
                            affinity[i].get((term.topology_key, val), 0) + 1
            for term in pod_info.required_anti_affinity_terms:
                if term.matches(pi.pod, pi.labels, ns_labels):
                    val = _topo(ni.node, term.topology_key)
                    if val is not None:
                        anti[(term.topology_key, val)] = \
                            anti.get((term.topology_key, val), 0) + 1
    return affinity, anti


class InterPodAffinity(PreFilterPlugin, FilterPlugin, PreScorePlugin, ScorePlugin):
    name = "InterPodAffinity"

    def __init__(self, handle=None):
        self._handle = handle

    def _ns_labels(self) -> dict | None:
        """A FRESH namespace-label snapshot (reference:
        GetNamespaceLabelsSnapshot per scheduling cycle — a TTL cache
        was tried and could resolve a just-relabeled namespace stale,
        letting a binding violate required anti-affinity; the store
        list is a cheap local read)."""
        if self._handle is None or self._handle.client is None:
            return None
        try:
            items, _rv = self._handle.client.list("namespaces", None)
        except Exception:  # noqa: BLE001 - no namespace store
            return None
        return {meta.name(o): (o["metadata"].get("labels") or {})
                for o in items}

    @staticmethod
    def _any_ns_selector(pod_info: PodInfo, nodes,
                         scoring: bool = False) -> bool:
        """Does anything in this cycle need namespace resolution?  O(1)
        per pod via the precomputed PodInfo flag; the node scan checks
        one bool per anti pod (and, for scoring, per affinity-carrying
        pod — existing pods' PREFERRED ns-selector terms score too)."""
        if pod_info.has_ns_selector_terms:
            return True
        if any(pi.has_ns_selector_terms
               for ni in nodes
               for pi in ni.pods_with_required_anti_affinity):
            return True
        if scoring:
            return any(pi.has_ns_selector_terms
                       for ni in nodes
                       for pi in ni.pods_with_affinity)
        return False

    def events_to_register(self):
        return [ClusterEvent("Pod", "*"), ClusterEvent("AssignedPod", "*"),
                ClusterEvent("Node", "Add"), ClusterEvent("Node", "Update")]

    # -- filtering -------------------------------------------------------

    def pre_filter(self, state: CycleState, pod_info: PodInfo, snapshot):
        st = _PreFilterState()
        st.pod_info = pod_info
        have_anti_nodes = snapshot.have_pods_with_required_anti_affinity_list
        ns_labels = (self._ns_labels()
                     if self._any_ns_selector(pod_info, have_anti_nodes)
                     else None)
        st.ns_labels = ns_labels
        st.existing_anti = _count_existing_anti(pod_info, have_anti_nodes,
                                                ns_labels)
        st.anti_keys = tuple({k for (k, _v) in st.existing_anti})
        if pod_info.required_affinity_terms or pod_info.required_anti_affinity_terms:
            # reference scans allNodes here (filtering.go:187) — the incoming
            # pod's terms match against every existing pod, affine or not
            st.affinity_counts, st.anti_affinity_counts = _count_incoming(
                pod_info, snapshot.list(), ns_labels)
        if (not st.existing_anti and not pod_info.required_affinity_terms
                and not pod_info.required_anti_affinity_terms):
            return None, Status(SKIP)
        state.write(_STATE_KEY, st)
        return None, None

    def add_pod(self, state, pod_info, to_add: PodInfo, node_info: NodeInfo):
        self._update(state, pod_info, to_add, node_info, +1)
        return None

    def remove_pod(self, state, pod_info, to_remove: PodInfo, node_info: NodeInfo):
        self._update(state, pod_info, to_remove, node_info, -1)
        return None

    def _update(self, state, pod_info: PodInfo, other: PodInfo,
                node_info: NodeInfo, delta: int) -> None:
        st: _PreFilterState | None = state.read(_STATE_KEY)
        if st is None or node_info.node is None:
            return
        node = node_info.node
        ns_labels = st.ns_labels
        for term in other.required_anti_affinity_terms:
            if term.matches(pod_info.pod, pod_info.labels, ns_labels):
                val = _topo(node, term.topology_key)
                if val is not None:
                    k = (term.topology_key, val)
                    st.existing_anti[k] = st.existing_anti.get(k, 0) + delta
                    if term.topology_key not in st.anti_keys:
                        st.anti_keys = st.anti_keys + (term.topology_key,)
        for i, term in enumerate(pod_info.required_affinity_terms):
            if term.matches(other.pod, other.labels, ns_labels):
                val = _topo(node, term.topology_key)
                if val is not None:
                    k = (term.topology_key, val)
                    st.affinity_counts[i][k] = st.affinity_counts[i].get(k, 0) + delta
        for term in pod_info.required_anti_affinity_terms:
            if term.matches(other.pod, other.labels, ns_labels):
                val = _topo(node, term.topology_key)
                if val is not None:
                    k = (term.topology_key, val)
                    st.anti_affinity_counts[k] = st.anti_affinity_counts.get(k, 0) + delta

    def filter(self, state: CycleState, pod_info: PodInfo,
               node_info: NodeInfo) -> Status | None:
        st: _PreFilterState | None = state.read(_STATE_KEY)
        if st is None:
            return None
        node = node_info.node

        # (1) existing pods' required anti-affinity must not match incoming
        # — one lookup per distinct topology key (filtering.go:367 indexes
        # by topologyPair the same way)
        for key in st.anti_keys:
            val = _topo(node, key)
            if val is not None and st.existing_anti.get((key, val), 0) > 0:
                return Status(UNSCHEDULABLE,
                              "node(s) had pods with anti-affinity rules "
                              "matching the incoming pod")

        # (3) incoming pod's anti-affinity must find no match in node's domains
        for term in pod_info.required_anti_affinity_terms:
            val = _topo(node, term.topology_key)
            if val is not None and st.anti_affinity_counts.get(
                    (term.topology_key, val), 0) > 0:
                return Status(UNSCHEDULABLE,
                              "node(s) didn't satisfy pod anti-affinity rules")

        # (2) every incoming affinity term must match in node's domain
        if pod_info.required_affinity_terms:
            all_match = True
            for i, term in enumerate(pod_info.required_affinity_terms):
                val = _topo(node, term.topology_key)
                if val is None or st.affinity_counts[i].get(
                        (term.topology_key, val), 0) <= 0:
                    all_match = False
                    break
            if not all_match:
                # bootstrap exception (filtering.go:439): if NO pod anywhere
                # matches any term but the pod matches its own terms, allow it
                # so the first pod of a self-affine group can schedule.
                cluster_empty = all(
                    sum(c.values()) == 0 for c in st.affinity_counts)
                self_match = all(
                    term.matches(pod_info.pod, pod_info.labels,
                                 st.ns_labels)
                    for term in pod_info.required_affinity_terms)
                if not (cluster_empty and self_match):
                    return Status(UNSCHEDULABLE,
                                  "node(s) didn't satisfy pod affinity rules")
        return None

    # -- scoring (scoring.go) -------------------------------------------

    def pre_score(self, state: CycleState, pod_info: PodInfo, nodes):
        has_preferred = bool(pod_info.preferred_affinity_terms
                             or pod_info.preferred_anti_affinity_terms)
        # existing pods' preferred terms toward the incoming pod also score
        scores: dict[str, int] = {}
        any_term = has_preferred
        if not any_term:
            # check existing pods for preferred terms (hasPreferredAffinityConstraints)
            any_term = any(pi.preferred_affinity_terms or pi.preferred_anti_affinity_terms
                           for ni in nodes for pi in ni.pods_with_affinity)
        if not any_term:
            return Status(SKIP)
        ns_labels = (self._ns_labels()
                     if self._any_ns_selector(pod_info, nodes,
                                              scoring=True) else None)
        counts: TPCounts = {}

        def bump(term: AffinityTerm, node, w: int) -> None:
            val = _topo(node, term.topology_key)
            if val is not None:
                counts[(term.topology_key, val)] = \
                    counts.get((term.topology_key, val), 0) + w

        for ni in nodes:
            if ni.node is None:
                continue
            for pi in ni.pods:
                # incoming pod's preferred (anti-)affinity vs existing pod
                for term in pod_info.preferred_affinity_terms:
                    if term.matches(pi.pod, pi.labels, ns_labels):
                        bump(term, ni.node, term.weight)
                for term in pod_info.preferred_anti_affinity_terms:
                    if term.matches(pi.pod, pi.labels, ns_labels):
                        bump(term, ni.node, -term.weight)
                # existing pod's preferred (anti-)affinity vs incoming pod
                for term in pi.preferred_affinity_terms:
                    if term.matches(pod_info.pod, pod_info.labels,
                                    ns_labels):
                        bump(term, ni.node, term.weight)
                for term in pi.preferred_anti_affinity_terms:
                    if term.matches(pod_info.pod, pod_info.labels,
                                    ns_labels):
                        bump(term, ni.node, -term.weight)
        state.write(_SCORE_STATE_KEY, counts)
        return None

    def score(self, state: CycleState, pod_info: PodInfo,
              node_info: NodeInfo) -> tuple[int, Status | None]:
        counts: TPCounts | None = state.read(_SCORE_STATE_KEY)
        if not counts:
            return 0, None
        node = node_info.node
        total = 0
        for (key, val), w in counts.items():
            if _topo(node, key) == val:
                total += w
        return total, None

    def normalize_scores(self, state, pod_info, scores):
        if not scores:
            return None
        mx, mn = max(scores.values()), min(scores.values())
        spread = mx - mn
        for k in scores:
            scores[k] = (MAX_NODE_SCORE * (scores[k] - mn) // spread
                         if spread else 0)
        return None
