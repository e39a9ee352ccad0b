"""SelectorSpread — spread pods of a service/controller across nodes/zones.

Reference: pkg/scheduler/framework/plugins/selectorspread/ (234 LoC,
non-default since PodTopologySpread subsumed it, but still registered):
  * PreScore collects the label selectors of every Service, ReplicaSet,
    ReplicationController and StatefulSet that selects the incoming pod
    (selector_spread.go PreScore via helper.DefaultSelector).
  * Score counts existing pods on the node matched by ANY of those
    selectors (selector_spread.go Score).
  * NormalizeScore inverts counts to favor emptier nodes and blends in a
    zone-level count with a 2/3 zone weight when nodes carry zone labels
    (selector_spread.go NormalizeScore, zoneWeighting=2.0/3.0).
"""

from __future__ import annotations

from ...api import meta
from ...api.labels import Selector, selector_from_dict, selector_from_match_labels
from ...client.clientset import (
    REPLICASETS, REPLICATIONCONTROLLERS, SERVICES, STATEFULSETS,
)
from ..framework import MAX_NODE_SCORE, PreScorePlugin, ScorePlugin
from ..types import SKIP, ClusterEvent, Status

_STATE_KEY = "SelectorSpread/selectors"
ZONE_LABEL = "topology.kubernetes.io/zone"
ZONE_WEIGHT = 2.0 / 3.0


class SelectorSpread(PreScorePlugin, ScorePlugin):
    name = "SelectorSpread"

    def __init__(self, informer_factory=None):
        self.factory = informer_factory

    def events_to_register(self):
        return [ClusterEvent("Pod", "*"), ClusterEvent("Node", "*"),
                ClusterEvent("Service", "*"), ClusterEvent("ReplicaSet", "*")]

    def _selectors_for(self, pod: dict) -> list[Selector]:
        """helper.DefaultSelector: selectors of every object selecting pod."""
        if self.factory is None:
            return []
        ns = meta.namespace(pod)
        labels = meta.labels(pod) or {}
        out: list[Selector] = []
        for svc in self.factory.informer(SERVICES).list(ns):
            sel = selector_from_match_labels(
                (svc.get("spec") or {}).get("selector"))
            if not sel.is_empty() and sel.matches(labels):
                out.append(sel)
        for rc in self.factory.informer(REPLICATIONCONTROLLERS).list(ns):
            sel = selector_from_match_labels(
                (rc.get("spec") or {}).get("selector"))
            if not sel.is_empty() and sel.matches(labels):
                out.append(sel)
        for res in (REPLICASETS, STATEFULSETS):
            for obj in self.factory.informer(res).list(ns):
                sel = selector_from_dict((obj.get("spec") or {}).get("selector"))
                if not sel.is_empty() and sel.matches(labels):
                    out.append(sel)
        return out

    def pre_score(self, state, pod_info, nodes):
        selectors = self._selectors_for(pod_info.pod)
        if not selectors:
            return Status(SKIP)
        state.write(_STATE_KEY, selectors)
        return None

    def score(self, state, pod_info, node_info):
        selectors: list[Selector] | None = state.read(_STATE_KEY)
        if not selectors:
            return 0, None
        ns = meta.namespace(pod_info.pod)
        count = 0
        for pi in node_info.pods:
            if meta.namespace(pi.pod) != ns:
                continue
            labels = meta.labels(pi.pod) or {}
            if any(s.matches(labels) for s in selectors):
                count += 1
        return count, None

    def normalize_scores(self, state, pod_info, scores):
        selectors: list[Selector] | None = state.read(_STATE_KEY)
        if not selectors:
            return None
        # raw scores are match counts; fold in zone counts then invert
        zones: dict[str, int] = {}
        node_zone: dict[str, str] = {}
        if self.factory is not None:
            for node in self.factory.informer("nodes").list():
                zone = (meta.labels(node) or {}).get(ZONE_LABEL)
                if zone:
                    node_zone[meta.name(node)] = zone
        for name, cnt in scores.items():
            zone = node_zone.get(name)
            if zone:
                zones[zone] = zones.get(zone, 0) + cnt
        max_node = max(scores.values(), default=0)
        max_zone = max(zones.values(), default=0)
        for name in scores:
            node_score = (MAX_NODE_SCORE * (max_node - scores[name]) / max_node
                          if max_node > 0 else MAX_NODE_SCORE)
            zone = node_zone.get(name)
            if zone and max_zone > 0:
                zone_score = MAX_NODE_SCORE * (max_zone - zones[zone]) / max_zone
                node_score = (1 - ZONE_WEIGHT) * node_score + \
                    ZONE_WEIGHT * zone_score
            scores[name] = int(node_score)
        return None
