"""DaemonSet controller.

Reference: pkg/controller/daemon/ — one pod per eligible node.  Node
eligibility: nodeSelector match + required node affinity + taints
tolerated (daemon pods get the standard not-ready/unreachable NoExecute
and NoSchedule tolerations).  Modern upstream routes daemon pods through
the scheduler with a node-affinity pin; we do the same: the pod carries a
requiredDuringScheduling nodeAffinity for its target node and the default
scheduler binds it (so resource fit is still enforced on TPU path too).

A copy of kubernetes_tpu/controllers/daemonset.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import DAEMONSETS, NODES, PODS
from ..store import kv
from .base import Controller, Expectations, is_owned_by, owner_ref, split_key
from .replicaset import pod_is_active, pod_is_ready

logger = logging.getLogger(__name__)

DAEMON_TOLERATIONS = [
    {"key": "node.kubernetes.io/not-ready", "operator": "Exists",
     "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unreachable", "operator": "Exists",
     "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unschedulable", "operator": "Exists",
     "effect": "NoSchedule"},
]


def _affinity_matches(pod_spec: dict, node: Obj) -> bool:
    """Template requiredDuringScheduling node affinity (matchExpressions
    over labels; matchFields over metadata.name), OR across terms."""
    terms = (((pod_spec.get("affinity") or {}).get("nodeAffinity") or {})
             .get("requiredDuringSchedulingIgnoredDuringExecution") or {}) \
        .get("nodeSelectorTerms")
    if not terms:
        return True
    node_labels = meta.labels(node)
    for term in terms:
        ok = True
        for req in term.get("matchExpressions", []):
            val = node_labels.get(req.get("key"))
            op = req.get("operator", "In")
            if op == "In":
                ok = val in (req.get("values") or [])
            elif op == "NotIn":
                ok = val not in (req.get("values") or [])
            elif op == "Exists":
                ok = req.get("key") in node_labels
            elif op == "DoesNotExist":
                ok = req.get("key") not in node_labels
            if not ok:
                break
        for req in term.get("matchFields", []) if ok else ():
            if req.get("key") == "metadata.name":
                ok = meta.name(node) in (req.get("values") or [])
            if not ok:
                break
        if ok:
            return True
    return False


def _node_matches(ds: Obj, node: Obj) -> bool:
    pod_spec = (((ds.get("spec") or {}).get("template") or {})
                .get("spec") or {})
    sel = pod_spec.get("nodeSelector") or {}
    node_labels = meta.labels(node)
    if not all(node_labels.get(k) == v for k, v in sel.items()):
        return False
    if not _affinity_matches(pod_spec, node):
        return False
    # untolerated NoSchedule/NoExecute taints exclude the node
    tolerations = (((ds.get("spec") or {}).get("template") or {})
                   .get("spec", {}).get("tolerations") or []) + DAEMON_TOLERATIONS
    for taint in (node.get("spec") or {}).get("taints", []):
        if taint.get("effect") not in ("NoSchedule", "NoExecute"):
            continue
        if not any(_tolerates(t, taint) for t in tolerations):
            return False
    return True


def _tolerates(tol: dict, taint: dict) -> bool:
    if tol.get("effect") and tol["effect"] != taint.get("effect"):
        return False
    if tol.get("operator", "Equal") == "Exists":
        return not tol.get("key") or tol["key"] == taint.get("key")
    return (tol.get("key") == taint.get("key")
            and tol.get("value", "") == taint.get("value", ""))


class DaemonSetController(Controller):
    name = "daemonset"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.ds_informer = factory.informer(DAEMONSETS)
        self.pod_informer = factory.informer(PODS)
        self.node_informer = factory.informer(NODES)
        self.expectations = Expectations()
        self.ds_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)
        self.node_informer.add_event_handler(self._on_node)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        ref = meta.controller_ref(pod)
        if ref and ref.get("kind") == "DaemonSet":
            key = f"{meta.namespace(pod)}/{ref['name']}"
            if type_ == kv.ADDED:
                self.expectations.creation_observed(key)
            elif type_ == kv.DELETED:
                self.expectations.deletion_observed(key)
            self.enqueue_key(key)

    def _on_node(self, type_, node: Obj, old) -> None:
        # node churn re-syncs every daemonset
        for ds in self.ds_informer.list(None):
            self.enqueue(ds)

    def _pod_node(self, pod: Obj) -> str:
        """Target node: bound nodeName, or the affinity pin pre-binding."""
        bound = meta.pod_node_name(pod)
        if bound:
            return bound
        terms = ((((pod.get("spec") or {}).get("affinity") or {})
                  .get("nodeAffinity") or {})
                 .get("requiredDuringSchedulingIgnoredDuringExecution") or {})
        for term in terms.get("nodeSelectorTerms", []):
            for f in term.get("matchFields", []):
                if f.get("key") == "metadata.name" and f.get("values"):
                    return f["values"][0]
        return ""

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        ds = self.ds_informer.get(ns, name)
        if ds is None:
            self.expectations.delete(key)
            return
        nodes = {meta.name(n): n for n in self.node_informer.list(None)}
        eligible = {n for n, node in nodes.items() if _node_matches(ds, node)}
        by_node: dict[str, Obj] = {}
        for p in self.pod_informer.list(ns):
            if is_owned_by(p, ds) and pod_is_active(p):
                by_node.setdefault(self._pod_node(p), p)

        if self.expectations.satisfied(key):
            to_create = sorted(eligible - set(by_node))
            to_delete = sorted(set(by_node) - eligible)
            if to_create:
                self.expectations.expect_creations(key, len(to_create))
                for node_name in to_create:
                    try:
                        if not self._create_pod(ds, node_name):
                            self.expectations.creation_observed(key)
                    except Exception:
                        self.expectations.creation_observed(key)
                        raise
            if to_delete:
                self.expectations.expect_deletions(key, len(to_delete))
                for node_name in to_delete:
                    try:
                        self.client.delete(PODS, ns,
                                           meta.name(by_node[node_name]))
                    except kv.NotFoundError:
                        self.expectations.deletion_observed(key)

        scheduled = sum(1 for n in by_node if n in eligible)
        ready = sum(1 for n, p in by_node.items()
                    if n in eligible and pod_is_ready(p))
        status = {"desiredNumberScheduled": len(eligible),
                  "currentNumberScheduled": scheduled,
                  "numberReady": ready,
                  "numberMisscheduled": len(set(by_node) - eligible),
                  "observedGeneration": ds["metadata"].get("generation", 0)}
        if (ds.get("status") or {}) != status:
            def patch(o):
                o["status"] = status
                return o
            try:
                self.client.guaranteed_update(DAEMONSETS, ns, name, patch)
            except kv.NotFoundError:
                pass

    def _create_pod(self, ds: Obj, node_name: str) -> bool:
        ns, ds_name = meta.namespace(ds), meta.name(ds)
        tmpl = (ds.get("spec") or {}).get("template") or {}
        pod = meta.new_object("Pod", f"{ds_name}-{node_name}", ns)
        tmpl_meta = tmpl.get("metadata") or {}
        pod["metadata"]["labels"] = dict(tmpl_meta.get("labels") or {})
        pod["metadata"]["ownerReferences"] = [owner_ref(ds, "DaemonSet")]
        pod["spec"] = meta.deep_copy(tmpl.get("spec") or {"containers": [
            {"name": "c0", "image": "img"}]})
        # pin to the node via required node affinity; scheduler binds it
        pod["spec"].setdefault("affinity", {})["nodeAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "nodeSelectorTerms": [{"matchFields": [{
                    "key": "metadata.name", "operator": "In",
                    "values": [node_name]}]}]}}
        pod["spec"].setdefault("tolerations", []).extend(DAEMON_TOLERATIONS)
        pod["spec"].setdefault("schedulerName", "default-scheduler")
        try:
            self.client.create(PODS, pod)
            return True
        except kv.AlreadyExistsError:
            return False
