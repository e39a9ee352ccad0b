"""ClusterRole aggregation controller.

Reference: pkg/controller/clusterroleaggregation/clusterroleaggregation_
controller.go — a ClusterRole carrying `aggregationRule.
clusterRoleSelectors` gets its `rules` REPLACED by the union of the
rules of every ClusterRole matching any of the selectors (this is how
`admin`/`edit`/`view` pick up aggregated CRD permissions).  Any
ClusterRole event re-queues every aggregating role, since a label
change anywhere can change some union.

A copy of kubernetes_tpu/controllers/clusterroleaggregation.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.labels import selector_from_dict
from ..api.meta import Obj
from ..client.clientset import CLUSTERROLES
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)


class ClusterRoleAggregationController(Controller):
    name = "clusterrole-aggregation"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.role_informer = factory.informer(CLUSTERROLES)
        self.role_informer.add_event_handler(self._on_role)

    def _on_role(self, type_, role: Obj, old: Obj | None) -> None:
        # any role's labels/rules feeding any union may have changed:
        # requeue every aggregating role (the reference does the same —
        # clusterroleaggregation_controller.go enqueues all)
        for r in self.role_informer.list(None):
            if (r.get("aggregationRule") or {}).get("clusterRoleSelectors"):
                self.enqueue_key(meta.name(r))

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        role = self.role_informer.get("", name)
        if role is None:
            return
        selectors = (role.get("aggregationRule")
                     or {}).get("clusterRoleSelectors") or []
        if not selectors:
            return
        compiled = [selector_from_dict(s) for s in selectors]
        union: list = []
        seen: set = set()
        for r in sorted(self.role_informer.list(None), key=meta.name):
            if meta.name(r) == name:
                continue  # never aggregate a role into itself
            labels = meta.labels(r)
            if not any(c.matches(labels) for c in compiled):
                continue
            for rule in r.get("rules") or ():
                fp = repr(sorted(rule.items()))
                if fp not in seen:
                    seen.add(fp)
                    union.append(rule)
        if (role.get("rules") or []) == union:
            return

        def patch(cur: Obj) -> Obj:
            cur["rules"] = union
            return cur
        try:
            self.client.guaranteed_update(CLUSTERROLES, "", name, patch)
        except kv.NotFoundError:
            pass
