"""ReplicationController controller.

Reference: pkg/controller/replication/ — upstream literally adapts the
ReplicaSet controller over converted RC objects (replication_controller.go:
"It is actually just a wrapper around ReplicaSetController", conversion in
conversion.go).  Same here: ReplicaSetController parameterized over
kind/resource, plus the RC-specific selector shape — RC spec.selector is a
bare label map (no matchExpressions), defaulting to the template labels.

A copy of kubernetes_tpu/controllers/replication.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

from ..api.meta import Obj
from ..client.clientset import REPLICATIONCONTROLLERS
from .replicaset import ReplicaSetController


class ReplicationControllerController(ReplicaSetController):
    name = "replicationcontroller"
    kind = "ReplicationController"
    resource = REPLICATIONCONTROLLERS

    def _normalize(self, rc: Obj) -> Obj:
        spec = rc.get("spec") or {}
        sel = spec.get("selector") or (
            ((spec.get("template") or {}).get("metadata") or {}).get("labels")
            or {})
        shim = dict(rc)
        shim["spec"] = dict(spec, selector={"matchLabels": dict(sel)})
        return shim
