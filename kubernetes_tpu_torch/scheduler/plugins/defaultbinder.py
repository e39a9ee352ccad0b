"""DefaultBinder — writes the Binding (sets spec.nodeName via the client).

Reference: pkg/scheduler/framework/plugins/defaultbinder/default_binder.go:62
(POST pods/{name}/binding subresource).
"""

from __future__ import annotations

from ...store import kv
from ..framework import BindPlugin, CycleState
from ..types import ERROR, NodeInfo, PodInfo, Status


class DefaultBinder(BindPlugin):
    name = "DefaultBinder"
    # marks the scheduler's bulk-bind fast path as semantically equivalent
    is_default_binder = True

    def __init__(self, client=None):
        self.client = client

    def bind(self, state: CycleState, pod_info: PodInfo,
             node_name: str) -> Status | None:
        try:
            self.client.bind(pod_info.pod, node_name)
        except kv.BindConflict:
            # lost the optimistic race to a peer scheduler instance: the
            # typed error must reach the binding cycle intact so the pod
            # is Forgotten + reclassified, not blamed as a plain error
            raise
        except kv.StoreError as e:
            return Status(ERROR, f"binding rejected: {e}")
        return None
