"""DefaultPreemption PostFilter plugin.

Reference: pkg/scheduler/framework/plugins/defaultpreemption/
default_preemption.go:83 — wraps preemption.Evaluator; on success the pod
is nominated onto the chosen node (status.nominatedNodeName) and requeued;
victim deletion events re-activate it.
"""

from __future__ import annotations

from ...api import meta
from ...client.clientset import PODS
from ..framework import CycleState, PostFilterPlugin
from ..preemption import Evaluator
from ..types import SUCCESS, UNSCHEDULABLE, ClusterEvent, PodInfo, Status


class DefaultPreemption(PostFilterPlugin):
    name = "DefaultPreemption"

    def __init__(self, client=None, framework=None, snapshot_getter=None):
        self.client = client
        self._framework = framework
        self._snapshot_getter = snapshot_getter or (lambda: None)
        self._evaluator: Evaluator | None = None
        # set by the Scheduler: observer(victim_count) for preemption metrics
        self.preemption_observer = None

    def set_framework(self, fw) -> None:
        self._framework = fw

    def events_to_register(self):
        return [ClusterEvent("AssignedPod", "Delete"), ClusterEvent("Pod", "Delete")]

    def evaluator(self) -> Evaluator:
        """The (lazily built) evaluator — shared with the batched TPU
        preemption path so both run identical victim selection."""
        if self._evaluator is None:
            self._evaluator = Evaluator(
                self._framework, self.client,
                observer=lambda n: (self.preemption_observer(n)
                                    if self.preemption_observer else None))
        return self._evaluator

    def persist_nomination(self, pod_info: PodInfo, nominated: str) -> None:
        """Patch status.nominatedNodeName (handleSchedulingFailure)."""
        try:
            def patch(p):
                p.setdefault("status", {})["nominatedNodeName"] = nominated
                return p
            self.client.guaranteed_update(
                PODS, meta.namespace(pod_info.pod), meta.name(pod_info.pod),
                patch)
        except Exception:  # noqa: BLE001
            pass

    def post_filter(self, state: CycleState, pod_info: PodInfo,
                    filtered_node_status_map: dict[str, Status]
                    ) -> tuple[str | None, Status]:
        self.evaluator()
        snapshot = self._snapshot_getter()
        if snapshot is None:
            return None, Status(UNSCHEDULABLE, "no snapshot for preemption")
        nominated, status = self._evaluator.preempt(
            state, pod_info, filtered_node_status_map, snapshot)
        if nominated:
            # persist the nomination (schedule_one.go handleSchedulingFailure
            # patches status.nominatedNodeName via the API)
            self.persist_nomination(pod_info, nominated)
            return nominated, Status(SUCCESS)
        return None, status
