"""Coscheduling (gang scheduling) plugin.

Reference: the kubernetes-sigs/scheduler-plugins Coscheduling plugin —
out-of-tree in the reference ecosystem (SURVEY.md §2.2 note), built on the
in-tree Permit/WaitOnPermit machinery (framework/interface.go:482-491,
runtime/waiting_pods_map.go), which this framework reproduces.

Model: a PodGroup object ("podgroups" resource) declares spec.minMember;
pods join a group via the label `scheduling.x-k8s.io/pod-group`.  A pod of
a group reaching Permit WAITs until minMember of its group are bound or
waiting; the threshold crossing allows the whole gang at once (all-or-
nothing binding).  PreFilter rejects pods whose group hasn't even been
created at minMember size yet, so partial gangs never hold resources.
"""

from __future__ import annotations

import time

from ...api import meta
from ...client.clientset import PODGROUPS, PODS
from ..framework import CycleState, PermitPlugin, PostBindPlugin, PreFilterPlugin
from ..types import (
    SKIP, SUCCESS, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE, WAIT,
    ClusterEvent, PodInfo, Status,
)

POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"
DEFAULT_WAIT_TIME = 60.0


def pod_group_name(pod_info: PodInfo) -> str | None:
    return pod_info.labels.get(POD_GROUP_LABEL)


class Coscheduling(PreFilterPlugin, PermitPlugin, PostBindPlugin):
    name = "Coscheduling"
    # the device batch path must run this plugin's membership gate on
    # the host before encoding (scheduler._dispatch_batch): an
    # incomplete gang that reaches Permit live-locks through
    # assume/wait/timeout/Unreserve cycles, starving competitors
    supports_batch_gate = True

    def __init__(self, client=None, handle=None):
        self.client = client
        self.handle = handle

    def batch_gate(self, pod_info: PodInfo, cache: dict | None = None):
        """Cheap host gate for the batch path: ~one dict lookup for
        non-gang pods; the PreFilter membership check ONCE PER GROUP
        per batch (`cache` is the dispatcher's per-batch memo — the
        membership scan is O(total pods) and identical for every
        member of a group in the same batch)."""
        group = pod_group_name(pod_info)
        if group is None:
            return None
        key = (self.name, meta.namespace(pod_info.pod), group)
        if cache is not None and key in cache:
            return cache[key]
        _result, status = self.pre_filter(CycleState(), pod_info, None)
        if status is not None and status.is_skip():
            status = None
        if cache is not None:
            cache[key] = status
        return status

    def events_to_register(self):
        return [ClusterEvent("Pod", "Add"), ClusterEvent("AssignedPod", "Add"),
                ClusterEvent("PodGroup", "*")]

    def _group(self, pod_info: PodInfo):
        name = pod_group_name(pod_info)
        if not name:
            return None, None
        try:
            pg = self.client.get(PODGROUPS, meta.namespace(pod_info.pod), name)
        except Exception:  # noqa: BLE001 - group object missing
            return name, None
        return name, pg

    def _member_pods(self, namespace: str, group: str) -> list:
        items, _ = self.client.list(PODS, namespace)
        return [p for p in items
                if (meta.labels(p).get(POD_GROUP_LABEL) == group
                    and not meta.pod_is_terminal(p))]

    # -- PreFilter -------------------------------------------------------

    def pre_filter(self, state: CycleState, pod_info: PodInfo, snapshot):
        name, pg = self._group(pod_info)
        if name is None:
            return None, Status(SKIP)
        if pg is None:
            return None, Status(
                UNSCHEDULABLE_AND_UNRESOLVABLE,
                f"pod group {name!r} does not exist", plugin=self.name)
        min_member = (pg.get("spec") or {}).get("minMember", 1)
        members = self._member_pods(meta.namespace(pod_info.pod), name)
        if len(members) < min_member:
            return None, Status(
                UNSCHEDULABLE,
                f"pod group {name!r} has {len(members)} pods, needs {min_member}",
                plugin=self.name)
        return None, None

    # -- Permit (the gang barrier) --------------------------------------

    def permit(self, state: CycleState, pod_info: PodInfo,
               node_name: str) -> tuple[Status | None, float]:
        name, pg = self._group(pod_info)
        if name is None:
            return None, 0.0
        min_member = ((pg.get("spec") or {}).get("minMember", 1)
                      if pg else 1)
        timeout = ((pg.get("spec") or {}).get("scheduleTimeoutSeconds",
                                              DEFAULT_WAIT_TIME)
                   if pg else DEFAULT_WAIT_TIME)
        ns = meta.namespace(pod_info.pod)
        bound = sum(1 for p in self._member_pods(ns, name)
                    if meta.pod_node_name(p))
        waiting = [wp for wp in self.handle.iterate_waiting_pods()
                   if pod_group_name(wp.pod_info) == name
                   and meta.namespace(wp.pod_info.pod) == ns]
        # +1 for this pod, which isn't in the waiting map yet
        if bound + len(waiting) + 1 >= min_member:
            for wp in waiting:
                wp.allow(self.name)
            return Status(SUCCESS), 0.0
        return Status(WAIT), float(timeout)

    # -- PostBind cleanup ------------------------------------------------

    def post_bind(self, state: CycleState, pod_info: PodInfo,
                  node_name: str) -> None:
        name, pg = self._group(pod_info)
        if name is None or pg is None:
            return
        try:
            def bump(g):
                st = g.setdefault("status", {})
                st["scheduled"] = st.get("scheduled", 0) + 1
                if st["scheduled"] >= (g.get("spec") or {}).get("minMember", 1):
                    st["phase"] = "Scheduled"
                return g
            self.client.guaranteed_update(
                PODGROUPS, meta.namespace(pod_info.pod), name, bump)
        except Exception:  # noqa: BLE001
            pass
