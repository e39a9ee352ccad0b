"""VolumeZone — bound PVs must live in the node's zone/region.

Reference: pkg/scheduler/framework/plugins/volumezone/ (206 LoC):
for each of the pod's bound PVCs, the PV's zone/region labels (both the GA
topology.kubernetes.io/* and legacy failure-domain.beta.kubernetes.io/*
keys) must be satisfied by the node's labels; zone label values may be
comma-separated sets (volume_zone.go Filter).
"""

from __future__ import annotations

from ...api import meta
from ...client.clientset import PVCS, PVS
from ..framework import FilterPlugin, PreFilterPlugin
from ..types import SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE, ClusterEvent, Status
from .volumebinding import pod_pvc_names

ZONE_LABELS = (
    "topology.kubernetes.io/zone",
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/region",
)


class VolumeZone(PreFilterPlugin, FilterPlugin):
    name = "VolumeZone"

    def __init__(self, informer_factory=None):
        self.factory = informer_factory

    def events_to_register(self):
        return [ClusterEvent("PersistentVolumeClaim", "*"),
                ClusterEvent("PersistentVolume", "*"),
                ClusterEvent("Node", "*")]

    def pre_filter(self, state, pod_info, snapshot):
        if not pod_pvc_names(pod_info.pod):
            return None, Status(SKIP)
        return None, None

    def filter(self, state, pod_info, node_info):
        if self.factory is None:
            return None
        ns = meta.namespace(pod_info.pod)
        node_labels = meta.labels(node_info.node) or {}
        for claim in pod_pvc_names(pod_info.pod):
            pvc = self.factory.informer(PVCS).get(ns, claim)
            if pvc is None:
                return Status(UNSCHEDULABLE,
                              f'persistentvolumeclaim "{claim}" not found')
            pv_name = (pvc.get("spec") or {}).get("volumeName")
            if not pv_name:
                continue  # unbound: VolumeBinding's problem, not ours
            pv = self.factory.informer(PVS).get("", pv_name)
            if pv is None:
                return Status(UNSCHEDULABLE,
                              f'persistentvolume "{pv_name}" not found')
            for key, val in (meta.labels(pv) or {}).items():
                if key not in ZONE_LABELS:
                    continue
                # PV zone values may be comma-separated sets (volume_zone.go)
                allowed = {z.strip() for z in val.split(",")}
                if node_labels.get(key) not in allowed:
                    return Status(
                        UNSCHEDULABLE_AND_UNRESOLVABLE,
                        "node(s) had no available volume zone")
        return None
