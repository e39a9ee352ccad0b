"""NodeVolumeLimits — attachable-volume count limits per node.

Reference: pkg/scheduler/framework/plugins/nodevolumelimits/ (977 LoC;
csi.go is the modern path, non_csi.go the legacy EBS/GCE-PD/AzureDisk
filters).  Semantics reproduced (CSI path, which the legacy plugins migrate
to via CSINode):
  * per-driver limits come from the node's CSINode object
    (csinode.spec.drivers[].allocatable.count, csi.go getVolumeLimits);
    without a CSINode entry the driver is uncounted (no limit known).
  * the filter counts unique volumes already attached (existing pods'
    PVC-backed volumes, resolved to their driver) plus the incoming pod's
    new unique volumes, and rejects when any driver would exceed its limit
    (csi.go Filter).
  * legacy in-tree volume types count against well-known defaults when no
    CSINode is present (non_csi.go: EBS 39, GCE-PD 16, AzureDisk 16).
"""

from __future__ import annotations

from ...api import meta
from ...client.clientset import CSINODES, PVCS, PVS
from ..framework import FilterPlugin, PreFilterPlugin
from ..types import SKIP, UNSCHEDULABLE, ClusterEvent, Status
from .volumebinding import pod_pvc_names

LEGACY_LIMITS = {  # non_csi.go default limits
    "kubernetes.io/aws-ebs": 39,
    "kubernetes.io/gce-pd": 16,
    "kubernetes.io/azure-disk": 16,
}


def _inline_driver(v: dict) -> tuple[str, str] | None:
    """(driver, unique volume handle) for inline in-tree volumes."""
    if v.get("awsElasticBlockStore"):
        return "kubernetes.io/aws-ebs", v["awsElasticBlockStore"].get("volumeID")
    if v.get("gcePersistentDisk"):
        return "kubernetes.io/gce-pd", v["gcePersistentDisk"].get("pdName")
    if v.get("azureDisk"):
        return "kubernetes.io/azure-disk", v["azureDisk"].get("diskName")
    if v.get("csi"):
        return v["csi"].get("driver"), v["csi"].get("volumeHandle")
    return None


class NodeVolumeLimits(PreFilterPlugin, FilterPlugin):
    name = "NodeVolumeLimits"

    def __init__(self, informer_factory=None):
        self.factory = informer_factory

    def events_to_register(self):
        return [ClusterEvent("CSINode", "*"), ClusterEvent("Pod", "Delete"),
                ClusterEvent("PersistentVolumeClaim", "*")]

    def _pod_volumes(self, pod: dict) -> set[tuple[str, str]]:
        """Unique (driver, handle) pairs a pod attaches."""
        out: set[tuple[str, str]] = set()
        ns = meta.namespace(pod)
        for v in (pod.get("spec") or {}).get("volumes") or ():
            inline = _inline_driver(v)
            if inline and inline[1]:
                out.add(inline)
                continue
            claim = (v.get("persistentVolumeClaim") or {}).get("claimName")
            if not claim or self.factory is None:
                continue
            pvc = self.factory.informer(PVCS).get(ns, claim)
            pv_name = ((pvc or {}).get("spec") or {}).get("volumeName")
            pv = self.factory.informer(PVS).get("", pv_name) if pv_name else None
            if pv is None:
                continue
            spec = pv.get("spec") or {}
            if spec.get("csi"):
                out.add((spec["csi"].get("driver"),
                         spec["csi"].get("volumeHandle") or pv_name))
            else:
                for key in ("awsElasticBlockStore", "gcePersistentDisk",
                            "azureDisk"):
                    inline = _inline_driver({key: spec.get(key)}) \
                        if spec.get(key) else None
                    if inline and inline[1]:
                        out.add(inline)
        return out

    def _limits_for(self, node_name: str) -> dict[str, int]:
        """driver -> attachable count (CSINode allocatable, else legacy)."""
        limits = dict(LEGACY_LIMITS)
        if self.factory is not None:
            csinode = self.factory.informer(CSINODES).get("", node_name)
            for d in ((csinode or {}).get("spec") or {}).get("drivers") or ():
                count = (d.get("allocatable") or {}).get("count")
                if count is not None:
                    limits[d.get("name")] = int(count)
        return limits

    def pre_filter(self, state, pod_info, snapshot):
        if not self._pod_volumes(pod_info.pod) and \
                not pod_pvc_names(pod_info.pod):
            return None, Status(SKIP)
        return None, None

    def filter(self, state, pod_info, node_info):
        new_vols = self._pod_volumes(pod_info.pod)
        if not new_vols:
            return None
        limits = self._limits_for(node_info.name)
        if not limits:
            return None
        attached: dict[str, set[str]] = {}
        for pi in node_info.pods:
            for driver, handle in self._pod_volumes(pi.pod):
                attached.setdefault(driver, set()).add(handle)
        for driver, handle in new_vols:
            attached.setdefault(driver, set()).add(handle)
        for driver, handles in attached.items():
            limit = limits.get(driver)
            if limit is not None and len(handles) > limit:
                return Status(UNSCHEDULABLE,
                              "node(s) exceed max volume count")
        return None
