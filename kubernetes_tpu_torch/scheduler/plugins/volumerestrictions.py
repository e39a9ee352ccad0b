"""VolumeRestrictions — inline-volume conflicts and ReadWriteOncePod.

Reference: pkg/scheduler/framework/plugins/volumerestrictions/ (215 LoC):
  * two pods on one node may not use the same GCEPersistentDisk unless both
    mount it read-only; same for AWS EBS (also rejects any double use) and
    AzureDisk; ISCSI same-target conflicts unless both read-only
    (volume_restrictions.go isVolumeConflict).
  * a PVC with the ReadWriteOncePod access mode may be used by at most one
    pod in the cluster; PreFilter rejects the pod if any existing pod
    already uses the claim (volume_restrictions.go CheckReadWriteOncePod).
"""

from __future__ import annotations

from ...api import meta
from ...client.clientset import PVCS
from ..framework import FilterPlugin, PreFilterPlugin
from ..types import (
    SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE, ClusterEvent, Status,
)
from .volumebinding import pod_pvc_names

READ_WRITE_ONCE_POD = "ReadWriteOncePod"

_RWOP_STATE_KEY = "VolumeRestrictions/rwop"


def _gce_pd(v: dict):
    d = v.get("gcePersistentDisk")
    return (d.get("pdName"), bool(d.get("readOnly"))) if d else None


def _aws_ebs(v: dict):
    d = v.get("awsElasticBlockStore")
    return (d.get("volumeID"), bool(d.get("readOnly"))) if d else None


def _azure_disk(v: dict):
    d = v.get("azureDisk")
    return (d.get("diskName"), bool(d.get("readOnly"))) if d else None


def _iscsi(v: dict):
    d = v.get("iscsi")
    if not d:
        return None
    return (f"{d.get('targetPortal')}/{d.get('iqn')}/{d.get('lun')}",
            bool(d.get("readOnly")))


def is_volume_conflict(v: dict, existing: dict) -> bool:
    """volume_restrictions.go isVolumeConflict, per volume pair."""
    for extract, ro_allowed in ((_gce_pd, True), (_aws_ebs, False),
                                (_azure_disk, False), (_iscsi, True)):
        a, b = extract(v), extract(existing)
        if a and b and a[0] == b[0]:
            if ro_allowed and a[1] and b[1]:
                continue  # both read-only: GCE PD / ISCSI allow sharing
            return True
    return False


class VolumeRestrictions(PreFilterPlugin, FilterPlugin):
    name = "VolumeRestrictions"

    def __init__(self, informer_factory=None):
        self.factory = informer_factory

    def events_to_register(self):
        return [ClusterEvent("Pod", "Delete"),
                ClusterEvent("PersistentVolumeClaim", "*")]

    def _rwop_claims(self, pod: dict) -> set[str]:
        """Namespaced keys of the pod's PVCs that are ReadWriteOncePod."""
        if self.factory is None:
            return set()
        ns = meta.namespace(pod)
        out = set()
        for name in pod_pvc_names(pod):
            pvc = self.factory.informer(PVCS).get(ns, name)
            if pvc and READ_WRITE_ONCE_POD in (
                    (pvc.get("spec") or {}).get("accessModes") or ()):
                out.add(f"{ns}/{name}")
        return out

    def pre_filter(self, state, pod_info, snapshot):
        has_inline = any(
            _gce_pd(v) or _aws_ebs(v) or _azure_disk(v) or _iscsi(v)
            for v in (pod_info.pod.get("spec") or {}).get("volumes") or ())
        rwop = self._rwop_claims(pod_info.pod)
        if rwop:
            # cluster-wide uniqueness: any existing pod using the claim wins
            for ni in snapshot.node_info_list:
                for key in rwop:
                    if ni.pvc_ref_counts.get(key, 0) > 0:
                        return None, Status(
                            UNSCHEDULABLE,
                            "pod uses a ReadWriteOncePod"
                            " PersistentVolumeClaim that is already in use")
        if not has_inline:
            return None, Status(SKIP)
        return None, None

    def filter(self, state, pod_info, node_info):
        volumes = (pod_info.pod.get("spec") or {}).get("volumes") or ()
        for existing_pi in node_info.pods:
            for ev in (existing_pi.pod.get("spec") or {}).get("volumes") or ():
                for v in volumes:
                    if is_volume_conflict(v, ev):
                        return Status(
                            UNSCHEDULABLE_AND_UNRESOLVABLE,
                            "node has conflicting volumes in use")
        return None
