"""Volume controllers: PV binder, attach/detach, PVC/PV protection,
ephemeral volumes.

Reference: pkg/controller/volume/
  persistentvolume/pv_controller.go - bind unbound PVCs to matching PVs
    (capacity / accessModes / storageClass / selector), dynamically
    provision for provisionable classes (honoring the scheduler's
    volume.kubernetes.io/selected-node annotation for WaitForFirstConsumer),
    reclaim released PVs per persistentVolumeReclaimPolicy
  attachdetach/attach_detach_controller.go - desired-vs-actual attachment
    reconciliation; we materialize VolumeAttachment objects and the node
    status.volumesAttached list
  pvcprotection/pvc_protection_controller.go - kubernetes.io/pvc-protection
    finalizer: added to live PVCs, removed once no non-terminal pod uses a
    terminating PVC (store finalizer semantics: kv.py delete/update)
  pvprotection/pv_protection_controller.go - same for PVs vs bound claims
  ephemeral/controller.go - create the <pod>-<volume> PVC for generic
    ephemeral volumes, owned by the pod

A copy of kubernetes_tpu/controllers/volume.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.labels import selector_from_dict
from ..api.meta import Obj
from ..api.quantity import parse_quantity
from ..client.clientset import (
    NODES, PODS, PVCS, PVS, STORAGECLASSES, VOLUMEATTACHMENTS,
)
from ..store import kv
from .base import Controller, owner_ref, split_key

logger = logging.getLogger(__name__)

PVC_PROTECTION_FINALIZER = "kubernetes.io/pvc-protection"
PV_PROTECTION_FINALIZER = "kubernetes.io/pv-protection"
SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"
NO_PROVISIONER = "kubernetes.io/no-provisioner"


def _pvc_names(pod: Obj) -> list[str]:
    out = []
    for v in (pod.get("spec") or {}).get("volumes") or ():
        claim = (v.get("persistentVolumeClaim") or {}).get("claimName")
        if claim:
            out.append(claim)
    return out


def _capacity(obj: Obj, field: str) -> int:
    spec = obj.get("spec") or {}
    if field == "pvc":
        q = ((spec.get("resources") or {}).get("requests") or {}).get(
            "storage", "0")
    else:
        q = (spec.get("capacity") or {}).get("storage", "0")
    return int(parse_quantity(q))


def pv_matches_claim(pv: Obj, pvc: Obj) -> bool:
    """find_matching_volume (pv_controller): class, size, accessModes,
    selector, and not already claimed by someone else."""
    pv_spec = pv.get("spec") or {}
    pvc_spec = pvc.get("spec") or {}
    ref = pv_spec.get("claimRef")
    if ref and (ref.get("namespace") != meta.namespace(pvc)
                or ref.get("name") != meta.name(pvc)):
        return False
    if (pv_spec.get("storageClassName") or "") != (
            pvc_spec.get("storageClassName") or ""):
        return False
    want_modes = set(pvc_spec.get("accessModes") or ())
    if not want_modes.issubset(set(pv_spec.get("accessModes") or ())):
        return False
    if _capacity(pv, "pv") < _capacity(pvc, "pvc"):
        return False
    sel = pvc_spec.get("selector")
    if sel and not selector_from_dict(sel).matches(
            meta.labels(pv)):
        return False
    return True


class PersistentVolumeController(Controller):
    """The binder (pv_controller.go syncClaim/syncVolume)."""

    name = "persistentvolume-binder"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pvc_informer = factory.informer(PVCS)
        self.pv_informer = factory.informer(PVS)
        self.sc_informer = factory.informer(STORAGECLASSES)
        self.pvc_informer.add_event_handler(self._on_claim)
        self.pv_informer.add_event_handler(self._on_volume)

    def _on_volume(self, type_, pv: Obj, old: Obj | None) -> None:
        self.enqueue_key("volume:" + meta.name(pv))
        # a PV appearing or becoming Available can satisfy waiting claims;
        # with no periodic resync, this event is their only wake-up
        if not (pv.get("spec") or {}).get("claimRef"):
            for pvc in self.pvc_informer.list(None):
                if not (pvc.get("spec") or {}).get("volumeName"):
                    self.enqueue_key("claim:" + meta.namespaced_name(pvc))

    def _on_claim(self, type_, pvc: Obj, old: Obj | None) -> None:
        self.enqueue_key("claim:" + meta.namespaced_name(pvc))
        # a (re)moved claim must re-sync its bound volume for reclaim
        for o in (pvc, old):
            vol = ((o or {}).get("spec") or {}).get("volumeName")
            if vol:
                self.enqueue_key("volume:" + vol)

    def sync(self, key: str) -> None:
        kind, _, rest = key.partition(":")
        if kind == "claim":
            self._sync_claim(rest)
        else:
            self._sync_volume(rest)

    # -- claims ----------------------------------------------------------

    def _sync_claim(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.pvc_informer.get(ns, name)
        if pvc is None or meta.deletion_timestamp(pvc):
            return
        spec = pvc.get("spec") or {}
        if spec.get("volumeName"):
            self._ensure_bound_status(pvc)
            return
        cls_name = spec.get("storageClassName")
        cls = self.sc_informer.get("", cls_name) if cls_name else None
        delayed = (cls or {}).get("volumeBindingMode") == "WaitForFirstConsumer"
        selected = (pvc["metadata"].get("annotations") or {}).get(
            SELECTED_NODE_ANNOTATION)
        if delayed and not selected:
            return  # scheduler decides first (volume binding plugin)
        # static match first
        for pv in self.pv_informer.list(None):
            if meta.deletion_timestamp(pv):
                continue
            if ((pv.get("status") or {}).get("phase") in (None, "Available",
                                                          "Pending")
                    and pv_matches_claim(pv, pvc)):
                self._bind(pvc, pv)
                return
        # dynamic provisioning
        provisioner = (cls or {}).get("provisioner")
        if provisioner and provisioner != NO_PROVISIONER:
            self._provision(pvc, cls, selected)

    def _bind(self, pvc: Obj, pv: Obj) -> None:
        # the claimRef write re-validates inside the CAS closure: the
        # informer view used for matching may lag a concurrent bind of the
        # same PV to another claim (two sync workers, one Available PV)
        won = {"bind": False}

        def set_claim_ref(o):
            won["bind"] = False  # re-evaluated on every CAS retry
            ref = (o.get("spec") or {}).get("claimRef")
            if ref and (ref.get("namespace") != meta.namespace(pvc)
                        or ref.get("name") != meta.name(pvc)):
                return o  # lost the race; claim resyncs to another PV
            o.setdefault("spec", {})["claimRef"] = {
                "namespace": meta.namespace(pvc), "name": meta.name(pvc),
                "uid": meta.uid(pvc)}
            o.setdefault("status", {})["phase"] = "Bound"
            won["bind"] = True
            return o

        def set_volume(o):
            o.setdefault("spec", {})["volumeName"] = meta.name(pv)
            o.setdefault("status", {})["phase"] = "Bound"
            return o
        try:
            self.client.guaranteed_update(PVS, "", meta.name(pv),
                                          set_claim_ref)
            if won["bind"]:
                self.client.guaranteed_update(PVCS, meta.namespace(pvc),
                                              meta.name(pvc), set_volume)
            else:
                # lost the PV to a racing claim: try again for another PV
                self.enqueue_key("claim:" + meta.namespaced_name(pvc))
        except kv.NotFoundError:
            pass

    def _provision(self, pvc: Obj, cls: Obj, selected_node: str | None) -> None:
        pv_name = f"pvc-{meta.uid(pvc)}"
        if self.pv_informer.get("", pv_name) is not None:
            return
        pv = meta.new_object("PersistentVolume", pv_name, None)
        pv["metadata"]["annotations"] = {
            "pv.kubernetes.io/provisioned-by": cls.get("provisioner")}
        pv["spec"] = {
            "capacity": {"storage": ((pvc.get("spec") or {}).get("resources")
                                     or {}).get("requests", {}).get("storage",
                                                                    "1Gi")},
            "accessModes": list((pvc.get("spec") or {}).get("accessModes")
                                or ["ReadWriteOnce"]),
            "storageClassName": (pvc.get("spec") or {}).get(
                "storageClassName", ""),
            "persistentVolumeReclaimPolicy": cls.get("reclaimPolicy",
                                                     "Delete"),
            "hostPath": {"path": f"/var/lib/k8s-tpu/{pv_name}"},
        }
        if selected_node:
            pv["spec"]["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
                {"matchExpressions": [{"key": "kubernetes.io/hostname",
                                       "operator": "In",
                                       "values": [selected_node]}]}]}}
        try:
            self.client.create(PVS, pv)
        except kv.AlreadyExistsError:
            pass
        self._bind(pvc, pv)

    def _ensure_bound_status(self, pvc: Obj) -> None:
        if (pvc.get("status") or {}).get("phase") == "Bound":
            return
        pv = self.pv_informer.get("", (pvc.get("spec") or {}).get("volumeName"))
        if pv is None:
            return

        def patch(o):
            o.setdefault("status", {})["phase"] = "Bound"
            return o
        try:
            self.client.guaranteed_update(PVCS, meta.namespace(pvc),
                                          meta.name(pvc), patch)
        except kv.NotFoundError:
            pass

    # -- volumes (reclaim) ------------------------------------------------

    def _sync_volume(self, name: str) -> None:
        pv = self.pv_informer.get("", name)
        if pv is None or meta.deletion_timestamp(pv):
            return
        ref = (pv.get("spec") or {}).get("claimRef")
        if not ref:
            if (pv.get("status") or {}).get("phase") not in ("Available",):
                # the closure re-checks against the CURRENT object: the
                # informer view may lag a concurrent bind (claimRef write)
                self._set_phase(name, "Available", unless_claimed=True)
            return
        pvc = self.pvc_informer.get(ref.get("namespace", ""), ref["name"])
        if pvc is not None and (not meta.uid(pvc) or not ref.get("uid")
                                or meta.uid(pvc) == ref["uid"]):
            return  # claim alive: stays Bound
        # claim is gone: phase -> Released first (pv_controller.go
        # syncVolume), which also tells pv-protection the PV is reclaimable
        if (pv.get("status") or {}).get("phase") != "Released":
            self._set_phase(name, "Released")
            return  # the MODIFIED event re-enters with phase Released
        policy = (pv.get("spec") or {}).get("persistentVolumeReclaimPolicy",
                                            "Retain")
        if policy == "Delete":
            try:
                self.client.delete(PVS, "", name)
            except kv.NotFoundError:
                pass
        elif policy == "Recycle":
            def scrub(o):
                o["spec"].pop("claimRef", None)
                o.setdefault("status", {})["phase"] = "Available"
                return o
            try:
                self.client.guaranteed_update(PVS, "", name, scrub)
            except kv.NotFoundError:
                pass
        # Retain: stays Released until an admin intervenes

    def _set_phase(self, name: str, phase: str,
                   unless_claimed: bool = False) -> None:
        def patch(o):
            if unless_claimed and (o.get("spec") or {}).get("claimRef"):
                return o
            o.setdefault("status", {})["phase"] = phase
            return o
        try:
            self.client.guaranteed_update(PVS, "", name, patch)
        except kv.NotFoundError:
            pass


class PVCProtectionController(Controller):
    """pvcprotection: finalizer lifecycle (pvc_protection_controller.go)."""

    name = "pvc-protection"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pvc_informer = factory.informer(PVCS)
        self.pod_informer = factory.informer(PODS)
        self.pvc_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod, old) -> None:
        for claim in _pvc_names(pod):
            self.enqueue_key(f"{meta.namespace(pod)}/{claim}")

    def _in_use(self, ns: str, claim: str) -> bool:
        for p in self.pod_informer.list(ns):
            if meta.pod_is_terminal(p):
                continue
            if claim in _pvc_names(p):
                return True
        return False

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.pvc_informer.get(ns, name)
        if pvc is None:
            return
        fins = pvc["metadata"].get("finalizers") or []
        deleting = bool(meta.deletion_timestamp(pvc))
        if not deleting and PVC_PROTECTION_FINALIZER not in fins:
            def add(o):
                f = o["metadata"].setdefault("finalizers", [])
                if PVC_PROTECTION_FINALIZER not in f:
                    f.append(PVC_PROTECTION_FINALIZER)
                return o
            try:
                self.client.guaranteed_update(PVCS, ns, name, add)
            except kv.NotFoundError:
                pass
        elif deleting and PVC_PROTECTION_FINALIZER in fins \
                and not self._in_use(ns, name):
            def remove(o):
                f = o["metadata"].get("finalizers") or []
                o["metadata"]["finalizers"] = [
                    x for x in f if x != PVC_PROTECTION_FINALIZER]
                return o
            try:
                self.client.guaranteed_update(PVCS, ns, name, remove)
            except kv.NotFoundError:
                pass


class PVProtectionController(Controller):
    """pvprotection (pv_protection_controller.go)."""

    name = "pv-protection"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pv_informer = factory.informer(PVS)
        self.pv_informer.add_event_handler(
            lambda t, obj, old: self.enqueue_key(meta.name(obj)))

    def sync(self, key: str) -> None:
        _, name = split_key(key)
        pv = self.pv_informer.get("", name)
        if pv is None:
            return
        fins = pv["metadata"].get("finalizers") or []
        deleting = bool(meta.deletion_timestamp(pv))
        # "in use" == phase Bound (pv_protection_controller.go)
        bound = (pv.get("status") or {}).get("phase") == "Bound"
        if not deleting and PV_PROTECTION_FINALIZER not in fins:
            def add(o):
                f = o["metadata"].setdefault("finalizers", [])
                if PV_PROTECTION_FINALIZER not in f:
                    f.append(PV_PROTECTION_FINALIZER)
                return o
            try:
                self.client.guaranteed_update(PVS, "", name, add)
            except kv.NotFoundError:
                pass
        elif deleting and PV_PROTECTION_FINALIZER in fins and not bound:
            def remove(o):
                f = o["metadata"].get("finalizers") or []
                o["metadata"]["finalizers"] = [
                    x for x in f if x != PV_PROTECTION_FINALIZER]
                return o
            try:
                self.client.guaranteed_update(PVS, "", name, remove)
            except kv.NotFoundError:
                pass


class AttachDetachController(Controller):
    """attachdetach: reconcile VolumeAttachment objects + node status
    (attach_detach_controller.go reconciler, much simplified: desired =
    {(node, pv) for scheduled pods with bound PVCs})."""

    name = "attachdetach"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pod_informer = factory.informer(PODS)
        self.pvc_informer = factory.informer(PVCS)
        self.va_informer = factory.informer(VOLUMEATTACHMENTS)
        self.node_informer = factory.informer(NODES)
        self.pod_informer.add_event_handler(self._on_pod)
        self.va_informer.add_event_handler(
            lambda t, obj, old: self.enqueue_key(
                (obj.get("spec") or {}).get("nodeName", "")))

    def _on_pod(self, type_, pod, old) -> None:
        node = meta.pod_node_name(pod) or (
            meta.pod_node_name(old) if old else "")
        if node and _pvc_names(pod):
            self.enqueue_key(node)

    def _desired_for_node(self, node: str) -> set[str]:
        want: set[str] = set()
        for p in self.pod_informer.list(None):
            if meta.pod_node_name(p) != node or meta.pod_is_terminal(p):
                continue
            for claim in _pvc_names(p):
                pvc = self.pvc_informer.get(meta.namespace(p), claim)
                vol = (pvc or {}).get("spec", {}).get("volumeName")
                if vol:
                    want.add(vol)
        return want

    def sync(self, key: str) -> None:
        _, node = split_key(key)
        if not node:
            return
        want = self._desired_for_node(node)
        have: dict[str, Obj] = {}
        for va in self.va_informer.list(None):
            spec = va.get("spec") or {}
            if spec.get("nodeName") == node:
                have[(spec.get("source") or {}).get("persistentVolumeName",
                                                    "")] = va
        for vol in want - set(have):
            # reference names are csi-<sha256(attacher+vol+node)> BECAUSE
            # concatenation is ambiguous: (node "a", vol "b-c") and
            # (node "a-b", vol "c") both make "a-b-c".  Always digest.
            import hashlib
            va_name = "va-" + hashlib.sha256(
                f"{node}/{vol}".encode()).hexdigest()[:32]
            va = meta.new_object("VolumeAttachment", va_name, None)
            va["spec"] = {"attacher": "tpu.kubernetes.io/host-attacher",
                          "nodeName": node,
                          "source": {"persistentVolumeName": vol}}
            va["status"] = {"attached": True}
            try:
                self.client.create(VOLUMEATTACHMENTS, va)
            except kv.AlreadyExistsError:
                pass
        for vol, va in have.items():
            if vol not in want:
                try:
                    self.client.delete(VOLUMEATTACHMENTS, "", meta.name(va))
                except kv.NotFoundError:
                    pass
        self._update_node_status(node, sorted(want))

    def _update_node_status(self, node: str, vols: list[str]) -> None:
        n = self.node_informer.get("", node)
        if n is None:
            return
        attached = [{"name": v, "devicePath": ""} for v in vols]
        if (n.get("status") or {}).get("volumesAttached") == attached:
            return

        def patch(o):
            o.setdefault("status", {})["volumesAttached"] = attached
            return o
        try:
            self.client.guaranteed_update(NODES, "", node, patch)
        except kv.NotFoundError:
            pass


class EphemeralVolumeController(Controller):
    """ephemeral: create PVCs for generic ephemeral volumes
    (pkg/controller/volume/ephemeral/controller.go)."""

    name = "ephemeral-volume"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pod_informer = factory.informer(PODS)
        self.pvc_informer = factory.informer(PVCS)
        self.pod_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pod = self.pod_informer.get(ns, name)
        if pod is None or meta.pod_is_terminal(pod):
            return
        for v in (pod.get("spec") or {}).get("volumes") or ():
            eph = v.get("ephemeral")
            if not eph:
                continue
            pvc_name = f"{name}-{v.get('name', 'vol')}"
            if self.pvc_informer.get(ns, pvc_name) is not None:
                continue
            tmpl = eph.get("volumeClaimTemplate") or {}
            pvc = meta.new_object("PersistentVolumeClaim", pvc_name, ns)
            tmpl_meta = tmpl.get("metadata") or {}
            if tmpl_meta.get("labels"):
                pvc["metadata"]["labels"] = dict(tmpl_meta["labels"])
            pvc["metadata"]["ownerReferences"] = [owner_ref(pod, "Pod")]
            pvc["spec"] = meta.deep_copy(tmpl.get("spec") or {
                "accessModes": ["ReadWriteOnce"],
                "resources": {"requests": {"storage": "1Gi"}}})
            try:
                self.client.create(PVCS, pvc)
            except kv.AlreadyExistsError:
                pass


class VolumeExpandController(Controller):
    """PVC expansion (pkg/controller/volume/expand/expand_controller.go):
    a bound claim whose requested storage grew past its status capacity
    gets its PV resized — gated on the StorageClass declaring
    `allowVolumeExpansion: true`, like the reference.  The simulated
    volume plane "resizes" instantly: PV capacity and PVC
    status.capacity follow the new request and the
    FileSystemResizePending dance collapses to one status write."""

    name = "persistentvolume-expander"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.pvc_informer = factory.informer(PVCS)
        self.sc_informer = factory.informer(STORAGECLASSES)
        self.pvc_informer.add_event_handler(
            lambda t, pvc, old: self.enqueue(pvc))
        # allowVolumeExpansion flipping true must wake claims that were
        # rejected at the gate: there is no periodic resync backstop
        self.sc_informer.add_event_handler(self._on_class)

    def _on_class(self, type_, sc: Obj, old: Obj | None) -> None:
        name = meta.name(sc)
        for pvc in self.pvc_informer.list(None):
            if (pvc.get("spec") or {}).get("storageClassName") == name:
                self.enqueue(pvc)

    def _expandable(self, pvc: Obj) -> bool:
        sc_name = (pvc.get("spec") or {}).get("storageClassName")
        if not sc_name:
            return False
        sc = self.sc_informer.get("", sc_name)
        return bool(sc and sc.get("allowVolumeExpansion"))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        pvc = self.pvc_informer.get(ns, name)
        if pvc is None or meta.deletion_timestamp(pvc):
            return
        spec = pvc.get("spec") or {}
        vol_name = spec.get("volumeName")
        status = pvc.get("status") or {}
        if not vol_name or status.get("phase") != "Bound":
            return
        pv = self.factory.informer(PVS).get("", vol_name)
        if pv is None:
            try:
                pv = self.client.get(PVS, "", vol_name)
            except kv.NotFoundError:
                return
        # compare against the VOLUME's capacity, never pvc.status (the
        # binder doesn't maintain status.capacity; a status-derived
        # `have` of 0 would shrink every statically-bound oversized PV
        # down to its claim's request on first sync)
        want = _capacity(pvc, "pvc")
        have = _capacity(pv, "pv")
        if want <= have:
            # catch up a stale status.capacity: the PV write and the
            # claim-status write are two transactions, and a crash or
            # transient failure between them must converge on retry
            pv_size = ((pv.get("spec") or {}).get("capacity")
                       or {}).get("storage")
            tracked = (status.get("capacity") or {}).get("storage")
            if tracked is not None and pv_size is not None \
                    and tracked != pv_size:
                def catch_up(c: Obj) -> Obj:
                    c.setdefault("status", {}).setdefault(
                        "capacity", {})["storage"] = pv_size
                    return c
                try:
                    self.client.guaranteed_update(PVCS, ns, name,
                                                  catch_up)
                except kv.NotFoundError:
                    pass
            return
        if not self._expandable(pvc):
            return  # reference: rejected unless the class allows it
        new_size = (spec.get("resources") or {})["requests"]["storage"]

        def grow_pv(pv: Obj) -> Obj:
            pv.setdefault("spec", {}).setdefault(
                "capacity", {})["storage"] = new_size
            return pv

        def grow_claim_status(c: Obj) -> Obj:
            c.setdefault("status", {}).setdefault(
                "capacity", {})["storage"] = new_size
            return c
        try:
            self.client.guaranteed_update(PVS, "", vol_name, grow_pv)
            self.client.guaranteed_update(PVCS, ns, name,
                                          grow_claim_status)
        except kv.NotFoundError:
            return
        self.client.create_event(pvc, "VolumeResizeSuccessful",
                                 f"expanded to {new_size}")
