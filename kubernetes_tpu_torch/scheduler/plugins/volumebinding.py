"""VolumeBinding — PVC/PV matching and dynamic-provisioning gating.

Reference: pkg/scheduler/framework/plugins/volumebinding/ (2,310 LoC; the
largest in-tree plugin).  Semantics reproduced:
  * PreFilter collects the pod's PVCs and classifies them bound /
    unbound-delayed (StorageClass WaitForFirstConsumer) / unbound-immediate
    (volume_binding.go PreFilter + binder.go GetPodVolumeClaims).
  * a pod with unbound IMMEDIATE-binding PVCs is unschedulable until the PV
    controller binds them (volume_binding.go:227).
  * Filter checks bound PVs' node affinity against the node and, for
    delayed-binding PVCs, finds a matching available PV (size, class,
    access modes, node affinity, unclaimed) or accepts the node if the
    class can dynamically provision (binder.go FindPodVolumes).
  * Reserve assumes the chosen PV bindings in an in-memory cache
    (binder.go AssumePodVolumes); Unreserve drops them.
  * PreBind writes the bindings through the API — PV.claimRef +
    PVC.volumeName for static matches, the selected-node annotation for
    dynamic provisioning (binder.go BindPodVolumes).

The tpu-batch path routes pods with PVCs through this per-pod oracle path
(they are rare in scheduling-throughput terms and deeply stateful).
"""

from __future__ import annotations

import threading

from ...api import meta
from ...api.quantity import parse_quantity
from ...client.clientset import PVCS, PVS, STORAGECLASSES
from ..framework import (
    FilterPlugin, PreBindPlugin, PreFilterPlugin, ReservePlugin,
)
from ..types import (
    ERROR, SKIP, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE,
    ClusterEvent, Status, _compile_node_selector_term,
    node_selector_terms_match,
)

SELECTED_NODE_ANNOTATION = "volume.kubernetes.io/selected-node"
NO_PROVISIONER = "kubernetes.io/no-provisioner"

_STATE_KEY = "VolumeBinding/state"


class _PodVolumeState:
    __slots__ = ("bound_pvcs", "delayed_pvcs", "bindings_by_node")

    def __init__(self):
        self.bound_pvcs: list[dict] = []
        self.delayed_pvcs: list[dict] = []
        # node -> list of (pvc, pv_or_None)  (None => dynamic provisioning)
        self.bindings_by_node: dict[str, list[tuple[dict, dict | None]]] = {}


def pod_pvc_names(pod: dict) -> list[str]:
    out = []
    for v in (pod.get("spec") or {}).get("volumes") or ():
        claim = (v.get("persistentVolumeClaim") or {}).get("claimName")
        if claim:
            out.append(claim)
    return out


def pv_node_affinity_matches(pv: dict, node: dict) -> bool:
    """pv.spec.nodeAffinity.required vs node labels (volume_binding checks
    via CheckNodeAffinity, k8s.io/component-helpers)."""
    affinity = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
    if not affinity:
        return True
    terms = [_compile_node_selector_term(t)
             for t in affinity.get("nodeSelectorTerms") or ()]
    return node_selector_terms_match(terms, node)


def _pvc_request(pvc: dict) -> float:
    req = (((pvc.get("spec") or {}).get("resources") or {})
           .get("requests") or {}).get("storage", "0")
    return parse_quantity(req)


def _pv_capacity(pv: dict) -> float:
    cap = ((pv.get("spec") or {}).get("capacity") or {}).get("storage", "0")
    return parse_quantity(cap)


def _access_modes_ok(pvc: dict, pv: dict) -> bool:
    want = set((pvc.get("spec") or {}).get("accessModes") or ())
    have = set((pv.get("spec") or {}).get("accessModes") or ())
    return want.issubset(have)


class VolumeBinding(PreFilterPlugin, FilterPlugin, ReservePlugin, PreBindPlugin):
    name = "VolumeBinding"
    # Reserve/PreBind act ONLY on CycleState written by this plugin's own
    # PreFilter (st is None -> immediate no-op).  The batch tail uses this
    # to prove the whole hook loop is skippable for batch-path pods, whose
    # CycleState is always empty (scheduler.Framework.batch_tail_trivial).
    state_gated = True

    def __init__(self, client=None, informer_factory=None,
                 bind_timeout: float = 30.0):
        self.client = client
        self.factory = informer_factory
        # binder.go bindTimeout: how long PreBind waits for the PV
        # controller / provisioner to complete the bindings it requested
        self.bind_timeout = bind_timeout
        self._lock = threading.Lock()
        # pv name -> pvc key it's assumed for (binder.go assumed cache)
        self._assumed: dict[str, str] = {}

    def events_to_register(self):
        return [ClusterEvent("PersistentVolumeClaim", "*"),
                ClusterEvent("PersistentVolume", "*"),
                ClusterEvent("StorageClass", "*"),
                ClusterEvent("Node", "*")]

    # -- listers -----------------------------------------------------------

    def _get(self, resource: str, namespace: str, name: str) -> dict | None:
        if self.factory is not None:
            return self.factory.informer(resource).get(namespace, name)
        if self.client is not None:
            try:
                return self.client.get(resource, namespace, name)
            except Exception:
                return None
        return None

    def _list(self, resource: str) -> list[dict]:
        if self.factory is not None:
            return self.factory.informer(resource).list()
        if self.client is not None:
            try:
                return self.client.list(resource)[0]
            except Exception:
                return []
        return []

    def _is_delayed_binding(self, pvc: dict) -> bool:
        cls_name = (pvc.get("spec") or {}).get("storageClassName")
        if not cls_name:
            return False
        cls = self._get(STORAGECLASSES, "", cls_name)
        if cls is None:
            return False
        return cls.get("volumeBindingMode") == "WaitForFirstConsumer"

    def _can_provision(self, pvc: dict) -> bool:
        cls_name = (pvc.get("spec") or {}).get("storageClassName")
        if not cls_name:
            return False
        cls = self._get(STORAGECLASSES, "", cls_name)
        if cls is None:
            return False
        return (cls.get("provisioner") or NO_PROVISIONER) != NO_PROVISIONER

    # -- extension points --------------------------------------------------

    def pre_filter(self, state, pod_info, snapshot):
        names = pod_pvc_names(pod_info.pod)
        if not names:
            return None, Status(SKIP)
        ns = meta.namespace(pod_info.pod)
        st = _PodVolumeState()
        for name in names:
            pvc = self._get(PVCS, ns, name)
            if pvc is None:
                return None, Status(
                    UNSCHEDULABLE_AND_UNRESOLVABLE,
                    f'persistentvolumeclaim "{name}" not found')
            if meta.deletion_timestamp(pvc):
                return None, Status(
                    UNSCHEDULABLE_AND_UNRESOLVABLE,
                    f'persistentvolumeclaim "{name}" is being deleted')
            if (pvc.get("spec") or {}).get("volumeName"):
                st.bound_pvcs.append(pvc)
            elif self._is_delayed_binding(pvc):
                st.delayed_pvcs.append(pvc)
            else:
                # immediate binding is the PV controller's job; wait for it
                return None, Status(
                    UNSCHEDULABLE,
                    "pod has unbound immediate PersistentVolumeClaims")
        state.write(_STATE_KEY, st)
        return None, None

    def filter(self, state, pod_info, node_info):
        st: _PodVolumeState | None = state.read(_STATE_KEY)
        if st is None:
            return None
        node = node_info.node
        for pvc in st.bound_pvcs:
            pv_name = (pvc.get("spec") or {}).get("volumeName")
            pv = self._get(PVS, "", pv_name)
            if pv is None:
                return Status(UNSCHEDULABLE,
                              f'persistentvolume "{pv_name}" not found')
            if not pv_node_affinity_matches(pv, node):
                return Status(
                    UNSCHEDULABLE,
                    "node(s) had volume node affinity conflict")
        if st.delayed_pvcs:
            bindings = self._find_bindings(st.delayed_pvcs, node)
            if bindings is None:
                return Status(UNSCHEDULABLE,
                              "node(s) didn't find available persistent"
                              " volumes to bind")
            st.bindings_by_node[node_info.name] = bindings
        return None

    def _find_bindings(self, pvcs: list[dict], node: dict
                       ) -> list[tuple[dict, dict | None]] | None:
        """binder.go FindPodVolumes: match each delayed PVC to an available
        PV on this node, else fall back to dynamic provisioning."""
        pvs = self._list(PVS)
        with self._lock:
            assumed = dict(self._assumed)
        taken: set[str] = set()
        out: list[tuple[dict, dict | None]] = []
        for pvc in pvcs:
            want_class = (pvc.get("spec") or {}).get("storageClassName")
            need = _pvc_request(pvc)
            best = None
            for pv in pvs:
                nm = meta.name(pv)
                if nm in taken or nm in assumed:
                    continue
                spec = pv.get("spec") or {}
                if spec.get("claimRef"):
                    continue
                if (spec.get("storageClassName") or "") != (want_class or ""):
                    continue
                if not _access_modes_ok(pvc, pv):
                    continue
                if _pv_capacity(pv) < need:
                    continue
                if not pv_node_affinity_matches(pv, node):
                    continue
                # smallest PV that fits (binder.go uses volume util
                # FindMatchingVolume with the same smallest-fit rule)
                if best is None or _pv_capacity(pv) < _pv_capacity(best):
                    best = pv
            if best is not None:
                taken.add(meta.name(best))
                out.append((pvc, best))
            elif self._can_provision(pvc):
                out.append((pvc, None))
            else:
                return None
        return out

    def reserve(self, state, pod_info, node_name):
        st: _PodVolumeState | None = state.read(_STATE_KEY)
        if st is None:
            return None
        with self._lock:
            for pvc, pv in st.bindings_by_node.get(node_name, ()):
                if pv is not None:
                    self._assumed[meta.name(pv)] = meta.namespaced_name(pvc)
        return None

    def unreserve(self, state, pod_info, node_name):
        st: _PodVolumeState | None = state.read(_STATE_KEY)
        if st is None:
            return
        with self._lock:
            for pvc, pv in st.bindings_by_node.get(node_name, ()):
                if pv is not None:
                    self._assumed.pop(meta.name(pv), None)

    def pre_bind(self, state, pod_info, node_name):
        st: _PodVolumeState | None = state.read(_STATE_KEY)
        if st is None or self.client is None:
            return None
        for pvc, pv in st.bindings_by_node.get(node_name, ()):
            ns, name = meta.namespace(pvc), meta.name(pvc)
            try:
                if pv is not None:
                    # static binding: PV.claimRef then PVC.volumeName.
                    # Never stomp a claimRef someone else won — the wait
                    # below detects the mismatch and fails this binding
                    # (the reference's bindAPIUpdate loses the same race
                    # to the PV controller's own binds)
                    def set_claim_ref(obj, pvc=pvc):
                        ref = (obj.get("spec") or {}).get("claimRef") or {}
                        if ref and (ref.get("namespace"),
                                    ref.get("name")) != (
                                meta.namespace(pvc), meta.name(pvc)):
                            return obj
                        obj.setdefault("spec", {})["claimRef"] = {
                            "namespace": meta.namespace(pvc),
                            "name": meta.name(pvc), "uid": meta.uid(pvc)}
                        obj.setdefault("status", {})["phase"] = "Bound"
                        return obj

                    def set_volume_name(obj, pv=pv):
                        obj.setdefault("spec", {})["volumeName"] = meta.name(pv)
                        obj.setdefault("status", {})["phase"] = "Bound"
                        return obj

                    self.client.guaranteed_update(PVS, "", meta.name(pv),
                                                  set_claim_ref)
                    self.client.guaranteed_update(PVCS, ns, name,
                                                  set_volume_name)
                    with self._lock:
                        self._assumed.pop(meta.name(pv), None)
                else:
                    # dynamic provisioning: tell the provisioner where
                    def annotate(obj, node_name=node_name):
                        obj.setdefault("metadata", {}).setdefault(
                            "annotations", {})[SELECTED_NODE_ANNOTATION] = node_name
                        return obj

                    self.client.guaranteed_update(PVCS, ns, name, annotate)
            except Exception as e:  # pragma: no cover - API failure path
                return Status(ERROR, f"binding volumes: {e}")
        # the writes above only REQUEST bindings; the PV controller (and,
        # for dynamic claims, the provisioner) must finish them before the
        # pod may bind (binder.go BindPodVolumes -> checkBindings poll)
        status = self._wait_for_bindings(st, node_name)
        if status is not None:
            self._rollback(st, node_name)
        return status

    def _wait_for_bindings(self, st: "_PodVolumeState",
                           node_name: str) -> Status | None:
        """checkBindings (binder.go:1002): poll until every requested
        binding reports Bound and each PV's claimRef still points at our
        PVC; detect conflicts (someone else took the PV) immediately."""
        import time
        bindings = st.bindings_by_node.get(node_name, ())
        if not bindings:
            return None
        deadline = time.monotonic() + self.bind_timeout
        while True:
            done = True
            for pvc, pv in bindings:
                ns, name = meta.namespace(pvc), meta.name(pvc)
                try:
                    cur = self.client.get(PVCS, ns, name)
                except Exception:
                    return Status(ERROR,
                                  f"pvc {ns}/{name} vanished while binding")
                vol = (cur.get("spec") or {}).get("volumeName")
                phase = (cur.get("status") or {}).get("phase")
                if pv is not None:
                    # static: the PV must still reference our claim
                    try:
                        cur_pv = self.client.get(PVS, "", meta.name(pv))
                    except Exception:
                        return Status(ERROR,
                                      f"pv {meta.name(pv)} vanished "
                                      "while binding")
                    ref = (cur_pv.get("spec") or {}).get("claimRef") or {}
                    if ref and (ref.get("namespace"), ref.get("name")) != \
                            (ns, name):
                        return Status(ERROR,
                                      f"pv {meta.name(pv)} was bound to a "
                                      "different claim")
                if not vol or phase != "Bound":
                    done = False
                    break
            if done:
                return None
            if time.monotonic() >= deadline:
                return Status(ERROR,
                              "timed out waiting for volume binding")
            time.sleep(0.05)

    def _rollback(self, st: "_PodVolumeState", node_name: str) -> None:
        """Failed/timed-out binding: revert what THIS plugin wrote so a
        retry can choose freely (reference: RevertAssumedPodVolumes plus
        leaving durable recovery to the PV controller; we additionally
        clear a still-unbound claim's selected-node annotation so a
        reschedule isn't pinned to the failed node).  Writes guarded by
        ownership checks — a binding that completed meanwhile is left
        alone."""
        for pvc, pv in st.bindings_by_node.get(node_name, ()):
            ns, name = meta.namespace(pvc), meta.name(pvc)
            try:
                if pv is not None:
                    def clear_ref(obj, pvc=pvc):
                        ref = (obj.get("spec") or {}).get("claimRef") or {}
                        if (ref.get("namespace"), ref.get("name")) == \
                                (meta.namespace(pvc), meta.name(pvc)):
                            obj["spec"].pop("claimRef", None)
                            obj.setdefault("status", {})["phase"] = \
                                "Available"
                        return obj
                    self.client.guaranteed_update(PVS, "", meta.name(pv),
                                                  clear_ref)

                    def clear_vol(obj, pv=pv):
                        # we wrote volumeName (and the Bound phase) for
                        # this static binding, so it is ours to revert;
                        # the wait already proved the PV does NOT
                        # reference this claim
                        spec = obj.setdefault("spec", {})
                        if spec.get("volumeName") == meta.name(pv):
                            spec.pop("volumeName", None)
                            obj.setdefault("status", {})["phase"] = "Pending"
                        return obj
                    self.client.guaranteed_update(PVCS, ns, name, clear_vol)
                else:
                    def deannotate(obj, node_name=node_name):
                        if (obj.get("status") or {}).get("phase") == "Bound":
                            return obj  # provisioning completed: keep it
                        anns = (obj.get("metadata") or {}).get(
                            "annotations") or {}
                        if anns.get(SELECTED_NODE_ANNOTATION) == node_name:
                            anns.pop(SELECTED_NODE_ANNOTATION, None)
                        return obj
                    self.client.guaranteed_update(PVCS, ns, name, deannotate)
            except Exception:  # noqa: BLE001 — rollback is best effort
                pass
        with self._lock:
            for pvc, pv in st.bindings_by_node.get(node_name, ()):
                if pv is not None:
                    self._assumed.pop(meta.name(pv), None)
