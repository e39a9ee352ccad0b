"""EndpointSlice controller.

Reference: pkg/controller/endpointslice/ (reconciler.go) — for every Service
with a selector, maintain EndpointSlice objects naming the ready pod
endpoints, chunked at maxEndpointsPerSlice (default 100).  Slices carry the
`kubernetes.io/service-name` label tying them to their Service; stale slices
are deleted, changed ones updated in place (the reference computes a minimal
create/update/delete plan per sync; we regenerate the desired slice set and
diff it against the informer's view).

A copy of kubernetes_tpu/controllers/endpointslice.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import hashlib
import logging

from ..api import meta
from ..api.labels import selector_from_dict
from ..api.meta import Obj
from ..client.clientset import ENDPOINTSLICES, PODS, SERVICES
from ..store import kv
from .base import Controller, owner_ref, split_key
from .replicaset import pod_is_ready

logger = logging.getLogger(__name__)

MAX_ENDPOINTS_PER_SLICE = 100
SERVICE_NAME_LABEL = "kubernetes.io/service-name"


def _numeric_or_service_port(pt: dict):
    tp = pt.get("targetPort", pt.get("port"))
    return tp if isinstance(tp, int) else pt.get("port")


def _resolve_ports(svc_ports: list, pod: Obj) -> list[dict]:
    """Per-endpoint port resolution: a string targetPort names a container
    port on the pod (reference resolves named ports per endpoint in
    endpointslice/reconciler.go); unresolvable names fall back to the
    service port so the proxier never sees a non-numeric backend port."""
    out = []
    containers = (pod.get("spec") or {}).get("containers") or []
    for pt in svc_ports:
        tp = pt.get("targetPort", pt.get("port"))
        if isinstance(tp, str):
            resolved = None
            for c in containers:
                for cp in c.get("ports") or []:
                    if cp.get("name") == tp:
                        resolved = cp.get("containerPort")
                        break
                if resolved is not None:
                    break
            tp = resolved if resolved is not None else pt.get("port")
        out.append({"name": pt.get("name", ""), "port": tp,
                    "protocol": pt.get("protocol", "TCP")})
    return out


class EndpointSliceController(Controller):
    name = "endpointslice"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.svc_informer = factory.informer(SERVICES)
        self.pod_informer = factory.informer(PODS)
        self.slice_informer = factory.informer(ENDPOINTSLICES)
        self.svc_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_: str, pod: Obj, old: Obj | None) -> None:
        ns = meta.namespace(pod)
        labels = meta.labels(pod)
        old_labels = meta.labels(old) if old else {}
        for svc in self.svc_informer.list(ns):
            sel = (svc.get("spec") or {}).get("selector")
            if not sel:
                continue
            s = selector_from_dict({"matchLabels": sel})
            if s.matches(labels) or (old is not None and s.matches(old_labels)):
                self.enqueue(svc)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        svc = self.svc_informer.get(ns, name)
        # slices owned by ANOTHER manager (the mirroring controller's
        # managed-by label) are never ours to reconcile or delete —
        # reference reconciler filters on managed-by the same way
        existing = [sl for sl in self.slice_informer.list(ns)
                    if meta.labels(sl).get(SERVICE_NAME_LABEL) == name
                    and meta.labels(sl).get(
                        "endpointslice.kubernetes.io/managed-by",
                        "endpointslice-controller.k8s.io")
                    == "endpointslice-controller.k8s.io"]
        if svc is None or not (svc.get("spec") or {}).get("selector"):
            for sl in existing:
                self._delete(ns, meta.name(sl))
            return
        sel = selector_from_dict(
            {"matchLabels": (svc["spec"] or {}).get("selector") or {}})
        svc_ports = list(svc["spec"].get("ports") or ())
        # endpoints grouped by their RESOLVED port numbers: a named
        # targetPort can map to different container ports on different
        # pods, and slice ports are per-slice, so each distinct mapping
        # gets its own slice group (reference reconciler behavior)
        groups: dict[tuple, list[dict]] = {}
        for p in self.pod_informer.list(ns):
            # unready pods are included with ready=False (slices publish
            # readiness as a condition, unlike legacy Endpoints subsets)
            if (sel.matches(meta.labels(p)) and meta.pod_node_name(p)
                    and meta.deletion_timestamp(p) is None
                    and not meta.pod_is_terminal(p)):
                ports = _resolve_ports(svc_ports, p)
                groups.setdefault(
                    tuple((pt["name"], pt["port"], pt["protocol"])
                          for pt in ports), []).append({
                              "addresses": [((p.get("status") or {})
                                             .get("podIP")) or "0.0.0.0",],
                              "conditions": {"ready": pod_is_ready(p)},
                              "nodeName": meta.pod_node_name(p),
                              "targetRef": {"kind": "Pod", "namespace": ns,
                                            "name": meta.name(p),
                                            "uid": meta.uid(p)},
                          })
        if not groups:
            groups[tuple((pt.get("name", ""),
                          _numeric_or_service_port(pt), pt.get(
                              "protocol", "TCP")) for pt in svc_ports)] = []

        desired: list[Obj] = []
        for ports_key in sorted(groups):
            endpoints = sorted(groups[ports_key],
                               key=lambda e: e["targetRef"]["name"])
            ports = [{"name": nm_, "port": port_, "protocol": proto_}
                     for nm_, port_, proto_ in ports_key]
            # slice names are stable per port-group (digest suffix), so a
            # group appearing/vanishing never renames other groups' slices
            # (a shared running index would delete+recreate them and spam
            # every proxier with no-op watch events)
            gid = hashlib.sha256(repr(ports_key).encode()).hexdigest()[:8]
            chunks = [endpoints[i:i + MAX_ENDPOINTS_PER_SLICE]
                      for i in range(0, len(endpoints),
                                     MAX_ENDPOINTS_PER_SLICE)] or [[]]
            for i, chunk in enumerate(chunks):
                sl = meta.new_object("EndpointSlice",
                                     f"{name}-{gid}-{i}", ns)
                sl["metadata"]["labels"] = {SERVICE_NAME_LABEL: name}
                sl["metadata"]["ownerReferences"] = [owner_ref(svc,
                                                               "Service")]
                sl["addressType"] = "IPv4"
                sl["endpoints"] = chunk
                sl["ports"] = ports
                desired.append(sl)

        want = {meta.name(sl): sl for sl in desired}
        have = {meta.name(sl): sl for sl in existing}
        for nm, sl in want.items():
            cur = have.get(nm)
            if cur is None:
                try:
                    self.client.create(ENDPOINTSLICES, sl)
                except kv.AlreadyExistsError:
                    self.enqueue_key(key)
            elif (cur.get("endpoints") != sl["endpoints"]
                  or cur.get("ports") != sl["ports"]):
                def patch(o, _sl=sl):
                    o["endpoints"] = _sl["endpoints"]
                    o["ports"] = _sl["ports"]
                    return o
                try:
                    self.client.guaranteed_update(ENDPOINTSLICES, ns, nm, patch)
                except kv.NotFoundError:
                    self.enqueue_key(key)
        for nm in have:
            if nm not in want:
                self._delete(ns, nm)

    def _delete(self, ns: str, nm: str) -> None:
        try:
            self.client.delete(ENDPOINTSLICES, ns, nm)
        except kv.NotFoundError:
            pass
