"""EndpointSlice mirroring controller.

Reference: pkg/controller/endpointslicemirroring/ — custom Endpoints
objects (their Service has NO selector, so the normal EndpointSlice
controller ignores the Service) are mirrored into EndpointSlices so
slice-only consumers (the proxier here reads slices) see
manually-managed backends too.  Skipped when the Endpoints carries the
`endpointslice.kubernetes.io/skip-mirror` label or the Service does
not exist; mirrored slices carry the service-name label plus
`endpointslice.kubernetes.io/managed-by: endpointslicemirroring-
controller.k8s.io` and are deleted when their Endpoints goes away.

A copy of kubernetes_tpu/controllers/endpointslicemirroring.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import ENDPOINTS, ENDPOINTSLICES, SERVICES
from ..store import kv
from .base import Controller, owner_ref, split_key
from .endpointslice import SERVICE_NAME_LABEL

logger = logging.getLogger(__name__)

SKIP_MIRROR_LABEL = "endpointslice.kubernetes.io/skip-mirror"
MANAGED_BY_LABEL = "endpointslice.kubernetes.io/managed-by"
MANAGED_BY = "endpointslicemirroring-controller.k8s.io"


class EndpointSliceMirroringController(Controller):
    name = "endpointslicemirroring"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.ep_informer = factory.informer(ENDPOINTS)
        self.svc_informer = factory.informer(SERVICES)
        self.ep_informer.add_event_handler(
            lambda t, ep, old: self.enqueue(ep))
        self.svc_informer.add_event_handler(
            lambda t, svc, old: self.enqueue(svc))
        # recover mirrors that something else deleted/modified
        factory.informer(ENDPOINTSLICES).add_event_handler(
            self._on_slice)

    def _on_slice(self, type_, sl: Obj, old: Obj | None) -> None:
        labels = meta.labels(sl)
        if labels.get(MANAGED_BY_LABEL) == MANAGED_BY \
                and labels.get(SERVICE_NAME_LABEL):
            self.enqueue_key(f"{meta.namespace(sl)}/"
                             f"{labels[SERVICE_NAME_LABEL]}")

    def _mirror_slices(self, ep: Obj) -> list[Obj]:
        """Desired slices for one Endpoints object: one slice per
        subset (custom Endpoints are small; the reference also chunks
        at 1000/slice)."""
        ns, name = meta.namespace(ep), meta.name(ep)
        out = []
        for i, subset in enumerate(ep.get("subsets") or ()):
            endpoints = [
                {"addresses": [a.get("ip")],
                 "conditions": {"ready": True},
                 **({"targetRef": a["targetRef"]}
                    if a.get("targetRef") else {})}
                for a in subset.get("addresses") or ()]
            endpoints += [
                {"addresses": [a.get("ip")],
                 "conditions": {"ready": False}}
                for a in subset.get("notReadyAddresses") or ()]
            if not endpoints:
                continue
            out.append({
                "apiVersion": "discovery.k8s.io/v1",
                "kind": "EndpointSlice",
                "metadata": {
                    "name": f"{name}-mirror-{i}",
                    "namespace": ns,
                    "labels": {SERVICE_NAME_LABEL: name,
                               MANAGED_BY_LABEL: MANAGED_BY},
                    "ownerReferences": [owner_ref(ep, "Endpoints")],
                },
                "addressType": "IPv4",
                "endpoints": endpoints,
                "ports": [
                    {"name": p.get("name", ""), "port": p.get("port"),
                     "protocol": p.get("protocol", "TCP")}
                    for p in subset.get("ports") or ()],
            })
        return out

    def _existing_mirrors(self, ns: str, name: str) -> list[Obj]:
        return [s for s in self.factory.informer(ENDPOINTSLICES).list(ns)
                if (meta.labels(s).get(MANAGED_BY_LABEL) == MANAGED_BY
                    and meta.labels(s).get(SERVICE_NAME_LABEL) == name)]

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        ep = self.ep_informer.get(ns, name)
        svc = self.svc_informer.get(ns, name)
        mirror = (
            ep is not None and not meta.deletion_timestamp(ep)
            and SKIP_MIRROR_LABEL not in meta.labels(ep)
            and svc is not None
            and not (svc.get("spec") or {}).get("selector"))
        desired = self._mirror_slices(ep) if mirror else []
        want = {meta.name(s): s for s in desired}
        have = {meta.name(s): s for s in self._existing_mirrors(ns, name)}
        for stale in set(have) - set(want):
            try:
                self.client.delete(ENDPOINTSLICES, ns, stale)
            except kv.NotFoundError:
                pass
        for nm, slice_ in want.items():
            cur = have.get(nm)
            if cur is None:
                try:
                    self.client.create(ENDPOINTSLICES, slice_)
                except kv.AlreadyExistsError:
                    pass
            elif (cur.get("endpoints") != slice_["endpoints"]
                  or cur.get("ports") != slice_["ports"]):
                def patch(c, slice_=slice_):
                    c["endpoints"] = slice_["endpoints"]
                    c["ports"] = slice_["ports"]
                    return c
                try:
                    self.client.guaranteed_update(ENDPOINTSLICES, ns, nm,
                                                  patch)
                except kv.NotFoundError:
                    pass
