"""API aggregation: APIService routing/proxying.

Reference: staging/src/k8s.io/kube-aggregator — APIService objects map an
API group/version to a backing service; the aggregation layer sits in
front of kube-apiserver and proxies /apis/<group>/<version>/** to the
registered backend (proxy handler in pkg/apiserver/handler_proxy.go),
serving local groups itself.  Availability is tracked per APIService
(status condition Available), recorded from proxy outcomes on transitions.

An APIService object here:
  metadata.name: "<version>.<group>"  (e.g. "v1beta1.metrics.example.com")
  spec.service.url: backend base URL (our stand-in for service+port
      resolution — the reference resolves a Service reference through the
      cluster network; we are single-host)
  spec.group / spec.version: parsed from name when absent
"""

from __future__ import annotations

import logging
import threading
import urllib.error
import urllib.request

from ..api import meta
from ..store import kv

logger = logging.getLogger(__name__)

APISERVICES = "apiservices"

HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "te",
               "upgrade", "proxy-authorization", "proxy-authenticate",
               "content-length", "host"}


class AggregatorRegistry:
    """Maps (group, version) -> backend URL, fed by APIService objects."""

    def __init__(self, store: kv.MemoryStore,
                 local_groups: frozenset[str] | set[str] = frozenset(),
                 is_local=None):
        self.store = store
        # groups the apiserver serves itself.  The reference pre-registers
        # Local APIService objects for built-in groups (kube-aggregator
        # pkg/apiserver/apiservice.go) and its autoregister controller does
        # the same for established CRD groups, so a service-backed
        # APIService can never shadow either.  We enforce the same
        # precedence: a static builtin set plus a dynamic predicate
        # (CRD groups establish AFTER an APIService may have been applied,
        # so the authoritative check happens at resolve time).
        self._local_groups = frozenset(local_groups)
        self._is_local_extra = is_local or (lambda group: False)
        self._lock = threading.Lock()
        # (group, version) -> (backend url, APIService name)
        self._routes: dict[tuple[str, str], tuple[str, str]] = {}
        self._available: dict[str, bool] = {}  # APIService name -> last state
        items, rev = store.list(APISERVICES)
        for obj in items:
            self._apply(obj)
        self._stop = threading.Event()
        # watch resumes from the LIST revision: an APIService created
        # between the list and watch registration must not be lost
        self._watch_thread = threading.Thread(
            target=self._watch_loop, args=(rev,), name="aggregator-watch",
            daemon=True)
        self._watch_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def known_group_versions(self) -> dict[str, set[str]]:
        """group -> versions served by registered (service-backed)
        APIServices — merged into /apis discovery alongside builtins and
        CRDs so advertised groups are reachable at their real versions."""
        out: dict[str, set[str]] = {}
        with self._lock:
            for group, version in self._routes:
                out.setdefault(group, set()).add(version)
        return out

    def _parse(self, obj: dict) -> tuple[str, str] | None:
        spec = obj.get("spec") or {}
        group, version = spec.get("group"), spec.get("version")
        if not (group and version):
            nm = meta.name(obj)
            version, _, group = nm.partition(".")
        if not version:
            return None
        return (group or "", version)

    def _apply(self, obj: dict, deleted: bool = False) -> None:
        gv = self._parse(obj)
        if gv is None:
            return
        if self._group_is_local(gv[0]):
            # locally-served group: ignore the route so an APIService
            # cannot hijack e.g. apps/v1 or an established CRD's traffic
            if not deleted:
                logger.warning(
                    "aggregator: ignoring APIService %s for locally-served "
                    "group %r", meta.name(obj), gv[0])
            return
        url = ((obj.get("spec") or {}).get("service") or {}).get("url")
        with self._lock:
            if deleted or not url:
                self._routes.pop(gv, None)
            else:
                self._routes[gv] = (url.rstrip("/"), meta.name(obj))

    def _watch_loop(self, since_rv: int) -> None:
        w = self.store.watch(APISERVICES, since_rv=since_rv)
        while not self._stop.is_set():
            ev = w.next(timeout=0.5)
            if ev is None:
                continue
            self._apply(ev.object, deleted=(ev.type == kv.DELETED))
        w.stop()

    def backend_for(self, group: str, version: str) -> str | None:
        with self._lock:
            route = self._routes.get((group, version))
            return route[0] if route else None

    def set_availability(self, obj_name: str, available: bool,
                         message: str = "") -> None:
        """Record the Available condition (apiservice status controller)."""
        def patch(o):
            conds = o.setdefault("status", {}).setdefault("conditions", [])
            conds[:] = [c for c in conds if c.get("type") != "Available"]
            conds.append({"type": "Available",
                          "status": "True" if available else "False",
                          "message": message})
            return o
        try:
            self.store.guaranteed_update(APISERVICES, "", obj_name, patch)
        except kv.StoreError:
            pass

    # -- the proxy -------------------------------------------------------

    def _group_is_local(self, group: str) -> bool:
        return (group == "" or group in self._local_groups
                or self._is_local_extra(group))

    def resolve(self, path: str) -> tuple[str, str] | None:
        """(backend url, APIService name) for a proxied path, else None.
        The single route lookup — callers pass the result to proxy_open.
        Locally-served groups (builtins + established CRDs) never resolve
        to a backend, even if a route slipped in before the CRD
        established."""
        parts = [p for p in path.split("/") if p]
        if len(parts) < 3 or parts[0] != "apis":
            return None
        if self._group_is_local(parts[1]):
            return None
        with self._lock:
            return self._routes.get((parts[1], parts[2]))

    def proxy_open(self, backend: str, svc_name: str, method: str, path: str,
                   query: str, body: bytes | None, headers: dict):
        """Open the backend request; returns (status, headers, resp) where
        resp is a file-like to STREAM from (so watch streams relay instead
        of buffering).  Availability transitions are recorded on the
        APIService's Available condition: only CONNECTION failures mark it
        unavailable — an idle-stream timeout mid-relay just ends the
        stream (the client re-watches, reflector semantics)."""
        import io
        url = backend + path + (f"?{query}" if query else "")
        fwd = {k: v for k, v in headers.items()
               if k.lower() not in HOP_HEADERS}
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=fwd)
        try:
            # Cluster-network egress (egress.py): aggregated backends may
            # live behind a konnectivity-style tunnel
            from .egress import CLUSTER, default_selector
            resp = default_selector.open(CLUSTER, req, 30)
            self._observe_availability(svc_name, True)
            return resp.status, dict(resp.headers), resp
        except urllib.error.HTTPError as e:
            # backend responded: it IS available, just unhappy
            self._observe_availability(svc_name, True)
            return e.code, dict(e.headers or {}), e
        except (urllib.error.URLError, OSError) as e:
            logger.warning("aggregator: backend %s unreachable: %s", url, e)
            self._observe_availability(svc_name, False, str(e))
            return (503, {"Content-Type": "application/json"},
                    io.BytesIO(b'{"kind":"Status","status":"Failure",'
                               b'"reason":"ServiceUnavailable",'
                               b'"message":"aggregated apiserver '
                               b'unreachable"}'))

    def proxy(self, method: str, path: str, query: str, body: bytes | None,
              headers: dict) -> tuple[int, dict, bytes] | None:
        """One-shot convenience (tests): resolve + open + read fully."""
        route = self.resolve(path)
        if route is None:
            return None
        status, hdrs, resp = self.proxy_open(route[0], route[1], method,
                                             path, query, body, headers)
        with resp:
            return status, hdrs, resp.read()

    def _observe_availability(self, svc_name: str, available: bool,
                              message: str = "") -> None:
        """Write the Available condition only on transitions (keeps the
        per-request path write-free in steady state)."""
        with self._lock:
            if self._available.get(svc_name) == available:
                return
            self._available[svc_name] = available
        self.set_availability(svc_name, available, message)
