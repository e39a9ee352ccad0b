"""REST+watch API server over the store.

Reference: the kube-apiserver serving stack, reduced to its load-bearing
contract (SURVEY.md layers 4-5):
  staging/src/k8s.io/apiserver/pkg/endpoints/installer.go:190 (routes)
    GET    /api/v1/{resource}                       list (all namespaces)
    GET    /api/v1/namespaces/{ns}/{resource}       list
    GET    /api/v1/namespaces/{ns}/{resource}/{nm}  get
    POST   /api/v1/namespaces/{ns}/{resource}       create
    PUT    /api/v1/namespaces/{ns}/{resource}/{nm}  update (CAS -> 409)
    PATCH  ...                                      merge/json/strategic patch
    DELETE /api/v1/namespaces/{ns}/{resource}/{nm}  delete
    GET    ...?watch=true&resourceVersion=N         newline-delimited JSON
                                                    event stream
  /apis/{group}/{version}/... serves the same verbs for grouped + custom
  resources (apiextensions-apiserver shape); subresources:
    PUT/PATCH .../{name}/status      status-only writes (registry strategies)
    POST      .../pods/{name}/binding    writes spec.nodeName (scheduler)
    POST      .../pods/{name}/eviction   PDB-checked delete (429 if blocked)
    GET/PUT   .../{name}/scale           replica count subresource

Handler chain (DefaultBuildHandlerChain, server/config.go:813, in order):
  request log -> authn (bearer token) -> audit -> API priority & fairness
  -> authorization (RBAC, rbac.py)
  -> route -> admission chain (mutating then validating) -> registry/store.

Errors are metav1.Status-shaped JSON with the right HTTP codes
(404/409/410 Gone for compacted watches/422 validation/429 APF).
Cluster-scoped resources (nodes, ...) use an empty namespace key; the routes
also accept /api/v1/{resource}/{name} for them.

This is the JAX package's apiserver with its imports pointing at this
package.  One field differs: GET /version reports "platform": "gpu", the
device this package's scheduler runs on.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlencode, urlparse

from .. import __version__
from ..api import core_versions as corever
from ..api import meta
from ..component_base import configz
from ..store import kv
from . import admission as adm
from . import audit as auditlib
from . import authn as authnlib
from . import crd as crdlib
from . import flowcontrol
from . import managedfields as mflib
from . import patch as patchlib
from . import rbac as rbaclib

logger = logging.getLogger(__name__)

from ..client.clientset import CLUSTER_SCOPED_RESOURCES

# alias, not a copy (a fork would re-split client/server scoping); the
# server enforces it on create: namespaced paths for these 400, and any
# client-supplied metadata.namespace is stripped so storage keys match
# the cluster-scoped read paths
CLUSTER_SCOPED = CLUSTER_SCOPED_RESOURCES

SUBRESOURCES = {"status", "binding", "eviction", "scale"}

# pod-only subresources served by tunneling to the pod's kubelet
# (pkg/registry/core/pod/rest/subresources.go -> UpgradeAwareProxy);
# routed only for pods and only on GET/POST — never as write targets
NODE_STREAM_SUBRESOURCES = {"log", "exec", "attach", "portforward"}

# subresources with no stored object behind them: tunnels + token minting
# (serviceaccounts/{name}/token is POST-only, token.go) — a write verb
# must never fall through to the parent object
VIRTUAL_SUBRESOURCES = NODE_STREAM_SUBRESOURCES | {"token"}

# built-in group routing (/apis/{group}/{version}); all resources share the
# flat store namespace, so the group prefix is addressing only
BUILTIN_GROUPS = {
    "apps": {"deployments", "replicasets", "statefulsets", "daemonsets"},
    "batch": {"jobs", "cronjobs"},
    "policy": {"poddisruptionbudgets"},
    "scheduling.k8s.io": {"priorityclasses"},
    "storage.k8s.io": {"storageclasses", "csinodes", "volumeattachments"},
    "coordination.k8s.io": {"leases"},
    "apiextensions.k8s.io": {crdlib.CRDS},
    "autoscaling": {"horizontalpodautoscalers"},
    "certificates.k8s.io": {"certificatesigningrequests"},
    "discovery.k8s.io": {"endpointslices"},
    "apiregistration.k8s.io": {"apiservices"},
    "flowcontrol.apiserver.k8s.io": {"flowschemas",
                                     "prioritylevelconfigurations"},
}

SCALABLE = {"deployments", "replicasets", "statefulsets",
            "replicationcontrollers"}


class AdmissionError(Exception):
    pass


def status_error(code: int, reason: str, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "message": message, "code": code}


def bind_conflict_status(err) -> dict:
    """409 Status for kv.BindConflict with the structured fields in
    `details`, so an HTTP scheduler rehydrates the same typed error a
    LocalClient one sees (the already_bound_same_node classification
    needs current_node, not message parsing)."""
    status = status_error(409, "BindConflict", str(err))
    status["details"] = {"name": err.key,
                         "currentNode": err.current_node,
                         "wantedNode": err.wanted_node}
    return status


class _QuietTLSServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that doesn't spray tracebacks when a TLS
    handshake fails (wrong client CA, plain-HTTP probe, port scan) —
    those are client errors, not server bugs.  Genuine server faults
    (bare OSError: ENOSPC, EMFILE) still get the full report."""

    def handle_error(self, request, client_address):
        import ssl
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ssl.SSLError, ConnectionError, TimeoutError)):
            logger.debug("connection error from %s: %s",
                         client_address, exc)
            return
        super().handle_error(request, client_address)


class _Route:
    __slots__ = ("resource", "ns", "name", "subresource", "group", "version",
                 "query", "path")

    def __init__(self, resource=None, ns=None, name=None, subresource=None,
                 group=None, version="v1", query=None, path=""):
        self.resource = resource
        self.ns = ns
        self.name = name
        self.subresource = subresource
        self.group = group
        self.version = version
        self.query = query or {}
        self.path = path


class APIServer:
    def __init__(self, store: kv.MemoryStore, host: str = "127.0.0.1",
                 port: int = 0, token: str | None = None,
                 tokens: dict[str, tuple[str, tuple[str, ...]]] | None = None,
                 enable_rbac: bool = False,
                 bootstrap_token_auth: bool = False,
                 admission_chain: adm.Chain | None = None,
                 enable_default_admission: bool = False,
                 flow_dispatcher: flowcontrol.Dispatcher | None = None,
                 audit_logger: auditlib.AuditLogger | None = None,
                 tls: dict | None = None,
                 enable_service_accounts: bool = False,
                 disable_admission_plugins: set | frozenset = frozenset()):
        self.store = store
        self.token = token
        # static bearer tokens -> identity (the reference's token-auth
        # file: one line per token,user,groups).  The legacy single
        # `token` becomes a superuser credential.
        self.tokens = dict(tokens or {})
        if token is not None:
            self.tokens.setdefault(
                token, ("system:admin", (rbaclib.SUPERUSER_GROUP,)))
        # --authorization-mode=Node,RBAC: the node authorizer scopes
        # kubelet certs to their own node's objects; RBAC covers the rest
        self.authorizer = rbaclib.CompositeAuthorizer(
            [rbaclib.NodeAuthorizer(store),
             rbaclib.RBACAuthorizer(store)]) if enable_rbac else None
        # bootstrap token authenticator (plugin/pkg/auth/authenticator/
        # token/bootstrap): live lookup of kube-system bootstrap Secrets,
        # so `kubeadm join --token` credentials work without restarting
        self.bootstrap_token_auth = bootstrap_token_auth
        self.admission_hooks: list = []  # legacy fn(verb, resource, obj) hooks

        def _authorize_for_admission(user, groups, verb, resource,
                                     subresource, ns, name) -> bool:
            """OwnerReferencesPermissionEnforcement's authorizer seam."""
            if self.authorizer is None:
                return True
            return self.authorizer.authorize(rbaclib.Attributes(
                user, tuple(groups), verb, resource, subresource, ns,
                name))

        self.admission_chain = admission_chain or (
            adm.default_chain(store, _authorize_for_admission,
                              disable=disable_admission_plugins)
            if enable_default_admission else adm.Chain())
        self.flow = flow_dispatcher  # None = APF filter disabled
        self.audit = audit_logger
        self.crds = crdlib.CRDRegistry()
        from . import aggregator as agglib
        self.aggregator = agglib.AggregatorRegistry(
            store, local_groups=set(BUILTIN_GROUPS),
            is_local=lambda group: group in self.crds.groups())
        self.metrics = {"requests_total": 0, "watch_streams": 0,
                        "requests_rejected_total": 0}
        self._metrics_lock = threading.Lock()
        # re-establish CRDs already persisted (restart = re-list, crash-only)
        try:
            existing, _ = store.list(crdlib.CRDS)
            for obj in existing:
                try:
                    self.crds.establish(obj)
                except crdlib.ValidationError:
                    logger.warning("skipping invalid persisted CRD %s",
                                   meta.name(obj))
        except Exception:  # noqa: BLE001 — store without that resource yet
            pass
        # ServiceAccount token issuer (TokenRequest + SA JWT authn —
        # pkg/serviceaccount/jwt.go); opt-in: it persists a signing-key
        # Secret in kube-system
        self.sa_issuer = (authnlib.ServiceAccountIssuer(store)
                          if enable_service_accounts else None)
        handler = self._make_handler()
        self.httpd = _QuietTLSServer((host, port), handler)
        self.httpd.daemon_threads = True
        # TLS serving + X.509 client-cert authn (x509.go): wrap the
        # listening socket; a client cert chained to client_ca_file
        # authenticates as CN/O
        self.tls = tls
        self.client_ca_auth = bool(tls and tls.get("client_ca_file"))
        if tls:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=tls["cert_file"],
                                keyfile=tls["key_file"])
            if self.client_ca_auth:
                ctx.load_verify_locations(cafile=tls["client_ca_file"])
                ctx.verify_mode = ssl.CERT_OPTIONAL
            # handshake deferred to the per-request handler thread
            # (Handler.setup): with do_handshake_on_connect=True a single
            # silent client would stall the accept loop — and every
            # other connection — for the duration of its handshake
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True,
                do_handshake_on_connect=False)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def _bootstrap_identity(self, token: str
                            ) -> tuple[str, tuple[str, ...]] | None:
        import hmac as hmaclib
        import time as timelib
        tid, _, tsec = token.partition(".")
        if not tid or not tsec:
            return None
        try:
            sec = self.store.get("secrets", "kube-system",
                                 f"bootstrap-token-{tid}")
        except kv.NotFoundError:
            return None
        if sec.get("type") != "bootstrap.kubernetes.io/token":
            return None
        data = sec.get("data") or {}
        if not hmaclib.compare_digest(str(data.get("token-secret", "")),
                                      tsec):
            return None
        if data.get("usage-bootstrap-authentication") != "true":
            return None
        exp = data.get("expiration")
        try:
            if exp is not None and float(exp) < timelib.time():
                return None
        except (TypeError, ValueError):
            return None
        return (f"system:bootstrap:{tid}", ("system:bootstrappers",))

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "APIServer":
        self.bootstrap_system()
        if self.flow is not None:
            # FlowSchema/PriorityLevelConfiguration objects drive the
            # dispatcher from here on (apf_controller.go)
            self.flow.bind_store(self.store)
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="apiserver", daemon=True)
        self._thread.start()
        return self

    def bootstrap_system(self) -> None:
        """System namespaces + the kubernetes Service — what the reference's
        controlplane bootstrap-controller materializes on startup
        (pkg/controlplane/controller.go RunKubernetesNamespaces/
        RunKubernetesService).  Idempotent; crash-only restart safe."""
        for ns in ("default", "kube-system", "kube-public",
                   "kube-node-lease"):
            obj = meta.new_object("Namespace", ns, None)
            obj["status"] = {"phase": "Active"}
            try:
                self.store.create("namespaces", obj)
            except kv.AlreadyExistsError:
                pass
        svc = meta.new_object("Service", "kubernetes", "default")
        svc["spec"] = {"type": "ClusterIP", "clusterIP": "10.96.0.1",
                       "ports": [{"name": "https", "port": 443,
                                  "protocol": "TCP",
                                  "targetPort": self.port}]}
        try:
            self.store.create("services", svc)
        except kv.AlreadyExistsError:
            pass
        if self.authorizer is not None:
            rbaclib.bootstrap_policy(self.store)

    def stop(self) -> None:
        if self.authorizer is not None:
            self.authorizer.stop()
        if self.flow is not None:
            self.flow.stop()
        self.aggregator.stop()
        self.httpd.shutdown()
        self.httpd.server_close()  # release the listening socket

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.httpd.server_address[0]}:{self.port}"

    # -- request handling ------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # response head and body go out as separate writes; with
            # Nagle on, the body waits for the client's delayed ACK —
            # a measured 40ms stall PER REQUEST on loopback (23 ->
            # 2700 req/s when disabled)
            disable_nagle_algorithm = True

            def setup(self):
                # deferred TLS handshake (see the wrap_socket call):
                # bounded so a silent peer costs one handler thread for
                # 30s, not the accept loop.  self.connection doesn't
                # exist until super().setup(); the raw socket is
                # self.request here.
                if hasattr(self.request, "do_handshake"):
                    self.request.settimeout(30.0)
                    self.request.do_handshake()
                    self.request.settimeout(None)
                super().setup()

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("apiserver: " + fmt, *args)

            def _send_json(self, code: int, obj: dict) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _identity(self) -> tuple[str, tuple[str, ...]] | None:
                """Resolve the request's (user, groups); None = bad creds.

                A PRESENT-but-unknown bearer token is a 401.  A request
                with NO credentials authenticates as the anonymous user
                ONLY when an authorizer is configured to judge it
                (--anonymous-auth + RBAC — this is what lets `kubeadm
                join` fetch kube-public/cluster-info before it has any
                credential); with token-auth but no authorizer, anonymous
                would mean unrestricted, so it stays a 401."""
                # X.509 client cert (request/x509/x509.go): the TLS
                # layer already verified the chain against the client
                # CA; CN/O become the identity
                if server.client_ca_auth:
                    try:
                        ident = authnlib.x509_identity(
                            self.connection.getpeercert())
                    except (ValueError, OSError):
                        ident = None
                    if ident is not None:
                        user, groups = ident
                        return (user, tuple(groups)
                                + ("system:authenticated",))
                auth = self.headers.get("Authorization", "")
                authn_on = (bool(server.tokens)
                            or server.bootstrap_token_auth
                            or server.client_ca_auth
                            or server.sa_issuer is not None)
                if not authn_on or (not auth
                                    and server.authorizer is not None):
                    return ("system:anonymous", ("system:unauthenticated",))
                if auth.startswith("Bearer "):
                    bearer = auth[len("Bearer "):]
                    ident = server.tokens.get(bearer)
                    if ident is None and server.bootstrap_token_auth \
                            and "." in bearer:
                        ident = server._bootstrap_identity(bearer)
                    if ident is None and server.sa_issuer is not None \
                            and bearer.count(".") == 2:
                        ident = server.sa_issuer.verify(bearer)
                    if ident is not None:
                        # every real credential is in system:authenticated
                        # (the group system:basic-user rights bind to)
                        user, groups = ident
                        if "system:authenticated" not in groups:
                            groups = tuple(groups) + (
                                "system:authenticated",)
                        return (user, groups)
                return None

            def _user(self) -> str:
                ident = self._identity()
                return ident[0] if ident else "system:anonymous"

            def _drain_body(self) -> None:
                """Consume an unread request body before an early error
                response — leftover bytes would be parsed as the next
                request on this keep-alive connection."""
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    self.rfile.read(length)

            def _authn(self) -> bool:
                if self._identity() is not None:
                    return True
                self._drain_body()
                self._send_json(401, status_error(401, "Unauthorized",
                                                  "invalid bearer token"))
                return False

            def _maybe_proxy(self) -> bool:
                """Aggregation layer (kube-aggregator handler_proxy.go):
                requests for an /apis/<group>/<version> registered to an
                external APIService are proxied (STREAMED — watch relays
                work) to its backend.  Runs after authn/APF, and records
                the same ResponseComplete audit event local requests get."""
                from . import aggregator as agglib
                u = urlparse(self.path)
                route = server.aggregator.resolve(u.path)
                if route is None:
                    return False
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else None
                status, hdrs, resp = server.aggregator.proxy_open(
                    route[0], route[1], self.command, u.path, u.query, body,
                    dict(self.headers))
                length_hdr = next((v for k, v in hdrs.items()
                                   if k.lower() == "content-length"), None)
                has_len = length_hdr is not None
                self.send_response(status)
                for k, v in hdrs.items():
                    if k.lower() not in agglib.HOP_HEADERS:
                        self.send_header(k, v)
                if has_len:
                    # body is relayed verbatim, so the backend's length
                    # stays valid (HOP_HEADERS drops it for the loop above)
                    self.send_header("Content-Length", length_hdr)
                else:
                    # unknown length (streaming backend): relay until EOF
                    # and close — the HTTP/1.0-style framing watch clients
                    # handle fine
                    self.send_header("Connection", "close")
                self.end_headers()
                try:
                    with resp:
                        while True:
                            chunk = resp.read(65536)
                            if not chunk:
                                break
                            self.wfile.write(chunk)
                            self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # client or backend went away mid-stream
                finally:
                    if not has_len:
                        self.close_connection = True
                self._audit(self._route(), self.command.lower(), status)
                return True

            def _route(self) -> _Route | None:
                u = urlparse(self.path)
                parts = [p for p in u.path.split("/") if p]
                q = parse_qs(u.query)
                r = _Route(query=q, path=u.path)
                if not parts:
                    return r
                if parts[0] == "api":
                    # core ("legacy") group: /api/{version}/... — v1 is
                    # the hub/storage form; additional served versions go
                    # through the core conversion seam (api/core_versions)
                    if len(parts) >= 2:
                        r.version = parts[1]
                        if r.version not in corever.SERVED_VERSIONS:
                            return r  # unknown core version -> 404
                    rest = parts[2:]
                elif parts[0] == "apis" and len(parts) >= 3:
                    r.group, r.version = parts[1], parts[2]
                    rest = parts[3:]
                else:
                    return r
                if len(rest) >= 3 and rest[0] == "namespaces":
                    r.ns, r.resource = rest[1], rest[2]
                    if len(rest) > 3:
                        r.name = rest[3]
                    if len(rest) > 4:
                        known = SUBRESOURCES
                        if r.resource == "pods":
                            known = known | NODE_STREAM_SUBRESOURCES
                        elif r.resource == "serviceaccounts":
                            known = known | {"token"}
                        if rest[4] in known and len(rest) == 5:
                            r.subresource = rest[4]
                        else:  # unknown subresource -> 404
                            r.resource = None
                elif rest:
                    r.resource = rest[0]
                    if len(rest) > 1:
                        r.name = rest[1]
                    if len(rest) > 2:
                        if rest[2] in SUBRESOURCES and len(rest) == 3:
                            r.subresource = rest[2]
                        else:
                            r.resource = None
                if (parts[0] == "api" and r.resource
                        and r.version not in (None, corever.HUB)
                        and not corever.handles(r.resource, r.version)):
                    r.resource = None  # resource not served at this version
                return r

            # ---- shared filters ----

            def _begin(self, verb: str):
                """authn + APF admission. Returns (route, ticket) or None
                after writing the error response."""
                with server._metrics_lock:
                    server.metrics["requests_total"] += 1
                if not self._authn():
                    return None
                r = self._route()
                ticket = None
                # long-running requests (watches, kubelet streams) are
                # exempt from APF — a held seat for a stream's lifetime
                # would starve the level (upstream longRunningRequestCheck
                # exempts watch + exec/attach/portforward/log the same way)
                is_watch = bool(r) and r.query.get("watch",
                                                   ["false"])[0] == "true"
                is_long = is_watch or (
                    bool(r) and r.subresource in NODE_STREAM_SUBRESOURCES)
                if server.flow is not None and r and r.resource \
                        and not is_long:
                    ident = self._identity() or ("system:anonymous", ())
                    try:
                        ticket = server.flow.admit(ident[0], verb,
                                                   r.resource,
                                                   tuple(ident[1]))
                    except flowcontrol.RejectedError as e:
                        with server._metrics_lock:
                            server.metrics["requests_rejected_total"] += 1
                        self._drain_body()
                        body = json.dumps(status_error(
                            429, "TooManyRequests", str(e))).encode()
                        self.send_response(429)
                        self.send_header("Retry-After", "1")
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                        return None
                # authorization (config.go:815 — after authn/APF, before
                # routing).  Non-resource paths (healthz, version, metrics)
                # stay open, like the reference's system:discovery defaults.
                if server.authorizer is not None and r is not None \
                        and r.resource:
                    if verb == "get":
                        rverb = ("watch" if is_watch
                                 else "get" if r.name else "list")
                    elif verb == "delete" and not r.name:
                        rverb = "deletecollection"
                    else:
                        rverb = verb
                    user, groups = self._identity()
                    attrs = rbaclib.Attributes(
                        user, tuple(groups), rverb, r.resource,
                        r.subresource or "", r.ns or "", r.name or "")
                    if not server.authorizer.authorize(attrs):
                        if ticket:
                            ticket.__exit__()
                        with server._metrics_lock:
                            server.metrics["requests_rejected_total"] += 1
                        self._drain_body()
                        target = r.resource + (
                            f"/{r.subresource}" if r.subresource else "")
                        self._send_json(403, status_error(
                            403, "Forbidden",
                            f"user {user!r} cannot {rverb} {target}"
                            + (f" in namespace {r.ns!r}" if r.ns else "")))
                        self._audit(r, rverb, 403)
                        return None
                return r, ticket

            def _audit(self, r: _Route, verb: str, code: int,
                       obj: dict | None = None) -> None:
                if server.audit is not None and r is not None and r.resource:
                    server.audit.log("ResponseComplete", self._user(), verb,
                                     r.resource, r.ns or "", r.name or "",
                                     code, obj)

            # ---- verbs ----

            def do_GET(self):
                begun = self._begin("get")
                if begun is None:
                    return
                r, ticket = begun
                try:
                    if self._maybe_proxy():
                        return
                    self._do_get(r)
                finally:
                    if ticket:
                        ticket.__exit__()

            def _do_get(self, r: _Route) -> None:
                path = r.path
                if path in ("/healthz", "/readyz", "/livez"):
                    self._send_json(200, {"status": "ok"})
                    return
                if path == "/version":
                    self._send_json(200, {"gitVersion": f"v{__version__}",
                                          "platform": "gpu"})
                    return
                if path == "/configz":
                    self._send_json(200, configz.default_registry.snapshot())
                    return
                if path == "/debug/profile":
                    # collapsed stacks (flamegraph.pl format) from the
                    # process-wide sampling profiler; empty body when
                    # the profiling: stanza never started it
                    from ..component_base import profiling
                    body = profiling.default_host_profiler \
                        .collapsed().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path.startswith("/debug/timeline"):
                    # wave timeline observatory: stage intervals + the
                    # union-derived idle share from the process-wide ring
                    # (component_base/timeline.py); ?format=chrome yields
                    # a Perfetto-loadable Chrome trace, default is JSON.
                    # Empty/disabled when profiling.timeline is off.
                    from ..component_base import timeline as cb_timeline
                    tl = cb_timeline.default_timeline
                    if r.query.get("format", [""])[0] == "chrome":
                        body = json.dumps(tl.to_chrome_trace()).encode()
                    else:
                        body = tl.debug_json().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/debug/traces":
                    # recent batch traces from the process-wide flight
                    # recorder (component_base/tracing.py); empty list
                    # when tracing is off or nothing was sampled
                    from ..component_base import tracing
                    body = tracing.default_tracer_provider \
                        .debug_traces_json().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path == "/metrics":
                    with server._metrics_lock:
                        lines = [f"apiserver_{k} {v}"
                                 for k, v in server.metrics.items()]
                    if server.flow is not None:
                        for name, st in server.flow.stats().items():
                            for k, v in st.items():
                                lines.append(
                                    'apiserver_flowcontrol_%s{priority_level'
                                    '="%s"} %s' % (k, name, v))
                    body = ("\n".join(lines) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if self._maybe_discovery(path):
                    return
                if r.resource is None:
                    self._send_json(404, status_error(404, "NotFound", path))
                    return
                try:
                    if r.subresource == "token":
                        self._send_json(405, status_error(
                            405, "MethodNotAllowed",
                            "token requests are POST-only"))
                    elif r.resource == "pods" \
                            and r.subresource in NODE_STREAM_SUBRESOURCES:
                        self._node_stream(r)
                    elif r.query.get("watch", ["false"])[0] == "true":
                        self._serve_watch(r.resource, r.query, r)
                    elif r.name is not None and r.subresource == "scale":
                        is_custom = self._is_custom(r)
                        paths = (server.crds.scale_paths(r.resource)
                                 if is_custom else None)
                        if is_custom and paths is None:
                            # GET and PUT must agree the subresource
                            # doesn't exist when undeclared
                            self._send_json(404, status_error(
                                404, "NotFound",
                                f"{r.resource} has no scale subresource"))
                            return
                        obj = server.store.get(r.resource, r.ns or "", r.name)
                        self._audit(r, "get", 200)
                        if paths is not None:
                            self._send_json(200, _crd_scale(obj, paths))
                        else:
                            self._send_json(200,
                                            _scale_of(obj, r.resource))
                    elif r.name is not None:
                        obj = self._serve_custom(
                            r, server.store.get(r.resource, r.ns or "",
                                                r.name))
                        self._audit(r, "get", 200)
                        self._send_json(200, obj)
                    else:
                        sel = r.query.get("labelSelector", [None])[0]
                        fsel = r.query.get("fieldSelector", [None])[0]
                        items, rv = server.store.list(r.resource, r.ns)
                        if sel:
                            items = [o for o in items
                                     if _matches_selector(o, sel)]
                        if fsel:
                            try:
                                validate_field_selector(fsel)
                                items = [o for o in items
                                         if _matches_field_selector(
                                             o, fsel)]
                            except ValueError as e:
                                self._send_json(400, status_error(
                                    400, "BadRequest", str(e)))
                                return
                        if self._is_custom(r):
                            # one batched ConversionReview, not N
                            items = server.crds.convert_many(
                                r.resource, items,
                                self._custom_version(r))
                        elif self._core_target(r) is not None:
                            items = corever.convert_many(
                                r.resource, items, self._core_target(r))
                        self._audit(r, "list", 200)
                        self._send_json(200, {
                            "kind": "List", "apiVersion": "v1",
                            "metadata": {"resourceVersion": str(rv)},
                            "items": items})
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))
                except kv.TooOldError as e:
                    self._send_json(410, status_error(410, "Expired", str(e)))
                except crdlib.ValidationError as e:
                    # read-path conversion failure (webhook down/refusing)
                    self._send_json(500, status_error(
                        500, "InternalError", str(e)))

            def _maybe_discovery(self, path: str) -> bool:
                """GET /api, /api/v1, /apis[...], /openapi/v2 (endpoints/
                discovery/): resolve groups/versions/resources from the
                server, not a client-side table."""
                from . import discovery as disc
                parts = [p for p in path.split("/") if p]
                doc = None
                if path == "/api":
                    doc = disc.api_versions()
                elif path == "/api/v1":
                    doc = disc.core_resource_list(CLUSTER_SCOPED,
                                                  SCALABLE)
                elif (len(parts) == 2 and parts[0] == "api"
                        and parts[1] in corever.SERVED_VERSIONS):
                    doc = disc.core_versioned_resource_list(
                        parts[1], CLUSTER_SCOPED)
                elif path == "/apis":
                    doc = disc.group_list(
                        BUILTIN_GROUPS, server.crds,
                        extra=server.aggregator.known_group_versions())
                elif path == "/openapi/v3":
                    doc = disc.openapi_v3_index(BUILTIN_GROUPS,
                                                server.crds)
                elif path.startswith("/openapi/v3/"):
                    doc = disc.openapi_v3_group(
                        path[len("/openapi/v3/"):], BUILTIN_GROUPS,
                        CLUSTER_SCOPED, server.crds)
                elif path == "/openapi/v2":
                    doc = disc.openapi_v2(BUILTIN_GROUPS, CLUSTER_SCOPED,
                                          server.crds)
                elif len(parts) == 2 and parts[0] == "apis":
                    doc = disc.api_group(
                        parts[1], BUILTIN_GROUPS, server.crds,
                        extra=server.aggregator.known_group_versions())
                elif len(parts) == 3 and parts[0] == "apis":
                    doc = disc.group_resource_list(
                        parts[1], parts[2], BUILTIN_GROUPS,
                        CLUSTER_SCOPED, SCALABLE, server.crds)
                else:
                    return False
                if doc is None:
                    self._send_json(404, status_error(
                        404, "NotFound", path))
                else:
                    self._send_json(200, doc)
                return True

            def _serve_watch(self, resource: str, q,
                             r: _Route | None = None) -> None:
                raw = q.get("resourceVersion", [""])[0]
                try:
                    since = int(raw) if raw != "" else None
                except ValueError:
                    self._send_json(400, status_error(
                        400, "BadRequest", f"invalid resourceVersion {raw!r}"))
                    return
                fsel = q.get("fieldSelector", [None])[0]
                if fsel:
                    try:
                        validate_field_selector(fsel)
                    except ValueError as e:
                        self._send_json(400, status_error(
                            400, "BadRequest", str(e)))
                        return
                w = server.store.watch(resource, since_rv=since)
                # field-filtered watch: a MODIFIED that ENTERS the
                # selection serves as ADDED, one that LEAVES serves as
                # DELETED (the reference cacher's watchFilter contract —
                # the kubelet's spec.nodeName watch sees its pods
                # "appear" when the scheduler binds them).  Seed the
                # matched set from current state (AFTER the watch is
                # registered, so nothing falls between): a client that
                # listed-then-watched must get leave/delete events for
                # objects that matched before the stream opened.
                fsel_matched: set[str] = set()
                if fsel:
                    seed_items, _seed_rv = server.store.list(resource,
                                                             r.ns if r
                                                             else None)
                    for o in seed_items:
                        if _matches_field_selector(o, fsel):
                            fsel_matched.add(meta.namespaced_name(o))
                with server._metrics_lock:
                    server.metrics["watch_streams"] += 1
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                # plain-identity streams (no field selector, no version
                # conversion) may use the event's shared wire cache:
                # one json.dumps per EVENT instead of one per watcher
                plain_wire = not fsel and (
                    r is None or not (self._is_custom(r)
                                      or self._core_target(r)))
                try:
                    while True:
                        evs = w.next_batch(timeout=5.0)
                        if not evs:
                            if w.stopped:
                                break
                            evs = [None]  # heartbeat below
                        lines = []
                        relist = False
                        if plain_wire:
                            for ev in evs:
                                if ev is None:
                                    lines.append(
                                        '{"type": "BOOKMARK", "object": '
                                        '{"metadata": {}}}\n')
                                    continue
                                wire = ev._wire
                                if wire is None:
                                    wire = json.dumps(
                                        {"type": ev.type,
                                         "object": ev.object}) + "\n"
                                    ev._wire = wire
                                lines.append(wire)
                            if lines:
                                data = "".join(lines).encode()
                                self.wfile.write(
                                    f"{len(data):x}\r\n".encode()
                                    + data + b"\r\n")
                                self.wfile.flush()
                            continue
                        for ev in evs:
                            if ev is None:
                                payload = {"type": kv.BOOKMARK,
                                           "object": {"metadata": {}}}
                            else:
                                obj = ev.object
                                etype = ev.type
                                if fsel:
                                    key = meta.namespaced_name(obj)
                                    hit = _matches_field_selector(obj,
                                                                  fsel)
                                    if etype == kv.DELETED:
                                        if key not in fsel_matched:
                                            continue
                                        fsel_matched.discard(key)
                                    elif hit and key not in fsel_matched:
                                        fsel_matched.add(key)
                                        etype = kv.ADDED  # entered
                                    elif hit:
                                        pass  # stays MODIFIED/ADDED
                                    elif key in fsel_matched:
                                        fsel_matched.discard(key)
                                        etype = kv.DELETED  # left
                                    else:
                                        continue  # never matched
                                if r is not None and (
                                        self._is_custom(r)
                                        or self._core_target(r)):
                                    try:
                                        obj = self._serve_custom(r, obj)
                                    except crdlib.ValidationError:
                                        # conversion webhook failure mid-
                                        # stream: end the watch cleanly
                                        # so the client relists
                                        relist = True
                                        break
                                payload = {"type": etype, "object": obj}
                            lines.append(json.dumps(payload) + "\n")
                        if lines:
                            # a burst is ONE chunk write + flush, not one
                            # syscall pair per event (a 16k-bind batch
                            # fans out to every pod watcher)
                            data = "".join(lines).encode()
                            self.wfile.write(f"{len(data):x}\r\n".encode()
                                             + data + b"\r\n")
                            self.wfile.flush()
                        if relist:
                            break
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    w.stop()
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass
                self.close_connection = True

            # ---- kubelet tunnel (exec/attach/portforward/log) ----

            def _kubelet_endpoint(self, r: _Route):
                """Resolve the pod's kubelet (host, port, pod spec) from
                node status daemonEndpoints, or write the error."""
                try:
                    pod = server.store.get("pods", r.ns or "", r.name)
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound",
                                                      str(e)))
                    return None
                node_name = (pod.get("spec") or {}).get("nodeName")
                if not node_name:
                    self._send_json(400, status_error(
                        400, "BadRequest",
                        f"pod {r.name!r} is not scheduled"))
                    return None
                try:
                    node = server.store.get("nodes", "", node_name)
                except kv.NotFoundError:
                    self._send_json(502, status_error(
                        502, "BadGateway", f"node {node_name!r} gone"))
                    return None
                status = node.get("status") or {}
                port = ((status.get("daemonEndpoints") or {})
                        .get("kubeletEndpoint") or {}).get("Port")
                addr = next((a.get("address")
                             for a in status.get("addresses") or ()
                             if a.get("type") == "InternalIP"), None)
                if not port or not addr:
                    self._send_json(502, status_error(
                        502, "BadGateway",
                        f"node {node_name!r} has no kubelet endpoint"))
                    return None
                return addr, int(port), pod

            def _node_stream(self, r: _Route) -> None:
                """Proxy a pod log/exec/attach/portforward subresource to
                the pod's kubelet.  Plain responses (log) are relayed as a
                stream; 101 upgrades hand the connection over to a blind
                two-way byte pump — the apiserver never parses frames,
                exactly the reference's UpgradeAwareProxy contract."""
                got = self._kubelet_endpoint(r)
                if got is None:
                    return
                addr, port, pod = got
                q = dict(r.query)
                if r.subresource == "portforward":
                    path = f"/portForward/{r.ns}/{r.name}"
                else:
                    container = (q.pop("container", [None]))[0]
                    if container is None:
                        spec = [c["name"] for c in
                                (pod.get("spec") or {}).get("containers")
                                or ()]
                        if len(spec) != 1:
                            self._send_json(400, status_error(
                                400, "BadRequest",
                                "container name required"))
                            return
                        container = spec[0]
                    seg = {"log": "containerLogs"}.get(r.subresource,
                                                      r.subresource)
                    path = f"/{seg}/{r.ns}/{r.name}/{container}"
                query = urlencode([(k, v) for k, vs in q.items()
                                   for v in vs])
                if query:
                    path += "?" + query
                verb = "create" if self.command == "POST" else "get"
                try:
                    upstream = socket.create_connection((addr, port),
                                                        timeout=30.0)
                except OSError as e:
                    self._audit(r, verb, 502)
                    self._send_json(502, status_error(
                        502, "BadGateway", f"kubelet dial failed: {e}"))
                    return
                try:
                    req = [f"{self.command} {path} HTTP/1.1",
                           f"Host: {addr}:{port}"]
                    for h in ("Upgrade", "Connection"):
                        v = self.headers.get(h)
                        if v:
                            req.append(f"{h}: {v}")
                    upstream.sendall(("\r\n".join(req) + "\r\n\r\n")
                                     .encode())
                    # relay the kubelet's response head verbatim
                    head = b""
                    while b"\r\n\r\n" not in head:
                        chunk = upstream.recv(65536)
                        if not chunk:
                            self._audit(r, verb, 502)
                            self._send_json(502, status_error(
                                502, "BadGateway",
                                "kubelet closed during handshake"))
                            return
                        head += chunk
                    # handshake done: an interactive stream may sit idle
                    # far longer than the 30s dial timeout
                    upstream.settimeout(None)
                    head_bytes, _, early = head.partition(b"\r\n\r\n")
                    self.wfile.write(head_bytes + b"\r\n\r\n" + early)
                    self.wfile.flush()
                    is_upgrade = head_bytes.startswith(b"HTTP/1.1 101")
                    try:
                        upstream_code = int(head_bytes.split()[1])
                    except (IndexError, ValueError):
                        upstream_code = 502
                    self._audit(r, verb, upstream_code)
                    self.close_connection = True
                    if is_upgrade:
                        self._pump_sockets(self.connection, upstream)
                    else:
                        self._relay_plain(head_bytes, early, upstream)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    try:
                        upstream.close()
                    except OSError:
                        pass

            def _relay_plain(self, head_bytes: bytes, early: bytes,
                             upstream: socket.socket) -> None:
                """Relay a non-upgrade kubelet response.  Error replies
                are keep-alive with Content-Length — relay exactly that
                many bytes or this thread blocks forever on a socket the
                kubelet never closes.  Length-less responses (log
                streams) relay until EOF, probing the client socket each
                idle beat so an abandoned `logs -f` doesn't pin this
                thread until container exit."""
                import select
                length = None
                for ln in head_bytes.split(b"\r\n")[1:]:
                    k, _, v = ln.partition(b":")
                    if k.strip().lower() == b"content-length":
                        try:
                            length = int(v.strip())
                        except ValueError:
                            pass
                sent = len(early)
                if length is not None and sent >= length:
                    return
                while True:
                    readable, _, _ = select.select(
                        [upstream, self.connection], [], [], 5.0)
                    if self.connection in readable:
                        # half-duplex stream: client bytes here mean EOF
                        try:
                            if self.connection.recv(
                                    1, socket.MSG_PEEK) == b"":
                                return
                        except OSError:
                            return
                    if upstream not in readable:
                        continue
                    chunk = upstream.recv(65536)
                    if not chunk:
                        return
                    self.wfile.write(chunk)
                    self.wfile.flush()
                    sent += len(chunk)
                    if length is not None and sent >= length:
                        return

            @staticmethod
            def _pump_sockets(a: socket.socket, b: socket.socket) -> None:
                """Two-way blind byte pump until either side closes."""
                def one_way(src, dst):
                    try:
                        while True:
                            data = src.recv(65536)
                            if not data:
                                break
                            dst.sendall(data)
                    except OSError:
                        pass
                    for s, how in ((dst, socket.SHUT_WR),
                                   (src, socket.SHUT_RD)):
                        try:
                            s.shutdown(how)
                        except OSError:
                            pass

                t = threading.Thread(target=one_way, args=(b, a),
                                     daemon=True)
                t.start()
                one_way(a, b)
                t.join(timeout=30.0)

            def _read_body(self) -> dict | list | None:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    return json.loads(self.rfile.read(length))
                except (json.JSONDecodeError, ValueError):
                    self._send_json(400, status_error(400, "BadRequest",
                                                      "invalid JSON body"))
                    return None

            def _admit_quiet(self, verb: str, r: _Route, obj: dict,
                             old: dict | None = None,
                             namespace: str | None = None
                             ) -> tuple[dict | None, dict | None]:
                """Run legacy hooks + the admission chain WITHOUT writing
                a response: (admitted_obj, None) or (None, status_error)
                — the bulk paths report per-item.

                `namespace` defaults to the URL namespace (the
                single-object contract: a body claiming another namespace
                must not shift which policy admits it); the bulk path
                passes each item's own namespace explicitly."""
                for hook in server.admission_hooks:
                    try:
                        obj = hook(verb, r.resource, obj) or obj
                    except AdmissionError as e:
                        return None, status_error(400, "AdmissionDenied",
                                                  str(e))
                ident = self._identity() or ("", ())
                attrs = adm.Attributes(
                    verb, r.resource, obj, old,
                    namespace=(namespace if namespace is not None
                               else r.ns or ""),
                    name=r.name or meta.name(obj) or "",
                    subresource=r.subresource or "",
                    user=ident[0], groups=tuple(ident[1]))
                try:
                    server.admission_chain.run(attrs)
                except adm.AdmissionDenied as e:
                    return None, status_error(
                        403, "Forbidden",
                        "admission plugin %s denied the request: %s"
                        % (e.plugin, e))
                return attrs.obj, None

            def _admit(self, verb: str, r: _Route, obj: dict,
                       old: dict | None = None) -> dict | None:
                """Run legacy hooks + the admission chain; None = rejected
                (response already written)."""
                admitted, err = self._admit_quiet(verb, r, obj, old)
                if err is not None:
                    self._send_json(err["code"], err)
                return admitted

            def _is_custom(self, r: _Route) -> bool:
                """CRD-backed resource?  True for BOTH addressing forms:
                the grouped /apis/{g}/{v} path AND the flat /api/v1 path
                (the store is flat, so clients may write custom objects
                there) — a flat-path write must still get the full
                prune/default/validate/CEL pipeline."""
                if r.group in BUILTIN_GROUPS:
                    return False
                return server.crds.lookup(r.resource) is not None

            def _custom_version(self, r: _Route) -> str:
                """The serving version for this request: the URL's on a
                grouped path; the CRD's storage version on the flat path
                (which serves objects in storage form)."""
                if r.group is not None:
                    return r.version
                info = server.crds.lookup(r.resource) or {}
                return info.get("storage_version", r.version)

            def _coerce_custom(self, r: _Route, obj: dict,
                               old: dict | None = None) -> dict | None:
                """Custom-resource write pipeline: prune -> default ->
                schema -> CEL rules, then convert to the CRD's storage
                version (the reference stores ONE version and converts
                on the wire).  None = rejected (422 already sent)."""
                if not self._is_custom(r):
                    if r.group is not None \
                            and r.group not in BUILTIN_GROUPS:
                        # grouped path, no CRD behind it: the resource
                        # does not exist — never silently persist
                        self._send_json(422, status_error(
                            422, "Invalid",
                            f"no CRD for resource {r.resource!r}"))
                        return None
                    tv = self._core_target(r)
                    if tv is not None:
                        # versioned core write: default in the request
                        # version, then convert to the v1 hub for
                        # storage, then hub-side defaulting
                        return corever.default_v1(
                            r.resource,
                            corever.to_storage(r.resource, obj, tv))
                    if r.subresource:
                        return obj  # status/scale splices onto a stored
                        # (already-defaulted) base; nothing to fill
                    # v1 write-time defaulting (defaults.go parity):
                    # idempotent missing-field fills only
                    return corever.default_v1(r.resource, obj)
                try:
                    obj = server.crds.coerce(r.resource,
                                             self._custom_version(r),
                                             obj, old)
                    return server.crds.to_storage(r.resource, obj)
                except crdlib.ValidationError as e:
                    self._send_json(422, status_error(422, "Invalid", str(e)))
                    return None

            def _core_target(self, r: _Route) -> str | None:
                """The non-hub core serving version for this request, or
                None (hub/v1 requests and grouped paths pass through)."""
                if (r.group is None and r.resource
                        and r.version not in (None, corever.HUB)
                        and corever.handles(r.resource, r.version)):
                    return r.version
                return None

            def _serve_custom(self, r: _Route, obj: dict) -> dict:
                """Convert a stored object to the requested serving
                version on the way out (CRDs via the CRD converter, core
                resources via api/core_versions — the same seam)."""
                if self._is_custom(r):
                    return server.crds.convert(r.resource, obj,
                                               self._custom_version(r))
                tv = self._core_target(r)
                if tv is not None:
                    return corever.convert(r.resource, obj, tv)
                return obj

            def do_POST(self):
                begun = self._begin("create")
                if begun is None:
                    return
                r, ticket = begun
                try:
                    if self._maybe_proxy():
                        return
                    self._do_post(r)
                finally:
                    if ticket:
                        ticket.__exit__()

            def _do_post(self, r: _Route) -> None:
                if r.resource is None:
                    self._send_json(404, status_error(404, "NotFound", r.path))
                    return
                if r.resource == "pods" \
                        and r.subresource in NODE_STREAM_SUBRESOURCES:
                    # upgrade requests carry no body — tunnel before any
                    # body read would eat the first stream frames
                    self._node_stream(r)
                    return
                obj = self._read_body()
                if obj is None:
                    return
                # -- subresources --
                if r.subresource == "binding":
                    self._post_binding(r, obj)
                    return
                if r.resource == "bindings":
                    # collection-level Binding (upstream supports a single
                    # POST .../bindings); BindingList extends it to the
                    # batch-scheduler write (store.bind_many, one
                    # transaction) — the front-door equivalent of the
                    # LocalClient bulk bind
                    self._post_bindings(r, obj)
                    return
                if isinstance(obj, dict) and obj.get("kind") == "List" \
                        and isinstance(obj.get("items"), list):
                    self._post_bulk_create(r, obj)
                    return
                if r.subresource == "eviction":
                    self._post_eviction(r, obj)
                    return
                if r.subresource == "token":
                    self._post_token(r, obj)
                    return
                if r.resource == "selfsubjectaccessreviews":
                    # authorization.k8s.io SelfSubjectAccessReview: answer
                    # "can I?" for the REQUESTING identity; never persisted
                    # (pkg/registry/authorization/selfsubjectaccessreview)
                    attrs_spec = ((obj.get("spec") or {})
                                  .get("resourceAttributes") or {})
                    user, groups = self._identity()
                    if server.authorizer is None:
                        allowed, reason = True, "no authorizer configured"
                    else:
                        allowed = server.authorizer.authorize(
                            rbaclib.Attributes(
                                user, tuple(groups),
                                attrs_spec.get("verb", "get"),
                                attrs_spec.get("resource", ""),
                                attrs_spec.get("subresource", ""),
                                attrs_spec.get("namespace", ""),
                                attrs_spec.get("name", "")))
                        reason = ""
                    obj.setdefault("status", {})
                    obj["status"] = {"allowed": bool(allowed),
                                     "reason": reason}
                    self._send_json(201, obj)
                    return
                if r.resource in CLUSTER_SCOPED:
                    if r.ns:
                        self._send_json(400, status_error(
                            400, "BadRequest",
                            f"{r.resource} is cluster-scoped"))
                        return
                    if "metadata" in obj:
                        # stray namespace would fork the storage key away
                        # from the cluster-scoped read path
                        obj["metadata"].pop("namespace", None)
                elif r.ns and "metadata" in obj:
                    obj["metadata"].setdefault("namespace", r.ns)
                obj = self._admit(adm.CREATE, r, obj)
                if obj is None:
                    return
                obj = self._coerce_custom(r, obj)
                if obj is None:
                    return
                if r.resource == crdlib.CRDS:
                    try:
                        obj = server.crds.establish(obj, dry_run=True)
                    except crdlib.ValidationError as e:
                        self._send_json(422, status_error(422, "Invalid",
                                                          str(e)))
                        return
                try:
                    created = server.store.create(r.resource, obj)
                    if r.resource == crdlib.CRDS:
                        server.crds.establish(created)
                    body = self._serve_custom(r, created)
                    self._audit(r, "create", 201, created)
                    self._send_json(201, body)
                except kv.AlreadyExistsError as e:
                    self._send_json(409, status_error(409, "AlreadyExists",
                                                      str(e)))

            def _post_token(self, r: _Route, req: dict) -> None:
                """POST serviceaccounts/{name}/token (TokenRequest,
                pkg/registry/core/serviceaccount/storage/token.go):
                mint a bound SA JWT for an existing account."""
                if server.sa_issuer is None:
                    self._send_json(404, status_error(
                        404, "NotFound",
                        "service account tokens are not enabled"))
                    return
                try:
                    sa = server.store.get("serviceaccounts", r.ns or "",
                                          r.name)
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound",
                                                      str(e)))
                    return
                spec = (req or {}).get("spec") or {}
                try:
                    seconds = int(spec.get("expirationSeconds") or 3600)
                except (TypeError, ValueError):
                    seconds = -1
                if seconds < 600:
                    # token.go: "may not specify a duration less than
                    # 10 minutes" — reject, never silently extend
                    self._send_json(400, status_error(
                        400, "BadRequest",
                        "expirationSeconds must be an integer >= 600"))
                    return
                audiences = tuple(spec.get("audiences") or ())
                token, exp = server.sa_issuer.issue(
                    r.ns or "", r.name, uid=meta.uid(sa) or "",
                    expiration_seconds=seconds, audiences=audiences)
                import time as timelib
                stamp = timelib.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         timelib.gmtime(exp))
                self._audit(r, "create", 201)
                self._send_json(201, {
                    "kind": "TokenRequest",
                    "apiVersion": "authentication.k8s.io/v1",
                    "metadata": {"name": r.name, "namespace": r.ns},
                    "spec": {"expirationSeconds": seconds,
                             "audiences": list(audiences)},
                    "status": {"token": token,
                               "expirationTimestamp": stamp}})

            def _post_bindings(self, r: _Route, body: dict) -> None:
                """POST .../bindings with a Binding (single) or
                BindingList (bulk): each item names its pod
                (metadata.namespace/name) and target node (target.name).
                Bulk rides ONE store transaction (kv.bind_many) — the
                server-side verb that keeps the scheduler's batched
                assignment from serializing into per-pod round trips."""
                if body.get("kind") == "BindingList" \
                        or isinstance(body.get("items"), list):
                    items = body.get("items") or []
                else:
                    items = [body]
                triples = []
                for it in items:
                    md = it.get("metadata") or {}
                    node = ((it.get("target") or {}).get("name")
                            or it.get("nodeName"))
                    if not md.get("name") or not node:
                        self._send_json(400, status_error(
                            400, "BadRequest",
                            "each binding needs metadata.name and "
                            "target.name"))
                        return
                    entry = (md.get("namespace") or r.ns
                             or "default", md["name"], node)
                    if md.get("resourceVersion") is not None:
                        # compare-and-bind precondition (scale-out
                        # schedulers): bind only if the pod hasn't moved
                        entry += (md["resourceVersion"],)
                    triples.append(entry)
                results = server.store.bind_many("pods", triples)
                out = []
                for _obj, err in results:
                    if err is None:
                        out.append({"kind": "Status", "status": "Success"})
                    elif isinstance(err, kv.BindConflict):
                        # distinct reason so HTTP schedulers can classify
                        # lost-the-optimistic-race without string parsing
                        out.append(bind_conflict_status(err))
                    elif isinstance(err, kv.ConflictError):
                        out.append(status_error(409, "Conflict", str(err)))
                    elif isinstance(err, kv.NotFoundError):
                        out.append(status_error(404, "NotFound", str(err)))
                    else:  # pragma: no cover - other store errors
                        out.append(status_error(500, "InternalError",
                                                str(err)))
                self._audit(r, "create", 201)
                self._send_json(201, {"kind": "BindingResultList",
                                      "items": out})

            def _post_bulk_create(self, r: _Route, body: dict) -> None:
                """POST a {kind: List, items: [...]} body on a resource
                collection: per-item admission, then ONE store
                transaction (kv.create_many) with per-item results —
                the bulk sibling of create, used by the event
                broadcaster's flush so a 4096-event burst is one round
                trip, not 4096."""
                if r.resource == crdlib.CRDS:
                    # CRDs need establish() side effects per object; the
                    # singular path is the only one that carries them
                    self._send_json(400, status_error(
                        400, "BadRequest",
                        "bulk create is not supported for "
                        "customresourcedefinitions"))
                    return
                custom = self._is_custom(r)
                items = body.get("items") or []
                prepared: list = []
                statuses: list[dict | None] = []
                for obj in items:
                    md = obj.get("metadata") \
                        if isinstance(obj, dict) else None
                    if not isinstance(md, dict) \
                            or not isinstance(md.get("name"), str):
                        statuses.append(status_error(
                            400, "BadRequest",
                            "item without metadata.name"))
                        prepared.append(None)
                        continue
                    if r.resource in CLUSTER_SCOPED:
                        md.pop("namespace", None)
                    elif r.ns:
                        md.setdefault("namespace", r.ns)
                    try:
                        admitted, err = self._admit_quiet(
                            adm.CREATE, r, obj,
                            namespace=md.get("namespace", ""))
                        core_tv = self._core_target(r)
                        if admitted is not None and core_tv is not None:
                            # versioned core items store in hub form,
                            # same as the singular POST path
                            admitted = corever.to_storage(
                                r.resource, admitted, core_tv)
                        if admitted is not None and not custom:
                            # hub-side v1 defaulting, like the singular
                            # path's _coerce_custom tail
                            admitted = corever.default_v1(r.resource,
                                                          admitted)
                        if admitted is not None and custom:
                            # same prune/default/validate/CEL + storage-
                            # version conversion the singular path runs
                            try:
                                admitted = server.crds.to_storage(
                                    r.resource, server.crds.coerce(
                                        r.resource,
                                        self._custom_version(r),
                                        admitted, None))
                            except crdlib.ValidationError as e:
                                admitted, err = None, status_error(
                                    422, "Invalid", str(e))
                    except Exception as e:  # noqa: BLE001 - per-item wall
                        admitted, err = None, status_error(
                            400, "BadRequest", f"bad item: {e}")
                    if admitted is None:
                        statuses.append(err)
                        prepared.append(None)
                        continue
                    prepared.append(admitted)
                    statuses.append(None)
                live = [o for o in prepared if o is not None]
                results = iter(server.store.create_many(r.resource, live))
                out = []
                for st in statuses:
                    if st is not None:
                        out.append(st)
                        continue
                    created, err = next(results)
                    if err is None:
                        out.append({"kind": "Status", "status": "Success",
                                    "metadata": {
                                        "resourceVersion":
                                        meta.resource_version(created)}})
                    elif isinstance(err, kv.AlreadyExistsError):
                        out.append(status_error(409, "AlreadyExists",
                                                str(err)))
                    else:  # pragma: no cover - other store errors
                        out.append(status_error(500, "InternalError",
                                                str(err)))
                self._audit(r, "create", 201)
                self._send_json(201, {"kind": "CreateResultList",
                                      "items": out})

            def _post_binding(self, r: _Route, binding: dict) -> None:
                """POST pods/{name}/binding (registry/core/pod/storage
                BindingREST): writes spec.nodeName once."""
                node = ((binding.get("target") or {}).get("name")
                        or binding.get("nodeName"))
                expect_rv = (binding.get("metadata")
                             or {}).get("resourceVersion")
                if not node:
                    self._send_json(400, status_error(
                        400, "BadRequest", "binding needs target.name"))
                    return
                try:
                    def bind(pod):
                        if meta.pod_node_name(pod):
                            cur_node = meta.pod_node_name(pod)
                            raise kv.BindConflict(
                                "pod %s is already assigned to node %s"
                                % (r.name, cur_node),
                                key=r.name, current_node=cur_node,
                                wanted_node=node)
                        if expect_rv is not None and \
                                (pod.get("metadata") or {}).get(
                                    "resourceVersion") != expect_rv:
                            raise kv.BindConflict(
                                "pod %s moved past resourceVersion %r"
                                % (r.name, expect_rv),
                                key=r.name, current_node=None,
                                wanted_node=node)
                        pod.setdefault("spec", {})["nodeName"] = node
                        return pod
                    server.store.guaranteed_update(
                        "pods", r.ns or "default", r.name, bind)
                    self._audit(r, "create", 201)
                    self._send_json(201, {"kind": "Status", "status": "Success"})
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))
                except kv.BindConflict as e:
                    self._send_json(409, bind_conflict_status(e))
                except kv.ConflictError as e:
                    self._send_json(409, status_error(409, "Conflict", str(e)))

            def _post_eviction(self, r: _Route, eviction: dict) -> None:
                """POST pods/{name}/eviction (registry/core/pod/storage
                EvictionREST): PDB-gated delete -> 429 when blocked."""
                ns = r.ns or "default"
                try:
                    pod = server.store.get("pods", ns, r.name)
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))
                    return
                try:
                    pdbs, _ = server.store.list("poddisruptionbudgets", ns)
                except Exception:  # noqa: BLE001
                    pdbs = []
                guarding = [p for p in pdbs if _pdb_matches(p, pod)]
                for pdb in guarding:
                    if not _pdb_allows_eviction(server.store, pdb, ns):
                        self._send_json(429, status_error(
                            429, "TooManyRequests",
                            "Cannot evict pod as it would violate the pod's "
                            "disruption budget."))
                        return
                server.store.delete("pods", ns, r.name)
                for pdb in guarding:  # eviction consumes a disruption
                    if "disruptionsAllowed" in (pdb.get("status") or {}):
                        def dec(cur):
                            st = cur.setdefault("status", {})
                            st["disruptionsAllowed"] = max(
                                0, int(st.get("disruptionsAllowed", 0)) - 1)
                            return cur
                        try:
                            server.store.guaranteed_update(
                                "poddisruptionbudgets", ns,
                                (pdb.get("metadata") or {}).get("name"), dec)
                        except kv.NotFoundError:
                            pass
                self._audit(r, "delete", 201)
                self._send_json(201, {"kind": "Status", "status": "Success"})

            def do_PUT(self):
                begun = self._begin("update")
                if begun is None:
                    return
                r, ticket = begun
                try:
                    if self._maybe_proxy():
                        return
                    self._do_put(r)
                finally:
                    if ticket:
                        ticket.__exit__()

            def _do_put(self, r: _Route) -> None:
                if r.resource is None or r.name is None:
                    self._send_json(404, status_error(404, "NotFound", r.path))
                    return
                if r.subresource in VIRTUAL_SUBRESOURCES:
                    # virtual subresources are GET/POST-only — a write
                    # here must never touch the parent object
                    self._drain_body()
                    self._send_json(405, status_error(
                        405, "MethodNotAllowed",
                        f"{r.subresource} does not support this verb"))
                    return
                obj = self._read_body()
                if obj is None:
                    return
                try:
                    if r.subresource == "status":
                        # status strategy: only .status moves (registry
                        # strategies split spec/status writes).  Custom
                        # resources only serve it when their CRD
                        # declares spec.subresources.status
                        # (customresource_handler.go).
                        if self._is_custom(r) \
                                and not server.crds.has_status_subresource(
                                    r.resource):
                            self._send_json(404, status_error(
                                404, "NotFound",
                                f"{r.resource} has no status subresource"))
                            return
                        # status writes pass ADMISSION like any update
                        # (NodeRestriction scopes a kubelet to its own
                        # pods'/node's status; this path used to bypass
                        # the chain entirely)
                        try:
                            old_for_adm = server.store.get(
                                r.resource, r.ns or "", r.name)
                        except kv.StoreError:
                            old_for_adm = None
                        if self._admit(adm.UPDATE, r, obj,
                                       old_for_adm) is None:
                            return
                        new_status = obj.get("status")

                        def set_status(cur):
                            if self._is_custom(r):
                                # the status write passes the same
                                # schema/CEL pipeline as a spec write
                                version = self._custom_version(r)
                                cur = server.crds.convert(
                                    r.resource, cur, version)
                                candidate = dict(cur,
                                                 status=new_status)
                                candidate = server.crds.coerce(
                                    r.resource, version, candidate, cur)
                                return server.crds.to_storage(
                                    r.resource, candidate)
                            tv = self._core_target(r)
                            if tv is not None:
                                # status arrives in the request-version
                                # shape: convert ONLY the status stanza to
                                # hub form and splice it in — a full
                                # convert/default round trip would mutate
                                # .spec from a status endpoint
                                hub_status = corever.to_storage(
                                    r.resource, {"status": new_status},
                                    tv, default=False).get("status")
                                cur["status"] = hub_status
                                return cur
                            cur["status"] = new_status
                            return cur
                        try:
                            updated = server.store.guaranteed_update(
                                r.resource, r.ns or "", r.name,
                                set_status)
                        except crdlib.ValidationError as e:
                            self._send_json(422, status_error(
                                422, "Invalid", str(e)))
                            return
                        body = self._serve_custom(r, updated)
                        self._audit(r, "update", 200)
                        self._send_json(200, body)
                        return
                    if r.subresource == "scale":
                        paths = (server.crds.scale_paths(r.resource)
                                 if self._is_custom(r) else None)
                        if self._is_custom(r) and paths is None:
                            self._send_json(404, status_error(
                                404, "NotFound",
                                f"{r.resource} has no scale subresource"))
                            return
                        replicas = int((obj.get("spec") or {})
                                       .get("replicas", 0))

                        def set_scale(cur):
                            if paths is not None:
                                _set_path(cur, paths.get(
                                    "specReplicasPath",
                                    ".spec.replicas"), replicas)
                            else:
                                cur.setdefault("spec", {})["replicas"] \
                                    = replicas
                            return cur
                        try:
                            updated = server.store.guaranteed_update(
                                r.resource, r.ns or "", r.name,
                                set_scale)
                        except crdlib.ValidationError as e:
                            self._send_json(422, status_error(
                                422, "Invalid", str(e)))
                            return
                        self._audit(r, "update", 200)
                        self._send_json(200, _crd_scale(updated, paths)
                                        if paths is not None
                                        else _scale_of(updated,
                                                       r.resource))
                        return
                    old = None
                    try:
                        old = server.store.get(r.resource, r.ns or "", r.name)
                    except kv.NotFoundError:
                        pass
                    obj = self._admit(adm.UPDATE, r, obj, old)
                    if obj is None:
                        return
                    obj = self._coerce_custom(r, obj, old)
                    if obj is None:
                        return
                    if r.resource == crdlib.CRDS:
                        try:
                            obj = server.crds.establish(obj, dry_run=True)
                        except crdlib.ValidationError as e:
                            self._send_json(422, status_error(
                                422, "Invalid", str(e)))
                            return
                    mflib.track_update(old, obj, self._field_manager())
                    updated = server.store.update(r.resource, obj)
                    if r.resource == crdlib.CRDS:
                        server.crds.establish(updated)
                    body = self._serve_custom(r, updated)
                    self._audit(r, "update", 200, updated)
                    self._send_json(200, body)
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))
                except kv.ConflictError as e:
                    self._send_json(409, status_error(409, "Conflict", str(e)))

            def do_PATCH(self):
                begun = self._begin("patch")
                if begun is None:
                    return
                r, ticket = begun
                try:
                    if self._maybe_proxy():
                        return
                    self._do_patch(r)
                finally:
                    if ticket:
                        ticket.__exit__()

            def _do_patch(self, r: _Route) -> None:
                if r.resource is None or r.name is None:
                    self._send_json(404, status_error(404, "NotFound", r.path))
                    return
                if r.subresource in VIRTUAL_SUBRESOURCES:
                    # virtual subresources are GET/POST-only — a write
                    # here must never touch the parent object
                    self._drain_body()
                    self._send_json(405, status_error(
                        405, "MethodNotAllowed",
                        f"{r.subresource} does not support this verb"))
                    return
                body = self._read_body()
                if body is None:
                    return
                ctype = self.headers.get("Content-Type",
                                         "application/strategic-merge-patch+json")
                if ctype.split(";")[0].strip() == mflib.APPLY_CONTENT_TYPE:
                    self._do_apply(r, body)
                    return
                if r.subresource == "status" and self._is_custom(r) \
                        and not server.crds.has_status_subresource(
                            r.resource):
                    # PUT and PATCH must agree it doesn't exist
                    self._send_json(404, status_error(
                        404, "NotFound",
                        f"{r.resource} has no status subresource"))
                    return
                try:
                    def apply(cur):
                        core_tv = self._core_target(r)
                        hub_cur = cur
                        if self._is_custom(r):
                            # patch against the REQUEST-version shape:
                            # patching the storage form and pruning with
                            # the request schema silently drops fields
                            cur = server.crds.convert(
                                r.resource, cur, self._custom_version(r))
                        elif core_tv is not None:
                            # no defaulting: injected defaults on the
                            # patch base would persist as if user-written
                            cur = corever.convert(r.resource, cur,
                                                  core_tv, default=False)
                        patched = patchlib.apply_patch(ctype, cur, body)
                        if r.subresource == "status":
                            # status patch may only change .status
                            merged = dict(cur)
                            merged["status"] = patched.get("status")
                            patched = merged
                        # resourceVersion comes from the store's CAS loop
                        patched.setdefault("metadata", {})["resourceVersion"] = \
                            (cur.get("metadata") or {}).get("resourceVersion")
                        mflib.track_update(cur, patched,
                                           self._field_manager())
                        # the patched object passes the same gates as a PUT
                        for hook in server.admission_hooks:
                            patched = hook(adm.UPDATE, r.resource,
                                           patched) or patched
                        ident = self._identity() or ("", ())
                        server.admission_chain.run(adm.Attributes(
                            adm.UPDATE, r.resource, patched, cur,
                            namespace=r.ns or "", name=r.name,
                            subresource=r.subresource or "",
                            user=ident[0], groups=tuple(ident[1])))
                        if self._is_custom(r):
                            patched = server.crds.coerce(
                                r.resource, self._custom_version(r),
                                patched, cur)
                            patched = server.crds.to_storage(r.resource,
                                                             patched)
                        elif core_tv is not None:
                            patched = corever.to_storage(
                                r.resource, patched, core_tv,
                                # spec patches get write-time defaulting;
                                # status patches must not touch spec at
                                # all — splice status onto the hub base
                                default=r.subresource != "status")
                            if r.subresource == "status":
                                patched = dict(
                                    hub_cur,
                                    status=patched.get("status"),
                                    metadata=patched.get("metadata"))
                        if r.resource == crdlib.CRDS:
                            patched = server.crds.establish(patched,
                                                            dry_run=True)
                        return patched
                    updated = server.store.guaranteed_update(
                        r.resource, r.ns or "", r.name, apply)
                    if r.resource == crdlib.CRDS:
                        server.crds.establish(updated)
                    body = self._serve_custom(r, updated)
                    self._audit(r, "patch", 200)
                    self._send_json(200, body)
                except (patchlib.PatchError, crdlib.ValidationError) as e:
                    self._send_json(422, status_error(422, "Invalid", str(e)))
                except adm.AdmissionDenied as e:
                    self._send_json(403, status_error(
                        403, "Forbidden",
                        "admission plugin %s denied the request: %s"
                        % (e.plugin, e)))
                except AdmissionError as e:
                    self._send_json(400, status_error(400, "AdmissionDenied",
                                                      str(e)))
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))
                except kv.ConflictError as e:
                    self._send_json(409, status_error(409, "Conflict", str(e)))

            def _field_manager(self, default: str = "unknown") -> str:
                r = self._route()
                vals = r.query.get("fieldManager") if r else None
                return vals[0] if vals else default

            def _do_apply(self, r: _Route, applied: dict) -> None:
                """Server-side apply (PATCH application/apply-patch+yaml):
                create-or-merge driven by managedFields ownership
                (managedfields.py; endpoints/handlers/patch.go applyPatcher)."""
                manager = self._field_manager(default="apply")
                force = (r.query.get("force") or ["false"])[0] == "true"
                applied.setdefault("metadata", {}).setdefault("name", r.name)
                if r.resource in CLUSTER_SCOPED:
                    # stray namespace would fork the storage key away from
                    # the cluster-scoped read path (same strip as POST)
                    applied["metadata"].pop("namespace", None)
                elif r.ns:
                    applied["metadata"].setdefault("namespace", r.ns)
                try:
                    try:
                        live = server.store.get(r.resource, r.ns or "",
                                                r.name)
                    except kv.NotFoundError:
                        live = None
                    if live is None:
                        new = mflib.apply_merge(None, applied, manager)
                        new = self._admit(adm.CREATE, r, new, None)
                        if new is None:
                            return
                        new = self._coerce_custom(r, new)
                        if new is None:
                            return
                        if r.resource == crdlib.CRDS:
                            # a CRD applied (SSA) must establish exactly
                            # like one POSTed, or it never serves
                            new = server.crds.establish(new,
                                                        dry_run=True)
                        try:
                            created = server.store.create(r.resource, new)
                            if r.resource == crdlib.CRDS:
                                server.crds.establish(created)
                        except kv.AlreadyExistsError:
                            # lost the create race to a concurrent first
                            # apply: fall through and MERGE with the
                            # winner (apply-to-existing is well-defined)
                            created = None
                        if created is not None:
                            body = self._serve_custom(r, created)
                            self._audit(r, "apply", 201, created)
                            self._send_json(201, body)
                            return

                    def merge(cur):
                        core_tv = self._core_target(r)
                        if self._is_custom(r):
                            # merge in the request-version shape (see
                            # the PATCH closure's rationale)
                            cur = server.crds.convert(
                                r.resource, cur, self._custom_version(r))
                        elif core_tv is not None:
                            cur = corever.convert(r.resource, cur,
                                                  core_tv, default=False)
                        new = mflib.apply_merge(cur, applied, manager,
                                                force=force)
                        new["metadata"]["resourceVersion"] = \
                            cur["metadata"].get("resourceVersion")
                        ident = self._identity() or ("", ())
                        server.admission_chain.run(adm.Attributes(
                            adm.UPDATE, r.resource, new, cur,
                            namespace=r.ns or "", name=r.name,
                            subresource=r.subresource or "",
                            user=ident[0], groups=tuple(ident[1])))
                        if self._is_custom(r):
                            new = server.crds.coerce(
                                r.resource, self._custom_version(r),
                                new, cur)
                            new = server.crds.to_storage(r.resource, new)
                        elif core_tv is not None:
                            new = corever.to_storage(r.resource, new,
                                                     core_tv,
                                                     default=False)
                        if r.resource == crdlib.CRDS:
                            new = server.crds.establish(new, dry_run=True)
                        return new
                    updated = server.store.guaranteed_update(
                        r.resource, r.ns or "", r.name, merge)
                    if r.resource == crdlib.CRDS:
                        server.crds.establish(updated)
                    body = self._serve_custom(r, updated)
                    self._audit(r, "apply", 200)
                    self._send_json(200, body)
                except mflib.ApplyConflict as e:
                    body = status_error(409, "Conflict", str(e))
                    body["details"] = {"conflicts": [
                        {"manager": m, "field": mflib.path_str(p)}
                        for m, p in e.conflicts]}
                    self._send_json(409, body)
                except adm.AdmissionDenied as e:
                    self._send_json(403, status_error(
                        403, "Forbidden",
                        "admission plugin %s denied the request: %s"
                        % (e.plugin, e)))
                except (patchlib.PatchError, crdlib.ValidationError) as e:
                    self._send_json(422, status_error(422, "Invalid", str(e)))
                except kv.ConflictError as e:
                    self._send_json(409, status_error(409, "Conflict",
                                                      str(e)))
                except kv.AlreadyExistsError as e:
                    self._send_json(409, status_error(409, "AlreadyExists",
                                                      str(e)))

            def do_DELETE(self):
                begun = self._begin("delete")
                if begun is None:
                    return
                r, ticket = begun
                try:
                    if self._maybe_proxy():
                        return
                    self._do_delete(r)
                finally:
                    if ticket:
                        ticket.__exit__()

            def _do_delete(self, r: _Route) -> None:
                if r.resource is None or r.name is None:
                    self._send_json(404, status_error(404, "NotFound", r.path))
                    return
                if r.subresource in VIRTUAL_SUBRESOURCES:
                    # virtual subresources are GET/POST-only — a write
                    # here must never touch the parent object
                    self._drain_body()
                    self._send_json(405, status_error(
                        405, "MethodNotAllowed",
                        f"{r.subresource} does not support this verb"))
                    return
                # the object being deleted rides old_obj so plugins that
                # decide on current state (NodeRestriction: whose node is
                # this pod bound to?) can see it
                try:
                    cur_obj = server.store.get(r.resource, r.ns or "",
                                               r.name)
                except kv.StoreError:
                    cur_obj = None
                if cur_obj is not None or r.resource == "namespaces":
                    # a DELETE of a missing object must fall through to
                    # the registry's 404, not die on a state-dependent
                    # admission verdict (a kubelet retrying a delete the
                    # GC won would otherwise loop on 403 forever).
                    # Namespaces stay admitted even when implicit: the
                    # immortal-namespace guard is name-based.
                    #
                    # INVARIANT (delete admission): attrs.obj is None on
                    # DELETE — only name/namespace/old_obj carry state.
                    # A plugin that denies deletes MUST therefore key on
                    # the NAME (like NamespaceLifecycle's immortal set)
                    # or on old_obj, never on attrs.obj: a deny derived
                    # from attrs.obj can't fire here, silently admitting
                    # exactly the deletes it was written to block.
                    ident = self._identity() or ("", ())
                    attrs = adm.Attributes(adm.DELETE, r.resource, None,
                                           cur_obj,
                                           namespace=r.ns or "",
                                           name=r.name,
                                           user=ident[0],
                                           groups=tuple(ident[1]))
                    try:
                        server.admission_chain.run(attrs)
                    except adm.AdmissionDenied as e:
                        self._send_json(403, status_error(
                            403, "Forbidden", str(e)))
                        return
                try:
                    # DeleteOptions.propagationPolicy: Foreground/Orphan
                    # park the object with the matching finalizer for the
                    # garbage collector (registry store deletion strategy)
                    policy = (r.query.get("propagationPolicy")
                              or [None])[0]
                    fin = meta.propagation_finalizer(policy)
                    if fin is not None:
                        def park(cur, fin=fin):
                            fins = cur["metadata"].setdefault(
                                "finalizers", [])
                            if fin not in fins:
                                fins.append(fin)
                            return cur
                        server.store.guaranteed_update(
                            r.resource, r.ns or "", r.name, park)
                    deleted = server.store.delete(r.resource, r.ns or "",
                                                  r.name)
                    if r.resource == crdlib.CRDS:
                        server.crds.remove(deleted)
                    self._audit(r, "delete", 200)
                    self._send_json(200, deleted)
                except kv.NotFoundError as e:
                    self._send_json(404, status_error(404, "NotFound", str(e)))

        return Handler


# -- helpers ---------------------------------------------------------------

def _get_path(obj: dict, path: str):
    """'.spec.replicas'-style JSON path lookup (customresource scale
    paths)."""
    cur = obj
    for part in path.strip(".").split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _set_path(obj: dict, path: str, value) -> None:
    parts = path.strip(".").split(".")
    cur = obj
    for part in parts[:-1]:
        nxt = cur.get(part)
        if nxt is None:
            nxt = cur[part] = {}
        elif not isinstance(nxt, dict):
            raise crdlib.ValidationError(
                f"cannot set {path}: {part!r} is not an object")
        cur = nxt
    cur[parts[-1]] = value


def _crd_scale(obj: dict, paths: dict) -> dict:
    """Scale projection through a CRD's declared subresource paths
    (customresource/status_strategy.go scale handling)."""
    return {"kind": "Scale", "apiVersion": "autoscaling/v1",
            "metadata": {"name": meta.name(obj),
                         "namespace": meta.namespace(obj)},
            "spec": {"replicas": _get_path(
                obj, paths.get("specReplicasPath", ".spec.replicas"))
                or 0},
            "status": {"replicas": _get_path(
                obj, paths.get("statusReplicasPath",
                               ".status.replicas")) or 0,
                       "selector": _get_path(
                obj, paths.get("labelSelectorPath", "")) or ""}}


def _scale_of(obj: dict, resource: str) -> dict:
    """autoscaling/v1 Scale subresource projection."""
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    return {"kind": "Scale", "apiVersion": "autoscaling/v1",
            "metadata": {"name": meta.name(obj),
                         "namespace": meta.namespace(obj)},
            "spec": {"replicas": spec.get("replicas", 0)},
            "status": {"replicas": status.get("replicas", 0),
                       "selector": (spec.get("selector") or {})
                       .get("matchLabels", {})}}


from ..api.fields import matches_field_selector as _matches_field_selector
from ..api.fields import validate_field_selector


def _matches_selector(obj: dict, selector: str) -> bool:
    """labelSelector query param: k=v[,k=v...] equality matching."""
    labels = (obj.get("metadata") or {}).get("labels") or {}
    for part in selector.split(","):
        part = part.strip()
        if not part:
            continue
        if "!=" in part:
            k, v = part.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "=" in part:
            k, v = part.split("=", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        else:  # existence
            if part not in labels:
                return False
    return True


def _pdb_matches(pdb: dict, pod: dict) -> bool:
    sel = ((pdb.get("spec") or {}).get("selector") or {}).get("matchLabels", {})
    labels = (pod.get("metadata") or {}).get("labels") or {}
    return bool(sel) and all(labels.get(k) == v for k, v in sel.items())


def _parse_intstr(value, expected: int) -> int:
    """IntOrString: '50%' of expected (rounded up for minAvailable-style
    use; upstream uses intstr.GetScaledValueFromIntOrPercent)."""
    if isinstance(value, str) and value.endswith("%"):
        pct = float(value[:-1])
        return -(-int(pct * expected) // 100)  # ceil
    return int(value)


def _expected_count(store: kv.MemoryStore, matching: list, ns: str) -> int:
    """Desired replica count summed over every distinct owning controller
    (the disruption controller reads scale subresources the same way);
    unowned pods count themselves."""
    owners: dict = {}
    unowned = 0
    for p in matching:
        ref = next((r for r in ((p.get("metadata") or {})
                                .get("ownerReferences") or [])
                    if r.get("controller")), None)
        if ref and ref.get("kind") in ("ReplicaSet", "StatefulSet",
                                       "ReplicationController", "Deployment"):
            key = (ref["kind"], ref["name"])
            if key in owners:
                continue
            try:
                owner = store.get(ref["kind"].lower() + "s", ns, ref["name"])
                owners[key] = int((owner.get("spec") or {})
                                  .get("replicas", 1))
            except kv.NotFoundError:
                owners[key] = 0
        else:
            unowned += 1
    if not owners:
        return len(matching)
    return sum(owners.values()) + unowned


def _pdb_allows_eviction(store: kv.MemoryStore, pdb: dict, ns: str) -> bool:
    """Eviction gate (registry/core/pod/storage/eviction.go): prefer the
    disruption controller's status.disruptionsAllowed; otherwise compute
    inline from minAvailable/maxUnavailable (IntOrString, % supported)."""
    status = pdb.get("status") or {}
    if "disruptionsAllowed" in status:
        return int(status["disruptionsAllowed"]) > 0
    spec = pdb.get("spec") or {}
    sel = (spec.get("selector") or {}).get("matchLabels", {})
    pods, _ = store.list("pods", ns)
    matching = [p for p in pods
                if all(((p.get("metadata") or {}).get("labels") or {})
                       .get(k) == v for k, v in sel.items())]
    healthy = sum(1 for p in matching
                  if (p.get("status") or {}).get("phase")
                  not in ("Failed", "Succeeded")
                  and not (p.get("metadata") or {}).get("deletionTimestamp"))
    expected = _expected_count(store, matching, ns)
    if "minAvailable" in spec:
        return healthy - 1 >= _parse_intstr(spec["minAvailable"], expected)
    if "maxUnavailable" in spec:
        max_unavail = _parse_intstr(spec["maxUnavailable"], expected)
        disrupted = max(0, expected - healthy)
        return disrupted + 1 <= max_unavail
    return True
