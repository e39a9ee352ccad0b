"""HTTP client speaking to the REST apiserver.

Reference: staging/src/k8s.io/client-go rest.Client + the watch decoder
(tools/watch). Implements the same Client interface as LocalClient, so
informers/controllers/schedulers run identically in-process or over HTTP.
"""

from __future__ import annotations

import http.client
import json
import threading
from typing import Callable

from ..api import meta
from ..api.meta import Obj
from ..store import kv
from .clientset import CLUSTER_SCOPED_RESOURCES, Client

_ERRORS = {404: kv.NotFoundError, 409: kv.ConflictError, 410: kv.TooOldError}


class HTTPError(kv.StoreError):
    def __init__(self, code: int, message: str):
        self.code = code
        super().__init__(f"HTTP {code}: {message}")


def _bind_conflict_from(body: dict) -> kv.BindConflict:
    """Rehydrate the typed conflict from a 409 Status: the structured
    fields ride the `details` block (apiserver bind_conflict_status) so
    an HTTP scheduler classifies already_bound_same_node/lost_to_peer
    exactly like a LocalClient one."""
    d = body.get("details") or {}
    return kv.BindConflict(body.get("message", ""),
                           key=d.get("name") or "",
                           current_node=d.get("currentNode"),
                           wanted_node=d.get("wantedNode"))


def _raise_for(code: int, body: dict) -> None:
    msg = body.get("message", "")
    if body.get("reason") == "AlreadyExists":
        raise kv.AlreadyExistsError(msg)
    if body.get("reason") == "BindConflict":
        raise _bind_conflict_from(body)
    err = _ERRORS.get(code)
    if err is not None:
        raise err(msg)
    raise HTTPError(code, msg)


def make_connection(host: str, port: int,
                    ssl_context=None) -> http.client.HTTPConnection:
    """The one place HTTP-vs-HTTPS connection choice lives."""
    if ssl_context is not None:
        return http.client.HTTPSConnection(host, port,
                                           context=ssl_context)
    return http.client.HTTPConnection(host, port)


class _ChunkDecoder:
    """Incremental HTTP/1.1 chunked-transfer decoder.

    http.client's own chunked reader is unusable for a live stream: its
    BufferedReader slurps wire bytes into a Python-level buffer that
    select() on the raw socket cannot see, so a delivered event can sit
    invisible until the NEXT write arrives (measured: a 3k-pod burst
    surfaced only when the 5s server heartbeat pushed it out).  Decoding
    the framing ourselves over raw recv() makes readability == select.
    """

    _HEADER, _PAYLOAD, _TRAILER_CRLF, _DONE = range(4)

    def __init__(self, chunked: bool):
        self.chunked = chunked
        self.raw = bytearray()
        self._state = self._HEADER
        self._left = 0  # payload bytes remaining in the current chunk

    def feed(self, data: bytes) -> bytes:
        """Decode more wire bytes; returns the payload bytes produced."""
        if not self.chunked:
            return data
        self.raw += data
        out = bytearray()
        while True:
            if self._state == self._HEADER:
                i = self.raw.find(b"\r\n")
                if i < 0:
                    break
                try:
                    size = int(bytes(self.raw[:i]).split(b";")[0], 16)
                except ValueError:
                    self._state = self._DONE  # corrupt framing: EOF
                    break
                del self.raw[:i + 2]
                if size == 0:
                    self._state = self._DONE
                    break
                self._left = size
                self._state = self._PAYLOAD
            elif self._state == self._PAYLOAD:
                if not self.raw:
                    break
                take = min(self._left, len(self.raw))
                out += self.raw[:take]
                del self.raw[:take]
                self._left -= take
                if self._left == 0:
                    self._state = self._TRAILER_CRLF
            elif self._state == self._TRAILER_CRLF:
                if len(self.raw) < 2:
                    break
                del self.raw[:2]
                self._state = self._HEADER
            else:  # _DONE
                break
        return bytes(out)

    @property
    def done(self) -> bool:
        return self._state == self._DONE


class HTTPWatch:
    """Consumes the newline-delimited JSON watch stream; quacks like kv.Watch.

    Framing is managed explicitly: raw socket recv -> _ChunkDecoder ->
    line buffer.  A poll timeout (select) leaves partial lines/chunks
    intact, and buffered-but-unparsed data can never hide from the
    readability check — see _ChunkDecoder's docstring for why
    http.client's reader cannot be used here."""

    def __init__(self, host: str, port: int, path: str,
                 headers: dict[str, str], ssl_context=None):
        self._conn = make_connection(host, port, ssl_context)
        self._conn.request("GET", path, headers=headers)
        self._resp = self._conn.getresponse()
        if self._resp.status != 200:
            body = json.loads(self._resp.read() or b"{}")
            self._conn.close()
            _raise_for(self._resp.status, body)
        chunked = (self._resp.getheader("Transfer-Encoding", "")
                   .lower() == "chunked")
        self._decoder = _ChunkDecoder(chunked)
        self._buf = bytearray()
        self._stopped = False
        self._lock = threading.Lock()
        self._sock = self._resp.fp.raw._sock \
            if hasattr(self._resp.fp, "raw") else None
        # getresponse()'s header reads may have overshot into the body:
        # drain the BufferedReader's residue without blocking, then stop
        # using it entirely
        if self._sock is not None:
            self._sock.setblocking(False)
            try:
                while True:
                    residue = self._resp.fp.read1(1 << 20)
                    if not residue:
                        break
                    self._buf += self._decoder.feed(residue)
            except (BlockingIOError, OSError):
                pass
            finally:
                self._sock.setblocking(True)

    def _fill(self, timeout: float | None) -> bool:
        """One raw recv into the line buffer. False on timeout/EOF/error
        (EOF/error also set _stopped).

        NEVER sets a socket timeout: SocketIO poisons itself permanently
        after one timed-out read ("cannot read from timed out object").
        Readiness comes from select; the recv itself runs on the
        blocking socket and returns promptly because data is there."""
        if not self._wait_readable(timeout):
            return False  # poll timeout: stream is still alive
        try:
            data = self._sock.recv(65536) if self._sock is not None \
                else self._resp.read1(65536)
        except OSError:
            self._stopped = True
            return False
        if not data:
            self._stopped = True
            return False
        self._buf += self._decoder.feed(data)
        if self._decoder.done:
            self._stopped = True
        return True

    def _wait_readable(self, timeout: float | None) -> bool:
        import select
        sock = self._sock
        if sock is None:  # no raw socket handle: read blocking
            return True
        pending = getattr(sock, "pending", None)  # TLS-layer buffer
        if pending is not None and pending():
            return True
        try:
            return bool(select.select([sock], [], [], timeout)[0])
        except (OSError, ValueError):
            self._stopped = True
            return False

    @staticmethod
    def _parse(line: bytes):
        """WatchEvent, kv.BOOKMARK for heartbeats, or None for junk."""
        try:
            payload = json.loads(line)
        except json.JSONDecodeError:
            return None
        if payload.get("type") == kv.BOOKMARK:
            return kv.BOOKMARK
        return kv.WatchEvent(payload["type"], payload["object"],
                             meta.resource_version(payload["object"]))

    def _next_buffered(self):
        """Next event already in the line buffer: a WatchEvent, the
        kv.BOOKMARK sentinel (heartbeat), or None when the buffer holds
        no complete line.  No socket reads."""
        while True:
            i = self._buf.find(b"\n")
            if i < 0:
                return None
            line = bytes(self._buf[:i + 1])
            del self._buf[:i + 1]
            ev = self._parse(line)
            if ev is None:
                continue  # junk line
            return ev

    def next(self, timeout: float | None = None):
        if self._stopped:
            return None
        while True:
            ev = self._next_buffered()
            if ev is kv.BOOKMARK:
                return None  # heartbeat: caller polls again
            if ev is not None:
                return ev
            if not self._fill(timeout):
                return None

    BATCH_MAX = 4096

    def next_batch(self, timeout: float | None = None):
        """kv.Watch.next_batch parity for bulk informer consumption:
        block for the first event, then drain complete buffered lines
        plus whatever the socket can hand over without blocking — a
        server-side flood arrives as one batch, so the informer's bulk
        handlers take one lock round per burst instead of one per
        event."""
        ev = self.next(timeout)
        if ev is None:
            return []
        batch = [ev]
        while len(batch) < self.BATCH_MAX:
            ev = self._next_buffered()
            if ev is kv.BOOKMARK:
                continue
            if ev is None:
                if self._stopped or not self._wait_readable(0):
                    break
                if not self._fill(0):
                    break
                continue
            batch.append(ev)
        return batch

    def stop(self) -> None:
        with self._lock:
            if not self._stopped:
                self._stopped = True
                try:
                    self._conn.close()
                except OSError:
                    pass

    @property
    def stopped(self) -> bool:
        return self._stopped


class HTTPClient(Client):
    def __init__(self, host: str, port: int, token: str | None = None,
                 cluster_scoped: frozenset[str] = CLUSTER_SCOPED_RESOURCES,
                 tls: dict | None = None):
        """`tls` switches to HTTPS: {"ca_file": pinned server CA or None
        (unverified), "cert_file"/"key_file": optional client cert —
        the X.509 identity the apiserver's client-CA authn reads}."""
        self.host, self.port = host, port
        self._headers = {"Content-Type": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        self._cluster_scoped = cluster_scoped
        self._local = threading.local()
        self._ssl_context = None
        if tls is not None:
            import ssl
            if tls.get("ca_file") or tls.get("ca_data"):
                ctx = ssl.create_default_context(
                    cafile=tls.get("ca_file"), cadata=tls.get("ca_data"))
                ctx.check_hostname = False  # pinned CA, IP endpoints
            else:
                ctx = ssl._create_unverified_context()
            if tls.get("cert_file"):
                ctx.load_cert_chain(tls["cert_file"],
                                    keyfile=tls.get("key_file"))
            self._ssl_context = ctx

    @classmethod
    def from_url(cls, url: str, token: str | None = None,
                 tls: dict | None = None) -> "HTTPClient":
        scheme, _, hostport = url.rstrip("/").rpartition("//")
        host, _, port = hostport.partition(":")
        if scheme.startswith("https") and tls is None:
            tls = {}  # unverified TLS — callers pin via tls["ca_file"]
        return cls(host, int(port or (443 if tls is not None else 80)),
                   token, tls=tls)

    @classmethod
    def from_kubeconfig(cls, path: str) -> "HTTPClient":
        """Build a client from a kubeconfig: endpoint + pinned CA +
        either a bearer token or a client cert/key (kubeadm output)."""
        import base64
        import os
        import tempfile

        import yaml
        with open(path) as f:
            doc = yaml.safe_load(f)
        cluster = (doc.get("clusters") or [{}])[0].get("cluster") or {}
        user = (doc.get("users") or [{}])[0].get("user") or {}
        server = cluster.get("server", "http://127.0.0.1:8080")
        tls = None
        tmpdir = None
        if server.startswith("https"):
            tls = {}
            if cluster.get("certificate-authority-data"):
                # CA goes straight into the ssl context — no file
                tls["ca_data"] = base64.b64decode(
                    cluster["certificate-authority-data"]).decode()
            if user.get("client-certificate-data"):
                if not user.get("client-key-data"):
                    raise ValueError(
                        f"kubeconfig {path}: user has "
                        "client-certificate-data but no client-key-data")
                # ssl.load_cert_chain only takes paths: materialize into
                # a TemporaryDirectory whose finalizer removes the key
                # when the client is garbage-collected
                tmpdir = tempfile.TemporaryDirectory(
                    prefix="ktpu-kubeconfig-")
                tls["cert_file"] = os.path.join(tmpdir.name, "client.crt")
                tls["key_file"] = os.path.join(tmpdir.name, "client.key")
                with open(tls["cert_file"], "wb") as f:
                    f.write(base64.b64decode(
                        user["client-certificate-data"]))
                fd = os.open(tls["key_file"],
                             os.O_WRONLY | os.O_CREAT, 0o600)
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(user["client-key-data"]))
        client = cls.from_url(server, token=user.get("token"), tls=tls)
        client._tls_tmpdir = tmpdir  # keep the finalizer alive
        return client

    # -- plumbing --------------------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._local.conn = make_connection(
                self.host, self.port, self._ssl_context)
        return conn

    def _request(self, method: str, path: str, body: Obj | None = None,
                 content_type: str | None = None) -> dict:
        payload = json.dumps(body) if body is not None else None
        headers = self._headers
        if content_type is not None:
            headers = dict(headers, **{"Content-Type": content_type})
        for attempt in range(2):  # retry once on stale keep-alive conns
            conn = self._conn()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = json.loads(resp.read() or b"{}")
                break
            except (http.client.HTTPException, OSError):
                self._local.conn = None
                if attempt:
                    raise
        if resp.status >= 400:
            _raise_for(resp.status, data)
        return data

    def _path(self, resource: str, namespace: str | None = None,
              name: str | None = None) -> str:
        if resource in self._cluster_scoped or not namespace:
            p = f"/api/v1/{resource}"
        else:
            p = f"/api/v1/namespaces/{namespace}/{resource}"
        return p + (f"/{name}" if name else "")

    # -- Client ----------------------------------------------------------

    def create(self, resource: str, obj: Obj) -> Obj:
        return self._request("POST", self._path(resource, meta.namespace(obj)),
                             obj)

    def get(self, resource: str, namespace: str, name: str) -> Obj:
        return self._request("GET", self._path(resource, namespace, name))

    def update(self, resource: str, obj: Obj) -> Obj:
        return self._request(
            "PUT", self._path(resource, meta.namespace(obj), meta.name(obj)),
            obj)

    def guaranteed_update(self, resource: str, namespace: str, name: str,
                          fn: Callable[[Obj], Obj], max_retries: int = 16) -> Obj:
        for _ in range(max_retries):
            cur = self.get(resource, namespace, name)
            try:
                return self.update(resource, fn(meta.deep_copy(cur)))
            except kv.ConflictError:
                continue
        raise kv.ConflictError(f"{resource} {namespace}/{name}: too many CAS retries")

    def delete(self, resource: str, namespace: str, name: str,
               propagation_policy: str | None = None) -> Obj:
        path = self._path(resource, namespace, name)
        if propagation_policy:
            path += f"?propagationPolicy={propagation_policy}"
        return self._request("DELETE", path)

    def list(self, resource: str, namespace: str | None = None
             ) -> tuple[list[Obj], int]:
        data = self._request("GET", self._path(resource, namespace))
        return data.get("items", []), int(data["metadata"]["resourceVersion"])

    def watch(self, resource: str, since_rv: int | None = None):
        path = self._path(resource) + "?watch=true"
        if since_rv is not None:
            path += f"&resourceVersion={since_rv}"
        return HTTPWatch(self.host, self.port, path, self._headers,
                         ssl_context=self._ssl_context)

    # -- patch + subresources (endpoints/handlers/patch.go; pod storage) --

    def patch(self, resource: str, namespace: str, name: str, patch_body,
              patch_type: str = "application/strategic-merge-patch+json",
              subresource: str | None = None) -> Obj:
        path = self._path(resource, namespace, name)
        if subresource:
            path += "/" + subresource
        return self._request("PATCH", path, patch_body,
                             content_type=patch_type)

    def apply(self, resource: str, obj: Obj, field_manager: str,
              force: bool = False) -> Obj:
        """Server-side apply: PATCH application/apply-patch+yaml with
        fieldManager/force query params (apply.go sendPatch)."""
        ns = (obj.get("metadata") or {}).get("namespace", "")
        nm = obj["metadata"]["name"]
        path = self._path(resource, ns, nm)
        path += f"?fieldManager={field_manager}"
        if force:
            path += "&force=true"
        return self._request("PATCH", path, obj,
                             content_type="application/apply-patch+yaml")

    def bind(self, pod: Obj, node_name: str,
             expect_rv: int | None = None) -> Obj:
        """POST pods/{name}/binding (DefaultBinder's write).  expect_rv
        rides metadata.resourceVersion as the compare-and-bind
        precondition (scale-out schedulers)."""
        path = self._path("pods", meta.namespace(pod), meta.name(pod)) + "/binding"
        md: Obj = {"name": meta.name(pod)}
        if expect_rv is not None:
            md["resourceVersion"] = expect_rv
        return self._request("POST", path, {
            "kind": "Binding", "apiVersion": "v1",
            "metadata": md,
            "target": {"kind": "Node", "name": node_name}})

    _BULK_ERRORS = {"BindConflict": kv.BindConflict,
                    "Conflict": kv.ConflictError,
                    "NotFound": kv.NotFoundError,
                    "AlreadyExists": kv.AlreadyExistsError}

    def bind_many(self, bindings: list[tuple]
                  ) -> list[tuple[Obj | None, Exception | None]]:
        """Bulk bind through ONE request: POST a BindingList to the
        bindings collection (server: _post_bindings -> kv.bind_many).
        Per-pod fallback when the server predates the bulk verb."""
        items = []
        for entry in bindings:
            ns, nm, node = entry[0], entry[1], entry[2]
            md = {"namespace": ns, "name": nm}
            if len(entry) > 3 and entry[3] is not None:
                md["resourceVersion"] = entry[3]
            items.append({"metadata": md,
                          "target": {"kind": "Node", "name": node}})
        body = {"kind": "BindingList", "apiVersion": "v1", "items": items}
        try:
            resp = self._request("POST", "/api/v1/bindings", body)
        except kv.NotFoundError:
            # server predates the bulk route (404 maps to NotFoundError;
            # a server WITH the route reports per-item errors in-band)
            return super().bind_many(bindings)
        out: list[tuple[Obj | None, Exception | None]] = []
        for item in resp.get("items") or ():
            if item.get("status") == "Success":
                out.append(({}, None))
            elif item.get("reason") == "BindConflict":
                out.append((None, _bind_conflict_from(item)))
            else:
                err = self._BULK_ERRORS.get(item.get("reason"), HTTPError)
                msg = item.get("message", "")
                out.append((None, err(item.get("code", 500), msg)
                            if err is HTTPError else err(msg)))
        while len(out) < len(bindings):  # pragma: no cover - short reply
            out.append((None, HTTPError(500, "missing bulk result")))
        return out

    def create_events(self, events: list[Obj]) -> None:
        """Event broadcaster flush: one bulk POST per burst (the generic
        base writes one by one)."""
        self.create_bulk("events", events)

    def create_bulk(self, resource: str, objs: list[Obj]) -> None:
        """Bulk create through ONE request: POST {kind: List, items} to
        the collection (server: _post_bulk_create -> kv.create_many).
        Raises on the first per-item failure, matching
        LocalClient.create_bulk's contract (the event broadcaster's
        flush catches StoreError, keeping events fire-and-forget)."""
        if not objs:
            return
        try:
            resp = self._request("POST",
                                 self._path(resource,
                                            meta.namespace(objs[0])),
                                 {"kind": "List", "apiVersion": "v1",
                                  "items": objs})
        except kv.NotFoundError:
            for o in objs:  # server predates the bulk route
                self.create(resource, o)
            return
        for item in resp.get("items") or ():
            if item.get("status") != "Success":
                err = self._BULK_ERRORS.get(item.get("reason"))
                msg = item.get("message", "")
                raise err(msg) if err is not None else HTTPError(
                    item.get("code", 500), msg)

    def evict(self, namespace: str, name: str) -> Obj:
        """POST pods/{name}/eviction — PDB-gated delete (429 when blocked)."""
        path = self._path("pods", namespace, name) + "/eviction"
        return self._request("POST", path, {
            "kind": "Eviction", "apiVersion": "policy/v1",
            "metadata": {"name": name, "namespace": namespace}})

    def update_status(self, resource: str, obj: Obj) -> Obj:
        path = self._path(resource, meta.namespace(obj), meta.name(obj)) + "/status"
        return self._request("PUT", path, obj)

    def scale(self, resource: str, namespace: str, name: str,
              replicas: int | None = None) -> Obj:
        path = self._path(resource, namespace, name) + "/scale"
        if replicas is None:
            return self._request("GET", path)
        return self._request("PUT", path, {"spec": {"replicas": replicas}})
