"""Bootstrap token controllers.

Reference: pkg/controller/bootstrap/
  tokencleaner.go  - delete bootstrap token Secrets past their
                     `expiration` field
  bootstrapsigner.go - maintain the `cluster-info` ConfigMap in
                     kube-public, JWS-signed with each valid token (we
                     publish the kubeconfig stub + HMAC signatures).

A copy of kubernetes_tpu/controllers/bootstrap.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import CONFIGMAPS, SECRETS
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)

BOOTSTRAP_TOKEN_TYPE = "bootstrap.kubernetes.io/token"
TOKEN_SECRET_NS = "kube-system"
CLUSTER_INFO_NS = "kube-public"


def build_cluster_info_kubeconfig(server_url: str = "",
                                  ca_pem: str = "") -> str:
    """The kubeconfig stub published in cluster-info.  JSON (a valid
    kubeconfig encoding) so join can parse it without a YAML dependency;
    carries the apiserver endpoint and CA bundle — the two facts the JWS
    exists to protect."""
    import json as _json
    cluster: dict = {}
    if server_url:
        cluster["server"] = server_url
    if ca_pem:
        cluster["certificate-authority-data"] = base64.b64encode(
            ca_pem.encode()).decode("ascii")
    return _json.dumps({
        "apiVersion": "v1", "kind": "Config",
        "clusters": [{"name": "", "cluster": cluster}],
    }, sort_keys=True)
CLUSTER_INFO_NAME = "cluster-info"


def _token_fields(secret: Obj) -> tuple[str, str] | None:
    data = secret.get("data") or {}
    tid, tsec = data.get("token-id"), data.get("token-secret")
    return (tid, tsec) if tid and tsec else None


class TokenCleaner(Controller):
    """Delete expired bootstrap tokens (tokencleaner.go)."""

    name = "tokencleaner"
    resync_seconds = 30.0

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.secret_informer = factory.informer(SECRETS)
        self.secret_informer.add_event_handler(self._on_secret)

    def _on_secret(self, type_, secret, old) -> None:
        if secret.get("type") == BOOTSTRAP_TOKEN_TYPE:
            self.enqueue(secret)

    def run(self) -> None:
        super().run()
        t = threading.Thread(target=self._tick, name="tokencleaner-tick",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _tick(self) -> None:
        while not self._stopped.wait(self.resync_seconds):
            for s in self.secret_informer.list(TOKEN_SECRET_NS):
                if s.get("type") == BOOTSTRAP_TOKEN_TYPE:
                    self.enqueue(s)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        secret = self.secret_informer.get(ns, name)
        if secret is None or secret.get("type") != BOOTSTRAP_TOKEN_TYPE:
            return
        exp = (secret.get("data") or {}).get("expiration")
        if exp is None:
            return
        try:
            expires = float(exp)
        except (TypeError, ValueError):
            logger.warning("bootstrap token %s: bad expiration %r", key, exp)
            return
        if time.time() >= expires:
            try:
                self.client.delete(SECRETS, ns, name)
            except kv.NotFoundError:
                pass


class BootstrapSigner(Controller):
    """Publish + sign the kube-public/cluster-info ConfigMap
    (bootstrapsigner.go): one `jws-kubeconfig-<token-id>` entry per live
    token, HMAC(token-secret, kubeconfig)."""

    name = "bootstrapsigner"

    def __init__(self, client, factory, kubeconfig: str = "",
                 server_url: str = "", ca_pem: str = ""):
        super().__init__(client, factory)
        # The signed payload must BIND cluster identity — endpoint + CA —
        # or the signature only proves token knowledge (bootstrapsigner.go
        # signs a kubeconfig carrying the CA bundle and server address).
        # When constructed from the manager registry (no explicit URL),
        # derive the endpoint from the HTTP client so the published
        # cluster-info stays joinable; in-process LocalClients have no
        # endpoint and publish a stub join must reject.
        if not server_url and hasattr(client, "host"):
            server_url = f"http://{client.host}:{client.port}"
        if not ca_pem:
            try:
                from .certificates import ClusterCA
                ca_pem = ClusterCA.shared().ca_pem()
            except Exception:  # cryptography unavailable: stub CA omitted
                ca_pem = ""
        self.kubeconfig = kubeconfig or build_cluster_info_kubeconfig(
            server_url, ca_pem)
        self.secret_informer = factory.informer(SECRETS)
        self.cm_informer = factory.informer(CONFIGMAPS)
        self.secret_informer.add_event_handler(self._on_change)
        self.cm_informer.add_event_handler(self._on_cm)

    def _on_change(self, type_, secret, old) -> None:
        if secret.get("type") == BOOTSTRAP_TOKEN_TYPE:
            self.enqueue_key(f"{CLUSTER_INFO_NS}/{CLUSTER_INFO_NAME}")

    def _on_cm(self, type_, cm, old) -> None:
        if (meta.namespace(cm) == CLUSTER_INFO_NS
                and meta.name(cm) == CLUSTER_INFO_NAME):
            self.enqueue(cm)

    def sync(self, key: str) -> None:
        sigs = {}
        now = time.time()
        for s in self.secret_informer.list(TOKEN_SECRET_NS):
            if s.get("type") != BOOTSTRAP_TOKEN_TYPE:
                continue
            exp = (s.get("data") or {}).get("expiration")
            if exp is not None:
                try:
                    if now >= float(exp):
                        continue
                except (TypeError, ValueError):
                    logger.warning("bootstrap token %s: bad expiration %r",
                                   meta.name(s), exp)
                    continue
            fields = _token_fields(s)
            if fields is None:
                continue
            tid, tsec = fields
            mac = hmac.new(tsec.encode(), self.kubeconfig.encode(),
                           hashlib.sha256).digest()
            sigs[f"jws-kubeconfig-{tid}"] = base64.urlsafe_b64encode(
                mac).decode("ascii")

        managed = {"kubeconfig": self.kubeconfig, **sigs}

        def merge(data: dict) -> dict:
            # only the kubeconfig + jws-* entries are ours; foreign keys
            # are preserved (bootstrapsigner.go updates signatures in place)
            out = {k: v for k, v in data.items()
                   if not k.startswith("jws-kubeconfig-")}
            out.update(managed)
            return out

        cm = self.cm_informer.get(CLUSTER_INFO_NS, CLUSTER_INFO_NAME)
        if cm is None:
            obj = meta.new_object("ConfigMap", CLUSTER_INFO_NAME,
                                  CLUSTER_INFO_NS)
            obj["data"] = dict(managed)
            try:
                self.client.create(CONFIGMAPS, obj)
            except kv.AlreadyExistsError:
                pass
        elif merge(cm.get("data") or {}) != (cm.get("data") or {}):
            def patch(o):
                o["data"] = merge(o.get("data") or {})
                return o
            try:
                self.client.guaranteed_update(CONFIGMAPS, CLUSTER_INFO_NS,
                                              CLUSTER_INFO_NAME, patch)
            except kv.NotFoundError:
                pass
