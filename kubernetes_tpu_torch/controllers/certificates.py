"""Certificates controllers: CSR approver + signer.

Reference: pkg/controller/certificates/
  approver/sarapprove.go  - auto-approve kubelet client CSRs whose usages/
                            signerName match the known profiles
  signer/signer.go        - sign Approved CSRs with the cluster CA, honoring
                            spec.expirationSeconds (capped), writing
                            status.certificate
  cleaner/cleaner.go      - GC CSRs: expired certs, long-Denied, long-Pending

The CA is generated in-process (cryptography lib): self-signed root, RSA
2048.  The reference loads --cluster-signing-cert-file; our ClusterCA is
that file's stand-in and is shared with the root-ca publisher.

A copy of kubernetes_tpu/controllers/certificates.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import base64
import datetime
import logging
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import CSRS
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)

KUBELET_CLIENT_SIGNER = "kubernetes.io/kube-apiserver-client-kubelet"
KUBELET_SERVING_SIGNER = "kubernetes.io/kubelet-serving"
MAX_EXPIRATION_SECONDS = 365 * 24 * 3600
DEFAULT_EXPIRATION_SECONDS = 24 * 3600

_PENDING_TTL = 24 * 3600      # cleaner.go pendingExpiration (we use 24h)
_DENIED_TTL = 3600            # cleaner.go deniedExpiration simplification


class ClusterCA:
    """In-process cluster CA (the --cluster-signing-cert-file stand-in)."""

    _singleton = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID

        self.key = rsa.generate_private_key(public_exponent=65537,
                                            key_size=2048)
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                             "kubernetes-tpu-ca")])
        now = datetime.datetime.now(datetime.timezone.utc)
        self.cert = (x509.CertificateBuilder()
                     .subject_name(name).issuer_name(name)
                     .public_key(self.key.public_key())
                     .serial_number(x509.random_serial_number())
                     .not_valid_before(now)
                     .not_valid_after(now + datetime.timedelta(days=3650))
                     .add_extension(x509.BasicConstraints(ca=True,
                                                          path_length=None),
                                    critical=True)
                     .sign(self.key, hashes.SHA256()))

    @classmethod
    def shared(cls) -> "ClusterCA":
        with cls._lock:
            if cls._singleton is None:
                cls._singleton = cls()
            return cls._singleton

    def ca_pem(self) -> str:
        from cryptography.hazmat.primitives import serialization
        return self.cert.public_bytes(
            serialization.Encoding.PEM).decode("ascii")

    def sign_csr_pem(self, csr_pem: bytes, seconds: int) -> bytes:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization

        req = x509.load_pem_x509_csr(csr_pem)
        now = datetime.datetime.now(datetime.timezone.utc)
        builder = (x509.CertificateBuilder()
                   .subject_name(req.subject)
                   .issuer_name(self.cert.subject)
                   .public_key(req.public_key())
                   .serial_number(x509.random_serial_number())
                   .not_valid_before(now)
                   .not_valid_after(now + datetime.timedelta(seconds=seconds)))
        for ext in req.extensions:
            builder = builder.add_extension(ext.value, ext.critical)
        cert = builder.sign(self.key, hashes.SHA256())
        return cert.public_bytes(serialization.Encoding.PEM)


def csr_condition(csr: Obj, type_: str) -> Obj | None:
    for c in (csr.get("status") or {}).get("conditions") or ():
        if c.get("type") == type_:
            return c
    return None


def is_approved(csr: Obj) -> bool:
    return csr_condition(csr, "Approved") is not None


def is_denied(csr: Obj) -> bool:
    return csr_condition(csr, "Denied") is not None


class CSRApprovingController(Controller):
    """Auto-approve well-known kubelet CSR profiles (approver/sarapprove.go)."""

    name = "csrapproving"

    RECOGNIZED = {
        KUBELET_CLIENT_SIGNER: {"key encipherment", "digital signature",
                                "client auth"},
        KUBELET_SERVING_SIGNER: {"key encipherment", "digital signature",
                                 "server auth"},
    }

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.csr_informer = factory.informer(CSRS)
        self.csr_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        csr = self.csr_informer.get(ns, name)
        if csr is None or is_approved(csr) or is_denied(csr):
            return
        spec = csr.get("spec") or {}
        allowed = self.RECOGNIZED.get(spec.get("signerName"))
        if allowed is None:
            return  # not ours to approve
        usages = set(spec.get("usages") or ())
        if not usages or not usages.issubset(allowed):
            return

        def patch(o):
            conds = o.setdefault("status", {}).setdefault("conditions", [])
            if any(c.get("type") in ("Approved", "Denied") for c in conds):
                return o
            conds.append({"type": "Approved", "status": "True",
                          "reason": "AutoApproved",
                          "message": "auto-approved kubelet CSR",
                          "lastUpdateTime": time.time()})
            return o
        try:
            self.client.guaranteed_update(CSRS, ns, name, patch)
        except kv.NotFoundError:
            pass


class CSRSigningController(Controller):
    """Sign Approved CSRs with the cluster CA (signer/signer.go)."""

    name = "csrsigning"

    def __init__(self, client, factory, ca: ClusterCA | None = None):
        super().__init__(client, factory)
        self.ca = ca or ClusterCA.shared()
        self.csr_informer = factory.informer(CSRS)
        self.csr_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        csr = self.csr_informer.get(ns, name)
        if csr is None or not is_approved(csr) or is_denied(csr):
            return
        if (csr.get("status") or {}).get("certificate"):
            return  # already signed
        spec = csr.get("spec") or {}
        if spec.get("signerName") not in (KUBELET_CLIENT_SIGNER,
                                          KUBELET_SERVING_SIGNER):
            return
        req_pem = base64.b64decode(spec.get("request") or b"")
        seconds = min(int(spec.get("expirationSeconds")
                          or DEFAULT_EXPIRATION_SECONDS),
                      MAX_EXPIRATION_SECONDS)
        try:
            cert_pem = self.ca.sign_csr_pem(req_pem, seconds)
        except Exception as e:  # malformed request: record failure condition
            logger.warning("csr %s: cannot sign: %s", key, e)

            def fail(o):
                conds = o.setdefault("status", {}).setdefault("conditions", [])
                if not any(c.get("type") == "Failed" for c in conds):
                    conds.append({"type": "Failed", "status": "True",
                                  "reason": "SigningError", "message": str(e)})
                return o
            try:
                self.client.guaranteed_update(CSRS, ns, name, fail)
            except kv.NotFoundError:
                pass
            return

        def patch(o):
            st = o.setdefault("status", {})
            if not st.get("certificate"):
                st["certificate"] = base64.b64encode(cert_pem).decode("ascii")
            return o
        try:
            self.client.guaranteed_update(CSRS, ns, name, patch)
        except kv.NotFoundError:
            pass


class CSRCleanerController(Controller):
    """GC stale CSRs (cleaner/cleaner.go): denied >1h, pending >24h."""

    name = "csrcleaner"
    resync_seconds = 60.0

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.csr_informer = factory.informer(CSRS)

    def run(self) -> None:
        super().run()
        t = threading.Thread(target=self._tick, name="csrcleaner-tick",
                             daemon=True)
        t.start()
        self._threads.append(t)

    def _tick(self) -> None:
        while not self._stopped.wait(self.resync_seconds):
            for csr in self.csr_informer.list(None):
                self.enqueue(csr)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        csr = self.csr_informer.get(ns, name)
        if csr is None:
            return
        age = time.time() - (meta.creation_timestamp(csr) or time.time())
        expired = (is_denied(csr) and age > _DENIED_TTL) or (
            not is_approved(csr) and not is_denied(csr) and age > _PENDING_TTL)
        if expired:
            try:
                self.client.delete(CSRS, ns, name)
            except kv.NotFoundError:
                pass
