"""Request authenticators beyond bearer-token lookup.

Reference:
  - X.509 client certs: staging/src/k8s.io/apiserver/pkg/authentication/
    request/x509/x509.go — the CommonName is the user, each Organization
    is a group, trust anchored on --client-ca-file.
  - ServiceAccount tokens: pkg/serviceaccount/jwt.go + the TokenRequest
    subresource (pkg/registry/core/serviceaccount/storage/token.go) —
    signed JWTs carrying system:serviceaccount:{ns}:{name}, validated
    for signature, expiry, and the account still existing.

TPU-stack shape: the apiserver is an in-process HTTP server, so TLS is
an `ssl`-module wrap of its listening socket and the peer certificate
arrives via SSLSocket.getpeercert().  SA tokens are HS256 JWTs over a
cluster-held signing secret persisted in kube-system (restart-stable),
rather than RSA-signed — the validation contract (signature, exp,
account liveness) is the same.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import secrets
import time

SA_ISSUER = "kubernetes-tpu/serviceaccount"
SA_KEY_SECRET = "serviceaccount-signing-key"
# the apiserver's own token audience: tokens minted for external
# audiences (vault, etc.) must NOT authenticate here (jwt.go audience
# validation against --api-audiences)
API_AUDIENCE = "kubernetes-tpu"


# -- X.509 ---------------------------------------------------------------

def x509_identity(peercert: dict | None
                  ) -> tuple[str, tuple[str, ...]] | None:
    """(user, groups) from an SSLSocket.getpeercert() dict: CN is the
    user, O values are the groups (x509.go CommonNameUserConversion)."""
    if not peercert:
        return None
    user = None
    groups: list[str] = []
    for rdn in peercert.get("subject") or ():
        for key, value in rdn:
            if key == "commonName":
                user = value
            elif key == "organizationName":
                groups.append(value)
    if not user:
        return None
    return user, tuple(groups)


# -- ServiceAccount JWTs -------------------------------------------------

def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


class ServiceAccountIssuer:
    """Mint + verify ServiceAccount JWTs (jwt.go's signer/validator pair).

    The signing key lives in a kube-system Secret so tokens survive an
    apiserver restart the way the reference's --service-account-key-file
    does; first boot generates it."""

    def __init__(self, store):
        from ..api import meta
        from ..store import kv
        self._store = store
        try:
            sec = store.get("secrets", "kube-system", SA_KEY_SECRET)
            self._key = base64.b64decode(sec["data"]["key"])
        except kv.NotFoundError:
            self._key = secrets.token_bytes(32)
            sec = meta.new_object("Secret", SA_KEY_SECRET, "kube-system")
            sec["type"] = "kubernetes-tpu/sa-signing-key"
            sec["data"] = {"key": base64.b64encode(self._key).decode()}
            try:
                store.create("secrets", sec)
            except kv.AlreadyExistsError:  # racing twin: adopt its key
                sec = store.get("secrets", "kube-system", SA_KEY_SECRET)
                self._key = base64.b64decode(sec["data"]["key"])

    def _sign(self, signing_input: bytes) -> str:
        return _b64url(hmac.new(self._key, signing_input,
                                hashlib.sha256).digest())

    def issue(self, namespace: str, name: str, uid: str = "",
              expiration_seconds: int = 3600,
              audiences: tuple[str, ...] = ()) -> tuple[str, float]:
        """-> (token, expiry unix time).  No audience = bound to the
        apiserver's own API_AUDIENCE (TokenRequest defaulting)."""
        now = time.time()
        exp = now + int(expiration_seconds)
        claims = {
            "iss": SA_ISSUER,
            "sub": f"system:serviceaccount:{namespace}:{name}",
            "iat": int(now), "exp": int(exp),
            "aud": list(audiences) or [API_AUDIENCE],
            "kubernetes.io": {"namespace": namespace,
                              "serviceaccount": {"name": name,
                                                 "uid": uid}},
        }
        header = _b64url(json.dumps({"alg": "HS256",
                                     "typ": "JWT"}).encode())
        payload = _b64url(json.dumps(claims).encode())
        signing_input = f"{header}.{payload}".encode()
        return f"{header}.{payload}.{self._sign(signing_input)}", exp

    def verify(self, token: str) -> tuple[str, tuple[str, ...]] | None:
        """(user, groups) or None.  Checks signature, issuer, expiry,
        and that the ServiceAccount object still exists (jwt.go's
        private-claims validation deletes tokens of deleted accounts)."""
        from ..store import kv
        parts = token.split(".")
        if len(parts) != 3:
            return None
        signing_input = f"{parts[0]}.{parts[1]}".encode()
        if not hmac.compare_digest(self._sign(signing_input), parts[2]):
            return None
        try:
            claims = json.loads(_unb64url(parts[1]))
        except (ValueError, json.JSONDecodeError):
            return None
        if claims.get("iss") != SA_ISSUER:
            return None
        aud = claims.get("aud")
        if isinstance(aud, str):
            aud = [aud]
        if not aud or API_AUDIENCE not in aud:
            return None  # token bound to someone else's audience
        try:
            if float(claims.get("exp", 0)) < time.time():
                return None
        except (TypeError, ValueError):
            return None
        sub = claims.get("sub") or ""
        prefix = "system:serviceaccount:"
        if not sub.startswith(prefix):
            return None
        ns, _, name = sub[len(prefix):].partition(":")
        if not ns or not name:
            return None
        try:
            self._store.get("serviceaccounts", ns, name)
        except kv.NotFoundError:
            return None
        return sub, ("system:serviceaccounts",
                     f"system:serviceaccounts:{ns}")


# -- serving/client certificate material ---------------------------------

def issue_cert(ca, common_name: str, organizations: tuple[str, ...] = (),
               dns_sans: tuple[str, ...] = (), ip_sans: tuple[str, ...] = (),
               days: int = 365, server: bool = False) -> tuple[str, str]:
    """(cert_pem, key_pem) signed by the ClusterCA — the certs phase of
    kubeadm (app/phases/certs) for apiserver serving + client certs."""
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    attrs += [x509.NameAttribute(NameOID.ORGANIZATION_NAME, o)
              for o in organizations]
    now = datetime.datetime.now(datetime.timezone.utc)
    eku = (ExtendedKeyUsageOID.SERVER_AUTH if server
           else ExtendedKeyUsageOID.CLIENT_AUTH)
    builder = (x509.CertificateBuilder()
               .subject_name(x509.Name(attrs))
               .issuer_name(ca.cert.subject)
               .public_key(key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now)
               .not_valid_after(now + datetime.timedelta(days=days))
               .add_extension(x509.ExtendedKeyUsage([eku]), critical=False))
    sans: list[x509.GeneralName] = [x509.DNSName(d) for d in dns_sans]
    sans += [x509.IPAddress(ipaddress.ip_address(ip)) for ip in ip_sans]
    if sans:
        builder = builder.add_extension(
            x509.SubjectAlternativeName(sans), critical=False)
    cert = builder.sign(ca.key, hashes.SHA256())
    cert_pem = cert.public_bytes(serialization.Encoding.PEM).decode()
    key_pem = key.private_bytes(
        serialization.Encoding.PEM, serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption()).decode()
    return cert_pem, key_pem


def write_serving_bundle(ca, cert_dir: str,
                         host: str = "127.0.0.1") -> dict[str, str]:
    """Materialize apiserver TLS serving files under cert_dir; returns
    {"cert_file", "key_file", "client_ca_file"} for APIServer(tls=...)."""
    import os
    cert_pem, key_pem = issue_cert(
        ca, "kube-apiserver",
        dns_sans=("localhost", "kubernetes", "kubernetes.default"),
        ip_sans=(host,) if host else ("127.0.0.1",), server=True)
    os.makedirs(cert_dir, exist_ok=True)
    paths = {"cert_file": os.path.join(cert_dir, "apiserver.crt"),
             "key_file": os.path.join(cert_dir, "apiserver.key"),
             "client_ca_file": os.path.join(cert_dir, "ca.crt")}
    with open(paths["cert_file"], "w") as f:
        f.write(cert_pem)
    with open(paths["key_file"], "w") as f:
        os.fchmod(f.fileno(), 0o600)
        f.write(key_pem)
    with open(paths["client_ca_file"], "w") as f:
        f.write(ca.ca_pem())
    return paths
