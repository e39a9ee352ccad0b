"""Envelope encryption at rest (the KMS provider integration).

Reference:
  staging/src/k8s.io/kms/ (KMS v2 gRPC EncryptRequest/DecryptRequest)
  staging/src/k8s.io/apiserver/pkg/storage/value/encrypt/envelope/ —
    per-object data-encryption keys (DEK) wrapped by the KMS-held
    key-encryption key (KEK); EncryptionConfiguration selects which
    resources are transformed (typically `secrets`).

Here: LocalKMS is the in-process stand-in for the external KMS plugin
(AES-256-GCM KEK, key id rotation supported); EnvelopeTransformer does
DEK-per-object envelope encryption of the VALUE while the store keeps
`metadata` in the clear (our etcd3-equivalent peeks at metadata for CAS /
key bookkeeping; the sensitive payload of a Secret lives under data/).
"""

from __future__ import annotations

import base64
import json
import os
import threading

ENVELOPE_KEY = "__k8s_tpu_envelope__"


class DecryptError(Exception):
    pass


class LocalKMS:
    """In-process KMS plugin: holds KEKs by key id (kms v2 Encrypt/Decrypt).

    rotate() adds a new KEK and makes it current; old key ids keep
    decrypting (the reference's multi-key DecryptRequest behavior).

    key_file (optional) persists the KEK ring so sealed objects recovered
    from a durable store stay decryptable across restarts — the role the
    external KMS's own storage plays for the reference; without it the
    keys are process-lifetime only (fine for a memory-only store)."""

    def __init__(self, key_file: str | None = None) -> None:
        self._lock = threading.Lock()
        self._keys: dict[str, bytes] = {}
        self._current = ""
        self._key_file = key_file
        if key_file and os.path.exists(key_file):
            with open(key_file) as f:
                ring = json.load(f)
            self._keys = {k: base64.b64decode(v) for k, v in
                          ring["keys"].items()}
            self._current = ring["current"]
        else:
            self.rotate()

    def rotate(self) -> str:
        with self._lock:
            kid = f"key-{len(self._keys) + 1}"
            self._keys[kid] = os.urandom(32)
            self._current = kid
            if self._key_file:
                tmp = self._key_file + ".tmp"
                with open(tmp, "w") as f:
                    os.fchmod(f.fileno(), 0o600)
                    json.dump({"current": kid,
                               "keys": {k: base64.b64encode(v).decode()
                                        for k, v in self._keys.items()}}, f)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self._key_file)
            return kid

    @property
    def current_key_id(self) -> str:
        with self._lock:
            return self._current

    def encrypt(self, plaintext: bytes) -> tuple[str, bytes]:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        with self._lock:
            kid, kek = self._current, self._keys[self._current]
        nonce = os.urandom(12)
        return kid, nonce + AESGCM(kek).encrypt(nonce, plaintext, None)

    def decrypt(self, key_id: str, blob: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        with self._lock:
            kek = self._keys.get(key_id)
        if kek is None:
            raise DecryptError(f"unknown KMS key id {key_id!r}")
        try:
            return AESGCM(kek).decrypt(blob[:12], blob[12:], None)
        except Exception as e:
            raise DecryptError(str(e)) from e


class EnvelopeTransformer:
    """value/encrypt/envelope semantics: fresh DEK per write, DEK wrapped
    by the KMS KEK, AES-GCM for the payload."""

    def __init__(self, kms: LocalKMS):
        self.kms = kms

    def encrypt_obj(self, obj: dict) -> dict:
        """Returns the at-rest form: clear metadata + sealed payload."""
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        payload = {k: v for k, v in obj.items() if k != "metadata"}
        dek = os.urandom(32)
        nonce = os.urandom(12)
        ct = AESGCM(dek).encrypt(nonce,
                                 json.dumps(payload).encode(), None)
        kid, edek = self.kms.encrypt(dek)
        return {
            "metadata": obj.get("metadata", {}),
            ENVELOPE_KEY: {
                "kid": kid,
                "edek": base64.b64encode(edek).decode("ascii"),
                "nonce": base64.b64encode(nonce).decode("ascii"),
                "ct": base64.b64encode(ct).decode("ascii"),
            },
        }

    def decrypt_obj(self, stored: dict) -> dict:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        env = stored.get(ENVELOPE_KEY)
        if env is None:
            return stored  # written before encryption was enabled
        dek = self.kms.decrypt(env["kid"], base64.b64decode(env["edek"]))
        try:
            payload = json.loads(AESGCM(dek).decrypt(
                base64.b64decode(env["nonce"]),
                base64.b64decode(env["ct"]), None))
        except Exception as e:
            raise DecryptError(str(e)) from e
        out = dict(payload)
        out["metadata"] = stored.get("metadata", {})
        return out

    def is_encrypted(self, stored: dict) -> bool:
        return ENVELOPE_KEY in stored
