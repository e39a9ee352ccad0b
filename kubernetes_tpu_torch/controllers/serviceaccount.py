"""ServiceAccount + token controller.

Reference: pkg/controller/serviceaccount/ — every namespace gets a
"default" ServiceAccount; a token Secret is minted per ServiceAccount
(legacy token controller shape; modern kubelets use projected tokens, but
the API contract — secrets list on the SA — is what clients consume).

A copy of kubernetes_tpu/controllers/serviceaccount.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import secrets as pysecrets

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import NAMESPACES, SECRETS, SERVICEACCOUNTS
from ..store import kv
from .base import Controller, split_key

logger = logging.getLogger(__name__)


class ServiceAccountController(Controller):
    name = "serviceaccount"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.ns_informer = factory.informer(NAMESPACES)
        self.sa_informer = factory.informer(SERVICEACCOUNTS)
        self.ns_informer.add_event_handler(
            lambda t, obj, old: self.enqueue_key(meta.name(obj)))
        self.sa_informer.add_event_handler(self._on_sa)

    def _on_sa(self, type_, sa: Obj, old) -> None:
        self.enqueue_key(meta.namespace(sa))

    def sync(self, key: str) -> None:
        _, ns_name = split_key(key)
        if self.ns_informer.get("", ns_name) is None:
            return
        sa = self.sa_informer.get(ns_name, "default")
        if sa is None:
            obj = meta.new_object("ServiceAccount", "default", ns_name)
            try:
                sa = self.client.create(SERVICEACCOUNTS, obj)
            except kv.AlreadyExistsError:
                return
        # token secret (legacy token controller).  Read-through to the
        # store (not the informer, which may lag our own patch) and append
        # inside the CAS closure so a racing sync can't double-mint.
        try:
            sa = self.client.get(SERVICEACCOUNTS, ns_name, "default")
        except kv.NotFoundError:
            return
        if not sa.get("secrets"):
            token_name = f"default-token-{pysecrets.token_hex(3)}"
            minted = {"made": False}

            def patch(o):
                if o.get("secrets"):
                    return o  # another sync won the race
                o.setdefault("secrets", []).append({"name": token_name})
                minted["made"] = True
                return o
            try:
                self.client.guaranteed_update(SERVICEACCOUNTS, ns_name,
                                              "default", patch)
            except kv.NotFoundError:
                return
            if minted["made"]:
                secret = meta.new_object("Secret", token_name, ns_name)
                secret["type"] = "kubernetes.io/service-account-token"
                secret["metadata"]["annotations"] = {
                    "kubernetes.io/service-account.name": "default"}
                secret["data"] = {"token": pysecrets.token_urlsafe(32)}
                try:
                    self.client.create(SECRETS, secret)
                except kv.AlreadyExistsError:
                    pass
