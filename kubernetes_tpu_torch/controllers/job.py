"""Job controller.

Reference: pkg/controller/job/ — syncJob: keep `parallelism` active pods
until `completions` pods have Succeeded; failed pods are retried up to
backoffLimit; on completion set the Complete condition, on exhaustion
Failed.

A copy of kubernetes_tpu/controllers/job.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import time
import uuid

from ..api import meta
from ..api.meta import Obj
from ..client.clientset import JOBS, PODS
from ..store import kv
from .base import Controller, Expectations, is_owned_by, owner_ref, split_key
from .replicaset import pod_is_active

logger = logging.getLogger(__name__)


class JobController(Controller):
    name = "job"

    def __init__(self, client, factory):
        super().__init__(client, factory)
        self.job_informer = factory.informer(JOBS)
        self.pod_informer = factory.informer(PODS)
        self.expectations = Expectations()
        self.job_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))
        self.pod_informer.add_event_handler(self._on_pod)

    def _on_pod(self, type_, pod: Obj, old) -> None:
        ref = meta.controller_ref(pod)
        if ref and ref.get("kind") == "Job":
            key = f"{meta.namespace(pod)}/{ref['name']}"
            if type_ == kv.ADDED:
                self.expectations.creation_observed(key)
            elif type_ == kv.DELETED:
                self.expectations.deletion_observed(key)
            self.enqueue_key(key)

    def sync(self, key: str) -> None:
        ns, name = split_key(key)
        job = self.job_informer.get(ns, name)
        if job is None:
            return
        spec = job.get("spec") or {}
        completions = spec.get("completions", 1)
        parallelism = spec.get("parallelism", 1)
        backoff_limit = spec.get("backoffLimit", 6)

        owned = [p for p in self.pod_informer.list(ns) if is_owned_by(p, job)]
        succeeded = sum(1 for p in owned
                        if (p.get("status") or {}).get("phase") == "Succeeded")
        failed = sum(1 for p in owned
                     if (p.get("status") or {}).get("phase") == "Failed")
        active = [p for p in owned if pod_is_active(p)]

        conds = (job.get("status") or {}).get("conditions") or []
        done = any(c.get("type") in ("Complete", "Failed") for c in conds)

        if not done and self.expectations.satisfied(key):
            if succeeded >= completions:
                conds = [{"type": "Complete", "status": "True"}]
                for p in active:  # completions reached: reap stragglers
                    try:
                        self.client.delete(PODS, ns, meta.name(p))
                    except kv.NotFoundError:
                        pass
                active = []
            elif failed > backoff_limit:
                conds = [{"type": "Failed", "status": "True",
                          "reason": "BackoffLimitExceeded"}]
            else:
                want_active = min(parallelism, completions - succeeded)
                n_new = want_active - len(active)
                if n_new > 0:
                    self.expectations.expect_creations(key, n_new)
                    for i in range(n_new):
                        try:
                            if not self._create_pod(job):
                                self.expectations.creation_observed(key)
                        except Exception:
                            # lower this + all remaining uncreated slots so
                            # the retry isn't gated for TIMEOUT (the
                            # reference's slowStartBatch does the same)
                            for _ in range(n_new - i):
                                self.expectations.creation_observed(key)
                            raise
        elif not done:
            # expectations pending: leave children alone this round
            pass

        status = {"active": len(active), "succeeded": succeeded,
                  "failed": failed, "conditions": conds}
        prev = job.get("status") or {}
        if any(c.get("type") in ("Complete", "Failed") for c in conds):
            # own the completion stamp so status rewrites don't wipe it
            # (the ttl-after-finished controller keys its sweep off this)
            status["completionTime"] = prev.get("completionTime",
                                                time.time())
        if prev != status:
            def patch(o):
                o["status"] = status
                return o
            try:
                self.client.guaranteed_update(JOBS, ns, name, patch)
            except kv.NotFoundError:
                pass

    def _create_pod(self, job: Obj) -> None:
        tmpl = (job.get("spec") or {}).get("template") or {}
        ns = meta.namespace(job)
        pod = meta.new_object("Pod", f"{meta.name(job)}-{uuid.uuid4().hex[:5]}", ns)
        tmpl_meta = tmpl.get("metadata") or {}
        pod["metadata"]["labels"] = dict(tmpl_meta.get("labels") or {})
        if tmpl_meta.get("annotations"):
            pod["metadata"]["annotations"] = dict(tmpl_meta["annotations"])
        pod["metadata"]["ownerReferences"] = [owner_ref(job, "Job")]
        pod["spec"] = meta.deep_copy(tmpl.get("spec") or {"containers": [
            {"name": "c0", "image": "img"}]})
        pod["spec"].setdefault("restartPolicy", "Never")
        pod["spec"].setdefault("schedulerName", "default-scheduler")
        try:
            self.client.create(PODS, pod)
            return True
        except kv.AlreadyExistsError:
            return False
