"""Scheduler extender — out-of-process extension over HTTP+JSON.

Reference: pkg/scheduler/extender.go (HTTPExtender) and the Extender
interface at pkg/scheduler/framework/extender.go:27-67; wire types from
staging/src/k8s.io/kube-scheduler/extender/v1.  Semantics reproduced:
  * Filter POSTs ExtenderArgs {pod, nodenames} and gets back the surviving
    node names plus failed / failed-and-unresolvable maps (extender.go
    Filter; nodeCacheCapable decides names-vs-full-objects on the wire).
  * Prioritize returns a host->score list that the scheduler multiplies by
    the extender's weight and adds to the plugin score sum
    (schedule_one.go:733 prioritizeNodes extender fan-out).
  * Bind delegates the binding POST to the extender when configured
    (extender.go Bind; used instead of the framework's Bind plugins).
  * is_interested gates all of it on the pod requesting at least one
    managed resource (extender.go IsInterested).
  * ignorable extenders are skipped on error instead of failing the cycle
    (extender.go IsIgnorable, schedule_one.go:613 findNodesThatPassExtenders).

This HTTP+JSON webhook is the reference's own precedent for shipping
scheduling work out of process — the TPU batch backend (ops/backend.py) is
the same seam with tensors instead of JSON.
"""

from __future__ import annotations

import json
import logging
import urllib.request

from ..api import meta
from ..api.meta import Obj
from .types import NodeInfo, PodInfo

logger = logging.getLogger(__name__)

DEFAULT_EXTENDER_TIMEOUT = 5.0


class ExtenderError(Exception):
    pass


class Extender:
    """framework/extender.go:27 Extender interface."""

    def name(self) -> str:
        raise NotImplementedError

    def is_ignorable(self) -> bool:
        return False

    def is_binder(self) -> bool:
        return False

    def is_interested(self, pod: Obj) -> bool:
        raise NotImplementedError

    def filter(self, pod: Obj, nodes: list[NodeInfo]
               ) -> tuple[list[NodeInfo], dict[str, str], dict[str, str]]:
        """Returns (feasible, failed, failed_and_unresolvable)."""
        raise NotImplementedError

    def prioritize(self, pod: Obj, nodes: list[NodeInfo]
                   ) -> tuple[dict[str, int], int]:
        """Returns (host->score, weight)."""
        raise NotImplementedError

    def bind(self, pod: Obj, node_name: str) -> None:
        raise NotImplementedError


class HTTPExtender(Extender):
    """pkg/scheduler/extender.go HTTPExtender."""

    def __init__(self, url_prefix: str, filter_verb: str = "",
                 prioritize_verb: str = "", bind_verb: str = "",
                 weight: int = 1, node_cache_capable: bool = False,
                 managed_resources: list[str] | None = None,
                 ignorable: bool = False,
                 timeout: float = DEFAULT_EXTENDER_TIMEOUT):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.weight = weight
        self.node_cache_capable = node_cache_capable
        self.managed_resources = set(managed_resources or ())
        self.ignorable = ignorable
        self.timeout = timeout

    def name(self) -> str:
        return self.url_prefix

    def is_ignorable(self) -> bool:
        return self.ignorable

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    def is_interested(self, pod: Obj) -> bool:
        """extender.go IsInterested: no managed resources -> always."""
        if not self.managed_resources:
            return True
        spec = pod.get("spec") or {}
        for c in list(spec.get("containers") or ()) + list(
                spec.get("initContainers") or ()):
            res = c.get("resources") or {}
            for section in ("requests", "limits"):
                for rname in (res.get(section) or {}):
                    if rname in self.managed_resources:
                        return True
        return False

    def _post(self, verb: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            from ..apiserver.egress import CLUSTER, default_selector
            with default_selector.open(CLUSTER, req, self.timeout) as resp:
                return json.loads(resp.read().decode())
        except Exception as e:
            raise ExtenderError(f"extender {self.url_prefix}/{verb}: {e}") from e

    def filter(self, pod, nodes):
        if not self.filter_verb:
            return nodes, {}, {}
        args: dict = {"pod": pod}
        if self.node_cache_capable:
            args["nodenames"] = [n.name for n in nodes]
        else:
            args["nodes"] = {"items": [n.node for n in nodes]}
        result = self._post(self.filter_verb, args)
        if result.get("error"):
            raise ExtenderError(result["error"])
        failed = result.get("failedNodes") or {}
        failed_unresolvable = result.get("failedAndUnresolvableNodes") or {}
        if self.node_cache_capable and result.get("nodenames") is not None:
            keep = set(result["nodenames"])
        elif result.get("nodes") is not None:
            keep = {meta.name(n) for n in result["nodes"].get("items") or ()}
        else:
            keep = {n.name for n in nodes} - set(failed) - set(failed_unresolvable)
        return ([n for n in nodes if n.name in keep], dict(failed),
                dict(failed_unresolvable))

    def prioritize(self, pod, nodes):
        if not self.prioritize_verb:
            return {}, 0
        args: dict = {"pod": pod}
        if self.node_cache_capable:
            args["nodenames"] = [n.name for n in nodes]
        else:
            args["nodes"] = {"items": [n.node for n in nodes]}
        result = self._post(self.prioritize_verb, args)
        scores = {e["host"]: int(e["score"])
                  for e in result or () if "host" in e}
        return scores, self.weight

    def bind(self, pod, node_name):
        if not self.bind_verb:
            raise ExtenderError("extender has no bind verb")
        result = self._post(self.bind_verb, {
            "podName": meta.name(pod), "podNamespace": meta.namespace(pod),
            "podUID": meta.uid(pod), "node": node_name})
        if result and result.get("error"):
            raise ExtenderError(result["error"])


def build_extenders(configs: list[dict]) -> list[Extender]:
    """KubeSchedulerConfiguration .extenders -> HTTPExtender list
    (apis/config/types.go Extender struct field names)."""
    out: list[Extender] = []
    for cfg in configs or ():
        out.append(HTTPExtender(
            url_prefix=cfg["urlPrefix"],
            filter_verb=cfg.get("filterVerb", ""),
            prioritize_verb=cfg.get("prioritizeVerb", ""),
            bind_verb=cfg.get("bindVerb", ""),
            weight=cfg.get("weight", 1),
            node_cache_capable=cfg.get("nodeCacheCapable", False),
            managed_resources=[m["name"] for m in
                               cfg.get("managedResources") or ()],
            ignorable=cfg.get("ignorable", False),
            timeout=cfg.get("httpTimeout", DEFAULT_EXTENDER_TIMEOUT)))
    return out
