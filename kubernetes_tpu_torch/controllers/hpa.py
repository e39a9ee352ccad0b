"""Horizontal Pod Autoscaler controller (autoscaling/v2 semantics).

Reference: pkg/controller/podautoscaler/horizontal.go —
  computeReplicasForMetrics: desired per metric spec =
  ceil(current * currentMetricValue / targetMetricValue); the FINAL
  recommendation is the MAX across metrics;
  tolerance (default 0.1): a ratio within [0.9, 1.1] does not scale;
  stabilization (stabilizeRecommendationWithBehaviors): scale-down acts
  on the max recommendation over its window (default 300s), scale-up on
  the min over its window (default 0 — instant);
  behavior policies (normalizeDesiredReplicasWithBehaviors): scaleUp /
  scaleDown each carry [{type: Pods|Percent, value, periodSeconds}]
  limits computed against the scale-event history, combined by
  selectPolicy Max|Min|Disabled.

There is no metrics-server in this stack; pod usage comes from a
pluggable metrics getter.  The default reads pod annotations — the same
seam upstream fills with the resource-metrics / custom-metrics APIs:
  metrics.kubernetes.io/cpu-usage        milliCPU (Resource cpu)
  metrics.kubernetes.io/memory-usage     bytes    (Resource memory)
  metrics.kubernetes.io/custom/<name>    float    (Pods custom metric)

The autoscaling/v1 shape (spec.targetCPUUtilizationPercentage) is
accepted and treated as a single Resource-cpu Utilization metric, the
same conversion the reference applies.

A copy of kubernetes_tpu/controllers/hpa.py: the same classes,
names and logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time

from ..api import meta, quantity
from ..api.meta import Obj
from ..client.clientset import HPAS, PODS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv

logger = logging.getLogger(__name__)

USAGE_ANNOTATION = "metrics.kubernetes.io/cpu-usage"
MEMORY_ANNOTATION = "metrics.kubernetes.io/memory-usage"
CUSTOM_PREFIX = "metrics.kubernetes.io/custom/"

TOLERANCE = 0.1  # horizontal.go defaultTestingTolerance / --horizontal-pod-autoscaler-tolerance

SCALE_TARGETS = {"Deployment": "deployments", "ReplicaSet": "replicasets",
                 "StatefulSet": "statefulsets"}


def default_metrics_getter(pod: Obj, metric: str = "cpu") -> float | None:
    """-> metric sample for one pod, or None.

    metric: "cpu" (milliCPU), "memory" (bytes), or a custom metric name.
    """
    ann = pod["metadata"].get("annotations") or {}
    try:
        if metric == "cpu":
            raw = ann.get(USAGE_ANNOTATION)
            return None if raw is None else float(
                quantity.parse_cpu_milli(raw))
        if metric == "memory":
            raw = ann.get(MEMORY_ANNOTATION)
            return None if raw is None else float(
                quantity.parse_mem_bytes(raw))
        raw = ann.get(CUSTOM_PREFIX + metric)
        return None if raw is None else float(quantity.parse_quantity(raw))
    except (ValueError, TypeError):
        return None


class HorizontalPodAutoscaler:
    name = "horizontalpodautoscaler"

    def __init__(self, client: Client, factory: SharedInformerFactory,
                 tick: float = 15.0, metrics_getter=default_metrics_getter,
                 downscale_stabilization: float = 300.0):
        self.client = client
        self.hpa_informer = factory.informer(HPAS)
        self.pod_informer = factory.informer(PODS)
        self.tick = tick
        self.metrics_getter = metrics_getter
        self.downscale_stabilization = downscale_stabilization
        self._recommendations: dict[str, list[tuple[float, int]]] = {}
        # scale-event history per HPA: [(time, replica_delta)] — behavior
        # policy rate limits are computed against it (horizontal.go
        # scaleUpEvents/scaleDownEvents)
        self._scale_events: dict[str, list[tuple[float, int]]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _get_metric(self, pod: Obj, metric: str) -> float | None:
        try:
            return self.metrics_getter(pod, metric)
        except TypeError:
            # 1-arg getter (pre-v2 seam): serves cpu only
            return self.metrics_getter(pod) if metric == "cpu" else None

    def run(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=self.name)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.tick):
            try:
                self.reconcile_once(time.time())
            except Exception:  # noqa: BLE001
                logger.exception("hpa reconcile failed")

    def reconcile_once(self, now: float) -> None:
        live = set()
        for hpa in self.hpa_informer.list(None):
            live.add(meta.namespaced_name(hpa))
            try:
                self._sync_one(hpa, now)
            except Exception as e:  # noqa: BLE001 — one bad HPA must not
                logger.warning("hpa %s: %s", meta.namespaced_name(hpa), e)
        # drop stabilization windows of deleted HPAs
        for key in list(self._recommendations):
            if key not in live:
                del self._recommendations[key]

    @staticmethod
    def _metric_specs(spec: dict) -> list[dict]:
        """spec.metrics (v2), or the v1 targetCPUUtilizationPercentage
        converted to a Resource-cpu Utilization metric."""
        if spec.get("metrics"):
            return spec["metrics"]
        pct = spec.get("targetCPUUtilizationPercentage", 80)
        return [{"type": "Resource",
                 "resource": {"name": "cpu",
                              "target": {"type": "Utilization",
                                         "averageUtilization": pct}}}]

    def _pod_request(self, pod: Obj, resource_name: str) -> float:
        parse = (quantity.parse_cpu_milli if resource_name == "cpu"
                 else quantity.parse_mem_bytes)
        return float(sum(parse(
            ((c.get("resources") or {}).get("requests") or {})
            .get(resource_name, "0"))
            for c in (pod.get("spec") or {}).get("containers", [])))

    def _desired_for_metric(self, m: dict, pods: list[Obj], current: int
                            ) -> tuple[int, dict] | None:
        """One metric spec -> (desired replicas, status entry), or None
        when there are no samples (hold — upstream no-scale on missing
        metrics) or the spec is invalid."""
        if m.get("type") == "Resource":
            res = m.get("resource") or {}
            name = res.get("name", "cpu")
            target = res.get("target") or {}
            samples = [(self._get_metric(p, name),
                        self._pod_request(p, name)) for p in pods]
            samples = [(u, r) for u, r in samples if u is not None]
            if not samples:
                return None
            if target.get("type") == "AverageValue" or \
                    "averageValue" in target:
                # same units as the metrics getter: milliCPU / bytes
                parse = (quantity.parse_cpu_milli if name == "cpu"
                         else quantity.parse_mem_bytes)
                want = float(parse(str(target.get("averageValue", 0))))
                if want <= 0:
                    return None
                avg = sum(u for u, _ in samples) / len(samples)
                ratio = avg / want
                cur_val = avg
                status = {"type": "Resource", "resource": {
                    "name": name, "current": {"averageValue": avg}}}
            else:
                pct = target.get("averageUtilization", 80)
                if not isinstance(pct, (int, float)) or pct <= 0:
                    return None
                utils = [100.0 * u / r for u, r in samples if r > 0]
                if not utils:
                    return None
                avg = sum(utils) / len(utils)
                ratio = avg / pct
                cur_val = avg
                status = {"type": "Resource", "resource": {
                    "name": name,
                    "current": {"averageUtilization": int(avg)}}}
        elif m.get("type") == "Pods":
            pm = m.get("pods") or {}
            name = (pm.get("metric") or {}).get("name", "")
            want = float(quantity.parse_quantity(
                str((pm.get("target") or {}).get("averageValue", 0))))
            if not name or want <= 0:
                return None
            samples = [self._get_metric(p, name) for p in pods]
            samples = [s for s in samples if s is not None]
            if not samples:
                return None
            avg = sum(samples) / len(samples)
            ratio = avg / want
            cur_val = avg
            status = {"type": "Pods", "pods": {
                "metric": {"name": name},
                "current": {"averageValue": avg}}}
        else:
            return None
        # tolerance: don't scale on noise (horizontal.go:806)
        if abs(ratio - 1.0) <= TOLERANCE:
            desired = current
        else:
            import math
            desired = max(1, math.ceil(current * ratio - 1e-9))
        return desired, status

    # -- behavior (normalizeDesiredReplicasWithBehaviors) ----------------

    @staticmethod
    def _policy_limit(policies: list[dict], events: list[tuple[float, int]],
                      current: int, now: float, up: bool,
                      select: str) -> int | None:
        """Replica bound allowed by the scaling policies, None = no limit
        (or Disabled -> current, i.e. no change in that direction).
        Only events in THIS direction consume policy budget (upstream
        keeps separate scaleUpEvents/scaleDownEvents for the same
        reason — an opposite-direction event must not inflate room)."""
        if select == "Disabled":
            return current
        if not policies:
            return None
        bounds = []
        for pol in policies:
            period = pol.get("periodSeconds", 60)
            changed = sum((d if up else -d) for t, d in events
                          if now - t <= period
                          and (d > 0) == up)
            if pol.get("type") == "Percent":
                allowed = int(current * pol.get("value", 100) / 100.0) or 1
            else:  # Pods
                allowed = pol.get("value", 4)
            room = max(0, allowed - changed)
            bounds.append(current + room if up else current - room)
        pick = max if (up == (select != "Min")) else min
        return pick(bounds)

    def _sync_one(self, hpa: Obj, now: float) -> None:
        spec = hpa.get("spec") or {}
        ref = spec.get("scaleTargetRef") or {}
        resource = SCALE_TARGETS.get(ref.get("kind"))
        if resource is None:
            return
        ns, hpa_name = meta.namespace(hpa), meta.name(hpa)
        target = self.client.get(resource, ns, ref.get("name", ""))
        current = int((target.get("spec") or {}).get("replicas", 1))
        sel = ((target.get("spec") or {}).get("selector") or {}) \
            .get("matchLabels", {})
        pods = [p for p in self.pod_informer.list(ns)
                if sel and all(meta.labels(p).get(k) == v
                               for k, v in sel.items())
                and (p.get("status") or {}).get("phase")
                not in ("Succeeded", "Failed")]
        # multi-metric: MAX of per-metric desires (computeReplicasForMetrics)
        proposals, current_metrics = [], []
        for m in self._metric_specs(spec):
            got = self._desired_for_metric(m, pods, current)
            if got is not None:
                proposals.append(got[0])
                current_metrics.append(got[1])
        if not proposals:
            return  # no metric produced a sample: hold
        desired = max(proposals)
        lo = spec.get("minReplicas", 1)
        hi = spec.get("maxReplicas", max(lo, desired))
        desired = max(lo, min(hi, desired))
        key = f"{ns}/{hpa_name}"

        behavior = spec.get("behavior") or {}
        up_b = behavior.get("scaleUp") or {}
        down_b = behavior.get("scaleDown") or {}
        # stabilization: down acts on the window max, up on the window min
        recs = self._recommendations.setdefault(key, [])
        recs.append((now, desired))
        max_window = max(
            float(down_b.get("stabilizationWindowSeconds",
                             self.downscale_stabilization)),
            float(up_b.get("stabilizationWindowSeconds", 0.0)))
        recs[:] = [(t, d) for t, d in recs if now - t <= max_window]
        if desired < current:
            win = float(down_b.get("stabilizationWindowSeconds",
                                   self.downscale_stabilization))
            desired = max(d for t, d in recs if now - t <= win)
        elif desired > current:
            win = float(up_b.get("stabilizationWindowSeconds", 0.0))
            desired = min(d for t, d in recs if now - t <= win)
        # behavior policies rate-limit the change
        events = self._scale_events.setdefault(key, [])
        events[:] = [(t, d) for t, d in events if now - t <= 3600.0]
        if desired > current:
            limit = self._policy_limit(
                up_b.get("policies") or [], events, current, now, up=True,
                select=up_b.get("selectPolicy", "Max"))
            if limit is not None:
                desired = min(desired, max(limit, current))
        elif desired < current:
            limit = self._policy_limit(
                down_b.get("policies") or [], events, current, now,
                up=False, select=down_b.get("selectPolicy", "Max"))
            if limit is not None:
                desired = max(desired, min(limit, current))
        desired = max(lo, min(hi, desired))

        if desired != current:
            def patch(o):
                o.setdefault("spec", {})["replicas"] = desired
                return o
            self.client.guaranteed_update(resource, ns, ref["name"], patch)
            events.append((now, desired - current))
        status = {"currentReplicas": current, "desiredReplicas": desired,
                  "currentMetrics": current_metrics,
                  "lastScaleTime": now if desired != current
                  else (hpa.get("status") or {}).get("lastScaleTime")}
        # v1 status compatibility: surface cpu utilization when present
        for cm in current_metrics:
            cur = (cm.get("resource") or {})
            if cur.get("name") == "cpu" and "averageUtilization" in \
                    (cur.get("current") or {}):
                status["currentCPUUtilizationPercentage"] = \
                    cur["current"]["averageUtilization"]
        def spatch(o):
            o["status"] = status
            return o
        try:
            self.client.guaranteed_update(HPAS, ns, hpa_name, spatch)
        except kv.NotFoundError:
            pass
