"""Probe manager: liveness + readiness workers.

Reference: pkg/kubelet/prober — one worker per (pod, container, probe
type); respects initialDelaySeconds / periodSeconds / failureThreshold /
successThreshold; readiness results flip the pod Ready condition, liveness
failures trigger a container restart through the kubelet callback.

The probe *handler* is pluggable (upstream: exec/httpGet/tcpSocket
runners).  The default handler understands the hollow runtime: a container
annotation ``hollow/fail-liveness`` / ``hollow/fail-readiness`` forces
failure; otherwise a RUNNING container passes.

A copy of kubernetes_tpu/kubelet/probes.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

LIVENESS = "liveness"
READINESS = "readiness"


def default_handler(pod: dict, container: dict, probe_type: str,
                    container_running: bool) -> bool:
    ann = (pod.get("metadata") or {}).get("annotations") or {}
    if probe_type == LIVENESS and ann.get("hollow/fail-liveness") == "true":
        return False
    if probe_type == READINESS and ann.get("hollow/fail-readiness") == "true":
        return False
    return container_running


class _Worker:
    def __init__(self, mgr: "ProbeManager", pod: dict, container: dict,
                 probe_type: str, spec: dict):
        self.mgr = mgr
        self.pod = pod
        self.container = container
        self.probe_type = probe_type
        self.initial_delay = float(spec.get("initialDelaySeconds", 0))
        self.period = max(0.05, float(spec.get("periodSeconds", 10)))
        self.failure_threshold = int(spec.get("failureThreshold", 3))
        self.success_threshold = int(spec.get("successThreshold", 1))
        self._failures = 0
        self._successes = 0
        self.result: Optional[bool] = None  # None until first sample
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        if self._stop.wait(self.initial_delay):
            return
        while not self._stop.is_set():
            self._probe_once()
            if self._stop.wait(self.period):
                return

    def _probe_once(self) -> None:
        ok = self.mgr._run_handler(self.pod, self.container, self.probe_type)
        if ok:
            self._successes += 1
            self._failures = 0
            if self._successes >= self.success_threshold:
                self._set_result(True)
        else:
            self._failures += 1
            self._successes = 0
            if self._failures >= self.failure_threshold:
                self._set_result(False)

    def _set_result(self, ok: bool) -> None:
        if self.result == ok:
            return
        self.result = ok
        self.mgr._on_result(self.pod, self.container, self.probe_type, ok)


class ProbeManager:
    def __init__(self, handler: Callable = default_handler,
                 container_running: Optional[Callable] = None,
                 on_liveness_failure: Optional[Callable] = None,
                 on_readiness_change: Optional[Callable] = None):
        self.handler = handler
        # container_running(pod, container_name) -> bool; injected by kubelet
        self.container_running = container_running or (lambda p, c: True)
        self.on_liveness_failure = on_liveness_failure or (lambda p, c: None)
        self.on_readiness_change = on_readiness_change or (
            lambda p, c, ok: None)
        self._lock = threading.Lock()
        self._workers: Dict[Tuple[str, str, str], _Worker] = {}
        # (pod_uid, container) -> readiness (True until a probe says no,
        # mirroring upstream: containers without readiness probes are ready)
        self.readiness: Dict[Tuple[str, str], bool] = {}

    def add_pod(self, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        for c in (pod.get("spec") or {}).get("containers") or ():
            for probe_type, field in ((LIVENESS, "livenessProbe"),
                                      (READINESS, "readinessProbe")):
                spec = c.get(field)
                if not spec:
                    continue
                key = (uid, c["name"], probe_type)
                with self._lock:
                    if key in self._workers:
                        continue
                    w = _Worker(self, pod, c, probe_type, spec)
                    self._workers[key] = w
                if probe_type == READINESS:
                    # not ready until the probe succeeds (upstream default)
                    self.readiness[(uid, c["name"])] = False
                w.start()

    def remove_pod(self, pod: dict) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            for key in [k for k in self._workers if k[0] == uid]:
                self._workers.pop(key).stop()
        for key in [k for k in self.readiness if k[0] == uid]:
            del self.readiness[key]

    def stop(self) -> None:
        with self._lock:
            for w in self._workers.values():
                w.stop()
            self._workers.clear()

    def pod_ready(self, pod: dict) -> bool:
        """All containers with readiness probes report ready."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        return all(ok for (u, _), ok in self.readiness.items() if u == uid)

    # -- worker callbacks -------------------------------------------------

    def _run_handler(self, pod, container, probe_type) -> bool:
        running = self.container_running(pod, container["name"])
        try:
            return self.handler(pod, container, probe_type, running)
        except Exception:  # noqa: BLE001 — probe errors count as failures
            logger.exception("probe handler failed")
            return False

    def _on_result(self, pod, container, probe_type, ok: bool) -> None:
        uid = (pod.get("metadata") or {}).get("uid", "")
        if probe_type == READINESS:
            self.readiness[(uid, container["name"])] = ok
            self.on_readiness_change(pod, container["name"], ok)
        elif not ok:
            logger.info("liveness probe failed for %s/%s; restarting",
                        uid, container["name"])
            self.on_liveness_failure(pod, container["name"])
