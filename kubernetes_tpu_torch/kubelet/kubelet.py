"""Full kubelet: syncLoop + pod workers + managers over the fake CRI.

Reference: pkg/kubelet/kubelet.go — Run (:1432) starts the managers and
syncLoop (:2019); syncLoopIteration (:2093) dispatches pod updates to per-
pod workers; kuberuntime SyncPod computes sandbox/container actions.  This
class composes the subsystem managers built alongside:

  pod_workers      per-pod serialized update pipelines (pod_workers.go)
  probes           liveness/readiness workers (pkg/kubelet/prober)
  status_manager   deduped status writer (pkg/kubelet/status)
  eviction         memory-pressure eviction (pkg/kubelet/eviction)
  images           image GC by disk thresholds (pkg/kubelet/images)
  checkpoint       atomic checksummed state files (checkpointmanager)
  qos              QoS classes driving eviction order

plus restart-policy enforcement with CrashLoopBackOff-style exponential
backoff (kuberuntime's computePodActions + backoff tracking).

HollowKubelet (hollow.py) stays the high-density kubemark node; Kubelet is
the full node agent.  Both speak the same CRI seam.

A copy of kubernetes_tpu/kubelet/kubelet.py: the same classes, names and
logic, over this package's api/, client/ and store/.
ROADMAP R14(d): restore_state reloads sandbox and container ids into a
fresh, empty FakeRuntimeService, so a restarted kubelet reports its
restored pods Running with Ready=False and no containerStatuses.
"""

from __future__ import annotations

import logging
import tempfile
import threading
import time

from ..api import meta
from ..api.meta import Obj
from ..api.quantity import parse_mem_bytes
from ..client.clientset import PODS, Client
from ..client.informer import SharedInformerFactory
from ..store import kv
from .cri import EXITED, RUNNING, FakeRuntimeService
from .eviction import EvictionManager
from .hollow import HollowKubelet
from .images import ImageGCManager
from .checkpoint import CheckpointManager
from .pod_workers import PodWorkers
from .probes import ProbeManager
from .qos import pod_qos
from .status_manager import StatusManager

logger = logging.getLogger(__name__)

CRASH_BACKOFF_INITIAL = 0.25
CRASH_BACKOFF_MAX = 10.0  # upstream: 10s..5m; compressed for tests


class Kubelet(HollowKubelet):
    def __init__(self, client: Client, factory: SharedInformerFactory,
                 node_name: str, root_dir: str | None = None, **kwargs):
        super().__init__(client, factory, node_name, **kwargs)
        root = root_dir or tempfile.mkdtemp(prefix=f"kubelet-{node_name}-")
        self.checkpoints = CheckpointManager(root)
        self.status_manager = StatusManager(client)
        self.workers = PodWorkers(self._sync_worker)
        self.probes = ProbeManager(
            container_running=self._container_running,
            on_liveness_failure=self._restart_container,
            on_readiness_change=lambda pod, c, ok: self._report_status(pod))
        self.images = ImageGCManager(self.runtime)
        self.eviction = EvictionManager(
            client, node_name,
            memory_capacity=parse_mem_bytes(self.memory),
            list_pods=self._my_pods)
        # container crash backoff: (uid, container) -> (delay, not_before)
        self._backoff: dict[tuple, tuple] = {}

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "Kubelet":
        super().start()
        t = threading.Thread(target=self._housekeeping_loop, daemon=True,
                             name=f"kubelet-{self.node_name}-housekeeping")
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        super().stop()
        self.probes.stop()
        self.workers.stop()

    # -- syncLoopIteration -> pod workers --------------------------------

    def _on_pod_event(self, type_: str, pod: Obj, old: Obj | None) -> None:
        mine = meta.pod_node_name(pod) == self.node_name
        was_mine = old is not None and meta.pod_node_name(old) == self.node_name
        if not mine and not was_mine:
            return
        if type_ == kv.DELETED or not mine:
            self.workers.update_pod("KILL", pod)
        else:
            self.workers.update_pod("SYNC", pod)

    def _sync_worker(self, update_type: str, pod: Obj) -> None:
        if update_type == "KILL":
            self.probes.remove_pod(pod)
            self._kill_pod(pod)
            self.status_manager.remove_pod(meta.uid(pod))
            self.workers.forget_pod(meta.uid(pod))
            return
        if meta.deletion_timestamp(pod) is not None:
            # graceful termination: honor terminationGracePeriodSeconds=0
            # shape by killing immediately (store deletes are final here)
            self.workers.update_pod("KILL", pod)
            return
        if not meta.pod_is_terminal(pod):
            self._sync_pod(pod)
            self._restart_exited_containers(pod)
            self.probes.add_pod(pod)
            for c in (pod.get("spec") or {}).get("containers") or ():
                self.images.image_used(c.get("image", ""))

    # -- restart policy + crash backoff ----------------------------------

    def _restart_exited_containers(self, pod: Obj) -> None:
        """computePodActions: exited containers restart per restartPolicy
        (Always; OnFailure only when exitCode != 0) behind a per-container
        exponential backoff (CrashLoopBackOff)."""
        policy = (pod.get("spec") or {}).get("restartPolicy", "Always")
        if policy == "Never":
            return
        uid = meta.uid(pod)
        with self._lock:
            st = self._pod_state.get(uid)
        if st is None:
            return
        now = time.monotonic()
        for c in self.runtime.list_containers(st["sandbox"]):
            if c["state"] != EXITED:
                continue
            if policy == "OnFailure" and c.get("exitCode") in (0, None):
                continue
            key = (uid, c["name"])
            delay, not_before = self._backoff.get(key,
                                                  (CRASH_BACKOFF_INITIAL, 0.0))
            if now < not_before:
                continue  # CrashLoopBackOff: wait it out
            self._backoff[key] = (min(delay * 2, CRASH_BACKOFF_MAX),
                                  now + delay)
            self.runtime.remove_container(c["id"])
            spec_c = next((x for x in (pod.get("spec") or {})
                           .get("containers", [])
                           if x["name"] == c["name"]), None)
            if spec_c is None:
                continue
            cid = self.runtime.create_container(st["sandbox"], {
                "name": spec_c["name"], "image": spec_c.get("image", ""),
                "annotations": meta.annotations(pod)})
            self.runtime.start_container(cid)
            with self._lock:
                st["containers"][c["name"]] = cid
            logger.info("restarted container %s/%s (backoff %.2fs)",
                        meta.name(pod), c["name"], delay)

    def _restart_container(self, pod: Obj, container_name: str) -> None:
        """Liveness failure: kill the container; restart policy picks it
        back up on the next sync."""
        uid = meta.uid(pod)
        with self._lock:
            st = self._pod_state.get(uid)
            cid = st["containers"].get(container_name) if st else None
        if cid:
            self.runtime.stop_container(cid)
            self.workers.update_pod("SYNC", pod)

    def _container_running(self, pod: Obj, container_name: str) -> bool:
        uid = meta.uid(pod)
        with self._lock:
            st = self._pod_state.get(uid)
            cid = st["containers"].get(container_name) if st else None
        if cid is None:
            return False
        return any(c["id"] == cid and c["state"] == RUNNING
                   for c in self.runtime.list_containers())

    # -- status: route through the status manager + probe readiness ------

    def _report_status(self, pod: Obj) -> None:
        uid = meta.uid(pod)
        with self._lock:
            st = self._pod_state.get(uid)
        if st is None:
            return
        containers = self.runtime.list_containers(st["sandbox"])
        running = [c for c in containers if c["state"] == RUNNING]
        exited = [c for c in containers if c["state"] == EXITED]
        if containers and not running and exited:
            failed = any(c.get("exitCode") not in (0, None) for c in exited)
            phase = "Failed" if failed else "Succeeded"
            ready = False
        else:
            phase = "Running"
            ready = bool(running) and self.probes.pod_ready(pod)
        status = {
            "phase": phase,
            "qosClass": pod_qos(pod),
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Ready", "status": "True" if ready else "False"},
            ],
            "containerStatuses": [
                {"name": c["name"], "state": c["state"],
                 "exitCode": c.get("exitCode"),
                 "restartCount": 0} for c in containers],
            "hostIP": f"10.0.0.{abs(hash(self.node_name)) % 250 + 1}",
            "podIP": f"10.{abs(hash(uid)) % 250}.{abs(hash(uid) >> 8) % 250}."
                     f"{abs(hash(uid) >> 16) % 250 + 1}",
        }
        self.status_manager.set_pod_status(pod, status)

    # -- housekeeping: eviction + image GC + checkpoints ------------------

    def _my_pods(self) -> list[Obj]:
        return [p for p in self.pod_informer.list()
                if meta.pod_node_name(p) == self.node_name]

    def _housekeeping_loop(self) -> None:
        while not self._stop.wait(2.0):
            try:
                self.eviction.synchronize()
                in_use = {c.get("image", "")
                          for p in self._my_pods()
                          for c in (p.get("spec") or {}).get("containers", ())}
                self.images.garbage_collect(in_use)
                self._checkpoint_state()
            except Exception:  # noqa: BLE001
                logger.exception("kubelet housekeeping failed")

    def _checkpoint_state(self) -> None:
        """Persist pod->container allocation (the device/cpu-manager state
        analogue) so a restarted kubelet can reconcile without re-creating
        sandboxes for pods it already runs."""
        with self._lock:
            state = {uid: {"sandbox": st["sandbox"],
                           "containers": dict(st["containers"])}
                     for uid, st in self._pod_state.items()}
        self.checkpoints.create_checkpoint("pod_state", state)

    def restore_state(self) -> bool:
        """Crash-only restart: reload the allocation checkpoint."""
        try:
            state = self.checkpoints.get_checkpoint("pod_state")
        except KeyError:
            return False
        with self._lock:
            self._pod_state.update(state)
        return True
