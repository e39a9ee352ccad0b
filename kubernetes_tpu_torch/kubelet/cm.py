"""Container manager: CPU, memory, device, and topology managers.

Reference: pkg/kubelet/cm/
  cpumanager/policy_static.go   - static policy: Guaranteed pods with
      integer CPU requests get exclusive cores carved from the shared pool;
      state checkpointed (cpumanager/state/state_checkpoint.go)
  memorymanager/policy_static.go - static policy: Guaranteed pods reserve
      memory from per-NUMA banks
  devicemanager/manager.go      - device plugin registry: plugins advertise
      lists of device IDs per resource name; allocations are checkpointed
      (devicemanager/checkpoint/checkpoint.go)
  topologymanager/manager.go    - merges TopologyHints (NUMA affinity
      bitmasks) from the providers under a policy (none/best-effort/
      restricted/single-numa-node); admission fails a pod whose merged hint
      is infeasible under `restricted`/`single-numa-node`

TPU note: the device manager is the seam where TPU chips surface as a
scalar resource (google.com/tpu) with NUMA-aware topology hints, exactly
like the reference's GPU plugins; the schedulable resource flows through
NodeResourcesFit's scalar slots (ops/flatten.py scalar_vocab).

A copy of kubernetes_tpu/kubelet/cm.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

from ..api.quantity import parse_quantity
from .checkpoint import CheckpointManager
from .qos import GUARANTEED, pod_qos

logger = logging.getLogger(__name__)

POLICY_NONE = "none"
POLICY_STATIC = "static"

TOPOLOGY_NONE = "none"
TOPOLOGY_BEST_EFFORT = "best-effort"
TOPOLOGY_RESTRICTED = "restricted"
TOPOLOGY_SINGLE_NUMA = "single-numa-node"


class AdmissionError(Exception):
    """Pod rejected by a resource manager (kubelet admission failure)."""


def _pod_cpu_request_milli(pod: dict) -> int:
    total = 0
    for c in (pod.get("spec") or {}).get("containers") or ():
        req = ((c.get("resources") or {}).get("requests") or {})
        total += int(parse_quantity(req.get("cpu", "0")) * 1000)
    return total


def _pod_memory_request(pod: dict) -> int:
    total = 0
    for c in (pod.get("spec") or {}).get("containers") or ():
        req = ((c.get("resources") or {}).get("requests") or {})
        total += int(parse_quantity(req.get("memory", "0")))
    return total


# --- topology hints (topologymanager/bitmask) ------------------------------

@dataclass(frozen=True)
class TopologyHint:
    """NUMA affinity bitmask + whether it's the provider's preferred one."""

    numa_mask: int     # bit i set = NUMA node i acceptable
    preferred: bool


def merge_hints(provider_hints: list[list[TopologyHint]],
                num_numa: int) -> TopologyHint:
    """topologymanager policy.go mergeProvidersHints: cross-product AND of
    masks, narrowest winning mask preferred."""
    full = (1 << num_numa) - 1
    best: TopologyHint | None = None
    stack = [(full, True, 0)]
    while stack:
        mask, preferred, i = stack.pop()
        if i == len(provider_hints):
            if mask != 0:
                cand = TopologyHint(mask, preferred)
                if best is None or _hint_better(cand, best):
                    best = cand
            continue
        hints = provider_hints[i] or [TopologyHint(full, True)]
        for h in hints:
            stack.append((mask & h.numa_mask, preferred and h.preferred,
                          i + 1))
    return best or TopologyHint(0, False)


def _hint_better(a: TopologyHint, b: TopologyHint) -> bool:
    if a.preferred != b.preferred:
        return a.preferred
    return bin(a.numa_mask).count("1") < bin(b.numa_mask).count("1")


class TopologyManager:
    """topologymanager/manager.go — admit pods by merged NUMA hint."""

    def __init__(self, policy: str = TOPOLOGY_NONE, num_numa: int = 1):
        self.policy = policy
        self.num_numa = num_numa
        self.pod_hints: dict[str, TopologyHint] = {}

    def admit(self, pod_uid: str,
              provider_hints: list[list[TopologyHint]]) -> TopologyHint:
        merged = merge_hints(provider_hints, self.num_numa)
        if self.policy == TOPOLOGY_NONE:
            self.pod_hints[pod_uid] = merged
            return merged
        if merged.numa_mask == 0:
            raise AdmissionError("TopologyAffinityError: no feasible NUMA "
                                 "assignment")
        if self.policy == TOPOLOGY_RESTRICTED and not merged.preferred:
            raise AdmissionError("TopologyAffinityError: merged hint not "
                                 "preferred under restricted policy")
        if (self.policy == TOPOLOGY_SINGLE_NUMA
                and bin(merged.numa_mask).count("1") != 1):
            raise AdmissionError("TopologyAffinityError: spans multiple NUMA "
                                 "nodes under single-numa-node policy")
        self.pod_hints[pod_uid] = merged
        return merged

    def remove(self, pod_uid: str) -> None:
        self.pod_hints.pop(pod_uid, None)


# --- CPU manager -----------------------------------------------------------

class CPUManager:
    """cpumanager static policy over a flat core list (NUMA-striped)."""

    CHECKPOINT = "cpu_manager_state"

    def __init__(self, num_cpus: int = 8, policy: str = POLICY_STATIC,
                 reserved: int = 1, num_numa: int = 1,
                 checkpoints: CheckpointManager | None = None):
        self.policy = policy
        self.num_cpus = num_cpus
        self.num_numa = max(1, num_numa)
        self.reserved = reserved
        self.checkpoints = checkpoints
        self._lock = threading.Lock()
        # pod uid -> sorted list of exclusive cores
        self.assignments: dict[str, list[int]] = {}
        self._restore()

    def _numa_of(self, cpu: int) -> int:
        return cpu * self.num_numa // self.num_cpus

    def shared_pool(self) -> list[int]:
        taken = {c for cores in self.assignments.values() for c in cores}
        return [c for c in range(self.num_cpus)
                if c not in taken and c >= self.reserved]

    def hints(self, pod: dict) -> list[TopologyHint]:
        """Topology hints: one per NUMA node that could host the request."""
        if not self._wants_exclusive(pod):
            return []
        need = _pod_cpu_request_milli(pod) // 1000
        pool = self.shared_pool()
        out = []
        for numa in range(self.num_numa):
            avail = sum(1 for c in pool if self._numa_of(c) == numa)
            if avail >= need:
                out.append(TopologyHint(1 << numa, True))
        if not out and len(pool) >= need:
            out.append(TopologyHint((1 << self.num_numa) - 1, False))
        return out

    def _wants_exclusive(self, pod: dict) -> bool:
        if self.policy != POLICY_STATIC or pod_qos(pod) != GUARANTEED:
            return False
        milli = _pod_cpu_request_milli(pod)
        return milli >= 1000 and milli % 1000 == 0

    def allocate(self, pod: dict, hint: TopologyHint | None = None) -> list[int]:
        """Admission-time allocation (policy_static.go Allocate)."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if uid in self.assignments:
                return self.assignments[uid]
            if not self._wants_exclusive(pod):
                return []
            need = _pod_cpu_request_milli(pod) // 1000
            pool = self.shared_pool()
            if hint is not None and hint.numa_mask:
                preferred = [c for c in pool
                             if (1 << self._numa_of(c)) & hint.numa_mask]
                pool = preferred + [c for c in pool if c not in preferred]
            if len(pool) < need:
                raise AdmissionError(
                    f"not enough exclusive CPUs: want {need}, "
                    f"free {len(pool)}")
            cores = sorted(pool[:need])
            self.assignments[uid] = cores
            self._persist()
            return cores

    def release(self, pod_uid: str) -> None:
        with self._lock:
            if self.assignments.pop(pod_uid, None) is not None:
                self._persist()

    def _persist(self) -> None:
        if self.checkpoints:
            self.checkpoints.create_checkpoint(
                self.CHECKPOINT, {"policy": self.policy,
                                  "assignments": self.assignments})

    def _restore(self) -> None:
        if not self.checkpoints:
            return
        try:
            data = self.checkpoints.get_checkpoint(self.CHECKPOINT)
        except Exception:
            return
        if data.get("policy") == self.policy:
            self.assignments = {k: list(v)
                                for k, v in data.get("assignments", {}).items()}


# --- memory manager --------------------------------------------------------

class MemoryManager:
    """memorymanager static policy over per-NUMA banks."""

    CHECKPOINT = "memory_manager_state"

    def __init__(self, numa_banks: list[int] | None = None,
                 policy: str = POLICY_STATIC,
                 checkpoints: CheckpointManager | None = None):
        self.policy = policy
        self.banks = list(numa_banks or [16 << 30])
        self.checkpoints = checkpoints
        self._lock = threading.Lock()
        # pod uid -> {numa_index: bytes}
        self.assignments: dict[str, dict[int, int]] = {}
        self._restore()

    def free_in(self, numa: int) -> int:
        used = sum(a.get(numa, 0) for a in self.assignments.values())
        return self.banks[numa] - used

    def hints(self, pod: dict) -> list[TopologyHint]:
        if self.policy != POLICY_STATIC or pod_qos(pod) != GUARANTEED:
            return []
        need = _pod_memory_request(pod)
        if need == 0:
            return []
        out = [TopologyHint(1 << i, True)
               for i in range(len(self.banks)) if self.free_in(i) >= need]
        if not out and sum(self.free_in(i)
                           for i in range(len(self.banks))) >= need:
            out.append(TopologyHint((1 << len(self.banks)) - 1, False))
        return out

    def allocate(self, pod: dict, hint: TopologyHint | None = None
                 ) -> dict[int, int]:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if uid in self.assignments:
                return self.assignments[uid]
            if self.policy != POLICY_STATIC or pod_qos(pod) != GUARANTEED:
                return {}
            need = _pod_memory_request(pod)
            if need == 0:
                return {}
            order = range(len(self.banks))
            if hint is not None and hint.numa_mask:
                order = sorted(order,
                               key=lambda i: not ((1 << i) & hint.numa_mask))
            alloc: dict[int, int] = {}
            remaining = need
            for i in order:
                take = min(self.free_in(i), remaining)
                if take > 0:
                    alloc[i] = take
                    remaining -= take
                if remaining == 0:
                    break
            if remaining > 0:
                raise AdmissionError(
                    f"not enough memory: want {need}, short {remaining}")
            self.assignments[uid] = alloc
            self._persist()
            return alloc

    def release(self, pod_uid: str) -> None:
        with self._lock:
            if self.assignments.pop(pod_uid, None) is not None:
                self._persist()

    def _persist(self) -> None:
        if self.checkpoints:
            self.checkpoints.create_checkpoint(
                self.CHECKPOINT,
                {"assignments": {u: {str(k): v for k, v in a.items()}
                                 for u, a in self.assignments.items()}})

    def _restore(self) -> None:
        if not self.checkpoints:
            return
        try:
            data = self.checkpoints.get_checkpoint(self.CHECKPOINT)
        except Exception:
            return
        self.assignments = {
            u: {int(k): v for k, v in a.items()}
            for u, a in data.get("assignments", {}).items()}


# --- device manager --------------------------------------------------------

@dataclass
class DevicePlugin:
    """An in-process device plugin (devicemanager plugin registration).
    devices maps device-id -> NUMA node index."""

    resource_name: str
    devices: dict[str, int] = field(default_factory=dict)


class DeviceManager:
    """devicemanager/manager.go — registry + checkpointed allocations."""

    CHECKPOINT = "device_manager_state"

    def __init__(self, checkpoints: CheckpointManager | None = None):
        self.checkpoints = checkpoints
        self._lock = threading.Lock()
        self.plugins: dict[str, DevicePlugin] = {}
        # pod uid -> {resource: [device ids]}
        self.allocations: dict[str, dict[str, list[str]]] = {}
        self._restore()

    def register(self, plugin: DevicePlugin) -> None:
        with self._lock:
            self.plugins[plugin.resource_name] = plugin

    def allocatable(self) -> dict[str, int]:
        """resource -> device count (feeds node.status.allocatable)."""
        with self._lock:
            return {name: len(p.devices) for name, p in self.plugins.items()}

    def _requested(self, pod: dict) -> dict[str, int]:
        want: dict[str, int] = {}
        for c in (pod.get("spec") or {}).get("containers") or ():
            for name, q in ((c.get("resources") or {}).get("requests")
                            or {}).items():
                if name in self.plugins:
                    want[name] = want.get(name, 0) + int(parse_quantity(q))
        return want

    def _free(self, resource: str) -> list[str]:
        taken = {d for alloc in self.allocations.values()
                 for d in alloc.get(resource, ())}
        return [d for d in self.plugins[resource].devices if d not in taken]

    def hints(self, pod: dict) -> list[TopologyHint]:
        want = self._requested(pod)
        if not want:
            return []
        numa_sets: list[set[int]] = []
        for resource, n in want.items():
            free = self._free(resource)
            if len(free) < n:
                return [TopologyHint(0, False)]  # infeasible
            by_numa: dict[int, int] = {}
            for d in free:
                numa = self.plugins[resource].devices[d]
                by_numa[numa] = by_numa.get(numa, 0) + 1
            numa_sets.append({numa for numa, cnt in by_numa.items()
                              if cnt >= n})
        common = set.intersection(*numa_sets) if numa_sets else set()
        hints = [TopologyHint(1 << numa, True) for numa in sorted(common)]
        all_numa = {n for r in want for n in
                    self.plugins[r].devices.values()}
        if not hints and all_numa:
            mask = 0
            for n in all_numa:
                mask |= 1 << n
            hints.append(TopologyHint(mask, False))
        return hints

    def allocate(self, pod: dict, hint: TopologyHint | None = None
                 ) -> dict[str, list[str]]:
        uid = (pod.get("metadata") or {}).get("uid", "")
        with self._lock:
            if uid in self.allocations:
                return self.allocations[uid]
            want = self._requested(pod)
            if not want:
                return {}
            alloc: dict[str, list[str]] = {}
            for resource, n in want.items():
                free = self._free(resource)
                if hint is not None and hint.numa_mask:
                    devs = self.plugins[resource].devices
                    free.sort(key=lambda d: not ((1 << devs[d])
                                                 & hint.numa_mask))
                if len(free) < n:
                    raise AdmissionError(
                        f"insufficient {resource}: want {n}, free {len(free)}")
                alloc[resource] = free[:n]
            self.allocations[uid] = alloc
            self._persist()
            return alloc

    def release(self, pod_uid: str) -> None:
        with self._lock:
            if self.allocations.pop(pod_uid, None) is not None:
                self._persist()

    def _persist(self) -> None:
        if self.checkpoints:
            self.checkpoints.create_checkpoint(self.CHECKPOINT,
                                               {"allocations": self.allocations})

    def _restore(self) -> None:
        if not self.checkpoints:
            return
        try:
            data = self.checkpoints.get_checkpoint(self.CHECKPOINT)
        except Exception:
            return
        self.allocations = {u: {r: list(ds) for r, ds in a.items()}
                            for u, a in data.get("allocations", {}).items()}


# --- the container manager facade -----------------------------------------

class ContainerManager:
    """cm/container_manager_linux.go — owns the resource managers and runs
    the kubelet's resource-admission step (AdmitPod)."""

    def __init__(self, num_cpus: int = 8, memory_bytes: int = 16 << 30,
                 num_numa: int = 1, topology_policy: str = TOPOLOGY_NONE,
                 cpu_policy: str = POLICY_STATIC,
                 checkpoint_dir: str | None = None):
        ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
        self.topology = TopologyManager(topology_policy, num_numa)
        self.cpu = CPUManager(num_cpus, cpu_policy, num_numa=num_numa,
                              checkpoints=ckpt)
        per_bank = memory_bytes // max(1, num_numa)
        self.memory = MemoryManager([per_bank] * max(1, num_numa),
                                    checkpoints=ckpt)
        self.devices = DeviceManager(checkpoints=ckpt)

    def admit_pod(self, pod: dict) -> None:
        """Admission: merge hints, then allocate under the merged hint.
        Raises AdmissionError (kubelet rejects the pod) on failure; partial
        allocations are rolled back."""
        uid = (pod.get("metadata") or {}).get("uid", "")
        hints = [self.cpu.hints(pod), self.memory.hints(pod),
                 self.devices.hints(pod)]
        merged = self.topology.admit(uid, hints)
        done = []
        try:
            for mgr in (self.cpu, self.memory, self.devices):
                mgr.allocate(pod, merged)
                done.append(mgr)
        except AdmissionError:
            for mgr in done:
                mgr.release(uid)
            self.topology.remove(uid)
            raise

    def release_pod(self, pod_uid: str) -> None:
        for mgr in (self.cpu, self.memory, self.devices):
            mgr.release(pod_uid)
        self.topology.remove(pod_uid)

    def reconcile(self, live_pod_uids: set[str]) -> None:
        """Release checkpoint-restored allocations whose pod no longer
        exists (cpumanager removeStaleState / devicemanager
        UpdateAllocatedDevices semantics on kubelet restart)."""
        known = (set(self.cpu.assignments) | set(self.memory.assignments)
                 | set(self.devices.allocations))
        for uid in known - live_pod_uids:
            logger.info("cm: releasing stale allocation for vanished pod %s",
                        uid)
            self.release_pod(uid)
