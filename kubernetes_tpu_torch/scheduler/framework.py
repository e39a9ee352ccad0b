"""Scheduling framework: plugin contracts + runtime.

Reference: pkg/scheduler/framework/interface.go (the 11 extension points:
QueueSort, PreFilter(+AddPod/RemovePod), Filter, PostFilter, PreScore,
Score(+NormalizeScore), Reserve/Unreserve, Permit, PreBind, Bind, PostBind),
framework/runtime/framework.go (execution + per-point ordering),
framework/cycle_state.go, framework/runtime/waiting_pods_map.go (Permit),
framework/runtime/registry.go.

TPU-native addition: BatchExtensions — a plugin may implement
batch_filter_scores(ctx) producing (mask[P,N], scores[P,N]) for a whole batch
of pods at once; the batch scheduler (scheduler.py) uses it in place of
per-pod Filter/Score when every enabled plugin supports it.  Per-pod
semantics remain the fallback and the oracle.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Iterable, Sequence

from ..api import meta
from ..api.meta import Obj
from .cache import Snapshot
from .types import (
    ERROR, SKIP, SUCCESS, UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE, WAIT,
    _CODE_NAMES, ClusterEvent, Diagnosis, NodeInfo, PodInfo, Status, is_success,
)

MAX_NODE_SCORE = 100  # framework/interface.go MaxNodeScore
MIN_NODE_SCORE = 0

def _status_label(out: Any) -> str:
    """Map a runner's return value to a status label for metrics."""
    status = out
    if isinstance(out, tuple):
        status = next((x for x in reversed(out) if isinstance(x, Status)), None)
    if status is None:
        return "Success"
    if isinstance(status, Status):
        return _CODE_NAMES.get(status.code, str(status.code))
    return "Success"


class CycleState:
    """Per-scheduling-cycle typed KV store (framework/cycle_state.go)."""

    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        self.skip_filter_plugins: set[str] = set()
        self.skip_score_plugins: set[str] = set()

    def read(self, key: str) -> Any:
        return self._data.get(key)

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def delete(self, key: str) -> None:
        self._data.pop(key, None)

    def clone(self) -> "CycleState":
        c = CycleState()
        c._data = dict(self._data)
        c.skip_filter_plugins = set(self.skip_filter_plugins)
        c.skip_score_plugins = set(self.skip_score_plugins)
        return c


class PreFilterResult:
    """interface.go:633 — a PreFilter may pin the feasible set of nodes."""

    __slots__ = ("node_names",)

    def __init__(self, node_names: set[str] | None):
        self.node_names = node_names  # None = all nodes

    def all_nodes(self) -> bool:
        return self.node_names is None

    def merge(self, other: "PreFilterResult | None") -> "PreFilterResult":
        if other is None or other.all_nodes():
            return self
        if self.all_nodes():
            return other
        return PreFilterResult(self.node_names & other.node_names)


class Plugin:
    """Base plugin. `name` must be unique within a profile."""

    name: str = "Plugin"

    def events_to_register(self) -> list[ClusterEvent]:
        """EnqueueExtensions (interface.go:327): cluster events that may make
        a pod rejected by this plugin schedulable again."""
        return [ClusterEvent("*", "*")]


class QueueSortPlugin(Plugin):
    def sort_key(self, qpi) -> tuple:
        raise NotImplementedError


class PreFilterPlugin(Plugin):
    def pre_filter(self, state: CycleState, pod_info: PodInfo,
                   snapshot: Snapshot) -> tuple[PreFilterResult | None, Status | None]:
        raise NotImplementedError

    # AddPod/RemovePod extensions (used by preemption dry-runs)
    def add_pod(self, state: CycleState, pod_info: PodInfo,
                to_add: PodInfo, node_info: NodeInfo) -> Status | None:
        return None

    def remove_pod(self, state: CycleState, pod_info: PodInfo,
                   to_remove: PodInfo, node_info: NodeInfo) -> Status | None:
        return None


class FilterPlugin(Plugin):
    def filter(self, state: CycleState, pod_info: PodInfo,
               node_info: NodeInfo) -> Status | None:
        raise NotImplementedError


class PostFilterPlugin(Plugin):
    def post_filter(self, state: CycleState, pod_info: PodInfo,
                    filtered_node_status_map: dict[str, Status]
                    ) -> tuple[str | None, Status]:
        """Returns (nominated_node_name, status)."""
        raise NotImplementedError


class PreScorePlugin(Plugin):
    def pre_score(self, state: CycleState, pod_info: PodInfo,
                  nodes: list[NodeInfo]) -> Status | None:
        raise NotImplementedError


class ScorePlugin(Plugin):
    def score(self, state: CycleState, pod_info: PodInfo,
              node_info: NodeInfo) -> tuple[int, Status | None]:
        raise NotImplementedError

    def normalize_scores(self, state: CycleState, pod_info: PodInfo,
                         scores: dict[str, int]) -> Status | None:
        return None


class ReservePlugin(Plugin):
    def reserve(self, state: CycleState, pod_info: PodInfo,
                node_name: str) -> Status | None:
        return None

    def unreserve(self, state: CycleState, pod_info: PodInfo,
                  node_name: str) -> None:
        pass


class PermitPlugin(Plugin):
    def permit(self, state: CycleState, pod_info: PodInfo,
               node_name: str) -> tuple[Status | None, float]:
        """Returns (status, wait_timeout_seconds). Status WAIT pauses binding."""
        return None, 0.0


class PreBindPlugin(Plugin):
    def pre_bind(self, state: CycleState, pod_info: PodInfo,
                 node_name: str) -> Status | None:
        return None


class BindPlugin(Plugin):
    def bind(self, state: CycleState, pod_info: PodInfo,
             node_name: str) -> Status | None:
        raise NotImplementedError


class PostBindPlugin(Plugin):
    def post_bind(self, state: CycleState, pod_info: PodInfo,
                  node_name: str) -> None:
        pass


class BatchExtensions:
    """TPU-native batch contract (no reference equivalent — this is the seam
    where the per-pod loop becomes a tensor program).

    A plugin implementing this exposes its Filter as a boolean mask and its
    Score as a float matrix over (batch_pods x nodes), computed on device.
    ops/plugins_tpu.py provides implementations backed by ops/flatten.py
    tensors; scheduler.py composes them under jit.
    """

    def batch_supported(self) -> bool:
        return True


class WaitingPod:
    """A pod paused at Permit (runtime/waiting_pods_map.go)."""

    def __init__(self, pod_info: PodInfo, plugin_timeouts: dict[str, float]):
        self.pod_info = pod_info
        self._pending = set(plugin_timeouts)
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._status: Status | None = None
        self._deadline = time.monotonic() + (max(plugin_timeouts.values())
                                             if plugin_timeouts else 0)

    def allow(self, plugin: str) -> None:
        with self._lock:
            self._pending.discard(plugin)
            if not self._pending and self._status is None:
                self._status = Status(SUCCESS)
                self._event.set()

    def reject(self, plugin: str, msg: str = "") -> None:
        with self._lock:
            if self._status is None:
                self._status = Status(UNSCHEDULABLE, msg or f"rejected by {plugin}",
                                      plugin=plugin)
                self._event.set()

    def wait(self) -> Status:
        remaining = self._deadline - time.monotonic()
        if remaining > 0:
            self._event.wait(remaining)
        with self._lock:
            if self._status is None:
                self._status = Status(UNSCHEDULABLE, "timed out waiting on permit")
            return self._status


class Handle:
    """What plugins get to touch (interface.go:587 Handle)."""

    def __init__(self, client=None, informer_factory=None, nominator=None):
        self.client = client
        self.informer_factory = informer_factory
        self.nominator = nominator
        self.waiting_pods: dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()

    def get_waiting_pod(self, uid_or_key: str) -> WaitingPod | None:
        with self._waiting_lock:
            return self.waiting_pods.get(uid_or_key)

    def iterate_waiting_pods(self) -> list[WaitingPod]:
        with self._waiting_lock:
            return list(self.waiting_pods.values())

    def _add_waiting(self, wp: WaitingPod) -> None:
        with self._waiting_lock:
            self.waiting_pods[wp.pod_info.key] = wp

    def _remove_waiting(self, key: str) -> None:
        with self._waiting_lock:
            self.waiting_pods.pop(key, None)


# plugin factory registry (runtime/registry.go)
Registry = dict[str, Callable[[dict, Handle], Plugin]]


class Framework:
    """A configured profile: ordered plugins per extension point
    (runtime/framework.go frameworkImpl)."""

    def __init__(self, profile_name: str, plugins: Sequence[Plugin],
                 score_weights: dict[str, int] | None = None,
                 handle: Handle | None = None,
                 point_filter: Callable[[str, str], bool] | None = None):
        """point_filter(plugin_name, point) gates which extension points a
        plugin is registered at — this is how the component config's
        per-extension-point enable/disable (apis/config types.go Plugins)
        maps onto the isinstance-based distribution below.  None = all."""
        self.profile_name = profile_name
        self.handle = handle or Handle()
        score_weights = score_weights or {}
        allow = point_filter or (lambda name, point: True)
        self.queue_sort: QueueSortPlugin | None = None
        self.pre_filter: list[PreFilterPlugin] = []
        self.filter: list[FilterPlugin] = []
        self.post_filter: list[PostFilterPlugin] = []
        self.pre_score: list[PreScorePlugin] = []
        self.score: list[tuple[ScorePlugin, int]] = []
        self.reserve: list[ReservePlugin] = []
        self.permit: list[PermitPlugin] = []
        self.pre_bind: list[PreBindPlugin] = []
        self.bind: list[BindPlugin] = []
        self.post_bind: list[PostBindPlugin] = []
        self.all_plugins: list[Plugin] = list(plugins)
        # host-side gates the BATCH path must honor: the device kernel
        # covers resource/affinity semantics but not group-membership
        # gates like Coscheduling's minMember PreFilter — without this,
        # an incomplete gang cycles assume -> Permit-wait -> timeout ->
        # Unreserve forever, starving competitors between cycles
        self.batch_gates: list[Plugin] = [
            p for p in plugins
            if getattr(p, "supports_batch_gate", False)
            and allow(p.name, "preFilter")]  # the gate IS the PreFilter
        for p in plugins:
            if isinstance(p, QueueSortPlugin) and allow(p.name, "queueSort"):
                self.queue_sort = p
            if isinstance(p, PreFilterPlugin) and allow(p.name, "preFilter"):
                self.pre_filter.append(p)
            if isinstance(p, FilterPlugin) and allow(p.name, "filter"):
                self.filter.append(p)
            if isinstance(p, PostFilterPlugin) and allow(p.name, "postFilter"):
                self.post_filter.append(p)
            if isinstance(p, PreScorePlugin) and allow(p.name, "preScore"):
                self.pre_score.append(p)
            if isinstance(p, ScorePlugin) and allow(p.name, "score"):
                self.score.append((p, score_weights.get(p.name, 1)))
            if isinstance(p, ReservePlugin) and allow(p.name, "reserve"):
                self.reserve.append(p)
            if isinstance(p, PermitPlugin) and allow(p.name, "permit"):
                self.permit.append(p)
            if isinstance(p, PreBindPlugin) and allow(p.name, "preBind"):
                self.pre_bind.append(p)
            if isinstance(p, BindPlugin) and allow(p.name, "bind"):
                self.bind.append(p)
            if isinstance(p, PostBindPlugin) and allow(p.name, "postBind"):
                self.post_bind.append(p)
        for p in plugins:  # late-bind plugins that need the framework itself
            if hasattr(p, "set_framework"):
                p.set_framework(self)
        # metrics_recorder(extension_point, status_code_str, seconds) — set by
        # the Scheduler; records framework_extension_point_duration_seconds
        # (runtime/framework.go records this around each RunXPlugins).
        self.metrics_recorder = None
        self._instrument_extension_points()

    _TIMED_POINTS = (
        ("PreFilter", "run_pre_filter_plugins"),
        ("PostFilter", "run_post_filter_plugins"),
        ("PreScore", "run_pre_score_plugins"),
        ("Score", "run_score_plugins"),
        ("Reserve", "run_reserve_plugins"),
        ("Permit", "run_permit_plugins"),
        ("PreBind", "run_pre_bind_plugins"),
        ("Bind", "run_bind_plugins"),
    )

    def _instrument_extension_points(self) -> None:
        """Wrap once-per-cycle runners with timing.  Filter is deliberately
        excluded: it runs per node (hot loop); its cost is covered by
        scheduling_algorithm_duration and the TPU device histograms."""
        for point, name in self._TIMED_POINTS:
            orig = getattr(self, name)

            def wrapper(*a, __orig=orig, __point=point, **kw):
                rec = self.metrics_recorder
                if rec is None:
                    return __orig(*a, **kw)
                t0 = time.perf_counter()
                out = __orig(*a, **kw)
                rec(__point, _status_label(out), time.perf_counter() - t0)
                return out

            setattr(self, name, wrapper)

    def cluster_event_map(self) -> dict[str, list[ClusterEvent]]:
        return {p.name: p.events_to_register() for p in self.all_plugins}

    # -- extension-point runners (runtime/framework.go) -------------------

    def run_pre_filter_plugins(self, state: CycleState, pod_info: PodInfo,
                               snapshot: Snapshot
                               ) -> tuple[PreFilterResult | None, Status | None]:
        result: PreFilterResult | None = None
        for p in self.pre_filter:
            r, s = p.pre_filter(state, pod_info, snapshot)
            if s is not None and s.is_skip():
                state.skip_filter_plugins.add(p.name)
                continue
            if not is_success(s):
                s.plugin = s.plugin or p.name
                return None, s
            if r is not None:
                result = r.merge(result) if result is not None else r
                if result.node_names is not None and not result.node_names:
                    return result, Status(
                        UNSCHEDULABLE_AND_UNRESOLVABLE,
                        "node(s) didn't satisfy plugin " + p.name, plugin=p.name)
        return result, None

    def run_filter_plugins(self, state: CycleState, pod_info: PodInfo,
                           node_info: NodeInfo) -> Status | None:
        for p in self.filter:
            if p.name in state.skip_filter_plugins:
                continue
            s = p.filter(state, pod_info, node_info)
            if not is_success(s):
                s.plugin = s.plugin or p.name
                return s
        return None

    def run_filter_plugins_with_nominated_pods(
            self, state: CycleState, pod_info: PodInfo,
            node_info: NodeInfo) -> Status | None:
        """schedule_one.go:455 + runtime/framework.go addNominatedPods:
        filter twice when higher-priority nominated pods exist on the node."""
        nominator = self.handle.nominator
        nominated = (nominator.nominated_pods_for_node(node_info.name)
                     if nominator else [])
        relevant = [pi for pi in nominated
                    if pi.priority >= pod_info.priority and pi.key != pod_info.key]
        if relevant:
            ni2 = node_info.clone()
            state2 = state.clone()
            for pi in relevant:
                ni2.add_pod(pi)
                for p in self.pre_filter:
                    p.add_pod(state2, pod_info, pi, ni2)
            s = self.run_filter_plugins(state2, pod_info, ni2)
            if not is_success(s):
                return s
        return self.run_filter_plugins(state, pod_info, node_info)

    def run_post_filter_plugins(self, state: CycleState, pod_info: PodInfo,
                                statuses: dict[str, Status]
                                ) -> tuple[str | None, Status]:
        best: str | None = None
        last = Status(UNSCHEDULABLE)
        for p in self.post_filter:
            nominated, s = p.post_filter(state, pod_info, statuses)
            if s is not None and s.code == SUCCESS:
                return nominated, s
            if s is not None and s.code == UNSCHEDULABLE_AND_UNRESOLVABLE:
                return None, s
            if s is not None:
                last = s
        return best, last

    def run_pre_score_plugins(self, state: CycleState, pod_info: PodInfo,
                              nodes: list[NodeInfo]) -> Status | None:
        for p in self.pre_score:
            s = p.pre_score(state, pod_info, nodes)
            if s is not None and s.is_skip():
                state.skip_score_plugins.add(p.name)
                continue
            if not is_success(s):
                s.plugin = s.plugin or p.name
                return s
        return None

    def run_score_plugins(self, state: CycleState, pod_info: PodInfo,
                          nodes: list[NodeInfo]
                          ) -> tuple[dict[str, int], Status | None]:
        """Returns total weighted score per node name (framework.go:903)."""
        totals: dict[str, int] = {ni.name: 0 for ni in nodes}
        for p, weight in self.score:
            if p.name in state.skip_score_plugins:
                continue
            scores: dict[str, int] = {}
            for ni in nodes:
                val, s = p.score(state, pod_info, ni)
                if not is_success(s):
                    s.plugin = s.plugin or p.name
                    return {}, s
                scores[ni.name] = val
            s = p.normalize_scores(state, pod_info, scores)
            if not is_success(s):
                return {}, s
            for name, val in scores.items():
                totals[name] += val * weight
        return totals, None

    def run_reserve_plugins(self, state: CycleState, pod_info: PodInfo,
                            node_name: str) -> Status | None:
        for i, p in enumerate(self.reserve):
            s = p.reserve(state, pod_info, node_name)
            if not is_success(s):
                for q in self.reserve[:i + 1]:
                    q.unreserve(state, pod_info, node_name)
                s.plugin = s.plugin or p.name
                return s
        return None

    def run_unreserve_plugins(self, state: CycleState, pod_info: PodInfo,
                              node_name: str) -> None:
        for p in reversed(self.reserve):
            p.unreserve(state, pod_info, node_name)

    def run_permit_plugins(self, state: CycleState, pod_info: PodInfo,
                           node_name: str) -> Status | None:
        timeouts: dict[str, float] = {}
        for p in self.permit:
            s, timeout = p.permit(state, pod_info, node_name)
            if s is not None and s.is_wait():
                timeouts[p.name] = timeout
            elif not is_success(s):
                s.plugin = s.plugin or p.name
                return s
        if timeouts:
            wp = WaitingPod(pod_info, timeouts)
            self.handle._add_waiting(wp)
            return Status(WAIT)
        return None

    def wait_on_permit(self, pod_info: PodInfo) -> Status | None:
        wp = self.handle.get_waiting_pod(pod_info.key)
        if wp is None:
            return None
        try:
            return wp.wait()
        finally:
            self.handle._remove_waiting(pod_info.key)

    def run_pre_bind_plugins(self, state: CycleState, pod_info: PodInfo,
                             node_name: str) -> Status | None:
        for p in self.pre_bind:
            s = p.pre_bind(state, pod_info, node_name)
            if not is_success(s):
                s.plugin = s.plugin or p.name
                return s
        return None

    def run_bind_plugins(self, state: CycleState, pod_info: PodInfo,
                         node_name: str) -> Status | None:
        if not self.bind:
            return Status(ERROR, "no bind plugin configured")
        for p in self.bind:
            s = p.bind(state, pod_info, node_name)
            if s is not None and s.is_skip():
                continue
            if not is_success(s):
                s.plugin = s.plugin or p.name
            return s
        return Status(ERROR, "all bind plugins skipped")

    def batch_tail_trivial(self) -> bool:
        """True when the Reserve/Permit/WaitOnPermit/PreBind/PostBind hooks
        are PROVABLY no-ops for a pod whose CycleState is empty — every
        plugin at those points is `state_gated` (acts only on state written
        by its own PreFilter, which the batch path never runs) and no
        Permit plugin exists (so nothing can ever be in the waiting map).
        The batch bind tail uses this to skip the per-pod hook loops
        wholesale; adding e.g. Coscheduling (Permit) or any non-gated
        reserve plugin turns the full path back on automatically."""
        return (not self.permit
                and all(getattr(p, "state_gated", False) for p in self.reserve)
                and all(getattr(p, "state_gated", False) for p in self.pre_bind)
                and all(getattr(p, "state_gated", False)
                        for p in self.post_bind))

    def run_post_bind_plugins(self, state: CycleState, pod_info: PodInfo,
                              node_name: str) -> None:
        for p in self.post_bind:
            p.post_bind(state, pod_info, node_name)
