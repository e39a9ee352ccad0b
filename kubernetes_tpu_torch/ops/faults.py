"""Deterministic fault injection for the port's batch path.

Counterpart of the load, topology and in-process scale-out halves of
kubernetes_tpu/ops/faults.py, copied: the seeded OverloadSchedule and the
ChaosBatchBackend wrapper that injects slow and all-escape waves at the
BatchBackend contract, the seeded ChurnStormSchedule with the
NodeStormDriver that floods node adds, drains and relabels through a live
store, and the seeded ScaleOutSchedule with the InstanceChurner.  Given
the same seed, each schedule here makes the same decisions as the JAX
one, so the port and the reference replay identical storms
(tests/test_torch_faults.py, tests/test_torch_storm.py,
tests/test_torch_scaleout.py).

Reference: test/e2e's disruptive "chaosmonkey" pattern (test/e2e/
chaosmonkey: register disruptions, run them against live components,
assert the system converges).  Every schedule is deterministic two ways:

  * `script` — {index: action} pins an exact fault to an exact step.
    Scripted entries win.
  * rates — probabilities drawn from a seeded random.Random.  Exactly ONE
    draw happens per step, before the script lookup, so adding a scripted
    entry never shifts the random stream of the steps around it.

The transport half (FaultSchedule, FaultyTransport) wraps the remote
seam's client transport (ops/remote.py): every failure mode the seam's
error ladder claims to handle is injected on a seeded schedule:

  DROP    -> raise TransientSeamError (the request never reaches the
             worker); the client's bounded backoff retry absorbs it.
  DELAY   -> sleep, then forward (tail latency; deadlines still apply).
  CORRUPT -> forward, then flip bytes in the response frame; the CRC
             framing detects it and the seq dedup makes the retry serve
             the original bytes without re-applying the step.
  KILL    -> call on_kill() (DeviceWorker.simulate_restart) BEFORE
             forwarding: the call lands on a state-lost worker and the
             client runs its checkpoint + journal resync.

The scale-out half (ScaleOutSchedule, InstanceChurner) kills and revives
whole scheduler instances in this process through their
ScaleOutCoordinator (scheduler/scaleout.py); the process-true churners
(ProcessChurner, UpgradeSchedule, UpgradeDriver) need the process
supervisor and wait for it (ROADMAP item 10b).

A chaos wrapper is applied only when a caller asks for it (the harness's
chaos_schedule, the nodeStorm opcode, the RemoteSeamFaulty row); it never
stands in for a failed device.
"""

from __future__ import annotations

import random
import threading
import time

NONE = "none"

# -- transport faults under the remote seam -------------------------------

DROP = "drop"
DELAY = "delay"
CORRUPT = "corrupt"
KILL = "kill"


class FaultSchedule:
    """Seeded, reproducible fault decisions, one per transport call.

    `action(i, verb)` is consulted with a global call index; subclass it
    for stateful schedules (a kill keyed on the Nth /step rather than an
    absolute call index)."""

    def __init__(self, seed: int = 0, drop_rate: float = 0.0,
                 delay_rate: float = 0.0, corrupt_rate: float = 0.0,
                 delay_s: float = 0.01,
                 script: dict[int, str] | None = None):
        self.rng = random.Random(seed)
        self.drop_rate = drop_rate
        self.delay_rate = delay_rate
        self.corrupt_rate = corrupt_rate
        self.delay_s = delay_s
        self.script = dict(script or {})

    def action(self, call_index: int, verb: str) -> str:
        # one draw per call REGARDLESS of the script, so scripted entries
        # don't shift the stream for later calls
        u = self.rng.random()
        scripted = self.script.get(call_index)
        if scripted is not None:
            return scripted
        if u < self.drop_rate:
            return DROP
        if u < self.drop_rate + self.delay_rate:
            return DELAY
        if u < self.drop_rate + self.delay_rate + self.corrupt_rate:
            return CORRUPT
        return NONE


def _corrupt(blob: bytes) -> bytes:
    """Flip a spray of bytes across the frame header and early payload:
    it breaks either the magic or the CRC check."""
    out = bytearray(blob)
    for i in range(0, min(len(out), 33), 8):
        out[i] ^= 0xFF
    return bytes(out)


class FaultyTransport:
    """A client transport wrapper that injects schedule-driven faults:
    the inner transport's `post` signature, handed to
    RemoteTorchBatchBackend as `transport=`.  `injected` counts what
    fired, by action; `calls` is the number of posts seen."""

    def __init__(self, inner, schedule: FaultSchedule, on_kill=None):
        self.inner = inner
        self.kind = getattr(inner, "kind", "?")
        self.schedule = schedule
        self.on_kill = on_kill
        self.calls = 0
        self.injected = {DROP: 0, DELAY: 0, CORRUPT: 0, KILL: 0}
        self._lock = threading.Lock()

    def post(self, verb: str, body: bytes, *, timeout: float,
             epoch: int | None = None, seq: int | None = None,
             traceparent: str | None = None) -> bytes:
        from .remote import TransientSeamError
        with self._lock:
            i = self.calls
            self.calls += 1
            act = self.schedule.action(i, verb)
        if act == DROP:
            self.injected[DROP] += 1
            raise TransientSeamError(verb, f"injected drop (call {i})")
        if act == KILL and self.on_kill is not None:
            # restart BEFORE forwarding: this very call arrives at a
            # state-lost worker
            self.injected[KILL] += 1
            self.on_kill()
        if act == DELAY:
            self.injected[DELAY] += 1
            time.sleep(self.schedule.delay_s)
        out = self.inner.post(verb, body, timeout=timeout, epoch=epoch,
                              seq=seq, traceparent=traceparent)
        if act == CORRUPT:
            self.injected[CORRUPT] += 1
            return _corrupt(out)
        return out

    def close(self) -> None:
        self.inner.close()


# -- overload chaos -------------------------------------------------------
#
# ChaosBatchBackend injects LOAD faults at the BatchBackend contract
# itself: slow waves (a device that still answers, but late: the
# stuck-wave watchdog's prey) and adversarial all-escape waves (every pod
# SKIPs toward the per-pod oracle: the escape-storm breaker's prey).
# Seeded and scriptable, so the SchedulingOverloadFlood row and the tests
# replay identical storms.

SLOW = "slow"
ALL_ESCAPE = "all_escape"


class OverloadSchedule:
    """Seeded, reproducible per-WAVE overload decisions.

    One rng draw per wave regardless of the script (same stream-stability
    rule as FaultSchedule): scripted waves never shift the random stream
    of the waves around them."""

    def __init__(self, seed: int = 0, slow_rate: float = 0.0,
                 slow_s: float = 0.25, all_escape_rate: float = 0.0,
                 script: dict[int, str] | None = None):
        self.rng = random.Random(seed)
        self.slow_rate = slow_rate
        self.slow_s = slow_s
        self.all_escape_rate = all_escape_rate
        self.script = dict(script or {})

    def action(self, wave_index: int) -> str:
        u = self.rng.random()
        scripted = self.script.get(wave_index)
        if scripted is not None:
            return scripted
        if u < self.slow_rate:
            return SLOW
        if u < self.slow_rate + self.all_escape_rate:
            return ALL_ESCAPE
        return NONE


class ChaosBatchBackend:
    """A BatchBackend wrapper that injects schedule-driven overload faults.

    SLOW        -> forward the dispatch; the returned resolve() sleeps
                   slow_s before yielding the real results (a live but
                   late device — deadline/watchdog territory).
    ALL_ESCAPE  -> do NOT touch the inner backend: every pod in the wave
                   comes back (None, SKIP) as if its constraints were not
                   tensor-encodable, and the wave tallies a
                   ("chaos", "injected_all_escape") escape reason.  No
                   device state is claimed, so abandoning or retrying the
                   wave needs no repair.

    `injected` counts fired faults; `waves` is the dispatch count."""

    def __init__(self, inner, schedule: OverloadSchedule):
        self.inner = inner
        self.supports_pipelining = getattr(inner, "supports_pipelining", True)
        self.schedule = schedule
        self.waves = 0
        self.injected = {SLOW: 0, ALL_ESCAPE: 0}
        self._lock = threading.Lock()
        self._esc_pending: dict[tuple[str, str], int] = {}

    @property
    def stats(self):
        return getattr(self.inner, "stats", {})

    def dispatch(self, pod_infos, snapshot):
        from ..scheduler.types import SKIP, Status
        with self._lock:
            i = self.waves
            self.waves += 1
            act = self.schedule.action(i)
        if act == ALL_ESCAPE:
            self.injected[ALL_ESCAPE] += 1
            n = len(pod_infos)
            with self._lock:
                key = ("chaos", "injected_all_escape")
                self._esc_pending[key] = self._esc_pending.get(key, 0) + n
            results = [(None, Status(SKIP, "injected escape storm"))
                       for _ in range(n)]
            return lambda: results
        resolve = self.inner.dispatch(pod_infos, snapshot)
        if not callable(resolve):
            return resolve  # FLUSH_FIRST sentinel passes through
        if act == SLOW:
            self.injected[SLOW] += 1

            def slow_resolve():
                time.sleep(self.schedule.slow_s)
                return resolve()
            return slow_resolve
        return resolve

    def assign(self, pod_infos, snapshot):
        return self.dispatch(pod_infos, snapshot)()

    # -- forwarded backend surface (all optional on the contract) --------

    def warmup(self) -> None:
        fn = getattr(self.inner, "warmup", None)
        if fn is not None:
            fn()

    def health(self):
        fn = getattr(self.inner, "health", None)
        return fn() if fn is not None else True

    def prefetch(self, view) -> None:
        fn = getattr(self.inner, "prefetch", None)
        if fn is not None:
            fn(view)

    def note_node_event(self, event_type: str, name: str, view) -> None:
        fn = getattr(self.inner, "note_node_event", None)
        if fn is not None:
            fn(event_type, name, view)

    def maintenance_snapshot(self) -> dict:
        fn = getattr(self.inner, "maintenance_snapshot", None)
        return fn() if fn is not None else {}

    def abandon_wave(self) -> None:
        fn = getattr(self.inner, "abandon_wave", None)
        if fn is not None:
            fn()

    def drain_escape_reasons(self) -> dict:
        with self._lock:
            out, self._esc_pending = self._esc_pending, {}
        fn = getattr(self.inner, "drain_escape_reasons", None)
        if fn is not None:
            for key, cnt in fn().items():
                out[key] = out.get(key, 0) + cnt
        return out

    def drain_batch_telemetry(self) -> list:
        fn = getattr(self.inner, "drain_batch_telemetry", None)
        return fn() if fn is not None else []

    def device_census(self, *args, **kwargs) -> dict:
        fn = getattr(self.inner, "device_census", None)
        return fn(*args, **kwargs) if fn is not None else {}

    @property
    def census_kind(self) -> str:
        return getattr(self.inner, "census_kind", "chaos")


# -- scale-out chaos -----------------------------------------------------
#
# One seam further out again: where ChaosBatchBackend stresses a single
# scheduler's device path, the scale-out harness stresses the MEMBERSHIP
# of N cooperating scheduler instances — killing and reviving whole
# instances mid-wave so the survivors must absorb the dead instance's
# ring slices while its in-flight batch lands in backoff, never on a
# node a peer now owns.  Seeded + scriptable like the schedules above so
# tests/test_scaleout.py and tests/test_torch_scaleout.py replay
# identical churn.

KILL_INSTANCE = "kill_instance"
REVIVE_INSTANCE = "revive_instance"


class ScaleOutSchedule:
    """Seeded, reproducible per-wave instance-churn decisions.

    One rng draw per wave regardless of the script (the stream-stability
    rule shared with FaultSchedule/OverloadSchedule).  The single draw
    decides BOTH the action and the victim: the draw's position inside
    its action band is re-scaled to an instance index, so adding a
    scripted wave never shifts the stream of the waves around it.
    Scripted entries are (action, instance_index) pairs and win."""

    def __init__(self, seed: int = 0, instance_count: int = 2,
                 kill_rate: float = 0.0, revive_rate: float = 0.0,
                 script: dict[int, tuple[str, int]] | None = None):
        self.rng = random.Random(seed)
        self.instance_count = instance_count
        self.kill_rate = kill_rate
        self.revive_rate = revive_rate
        self.script = dict(script or {})

    def action(self, wave_index: int) -> tuple[str, int]:
        u = self.rng.random()
        scripted = self.script.get(wave_index)
        if scripted is not None:
            return scripted
        if self.kill_rate and u < self.kill_rate:
            victim = int(u / self.kill_rate * self.instance_count)
            return (KILL_INSTANCE, min(victim, self.instance_count - 1))
        if self.revive_rate and u < self.kill_rate + self.revive_rate:
            frac = (u - self.kill_rate) / self.revive_rate
            victim = int(frac * self.instance_count)
            return (REVIVE_INSTANCE, min(victim, self.instance_count - 1))
        return (NONE, -1)


class InstanceChurner:
    """Applies ScaleOutSchedule actions to live ScaleOutCoordinators.

    The in-process kill switch is coordinator.retire(): the instance
    stops renewing its lease AND flips self_live to False, so its next
    bind wave takes the fenced path — exactly what lease expiry or a
    store fence does to a real deployment, minus the process exit.
    A min_live floor refuses kills that would leave the cluster with no
    scheduler at all (chaos must not deadlock the test).  `injected`
    counts actions that actually changed state, for assertions."""

    def __init__(self, coordinators, schedule: ScaleOutSchedule,
                 min_live: int = 1):
        self.coordinators = list(coordinators)
        self.schedule = schedule
        self.min_live = min_live
        self.waves = 0
        self.injected = {KILL_INSTANCE: 0, REVIVE_INSTANCE: 0}
        self.log: list[tuple[int, str, int]] = []
        self._lock = threading.Lock()

    def step(self) -> tuple[str, int] | None:
        """Consult the schedule for the next wave; returns the applied
        (action, instance) or None when nothing changed."""
        with self._lock:
            i = self.waves
            self.waves += 1
            act, idx = self.schedule.action(i)
            if act == NONE or not (0 <= idx < len(self.coordinators)):
                return None
            co = self.coordinators[idx]
            retired = getattr(co, "_retired", False)
            if act == KILL_INSTANCE:
                alive = sum(1 for c in self.coordinators
                            if not getattr(c, "_retired", False))
                if retired or alive <= self.min_live:
                    return None
                co.retire()
            else:
                if not retired:
                    return None
                co.revive()
            self.injected[act] += 1
            self.log.append((i, act, idx))
            return (act, idx)


# -- churn-storm chaos ----------------------------------------------------
#
# The chaos above stresses the device path; the storm below stresses the
# CLUSTER TOPOLOGY itself —
# flooding node adds, drains and relabels through the informer while pod
# floods are in flight, so the backend's row patches, between-wave
# compaction and pipelined generation fences absorb real event pressure
# with SLOs asserted on top.  Seeded + scriptable under the same
# one-draw-per-step stream-stability rule as the schedule above, so the
# SchedulingChurnStorm workload and the tests replay identical storms.

NODE_ADD = "node_add"
NODE_DRAIN = "node_drain"
NODE_RELABEL = "node_relabel"


class ChurnStormSchedule:
    """Seeded, reproducible per-step node-churn decisions.

    One rng draw per step regardless of the script; the single draw
    decides BOTH the action and the victim — its position inside the
    action's probability band re-scales to a victim fraction (the
    ScaleOutSchedule idiom), so adding a scripted step never shifts the
    stream of the steps around it.  Scripted entries are
    (action, victim_fraction) pairs and win."""

    def __init__(self, seed: int = 0, add_rate: float = 0.0,
                 drain_rate: float = 0.0, relabel_rate: float = 0.0,
                 script: dict[int, tuple[str, float]] | None = None):
        self.rng = random.Random(seed)
        self.add_rate = add_rate
        self.drain_rate = drain_rate
        self.relabel_rate = relabel_rate
        self.script = dict(script or {})

    def action(self, step_index: int) -> tuple[str, float]:
        u = self.rng.random()
        scripted = self.script.get(step_index)
        if scripted is not None:
            return scripted
        if self.add_rate and u < self.add_rate:
            return (NODE_ADD, u / self.add_rate)
        lo = self.add_rate
        if self.drain_rate and u < lo + self.drain_rate:
            return (NODE_DRAIN, (u - lo) / self.drain_rate)
        lo += self.drain_rate
        if self.relabel_rate and u < lo + self.relabel_rate:
            return (NODE_RELABEL, (u - lo) / self.relabel_rate)
        return (NONE, 0.0)


class NodeStormDriver:
    """Applies ChurnStormSchedule actions to a live cluster store.

    NODE_ADD      -> create a fresh schedulable node (storm-N); lands as
                     an informer add -> backend row patch / gen bump.
    NODE_DRAIN    -> delete the victim node outright (the storm models
                     abrupt capacity loss, not cordon+wait): its row is
                     tombstoned, bound pods' accounting unwinds, and any
                     in-flight wave dispatched against the old topology
                     must gen-fence.  A min_nodes floor refuses drains
                     that would leave the flood nowhere to land (chaos
                     must not deadlock the run).
    NODE_RELABEL  -> bump a storm epoch label on the victim via
                     guaranteed_update; an update event that changes
                     labels invalidates selector caches without touching
                     capacity — the cheap-patch path under pressure.

    Victims are picked from the driver's live-name view (base nodes +
    storm adds - drains); `injected` counts applied actions and `log`
    records (step, action, node) for deterministic assertions."""

    def __init__(self, client, schedule: ChurnStormSchedule,
                 base_nodes, min_nodes: int = 1, max_nodes: int = 0,
                 cpu: str = "32", mem: str = "256Gi", pods: int = 110,
                 rack_labels: int = 0, name_prefix: str = "storm-"):
        self.client = client
        self.schedule = schedule
        self.min_nodes = max(1, min_nodes)
        # ceiling symmetrical to the floor: unbounded adds would grow the
        # cluster past the backend's tensor caps (n_cap) and stall every
        # wave; 0 = no ceiling (unit tests), harness default is 2x base
        self.max_nodes = max_nodes
        self.cpu, self.mem, self.pods = cpu, mem, pods
        self.rack_labels = rack_labels
        self.name_prefix = name_prefix
        self._names = list(base_nodes)
        self._next_id = 0
        self.steps = 0
        self.injected = {NODE_ADD: 0, NODE_DRAIN: 0, NODE_RELABEL: 0}
        self.log: list[tuple[int, str, str]] = []
        self._lock = threading.Lock()

    def _build_node(self, name: str, epoch: int):
        from ..testing import make_node
        w = make_node(name).capacity(cpu=self.cpu, mem=self.mem,
                                     pods=self.pods)
        labels = {"kubernetes.io/hostname": name,
                  "ktpu.io/storm-epoch": str(epoch)}
        if self.rack_labels:
            labels["ktpu.io/rack"] = str(epoch % self.rack_labels)
        w.labels(**labels)
        return w.build()

    def step(self) -> tuple[str, str] | None:
        """Consult the schedule once; returns the applied (action, node)
        or None when the step was a no-op (NONE draw or floor refusal)."""
        from ..client.clientset import NODES
        from ..store import kv
        with self._lock:
            i = self.steps
            self.steps += 1
            act, frac = self.schedule.action(i)
            if act == NODE_ADD:
                if self.max_nodes and len(self._names) >= self.max_nodes:
                    return None
                name = f"{self.name_prefix}{self._next_id}"
                node = self._build_node(name, self._next_id)
                self._next_id += 1
                try:
                    self.client.create(NODES, node)
                except kv.StoreError:
                    return None
                self._names.append(name)
            elif act == NODE_DRAIN:
                if len(self._names) <= self.min_nodes:
                    return None
                name = self._names.pop(
                    min(int(frac * len(self._names)),
                        len(self._names) - 1))
                try:
                    self.client.delete(NODES, "", name)
                except kv.StoreError:
                    return None
            elif act == NODE_RELABEL:
                if not self._names:
                    return None
                name = self._names[min(int(frac * len(self._names)),
                                       len(self._names) - 1)]

                def bump(cur, i=i):
                    cur["metadata"].setdefault("labels", {})[
                        "ktpu.io/storm-epoch"] = str(i)
                    return cur
                try:
                    self.client.guaranteed_update(NODES, "", name, bump)
                except kv.StoreError:
                    return None
            else:
                return None
            self.injected[act] += 1
            self.log.append((i, act, name))
            return (act, name)
