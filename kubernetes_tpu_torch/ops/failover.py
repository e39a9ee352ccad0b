"""Circuit-breaker failover ladder for the port's batch backends.

Counterpart of kubernetes_tpu/ops/failover.py.  Reference:
pkg/scheduler/extender.go's `ignorable` extenders (an out-of-process
scheduling helper may be marked non-fatal, scheduling carrying on without
it) and SURVEY §5: a device-resident scheduler must degrade to the host
path when the device seam is unhealthy; a scheduler that stops binding is
an outage, one that schedules more slowly is a latency regression.

`FailoverBatchBackend` stacks rungs of decreasing dependency surface:

    remote RemoteTorchBatchBackend   (network + worker process + card)
      -> in-process TorchBatchBackend (the same card, this process)
        -> per-pod oracle             (pure Python, always available)

Each rung carries a circuit breaker (Nygard, "Release It!"):

  * CLOSED — the rung serves dispatches.  A dispatch or resolve that
    raises BackendUnavailableError counts one consecutive failure; at
    `failure_threshold` the breaker OPENS and the ladder falls to the
    next rung.  Any success resets the count.
  * OPEN — the rung is skipped.  After `probe_interval` seconds the next
    dispatch half-opens it: one `health()` round trip (a backend without
    a health probe is trusted).  A good probe RE-CLOSES the breaker
    (fail-back); a bad one re-arms the window.
  * all rungs open — the oracle rung: dispatch returns every pod as SKIP,
    which the scheduler routes to its per-pod path.  Nothing is dropped
    and no binding is wrong, it is merely slow, and the breakers keep
    probing.

The ladder never absorbs a failed batch: the failing dispatch or resolve
re-raises BackendUnavailableError and the scheduler requeues the batch
(queue.requeue_backoff), so the same pods re-dispatch on whatever rung
the breakers then select.  On fail-back a re-closed remote rung diffs the
authoritative tensors against its stale mirror and refreshes itself
(ops/backend.py).
"""

from __future__ import annotations

import logging
import threading
import time

from ..scheduler.batch_backend import BatchBackend
from ..scheduler.scheduler import BackendUnavailableError
from ..scheduler.types import SKIP, Status

logger = logging.getLogger(__name__)


class _Breaker:
    """Consecutive-failure circuit breaker for one rung."""

    def __init__(self, threshold: int, probe_interval: float, now_fn):
        self.threshold = max(1, threshold)
        self.probe_interval = probe_interval
        self._now = now_fn
        self.consecutive = 0
        self.opened_at: float | None = None

    @property
    def is_open(self) -> bool:
        return self.opened_at is not None

    def record_failure(self) -> bool:
        """Returns True when this failure OPENS the breaker."""
        if self.opened_at is not None:
            # failed while open (a bad probe): re-arm the probe window
            self.opened_at = self._now()
            return False
        self.consecutive += 1
        if self.consecutive >= self.threshold:
            self.opened_at = self._now()
            return True
        return False

    def record_success(self) -> bool:
        """Returns True when this success RE-CLOSES an open breaker."""
        self.consecutive = 0
        if self.opened_at is not None:
            self.opened_at = None
            return True
        return False

    def probe_due(self) -> bool:
        return (self.opened_at is not None
                and self._now() - self.opened_at >= self.probe_interval)


class _Rung:
    __slots__ = ("name", "backend", "breaker")

    def __init__(self, name: str, backend, breaker: _Breaker):
        self.name = name
        self.backend = backend
        self.breaker = breaker


class FailoverBatchBackend(BatchBackend):
    """BatchBackend that serves each dispatch from the healthiest rung.

    `backends` is an ordered [(name, backend), ...], best first, e.g.
    [("remote", RemoteTorchBatchBackend(...)), ("inproc",
    TorchBatchBackend(...))].  The oracle rung is implicit and last."""

    def __init__(self, backends, failure_threshold: int = 3,
                 probe_interval: float = 5.0, now_fn=time.monotonic):
        if not backends:
            raise ValueError("FailoverBatchBackend needs at least one rung")
        self._rungs = [
            _Rung(name, backend,
                  _Breaker(failure_threshold, probe_interval, now_fn))
            for name, backend in backends]
        self._lock = threading.Lock()
        self.seam_stats = {"failovers": 0, "recloses": 0, "probes": 0,
                           "failed_probes": 0, "oracle_batches": 0,
                           "rung_failures": 0}

    # -- rung selection --------------------------------------------------

    def _probe(self, rung: _Rung) -> bool:
        self.seam_stats["probes"] += 1
        health = getattr(rung.backend, "health", None)
        if health is None:
            return True  # no probe surface: trust the half-open attempt
        try:
            got = health()
            return bool(got.get("ok", True))
        except Exception:  # noqa: BLE001 — any probe failure keeps it open
            return False

    def _active(self) -> _Rung | None:
        """First healthy rung, half-open-probing open rungs whose window
        elapsed.  None = every rung is open -> oracle."""
        for rung in self._rungs:
            if not rung.breaker.is_open:
                return rung
            if rung.breaker.probe_due():
                if self._probe(rung):
                    rung.breaker.record_success()
                    self.seam_stats["recloses"] += 1
                    logger.warning("failover: rung %r healthy again; "
                                   "re-closing breaker", rung.name)
                    return rung
                self.seam_stats["failed_probes"] += 1
                rung.breaker.record_failure()  # re-arm the window
        return None

    def _on_failure(self, rung: _Rung, err: BaseException) -> None:
        self.seam_stats["rung_failures"] += 1
        if rung.breaker.record_failure():
            self.seam_stats["failovers"] += 1
            logger.warning(
                "failover: rung %r opened after %d consecutive failures "
                "(%s); falling to next rung", rung.name,
                rung.breaker.threshold, err)

    # -- BatchBackend ----------------------------------------------------

    @property
    def supports_pipelining(self) -> bool:
        with self._lock:
            rung = next((r for r in self._rungs if not r.breaker.is_open),
                        None)
        if rung is None:
            return False  # oracle rung: nothing in flight, ever
        return getattr(rung.backend, "supports_pipelining", True)

    def dispatch(self, pod_infos, snapshot):
        with self._lock:
            rung = self._active()
        if rung is None:
            self.seam_stats["oracle_batches"] += 1
            n = len(pod_infos)
            results = [(None, Status(
                SKIP, "all TPU rungs unavailable; per-pod oracle path"))
            ] * n
            return lambda: results
        try:
            resolve = rung.backend.dispatch(pod_infos, snapshot)
        except BackendUnavailableError as e:
            with self._lock:
                self._on_failure(rung, e)
            raise
        if not callable(resolve):
            return resolve  # FLUSH_FIRST passes through by identity

        def _resolve():
            try:
                results = resolve()
            except BackendUnavailableError as e:
                with self._lock:
                    self._on_failure(rung, e)
                raise
            with self._lock:
                if rung.breaker.record_success():
                    self.seam_stats["recloses"] += 1
            return results

        return _resolve

    def assign(self, pod_infos, snapshot):
        resolve = self.dispatch(pod_infos, snapshot)
        if not callable(resolve):  # pragma: no cover — FLUSH_FIRST
            raise RuntimeError("assign() cannot honor FLUSH_FIRST; "
                               "use dispatch/resolve")
        return resolve()

    # -- delegation ------------------------------------------------------

    def device_census(self, *args, **kwargs) -> dict:
        """Census the currently-active rung (the program waves actually
        run through); rungs without a device path contribute nothing."""
        with self._lock:
            rung = next((r for r in self._rungs if not r.breaker.is_open),
                        None)
        if rung is None:
            return {}
        fn = getattr(rung.backend, "device_census", None)
        return fn(*args, **kwargs) if fn is not None else {}

    @property
    def census_kind(self) -> str:
        with self._lock:
            rung = next((r for r in self._rungs if not r.breaker.is_open),
                        None)
        if rung is None:
            return "failover"
        inner = getattr(rung.backend, "census_kind", rung.name)
        return f"failover-{inner}"

    def warmup(self) -> None:
        """Warm EVERY rung: a failover target that still has kernels to
        compile would turn the first degraded batch into a compile storm."""
        for rung in self._rungs:
            warm = getattr(rung.backend, "warmup", None)
            if warm is None:
                continue
            try:
                warm()
            except BackendUnavailableError as e:
                with self._lock:
                    self._on_failure(rung, e)

    def prefetch(self, snapshot) -> None:
        for rung in self._rungs:
            if not rung.breaker.is_open:
                fn = getattr(rung.backend, "prefetch", None)
                if fn is not None:
                    fn(snapshot)
                return

    def note_namespace_event(self, event_type: str, obj, old=None) -> None:
        """Fan namespace-label events to EVERY rung (not just the active
        one): a cold standby must resolve namespaceSelector terms from a
        current cache the moment failover promotes it."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "note_namespace_event", None)
            if fn is not None:
                fn(event_type, obj, old)

    def note_pdb_event(self, event_type: str, obj, old=None) -> None:
        """Fan PDB events to EVERY rung (same reason as namespace events:
        a standby's victim-tensor PDB bits must be current at promotion)."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "note_pdb_event", None)
            if fn is not None:
                fn(event_type, obj, old)

    def note_node_event(self, event_type: str, name: str, view) -> None:
        """Fan node events to EVERY rung (incremental flatten): each rung
        keeps its own resident ClusterTensors, and a cold standby's rows
        must be generation-current the moment failover promotes it."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "note_node_event", None)
            if fn is not None:
                fn(event_type, name, view)

    def preempt_candidates(self, pod_infos, k: int = 16):
        for rung in self._rungs:
            if not rung.breaker.is_open:
                fn = getattr(rung.backend, "preempt_candidates", None)
                if fn is not None:
                    return fn(pod_infos, k)
        return None

    def preempt_batch(self, pod_infos, node_ord_of, nominated=()):
        """Serve the batched dry run from the healthiest rung; a rung
        failure opens its breaker and the NEXT rung answers — the last
        resort escapes the whole wave to the per-pod Evaluator, one rung
        at a time down the same ladder dispatch rides."""
        for rung in self._rungs:
            with self._lock:
                open_ = rung.breaker.is_open
            if open_:
                continue
            fn = getattr(rung.backend, "preempt_batch", None)
            if fn is None:
                continue
            try:
                return fn(pod_infos, node_ord_of, nominated)
            except BackendUnavailableError as e:
                with self._lock:
                    self._on_failure(rung, e)
        # no healthy rung implements it: the caller's legacy tier takes
        # the wave (per-pod Evaluator / full host PostFilter)
        return ([None] * len(pod_infos),
                {i: "backend_unavailable" for i in range(len(pod_infos))})

    # -- observability ---------------------------------------------------

    def victim_occupancy(self) -> float:
        for rung in self._rungs:
            fn = getattr(rung.backend, "victim_occupancy", None)
            if fn is not None and not rung.breaker.is_open:
                return fn()
        return 0.0

    def maintenance_snapshot(self) -> dict:
        """The ACTIVE rung's tensor-maintenance readout (occupancy and
        tombstones are per-tensor-copy state, not summable; the wave
        counters follow the rung that actually dispatched)."""
        for rung in self._rungs:
            fn = getattr(rung.backend, "maintenance_snapshot", None)
            if fn is not None and not rung.breaker.is_open:
                return fn()
        return {}

    @property
    def stats(self) -> dict:
        """Summed per-rung batch stats (the scheduler reads e.g.
        stats['batches'] for its bench counters)."""
        total: dict = {}
        for rung in self._rungs:
            for key, val in getattr(rung.backend, "stats", {}).items():
                if isinstance(val, (int, float)):
                    total[key] = total.get(key, 0) + val
        return total

    def drain_escape_reasons(self) -> dict:
        """Summed per-(plugin, reason) escape tallies across rungs (the
        scheduler applies them as scheduler_tpu_escape_total deltas)."""
        out: dict = {}
        for rung in self._rungs:
            fn = getattr(rung.backend, "drain_escape_reasons", None)
            if fn is not None:
                for key, cnt in fn().items():
                    out[key] = out.get(key, 0) + cnt
        return out

    def drain_batch_telemetry(self) -> list:
        out: list = []
        for rung in self._rungs:
            fn = getattr(rung.backend, "drain_batch_telemetry", None)
            if fn is not None:
                out.extend(fn())
        return out

    def breaker_state(self) -> dict[str, float]:
        with self._lock:
            return {r.name: 1.0 if r.breaker.is_open else 0.0
                    for r in self._rungs}

    def seam_snapshot(self) -> dict[str, float]:
        """Own ladder counters + the primary rung's transport counters
        (retries/resyncs/...), prefixed, for scheduler.expose_metrics."""
        snap = dict(self.seam_stats)
        primary = self._rungs[0].backend
        for key, val in getattr(primary, "seam_stats", {}).items():
            snap[f"remote_{key}"] = val
        return snap

    def close(self) -> None:
        for rung in self._rungs:
            fn = getattr(rung.backend, "close", None)
            if fn is not None:
                fn()
