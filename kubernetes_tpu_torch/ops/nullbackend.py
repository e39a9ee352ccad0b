"""NullBatchBackend — the host pipeline with the device step nulled.

Counterpart of kubernetes_tpu/ops/nullbackend.py, numpy only.

Measurement tool (NOT a production backend): runs the ENTIRE host side
of the batch path — store -> watch -> informer -> queue -> encode ->
assume -> bulk bind — with the device step replaced by an instant
vectorized capacity fill.  Every millisecond on the clock is host work,
which makes this the source for:

  * the host-throughput ceiling (the SchedulingHostNull bench row): the
    pods/s the loop reaches with no device work at all, read beside the
    same workload on the card to split the loop's wall into host and
    device work;
  * profiler runs locating where host µs/pod goes.

It is used only when a caller asks for it by name
(make_batch_backend("null"), the harness's null_device=True); nothing
falls back to it.

Scope: PLAIN pods only (no selectors/affinity/constraints/ports/pins).
Anything else escapes to the per-pod oracle with SKIP — the null
"device" has no constraint solver, and silently placing constraint
pods by capacity alone would produce placements the real kernel would
never emit.  supports_pipelining=False: with an instant device there is
no flight to overlap, and the flush-before-dispatch ordering means each
dispatch's re-encode sees the previous batch's assumed claims (the
sync-path contract in scheduler.BatchBackend).

Reference analog: scheduler_perf's null-kubelet shape (hollow nodes,
test/integration/scheduler_perf/util.go:79) — the harness isolates the
control loop from the execution substrate the same way.
"""

from __future__ import annotations

import threading
import time
from typing import Sequence

import numpy as np

from ..scheduler.batch_backend import BatchBackend
from ..scheduler.types import PodInfo, Status
from .backend import decode_results, record_batch_stats
from .flatten import BatchEncoder, Caps, ClusterTensors, VocabFullError

SKIP_MSG = "null backend: constraint pod -> per-pod oracle"


class FlightDelayBackend:
    """Measurement wrapper (NOT a production backend): pins the device
    flight of every wave to a minimum wall duration.

    ``dispatch`` starts the flight clock; the returned resolve blocks
    (GIL released) until ``flight_s`` has elapsed since dispatch, then
    resolves the inner wave.  This models what a real accelerator is
    from the host's perspective — a step that takes wall time but ~zero
    host CPU — which a CPU-simulated device on a single-core box cannot
    exhibit (host and "device" compete for the same core, so pipeline
    overlap is physically impossible no matter what the scheduler
    does).  `bench.py --pipeline-ab` uses this arm
    (``BENCH_PIPELINE_FLIGHT_MS``) to measure the wave pipeline's
    overlap in isolation from that box artifact: at depth 2 the flight
    of wave N+1 runs concurrently with wave N's resolve wait and the
    host leg forming wave N+2, so steady-state wall per wave drops from
    ``host + flight`` toward ``max(host, flight)``.

    The wait happens INSIDE the wrapped resolve, before the inner
    resolve's device pull, so the backend's own timeline record
    (``device-step``: launch -> results landed) attributes the flight
    to device time — idle-share and overlap metrics read the same as
    they would with a genuinely slow device."""

    def __init__(self, inner, flight_s: float):
        self.inner = inner
        self.flight_s = float(flight_s)

    def dispatch(self, pod_infos, snapshot):
        inner_resolve = self.inner.dispatch(pod_infos, snapshot)
        if not callable(inner_resolve):  # pass-through sentinel / results
            return inner_resolve
        t_dispatch = time.monotonic()

        def resolve():
            remaining = self.flight_s - (time.monotonic() - t_dispatch)
            if remaining > 0:
                time.sleep(remaining)
            return inner_resolve()

        return resolve

    def __getattr__(self, name):
        # warmup/assign/health/prefetch/abandon_wave/stats/tensors/
        # supports_pipelining all forward untouched
        return getattr(self.inner, name)


class NullBatchBackend(BatchBackend):
    supports_pipelining = False

    def __init__(self, caps: Caps | None = None, batch_size: int = 256,
                 weights: dict | None = None, k_cap: int = 1024):
        self.caps = caps or Caps()
        self.batch_size = batch_size
        self.tensors = ClusterTensors(self.caps)
        self.encoder = BatchEncoder(self.tensors, batch_size)
        self._lock = threading.Lock()
        # incremental per-row slot counts (see _assign_vectorized): the
        # null device must cost O(dirty + pods), not O(n_cap), per
        # dispatch, or a full-array capacity recompute per batch would
        # pollute the host measurement this backend exists to take
        self._cap = np.zeros(self.caps.n_cap, np.int64)
        self._cap_maxreq: np.ndarray | None = None
        self._carry_dirty: set[int] = set()
        # epoch fast path (same contract as TorchBatchBackend): when
        # every cache change since the last sync was this backend's own
        # bulk assume/confirm lifecycle, the O(dirty-rows) re-encode is
        # skipped and this backend replays its own placements into the
        # tensors directly (_replay_claims), the dominant steady-state
        # shape
        self._last_epoch: int | None = None
        self._synced = False
        self.stats = {"batches": 0}

    def warmup(self) -> None:
        self.encoder.encode([])

    def prefetch(self, view) -> None:
        """Idle-time tensor sync (same contract as TorchBatchBackend); rows
        synced here must still reach the next dispatch's capacity
        recount, so they carry."""
        with self._lock:
            try:
                self._carry_dirty |= set(
                    self.tensors.update_from_snapshot_tracked(view))
            except VocabFullError:
                pass

    def _recount_rows(self, rows: np.ndarray, maxreq: np.ndarray) -> None:
        """Recompute remaining slot counts for `rows` given the reference
        per-pod claim `maxreq`."""
        t = self.tensors
        remaining = t.alloc[rows] - t.used[rows]
        with np.errstate(divide="ignore", invalid="ignore"):
            per_res = np.where(maxreq > 0, remaining / maxreq, np.inf)
        cap = np.floor(per_res.min(axis=1))
        cap = np.minimum(cap, t.maxpods[rows] - t.npods[rows])
        self._cap[rows] = np.clip(cap, 0, 1 << 40).astype(np.int64)
        self._cap[rows[~t.valid[rows]]] = 0

    def _assign_vectorized(self, batch, n: int,
                           dirty: np.ndarray) -> np.ndarray:
        """Capacity-aware fill, O(dirty rows + pods) per dispatch.

        Per-pod claims use the batch's MAX request per resource (bench
        batches are uniform, where this is exact; mixed batches
        under-pack, never over-pack).  Slot counts live in self._cap,
        recomputed only for rows whose encode changed this dispatch (or
        everywhere when the reference claim changes) and decremented in
        place for this batch's own placements — rows fill lowest-index
        first; placement ORDER is not what this backend measures."""
        t = self.tensors
        assignments = np.full(self.batch_size, -1, np.int64)
        if n == 0:
            return assignments
        maxreq = batch.req[:n].max(axis=0)
        if (self._cap_maxreq is None
                or not np.array_equal(maxreq, self._cap_maxreq)):
            self._cap_maxreq = maxreq
            self._recount_rows(np.nonzero(t.valid)[0], maxreq)
        elif len(dirty):
            self._recount_rows(dirty, maxreq)
        rows = np.nonzero(self._cap > 0)[0]
        if not len(rows):
            return assignments
        cap = np.minimum(self._cap[rows], n)
        # materialize only the first n slots: at 100k nodes the full
        # repeat would build a ~30M-element array per dispatch for 16k
        # placements
        cum = np.cumsum(cap)
        stop = int(np.searchsorted(cum, n))
        if stop < len(rows):
            cap = cap[:stop + 1].copy()
            cap[stop] -= int(cum[stop]) - n  # partial last row
            rows = rows[:stop + 1]
        slots = np.repeat(rows, cap)
        k = min(len(slots), n)
        assignments[:k] = slots[:k]
        self._cap[rows] -= cap
        return assignments

    def _replay_claims(self, batch, assignments: np.ndarray, n: int) -> None:
        """Apply this batch's placements to the host tensors so the next
        dispatch's epoch skip sees current used/npods without a cache
        re-encode (the cache's authoritative re-encode overwrites these
        rows with identical values whenever an external epoch bump forces
        a real sync)."""
        t = self.tensors
        rows = assignments[:min(n, self.batch_size)]
        placed = np.nonzero(rows >= 0)[0]
        if placed.size == 0:
            return
        prow = rows[placed]
        np.add.at(t.used, prow, batch.req[placed])
        np.add.at(t.used_nz, prow, batch.req_nz[placed])
        np.add.at(t.npods, prow, 1.0)

    def dispatch(self, pod_infos: Sequence[PodInfo], snapshot):
        with self._lock:
            epoch_fn = getattr(snapshot, "epoch", None)
            epoch = epoch_fn() if epoch_fn is not None else None
            skip_sync = (epoch is not None and self._synced
                         and epoch == self._last_epoch
                         and not self._carry_dirty)
            try:
                if skip_sync:
                    dirty = set()
                else:
                    dirty = set(self.tensors.update_from_snapshot_tracked(
                        snapshot))
                    dirty |= self._carry_dirty
                    self._carry_dirty = set()
                    self._last_epoch = epoch
                    self._synced = True
                batch = self.encoder.encode(list(pod_infos))
            except VocabFullError as e:
                from ..scheduler.types import SKIP
                self._synced = False  # partial sync: force a real one next
                results = [(None, Status(SKIP, str(e)))] * len(pod_infos)
                return lambda: results
            n = len(pod_infos)
            # constraint pods escape: the null device has no solver
            is_plain = self.encoder._is_plain
            extra_escapes = {i for i, pi in enumerate(pod_infos[:self.batch_size])
                             if not is_plain(pi)}
            assignments = self._assign_vectorized(
                batch, n, np.fromiter(dirty, np.int64, len(dirty)))
            if extra_escapes:
                assignments[list(extra_escapes)] = -1
            self._replay_claims(batch, assignments, n)
            row_names = list(self.tensors.row_names)
            self.stats["batches"] += 1
            self.stats["epoch_skips"] = self.stats.get(
                "epoch_skips", 0) + (1 if skip_sync else 0)
        escapes = set(batch.escape) | extra_escapes

        def resolve():
            out = decode_results(assignments, n, self.batch_size, escapes,
                                 row_names, "no feasible node (null backend)",
                                 nofit_escapes=set(batch.nofit_oracle))
            record_batch_stats(self.stats, self._lock, out, n)
            return out

        return resolve
