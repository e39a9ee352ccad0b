"""Wave timeline: overlap-aware stage intervals for the batch pipeline.

Reference: staging/src/k8s.io/component-base/tracing (the span layer
this rides next to) and the scheduler's utiltrace usage at
pkg/scheduler/schedule_one.go — but where utiltrace logs slow-path
step durations, this module keeps interval SETS, because the quantity
the paper's pipelining argument needs (device idle share) is a union
measure no per-step duration sum can express.

The PR 8 observatory samples stacks and sums per-stage seconds — a
*duration* view that cannot distinguish "device busy 40% of the wall
clock" from "device busy 40% of the time the host happened to also be
busy".  This module records every pipeline stage as an INTERVAL
``(wave_id, stage, t_start, t_end, thread)`` in a bounded per-process
ring, so the committed metrics are computed from interval set algebra:

- ``scheduler_wave_device_idle_share`` — the wall-clock fraction where
  NO device stage (h2d / device-step / d2h) is in flight, computed by
  interval UNION.  ``1 - Σ stage_seconds / wall`` double-counts the
  moment two stages overlap and goes wrong the instant the pipeline
  PR lands; the union form stays correct under depth-N pipelining.
- per-stage overlap ratios — for each stage, the fraction of its own
  busy time during which at least one OTHER stage is also in flight
  (0.0 = fully serial pipeline, → 1.0 = fully overlapped).
- per-pod e2e decomposition — enqueue → dispatch → batch-form →
  device → resolve → bind-commit wall boundaries, telescoped so the
  segment sum equals the measured e2e by construction, plus a watch
  segment stitched in post-hoc from bind-ledger observation times.

Everything is off by default (``profiling.timeline``) and the armed
overhead is pinned ≤5% by a bench A/B (tests/test_timeline.py).

Clock discipline: callers pass ``time.monotonic()`` pairs; the ring
stores wall-anchored seconds (``wall = mono + anchor`` with the anchor
captured once per reset — the same wall-anchoring trick tracing.Span
uses), so intervals from different processes merge by concatenation
once each process anchored its own ring (the PR 2 traceparent offset
handshake gives the remote seam the same property for worker spans).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import tracing

# The eight pipeline stages, in wave order.  Stage names are the
# vocabulary shared by the ring, /debug/timeline, bench rows and the
# README "Wave timeline" section — add here first.
STAGES = ("event-drain", "patch", "batch-form", "h2d",
          "device-step", "d2h", "resolve", "bind-commit")

# Stages during which the device is (or may be) doing work: the idle
# share is 1 - union(these)/wall.  Host-only stages deliberately
# excluded — a host stage overlapping a device stage is the GOAL.
DEVICE_STAGES = frozenset({"h2d", "device-step", "d2h"})

# Per-pod decomposition segments, in telescoped order.  queue+form+
# device+resolve+bind sum to the bind-visible e2e exactly; watch is
# stitched in afterwards from ledger observation timestamps.
POD_SEGMENTS = ("queue", "form", "device", "resolve", "bind", "watch")


def derive_segment_cols(t_enq, t_bind: float, marks) -> Dict[str, Any]:
    """Telescoped per-pod decomposition columns from raw wave inputs.

    ``marks`` is ``(form_start, form_end, device_end, resolve_end)``
    wall seconds (any entry may be None when that stage didn't run).
    Boundaries are clamped monotone non-decreasing into
    ``[t_enq, t_bind]``, so every segment is >= 0 and the segments of
    one pod sum EXACTLY to its bind-visible e2e.  This runs at READ
    time (pods() views, segment summaries) — the bind hot path records
    only the raw block, which is what keeps the armed overhead inside
    the ≤5% pin."""
    f0, f1, dev, res = marks
    try:
        import numpy as np
    except ImportError:
        np = None
    if np is not None:
        t = np.asarray(t_enq, np.float64)
        b_disp = np.minimum(t_bind, np.maximum(t, f0)) \
            if f0 is not None else np.minimum(t_bind, t)
        b_form = np.minimum(t_bind, np.maximum(b_disp, f1)) \
            if f1 is not None else b_disp
        b_dev = np.minimum(t_bind, np.maximum(b_form, dev)) \
            if dev is not None else b_form
        b_res = np.minimum(t_bind, np.maximum(b_dev, res)) \
            if res is not None else b_dev
        return {"queue": (b_disp - t) * 1e3,
                "form": (b_form - b_disp) * 1e3,
                "device": (b_dev - b_form) * 1e3,
                "resolve": (b_res - b_dev) * 1e3,
                "bind": (t_bind - b_res) * 1e3,
                "watch": np.zeros(len(t))}
    cols: Dict[str, Any] = {s: [] for s in POD_SEGMENTS}
    for te in t_enq:
        b_disp = min(t_bind, max(te, f0)) if f0 is not None \
            else min(t_bind, te)
        b_form = min(t_bind, max(b_disp, f1)) if f1 is not None else b_disp
        b_dev = min(t_bind, max(b_form, dev)) if dev is not None else b_form
        b_res = min(t_bind, max(b_dev, res)) if res is not None else b_dev
        cols["queue"].append((b_disp - te) * 1e3)
        cols["form"].append((b_form - b_disp) * 1e3)
        cols["device"].append((b_dev - b_form) * 1e3)
        cols["resolve"].append((b_res - b_dev) * 1e3)
        cols["bind"].append((t_bind - b_res) * 1e3)
        cols["watch"].append(0.0)
    return cols


# -- interval set algebra ---------------------------------------------------


def _merged(pairs: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Sorted, disjoint segments covering the union of ``pairs``."""
    out: List[List[float]] = []
    for t0, t1 in sorted(p for p in pairs if p[1] > p[0]):
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return out


def interval_union(pairs: Iterable[Tuple[float, float]]) -> float:
    """Total measure of the union of ``(t0, t1)`` pairs.  Overlapping
    and nested intervals count once — the whole point."""
    return sum(hi - lo for lo, hi in _merged(pairs))


def _intersect_measure(a: List[List[float]], b: List[List[float]]) -> float:
    """Measure of the intersection of two merged segment lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle_share(intervals: Iterable[Dict[str, Any]],
                      window: Optional[Tuple[float, float]] = None,
                      ) -> Optional[float]:
    """Wall-clock fraction of ``window`` with no device stage in
    flight, by interval union (NOT ``1 - Σ durations / wall``, which
    double-counts overlap and would report negative idle the moment
    h2d for wave N+1 overlaps device-step for wave N).

    ``window`` defaults to the observed extent of ALL intervals (host
    stages included — host-only head/tail time is honestly idle).
    Returns None when there is nothing to measure."""
    rows = list(intervals)
    if window is None:
        if not rows:
            return None
        w0 = min(r["t0_unix_s"] for r in rows)
        w1 = max(r["t1_unix_s"] for r in rows)
    else:
        w0, w1 = window
    span = w1 - w0
    if span <= 0:
        return None
    busy = interval_union(
        (max(r["t0_unix_s"], w0), min(r["t1_unix_s"], w1))
        for r in rows if r["stage"] in DEVICE_STAGES)
    return max(0.0, min(1.0, 1.0 - busy / span))


def overlap_ratios(intervals: Iterable[Dict[str, Any]],
                   ) -> Dict[str, float]:
    """Per stage: the fraction of that stage's OWN union time during
    which at least one interval of any OTHER stage is in flight.
    A fully serial pipeline scores 0.0 everywhere; the double-buffered
    pipeline should drive device-step's ratio toward 1.0."""
    by_stage: Dict[str, List[Tuple[float, float]]] = {}
    for r in intervals:
        by_stage.setdefault(r["stage"], []).append(
            (r["t0_unix_s"], r["t1_unix_s"]))
    out: Dict[str, float] = {}
    for stage, pairs in by_stage.items():
        own = _merged(pairs)
        own_t = sum(hi - lo for lo, hi in own)
        if own_t <= 0:
            out[stage] = 0.0
            continue
        others = _merged(p for s2, ps in by_stage.items()
                         if s2 != stage for p in ps)
        out[stage] = min(1.0, _intersect_measure(own, others) / own_t)
    return out


def stitch_watch_segments(pod_rows: Iterable[Dict[str, Any]],
                          observed_at: Dict[str, float],
                          ) -> List[Dict[str, Any]]:
    """Backfill the ``watch`` segment from external observation times
    (``{pod_key: wall_s}`` — e.g. a WireBindLedger tailing the
    apiserver watch), re-summing e2e so the telescoping invariant
    (segments sum to e2e) survives the stitch."""
    out = []
    for row in pod_rows:
        row = dict(row)
        seg = dict(row["segments_ms"])
        obs = observed_at.get(row["key"])
        t_bind = row.get("t_bind_unix_s")
        if obs is not None and t_bind is not None and obs > t_bind:
            seg["watch"] = (obs - t_bind) * 1e3
        row["segments_ms"] = seg
        row["e2e_ms"] = sum(seg.values())
        out.append(row)
    return out


# -- the recorder -----------------------------------------------------------


class _StageToken:
    """Handle from Timeline.begin(); ends the interval on exit (the
    context-manager form the timeline-stage-paired lint rule checks
    for).  A shared inert instance stands in when recording is off so
    the disabled path allocates nothing."""

    __slots__ = ("tl", "stage_name", "wave", "t0")

    def __init__(self, tl: Optional["Timeline"], stage_name: str,
                 wave: Optional[int], t0: float):
        self.tl = tl
        self.stage_name = stage_name
        self.wave = wave
        self.t0 = t0

    def __enter__(self) -> "_StageToken":
        return self

    def __exit__(self, *exc) -> None:
        if self.tl is not None:
            self.tl.end(self)


_NULL_TOKEN = _StageToken(None, "", None, 0.0)

# Shared inert context manager for call sites whose Timeline may be
# entirely absent (scheduler._tl_stage): entering/exiting is a no-op.
NULL_STAGE = _NULL_TOKEN


class _WaveScope:
    __slots__ = ("tl", "wave", "prev")

    def __init__(self, tl: "Timeline", wave: Optional[int]):
        self.tl = tl
        self.wave = wave

    def __enter__(self) -> "_WaveScope":
        self.prev = getattr(self.tl._tls, "wave", None)
        self.tl._tls.wave = self.wave
        return self

    def __exit__(self, *exc) -> None:
        self.tl._tls.wave = self.prev


class Timeline:
    """Bounded per-process interval ring plus derived views.

    Cheap when disabled: every hot-path call is guarded by one
    attribute read (``if tl.enabled``) and the begin/stage fast paths
    return a shared inert token.  When enabled, a commit is one lock
    acquire, one deque append and one per-wave min/max merge."""

    MAX_WAVE_MARKS = 512

    def __init__(self, ring: int = 4096, pod_ring: int = 4096,
                 enabled: bool = False, proc: str = "scheduler"):
        self.enabled = enabled
        self.proc = proc
        self._ring = ring
        self._pod_ring = pod_ring
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            # wall = mono + anchor; captured once so every interval in
            # this ring shares one consistent clock mapping
            self._anchor = time.time() - time.monotonic()
            self._rows: deque = deque(maxlen=self._ring)
            # per-wave column blocks (keys, wave, t_enq_seq, t_bind,
            # {segment: ms_seq}); bounded by total pod count, evicted
            # block-at-a-time (the bind-commit path appends one block
            # per wave instead of one row per pod)
            self._pods: deque = deque()
            self._pod_n = 0
            self._marks: Dict[Any, Dict[str, List[float]]] = {}

    def configure(self, enabled: Optional[bool] = None,
                  ring: Optional[int] = None,
                  pod_ring: Optional[int] = None,
                  proc: Optional[str] = None) -> None:
        """Apply a profiling: stanza to the live (import-time) default
        instance; resizing re-arms the ring."""
        if proc is not None:
            self.proc = proc
        resize = ((ring is not None and ring != self._ring)
                  or (pod_ring is not None and pod_ring != self._pod_ring))
        if ring is not None:
            self._ring = ring
        if pod_ring is not None:
            self._pod_ring = pod_ring
        if resize:
            self.reset()
        if enabled is not None:
            self.enabled = enabled

    # -- clock --------------------------------------------------------------

    def wall(self, t_mono: float) -> float:
        """Map a time.monotonic() reading onto this ring's wall clock
        (the same anchor every committed interval used)."""
        return t_mono + self._anchor

    # -- recording ----------------------------------------------------------

    def current_wave(self) -> Optional[int]:
        return getattr(self._tls, "wave", None)

    def use_wave(self, wave: Optional[int]) -> _WaveScope:
        """Thread-local current-wave scope (mirrors tracing.use_span):
        backends record intervals against the dispatching wave without
        widening dispatch() signatures across the backend ladder."""
        return _WaveScope(self, wave)

    def begin(self, stage_name: str,
              wave: Optional[int] = None) -> _StageToken:
        if not self.enabled:
            return _NULL_TOKEN
        if wave is None:
            wave = self.current_wave()
        return _StageToken(self, stage_name, wave, time.monotonic())

    def end(self, token: _StageToken) -> None:
        if token.tl is None or not self.enabled:
            return
        self.record(token.stage_name, token.t0, time.monotonic(),
                    wave=token.wave)

    def stage(self, stage_name: str,
              wave: Optional[int] = None) -> _StageToken:
        """``with tl.stage("resolve", wave=cycle):`` — the common form."""
        return self.begin(stage_name, wave=wave)

    def record(self, stage_name: str, t0: float, t1: float,
               wave: Optional[int] = None) -> None:
        """Commit an interval from a time.monotonic() pair.  The
        retroactive form — for intervals whose endpoints live on
        opposite sides of a closure boundary (dispatch vs resolve),
        where a begin token cannot travel."""
        if not self.enabled or t1 < t0:
            return
        if wave is None:
            wave = self.current_wave()
        thread = threading.current_thread().name
        with self._lock:
            w0 = t0 + self._anchor
            w1 = t1 + self._anchor
            self._rows.append((stage_name, wave, w0, w1, thread, self.proc))
            if wave is not None:
                m = self._marks.get(wave)
                if m is None:
                    m = self._marks[wave] = {}
                    while len(self._marks) > self.MAX_WAVE_MARKS:
                        self._marks.pop(next(iter(self._marks)))
                span = m.get(stage_name)
                if span is None:
                    m[stage_name] = [w0, w1]
                else:
                    if w0 < span[0]:
                        span[0] = w0
                    if w1 > span[1]:
                        span[1] = w1

    def ingest(self, rows: Iterable[Dict[str, Any]]) -> int:
        """Merge already-wall-anchored interval dicts from another
        process (remote device worker over the seam, procrun children
        into the supervisor).  Returns the count merged."""
        n = 0
        with self._lock:
            for r in rows:
                self._rows.append((r["stage"], r.get("wave"),
                                   float(r["t0_unix_s"]),
                                   float(r["t1_unix_s"]),
                                   r.get("thread", "?"),
                                   r.get("proc", "?")))
                n += 1
        return n

    def record_pod(self, key: str, segments_ms: Dict[str, float],
                   t_enqueue_wall: float, t_bind_wall: float,
                   wave: Optional[int] = None) -> None:
        self.record_pod_block(
            [key], wave, [t_enqueue_wall], t_bind_wall,
            {s: [float(segments_ms.get(s, 0.0))] for s in POD_SEGMENTS})

    def record_pod_block(self, keys: List[str], wave: Optional[int],
                         t_enq, t_bind_wall: float,
                         seg_cols: Optional[Dict[str, Any]] = None,
                         marks: Optional[Tuple] = None) -> None:
        """Column form of record_pod for the bind-commit hot path: one
        append and one lock round per WAVE, not per pod.  ``t_enq`` and
        each ``seg_cols[segment]`` are sequences (list or numpy array)
        aligned with ``keys``; values are wall seconds / milliseconds.
        Callers on the hot path pass ``marks`` — the raw
        ``(form_start, form_end, device_end, resolve_end)`` wave marks
        — instead of ``seg_cols``; the telescoped decomposition is then
        derived lazily by pods() (derive_segment_cols), so arming adds
        only this append to the bind path.  The ring bound counts pods,
        evicting whole blocks oldest-first (an oversized single block
        keeps its newest ``pod_ring`` rows)."""
        if not self.enabled or not len(keys):
            return
        with self._lock:
            self._pods.append((keys, wave, t_enq, t_bind_wall,
                               seg_cols, marks))
            self._pod_n += len(keys)
            while self._pod_n > self._pod_ring and len(self._pods) > 1:
                old = self._pods.popleft()
                self._pod_n -= len(old[0])
            if self._pod_n > self._pod_ring:
                k, w, te, tb, cols, mk = self._pods[0]
                keep = self._pod_ring
                self._pods[0] = (k[-keep:], w, te[-keep:], tb,
                                 None if cols is None else
                                 {s: c[-keep:] for s, c in cols.items()},
                                 mk)
                self._pod_n = keep

    # -- views --------------------------------------------------------------

    def intervals(self, drain: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            rows = list(self._rows)
            if drain:
                self._rows.clear()
        return [{"stage": s, "wave": w, "t0_unix_s": t0, "t1_unix_s": t1,
                 "thread": thr, "proc": proc}
                for s, w, t0, t1, thr, proc in rows]

    def pods(self, drain: bool = False) -> List[Dict[str, Any]]:
        with self._lock:
            blocks = list(self._pods)
            if drain:
                self._pods.clear()
                self._pod_n = 0
        out: List[Dict[str, Any]] = []
        for keys, wave, t_enq, t_bind, cols, marks in blocks:
            if cols is None:
                cols = derive_segment_cols(t_enq, t_bind,
                                           marks or (None,) * 4)
            colseq = [cols.get(s) for s in POD_SEGMENTS]
            for i, key in enumerate(keys):
                segs = {s: (float(c[i]) if c is not None else 0.0)
                        for s, c in zip(POD_SEGMENTS, colseq)}
                out.append({"key": key, "wave": wave,
                            "t_enqueue_unix_s": float(t_enq[i]),
                            "t_bind_unix_s": float(t_bind),
                            "segments_ms": segs,
                            "e2e_ms": sum(segs.values())})
        return out

    def wave_marks(self, wave: Any) -> Dict[str, Tuple[float, float]]:
        """Per-stage merged (first-start, last-end) wall bounds for one
        wave — the boundary timestamps the pod decomposition telescopes
        between."""
        with self._lock:
            m = self._marks.get(wave) or {}
            return {s: (b[0], b[1]) for s, b in m.items()}

    def snapshot_summary(self, window_s: Optional[float] = None,
                         ) -> Dict[str, Any]:
        rows = self.intervals()
        if window_s is not None and rows:
            w1 = max(r["t1_unix_s"] for r in rows)
            rows = [r for r in rows if r["t1_unix_s"] >= w1 - window_s]
        counts: Dict[str, int] = {}
        for r in rows:
            counts[r["stage"]] = counts.get(r["stage"], 0) + 1
        return {
            "proc": self.proc,
            "intervals": len(rows),
            "stages": counts,
            "device_idle_share": device_idle_share(rows),
            "overlap": overlap_ratios(rows),
        }

    def debug_json(self) -> str:
        """The /debug/timeline body: summary + raw intervals + pod
        decomposition rows (the Chrome form is served separately)."""
        return json.dumps({
            "enabled": self.enabled,
            **self.snapshot_summary(),
            "interval_rows": self.intervals(),
            "pods": self.pods(),
        }, indent=1)

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Perfetto-loadable Chrome trace-event document: one pid lane
        per recording process, one named tid lane per thread (via the
        shared metadata-aware writer, satellite of PR 2)."""
        events: List[Dict[str, Any]] = []
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[int, str], int] = {}
        for r in self.intervals():
            pid = pids.setdefault(r["proc"], len(pids) + 1)
            tid = tids.setdefault((pid, r["thread"]), len(tids) + 1)
            events.append({
                "name": r["stage"], "ph": "X", "cat": "timeline",
                "ts": r["t0_unix_s"] * 1e6,
                "dur": max(r["t1_unix_s"] - r["t0_unix_s"], 0.0) * 1e6,
                "pid": pid, "tid": tid,
                "args": {"wave": r["wave"]},
            })
        return tracing.chrome_trace_doc(
            events,
            {pid: name for name, pid in pids.items()},
            {(pid, tid): thr for (pid, thr), tid in tids.items()})


# process-local: per-process interval ring — each OS process (scheduler
# child, device worker) anchors and fills its own; cross-process views
# merge via ingest()/federation, never via shared memory.
default_timeline = Timeline()
