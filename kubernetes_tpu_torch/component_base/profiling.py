"""Continuous performance observatory: census core, host profiler, SLO
burn-rate tracker, and cross-process metrics federation.

The paper's success criteria (>=50k pods/s at p99 < 10ms, collective
bytes/wave cut >=4x under sharding) were, until this layer, verified by
one-off scripts (tools/collective_census.py, tools/profile_host.py)
whose output was hand-pasted into SCALING.md / LATENCY.md.  This module
turns each of those quantities into something the running system
observes about itself:

  * HLO collective census — a pure-regex walk over compiled-step HLO
    (no jax dependency at module level) counting every ICI collective
    with its tensor bytes and whether it sits inside the wave loop.
    Backends run it against their own lowered step functions at
    warmup/census time (`device_census()`); tools/collective_census.py
    is a thin CLI over the same code, so the committed
    `tpu_wave_collective_bytes` gauges and the offline tool agree
    bit-for-bit by construction.
  * HostProfiler — the sys._current_frames() sampling profiler lifted
    out of tools/profile_host.py into a bounded start/stop service with
    per-pipeline-stage host-time attribution
    (informer/submitter/resolver/binder) and collapsed-stacks output
    for the /debug/profile endpoints.
  * SLOTracker — rolling-window p50/p95/p99 scheduling latency against
    the 10 ms target with multi-window burn rates (SRE-style): the
    arm/disarm signal the adaptive overload-engagement path consumes.
  * Federation — aggregate per-instance metrics snapshots (structured
    Registry.gather() dicts or /metrics Prometheus text) into
    fleet-wide series for scale-out phase 2.

Everything here is off by default and wired up only through the
`profiling:` config stanza (scheduler/config.py) — an unconfigured
scheduler pays nothing.

This copy leaves out the functions that read jax objects (the virtual
CPU mesh bootstrap, compiled_cost, census_lowered): the device census
on the GPU is TorchBatchBackend.device_census (ops/backend.py), built
from the profiler and the kernels' own counts.  The HLO-text census core
stays.

Reference: staging/src/k8s.io/component-base/metrics (the stability-
levelled registry all of this exports through) and
pkg/scheduler/metrics/metrics.go:58 (the latency histograms whose 10 ms
SLO boundary the tracker mirrors); the /debug/profile endpoint follows
the net/http/pprof convention of serving profiler state next to
/metrics.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time
from collections import Counter as _Counter
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# HLO collective census core (jax-free: operates on HLO text)
# ---------------------------------------------------------------------------

DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
               "pred": 1, "s8": 1, "u8": 1, "f64": 8, "s64": 8, "u64": 8}

# The async `-start` forms (all-gather-start, reduce-scatter-start, ...)
# carry a (operand, result) tuple type; the matching `-done` ops are
# deliberately NOT matched so an async pair counts once.
COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*"
    r"(.*?)\s*"
    r"(all-gather|all-reduce|reduce-scatter|collective-permute|"
    r"all-to-all)(-start)?\(", re.M)
SHAPE_RE = re.compile(r"(f32|s32|u32|bf16|f16|pred|s8|u8|f64|s64|u64)"
                      r"\[([\d,]*)\]")

_COMP_HEADER_RE = re.compile(r"^(?:ENTRY\s+)?%([\w.\-]+)\s*\(")
_CALL_RE = re.compile(r"(?:calls|to_apply|body|condition)=%?([\w.\-]+)")


def shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in SHAPE_RE.findall(type_str):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def census_from_hlo(hlo: str) -> dict:
    """Count every collective in an optimized-HLO module with its tensor
    bytes; collectives reachable from a while body run once PER WAVE.

    Returns {"collectives": {key: {op, count, bytes, per_wave}},
    "per_call_bytes": ..., "per_wave_bytes": ...} — the exact record
    tools/collective_census.py has always emitted (it now delegates
    here), so gauges derived from this match the tool bit-for-bit."""
    # split module into computations; while-loop bodies are separate
    # computations whose callers are while ops
    comps: dict[str, str] = {}
    cur = None
    for line in hlo.splitlines():
        # computation headers: "%name (params...) -> type {" — params may
        # contain nested parens (tuple types), so match only the prefix
        m = _COMP_HEADER_RE.match(line)
        if m and line.rstrip().endswith("{"):
            cur = m.group(1)
            comps[cur] = ""
        elif cur is not None:
            comps[cur] += line + "\n"
    while_bodies = set(re.findall(r"body=%?([\w.\-]+)", hlo))
    # transitively include computations called from while bodies
    frontier = set(while_bodies)
    in_loop: set[str] = set()
    while frontier:
        nxt = set()
        for name in frontier:
            if name in in_loop:
                continue
            in_loop.add(name)
            nxt |= set(_CALL_RE.findall(comps.get(name, "")))
        frontier = nxt - in_loop

    out: dict[str, dict] = {}
    for comp, body in comps.items():
        for m in COLLECTIVE_RE.finditer(body):
            out_type, op, started = m.group(1), m.group(2), m.group(3)
            if started:
                # async start: the tuple type is (operand, result); the
                # bytes moved are the result element (the last shape)
                shapes = SHAPE_RE.findall(out_type)
                b = 0
                if shapes:
                    dt, dims = shapes[-1]
                    n = 1
                    for d in dims.split(","):
                        if d:
                            n *= int(d)
                    b = n * DTYPE_BYTES[dt]
            else:
                b = shape_bytes(out_type)
            key = f"{op} {out_type.strip()}"
            rec = out.setdefault(key, {"op": op, "count": 0, "bytes": b,
                                       "per_wave": False})
            rec["count"] += 1
            if comp in in_loop:
                rec["per_wave"] = True
    return {"collectives": out,
            "per_call_bytes": sum(r["bytes"] * r["count"]
                                  for r in out.values()
                                  if not r["per_wave"]),
            "per_wave_bytes": sum(r["bytes"] * r["count"]
                                  for r in out.values() if r["per_wave"])}


def collective_bytes_by_op(rec: dict) -> tuple[dict, dict]:
    """Aggregate a census record into {op: bytes} sums for the per-wave
    and per-call collectives — the exact values the
    tpu_wave_collective_bytes / tpu_step_collective_bytes gauges carry."""
    per_wave: dict[str, int] = {}
    per_call: dict[str, int] = {}
    for r in rec.get("collectives", {}).values():
        dst = per_wave if r["per_wave"] else per_call
        dst[r["op"]] = dst.get(r["op"], 0) + r["bytes"] * r["count"]
    return per_wave, per_call


# ---------------------------------------------------------------------------
# host sampling profiler (lifted from tools/profile_host.py)
# ---------------------------------------------------------------------------

# thread-name -> pipeline stage.  Binder work happens inside the
# submitter/resolver threads, so it is carved out by frame (see
# _BINDER_FRAMES) before the thread mapping applies.
_STAGE_PATTERNS: tuple[tuple[str, str], ...] = (
    ("informer-", "informer"),
    ("bind", "binder"),          # ThreadPoolExecutor(thread_name_prefix="bind")
    ("sched-loop", "submitter"),
    ("wave-resolve", "resolver"),
    ("queue-flush", "queue"),
    ("apiserver", "apiserver"),
    ("tpu-worker", "device_worker"),
    ("MainThread", "main"),
)
_BINDER_FRAMES = frozenset({"_bulk_bind_commit", "_store_bind",
                            "bind_many", "_finish_batch",
                            # PR 13 decoupled binder: the _BinderWorker
                            # drain loop and its commit variants run on
                            # "binder<N>" threads, but a sample caught in
                            # a shared helper (binding_rows builds the
                            # wire rows, wait_on_permit blocks on the
                            # flow-control gate) must still attribute to
                            # binder work whatever thread it lands on
                            "_binding_cycle_turbo", "_binding_cycle_bulk",
                            "wait_on_permit", "binding_rows"})
# incremental flatten: the two halves of host-side tensor maintenance,
# carved out by frame like binder work.  Patch frames are checked FIRST —
# patch_node calls _encode_node, and an event patch should attribute to
# snapshot.patch even when the sample lands inside the shared encoder.
_PATCH_FRAMES = frozenset({"note_node_event", "patch_node", "patch_remove",
                           "compact", "_maybe_compact", "run_locked_node",
                           # PR 15 event-driven row maintenance: group-row
                           # release/probe and the namespace-mask row
                           # rewrite run only on the patch path
                           "_release_row", "_probe_bucket",
                           "_ns_mask_row_update"})
_FLATTEN_FRAMES = frozenset({"update_from_snapshot_tracked",
                             "_update_from_dirty", "_update_from_nodes_tracked",
                             "_sync_rows", "_encode_node",
                             "_encode_dynamic_bulk", "_encode_fresh_bulk",
                             # group registration also runs under
                             # patch_node, where the patch-first check
                             # order attributes it to snapshot.patch
                             "register_sg", "register_asg"})


def classify_stage(thread_name: str, co_names: Iterable[str]) -> str:
    """Map one sample (thread name + frame co_names, leaf first) onto a
    pipeline stage for scheduler_host_stage_seconds{stage}."""
    names = tuple(co_names)
    for co in names:
        if co in _BINDER_FRAMES:
            return "binder"
    for co in names:
        if co in _PATCH_FRAMES:
            return "snapshot.patch"
    for co in names:
        if co in _FLATTEN_FRAMES:
            return "snapshot.flatten"
    for prefix, stage in _STAGE_PATTERNS:
        if thread_name.startswith(prefix):
            return stage
    return "other"


def thread_cpu_seconds() -> dict:
    """Per-thread CPU seconds from /proc/self/task (utime+stime)."""
    out: dict[str, float] = {}
    base = "/proc/self/task"
    try:
        tids = os.listdir(base)
    except OSError:  # pragma: no cover - non-Linux
        return out
    for tid in tids:
        try:
            with open(f"{base}/{tid}/stat") as f:
                parts = f.read().rsplit(")", 1)[1].split()
            with open(f"{base}/{tid}/comm") as f:
                comm = f.read().strip()
            tick = os.sysconf("SC_CLK_TCK")
            out[f"{comm}-{tid}"] = round(
                (int(parts[11]) + int(parts[12])) / tick, 2)
        except (OSError, IndexError, ValueError):
            pass
    return out


class HostProfiler:
    """Always-on-capable sampling profiler over every Python thread.

    Python 3.12's cProfile holds the single global sys.monitoring slot,
    so per-thread deterministic profiling is impossible; this samples
    sys._current_frames() at ~200 Hz instead (low overhead, all
    threads, like py-spy).  Bounded: at most `max_stacks` distinct
    collapsed-stack keys are retained (overflow folds into a per-thread
    `<other>` bucket), so an arbitrarily long run holds constant memory.

    start()/stop() are idempotent; stop() joins the sampler thread so a
    stopped profiler leaves nothing running (pinned by
    tests/test_profiling.py)."""

    THREAD_NAME = "prof-sampler"

    def __init__(self, interval: float = 0.005, max_stacks: int = 512,
                 max_depth: int = 6):
        self.interval = interval
        self.max_stacks = max_stacks
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._stacks: _Counter = _Counter()        # collapsed line -> samples
        self._stage_samples: _Counter = _Counter()  # stage -> samples
        self._stage_drained: dict[str, int] = {}    # stage -> samples drained
        self._samples_total = 0

    # -- lifecycle -------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        with self._lock:
            if self.running:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name=self.THREAD_NAME, daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 1.0) -> bool:
        """Stop and join the sampler; returns True once the thread is
        gone."""
        with self._lock:
            t = self._thread
            self._stop.set()
        if t is not None:
            t.join(timeout)
            if t.is_alive():  # pragma: no cover - join timeout
                return False
        with self._lock:
            self._thread = None
        return True

    # -- sampling --------------------------------------------------------

    def _run(self) -> None:
        names: dict[int, str] = {}
        while not self._stop.is_set():
            for t in threading.enumerate():
                names[t.ident] = t.name
            self._sample_once(sys._current_frames(), names)
            time.sleep(self.interval)

    def _sample_once(self, frames: dict, names: dict) -> None:
        for ident, frame in frames.items():
            name = names.get(ident, str(ident))
            if name == self.THREAD_NAME:
                continue
            leaf = (f"{frame.f_code.co_name} "
                    f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}"
                    f":{frame.f_lineno}")
            # full co_name walk for stage classification (binder frames
            # can sit well above the leaf); repo-only frames, capped at
            # max_depth, for the collapsed stack
            parts: list[str] = []
            co_names: list[str] = []
            f = frame
            while f is not None:
                fn = f.f_code.co_filename
                co_names.append(f.f_code.co_name)
                if len(parts) < self.max_depth and (
                        "kubernetes_tpu" in fn or fn.endswith("bench.py")):
                    parts.append(f"{f.f_code.co_name}@{fn.rsplit('/', 1)[-1]}")
                f = f.f_back
            stage = classify_stage(name, co_names)
            # collapsed-stacks convention: root first, leaf last
            stack = ";".join([name] + list(reversed(parts))) if parts \
                else f"{name};{leaf.replace(' ', ':')}"
            with self._lock:
                self._samples_total += 1
                self._stage_samples[stage] += 1
                if stack in self._stacks or len(self._stacks) < self.max_stacks:
                    self._stacks[stack] += 1
                else:
                    self._stacks[f"{name};<other>"] += 1

    # -- views -----------------------------------------------------------

    def collapsed(self) -> str:
        """Collapsed-stacks text (Brendan Gregg format): one
        `frame;frame;...;frame count` line per distinct stack — the
        /debug/profile payload, flamegraph.pl-compatible."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{stack} {n}" for stack, n in items) + (
            "\n" if items else "")

    def top_stacks(self, n: int = 5) -> list[tuple[str, int]]:
        with self._lock:
            return _Counter(self._stacks).most_common(n)

    def stage_seconds(self) -> dict[str, float]:
        """Cumulative per-stage host seconds (samples x interval)."""
        with self._lock:
            return {s: c * self.interval
                    for s, c in self._stage_samples.items()}

    def drain_stage_seconds(self) -> dict[str, float]:
        """Per-stage host-second DELTAS since the previous drain — the
        inc-only feed for the scheduler_host_stage_seconds counter (same
        drain discipline as the escape/shed tallies)."""
        out: dict[str, float] = {}
        with self._lock:
            for stage, c in self._stage_samples.items():
                d = c - self._stage_drained.get(stage, 0)
                if d > 0:
                    out[stage] = d * self.interval
                    self._stage_drained[stage] = c
        return out

    def samples_total(self) -> int:
        with self._lock:
            return self._samples_total

    def reset(self) -> None:
        with self._lock:
            self._stacks.clear()
            self._stage_samples.clear()
            self._stage_drained.clear()
            self._samples_total = 0


# The process-wide profiler behind /debug/profile on the apiserver and
# the device worker (tracing.default_tracer_provider analogue).
# Constructed idle; only the profiling: config stanza starts it.
default_host_profiler = HostProfiler()


# ---------------------------------------------------------------------------
# SLO tracker: rolling-window latency quantiles + multi-window burn rates
# ---------------------------------------------------------------------------


class SLOTracker:
    """Rolling-window scheduling-latency SLO accounting.

    Tracks submit->bind latencies against `target_ms` (the paper's
    10 ms p99 target) over multiple lookback windows and reports
    SRE-style burn rates: (fraction of observations over target) /
    (1 - objective).  A burn rate of 1.0 means the error budget is
    being consumed exactly at the sustainable rate; the multi-window
    AND (short window burning fast while a longer window confirms) is
    the standard page/arm signal and is exactly the engagement input
    the adaptive overload path needs."""

    def __init__(self, target_ms: float = 10.0, objective: float = 0.99,
                 windows: Sequence[float] = (60.0, 300.0, 3600.0),
                 max_samples: int = 16384, time_fn=time.monotonic):
        if not 0.0 < objective < 1.0:
            raise ValueError("objective must be in (0,1)")
        self.target_s = target_ms / 1000.0
        self.objective = objective
        self.windows = tuple(sorted(windows))
        self.max_samples = max_samples
        self._time = time_fn
        self._lock = threading.Lock()
        self._samples: deque[tuple[float, float]] = deque()  # (t, latency_s)

    def observe(self, latencies_s: Iterable[float],
                now: float | None = None) -> None:
        now = self._time() if now is None else now
        horizon = now - self.windows[-1]
        with self._lock:
            for lat in latencies_s:
                self._samples.append((now, lat))
            while self._samples and (self._samples[0][0] < horizon
                                     or len(self._samples) > self.max_samples):
                self._samples.popleft()

    def _window_samples(self, window: float | None,
                        now: float) -> list[float]:
        with self._lock:
            if window is None:
                return [lat for _, lat in self._samples]
            cutoff = now - window
            return [lat for t, lat in self._samples if t >= cutoff]

    def quantiles(self, window: float | None = None,
                  now: float | None = None) -> dict:
        """{"count", "p50_ms", "p95_ms", "p99_ms"} over the window (or
        the whole retained horizon)."""
        now = self._time() if now is None else now
        lats = sorted(self._window_samples(window, now))
        if not lats:
            return {"count": 0, "p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0}

        def pct(q: float) -> float:
            i = min(len(lats) - 1, int(q * len(lats)))
            return lats[i] * 1000.0

        return {"count": len(lats), "p50_ms": pct(0.50),
                "p95_ms": pct(0.95), "p99_ms": pct(0.99)}

    def burn_rates(self, now: float | None = None) -> dict[str, float]:
        """{window_label: burn_rate}; labels are e.g. '60s', '3600s'."""
        now = self._time() if now is None else now
        budget = 1.0 - self.objective
        out: dict[str, float] = {}
        for w in self.windows:
            lats = self._window_samples(w, now)
            if not lats:
                out[f"{int(w)}s"] = 0.0
                continue
            over = sum(1 for lat in lats if lat > self.target_s)
            out[f"{int(w)}s"] = (over / len(lats)) / budget
        return out

    def breached(self, now: float | None = None) -> bool:
        """Multi-window arm signal: the two shortest windows BOTH burning
        faster than budget (fast burn confirmed by the slower window —
        a transient spike on the short window alone does not arm)."""
        rates = self.burn_rates(now)
        keys = [f"{int(w)}s" for w in self.windows[:2]]
        return all(rates.get(k, 0.0) > 1.0 for k in keys)


# ---------------------------------------------------------------------------
# cross-process metrics federation
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'[a-zA-Z_][a-zA-Z0-9_]*="((?:[^"\\]|\\.)*)"')


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def parse_prometheus_text(text: str) -> Dict[str, Dict[Tuple[str, ...], float]]:
    """Parse /metrics exposition text into the same structured shape
    Registry.gather() returns for counters/gauges ({name: {label_values:
    value}}).  Histogram series surface as their _bucket/_sum/_count
    sample names (cumulative), which federate correctly by summation."""
    out: Dict[str, Dict[Tuple[str, ...], float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels, raw = m.groups()
        try:
            value = float(raw)
        except ValueError:
            continue
        key = tuple(_unescape(v) for v in _LABEL_RE.findall(labels or ""))
        out.setdefault(name, {})[key] = value
    return out


def federate(snapshots: Iterable[Dict[str, Dict[Tuple[str, ...], Any]]]
             ) -> Dict[str, Dict[Tuple[str, ...], Any]]:
    """Merge per-instance metric snapshots (Registry.gather() dicts or
    parse_prometheus_text() results) into one fleet-wide view: counters
    and gauges sum per label series; histogram (count, sum) pairs sum
    elementwise.  An instance that died mid-window simply contributes
    its last snapshot — counters are monotone per instance, so the
    federated total never goes backwards as long as callers snapshot
    before discarding an instance (bench.py run_scaleout does)."""
    out: Dict[str, Dict[Tuple[str, ...], Any]] = {}
    for snap in snapshots:
        for name, series in snap.items():
            dst = out.setdefault(name, {})
            for key, val in series.items():
                if isinstance(val, tuple):
                    c, s = dst.get(key, (0, 0.0))
                    dst[key] = (c + val[0], s + val[1])
                else:
                    dst[key] = dst.get(key, 0.0) + val
    return out


def federate_texts(texts: Iterable[str]
                   ) -> Dict[str, Dict[Tuple[str, ...], float]]:
    """Federation over raw per-instance /metrics exposition bodies — the
    true cross-process path (scale-out phase 2: one HTTP pull per
    instance, one merged view)."""
    return federate(parse_prometheus_text(t) for t in texts)
