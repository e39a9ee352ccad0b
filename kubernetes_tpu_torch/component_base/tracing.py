"""Operation tracing.

Two layers, mirroring the reference:

1. ``Trace`` — utiltrace-style (k8s.io/utils/trace, used by the scheduler
   at schedule_one.go:373: a named operation accumulates steps and is
   logged only if total latency exceeds a threshold).
2. ``TracerProvider``/``Span`` — a minimal OTel-shaped provider
   (component-base/tracing/utils.go:35 NewProvider) with an in-memory
   exporter, so the apiserver WithTracing filter and kubelet CRI wrapping
   (KubeletTracing gate) have a seam.  On TPU the heavyweight profiling
   story is jax.profiler (see ops/backend.py), not OTel; this keeps the
   control-plane contract.

The span layer carries W3C trace context (``traceparent``,
https://www.w3.org/TR/trace-context/) so spans opened on a remote device
worker (ops/remote.py) parent into the scheduler-side batch trace, and
head sampling mirrors TracingConfiguration.SamplingRatePerMillion
(component-base/apis/v1: the KEP-647 stanza): the decision is made once
at the ROOT span and inherited by children/remote spans, so a trace is
never torn.  Exported spans land in a bounded in-memory ring grouped by
trace (the flight recorder served at /debug/traces) and can be dumped as
Chrome trace-event JSON (Perfetto-loadable) via ``to_chrome_trace``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class Trace:
    """utiltrace.Trace: log steps when an operation exceeds a threshold."""

    def __init__(self, name: str, **fields: Any):
        self.name = name
        self.fields = fields
        self.start = time.monotonic()
        self.steps: List[tuple] = []

    def step(self, msg: str, **fields: Any) -> None:
        self.steps.append((time.monotonic(), msg, fields))

    def log_if_long(self, threshold: float) -> bool:
        total = time.monotonic() - self.start
        if total < threshold:
            return False
        parts = ["Trace %r (total %.1fms):" % (self.name, total * 1e3)]
        last = self.start
        for t, msg, fields in self.steps:
            extra = (" " + ",".join("%s=%s" % kv for kv in fields.items())
                     if fields else "")
            parts.append("  step %r +%.1fms%s" % (msg, (t - last) * 1e3, extra))
            last = t
        logger.info("\n".join(parts))
        return True


# -- W3C trace context -----------------------------------------------------

class SpanContext:
    """The propagated identity of a span: what crosses a process boundary.

    Mirrors OTel SpanContext / the W3C traceparent triple: 128-bit trace
    id, 64-bit span id, and the sampled flag (the head-sampling decision
    travels WITH the context so a remote worker never re-samples)."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "SpanContext(%s, %s, sampled=%s)" % (
            self.trace_id, self.span_id, self.sampled)


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(ctx: SpanContext) -> str:
    """``00-<trace-id>-<parent-id>-<flags>`` (trace-context section 3.2)."""
    return "00-%s-%s-%s" % (ctx.trace_id, ctx.span_id,
                            "01" if ctx.sampled else "00")


def parse_traceparent(header: Optional[str]) -> Optional[SpanContext]:
    """Parse a W3C traceparent header; None on anything malformed (an
    unparseable header MUST NOT fail the request — the span is simply
    unparented, per spec section 4)."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if (len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16
            or len(flags) != 2):
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id, sampled=bool(int(flags, 16) & 1))


class Span:
    """One timed operation.  Wall-clock start (time.time()) anchors the
    span on a cross-process timeline (Chrome trace alignment between
    scheduler and worker); the monotonic pair measures duration."""

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"] = None,
                 context: Optional[SpanContext] = None,
                 start: Optional[float] = None):
        self.tracer = tracer
        self.name = name
        self.parent = parent
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_span_id = parent.span_id
            self.sampled: Optional[bool] = parent.sampled
        elif context is not None:  # remote parent (propagated traceparent)
            self.trace_id = context.trace_id
            self.parent_span_id = context.span_id
            self.sampled = context.sampled
        else:
            self.trace_id = new_trace_id()
            self.parent_span_id = None
            # root: head-sampling decision now, inherited by children
            self.sampled = tracer.provider._sample()
        self.span_id = new_span_id()
        self.attributes: Dict[str, Any] = {}
        self.events: List[tuple] = []
        # recording thread, captured at creation: the Chrome export
        # names one tid lane per (process, thread) so Perfetto groups
        # scheduler-loop vs binder-worker vs server threads
        self.thread = threading.current_thread().name
        now = time.monotonic()
        self.start_time = start if start is not None else now
        # wall anchor back-dated by the same monotonic offset
        self.start_wall = time.time() - (now - self.start_time)
        self.end_time: Optional[float] = None

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id,
                           sampled=bool(self.sampled))

    def traceparent(self) -> str:
        return format_traceparent(self.context)

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def add_event(self, name: str, **attrs: Any) -> None:
        self.events.append((time.monotonic(), name, attrs))

    def end(self, end: Optional[float] = None) -> None:
        if self.end_time is None:
            self.end_time = end if end is not None else time.monotonic()
            self.tracer.provider._export(self)

    @property
    def duration(self) -> float:
        return (self.end_time or time.monotonic()) - self.start_time

    def to_dict(self) -> Dict[str, Any]:
        """JSON-friendly view (the /debug/traces wire shape)."""
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "start_unix_s": round(self.start_wall, 6),
            "duration_s": round(self.duration, 6),
            "attributes": dict(self.attributes),
            "events": [{"name": n, "offset_s": round(t - self.start_time, 6),
                        **({"attributes": a} if a else {})}
                       for t, n, a in self.events],
        }

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class Tracer:
    def __init__(self, provider: "TracerProvider", name: str):
        self.provider = provider
        self.name = name

    def start_span(self, name: str, parent: Optional[Span] = None,
                   context: Optional[SpanContext] = None,
                   start: Optional[float] = None) -> Span:
        return Span(self, name, parent=parent, context=context, start=start)


class TracerProvider:
    """In-memory provider; sampling_rate mirrors TracingConfiguration
    SamplingRatePerMillion (0 disables record-keeping but spans still
    function as timers).

    Exported spans feed two bounded stores: ``spans`` (flat, newest
    ``max_spans``) and a per-trace flight-recorder ring (newest
    ``max_traces`` traces, served at /debug/traces)."""

    def __init__(self, sampling_rate_per_million: int = 1_000_000,
                 max_spans: int = 4096, max_traces: int = 256):
        self.sampling_rate_per_million = sampling_rate_per_million
        self.max_spans = max_spans
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self.spans: List[Span] = []
        self._traces: "OrderedDict[str, List[Span]]" = OrderedDict()
        self._counter = 0

    def tracer(self, name: str) -> Tracer:
        return Tracer(self, name)

    def configure(self, sampling_rate_per_million: Optional[int] = None,
                  max_spans: Optional[int] = None,
                  max_traces: Optional[int] = None) -> None:
        """Apply a tracing: config stanza to a live provider (the shared
        default provider is created at import, before config loads)."""
        with self._lock:
            if sampling_rate_per_million is not None:
                self.sampling_rate_per_million = sampling_rate_per_million
            if max_spans is not None:
                self.max_spans = max_spans
            if max_traces is not None:
                self.max_traces = max_traces

    def _sample(self) -> bool:
        """Head-sampling decision for a new root span.

        Counter-proportional: root k is kept exactly when the running
        product k*rate crosses the next multiple of one million, so any
        window of n roots keeps n*rate/1e6 +- 1 of them.  (The previous
        modulo form compared (k*rate) % 1e6 against the rate itself,
        which keeps a fraction unrelated to rate/1e6 for intermediate
        rates — e.g. rate 600_000 kept every root.)"""
        rate = self.sampling_rate_per_million
        if rate >= 1_000_000:
            return True
        if rate <= 0:
            return False
        with self._lock:
            self._counter += 1
            c = self._counter
        return (c * rate) // 1_000_000 > ((c - 1) * rate) // 1_000_000

    def _export(self, span: Span) -> None:
        if span.sampled is None:  # bare Span() never given a decision
            span.sampled = self._sample()
        if not span.sampled:
            return
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.max_spans:
                del self.spans[: len(self.spans) - self.max_spans]
            group = self._traces.get(span.trace_id)
            if group is None:
                group = self._traces[span.trace_id] = []
                while len(self._traces) > self.max_traces:
                    self._traces.popitem(last=False)
            group.append(span)

    def snapshot(self) -> List[Span]:
        with self._lock:
            return list(self.spans)

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self._traces.clear()

    def recent_traces(self, limit: int = 32) -> List[Dict[str, Any]]:
        """Newest `limit` traces from the flight recorder, each a
        {trace_id, spans: [span dicts]} group (the /debug/traces body)."""
        with self._lock:
            groups = list(self._traces.items())[-limit:]
        return [{"trace_id": tid,
                 "spans": [s.to_dict() for s in spans]}
                for tid, spans in reversed(groups)]

    def debug_traces_json(self, limit: int = 32) -> str:
        return json.dumps({"traces": self.recent_traces(limit)}, indent=1)


def chrome_trace_doc(events: List[Dict[str, Any]],
                     process_names: Dict[int, str],
                     thread_names: Dict[tuple, str]) -> Dict[str, Any]:
    """Assemble a Chrome trace-event document from data events plus
    lane names: ``M`` (metadata) records declare every pid as
    ``process_name`` and every (pid, tid) as ``thread_name``, so
    Perfetto groups lanes by component (scheduler child, binder
    worker, device worker) instead of showing bare numeric TIDs.
    Shared by the span export below and timeline.to_chrome_trace."""
    meta: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": name}}
        for pid, name in process_names.items()]
    meta += [
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
         "args": {"name": name}}
        for (pid, tid), name in thread_names.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def to_chrome_trace(spans: List[Span],
                    pid_attr: str = "process") -> Dict[str, Any]:
    """Render spans as Chrome trace-event JSON (Perfetto-loadable).

    Complete ("X") events on microsecond wall timestamps; each process
    (span attribute `pid_attr`, default span.attributes["process"]) gets
    its own pid lane and each recording THREAD its own named tid lane
    (scheduler loop, binder worker, server threads), so parent-child
    spans nest on the thread that ran them and worker-side spans land
    in a second process lane on the same wall clock.  Span events
    become instant ("i") events on the same track."""
    events: List[Dict[str, Any]] = []
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    for s in spans:
        proc = str(s.attributes.get(pid_attr, "scheduler"))
        pid = pids.setdefault(proc, len(pids) + 1)
        thread = getattr(s, "thread", "MainThread")
        tid = tids.setdefault((pid, thread), len(tids) + 1)
        ts_us = s.start_wall * 1e6
        events.append({
            "name": s.name, "ph": "X", "cat": "batch",
            "ts": ts_us, "dur": max(s.duration, 0.0) * 1e6,
            "pid": pid, "tid": tid,
            "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                     "parent_span_id": s.parent_span_id,
                     **{k: v for k, v in s.attributes.items()
                        if k != pid_attr}},
        })
        for t, name, attrs in s.events:
            events.append({
                "name": name, "ph": "i", "cat": "batch", "s": "t",
                "ts": ts_us + (t - s.start_time) * 1e6,
                "pid": pid, "tid": tid,
                "args": dict(attrs),
            })
    return chrome_trace_doc(
        events,
        {pid: name for name, pid in pids.items()},
        {(pid, tid): thr for (pid, thr), tid in tids.items()})


# -- current-span propagation ----------------------------------------------
# The batch pipeline hands the root span from the scheduling loop to the
# batch backend (and its resolve closure) through a thread-local instead
# of widening every dispatch() signature across the backend ladder
# (ops/failover.py wraps backends; ops/remote.py subclasses them).

_current = threading.local()


def current_span() -> Optional[Span]:
    return getattr(_current, "span", None)


class use_span:
    """Context manager installing `span` as the thread's current span
    (restores the previous one on exit; None is allowed and clears it)."""

    def __init__(self, span: Optional[Span]):
        self.span = span
        self._prev: Optional[Span] = None

    def __enter__(self) -> Optional[Span]:
        self._prev = getattr(_current, "span", None)
        _current.span = self.span
        return self.span

    def __exit__(self, *exc) -> None:
        _current.span = self._prev


default_tracer_provider = TracerProvider()
