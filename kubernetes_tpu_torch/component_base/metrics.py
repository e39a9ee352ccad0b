"""Prometheus-style metrics with Kubernetes stability levels.

Reference: staging/src/k8s.io/component-base/metrics — kube wraps
prometheus/client_golang with metric *stability levels* (ALPHA/STABLE),
deprecation versions (metric hidden after N+3 releases), and a shared
registry every binary exposes at /metrics.  This module reproduces that
contract: Counter/Gauge/Histogram (+ *Vec labeled variants), a Registry
with text exposition in the Prometheus format, stability/deprecation
metadata, and the exponential-bucket helper the scheduler histograms use
(pkg/scheduler/metrics/metrics.go:58 ExponentialBuckets(0.001, 2, 15)).

Thread-safe; hot-path observe() is a dict update under a per-metric lock.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

ALPHA = "ALPHA"
BETA = "BETA"
STABLE = "STABLE"


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    return [start * factor ** i for i in range(count)]


def linear_buckets(start: float, width: float, count: int) -> List[float]:
    return [start + width * i for i in range(count)]


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    # exposition format escapes backslash, double-quote AND newline in
    # label values (a raw newline would split the sample line in two)
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for n, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class _Metric:
    """Base: name/help/stability/deprecation + label schema."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 stability: str = ALPHA,
                 deprecated_version: Optional[str] = None):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self.stability = stability
        self.deprecated_version = deprecated_version
        self.hidden = False  # deprecated metrics can be hidden, not dropped
        self._lock = threading.Lock()

    def _header(self) -> List[str]:
        help_text = self.help
        if self.deprecated_version:
            help_text = ("(Deprecated since %s) " % self.deprecated_version
                         ) + help_text
        return ["# HELP %s [%s] %s" % (self.name, self.stability, help_text),
                "# TYPE %s %s" % (self.name, self.kind)]

    def collect(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, *label_values: str) -> None:
        if amount < 0:
            raise ValueError("counter cannot decrease")
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def labels(self, *label_values: str) -> "_BoundCounter":
        return _BoundCounter(self, tuple(str(v) for v in label_values))

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def values(self) -> Dict[Tuple[str, ...], float]:
        """Point-in-time snapshot of every label series (Registry.gather)."""
        with self._lock:
            return dict(self._values)

    def collect(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self._header()
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append("%s%s %s" % (self.name,
                                    _fmt_labels(self.label_names, key),
                                    _fmt_value(v)))
        return out


class _BoundCounter:
    __slots__ = ("_c", "_key")

    def __init__(self, c: Counter, key: Tuple[str, ...]):
        self._c, self._key = c, key

    def inc(self, amount: float = 1.0) -> None:
        self._c.inc(amount, *self._key)


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[tuple(str(v) for v in label_values)] = float(value)

    def inc(self, amount: float = 1.0, *label_values: str) -> None:
        key = tuple(str(v) for v in label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, *label_values: str) -> None:
        self.inc(-amount, *label_values)

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in label_values), 0.0)

    def values(self) -> Dict[Tuple[str, ...], float]:
        """Point-in-time snapshot of every label series (Registry.gather)."""
        with self._lock:
            return dict(self._values)

    def collect(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        out = self._header()
        if not items and not self.label_names:
            items = [((), 0.0)]
        for key, v in items:
            out.append("%s%s %s" % (self.name,
                                    _fmt_labels(self.label_names, key),
                                    _fmt_value(v)))
        return out


class Histogram(_Metric):
    kind = "histogram"

    DEFAULT_BUCKETS = exponential_buckets(0.001, 2, 15)

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 buckets: Optional[Iterable[float]] = None, **kw):
        super().__init__(name, help, labels, **kw)
        self.buckets = sorted(buckets if buckets is not None
                              else self.DEFAULT_BUCKETS)
        # per label-key: mutable [per-bucket counts (NON-cumulative), sum, n].
        # observe() is on the per-pod scheduling path, so it does one bisect
        # + one increment; the cumulative form Prometheus exposes is computed
        # at collect/quantile time instead.
        self._series: Dict[Tuple[str, ...], List[Any]] = {}

    def observe(self, value: float, *label_values: str) -> None:
        for v in label_values:
            if type(v) is not str:
                label_values = tuple(str(x) for x in label_values)
                break
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(label_values)
            if s is None:
                s = self._series[label_values] = [[0] * len(self.buckets), 0.0, 0]
            if i < len(self.buckets):
                s[0][i] += 1
            s[1] += value
            s[2] += 1

    def observe_many(self, values: Sequence[float], *label_values: str) -> None:
        """Bulk observe under one lock (batch scheduling tail)."""
        if not values:
            return
        for v in label_values:
            if type(v) is not str:
                label_values = tuple(str(x) for x in label_values)
                break
        nb = len(self.buckets)
        with self._lock:
            s = self._series.get(label_values)
            if s is None:
                s = self._series[label_values] = [[0] * nb, 0.0, 0]
            counts = s[0]
            for value in values:
                i = bisect.bisect_left(self.buckets, value)
                if i < nb:
                    counts[i] += 1
            s[1] += sum(values)
            s[2] += len(values)

    def observe_array(self, values, *label_values: str) -> None:
        """Vectorized observe_many for numpy arrays (the timeline's
        per-pod decomposition feeds thousands of samples per wave; a
        per-value bisect there is the difference between a ≤5% and a
        ~15% armed-recording overhead).  Plain sequences fall through
        to observe_many."""
        try:
            import numpy as np
        except ImportError:
            self.observe_many(list(values), *label_values)
            return
        arr = np.asarray(values, dtype=float)
        if arr.size == 0:
            return
        for v in label_values:
            if type(v) is not str:
                label_values = tuple(str(x) for x in label_values)
                break
        nb = len(self.buckets)
        # side="left" matches observe_many's bisect_left exactly
        idx = np.searchsorted(self.buckets, arr, side="left")
        binc = np.bincount(idx[idx < nb], minlength=nb)
        total = float(arr.sum())
        with self._lock:
            s = self._series.get(label_values)
            if s is None:
                s = self._series[label_values] = [[0] * nb, 0.0, 0]
            counts = s[0]
            for j in binc.nonzero()[0]:
                counts[j] += int(binc[j])
            s[1] += total
            s[2] += int(arr.size)

    def labels(self, *label_values: str) -> "_BoundHistogram":
        return _BoundHistogram(self, tuple(str(v) for v in label_values))

    def count(self, *label_values: str) -> int:
        with self._lock:
            s = self._series.get(tuple(str(v) for v in label_values))
            return s[2] if s else 0

    def sum(self, *label_values: str) -> float:
        with self._lock:
            s = self._series.get(tuple(str(v) for v in label_values))
            return s[1] if s else 0.0

    def values(self) -> Dict[Tuple[str, ...], Tuple[int, float]]:
        """Point-in-time {labels: (count, sum)} snapshot (Registry.gather)."""
        with self._lock:
            return {k: (s[2], s[1]) for k, s in self._series.items()}

    def quantile(self, q: float, *label_values: str) -> float:
        """Approximate quantile from bucket upper bounds (for tests/latency
        reporting; Prometheus computes this server-side)."""
        with self._lock:
            s = self._series.get(tuple(str(v) for v in label_values))
            if not s or s[2] == 0:
                return 0.0
            counts, _, n = list(s[0]), s[1], s[2]
        target = q * n
        cum = 0
        for i, ub in enumerate(self.buckets):
            cum += counts[i]
            if cum >= target:
                return ub
        return float("inf")

    def collect(self) -> List[str]:
        with self._lock:
            items = sorted((k, (list(c), t, n))
                           for k, (c, t, n) in self._series.items())
        out = self._header()
        for key, (counts, total, n) in items:
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                out.append("%s_bucket%s %d" % (
                    self.name,
                    _fmt_labels(self.label_names + ("le",),
                                key + (_fmt_value(ub),)), cum))
            out.append("%s_bucket%s %d" % (
                self.name,
                _fmt_labels(self.label_names + ("le",), key + ("+Inf",)), n))
            out.append("%s_sum%s %s" % (
                self.name, _fmt_labels(self.label_names, key),
                _fmt_value(total)))
            out.append("%s_count%s %d" % (
                self.name, _fmt_labels(self.label_names, key), n))
        return out


class _BoundHistogram:
    __slots__ = ("_h", "_key")

    def __init__(self, h: Histogram, key: Tuple[str, ...]):
        self._h, self._key = h, key

    def observe(self, value: float) -> None:
        self._h.observe(value, *self._key)


class Registry:
    """A metrics registry; every binary holds one and serves it at /metrics.

    Mirrors component-base/metrics KubeRegistry: duplicate registration is
    an error; hidden (deprecated-past-window) metrics are skipped in
    exposition but keep accepting writes.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError("metric %r already registered" % metric.name)
            self._metrics[metric.name] = metric
        return metric

    def must_register(self, *metrics: _Metric) -> None:
        for m in metrics:
            self.register(m)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def expose(self) -> str:
        """Prometheus text exposition format."""
        with self._lock:
            metrics = [m for _, m in sorted(self._metrics.items())]
        lines: List[str] = []
        for m in metrics:
            if m.hidden:
                continue
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"

    def gather(self) -> Dict[str, Dict[Tuple[str, ...], Any]]:
        """Structured snapshot: {metric_name: {label_key: value}} — counters
        and gauges yield floats, histograms (count, sum) pairs.  The
        programmatic twin of expose(), for tests and the seam dashboards
        (no text-format parsing)."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Dict[Tuple[str, ...], Any]] = {}
        for m in metrics:
            values = getattr(m, "values", None)
            if values is not None:
                out[m.name] = values()
        return out


# The default registry, shared across one process (legacyregistry analogue).
default_registry = Registry()


def new_counter(name, help="", labels=(), registry=None, **kw) -> Counter:
    return (registry or default_registry).register(
        Counter(name, help, labels, **kw))  # type: ignore[return-value]


def new_gauge(name, help="", labels=(), registry=None, **kw) -> Gauge:
    return (registry or default_registry).register(
        Gauge(name, help, labels, **kw))  # type: ignore[return-value]


def new_histogram(name, help="", labels=(), buckets=None,
                  registry=None, **kw) -> Histogram:
    return (registry or default_registry).register(
        Histogram(name, help, labels, buckets, **kw))  # type: ignore[return-value]
