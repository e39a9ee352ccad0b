"""Batch-path stage-latency collector (diagnostic, env-gated).

KTPU_STAGE_DEBUG=1 turns on per-batch stage timing in the scheduler's
TPU batch path so a paced-latency run can show WHERE pod latency
accrues:

    queue_wait     pod sat in activeQ before its batch dispatched
    dispatch_host  host time inside backend.dispatch (encode + upload)
    pipeline_wait  dispatch call -> resolve begins (host dispatch time
                   plus depth-D pipeline residency; subtract
                   dispatch_host for residency alone)
    resolve_block  host blocked in resolve() (device wait + decode)
    disp_to_bound  dispatch -> binding committed (device + tail)

Zero overhead when disabled: callers guard on `ENABLED` (module constant
read once at import).  The collector keeps bounded reservoirs; summary()
reports count/mean/p50/p99 per stage in milliseconds.

Reference analog: the per-extension-point latency histograms the
scheduler exports (pkg/scheduler/metrics/metrics.go:137-157) — this is
the TPU-batch-path equivalent, split along the pipeline's stage
boundaries instead of plugin extension points.
"""

from __future__ import annotations

import os
import threading

ENABLED = os.environ.get("KTPU_STAGE_DEBUG", "0") not in ("", "0")

_CAP = 4096  # per-stage reservoir bound (newest kept, oldest dropped)
_lock = threading.Lock()
# process-local: latency reservoir; each scheduler process reports
# its own stages, federation happens at the /metrics text layer
_stages: dict[str, list[float]] = {}


def record(stage: str, seconds: float) -> None:
    with _lock:
        vals = _stages.setdefault(stage, [])
        vals.append(seconds)
        if len(vals) > _CAP:
            del vals[: len(vals) - _CAP]


def reset() -> None:
    with _lock:
        _stages.clear()


def summary() -> dict[str, dict[str, float]]:
    """{stage: {count, mean_ms, p50_ms, p99_ms}} over recorded samples."""
    out: dict[str, dict[str, float]] = {}
    with _lock:
        snap = {k: list(v) for k, v in _stages.items()}
    for stage, vals in snap.items():
        if not vals:
            continue
        vals.sort()
        n = len(vals)
        out[stage] = {
            "count": n,
            "mean_ms": round(sum(vals) / n * 1e3, 2),
            "p50_ms": round(vals[n // 2] * 1e3, 2),
            "p99_ms": round(vals[min(n - 1, int(n * 0.99))] * 1e3, 2),
        }
    return out
