"""Garbage-collector tuning for long-running control-plane processes.

The reference's components run on the Go runtime, whose concurrent GC
never stops the world for more than fractions of a millisecond; CPython's
generational cyclic collector, by contrast, stops everything — and with a
million live acyclic objects (stored pods, watch history, informer
indexers) a gen-2 pass costs hundreds of milliseconds and fires often at
default thresholds (700, 10, 10).  At bench scale that was ~35% of
scheduler throughput.

Control-plane state here is overwhelmingly acyclic (dict/list trees freed
by refcounting), so delaying cycle detection is safe: reference cycles
are rare (exception tracebacks, some framework closures) and still get
collected, just less often.

Reference analog: the scheduler's throughput assumptions in
test/integration/scheduler_perf (util.go:288-355) are calibrated against
Go's pauseless collector; this is the CPython-native equivalent knob.
"""

from __future__ import annotations

import gc

_tuned = False


def tune_for_throughput(freeze_startup: bool = True) -> None:
    """Raise collection thresholds for steady-state serving and move
    everything allocated so far into the permanent generation (it is
    module/config state that will never become garbage).

    Idempotent: only the FIRST call freezes/tunes.  Repeated freezing
    (e.g. per-cluster setup inside one pytest process) would move earlier
    clusters' cyclic garbage into the permanent generation where it can
    never be reclaimed."""
    global _tuned
    if _tuned:
        return
    _tuned = True
    if freeze_startup:
        gc.collect()
        gc.freeze()
    gc.set_threshold(200_000, 100, 100)
    # Fewer GIL handoffs: the pipeline runs 5-6 cooperating threads
    # (sched loop, binder, informer, event broadcaster, collector) that
    # each do long CPU bursts; the default 5ms switch interval forces
    # ~40 forced preemptions per batch tail, each costing a futex
    # round-trip plus cache refill.  20ms keeps bursts intact; blocking
    # calls (device waits, condition waits) still release the GIL
    # immediately, so latency-sensitive handoffs are unaffected.
    import sys
    sys.setswitchinterval(0.02)
