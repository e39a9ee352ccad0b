"""Probe of lease renewal under in-process scale-out on the card.

Runs kubernetes_tpu_torch.perf.bench.run_scaleout(N) (1, 2, 4 and N
instances over one MemoryStore, bench.py's sizes unless NODES / PODS /
BATCH are set; DEV names the torch device, CUDA by default) and prints
for each pass what can keep an instance from renewing its lease in time:

  - the store lock, by the function that took it: acquisitions, total
    and longest hold, longest wait; every hold of 0.3 s or more;
  - every lease renewal (from the loop's tick or the renewal thread):
    the longest gaps between two renewals of one instance and the
    longest renewals;
  - a probe thread's lateness waking from a 20 ms sleep (the GIL's
    latency), 0.1 s or more; a faulthandler watchdog writes every
    thread's stack to $PROBE_OUT/stacks.txt (default probe_out/) when the
    probe is 1 s late;
  - garbage collections of 0.05 s or more (start, generation, seconds);
  - membership changes and tensorization overflows (a batch sent to the
    per-pod path).

    python3 scaleout_probe.py 4 > probe.log

Times are seconds from the start of the pass.  The instrumented lock
adds a frame read and two clock reads to every store operation.
"""
import collections
import faulthandler
import gc
import logging
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from kubernetes_tpu_torch.perf import bench  # noqa: E402
from kubernetes_tpu_torch.scheduler.scaleout import (  # noqa: E402
    ScaleOutCoordinator,
)
from kubernetes_tpu_torch.store import kv  # noqa: E402

OUT = os.environ.get("PROBE_OUT", "probe_out")
T0 = [time.monotonic()]
_tls = threading.local()


def since():
    return round(time.monotonic() - T0[0], 3)


class TimedRLock:
    """The store's RLock, timing each outermost hold by its caller."""

    def __init__(self):
        self._lock = threading.RLock()
        self.by_caller = collections.defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        self.long_holds = []

    def __enter__(self):
        depth = getattr(_tls, "depth", 0)
        if depth == 0:
            _tls.caller = sys._getframe(1).f_code.co_name
            t = time.monotonic()
            self._lock.acquire()
            _tls.acquired = time.monotonic()
            _tls.waited = _tls.acquired - t
        else:
            self._lock.acquire()
        _tls.depth = depth + 1
        return self

    def __exit__(self, *exc):
        _tls.depth -= 1
        if _tls.depth == 0:
            held = time.monotonic() - _tls.acquired
            row = self.by_caller[_tls.caller]
            row[0] += 1
            row[1] += held
            row[2] = max(row[2], held)
            row[3] = max(row[3], _tls.waited)
            if held >= 0.3:
                self.long_holds.append((since(), _tls.caller, round(held, 3),
                                        threading.current_thread().name))
        self._lock.release()
        return False


locks = []
renewals = collections.defaultdict(list)
late, pauses, overflows, changes = [], [], [], []
done = threading.Event()


def install():
    init = kv.MemoryStore.__init__

    def timed_init(self, *a, **k):
        init(self, *a, **k)
        self._lock = TimedRLock()
        locks.append(self._lock)
    kv.MemoryStore.__init__ = timed_init

    beat = ScaleOutCoordinator.heartbeat
    update = kv.MemoryStore.update

    def timed_beat(co, client, now):
        t = time.monotonic()
        try:
            return beat(co, client, now)
        finally:
            renewals[co.index].append((since(), time.monotonic() - t))

    def timed_update(store, resource, obj, expect_rv=None):
        # the renewal thread's one write (ScaleOutCoordinator.renew_off_loop)
        t = time.monotonic()
        try:
            return update(store, resource, obj, expect_rv)
        finally:
            name = (obj.get("metadata") or {}).get("name", "")
            if resource == "leases" and threading.current_thread().name \
                    .startswith("scaleout-lease-"):
                renewals[int(name.rsplit("-", 1)[1])].append(
                    (since(), time.monotonic() - t))
    ScaleOutCoordinator.heartbeat = timed_beat
    kv.MemoryStore.update = timed_update

    tick = ScaleOutCoordinator.tick

    def timed_tick(co, client, now=None):
        changed = tick(co, client, now)
        if changed:
            changes.append((since(), co.index, co.live))
        return changed
    ScaleOutCoordinator.tick = timed_tick

    stacks = open(f"{OUT}/stacks.txt", "w")

    def probe():
        while not done.is_set():
            t = time.monotonic()
            faulthandler.dump_traceback_later(1.0, file=stacks)
            time.sleep(0.02)
            lag = time.monotonic() - t - 0.02
            if lag >= 0.1:
                late.append((round(t - T0[0], 3), round(lag, 3)))
    prober = threading.Thread(target=probe, daemon=True, name="gil-probe")
    prober.start()

    started = [None]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.monotonic()
        elif started[0] is not None:
            secs = time.monotonic() - started[0]
            if secs >= 0.05:
                pauses.append((round(started[0] - T0[0], 3),
                               info["generation"], round(secs, 3)))
    gc.callbacks.append(on_gc)

    class Overflow(logging.Handler):
        def emit(self, record):
            if "tensorization overflow" in record.getMessage():
                overflows.append((since(), record.getMessage()[:80]))
    logging.getLogger().addHandler(Overflow())
    return stacks, prober


def before(n):
    T0[0] = time.monotonic()
    for seen in (renewals, late, pauses, overflows, changes):
        seen.clear()
    print(f"== N={n}: switch interval {sys.getswitchinterval()}, gc "
          f"thresholds {gc.get_threshold()}", flush=True)


def after(n, row, clusters, store):
    lock = locks[-1]
    print(f"N={n}: {row}; threads {threading.active_count()}", flush=True)
    print(f"  overflows {len(overflows)} {overflows[:3]}; membership "
          f"changes (s, instance, live) {changes}", flush=True)
    for caller, (count, total, longest, wait) in sorted(
            lock.by_caller.items(), key=lambda kv_: -kv_[1][2])[:10]:
        print(f"  store lock {caller}: {count} holds, {total:.3f} s in all, "
              f"longest {longest:.3f} s, longest wait {wait:.3f} s",
              flush=True)
    print(f"  holds >= 0.3 s: {len(lock.long_holds)} "
          f"{lock.long_holds[:20]}", flush=True)
    for index, rows in sorted(renewals.items()):
        rows.sort()
        gaps = sorted(((round(b[0] - a[0], 3), a[0], round(a[1], 3))
                       for a, b in zip(rows, rows[1:])), reverse=True)
        longest = sorted(((round(d, 3), t) for t, d in rows), reverse=True)
        print(f"  renewals of {index}: {len(rows)}; longest gaps (gap, at, "
              f"the renewal before it took) {gaps[:5]}; longest renewals "
              f"(s, at) {longest[:5]}", flush=True)
    print(f"  probe late >= 0.1 s, longest first: {len(late)} "
          f"{sorted(late, key=lambda r: -r[1])[:10]}", flush=True)
    print(f"  gc >= 0.05 s, longest first (at, gen, s): {len(pauses)} "
          f"{sorted(pauses, key=lambda r: -r[2])[:10]}", flush=True)


def main():
    os.makedirs(OUT, exist_ok=True)
    stacks, prober = install()
    res = bench.run_scaleout(
        int(sys.argv[1]) if len(sys.argv) > 1 else 4,
        device=os.environ.get("DEV"),
        nodes=int(os.environ.get("NODES", bench.SCALEOUT_NODES)),
        pods=int(os.environ.get("PODS", bench.SCALEOUT_PODS)),
        batch=int(os.environ.get("BATCH", bench.SCALEOUT_BATCH)),
        before=before, after=after)
    done.set()
    prober.join()
    faulthandler.cancel_dump_traceback_later()
    stacks.close()
    print({n: {k: row.get(k) for k in ("pods_per_s", "wall_s", "bound",
                                       "conflicts")}
           for n, row in res["BENCH_SCALEOUT"].items()})
    failed = [n for n, row in res["BENCH_SCALEOUT"].items()
              if "error" in row]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
