"""Scheduler cache debugger: dump + cache-vs-apiserver comparer.

Reference: pkg/scheduler/internal/cache/debugger/ — on SIGUSR2 the
scheduler logs a dump of the cache and queue (dumper.go) and compares the
cached nodes/pods against the apiserver's view (comparer.go), reporting
discrepancies that would otherwise poison snapshots silently.

A copy of kubernetes_tpu/scheduler/debugger.py, its logic unchanged: the
port's cache and queue expose the same dump, comparison_snapshot and
stats (tests/test_torch_cmd_scheduler.py holds the two against each
other).
"""

from __future__ import annotations

import logging
import signal

from ..api import meta
from ..client.clientset import NODES, PODS, Client

logger = logging.getLogger(__name__)


class CacheDebugger:
    def __init__(self, scheduler, client: Client | None = None):
        self.scheduler = scheduler
        self.client = client or scheduler.client

    # -- dumper.go --------------------------------------------------------

    def dump(self) -> dict:
        """Cache + queue snapshot (dumper.go DumpAll shape)."""
        return {
            "cache": self.scheduler.cache.dump(),
            "queue": self.scheduler.queue.stats(),
        }

    # -- comparer.go ------------------------------------------------------

    def compare(self) -> dict:
        """Diff the scheduler cache against the apiserver.

        Returns {"nodes": {"missing": [...], "extra": [...]},
                 "pods": {"missing": [...], "extra": [...]}} — missing =
        in apiserver but not cached; extra = cached but gone upstream
        (assumed-but-unconfirmed pods are expected extras and excluded)."""
        api_nodes = {meta.name(n) for n in self.client.list(NODES)[0]}
        api_pods = {meta.namespaced_name(p)
                    for p in self.client.list(PODS)[0]
                    if meta.pod_node_name(p)}
        cached_nodes, cached_pods, assumed = \
            self.scheduler.cache.comparison_snapshot()
        return {
            "nodes": {"missing": sorted(api_nodes - cached_nodes),
                      "extra": sorted(cached_nodes - api_nodes)},
            "pods": {"missing": sorted(api_pods - cached_pods),
                     "extra": sorted(cached_pods - api_pods - assumed)},
        }

    def log_all(self, *_signal_args) -> None:
        """SIGUSR2 handler body (debugger.go ListenForSignal)."""
        logger.info("scheduler cache dump: %s", self.dump())
        diff = self.compare()
        clean = not any(v for side in diff.values() for v in side.values())
        if clean:
            logger.info("cache comparer: cache is in sync with apiserver")
        else:
            logger.warning("cache comparer: DISCREPANCIES %s", diff)

    def listen_for_signal(self) -> None:
        """Install the SIGUSR2 handler (main thread only)."""
        signal.signal(signal.SIGUSR2, self.log_all)
