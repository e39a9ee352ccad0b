"""Work queues for controllers.

Reference semantics: staging/src/k8s.io/client-go/util/workqueue/
  queue.go          - dedup via dirty/processing sets; Get/Done protocol
  delaying_queue.go - AddAfter via time-ordered heap
  default_rate_limiters.go - per-item exponential backoff + overall bucket

An item added while being processed is remembered (dirty) and re-queued when
Done() is called — this is the exact property controllers rely on to never
miss an event and never process the same key concurrently.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Any, Hashable


class WorkQueue:
    """FIFO with dedup + in-flight tracking (workqueue/queue.go)."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._queue: list[Hashable] = []
        self._dirty: set[Hashable] = set()
        self._processing: set[Hashable] = set()
        self._shutting_down = False

    def add(self, item: Hashable) -> None:
        with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._queue.append(item)
            self._cond.notify()

    def get(self, timeout: float | None = None) -> tuple[Any, bool]:
        """Returns (item, shutdown). Blocks until an item or shutdown."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutting_down:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None, False
                self._cond.wait(remaining)
            if not self._queue:
                return None, True
            item = self._queue.pop(0)
            self._processing.add(item)
            self._dirty.discard(item)
            return item, False

    def done(self, item: Hashable) -> None:
        with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    def __len__(self) -> int:
        with self._cond:
            return len(self._queue)

    def shut_down(self) -> None:
        with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        with self._cond:
            return self._shutting_down


class DelayingQueue(WorkQueue):
    """WorkQueue + add_after (workqueue/delaying_queue.go)."""

    def __init__(self) -> None:
        super().__init__()
        self._heap: list[tuple[float, int, Hashable]] = []
        self._seq = 0
        self._waiter = threading.Condition()
        self._loop = threading.Thread(target=self._waiting_loop, daemon=True)
        self._loop.start()

    def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._waiter:
            self._seq += 1
            heapq.heappush(self._heap, (time.monotonic() + delay, self._seq, item))
            self._waiter.notify()

    def _waiting_loop(self) -> None:
        while True:
            with self._waiter:
                if self.shutting_down:
                    return
                now = time.monotonic()
                ready: list[Hashable] = []
                while self._heap and self._heap[0][0] <= now:
                    ready.append(heapq.heappop(self._heap)[2])
                wait = (self._heap[0][0] - now) if self._heap else 0.2
            for item in ready:
                self.add(item)
            with self._waiter:
                if not self.shutting_down:
                    self._waiter.wait(min(wait, 0.2))

    def shut_down(self) -> None:
        super().shut_down()
        with self._waiter:
            self._waiter.notify_all()


class RateLimiter:
    """Per-item exponential backoff (ItemExponentialFailureRateLimiter)."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self._base = base_delay
        self._max = max_delay
        self._failures: dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, item: Hashable) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
            return min(self._base * (2 ** n), self._max)

    def forget(self, item: Hashable) -> None:
        with self._lock:
            self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        with self._lock:
            return self._failures.get(item, 0)


class RateLimitingQueue(DelayingQueue):
    """DelayingQueue + rate limiter (workqueue/rate_limiting_queue.go)."""

    def __init__(self, rate_limiter: RateLimiter | None = None):
        super().__init__()
        self.rate_limiter = rate_limiter or RateLimiter()

    def add_rate_limited(self, item: Hashable) -> None:
        self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)
