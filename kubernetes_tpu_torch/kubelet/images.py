"""Image manager: GC by disk thresholds.

Reference: pkg/kubelet/images/image_gc_manager.go — when image disk usage
exceeds highThresholdPercent, delete unused images oldest-last-used first
until usage drops below lowThresholdPercent.  Disk usage is synthetic
here: every image costs `image_size` bytes against `disk_capacity`.

A copy of kubernetes_tpu/kubelet/images.py: the same classes, names and
logic, over this package's api/, client/ and store/.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Set

logger = logging.getLogger(__name__)


class ImageGCManager:
    def __init__(self, runtime, disk_capacity: int = 100 << 30,
                 image_size: int = 1 << 30,
                 high_threshold_percent: int = 85,
                 low_threshold_percent: int = 80):
        self.runtime = runtime  # FakeRuntimeService (list_images/remove)
        self.disk_capacity = disk_capacity
        self.image_size = image_size
        self.high = high_threshold_percent
        self.low = low_threshold_percent
        self._lock = threading.Lock()
        self._last_used: Dict[str, float] = {}

    def image_used(self, image: str) -> None:
        with self._lock:
            self._last_used[image] = time.monotonic()

    def usage_percent(self) -> float:
        n = len(self.runtime.list_images())
        return 100.0 * n * self.image_size / self.disk_capacity

    def garbage_collect(self, in_use: Set[str]) -> list[str]:
        """-> images deleted.  in_use images are never deleted."""
        deleted = []
        if self.usage_percent() < self.high:
            return deleted
        with self._lock:
            candidates = sorted(
                (img for img in self.runtime.list_images()
                 if img not in in_use),
                key=lambda img: self._last_used.get(img, 0.0))
        for img in candidates:
            if self.usage_percent() <= self.low:
                break
            self._remove(img)
            deleted.append(img)
        if self.usage_percent() > self.high:
            logger.warning("image GC: still above high threshold "
                           "(%.0f%%) after deleting %d images",
                           self.usage_percent(), len(deleted))
        return deleted

    def _remove(self, image: str) -> None:
        with self.runtime._lock:
            self.runtime._images.discard(image)
        with self._lock:
            self._last_used.pop(image, None)
