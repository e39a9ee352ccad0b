"""PrioritySort queue-sort plugin.

Reference: pkg/scheduler/framework/plugins/queuesort/priority_sort.go —
higher .spec.priority first, earlier queue-entry time breaks ties.
"""

from __future__ import annotations

from ..framework import QueueSortPlugin
from ..types import QueuedPodInfo


class PrioritySort(QueueSortPlugin):
    name = "PrioritySort"
    # marker for SchedulingQueue: this sort is exactly priority-then-FIFO,
    # so the O(1) bucket queue implements it (queue.py _BucketQueue)
    priority_fifo = True

    def sort_key(self, qpi: QueuedPodInfo) -> tuple:
        return (-qpi.pod_info.priority, qpi.timestamp)
