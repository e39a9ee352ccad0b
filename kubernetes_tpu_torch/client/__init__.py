"""Client machinery: clientset, informers, workqueues, leader election."""

from .clientset import Client, LocalClient  # noqa: F401
from .informer import Informer, SharedInformerFactory  # noqa: F401
from .workqueue import DelayingQueue, RateLimiter, RateLimitingQueue, WorkQueue  # noqa: F401
