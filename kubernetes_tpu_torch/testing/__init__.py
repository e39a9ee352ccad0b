"""Testing kit (reference: pkg/scheduler/testing)."""

from .wrappers import NodeWrapper, PodWrapper, make_node, make_pod  # noqa: F401


def wait_for(predicate, timeout: float = 30.0, interval: float = 0.02) -> bool:
    """Poll until predicate() is truthy; the shared test/e2e helper
    (test/e2e/framework wait.go shape)."""
    import time
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False
