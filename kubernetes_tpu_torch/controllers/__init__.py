"""Controllers (reference: pkg/controller + kube-controller-manager).

A copy of kubernetes_tpu/controllers/, over this package's api/,
client/ and store/.
"""

from .base import Controller  # noqa: F401
from .deployment import DeploymentController  # noqa: F401
from .garbagecollector import GarbageCollector  # noqa: F401
from .job import JobController  # noqa: F401
from .manager import ControllerManager  # noqa: F401
from .nodelifecycle import NodeLifecycleController  # noqa: F401
from .replicaset import ReplicaSetController  # noqa: F401
