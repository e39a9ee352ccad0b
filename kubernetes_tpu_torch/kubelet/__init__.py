"""Node agent: hollow kubelet + fake CRI (reference: pkg/kubelet, kubemark).

A copy of kubernetes_tpu/kubelet/, over this package's api/, client/ and
store/.
"""

from .cri import FakeRuntimeService  # noqa: F401
from .hollow import HollowKubelet, start_hollow_nodes  # noqa: F401
from .server import KubeletServer  # noqa: F401
