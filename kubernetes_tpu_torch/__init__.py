"""kubernetes_tpu_torch — the scheduler's device half on PyTorch and CUDA.

The counterpart of `kubernetes_tpu` (the JAX reference) for one NVIDIA
Hopper GPU.  It imports torch and numpy, never jax and never anything of
`kubernetes_tpu`: the host modules it needs are its own copies.

Package map:
  api/, utils/, scheduler/, testing/ - host copies: objects, quantities,
      PodInfo/NodeInfo, Cache/Snapshot and the BatchBackend contract
  ops/flatten.py  - snapshot -> numpy tensors (copy)
  ops/kernels.py  - the claims kernel wrapper and its plain torch version
  ops/csrc/       - hand-written CUDA sources (sm_90a), built at first use
  models/assign.py - the wave step in torch: plain (claims kernel) and
      full (selectors, ports, pins, spread, pod (anti-)affinity)
  models/carry.py  - resident state to and from the JAX package's arrays
  ops/backend.py   - TorchBatchBackend behind the BatchBackend contract

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
