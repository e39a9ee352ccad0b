"""kubernetes_tpu_torch — the scheduler on PyTorch and CUDA.

The counterpart of `kubernetes_tpu` (the JAX reference) for one NVIDIA
Hopper GPU.  It imports torch and numpy, never jax and never anything of
`kubernetes_tpu`: the host modules it needs are its own copies.

Package map:
  api/, utils/, testing/ - host copies: objects, quantities, builders,
      the per-pod host helpers (Python versions of the JAX package's
      native ones), stage latencies, GC tuning
  store/          - MemoryStore with watch, the WAL it imports and the
      envelope encryption of secrets at rest (copy)
  client/         - LocalClient, informers, work queues, HTTPClient (copy)
  apiserver/      - the REST and watch server: RBAC, admission, flow
      control, audit, CRDs with CEL, discovery, patch and server-side
      apply (copy; `python -m kubernetes_tpu_torch.cmd.apiserver`)
  component_base/ - metrics, tracing, timeline, logs, feature gates,
      profiling (copy, without the jax-reading census functions)
  scheduler/      - the scheduler: cache, queue, framework, plugins,
      preemption, extenders, config, the scheduling loop (copies) and the
      BatchBackend contract
  ops/flatten.py  - snapshot -> numpy tensors (copy)
  ops/kernels.py  - the claims kernel wrapper and its plain torch version
  ops/csrc/       - hand-written CUDA sources (sm_90a), built at first use
  models/assign.py - the wave step in torch: plain (claims kernel) and
      full (selectors, ports, pins, spread, pod (anti-)affinity); the
      single-device snapshot form (build_assign_fn: the full waves, or
      the strict one-pod-at-a-time scan, the parity oracle)
  models/carry.py  - resident state to and from the JAX package's arrays
  ops/backend.py   - TorchBatchBackend behind the BatchBackend contract,
      and make_batch_backend (the `backend:` kinds)
  perf/            - the scheduler_perf harness (workloads as JSON) and
      the bench entry, `python3 -m kubernetes_tpu_torch.perf.bench`
  entry.py         - the entry points (entry, dryrun_multichip),
      the counterpart of the repo root's __graft_entry__.py

Entry points run on CUDA unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
