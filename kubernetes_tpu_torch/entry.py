"""The entry points of the port: the counterpart of the repo root's
__graft_entry__.py, which imports JAX.

entry(device=None)          - (fn, example_args): the single-device
                              snapshot step (models/assign.py
                              make_assign_core, the full wave variant) on a
                              realistic cluster snapshot.
dryrun_multichip(n, devices=None)
                            - one full scheduling step over an n-shard mesh
                              (parallel/mesh.py) on tiny shapes, 16 pods
                              bound through ShardedTorchBatchBackend under
                              the Scheduler, then no-loss parity of the
                              sharded and single-device backends at
                              n_cap=16,384.

Both run on CUDA unless the caller names a device: dryrun_multichip takes
n cards where that many are visible, else n shards of cuda:0.  JAX's
dry run repins its process to n virtual CPU devices; here a mesh is a list
of devices, so dryrun_multichip(n, devices="cpu") is n CPU shards and
changes nothing else in the process.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .device import resolve_device


def _build_example(caps, n_nodes: int, n_pods: int, batch_size: int):
    """A small but representative workload: mixed resources, zones,
    topology-spread and anti-affinity pods.  Returns (node arrays as
    numpy, PodBatch)."""
    from .ops.flatten import BatchEncoder, ClusterTensors
    from .parallel.mesh import NODE_KEYS
    from .scheduler.cache import Cache, Snapshot
    from .scheduler.types import PodInfo
    from .testing import make_node, make_pod

    cache = Cache()
    for i in range(n_nodes):
        zone = "abc"[i % 3]
        cache.add_node(
            make_node(f"n{i}").zone(zone)
            .labels(**{"kubernetes.io/hostname": f"n{i}"})
            .capacity(cpu="4", mem="16Gi").build())
    snap = cache.update_snapshot(Snapshot())

    pods = []
    for i in range(n_pods):
        if i % 3 == 0:
            p = (make_pod(f"p{i}").labels(app="web").req(cpu="250m", mem="256Mi")
                 .topology_spread("topology.kubernetes.io/zone", max_skew=2,
                                  match_labels={"app": "web"}).build())
        elif i % 3 == 1:
            p = (make_pod(f"p{i}").labels(app=f"svc{i % 7}").req(cpu="100m")
                 .pod_affinity("kubernetes.io/hostname", {"app": f"svc{i % 7}"},
                               anti=True).build())
        else:
            p = make_pod(f"p{i}").req(cpu="500m", mem="512Mi").build()
        pods.append(p)

    tensors = ClusterTensors(caps)
    tensors.update_from_snapshot(snap)
    enc = BatchEncoder(tensors, batch_size)
    batch = enc.encode([PodInfo(p) for p in pods])
    cd_sg, cd_asg = tensors.domain_base_counts()
    # the JAX example's arrays: no namespace masks (its batch carries no
    # namespaceSelector term)
    node_arrays = {k: getattr(tensors, k) for k in NODE_KEYS
                   if k not in ("cd_sg", "cd_asg", "sg_ns_mask",
                                "asg_ns_mask")}
    node_arrays.update(cd_sg=cd_sg, cd_asg=cd_asg)
    return node_arrays, batch


def entry(device=None):
    """Returns (fn, example_args): the single-device scheduling step
    fn(node, batch) on `device` (CUDA unless the caller names another)
    and its arguments, the node arrays as tensors on that device and the
    PodBatch."""
    from .models.assign import make_assign_core
    from .ops.flatten import Caps

    dev = resolve_device(device)
    caps = Caps(n_cap=256, l_cap=128, kl_cap=64, t_cap=16, pt_cap=16,
                s_cap=3, sg_cap=16, asg_cap=16)
    node_arrays, batch = _build_example(caps, n_nodes=200, n_pods=64,
                                        batch_size=64)
    # sync-point: the example's pageable uploads, once
    node_arrays = {k: torch.as_tensor(v).to(dev)
                   for k, v in node_arrays.items()}
    fn = make_assign_core(caps, device=dev)
    return fn, (node_arrays, batch)


def _dryrun_mesh(n_devices: int, devices):
    from .parallel.mesh import make_mesh
    if devices is not None:
        return make_mesh(devices, shards=n_devices)
    resolve_device(None)   # raises without a GPU
    if torch.cuda.device_count() >= n_devices:
        return make_mesh([f"cuda:{i}" for i in range(n_devices)])
    return make_mesh("cuda:0", shards=n_devices)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the FULL scheduling step over an n_devices-shard mesh (node
    axis sharded, pod batch and domain tables on the first shard's
    device) on tiny shapes, bind 16 pods through the sharded backend
    under the Scheduler, then hold the sharded backend to the single
    device's no-loss parity at n_cap=16,384, inside a deadline anchored
    at the call's start (the ratio is printed, not asserted).  `devices`
    names the shards' device(s) (e.g. "cpu"); by default n cards where
    that many are visible, else n shards of cuda:0.  Returns the phases'
    numbers."""
    func_t0 = time.monotonic()

    from .ops.flatten import Caps
    from .parallel.mesh import build_sharded_assign_fn

    mesh = _dryrun_mesh(n_devices, devices)
    n_cap = 16 * n_devices
    caps = Caps(n_cap=n_cap, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8,
                s_cap=2, sg_cap=8, asg_cap=8)
    node_arrays, batch = _build_example(
        caps, n_nodes=n_cap - n_devices, n_pods=16, batch_size=16)

    fn = build_sharded_assign_fn(caps, mesh, batch.p_cap)
    out = fn(node_arrays, batch)
    assignments = out["assignments"]
    placed = int((assignments >= 0).sum())
    assert placed > 0, "dryrun scheduled nothing"
    print(f"dryrun_multichip({n_devices}): placed {placed}/16 pods "
          f"across {n_cap - n_devices} nodes on a {n_devices}-shard mesh "
          f"{mesh}")
    result = {"mesh": [str(d) for d in mesh.devices], "step_placed": placed}

    # full step end-to-end: store -> informers -> queue -> sharded batch
    # backend (the step over the mesh's shards) -> assume -> bulk bind
    from .api import meta as _meta
    from .client import LocalClient, SharedInformerFactory
    from .parallel.backend import ShardedTorchBatchBackend
    from .scheduler import Profile, Scheduler, new_default_framework
    from .store import kv
    from .testing import make_node, make_pod

    backend = ShardedTorchBatchBackend(caps, batch_size=16, mesh=mesh)
    store = kv.MemoryStore()
    client = LocalClient(store)
    factory = SharedInformerFactory(client)
    fw = new_default_framework(client, factory)
    sched = Scheduler(client, factory, {"default-scheduler": Profile(
        fw, batch_backend=backend, batch_size=16)})
    factory.start()
    factory.wait_for_cache_sync()
    sched.run()
    try:
        for i in range(min(24, n_cap - n_devices)):
            client.create("nodes", make_node(f"dm-{i}")
                          .capacity(cpu="8", mem="32Gi").build())
        for i in range(16):
            client.create("pods", make_pod(f"dmp{i}").req(cpu="250m").build())
        deadline = time.time() + 120
        while time.time() < deadline:
            pods, _ = client.list("pods", "default")
            if all(_meta.pod_node_name(p) for p in pods):
                break
            time.sleep(0.1)
        else:
            raise AssertionError("dryrun: pods left unscheduled")
        print(f"dryrun_multichip({n_devices}): full scheduler step bound "
              f"16/16 pods through the sharded backend")
        result["scheduler_bound"] = 16
    finally:
        sched.stop()
        factory.stop()

    # scale + parity: thousands of pods at n_cap=16384, the smallest scale
    # representative of the 100k-node tier.  Wall-clock bounded; the ratio
    # is printed, not asserted: the correctness assertion is no-loss
    # parity only
    from .ops.backend import TorchBatchBackend
    from .scheduler.cache import Cache, Snapshot
    from .scheduler.types import PodInfo

    n_cap = 16384
    caps = Caps(n_cap=n_cap, l_cap=64, kl_cap=32, t_cap=8, pt_cap=8,
                s_cap=2, sg_cap=8, asg_cap=8)
    cache = Cache()
    for i in range(n_cap - n_devices * 8):
        cache.add_node(make_node(f"sc-{i}")
                       .capacity(cpu="64", mem="256Gi", pods=1000).build())
    snap = cache.update_snapshot(Snapshot())
    BATCH, MAX_ROUNDS = 512, 5
    PHASE_BUDGET_S = 75.0  # per backend: timed rounds after the first batch
    # anchored at the call's start: earlier phases running long shrink
    # this phase; the first (parity-critical) batch per backend always runs
    phase_deadline = func_t0 + 240.0

    def make_batch(tag, r):
        return [PodInfo(make_pod(f"{tag}{r}-{i}")
                        .req(cpu="100m", mem="64Mi").build())
                for i in range(BATCH)]

    def drive(backend, tag, max_rounds):
        backend.warmup()
        placed = sum(1 for nm, _ in backend.assign(make_batch(tag, 0), snap)
                     if nm)
        done = 1
        t_assign = 0.0  # the rate leaves out building each round's batch
        for r in range(1, max_rounds):
            if t_assign > PHASE_BUDGET_S or time.monotonic() > phase_deadline:
                break
            batch = make_batch(tag, r)
            ta = time.monotonic()
            placed += sum(1 for nm, _ in backend.assign(batch, snap) if nm)
            t_assign += time.monotonic() - ta
            done = r + 1
        rate = ((done - 1) * BATCH / max(t_assign, 1e-9) if done > 1
                else float("nan"))   # the deadline shed every timed round
        return placed, done, rate

    mesh_backend = ShardedTorchBatchBackend(caps, batch_size=BATCH, mesh=mesh)
    sh_placed, sh_done, sh_rate = drive(mesh_backend, "sh", MAX_ROUNDS)
    si_placed, si_done, si_rate = drive(
        TorchBatchBackend(caps, batch_size=BATCH, device=mesh.home), "si",
        sh_done)
    assert sh_placed == sh_done * BATCH, (
        f"sharded backend lost pods: placed {sh_placed}, "
        f"want {sh_done * BATCH}")
    assert si_placed == si_done * BATCH, (
        f"single-device backend lost pods: placed {si_placed}, "
        f"want {si_done * BATCH}")
    if sh_done == si_done:
        assert sh_placed == si_placed, (
            f"backends disagree over identical offered load: "
            f"sharded {sh_placed} vs single {si_placed}")
    ratio = sh_rate / si_rate
    print(f"dryrun_multichip({n_devices}): parity ok — no pods lost "
          f"(sharded {sh_placed}/{sh_done * BATCH}, "
          f"single {si_placed}/{si_done * BATCH}) at n_cap={n_cap}; "
          f"throughput sharded {sh_rate:.0f} pods/s vs single "
          f"{si_rate:.0f} pods/s (ratio {ratio:.2f}, "
          f"measurement only — load-sensitive, not asserted)")
    result.update(sharded=(sh_placed, sh_done * BATCH, sh_rate),
                  single=(si_placed, si_done * BATCH, si_rate), ratio=ratio,
                  seconds=time.monotonic() - func_t0)
    return result


if __name__ == "__main__":
    import os
    import sys

    dev = sys.argv[1] if len(sys.argv) > 1 else None
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "4")), dev)
    fn, args = entry(dev)
    out = fn(*args)
    print("entry ok:", int((np.asarray(out["assignments"]) >= 0).sum()),
          "placed")
