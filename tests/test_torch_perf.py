"""The port's scheduler_perf harness and bench entry on the CPU.

The workload file is the JAX package's, converted to JSON; a tiny
SchedulingBasic runs end to end through the port's Scheduler on a
TorchBatchBackend(device="cpu") and binds what the JAX harness binds; the
bench module prints one row in bench.py's shape; the census over the
remote seam is served by the worker that runs its step; configure_scaleout
attaches a ScaleOutCoordinator (tests/test_torch_scaleout.py holds
scale-out against the JAX package), and the entry points refuse to run
without a GPU unless the caller names the CPU.
"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_tpu_torch import perf as port_perf
from kubernetes_tpu_torch.ops import backend as port_backend
from kubernetes_tpu_torch.perf import bench
from kubernetes_tpu_torch.store import kv

ROOT = Path(__file__).resolve().parent.parent
N_NODES, N_PODS, BATCH = 200, 1000, 256


def tiny_basic(perf_mod):
    """The bench's SchedulingBasic (SchedulingBasicLarge: a 1,000-pod
    warm-up, then the measured createPods) at 200 nodes, 1,000 pods."""
    cfg = copy.deepcopy(perf_mod.load_workloads()["SchedulingBasicLarge"])
    for op in cfg["workloadTemplate"]:
        if op["opcode"] == "createNodes":
            op["count"] = N_NODES
        elif op["opcode"] == "createPods" and op.get("collectMetrics"):
            op["count"] = N_PODS
    return cfg


def test_workloads_equal_the_jax_yaml():
    jax_perf = pytest.importorskip("kubernetes_tpu.perf")
    ours, theirs = port_perf.load_workloads(), jax_perf.load_workloads()
    assert list(ours) == list(theirs)
    for name in theirs:
        assert ours[name] == theirs[name], name


def test_run_named_workload_binds_every_pod_on_cpu():
    store = kv.MemoryStore()
    summary, stats = port_perf.run_named_workload(
        tiny_basic(port_perf),
        caps=port_perf.caps_for_nodes(N_NODES), batch_size=BATCH,
        pipeline_depth=2, device="cpu", store=store)
    assert stats["barrier_ok"]
    placed = bench.check_placements(store)
    assert placed["pods"] == placed["bound"] == 2 * N_PODS
    assert placed["nodes_over_capacity"] == 0
    assert placed["max_pods_per_node"] <= 110
    assert summary.total_pods == N_PODS
    assert "p99_ms" in stats["e2e"]
    assert stats["backend_stats"]["batches"] > 0
    assert stats["escape_rate"] == 0.0
    assert stats["schedule_attempts"]["error"] == 0
    assert stats["tensor_maintenance"]["waves_reflattened"] >= 0


def test_jax_harness_binds_the_same_count(monkeypatch):
    """The JAX harness (TPUBatchBackend, KTPU_PALLAS=0) and the port's on
    the same workload: both barriers pass and both count every measured
    pod bound."""
    jax_perf = pytest.importorskip("kubernetes_tpu.perf")
    monkeypatch.setenv("KTPU_PALLAS", "0")
    runs = {}
    for name, perf_mod, kw in (("jax", jax_perf, {"tpu": True}),
                               ("port", port_perf, {"device": "cpu"})):
        summary, stats = perf_mod.run_named_workload(
            tiny_basic(perf_mod),
            caps=perf_mod.caps_for_nodes(N_NODES), batch_size=BATCH,
            pipeline_depth=2, **kw)
        runs[name] = (stats["barrier_ok"], summary.total_pods,
                      stats["created_pods"], stats["escape_rate"])
    assert runs["port"] == runs["jax"] == (True, N_PODS, 2 * N_PODS, 0.0)


BENCH_KEYS = ("nodes", "pods", "batch", "wall_s", "Average", "Perc50",
              "Perc90", "Perc99", "TotalPods", "DurationSeconds",
              "pod_e2e_p50_ms", "pod_e2e_p95_ms", "pod_e2e_p99_ms",
              "escape_rate", "tensor_maintenance")


def test_bench_module_prints_one_row():
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.perf.bench",
         "--config", "SchedulingBasic", "--device", "cpu",
         "--nodes", str(N_NODES), "--pods", str(N_PODS),
         "--batch", str(BATCH)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    row = json.loads(lines[0])
    assert row["metric"] == "scheduler_perf_throughput"
    assert row["unit"] == "pods/s" and row["value"] > 0
    # both are rounded from the unrounded pods/s: value to 0.1, the ratio
    # to 0.01
    assert abs(row["vs_baseline"] - row["value"] / 300.0) <= (
        0.005 + 0.05 / 300.0)
    for key in BENCH_KEYS:
        assert key in row["detail"], key
    assert row["detail"]["placements"]["bound"] == 2 * N_PODS
    assert row["detail"]["escape_rate"] == 0.0


def test_bench_host_profile_reads_threads():
    """The bench's diagnostics: the sampling profiler armed (--host-profile,
    ProfilingPolicy(enabled=True)) adds its stage seconds and each pipeline
    thread's CPU seconds to the row."""
    from kubernetes_tpu_torch.scheduler.config import ProfilingPolicy
    res = bench.run_once("SchedulingBasicLarge", 50, 300, 128,
                         depth=2, device="cpu",
                         profiling_policy=ProfilingPolicy(enabled=True))
    assert "error" not in res
    cpu = res["detail"]["thread_cpu_s"]
    assert {"MainThread", "sched-loop", "informer-pods"} <= set(cpu)
    assert all(v >= 0.0 for v in cpu.values())
    assert sum(res["detail"]["host_stages"].values()) > 0


def _cfg():
    return tiny_basic(port_perf)


def _remote_census():
    """The census over the remote seam (ROADMAP item 6b): the step it runs
    lives in the worker's process (a worker on the CPU, stopped before
    returning), which serves /census.  Returns (the census, the verbs the
    worker served)."""
    from kubernetes_tpu_torch.ops.flatten import Caps
    from kubernetes_tpu_torch.ops.remote import (
        DeviceWorker, RemoteTorchBatchBackend,
    )
    worker = DeviceWorker(device="cpu").start()
    try:
        client = RemoteTorchBatchBackend(
            worker.url, Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4,
                             pt_cap=4, s_cap=1, sg_cap=2, asg_cap=2),
            batch_size=4)
        try:
            return client.device_census(), dict(worker.core.served)
        finally:
            client.close()
    finally:
        worker.stop()


def test_remote_census_is_served():
    """Before any dispatch: the client makes the static arrays and the
    state resident on the worker, which runs the census of both
    variants (the default census request on an empty cluster)."""
    census, served = _remote_census()
    assert set(census) == {"full", "plain"}
    for v in census.values():
        assert v["waves"] >= 1 and v["batch"]["pods"] >= 1
        assert v["cost"]["bytes_accessed"] > 0
    assert served["/census"] == 1 and served["/static"] == 1
    assert served["/refresh"] == 1


def test_apply_and_scaleout_raise():
    """Neither raises any more: LocalClient.apply creates the object with
    its manager recorded since the managed-fields merge is ported
    (tests/test_torch_http_client.py holds it against the JAX package),
    and configure_scaleout attaches a ScaleOutCoordinator for an enabled
    policy, none for a single instance, and None detaches it
    (tests/test_torch_scaleout.py holds the layer against the JAX
    package)."""
    from kubernetes_tpu_torch.client import LocalClient, SharedInformerFactory
    from kubernetes_tpu_torch.scheduler import new_scheduler
    from kubernetes_tpu_torch.scheduler.config import ScaleOutPolicy
    from kubernetes_tpu_torch.scheduler.scaleout import ScaleOutCoordinator
    from kubernetes_tpu_torch.testing import make_pod
    client = LocalClient(kv.MemoryStore())
    applied = client.apply("pods", make_pod("p").build(), "tester")
    assert [m["manager"] for m in applied["metadata"]["managedFields"]] == [
        "tester"]
    sched = new_scheduler(client, SharedInformerFactory(client))
    policy = ScaleOutPolicy(instance_count=2, instance_index=1)
    sched.configure_scaleout(policy)
    assert isinstance(sched.scaleout, ScaleOutCoordinator)
    assert sched.scaleout.policy is policy and sched.scaleout.index == 1
    assert sched.scaleout.live == (0, 1) and sched.scaleout.self_live
    sched.configure_scaleout(None)
    assert sched.scaleout is None
    sched.configure_scaleout(ScaleOutPolicy(instance_count=1))
    assert sched.scaleout is None


@pytest.mark.parametrize("shards", [None, 4])
def test_sharded_backend_builds_and_places_on_cpu(shards):
    """The `backend: {kind: sharded}` stanza's kind through
    make_batch_backend(kind, device="cpu") builds ShardedTorchBatchBackend
    on a mesh of the CPU (one shard, or `shards`) and places a small batch
    within capacity."""
    from kubernetes_tpu_torch.ops.flatten import Caps
    from kubernetes_tpu_torch.parallel.backend import ShardedTorchBatchBackend
    from kubernetes_tpu_torch.scheduler.config import load_config
    from torch_cases import Side, port_cache, port_testing, port_types
    kind = load_config({"backend": {"kind": "sharded"}}).backend.kind
    b = port_backend.make_batch_backend(
        kind, Caps(n_cap=16, l_cap=16, kl_cap=8, t_cap=4, pt_cap=4,
                        s_cap=1, sg_cap=2, asg_cap=2),
        batch_size=8, device="cpu", shards=shards)
    assert isinstance(b, ShardedTorchBatchBackend)
    assert b.mesh.size == (shards or 1) and b.census_kind == "sharded"
    s = Side(port_cache, port_types, port_testing, b,
             port_backend.FLUSH_FIRST)
    for i in range(6):
        s.cache.add_node(s.node(f"n{i}", cpu="1", mem="4Gi"))
    pods = [s.pod(f"p{i}", cpu="300m") for i in range(8)]
    got = b.assign(s.infos(pods), s.snapshot())
    names = [nm for nm, _st in got]
    assert all(names) and max(names.count(n) for n in set(names)) <= 3
    assert b.stats["plain"] == 1 and not hasattr(b, "preempt_batch")


def test_run_named_workload_on_a_sharded_cpu_mesh():
    from kubernetes_tpu_torch.parallel.mesh import make_mesh
    store = kv.MemoryStore()
    summary, stats = port_perf.run_named_workload(
        tiny_basic(port_perf),
        caps=port_perf.caps_for_nodes(N_NODES), batch_size=BATCH,
        pipeline_depth=2, device="cpu", store=store, backend_kind="sharded",
        mesh=make_mesh("cpu", shards=4))
    assert stats["barrier_ok"]
    placed = bench.check_placements(store)
    assert placed["pods"] == placed["bound"] == 2 * N_PODS
    assert placed["nodes_over_capacity"] == 0
    assert summary.total_pods == N_PODS
    assert stats["escape_rate"] == 0.0


def test_bench_sharded_row_on_cpu():
    """perf.bench --backend sharded: bench.py's headline shape (census and
    timeline armed) at a tiny size on four CPU shards."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.perf.bench",
         "--config", "Scheduling100k", "--device", "cpu", "--backend",
         "sharded", "--shards", "4", "--nodes", str(N_NODES), "--pods",
         str(N_PODS), "--batch", str(BATCH)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    d = json.loads(lines[0])["detail"]
    assert d["backend"] == "sharded" and d["escape_rate"] == 0.0
    assert d["placements"]["bound"] == 2 * N_PODS
    gauges = d["tpu_wave_collective_bytes"]
    assert set(gauges) == {"sharded-full", "sharded-plain"}
    assert gauges["sharded-plain"]["mesh_devices"] == 4
    assert gauges["sharded-plain"]["tpu_wave_collective_bytes"]["all-gather"]
    assert 0.0 <= d["device_idle_share"] <= 1.0
    assert d["latency_decomposition"]


NEEDS_GPU = {
    "make_batch_backend": lambda: port_backend.make_batch_backend("tpu"),
    "make_batch_backend_sharded": lambda: port_backend.make_batch_backend(
        "sharded"),
    "setup_cluster": lambda: port_perf.setup_cluster(),
    "run_named_workload": lambda: port_perf.run_named_workload(_cfg()),
    "bench": lambda: bench.main(["--config", "SchedulingBasic"]),
}


@pytest.mark.parametrize("case", sorted(NEEDS_GPU))
def test_entry_points_default_to_cuda(case):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NEEDS_GPU[case]()
