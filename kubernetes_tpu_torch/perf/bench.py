"""The port's bench entry: one scheduler_perf workload through the whole
pipeline — store -> watch -> informers -> queue -> batch Filter/Score/
Assign on the GPU (TorchBatchBackend) -> assume -> bind — printing ONE
JSON line in the row shape of the JAX package's bench.py.

    python3 -m kubernetes_tpu_torch.perf.bench --config Scheduling100k
    python3 -m kubernetes_tpu_torch.perf.bench --config SchedulingBasic \\
        --device cpu --nodes 200 --pods 1000 --batch 256

Configs (the JAX bench's own parameters):
  SchedulingBasic       5,000 nodes, 50,000 measured pods after the
                        workload's 1,000-pod warm-up, batch 16,384, depth 2
  Scheduling100k        100,000 nodes, 200,000 pods, batch 16,384, depth 2
  SchedulingBasicPaced  5,000 nodes, 24,000 pods arriving at 8,000 pods/s,
                        batch 512, depth 12, 1 ms admission window (the
                        latency row)
  PreemptionBasic       the workload's own 500 nodes (4 CPU), 2,000
                        low-priority pods, then 500 measured priority-10
                        pods that each must evict; batch 1,024, depth 1
  PreemptionDense       the workload's own 100 nodes (8 CPU), 800
                        low-priority pods, then 400 measured preemptors,
                        four to a node, each evicting several; batch 1,024,
                        depth 1
The JAX bench runs the two preemption configs twice (`two_pass`, a warm-up
pass first); this entry runs them once.

The device is CUDA unless --device names another; without a GPU the
default raises.  --nodes/--pods/--batch override a config's sizes (tests
run tiny ones on the CPU).  The row's detail also carries `placements`,
read from the store after the run: pods created and bound, and the nodes
whose bound pods exceed their CPU, memory or pod count, and the pods
created but no longer in the store (victims evicted by preemption are
deleted: gone, not unbound).  Diagnostics:
KTPU_STAGE_DEBUG=1 adds the per-batch stage latencies (stage_latency),
--host-profile the sampling profiler's seconds per pipeline stage
(host_stages) and each thread's CPU seconds over the run (thread_cpu_s).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import threading
import time

from ..api import meta
from ..api.resources import node_allocatable, pod_request
from ..client.clientset import NODES, PODS
from ..component_base import profiling
from ..store import kv
from . import caps_for_nodes, load_workloads, run_named_workload
from .scheduler_perf import is_measured

BASELINE_PODS_PER_SEC = 300.0

CONFIGS = {
    "SchedulingBasic": {"workload": "SchedulingBasicLarge", "nodes": 5000,
                        "pods": 50_000, "batch": 16384, "depth": 2},
    "Scheduling100k": {"workload": "SchedulingBasicLarge", "nodes": 100_000,
                       "pods": 200_000, "batch": 16384, "depth": 2,
                       "timeout": 1200.0},
    "SchedulingBasicPaced": {"workload": "SchedulingBasicLarge",
                             "nodes": 5000, "pods": 24_000, "batch": 512,
                             "rate": 8000, "depth": 12, "admission_ms": 1.0},
    # bench.py's own parameters, at the workload's node and pod counts
    "PreemptionBasic": {"workload": "PreemptionBasic", "nodes": None,
                        "pods": None, "batch": 1024, "depth": 1,
                        "timeout": 900.0},
    "PreemptionDense": {"workload": "PreemptionDense", "nodes": None,
                        "pods": None, "batch": 1024, "depth": 1,
                        "timeout": 900.0},
}


def scaled_timeout(pods: int, base: float = 900.0) -> float:
    """Barrier budget: the config's timeout, or more for large pod counts
    (the JAX bench's rule: 60 s plus 100 pods/s)."""
    return max(base, 60.0 + pods / 100.0)


def check_placements(store: kv.MemoryStore,
                     created: int | None = None) -> dict:
    """What the store holds after a run, independent of the backend: pods
    present and bound, pods deleted (`created` minus present, when given:
    preemption's victims), the nodes in use, the most pods on one node, and the nodes
    whose bound pods' requests exceed their allocatable CPU, memory or pod
    count."""
    pods, _ = store.list(PODS)
    nodes, _ = store.list(NODES)
    alloc = {meta.name(n): node_allocatable(n) for n in nodes}
    used: dict[str, list[int]] = {}
    bound = 0
    for p in pods:
        node = meta.pod_node_name(p)
        if not node:
            continue
        bound += 1
        r = pod_request(p)
        u = used.setdefault(node, [0, 0, 0])
        u[0] += r.milli_cpu
        u[1] += r.memory
        u[2] += 1
    over = [n for n, (cpu, mem, cnt) in used.items()
            if n not in alloc or cpu > alloc[n].milli_cpu
            or mem > alloc[n].memory or cnt > alloc[n].allowed_pod_number]
    return {"pods": len(pods), "bound": bound,
            "deleted": None if created is None else created - len(pods),
            "nodes_used": len(used),
            "max_pods_per_node": max((u[2] for u in used.values()),
                                     default=0),
            "nodes_over_capacity": len(over), "over_examples": over[:5]}


def thread_cpu_seconds() -> dict[str, float]:
    """CPU seconds of every live Python thread, summed by thread name
    (component_base.profiling reads /proc/self/task, where every thread
    is named after the interpreter)."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    out: dict[str, float] = {}
    for key, secs in profiling.thread_cpu_seconds().items():
        name = names.get(int(key.rsplit("-", 1)[1]))
        if name is not None:
            out[name] = round(out.get(name, 0.0) + secs, 2)
    return out


def run_once(workload: str, nodes: int | None, pods: int | None,
             batch: int, barrier_timeout: float = 900.0,
             rate: float | None = None, depth: int = 1,
             admission_ms: float = 0.0, device=None,
             host_profile: bool = False, after=None) -> dict:
    """One full workload pass in this process (the JAX bench's run_once,
    device-backed by TorchBatchBackend on `device`).  host_profile arms
    the sampling host profiler (its per-stage host seconds land in the
    row as host_stages; they count a thread's samples whether it runs or
    waits) and reads each thread's CPU seconds over the run before the
    shutdown (thread_cpu_s); `after(cluster)` runs once the workload's
    stats and the store's placements are read.  Returns {"value", "wall_s", "detail", "stats"}, plus
    "error" when the barrier failed."""
    cfg = copy.deepcopy(load_workloads()[workload])
    tpl = cfg["workloadTemplate"]
    # count/rate overrides target the MEASURED createPods only: warm-up
    # ops keep their configured size
    for op in tpl:
        measured = is_measured(op, tpl)
        if op["opcode"] == "createNodes" and nodes is not None:
            op["count"] = nodes
        elif op["opcode"] == "createPods" and measured and pods is not None:
            op["count"] = pods
        if op["opcode"] == "createPods" and measured and rate:
            op["ratePerSecond"] = rate
    n_measured = sum(op["count"] for op in tpl
                     if op["opcode"] == "createPods" and is_measured(op, tpl))
    for op in tpl:
        if op["opcode"] == "barrier":
            op["timeout"] = scaled_timeout(n_measured, barrier_timeout)
    n_nodes = next(op["count"] for op in tpl if op["opcode"] == "createNodes")
    n_created = sum(op["count"] for op in tpl if op["opcode"] == "createPods")
    profiling_policy = None
    if host_profile:
        from ..scheduler.config import ProfilingPolicy
        profiling_policy = ProfilingPolicy(enabled=True)
    cpu: dict[str, float] = {}
    placements: dict = {}

    def after_run(cluster):
        # the store as the workload left it, before `after` adds to it
        placements.update(check_placements(store, n_created))
        if host_profile:
            cpu.update(thread_cpu_seconds())
        if after is not None:
            after(cluster)
    store = kv.MemoryStore(history=1_000_000)
    t0 = time.monotonic()
    summary, stats = run_named_workload(
        cfg, caps=caps_for_nodes(n_nodes), batch_size=batch,
        pipeline_depth=depth, admission_interval=admission_ms / 1e3,
        device=device, store=store, profiling_policy=profiling_policy,
        after=after_run)
    wall = time.monotonic() - t0
    detail = summary.to_dict()
    detail["placements"] = placements
    if not stats.get("barrier_ok", False):
        return {"error": "pods left unscheduled", "value": 0.0,
                "wall_s": round(wall, 1), "detail": detail, "stats": stats,
                "nodes": n_nodes, "pods": n_measured}
    e2e = stats.get("e2e") or {}
    if e2e:
        detail["pod_e2e_p50_ms"] = e2e.get("p50_ms")
        detail["pod_e2e_p95_ms"] = e2e.get("p95_ms")
        detail["pod_e2e_p99_ms"] = e2e.get("p99_ms")
    for key in ("escape_rate", "preemption_attempts"):
        if key in stats:
            detail[key] = stats[key]
    maint = stats.get("tensor_maintenance")
    if maint:
        patch_s = float(maint.get("patch_seconds", 0.0))
        flat_s = float(maint.get("flatten_seconds", 0.0))
        detail["tensor_maintenance"] = {
            "waves_patched": maint.get("waves_patched", 0),
            "waves_reflattened": maint.get("waves_reflattened", 0),
            "event_patches": maint.get("event_patches", 0),
            "compactions": maint.get("compactions", 0),
            "gen_stale_waves": maint.get("gen_stale_waves", 0),
            "snapshot_patch_s": round(patch_s, 3),
            "snapshot_flatten_s": round(flat_s, 3),
            "host_share": round((patch_s + flat_s) / wall, 4) if wall else 0.0,
        }
    detail["schedule_attempts"] = stats.get("schedule_attempts")
    for key in ("setup_s", "create_nodes_s", "flatten_before_window_s"):
        detail[key] = round(stats.get(key, 0.0), 3)
    # diagnostics: per-batch stage latencies (KTPU_STAGE_DEBUG=1) and the
    # sampling profiler's host seconds per pipeline stage (host_profile)
    for key in ("stage_latency", "host_stages"):
        if key in stats:
            detail[key] = stats[key]
    if cpu:
        detail["thread_cpu_s"] = cpu
    return {"value": summary.average, "wall_s": round(wall, 1),
            "detail": detail, "stats": stats, "nodes": n_nodes,
            "pods": n_measured}


def row(value: float, nodes: int, pods: int, batch: int,
        extra: dict) -> dict:
    """bench.py's row shape."""
    return {"metric": "scheduler_perf_throughput",
            "value": round(value, 1), "unit": "pods/s",
            "vs_baseline": round(value / BASELINE_PODS_PER_SEC, 2),
            "detail": {"nodes": nodes, "pods": pods, "batch": batch,
                       **extra}}


def run_config(name: str, device=None, nodes: int | None = None,
               pods: int | None = None, batch: int | None = None,
               host_profile: bool = False, after=None) -> tuple:
    """Run a named config (sizes optionally overridden); returns (the row,
    run_once's result)."""
    c = {**CONFIGS[name]}
    for key, val in (("nodes", nodes), ("pods", pods), ("batch", batch)):
        if val is not None:
            c[key] = val
    res = run_once(c["workload"], c["nodes"], c["pods"], c["batch"],
                   c.get("timeout", 900.0), rate=c.get("rate"),
                   depth=c.get("depth", 1),
                   admission_ms=c.get("admission_ms", 0.0), device=device,
                   host_profile=host_profile, after=after)
    extra = {"config": name, "wall_s": res.get("wall_s"), **res["detail"]}
    if "error" in res:
        extra["error"] = res["error"]
    return row(res["value"], res["nodes"], res["pods"], c["batch"],
               extra), res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="SchedulingBasic",
                    choices=sorted(CONFIGS))
    ap.add_argument("--device", default=None,
                    help="torch device of the batch backend (default cuda)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--host-profile", action="store_true",
                    help="sample the host threads; the row gains "
                         "host_stages (seconds per pipeline stage) and "
                         "thread_cpu_s (CPU seconds per thread)")
    args = ap.parse_args(argv)
    out, res = run_config(args.config, args.device, args.nodes, args.pods,
                          args.batch, host_profile=args.host_profile)
    print(json.dumps(out), flush=True)
    return 1 if "error" in res else 0


if __name__ == "__main__":
    sys.exit(main())
