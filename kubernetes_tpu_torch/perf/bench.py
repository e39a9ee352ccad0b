"""The port's bench entry: one scheduler_perf workload through the whole
pipeline — store -> watch -> informers -> queue -> batch Filter/Score/
Assign on the GPU (TorchBatchBackend) -> assume -> bind — printing ONE
JSON line in the row shape of the JAX package's bench.py.

    python3 -m kubernetes_tpu_torch.perf.bench --config Scheduling100k
    python3 -m kubernetes_tpu_torch.perf.bench --config SchedulingBasic \\
        --device cpu --nodes 200 --pods 1000 --batch 256

Configs: every single-device row of the JAX package's bench.py
(bench.py:80-242), with its parameters (batch, depth, admission window,
percentage of nodes to score, two passes) at its workload's own scale,
plus SchedulingChurnStorm.  The main ones:
  SchedulingBasic       5,000 nodes, 50,000 measured pods after the
                        workload's 1,000-pod warm-up, batch 16,384, depth 2
  Scheduling100k        100,000 nodes, 200,000 pods, batch 16,384, depth 2
  SchedulingBasicPaced  5,000 nodes, 24,000 pods arriving at 8,000 pods/s,
                        batch 512, depth 12, 1 ms admission window (the
                        latency row; Paced4k and Paced1k at 4,000 and
                        1,000 pods/s)
  SchedulingHostNull    SchedulingBasic's 5,000 nodes and 50,000 pods,
                        batch 16,384, depth 1, with the device step nulled
                        (ops/nullbackend.py): the host ceiling, read beside
                        SchedulingBasic
  SchedulingPodAntiAffinity, SchedulingHighCardinality, TopologySpreading,
  CoschedulingGang      the constraint rows: batch 8,192, depth 2, 50 ms
                        admission window
  PreemptionBasic       the workload's own 500 nodes (4 CPU), 2,000
                        low-priority pods, then 500 measured priority-10
                        pods that each must evict; batch 1,024, depth 1
  PreemptionDense       100 nodes (8 CPU), 800 low-priority pods, then 400
                        measured preemptors, four to a node
  Unschedulable ... SchedulingNSSelectorDense
                        the other scheduler_perf workloads (bench.py's
                        round-5 rows), batch 4,096 or 8,192, depth 2
  SchedulingMixedEscapes  every 20th pod carries a Gt node-affinity term
                        the tensor path does not encode: a non-zero escape
                        rate by design
  SchedulingOverloadFlood  a 30,000-pod flood under the full overload
                        policy and a seeded chaos schedule (slow and
                        all-escape waves, ops/faults.py)
  SchedulingChurnStorm  the nodeStorm workload (seeded node adds, drains
                        and relabels during a 12,000-pod flood) with the
                        default overload policy, batch 4,096, depth 2
  SchedulingBasicHTTP   5,000 nodes, 10,000 pods, batch 4,096, depth 2
                        through the apiserver (RBAC, default admission,
                        WAL) over HTTP: the front door; SchedulingBasicHTTPProc
                        runs the apiserver as a separate process
                        (python -m kubernetes_tpu_torch.cmd.apiserver)
Rows marked two_pass (as in bench.py) run twice in this process and keep
the better pass (higher pods/s; lower p99 for a paced row); the other
pass lands in detail.second_pass.  A row fails (detail.error, exit code
1) when any of its passes failed.

--backend sharded runs a row through ShardedTorchBatchBackend
(parallel/backend.py) with the census and the timeline armed, as bench.py's
headline runs Scheduling100k (bench.py:1615-1624):
    python3 -m kubernetes_tpu_torch.perf.bench --config Scheduling100k \
        --backend sharded
on a mesh of every visible card (one shard each), or of --shards shards
over --device (e.g. --device cuda:0 --shards 4; on the CPU --device cpu
--shards 8).

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

The seam rows (bench.py's RemoteSeamGrpc and RemoteSeamFaulty, run_seam):
5,000 nodes, six rounds of 4,096 plain pods through a device worker (an
in-process GrpcDeviceWorker, --seam http for DeviceWorker, or the worker
at --worker-url) and through the in-process backend; RemoteSeamFaulty
adds the seeded faults, a worker kill and resync and an outage that trips
the failover breaker and fails back.

Horizontal scale-out (bench.py's --instances N, run_scaleout):
    python3 -m kubernetes_tpu_torch.perf.bench --instances 4
runs 1, 2, 4 (and N) scheduler instances in this process over one
MemoryStore, partitioned on the scaleOut node-pool ring, each with its own
TorchBatchBackend on --device: 100,000 nodes and 200,000 pods, batch
16,384, depth 2 unless --nodes/--pods/--batch say otherwise; one JSON row
whose value is the best count's pods/s and whose detail holds every
count's pods/s, wall, bound pods, bind conflicts by kind, conflict rate
and speedup over one instance.

Process-true scale-out (bench.py's --processes N, run_scaleout_proc):
    python3 -m kubernetes_tpu_torch.perf.bench --processes 4
starts an apiserver process and 1, 2, 4 (and N) scheduler processes
(scheduler/procrun.py), each on the null device as bench.py has it:
20,000 nodes, 60,000 pods, batch 4,096 unless BENCH_SCALEOUT_NODES/PODS/
BATCH/TIMEOUT or --nodes/--pods/--batch say otherwise; one JSON row whose
detail holds every count's pods/s, wall, bound pods, double binds, bind
conflicts by kind, speedup over one process and, above one, the seeded
crash sub-pass (child 0 SIGKILLed, then max(1,000, pods / 20) more pods).
It exits 1 when a pass left a pod unbound or bound one twice.

The observatory read-outs (the JAX bench.py's --profile and --timeline):
    python3 -m kubernetes_tpu_torch.perf.bench --profile [--out PATH]
    python3 -m kubernetes_tpu_torch.perf.bench --timeline [--out PATH]
each run one SchedulingBasicLarge pass (1,000 nodes, 5,000 pods, batch
1,024, depth 2 unless --nodes/--pods/--batch say otherwise) with the
profiling: stanza armed (--profile: the host sampler, the device census
and the SLO tracker; --timeline: the wave timeline), then the same pass
with it off, print one JSON line (the armed pass's numbers, both passes'
pods/s and their ratio) and write the artifact to --out (default
kubernetes_tpu_torch/_build/{profile,timeline}_SchedulingBasicLarge.json).
--trace (bench.py's) runs the same pass over the gRPC device worker seam
(--seam http for HTTP) with every batch traced, then untraced, and writes
both sides' spans as Chrome trace JSON (trace_SchedulingBasicLarge.json).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import threading
import time

from ..api import meta
from ..api.resources import node_allocatable, pod_request
from ..client.clientset import NODES, PODS
from ..component_base import profiling
from ..ops.faults import DROP, KILL, FaultSchedule
from ..store import kv
from . import caps_for_nodes, load_workloads, run_named_workload
from .scheduler_perf import is_measured

BASELINE_PODS_PER_SEC = 300.0

# bench.py's single-device rows with its own parameters (bench.py:80-242;
# "null" is its SchedulingHostNull flag, "overload" its overload shape)
CONFIGS = {
    "SchedulingBasic": {"workload": "SchedulingBasicLarge", "nodes": 5000,
                        "pods": 50_000, "batch": 16384, "depth": 2},
    "Scheduling100k": {"workload": "SchedulingBasicLarge", "nodes": 100_000,
                       "pods": 200_000, "batch": 16384, "depth": 2,
                       "timeout": 1200.0},
    "SchedulingBasicPaced": {"workload": "SchedulingBasicLarge",
                             "nodes": 5000, "pods": 24_000, "batch": 512,
                             "rate": 8000, "depth": 12, "admission_ms": 1.0},
    "SchedulingBasicPaced4k": {"workload": "SchedulingBasicLarge",
                               "nodes": 5000, "pods": 12_000, "batch": 512,
                               "rate": 4000, "depth": 12,
                               "admission_ms": 1.0},
    "SchedulingBasicPaced1k": {"two_pass": True,
                               "workload": "SchedulingBasicLarge",
                               "nodes": 5000, "pods": 6_000, "batch": 256,
                               "rate": 1000, "depth": 12,
                               "admission_ms": 1.0},
    # the constraint rows: full-variant chunks inside one dispatch, a
    # 50 ms admission window so an arrival flood coalesces
    "SchedulingPodAntiAffinity": {"two_pass": True,
                                  "workload": "SchedulingPodAntiAffinity",
                                  "batch": 8192, "depth": 2,
                                  "admission_ms": 50.0},
    "SchedulingHighCardinality": {"two_pass": True,
                                  "workload": "SchedulingHighCardinality",
                                  "batch": 8192, "depth": 2,
                                  "admission_ms": 50.0},
    "TopologySpreading": {"two_pass": True,
                          "workload": "TopologySpreading", "batch": 8192,
                          "depth": 2, "admission_ms": 50.0},
    "CoschedulingGang": {"two_pass": True,
                         "workload": "CoschedulingGang", "batch": 8192,
                         "depth": 2, "admission_ms": 50.0},
    # the front door: SchedulingBasicLarge through a real apiserver (RBAC,
    # admission, WAL) with every component speaking HTTP, in process and
    # as a separate process; the gap to the LocalClient row is the REST
    # tax (bench.py:127-140)
    "SchedulingBasicHTTP": {"workload": "SchedulingBasicLarge",
                            "nodes": 5000, "pods": 10_000, "batch": 4096,
                            "depth": 2, "timeout": 900.0, "http": True},
    "SchedulingBasicHTTPProc": {"workload": "SchedulingBasicLarge",
                                "nodes": 5000, "pods": 10_000,
                                "batch": 4096, "depth": 2,
                                "timeout": 900.0, "http": "proc"},
    # the host ceiling: the same pipeline with the device step nulled
    "SchedulingHostNull": {"workload": "SchedulingBasicLarge",
                           "nodes": 5000, "pods": 50_000, "batch": 16384,
                           "depth": 1, "null": True},
    "PreemptionBasic": {"two_pass": True,
                        "workload": "PreemptionBasic", "batch": 1024,
                        "depth": 1},
    "PreemptionDense": {"two_pass": True,
                        "workload": "PreemptionDense", "batch": 1024,
                        "depth": 1},
    "Unschedulable": {"workload": "Unschedulable", "batch": 4096,
                      "depth": 2},
    "SchedulingWithMixedChurn": {"workload": "SchedulingWithMixedChurn",
                                 "batch": 4096, "depth": 2},
    "SchedulingPodAffinity": {"workload": "SchedulingPodAffinity",
                              "batch": 8192, "depth": 2,
                              "admission_ms": 50.0},
    "SchedulingNodeAffinity": {"workload": "SchedulingNodeAffinity",
                               "batch": 4096, "depth": 2},
    "SchedulingPreferredPodAffinity": {
        "workload": "SchedulingPreferredPodAffinity",
        "batch": 8192, "depth": 2, "admission_ms": 50.0},
    "SchedulingPreferredPodAntiAffinity": {
        "workload": "SchedulingPreferredPodAntiAffinity",
        "batch": 8192, "depth": 2, "admission_ms": 50.0},
    "PreferredTopologySpreading": {
        "workload": "PreferredTopologySpreading",
        "batch": 8192, "depth": 2, "admission_ms": 50.0},
    "MixedSchedulingBasePod": {"workload": "MixedSchedulingBasePod",
                               "batch": 4096, "depth": 2},
    "SchedulingSecrets": {"workload": "SchedulingSecrets", "batch": 4096,
                          "depth": 2},
    # no pct_nodes on the required-anti row (bench.py's note: a 2% sample
    # of a contended one-pod-per-host cluster often holds no free host)
    "SchedulingRequiredPodAntiAffinityWithNSSelector": {
        "workload": "SchedulingRequiredPodAntiAffinityWithNSSelector",
        "batch": 4096, "depth": 2, "timeout": 1200.0},
    "SchedulingPreferredAffinityWithNSSelector": {
        "workload": "SchedulingPreferredAffinityWithNSSelector",
        "batch": 4096, "depth": 2, "pct_nodes": 2},
    "SchedulingNSSelectorDense": {
        "workload": "SchedulingNSSelectorDense",
        "batch": 4096, "depth": 2, "timeout": 1200.0},
    # blended tensor + per-pod oracle: the Gt node-affinity pods escape
    # (pct_nodes: percentageOfNodesToScore for the escaped pods' cycles)
    "SchedulingMixedEscapes": {"workload": "SchedulingMixedEscapes",
                               "batch": 16384, "depth": 2, "pct_nodes": 2},
    # the overload acceptance row: the full policy against a seeded chaos
    # schedule of slow and all-escape waves
    "SchedulingOverloadFlood": {"workload": "SchedulingOverloadFlood",
                                "batch": 4096, "depth": 2,
                                "timeout": 1200.0, "overload": True},
    # topology churn at the workload's own scale, the default overload
    # policy (engagement auto) as the churn-storm tier runs it
    "SchedulingChurnStorm": {"workload": "SchedulingChurnStorm",
                             "batch": 4096, "depth": 2,
                             "overload": "default"},
    # the device-worker seam's cost: identical plain batches through the
    # in-process backend and through a gRPC device worker (run_seam)
    "RemoteSeamGrpc": {"seam": "grpc", "timeout": 600.0},
    # the same seam under seeded chaos: drops, delays, corrupt frames, one
    # worker kill and resync, and an outage that trips the breaker into
    # the in-process rung and back (ops/faults.py, ops/failover.py)
    "RemoteSeamFaulty": {"seam": "grpc", "faulty": True, "timeout": 900.0},
}

# run_seam's sizes: bench.py's run_seam_micro (BENCH_SEAM_NODES and
# BENCH_SEAM_BATCH defaults, six rounds) and its fault schedule's seed,
# rates, kill and outage
SEAM_NODES = 5000
SEAM_BATCH = 4096
SEAM_ROUNDS = 6


def overload_shape(batch: int):
    """bench.py's SchedulingOverloadFlood knobs: a policy sized against the
    flood (cap = a few waves of backlog), engagement pinned always-on so
    the row measures the protection layers, and the seeded chaos schedule
    (slow waves and adversarial all-escape waves)."""
    from ..ops.faults import OverloadSchedule
    from ..scheduler.config import OverloadPolicy
    policy = OverloadPolicy(
        engagement="always", queue_cap=4 * batch,
        shed_protect_priority=1000,   # the workload's hipri- pods
        shed_protect_age=30.0, slo_p99_ms=250.0,
        wave_min=max(16, batch // 64), wave_increase=max(32, batch // 32),
        escape_rate_threshold=0.5, escape_min_batch=64,
        breaker_threshold=1, breaker_probe_interval=0.5,
        wave_deadline=120.0)
    chaos = OverloadSchedule(seed=42, slow_rate=0.05, slow_s=0.05,
                             all_escape_rate=0.1)
    return policy, chaos


def scaled_timeout(pods: int, base: float = 900.0) -> float:
    """Barrier budget: the config's timeout, or more for large pod counts
    (the JAX bench's rule: 60 s plus 100 pods/s)."""
    return max(base, 60.0 + pods / 100.0)


def check_placements(store: kv.MemoryStore, created: int | None = None,
                     removed_nodes_ok: bool = False) -> dict:
    """What the store holds after a run, independent of the backend: pods
    present and bound, pods deleted (`created` minus present, when given:
    preemption's victims), the nodes in use, the most pods on one node, and
    the nodes whose bound pods' requests exceed their allocatable CPU,
    memory or pod count.  A pod bound to a node the store no longer holds
    counts as over capacity, unless removed_nodes_ok (a workload that
    deletes nodes under bound pods, as the node storm's drains do): then
    such pods are counted in on_removed_nodes instead."""
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
    removed = {n: u[2] for n, u in used.items() if n not in alloc} \
        if removed_nodes_ok else {}
    for n in removed:
        del used[n]
    over = [n for n, (cpu, mem, cnt) in used.items()
            if n not in alloc or cpu > alloc[n].milli_cpu
            or mem > alloc[n].memory or cnt > alloc[n].allowed_pod_number]
    out = {"pods": len(pods), "bound": bound,
           "deleted": None if created is None else created - len(pods),
           "nodes_used": len(used),
           "max_pods_per_node": max((u[2] for u in used.values()),
                                    default=0),
           "nodes_over_capacity": len(over), "over_examples": over[:5]}
    if removed_nodes_ok:
        out["on_removed_nodes"] = sum(removed.values())
    return out


class BindLedger:
    """Exactly-once bind ledger over the store's pods watch: replays the
    stream and flags any pod whose nodeName, once set, changes to another
    node (a double bind).  since_rv=0 replays the store's history from
    the start; drain once after the run (the watch buffers the stream)."""

    def __init__(self, store: kv.MemoryStore, since_rv: int | None = None):
        self._watch = store.watch(PODS, since_rv=since_rv)
        self.bound: dict[str, str] = {}
        self.rebinds: list[tuple[str, str, str]] = []

    def drain(self) -> None:
        while True:
            evs = self._watch.next_batch(timeout=0.0)
            if not evs:
                return
            for ev in evs:
                md = ev.object["metadata"]
                k = f"{md.get('namespace', '')}/{md['name']}"
                if ev.type == kv.DELETED:
                    self.bound.pop(k, None)
                    continue
                node = (ev.object.get("spec") or {}).get("nodeName")
                if node and self.bound.setdefault(k, node) != node:
                    self.rebinds.append((k, self.bound[k], node))

    def stop(self) -> None:
        self._watch.stop()


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


def profiled_op(tpl: list[dict]) -> dict | None:
    """What profile_batch's pods copy for a workload template: its measured
    createPods op, or None (SchedulingBasic's shape, which must bind) when
    that op's pods are plain."""
    measured = next(op for op in tpl if is_measured(op, tpl))
    plain = not any(k in measured for k in (
        "podTemplate", "podGroups", "escapeEvery", "distinctServices",
        "namespaceRoundRobin"))
    return None if plain else measured


def profile_batch(cluster, batch: int, label: str, op: dict | None = None,
                  timeout: float = 120.0) -> dict:
    """One more batch through the running Scheduler under torch.profiler
    (CPU and CUDA activities): wall from the create to the batch's last
    scheduling attempt, the device busy time of the kernels and copies in
    it, and the device's idle share (1 - busy / wall).  The pods are
    `batch` of SchedulingBasic's shape, which must all bind, or of the
    createPods op `op` (a workload's measured pods), which may also end
    unschedulable.  Gang pods and pods that keep one another off a host
    (required anti-affinity on one selector, as in a cluster the run left
    full of them) go to a namespace of their own, where their groups and
    terms count only each other; their pod groups are created first.
    Other pods join the run's namespace, so they add no selector group.
    Returns {pods, wall_ms, busy_ms, idle_share, waves, events, top:
    [(device ms, count, name)], done, window: (start, end) as
    time.monotonic() readings}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ..client.clientset import PODGROUPS
    from .scheduler_perf import _default_pod
    sched = cluster.scheduler
    backend = sched.profiles["default-scheduler"].batch_backend
    plain = op is None
    op = {k: v for k, v in copy.deepcopy(op or {}).items()
          if not k.startswith("_")}
    op["podNamePrefix"] = f"prof-{label}-"
    anti = (((op.get("podTemplate") or {}).get("spec") or {})
            .get("affinity") or {}).get("podAntiAffinity")
    if "podGroups" in op or (anti and "distinctServices" not in op):
        op["namespace"] = f"prof-{label.lower()}"
    pg = op.get("podGroups")
    if pg:
        size = pg.get("minMember", 10)
        batch -= batch % size
        for g in range(batch // size):
            obj = meta.new_object(
                "PodGroup", f"{pg.get('namePrefix', 'pg-')}{g}",
                op["namespace"])
            obj["spec"] = {"minMember": size, "scheduleTimeoutSeconds": 120}
            cluster.client.create(PODGROUPS, obj)
    pods = [_default_pod(i, op) for i in range(batch)]

    def attempted():
        with sched.metrics.lock:
            a = sched.metrics.schedule_attempts
            return a.get("scheduled", 0) + (
                0 if plain else a.get("unschedulable", 0))

    cuda = torch.cuda.is_available()
    base, w0 = attempted(), backend.stats.get("waves", 0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        cluster.client.create_bulk(PODS, pods)
        deadline = t0 + timeout
        while attempted() < base + batch and time.monotonic() < deadline:
            time.sleep(0.002)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.monotonic()
        wall_ms = (t1 - t0) * 1e3
    # device events only; the full step's record_function ranges
    # ("full.*") repeat the time of the kernels inside them
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and e.self_device_time_total > 0
                   and not e.key.startswith("full.")), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return {"pods": batch, "wall_ms": round(wall_ms, 3),
            "busy_ms": round(busy_ms, 3),
            "idle_share": round(1 - busy_ms / wall_ms, 4),
            "waves": backend.stats.get("waves", 0) - w0,
            "events": sum(r[1] for r in rows), "top": rows[:8],
            "done": attempted() >= base + batch, "window": (t0, t1)}


def run_once(workload: str, nodes: int | None, pods: int | None,
             batch: int, barrier_timeout: float = 900.0,
             rate: float | None = None, depth: int = 1,
             admission_ms: float = 0.0, device=None, after=None,
             null_device: bool = False, pct_nodes: int = 0,
             overload=None, profile_pods: int = 0, tracing_provider=None,
             profiling_policy=None, remote_seam: str | None = None,
             backend_kind: str = "tpu", mesh=None,
             via_http=False) -> dict:
    """One full workload pass in this process (the JAX bench's run_once,
    device-backed by TorchBatchBackend on `device`; null_device=True nulls
    the device step instead).  pct_nodes is the profile's
    percentageOfNodesToScore (0: adaptive); overload=True runs
    overload_shape's policy and chaos schedule, overload="default" the
    default OverloadPolicy without chaos.  profile_pods > 0 runs one more
    batch of that many of the workload's measured pods after `after`,
    under torch.profiler (profile_batch; the row's profiled_batch: device
    busy ms and idle share).  `tracing_provider` traces the batches and
    `profiling_policy` (a ProfilingPolicy) arms the profiling: stanza
    (census, timeline, sampler) as run_named_workload does; `remote_seam`
    ("http", "grpc" or a worker's URL) runs the batch backend behind the
    device worker seam (setup_cluster); `backend_kind` "sharded" runs
    ShardedTorchBatchBackend on `mesh` (default: a mesh of `device`) with
    the census and the timeline armed, as bench.py's headline does (the
    row gains tpu_wave_collective_bytes, device_idle_share and the
    latency decomposition); with the
    sampling host profiler armed (`enabled`) its per-stage host seconds
    land in the row as host_stages (they count a thread's samples whether
    it runs or waits) and each thread's CPU seconds over the run are read
    before the shutdown (thread_cpu_s).  `via_http` (True, or "process")
    puts the apiserver between the scheduler and its store
    (setup_cluster); the placements are then read through the cluster's
    store.  `after(cluster)` runs once the
    workload's stats and the store's placements are read.  Returns
    {"value", "wall_s", "detail", "stats"}, plus "error" when the barrier
    failed."""
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
    storm = [op for op in tpl if op["opcode"] == "nodeStorm"]
    # a node storm grows the cluster up to its maxNodes (the harness's
    # default: twice the created nodes): size the caps for that
    caps_nodes = max([n_nodes] + [op.get("maxNodes", 2 * n_nodes)
                                  for op in storm])
    policy = chaos = None
    if overload == "default":
        from ..scheduler.config import OverloadPolicy
        policy = OverloadPolicy()
    elif overload:
        policy, chaos = overload_shape(batch)
    host_profile = profiling_policy is not None and profiling_policy.enabled
    cpu: dict[str, float] = {}
    placements: dict = {}
    profiled: dict = {}

    def after_run(cluster):
        # the store as the workload left it, before `after` adds to it
        placements.update(check_placements(cluster.store, n_created,
                                           removed_nodes_ok=bool(storm)))
        if host_profile:
            cpu.update(thread_cpu_seconds())
        if after is not None:
            after(cluster)
        if profile_pods:
            profiled.update(profile_batch(
                cluster, min(batch, profile_pods), workload,
                op=profiled_op(tpl)))
    sharded = backend_kind == "sharded"
    if sharded:
        # bench.py's headline arms the census and the timeline
        # (bench.py:1615-1624)
        from ..scheduler.config import ProfilingPolicy
        profiling_policy = ProfilingPolicy(
            enabled=bool(profiling_policy and profiling_policy.enabled),
            census=True, timeline=True)
    # via_http builds the store behind its apiserver
    store = None if via_http else kv.MemoryStore(history=1_000_000)
    t0 = time.monotonic()
    summary, stats = run_named_workload(
        cfg, caps=caps_for_nodes(caps_nodes), batch_size=batch,
        pipeline_depth=depth, admission_interval=admission_ms / 1e3,
        null_device=null_device, percentage_of_nodes_to_score=pct_nodes,
        overload=policy, chaos_schedule=chaos, device=device, store=store,
        profiling_policy=profiling_policy, tracing_provider=tracing_provider,
        remote_seam=remote_seam, after=after_run,
        backend_kind=backend_kind, mesh=mesh, via_http=via_http)
    wall = time.monotonic() - t0
    detail = summary.to_dict()
    detail["placements"] = placements
    bstats = stats.get("backend_stats") or {}
    if "waves" in bstats and bstats.get("batches"):
        detail["waves_per_batch"] = round(
            bstats["waves"] / bstats["batches"], 3)
        detail["full_batches"] = bstats["batches"] - bstats.get("plain", 0)
    if profiled:
        detail["profiled_batch"] = {k: v for k, v in profiled.items()
                                    if k not in ("top", "window")}
        detail["profiled_batch"]["top"] = [
            [round(ms, 3), n, name[:60]] for ms, n, name in profiled["top"]]
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
    for key in ("overload", "chaos_injected", "storm"):
        if key in stats:
            detail[key] = stats[key]
    if null_device:
        detail["backend"] = "null"
    if sharded:
        detail["backend"] = "sharded"
        detail.update(_sharded_detail(stats))
    detail["schedule_attempts"] = stats.get("schedule_attempts")
    for key in ("setup_s", "create_nodes_s", "flatten_before_window_s"):
        detail[key] = round(stats.get(key, 0.0), 3)
    # diagnostics: per-batch stage latencies (KTPU_STAGE_DEBUG=1) and the
    # sampling profiler's host seconds per pipeline stage
    for key in ("stage_latency", "host_stages"):
        if key in stats:
            detail[key] = stats[key]
    if cpu:
        detail["thread_cpu_s"] = cpu
    return {"value": summary.average, "wall_s": round(wall, 1),
            "detail": detail, "stats": stats, "nodes": n_nodes,
            "pods": n_measured}


def _sharded_detail(stats: dict) -> dict:
    """The sharded row's census gauges and timeline read-out, as bench.py's
    run_once puts them in its row (bench.py:1352-1374)."""
    out = {}
    gauges: dict[str, dict] = {}
    for kind, recs in (stats.get("device_census") or {}).items():
        for variant, rec in recs.items():
            per_wave, per_call = profiling.collective_bytes_by_op(rec)
            gauges[f"{kind}-{variant}"] = {
                "per_wave_bytes": rec.get("per_wave_bytes", 0),
                "tpu_wave_collective_bytes": per_wave,
                "tpu_step_collective_bytes": per_call,
                "mesh_devices": rec.get("mesh_devices")}
    if gauges:
        out["tpu_wave_collective_bytes"] = gauges
    tl = stats.get("timeline")
    if tl:
        out["device_idle_share"] = tl.get("device_idle_share")
        out["stage_overlap"] = tl.get("overlap")
        out["latency_decomposition"] = tl.get("segments")
        out["timeline_intervals"] = tl.get("intervals")
    return out


def row(value: float, nodes: int, pods: int, batch: int,
        extra: dict) -> dict:
    """bench.py's row shape."""
    return {"metric": "scheduler_perf_throughput",
            "value": round(value, 1), "unit": "pods/s",
            "vs_baseline": round(value / BASELINE_PODS_PER_SEC, 2),
            "detail": {"nodes": nodes, "pods": pods, "batch": batch,
                       **extra}}


def pass_args(name: str, nodes: int | None = None, pods: int | None = None,
              batch: int | None = None) -> dict:
    """run_once's keyword arguments for one pass of a named config (sizes
    optionally overridden)."""
    c = {**CONFIGS[name]}
    for key, val in (("nodes", nodes), ("pods", pods), ("batch", batch)):
        if val is not None:
            c[key] = val
    return dict(workload=c["workload"], nodes=c.get("nodes"),
                pods=c.get("pods"), batch=c["batch"],
                barrier_timeout=c.get("timeout", 900.0), rate=c.get("rate"),
                depth=c.get("depth", 1),
                admission_ms=c.get("admission_ms", 0.0),
                null_device=bool(c.get("null")),
                pct_nodes=c.get("pct_nodes", 0), overload=c.get("overload"),
                via_http=_VIA_HTTP[c.get("http", False)])


# a row's "http" (bench.py's spelling) -> setup_cluster's via_http
_VIA_HTTP = {False: False, True: True, "proc": "process"}


class BenchFaultSchedule(FaultSchedule):
    """bench.py's _BenchFaultSchedule: seeded weather (seed 42: 2% drops,
    5% delays of 5 ms, 2% corrupt frames), one worker kill at the 3rd
    /step (the untimed warm round) and one hard outage from the 8th /step
    on, every call dropped for (max_retries + 1) * failure_threshold = 4
    calls: enough to open the breaker, gone by the first probe."""

    def __init__(self):
        super().__init__(seed=42, drop_rate=0.02, delay_rate=0.05,
                         corrupt_rate=0.02, delay_s=0.005)
        self.steps = 0
        self.killed = False
        self.outage_from: int | None = None
        self.outage_calls = 4

    def action(self, i, verb):
        if verb.startswith("/step"):
            self.steps += 1
            if self.steps == 3 and not self.killed:
                self.killed = True
                self.rng.random()
                return KILL
            if self.steps == 8 and self.outage_from is None:
                self.outage_from = i
        if (self.outage_from is not None
                and i < self.outage_from + self.outage_calls):
            self.rng.random()
            return DROP
        return super().action(i, verb)


def run_seam(kind: str = "grpc", faulty: bool = False, device=None,
             nodes: int | None = None, batch: int | None = None,
             rounds: int = SEAM_ROUNDS, worker_url: str | None = None
             ) -> dict:
    """The seam rows (bench.py's run_seam_micro): `rounds` batches of
    `batch` plain pods (10m, 16Mi) on `nodes` nodes (64 CPU, 256Gi, 1,000
    pods), assign() through a RemoteTorchBatchBackend and then through an
    in-process TorchBatchBackend on `device`, the first round of each
    untimed; pods/s both ways and their ratio.  The worker is an
    in-process DeviceWorker ("http") or GrpcDeviceWorker ("grpc") on
    `device`, or the one at `worker_url` (another process).  Returns the
    row's detail plus `placements` (node names per round, each way) and
    `assignments_equal`.

    faulty=True drives the remote rung through FaultyTransport under
    BenchFaultSchedule behind a FailoverBatchBackend [remote, in-process
    on `device`] (breaker threshold 2, probe 0.2 s; RemoteSeamPolicy with
    one retry), retrying a failed batch as the scheduler's requeue does,
    then untimed 64-pod rounds until the breaker fails back; the detail
    adds the ladder's counters, the breakers, the injected faults, the
    requeues, which rung served each round (`served_by`) and whether the
    remote rung's rounds before the outage equal the in-process run's
    (`remote_rounds_equal`: the resync after the kill rebuilt the state
    bit for bit)."""
    from ..ops.backend import TorchBatchBackend
    from ..ops.flatten import Caps
    from ..ops.remote import RemoteTorchBatchBackend, make_worker
    from ..scheduler.cache import Cache, Snapshot
    from ..scheduler.types import PodInfo
    from ..testing import make_node, make_pod

    n_nodes = nodes or SEAM_NODES
    n_batch = batch or SEAM_BATCH
    caps = Caps(n_cap=max(1024, -(-int(n_nodes * 1.1) // 256) * 256),
                l_cap=128, kl_cap=62, t_cap=16, pt_cap=16,
                s_cap=3, sg_cap=16, asg_cap=16)
    cache = Cache()
    cache.add_nodes([make_node(f"n{i}").capacity(cpu="64", mem="256Gi",
                                                 pods=1000).build()
                     for i in range(n_nodes)])
    snap = cache.update_snapshot(Snapshot())

    def batches(tag, count=n_batch, n=rounds):
        return [[PodInfo(make_pod(f"{tag}{r}-{i}").req(cpu="10m",
                                                        mem="16Mi").build())
                 for i in range(count)] for r in range(n)]

    def drive(backend, tag, assign):
        backend.warmup()
        names = [[nm for nm, _ in assign(b)] for b in batches(tag)[:1]]
        t0 = time.monotonic()
        for b in batches(tag)[1:]:
            names.append([nm for nm, _ in assign(b)])
        rate = (rounds - 1) * n_batch / (time.monotonic() - t0)
        return names, rate

    if faulty and worker_url:
        raise ValueError("run_seam: the faulty row kills the worker in "
                         "process; it takes no worker_url")
    worker = None
    if worker_url is None:
        worker = make_worker(kind, device=device).start()
        worker_url = worker.url
    detail: dict = {}
    try:
        if faulty:
            names, remote_rate, detail = _drive_faulty(
                worker, caps, n_batch, device, batches, drive, snap)
        else:
            remote = RemoteTorchBatchBackend(worker_url, caps,
                                             batch_size=n_batch)
            try:
                names, remote_rate = drive(
                    remote, "r", lambda b: remote.assign(b, snap))
            finally:
                remote.close()
    finally:
        if worker is not None:
            worker.stop()
    local = TorchBatchBackend(caps, batch_size=n_batch, device=device)
    local_names, local_rate = drive(local, "l",
                                    lambda b: local.assign(b, snap))
    out = {"seam": kind + ("_faulty" if faulty else ""),
           "nodes": n_nodes, "batch": n_batch, "rounds": rounds,
           "inproc_pods_per_s": round(local_rate, 1),
           "remote_pods_per_s": round(remote_rate, 1),
           "seam_cost_ratio": round(local_rate / max(remote_rate, 1e-9), 4),
           "placed": [sum(1 for nm in r if nm) for r in names],
           "assignments_equal": names == local_names, **detail,
           "placements": {"remote": names, "inproc": local_names}}
    if faulty:
        served = detail["served_by"]
        before = [r for r in range(rounds) if served[r] == "remote"
                  and all(s == "remote" for s in served[:r + 1])]
        out["remote_rounds_equal"] = bool(before) and all(
            names[r] == local_names[r] for r in before)
    return out


def _drive_faulty(worker, caps, n_batch, device, batches, drive, snap):
    """run_seam's faulty remote half: (names per round, pods/s, detail)."""
    from ..ops.backend import TorchBatchBackend
    from ..ops.failover import FailoverBatchBackend
    from ..ops.faults import FaultyTransport
    from ..ops.remote import RemoteTorchBatchBackend, transport_for
    from ..scheduler.config import RemoteSeamPolicy
    from ..scheduler.scheduler import BackendUnavailableError
    from ..scheduler.types import PodInfo
    from ..testing import make_pod

    schedule = BenchFaultSchedule()
    transport = FaultyTransport(transport_for(worker.url), schedule,
                                on_kill=worker.simulate_restart)
    policy = RemoteSeamPolicy(max_retries=1, retry_base=0.01, retry_max=0.05,
                              probe_interval=0.2)
    remote = RemoteTorchBatchBackend(worker.url, caps, batch_size=n_batch,
                                     transport=transport, policy=policy)
    ladder = FailoverBatchBackend(
        [("remote", remote),
         ("inproc", TorchBatchBackend(caps, batch_size=n_batch,
                                      device=device))],
        failure_threshold=2, probe_interval=0.2)
    requeues = 0
    served = []

    def assign_retry(batch):
        # the scheduler's requeue loop in miniature: a failed batch
        # re-enters with backoff until a rung serves it
        nonlocal requeues
        for _ in range(20):
            r0 = remote.stats["batches"]
            try:
                out = ladder.assign(batch, snap)
            except BackendUnavailableError:
                requeues += 1
                time.sleep(0.02)
                continue
            served.append("remote" if remote.stats["batches"] > r0
                          else "inproc")
            return out
        raise RuntimeError("bench: batch never recovered")

    try:
        names, rate = drive(ladder, "r", assign_retry)
        # recovery rounds (untimed): wait out probe windows until the
        # breaker half-opens, probes the recovered worker and fails back
        for n in range(5):
            time.sleep(policy.probe_interval + 0.05)
            assign_retry([PodInfo(make_pod(f"rrec{n}-{i}").req(
                cpu="10m", mem="16Mi").build()) for i in range(64)])
            if ladder.breaker_state().get("remote") == 0.0:
                break
    finally:
        remote.close()
    return names, rate, {"failover": ladder.seam_snapshot(),
                         "breakers": ladder.breaker_state(),
                         "injected": dict(transport.injected),
                         "bench_requeues": requeues, "served_by": served}


def seam_row(name: str, device=None, nodes: int | None = None,
             batch: int | None = None, kind: str | None = None,
             worker_url: str | None = None) -> dict:
    """A seam config's row: run_seam at its parameters (`kind` overrides
    the transport, `worker_url` drives a worker in another process),
    pods/s through the seam as the value; the per-round placements are
    left out of the row."""
    c = CONFIGS[name]
    res = run_seam(kind or c["seam"], bool(c.get("faulty")), device,
                   nodes, batch, worker_url=worker_url)
    extra = {"config": name,
             **{k: v for k, v in res.items() if k != "placements"}}
    bad = (not res["assignments_equal"] if not c.get("faulty") else not (
        res["remote_rounds_equal"]
        and res["breakers"].get("remote") == 0.0))
    if bad or min(res["placed"]) < res["batch"]:
        extra["error"] = "seam row check failed"
    return row(res["remote_pods_per_s"], res["nodes"],
               res["rounds"] * res["batch"], res["batch"], extra)


def run_config(name: str, device=None, nodes: int | None = None,
               pods: int | None = None, batch: int | None = None,
               profiling_policy=None, after=None,
               profile_pods: int = 0, remote_seam: str | None = None,
               backend_kind: str = "tpu", mesh=None,
               passes: int | None = None) -> tuple:
    """Run a named config (sizes optionally overridden); returns (the row,
    every pass's run_once result in run order).  A two_pass config runs
    twice (`passes` overrides the count); the row keeps the better pass (the higher pods/s, or for a
    paced config the lower p99) and puts the other in
    detail.second_pass.  A pass that failed makes the row's error, even
    when the other pass is the one kept.  `after` runs after each
    pass; `remote_seam`, `backend_kind` and `mesh` go to run_once.  A
    seam config (RemoteSeamGrpc,
    RemoteSeamFaulty) runs seam_row instead: (the row, [])."""
    if "seam" in CONFIGS[name]:
        return seam_row(name, device, nodes, batch), []
    args = pass_args(name, nodes, pods, batch)
    paced = bool(args["rate"])
    results = [run_once(**args, device=device,
                        profiling_policy=profiling_policy, after=after,
                        profile_pods=profile_pods, remote_seam=remote_seam,
                        backend_kind=backend_kind, mesh=mesh)
               for _ in range(passes or (2 if CONFIGS[name].get("two_pass")
                                         else 1))]

    def worse(r):
        if "error" in r:
            return (1, 0.0)
        if paced:
            return (0, r["detail"].get("pod_e2e_p99_ms") or 1e12)
        return (0, -r["value"])
    res = min(results, key=worse)
    extra = {"config": name, "wall_s": res.get("wall_s"), **res["detail"]}
    for other in results:
        if other is not res:
            extra["second_pass"] = {
                "pods_per_s": round(other["value"], 1),
                "p99_ms": other["detail"].get("pod_e2e_p99_ms"),
                "wall_s": other.get("wall_s")}
            if "error" in other:
                extra["second_pass"]["error"] = other["error"]
    errors = [r["error"] for r in results if "error" in r]
    if errors:
        extra["error"] = errors[0]
    return row(res["value"], res["nodes"], res["pods"], args["batch"],
               extra), results


ARTIFACT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def _basic_large(nodes: int, pods: int) -> dict:
    """SchedulingBasicLarge at `nodes` nodes and `pods` measured pods."""
    cfg = copy.deepcopy(load_workloads()["SchedulingBasicLarge"])
    tpl = cfg["workloadTemplate"]
    for op in tpl:
        if op["opcode"] == "createNodes":
            op["count"] = nodes
        elif op["opcode"] == "createPods" and is_measured(op, tpl):
            op["count"] = pods
        elif op["opcode"] == "barrier":
            op["timeout"] = 600.0
    return cfg


def _observatory_passes(policy, nodes: int, pods: int, batch: int, device,
                        between) -> tuple:
    """The armed pass, then the same pass with the stanza off: (armed
    summary, armed stats, off summary, what `between()` returned; it runs
    between the two passes)."""
    caps = caps_for_nodes(nodes)
    summary_a, stats_a = run_named_workload(
        _basic_large(nodes, pods), caps=caps, batch_size=batch,
        pipeline_depth=2, profiling_policy=policy, device=device)
    taken = between()
    summary_u, _ = run_named_workload(
        _basic_large(nodes, pods), caps=caps, batch_size=batch,
        pipeline_depth=2, device=device)
    return summary_a, stats_a, summary_u, taken


def _write_artifact(out_path: str, doc: dict) -> str:
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    return out_path


def run_profile(out_path: str | None = None, device=None, nodes: int = 1000,
                pods: int = 5000, batch: int = 1024) -> dict:
    """--profile: the performance observatory's read-out.  One
    SchedulingBasicLarge pass with the profiling: stanza on (the host
    sampler, the device census of both step variants and the SLO
    tracker), then the same pass with it off, for the overhead.  The
    artifact holds the row (per-stage host seconds, the census summary,
    SLO quantiles and burn rates), the full census and the collapsed
    stacks."""
    from ..scheduler.config import ProfilingPolicy
    out_path = out_path or os.path.join(ARTIFACT_DIR,
                                        "profile_SchedulingBasicLarge.json")
    summary_p, stats_p, summary_u, collapsed = _observatory_passes(
        ProfilingPolicy(enabled=True, census=True), nodes, pods, batch,
        device, between=profiling.default_host_profiler.collapsed)
    census = stats_p.get("device_census") or {}
    census_summary: dict[str, dict] = {}
    for label, variants in census.items():
        for variant, rec in variants.items():
            per_wave, per_call = profiling.collective_bytes_by_op(rec)
            census_summary[f"{label}-{variant}"] = {
                "per_wave_bytes": rec.get("per_wave_bytes", 0),
                "per_call_bytes": rec.get("per_call_bytes", 0),
                "wave_collective_bytes": per_wave,
                "step_collective_bytes": per_call,
                **(rec.get("cost") or {}), "waves": rec.get("waves"),
                "device_ms": rec.get("device_ms"),
                "kernels": rec.get("kernels")}
    e2e = stats_p.get("e2e") or {}
    out = {"nodes": nodes, "pods": pods, "batch": batch,
           "pods_per_s": round(summary_p.average, 1),
           "p50_ms": e2e.get("p50_ms"), "p95_ms": e2e.get("p95_ms"),
           "p99_ms": e2e.get("p99_ms"),
           "host_stages": stats_p.get("host_stages"),
           "profile_samples": stats_p.get("profile_samples"),
           "slo": stats_p.get("slo"), "census": census_summary}
    path = _write_artifact(out_path, {
        "rows": [out], "device_census": census,
        "hot_stacks": stats_p.get("hot_stacks"),
        "collapsed_stacks": collapsed})
    return {**out, "profile_file": path,
            "profiled_pods_per_s": round(summary_p.average, 1),
            "unprofiled_pods_per_s": round(summary_u.average, 1),
            "overhead_ratio": round(summary_u.average
                                    / max(summary_p.average, 1e-9), 3),
            "barrier_ok": stats_p.get("barrier_ok", False)}


def run_timeline(out_path: str | None = None, device=None, nodes: int = 1000,
                 pods: int = 5000, batch: int = 1024) -> dict:
    """--timeline: the wave timeline's read-out.  One SchedulingBasicLarge
    pass with profiling.timeline armed (the interval ring and the per-pod
    decomposition), then the same pass with it off, for the overhead.
    The artifact holds the row (the union-derived device idle share,
    per-stage overlap ratios, per-segment latency quantiles) and the
    Perfetto-loadable Chrome trace of the ring."""
    from ..component_base import timeline as cb_timeline
    from ..scheduler.config import ProfilingPolicy
    out_path = out_path or os.path.join(ARTIFACT_DIR,
                                        "timeline_SchedulingBasicLarge.json")
    ring = cb_timeline.default_timeline

    def take_and_disarm():
        # the backend records while the process-wide ring is armed, so the
        # off pass needs it disarmed
        doc = ring.to_chrome_trace()
        ring.configure(enabled=False)
        return doc

    summary_t, stats_t, summary_u, trace_doc = _observatory_passes(
        ProfilingPolicy(timeline=True), nodes, pods, batch, device,
        between=take_and_disarm)
    tl = stats_t.get("timeline") or {}
    e2e = stats_t.get("e2e") or {}
    out = {"nodes": nodes, "pods": pods, "batch": batch,
           "pods_per_s": round(summary_t.average, 1),
           "p50_ms": e2e.get("p50_ms"), "p95_ms": e2e.get("p95_ms"),
           "p99_ms": e2e.get("p99_ms"),
           "device_idle_share": tl.get("device_idle_share"),
           "stages": tl.get("stages"),
           "stage_overlap": tl.get("overlap"),
           "latency_decomposition": tl.get("segments"),
           "timeline_intervals": tl.get("intervals"),
           "pods_decomposed": tl.get("pods_decomposed")}
    path = _write_artifact(out_path, {"rows": [out],
                                      "chrome_trace": trace_doc})
    return {**out, "timeline_file": path,
            "timed_pods_per_s": round(summary_t.average, 1),
            "untimed_pods_per_s": round(summary_u.average, 1),
            "overhead_ratio": round(summary_u.average
                                    / max(summary_t.average, 1e-9), 3),
            "barrier_ok": stats_t.get("barrier_ok", False)}


def run_trace(out_path: str | None = None, device=None, nodes: int = 1000,
              pods: int = 5000, batch: int = 1024, seam: str = "grpc"
              ) -> dict:
    """--trace (bench.py's run_trace): one SchedulingBasicLarge pass over
    the `seam` device worker (gRPC unless --seam http) with every batch
    traced, written as Chrome trace-event JSON (chrome://tracing,
    Perfetto) holding both sides of the seam: the scheduler's spans and
    the worker's worker.<verb> spans, parented into the same traces by the
    propagated traceparent; then the same pass untraced, for the
    overhead."""
    from ..component_base import tracing
    out_path = out_path or os.path.join(ARTIFACT_DIR,
                                        "trace_SchedulingBasicLarge.json")
    caps = caps_for_nodes(nodes)
    provider = tracing.TracerProvider(sampling_rate_per_million=1_000_000,
                                      max_spans=65536, max_traces=8192)
    summary_t, stats_t = run_named_workload(
        _basic_large(nodes, pods), caps=caps, batch_size=batch,
        pipeline_depth=2, remote_seam=seam, tracing_provider=provider,
        device=device)
    spans = provider.snapshot() + list(stats_t.get("worker_spans") or ())
    path = _write_artifact(out_path, tracing.to_chrome_trace(spans))
    summary_u, _ = run_named_workload(
        _basic_large(nodes, pods), caps=caps, batch_size=batch,
        pipeline_depth=2, remote_seam=seam, device=device)
    names: dict[str, int] = {}
    for sp in spans:
        names[sp.name] = names.get(sp.name, 0) + 1
    return {"nodes": nodes, "pods": pods, "batch": batch, "seam": seam,
            "trace_file": path, "events": len(spans),
            "span_names": dict(sorted(names.items())),
            "worker_spans_parented": sum(
                1 for sp in spans if sp.name.startswith("worker.")
                and sp.parent_span_id is not None),
            "traced_pods_per_s": round(summary_t.average, 1),
            "untraced_pods_per_s": round(summary_u.average, 1),
            "overhead_ratio": round(summary_u.average
                                    / max(summary_t.average, 1e-9), 3),
            "barrier_ok": stats_t.get("barrier_ok", False)}


# --instances N (bench.py's run_scaleout and its BENCH_SCALEOUT_* defaults)
SCALEOUT_NODES = 100_000
SCALEOUT_PODS = 200_000
SCALEOUT_BATCH = 16_384
SCALEOUT_TIMEOUT = 1200.0
SCALEOUT_CHUNK = 10_000


def shutdown_all(clusters) -> None:
    """Shut the instances of one store down together: one stopped while
    its peers still schedule lapses its lease under them, and their next
    tick would start a resync of the whole cluster during the teardown."""
    if clusters:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(clusters)) as pool:
            list(pool.map(lambda cl: cl.shutdown(), clusters))


def run_scaleout(max_instances: int, device=None,
                 nodes: int = SCALEOUT_NODES, pods: int = SCALEOUT_PODS,
                 batch: int = SCALEOUT_BATCH,
                 timeout: float = SCALEOUT_TIMEOUT, before=None,
                 after=None) -> dict:
    """--instances N: horizontal scale-out A/B (bench.py's run_scaleout).
    1, 2, ... N cooperating scheduler instances (each with its own
    informers, cache, queue and TorchBatchBackend on `device`, CUDA unless
    the caller names the CPU) share ONE MemoryStore, the Omega
    shared-state shape, and drain the Scheduling100k-scale flood together:
    `nodes` nodes of 64 CPU / 256Gi / 1,000 pods, then `pods` pods of
    10m / 16Mi, both created in chunks of 10,000, batch `batch`, depth 2.
    Instances >1 partition nodes AND pods over the scaleOut node-pool ring
    (ring_slices max(64, 16 n), the default leases), so the steady-state
    conflict rate should be ~0; every optimistic-bind loss that does
    happen is counted by scheduler_bind_conflict_total, read through
    federate_texts over every instance's exposition, and reported as
    conflict_rate (conflicted pod-events / pods).

    In-process by design, as bench.py's: N interpreters would each pay the
    device warmup, and the instances must share a store object.
    `before(n)` runs at the start of each pass, before its store exists;
    `after(n, row, clusters, store)` once its row is read, before its
    clusters shut down (chip_smoke.py checks placements there).
    Returns {"nodes", "pods", "batch", "BENCH_SCALEOUT": {str(n): row}}
    with bench.py's row keys (pods_per_s, wall_s, bound, conflicts,
    conflict_rate, speedup_vs_1; error when pods were left unbound)."""
    from ..client.clientset import LocalClient
    from ..component_base.profiling import federate_texts
    from ..scheduler.config import ScaleOutPolicy
    from ..testing import make_node, make_pod
    from . import caps_for_nodes
    from .scheduler_perf import ThroughputCollector, setup_cluster

    def one_pass(n: int) -> dict:
        if before is not None:
            before(n)
        store = kv.MemoryStore(history=2_000_000)
        admin = LocalClient(store)
        # each instance tracks only ~1/n of the ring, so its backend's
        # node capacity shrinks with n (1.6/n covers crc32 slice skew)
        caps = caps_for_nodes(
            nodes if n == 1 else min(nodes, int(nodes * 1.6 / n) + 256))
        clusters = []
        try:
            for i in range(n):
                cl = setup_cluster(caps=caps, batch_size=batch, store=store,
                                   pipeline_depth=2, device=device)
                clusters.append(cl)
                if n > 1:
                    cl.scheduler.configure_scaleout(ScaleOutPolicy(
                        instance_count=n, instance_index=i,
                        ring_slices=max(64, 16 * n)))
            for lo in range(0, nodes, SCALEOUT_CHUNK):
                admin.create_bulk(NODES, [
                    make_node(f"sn-{i}")
                    .capacity(cpu="64", mem="256Gi", pods=1000).build()
                    for i in range(lo, min(lo + SCALEOUT_CHUNK, nodes))])
            # let every instance fold its node partition into its host
            # tensors before the flood (same reason as the idle prefetch)
            time.sleep(1.0 + nodes / 50_000)
            collector = ThroughputCollector(store)
            collector.start()
            t0 = time.monotonic()
            for lo in range(0, pods, SCALEOUT_CHUNK):
                admin.create_bulk(PODS, [
                    make_pod(f"sp-{i}").req(cpu="10m", mem="16Mi").build()
                    for i in range(lo, min(lo + SCALEOUT_CHUNK, pods))])
            ok = False
            while time.monotonic() - t0 < timeout:
                if collector.bound_total() >= pods:
                    ok = True
                    break
                time.sleep(0.25)
            elapsed = time.monotonic() - t0
            collector.stop()
            # one merged view over every instance's /metrics exposition
            # text, through the parse-and-sum code an HTTP-pull federator
            # would run
            fleet = federate_texts(
                cl.scheduler.expose_metrics() for cl in clusters)
            conflicts = {
                labels[0]: v for labels, v in
                fleet.get("scheduler_bind_conflict_total", {}).items()}
            out = {"pods_per_s": round(pods / elapsed, 1) if ok else 0.0,
                   "wall_s": round(elapsed, 1),
                   "bound": collector.bound_total(),
                   "conflicts": {k: int(v) for k, v in
                                 sorted(conflicts.items())},
                   "conflict_rate": round(
                       sum(conflicts.values()) / max(pods, 1), 6)}
            if not ok:
                out["error"] = "pods left unscheduled"
            if after is not None:
                after(n, out, clusters, store)
            return out
        finally:
            shutdown_all(clusters)

    counts = [c for c in (1, 2, 4) if c <= max_instances]
    if max_instances not in counts:
        counts.append(max_instances)
    instances: dict[str, dict] = {}
    for n in counts:
        instances[str(n)] = one_pass(n)
    base = instances.get("1", {}).get("pods_per_s") or 0.0
    for out in instances.values():
        if base and out.get("pods_per_s"):
            out["speedup_vs_1"] = round(out["pods_per_s"] / base, 2)
    return {"nodes": nodes, "pods": pods, "batch": batch,
            "BENCH_SCALEOUT": instances}


# --processes N (bench.py's run_scaleout_proc and its BENCH_SCALEOUT_*
# environment defaults; the variables win over these, arguments over both)
SCALEOUT_PROC_NODES = 20_000
SCALEOUT_PROC_PODS = 60_000
SCALEOUT_PROC_BATCH = 4096
SCALEOUT_PROC_TIMEOUT = 1200.0


def await_bound(ledger, want: int, timeout: float) -> bool:
    """Poll the ledger until `want` pods are bound; False after
    `timeout` s."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if ledger.bound_total() >= want:
            return True
        time.sleep(0.25)
    return False


def create_flood_pods(admin, lo: int, hi: int) -> None:
    """Pods sp-lo .. sp-(hi - 1) of 10m / 16Mi, in chunks of 10,000."""
    from ..testing import make_pod
    for start in range(lo, hi, SCALEOUT_CHUNK):
        admin.create_bulk(PODS, [
            make_pod(f"sp-{i}").req(cpu="10m", mem="16Mi").build()
            for i in range(start, min(start + SCALEOUT_CHUNK, hi))])


def run_scaleout_proc(max_procs: int, nodes: int | None = None,
                      pods: int | None = None, batch: int | None = None,
                      timeout: float | None = None, backend: str = "null",
                      device=None, cluster_cls=None, child_env=None,
                      before=None, flooded=None, after=None) -> dict:
    """--processes N: PROCESS-TRUE scale-out A/B (bench.py's
    run_scaleout_proc).  Unlike --instances (N schedulers sharing one
    interpreter and one MemoryStore object), this spawns one apiserver
    process (kubernetes_tpu_torch.cmd.apiserver) plus 1, 2, ... N
    scheduler OS processes through the procrun supervisor: every
    list/watch/bind crosses an actual process boundary over HTTP, so the
    numbers carry serialization, socket and GIL-free costs the
    in-process row hides.

    `nodes` nodes of 64 CPU / 256Gi / 1,000 pods, then `pods` pods of
    10m / 16Mi, both created in chunks of 10,000, batch `batch`
    (defaults: BENCH_SCALEOUT_NODES/PODS/BATCH/TIMEOUT, else 20,000,
    60,000, 4,096 and 1,200 s).  Exactly-once is proved per pass by a
    store-watch WireBindLedger (zero double-binds, zero lost pods), and
    every multi-process count re-validates it under a seeded crash ->
    failover sub-pass: ScaleOutSchedule(seed=13) SIGKILLs child 0, then
    max(1000, pods // 20) more pods must bind.

    On the null device by default, as bench.py's row: the question it
    answers is whether the control plane scales across processes.
    `backend` "tpu" gives every child a TorchBatchBackend on `device`
    (None: the child's default, CUDA); `cluster_cls` replaces ProcCluster
    (a subclass whose children a harness wraps) and `child_env` is its
    per-child environment.  `before(n)` runs at the start of each pass,
    before its processes exist; `flooded(n, row, cluster)` once the
    flood's row is read, before the crash sub-pass; `after(n, row,
    cluster)` at the end of the pass, before its processes shut down.
    Returns {"nodes", "pods", "batch", "host_cores",
    "BENCH_SCALEOUT_PROC": {str(n): row}} with bench.py's row keys
    (pods_per_s, wall_s, bound, double_binds, conflicts, conflict_rate,
    speedup_vs_1, churn; error when pods were left unbound)."""
    from ..component_base.profiling import federate_texts
    from ..ops.faults import KILL_INSTANCE, ProcessChurner, ScaleOutSchedule
    from ..scheduler.procrun import ProcCluster, WireBindLedger
    from ..testing import make_node

    env = os.environ
    nodes = nodes or int(env.get("BENCH_SCALEOUT_NODES",
                                 SCALEOUT_PROC_NODES))
    pods = pods or int(env.get("BENCH_SCALEOUT_PODS", SCALEOUT_PROC_PODS))
    batch = batch or int(env.get("BENCH_SCALEOUT_BATCH",
                                 SCALEOUT_PROC_BATCH))
    timeout = timeout or float(env.get("BENCH_SCALEOUT_TIMEOUT",
                                       SCALEOUT_PROC_TIMEOUT))
    cluster_cls = cluster_cls or ProcCluster

    def doubles(ledger) -> int | str:
        try:
            ledger.assert_no_double_binds()
            return 0
        except AssertionError as e:  # record, don't abort the sweep
            return str(e)[:500]

    def one_pass(n: int) -> dict:
        if before is not None:
            before(n)
        cluster = cluster_cls(n, backend=backend, batch_size=batch,
                              nodes=nodes, device=device,
                              child_env=child_env)
        try:
            cluster.start()
            admin = cluster.admin_client()
            for lo in range(0, nodes, SCALEOUT_CHUNK):
                admin.create_bulk(NODES, [
                    make_node(f"sn-{i}")
                    .capacity(cpu="64", mem="256Gi", pods=1000).build()
                    for i in range(lo, min(lo + SCALEOUT_CHUNK, nodes))])
            # let every child replicate its node partition over the wire
            # before the flood (the in-process pass sleeps for the same
            # reason; here the watch stream adds HTTP latency on top)
            time.sleep(2.0 + nodes / 20_000)
            ledger = WireBindLedger(admin)
            t0 = time.monotonic()
            create_flood_pods(admin, 0, pods)
            ok = await_bound(ledger, pods, timeout)
            elapsed = time.monotonic() - t0
            fleet = federate_texts(cluster.metrics_texts())
            conflicts = {
                labels[0]: v for labels, v in
                fleet.get("scheduler_bind_conflict_total", {}).items()}
            out = {"pods_per_s": round(pods / elapsed, 1) if ok else 0.0,
                   "wall_s": round(elapsed, 1),
                   "bound": ledger.bound_total(),
                   "double_binds": doubles(ledger),
                   "conflicts": {k: int(v) for k, v in
                                 sorted(conflicts.items())},
                   "conflict_rate": round(
                       sum(conflicts.values()) / max(pods, 1), 6)}
            if not ok:
                out["error"] = "pods left unscheduled"
            if flooded is not None:
                flooded(n, out, cluster)
            # seeded crash->failover validation: SIGKILL one child, then
            # prove the survivors drain a fresh flood with the same
            # exactly-once guarantees (ledger stays live: it has seen
            # every bind since rv=0, so double-binds across the crash
            # boundary are visible too)
            if n > 1 and ok:
                churner = ProcessChurner(
                    cluster,
                    ScaleOutSchedule(seed=13, instance_count=n,
                                     script={0: (KILL_INSTANCE, 0)}),
                    min_live=1)
                applied = churner.step()
                extra = max(1000, pods // 20)
                create_flood_pods(admin, pods, pods + extra)
                c0 = time.monotonic()
                c_ok = await_bound(ledger, pods + extra, timeout)
                out["churn"] = {
                    "applied": list(applied) if applied else None,
                    "extra_pods": extra,
                    "bound_after": ledger.bound_total(),
                    "zero_lost": c_ok,
                    "double_binds": doubles(ledger),
                    "wall_s": round(time.monotonic() - c0, 1)}
            ledger.stop()
            if after is not None:
                after(n, out, cluster)
            return out
        finally:
            cluster.shutdown()

    counts = [c for c in (1, 2, 4) if c <= max_procs]
    if max_procs not in counts:
        counts.append(max_procs)
    procs: dict[str, dict] = {}
    for n in counts:
        procs[str(n)] = one_pass(n)
    base = procs.get("1", {}).get("pods_per_s") or 0.0
    for out in procs.values():
        if base and out.get("pods_per_s"):
            out["speedup_vs_1"] = round(out["pods_per_s"] / base, 2)
    return {"nodes": nodes, "pods": pods, "batch": batch,
            "host_cores": os.cpu_count(),
            "BENCH_SCALEOUT_PROC": procs}


def proc_row_failed(res: dict) -> bool:
    """A --processes pass that left a pod unbound, saw a double bind or
    lost a pod across its crash sub-pass."""
    for out in res["BENCH_SCALEOUT_PROC"].values():
        churn = out.get("churn", {"zero_lost": True, "double_binds": 0})
        if ("error" in out or out["double_binds"] != 0
                or not churn["zero_lost"] or churn["double_binds"] != 0):
            return True
    return False

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=["SchedulingBasic"], nargs="+",
                    choices=sorted(CONFIGS),
                    help="one or more rows, run in turn in this process, "
                         "one JSON line each")
    ap.add_argument("--device", default=None,
                    help="torch device of the batch backend (default cuda)")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--profile-pods", type=int, default=0,
                    help="after each pass, run one more batch of this "
                         "many of the workload's pods under "
                         "torch.profiler; the row gains profiled_batch "
                         "(device busy ms, idle share)")
    ap.add_argument("--host-profile", action="store_true",
                    help="sample the host threads; the row gains "
                         "host_stages (seconds per pipeline stage) and "
                         "thread_cpu_s (CPU seconds per thread)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--profile", action="store_true",
                      help="SchedulingBasicLarge with the profiling: "
                           "stanza (sampler, census, SLO) armed, then off; "
                           "writes the profile artifact to --out")
    mode.add_argument("--timeline", action="store_true",
                      help="SchedulingBasicLarge with profiling.timeline "
                           "armed, then off; writes the timeline artifact "
                           "to --out")
    mode.add_argument("--trace", action="store_true",
                      help="SchedulingBasicLarge over the device worker "
                           "seam, every batch traced, then untraced; "
                           "writes the Chrome trace to --out")
    mode.add_argument("--instances", type=int, nargs="?", const=2,
                      default=None, metavar="N",
                      help="horizontal scale-out: 1, 2, 4 and N scheduler "
                           "instances over one store (bench.py's "
                           "--instances; 100,000 nodes, 200,000 pods, "
                           "batch 16,384 unless --nodes/--pods/--batch)")
    mode.add_argument("--processes", type=int, nargs="?", const=2,
                      default=None, metavar="N",
                      help="process-true scale-out: an apiserver process "
                           "and 1, 2, 4 and N scheduler processes on the "
                           "null device (bench.py's --processes; 20,000 "
                           "nodes, 60,000 pods, batch 4,096 unless "
                           "BENCH_SCALEOUT_NODES/PODS/BATCH or "
                           "--nodes/--pods/--batch)")
    ap.add_argument("--out", default=None,
                    help="the --profile / --timeline / --trace artifact's "
                         f"path (default under {ARTIFACT_DIR})")
    ap.add_argument("--seam", default=None, choices=("grpc", "http"),
                    help="the seam rows' and --trace's transport (default: "
                         "the row's, gRPC)")
    ap.add_argument("--backend", default="tpu", choices=("tpu", "sharded"),
                    help="the batch backend: tpu (TorchBatchBackend, the "
                         "default) or sharded (ShardedTorchBatchBackend, "
                         "with the census and the timeline armed, as "
                         "bench.py's headline)")
    ap.add_argument("--shards", type=int, default=None,
                    help="--backend sharded: this many shards over the "
                         "device (default: one per visible card; on the "
                         "CPU one)")
    ap.add_argument("--worker-url", default=None,
                    help="a seam row drives the device worker at this URL "
                         "(python -m kubernetes_tpu_torch.cmd.tpu_worker) "
                         "instead of one in this process")
    args = ap.parse_args(argv)
    if args.profile or args.timeline or args.trace:
        sizes = {k: v for k, v in (("nodes", args.nodes),
                                   ("pods", args.pods),
                                   ("batch", args.batch)) if v is not None}
        if args.trace:
            out = run_trace(args.out, args.device, seam=args.seam or "grpc",
                            **sizes)
        else:
            run = run_profile if args.profile else run_timeline
            out = run(args.out, args.device, **sizes)
        print(json.dumps(out), flush=True)
        return 0 if out["barrier_ok"] else 1
    if args.instances is not None:
        sizes = {k: v for k, v in (("nodes", args.nodes),
                                   ("pods", args.pods),
                                   ("batch", args.batch)) if v is not None}
        res = run_scaleout(args.instances, args.device, **sizes)
        best = max((r.get("pods_per_s") or 0.0)
                   for r in res["BENCH_SCALEOUT"].values())
        print(json.dumps(row(best, res["nodes"], res["pods"], res["batch"],
                             {"mode": "scaleout", **res})), flush=True)
        return 1 if any("error" in r for r in
                        res["BENCH_SCALEOUT"].values()) else 0
    if args.processes is not None:
        res = run_scaleout_proc(args.processes, args.nodes, args.pods,
                                args.batch)
        best = max((r.get("pods_per_s") or 0.0)
                   for r in res["BENCH_SCALEOUT_PROC"].values())
        print(json.dumps(row(best, res["nodes"], res["pods"], res["batch"],
                             {"mode": "scaleout-proc", **res})), flush=True)
        return 1 if proc_row_failed(res) else 0
    failed = False
    policy = None
    if args.host_profile:
        from ..scheduler.config import ProfilingPolicy
        policy = ProfilingPolicy(enabled=True)
    mesh = None
    if args.backend == "sharded" and (args.shards or args.device):
        from ..parallel.mesh import make_mesh
        mesh = make_mesh(args.device, shards=args.shards)
    for name in args.config:
        if "seam" in CONFIGS[name]:
            out = seam_row(name, args.device, args.nodes, args.batch,
                           kind=args.seam, worker_url=args.worker_url)
        else:
            out, _results = run_config(
                name, args.device, args.nodes, args.pods, args.batch,
                profiling_policy=policy, profile_pods=args.profile_pods,
                backend_kind=args.backend, mesh=mesh)
        print(json.dumps(out), flush=True)
        failed |= "error" in out["detail"]
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
